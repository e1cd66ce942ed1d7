"""Engine, configuration, workloads and techniques of the port."""
