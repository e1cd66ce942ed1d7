"""Hand-written CUDA kernels (``csrc/``), their wrappers, routing and
plain PyTorch versions."""
