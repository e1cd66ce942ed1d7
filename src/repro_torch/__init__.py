"""PyTorch / CUDA port of the EasyDRAM emulation engine (the reference is
the JAX package ``repro``). Imports torch and numpy only."""
