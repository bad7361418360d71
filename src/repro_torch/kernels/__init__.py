"""Hand-written CUDA kernels of the port, each with its plain PyTorch
version beside it. ``build`` compiles them at first launch; nothing here
imports it eagerly, so the package imports on hosts without ``nvcc``."""
