"""Flash attention (forward): CUDA kernel (``csrc/flash_attention.cu``),
its launcher, the plain PyTorch version (``ref.py``) and the
device-dispatching op."""
