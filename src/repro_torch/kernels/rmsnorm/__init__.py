"""Fused RMSNorm: CUDA kernel (``csrc/rmsnorm.cu``), its launcher, the
plain PyTorch version (``ref.py``) and the device-dispatching op."""
