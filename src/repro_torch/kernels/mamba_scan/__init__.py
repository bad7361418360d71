"""Fused selective scan (the Mamba recurrence): CUDA kernel
(``csrc/mamba_scan.cu``), its launcher, the plain PyTorch version
(``ref.py``) and the device-dispatching op."""
