"""Hand-written CUDA kernels of the port, each with its plain PyTorch
version beside it. ``build`` compiles them at first launch; nothing here
imports it eagerly, so the package imports on hosts without ``nvcc``."""
from __future__ import annotations

import torch

# The kernel packages, each with its CUDA source in <package>/csrc/.
PACKAGES = ("alf_step", "rmsnorm", "flash_attention", "mamba_scan")


def on_cuda(name: str, device: torch.device) -> bool:
    """Dispatch of every op by the device of its tensors: True on a CUDA
    device (launch the kernel, or raise), False on the CPU (the plain
    version). There is no fallback from one to the other."""
    if device.type == "cuda":
        return True
    if device.type == "cpu":
        return False
    raise ValueError(f"{name}: no kernel or plain version for device "
                     f"{device}")
