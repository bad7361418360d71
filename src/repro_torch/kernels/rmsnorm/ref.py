"""Plain PyTorch version of the fused RMSNorm kernel.

What the CPU tests run, and the yardstick ``chip_smoke.py`` holds the CUDA
kernel against on the card: the JAX package's ``rmsnorm_ref`` (and its
``models.common.rmsnorm``), reduction and scaling in float32, the result
cast back to ``x``'s dtype.
"""
from __future__ import annotations

import torch


def rmsnorm_ref(x: torch.Tensor, scale: torch.Tensor,
                eps: float = 1e-6) -> torch.Tensor:
    """x: [..., d]; scale: [d]."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)
