"""The public RMSNorm op, dispatched by device.

``rmsnorm(x, scale)`` over ``x`` of any shape ``[..., d]``: on a CUDA
tensor it launches the fused kernel once over the rows (or raises — there
is no fallback), on a CPU tensor it runs the plain version of ``ref.py``.
Forward only (serving); see :mod:`repro_torch.kernels.registry`.
:func:`rmsnorm_work` is the work one call declares (``kernels.Work``).
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels import Work, declared, on_cuda

from . import ref
from .rmsnorm import rmsnorm_call

# Calls since the last reset_op_calls(), on any device.
OP_CALLS: Dict[str, int] = {"rmsnorm": 0}


def reset_op_calls() -> None:
    for k in OP_CALLS:
        OP_CALLS[k] = 0


def rmsnorm_work(x: torch.Tensor, scale: torch.Tensor) -> Work:
    """One call's work: x read and the output written (x's dtype), the
    scale read once; 4 f32 operations an element (square, sum, two
    products)."""
    d = x.shape[-1]
    n = x.numel()
    return Work(4 * n, 2 * n * x.element_size() + d * scale.element_size())


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """x * rsqrt(mean(x^2, -1) + eps) * scale, f32 reduction, in x's
    dtype. x: [..., d]; scale: [d]."""
    OP_CALLS["rmsnorm"] += 1
    with declared("rmsnorm", rmsnorm_work, x, scale):
        if not on_cuda("rmsnorm", x.device):
            return ref.rmsnorm_ref(x, scale, eps)
        d = x.shape[-1]
        out = rmsnorm_call(x.reshape(-1, d).contiguous(),
                           scale.contiguous(), eps)
        return out.reshape(x.shape)
