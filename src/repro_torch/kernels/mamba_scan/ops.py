"""The public selective-scan op, dispatched by device.

``selective_scan(delta, u, A, B, C, h0=None)``: on CUDA tensors it
launches the kernel once (or raises — there is no fallback), on CPU
tensors it runs the plain version of ``ref.py``. Nothing is padded: the
kernel masks the channels past DI itself. Forward only (serving); see
:mod:`repro_torch.kernels.registry`.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import on_cuda

from . import ref
from .mamba_scan import selective_scan_call

# Calls since the last reset_op_calls(), on any device.
OP_CALLS: Dict[str, int] = {"selective_scan": 0}


def reset_op_calls() -> None:
    for k in OP_CALLS:
        OP_CALLS[k] = 0


def selective_scan(delta: torch.Tensor, u: torch.Tensor, A: torch.Tensor,
                   B: torch.Tensor, C: torch.Tensor,
                   h0: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """delta/u: [Bt, S, DI]; A: [DI, ST]; B/C: [Bt, S, ST]; h0: [Bt, DI,
    ST] (zeros when None). Returns (y [Bt, S, DI] f32, h_final [Bt, DI, ST]
    f32)."""
    OP_CALLS["selective_scan"] += 1
    if not on_cuda("selective_scan", delta.device):
        return ref.selective_scan_ref(delta, u, A, B, C, h0)
    bt, _, di = delta.shape
    st = A.shape[1]
    # A and h0 are [DI, ST] and [Bt, DI, ST]: small next to delta and u
    h0 = (torch.zeros((bt, di, st), dtype=torch.float32, device=delta.device)
          if h0 is None else h0.float().contiguous())
    return selective_scan_call(delta, u, A.float().contiguous(), B, C, h0)
