"""The public selective-scan op, dispatched by device.

``selective_scan(delta, u, A, B, C, h0=None)``: on CUDA tensors it
launches the kernel once (or raises — there is no fallback), on CPU
tensors it runs the plain version of ``ref.py``. Nothing is padded: the
kernel masks the channels past DI itself. Forward only (serving); see
:mod:`repro_torch.kernels.registry`. :func:`selective_scan_work` is the
work one call declares (``kernels.Work``).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import Work, declared, on_cuda

from . import ref
from .mamba_scan import selective_scan_call

# Calls since the last reset_op_calls(), on any device.
OP_CALLS: Dict[str, int] = {"selective_scan": 0}


def reset_op_calls() -> None:
    for k in OP_CALLS:
        OP_CALLS[k] = 0


def selective_scan_work(delta: torch.Tensor, u: torch.Tensor,
                        A: torch.Tensor, B: torch.Tensor,
                        C: torch.Tensor) -> Work:
    """One call's work: delta, u, B, C read in their dtypes, A (f32) and
    h0 (f32) read, y (f32) and the final h (f32) written; 7 f32
    operations for each (row, step, channel, state) (delta*A, exp,
    dA*h, du*B, +, h*C, +; the exp counted as one) and one for each
    (row, step, channel) (delta*u)."""
    bt, s, di = delta.shape
    st = A.shape[1]
    n = bt * s * di
    moved = (n * (delta.element_size() + u.element_size() + 4)
             + bt * s * st * (B.element_size() + C.element_size())
             + di * st * 4 + 2 * bt * di * st * 4)
    return Work(7 * n * st + n, moved)


def selective_scan(delta: torch.Tensor, u: torch.Tensor, A: torch.Tensor,
                   B: torch.Tensor, C: torch.Tensor,
                   h0: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """delta/u: [Bt, S, DI]; A: [DI, ST]; B/C: [Bt, S, ST]; h0: [Bt, DI,
    ST] (zeros when None). Returns (y [Bt, S, DI] f32, h_final [Bt, DI, ST]
    f32)."""
    OP_CALLS["selective_scan"] += 1
    with declared("selective_scan", selective_scan_work, delta, u, A, B, C):
        bt, _, di = delta.shape
        st = A.shape[1]
        if delta.is_meta:
            # the plain version's shapes, without its loop over S (on the
            # meta device it would compute nothing, step by step)
            return (torch.empty(delta.shape, dtype=torch.float32,
                                device=delta.device),
                    torch.empty((bt, di, st), dtype=torch.float32,
                                device=delta.device))
        if not on_cuda("selective_scan", delta.device):
            return ref.selective_scan_ref(delta, u, A, B, C, h0)
        # A and h0 are [DI, ST] and [Bt, DI, ST]: small next to delta, u
        h0 = (torch.zeros((bt, di, st), dtype=torch.float32,
                          device=delta.device)
              if h0 is None else h0.float().contiguous())
        return selective_scan_call(delta, u, A.float().contiguous(), B, C,
                                   h0)
