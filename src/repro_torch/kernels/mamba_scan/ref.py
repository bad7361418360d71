"""Plain PyTorch version of the fused selective-scan kernel.

What the CPU tests run, what ``backend="reference"`` runs on the card, and
the yardstick ``chip_smoke.py`` holds the CUDA kernel against there: the
JAX package's ``selective_scan_ref``,

    h_t = exp(delta_t * A) * h_{t-1} + (delta_t * u_t) * B_t
    y_t = sum_s h_t[..., s] * C_t[s]

with the same operation order, in float32. The JAX oracle materialises
``dA`` and ``dBu`` ([Bt, S, DI, ST] f32 each, 2.1 GB apiece at Jamba's
prefill); this version forms them one time step at a time inside the loop
over S, so it fits on the card beside the model's weights. It is the same
function.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def selective_scan_ref(delta: torch.Tensor, u: torch.Tensor, A: torch.Tensor,
                       B: torch.Tensor, C: torch.Tensor,
                       h0: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """delta/u: [Bt, S, DI]; A: [DI, ST]; B/C: [Bt, S, ST];
    h0: [Bt, DI, ST]. Returns (y [Bt, S, DI] f32, h_final [Bt, DI, ST]
    f32)."""
    bt, s, di = delta.shape
    st = A.shape[1]
    d, uf = delta.float(), u.float()
    a, bm, cm = A.float(), B.float(), C.float()
    h = (torch.zeros((bt, di, st), dtype=torch.float32, device=delta.device)
         if h0 is None else h0.float())
    y = torch.empty((bt, s, di), dtype=torch.float32, device=delta.device)
    for t in range(s):
        dt = d[:, t]                                       # [Bt, DI]
        dA_t = torch.exp(dt[..., None] * a)                # [Bt, DI, ST]
        dBu_t = (dt * uf[:, t])[..., None] * bm[:, t, None, :]
        h = dA_t * h + dBu_t
        # elementwise product and sum, not a matmul: no TF32 on the card
        y[:, t] = (h * cm[:, t, None, :]).sum(-1)
    return y, h
