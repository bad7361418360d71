"""Plain PyTorch version of the flash-attention kernel.

A port of the JAX package's ``attention_ref``: causal (or not) grouped
attention with the optional logit softcap and sliding window, scores and
softmax in float32, masked scores set to ``NEG_INF = -2**30``, query ``i``
at position ``i`` and key ``j`` at position ``j``. What the CPU tests run,
and the yardstick ``chip_smoke.py`` holds the CUDA kernel against on the
card.
"""
from __future__ import annotations

import torch

NEG_INF = -2.0 ** 30


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0,
                  softcap: float = 0.0) -> torch.Tensor:
    """q: [B, Sq, H, d]; k/v: [B, Sk, K, d] with H % K == 0. f32 math,
    result in q's dtype."""
    b, sq, h, d = q.shape
    sk, kh = k.shape[1], k.shape[2]
    g = h // kh
    qg = q.reshape(b, sq, kh, g, d).float()
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) * (d ** -0.5)
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    qpos = torch.arange(sq, device=q.device)
    kpos = torch.arange(sk, device=q.device)
    keep = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        keep &= kpos[None, :] <= qpos[:, None]
    if window > 0:
        keep &= kpos[None, :] > qpos[:, None] - window
    s = s.masked_fill(~keep, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return o.reshape(b, sq, h, d).to(q.dtype)
