"""The public flash-attention op, dispatched by device.

``flash_attention(q, k, v)`` in the model's layout, q ``[B, Sq, H, d]``
and k/v ``[B, Sk, K, d]``: on CUDA tensors it launches the kernel once
(or raises — there is no fallback), on CPU tensors it runs the plain
version of ``ref.py``. Forward only (serving); see
:mod:`repro_torch.kernels.registry`.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels import Work, declared, on_cuda

from . import ref
from .flash_attention import flash_attention_call

# Calls since the last reset_op_calls(), on any device.
OP_CALLS: Dict[str, int] = {"flash_attention": 0}


def reset_op_calls() -> None:
    for k in OP_CALLS:
        OP_CALLS[k] = 0


def unmasked_pairs(sq: int, sk: int, causal: bool, window: int) -> int:
    """How many (query, key) pairs of one head the mask keeps: query i
    at position i sees key j where j <= i (causal) and j > i - window
    (window > 0), as ``ref.attention_ref`` masks."""
    if window <= 0:
        if not causal:
            return sq * sk
        m = min(sq, sk)
        return m * (m + 1) // 2 + (sq - m) * sk
    total = 0
    for i in range(sq):
        hi = min(i, sk - 1) if causal else sk - 1
        total += max(0, hi - max(0, i - window + 1) + 1)
    return total


def flash_attention_work(q: torch.Tensor, k: torch.Tensor,
                         causal: bool = True, window: int = 0) -> Work:
    """One call's work: 4 d operations for each unmasked (query, key)
    pair and head (the two products; the masked scores are not counted),
    on the tensor cores for bf16/f16 inputs; q read and the output
    written in q's dtype, k and v read once."""
    b, sq, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    pairs = b * h * unmasked_pairs(sq, sk, causal, window)
    cls = "bf16" if q.dtype in (torch.bfloat16, torch.float16) else "f32"
    return Work(4 * pairs * d, 2 * b * sq * h * d * q.element_size()
                + 2 * b * sk * kv * d * k.element_size(), cls)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0) -> torch.Tensor:
    """q: [B, Sq, H, d]; k/v: [B, Sk, K, d] -> [B, Sq, H, d]."""
    OP_CALLS["flash_attention"] += 1
    with declared("flash_attention", flash_attention_work, q, k, causal,
                  window):
        if on_cuda("flash_attention", q.device):
            return flash_attention_call(q, k, v, causal=causal,
                                        window=window, softcap=softcap)
        return ref.attention_ref(q, k, v, causal=causal, window=window,
                                 softcap=softcap)
