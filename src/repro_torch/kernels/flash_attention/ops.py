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

from repro_torch.kernels import on_cuda

from . import ref
from .flash_attention import flash_attention_call

# Calls since the last reset_op_calls(), on any device.
OP_CALLS: Dict[str, int] = {"flash_attention": 0}


def reset_op_calls() -> None:
    for k in OP_CALLS:
        OP_CALLS[k] = 0


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0) -> torch.Tensor:
    """q: [B, Sq, H, d]; k/v: [B, Sk, K, d] -> [B, Sq, H, d]."""
    OP_CALLS["flash_attention"] += 1
    if on_cuda("flash_attention", q.device):
        return flash_attention_call(q, k, v, causal=causal, window=window,
                                    softcap=softcap)
    return ref.attention_ref(q, k, v, causal=causal, window=window,
                             softcap=softcap)
