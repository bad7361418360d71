"""Gradient compression: int8 quantization with error feedback (the
1-bit-Adam / EF-SGD family).

The port of the JAX package's ``repro.optim.compression``: each tensor is
quantized per tensor, symmetric int8, after adding the residual carried
from the last step, so compression error does not accumulate. The train
step applies Q(g + e) -> dequant -> optimizer, e' = (g + e) - deq. With
data parallelism the int8 payload is what would cross the interconnect;
here the numerics — what affects training — are exact, and
:func:`compressed_bytes` gives the wire bytes analytically.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch

from repro_torch import tree_util as pytree

Pytree = Any


class EFState(NamedTuple):
    error: Pytree   # float32 residual per parameter


def init_ef_state(params: Pytree) -> EFState:
    return EFState(pytree.tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
        params))


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric int8. Returns (q, scale)."""
    amax = torch.max(torch.abs(x))
    scale = torch.clamp_min(
        amax / torch.full((), 127.0, dtype=amax.dtype, device=amax.device),
        1e-12)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_grads(grads: Pytree, ef: EFState) -> Tuple[Pytree, EFState]:
    """Error-feedback int8 round trip: returns (dequantized grads, new
    error-feedback state)."""
    leaves, spec = pytree.tree_flatten(grads)
    deq, err = [], []
    for g, e in zip(leaves, pytree.tree_leaves(ef.error)):
        gf = g.float() + e
        d = dequantize_int8(*quantize_int8(gf))
        deq.append(d.to(g.dtype))
        err.append(gf - d)
    return (pytree.tree_unflatten(deq, spec),
            EFState(pytree.tree_unflatten(err, spec)))


def compressed_bytes(grads: Pytree) -> int:
    """Wire bytes if the gradient reduction carried int8 payloads."""
    return sum(int(leaf.numel()) for leaf in pytree.tree_leaves(grads))
