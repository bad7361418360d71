"""Gradient compression: int8 quantization with error feedback (the
1-bit-Adam / EF-SGD family).

The port of the JAX package's ``repro.optim.compression``: each tensor is
quantized per tensor, symmetric int8, after adding the residual carried
from the last step, so compression error does not accumulate. The train
step applies Q(g + e) -> dequant -> optimizer, e' = (g + e) - deq, to
the reduced gradient, as the JAX package does after GSPMD's reduction;
under data parallelism to each rank's shard of it, with the whole
tensor's scale, the residual sharded like the optimizer state. The int8
payload is what would cross the interconnect; here the numerics — what
affects training — are exact, and :func:`compressed_bytes` gives the
wire bytes analytically.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch

from repro_torch import tree_util as pytree

Pytree = Any


class EFState(NamedTuple):
    error: Pytree   # float32 residual per parameter


def init_ef_state(params: Pytree) -> EFState:
    return EFState(pytree.tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
        params))


def quantize_int8(x: torch.Tensor, amax: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric int8. Returns (q, scale). ``amax`` given: the
    whole tensor's max |x| when ``x`` is a shard of it."""
    if amax is None:
        amax = torch.max(torch.abs(x))
    scale = torch.clamp_min(
        amax / torch.full((), 127.0, dtype=amax.dtype, device=amax.device),
        1e-12)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_grads(grads: Pytree, ef: EFState,
                   max_over_ranks: Optional[Callable] = None
                   ) -> Tuple[Pytree, EFState]:
    """Error-feedback int8 round trip: returns (dequantized grads, new
    error-feedback state). Over a mesh ``grads`` and ``ef`` hold this
    rank's blocks (split over 'data', 'model' or both) and
    ``max_over_ranks`` maps the blocks' maxima to the whole tensors'
    (one collective over the mesh), so each block takes its tensor's
    scale."""
    leaves, spec = pytree.tree_flatten(grads)
    errors = pytree.tree_leaves(ef.error)
    amaxes = [None] * len(leaves)
    if max_over_ranks is not None:
        amaxes = max_over_ranks([torch.max(torch.abs(g.float() + e))
                                 for g, e in zip(leaves, errors)])
    deq, err = [], []
    for g, e, amax in zip(leaves, errors, amaxes):
        gf = g.float() + e
        d = dequantize_int8(*quantize_int8(gf, amax))
        deq.append(d.to(g.dtype))
        err.append(gf - d)
    return (pytree.tree_unflatten(deq, spec),
            EFState(pytree.tree_unflatten(err, spec)))


def compressed_bytes(grads: Pytree) -> int:
    """Wire bytes if the gradient reduction carried int8 payloads."""
    return sum(int(leaf.numel()) for leaf in pytree.tree_leaves(grads))
