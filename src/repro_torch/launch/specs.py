"""input_specs(): meta-tensor stand-ins for every model input.

The port of the JAX package's ``repro.launch.specs``. Where the JAX
package returns ``jax.ShapeDtypeStruct`` leaves (through
``jax.eval_shape``), these return tensors on ``torch.device("meta")``:
a shape and a dtype, no storage. ``param_specs`` and ``serve_state_specs``
run the port's own ``init_lm`` and ``init_serve_state`` on the meta
device, so they allocate nothing at any width (grok-1-314b's 633 GB of
bf16 weights included), and their trees are the ones the real calls make.
:func:`tree_bytes` sums a tree's bytes: what a config's weights or cache
will take on the card, known before either is made;
:func:`serve_shard_bytes` what one rank of a mesh holds of them by the
sharding rules.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch import tree_util
from repro_torch.configs.base import ModelConfig, ShapeCell
from repro_torch.models import init_lm, init_serve_state
from repro_torch.models.common import torch_dtype
from repro_torch.models.lm import ServeState

Pytree = Any

META = torch.device("meta")


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def batch_specs(cfg: ModelConfig, cell: ShapeCell) -> Dict[str, Any]:
    """Training / prefill batch input specs at the cell's global shape."""
    b, s = cell.global_batch, cell.seq_len
    if cfg.input_mode == "embeds":
        specs = {"embeds": _spec((b, s, cfg.d_model),
                                 torch_dtype(cfg.compute_dtype))}
    else:
        specs = {"tokens": _spec((b, s), torch.int32)}
    if cell.kind == "train":
        specs["labels"] = _spec((b, s), torch.int32)
    return specs


def decode_token_specs(cfg: ModelConfig, cell: ShapeCell) -> torch.Tensor:
    b = cell.global_batch
    if cfg.input_mode == "embeds":
        return _spec((b, 1, cfg.d_model), torch_dtype(cfg.compute_dtype))
    return _spec((b, 1), torch.int32)


def param_specs(cfg: ModelConfig) -> Pytree:
    """The parameter tree as meta tensors (no allocation)."""
    return init_lm(torch.Generator(), cfg, META)


def serve_state_specs(cfg: ModelConfig, cell: ShapeCell) -> ServeState:
    """The serve state (cache and position) as meta tensors (under an
    ambient mesh of several ranks, the rank's blocks)."""
    return init_serve_state(cfg, cell.global_batch, cell.seq_len, META)


def input_specs(cfg: ModelConfig, cell: ShapeCell) -> Dict[str, Any]:
    """All step-function inputs for this (arch x shape) cell."""
    out: Dict[str, Any] = {"batch": batch_specs(cfg, cell)}
    if cell.kind == "decode":
        out["tokens"] = decode_token_specs(cfg, cell)
        out["state"] = serve_state_specs(cfg, cell)
    elif cell.kind == "prefill":
        out["state"] = serve_state_specs(cfg, cell)
    return out


def tree_bytes(specs: Pytree) -> int:
    """The bytes of every tensor in a tree (meta or real)."""
    return sum(t.numel() * t.element_size()
               for t in tree_util.tree_leaves(specs))


def serve_shard_bytes(cfg: ModelConfig, mesh, batch: int,
                      s_max: int) -> Dict[str, int]:
    """The bytes one rank of ``mesh`` (a DeviceMesh or ``{axis: size}``)
    holds to serve a global ``batch`` of ``s_max`` positions, by the
    rules: ``"params"`` its parameter shards (``param_shardings``),
    ``"cache"`` its blocks of the caches (``cache_shardings``, which
    raises where the JAX package's does), ``"pos"`` the position."""
    from repro_torch.distributed.sharding import (cache_shardings,
                                                  param_shardings,
                                                  shard_bytes)
    from repro_torch.models.transformer import init_cache
    params = param_specs(cfg)
    cache = init_cache(cfg, batch, s_max, META)
    return {"params": shard_bytes(param_shardings(cfg, mesh, params),
                                  params, mesh),
            "cache": shard_bytes(cache_shardings(cfg, mesh, cache, batch),
                                 cache, mesh),
            "pos": 4}


__all__ = ["META", "batch_specs", "decode_token_specs", "param_specs",
           "serve_state_specs", "input_specs", "tree_bytes",
           "serve_shard_bytes"]
