"""Dense gated-MLP (SwiGLU) feed-forward. The products stay
``torch.matmul`` (cuBLAS on the card), as the JAX package leaves them to
XLA. Under tensor parallelism
(:func:`~repro_torch.distributed.tensor_parallel.model_split`) the rule
splits d_ff over 'model': ``w_gate``/``w_up`` are column-parallel,
``w_down`` row-parallel, and the ranks' partial outputs are summed."""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.tensor_parallel import (enter, leave,
                                                     model_split, splits)

from .common import dense_inits, silu, torch_dtype

Pytree = Any


def mlp_inits(generator: torch.Generator, cfg: ModelConfig, d_ff: int,
              device) -> Pytree:
    """Leaf initializers (``common.materialize``) of one gated MLP."""
    dt = torch_dtype(cfg.param_dtype)
    d = cfg.d_model
    return {
        "w_gate": dense_inits(generator, (d, d_ff), dt, device),
        "w_up": dense_inits(generator, (d, d_ff), dt, device),
        "w_down": dense_inits(generator, (d_ff, d), dt, device, fan_in=d_ff),
    }


def mlp_partial(params: Pytree, x: torch.Tensor) -> torch.Tensor:
    """The gated MLP of ``x`` on the d_ff block ``params`` holds (the
    whole output when it holds all of d_ff)."""
    return (silu(x @ params["w_gate"]) * (x @ params["w_up"])) \
        @ params["w_down"]


def apply_mlp(params: Pytree, x: torch.Tensor,
              d_ff: Optional[int] = None) -> torch.Tensor:
    """x [..., D] -> [..., D]. ``d_ff`` (the whole hidden width) lets a
    training step under tensor parallelism see whether the rule splits
    this MLP over 'model'; without it the MLP is whole."""
    tp = model_split()
    if d_ff is None or not splits(tp, d_ff):
        return mlp_partial(params, x)
    return leave(mlp_partial(params, enter(x)))
