"""Dense gated-MLP (SwiGLU) feed-forward. The products stay
``torch.matmul`` (cuBLAS on the card), as the JAX package leaves them to
XLA."""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ModelConfig

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


def apply_mlp(params: Pytree, x: torch.Tensor) -> torch.Tensor:
    return (silu(x @ params["w_gate"]) * (x @ params["w_up"])) \
        @ params["w_down"]
