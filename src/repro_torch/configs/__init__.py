"""Config registry: the assigned architectures + reduced smoke variants.

The same ten configs as the JAX package's ``repro.configs``, in data files
of their own. Every config loads, and the port serves and trains each
one.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from repro_torch.core.ode_block import OdeSettings

from .base import (SHAPE_CELLS, LayerSpec, ModelConfig, ShapeCell,
                   cell_applicable, get_shape_cell, uniform_pattern)
from .deepseek_moe_16b import CONFIG as _deepseek
from .gemma2_2b import CONFIG as _gemma2
from .granite_20b import CONFIG as _granite
from .grok_1_314b import CONFIG as _grok
from .internvl2_76b import CONFIG as _internvl2
from .jamba_v01_52b import CONFIG as _jamba
from .musicgen_large import CONFIG as _musicgen
from .qwen3_1_7b import CONFIG as _qwen3
from .stablelm_1_6b import CONFIG as _stablelm
from .xlstm_125m import CONFIG as _xlstm

ARCHS: Dict[str, ModelConfig] = {
    c.name: c.validate() for c in (
        _musicgen, _internvl2, _stablelm, _qwen3, _granite, _gemma2,
        _xlstm, _deepseek, _grok, _jamba)
}

# The paper's own setting: continuous-depth variants are obtained with
# get_config(name, ode=OdeSettings(mode='per_block', ...)).
DEFAULT_ODE = OdeSettings(mode="per_block", method="mali", solver="alf",
                          n_steps=2)


def get_config(name: str, ode: Optional[OdeSettings] = None) -> ModelConfig:
    if name not in ARCHS:
        raise ValueError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    cfg = ARCHS[name]
    if ode is not None:
        cfg = cfg.with_ode(ode)
    return cfg.validate()


def smoke_config(name: str, ode: Optional[OdeSettings] = None) -> ModelConfig:
    """Reduced same-family config: tiny widths/depth, same layer pattern."""
    cfg = get_config(name, ode)
    n_kv = min(cfg.n_kv_heads, 2)
    n_heads = max(2, min(cfg.n_heads, 4))
    n_heads = max(n_heads, n_kv) - (max(n_heads, n_kv) % n_kv)
    d_head = 16
    d_model = 64
    reduced = dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        d_model=d_model, n_heads=n_heads, n_kv_heads=n_kv, d_head=d_head,
        d_ff=(128 if cfg.d_ff else 0), vocab_size=256,
        moe_experts=(4 if cfg.moe_experts else 0),
        moe_top_k=(2 if cfg.moe_top_k else 0),
        moe_d_ff=(32 if cfg.moe_d_ff else 0),
        # dropless in smoke (cap >= N both train and serve)
        moe_capacity_factor=2.0, moe_eval_capacity_factor=2.0,
        prelude_d_ff=(64 if cfg.prelude_d_ff else 0),
        n_periods=min(cfg.n_periods, 2),
        mamba_d_state=8,
        sliding_window=(8 if cfg.sliding_window else 0),
        param_dtype="float32", compute_dtype="float32",
        sharding="tp",
    )
    return reduced.validate()


__all__ = ["ARCHS", "get_config", "smoke_config", "DEFAULT_ODE",
           "ModelConfig", "LayerSpec", "ShapeCell", "SHAPE_CELLS",
           "get_shape_cell", "cell_applicable", "uniform_pattern",
           "OdeSettings"]
