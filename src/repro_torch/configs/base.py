"""Config system: architecture, layer-pattern and shape-cell configs.

A copy of the JAX package's ``repro.configs.base`` with the same names,
fields and defaults, so one config means the same model in both packages.

Layer patterns are expressed as (prelude, period, n_periods): the prelude
layers are unrolled, the period is repeated ``n_periods`` times with its
parameters and caches stacked on a leading ``n_periods`` axis (the JAX
package scans over that axis; the port loops over it in Python). All
layers inside one period may be heterogeneous (Jamba's mamba/attn
interleave, Gemma-2's local/global alternation); layers across periods
must repeat exactly.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

from repro_torch.core.ode_block import OdeSettings


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One sub-layer of a period."""
    mixer: str = "attn"           # 'attn' | 'mamba' | 'mlstm' | 'slstm'
    mlp: str = "dense"            # 'dense' | 'moe' | 'none'
    attn_kind: str = "global"     # 'global' | 'local'  (gemma2 alternation)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab_size: int
    # depth pattern
    prelude: Tuple[LayerSpec, ...]
    period: Tuple[LayerSpec, ...]
    n_periods: int
    # MoE
    moe_experts: int = 0
    moe_top_k: int = 0
    moe_shared_experts: int = 0
    moe_d_ff: int = 0              # per-(routed)-expert hidden dim
    moe_capacity_factor: float = 1.25
    moe_eval_capacity_factor: float = 2.0
    # dense-FFN override for prelude layers (DeepSeek layer-0 dense)
    prelude_d_ff: int = 0
    # attention details
    qk_norm: bool = False
    attn_softcap: float = 0.0      # gemma2: 50.0
    final_softcap: float = 0.0     # gemma2: 30.0
    sliding_window: int = 0        # local-attn window (gemma2: 4096)
    rope_theta: float = 10000.0
    # ssm (mamba) details
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_expand: int = 2
    # xlstm details
    lstm_proj_factor: float = 2.0
    # embedding / head
    tie_embeddings: bool = False
    input_mode: str = "tokens"     # 'tokens' | 'embeds' (vlm stub frontend)
    # numerics
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    # long-seq attention backward of the training path: 'flash' (FA2-style,
    # O(S*d) residuals) or 'autodiff'; read by the training slice
    attn_bwd: str = "flash"
    # the paper's technique
    ode: OdeSettings = dataclasses.field(default_factory=OdeSettings)
    # sharding strategy of the JAX package's mesh ('tp', 'dp', 'fsdp_tp');
    # carried for parity, unused on one card
    sharding: str = "tp"
    # sub-quadratic? (controls long_500k eligibility)
    subquadratic: bool = False

    @property
    def n_layers(self) -> int:
        return len(self.prelude) + len(self.period) * self.n_periods

    def layers(self) -> Tuple[LayerSpec, ...]:
        return self.prelude + self.period * self.n_periods

    def with_ode(self, ode: OdeSettings) -> "ModelConfig":
        return dataclasses.replace(self, ode=ode)

    def validate(self) -> "ModelConfig":
        if self.period and self.n_periods <= 0:
            raise ValueError("n_periods must be positive when period non-empty")
        has_moe = any(l.mlp == "moe" for l in self.prelude + self.period)
        if has_moe and (self.moe_experts <= 0 or self.moe_top_k <= 0):
            raise ValueError(f"{self.name}: moe layers need moe_experts/top_k")
        self.ode.validate()
        return self


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    """One assigned (input-shape) cell."""
    name: str                      # train_4k / prefill_32k / decode_32k / long_500k
    seq_len: int
    global_batch: int
    kind: str                      # 'train' | 'prefill' | 'decode'


SHAPE_CELLS = (
    ShapeCell("train_4k", 4096, 256, "train"),
    ShapeCell("prefill_32k", 32768, 32, "prefill"),
    ShapeCell("decode_32k", 32768, 128, "decode"),
    ShapeCell("long_500k", 524288, 1, "decode"),
)


def get_shape_cell(name: str) -> ShapeCell:
    for c in SHAPE_CELLS:
        if c.name == name:
            return c
    raise ValueError(f"unknown shape cell {name!r}")


def cell_applicable(cfg: ModelConfig, cell: ShapeCell) -> Tuple[bool, str]:
    """Assignment rule: long_500k only for sub-quadratic archs."""
    if cell.name == "long_500k" and not cfg.subquadratic:
        return False, ("skip: long_500k requires sub-quadratic attention; "
                       f"{cfg.name} has full/global attention layers")
    return True, ""


def uniform_pattern(n_layers: int, spec: LayerSpec) -> dict:
    """Homogeneous depth: scan all layers as 1-layer periods."""
    return dict(prelude=(), period=(spec,), n_periods=n_layers)
