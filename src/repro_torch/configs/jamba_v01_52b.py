"""jamba-v0.1-52b [hybrid]: 32L d=4096 32H (GQA kv=8) d_ff=14336 vocab=65536,
Mamba:attention 7:1 interleave, MoE 16 experts top-2 every 2 layers
[arXiv:2403.19887]. Period of 8: attention at index 4, MoE at odd indices.
Mamba-dominant ⇒ sub-quadratic ⇒ runs the long_500k cell.
"""
from .base import LayerSpec, ModelConfig

_PERIOD = tuple(
    LayerSpec(mixer=("attn" if j == 4 else "mamba"),
              mlp=("moe" if j % 2 == 1 else "dense"))
    for j in range(8))

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    d_model=4096, n_heads=32, n_kv_heads=8, d_head=128,
    d_ff=14336, vocab_size=65536,
    moe_experts=16, moe_top_k=2, moe_d_ff=14336,
    mamba_d_state=16, mamba_d_conv=4, mamba_expand=2,
    prelude=(), period=_PERIOD, n_periods=4,
    sharding="fsdp_tp",
    subquadratic=True,
)
