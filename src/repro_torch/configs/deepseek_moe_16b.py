"""deepseek-moe-16b [moe]: 28L d=2048 16H (MHA kv=16) vocab=102400,
MoE 64 routed experts top-6 + 2 shared, per-expert d_ff=1408, layer-0 dense
(d_ff=10944) [arXiv:2401.06066].
"""
from .base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    d_model=2048, n_heads=16, n_kv_heads=16, d_head=128,
    d_ff=1408, vocab_size=102400,
    moe_experts=64, moe_top_k=6, moe_shared_experts=2, moe_d_ff=1408,
    prelude=(LayerSpec(mixer="attn", mlp="dense"),),
    prelude_d_ff=10944,
    period=(LayerSpec(mixer="attn", mlp="moe"),),
    n_periods=27,
    sharding="fsdp_tp",
)
