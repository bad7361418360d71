"""grok-1-314b [moe]: 64L d=6144 48H (GQA kv=8) d_ff=32768 vocab=131072,
MoE 8 experts top-2 [hf:xai-org/grok-1].
"""
from .base import LayerSpec, ModelConfig, uniform_pattern

CONFIG = ModelConfig(
    name="grok-1-314b",
    d_model=6144, n_heads=48, n_kv_heads=8, d_head=128,
    d_ff=32768, vocab_size=131072,
    moe_experts=8, moe_top_k=2, moe_d_ff=32768,
    sharding="fsdp_tp",
    **uniform_pattern(64, LayerSpec(mixer="attn", mlp="moe")),
)
