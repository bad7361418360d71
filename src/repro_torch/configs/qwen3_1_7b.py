"""qwen3-1.7b [dense]: 28L d=2048 16H (GQA kv=8) d_ff=6144 vocab=151936.

qk_norm + GQA [hf:Qwen/Qwen3-*].
"""
from .base import LayerSpec, ModelConfig, uniform_pattern

CONFIG = ModelConfig(
    name="qwen3-1.7b",
    d_model=2048, n_heads=16, n_kv_heads=8, d_head=128,
    d_ff=6144, vocab_size=151936,
    qk_norm=True, rope_theta=1e6,
    sharding="dp",
    **uniform_pattern(28, LayerSpec(mixer="attn", mlp="dense")),
)
