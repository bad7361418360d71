"""stablelm-1.6b [dense]: 24L d=2048 32H (MHA kv=32) d_ff=5632 vocab=100352.

[hf:stabilityai/stablelm-2-1_6b]
"""
from .base import LayerSpec, ModelConfig, uniform_pattern

CONFIG = ModelConfig(
    name="stablelm-1.6b",
    d_model=2048, n_heads=32, n_kv_heads=32, d_head=64,
    d_ff=5632, vocab_size=100352,
    sharding="dp",
    **uniform_pattern(24, LayerSpec(mixer="attn", mlp="dense")),
)
