"""granite-20b [dense]: 52L d=6144 48H (MQA kv=1) d_ff=24576 vocab=49152.

llama-arch code model [arXiv:2405.04324].
"""
from .base import LayerSpec, ModelConfig, uniform_pattern

CONFIG = ModelConfig(
    name="granite-20b",
    d_model=6144, n_heads=48, n_kv_heads=1, d_head=128,
    d_ff=24576, vocab_size=49152,
    sharding="fsdp_tp",
    **uniform_pattern(52, LayerSpec(mixer="attn", mlp="dense")),
)
