"""musicgen-large [audio]: 48L d=2048 32H (MHA kv=32) d_ff=8192 vocab=2048.

Decoder-only transformer over EnCodec tokens [arXiv:2306.05284]. The EnCodec
frontend is a stub: input_specs() provides precomputed frame embeddings
(input_mode='embeds'); the backbone is the assigned spec.
"""
from .base import LayerSpec, ModelConfig, uniform_pattern

CONFIG = ModelConfig(
    name="musicgen-large",
    d_model=2048, n_heads=32, n_kv_heads=32, d_head=64,
    d_ff=8192, vocab_size=2048,
    input_mode="embeds",
    sharding="dp",
    **uniform_pattern(48, LayerSpec(mixer="attn", mlp="dense")),
)
