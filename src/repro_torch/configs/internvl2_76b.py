"""internvl2-76b [vlm]: 80L d=8192 64H (GQA kv=8) d_ff=28672 vocab=128256.

InternViT + InternLM2 [arXiv:2404.16821]. The ViT frontend is a stub:
input_specs() provides precomputed patch embeddings (input_mode='embeds');
the backbone (InternLM2-style GQA transformer) is the assigned spec.
"""
from .base import LayerSpec, ModelConfig, uniform_pattern

CONFIG = ModelConfig(
    name="internvl2-76b",
    d_model=8192, n_heads=64, n_kv_heads=8, d_head=128,
    d_ff=28672, vocab_size=128256,
    input_mode="embeds",
    sharding="fsdp_tp",
    **uniform_pattern(80, LayerSpec(mixer="attn", mlp="dense")),
)
