"""gemma2-2b [dense]: 26L d=2304 8H (GQA kv=4) d_ff=9216 vocab=256000.

Local/global alternating attention (window 4096), attn-logit softcap 50,
final-logit softcap 30, tied embeddings, head_dim 256 [arXiv:2408.00118].
"""
from .base import LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="gemma2-2b",
    d_model=2304, n_heads=8, n_kv_heads=4, d_head=256,
    d_ff=9216, vocab_size=256000,
    attn_softcap=50.0, final_softcap=30.0, sliding_window=4096,
    tie_embeddings=True,
    sharding="dp",
    prelude=(),
    period=(LayerSpec(mixer="attn", mlp="dense", attn_kind="local"),
            LayerSpec(mixer="attn", mlp="dense", attn_kind="global")),
    n_periods=13,
)
