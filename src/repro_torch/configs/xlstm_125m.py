"""xlstm-125m [ssm]: 12L d=768 4H, no FFN (d_ff=0), vocab=50304.

sLSTM + mLSTM blocks [arXiv:2405.04517]. Ratio choice (documented per
DESIGN.md): 5 mLSTM : 1 sLSTM per 6-layer period (the paper's xLSTM[7:1]
ratio rounded to this depth). Sub-quadratic — runs the long_500k cell.
"""
from .base import LayerSpec, ModelConfig

_PERIOD = tuple([LayerSpec(mixer="mlstm", mlp="none")] * 5
                + [LayerSpec(mixer="slstm", mlp="none")])

CONFIG = ModelConfig(
    name="xlstm-125m",
    d_model=768, n_heads=4, n_kv_heads=4, d_head=192,
    d_ff=0, vocab_size=50304,
    prelude=(), period=_PERIOD, n_periods=2,
    subquadratic=True,
    sharding="dp",
)
