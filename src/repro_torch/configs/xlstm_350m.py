"""xlstm-350m [ssm]: 24 blocks, d_model=1024, 4 heads, vocab=50304,
d_ff=0 (no separate FFN: xLSTM blocks carry internal up/down projections).
sLSTM + mLSTM blocks in the paper's xLSTM[7:1] ratio -> period-8 super-block
of 7 mLSTM + 1 sLSTM, 24L = 3 super-blocks.  [arXiv:2405.04517; unverified]
"""
from repro_torch.configs.base import ModelConfig, XLSTMConfig

_PERIOD8 = tuple(("mlstm", "none") for _ in range(7)) + (("slstm", "none"),)

CONFIG = ModelConfig(
    name="xlstm-350m",
    family="ssm",
    num_layers=24,
    d_model=1024,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    block_defs=_PERIOD8,
    pos_embedding="none",
    xlstm=XLSTMConfig(),
    source="arXiv:2405.04517; unverified",
)
