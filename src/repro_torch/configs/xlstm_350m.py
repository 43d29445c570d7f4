"""xlstm-350m [ssm]: 24L, d=1024, 4H (kv=4), no FFN (d_ff=0), vocab=50304.
sLSTM + mLSTM blocks (every 4th block is sLSTM). Fully recurrent =>
long_500k runs. [arXiv:2405.04517]"""
from .base import ArchConfig

_pattern = tuple("S" if (i % 4 == 3) else "X" for i in range(24))

CONFIG = ArchConfig(
    name="xlstm-350m", family="ssm",
    n_layers=24, d_model=1024, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab_size=50304,
    block_pattern=_pattern, scan_layers=False,
    train_microbatch=16,
)
