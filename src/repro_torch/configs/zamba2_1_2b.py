"""zamba2-1.2b [hybrid]: 38L, d=2048, 32H (kv=32), ff=8192, vocab=32000,
ssm_state=64. Mamba2 backbone with a SHARED attention block applied every
6th layer (weight-tied). Attention blocks use a 4096 sliding window at long
context (sub-quadratic => long_500k runs). [arXiv:2411.15242]"""
from .base import ArchConfig

_pattern = tuple("A" if (i % 6 == 5) else "M" for i in range(38))

CONFIG = ArchConfig(
    name="zamba2-1.2b", family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab_size=32000,
    ssm_state=64, block_pattern=_pattern, shared_attention=True,
    attn_window=4096, scan_layers=False,
    train_microbatch=16,
)
