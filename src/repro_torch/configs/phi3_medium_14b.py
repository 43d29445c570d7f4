"""phi3-medium-14b [dense]: 40L, d=5120, 40H (GQA kv=10), ff=17920,
vocab=100352. RoPE + SwiGLU + GQA. [arXiv:2404.14219]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="phi3-medium-14b", family="dense",
    n_layers=40, d_model=5120, n_heads=40, n_kv_heads=10,
    d_ff=17920, vocab_size=100352,
    train_microbatch=8,
)
