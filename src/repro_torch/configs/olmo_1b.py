"""olmo-1b [dense]: 16L, d=2048, 16H (kv=16), ff=8192, vocab=50304.
Non-parametric LayerNorm. [arXiv:2402.00838]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="olmo-1b", family="dense",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=8192, vocab_size=50304,
    norm="nonparametric_ln", tie_embeddings=True,
)
