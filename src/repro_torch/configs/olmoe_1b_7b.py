"""olmoe-1b-7b [moe]: 16L, d=2048, 16H (kv=16), expert ff=1024,
vocab=50304, MoE 64 experts top-8. [arXiv:2409.02060]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="olmoe-1b-7b", family="moe",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1024, vocab_size=50304,
    moe=True, n_experts=64, experts_per_token=8, moe_d_ff=1024,
)
