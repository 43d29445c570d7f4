"""glm4-9b [dense]: 40L, d=4096, 32H (GQA kv=2), ff=13696, vocab=151552.
[hf:THUDM/glm-4-9b]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="glm4-9b", family="dense",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=2,
    d_ff=13696, vocab_size=151552,
    train_microbatch=4,
)
