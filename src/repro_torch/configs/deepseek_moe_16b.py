"""deepseek-moe-16b [moe]: 28L, d=2048, 16H (kv=16), expert ff=1408,
vocab=102400, 2 shared + 64 routed top-6, fine-grained experts; layer 0 is a
dense FFN (DeepSeekMoE design). [arXiv:2401.06066]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-moe-16b", family="moe",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1408, vocab_size=102400,
    moe=True, n_experts=64, experts_per_token=6, n_shared_experts=2,
    moe_d_ff=1408, dense_d_ff=11264, moe_layer_start=1,
    train_microbatch=2,
)
