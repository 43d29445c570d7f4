"""whisper-small [audio]: 12L enc + 12L dec, d=768, 12H (kv=12), ff=3072,
vocab=51865. Encoder-decoder; conv/audio frontend is a STUB (input_specs
provides precomputed frame embeddings). [arXiv:2212.04356]"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-small", family="encdec",
    n_layers=12, d_model=768, n_heads=12, n_kv_heads=12,
    d_ff=3072, vocab_size=51865,
    norm="layernorm", act="gelu",
    encoder_layers=12, encoder_seq=1500,
    rope_theta=0.0,  # whisper uses learned/sinusoidal positions, not RoPE
    tie_embeddings=True,
)
