"""Architecture registry of the port: the configurations whose serving
path it runs so far (Zamba2-1.2B, hybrid; xlstm-350m, ssm; qwen2-1.5b,
olmo-1b, glm4-9b and phi3-medium-14b, dense; olmoe-1b-7b and
deepseek-moe-16b, moe; phi-3-vision-4.2b, vlm; whisper-small, encdec):
every architecture of `repro.configs`. `get_arch` and `reduced` behave
as `repro.configs`'s do."""
from .base import SHAPES, ArchConfig, ShapeSpec
from . import (deepseek_moe_16b, glm4_9b, olmo_1b, olmoe_1b_7b,
               phi3_medium_14b, phi3_vision_4_2b, qwen2_1_5b, whisper_small,
               xlstm_350m, zamba2_1_2b)

ARCHS: dict[str, ArchConfig] = {
    c.CONFIG.name: c.CONFIG
    for c in (zamba2_1_2b, xlstm_350m, qwen2_1_5b, olmo_1b, glm4_9b,
              phi3_medium_14b, olmoe_1b_7b, deepseek_moe_16b,
              phi3_vision_4_2b, whisper_small)}


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


def reduced(cfg: ArchConfig, **overrides) -> ArchConfig:
    """A small same-family config for CPU smoke tests (equal to
    `repro.configs.reduced`)."""
    import dataclasses as _dc
    small = dict(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=max(1, min(cfg.n_kv_heads, 2)),
        d_ff=128 if cfg.d_ff else 0, vocab_size=512,
        scan_layers=cfg.scan_layers, remat=False,
    )
    if cfg.moe:
        small.update(n_experts=4, experts_per_token=2, moe_d_ff=64,
                     dense_d_ff=128 if cfg.dense_d_ff else 0)
    if cfg.block_pattern:
        small["block_pattern"] = cfg.block_pattern[:2]
        small["n_layers"] = 2
    if cfg.family == "encdec":
        small.update(encoder_layers=2, encoder_seq=16)
    if cfg.family == "vlm":
        small.update(num_patches=8)
    if cfg.ssm_state:
        small.update(ssm_state=16)
    small.update(overrides)
    return _dc.replace(cfg, **small)


__all__ = ["ARCHS", "SHAPES", "ArchConfig", "ShapeSpec", "get_arch",
           "reduced"]
