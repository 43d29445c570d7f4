"""Model assembly of the port, hybrid family (Zamba2): a Mamba2 backbone
with one attention block whose weights are shared by every "A" position —
the counterpart of `repro.models.model` for `cfg.family == "hybrid"`.

Entry points:
  init_params          — the model (`HybridLM`), weights from a seeded
                         torch.Generator on the device
  prefill / decode_step — the serving paths with per-layer caches
  cache_specs          — shapes and types of decode_step's cache

Parameters carry the reference tree's names (`embed.tok`,
`blocks.0.mamba.in_x`, `shared_attn.attn.wq`, ...): the "A" positions of
`blocks` are empty, as the reference's `{}` entries are, and their weights
live in `shared_attn`. Other families raise NotImplementedError: they come
with later slices (ROADMAP.md).
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.device import resolve_device

from . import attention as A
from . import layers as L
from . import ssm as SS


def _check_family(cfg) -> None:
    """Raise for a config this slice does not run: the hybrid family with
    "M" blocks and one shared "A" block, rmsnorm, SwiGLU, RoPE, no qkv
    bias, untied head."""
    if cfg.family != "hybrid" or not cfg.shared_attention \
            or any(k not in ("A", "M") for k in cfg.block_pattern) \
            or cfg.norm != "rmsnorm" or cfg.act != "swiglu" \
            or cfg.rope_theta <= 0 or cfg.qkv_bias or cfg.tie_embeddings:
        raise NotImplementedError(
            f"the port runs the hybrid family (Zamba2) so far; "
            f"{cfg.name!r} ({cfg.family}) comes with a later slice "
            f"(ROADMAP.md)")


class AttnBlock(nn.Module):
    """Zamba2's shared attention block: ln1, attn, ln2, mlp."""

    def __init__(self, cfg, g, device=None):
        super().__init__()
        self.ln1 = L.Norm(cfg, device)
        self.attn = A.Attention(cfg, g, device)
        self.ln2 = L.Norm(cfg, device)
        self.mlp = L.MLP(cfg, g, device)


class MambaBlock(nn.Module):
    """A Mamba2 block: ln1, mamba."""

    def __init__(self, cfg, g, device=None):
        super().__init__()
        self.ln1 = L.Norm(cfg, device)
        self.mamba = SS.Mamba2(cfg, g, device)


class HybridLM(nn.Module):
    """embed, blocks (one per `cfg.block_pattern` entry; empty at shared
    "A" positions), shared_attn, final_norm."""

    def __init__(self, cfg, g: torch.Generator, device=None):
        super().__init__()
        _check_family(cfg)
        self.cfg = cfg
        self.embed = L.Embed(cfg, g, device)
        blocks = []
        for kind in cfg.block_pattern:
            if kind == "A":
                if not hasattr(self, "shared_attn"):
                    self.shared_attn = AttnBlock(cfg, g, device)
                blocks.append(nn.Module())  # weights in shared_attn
            else:
                blocks.append(MambaBlock(cfg, g, device))
        self.blocks = nn.ModuleList(blocks)
        self.final_norm = L.Norm(cfg, device)

    def block(self, i: int) -> nn.Module:
        """The module holding block i's weights."""
        if self.cfg.block_pattern[i] == "A":
            return self.shared_attn
        return self.blocks[i]


def init_params(cfg, seed: int = 0, *, device=None) -> HybridLM:
    """The model with random weights drawn from a torch.Generator seeded
    with `seed`, on `device` (None = the card; raises without CUDA)."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(int(seed))
    return HybridLM(cfg, g, dev).eval()


def _apply_block_full(cfg, kind: str, p, x, *, window: int = 0):
    """Full-sequence block (prefill). Returns (x, cache entry)."""
    if kind == "A":
        h, (k, v) = A.attention(cfg, p.attn, p.ln1(x), window=window)
        x = x + h
        x = x + p.mlp(p.ln2(x))
        return x, {"k": k, "v": v}
    h, st = SS.apply_mamba2(cfg, p.mamba, p.ln1(x))
    return x + h, st


@torch.no_grad()
def prefill(cfg, params: HybridLM, batch, *, dtype=torch.float32):
    """Process the whole prompt (`batch["tokens"]` (B, S) int); return
    (last-token logits (B, V), cache): per layer {"k", "v"} (B,S,Hkv,dh) at
    "A" positions and {"conv", "ssm"} at "M" positions."""
    _check_family(cfg)
    x = L.embed_tokens(params.embed, batch["tokens"]).to(dtype)
    cache = []
    for i, kind in enumerate(cfg.block_pattern):
        window = cfg.attn_window if kind == "A" else 0
        x, st = _apply_block_full(cfg, kind, params.block(i), x,
                                  window=window)
        cache.append(st)
    x = params.final_norm(x)
    return L.lm_logits(params.embed, x[:, -1]), cache


@torch.no_grad()
def decode_step(cfg, params: HybridLM, tokens, cache, pos: int, *,
                dtype=torch.float32):
    """One decode step. tokens (B, 1) int; pos: the current write position,
    the same across the batch. Returns (logits (B, V), new cache); the
    attention caches are written in place."""
    _check_family(cfg)
    x = L.embed_tokens(params.embed, tokens).to(dtype)
    new_cache = []
    for i, kind in enumerate(cfg.block_pattern):
        p, st = params.block(i), cache[i]
        if kind == "A":
            h, ck, cv = A.decode_attention(cfg, p.attn, p.ln1(x), st["k"],
                                           st["v"], pos,
                                           window=cfg.attn_window)
            x = x + h
            x = x + p.mlp(p.ln2(x))
            new_cache.append({"k": ck, "v": cv})
        else:
            h, ns = SS.apply_mamba2(cfg, p.mamba, p.ln1(x), state=st)
            x = x + h
            new_cache.append(ns)
    x = params.final_norm(x)
    return L.lm_logits(params.embed, x[:, -1]), new_cache


def cache_specs(cfg, batch: int, cache_len: int, dtype=torch.float32):
    """(shape, dtype) tree matching decode_step's cache argument."""
    _check_family(cfg)
    hkv, dh = cfg.n_kv_heads, cfg.dh
    specs = []
    for kind in cfg.block_pattern:
        if kind == "A":
            w = min(cache_len, cfg.attn_window) if cfg.attn_window \
                else cache_len
            specs.append({"k": ((batch, w, hkv, dh), dtype),
                          "v": ((batch, w, hkv, dh), dtype)})
        else:
            specs.append(SS.mamba2_state_spec(cfg, batch))
    return specs
