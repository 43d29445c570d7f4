"""Model assembly of the port, the per-layer block families: hybrid
(Zamba2: a Mamba2 backbone with one attention block whose weights are
shared by every "A" position) and ssm (xLSTM: mLSTM "X" and sLSTM "S"
blocks, or Mamba2 "M") — the counterpart of `repro.models.model` for
`cfg.family in ("hybrid", "ssm")`.

Entry points:
  init_params           — the model (`HybridLM`), weights from a seeded
                          torch.Generator on the device
  prefill / decode_step — the serving paths with per-layer caches
  cache_specs           — shapes and types of decode_step's cache
  extend_cache_specs_ok / empty_extend_cache / prefill_extend
                        — incremental chunked prefill (the ssm family)

Parameters carry the reference tree's names (`embed.tok`,
`blocks.0.mamba.in_x`, `blocks.0.mlstm.wq`, `blocks.3.slstm.r`,
`shared_attn.attn.wq`, ...): the "A" positions of `blocks` are empty, as
the reference's `{}` entries are, and their weights live in
`shared_attn`. Other families raise NotImplementedError: they come with
later slices (ROADMAP.md).
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.device import resolve_device

from . import attention as A
from . import layers as L
from . import ssm as SS


def _check_family(cfg) -> None:
    """Raise for a config the port does not run yet. It runs the hybrid
    family with "M" blocks and one shared "A" block (SwiGLU, RoPE, no qkv
    bias) and the ssm family with "M", "X" and "S" blocks; both with
    rmsnorm, an untied head and no learned positions."""
    pattern = set(cfg.block_pattern)
    if cfg.family == "hybrid":
        ok = cfg.shared_attention and pattern <= {"A", "M"} \
            and cfg.act == "swiglu" and not cfg.qkv_bias
    else:
        ok = cfg.family == "ssm" and pattern <= {"M", "X", "S"}
    if not ok or cfg.norm != "rmsnorm" or cfg.rope_theta <= 0 \
            or cfg.tie_embeddings:
        raise NotImplementedError(
            f"the port runs the hybrid (Zamba2) and ssm (xLSTM) families so "
            f"far; {cfg.name!r} ({cfg.family}) comes with a later slice "
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
    """A Mamba2 block ("M"): ln1, mamba."""

    def __init__(self, cfg, g, device=None):
        super().__init__()
        self.ln1 = L.Norm(cfg, device)
        self.mamba = SS.Mamba2(cfg, g, device)


class MLSTMBlock(nn.Module):
    """An mLSTM block ("X"): ln1, mlstm."""

    def __init__(self, cfg, g, device=None):
        super().__init__()
        self.ln1 = L.Norm(cfg, device)
        self.mlstm = SS.MLSTM(cfg, g, device)


class SLSTMBlock(nn.Module):
    """An sLSTM block ("S"): ln1, slstm."""

    def __init__(self, cfg, g, device=None):
        super().__init__()
        self.ln1 = L.Norm(cfg, device)
        self.slstm = SS.SLSTM(cfg, g, device)


_BLOCKS = {"M": MambaBlock, "X": MLSTMBlock, "S": SLSTMBlock}


class HybridLM(nn.Module):
    """embed, blocks (one per `cfg.block_pattern` entry; empty at shared
    "A" positions), shared_attn (when the pattern has "A"), final_norm —
    the reference's parameter tree of both its hybrid and ssm families."""

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
                blocks.append(_BLOCKS[kind](cfg, g, device))
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


def _apply_recurrent(cfg, kind: str, p, x, state=None, **scan):
    """One "M", "X" or "S" block on x from `state`: (x, new state).
    `scan` (chunk, exact_chunk) goes to the chunked scans."""
    xin = p.ln1(x)
    if kind == "M":
        h, st = SS.apply_mamba2(cfg, p.mamba, xin, state=state, **scan)
    elif kind == "X":
        h, st = SS.apply_mlstm(cfg, p.mlstm, xin, state=state, **scan)
    else:
        h, st = SS.apply_slstm(cfg, p.slstm, xin, state=state, **scan)
    return x + h, st


def _apply_block_full(cfg, kind: str, p, x, *, window: int = 0):
    """Full-sequence block (prefill). Returns (x, cache entry)."""
    if kind == "A":
        h, (k, v) = A.attention(cfg, p.attn, p.ln1(x), window=window)
        x = x + h
        x = x + p.mlp(p.ln2(x))
        return x, {"k": k, "v": v}
    return _apply_recurrent(cfg, kind, p, x)


@torch.no_grad()
def prefill(cfg, params: HybridLM, batch, *, dtype=torch.float32):
    """Process the whole prompt (`batch["tokens"]` (B, S) int); return
    (last-token logits (B, V), cache): per layer {"k", "v"} (B,S,Hkv,dh) at
    "A" positions, {"conv", "ssm"} at "M", the (B,H,dh+1,dh) mLSTM state
    at "X" and {"h", "c"} at "S"."""
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
            x, ns = _apply_recurrent(cfg, kind, p, x, state=st)
            new_cache.append(ns)
    x = params.final_norm(x)
    return L.lm_logits(params.embed, x[:, -1]), new_cache


def _state_spec(cfg, kind: str, batch: int, dtype=torch.float32):
    """(shape, dtype) tree of one recurrent block's state; `dtype` is the
    Mamba2 conv state's."""
    if kind == "M":
        return SS.mamba2_state_spec(cfg, batch, dtype)
    if kind == "X":
        return SS.mlstm_state_spec(cfg, batch)
    return SS.slstm_state_spec(cfg, batch)


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
            specs.append(_state_spec(cfg, kind, batch))
    return specs


# ----------------------------------------------------------------------------
# Incremental chunked prefill
# ----------------------------------------------------------------------------

def extend_cache_specs_ok(cfg) -> bool:
    """True when `prefill_extend` runs this config: the ssm family, whose
    O(1) block states (Mamba2 conv + ssm, the mLSTM matrix, sLSTM h/c)
    thread from chunk to chunk. The reference also extends stacked
    attention caches (dense, vlm, moe); those come with the dense slice
    (ROADMAP.md queue 1 item 2). An "A" block in the pattern would need a
    windowed KV extension: the hybrid family stays on the prefix rerun."""
    return cfg.family == "ssm" and \
        all(k in ("M", "X", "S") for k in cfg.block_pattern)


def _zeros(spec, device):
    if isinstance(spec, dict):
        return {name: _zeros(s, device) for name, s in spec.items()}
    shape, dtype = spec
    return torch.zeros(shape, dtype=dtype, device=device)


def empty_extend_cache(cfg, batch: int, seq: int, dtype=torch.float32, *,
                       device=None):
    """The block states an incremental prefill of `seq` tokens starts
    from: zeros, which is what a scan from scratch starts from, so the
    first chunk replays a one-shot prefill's opening steps. (`seq` sizes
    the attention caches of the families that have them.)"""
    if not extend_cache_specs_ok(cfg):
        raise NotImplementedError(
            f"empty_extend_cache runs the ssm family so far, not "
            f"{cfg.family!r} (ROADMAP.md queue 1 item 2)")
    dev = resolve_device(device)
    return [_zeros(_state_spec(cfg, kind, batch, dtype), dev)
            for kind in cfg.block_pattern]


@torch.no_grad()
def prefill_extend(cfg, params: HybridLM, tokens, cache, done: int, *,
                   dtype=torch.float32, ssm_chunk: int = None):
    """Incremental chunked prefill: run ONLY the new chunk `tokens`
    (B, C), which starts at absolute position `done`, from the block
    states in `cache` (`empty_extend_cache` for the first chunk). Returns
    (last-token logits, new cache).

    ssm family: every scan runs with scan-block length exactly
    Q = `ssm_chunk` (default cfg.ssm_chunk). With Q the one-shot prefill's
    min(cfg.ssm_chunk, prompt length) and every chunk boundary a multiple
    of it — the serving engine keeps both — each call replays exactly the
    scan steps of the one-shot prefill, and the "X" and "S" blocks run
    their token-wise products per block of Q tokens (`ssm.by_blocks`), so
    the last logits and the final states are its bits. ("M" blocks run
    theirs per call, as Zamba2's prefill does: no ssm config of the repo
    has them.) The stacked-attention branch of the reference comes with
    the dense slice (ROADMAP.md queue 1 item 2)."""
    if not extend_cache_specs_ok(cfg):
        raise NotImplementedError(
            f"prefill_extend runs the ssm family so far, not "
            f"{cfg.family!r}: the stacked-attention branch comes with "
            f"ROADMAP.md queue 1 item 2")
    Q = int(ssm_chunk or cfg.ssm_chunk)
    x = L.embed_tokens(params.embed, tokens).to(dtype)
    new_cache = []
    for i, kind in enumerate(cfg.block_pattern):
        x, ns = _apply_recurrent(cfg, kind, params.blocks[i], x,
                                 state=cache[i], chunk=Q, exact_chunk=True)
        new_cache.append(ns)
    x = params.final_norm(x)
    return L.lm_logits(params.embed, x[:, -1]), new_cache
