"""GQA attention of the port: q/k/v with the qkv biases and RoPE at given
positions, prefill through the flash attention kernel, single-token
decode against a KV cache, sliding windows — the port's counterpart of
`repro.models.attention` (self-attention only).

GQA is computed with grouped products: K/V are never repeated to Hq width.
On the card `attention(...)` and the dense family's chunks
(`models.model.prefill_extend`) call the hand-written flash kernel
(`kernels/flash_attention`) for every prompt length; the reference
calls `blockwise_attention`, its XLA mirror of that kernel, from 1,024
tokens on and `full_attention` below that (and `full_attention(q_offset=)`
for a chunk), which agree within float32 rounding. On the CPU the
kernel's wrapper runs its plain version. Decode is plain PyTorch (the
kernel's plain version over the cache, the reference's `full_attention`),
as the reference computes it outside any Pallas kernel.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.kernels.flash_attention.flash_attention import (
    flash_attention, flash_attention_plain)

from . import layers as L


class Attention(nn.Module):
    """`wq` (d, Hq*dh), `wk`/`wv` (d, Hkv*dh), `wo` (Hq*dh, d), and with
    `cfg.qkv_bias` the biases `bq` (Hq*dh), `bk`, `bv` (Hkv*dh), zeros at
    init as in the reference."""

    def __init__(self, cfg, g: torch.Generator, device=None):
        super().__init__()
        d, dh = cfg.d_model, cfg.dh
        hq, hkv = cfg.n_heads, cfg.n_kv_heads
        self.wq = L.dense_init(g, d, hq * dh, device)
        self.wk = L.dense_init(g, d, hkv * dh, device)
        self.wv = L.dense_init(g, d, hkv * dh, device)
        self.wo = L.dense_init(g, hq * dh, d, device)
        if cfg.qkv_bias:
            self.bq = L.const((hq * dh,), 0.0, device)
            self.bk = L.const((hkv * dh,), 0.0, device)
            self.bv = L.const((hkv * dh,), 0.0, device)


def _qkv(cfg, p: Attention, x: torch.Tensor):
    B, S = x.shape[:2]
    q = x @ p.wq.to(x.dtype)
    k = x @ p.wk.to(x.dtype)
    v = x @ p.wv.to(x.dtype)
    if cfg.qkv_bias:
        q = q + p.bq.to(x.dtype)
        k = k + p.bk.to(x.dtype)
        v = v + p.bv.to(x.dtype)
    return (q.reshape(B, S, cfg.n_heads, cfg.dh),
            k.reshape(B, S, cfg.n_kv_heads, cfg.dh),
            v.reshape(B, S, cfg.n_kv_heads, cfg.dh))


def qkv_at(cfg, p: Attention, x: torch.Tensor, positions: torch.Tensor):
    """q (B,S,Hq,dh), k, v (B,S,Hkv,dh) of x (B,S,d) at `positions` (S,),
    RoPE applied to q and k: the token-wise part of attention."""
    q, k, v = _qkv(cfg, p, x)
    cos, sin = L.rope_freqs(positions, cfg.dh, cfg.rope_theta)
    return L.apply_rope(q, cos, sin), L.apply_rope(k, cos, sin), v


def attention(cfg, p: Attention, x: torch.Tensor, *, window: int = 0):
    """Causal self-attention over the whole sequence (prefill) through the
    flash kernel, positions 0..S-1. Returns (out (B,S,d), (k, v)) with k/v
    (B,S,Hkv,dh) after RoPE."""
    q, k, v = qkv_at(cfg, p, x, torch.arange(x.shape[1], device=x.device))
    out = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                          causal=True, window=window)
    out = out.reshape(x.shape[0], x.shape[1], cfg.n_heads * cfg.dh)
    return out @ p.wo.to(x.dtype), (k, v)


def decode_attention(cfg, p: Attention, x: torch.Tensor, cache_k, cache_v,
                     pos: int, *, window: int = 0):
    """Single-token decode. cache_k/v (B, S_max, Hkv, dh); pos: the current
    position, the same for every row. Writes the new key and value at pos
    (pos % S_max when window > 0: a ring buffer) IN PLACE — the reference
    returns updated copies; the port saves copying the whole cache per
    token. Returns (out, cache_k, cache_v)."""
    B = x.shape[0]
    q, k1, v1 = qkv_at(cfg, p, x, torch.tensor([pos], device=x.device))
    write = pos % cache_k.shape[1] if window > 0 else pos
    cache_k[:, write] = k1[:, 0].to(cache_k.dtype)
    cache_v[:, write] = v1[:, 0].to(cache_v.dtype)
    # a windowed ring cache holds only live slots within the window, and
    # k_pos <= pos masks the slots not written yet, so the causal mask is
    # right for the ring and the linear cache alike
    out = flash_attention_plain(q, cache_k, cache_v, causal=True,
                                q_offset=pos)
    out = out.reshape(B, 1, cfg.n_heads * cfg.dh) @ p.wo.to(x.dtype)
    return out, cache_k, cache_v
