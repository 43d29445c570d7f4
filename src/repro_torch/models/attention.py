"""GQA attention of the port: q/k/v with the qkv biases and RoPE at given
positions (none with learned positions, `cfg.rope_theta == 0`), prefill
through the flash attention kernel, causal or not, single-token decode
against a KV cache, sliding windows, and whisper's cross-attention (q
from the decoder against keys and values of the encoder's output) — the
port's counterpart of `repro.models.attention`.

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
    RoPE applied to q and k when `cfg.rope_theta > 0`: the token-wise part
    of attention."""
    q, k, v = _qkv(cfg, p, x)
    if cfg.rope_theta <= 0:
        return q, k, v
    cos, sin = L.rope_freqs(positions, cfg.dh, cfg.rope_theta)
    return L.apply_rope(q, cos, sin), L.apply_rope(k, cos, sin), v


def cross_q(cfg, p: Attention, x: torch.Tensor) -> torch.Tensor:
    """q (B,S,Hq,dh) of a cross-attention: x . wq, plus bq with
    `cfg.qkv_bias`; no positions."""
    q = x @ p.wq.to(x.dtype)
    if cfg.qkv_bias:
        q = q + p.bq.to(x.dtype)
    return q.reshape(x.shape[0], x.shape[1], cfg.n_heads, cfg.dh)


def encoder_kv(cfg, p: Attention, enc_out: torch.Tensor):
    """k, v (B,S_enc,Hkv,dh) of a cross-attention over the encoder's output
    (B,S_enc,d): enc_out . wk and enc_out . wv, without bias, as the
    reference builds them (`repro/models/model.py:474-477`)."""
    B, S = enc_out.shape[:2]
    k = enc_out @ p.wk.to(enc_out.dtype)
    v = enc_out @ p.wv.to(enc_out.dtype)
    return (k.reshape(B, S, cfg.n_kv_heads, cfg.dh),
            v.reshape(B, S, cfg.n_kv_heads, cfg.dh))


def attention(cfg, p: Attention, x: torch.Tensor, *, window: int = 0,
              causal: bool = True, cross_kv=None):
    """Attention over the whole sequence (prefill) through the flash
    kernel. Self-attention (positions 0..S-1, causal or not — whisper's
    encoder is not): returns (out (B,S,d), (k, v)) with k/v (B,S,Hkv,dh)
    after RoPE. Cross-attention, `cross_kv=(k, v)` (`encoder_kv`): q
    from x alone (`cross_q`) against those keys and values, with the
    `causal` mask the caller gives (whisper's decoder: False); returns
    (out, None)."""
    if cross_kv is not None:
        q, (k, v) = cross_q(cfg, p, x), cross_kv
        kv = None
    else:
        q, k, v = qkv_at(cfg, p, x, torch.arange(x.shape[1],
                                                 device=x.device))
        kv = (k, v)
    out = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                          causal=causal, window=window)
    out = out.reshape(x.shape[0], x.shape[1], cfg.n_heads * cfg.dh)
    return out @ p.wo.to(x.dtype), kv


def decode_attention(cfg, p: Attention, x: torch.Tensor, cache_k, cache_v,
                     pos: int, *, window: int = 0, cross: bool = False):
    """Single-token decode. cache_k/v (B, S_max, Hkv, dh); pos: the current
    position, the same for every row. Writes the new key and value at pos
    (pos % S_max when window > 0: a ring buffer) IN PLACE — the reference
    returns updated copies; the port saves copying the whole cache per
    token. With `cross=True` the caches are a cross-attention's keys and
    values of the encoder's output: q alone is projected, nothing is
    written, and every key is kept. Returns (out, cache_k, cache_v)."""
    B = x.shape[0]
    if cross:
        out = flash_attention_plain(cross_q(cfg, p, x), cache_k, cache_v,
                                    causal=False)
        out = out.reshape(B, 1, cfg.n_heads * cfg.dh) @ p.wo.to(x.dtype)
        return out, cache_k, cache_v
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
