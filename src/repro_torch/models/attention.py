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

On a mesh (`dist`, with `attention_pspec`'s layout): where the query
heads divide the model ranks, each rank computes its H/tp query heads
(column-parallel wq, and wk/wv when the KV heads divide too; x through
`to_model`), runs the flash kernel on them, and its row-parallel part of
wo is summed by `from_model`. Where the KV heads do not divide, the rank
holds wk/wv whole (their gradient then partial: `to_model` on the
weights sums it over "model") and maps its query heads to the KV heads
they read (`kv_for`). Where the query heads do not divide, every rank
computes every head (FSDP only). A cross-attention splits the same way
(`cross_q`, `encoder_kv`); its decode reads the whole cross cache every
model rank holds through `kv_for`. Decode over a cache whose sequence is
split over "model" is `decode_attention_seqsharded` (a windowed ring
cache by slot).
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.kernels.flash_attention.flash_attention import (
    NEG_INF, flash_attention, flash_attention_plain)
from repro_torch.launch import collectives as C

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


def attention_pspec(cfg, tp: int = 16) -> dict:
    """Heads over "model" when they divide tp, else FSDP only; the KV
    heads over "model" only when they divide too
    (`repro/models/attention.py:44-58`)."""
    q_tp = "model" if (cfg.n_heads * cfg.dh) % tp == 0 and \
        cfg.n_heads % tp == 0 else None
    kv_tp = "model" if q_tp == "model" and cfg.n_kv_heads % tp == 0 \
        else None
    p = {"wq": ("data", q_tp), "wk": ("data", kv_tp), "wv": ("data", kv_tp),
         "wo": (q_tp, "data")}
    if cfg.qkv_bias:
        p.update(bq=(q_tp,), bk=(kv_tp,), bv=(kv_tp,))
    return p


def head_group(p: Attention, dist):
    """The model ranks' group when this rank computes a slice of the query
    heads (wq's columns split over them), else None."""
    return L.model_group(p, "wq", 1, dist)


def _qkv(cfg, p: Attention, x: torch.Tensor, dist=None):
    B, S = x.shape[:2]
    q = _project(cfg, p, x, ("q", "k", "v"), dist)
    return tuple(t.reshape(B, S, -1, cfg.dh) for t in q)


def _project(cfg, p: Attention, x: torch.Tensor, which, dist=None,
             bias: bool = True):
    """x . w<n> (+ b<n> with `cfg.qkv_bias` and `bias`) for each n of
    `which`, flat (B, S, heads * dh): with `dist` this rank's query heads
    where wq's columns are split (x through `to_model`), its KV heads where
    wk's are, else whole ones."""
    group = head_group(p, dist)
    kv_local = L.model_group(p, "wk", 1, dist) is not None
    xin = x if group is None else C.to_model(x, group)

    def w(leaf, local):
        t = L.weight(p, leaf, dist, local)
        # whole KV weights beside a slice of the query heads: each rank
        # adds only its heads' part of their gradient
        if group is not None and leaf[1] in "kv" and not kv_local:
            t = C.to_model(t, group)
        return t.to(x.dtype)

    out = [xin @ w(f"w{n}", (1,)) for n in which]
    if cfg.qkv_bias and bias:
        out = [t + w(f"b{n}", (0,)) for t, n in zip(out, which)]
    return out


def kv_for(cfg, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, dist):
    """k, v (B,S,Hkv',dh) cut to the KV heads this rank's query heads q
    (B,S,Hq',dh) read, so that the flash kernel's map (query head i reads
    KV head i // (Hq' / Hkv')) holds: unchanged when both are local
    slices or both whole; for a slice of the query heads against whole KV
    heads, the heads' whole groups, their one group, or one KV head a
    query head when the slice straddles a group boundary."""
    hq, hk = q.shape[2], k.shape[2]
    if hq == cfg.n_heads or hk != cfg.n_kv_heads:
        return k, v
    rep = cfg.n_heads // cfg.n_kv_heads
    first = dist.index(dist.tp_axis) * hq
    if hq % rep == 0:
        k, v = (t.narrow(2, first // rep, hq // rep) for t in (k, v))
    elif rep % hq == 0:
        k, v = (t.narrow(2, first // rep, 1) for t in (k, v))
    else:
        idx = torch.div(torch.arange(first, first + hq, device=k.device),
                        rep, rounding_mode="floor")
        k, v = k[:, :, idx], v[:, :, idx]
    return k.contiguous(), v.contiguous()


def out_proj(p: Attention, o: torch.Tensor, dist=None) -> torch.Tensor:
    """o (..., Hq'*dh) . wo: row-parallel over the model ranks (summed by
    `from_model`) when this rank holds a slice of the heads."""
    group = head_group(p, dist)
    w = L.weight(p, "wo", dist, () if group is None else (0,))
    y = o @ w.to(o.dtype)
    return y if group is None else C.from_model(y, group)


def qkv_at(cfg, p: Attention, x: torch.Tensor, positions: torch.Tensor,
           dist=None):
    """q (B,S,Hq,dh), k, v (B,S,Hkv,dh) of x (B,S,d) at `positions` (S,),
    RoPE applied to q and k when `cfg.rope_theta > 0`: the token-wise part
    of attention. With `dist` the heads this rank holds (Hq/tp query
    heads; Hkv/tp KV heads, or all of them where they do not divide)."""
    q, k, v = _qkv(cfg, p, x, dist)
    if cfg.rope_theta <= 0:
        return q, k, v
    cos, sin = L.rope_freqs(positions, cfg.dh, cfg.rope_theta)
    return L.apply_rope(q, cos, sin), L.apply_rope(k, cos, sin), v


def cross_q(cfg, p: Attention, x: torch.Tensor, dist=None) -> torch.Tensor:
    """q (B,S,Hq,dh) of a cross-attention: x . wq, plus bq with
    `cfg.qkv_bias`; no positions. With `dist` this rank's query heads
    where they are split."""
    q, = _project(cfg, p, x, ("q",), dist)
    return q.reshape(x.shape[0], x.shape[1], -1, cfg.dh)


def encoder_kv(cfg, p: Attention, enc_out: torch.Tensor, dist=None):
    """k, v (B,S_enc,Hkv,dh) of a cross-attention over the encoder's output
    (B,S_enc,d): enc_out . wk and enc_out . wv, without bias, as the
    reference builds them (`repro/models/model.py:474-477`). With `dist`
    the KV heads this rank holds (`_qkv`'s rule)."""
    B, S = enc_out.shape[:2]
    k, v = _project(cfg, p, enc_out, ("k", "v"), dist, bias=False)
    return (k.reshape(B, S, -1, cfg.dh), v.reshape(B, S, -1, cfg.dh))


def attention(cfg, p: Attention, x: torch.Tensor, *, window: int = 0,
              causal: bool = True, cross_kv=None, dist=None):
    """Attention over the whole sequence (prefill) through the flash
    kernel. Self-attention (positions 0..S-1, causal or not — whisper's
    encoder is not): returns (out (B,S,d), (k, v)) with k/v (B,S,Hkv,dh)
    after RoPE. Cross-attention, `cross_kv=(k, v)` (`encoder_kv`): q
    from x alone (`cross_q`) against those keys and values, with the
    `causal` mask the caller gives (whisper's decoder: False); returns
    (out, None). With `dist`, this rank's heads (`qkv_at`); k/v are the
    heads it holds."""
    if cross_kv is not None:
        q, (k, v) = cross_q(cfg, p, x, dist), cross_kv
        kv = None
    else:
        q, k, v = qkv_at(cfg, p, x, torch.arange(x.shape[1],
                                                 device=x.device), dist)
        kv = (k, v)
    ks, vs = kv_for(cfg, q, k, v, dist)
    out = flash_attention(q.contiguous(), ks.contiguous(), vs.contiguous(),
                          causal=causal, window=window)
    out = out.reshape(x.shape[0], x.shape[1], -1)
    return out_proj(p, out, dist), kv


def decode_attention(cfg, p: Attention, x: torch.Tensor, cache_k, cache_v,
                     pos: int, *, window: int = 0, cross: bool = False,
                     dist=None):
    """Single-token decode. cache_k/v (B, S_max, Hkv, dh); pos: the current
    position, the same for every row. Writes the new key and value at pos
    (pos % S_max when window > 0: a ring buffer) IN PLACE — the reference
    returns updated copies; the port saves copying the whole cache per
    token. With `cross=True` the caches are a cross-attention's keys and
    values of the encoder's output: q alone is projected, nothing is
    written, and every key is kept. Returns (out, cache_k, cache_v).
    With `dist`, the query heads this rank holds against the KV heads of
    the cache (this rank's, or whole ones mapped by `kv_for`: the cross
    cache is whole on every model rank)."""
    B = x.shape[0]
    if cross:
        q = cross_q(cfg, p, x, dist)
        ks, vs = kv_for(cfg, q, cache_k, cache_v, dist)
        out = flash_attention_plain(q, ks, vs, causal=False)
        return out_proj(p, out.reshape(B, 1, -1), dist), cache_k, cache_v
    q, k1, v1 = qkv_at(cfg, p, x, torch.tensor([pos], device=x.device),
                       dist)
    write = pos % cache_k.shape[1] if window > 0 else pos
    cache_k[:, write] = k1[:, 0].to(cache_k.dtype)
    cache_v[:, write] = v1[:, 0].to(cache_v.dtype)
    # a windowed ring cache holds only live slots within the window, and
    # k_pos <= pos masks the slots not written yet, so the causal mask is
    # right for the ring and the linear cache alike
    ks, vs = kv_for(cfg, q, cache_k, cache_v, dist)
    out = flash_attention_plain(q, ks, vs, causal=True, q_offset=pos)
    return out_proj(p, out.reshape(B, 1, -1), dist), cache_k, cache_v


def whole_qkv(cfg, p: Attention, x: torch.Tensor, pos: int, dist):
    """q (B,1,Hq,dh), k, v (B,1,Hkv,dh) of every head at position pos,
    every weight gathered whole on this rank (serving only)."""
    B = x.shape[0]
    w = {leaf: L.weight(p, leaf, dist).to(x.dtype)
         for leaf in ("wq", "wk", "wv", "bq", "bk", "bv")
         if hasattr(p, leaf)}
    q, k, v = x @ w["wq"], x @ w["wk"], x @ w["wv"]
    if cfg.qkv_bias:
        q, k, v = q + w["bq"], k + w["bk"], v + w["bv"]
    q, k, v = (t.reshape(B, 1, -1, cfg.dh) for t in (q, k, v))
    if cfg.rope_theta > 0:
        cos, sin = L.rope_freqs(torch.tensor([pos], device=x.device),
                                cfg.dh, cfg.rope_theta)
        q, k = L.apply_rope(q, cos, sin), L.apply_rope(k, cos, sin)
    return q, k, v


def decode_attention_seqsharded(cfg, p: Attention, x: torch.Tensor, cache_k,
                                cache_v, pos: int, dist, *, window: int = 0):
    """Decode over a KV cache whose sequence is split over "model" (the
    layout `models.model.cache_pspecs` gives when the KV heads do not
    divide tp) — the reference's `decode_attention_seqsharded`
    (`repro/models/attention.py:234-306`): every rank computes every
    head's q, the new key and value are written on the rank that owns
    position pos only, each rank computes its partial softmax (m, l, acc)
    over its 1/tp of the context, and the ranks merge their stats
    (all-gathers of B x Hq x (dh + 2) values, never of the cache). cache_k
    /v (B, S/tp, Hkv, dh), this rank's slots [r S/tp, (r+1) S/tp). With
    `window` > 0 the cache is a ring, as `decode_attention`'s: position
    pos goes to slot pos % S on the rank that holds it, and every slot
    written so far is kept. Returns (out, cache_k, cache_v), the cache
    written in place."""
    B = x.shape[0]
    group = dist.group(dist.tp_axis)
    q, k1, v1 = whole_qkv(cfg, p, x, pos, dist)
    r, s_loc = dist.index(dist.tp_axis), cache_k.shape[1]
    slot = pos % (s_loc * dist.tp) if window > 0 else pos
    local = slot - r * s_loc
    if 0 <= local < s_loc:
        cache_k[:, local] = k1[:, 0].to(cache_k.dtype)
        cache_v[:, local] = v1[:, 0].to(cache_v.dtype)
    hkv = cfg.n_kv_heads
    qg = q.float().reshape(B, hkv, cfg.n_heads // hkv, cfg.dh)
    s = torch.einsum("bgrd,bkgd->bgrk", qg, cache_k.float()) * cfg.dh ** -0.5
    k_pos = r * s_loc + torch.arange(s_loc, device=x.device)
    s = torch.where(k_pos <= pos, s, NEG_INF)
    m = s.amax(dim=-1)                                    # (B, G, rep)
    pexp = torch.exp(s - m[..., None])
    l = pexp.sum(dim=-1)
    acc = torch.einsum("bgrk,bkgd->bgrd", pexp, cache_v.float())
    stats = C.all_gather(torch.cat([m[..., None], l[..., None], acc], -1)
                         [None], 0, group)                # (tp, B, G, rep, dh+2)
    m_all, l_all, acc_all = stats[..., 0], stats[..., 1], stats[..., 2:]
    corr = torch.exp(m_all - m_all.amax(dim=0)[None])
    l_g = (l_all * corr).sum(dim=0)
    acc_g = (acc_all * corr[..., None]).sum(dim=0)
    out = (acc_g / torch.clamp(l_g, min=1e-20)[..., None]).reshape(
        B, 1, cfg.n_heads * cfg.dh).to(x.dtype)
    return out @ L.weight(p, "wo", dist).to(x.dtype), cache_k, cache_v
