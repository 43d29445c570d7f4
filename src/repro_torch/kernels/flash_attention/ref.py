"""Oracle for the flash attention kernel, independent of its blocking:
K/V repeated to Hq width and the softmax taken over all keys (the port's
copy of `repro.kernels.flash_attention.ref.attention_ref`)."""
from __future__ import annotations

import torch


def attention_ref(q, k, v, *, causal: bool = True) -> torch.Tensor:
    """q (B,Sq,Hq,dh); k,v (B,Skv,Hkv,dh). float32 math; the causal mask
    aligns the last query with the last key."""
    B, Sq, Hq, dh = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    rep = Hq // Hkv
    if rep > 1:
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * dh ** -0.5
    if causal:
        keep = torch.ones((Sq, Skv), dtype=torch.bool,
                          device=q.device).tril(Skv - Sq)
        s = torch.where(keep, s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)
