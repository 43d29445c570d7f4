"""Oracles for the iCh-scheduled MoE dispatch kernel, independent of the
schedule: the plan's expert-major CSR applied expert by expert."""
from __future__ import annotations

import torch


def moe_dispatch_ref(indptr, tok, w, x, wi, wg, wo) -> torch.Tensor:
    """y[t] += w_entry * FFN_e(x[t]) over every kept entry of every expert
    e of the CSR (indptr (E+1,), token ids, combine weights), with
    FFN_e(v) = (silu(v . wg[e]) * (v . wi[e])) . wo[e]. The entries are
    scattered with `index_add_`, so their order per token is not fixed."""
    tok = torch.as_tensor(tok).long()
    w = torch.as_tensor(w)
    y = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for e in range(len(indptr) - 1):
        lo, hi = int(indptr[e]), int(indptr[e + 1])
        if hi == lo:
            continue
        xs = x[tok[lo:hi]].to(torch.float32)
        a = torch.nn.functional.silu(xs @ wg[e]) * (xs @ wi[e])
        y.index_add_(0, tok[lo:hi], (a @ wo[e]) * w[lo:hi, None])
    return y


def expert_loads_ref(indptr) -> torch.Tensor:
    """Per-expert kept token counts straight off the CSR layout, int64."""
    return torch.diff(torch.as_tensor(indptr)).to(torch.int64)
