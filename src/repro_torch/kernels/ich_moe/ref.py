"""Oracles for the iCh-scheduled MoE dispatch kernel and its backward,
independent of the schedule: the plan's expert-major CSR applied expert
by expert, and its gradient by autograd."""
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


def moe_dispatch_backward_ref(indptr, tok, w, x, wi, wg, wo, dy):
    """The gradient of `moe_dispatch_ref` by autograd, given y's gradient
    dy: (dx, dwi, dwg, dwo, dw) with dw the combine weights' gradient in
    CSR order — the oracle of the expert FFN's backward
    (`ich_moe_bwd.ich_moe_backward`)."""
    leaves = [t.detach().to(torch.float32).requires_grad_(True)
              for t in (x, wi, wg, wo, torch.as_tensor(w))]
    y = moe_dispatch_ref(indptr, tok, leaves[4], *leaves[:4])
    dx, dwi, dwg, dwo, dw = torch.autograd.grad(y, leaves, dy,
                                                allow_unused=True)
    return tuple(torch.zeros_like(t) if g is None else g
                 for g, t in zip((dx, dwi, dwg, dwo, dw), leaves))
