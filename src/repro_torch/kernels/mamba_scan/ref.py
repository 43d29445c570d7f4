"""Oracle for the SSD scan, independent of chunking: the step-by-step
recurrence S_t = a_t S_{t-1} + k_t (x) v_t, y_t = q_t . S_t in float64."""
from __future__ import annotations

import torch


def ssd_sequential_ref(q, k, v, log_a, state=None):
    """q,k (B,S,H,N); v (B,S,H,Pd); log_a (B,S,H); state (B,H,N,Pd), the
    state before the first step, or None (zeros). Returns (y (B,S,H,Pd)
    float64, final state (B,H,N,Pd) float64)."""
    q, k, v, la = (t.double() for t in (q, k, v, log_a))
    B, S, H, N = q.shape
    st = (torch.zeros((B, H, N, v.shape[-1]), dtype=torch.float64,
                      device=q.device)
          if state is None else state.double())
    ys = []
    for t in range(S):
        st = st * torch.exp(la[:, t])[:, :, None, None] \
            + torch.einsum("bhn,bhp->bhnp", k[:, t], v[:, t])
        ys.append(torch.einsum("bhn,bhnp->bhp", q[:, t], st))
    return torch.stack(ys, 1), st
