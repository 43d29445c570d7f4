"""Oracles for the iCh-scheduled SpMV kernels, independent of the tile
fold: a CSR product and a product over the packed tiles themselves (which
isolates packing bugs from kernel bugs)."""
from __future__ import annotations

import torch


def spmv_ref(indptr, indices, data, x) -> torch.Tensor:
    """CSR @ x by a per-row index sum. Tensors on any one device; the
    result has x's dtype."""
    indptr = torch.as_tensor(indptr)
    n = indptr.numel() - 1
    seg = torch.repeat_interleave(torch.arange(n, device=indptr.device),
                                  torch.diff(indptr))
    prod = torch.as_tensor(data) * x[torch.as_tensor(indices).long()]
    return torch.zeros(n, dtype=prod.dtype,
                       device=prod.device).index_add_(0, seg, prod)


def tiles_ref(vals, cols, rowid, x, n_rows: int) -> torch.Tensor:
    """Oracle on the packed-tile format: (T, R) slot partials summed into
    their rows."""
    partial = (vals * x[cols.long()]).sum(dim=2)
    valid = rowid >= 0
    y = torch.zeros(n_rows, dtype=partial.dtype, device=partial.device)
    return y.index_add_(0, rowid[valid].long(), partial[valid])
