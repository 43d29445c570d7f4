"""The segmented-reduction epilogue of the iCh kernels, as plain PyTorch.

Every tile computes one value per segment slot and folds those R values
into the output at the rows its schedule names; several slots may name the
same row (a split item contributes several segments, possibly within one
tile or across consecutive tiles). The reference (`repro.core.segmented`)
does this on the TPU with a length-R window read-modify-write per tile,
which relies on grid steps running in order on one core.

On the card the CUDA kernels (`csrc/segmented.cuh`, shared by
`csrc/ich_spmv.cu`, `ich_bfs.cu`, `ich_kmeans.cu` and, for its step
costs, `ich_moe.cu`) do the same fold in a
fixed order, and this module is its plain twin, vectorized over a batch of
tiles:

* `segment_sum` — within each tile, the same-row slots are folded in
  ascending slot order (the reference's one-hot `segment_sum`, in one
  fixed order, with add or, for the max-based combines, max);
* `segmented_apply` — each tile's per-row values are folded into the
  output in ascending tile order (the reference's `segmented_apply_batch`)
  under one of three combines: "add" (SpMV partial sums), "max" (BFS
  frontier OR) and "store" (K-Means assignment: the tile's per-row max
  replaces the row, later tiles winning). Only the rows the slots name are
  written: the reference's window write-back also rewrites uncovered
  window rows, which on a card whose CTAs run concurrently would race the
  row's owning worker, so no window (`slot_window`) is formed at all;
* `emit_step_cost` — one superstep's executed cost, slots with row -1
  masked out (padding steps read a clamped block);
* `longest_run` — the most slots one row holds in a row of consecutive
  slots of the flat stream: the serial part of the flat kernels' fold,
  where each row's run is folded by one thread;
* `worker_reduce` — the fixed-order pairwise tree over (p, n) per-worker
  accumulators: add for "add", maximum for "max" and for "store" (lowered
  to max over the zero-initialized identity, as the reference does).
  Exact in any order because the shard partition is item-closed: each row
  was accumulated by one worker from +0.0 (never -0.0) and every other
  worker holds +0.0 there; max and store values are >= 0.
"""
from __future__ import annotations

import torch

COMBINES = ("add", "max", "store")


def segment_sum(values: torch.Tensor, rows: torch.Tensor, *,
                op=torch.add) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-tile sums of same-row slots, for (N, R) slot `values` and row
    ids `rows` (-1 = padding). Returns `(group, last)`: `group[t, j]` is
    the left fold with `op`, in slot order, of the run of slots of tile t
    that share slot j's row and end at j; `last[t, j]` marks the final
    slot of each run on a real row, so `group[last]` are the tile's
    per-row sums in (tile, slot) order. A tile's same-row slots are
    consecutive because construction emits segments in item order."""
    group = values.clone()
    for j in range(1, rows.shape[1]):
        same = rows[:, j] == rows[:, j - 1]
        group[:, j] = torch.where(same, op(group[:, j - 1], values[:, j]),
                                  values[:, j])
    last = rows >= 0
    last[:, :-1] &= rows[:, 1:] != rows[:, :-1]
    return group, last


def segmented_apply(out: torch.Tensor, rows: torch.Tensor,
                    values: torch.Tensor, *,
                    combine: str = "add") -> torch.Tensor:
    """Fold N tiles of (R,) slot values into the 1-D `out`, in place, in
    ascending tile order. Per tile and row r, with `s` the fold of the
    tile's slots on r: "add" sets `out[r] = out[r] + s` (slots summed),
    "max" sets `out[r] = max(out[r], s)` and "store" sets `out[r] = s`
    (slots maxed, so a later tile's value wins). Returns `out`."""
    if combine not in COMBINES:
        raise ValueError(f"combine must be one of {COMBINES}, got {combine!r}")
    group, last = segment_sum(
        values, rows, op=torch.add if combine == "add" else torch.maximum)
    r = rows[last].long()
    g = group[last].to(out.dtype)
    if r.numel() == 0:
        return out
    if combine == "max":
        # max is exact in any order
        return out.scatter_reduce_(0, r, g, reduce="amax", include_self=True)
    if combine == "store":
        # the last contribution to each row, in (tile, slot) order, wins
        pos = torch.arange(r.numel(), device=r.device)
        final = torch.full_like(out, -1, dtype=torch.long).scatter_reduce_(
            0, r, pos, reduce="amax")
        sel = pos == final[r]
        out[r[sel]] = g[sel]
        return out
    # rank of each contribution among its row's, in fold order; ranks are
    # applied one at a time so each row's sums land in tile order
    order = torch.argsort(r, stable=True)
    r_sorted = r[order]
    pos = torch.arange(r.numel(), device=r.device)
    head = torch.ones_like(r_sorted, dtype=torch.bool)
    head[1:] = r_sorted[1:] != r_sorted[:-1]
    start = torch.cummax(torch.where(head, pos, 0), dim=0).values
    rank = pos - start
    for k in range(int(rank.max()) + 1):
        sel = order[rank == k]
        rr = r[sel]  # distinct rows: no two writes to one row in a pass
        out[rr] = out[rr] + g[sel]
    return out


def emit_step_cost(rows: torch.Tensor,
                   slot_cost: torch.Tensor) -> torch.Tensor:
    """Executed cost per superstep: (S, K) row ids and slot costs of S
    supersteps of K = B*R slots each -> (S,) float32, the left fold in slot
    order of the costs of slots whose row is >= 0. Padding steps read a
    clamped block whose rows are all -1, so they emit 0."""
    acc = torch.zeros(rows.shape[0], dtype=torch.float32,
                      device=slot_cost.device)
    zero = torch.zeros((), dtype=torch.float32, device=slot_cost.device)
    for k in range(rows.shape[1]):
        acc = acc + torch.where(rows[:, k] >= 0, slot_cost[:, k], zero)
    return acc


def longest_run(rows: torch.Tensor) -> int:
    """Slots in the longest run of one row (>= 0) over the flat slot
    stream `rows` (any shape, read in C order, across tile boundaries);
    0 when every slot is padding."""
    r = rows.reshape(-1)
    if r.numel() == 0:
        return 0
    head = torch.ones_like(r, dtype=torch.bool)
    head[1:] = r[1:] != r[:-1]
    starts = torch.nonzero(head).flatten()
    ends = torch.cat([starts[1:], starts.new_tensor([r.numel()])])
    lengths = (ends - starts)[r[starts] >= 0]
    return int(lengths.max()) if lengths.numel() else 0


def worker_reduce(acc: torch.Tensor, combine: str = "add") -> torch.Tensor:
    """Fold (p, n) per-worker accumulators into the final (n,) output with
    a pairwise tree over the worker axis: add for "add", maximum for "max"
    and "store"."""
    if combine not in COMBINES:
        raise ValueError(f"combine must be one of {COMBINES}, got {combine!r}")
    op = torch.add if combine == "add" else torch.maximum
    parts = list(acc.unbind(0))
    while len(parts) > 1:
        folded = [op(parts[i], parts[i + 1])
                  for i in range(0, len(parts) - 1, 2)]
        if len(parts) % 2:
            folded.append(parts[-1])
        parts = folded
    return parts[0]
