"""Registry-backed kernel op for the SpMV workload — the port's
`scheduler.build("spmv", indptr, indices, data)`.

`SpmvOp` binds a constructed `Schedule` to a CSR matrix once: it lowers the
schedule onto `schedule.p` workers (`Schedule.shard()`), packs the payload
into the flat (T_pad, R, W) layout padded to whole supersteps, and keeps
vals, cols, the sharded row ids, the block ids and the per-slot cost stream
on its device. Each call runs `ich_spmv_sharded` (the CUDA kernel on the
card, its plain version on the CPU), which also emits the (p, S_B) cost
stream; the op stashes it as `last_costs`, and `op.observe()` folds it
into the schedule's refiner, after which `.refine()` re-lowers under a
fresh cache generation. Per-worker sums of the stream equal the
schedule's per-worker tile-cost totals exactly.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.tiling import WorkerShards, pack_csr
from repro_torch.device import resolve_device
from repro_torch.kernels.ich_spmv.ich_spmv import ich_spmv_sharded

from .api import Schedule
from .costs import NnzCosts
from .registry import register


def _flat_slot_cost(slot_cost: np.ndarray,
                    n_tiles_padded: int) -> np.ndarray:
    """The (T_pad, R) float32 per-slot cost stream the sharded kernel
    reads blockwise (pad tiles carry zeros)."""
    sc = np.zeros((n_tiles_padded, slot_cost.shape[1]), np.float32)
    sc[:slot_cost.shape[0]] = slot_cost
    return sc


class SpmvOp:
    """iCh-scheduled segmented CSR SpMV: pack once, apply many times."""

    def __init__(self, schedule: Schedule, indptr, indices, data, *,
                 device=None):
        indptr = np.asarray(indptr)
        indices = np.asarray(indices)
        n_rows = len(indptr) - 1
        if schedule.n_items != n_rows:
            raise ValueError(f"schedule has {schedule.n_items} items but the "
                             f"matrix has {n_rows} rows")
        shards = schedule.shard()
        vals, cols = pack_csr(indptr, indices,
                              np.asarray(data, np.float32), schedule.tiles,
                              pad_tiles_to=shards.superstep)
        self._bind(schedule.item_id, shards, vals, cols,
                   schedule.slot_cost(), n_rows, schedule.width,
                   int(indices.max()) + 1 if indices.size else 0,
                   resolve_device(device), schedule)

    @classmethod
    def from_lowering(cls, item_id: np.ndarray, shards: WorkerShards,
                      vals: np.ndarray, cols: np.ndarray,
                      slot_cost: np.ndarray, n_rows: int, *, device=None,
                      schedule: Optional[Schedule] = None) -> "SpmvOp":
        """An op over an explicit lowering: the (T, R) tile item ids, its
        worker shards, the packed (T_pad, R, W) payload and the (T, R) or
        (T_pad, R) slot-cost stream (`repro_torch.convert` builds one from
        the reference's lowering). `observe()` needs `schedule`."""
        op = cls.__new__(cls)
        width = int(np.asarray(vals).shape[2])
        n_cols = int(np.asarray(cols).max()) + 1 if np.asarray(cols).size \
            else 0
        op._bind(np.asarray(item_id), shards, vals, cols,
                 np.asarray(slot_cost), int(n_rows), width, n_cols,
                 resolve_device(device), schedule)
        return op

    def _bind(self, item_id, shards, vals, cols, slot_cost, n_rows, width,
              n_cols, device, schedule) -> None:
        self.schedule = schedule
        self.shards = shards
        self.n_rows = n_rows
        self.n_cols = n_cols  # x must hold at least this many entries
        self.n_tiles = int(item_id.shape[0])
        self.width = width
        self.p = shards.p
        self.superstep = shards.superstep
        self.device = device

        def put(a, dtype):
            return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(device)

        self.vals = put(vals, np.float32)
        self.cols = put(cols, np.int32)
        self.rowid = put(shards.shard_item_id(item_id), np.int32)
        self.blkid = put(shards.kernel_block_ids(), np.int32)
        self.slot_cost = put(_flat_slot_cost(slot_cost,
                                             shards.n_tiles_padded),
                             np.float32)
        self.last_costs = None  # (p, S_B) stream of the latest call

    def __call__(self, x) -> torch.Tensor:
        """y = A @ x on the op's device. x is a float32 tensor on that
        device, or an array that is copied there."""
        if not isinstance(x, torch.Tensor):
            x = torch.as_tensor(np.asarray(x, np.float32), device=self.device)
        if x.device.type != self.device.type:
            raise ValueError(f"x lies on {x.device}, the op on {self.device}")
        if x.ndim != 1 or x.numel() < self.n_cols:
            raise ValueError(f"x must be 1-D with at least {self.n_cols} "
                             f"entries, got shape {tuple(x.shape)}")
        if self.n_tiles == 0:
            # an empty workload lowers as a no-op: no launch, zero output,
            # an all-zero cost stream of the layout's shape
            self.last_costs = torch.zeros(self.shards.block_perm.shape,
                                          dtype=torch.float32,
                                          device=self.device)
            return torch.zeros(self.n_rows, dtype=torch.float32,
                               device=self.device)
        y, self.last_costs = ich_spmv_sharded(
            self.vals, self.cols, self.rowid, self.blkid, x, self.n_rows,
            self.p, self.superstep, slot_cost=self.slot_cost)
        return y

    def observe(self) -> Schedule:
        """Fold the latest call's per-worker, per-superstep cost stream into
        `schedule.refiner`; chain with ``op.observe().refine()``. The op
        names its own shard lowering explicitly."""
        if self.last_costs is None:
            raise ValueError("no kernel invocation to observe yet; run the "
                             "op first")
        if self.schedule is None:
            raise ValueError("this op was built from a bare lowering and "
                             "has no schedule to refine")
        return self.schedule.observe(self.last_costs, shards=self.shards)


register(
    "spmv",
    costs=lambda indptr, indices, data: NnzCosts(indptr),
    build=SpmvOp,
    doc="Segmented CSR SpMV; inputs (indptr, indices, data); cost = row nnz.")
