"""Registry-backed kernel ops for the paper's three applications and MoE
expert dispatch — the port's `scheduler.build("spmv" | "bfs" | "kmeans" |
"moe-dispatch", ...)` — and the continuous batcher's "serve-prefill"
entry, whose op is the schedule itself (no kernel).

Each op binds a constructed `Schedule` to its workload once: it lowers the
schedule onto `schedule.p` workers (`Schedule.shard()`), packs the payload
(SpMV's vals/cols, BFS's all-ones mask/cols) into the flat (T_pad, R, W)
layout padded to whole supersteps (MoE: its plan's expert-major CSR of
token ids and combine weights), and keeps the payload, the sharded row
ids, the block ids and the per-slot cost stream on its device. Each call
runs the sharded kernel (the CUDA kernel on the card, its plain version on
the CPU), which also emits the (p, S_B) cost stream; the op stashes it as
`last_costs`, and `op.observe()` folds it into the schedule's refiner,
after which `.refine()` re-lowers under a fresh cache generation.
Per-worker sums of the stream equal the schedule's per-worker tile-cost
totals (exactly for integer costs; K-Means' float costs to rounding).

* `SpmvOp` — `op(x)`: segmented CSR SpMV (`ich_spmv_sharded`);
* `BfsOp` — `op.step(frontier, visited)` and `op.levels(source)`:
  pull-direction BFS (`ich_bfs_step_sharded`); `levels` keeps frontier,
  visited and levels on the op's device and syncs once per level;
* `KMeansOp` — `op(points, centroids)`: nearest-centroid ids
  (`ich_kmeans_assign_sharded`), whose row ids and slot costs are laid out
  in the shard layout itself (no flat payload, no block ids);
* `MoeDispatchOp` — `op(x, wi, wg, wo)`: the gated expert FFN of a
  `DispatchPlan` (`ich_moe_sharded`), combined per token; besides the
  (p, S_B) stream it keeps the (p, E) per-expert costs as
  `last_expert_costs`, and `expert_load()` worker-sums them into the
  measured per-expert load that `sched.moe.refine_cap_scale` turns into
  the next plan's capacity scale.

An empty workload (0 tiles; for MoE also 0 tokens) lowers as a no-op: no
launch, a zero output and all-zero cost streams of the layout's shape.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.tiling import WorkerShards, pack_csr
from repro_torch.device import resolve_device
from repro_torch.kernels.ich_bfs.ich_bfs import ich_bfs_step_sharded
from repro_torch.kernels.ich_kmeans.ich_kmeans import \
    ich_kmeans_assign_sharded
from repro_torch.kernels.ich_moe.ich_moe import ich_moe_sharded, moe_slots
from repro_torch.kernels.ich_spmv.ich_spmv import ich_spmv_sharded

from .api import Schedule
from .costs import (DegreeCosts, ExpertLoadCosts, ExplicitCosts, NnzCosts,
                    RemainingTokensCosts)
from .registry import register


def _flat_slot_cost(slot_cost: np.ndarray,
                    n_tiles_padded: int) -> np.ndarray:
    """The (T_pad, R) float32 per-slot cost stream the sharded SpMV/BFS
    kernels read blockwise (pad tiles carry zeros)."""
    sc = np.zeros((n_tiles_padded, slot_cost.shape[1]), np.float32)
    sc[:slot_cost.shape[0]] = slot_cost
    return sc


def _sharded_slot_cost(slot_cost: np.ndarray,
                       shards: WorkerShards) -> np.ndarray:
    """The (p*S, R) per-slot cost stream in SHARD layout for the K-Means
    kernel, which has no flat-payload indirection; padding rows are
    zero."""
    flat = shards.perm.reshape(-1)
    if slot_cost.shape[0] == 0:  # 0-tile schedule: all rows are padding
        return np.zeros((flat.size, slot_cost.shape[1]), np.float32)
    out = np.where((flat >= 0)[:, None],
                   slot_cost[np.clip(flat, 0, None)], 0.0)
    return np.ascontiguousarray(out, np.float32)


def _check_targets(cols: np.ndarray, n: int) -> None:
    """The kernels gather frontier[cols] unchecked: every target must be a
    vertex."""
    if cols.size and (int(cols.min()) < 0 or int(cols.max()) >= n):
        raise ValueError(f"edge targets must lie in [0, {n}), got "
                         f"[{int(cols.min())}, {int(cols.max())}]")


class _ObservableOp:
    """What every op shares: its lowering's arrays on its device, the
    0-tile no-op, and the feedback plumbing that routes the kernel's
    latest cost stream into the schedule's refiner."""

    schedule: Optional[Schedule]
    shards: WorkerShards
    device: torch.device
    n_tiles: int
    last_costs = None  # (p, S_B) stream of the latest call

    def _lower(self, schedule, shards, n_tiles, device) -> None:
        self.schedule = schedule
        self.shards = shards
        self.n_tiles = int(n_tiles)
        self.p = shards.p
        self.superstep = shards.superstep
        self.device = device
        self.last_costs = None

    def _put_flat_lowering(self, item_id, slot_cost) -> None:
        """Row ids, block ids and the (T_pad, R) slot-cost stream of a
        flat-payload kernel (SpMV, BFS), on the op's device."""
        self.rowid = self._put(self.shards.shard_item_id(item_id), np.int32)
        self.blkid = self._put(self.shards.kernel_block_ids(), np.int32)
        self.slot_cost = self._put(
            _flat_slot_cost(slot_cost, self.shards.n_tiles_padded),
            np.float32)

    def _put(self, a, dtype) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(
            self.device)

    def _input(self, name: str, a, dtype) -> torch.Tensor:
        """An argument as a tensor on the op's device: arrays are copied
        there, tensors must already lie there."""
        if not isinstance(a, torch.Tensor):
            return torch.as_tensor(np.asarray(a, dtype), device=self.device)
        if a.device.type != self.device.type:
            raise ValueError(f"{name} lies on {a.device}, the op on "
                             f"{self.device}")
        return a

    def _noop(self, shape, dtype) -> torch.Tensor:
        """An empty workload lowers as a no-op: no launch, zero output,
        an all-zero cost stream of the layout's shape."""
        self.last_costs = torch.zeros(self.shards.block_perm.shape,
                                      dtype=torch.float32, device=self.device)
        return torch.zeros(shape, dtype=dtype, device=self.device)

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


class SpmvOp(_ObservableOp):
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
        self._lower(schedule, shards, item_id.shape[0], device)
        self.n_rows = n_rows
        self.n_cols = n_cols  # x must hold at least this many entries
        self.width = width
        self.vals = self._put(vals, np.float32)
        self.cols = self._put(cols, np.int32)
        self._put_flat_lowering(item_id, slot_cost)

    def __call__(self, x) -> torch.Tensor:
        """y = A @ x on the op's device. x is a float32 tensor on that
        device, or an array that is copied there."""
        x = self._input("x", x, np.float32)
        if x.ndim != 1 or x.numel() < self.n_cols:
            raise ValueError(f"x must be 1-D with at least {self.n_cols} "
                             f"entries, got shape {tuple(x.shape)}")
        if self.n_tiles == 0:
            return self._noop(self.n_rows, torch.float32)
        y, self.last_costs = ich_spmv_sharded(
            self.vals, self.cols, self.rowid, self.blkid, x, self.n_rows,
            self.p, self.superstep, slot_cost=self.slot_cost)
        return y


class BfsOp(_ObservableOp):
    """iCh-scheduled pull-direction BFS: pack the graph once (row u of the
    CSR lists u's in-neighbors), expand frontiers many times."""

    def __init__(self, schedule: Schedule, indptr, indices, *, device=None):
        indptr = np.asarray(indptr)
        indices = np.asarray(indices)
        n = len(indptr) - 1
        if schedule.n_items != n:
            raise ValueError(f"schedule has {schedule.n_items} items but the "
                             f"graph has {n} vertices")
        shards = schedule.shard()
        mask, cols = pack_csr(indptr, indices,
                              np.ones(len(indices), np.float32),
                              schedule.tiles, pad_tiles_to=shards.superstep)
        self._bind(schedule.item_id, shards, mask, cols,
                   schedule.slot_cost(), n, resolve_device(device), schedule)

    @classmethod
    def from_lowering(cls, item_id: np.ndarray, shards: WorkerShards,
                      mask: np.ndarray, cols: np.ndarray,
                      slot_cost: np.ndarray, n_vertices: int, *, device=None,
                      schedule: Optional[Schedule] = None) -> "BfsOp":
        """An op over an explicit lowering: the (T, R) tile vertex ids, its
        worker shards, the packed (T_pad, R, W) mask/cols and the (T, R)
        or (T_pad, R) slot-cost stream (`repro_torch.convert` builds one
        from the reference's lowering). `observe()` needs `schedule`."""
        op = cls.__new__(cls)
        op._bind(np.asarray(item_id), shards, mask, cols,
                 np.asarray(slot_cost), int(n_vertices),
                 resolve_device(device), schedule)
        return op

    def _bind(self, item_id, shards, mask, cols, slot_cost, n, device,
              schedule) -> None:
        _check_targets(np.asarray(cols), n)
        self._lower(schedule, shards, item_id.shape[0], device)
        self.n = n
        self.mask = self._put(mask, np.float32)
        self.cols = self._put(cols, np.int32)
        self._put_flat_lowering(item_id, slot_cost)

    def step(self, frontier, visited) -> torch.Tensor:
        """One frontier expansion: (n,) float32 0/1 indicators in (tensors
        on the op's device, or arrays copied there), the next frontier
        out."""
        frontier = self._input("frontier", frontier, np.float32)
        visited = self._input("visited", visited, np.float32)
        for name, t in (("frontier", frontier), ("visited", visited)):
            if tuple(t.shape) != (self.n,):
                raise ValueError(f"{name} must have shape ({self.n},), got "
                                 f"{tuple(t.shape)}")
        if self.n_tiles == 0:
            return self._noop(self.n, torch.float32)
        nxt, self.last_costs = ich_bfs_step_sharded(
            self.mask, self.cols, self.rowid, self.blkid, frontier, visited,
            self.n, self.p, self.superstep, slot_cost=self.slot_cost)
        return nxt

    def levels(self, source: int = 0) -> torch.Tensor:
        """Full traversal from `source`: (n,) int32 level per vertex
        (-1 = unreached) on the op's device. Frontier, visited and levels
        stay there; the loop syncs once per level, to test the frontier.
        `last_costs` is the last level's stream (a degree-cost stream does
        not depend on the frontier)."""
        level = torch.full((self.n,), -1, dtype=torch.int32,
                           device=self.device)
        level[source] = 0
        frontier = torch.zeros(self.n, dtype=torch.float32,
                               device=self.device)
        frontier[source] = 1.0
        visited = frontier.clone()
        depth = 0
        while bool(frontier.any()):
            nxt = self.step(frontier, visited)
            depth += 1
            # torch.where, not a masked store: that would sync again
            level = torch.where(nxt > 0, depth, level)
            visited = torch.maximum(visited, nxt)
            frontier = nxt
        return level


class KMeansOp(_ObservableOp):
    """iCh-scheduled K-Means assignment over a predicted per-point cost:
    lower once, assign many times."""

    def __init__(self, schedule: Schedule, costs, *, device=None):
        # `costs` are the per-point costs the schedule was built from: the
        # registry hands every op its raw inputs, and this one needs only
        # the schedule
        shards = schedule.shard()
        self._bind(schedule.item_id, shards,
                   _sharded_slot_cost(schedule.slot_cost(), shards),
                   schedule.n_items, resolve_device(device), schedule)

    @classmethod
    def from_lowering(cls, item_id: np.ndarray, shards: WorkerShards,
                      slot_cost: np.ndarray, n_points: int, *, device=None,
                      schedule: Optional[Schedule] = None) -> "KMeansOp":
        """An op over an explicit lowering: the (T, R) tile point ids, its
        worker shards and the (p*S, R) slot-cost stream in the SHARD layout
        (`repro_torch.convert` builds one from the reference's lowering).
        `observe()` needs `schedule`."""
        op = cls.__new__(cls)
        op._bind(np.asarray(item_id), shards, np.asarray(slot_cost),
                 int(n_points), resolve_device(device), schedule)
        return op

    def _bind(self, item_id, shards, slot_cost, n, device, schedule) -> None:
        self._lower(schedule, shards, item_id.shape[0], device)
        self.n = n
        self.rowid = self._put(shards.shard_item_id(item_id), np.int32)
        if slot_cost.shape != tuple(self.rowid.shape):
            raise ValueError(f"slot_cost {slot_cost.shape} must have the "
                             f"shard layout's shape {tuple(self.rowid.shape)}")
        self.slot_cost = self._put(slot_cost, np.float32)

    def __call__(self, points, centroids) -> torch.Tensor:
        """(n,) int32 nearest-centroid id of every point: points (n, D) and
        centroids (K, D) float32, tensors on the op's device or arrays
        copied there."""
        points = self._input("points", points, np.float32)
        centroids = self._input("centroids", centroids, np.float32)
        if points.ndim != 2 or points.shape[0] != self.n:
            raise ValueError(f"points must be ({self.n}, D), got "
                             f"{tuple(points.shape)}")
        if self.n_tiles == 0:
            return self._noop(self.n, torch.int32)
        ids, self.last_costs = ich_kmeans_assign_sharded(
            points, centroids, self.rowid, self.p, self.superstep,
            slot_cost=self.slot_cost)
        return ids


class MoeDispatchOp(_ObservableOp):
    """iCh-scheduled MoE expert application: pack a dispatch plan once,
    apply the expert FFN stack many times.

    The plan's expert-major CSR (token ids + combine weights per expert)
    packs through the same `pack_csr` path as SpMV — expert = item, a hot
    expert's tokens split across slot rows like a heavy row — and runs on
    the sharded `ich_moe_sharded` kernel, which also returns the (p, E)
    per-worker per-expert costs (`last_expert_costs`)."""

    def __init__(self, schedule: Schedule, plan, *, device=None):
        shards = schedule.shard()
        indptr, tok, w = plan.csr()
        vals, cols = pack_csr(indptr, tok, w, schedule.tiles,
                              pad_tiles_to=shards.superstep)
        self._bind(schedule.item_id, shards, vals, cols,
                   schedule.slot_cost(), plan.counts, plan.n_tokens,
                   resolve_device(device), schedule)

    @classmethod
    def from_lowering(cls, item_id: np.ndarray, shards: WorkerShards,
                      vals: np.ndarray, cols: np.ndarray,
                      slot_cost: np.ndarray, counts: np.ndarray,
                      n_tokens: int, *, device=None,
                      schedule: Optional[Schedule] = None
                      ) -> "MoeDispatchOp":
        """An op over an explicit lowering: the (T, R) tile expert ids, its
        worker shards, the packed (T_pad, R, W) combine weights and token
        ids, the (T, R) or (T_pad, R) slot-cost stream and the plan's
        per-expert kept token counts, which the CSR was laid out with
        (`repro_torch.convert` builds one from the reference's lowering).
        `observe()` needs `schedule`."""
        op = cls.__new__(cls)
        op._bind(np.asarray(item_id), shards, vals, cols,
                 np.asarray(slot_cost), np.asarray(counts), int(n_tokens),
                 resolve_device(device), schedule)
        return op

    def _bind(self, item_id, shards, vals, cols, slot_cost, counts,
              n_tokens, device, schedule) -> None:
        self._lower(schedule, shards, item_id.shape[0], device)
        self.n_tokens = n_tokens
        self.n_experts = int(counts.size)
        self.vals = self._put(vals, np.float32)
        self.cols = self._put(cols, np.int32)
        self._put_flat_lowering(item_id, slot_cost)
        self.slots = moe_slots(item_id, counts, np.asarray(cols), n_tokens,
                               device)
        self.last_expert_costs = None  # (p, E) of the latest call

    def __call__(self, x, wi, wg, wo) -> torch.Tensor:
        """y (n_tokens, D) float32 on the op's device: x (n_tokens, D)
        token activations, wi/wg (E, D, F) and wo (E, F, D) expert FFN
        weights, float32 tensors on the op's device or arrays copied
        there."""
        x = self._input("x", x, np.float32)
        wi, wg, wo = (self._input(n, a, np.float32)
                      for n, a in (("wi", wi), ("wg", wg), ("wo", wo)))
        if x.ndim != 2 or x.shape[0] != self.n_tokens:
            raise ValueError(f"x must be ({self.n_tokens}, D), got "
                             f"{tuple(x.shape)}")
        D = x.shape[1]
        if wi.ndim != 3 or wi.shape[:2] != (self.n_experts, D) \
                or wg.shape != wi.shape \
                or tuple(wo.shape) != (self.n_experts, wi.shape[2], D):
            raise ValueError(
                f"expert weights must be wi/wg ({self.n_experts}, {D}, F) "
                f"and wo ({self.n_experts}, F, {D}), got {tuple(wi.shape)}, "
                f"{tuple(wg.shape)}, {tuple(wo.shape)}")
        # 0 tokens is a no-op too: a zero-admission plan still has one
        # tile per (zero-count) expert, but no token to gather
        if self.n_tiles == 0 or self.n_tokens == 0:
            self.last_expert_costs = torch.zeros(
                (self.p, self.n_experts), dtype=torch.float32,
                device=self.device)
            return self._noop((self.n_tokens, D), torch.float32)
        y, self.last_costs, self.last_expert_costs = ich_moe_sharded(
            self.vals, self.cols, self.rowid, self.blkid, x, wi, wg, wo,
            self.p, self.superstep, self.slots, slot_cost=self.slot_cost)
        return y

    def expert_load(self) -> np.ndarray:
        """Measured per-expert cost totals of the latest call, worker-summed
        into an (E,) float64 array: the plan's kept token counts, exactly;
        what `refine_cap_scale` consumes."""
        if self.last_expert_costs is None:
            raise ValueError("no kernel invocation to read yet; run the "
                             "op first")
        return self.last_expert_costs.cpu().numpy().astype(
            np.float64).sum(axis=0)


register(
    "spmv",
    costs=lambda indptr, indices, data: NnzCosts(indptr),
    build=SpmvOp,
    doc="Segmented CSR SpMV; inputs (indptr, indices, data); cost = row nnz.")
register(
    "bfs",
    costs=lambda indptr, indices: DegreeCosts(indptr),
    build=BfsOp,
    doc="Pull-direction BFS; inputs (indptr, indices); cost = in-degree.")
register(
    "kmeans",
    # float64 coercion keeps the provider on its quantizing path (ceil, >= 1
    # unit per point) for integer inputs too — every point must be computed
    costs=lambda costs: ExplicitCosts(np.asarray(costs, np.float64)),
    build=KMeansOp,
    doc="K-Means assignment; input (predicted per-point costs).")
register(
    "moe-dispatch",
    costs=lambda plan: ExpertLoadCosts(plan.counts),
    build=MoeDispatchOp,
    doc="MoE expert FFN over a dispatch plan (sched/moe.py); input "
        "(DispatchPlan); cost = per-expert kept token load.")
register(
    "serve-prefill",
    costs=lambda remaining: RemainingTokensCosts(
        np.asarray(remaining, np.int64)),
    # there is no kernel here: the "op" IS the schedule — the continuous
    # batcher (serve/batcher.py) consumes its cost estimates and tile
    # order to pick the next prefill target, and routes measured step
    # wall-clock back through Schedule.observe/refine (DESIGN.md §2.10)
    build=lambda schedule, remaining, device=None: schedule,
    doc="Continuous-batching prefill scheduling; input (per-request "
        "remaining prompt token counts); cost = remaining tokens.")
