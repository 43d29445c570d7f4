"""Superstep-boundary checkpoint/restart for the sharded kernels — the
port's copy of `repro.robust.recovery`.

The (p, S_B) layout of `core/tiling.py` runs one B-tile block per worker
per superstep, and the superstep barrier is a **consistent cut**: at
barrier s every worker has either fully executed its block
`block_perm[w, s]` or not touched it. A `CheckpointLog` records exactly
those facts, one `(worker, step)` entry per completed block; the schedule
itself is a pure function of `(costs, policy, p)` and rebuilds from its
inputs.

On k worker deaths, `plan_recovery` (surfaced as
`Schedule.reshard_survivors(dead=...)`):

1. collects every block NOT known complete from the checkpoint — the dead
   workers' lost blocks plus whatever anyone had not yet reached;
2. widens that set to whole **item-closed chains** (`block_chains`): a
   chain with any incomplete block is re-executed entirely, because its
   items' partial sums cannot be split across an old and a new worker
   without changing the fold order;
3. re-lowers the widened set onto the p-k survivors with the SAME
   `partition_tiles` LPT the original lowering used, producing a standard
   `WorkerShards` over the original flat payload: recovery runs the normal
   sharded kernels, just over fewer rows (on the card, p-k CTAs for the
   SpMV and BFS walks).

`RecoveryPlan.combine` merges the interrupted run's output with the
re-execution's: every item belongs to exactly one chain, so the selector
is a per-item mask. Each item is folded by exactly one worker in
ascending tile order in both pieces, so the combined output is
bit-identical to the fault-free run. The plans are host numpy over the
port's `core/tiling.py`; `combine` also takes the tensors the port's
kernels return and answers on their device.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Iterable, Optional, Union

import numpy as np
import torch

from repro_torch.core import tiling as T


@dataclasses.dataclass
class CheckpointLog:
    """Append-only record of completed (worker, superstep) blocks.

    `mark(w, s)` means "worker w's grid step s block finished" — written at
    the superstep barrier, so an entry is only ever appended for fully
    executed blocks. The log round-trips through JSON (the reference's
    `to_json` output reads back here) and ignores marks for padding steps,
    so `mark_through(w, n)` can blanket-mark a prefix."""

    entries: list = dataclasses.field(default_factory=list)

    def mark(self, worker: int, step: int) -> None:
        w, s = int(worker), int(step)
        if w < 0 or s < 0:
            raise ValueError(f"invalid checkpoint entry ({worker}, {step})")
        self.entries.append((w, s))

    def mark_through(self, worker: int, n_steps: int) -> None:
        """Worker completed grid steps 0..n_steps-1 (its position at the
        barrier where the run was interrupted)."""
        for s in range(int(n_steps)):
            self.mark(worker, s)

    def completed_blocks(self, shards: T.WorkerShards) -> np.ndarray:
        """Sorted block ids the log proves complete under `shards`."""
        done = set()
        for w, s in self.entries:
            if w < shards.p and s < shards.n_steps:
                b = int(shards.block_perm[w, s])
                if b >= 0:
                    done.add(b)
        return np.array(sorted(done), dtype=np.int64)

    def to_json(self) -> str:
        return json.dumps({"entries": [[int(w), int(s)]
                                       for w, s in self.entries]},
                          separators=(",", ":"))

    @classmethod
    def from_json(cls, blob: Union[str, dict]) -> "CheckpointLog":
        d = json.loads(blob) if isinstance(blob, str) else dict(blob)
        log = cls()
        for w, s in d.get("entries", ()):
            log.mark(w, s)
        return log


@dataclasses.dataclass(frozen=True)
class RecoveryPlan:
    """The re-lowering that finishes an interrupted sharded run.

    `done_shards` is the completed prefix as a partial layout over the
    ORIGINAL p workers (what the interrupted run's output provably
    contains); `shards` is the survivor re-execution layout over p_rec =
    p - k rows. Both index the original flat payload, so the standard
    sharded kernels run both without repacking. `redo_items` masks the
    items owned by re-executed chains — `combine` selects per item."""

    dead: tuple                # original worker ids lost
    survivors: tuple           # original worker ids still alive
    superstep: int             # B, unchanged from the original lowering
    keep_blocks: np.ndarray    # blocks of fully-complete chains (kept)
    redo_blocks: np.ndarray    # blocks re-executed on survivors
    lost_blocks: np.ndarray    # blocks not proven complete (pre-widening)
    shards: T.WorkerShards     # (p_rec, S_rec) survivor re-execution layout
    done_shards: T.WorkerShards  # (p, S_B) completed-prefix partial layout
    redo_items: np.ndarray     # bool (n_items,): owned by a redo chain

    @property
    def p_rec(self) -> int:
        return self.shards.p

    def combine(self, partial, recovered):
        """Merge per-item outputs: re-executed chains' items take the
        recovered value, completed chains' items keep the checkpointed
        one. Works for any per-item-leading-axis output (SpMV y, BFS
        frontier, K-Means assignments). Two tensors give a tensor on their
        device (`torch.where`); arrays give an array."""
        tensors = isinstance(partial, torch.Tensor) \
            or isinstance(recovered, torch.Tensor)
        if not tensors:
            partial = np.asarray(partial)
            recovered = np.asarray(recovered)
        if tuple(partial.shape) != tuple(recovered.shape):
            raise ValueError(f"cannot combine outputs of shapes "
                             f"{tuple(partial.shape)} and "
                             f"{tuple(recovered.shape)}")
        if partial.shape[0] != self.redo_items.size:
            raise ValueError(
                f"output leading axis {partial.shape[0]} does not match "
                f"{self.redo_items.size} items")
        shape = (-1,) + (1,) * (partial.ndim - 1)
        if not tensors:
            return np.where(self.redo_items.reshape(shape), recovered,
                            partial)
        if not (isinstance(partial, torch.Tensor)
                and isinstance(recovered, torch.Tensor)) \
                or partial.device != recovered.device:
            raise ValueError("combine takes two tensors on one device or "
                             "two arrays")
        mask = torch.from_numpy(self.redo_items).to(partial.device)
        return torch.where(mask.reshape(shape), recovered, partial)

    def makespan_model(self, tile_cost: np.ndarray) -> dict:
        """Barrier-time cost model for the recovered run: the completed
        prefix ran concurrently on all p workers (bounded by its slowest
        worker), then survivors execute the re-lowered remainder."""
        tile_cost = np.asarray(tile_cost, np.float64)
        t_done = float(self.done_shards.worker_cost(tile_cost).max(
            initial=0.0))
        t_redo = float(self.shards.worker_cost(tile_cost).max(initial=0.0))
        return {"t_done": t_done, "t_redo": t_redo,
                "makespan": t_done + t_redo}


def plan_recovery(tiles: T.TileSchedule, tile_cost: np.ndarray,
                  shards: T.WorkerShards, *, dead: Iterable[int],
                  checkpoint: Optional[CheckpointLog] = None) -> RecoveryPlan:
    """Build the survivor re-execution plan for an interrupted sharded run.

    Without a checkpoint the plan is worst-case: nothing is proven
    complete and every chain is re-executed on the survivors (a full
    restart at p-k, still bit-identical). See the module docstring for
    the widening argument."""
    tile_cost = np.asarray(tile_cost, np.float64)
    p, B = shards.p, shards.superstep
    Tn = int(shards.worker.size)
    n_blocks = -(-Tn // B)
    dead = tuple(sorted({int(w) for w in dead}))
    if any(w < 0 or w >= p for w in dead):
        raise ValueError(f"dead workers {dead} out of range for p={p}")
    survivors = tuple(w for w in range(p) if w not in dead)
    if not survivors:
        raise ValueError(f"all {p} workers dead: nothing can recover")

    done = (checkpoint.completed_blocks(shards) if checkpoint is not None
            else np.empty(0, np.int64))
    done_mask = np.zeros(n_blocks, dtype=bool)
    done_mask[done] = True
    lost = np.flatnonzero(~done_mask)

    # widen to item-closed chains: any chain with an incomplete block is
    # re-executed whole (its items' fold order cannot be split)
    chain = T.block_chains(tiles.item_id, B)
    redo_chains = np.unique(chain[lost]) if lost.size else np.empty(
        0, np.int64)
    redo_mask = np.isin(chain, redo_chains)
    redo = np.flatnonzero(redo_mask)
    keep = np.flatnonzero(~redo_mask)

    done_shards = _partial_layout(shards, keep, Tn, B)
    rec_shards = _relower(tiles, tile_cost, redo, len(survivors), Tn, B)

    # items owned by redo chains: the ids appearing in redo blocks' tiles
    redo_items = np.zeros(tiles.n_items, dtype=bool)
    if redo.size:
        idx = (redo[:, None] * B + np.arange(B)).reshape(-1)
        idx = idx[idx < Tn]
        ids = tiles.item_id[idx]
        redo_items[ids[ids >= 0]] = True

    return RecoveryPlan(dead=dead, survivors=survivors, superstep=B,
                        keep_blocks=keep, redo_blocks=redo,
                        lost_blocks=lost, shards=rec_shards,
                        done_shards=done_shards, redo_items=redo_items)


def _partial_layout(shards: T.WorkerShards, blocks: np.ndarray,
                    n_tiles: int, B: int) -> T.WorkerShards:
    """`shards` restricted to `blocks`: same rows, kept blocks at their
    original owner in their original ascending order."""
    keep_mask = np.zeros(-(-n_tiles // B), dtype=bool)
    keep_mask[blocks] = True
    bp = np.where((shards.block_perm >= 0)
                  & keep_mask[np.clip(shards.block_perm, 0, None)],
                  shards.block_perm, -1)
    # compact each row left so S_B shrinks to the longest kept row
    rows = [r[r >= 0] for r in bp]
    s_b = max((len(r) for r in rows), default=0) or 1
    out = np.full((shards.p, s_b), -1, np.int32)
    for w, r in enumerate(rows):
        out[w, :len(r)] = r
    return T.shards_from_block_perm(out, n_tiles, B)


def _relower(tiles: T.TileSchedule, tile_cost: np.ndarray,
             redo: np.ndarray, p_rec: int, n_tiles: int,
             B: int) -> T.WorkerShards:
    """Re-partition the redo blocks' tiles onto the survivors with the
    original `partition_tiles` LPT. The subset is processed in ascending
    block order, so subset block j IS original block redo[j] (only the
    final original block can be partial, and it sorts last); chains inside
    the subset coincide with the original chains because every redo chain
    is included whole."""
    if redo.size == 0:
        return T.shards_from_block_perm(
            np.full((p_rec, 1), -1, np.int32), n_tiles, B)
    idx = (redo[:, None] * B + np.arange(B)).reshape(-1)
    idx = idx[idx < n_tiles]
    sub_worker = T.partition_tiles(tile_cost[idx], tiles.item_id[idx],
                                   p_rec, block=B)
    block_w = sub_worker[::B]                       # per subset block
    counts = np.bincount(block_w, minlength=p_rec)
    s_rec = max(int(counts.max(initial=0)), 1)
    bp = np.full((p_rec, s_rec), -1, np.int32)
    order = np.argsort(block_w, kind="stable")      # ascending per worker
    w_sorted = block_w[order]
    pos = np.arange(order.size) - np.searchsorted(w_sorted, w_sorted)
    bp[w_sorted, pos] = redo[order].astype(np.int32)  # original block ids
    return T.shards_from_block_perm(bp, n_tiles, B)
