"""Measured-cost feedback: fold observed execution costs into refreshed
per-item estimates — the port's copy of `repro.sched.adaptive`.

The paper's iCh adapts chunk size *during* a loop from the running
mean/deviation band of observed progress (§3.2, eqs. 4-8). Here the
schedule is constructed ahead of time, so the same signal closes the loop
ACROSS invocations: the sharded kernel emits a per-worker, per-superstep
cost stream (`sched/kernels.py`), `CostRefiner` distributes it down to
items proportionally to the current estimates and folds one Welford
sample per covered item (`core/welford.WelfordVec`), `refined_costs()`
blends the running means with the priors, and `Schedule.refine()`
re-partitions from the result under a fresh cache generation. The host
layers feed it too: the discrete-event simulator's per-chunk work
(`SimResult.chunk_log`) and the threaded executor's per-chunk wall
seconds (`ExecStats.chunk_log`), over item or work-unit ranges
(`observe_item_ranges`, `observe_unit_ranges`).

An item only partially covered by an observation has its sample
extrapolated by the observed fraction of its estimated mass, so partial
observations don't bias items low. Each ``observe_*`` call is one
execution round.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.core.tiling import TileSchedule, WorkerShards
from repro_torch.core.welford import WelfordVec

from .defaults import REFINE_BLEND


def _proportional_split(measured: np.ndarray,
                        weights: np.ndarray,
                        owner: np.ndarray,
                        n_groups: int) -> np.ndarray:
    """Distribute `measured[g]` over the members of each group g in
    proportion to `weights` (uniform within a group whose weight mass is
    zero but which still has members). `owner[k]` names member k's group
    (-1 = unowned, dropped). Returns the per-member share array."""
    measured = np.asarray(measured, np.float64)
    weights = np.asarray(weights, np.float64)
    owned = owner >= 0
    safe_owner = np.where(owned, owner, 0)
    wsum = np.bincount(safe_owner[owned], weights=weights[owned],
                       minlength=n_groups)
    csum = np.bincount(safe_owner[owned], minlength=n_groups)
    # zero-mass groups fall back to an even split over their members
    frac = np.where(wsum[safe_owner] > 0,
                    np.divide(weights, wsum[safe_owner],
                              out=np.zeros_like(weights),
                              where=wsum[safe_owner] > 0),
                    np.divide(1.0, csum[safe_owner],
                              out=np.zeros_like(weights),
                              where=csum[safe_owner] > 0))
    return np.where(owned, measured[safe_owner] * frac, 0.0)


@dataclasses.dataclass
class CostRefiner:
    """Per-item running cost statistics fed by measured execution traces.

    `sizes`/`prior` are the work units and a-priori cost estimates the
    schedule under refinement was built from; `est` is the attribution
    estimate used to split coarse observations (it starts as the prior and
    is refreshed to the latest refined costs by `Schedule.refine`, so each
    round attributes with the best information available). Thread-safety:
    callers serialize observe calls (the facade's Schedule does).
    """

    sizes: np.ndarray            # (n,) int64 work units per item
    prior: np.ndarray            # (n,) float64 a-priori estimates
    est: np.ndarray              # (n,) float64 current attribution estimate
    stats: WelfordVec            # per-item running (count, mean, M2)
    blend: float = REFINE_BLEND
    rounds: int = 0              # completed observation rounds

    @classmethod
    def for_costs(cls, sizes: np.ndarray, costs: np.ndarray,
                  blend: float = REFINE_BLEND) -> "CostRefiner":
        sizes = np.asarray(sizes, np.int64)
        prior = np.asarray(costs, np.float64).copy()
        return cls(sizes=sizes, prior=prior, est=prior.copy(),
                   stats=WelfordVec.zeros(prior.size), blend=float(blend))

    @property
    def n_items(self) -> int:
        return int(self.prior.size)

    # ------------------------------------------------------------ folding
    def _fold(self, per_item: np.ndarray, covered: np.ndarray) -> None:
        """One Welford sample for every covered item, extrapolating items
        whose estimated mass was only partially covered this round."""
        self.stats.update(np.maximum(per_item, 0.0), covered)
        self.rounds += 1

    def _covered_sample(self, per_item: np.ndarray,
                        est_covered: np.ndarray) -> tuple[np.ndarray,
                                                          np.ndarray]:
        """Scale partially-covered items up by the observed fraction of
        their estimated mass; an item counts as covered when any of its
        estimate mass (or, for zero-estimate items, any of its work) was
        inside the observed chunks."""
        # bincount over an EMPTY observation returns int64 regardless of
        # its weights dtype; keep the arithmetic in float64 either way
        per_item = np.asarray(per_item, np.float64)
        est_covered = np.asarray(est_covered, np.float64)
        covered = est_covered > 0
        frac = np.divide(est_covered, self.est,
                         out=np.ones_like(est_covered),
                         where=self.est > 0)
        frac = np.clip(frac, 1e-12, 1.0)
        sample = np.divide(per_item, frac, out=per_item.copy(),
                           where=covered)
        return sample, covered

    # ------------------------------------------------------- entry points
    def observe_items(self, measured: np.ndarray,
                      mask: Optional[np.ndarray] = None) -> None:
        """Finest granularity: one measured cost per item (mask = items
        actually observed this round)."""
        measured = np.asarray(measured, np.float64)
        if measured.shape != (self.n_items,):
            raise ValueError(f"per-item observation must have shape "
                             f"({self.n_items},), got {measured.shape}")
        covered = (np.ones(self.n_items, bool) if mask is None
                   else np.asarray(mask, bool))
        self._fold(measured.copy(), covered)

    def observe_tiles(self, tiles: TileSchedule, measured: np.ndarray,
                      tile_mask: Optional[np.ndarray] = None) -> None:
        """Per-tile measured costs (what the kernel cost stream reduces
        to): distributed to items through the
        tile's slot-cost decomposition under the current estimates."""
        measured = np.asarray(measured, np.float64)
        T, R = tiles.n_tiles, tiles.rows_per_tile
        if measured.shape != (T,):
            raise ValueError(f"per-tile observation must have shape ({T},),"
                             f" got {measured.shape}")
        slot_est = tiles.slot_cost(self.est, self.sizes).reshape(-1)
        seg = tiles.seg_len.reshape(-1).astype(np.float64)
        item = tiles.item_id.reshape(-1)
        tile_of_slot = np.repeat(np.arange(T, dtype=np.int64), R)
        owner = np.where(item >= 0, tile_of_slot, -1)
        # slots of unobserved tiles drop out of both the split and coverage
        if tile_mask is not None:
            keep = np.repeat(np.asarray(tile_mask, bool), R)
            owner = np.where(keep, owner, -1)
        # split by estimated slot cost; a tile whose estimate mass is zero
        # splits by work units instead, so zero-estimate items still
        # receive their share of that tile's measurement
        tile_mass = np.bincount(tile_of_slot, weights=slot_est, minlength=T)
        weights = np.where(tile_mass[tile_of_slot] > 0, slot_est, seg)
        slot_share = _proportional_split(measured, weights, owner, T)
        valid = owner >= 0
        per_item = np.bincount(item[valid], weights=slot_share[valid],
                               minlength=self.n_items)
        est_covered = np.bincount(item[valid], weights=slot_est[valid],
                                  minlength=self.n_items)
        # an all-zero-estimate item is covered if any of its units was seen
        unit_cov = np.bincount(item[valid], weights=seg[valid],
                               minlength=self.n_items)
        sample, covered = self._covered_sample(per_item, est_covered)
        covered |= (unit_cov > 0) & (self.est <= 0)
        self._fold(sample, covered)

    def observe_item_ranges(self, ranges, measured: np.ndarray) -> None:
        """Chunk records over ITEM index space (the threaded executor's
        `parallel_for` chunk_log): each chunk's measurement splits over the
        items it ran, proportional to current estimates."""
        ranges = np.asarray(ranges, np.int64).reshape(-1, 2)
        measured = np.asarray(measured, np.float64)
        owner = np.full(self.n_items, -1, np.int64)
        for c, (b, e) in enumerate(ranges):
            owner[b:e] = c
        per_item = _proportional_split(measured, self.est, owner,
                                       len(ranges))
        est_covered = np.where(owner >= 0, self.est, 0.0)
        sample, covered = self._covered_sample(per_item, est_covered)
        covered |= (owner >= 0) & (self.est <= 0)
        self._fold(sample, covered)

    def observe_unit_ranges(self, ranges, measured: np.ndarray) -> None:
        """Chunk records over flattened WORK-UNIT space (simulator replay /
        `parallel_for_units` logs): split each chunk over its units by the
        current per-unit estimate, then fold units into their items."""
        ranges = np.asarray(ranges, np.int64).reshape(-1, 2)
        measured = np.asarray(measured, np.float64)
        n_units = int(self.sizes.sum())
        unit_item = np.repeat(np.arange(self.n_items, dtype=np.int64),
                              self.sizes)
        unit_est = np.repeat(
            np.divide(self.est, self.sizes, out=np.zeros_like(self.est),
                      where=self.sizes > 0), self.sizes)
        owner = np.full(n_units, -1, np.int64)
        for c, (b, e) in enumerate(ranges):
            owner[b:e] = c
        per_unit = _proportional_split(measured, unit_est, owner,
                                       len(ranges))
        seen = owner >= 0
        per_item = np.bincount(unit_item[seen], weights=per_unit[seen],
                               minlength=self.n_items)
        est_covered = np.bincount(unit_item[seen], weights=unit_est[seen],
                                  minlength=self.n_items)
        unit_cov = np.bincount(unit_item[seen], minlength=self.n_items)
        sample, covered = self._covered_sample(per_item, est_covered)
        covered |= (unit_cov > 0) & (self.est <= 0)
        self._fold(sample, covered)

    def observe_worker_steps(self, tiles: TileSchedule,
                             shards: WorkerShards,
                             measured: np.ndarray) -> None:
        """The sharded kernels' cost output: measured[w, s] is what worker
        w's s-th superstep block cost. Block costs split over the block's
        tiles by estimated tile cost, then tiles fold into items."""
        measured = np.asarray(measured, np.float64)
        if measured.shape != shards.block_perm.shape:
            raise ValueError(
                f"worker-step observation must have shape "
                f"{shards.block_perm.shape} (p, S_B), got {measured.shape}")
        T = tiles.n_tiles
        B = shards.superstep
        tile_est = tiles.tile_cost(self.est, self.sizes)
        # tile -> block (only real blocks; padding steps have perm -1)
        block = np.arange(T) // B
        flat_blocks = shards.block_perm.reshape(-1)
        step_cost = measured.reshape(-1)
        n_blocks = -(-T // B)
        block_cost = np.zeros(n_blocks)
        real = flat_blocks >= 0
        block_cost[flat_blocks[real]] = step_cost[real]
        tile_share = _proportional_split(block_cost, tile_est, block,
                                         n_blocks)
        self.observe_tiles(tiles, tile_share)

    # ------------------------------------------------------------- output
    def refined_costs(self) -> np.ndarray:
        """Blend of running observed means and priors: an item observed at
        least once moves to `blend * mean + (1-blend) * prior`; an item
        never observed keeps its prior untouched."""
        seen = self.stats.count > 0
        out = self.prior.copy()
        out[seen] = (self.blend * self.stats.mean[seen]
                     + (1.0 - self.blend) * self.prior[seen])
        return np.maximum(out, 0.0)

    def successor(self, sizes: np.ndarray) -> "CostRefiner":
        """The refiner handed to the NEXT schedule generation: same running
        statistics (they keep compounding across refine() rounds — the
        WelfordVec is shared, not copied), same priors, fresh attribution
        estimate, sizes as the new generation derived them."""
        return dataclasses.replace(
            self, sizes=np.asarray(sizes, np.int64),
            est=self.refined_costs())

    def refresh_estimates(self) -> np.ndarray:
        """Move the attribution estimate to the current refined costs (the
        refine step calls this so the NEXT round's coarse observations
        split with the freshest information). Returns the refined array."""
        refined = self.refined_costs()
        self.est = refined.copy()
        return refined
