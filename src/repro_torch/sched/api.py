"""The `LoopScheduler` facade and the `Schedule` it hands out — the port's
copy of `repro.sched.api`, cut to the kernel path.

`LoopScheduler.schedule(costs)` turns per-item cost into a cached
`Schedule` of uniform (R, W) tiles; `Schedule.shard()` lowers it onto p
workers; `LoopScheduler.build(name, *inputs)` instantiates a registered
workload's kernel op on the scheduler's device; and the op's
`observe().refine()` re-lowers the schedule from the cost stream the
kernel measured. The simulator, threaded executor, fault-replay and
recovery methods of the reference's `Schedule` are not part of this slice.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.core import policies as P
from repro_torch.core import tiling as T
from repro_torch.device import resolve_device

from .adaptive import CostRefiner
from .cache import CacheStats, ScheduleCache
from .costs import RefinedCosts, as_cost_provider
from .defaults import (ICH_EPS, MAX_WIDTH, MIN_WIDTH, ROWS_PER_TILE,
                       SUPERSTEP)


@dataclasses.dataclass(frozen=True, eq=False)
class Schedule:
    """An immutable constructed schedule: per-item costs + policy + tiles.

    Identity semantics (eq=False): schedules compare by object identity,
    matching the cache's contract. `tiles` is the (T, R) iCh tile layout;
    `sizes`/`costs` are the per-item work units / float costs it was built
    from. `p` and `superstep` are the kernel-lowering defaults: `shard()`
    partitions the tiles across `p` workers in supersteps of `superstep`
    tiles.
    """

    sizes: np.ndarray        # (n,) int64 work units per item
    costs: np.ndarray        # (n,) float64 per-item costs
    policy: P.Policy
    p: int
    tiles: T.TileSchedule
    superstep: int = SUPERSTEP
    # memoized worker shard layouts keyed (p, superstep); benign build race
    _shards: dict = dataclasses.field(default_factory=dict, repr=False)
    # ---- measured-cost feedback state ----
    # refinement generation: 0 = built from a-priori estimates, g+1 = built
    # by the g-th schedule's refine(); part of the schedule-cache key
    generation: int = 0
    # True when sizes describe a payload layout (CSR nnz) refine() keeps
    structural_sizes: bool = True
    # construction parameters refine() rebuilds with (None width = re-band)
    width_arg: Optional[int] = None
    band_eps: float = ICH_EPS
    # lazily-created CostRefiner lives here (frozen dataclass)
    _feedback: dict = dataclasses.field(default_factory=dict, repr=False)
    # the constructing facade — refine() re-enters its cache; None for
    # hand-assembled Schedules (refine then rebuilds directly)
    _scheduler: Optional["LoopScheduler"] = dataclasses.field(
        default=None, repr=False)

    # ------------------------------------------------------------- lowering
    def shard(self, *, p: Optional[int] = None,
              superstep: Optional[int] = None) -> T.WorkerShards:
        """The worker-sharded lowering of the tiles: a cost-balanced,
        item-closed LPT partition across `p` workers, padded to supersteps
        of `superstep` tiles — the layout `ich_spmv_sharded` consumes.
        Memoized per (p, superstep) on this Schedule."""
        key = (int(p if p is not None else self.p),
               int(superstep if superstep is not None else self.superstep))
        hit = self._shards.get(key)
        if hit is None:
            hit = self._shards.setdefault(key, T.shard_schedule(
                self.tiles, self.tile_cost(), key[0], superstep=key[1]))
        return hit

    @property
    def n_items(self) -> int:
        return int(self.sizes.size)

    @property
    def n_tiles(self) -> int:
        return self.tiles.n_tiles

    @property
    def rows_per_tile(self) -> int:
        return self.tiles.rows_per_tile

    @property
    def width(self) -> int:
        return self.tiles.width

    @property
    def item_id(self) -> np.ndarray:
        """(T, R) tile schedule (-1 = padding slot)."""
        return self.tiles.item_id

    def tile_cost(self) -> np.ndarray:
        """Predicted per-tile cost, shape (T,)."""
        return self.tiles.tile_cost(self.costs, self.sizes)

    def slot_cost(self) -> np.ndarray:
        """Per-slot (T, R) cost decomposition; rows sum to `tile_cost`.
        This is the stream the sharded kernel accounts its per-worker cost
        output against (`sched/kernels.py`)."""
        return self.tiles.slot_cost(self.costs, self.sizes)

    # ---------------------------------------------- measured-cost feedback
    @property
    def refiner(self) -> CostRefiner:
        """This schedule's cost refiner (created on first use). Carries the
        per-item Welford statistics across observe() rounds and — through
        refine() — across schedule generations."""
        r = self._feedback.get("refiner")
        if r is None:
            r = self._feedback.setdefault(
                "refiner", CostRefiner.for_costs(self.sizes, self.costs))
        return r

    def observe(self, measured, *, level: str = "auto",
                shards: Optional[T.WorkerShards] = None) -> "Schedule":
        """Fold one execution round's measured costs into the refiner.

        * a (p, S_B) array — the sharded kernel's per-worker,
          per-superstep cost output (`SpmvOp.observe()`). Attributed
          through the schedule's DEFAULT shard lowering unless `shards`
          names the lowering the measurement came from — shapes alone
          cannot identify a lowering;
        * a 1-D array — per-item (`level="item"`) or per-tile
          (`level="tile"`) measurements; "auto" infers from the length and
          raises when n_items == n_tiles makes it ambiguous.

        Accepts numpy arrays and tensors (on any device). Returns self, so
        a round reads ``schedule.observe(measured).refine()``.
        """
        r = self.refiner
        if hasattr(measured, "detach"):  # a tensor, possibly on the card
            measured = measured.detach().cpu().numpy()
        arr = np.asarray(measured, np.float64)
        if arr.ndim == 2:
            sh = shards if shards is not None else self.shard()
            if sh.block_perm.shape != arr.shape:
                raise ValueError(
                    f"worker-step observation {arr.shape} does not match "
                    f"the {'given' if shards is not None else 'default'} "
                    f"shard lowering's (p, S_B) grid "
                    f"{sh.block_perm.shape}; pass shards=<the lowering the "
                    "measurement came from> (shapes alone cannot identify "
                    "a lowering)")
            r.observe_worker_steps(self.tiles, sh, arr)
            return self
        if arr.ndim != 1:
            raise ValueError(f"cannot interpret a {arr.ndim}-D observation")
        if level == "auto":
            if arr.size == self.n_items == self.n_tiles:
                raise ValueError(
                    "n_items == n_tiles: pass level='item' or level='tile'")
            level = ("item" if arr.size == self.n_items else
                     "tile" if arr.size == self.n_tiles else None)
            if level is None:
                raise ValueError(
                    f"observation of length {arr.size} matches neither "
                    f"items ({self.n_items}) nor tiles ({self.n_tiles})")
        if level == "item":
            r.observe_items(arr)
        elif level == "tile":
            r.observe_tiles(self.tiles, arr)
        else:
            raise ValueError(f"unknown observation level {level!r}")
        return self

    def refine(self, *, blend: Optional[float] = None) -> "Schedule":
        """Re-construct from the refiner's current refined costs: re-tile
        (unless sizes are structural), re-partition, and re-shard, under a
        fresh cache GENERATION so no stale lowering is ever reused. The
        refiner — with its accumulated per-item statistics — transfers to
        the new schedule, so rounds keep compounding:
        ``s = s.observe(m).refine()``.
        """
        r = self.refiner
        if blend is not None:
            r.blend = float(blend)
        refined = r.refresh_estimates()
        provider = RefinedCosts(self.sizes, refined,
                                generation=self.generation + 1,
                                structural=self.structural_sizes)
        if self._scheduler is not None:
            new = self._scheduler.schedule(
                provider, policy=self.policy, p=self.p,
                rows_per_tile=self.rows_per_tile, width=self.width_arg,
                eps=self.band_eps, superstep=self.superstep,
                _generation=self.generation + 1)
        else:  # hand-assembled schedule: rebuild directly, no cache
            tiles = T.build_schedule(provider.sizes(),
                                     rows_per_tile=self.rows_per_tile,
                                     width=self.width_arg,
                                     eps=self.band_eps)
            new = dataclasses.replace(
                self, sizes=provider.sizes(), costs=provider.costs(),
                tiles=tiles, generation=self.generation + 1,
                _shards={}, _feedback={})
        new._feedback["refiner"] = r.successor(new.sizes)
        return new


class LoopScheduler:
    """Facade over policies, tile construction and the kernel ops.

    Construction parameters set here are the instance defaults; every
    method takes per-call overrides. Schedules are cached (LRU) on
    ``(cost fingerprint, full policy, p, construction params, superstep,
    generation)`` — see `sched/cache.py`. `cache_size=0` disables caching.

    `device` is where the ops that `build()` returns keep their payload
    and launch their kernels: None means the card, and raises when CUDA is
    unavailable; pass ``device="cpu"`` for the plain PyTorch versions.
    """

    def __init__(self, *, p: int = 8, policy: Optional[P.Policy] = None,
                 rows_per_tile: int = ROWS_PER_TILE,
                 min_w: int = MIN_WIDTH, max_w: int = MAX_WIDTH,
                 superstep: int = SUPERSTEP,
                 cache_size: int = 32,
                 device=None):
        self.device = resolve_device(device)
        self.p = int(p)
        self.policy = policy if policy is not None else P.ich(ICH_EPS)
        self.rows_per_tile = int(rows_per_tile)
        self.min_w = int(min_w)
        self.max_w = int(max_w)
        self.superstep = int(superstep)
        self.cache = ScheduleCache(cache_size) if cache_size > 0 else None

    # ------------------------------------------------- schedule construction
    def schedule(self, costs, *, policy: Optional[P.Policy] = None,
                 p: Optional[int] = None,
                 rows_per_tile: Optional[int] = None,
                 width: Optional[int] = None,
                 eps: Optional[float] = None,
                 superstep: Optional[int] = None,
                 _generation: int = 0) -> Schedule:
        """Construct (or fetch from cache) the schedule for `costs`.

        `costs` is a `CostProvider` or a bare per-item array
        (`as_cost_provider`). The tile width comes from the paper's band at
        `eps` (default: the policy's epsilon for adaptive policies, else
        `ICH_EPS`) unless `width` pins it explicitly. The cache key holds
        the worker-partition parameters `p` and `superstep` (a cached
        schedule memoizes its shard layout) and the refinement generation.
        """
        provider = as_cost_provider(costs)
        pol = policy if policy is not None else self.policy
        pp = int(p if p is not None else self.p)
        rpt = int(rows_per_tile if rows_per_tile is not None
                  else self.rows_per_tile)
        band_eps = float(eps if eps is not None
                         else (pol.eps if pol.adaptive else ICH_EPS))
        sstep = int(superstep if superstep is not None else self.superstep)
        gen = int(_generation)
        # absent a declaration, sizes count as structural: keeping them
        # across refinement is always payload-safe (see sched/costs.py)
        structural = bool(getattr(provider, "sizes_are_structural", True))
        key = (provider.fingerprint(), pol, pp, rpt, width,
               band_eps, self.min_w, self.max_w, sstep, gen)

        def build() -> Schedule:
            sizes = provider.sizes()
            tiles = T.build_schedule(sizes, rows_per_tile=rpt,
                                     width=width, eps=band_eps,
                                     min_w=self.min_w, max_w=self.max_w)
            return Schedule(sizes=sizes, costs=provider.costs(), policy=pol,
                            p=pp, tiles=tiles, superstep=sstep,
                            generation=gen, structural_sizes=structural,
                            width_arg=width, band_eps=band_eps,
                            _scheduler=self)

        if self.cache is None:
            return build()
        return self.cache.get_or_build(key, build)

    # ----------------------------------------------------- workload registry
    def build(self, workload: str, *inputs,
              policy: Optional[P.Policy] = None, p: Optional[int] = None,
              rows_per_tile: Optional[int] = None,
              width: Optional[int] = None, eps: Optional[float] = None,
              superstep: Optional[int] = None):
        """Instantiate a registered workload's kernel op from raw inputs,
        on this scheduler's device."""
        from . import registry
        entry = registry.get(workload)
        provider = entry.costs(*inputs)
        s = self.schedule(provider, policy=policy, p=p,
                          rows_per_tile=rows_per_tile, width=width, eps=eps,
                          superstep=superstep)
        return entry.build(s, *inputs, device=self.device)

    @property
    def cache_stats(self) -> CacheStats:
        return self.cache.stats if self.cache is not None else CacheStats()
