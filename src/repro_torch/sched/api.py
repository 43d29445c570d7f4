"""The `LoopScheduler` facade and the `Schedule` it hands out — the port's
copy of `repro.sched.api`.

One object per constructed schedule, three consumers:

* ``Schedule.simulate()`` / ``replay()`` / ``replay_sharded()`` — the
  discrete-event simulator (`core/simulator.py`): `simulate` runs the
  schedule's policy over the per-item cost array; `replay` re-dispatches
  the constructed tiles chunk-for-chunk (`policies.pretiled` over
  flattened work units); `replay_sharded` runs each tile on the worker
  `shard()` gave it, the simulator twin of the sharded CUDA kernels and
  of the cost streams they emit.
* ``Schedule.parallel_for()`` / ``parallel_for_units()`` — the real
  threaded executor (`core/executor.py`): per-item under the policy, or
  per-work-unit under the exact tile chunking.
* ``Schedule.lower()`` / ``shard()`` — the tiles and the worker shard
  layout the kernels consume (`core/tiling.py`);
  `LoopScheduler.build(name, *inputs)` instantiates a registered
  workload's kernel op on the scheduler's device, and the op's
  `observe().refine()` re-lowers the schedule from the cost stream the
  kernel measured. ``Schedule.device_lowering()`` is the same lowering
  built on the scheduler's device by the tensor pipeline
  (`core/tiling_torch.py`), element-identical to `shard()` and its
  kernel streams; ``LoopScheduler(backend="torch")`` builds the tiles
  themselves with that pipeline. ``Schedule.reshard_survivors()`` plans
  the recovery of an interrupted sharded run on the surviving workers
  (`robust/recovery.py`).

`observe()` takes what each layer measures: a simulator `SimResult`, an
executor `ExecStats`, a kernel's (p, S_B) cost stream, or per-item or
per-tile arrays.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Callable, Optional

import numpy as np

from repro_torch.core import executor as E
from repro_torch.core import policies as P
from repro_torch.core import simulator as S
from repro_torch.core import tiling as T
from repro_torch.core import tiling_torch as TT
from repro_torch.device import resolve_device
from repro_torch.robust import faults as F
from repro_torch.robust import recovery as R

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
    from; `policy`/`p` are the runtime-side defaults its simulator and
    executor methods use. `p` and `superstep` are also the kernel-lowering
    defaults: `shard()` partitions the tiles across `p` workers in
    supersteps of `superstep` tiles.
    """

    sizes: np.ndarray        # (n,) int64 work units per item
    costs: np.ndarray        # (n,) float64 per-item costs
    policy: P.Policy
    p: int
    tiles: T.TileSchedule
    # simulator time model inherited from the constructing LoopScheduler
    sim_params: S.SimParams = dataclasses.field(default_factory=S.SimParams)
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
    # construction pipeline of the tiles: "numpy" (host) or "torch"
    # (core/tiling_torch.py on the scheduler's device)
    backend: str = "numpy"
    # memoized device lowerings keyed (p, superstep), like _shards
    _device: dict = dataclasses.field(default_factory=dict, repr=False)

    # ------------------------------------------------------------- lowering
    def lower(self) -> T.TileSchedule:
        """The static tile schedule the kernels consume."""
        return self.tiles

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

    def device_lowering(self, *, p: Optional[int] = None,
                        superstep: Optional[int] = None):
        """The lowering of this schedule built on the device by the tensor
        pipeline (`core/tiling_torch.DeviceLowering`): build -> cost ->
        partition -> shard layout, element-identical to the host `shard()`
        arrays and the kernels' streams, but resident as tensors the
        sharded kernels consume without a host round trip. It runs on the
        constructing scheduler's device (the card for a hand-assembled
        Schedule, raising without CUDA). Memoized per (p, superstep) like
        `shard()`.

        Generation safety: `refine()` always returns a NEW Schedule under a
        fresh cache generation with an EMPTY device memo, so a memoized
        lowering never serves a later generation's costs. The width is
        pinned to this schedule's own, so the pipeline reproduces these
        exact tiles rather than re-deriving the band."""
        key = (int(p if p is not None else self.p),
               int(superstep if superstep is not None else self.superstep))
        hit = self._device.get(key)
        if hit is None:
            device = (self._scheduler.device if self._scheduler is not None
                      else None)
            hit = self._device.setdefault(key, TT.lower_schedule_torch(
                self.sizes, self.costs, p=key[0], superstep=key[1],
                rows_per_tile=self.rows_per_tile, width=self.width,
                eps=self.band_eps, device=device))
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

    # ------------------------------------------- work-unit space utilities
    def unit_ranges(self) -> np.ndarray:
        """(T, 2) [begin, end) tile chunks in flattened work-unit space."""
        return self.tiles.slot_ranges()

    def unit_costs(self) -> np.ndarray:
        """Per-work-unit cost array that `unit_ranges` indexes into."""
        return self.tiles.unit_costs(self.costs, self.sizes)

    def unit_to_item(self) -> np.ndarray:
        """Flattened-unit -> item map (item i owns sizes[i] units)."""
        return np.repeat(np.arange(self.n_items, dtype=np.int64), self.sizes)

    def tile_work(self) -> np.ndarray:
        """Work units packed into each tile, shape (T,)."""
        return self.tiles.tile_work()

    def tile_cost(self) -> np.ndarray:
        """Predicted per-tile cost, shape (T,); what `replay` must
        reproduce."""
        return self.tiles.tile_cost(self.costs, self.sizes)

    def slot_cost(self) -> np.ndarray:
        """Per-slot (T, R) cost decomposition; rows sum to `tile_cost`.
        This is the stream the sharded kernel accounts its per-worker cost
        output against (`sched/kernels.py`)."""
        return self.tiles.slot_cost(self.costs, self.sizes)

    def imbalance(self, *, p: Optional[int] = None,
                  superstep: Optional[int] = None) -> float:
        """max/mean per-worker cost of the sharded lowering (1.0 =
        perfectly balanced). The load-balance figure the refine loop
        drives down: observe() + refine() re-partitions from measured
        costs, so a schedule built from stale estimates converges toward
        imbalance 1.0 over rounds."""
        shards = self.shard(p=p, superstep=superstep)
        wc = shards.worker_cost(self.tile_cost())
        mean = float(wc.mean())
        return float(wc.max()) / mean if mean > 0 else 1.0

    # ------------------------------------------------------- (a) simulator
    def simulate(self, *, p: Optional[int] = None,
                 policy: Optional[P.Policy] = None,
                 params: Optional[S.SimParams] = None,
                 **kw) -> S.SimResult:
        """Discrete-event run of `policy` (default: the schedule's) over the
        per-item cost array."""
        return S.simulate(self.costs, p or self.p, policy or self.policy,
                          params if params is not None else self.sim_params,
                          **kw)

    def replay(self, *, p: Optional[int] = None,
               params: Optional[S.SimParams] = None,
               record_chunks: bool = True) -> S.SimResult:
        """Replay the constructed tiles through the simulator: each tile is
        dispatched as one explicit central-queue chunk over the flattened
        work units. `chunk_log` ranges equal `unit_ranges()` row-for-row
        and per-chunk work equals `tile_cost()`."""
        return S.simulate(self.unit_costs(), p or self.p,
                          P.pretiled(self.unit_ranges()),
                          params if params is not None else self.sim_params,
                          record_chunks=record_chunks)

    def replay_sharded(self, *, p: Optional[int] = None,
                       superstep: Optional[int] = None,
                       params: Optional[S.SimParams] = None,
                       record_chunks: bool = True) -> S.SimResult:
        """Replay the WORKER-SHARDED lowering through the simulator: each
        tile is dispatched on exactly the worker `shard()` assigned it
        (`policies.assigned`, static assignment — no queue, no stealing).
        Per-worker dispatched work must equal `shard().worker_cost(
        tile_cost())` worker-for-worker, and under zero overhead/jitter the
        makespan is the partition's max per-worker cost — the simulator
        cross-check for the sharded CUDA kernels, whose per-worker cost
        streams sum to the same figures (`chip_smoke.py`)."""
        shards = self.shard(p=p, superstep=superstep)
        return S.simulate(self.unit_costs(), shards.p,
                          P.assigned(self.unit_ranges(), shards.worker),
                          params if params is not None else self.sim_params,
                          record_chunks=record_chunks)

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
                space: str = "auto", normalize: Optional[bool] = None,
                shards: Optional[T.WorkerShards] = None) -> "Schedule":
        """Fold one execution round's measured costs into the refiner.

        Accepts what each execution layer emits:

        * a `SimResult` with `chunk_log` (from `replay`/`replay_sharded`/
          `simulate(record_chunks=True)`) — per-chunk dispatched work, in
          item space (simulate) or flattened work-unit space (replays);
          inferred from the simulated n, with the same `space=` escape
          hatch as ExecStats when the two coincide;
        * an `ExecStats` with `chunk_log` (from `parallel_for(record_chunks
          =True)` / `parallel_for_units`) — per-chunk wall seconds,
          normalized onto the estimate scale by default (wall clocks and
          abstract cost units share no unit). Chunk ranges live in ITEM
          space (`parallel_for`) or flattened WORK-UNIT space
          (`parallel_for_units`); this is inferred from where the ranges
          end, and when n_items == n_units with non-uniform sizes makes
          the two indistinguishable, `space="items"`/`"units"` must say
          which executor produced the stats;
        * a (p, S_B) array or tensor (on any device) — the sharded
          kernels' per-worker, per-superstep cost output
          (`sched/kernels.py` ops' `.observe()`). Attributed
          through the schedule's DEFAULT shard lowering unless `shards`
          names the lowering the measurement came from — shapes alone
          cannot identify a lowering (distinct supersteps can share a
          (p, S_B) grid), so a non-default lowering must be passed
          explicitly;
        * a 1-D array — per-item (`level="item"`) or per-tile
          (`level="tile"`) measurements; "auto" infers from the length and
          raises when n_items == n_tiles makes it ambiguous.

        Returns self, so a round reads
        ``schedule.observe(measured).refine()``.
        """
        r = self.refiner
        if isinstance(measured, S.SimResult):
            if not measured.chunk_log:
                raise ValueError(
                    "SimResult carries no chunk_log; run the simulator "
                    "with record_chunks=True to observe it")
            ranges = [(b, e) for (b, e, _, _) in measured.chunk_log]
            work = np.array([wk for (_, _, _, wk) in measured.chunk_log])
            n_units = int(self.sizes.sum())
            if space not in ("auto", "items", "units"):
                raise ValueError(f"space must be 'auto', 'items' or "
                                 f"'units', got {space!r}")
            # simulate() runs over per-item costs, replay()/replay_sharded()
            # over flattened work units; same ambiguity rule as ExecStats
            # below when the two coincide with non-uniform sizes
            if space != "auto":
                unit_space = space == "units"
                expect = n_units if unit_space else self.n_items
                if measured.n != expect:
                    raise ValueError(
                        f"SimResult ran over n={measured.n} iterations but "
                        f"the {space} space has {expect} entries")
            elif measured.n == self.n_items == n_units \
                    and not (self.sizes == 1).all():
                raise ValueError(
                    "n_items == work units with non-uniform sizes: pass "
                    "space='items' (a simulate() run) or space='units' "
                    "(a replay)")
            elif measured.n == self.n_items:
                unit_space = False
            elif measured.n == n_units:
                unit_space = True
            else:
                raise ValueError(
                    f"SimResult over n={measured.n} iterations matches "
                    f"neither items ({self.n_items}) nor work units "
                    f"({n_units}) of this schedule")
            if unit_space:
                r.observe_unit_ranges(ranges, work)
            else:
                r.observe_item_ranges(ranges, work)
            return self
        if isinstance(measured, E.ExecStats):
            if not measured.chunk_log:
                raise ValueError(
                    "ExecStats carries no chunk_log; run parallel_for with "
                    "record_chunks=True to observe it")
            ranges = np.array([(b, e) for (b, e, _, _) in measured.chunk_log],
                              np.int64)
            secs = np.array([dt for (_, _, _, dt) in measured.chunk_log])
            n_units = int(self.sizes.sum())
            end = int(ranges[:, 1].max(initial=0))
            if space not in ("auto", "items", "units"):
                raise ValueError(f"space must be 'auto', 'items' or "
                                 f"'units', got {space!r}")
            # parallel_for chunks cover [0, n_items), parallel_for_units
            # [0, n_units); when the two coincide AND sizes are non-
            # uniform, the spaces distribute differently and the caller
            # must say which executor produced the stats
            if space != "auto":
                unit_space = space == "units"
                expect = n_units if unit_space else self.n_items
                if end != expect:
                    raise ValueError(
                        f"ExecStats chunks end at {end} but the "
                        f"{space} space has {expect} entries")
            elif end == self.n_items == n_units \
                    and not (self.sizes == 1).all():
                raise ValueError(
                    "n_items == work units with non-uniform sizes: pass "
                    "space='items' (parallel_for stats) or space='units' "
                    "(parallel_for_units stats)")
            elif end == self.n_items:
                unit_space = False
            elif end == n_units:
                unit_space = True
            else:
                raise ValueError(
                    f"ExecStats chunks end at {end}, matching neither "
                    f"items ({self.n_items}) nor work units ({n_units})")
            if normalize is None:
                normalize = True  # wall seconds -> estimate scale
            if normalize and secs.sum() > 0:
                if unit_space:
                    unit_est = self.unit_costs()
                    covered = sum(float(unit_est[b:e].sum())
                                  for b, e in ranges)
                else:
                    covered = sum(float(r.est[b:e].sum()) for b, e in ranges)
                if covered > 0:
                    secs = secs * (covered / secs.sum())
            if unit_space:
                r.observe_unit_ranges(ranges, secs)
            else:
                r.observe_item_ranges(ranges, secs)
            return self
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
            if self.backend == "torch":
                tiles = TT.build_schedule_torch(
                    provider.sizes(), rows_per_tile=self.rows_per_tile,
                    width=self.width_arg, eps=self.band_eps).to_host()
            else:
                tiles = T.build_schedule(provider.sizes(),
                                         rows_per_tile=self.rows_per_tile,
                                         width=self.width_arg,
                                         eps=self.band_eps)
            new = dataclasses.replace(
                self, sizes=provider.sizes(), costs=provider.costs(),
                tiles=tiles, generation=self.generation + 1,
                _shards={}, _feedback={}, _device={})
        new._feedback["refiner"] = r.successor(new.sizes)
        return new

    def replay_refined(self, true_costs, *, sharded: bool = False,
                       p: Optional[int] = None,
                       superstep: Optional[int] = None,
                       params: Optional[S.SimParams] = None,
                       record_chunks: bool = False) -> S.SimResult:
        """Deterministically answer "what does THIS schedule cost on that
        workload": replay the constructed chunks with per-item costs
        `true_costs` (measured or ground truth) instead of the estimates
        the schedule was built from — `simulator.replay_refined` over the
        tile ranges, through the central pretiled queue, or as the static
        sharded assignment when `sharded=True`. The observe/refine loop
        must drive this makespan down."""
        true_costs = np.asarray(true_costs, np.float64)
        if true_costs.shape != (self.n_items,):
            raise ValueError(f"true costs must have shape "
                             f"({self.n_items},), got {true_costs.shape}")
        unit = self.tiles.unit_costs(true_costs, self.sizes)
        prm = params if params is not None else self.sim_params
        if sharded:
            shards = self.shard(p=p, superstep=superstep)
            return S.replay_refined(unit, self.unit_ranges(), shards.p,
                                    workers=shards.worker, params=prm,
                                    record_chunks=record_chunks)
        return S.replay_refined(unit, self.unit_ranges(), p or self.p,
                                params=prm, record_chunks=record_chunks)

    # -------------------------------------- fault replay & chaos runs
    def replay_faulty(self, plan: F.FaultPlan, *,
                      p: Optional[int] = None,
                      policy: Optional[P.Policy] = None,
                      params: Optional[S.SimParams] = None,
                      record_chunks: bool = False,
                      record_assignment: bool = False) -> F.FaultReport:
        """Simulate this schedule's policy over its cost array twice —
        fault-free and under the seeded `FaultPlan` — and report both runs
        plus the makespan inflation the chaos scenario costs it. Dead
        workers' queued work is reclaimed by survivors through the steal
        machinery, so the faulty run still dispatches every item exactly
        once (or raises `repro_torch.robust.FaultError` when no live worker
        remains). Deterministic: the same plan replays bit-identically."""
        return F.simulate_faulty(
            self.costs, p or self.p, policy or self.policy, plan,
            params=params if params is not None else self.sim_params,
            record_chunks=record_chunks,
            record_assignment=record_assignment)

    def reshard_survivors(self, *, dead,
                          checkpoint: Optional[R.CheckpointLog] = None,
                          p: Optional[int] = None,
                          superstep: Optional[int] = None) -> R.RecoveryPlan:
        """Recovery re-lowering for an interrupted sharded run: given the
        workers lost and a `CheckpointLog` of blocks completed at superstep
        barriers, re-partition every incomplete item-closed chain onto the
        p - k survivors with the same `partition_tiles` LPT the original
        lowering used. The returned `RecoveryPlan` carries the survivor
        layout (`.shards`), the completed-prefix layout (`.done_shards`)
        and `.combine()`: both layouts drive the standard sharded kernels
        over the original flat payload, and the combined output is
        bit-identical to the fault-free run. Without a checkpoint the plan
        is a full re-execution on the survivors."""
        shards = self.shard(p=p, superstep=superstep)
        return R.plan_recovery(self.tiles, self.tile_cost(), shards,
                               dead=dead, checkpoint=checkpoint)

    # -------------------------------------------------------- (b) executor
    def parallel_for(self, body: Callable[[int], None], *,
                     p: Optional[int] = None,
                     policy: Optional[P.Policy] = None,
                     seed: int = 0, record_chunks: bool = False,
                     deterministic: bool = False,
                     faults: Optional[F.FaultPlan] = None,
                     retries: int = 0, retry_backoff_s: float = 0.0,
                     watchdog_s: Optional[float] = None,
                     sleep_fn: Optional[Callable[[float], None]] = None
                     ) -> E.ExecStats:
        """Run `body(i)` for every item on real threads under `policy`
        (default: the schedule's). `record_chunks=True` fills the per-chunk
        wall-time log `observe()` consumes. `faults`,
        `retries`/`retry_backoff_s`, `watchdog_s`, and `sleep_fn` pass
        through to the supervised executor: injected
        chaos, per-item retry budget, heartbeat-based dead-worker
        detection, and the virtual-sleep hook for zero-wall-clock
        retry/stall suites."""
        return E.parallel_for(self.n_items, body, p or self.p,
                              policy or self.policy, seed=seed,
                              record_chunks=record_chunks,
                              deterministic=deterministic, faults=faults,
                              retries=retries,
                              retry_backoff_s=retry_backoff_s,
                              watchdog_s=watchdog_s, sleep_fn=sleep_fn)

    def parallel_for_units(self, body: Callable[[int], None], *,
                           p: Optional[int] = None,
                           seed: int = 0, record_chunks: bool = False,
                           deterministic: bool = False,
                           faults: Optional[F.FaultPlan] = None,
                           retries: int = 0, retry_backoff_s: float = 0.0,
                           sleep_fn: Optional[Callable[[float], None]] = None
                           ) -> E.ExecStats:
        """Run `body(u)` for every flattened work unit on real threads,
        dispatched in exactly the constructed tile chunks (one central-queue
        chunk per tile — the threaded twin of `replay`). With
        `record_chunks=True` the returned stats carry one wall-time record
        per tile, ready for `observe()`. `faults`/`retries` pass through to
        the supervised executor (central path: no watchdog — there are no
        per-worker deques to reclaim; survivors drain the shared queue)."""
        n_units = int(self.sizes.sum())
        return E.parallel_for(n_units, body, p or self.p,
                              P.pretiled(self.unit_ranges()), seed=seed,
                              record_chunks=record_chunks,
                              deterministic=deterministic, faults=faults,
                              retries=retries,
                              retry_backoff_s=retry_backoff_s,
                              sleep_fn=sleep_fn)


class LoopScheduler:
    """Facade over policies, simulator, executor, tile construction and
    the kernel ops.

    Construction parameters set here are the instance defaults; every
    method takes per-call overrides. Schedules are cached (LRU) on
    ``(cost fingerprint, full policy, p, construction params, superstep,
    generation, backend)`` — see `sched/cache.py`. `cache_size=0` disables
    caching.

    `device` is where the ops that `build()` returns keep their payload
    and launch their kernels, and where `Schedule.device_lowering()` runs:
    None means the card, and raises when CUDA is unavailable; pass
    ``device="cpu"`` for the plain PyTorch versions.

    `backend` picks the pipeline that builds the tiles: ``"numpy"`` (host,
    `core/tiling.py`) or ``"torch"`` (`core/tiling_torch.py` on `device`,
    element-identical tiles). It is part of the cache key, so the two
    pipelines' schedules, and the device lowerings a torch-built one
    memoizes, never alias.
    """

    def __init__(self, *, p: int = 8, policy: Optional[P.Policy] = None,
                 rows_per_tile: int = ROWS_PER_TILE,
                 min_w: int = MIN_WIDTH, max_w: int = MAX_WIDTH,
                 superstep: int = SUPERSTEP,
                 cache_size: int = 32,
                 sim_params: Optional[S.SimParams] = None,
                 device=None, backend: str = "numpy"):
        if backend not in ("numpy", "torch"):
            raise ValueError(
                f"backend must be 'numpy' or 'torch', got {backend!r}")
        self.backend = backend
        self.device = resolve_device(device)
        self.p = int(p)
        self.policy = policy if policy is not None else P.ich(ICH_EPS)
        self.rows_per_tile = int(rows_per_tile)
        self.min_w = int(min_w)
        self.max_w = int(max_w)
        self.superstep = int(superstep)
        self.sim_params = (sim_params if sim_params is not None
                           else S.SimParams())
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
               band_eps, self.min_w, self.max_w, sstep, gen, self.backend)

        def build() -> Schedule:
            sizes = provider.sizes()
            if self.backend == "torch":
                tiles = TT.build_schedule_torch(
                    sizes, rows_per_tile=rpt, width=width, eps=band_eps,
                    min_w=self.min_w, max_w=self.max_w,
                    device=self.device).to_host()
            else:
                tiles = T.build_schedule(sizes, rows_per_tile=rpt,
                                         width=width, eps=band_eps,
                                         min_w=self.min_w, max_w=self.max_w)
            return Schedule(sizes=sizes, costs=provider.costs(), policy=pol,
                            p=pp, tiles=tiles, sim_params=self.sim_params,
                            superstep=sstep,
                            generation=gen, structural_sizes=structural,
                            width_arg=width, band_eps=band_eps,
                            backend=self.backend, _scheduler=self)

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

    # --------------------------------------------- direct backend shortcuts
    def simulate(self, costs, *, policy: Optional[P.Policy] = None,
                 p: Optional[int] = None,
                 params: Optional[S.SimParams] = None,
                 **kw) -> S.SimResult:
        """Simulator pass-through for policy studies that need no tiles
        (the paper-figure benchmarks); `costs` is per-ITEM here."""
        return S.simulate(np.asarray(costs, np.float64),
                          p or self.p, policy or self.policy,
                          params if params is not None else self.sim_params,
                          **kw)

    def parallel_for(self, n: int, body: Callable[[int], None], *,
                     policy: Optional[P.Policy] = None,
                     p: Optional[int] = None, seed: int = 0) -> E.ExecStats:
        """Threaded-executor pass-through: `body(i)` for i in [0, n)."""
        return E.parallel_for(n, body, p or self.p, policy or self.policy,
                              seed=seed)

    @property
    def cache_stats(self) -> CacheStats:
        return self.cache.stats if self.cache is not None else CacheStats()


_DEFAULT: Optional[LoopScheduler] = None
_DEFAULT_LOCK = threading.Lock()


def default_scheduler() -> LoopScheduler:
    """Process-wide facade instance (one shared schedule cache), on the
    card: like `LoopScheduler()`, it raises when CUDA is unavailable."""
    global _DEFAULT
    with _DEFAULT_LOCK:
        if _DEFAULT is None:
            _DEFAULT = LoopScheduler()
        return _DEFAULT
