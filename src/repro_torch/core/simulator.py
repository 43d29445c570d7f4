"""Discrete-event simulator for self-scheduling policies (paper §5-6) — the
port's copy of `repro.core.simulator`, element-identical to it (numpy only).

The paper evaluates on a 28-thread Xeon; a host with fewer cores cannot
show that, so scheduler *quality* (makespan / speedup) is evaluated with a
discrete-event simulator whose policy logic is bit-faithful to the paper
(chunk laws, iCh classification/adaptation, THE-protocol steal-half with
rollback) and whose time model captures the costs the paper discusses:

* per-chunk dispatch under a queue lock (central queue => serialization,
  which is what kills ``dynamic(1)`` at high thread counts),
* local dispatch cost on distributed deques,
* steal cost, failed-steal cost, and a remote (cross-socket NUMA, or a
  link between devices) penalty multiplier,
* per-worker speed heterogeneity (DVFS / memory-bandwidth jitter, §3.2),
* iCh adaptation bookkeeping cost.

Events are processed at chunk granularity: O(#chunks + #steals) heap ops.
"""
from __future__ import annotations

import dataclasses
import heapq
import math
from typing import Optional

import numpy as np

from . import policies as P
from . import welford as W
# numpy-only, imports nothing back from repro_torch.core (see robust/faults.py)
from repro_torch.robust.faults import FaultClock, FaultError


@dataclasses.dataclass(frozen=True)
class SimParams:
    dispatch_overhead: float = 1.0      # central-queue grab (lock held)
    local_dispatch_overhead: float = 0.25
    steal_overhead: float = 4.0         # successful steal (lock held)
    failed_steal_overhead: float = 1.0  # empty-victim probe / rollback
    adapt_overhead: float = 0.15        # iCh classification + d update
    task_overhead: float = 3.0          # taskloop task creation/scheduling
    remote_penalty: float = 3.0         # cross-socket steal multiplier
    socket_size: int = 14               # threads per socket (2x14 Haswell)
    speed_jitter: float = 0.06          # stddev of per-worker speed factor
    seed: int = 0


@dataclasses.dataclass
class SimResult:
    makespan: float
    n: int
    p: int
    policy: str
    chunks: int = 0
    steals: int = 0
    failed_steals: int = 0
    busy: float = 0.0
    overhead: float = 0.0
    ks: Optional[np.ndarray] = None
    ds: Optional[np.ndarray] = None
    assignment: Optional[np.ndarray] = None  # per-iteration worker id
    # per-dispatched-chunk records (begin, end, worker, work), in dispatch
    # order; filled when simulate(..., record_chunks=True)
    chunk_log: Optional[list] = None
    # per-worker busy time (sum of work/speed dispatched to each worker) —
    # the imbalance diagnostic the measured-cost refiner reports on
    worker_busy: Optional[np.ndarray] = None
    # ---- fault injection (repro_torch.robust, DESIGN.md §2.9) ----
    deaths: int = 0      # workers that retired under an injected death
    stall_events: int = 0
    reclaims: int = 0    # whole-range steals from dead workers' queues
    # ("death", t, w) / ("stall", t, w, duration) /
    # ("reclaim", t, thief, victim, begin, end), in simulated-time order;
    # filled when simulate(..., faults=...) is given a plan
    fault_log: Optional[list] = None

    @property
    def efficiency(self) -> float:
        return self.busy / (self.makespan * self.p) if self.makespan > 0 else 0.0


_SPEEDS_CACHE: dict[tuple[int, float, int], np.ndarray] = {}


def _speeds(p: int, params: SimParams) -> np.ndarray:
    # One stable speed stream per seed: worker w has the same speed at every
    # thread count, so speedups are measured against a consistent baseline.
    # Memoized per (p, jitter, seed): policy-grid sweeps call simulate()
    # hundreds of times with identical params, and re-seeding a default_rng
    # per call was measurable overhead. Cached arrays are frozen read-only.
    key = (p, params.speed_jitter, params.seed)
    s = _SPEEDS_CACHE.get(key)
    if s is None:
        rng = np.random.default_rng(params.seed)
        s = 1.0 + params.speed_jitter * rng.standard_normal(max(p, 64))
        s = np.clip(s[:p], 0.5, None)
        s.setflags(write=False)
        _SPEEDS_CACHE[key] = s
    return s


def simulate(
    costs: np.ndarray,
    p: int,
    policy: P.Policy,
    params: SimParams = SimParams(),
    record_assignment: bool = False,
    estimate: np.ndarray = None,
    record_chunks: bool = False,
    faults=None,
) -> SimResult:
    """`estimate` is the workload estimate HANDED to workload-aware policies
    (binlpt); defaults to the true costs. Passing a stale estimate models
    K-Means-style per-round workload drift (paper §6.1).

    `faults` is an optional `repro_torch.robust.FaultPlan` (DESIGN.md §2.9):
    worker deaths and stalls become discrete events. A dead worker's
    remaining queue is reclaimed by survivors through the steal path
    (whole-range drain — a dead owner never frees its own last item), so
    every iteration is still dispatched exactly once; if every worker dies
    with work outstanding, `FaultError` is raised. Fault replay is
    deterministic: the same plan + params yields an identical trace."""
    costs = np.asarray(costs, dtype=np.float64)
    n = len(costs)
    csum = np.concatenate([[0.0], np.cumsum(costs)])
    res = SimResult(0.0, n, p, policy.label())
    res.worker_busy = np.zeros(p)
    if record_chunks:
        res.chunk_log = []
    if faults is not None:
        faults.validate_workers(p)
        res.fault_log = []
    if n == 0:
        return res
    speeds = _speeds(p, params)
    assignment = np.full(n, -1, dtype=np.int32) if record_assignment else None

    if policy.kind == P.CENTRAL:
        est = costs if estimate is None else np.asarray(estimate, np.float64)
        _simulate_central(costs, csum, p, policy, params, speeds, res,
                          assignment, est, faults)
    else:
        _simulate_distributed(costs, csum, p, policy, params, speeds, res,
                              assignment, faults)
    res.assignment = assignment
    return res


class _FaultState(FaultClock):
    """The shared fault clock plus the simulator's per-worker dead flags."""

    __slots__ = ("dead",)

    def __init__(self, plan, p: int):
        super().__init__(plan, p)
        self.dead = np.zeros(p, dtype=bool)


# ----------------------------------------------------------------------------
# Central-queue family: dynamic / guided / taskloop / binlpt / static
# ----------------------------------------------------------------------------

def _simulate_central(costs, csum, p, policy, params, speeds, res, assignment,
                      estimate=None, faults=None):
    n = len(costs)
    pretiled: Optional[list[tuple[int, int]]] = None
    if policy.law == "pretiled":
        pretiled = P.pretile(policy, costs if estimate is None else estimate, p)
    grab_cost = params.task_overhead if policy.name == "taskloop" else params.dispatch_overhead

    if faults is not None and policy.name in ("assigned", "binlpt"):
        # both bind chunks to workers statically before the run: a dead
        # worker's share has no queue anyone can reclaim it from
        raise ValueError(
            f"policy {policy.name!r} assigns work statically; fault "
            "injection needs a queue survivors can reclaim from")
    fs = _FaultState(faults, p) if faults is not None else None

    if policy.name == "assigned":
        # Static per-chunk worker assignment (policies.assigned): worker w
        # runs its chunks in list order, no queue and no stealing — the
        # simulator twin of the worker-sharded kernel grids. Makespan is
        # the max per-worker finish time; with zero dispatch overhead and
        # jitter it reduces to the partition's max per-worker cost
        # (Schedule.replay_sharded / tests/test_sharding.py).
        if policy.workers and not (0 <= min(policy.workers)
                                   and max(policy.workers) < p):
            raise ValueError(f"assignment names workers outside [0, {p}): "
                             f"[{min(policy.workers)}, "
                             f"{max(policy.workers)}]")
        tw = np.zeros(p)
        for (b, e), w in zip(pretiled, policy.workers or ()):
            work = csum[e] - csum[b]
            tw[w] += grab_cost + work / speeds[w]
            if assignment is not None:
                assignment[b:e] = w
            if res.chunk_log is not None:
                res.chunk_log.append((b, e, w, work))
            res.chunks += 1
            res.busy += work / speeds[w]
            res.worker_busy[w] += work / speeds[w]
            res.overhead += grab_cost
        res.makespan = float(tw.max()) if p else 0.0
        return

    if policy.name == "binlpt":
        # BinLPT (paper ref. 9): equal-work chunks are STATICALLY assigned to
        # threads by LPT on the workload ESTIMATE; threads then run their own
        # bins (no stealing). Imbalance comes from estimate staleness and
        # worker-speed jitter — which is why the paper's binlpt falls behind
        # on-demand methods on skewed workloads.
        est = costs if estimate is None else estimate
        ecsum = np.concatenate([[0.0], np.cumsum(np.asarray(est, np.float64))])
        loads = np.zeros(p)
        bins: list[list[tuple[int, int]]] = [[] for _ in range(p)]
        for (b, e) in pretiled:  # already in descending-work order
            w = int(np.argmin(loads))
            bins[w].append((b, e))
            loads[w] += ecsum[e] - ecsum[b]
        makespan = 0.0
        for w in range(p):
            tw = 0.0
            for (b, e) in bins[w]:
                work = csum[e] - csum[b]
                tw += grab_cost + work / speeds[w]
                if assignment is not None:
                    assignment[b:e] = w
                if res.chunk_log is not None:
                    res.chunk_log.append((b, e, w, work))
                res.chunks += 1
                res.busy += work / speeds[w]
                res.worker_busy[w] += work / speeds[w]
                res.overhead += grab_cost
            makespan = max(makespan, tw)
        res.makespan = makespan
        return

    next_idx = 0          # next unscheduled iteration (law policies)
    next_chunk = 0        # next chunk index (pretiled policies)
    queue_free = 0.0      # central-queue lock availability
    heap: list[tuple[float, int, int]] = [(0.0, w, w) for w in range(p)]
    heapq.heapify(heap)
    seq = p
    makespan = 0.0

    while heap:
        t, _, w = heapq.heappop(heap)
        makespan = max(makespan, t)
        if fs is not None and not fs.dead[w]:
            # fault clock ticks at chunk boundaries: death first (a worker
            # both due to die and due to stall is simply dead), then stalls
            if fs.dies_now(w):
                fs.dead[w] = True
                res.deaths += 1
                res.fault_log.append(("death", t, w))
                continue  # retires: never requeued; queue stays shared
            st = fs.pending_stall(w)
            if st is not None:
                res.stall_events += 1
                res.fault_log.append(("stall", t, w, st.duration))
                seq += 1
                heapq.heappush(heap, (t + st.duration, seq, w))
                continue
        # request work from the central queue
        if pretiled is not None:
            if next_chunk >= len(pretiled):
                continue
            start = max(t, queue_free)
            queue_free = start + grab_cost
            b, e = pretiled[next_chunk]
            next_chunk += 1
        else:
            if next_idx >= n:
                continue
            start = max(t, queue_free)
            queue_free = start + grab_cost
            remaining = n - next_idx
            if policy.law == "guided":
                chunk = P.guided_next_chunk(remaining, p, policy.chunk)
            else:
                chunk = min(policy.chunk, remaining)
            b, e = next_idx, next_idx + chunk
            next_idx = e
        work = csum[e] - csum[b]
        if assignment is not None:
            assignment[b:e] = w
        if res.chunk_log is not None:
            res.chunk_log.append((b, e, w, work))
        done = start + grab_cost + work / speeds[w]
        res.chunks += 1
        if fs is not None:
            fs.chunks_done[w] += 1
        res.busy += work / speeds[w]
        res.worker_busy[w] += work / speeds[w]
        res.overhead += (start - t) + grab_cost
        seq += 1
        heapq.heappush(heap, (done, seq, w))
    if fs is not None:
        stranded = (len(pretiled) - next_chunk if pretiled is not None
                    else n - next_idx)
        if stranded > 0:
            raise FaultError(
                f"every worker died with {stranded} central-queue "
                f"chunk(s)/iteration(s) outstanding")
    res.makespan = makespan


# ----------------------------------------------------------------------------
# Distributed-queue family: stealing / iCh (THE protocol)
# ----------------------------------------------------------------------------

def _simulate_distributed(costs, csum, p, policy, params, speeds, res,
                          assignment, faults=None):
    fs = _FaultState(faults, p) if faults is not None else None
    n = len(costs)
    # Even contiguous initial split (paper §3.1): |q_i| = n/p.
    bounds = np.linspace(0, n, p + 1).astype(np.int64)
    qbegin = bounds[:-1].astype(np.int64).copy()
    qend = bounds[1:].astype(np.int64).copy()
    lock_free = np.zeros(p)
    ks = np.zeros(p)                      # completed-iteration counters k_i
    ds = np.full(p, P.ich_initial_d(p))   # chunk divisors d_i (iCh)
    fails = np.zeros(p, dtype=np.int64)   # consecutive failed steal attempts
    rng = np.random.default_rng(params.seed + 104729 * p)

    # events: (time, seq, worker, kind, payload) kind: 0=idle, 1=chunk-done
    heap: list[tuple[float, int, int, int, int]] = []
    for w in range(p):
        heap.append((0.0, w, w, 0, 0))
    heapq.heapify(heap)
    seq = p
    makespan = 0.0
    remaining_total = n

    def qlen(v: int) -> int:
        return int(qend[v] - qbegin[v])

    def push(t: float, w: int, kind: int, payload: int = 0):
        nonlocal seq
        seq += 1
        heapq.heappush(heap, (t, seq, w, kind, payload))

    while heap:
        t, _, w, kind, payload = heapq.heappop(heap)
        makespan = max(makespan, t)

        if kind == 1:  # chunk completed: update bookkeeping, then go idle
            ks[w] += payload
            if fs is not None:
                fs.chunks_done[w] += 1
            if policy.adaptive:
                mu, delta = W.ich_band(ks, policy.eps)
                ds[w] = W.adapt_d(ds[w], W.classify(ks[w], mu, delta))
                res.overhead += params.adapt_overhead
                push(t + params.adapt_overhead, w, 0)
            else:
                push(t, w, 0)
            continue

        # kind == 0: idle -> dispatch from own queue or steal
        if fs is not None and not fs.dead[w]:
            # fault clock ticks at chunk boundaries (death wins over a
            # stall due at the same boundary); a dead worker's deque keeps
            # its [begin, end) range for survivors to reclaim
            if fs.dies_now(w):
                fs.dead[w] = True
                res.deaths += 1
                res.fault_log.append(("death", t, w))
                continue  # retires; never requeued
            st = fs.pending_stall(w)
            if st is not None:
                res.stall_events += 1
                res.fault_log.append(("stall", t, w, st.duration))
                push(t + st.duration, w, 0)
                continue
        if qlen(w) > 0:
            fails[w] = 0
            start = max(t, lock_free[w])
            lock_free[w] = start + params.local_dispatch_overhead
            ql = qlen(w)
            if policy.adaptive:
                chunk = min(ql, P.ich_chunk(ql, ds[w]))
            else:
                chunk = min(ql, max(1, policy.chunk))
            b = int(qbegin[w])
            e = b + chunk
            qbegin[w] = e
            remaining_total -= chunk
            work = csum[e] - csum[b]
            if assignment is not None:
                assignment[b:e] = w
            if res.chunk_log is not None:
                res.chunk_log.append((b, e, w, work))
            done = start + params.local_dispatch_overhead + work / speeds[w]
            res.chunks += 1
            res.busy += work / speeds[w]
            res.worker_busy[w] += work / speeds[w]
            res.overhead += (start - t) + params.local_dispatch_overhead
            push(done, w, 1, chunk)
            continue

        # Steal path (paper Listing 1, THE protocol). Victim selection is
        # BLIND random probing (a thief cannot see queue sizes without
        # touching the victim's cache line) — the paper's "randomly selecting
        # from nonoptimal choices". An empty probe costs a (remote-penalized)
        # round trip; consecutive failures back off exponentially.
        if remaining_total <= 0:
            continue  # nothing left anywhere: worker retires
        v = int((w + 1 + rng.integers(p - 1)) % p) if p > 1 else w
        remote = (w // params.socket_size) != (v // params.socket_size)
        rmul = params.remote_penalty if remote else 1.0
        # a DEAD victim's queue is reclaimed whole: steal-half would strand
        # its last iteration forever (the owner never drains it), so the
        # thief takes the entire remaining range through the same lock
        dead_v = fs is not None and fs.dead[v]
        if p == 1 or (qlen(v) if dead_v else qlen(v) // 2) <= 0:
            # empty probe: victim has <2 stealable iterations (or a dead
            # victim's queue is already empty)
            res.failed_steals += 1
            probe = params.failed_steal_overhead * rmul
            back = params.failed_steal_overhead * float(2 ** min(fails[w], 10))
            fails[w] += 1
            res.overhead += probe + back
            push(t + probe + back, w, 0)
            continue
        cost = params.steal_overhead * rmul
        start = max(t, lock_free[v])
        lock_free[v] = start + cost
        # re-read under the lock (may have drained)
        take = qlen(v) if dead_v else qlen(v) // 2
        if take <= 0:
            # rollback (paper Listing 1 lines 12-16)
            res.failed_steals += 1
            back = params.failed_steal_overhead * float(2 ** min(fails[w], 10))
            fails[w] += 1
            res.overhead += (start - t) + cost + back
            push(start + cost + back, w, 0)
            continue
        if dead_v:
            b, e = int(qbegin[v]), int(qend[v])
            qbegin[v] = e
            qbegin[w], qend[w] = b, e
            res.reclaims += 1
            res.fault_log.append(("reclaim", start + cost, w, v, b, e))
        else:
            new_end = int(qend[v]) - take
            qend[v] = new_end
            qbegin[w] = new_end
            qend[w] = new_end + take
        res.steals += 1
        fails[w] = 0
        res.overhead += (start - t) + cost
        if policy.adaptive:
            ks[w], ds[w] = W.steal_merge(ks[w], ds[w], ks[v], ds[v])
        push(start + cost, w, 0)

    if fs is not None and remaining_total > 0:
        raise FaultError(
            f"every worker died with {remaining_total} iteration(s) "
            f"stranded in dead workers' queues")
    res.makespan = makespan
    res.ks = ks
    res.ds = ds


# ----------------------------------------------------------------------------
# Schedule replay on refreshed costs (measured-cost feedback, DESIGN.md §2.7)
# ----------------------------------------------------------------------------

def replay_refined(
    unit_costs: np.ndarray,
    ranges,
    p: int,
    workers: Optional[np.ndarray] = None,
    params: SimParams = SimParams(),
    record_chunks: bool = False,
) -> SimResult:
    """Replay an already-constructed schedule's chunk list on a REFRESHED
    per-unit cost array — the deterministic check of refinement quality.

    A constructed schedule fixes `ranges` ([begin, end) chunks in flattened
    work-unit space, e.g. `TileSchedule.slot_ranges()`); `unit_costs` is
    what those units are NOW believed (or measured) to cost, which need not
    be the estimates the schedule was built from. With `workers=None` the
    chunks go through the central pretiled queue (`policies.pretiled`);
    with a per-chunk worker array they replay as the static sharded
    assignment (`policies.assigned`). The makespan answers "what would this
    schedule cost on the true workload" — `Schedule.replay_refined` feeds
    it per-item costs, and the observe/refine loop must drive it down
    (benchmarks/bench_schedule_build.py's refine-loop section,
    tests/test_adaptive_properties.py).
    """
    pol = (P.pretiled(ranges) if workers is None
           else P.assigned(ranges, workers))
    return simulate(np.asarray(unit_costs, np.float64), int(p), pol, params,
                    record_chunks=record_chunks)


# ----------------------------------------------------------------------------
# Paper metrics (§6.1 eq. 9, §6.2 eqs. 10-11)
# ----------------------------------------------------------------------------

def best_time_over_grid(
    costs: np.ndarray, p: int, name: str, params: SimParams = SimParams()
) -> float:
    """T(app, schedule, p): best makespan across the Table 2 parameter grid."""
    times = [
        simulate(costs, p, pol, params).makespan
        for pol in P.paper_policy_grid(p)
        if pol.name == name
    ]
    return float(min(times))


def speedup(costs: np.ndarray, p: int, name: str, params: SimParams = SimParams()) -> float:
    """Paper eq. 9: speedup vs. guided on one thread."""
    t1 = best_time_over_grid(costs, 1, "guided", params)
    tp = best_time_over_grid(costs, p, name, params)
    return t1 / tp


def eps_sensitivity(costs: np.ndarray, p: int, params: SimParams = SimParams()) -> float:
    """Paper eq. 10: worst/best iCh makespan over eps in {25%, 33%, 50%}."""
    times = [simulate(costs, p, P.ich(e), params).makespan for e in (0.25, 0.33, 0.50)]
    return float(max(times) / min(times))


def worst_stealing(costs: np.ndarray, p: int, params: SimParams = SimParams()) -> float:
    """Paper eq. 11: worst-eps iCh over best-chunk stealing."""
    ich_t = max(simulate(costs, p, P.ich(e), params).makespan for e in (0.25, 0.33, 0.50))
    st_t = min(simulate(costs, p, P.stealing(c), params).makespan for c in (1, 2, 3, 64))
    return float(ich_t / st_t)
