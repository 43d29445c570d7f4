"""Real threaded fork-join executor for the scheduler family — the port's
copy of `repro.core.executor`, element-identical to it (numpy only).

This is the host-side realization of the paper's runtime (the analogue of the
libgomp implementation): actual ``threading.Thread`` workers, per-worker
deques with locks, THE-protocol steal-half with rollback, and iCh's adaptive
chunk bookkeeping. On a host with few CPU cores it cannot demonstrate
wall-clock speedup (the simulator covers scheduler quality); its job is to
prove the *policy implementations* are operational under real concurrency:
every iteration executes exactly once, steals happen, counters stay sane.

The `repro_torch.sched.LoopScheduler` facade reaches it through
`Schedule.parallel_for` / `parallel_for_units`.

Measured-cost feedback (DESIGN.md §2.7): with ``record_chunks=True`` the
executor records one ``(begin, end, worker, elapsed_seconds)`` entry per
dispatched chunk — on BOTH the central-queue and distributed-deque paths —
and, on the distributed path, one ``(thief, victim, begin, end)`` entry per
committed steal. These are the wall-clock observations
``Schedule.observe`` folds back into the cost refiner. Because thread
interleaving is nondeterministic, ``deterministic=True`` additionally runs
the SAME per-worker dispatch/steal logic cooperatively (round-robin, one
dispatch-or-steal attempt per turn, single thread): with a fixed seed the
chunk and steal logs are bit-reproducible run to run, which is what pins
the instrumentation's accounting in tests (`tests/test_torch_executor.py`).

Supervision & fault recovery (DESIGN.md §2.9): workers are supervised —
the first exception a worker thread raises is captured, aborts the run,
and re-raises in the caller (a raising ``body`` can never silently return
partial results). Each item gets a retry budget with bounded exponential
backoff (``retries`` / ``retry_backoff_s``); a seeded
`repro_torch.robust.FaultPlan` (``faults=``) injects worker deaths, stalls, and
flaky/poisoned bodies at deterministic points; a watchdog (``watchdog_s``)
declares workers that stop heartbeating dead so survivors reclaim their
deque range through the steal path (whole-range drain — a dead owner never
frees its own last item). Recovery preserves the exactly-once invariant:
completed chunks stand, queued ranges move atomically under the deque
locks, and a run that cannot complete (every worker dead with work
outstanding) raises `FaultError` instead of hanging.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Optional

import numpy as np

from . import policies as P
from . import welford as W
from repro_torch.robust.faults import FaultClock, FaultError, FaultPlan

# bound on the per-retry exponential backoff sleep
RETRY_BACKOFF_CAP_S = 0.1


@dataclasses.dataclass
class ExecStats:
    chunks: int = 0
    steals: int = 0
    failed_steals: int = 0
    ks: Optional[np.ndarray] = None
    ds: Optional[np.ndarray] = None
    # per-dispatched-chunk records (begin, end, worker, elapsed_seconds),
    # appended at chunk completion; filled when record_chunks=True
    chunk_log: Optional[list] = None
    # per-committed-steal records (thief, victim, begin, end), in commit
    # order; filled when record_chunks=True on the distributed path
    steal_log: Optional[list] = None
    # ---- supervision / fault recovery (DESIGN.md §2.9) ----
    retries: int = 0          # re-attempts after a body exception
    deaths: int = 0           # workers retired (injected death or watchdog)
    stall_events: int = 0     # injected stalls taken
    reclaims: int = 0         # whole-range drains of dead workers' deques
    faults_observed: int = 0  # body exceptions + deaths + stalls seen
    faults_recovered: int = 0  # retried-to-success items + reclaims
    # ("death", worker, chunks_done) / ("stall", worker, chunks_done, dur) /
    # ("watchdog_kill", worker) / ("reclaim", thief, victim, begin, end);
    # filled when faults= or watchdog_s= is active. Under deterministic=True
    # the log is bit-reproducible for a fixed plan/seed.
    fault_log: Optional[list] = None


class _Deque:
    """[begin, end) index deque guarded by a lock (THE-protocol shaped)."""

    __slots__ = ("begin", "end", "lock")

    def __init__(self, begin: int, end: int):
        self.begin = begin
        self.end = end
        self.lock = threading.Lock()

    def pop_front(self, chunk: int) -> tuple[int, int]:
        """Owner-side dispatch: take up to `chunk` iterations from the front."""
        with self.lock:
            take = min(chunk, self.end - self.begin)
            if take <= 0:
                return 0, 0
            b = self.begin
            self.begin = b + take
            return b, b + take

    def steal_back_half(self) -> tuple[int, int]:
        """Thief-side: steal half the remaining range from the back
        (paper Listing 1; rollback == returning an empty range)."""
        with self.lock:
            half = (self.end - self.begin) // 2
            if half <= 0:
                return 0, 0
            new_end = self.end - half
            self.end = new_end
            return new_end, new_end + half

    def drain(self) -> tuple[int, int]:
        """Thief-side reclaim of a DEAD owner's queue: take the ENTIRE
        remaining range. Steal-half would strand the last iteration forever
        (the owner will never dispatch it), so recovery drains whole."""
        with self.lock:
            b, e = self.begin, self.end
            self.begin = e
            return b, e

    def size(self) -> int:
        return self.end - self.begin


def _attempt(body, i: int, retries: int, backoff_s: float,
             stats: ExecStats, stats_lock, sleep_fn=None) -> None:
    """Run `body(i)` under the per-item retry budget: transient failures
    are re-attempted up to `retries` times with bounded exponential
    backoff; a still-failing item re-raises (and the supervisor aborts the
    run). Retrying per ITEM — not per chunk — is what keeps the
    exactly-once invariant: items before the failing one are never
    re-executed. `sleep_fn` replaces `time.sleep` for the backoff wait
    (tests and simulated clocks pass a no-op / virtual sleep so retry
    suites cost zero wall-clock)."""
    if sleep_fn is None:
        sleep_fn = time.sleep
    attempt = 0
    while True:
        try:
            body(i)
            if attempt:
                with stats_lock:
                    stats.faults_recovered += 1
            return
        except Exception:
            with stats_lock:
                stats.faults_observed += 1
            if attempt >= retries:
                raise
            attempt += 1
            with stats_lock:
                stats.retries += 1
            delay = min(backoff_s * (2 ** (attempt - 1)),
                        RETRY_BACKOFF_CAP_S)
            if delay > 0:
                sleep_fn(delay)


def parallel_for(
    n: int,
    body: Callable[[int], None],
    p: int,
    policy: P.Policy,
    seed: int = 0,
    record_chunks: bool = False,
    deterministic: bool = False,
    faults: Optional[FaultPlan] = None,
    retries: int = 0,
    retry_backoff_s: float = 0.0,
    watchdog_s: Optional[float] = None,
    sleep_fn: Optional[Callable[[float], None]] = None,
) -> ExecStats:
    """Run `body(i)` for i in [0, n) on `p` threads under `policy`.

    `record_chunks` fills `ExecStats.chunk_log` (and `steal_log` on
    distributed policies); `deterministic` replaces the threads with a
    cooperative round-robin driver over the same per-worker logic, so the
    recorded logs are bit-reproducible for a fixed seed.

    Supervision: worker exceptions abort the run and re-raise here;
    `retries`/`retry_backoff_s` give each item a transient-failure budget;
    `faults` injects a seeded `repro_torch.robust.FaultPlan` (deaths, stalls,
    flaky/poisoned bodies — deaths trigger at chunk boundaries, queued
    work is reclaimed by survivors); `watchdog_s` (threaded distributed
    path only) declares a worker dead after that many seconds without a
    heartbeat and re-enqueues its deque range for stealing. Under a plan
    every iteration still executes exactly once unless NO live worker
    remains, which raises `FaultError`. Injected stalls sleep for their
    duration on threads; the deterministic driver logs them and charges
    one round-robin turn instead (turns, not wall time, are its clock).
    `sleep_fn` replaces `time.sleep` for retry backoff AND injected stall
    waits (pass a no-op to run chaos/retry suites at zero wall-clock
    without changing the recorded fault logs).
    """
    stats = ExecStats()
    stats_lock = threading.Lock()
    if record_chunks:
        stats.chunk_log = []
    if faults is not None or watchdog_s is not None:
        stats.fault_log = []
    fc = None
    if faults is not None:
        faults.validate_workers(p)
        fc = FaultClock(faults, p)
        body = faults.wrap_body(body, n)

    if policy.kind == P.CENTRAL:
        _run_central(n, body, p, policy, stats, stats_lock, deterministic,
                     fc=fc, retries=retries, backoff_s=retry_backoff_s,
                     sleep_fn=sleep_fn)
    else:
        if record_chunks:
            stats.steal_log = []
        _run_distributed(n, body, p, policy, stats, stats_lock, seed,
                         deterministic, fc=fc, retries=retries,
                         backoff_s=retry_backoff_s, watchdog_s=watchdog_s,
                         sleep_fn=sleep_fn)
    return stats


# step outcomes shared by both families' per-worker logic
_RAN, _STOLE, _FAILED, _EMPTY, _DEAD, _STALLED = range(6)


def _fault_gate(w, fc, dead, stats, stats_lock, deterministic,
                sleep_fn=None) -> Optional[int]:
    """The per-step fault clock check both families run at chunk
    boundaries: returns a step outcome when worker w dies/stalls/was
    already declared dead, else None (proceed to dispatch)."""
    if fc is not None and not dead[w]:
        if fc.dies_now(w):
            dead[w] = True
            with stats_lock:
                stats.deaths += 1
                stats.faults_observed += 1
                stats.fault_log.append(
                    ("death", w, int(fc.chunks_done[w])))
            return _DEAD
        st = fc.pending_stall(w)
        if st is not None:
            with stats_lock:
                stats.stall_events += 1
                stats.faults_observed += 1
                stats.fault_log.append(
                    ("stall", w, int(fc.chunks_done[w]), st.duration))
            if not deterministic:
                (sleep_fn or time.sleep)(st.duration)
            return _STALLED
    if dead[w]:  # planned death or watchdog declaration
        return _DEAD
    return None


def _run_central(n, body, p, policy, stats, stats_lock, deterministic=False,
                 fc=None, retries=0, backoff_s=0.0, sleep_fn=None):
    pos = [0]
    tiles: Optional[list[tuple[int, int]]] = None
    if policy.law == "pretiled":
        # pretiled central policies need a workload estimate; with none
        # available at execution time we fall back to equal-count tiles.
        uniform = np.ones(n)
        tiles = P.pretile(policy if policy.name != "binlpt" else P.taskloop(p), uniform, p)
    qlock = threading.Lock()
    dead = np.zeros(p, dtype=bool)

    def grab() -> tuple[int, int]:
        with qlock:
            if tiles is not None:
                if pos[0] >= len(tiles):
                    return 0, 0
                t = tiles[pos[0]]
                pos[0] += 1
                return t
            if pos[0] >= n:
                return 0, 0
            remaining = n - pos[0]
            if policy.law == "guided":
                c = P.guided_next_chunk(remaining, p, policy.chunk)
            else:
                c = min(policy.chunk, remaining)
            b = pos[0]
            pos[0] = b + c
            return b, b + c

    def step(w: int) -> int:
        """One chunk grab + execution for (virtual) worker w."""
        gate = _fault_gate(w, fc, dead, stats, stats_lock, deterministic,
                           sleep_fn)
        if gate is not None:
            return gate
        b, e = grab()
        if e <= b:
            return _EMPTY
        record = stats.chunk_log is not None  # clock reads only when asked
        t0 = time.perf_counter() if record else 0.0
        for i in range(b, e):
            _attempt(body, i, retries, backoff_s, stats, stats_lock,
                     sleep_fn)
        if record:
            dt = time.perf_counter() - t0
        if fc is not None:
            fc.chunks_done[w] += 1
        with stats_lock:
            stats.chunks += 1
            if record:
                stats.chunk_log.append((b, e, w, dt))
        return _RAN

    if deterministic:
        live = list(range(p))
        while live:
            live = [w for w in live if step(w) in (_RAN, _STALLED)]
    else:
        abort = threading.Event()

        def worker(w: int):
            while not abort.is_set():
                r = step(w)
                if r in (_DEAD, _EMPTY):
                    return

        _run_threads(worker, p, abort)

    if fc is not None:
        stranded = ((len(tiles) - pos[0]) if tiles is not None
                    else (n - pos[0]))
        if stranded > 0:
            raise FaultError(
                f"every worker died with {stranded} central-queue "
                f"chunk(s)/iteration(s) outstanding")


def _run_distributed(n, body, p, policy, stats, stats_lock, seed,
                     deterministic=False, fc=None, retries=0, backoff_s=0.0,
                     watchdog_s=None, sleep_fn=None):
    bounds = np.linspace(0, n, p + 1).astype(np.int64)
    deques = [_Deque(int(bounds[i]), int(bounds[i + 1])) for i in range(p)]
    ks = np.zeros(p)
    ds = np.full(p, P.ich_initial_d(p))
    dead = np.zeros(p, dtype=bool)
    heartbeat = [time.perf_counter()] * p
    rngs = [np.random.default_rng(seed + w) for w in range(p)]

    def step(w: int) -> int:
        """One dispatch-or-steal attempt for worker w — the unit the
        threaded loop AND the deterministic round-robin driver share."""
        gate = _fault_gate(w, fc, dead, stats, stats_lock, deterministic,
                           sleep_fn)
        if gate is not None:
            return gate
        heartbeat[w] = time.perf_counter()
        q = deques[w]
        if policy.adaptive:
            chunk = P.ich_chunk(q.size(), ds[w])
        else:
            chunk = max(1, policy.chunk)
        b, e = q.pop_front(chunk)
        if e > b:
            record = stats.chunk_log is not None
            t0 = time.perf_counter() if record else 0.0
            for i in range(b, e):
                _attempt(body, i, retries, backoff_s, stats, stats_lock,
                         sleep_fn)
            if record:
                dt = time.perf_counter() - t0
            ks[w] += e - b
            if policy.adaptive:
                mu, delta = W.ich_band(ks, policy.eps)
                ds[w] = W.adapt_d(ds[w], W.classify(ks[w], mu, delta))
            if fc is not None:
                fc.chunks_done[w] += 1
            with stats_lock:
                stats.chunks += 1
                if record:
                    stats.chunk_log.append((b, e, w, dt))
            return _RAN
        # steal phase
        victims = [v for v in range(p) if v != w and deques[v].size() > 0]
        if not victims:
            return _EMPTY
        v = int(victims[rngs[w].integers(len(victims))])
        if dead[v]:
            # reclaim: the owner is dead, take its whole remaining range
            sb, se = deques[v].drain()
        else:
            sb, se = deques[v].steal_back_half()
        if se <= sb:
            with stats_lock:
                stats.failed_steals += 1
            return _FAILED
        if policy.adaptive:
            ks[w], ds[w] = W.steal_merge(ks[w], ds[w], ks[v], ds[v])
        dq = deques[w]
        with dq.lock:
            dq.begin, dq.end = sb, se
        with stats_lock:
            stats.steals += 1
            if dead[v]:
                stats.reclaims += 1
                stats.faults_recovered += 1
                stats.fault_log.append(("reclaim", w, v, sb, se))
            if stats.steal_log is not None:
                stats.steal_log.append((w, v, sb, se))
        return _STOLE

    if deterministic:
        # Cooperative round-robin: worker 0..p-1 each take one step per
        # sweep. A worker retires when it dies or when its step found no
        # work anywhere (steals within the sweep re-activate nobody: once
        # every deque is empty it stays empty — steals only move work
        # between deques; a DEAD worker's nonempty deque keeps survivors
        # in rotation until they reclaim it).
        live = list(range(p))
        while live:
            nxt = []
            for w in live:
                r = step(w)
                if r == _DEAD:
                    continue
                if r == _EMPTY and all(d.size() == 0 for d in deques):
                    continue
                nxt.append(w)
            live = nxt
    else:
        abort = threading.Event()
        stop_watchdog = threading.Event()
        monitor = None
        if watchdog_s is not None:
            def watchdog():
                # Declares a worker dead when its heartbeat goes stale
                # while its deque still holds work: survivors then reclaim
                # the range via drain(). The declared worker retires at
                # its next step (a Python thread cannot be killed; if it
                # was merely slow, its current chunk still completes —
                # exactly-once is preserved either way).
                while not stop_watchdog.wait(watchdog_s / 4.0):
                    now = time.perf_counter()
                    for v in range(p):
                        if (not dead[v] and deques[v].size() > 0
                                and now - heartbeat[v] > watchdog_s):
                            dead[v] = True
                            with stats_lock:
                                stats.deaths += 1
                                stats.faults_observed += 1
                                stats.fault_log.append(("watchdog_kill", v))

            monitor = threading.Thread(target=watchdog, daemon=True)
            monitor.start()

        def worker(w: int):
            while not abort.is_set():
                r = step(w)
                if r == _DEAD:
                    return
                if r != _EMPTY:
                    continue
                if all(deques[v].size() == 0 for v in range(p)):
                    return
                # other workers may still publish stolen work; loop on

        try:
            _run_threads(worker, p, abort)
        finally:
            stop_watchdog.set()
            if monitor is not None:
                monitor.join()

    stats.ks = ks
    stats.ds = ds
    if fc is not None or watchdog_s is not None:
        stranded = sum(d.size() for d in deques)
        if stranded > 0:
            raise FaultError(
                f"every worker died with {stranded} iteration(s) stranded "
                f"in dead workers' deques")


def _run_threads(fn, p, abort: Optional[threading.Event] = None):
    """Run fn(0..p-1) on real threads, supervised: the first exception any
    worker raises is captured and RE-RAISED here in the caller — a raising
    `body` must never silently return partial results (the pre-robustness
    behavior lost worker exceptions entirely). On failure `abort` is set so
    sibling workers drain out at their next step instead of spinning
    against a dead worker's nonempty deque."""
    errors: list[tuple[int, BaseException]] = []
    elock = threading.Lock()

    def run(w: int):
        try:
            fn(w)
        except BaseException as e:  # noqa: BLE001 - supervisor re-raises
            with elock:
                errors.append((w, e))
            if abort is not None:
                abort.set()

    threads = [threading.Thread(target=run, args=(w,)) for w in range(p)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        # deterministic choice among racing failures: lowest worker id
        errors.sort(key=lambda we: we[0])
        raise errors[0][1]
