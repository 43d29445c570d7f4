"""The continuous batcher: interleaved decode + chunked prefill per step
(the port's copy of `repro.serve.batcher`).

One engine step (Sarathi-style continuous batching) assembles

    [ one decode token for EVERY running decode stream ]
  + [ one prefill chunk for ONE policy-chosen stream  ]

so decode latency stays bounded while prefills make progress. WHICH
stream prefills and HOW LARGE the chunk is are the dispatch policy's
calls (serve/policies.py); the `ich-adaptive` policy routes them through
the `sched` facade with per-request cost = remaining prompt tokens,
refined each step from the measured step wall-clock.

Two execution backends behind one `step_plan` contract:

* `SimBackend` — no model, a seeded `StepCostModel` prices each step
  (fixed dispatch overhead + per-decode-token + context-dependent
  per-prefill-token + lognormal jitter) and a `SimClock` advances by it.
  Bit-deterministic: CI and benchmarks/bench_serve.py sweep offered load
  on this backend with zero machine noise.
* `EngineBackend` — the real `serve.engine.Engine` under a `WallClock`;
  each request owns its KV cache and the step executes per-request
  (B=1), so interleaving is bit-identical to serial execution
  (tests/test_serve_batch.py).

Faults: a `FaultPlan`'s stalls apply to the batcher loop as worker
0 — a pending stall at a step boundary adds its duration to that step's
clock, and deadline handling must DEGRADE the affected requests (shed
remaining decode, keep the prefix) rather than blow their SLOs silently
(tests/test_serve_slo_chaos.py).

Durability (DESIGN.md §2.11): pass ``journal=`` (a
`repro_torch.robust.ServeJournal`) and the batcher appends every admission,
`StepPlan`, stall, and completion as a JSON line; because every policy
decision and simulated cost is a pure function of seeds + recorded
events, replaying the journal through a fresh batcher
(`repro_torch.robust.resume_from_journal`) reconstructs the exact pre-crash
state — queue, per-request iCh bands, policy internals, metrics — and
the resumed run is bit-identical to an uninterrupted one. `snapshot()`
captures the same state directly for cross-checks and for
`ContinuousBatcher.restore`. The `EngineBackend` boundary is hardened:
a per-op retry budget (the executor's `_attempt` contract) plus a
`CircuitBreaker` turn a flaky backend into degraded requests via the
deadline path instead of an exception out of the batcher loop.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Optional

import numpy as np

from ..core import executor as E
from ..robust.faults import FaultClock, FaultError, FaultPlan, InjectedFault
from .loadgen import Arrival, OpenPoissonLoadGen
from .metrics import ServeMetrics
from .policies import DispatchPolicy, StepPlan
from .queue import AdmissionQueue, Request, RequestState


# --------------------------------------------------------------------- clocks
class WallClock:
    """Real time (monotonic)."""

    def now(self) -> float:
        return time.monotonic()

    def advance(self, dt: float) -> None:  # wall time advances itself
        pass


class SimClock:
    """Simulated serving clock: starts at 0, advances only when told."""

    def __init__(self, t0: float = 0.0):
        self._t = float(t0)

    def now(self) -> float:
        return self._t

    def advance(self, dt: float) -> None:
        if dt < 0:
            raise ValueError(f"clock cannot run backwards (dt={dt})")
        self._t += float(dt)

    def jump(self, t: float) -> None:
        """Set the clock outright — journal replay snaps it to each
        RECORDED step time so a wall-clock run's deadline decisions
        replay exactly (accumulated float drift would otherwise flip a
        borderline shed)."""
        self._t = float(t)


# ----------------------------------------------------------------- cost model
@dataclasses.dataclass(frozen=True)
class StepCostModel:
    """Prices one batched engine step for the simulated backend.

    seconds = overhead
            + n_decode * decode_token_s
            + chunk * prefill_token_s * (1 + ctx / ctx_scale)
            + lognormal jitter (seeded per step)

    The context term makes LATE chunks of a long prompt cost more per
    token than early ones (attention over the growing KV prefix) — the
    nonuniformity the iCh divisor and the cost refiner exist to track.
    """

    overhead_s: float = 2e-3
    decode_token_s: float = 2e-4
    prefill_token_s: float = 5e-5
    ctx_scale: float = 512.0
    jitter_sigma: float = 0.10
    seed: int = 0

    def step_seconds(self, plan: StepPlan, step_idx: int) -> float:
        cost = self.overhead_s + plan.n_decode * self.decode_token_s
        if plan.prefill is not None and plan.prefill_chunk > 0:
            ctx = plan.prefill.prefill_done
            cost += (plan.prefill_chunk * self.prefill_token_s
                     * (1.0 + ctx / self.ctx_scale))
        if self.jitter_sigma > 0:
            rng = np.random.default_rng((self.seed << 24) + step_idx)
            cost *= float(rng.lognormal(0.0, self.jitter_sigma))
        return cost


# ------------------------------------------------------------------- backends
class SimBackend:
    """Advance request state logically; a `StepCostModel` prices the step.

    Generated token ids are a deterministic function of (req_id, position)
    so interleaving order can never change outputs — the simulated twin of
    the real backend's bit-identity property."""

    def __init__(self, cost_model: Optional[StepCostModel] = None):
        self.cost_model = cost_model if cost_model is not None \
            else StepCostModel()
        self.wall_clock = False

    def execute(self, plan: StepPlan, step_idx: int) -> float:
        dt = self.cost_model.step_seconds(plan, step_idx)
        for st in plan.decode:
            st.out_tokens.append(
                int((st.request.req_id * 7919 + len(st.out_tokens)) % 251))
        if plan.prefill is not None and plan.prefill_chunk > 0:
            st = plan.prefill
            st.prefill_done += plan.prefill_chunk
            if st.remaining_prefill == 0:
                # prefill's final logits yield the first generated token
                st.out_tokens.append(int((st.request.req_id * 7919) % 251))
        return dt


class CircuitBreaker:
    """Three-state breaker guarding the engine boundary (DESIGN.md §2.11).

    closed --[threshold consecutive failed steps]--> open
    open   --[cooldown_steps engine steps pass]----> half_open (one probe)
    half_open --success--> closed    half_open --failure--> open

    The cooldown is measured in ENGINE STEPS, not seconds, so breaker
    behaviour is deterministic under the simulated clock and replays
    bit-identically from a journal. While open, `allow()` is False and
    the backend skips the step's ops entirely — requests stop making
    progress and the deadline path degrades them, which is the intended
    failure mode for a down backend (bounded, accounted, no exception).
    """

    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"

    def __init__(self, *, threshold: int = 3, cooldown_steps: int = 8):
        if threshold < 1 or cooldown_steps < 1:
            raise ValueError("threshold and cooldown_steps must be >= 1")
        self.threshold = int(threshold)
        self.cooldown_steps = int(cooldown_steps)
        self.state = self.CLOSED
        self.failures = 0          # consecutive failed steps while closed
        self.opened_at = -1        # step_idx of the last trip
        self.n_trips = 0

    def allow(self, step_idx: int) -> bool:
        """May this step touch the engine? Transitions open->half_open
        once the cooldown has elapsed (the single probe step)."""
        if self.state == self.OPEN:
            if step_idx - self.opened_at >= self.cooldown_steps:
                self.state = self.HALF_OPEN
                return True
            return False
        return True

    def record_success(self) -> None:
        self.state = self.CLOSED
        self.failures = 0

    def record_failure(self, step_idx: int) -> None:
        self.failures += 1
        if self.state == self.HALF_OPEN or self.failures >= self.threshold:
            self.state = self.OPEN
            self.opened_at = int(step_idx)
            self.failures = 0
            self.n_trips += 1

    # ------------------------------------------------------------- snapshot
    def state_dict(self) -> dict:
        return {"threshold": self.threshold,
                "cooldown_steps": self.cooldown_steps, "state": self.state,
                "failures": self.failures, "opened_at": self.opened_at,
                "n_trips": self.n_trips}

    @classmethod
    def from_state(cls, d: dict) -> "CircuitBreaker":
        b = cls(threshold=d["threshold"], cooldown_steps=d["cooldown_steps"])
        b.state = d["state"]
        b.failures = int(d["failures"])
        b.opened_at = int(d["opened_at"])
        b.n_trips = int(d["n_trips"])
        return b


class EngineBackend:
    """Execute the plan on the real `serve.engine.Engine`, one request at
    a time (B=1): each `RequestState` owns its KV cache and iCh band, so
    a step's work is a pure function of per-request state and interleaved
    execution is bit-identical to running the requests serially.

    The boundary is hardened (DESIGN.md §2.11): each engine op runs under
    the executor's `_attempt` retry contract (`retries` attempts with
    bounded exponential backoff, `sleep_fn=` injectable so retry suites
    cost zero wall-clock), and a terminal `FaultError`/`InjectedFault` is
    ABSORBED — the op's request simply makes no progress this step, and
    the deadline path eventually degrades it. A `CircuitBreaker` stops
    hammering an engine that fails whole steps consecutively. Real bugs
    (any other exception type) still propagate.
    """

    def __init__(self, engine, *, retries: int = 0,
                 retry_backoff_s: float = 0.0,
                 breaker: Optional[CircuitBreaker] = None,
                 open_step_s: float = 0.0,
                 sleep_fn: Optional[Callable[[float], None]] = None):
        self.engine = engine
        self.wall_clock = True
        self.retries = int(retries)
        self.retry_backoff_s = float(retry_backoff_s)
        self.breaker = breaker
        # seconds charged to a breaker-skipped step so a simulated clock
        # still advances toward the deadlines that degrade stuck requests
        self.open_step_s = float(open_step_s)
        self.sleep_fn = sleep_fn
        self.n_faults = 0           # terminal per-op faults absorbed
        self._stats = E.ExecStats()
        self._lock = threading.Lock()

    @property
    def n_retries(self) -> int:
        return self._stats.retries

    def _op(self, fn: Callable[[], None]) -> bool:
        """One engine op under the retry budget; False = fault absorbed."""
        try:
            E._attempt(lambda _i: fn(), 0, self.retries,
                       self.retry_backoff_s, self._stats, self._lock,
                       self.sleep_fn)
            return True
        except (FaultError, InjectedFault):
            self.n_faults += 1
            return False

    def execute(self, plan: StepPlan, step_idx: int) -> float:
        t0 = time.monotonic()
        if self.breaker is not None and not self.breaker.allow(step_idx):
            return (time.monotonic() - t0) + self.open_step_s
        ok = True
        for st in plan.decode:
            if not self._op(lambda st=st: self.engine.decode_one(st)):
                ok = False
        if plan.prefill is not None and plan.prefill_chunk > 0:
            if not self._op(lambda: self.engine.prefill_chunk_step(
                    plan.prefill, plan.prefill_chunk)):
                ok = False
        if self.breaker is not None:
            if ok:
                self.breaker.record_success()
            else:
                self.breaker.record_failure(step_idx)
        return time.monotonic() - t0

    # ---------------------------------------------- restore (DESIGN.md §2.11)
    def rebuild_state(self, st: RequestState) -> None:
        """Re-derive `st.cache`/`st.last_logits` after a snapshot restore.

        KV caches are never serialized; instead the journaled prefill
        chunk SIZES are replayed through `prefill_chunk_step` — identical
        chunking means identical `prefill_extend` calls, so the rebuilt
        cache is bit-identical (§2.10's chunk-invariance) — then the
        already-emitted decode tokens are re-derived with `decode_one`.
        The replayed tokens must match the snapshot or the restore is
        refused.
        """
        if st.prefill_done == 0 and not st.out_tokens:
            st.cache = None
            st.last_logits = None
            return
        tmp = RequestState(request=st.request, status=st.status, d=st.d)
        for rec in st.chunk_log:
            c = min(int(rec["chunk"]), tmp.remaining_prefill)
            if c > 0:
                self.engine.prefill_chunk_step(tmp, c)
        if tmp.prefill_done != st.prefill_done:
            raise ValueError(
                f"chunk log replays to {tmp.prefill_done} prefill tokens "
                f"but the snapshot recorded {st.prefill_done}")
        while len(tmp.out_tokens) < len(st.out_tokens):
            self.engine.decode_one(tmp)
        if tmp.out_tokens != [int(t) for t in st.out_tokens]:
            raise ValueError("replayed tokens diverge from the snapshot; "
                             "refusing to resume on a different engine")
        st.cache = tmp.cache
        st.last_logits = tmp.last_logits


# ------------------------------------------------------------------- batcher
class ContinuousBatcher:
    """Open-loop serving loop: admission queue + policy + backend.

    `run(arrivals, ...)` releases requests at their arrival stamps (the
    open loop: arrivals never wait for completions, so overload shows up
    as backlog and tail latency, not reduced offered load), steps the
    engine until drained, and accounts TTFT / per-token / e2e latency
    into `ServeMetrics`.
    """

    JOURNAL_VERSION = 1

    def __init__(self, policy: DispatchPolicy, *,
                 queue: Optional[AdmissionQueue] = None,
                 backend=None, clock=None,
                 faults: Optional[FaultPlan] = None,
                 metrics: Optional[ServeMetrics] = None,
                 journal=None):
        self.policy = policy
        self.queue = queue if queue is not None else AdmissionQueue()
        self.backend = backend if backend is not None else SimBackend()
        if clock is None:
            clock = WallClock() if getattr(self.backend, "wall_clock",
                                           False) else SimClock()
        self.clock = clock
        self.metrics = metrics if metrics is not None else ServeMetrics()
        self.faults = faults
        self.fault_clock = (FaultClock(faults, 1)
                            if faults is not None else None)
        self.step_idx = 0
        self._t_start: Optional[float] = None
        self._submitted_ids: set = set()
        self.journal = journal
        if journal is not None:
            journal.append(self._header())

    def _header(self) -> dict:
        cm = getattr(self.backend, "cost_model", None)
        return {"ev": "header", "version": self.JOURNAL_VERSION,
                "policy": type(self.policy).__name__,
                "backend": type(self.backend).__name__,
                "cost_model": (dataclasses.asdict(cm)
                               if cm is not None else None),
                "queue": {"max_pending": self.queue.max_pending,
                          "max_running": self.queue.max_running,
                          "init_divisor": self.queue.init_divisor},
                "faults": (self.faults.to_json()
                           if self.faults is not None else None),
                "faults_fp": (self.faults.fingerprint()
                              if self.faults is not None else None)}

    def _j(self, ev: dict) -> None:
        if self.journal is not None:
            self.journal.append(ev)

    # ------------------------------------------------------------ lifecycle
    def submit(self, req: Request) -> Optional[RequestState]:
        self.metrics.n_arrived += 1
        self._submitted_ids.add(req.req_id)
        st = self.queue.submit(req)
        if st is None:
            self.metrics.n_shed_admission += 1
            self.metrics.n_tokens_shed += req.n_new
        else:
            self.metrics.n_admitted += 1
        self._j({"ev": "submit", "req": req.to_dict(),
                 "admitted": st is not None})
        return st

    def _shed_expired(self, now: float) -> None:
        """Deadline enforcement at step boundaries: a running request past
        its SLO budget sheds its remaining decode steps and finalizes
        DEGRADED — the per-request deadline contract (prefix kept, n_shed
        counted, never an exception)."""
        for st in list(self.queue.running):
            if not st.past_deadline(now):
                continue
            shed = (st.remaining_decode if st.remaining_prefill == 0
                    else st.request.n_new - len(st.out_tokens))
            if shed > 0:
                st.degraded = True
                st.n_shed = shed
                self.metrics.n_degraded += 1
                self.metrics.n_tokens_shed += shed
            self._finalize(st, now)

    def _finalize(self, st: RequestState, now: float) -> None:
        self.queue.finish(st, now)
        self.metrics.n_completed += 1
        self.metrics.n_tokens_out += len(st.out_tokens)
        if st.t_first_token is not None:
            self.metrics.ttft.record(
                st.t_first_token - st.request.t_arrival)
        self.metrics.e2e.record(now - st.request.t_arrival)
        self._j({"ev": "finish", "req_id": st.request.req_id, "t": now,
                 "degraded": st.degraded, "n_shed": st.n_shed,
                 "n_tok": len(st.out_tokens)})

    # ----------------------------------------------------------------- step
    def step(self, _dt_override: Optional[float] = None) -> bool:
        """One engine step; returns False when there was nothing to do.

        `_dt_override` is the journal-replay hook: `resume_from_journal`
        passes the RECORDED step duration so a wall-clock run's measured
        timings replay exactly (simulated backends never need it — their
        costs are already pure functions of seeds)."""
        now = self.clock.now()
        self.queue.admit(now)
        self._shed_expired(now)
        plan = self.policy.choose(self.queue, now)
        if plan.prefill is None and not plan.decode:
            return False
        idx = self.step_idx
        prefill_st = plan.prefill
        n_out_before = {id(st): len(st.out_tokens) for st in plan.decode}
        dt = self.backend.execute(plan, idx)
        # stalls from a FaultPlan hit the batcher loop as worker 0:
        # the stall's duration lands on this step's clock, and the
        # deadline check at the NEXT boundary degrades what it blew
        if self.fault_clock is not None:
            self.fault_clock.chunks_done[0] += 1
            stall = self.fault_clock.pending_stall(0)
            if stall is not None:
                dt += stall.duration
                self._j({"ev": "stall", "i": idx,
                         "duration": stall.duration})
        if _dt_override is not None:
            dt = float(_dt_override)
        self.clock.advance(dt)
        self.step_idx += 1
        now = self.clock.now()
        self._j({"ev": "step", "i": idx,
                 "decode": [st.request.req_id for st in plan.decode],
                 "prefill": (prefill_st.request.req_id
                             if prefill_st is not None else None),
                 "chunk": plan.prefill_chunk, "dt": dt, "t": now})
        # ---- account decode tokens ----
        for st in plan.decode:
            if len(st.out_tokens) > n_out_before[id(st)]:
                if st.t_last_token is not None:
                    self.metrics.per_token.record(now - st.t_last_token)
                st.t_last_token = now
                if st.t_first_token is None:  # decode-started-first stream
                    st.t_first_token = now
        # ---- account the prefill chunk ----
        if prefill_st is not None and plan.prefill_chunk > 0:
            prefill_st.chunk_log.append(
                {"chunk": plan.prefill_chunk, "dt": dt, "d": prefill_st.d})
            if prefill_st.remaining_prefill == 0 and prefill_st.out_tokens:
                # prefill completed this step: its final logits produced
                # the request's first token
                prefill_st.t_first_token = now
                prefill_st.t_last_token = now
        # ---- hardened-boundary counters (EngineBackend only) ----
        if hasattr(self.backend, "n_faults"):
            self.metrics.n_backend_faults = self.backend.n_faults
            self.metrics.n_backend_retries = self.backend.n_retries
            if self.backend.breaker is not None:
                self.metrics.n_breaker_trips = self.backend.breaker.n_trips
        # surface any O(n^2) prefix-rerun prefill chunks the engine took
        eng = getattr(self.backend, "engine", None)
        if eng is not None and hasattr(eng, "n_prefill_fallbacks"):
            self.metrics.n_prefill_fallback = eng.n_prefill_fallbacks
        self.policy.observe(plan, dt)
        # ---- retire finished streams ----
        for st in list(self.queue.running):
            if (st.remaining_prefill == 0
                    and len(st.out_tokens) >= st.request.n_new):
                self._finalize(st, now)
        return True

    # ------------------------------------------------------------------ run
    def run(self, arrivals: list, *,
            make_request: Callable[[Arrival], Request],
            max_steps: int = 100_000) -> ServeMetrics:
        """Drive the full open-loop trace to completion.

        `arrivals` are released when the serving clock reaches their
        stamp; when the queue is idle but arrivals remain, the clock
        jumps to the next stamp (simulated clock) or sleeps (wall clock).
        Resumable: a restored batcher keeps its original `t_start`, and
        arrivals already submitted before the crash are skipped.
        """
        pending = sorted(arrivals, key=lambda a: (a.t, a.req_id))
        i = 0
        if self._t_start is None:
            self._t_start = self.clock.now()
            self._j({"ev": "run", "t_start": self._t_start})
        t_start = self._t_start
        for _ in range(max_steps):
            now = self.clock.now()
            while i < len(pending) and pending[i].t + t_start <= now:
                if pending[i].req_id not in self._submitted_ids:
                    # shift the arrival onto the serving clock so
                    # latencies and deadlines measure from the actual
                    # release stamp
                    a = dataclasses.replace(pending[i],
                                            t=pending[i].t + t_start)
                    self.submit(make_request(a))
                i += 1
            if not self.step():
                if i >= len(pending):
                    if self.queue.n_outstanding == 0:
                        break
                    # outstanding but unsteppable should be impossible:
                    # admit() promotes whenever a slot is free
                    self.queue.admit(now)
                    continue
                gap = pending[i].t + t_start - now
                if isinstance(self.clock, SimClock):
                    self._j({"ev": "gap", "dt": gap})
                    self.clock.advance(gap)
                else:  # pragma: no cover - wall-clock idle
                    time.sleep(min(gap, 0.05))
        self.metrics.t_elapsed = self.clock.now() - t_start
        return self.metrics

    # ------------------------------------------- snapshot (DESIGN.md §2.11)
    def snapshot(self) -> dict:
        """JSON-serializable full batcher state at a step boundary.

        Captures everything `restore` needs EXCEPT policy internals and
        KV caches: stateless policies (`fcfs-static`, `round-robin` up to
        its cursor) restore exactly; the iCh-adaptive policy's refiner
        state is replay-derived (use `resume_from_journal` when policy
        internals must survive bit-exactly); KV caches are re-derived by
        `EngineBackend.rebuild_state`.
        """
        return {"version": self.JOURNAL_VERSION,
                "step_idx": self.step_idx,
                "t_now": self.clock.now(), "t_start": self._t_start,
                "queue": self.queue.state_dict(),
                "metrics": self.metrics.state_dict(),
                "fault_clock": (None if self.fault_clock is None else
                                {"chunks_done":
                                     [int(c) for c in
                                      self.fault_clock.chunks_done],
                                 "stall_idx":
                                     [int(s) for s in
                                      self.fault_clock.stall_idx]}),
                "breaker": (self.backend.breaker.state_dict()
                            if getattr(self.backend, "breaker", None)
                            is not None else None)}

    @classmethod
    def restore(cls, snap: dict, *, policy: DispatchPolicy, backend=None,
                clock=None, faults: Optional[FaultPlan] = None,
                journal=None) -> "ContinuousBatcher":
        """Rebuild a batcher from `snapshot()` output.

        The clock defaults to a `SimClock` resumed at the snapshot's
        serving-clock time (pass `clock=` to override). Running requests
        get their KV re-derived via `backend.rebuild_state` when the
        backend provides it.
        """
        if snap.get("version") != cls.JOURNAL_VERSION:
            raise ValueError(
                f"snapshot version {snap.get('version')} != "
                f"{cls.JOURNAL_VERSION}")
        q = AdmissionQueue.from_state(snap["queue"])
        m = ServeMetrics.from_state(snap["metrics"])
        if clock is None:
            clock = SimClock(snap["t_now"])
        b = cls(policy, queue=q, backend=backend, clock=clock,
                faults=faults, metrics=m, journal=journal)
        b.step_idx = int(snap["step_idx"])
        b._t_start = snap["t_start"]
        for group in ("pending", "running", "done"):
            for s in snap["queue"][group]:
                b._submitted_ids.add(int(s["request"]["req_id"]))
        for r in snap["queue"]["shed"]:
            b._submitted_ids.add(int(r["req_id"]))
        fc_state = snap.get("fault_clock")
        if b.fault_clock is not None and fc_state is not None:
            for w, c in enumerate(fc_state["chunks_done"]):
                b.fault_clock.chunks_done[w] = int(c)
            for w, s in enumerate(fc_state["stall_idx"]):
                b.fault_clock.stall_idx[w] = int(s)
        if (snap.get("breaker") is not None
                and getattr(b.backend, "breaker", None) is not None):
            b.backend.breaker = CircuitBreaker.from_state(snap["breaker"])
        if hasattr(b.backend, "rebuild_state"):
            for st in b.queue.running:
                b.backend.rebuild_state(st)
        return b


def make_request_factory(gen: OpenPoissonLoadGen, *,
                         vocab_size: int) -> Callable[[Arrival], Request]:
    """Arrival -> Request using the load generator's seeded prompt
    tokens; the factory bench_serve and the quickstart share."""

    def make(a: Arrival) -> Request:
        return Request(req_id=a.req_id,
                       tokens=gen.prompt_tokens(a, vocab_size),
                       n_new=a.n_new, deadline_s=a.deadline_s,
                       t_arrival=a.t)

    return make
