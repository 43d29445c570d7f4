"""Dispatch policies for the continuous batcher, compared queue_flex-style
(the port's copy of `repro.serve.policies`).

*A Comparative Study of OpenMP Scheduling Algorithm Selection Strategies*
(PAPERS.md) argues the gap to the best scheduler is closed by comparing
policies per workload; here the "workload" is an offered-load level and the
policies decide, each engine step, (a) WHICH pending prefill advances and
(b) by HOW MANY tokens — while every running decode stream gets one token.
The common `DispatchPolicy` protocol lets benchmarks/bench_serve.py sweep
them against the same seeded arrival trace (the EREW/CREW comparison shape
of the queue_flex exemplar):

* ``fcfs-static`` — requests prefill one at a time in arrival order with a
  FIXED chunk: the head-of-line baseline (a long prompt monopolizes the
  prefill slot, and the chunk never adapts to the machine).
* ``round-robin`` — the fixed chunk rotates across all requests needing
  prefill: fair, but finishes nobody early, so TTFT of EVERY request drifts
  toward the worst case under load.
* ``ich-adaptive`` — the paper's scheduler applied to serving: per-request
  cost = remaining prompt tokens through the `sched` facade
  (`RemainingTokensCosts` + the ``serve-prefill`` registry entry), refined
  across steps from measured step wall-clock via `Schedule.observe/refine`;
  the next prefill target is the cheapest refined stream (finish the
  near-done request first — the stealing intuition: never let a nearly
  empty queue idle behind a heavy one), and the chunk size is the
  per-request iCh divisor ``d`` adapted against the measured throughput
  band exactly like `Engine._adapt` (paper eqs. 1-8).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Protocol, runtime_checkable

import numpy as np

from ..core import welford as W
from ..sched.defaults import ICH_EPS
from .queue import AdmissionQueue, RequestState


@dataclasses.dataclass
class StepPlan:
    """What one engine step will execute: every decoding request advances
    one token; at most one prefill stream advances `prefill_chunk`."""

    decode: list            # list[RequestState]
    prefill: Optional[RequestState] = None
    prefill_chunk: int = 0

    @property
    def n_decode(self) -> int:
        return len(self.decode)

    @property
    def work_tokens(self) -> int:
        return self.n_decode + self.prefill_chunk


@runtime_checkable
class DispatchPolicy(Protocol):
    """The protocol bench_serve sweeps. `choose` must be a pure function of
    queue state (same queue -> same plan: determinism is asserted);
    `observe` feeds the measured step wall-clock back for adaptation."""

    name: str

    def choose(self, queue: AdmissionQueue, now: float = 0.0) -> StepPlan: ...

    def observe(self, plan: StepPlan, dt: float) -> None: ...


def _clamp_chunk(chunk: int, remaining: int, min_chunk: int) -> int:
    return min(max(chunk, min_chunk), remaining)


class FCFSStatic:
    """First-come-first-served prefill with a fixed chunk size."""

    def __init__(self, chunk: int = 64, min_chunk: int = 8):
        self.name = "fcfs-static"
        self.chunk = int(chunk)
        self.min_chunk = int(min_chunk)

    def choose(self, queue: AdmissionQueue, now: float = 0.0) -> StepPlan:
        plan = StepPlan(decode=queue.decoding())
        pre = queue.prefilling()
        if pre:
            st = min(pre, key=lambda s: s.request.req_id)  # arrival order
            plan.prefill = st
            plan.prefill_chunk = _clamp_chunk(
                self.chunk, st.remaining_prefill, self.min_chunk)
        return plan

    def observe(self, plan: StepPlan, dt: float) -> None:
        pass  # static: nothing adapts


class RoundRobin:
    """Fixed chunk, rotating fairly across prefill-needing requests."""

    def __init__(self, chunk: int = 64, min_chunk: int = 8):
        self.name = "round-robin"
        self.chunk = int(chunk)
        self.min_chunk = int(min_chunk)
        self._next = 0

    def choose(self, queue: AdmissionQueue, now: float = 0.0) -> StepPlan:
        plan = StepPlan(decode=queue.decoding())
        pre = sorted(queue.prefilling(), key=lambda s: s.request.req_id)
        if pre:
            st = pre[self._next % len(pre)]
            self._next += 1
            plan.prefill = st
            plan.prefill_chunk = _clamp_chunk(
                self.chunk, st.remaining_prefill, self.min_chunk)
        return plan

    def observe(self, plan: StepPlan, dt: float) -> None:
        pass


class IChAdaptive:
    """iCh-scheduled dispatch through the `sched` facade.

    Target selection: a `Schedule` is constructed over the current
    prefill backlog's remaining-token counts (the ``serve-prefill``
    registry entry / `RemainingTokensCosts`), its per-item cost estimates
    are refined from measured step wall-clock (`Schedule.observe/refine`
    — each step's seconds are attributed to the items it advanced), and
    the next target is the stream with the LEAST refined remaining cost
    (shortest-refined-work-first: drain nearly-done prompts so their
    decode streams start, instead of queueing them behind a monster
    prompt).

    Chunk sizing: the per-request divisor ``d`` (paper §3.2) lives on
    `RequestState`; each observed chunk's token throughput is classified
    against the running band mu +- eps*mu and d halves (slow: grow the
    chunk, amortize dispatch) or doubles (fast: shrink it, leave room for
    interleaved decode).
    """

    def __init__(self, *, eps: float = ICH_EPS, min_chunk: int = 32,
                 d_min: float = 1.0, d_max: float = 64.0, aging: float = 1.0,
                 scheduler=None, refine_every: int = 4):
        self.name = "ich-adaptive"
        self.eps = float(eps)
        self.min_chunk = int(min_chunk)
        self.d_min, self.d_max = float(d_min), float(d_max)
        # SRPT-with-aging: each second a stream waits discounts one
        # `aging`-weighted second of its estimated remaining work, so a
        # monster prompt is deferred, never starved (pure SRPT would hold
        # it to the very end and its e2e would swallow the whole makespan)
        self.aging = float(aging)
        self._scheduler = scheduler  # LoopScheduler (lazy default)
        self.refine_every = int(refine_every)
        self._schedule = None        # current serve-prefill Schedule
        self._sched_ids: list = []   # req ids, aligned with schedule items
        self._observed = 0
        self._last_plan_items: list = []
        # running seconds-per-token baseline: measured chunk slowness is
        # fed to the refiner RELATIVE to this, keeping the measurement on
        # the same token-count scale as the provider's prior costs
        self._spt_sum = 0.0
        self._spt_tokens = 0

    # ---------------------------------------------------- facade plumbing
    @property
    def scheduler(self):
        if self._scheduler is None:
            from repro_torch import sched
            # one-shot cost arrays every step: construction is cheap at
            # per-queue sizes and caching them would only evict real
            # workloads, so this facade instance runs cache-off. The
            # serve-prefill schedule is host numpy and launches nothing:
            # its scheduler lives on the CPU.
            self._scheduler = sched.LoopScheduler(p=1, cache_size=0,
                                                  device="cpu")
        return self._scheduler

    def _refresh_schedule(self, pre: list) -> None:
        """(Re)build the serve-prefill schedule over the current backlog,
        carrying forward refined per-request cost estimates."""
        ids = [st.request.req_id for st in pre]
        remaining = np.array([st.remaining_prefill for st in pre], np.int64)
        sch = self.scheduler.build("serve-prefill", remaining)
        # transplant refined per-token cost for requests surviving from the
        # previous backlog: slowness learned there still applies. The carry
        # goes into BOTH prior and est — `refined_costs` falls back to the
        # prior for never-observed items, so est alone would be wiped by
        # the first refresh.
        if self._schedule is not None and self._sched_ids:
            prev = {rid: float(c) / max(float(s), 1.0)
                    for rid, c, s in zip(self._sched_ids,
                                         self._schedule.refiner
                                             .refresh_estimates(),
                                         self._schedule.sizes)}
            per_tok = np.array([prev.get(rid, 1.0) for rid in ids])
            carried = np.maximum(remaining, 1) * per_tok
            r = sch.refiner
            r.prior[:] = carried
            r.est[:] = carried
        self._schedule = sch
        self._sched_ids = ids

    # ------------------------------------------------------------- choose
    def choose(self, queue: AdmissionQueue, now: float = 0.0) -> StepPlan:
        plan = StepPlan(decode=queue.decoding())
        pre = sorted(queue.prefilling(), key=lambda s: s.request.req_id)
        self._last_plan_items = []
        if not pre:
            return plan
        ids = [st.request.req_id for st in pre]
        if ids != self._sched_ids or self._schedule is None:
            self._refresh_schedule(pre)
        est = self._schedule.refiner.refresh_estimates()
        # shortest-refined-work-first with aging: refined token estimates
        # convert to seconds at the running seconds-per-token baseline,
        # minus the time the stream has already waited; req_id breaks
        # ties -> deterministic
        spt = (self._spt_sum / self._spt_tokens if self._spt_tokens
               else 1e-4)
        order = sorted(
            range(len(pre)),
            key=lambda i: (est[i] * spt
                           - self.aging * (now - pre[i].t_admit), ids[i]))
        st = pre[order[0]]
        chunk = int(np.ceil(st.remaining_prefill / st.d))
        chunk = _clamp_chunk(chunk, st.remaining_prefill, self.min_chunk)
        if st.remaining_prefill - chunk < self.min_chunk:
            # fold the tail: a sub-min_chunk remainder would cost a whole
            # extra step of fixed overhead for a sliver of work
            chunk = st.remaining_prefill
        plan.prefill = st
        plan.prefill_chunk = chunk
        self._last_plan_items = [order[0]]
        return plan

    # ------------------------------------------------------------ observe
    def observe(self, plan: StepPlan, dt: float) -> None:
        if plan.prefill is None:
            return
        st, chunk = plan.prefill, plan.prefill_chunk
        # (a) per-request iCh band: classify measured chunk throughput and
        #     adapt the divisor exactly like Engine._adapt
        thr = chunk / max(dt, 1e-9)
        st.ks.append(thr)
        mu, delta = W.ich_band(np.asarray(st.ks[-16:]), self.eps)
        st.d = W.adapt_d(st.d, W.classify(thr, mu, delta),
                         d_min=self.d_min, d_max=self.d_max)
        # (b) facade feedback: attribute this step's wall seconds to the
        #     advanced item's unit range. The sample is expressed on the
        #     provider's token-count scale as covered_tokens * relative
        #     slowness (chunk seconds-per-token over the running global
        #     baseline) — normalizing a single chunk to its OWN estimate
        #     mass would make the sample equal the estimate and learn
        #     nothing.
        if self._schedule is None or not self._last_plan_items:
            return
        self._spt_sum += max(dt, 0.0)
        self._spt_tokens += chunk
        i = self._last_plan_items[0]
        sizes = self._schedule.sizes
        begin = int(sizes[:i].sum())
        covered = min(chunk, int(sizes[i]))
        if covered <= 0 or self._spt_sum <= 0:
            return
        mean_spt = self._spt_sum / max(self._spt_tokens, 1)
        rel = (max(dt, 1e-9) / max(chunk, 1)) / mean_spt
        self._schedule.refiner.observe_unit_ranges(
            [(begin, begin + covered)], np.array([covered * rel]))
        self._observed += 1
        if self._observed % self.refine_every == 0:
            try:
                self._schedule = self._schedule.refine()
            except Exception:
                self._schedule = None  # rebuild lazily on next choose()


def default_policies(chunk: int = 64) -> list:
    """The bench's standard comparison set (>= 3 policies)."""
    return [FCFSStatic(chunk=chunk), RoundRobin(chunk=chunk), IChAdaptive()]
