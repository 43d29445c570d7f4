"""Deterministic, seeded fault injection for the scheduler stack — the
port's copy of `repro.robust.faults`, element-identical to it.

The paper's pitch is that iCh + work-stealing stays near-best *without
tuning* because stealing absorbs surprises; this module makes the surprises
first-class and replayable (DESIGN.md §2.9). A `FaultPlan` is a frozen,
seeded description of everything that will go wrong in one run:

* **worker deaths** — worker `w` retires permanently after completing
  `after_chunks` chunks. Its already-completed work stands; its *queued*
  work is reclaimed by survivors through the existing steal machinery
  (whole-range drain instead of steal-half, because a dead owner will
  never drain its own last item).
* **transient stalls** — worker `w` goes unresponsive for `duration`
  (seconds on the threaded executor, simulated time units in the
  discrete-event simulator) at a chunk boundary, then resumes.
* **flaky / poisoned items** — a seeded fraction of loop bodies raise
  `InjectedFault` on their first `flaky_failures` attempts (recoverable by
  the executor's per-item retry budget); `poison` items raise on EVERY
  attempt (a permanent fault that must propagate to the caller).
* **corrupted cost estimates** — multiplicative lognormal noise on the
  per-item cost array handed to schedule construction (the workload the
  stealing layer must absorb at runtime).

Everything derived from a plan is a pure function of ``(plan, n, p)`` with
its own `numpy` Generator streams, so a chaos run replays bit-identically:
the same plan yields the same flaky-item set, the same corruption, the same
death/stall points — asserted in `tests/test_torch_simulator.py`.

This module is numpy-only and imports nothing from `repro_torch.core`, so the
simulator and executor can import it without cycles; `simulate_faulty`
imports the simulator lazily.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import threading
from typing import Callable, Optional, Union

import numpy as np

_NEVER = 1 << 62  # "after more chunks than any run dispatches"


class InjectedFault(RuntimeError):
    """Raised by a ChaosBody-wrapped loop body at a planned fault site."""


class FaultError(RuntimeError):
    """Unrecoverable fault outcome: work remained but no live worker could
    execute it (e.g. every worker died), or a static assignment cannot
    reclaim a dead worker's share."""


@dataclasses.dataclass(frozen=True)
class Death:
    """Worker `worker` retires right before dispatching its
    (`after_chunks`+1)-th chunk; completed chunks stand, queued work is
    reclaimed by survivors."""

    worker: int
    after_chunks: int = 0

    def __post_init__(self):
        if self.worker < 0:
            raise ValueError(f"worker must be >= 0, got {self.worker}")
        if self.after_chunks < 0:
            raise ValueError(
                f"after_chunks must be >= 0, got {self.after_chunks}")


@dataclasses.dataclass(frozen=True)
class Stall:
    """Worker `worker` goes unresponsive for `duration` at the chunk
    boundary after completing `after_chunks` chunks, then resumes (the
    executor's watchdog may declare it dead in the meantime, in which case
    its queue is reclaimed by survivors and the worker retires on wake)."""

    worker: int
    after_chunks: int = 0
    duration: float = 1.0

    def __post_init__(self):
        if self.worker < 0:
            raise ValueError(f"worker must be >= 0, got {self.worker}")
        if self.after_chunks < 0:
            raise ValueError(
                f"after_chunks must be >= 0, got {self.after_chunks}")
        if self.duration < 0:
            raise ValueError(f"duration must be >= 0, got {self.duration}")



@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """One seeded, frozen chaos scenario; every derived stream replays
    bit-identically for the same plan."""

    seed: int = 0
    deaths: tuple = ()       # tuple[Death, ...] (bare (w, k) pairs coerced)
    stalls: tuple = ()       # tuple[Stall, ...] (bare tuples coerced)
    flaky_frac: float = 0.0  # fraction of items that fail transiently
    flaky_failures: int = 1  # failed attempts per flaky item before success
    poison: tuple = ()       # item indices that fail on EVERY attempt
    cost_noise: float = 0.0  # lognormal sigma of estimate corruption

    def __post_init__(self):
        object.__setattr__(self, "deaths", tuple(
            d if isinstance(d, Death) else Death(*d) for d in self.deaths))
        object.__setattr__(self, "stalls", tuple(
            s if isinstance(s, Stall) else Stall(*s) for s in self.stalls))
        object.__setattr__(self, "poison",
                           tuple(int(i) for i in self.poison))
        if not (0.0 <= self.flaky_frac <= 1.0):
            raise ValueError(
                f"flaky_frac must be in [0, 1], got {self.flaky_frac}")
        if self.flaky_failures < 1:
            raise ValueError(
                f"flaky_failures must be >= 1, got {self.flaky_failures}")
        if self.cost_noise < 0:
            raise ValueError(
                f"cost_noise must be >= 0, got {self.cost_noise}")

    # ------------------------------------------------------ derived streams
    def validate_workers(self, p: int) -> None:
        """Reject plans naming workers a p-worker run does not have —
        a silently ignored death would make a chaos test vacuously green."""
        for f in (*self.deaths, *self.stalls):
            if f.worker >= p:
                raise ValueError(
                    f"fault plan names worker {f.worker} but the run has "
                    f"p={p} workers")

    def death_after(self, p: int) -> np.ndarray:
        """(p,) chunk count after which each worker dies (huge = never)."""
        self.validate_workers(p)
        after = np.full(p, _NEVER, dtype=np.int64)
        for d in self.deaths:
            after[d.worker] = min(after[d.worker], d.after_chunks)
        return after

    def stalls_for(self, p: int) -> list:
        """Per-worker stall lists, each sorted by `after_chunks`."""
        self.validate_workers(p)
        per: list[list[Stall]] = [[] for _ in range(p)]
        for s in self.stalls:
            per[s.worker].append(s)
        for lst in per:
            lst.sort(key=lambda s: s.after_chunks)
        return per

    def flaky_items(self, n: int) -> np.ndarray:
        """Sorted item indices chosen to fail transiently (seeded)."""
        k = int(round(self.flaky_frac * n))
        if k == 0:
            return np.empty(0, dtype=np.int64)
        rng = np.random.default_rng(self.seed)
        return np.sort(rng.choice(n, size=k, replace=False)).astype(np.int64)

    def corrupt_costs(self, costs: np.ndarray) -> np.ndarray:
        """Cost estimates under multiplicative lognormal corruption —
        what schedule construction sees when its cost model is wrong.
        Identity (a copy) when `cost_noise` is 0."""
        costs = np.asarray(costs, np.float64)
        if self.cost_noise == 0.0:
            return costs.copy()
        rng = np.random.default_rng(self.seed + 1)
        return costs * np.exp(
            self.cost_noise * rng.standard_normal(costs.shape))

    def wrap_body(self, body: Callable[[int], None], n: int):
        """`body` with this plan's flaky/poison faults injected; returns
        `body` unchanged when the plan injects no body faults."""
        if self.flaky_frac == 0.0 and not self.poison:
            return body
        return ChaosBody(self, n, body)

    @property
    def has_body_faults(self) -> bool:
        return self.flaky_frac > 0.0 or bool(self.poison)

    # ------------------------------------------------------ serialization
    def to_json(self) -> str:
        """Canonical JSON for this plan (sorted keys, no whitespace) —
        the journal/CI artifact form. `from_json(to_json(p)) == p` for
        every valid plan, and equal plans serialize to equal strings, so
        `fingerprint()` is a stable identity."""
        return json.dumps({
            "seed": int(self.seed),
            "deaths": [[d.worker, d.after_chunks] for d in self.deaths],
            "stalls": [[s.worker, s.after_chunks, s.duration]
                       for s in self.stalls],
            "flaky_frac": float(self.flaky_frac),
            "flaky_failures": int(self.flaky_failures),
            "poison": list(self.poison),
            "cost_noise": float(self.cost_noise),
        }, sort_keys=True, separators=(",", ":"))

    @classmethod
    def from_json(cls, blob: Union[str, dict]) -> "FaultPlan":
        """Inverse of `to_json` (also accepts an already-parsed dict).
        Round-trips through `__post_init__`, so invalid serialized plans
        are rejected with the same errors as invalid constructor args."""
        d = json.loads(blob) if isinstance(blob, str) else dict(blob)
        return cls(
            seed=int(d.get("seed", 0)),
            deaths=tuple(Death(int(w), int(a))
                         for w, a in d.get("deaths", ())),
            stalls=tuple(Stall(int(w), int(a), float(dur))
                         for w, a, dur in d.get("stalls", ())),
            flaky_frac=float(d.get("flaky_frac", 0.0)),
            flaky_failures=int(d.get("flaky_failures", 1)),
            poison=tuple(d.get("poison", ())),
            cost_noise=float(d.get("cost_noise", 0.0)),
        )

    def fingerprint(self) -> str:
        """Short stable content hash of the canonical JSON. A journal
        stamps this in its header so resume can refuse to continue under
        a different chaos plan than the one the prefix ran under."""
        return hashlib.sha256(self.to_json().encode()).hexdigest()[:16]


class FaultClock:
    """Per-run fault bookkeeping shared by the simulator and the threaded
    executor: when each worker dies, which stalls it has left, and how many
    chunks it has completed — the layer-independent fault clock (faults
    trigger at chunk boundaries in BOTH layers, which is what makes one
    plan replayable across them)."""

    __slots__ = ("death_after", "stalls", "stall_idx", "chunks_done")

    def __init__(self, plan: FaultPlan, p: int):
        self.death_after = plan.death_after(p)
        self.stalls = plan.stalls_for(p)
        self.stall_idx = [0] * p
        self.chunks_done = np.zeros(p, dtype=np.int64)

    def dies_now(self, w: int) -> bool:
        return bool(self.chunks_done[w] >= self.death_after[w])

    def pending_stall(self, w: int) -> Optional[Stall]:
        """The next unconsumed stall due at (or before) w's current chunk
        count, consumed on read; None when w runs undisturbed."""
        i = self.stall_idx[w]
        lst = self.stalls[w]
        if i < len(lst) and lst[i].after_chunks <= self.chunks_done[w]:
            self.stall_idx[w] = i + 1
            return lst[i]
        return None


class ChaosBody:
    """A loop body wrapped with planned faults: flaky items raise
    `InjectedFault` on their first `flaky_failures` attempts then succeed
    (the executor's retry budget is the recovery path); poisoned items
    raise on every attempt. Thread-safe; `injected` counts faults fired."""

    def __init__(self, plan: FaultPlan, n: int, body: Callable[[int], None]):
        self._body = body
        self._lock = threading.Lock()
        self._left = {int(i): plan.flaky_failures
                      for i in plan.flaky_items(n)}
        self._poison = frozenset(plan.poison)
        self.injected = 0

    def __call__(self, i: int):
        i = int(i)
        if i in self._poison:
            with self._lock:
                self.injected += 1
            raise InjectedFault(f"poisoned item {i}")
        fire = False
        with self._lock:
            left = self._left.get(i, 0)
            if left > 0:
                self._left[i] = left - 1
                self.injected += 1
                fire = True
        if fire:
            raise InjectedFault(f"transient fault at item {i}")
        return self._body(i)


@dataclasses.dataclass
class FaultReport:
    """A chaos run next to its fault-free twin (same costs, policy, p,
    time model, simulator seed — only the plan differs)."""

    faulty: object  # SimResult
    clean: object   # SimResult
    plan: FaultPlan

    @property
    def inflation(self) -> float:
        """Makespan inflation vs the fault-free run (>= ~1.0: losing
        workers can only slow a run down, modulo steal-path luck)."""
        if self.clean.makespan <= 0:
            return 1.0
        return float(self.faulty.makespan / self.clean.makespan)


def simulate_faulty(costs, p: int, policy, plan: FaultPlan, *,
                    params=None, record_chunks: bool = False,
                    record_assignment: bool = False) -> FaultReport:
    """Run the discrete-event simulator twice — fault-free and under
    `plan` — and return both results with the makespan inflation. Both
    runs are deterministic, so the report replays bit-identically."""
    from repro_torch.core import simulator as S  # lazy: avoids an import cycle

    prm = params if params is not None else S.SimParams()
    clean = S.simulate(np.asarray(costs, np.float64), int(p), policy, prm,
                       record_chunks=record_chunks,
                       record_assignment=record_assignment)
    faulty = S.simulate(np.asarray(costs, np.float64), int(p), policy, prm,
                        record_chunks=record_chunks,
                        record_assignment=record_assignment, faults=plan)
    return FaultReport(faulty=faulty, clean=clean, plan=plan)
