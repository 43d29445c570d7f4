"""Self-scheduling policy descriptors (paper §2.1, §5.2, Table 2) — the
port's copy of the `Policy` dataclass and its constructors from
`repro.core.policies`.

A policy is part of a schedule's identity (the schedule cache keys on the
full frozen dataclass), supplies iCh's epsilon for the tile-width band,
and drives the discrete-event simulator (`core.simulator`) and the
threaded executor (`core.executor`) through the chunk laws below. Two
families exist:

* central-queue policies — ``dynamic``, ``guided``, ``taskloop``, ``binlpt``,
  ``static``, ``pretiled``, ``assigned``;
* distributed-queue policies — ``stealing``, ``ich``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np

from repro_torch.sched.defaults import ICH_EPS

CENTRAL = "central"
DISTRIBUTED = "distributed"


@dataclasses.dataclass(frozen=True)
class Policy:
    name: str
    kind: str
    # central-queue chunk law: one of "fixed", "guided", "pretiled"
    law: str = "fixed"
    chunk: int = 1
    # distributed-queue parameters
    adaptive: bool = False  # True only for iCh
    eps: float = ICH_EPS  # iCh epsilon (paper grid: 25%, 33%, 50%)
    # pretiled chunk policies (taskloop / binlpt / static / pretiled)
    num_tasks: Optional[int] = None  # taskloop: num_tasks = p
    binlpt_chunks: Optional[int] = None  # binlpt: max number of chunks
    explicit: Optional[tuple] = None  # pretiled: ((begin, end), ...)
    # assigned: static per-chunk worker ids (parallel to `explicit`)
    workers: Optional[tuple] = None

    def label(self) -> str:
        if self.name == "ich":
            return f"ich(eps={self.eps:g})"
        if self.name == "taskloop":
            return "taskloop"
        if self.name == "binlpt":
            return f"binlpt({self.binlpt_chunks})"
        if self.name == "pretiled":
            return f"pretiled({len(self.explicit or ())})"
        if self.name == "assigned":
            return f"assigned({len(self.explicit or ())})"
        return f"{self.name}({self.chunk})"


def dynamic(chunk: int = 1) -> Policy:
    """OpenMP ``schedule(dynamic, chunk)``: central queue, fixed chunk."""
    return Policy("dynamic", CENTRAL, law="fixed", chunk=chunk)


def guided(chunk: int = 1) -> Policy:
    """OpenMP ``schedule(guided, chunk)``: chunk = max(remaining/p, chunk)."""
    return Policy("guided", CENTRAL, law="guided", chunk=chunk)


def taskloop(num_tasks: Optional[int] = None) -> Policy:
    """OpenMP ``taskloop num_tasks(p)``: p contiguous equal-count tasks."""
    return Policy("taskloop", CENTRAL, law="pretiled", num_tasks=num_tasks)


def binlpt(nchunks: int = 384) -> Policy:
    """BinLPT (paper ref. 9): workload-aware equal-work chunking + LPT
    order."""
    return Policy("binlpt", CENTRAL, law="pretiled", binlpt_chunks=nchunks)


def static() -> Policy:
    """OpenMP ``schedule(static)``: p contiguous equal-count blocks."""
    return Policy("static", CENTRAL, law="pretiled", num_tasks=-1)


def pretiled(chunks) -> Policy:
    """Explicit central-queue chunk list, e.g. a tile schedule's ranges."""
    return Policy("pretiled", CENTRAL, law="pretiled",
                  explicit=tuple((int(b), int(e)) for b, e in chunks))


def assigned(chunks, workers) -> Policy:
    """Explicit chunk list with a STATIC per-chunk worker assignment: chunk
    i runs on workers[i], no queue, no stealing."""
    chunks = tuple((int(b), int(e)) for b, e in chunks)
    workers = tuple(int(w) for w in workers)
    if len(workers) != len(chunks):
        raise ValueError(f"{len(chunks)} chunks but {len(workers)} worker "
                         "assignments")
    if workers and min(workers) < 0:
        raise ValueError(f"worker ids must be >= 0, got {min(workers)}")
    return Policy("assigned", CENTRAL, law="pretiled", explicit=chunks,
                  workers=workers)


def stealing(chunk: int = 1) -> Policy:
    """Generic work-stealing with fixed chunk (paper's base algorithm)."""
    return Policy("stealing", DISTRIBUTED, chunk=chunk, adaptive=False)


def ich(eps: float = ICH_EPS) -> Policy:
    """iCh: adaptive chunk work-stealing (the paper's contribution)."""
    return Policy("ich", DISTRIBUTED, adaptive=True, eps=eps)


# ----------------------------------------------------------------------------
# Chunk laws / pretiling helpers (shared by simulator and executor)
# ----------------------------------------------------------------------------

def guided_next_chunk(remaining: int, p: int, min_chunk: int) -> int:
    """Guided self-scheduling law (paper §2.1): ~remaining/p, floored."""
    return max(min(remaining, min_chunk), int(math.ceil(remaining / p)))


def pretile(policy: Policy, costs: np.ndarray, p: int) -> list[tuple[int, int]]:
    """Build the chunk list for pretiled central policies.

    Returns [(begin, end), ...] in the order workers will be offered them.
    """
    n = len(costs)
    if policy.explicit is not None:
        return [(int(b), int(e)) for b, e in policy.explicit]
    if policy.name in ("taskloop", "static"):
        k = p if (policy.num_tasks is None or policy.num_tasks < 0) else policy.num_tasks
        k = max(1, min(k, n))
        bounds = np.linspace(0, n, k + 1).astype(np.int64)
        return [(int(bounds[i]), int(bounds[i + 1])) for i in range(k) if bounds[i] < bounds[i + 1]]
    if policy.name == "binlpt":
        k = max(p, min(policy.binlpt_chunks or p, n))
        # Equal-WORK contiguous chunking from the (known) workload estimate.
        csum = np.concatenate([[0.0], np.cumsum(costs, dtype=np.float64)])
        total = csum[-1]
        targets = np.linspace(0, total, k + 1)
        bounds = np.searchsorted(csum, targets, side="left")
        bounds[0], bounds[-1] = 0, n
        bounds = np.unique(bounds)
        chunks = [(int(bounds[i]), int(bounds[i + 1])) for i in range(len(bounds) - 1)]
        # LPT order: heaviest chunks are handed out first.
        work = [float(csum[e] - csum[b]) for b, e in chunks]
        order = np.argsort(work)[::-1]
        return [chunks[i] for i in order]
    raise ValueError(f"not a pretiled policy: {policy.name}")


def ich_initial_d(p: int) -> float:
    """Paper §3.1: d_i = p so that the initial chunk is |q_i|/p = n/p^2."""
    return float(p)


def ich_chunk(queue_len: int, d_i: float) -> int:
    """chunk = ceil(|q_i| / d_i), at least 1 (consistent w/ paper Fig. 2)."""
    if queue_len <= 0:
        return 0
    return max(1, int(math.ceil(queue_len / d_i)))


def paper_policy_grid(p: int) -> list[Policy]:
    """The full Table 2 parameter grid used in the paper's evaluation."""
    grid: list[Policy] = []
    grid += [guided(c) for c in (1, 2, 3)]
    grid += [dynamic(c) for c in (1, 2, 3)]
    grid += [taskloop(p)]
    grid += [binlpt(c) for c in (128, 384, 576)]
    grid += [stealing(c) for c in (1, 2, 3, 64)]
    grid += [ich(e) for e in (0.25, 0.33, 0.50)]
    return grid
