"""Self-scheduling policy descriptors (paper §2.1, §5.2, Table 2) — the
port's copy of the `Policy` dataclass and its constructors from
`repro.core.policies`.

In this package a policy is part of a schedule's identity (the schedule
cache keys on the full frozen dataclass) and supplies iCh's epsilon for the
tile-width band. Two families exist:

* central-queue policies — ``dynamic``, ``guided``, ``taskloop``, ``binlpt``,
  ``static``, ``pretiled``, ``assigned``;
* distributed-queue policies — ``stealing``, ``ich``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

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
