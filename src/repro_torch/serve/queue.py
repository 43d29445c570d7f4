"""Admission-controlled request queue: pending/running/done lifecycle
(the port's copy of `repro.serve.queue`).

The continuous batcher (serve/batcher.py) owns one `AdmissionQueue`.
Requests flow

    submit() -> PENDING -> admit() -> RUNNING -> DONE
           \\-> shed (bounded queue overflow, deterministic)

and every request carries its own `RequestState`: the per-request iCh
divisor band (``d``, ``ks`` — moved OFF the engine singleton, so two
interleaved requests can no longer pollute each other's band), the prefill
cursor, the KV cache, the generated tokens, and the latency timestamps the
metrics layer reads. `deadline_s` is the per-request SLO budget
(DESIGN.md §2.9): when the serving clock overruns it mid-decode the
batcher sheds the remaining steps and finalizes the request `degraded`
with the same ``degraded``/``n_shed`` contract `Engine.generate` exposes.

Numpy-only: no torch import, the queue works identically under the real
engine and the simulated-clock backend.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any, Optional

import numpy as np

PENDING, RUNNING, DONE, SHED = "pending", "running", "done", "shed"


@dataclasses.dataclass(frozen=True)
class Request:
    """What the client submitted (immutable)."""

    req_id: int
    tokens: np.ndarray           # (1, S) int prompt
    n_new: int                   # decode budget
    deadline_s: Optional[float] = None   # e2e SLO budget from arrival
    t_arrival: float = 0.0

    def __post_init__(self):
        t = np.asarray(self.tokens)
        if t.ndim == 1:
            t = t[None, :]
        if t.ndim != 2 or t.shape[0] != 1 or t.shape[1] < 1:
            raise ValueError(
                f"prompt must be (1, S>=1) or (S>=1,), got {t.shape}")
        object.__setattr__(self, "tokens", t)
        if self.n_new < 1:
            raise ValueError(f"n_new must be >= 1, got {self.n_new}")

    @property
    def prompt_len(self) -> int:
        return int(self.tokens.shape[1])

    def to_dict(self) -> dict:
        """JSON-serializable form (journal admission events, snapshots)."""
        return {"req_id": int(self.req_id),
                "tokens": [int(t) for t in self.tokens[0]],
                "n_new": int(self.n_new), "deadline_s": self.deadline_s,
                "t_arrival": float(self.t_arrival)}

    @classmethod
    def from_dict(cls, d: dict) -> "Request":
        return cls(req_id=int(d["req_id"]),
                   tokens=np.asarray(d["tokens"], np.int32),
                   n_new=int(d["n_new"]), deadline_s=d.get("deadline_s"),
                   t_arrival=float(d.get("t_arrival", 0.0)))


@dataclasses.dataclass
class RequestState:
    """Per-request runtime state (one per admitted request).

    The iCh fields are the paper's per-worker (d_i, k_i) pair scoped to the
    request's prefill stream: `d` divides the remaining prompt into the
    next chunk, `ks` is the measured chunk-throughput history the band
    classifies against. `cache`/`last_logits` are opaque to the queue (torch
    tensors under the real engine, None under the simulated backend).
    """

    request: Request
    status: str = PENDING
    # ---- iCh chunk state (per request, NOT per engine) ----
    d: float = 4.0
    ks: list = dataclasses.field(default_factory=list)
    chunk_log: list = dataclasses.field(default_factory=list)
    # ---- prefill / decode cursors ----
    prefill_done: int = 0
    cache: Any = None
    last_logits: Any = None
    out_tokens: list = dataclasses.field(default_factory=list)
    # ---- SLO outcome (the generate() deadline contract, per request) ----
    degraded: bool = False
    n_shed: int = 0
    # ---- timestamps (serving-clock seconds) ----
    t_admit: float = 0.0
    t_first_token: Optional[float] = None
    t_last_token: Optional[float] = None
    t_done: Optional[float] = None

    # ------------------------------------------------------------ progress
    @property
    def prompt_len(self) -> int:
        return self.request.prompt_len

    @property
    def remaining_prefill(self) -> int:
        return self.prompt_len - self.prefill_done

    @property
    def needs_prefill(self) -> bool:
        return self.status == RUNNING and self.remaining_prefill > 0

    @property
    def decoding(self) -> bool:
        return (self.status == RUNNING and self.remaining_prefill == 0
                and len(self.out_tokens) < self.request.n_new)

    @property
    def remaining_decode(self) -> int:
        return self.request.n_new - len(self.out_tokens)

    @property
    def deadline_at(self) -> Optional[float]:
        if self.request.deadline_s is None:
            return None
        return self.request.t_arrival + self.request.deadline_s

    def past_deadline(self, now: float) -> bool:
        dl = self.deadline_at
        return dl is not None and now > dl

    def output(self) -> np.ndarray:
        """(1, n_done) generated ids (empty (1, 0) before first token)."""
        if not self.out_tokens:
            return np.zeros((1, 0), dtype=np.int32)
        return np.asarray(self.out_tokens, dtype=np.int32).reshape(1, -1)

    def stats(self) -> dict:
        """The per-request stats contract (`Engine.generate` superset)."""
        return {"chunks": self.chunk_log, "d_final": self.d,
                "degraded": self.degraded, "n_shed": self.n_shed,
                "deadline_s": self.request.deadline_s,
                "ttft": (None if self.t_first_token is None
                         else self.t_first_token - self.request.t_arrival),
                "e2e": (None if self.t_done is None
                        else self.t_done - self.request.t_arrival)}

    # ------------------------------------------- snapshot (DESIGN.md §2.11)
    def state_dict(self) -> dict:
        """Everything durable about the request: cursors, iCh band, output,
        timestamps. `cache`/`last_logits` are deliberately absent — under
        the real engine they are re-derived bit-identically by replaying
        the journaled prefill chunks through `prefill_extend`
        (`EngineBackend.rebuild_state`)."""
        return {"request": self.request.to_dict(), "status": self.status,
                "d": self.d, "ks": list(self.ks),
                "chunk_log": [dict(c) for c in self.chunk_log],
                "prefill_done": int(self.prefill_done),
                "out_tokens": [int(t) for t in self.out_tokens],
                "degraded": self.degraded, "n_shed": int(self.n_shed),
                "t_admit": self.t_admit,
                "t_first_token": self.t_first_token,
                "t_last_token": self.t_last_token, "t_done": self.t_done}

    @classmethod
    def from_state(cls, d: dict) -> "RequestState":
        return cls(request=Request.from_dict(d["request"]),
                   status=d["status"], d=float(d["d"]),
                   ks=list(d["ks"]),
                   chunk_log=[dict(c) for c in d["chunk_log"]],
                   prefill_done=int(d["prefill_done"]),
                   out_tokens=[int(t) for t in d["out_tokens"]],
                   degraded=bool(d["degraded"]), n_shed=int(d["n_shed"]),
                   t_admit=d["t_admit"],
                   t_first_token=d["t_first_token"],
                   t_last_token=d["t_last_token"], t_done=d["t_done"])


class AdmissionQueue:
    """Bounded pending queue + running set with deterministic shed.

    `submit()` accepts a request into PENDING unless the queue already
    holds `max_pending` requests — then the NEW request is shed
    immediately (deterministic drop-tail: the same arrival trace always
    sheds the same request ids, asserted in tests/test_serve_batch.py).
    `admit()` promotes FCFS from PENDING to RUNNING up to `max_running`
    concurrent requests (the continuous batch size).
    """

    def __init__(self, *, max_pending: int = 64, max_running: int = 8,
                 init_divisor: float = 4.0):
        if max_pending < 1 or max_running < 1:
            raise ValueError("max_pending and max_running must be >= 1")
        self.max_pending = int(max_pending)
        self.max_running = int(max_running)
        self.init_divisor = float(init_divisor)
        self.pending: deque[RequestState] = deque()
        self.running: list[RequestState] = []
        self.done: list[RequestState] = []
        self.shed: list[Request] = []

    # ------------------------------------------------------------ lifecycle
    def submit(self, req: Request) -> Optional[RequestState]:
        """Queue a request; returns its state, or None when shed."""
        if len(self.pending) >= self.max_pending:
            self.shed.append(req)
            return None
        st = RequestState(request=req, d=self.init_divisor)
        self.pending.append(st)
        return st

    def admit(self, now: float) -> list[RequestState]:
        """Promote pending -> running (FCFS) up to `max_running`."""
        admitted = []
        while self.pending and len(self.running) < self.max_running:
            st = self.pending.popleft()
            st.status = RUNNING
            st.t_admit = now
            self.running.append(st)
            admitted.append(st)
        return admitted

    def finish(self, st: RequestState, now: float) -> None:
        """Move a running request to DONE (completed or degraded)."""
        st.status = DONE
        st.t_done = now
        self.running.remove(st)
        self.done.append(st)

    # ------------------------------------------------------------- queries
    @property
    def n_outstanding(self) -> int:
        return len(self.pending) + len(self.running)

    @property
    def n_shed(self) -> int:
        return len(self.shed)

    def prefilling(self) -> list[RequestState]:
        return [st for st in self.running if st.needs_prefill]

    def decoding(self) -> list[RequestState]:
        return [st for st in self.running if st.decoding]

    # ------------------------------------------- snapshot (DESIGN.md §2.11)
    def state_dict(self) -> dict:
        return {"max_pending": self.max_pending,
                "max_running": self.max_running,
                "init_divisor": self.init_divisor,
                "pending": [st.state_dict() for st in self.pending],
                "running": [st.state_dict() for st in self.running],
                "done": [st.state_dict() for st in self.done],
                "shed": [r.to_dict() for r in self.shed]}

    @classmethod
    def from_state(cls, d: dict) -> "AdmissionQueue":
        q = cls(max_pending=d["max_pending"], max_running=d["max_running"],
                init_divisor=d["init_divisor"])
        q.pending = deque(RequestState.from_state(s) for s in d["pending"])
        q.running = [RequestState.from_state(s) for s in d["running"]]
        q.done = [RequestState.from_state(s) for s in d["done"]]
        q.shed = [Request.from_dict(r) for r in d["shed"]]
        return q
