"""Append-only serving journal + deterministic crash resume
(DESIGN.md §2.11). The port's copy of `repro.robust.journal`.

The continuous batcher (serve/batcher.py) is deterministic by
construction: every policy decision is a pure function of queue state,
every simulated step cost is a pure function of (seed, step_idx), and
every generated token is a pure function of (req_id, position) — or, on
the real engine, of the journaled prefill chunk sizes (§2.10's
chunk-invariance). So the journal does not need to checkpoint any
derived state. It records only the batcher's own events — admissions, step
plans, injected stalls, completions, idle gaps — and
`resume_from_journal` replays them through a fresh batcher. The replay
re-derives queue contents, per-request iCh bands, policy internals, and
metrics bit-identically, then verifies itself: the old journal must be
an exact prefix of the new one, event by event, or the resume is
refused with `JournalDivergence`.

Journal lines are JSON (one event per line). Python's repr-based float
serialization round-trips exactly, so event equality — including
recorded step durations — is bit-exact across a save/load cycle. A torn
final line (the crash happened mid-write) is tolerated and dropped.

Module-level imports stay numpy/stdlib-only; `repro_torch.serve` is
imported lazily inside `resume_from_journal` to keep `repro_torch.robust`
importable from the core executor/simulator (same discipline as
`faults.simulate_faulty`).
"""
from __future__ import annotations

import json
from typing import Optional


class JournalDivergence(RuntimeError):
    """Replaying a journal did not reproduce it (or the resume
    configuration does not match the journal's header)."""


def _canonical(ev: dict) -> str:
    """Serialize an event to its journal line, coercing numpy scalars."""
    def default(o):
        item = getattr(o, "item", None)
        if callable(item):
            return item()
        raise TypeError(f"journal events must be JSON-serializable, "
                        f"got {type(o).__name__}")
    return json.dumps(ev, sort_keys=True, separators=(",", ":"),
                      default=default)


class ServeJournal:
    """Append-only event log, optionally mirrored to a JSONL file.

    Events are stored in canonical JSON form (every `append` round-trips
    the dict through `json`), so an in-memory journal compares equal to
    the same journal loaded back from disk. When `path` is given, every
    event is written and flushed immediately — the file is crash-durable
    up to the last completed line.
    """

    def __init__(self, path: Optional[str] = None, events=None):
        self.path = None if path is None else str(path)
        self.events: list = []
        self._fh = None
        if self.path is not None:
            self._fh = open(self.path, "a", encoding="utf-8")
        if events:
            for ev in events:
                self.append(ev)

    def append(self, ev: dict) -> None:
        line = _canonical(ev)
        self.events.append(json.loads(line))
        if self._fh is not None:
            self._fh.write(line + "\n")
            self._fh.flush()

    @property
    def header(self) -> Optional[dict]:
        if self.events and self.events[0].get("ev") == "header":
            return self.events[0]
        return None

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __len__(self) -> int:
        return len(self.events)

    # ------------------------------------------------------------------ io
    def to_jsonl(self) -> str:
        return "".join(_canonical(ev) + "\n" for ev in self.events)

    @classmethod
    def from_jsonl(cls, text: str) -> "ServeJournal":
        """Parse a journal dump; a torn FINAL line is dropped (the crash
        interrupted the write), a malformed line anywhere else raises."""
        j = cls()
        lines = [ln for ln in text.split("\n") if ln.strip()]
        for k, ln in enumerate(lines):
            try:
                j.events.append(json.loads(ln))
            except json.JSONDecodeError:
                if k == len(lines) - 1:
                    break
                raise
        return j

    @classmethod
    def load(cls, path) -> "ServeJournal":
        with open(path, "r", encoding="utf-8") as fh:
            return cls.from_jsonl(fh.read())


def _replayable_prefix(events: list) -> list:
    """Drop torn tail events that belong to a step which never landed.

    A "stall" line is always followed by its "step" line within the same
    `step()` call; a journal ending in a stall means the crash hit
    between the two writes, and that step never completed — replay must
    not include it.
    """
    out = list(events)
    while out and out[-1].get("ev") == "stall":
        out.pop()
    return out


def resume_from_journal(journal, *, policy, backend=None, queue=None,
                        clock=None, faults=None, metrics=None,
                        journal_path: Optional[str] = None,
                        strict: bool = True):
    """Rebuild a `ContinuousBatcher` by replaying a journal.

    Constructs a fresh batcher (journaling into a NEW journal, mirrored
    to `journal_path` if given) with the caller-supplied components —
    which must match the crashed run's configuration; under
    ``strict=True`` the new header must equal the journaled one — and
    drives the recorded batcher events through it: submits re-enter the
    admission queue, gaps advance the clock, and each recorded step runs
    through the full `step()` path with the RECORDED duration, so even
    wall-clock-measured timings replay exactly. Afterward the old
    journal must be an exact prefix of the new one or
    `JournalDivergence` is raised.

    Returns the resumed batcher: its queue, policy state, metrics, and
    step counter are bit-identical to the crashed run's at the kill
    point, and calling `run()` with the original arrival trace continues
    it (already-submitted arrivals are skipped).
    """
    from repro_torch.serve.batcher import ContinuousBatcher, SimClock
    from repro_torch.serve.queue import Request

    events = _replayable_prefix(journal.events)
    if not events or events[0].get("ev") != "header":
        raise JournalDivergence("journal has no header; nothing to resume")
    if clock is None:
        # replay always runs on the simulated clock so recorded times
        # land exactly; a resumed wall-clock run keeps advancing it by
        # each step's measured duration
        t0 = next((ev["t_start"] for ev in events
                   if ev.get("ev") == "run"), 0.0)
        clock = SimClock(t0)
    new = ServeJournal(path=journal_path)
    b = ContinuousBatcher(policy, queue=queue, backend=backend,
                          clock=clock, faults=faults, metrics=metrics,
                          journal=new)
    old_hdr, new_hdr = events[0], new.events[0]
    if strict and old_hdr != new_hdr:
        bad = sorted(k for k in set(old_hdr) | set(new_hdr)
                     if old_hdr.get(k) != new_hdr.get(k))
        raise JournalDivergence(
            f"resume configuration differs from the journal header on "
            f"{bad}; pass strict=False to override")
    # a wall-clock journal's step times are MEASUREMENTS, not derived
    # state: replay injects the recorded durations and snaps the clock
    # to each recorded step time (so deadline decisions replay exactly),
    # and the self-check compares events modulo the measured "t" stamps
    wall = bool(getattr(b.backend, "wall_clock", False))
    for ev in events[1:]:
        kind = ev.get("ev")
        if kind == "run":
            b._t_start = ev["t_start"]
            b._j(dict(ev))
        elif kind == "submit":
            st = b.submit(Request.from_dict(ev["req"]))
            if (st is not None) != bool(ev["admitted"]):
                raise JournalDivergence(
                    f"request {ev['req']['req_id']} admission diverged "
                    f"on replay")
        elif kind == "gap":
            b._j(dict(ev))
            b.clock.advance(ev["dt"])
        elif kind == "step":
            if not b.step(_dt_override=ev["dt"]):
                raise JournalDivergence(
                    f"journal step {ev['i']} replayed to an empty plan")
            if wall and isinstance(b.clock, SimClock):
                b.clock.jump(ev["t"])
        elif kind in ("stall", "finish"):
            pass  # re-emitted by the replayed step() itself
        else:
            raise JournalDivergence(f"unknown journal event {kind!r}")
    # ---- self-check: the old journal must be a prefix of the new one ----
    if len(new.events) < len(events):
        raise JournalDivergence(
            f"replay produced {len(new.events)} events for a journal of "
            f"{len(events)}")

    def norm(ev):
        return {k: v for k, v in ev.items() if k != "t"} if wall else ev

    for k, (a, c) in enumerate(zip(events, new.events)):
        if norm(a) != norm(c):
            raise JournalDivergence(
                f"replay diverged at event {k}: recorded {a!r}, "
                f"replayed {c!r}")
    return b
