"""Seeded open-loop Poisson load generation for the serving engine (the
port's copy of `repro.serve.loadgen`).

OPEN-loop means arrivals are scheduled up front from the seed — they do not
wait for the system to finish previous requests (the queue_flex exemplar's
`OpenPoissonLoadGen`). That is the property that makes tail-latency curves
honest: a saturated server keeps receiving work and the backlog shows up in
p99/p999 instead of silently throttling the generator.

Prompt-length and output-length distributions mirror the paper-grid
workload families (`tests/_paper_grid.py`): heavy-tailed zipf (the
production prompt mix — many short, few huge) and lognormal, plus fixed /
uniform for controlled tests. Everything is a pure function of the seed.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class LengthDist:
    """A seeded integer length distribution clamped to [lo, hi].

    kinds: ``fixed`` (always lo), ``uniform`` (lo..hi inclusive),
    ``zipf`` (lo + zipf(alpha) - 1, clamped — the heavy-tailed prompt mix),
    ``lognormal`` (lo + round(lognormal(mu, sigma)), clamped).
    """

    kind: str = "fixed"
    lo: int = 32
    hi: int = 32
    alpha: float = 1.8     # zipf exponent
    mu: float = 3.0        # lognormal log-mean
    sigma: float = 0.8     # lognormal log-std

    def __post_init__(self):
        if self.kind not in ("fixed", "uniform", "zipf", "lognormal"):
            raise ValueError(f"unknown length distribution {self.kind!r}")
        if not (1 <= self.lo <= self.hi):
            raise ValueError(
                f"need 1 <= lo <= hi, got lo={self.lo}, hi={self.hi}")
        if self.kind == "zipf" and self.alpha <= 1.0:
            raise ValueError(f"zipf alpha must be > 1, got {self.alpha}")

    def sample(self, rng: np.random.Generator, size: int) -> np.ndarray:
        if self.kind == "fixed":
            return np.full(size, self.lo, dtype=np.int64)
        if self.kind == "uniform":
            return rng.integers(self.lo, self.hi + 1, size).astype(np.int64)
        if self.kind == "zipf":
            raw = self.lo + rng.zipf(self.alpha, size) - 1
        else:  # lognormal
            raw = self.lo + np.round(
                rng.lognormal(self.mu, self.sigma, size)).astype(np.int64)
        return np.minimum(raw, self.hi).astype(np.int64)


@dataclasses.dataclass(frozen=True)
class Arrival:
    """One generated request: when it arrives and how big it is."""

    req_id: int
    t: float               # arrival time (serving-clock seconds)
    prompt_len: int
    n_new: int
    deadline_s: Optional[float] = None  # per-request SLO budget


class OpenPoissonLoadGen:
    """Open-loop Poisson arrival process at `rate` requests/second.

    Inter-arrival gaps are iid Exponential(rate); prompt/output lengths
    draw from their `LengthDist`s. The whole trace is a pure function of
    `seed`, so a sweep point replays bit-identically (the determinism the
    CI smoke asserts)."""

    def __init__(self, rate: float, *,
                 prompt_lens: Optional[LengthDist] = None,
                 output_lens: Optional[LengthDist] = None,
                 deadline_s: Optional[float] = None,
                 seed: int = 0):
        if rate <= 0:
            raise ValueError(f"arrival rate must be > 0, got {rate}")
        self.rate = float(rate)
        self.prompt_lens = prompt_lens if prompt_lens is not None \
            else LengthDist("zipf", lo=16, hi=256, alpha=1.6)
        self.output_lens = output_lens if output_lens is not None \
            else LengthDist("fixed", lo=8, hi=8)
        self.deadline_s = deadline_s
        self.seed = int(seed)

    def arrivals(self, n: int, t0: float = 0.0) -> list[Arrival]:
        """The first `n` arrivals after `t0`, scheduled open-loop."""
        if n <= 0:
            return []
        rng = np.random.default_rng(self.seed)
        gaps = rng.exponential(1.0 / self.rate, n)
        times = t0 + np.cumsum(gaps)
        plens = self.prompt_lens.sample(rng, n)
        nlens = self.output_lens.sample(rng, n)
        return [Arrival(req_id=i, t=float(times[i]),
                        prompt_len=int(plens[i]), n_new=int(nlens[i]),
                        deadline_s=self.deadline_s)
                for i in range(n)]

    def prompt_tokens(self, arrival: Arrival, vocab_size: int) -> np.ndarray:
        """Deterministic (1, S) token ids for an arrival — seeded per
        request id so the same trace yields the same prompts."""
        rng = np.random.default_rng((self.seed << 20) + arrival.req_id)
        return rng.integers(0, vocab_size,
                            (1, arrival.prompt_len)).astype(np.int32)
