"""Running statistics used by iCh (paper §3.2, eqs. 4-8) — the port's
copy of `repro.core.welford`: the scalar `Welford` (running mean and
variance, eqs. 6-7); `WelfordVec`, its per-item form, which the
measured-cost refiner (`sched/adaptive.py`) folds observations through;
and the paper's cheap band (`ich_band`, `classify`, `adapt_d`,
`steal_merge`), which the serving engine's chunked prefill, the
simulator and the executor adapt their chunk divisors with."""
from __future__ import annotations

import dataclasses
from typing import Iterable

import numpy as np


@dataclasses.dataclass
class Welford:
    """Welford running mean/variance (paper eq. 6-7)."""

    count: int = 0
    mean: float = 0.0
    m2: float = 0.0

    def update(self, x: float) -> None:
        self.count += 1
        d = x - self.mean
        self.mean += d / self.count
        self.m2 += d * (x - self.mean)

    def update_many(self, xs: Iterable[float]) -> None:
        for x in xs:
            self.update(x)

    @property
    def variance(self) -> float:
        return self.m2 / self.count if self.count > 0 else 0.0

    @property
    def std(self) -> float:
        return float(np.sqrt(self.variance))


@dataclasses.dataclass
class WelfordVec:
    """One running (count, mean, M2) triple PER ITEM, as three aligned
    arrays: `update(x, mask)` is the scalar Welford recurrence applied at
    every `mask`-selected lane."""

    count: np.ndarray  # (n,) int64 samples folded per item
    mean: np.ndarray   # (n,) float64 running mean
    m2: np.ndarray     # (n,) float64 running sum of squared deviations

    @classmethod
    def zeros(cls, n: int) -> "WelfordVec":
        return cls(np.zeros(n, np.int64), np.zeros(n), np.zeros(n))

    @property
    def n(self) -> int:
        return int(self.count.size)

    def update(self, xs: np.ndarray, mask: np.ndarray | None = None) -> None:
        """Fold one sample per item; items where `mask` is False keep their
        stats untouched (an execution round that never observed them)."""
        xs = np.asarray(xs, np.float64)
        if mask is None:
            mask = np.ones(self.n, dtype=bool)
        cnt = self.count + mask
        safe = np.maximum(cnt, 1)
        d = xs - self.mean
        mean = self.mean + np.where(mask, d / safe, 0.0)
        self.m2 += np.where(mask, d * (xs - mean), 0.0)
        self.mean = mean
        self.count = cnt

    @property
    def variance(self) -> np.ndarray:
        return np.divide(self.m2, self.count,
                         out=np.zeros_like(self.m2),
                         where=self.count > 0)


# ---------------------------------------------------------- the iCh band
# (the rest of `repro.core.welford`, which the serving engine's chunked
# prefill adapts its divisor with)

LOW, NORMAL, HIGH = -1, 0, 1


def ich_band(ks: np.ndarray, eps: float) -> tuple[float, float]:
    """Paper eq. 8: the (mu, delta) band from per-worker completed counts.

    mu    = sum_j k_j / p   (mean iteration throughput)
    delta = eps * mu
    """
    mu = float(np.sum(ks)) / len(ks)
    return mu, eps * mu


def classify(k_i: float, mu: float, delta: float) -> int:
    """Paper eqs. 1-3: classify a worker's throughput against mu +- delta."""
    if k_i < mu - delta:
        return LOW
    if k_i > mu + delta:
        return HIGH
    return NORMAL


def adapt_d(d_i: float, cls: int, d_min: float = 1.0, d_max: float = 4096.0) -> float:
    """Paper §3.2 adaptation of the chunk divisor d_i.

    chunk = ceil(|q_i| / d_i); the *direction* is deliberately inverted vs.
    load-balance tuning:
      low  (slow worker)  -> d/2  -> chunk DOUBLES  (fewer interruptions)
      high (fast worker)  -> 2d   -> chunk HALVES   (more stealable work)
    """
    if cls == LOW:
        d_i = d_i / 2.0
    elif cls == HIGH:
        d_i = d_i * 2.0
    return float(min(max(d_i, d_min), d_max))


def steal_merge(k_thief: float, d_thief: float, k_victim: float, d_victim: float) -> tuple[float, float]:
    """Paper Listing 1 lines 6-7: average thief/victim bookkeeping on steal."""
    return (k_thief + k_victim) / 2.0, (d_thief + d_victim) / 2.0
