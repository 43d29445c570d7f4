"""Vectorized Welford running statistics (paper §3.2, eqs. 6-7) — the
port's copy of `repro.core.welford.WelfordVec`, which the measured-cost
refiner (`sched/adaptive.py`) folds observations through."""
from __future__ import annotations

import dataclasses

import numpy as np


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
