"""Dependency-free log-bucketed latency histograms + serving counters
(the port's copy of `repro.serve.metrics`).

The tail-latency reporting layer of the serving engine (DESIGN.md §2.10),
modeled on HdrHistogram: values are recorded into geometrically-spaced
buckets, so percentile queries (p50/p90/p99/p999) cost O(buckets) memory
regardless of how many samples stream through an offered-load sweep, and
every quantile answer is within one bucket's relative resolution of the
exact order statistic (asserted against a numpy-sort oracle in
tests/test_serve_batch.py).

Pure Python on purpose — no numpy, no torch — so the metrics layer imports
anywhere (the load generator, the CI smoke, a log post-processor) without
paying for the numeric stack.
"""
from __future__ import annotations

import math
from typing import Iterable, Optional


class LatencyHistogram:
    """Log-bucketed histogram over positive values.

    `resolution` is the relative bucket width (0.05 = 5%): any percentile
    query is within a factor of (1 + resolution) of the exact sample
    quantile. Values below `min_value` clamp into the first bucket; values
    above `max_value` clamp into the last (min/max are still tracked
    exactly, and p0/p100 report them exactly).
    """

    __slots__ = ("min_value", "max_value", "resolution", "_log_g",
                 "_n_buckets", "_counts", "count", "total",
                 "_min_seen", "_max_seen")

    def __init__(self, min_value: float = 1e-6, max_value: float = 1e5,
                 resolution: float = 0.05):
        if not (0 < min_value < max_value):
            raise ValueError(
                f"need 0 < min_value < max_value, got {min_value}, {max_value}")
        if not (0 < resolution < 1):
            raise ValueError(f"resolution must be in (0, 1), got {resolution}")
        self.min_value = float(min_value)
        self.max_value = float(max_value)
        self.resolution = float(resolution)
        self._log_g = math.log1p(resolution)
        self._n_buckets = 1 + int(
            math.log(max_value / min_value) / self._log_g)
        self._counts = [0] * self._n_buckets
        self.count = 0
        self.total = 0.0
        self._min_seen: Optional[float] = None
        self._max_seen: Optional[float] = None

    # -------------------------------------------------------------- record
    def _bucket(self, v: float) -> int:
        if v <= self.min_value:
            return 0
        i = int(math.log(v / self.min_value) / self._log_g)
        return min(i, self._n_buckets - 1)

    def record(self, v: float) -> None:
        v = float(v)
        if not math.isfinite(v) or v < 0:
            raise ValueError(f"latency samples must be finite and >= 0: {v}")
        self._counts[self._bucket(v)] += 1
        self.count += 1
        self.total += v
        if self._min_seen is None or v < self._min_seen:
            self._min_seen = v
        if self._max_seen is None or v > self._max_seen:
            self._max_seen = v

    def record_many(self, vs: Iterable[float]) -> None:
        for v in vs:
            self.record(v)

    # -------------------------------------------------------------- queries
    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def percentile(self, q: float) -> float:
        """The q-th percentile (q in [0, 100]); 0.0 when empty.

        Quantile convention matches `numpy.percentile(..., method="lower"
        )`-style order statistics: the value at rank ceil(q/100 * count),
        reported as the geometric midpoint of its bucket (within one
        bucket's resolution of exact)."""
        if not (0 <= q <= 100):
            raise ValueError(f"percentile must be in [0, 100], got {q}")
        if self.count == 0:
            return 0.0
        if q == 0:
            return self._min_seen
        if q == 100:
            return self._max_seen
        rank = max(1, math.ceil(q / 100.0 * self.count))
        seen = 0
        for i, c in enumerate(self._counts):
            seen += c
            if seen >= rank:
                lo = self.min_value * math.exp(i * self._log_g)
                hi = lo * (1.0 + self.resolution)
                # clamp into the exactly-tracked range so a one-sample
                # histogram answers that sample, not its bucket midpoint
                mid = math.sqrt(lo * hi)
                return min(max(mid, self._min_seen), self._max_seen)
        return self._max_seen  # pragma: no cover - rank <= count

    def percentiles(self, qs=(50, 90, 99, 99.9)) -> dict:
        def label(q):
            s = f"{float(q):g}"  # 50 -> "50", 99.9 -> "99.9"
            return f"p{s.replace('.', '')}" if "." in s else f"p{s}"
        return {label(q): self.percentile(q) for q in qs}

    def merge(self, other: "LatencyHistogram") -> "LatencyHistogram":
        """Fold `other` into self (bucket layouts must match)."""
        if (other.min_value, other.max_value, other.resolution) != \
                (self.min_value, self.max_value, self.resolution):
            raise ValueError("cannot merge histograms with different "
                             "bucket layouts")
        for i, c in enumerate(other._counts):
            self._counts[i] += c
        self.count += other.count
        self.total += other.total
        for v in (other._min_seen, other._max_seen):
            if v is not None:
                if self._min_seen is None or v < self._min_seen:
                    self._min_seen = v
                if self._max_seen is None or v > self._max_seen:
                    self._max_seen = v
        return self

    def summary(self) -> dict:
        s = {"count": self.count, "mean": self.mean}
        s.update(self.percentiles((50, 90, 99, 99.9)))
        return s

    # ------------------------------------------------- snapshot (DESIGN §2.11)
    def state_dict(self) -> dict:
        """JSON-serializable full state; `from_state` restores a histogram
        that answers every query identically (crash-resume snapshots)."""
        return {"min_value": self.min_value, "max_value": self.max_value,
                "resolution": self.resolution, "counts": list(self._counts),
                "count": self.count, "total": self.total,
                "min_seen": self._min_seen, "max_seen": self._max_seen}

    @classmethod
    def from_state(cls, d: dict) -> "LatencyHistogram":
        h = cls(min_value=d["min_value"], max_value=d["max_value"],
                resolution=d["resolution"])
        counts = list(d["counts"])
        if len(counts) != h._n_buckets:
            raise ValueError(f"state has {len(counts)} buckets, layout "
                             f"needs {h._n_buckets}")
        h._counts = counts
        h.count = int(d["count"])
        h.total = float(d["total"])
        h._min_seen = d["min_seen"]
        h._max_seen = d["max_seen"]
        return h

    def __repr__(self):
        if self.count == 0:
            return "LatencyHistogram(empty)"
        p = self.percentiles((50, 99))
        return (f"LatencyHistogram(n={self.count}, mean={self.mean:.4g}, "
                f"p50={p['p50']:.4g}, p99={p['p99']:.4g})")


class ServeMetrics:
    """One serving run's latency histograms + goodput/shed counters.

    Three latency dimensions per request (all in clock seconds):

    * **TTFT** — arrival to first token (the prefill argmax), the
      queueing + chunked-prefill tail;
    * **per-token** — gap between consecutive decode tokens (how much a
      decode stream stutters when steps carry other requests' prefill
      chunks);
    * **e2e** — arrival to completion, COMPLETED requests only (degraded
      completions are counted separately so shedding cannot flatter the
      tail).
    """

    def __init__(self, resolution: float = 0.02):
        self.ttft = LatencyHistogram(resolution=resolution)
        self.per_token = LatencyHistogram(resolution=resolution)
        self.e2e = LatencyHistogram(resolution=resolution)
        self.n_arrived = 0
        self.n_admitted = 0
        self.n_shed_admission = 0     # rejected at the bounded queue
        self.n_completed = 0          # full n_new tokens delivered
        self.n_degraded = 0           # deadline hit: partial output returned
        self.n_tokens_out = 0         # goodput numerator
        self.n_tokens_shed = 0        # decode steps shed by degradation
        self.n_prefill_fallback = 0   # O(n^2) prefix-rerun prefill chunks
        self.t_elapsed = 0.0          # serving-clock seconds (set by run())
        # ---- hardened backend boundary (DESIGN.md §2.11) ----
        self.n_backend_faults = 0     # terminal per-op FaultErrors absorbed
        self.n_backend_retries = 0    # per-op retry attempts spent
        self.n_breaker_trips = 0      # circuit breaker closed->open events

    def goodput(self, elapsed_s: Optional[float] = None) -> float:
        """Delivered tokens per second of serving-clock time."""
        if elapsed_s is None:
            elapsed_s = self.t_elapsed
        return self.n_tokens_out / elapsed_s if elapsed_s > 0 else 0.0

    def summary(self, elapsed_s: Optional[float] = None) -> dict:
        if elapsed_s is None:
            elapsed_s = self.t_elapsed
        return {
            "ttft": self.ttft.summary(),
            "per_token": self.per_token.summary(),
            "e2e": self.e2e.summary(),
            "n_arrived": self.n_arrived,
            "n_admitted": self.n_admitted,
            "n_shed_admission": self.n_shed_admission,
            "n_completed": self.n_completed,
            "n_degraded": self.n_degraded,
            "n_tokens_out": self.n_tokens_out,
            "n_tokens_shed": self.n_tokens_shed,
            "n_prefill_fallback": self.n_prefill_fallback,
            "n_backend_faults": self.n_backend_faults,
            "n_backend_retries": self.n_backend_retries,
            "n_breaker_trips": self.n_breaker_trips,
            "elapsed_s": elapsed_s,
            "goodput_tok_s": self.goodput(elapsed_s),
        }

    # ------------------------------------------------- snapshot (DESIGN §2.11)
    _COUNTERS = ("n_arrived", "n_admitted", "n_shed_admission",
                 "n_completed", "n_degraded", "n_tokens_out",
                 "n_tokens_shed", "n_prefill_fallback", "t_elapsed",
                 "n_backend_faults", "n_backend_retries",
                 "n_breaker_trips")

    def state_dict(self) -> dict:
        d = {"ttft": self.ttft.state_dict(),
             "per_token": self.per_token.state_dict(),
             "e2e": self.e2e.state_dict()}
        for k in self._COUNTERS:
            d[k] = getattr(self, k)
        return d

    @classmethod
    def from_state(cls, d: dict) -> "ServeMetrics":
        m = cls()
        m.ttft = LatencyHistogram.from_state(d["ttft"])
        m.per_token = LatencyHistogram.from_state(d["per_token"])
        m.e2e = LatencyHistogram.from_state(d["e2e"])
        for k in cls._COUNTERS:
            setattr(m, k, d[k])
        return m
