"""LRU schedule cache — the port's copy of `repro.sched.cache`.

Most requests re-present a cost distribution the scheduler has already
seen (the same CSR matrix), so `LoopScheduler.schedule()` keys built
schedules on ``(cost_fingerprint, policy, p, construction params,
superstep, generation)`` — the full frozen `Policy` dataclass, not its
lossy ``label()``, and the worker PARTITION parameters `p`/`superstep`: a
cached `Schedule` memoizes its worker-shard lowering (`Schedule.shard`),
so entries built for different worker counts must never alias. The
refinement GENERATION keys too: `Schedule.refine()` re-enters the cache
with generation g+1 and a `RefinedCosts` fingerprint, so a stale
generation-g lowering is never served for generation-g+1 costs. Old
generations age out through normal LRU eviction.

Thread-safe; eviction is least-recently-used. Construction runs outside
the cache lock, so a slow build never blocks concurrent hits. Two threads
racing on the same missing key may both build; the first insert wins.
"""
from __future__ import annotations

import dataclasses
import threading
from collections import OrderedDict
from typing import Any, Callable, Hashable


@dataclasses.dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    evictions: int = 0

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0


class ScheduleCache:
    """LRU map from schedule keys to built `Schedule` objects."""

    def __init__(self, maxsize: int = 128):
        if maxsize < 1:
            raise ValueError(f"cache maxsize must be >= 1, got {maxsize}")
        self.maxsize = int(maxsize)
        self._data: OrderedDict[Hashable, Any] = OrderedDict()
        self._lock = threading.Lock()
        self.stats = CacheStats()

    def __len__(self) -> int:
        return len(self._data)

    def get_or_build(self, key: Hashable, build: Callable[[], Any]) -> Any:
        """Return the cached value for `key`, building it on a miss."""
        with self._lock:
            if key in self._data:
                self._data.move_to_end(key)
                self.stats.hits += 1
                return self._data[key]
            self.stats.misses += 1
        value = build()
        with self._lock:
            if key not in self._data:  # lost races keep the first insert
                self._data[key] = value
                if len(self._data) > self.maxsize:
                    self._data.popitem(last=False)
                    self.stats.evictions += 1
            return self._data[key]

    def clear(self) -> None:
        with self._lock:
            self._data.clear()
            self.stats = CacheStats()
