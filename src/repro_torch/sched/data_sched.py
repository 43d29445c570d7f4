"""Per-host input-shard dispatch with stealing — the port's copy of
`repro.sched.data_sched`, the data-path consumer of the threaded executor
(`core/executor.py`, numpy only).

The global batch is a loop over example shards: each ingest host owns a
contiguous shard range (distributed deques), chunk sizes adapt with iCh's
band classification, and idle hosts steal shard ranges from stragglers.
`data/pipeline.py` wraps this dispatcher in its double-buffered pipeline.
When per-shard costs are known, `dispatch_weighted` cuts them into
equal-work chunks (the BinLPT law) through the `LoopScheduler` facade's
LRU cache, so a repeated cost array across steps skips chunking.

The facade is the caller's `scheduler`, else the process-wide
`default_scheduler()` (on the card, as every entry point of the port).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np

from repro_torch.core import executor as E
from repro_torch.core import policies as P

from .api import LoopScheduler, default_scheduler
from .costs import _digest
from .defaults import ICH_EPS


@dataclasses.dataclass
class DispatchStats:
    chunks: int = 0
    steals: int = 0

    @classmethod
    def from_exec(cls, stats: E.ExecStats) -> "DispatchStats":
        return cls(chunks=stats.chunks, steals=stats.steals)


class ShardDispatcher:
    """Dispatch ingest work items across `n_hosts` worker threads under the
    iCh policy (adaptive chunk + stealing)."""

    def __init__(self, n_hosts: int = 4, eps: float = ICH_EPS,
                 scheduler: Optional[LoopScheduler] = None):
        self.n_hosts = int(n_hosts)
        self.policy = P.ich(eps)
        self._scheduler = scheduler

    @property
    def scheduler(self) -> LoopScheduler:
        return self._scheduler or default_scheduler()

    def dispatch(self, n_shards: int,
                 read_fn: Callable[[int], None]) -> DispatchStats:
        """read_fn(i) ingests shard i (exactly once, any host)."""
        stats = self.scheduler.parallel_for(
            n_shards, read_fn, p=self.n_hosts, policy=self.policy)
        return DispatchStats.from_exec(stats)

    def weighted_chunks(self, shard_costs) -> tuple:
        """The (begin, end) chunks `dispatch_weighted` offers for these
        per-shard costs, memoized in the facade's cache."""
        costs = np.asarray(shard_costs, np.float64)

        def chunk():
            return tuple(P.pretile(P.binlpt(4 * self.n_hosts), costs,
                                   self.n_hosts))

        cache = self.scheduler.cache
        if cache is None:
            return chunk()
        return cache.get_or_build(
            ("data_sched", _digest(costs), self.n_hosts), chunk)

    def dispatch_weighted(self, shard_costs: np.ndarray,
                          read_fn: Callable[[int], None]) -> DispatchStats:
        """Cost-aware dispatch: shards with known per-shard costs are cut
        into equal-work contiguous chunks offered heaviest-first
        (`weighted_chunks`); `read_fn` runs exactly once per shard."""
        chunks = self.weighted_chunks(shard_costs)
        stats = self.scheduler.parallel_for(
            len(np.asarray(shard_costs)), read_fn, p=self.n_hosts,
            policy=P.pretiled(chunks))
        return DispatchStats.from_exec(stats)
