"""Input pipeline with the iCh data dispatcher — the port's copy of
`repro.data.pipeline` (numpy batches; the trainer moves them to the
device).

The global batch is a loop over example shards; each ingest host owns a
contiguous shard range, sizes its read-ahead chunk with iCh's adaptive
rule, and idle hosts steal shard ranges from stragglers, on the threaded
executor of `core/`. The tokens are synthetic (seeded Zipf-like integer
streams), so runs are hermetic.

One difference from the reference: `Pipeline.get_batch(step)` returns the
batch of `step`. The reference's returns whatever its prefetch assembled,
and it starts with step 0's, so a trainer that resumes at step s > 0
trains its first step on step 0's batch (ROADMAP.md queue 3); here a
prefetch of another step is replaced by `step`'s, assembled then.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Optional

import numpy as np

from repro_torch.sched.api import LoopScheduler
from repro_torch.sched.data_sched import ShardDispatcher
from repro_torch.sched.defaults import ICH_EPS


def synthetic_tokens(batch: int, seq: int, vocab: int, step: int,
                     seed: int = 0) -> dict:
    """Deterministic pseudo-corpus: Zipf-ish unigram stream + shifted labels."""
    rng = np.random.default_rng(seed + step)
    ranks = rng.zipf(1.3, size=(batch, seq + 1)).astype(np.int64)
    toks = np.minimum(ranks, vocab - 1).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}


@dataclasses.dataclass
class HostIngestStats:
    chunks: int = 0
    steals: int = 0


class IChDataDispatcher(ShardDispatcher):
    """Dispatch `n_examples` ingest work items across `n_hosts` worker
    threads under the iCh policy (adaptive chunk + stealing)."""

    def __init__(self, n_hosts: int = 4, eps: float = ICH_EPS,
                 scheduler: Optional[LoopScheduler] = None):
        super().__init__(n_hosts=n_hosts, eps=eps, scheduler=scheduler)

    def ingest(self, n_examples: int, read_fn) -> HostIngestStats:
        """read_fn(i) ingests example i (exactly once, any host)."""
        stats = self.dispatch(n_examples, read_fn)
        return HostIngestStats(chunks=stats.chunks, steals=stats.steals)


class Pipeline:
    """Double-buffered synthetic pipeline: batch t+1 is assembled (via the
    iCh dispatcher, on a thread) while batch t trains. The dispatcher runs
    on a `LoopScheduler` on `device` (None: the process-wide default
    scheduler, on the card)."""

    def __init__(self, cfg, batch: int, seq: int, n_hosts: int = 4,
                 seed: int = 0, device=None):
        self.cfg, self.batch, self.seq, self.seed = cfg, batch, seq, seed
        self.dispatcher = IChDataDispatcher(n_hosts, scheduler=(
            None if device is None else LoopScheduler(device=device)))
        self._next = None
        self._thread = None
        self._start(0)

    def _assemble(self, step: int):
        out = synthetic_tokens(self.batch, self.seq, self.cfg.padded_vocab,
                               step, self.seed)
        buf = {"tokens": np.zeros_like(out["tokens"]),
               "labels": np.zeros_like(out["labels"])}

        def read(i):  # per-example ingest work item
            buf["tokens"][i] = out["tokens"][i]
            buf["labels"][i] = out["labels"][i]

        stats = self.dispatcher.ingest(self.batch, read)
        self._next = (step, buf, stats)

    def _start(self, step: int):
        self._thread = threading.Thread(target=self._assemble, args=(step,))
        self._thread.start()

    def get_batch(self, step: int):
        """(batch of `step`: {"tokens", "labels"} int32 (B, S) arrays,
        HostIngestStats); starts assembling step + 1."""
        self._thread.join()
        if self._next is None or self._next[0] != step:
            self._assemble(step)
        _, batch, stats = self._next
        self._start(step + 1)
        return batch, stats

    def close(self) -> None:
        """Wait for the batch being assembled."""
        if self._thread is not None:
            self._thread.join()
