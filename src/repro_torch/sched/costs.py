"""Cost providers: how a workload tells the scheduler what its items cost —
the port's copy of `repro.sched.costs`.

`CostProvider` is the small protocol the `LoopScheduler` facade consumes:

* ``sizes()``  -> integer work units per item (drives tile construction;
  zero is allowed — a zero-size item still gets an output slot);
* ``costs()``  -> float per-item costs (drive partitioning and the cost
  stream the sharded kernel emits);
* ``fingerprint()`` -> stable content hash, the schedule-cache key part.

`NnzCosts` covers the SpMV workload (CSR row lengths), `DegreeCosts` the
BFS one (vertex degrees), `ExplicitCosts` any per-item array (K-Means
per-point costs), `ExpertLoadCosts` the MoE dispatch one (per-expert kept
token counts), `RemainingTokensCosts` a serving batch's remaining prompt
tokens, and `RefinedCosts` the output of measured-cost refinement.
`as_cost_provider` lets callers pass a bare array anywhere a provider is
expected.
"""
from __future__ import annotations

import hashlib
from typing import Protocol, runtime_checkable

import numpy as np


@runtime_checkable
class CostProvider(Protocol):
    """Per-item work description consumed by `LoopScheduler.schedule`."""

    def sizes(self) -> np.ndarray:
        """Integer work units per item, shape (n,). May contain zeros."""
        ...

    def costs(self) -> np.ndarray:
        """Float per-item costs, shape (n,)."""
        ...

    def fingerprint(self) -> str:
        """Stable content hash; equal inputs must produce equal values."""
        ...

    # NOTE: providers may additionally expose `sizes_are_structural`
    # (bool). True means sizes() describes a payload layout (CSR row nnz)
    # that measured-cost refinement must NOT re-derive from refreshed
    # costs; False means sizes are merely quantized cost estimates and
    # refinement may re-tile from scratch. Absent, the facade assumes True.


def _digest(*arrays: np.ndarray) -> str:
    h = hashlib.blake2b(digest_size=16)
    for a in arrays:
        a = np.ascontiguousarray(a)
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    return h.hexdigest()


def quantize_costs(costs: np.ndarray) -> np.ndarray:
    """Predicted float costs -> integer work units (>= 1 per item)."""
    return np.maximum(np.ceil(np.asarray(costs, np.float64)), 1.0).astype(
        np.int64)


class ExplicitCosts:
    """A bare per-item cost array.

    Integer arrays are taken as work units verbatim (zeros allowed); float
    arrays are costs and are quantized to `>= 1` work units for tile
    construction. Only the fingerprint is computed eagerly; `sizes()`/
    `costs()` materialize (as copies) on first use, so a schedule-cache
    HIT pays the hash and nothing else. Do not mutate the input array
    between construction and the first `sizes()`/`costs()` call.
    """

    def __init__(self, values: np.ndarray):
        values = np.asarray(values)
        if values.ndim != 1:
            raise ValueError(f"per-item costs must be 1-D, got {values.shape}")
        if not (np.issubdtype(values.dtype, np.integer)
                or np.issubdtype(values.dtype, np.floating)):
            raise TypeError(f"cost array must be numeric, got {values.dtype}")
        self._values = values
        self._sizes = None
        self._costs = None
        self._structural = np.issubdtype(values.dtype, np.integer)
        self._fp = f"explicit:{_digest(values)}"

    def _materialize(self) -> None:
        values = self._values
        # astype copies: the results outlive this call inside cached
        # Schedule objects and must not alias caller-mutable buffers
        if np.issubdtype(values.dtype, np.integer):
            self._sizes = values.astype(np.int64)
            self._costs = values.astype(np.float64)
        else:
            self._costs = values.astype(np.float64)
            self._sizes = quantize_costs(self._costs)
        self._values = None  # drop the caller-buffer reference

    def sizes(self) -> np.ndarray:
        if self._sizes is None:
            self._materialize()
        return self._sizes

    def costs(self) -> np.ndarray:
        if self._costs is None:
            self._materialize()
        return self._costs

    def fingerprint(self) -> str:
        return self._fp

    @property
    def sizes_are_structural(self) -> bool:
        """Integer inputs ARE the work units (keep them across refinement);
        float inputs only quantize to units (refinement may re-derive)."""
        return bool(self._structural)


class NnzCosts:
    """Per-row nonzero counts of a CSR matrix: cost[i] = indptr[i+1] -
    indptr[i]. The paper's SpMV workload (cost ~ row nnz). Fingerprint
    eager, `sizes()` lazy — same economics as `ExplicitCosts`."""

    _kind = "nnz"

    def __init__(self, indptr: np.ndarray):
        indptr = np.asarray(indptr)
        if indptr.ndim != 1 or indptr.size < 1:
            raise ValueError(f"indptr must be 1-D non-empty, got {indptr.shape}")
        self._indptr = indptr
        self._sizes = None
        self._fp = f"{self._kind}:{_digest(indptr)}"

    def sizes(self) -> np.ndarray:
        if self._sizes is None:
            # np.diff allocates fresh memory: no caller-buffer aliasing
            self._sizes = np.diff(self._indptr).astype(np.int64, copy=False)
            self._indptr = None
        return self._sizes

    def costs(self) -> np.ndarray:
        return self.sizes().astype(np.float64)

    def fingerprint(self) -> str:
        return self._fp

    @property
    def sizes_are_structural(self) -> bool:
        """Row lengths ARE the CSR payload layout; refinement keeps them."""
        return True


class DegreeCosts(NnzCosts):
    """Per-vertex degree of a CSR graph (row u = u's neighbor list): the
    paper's BFS per-vertex cost. Structurally `NnzCosts`; kept distinct so
    registry entries and fingerprints name the workload they describe."""

    _kind = "degree"


class ExpertLoadCosts:
    """Per-expert kept token counts from an MoE dispatch plan — the
    expert-dispatch analogue of `NnzCosts`: item = expert, work units =
    tokens dispatched to it. The counts ARE the plan's expert-major CSR
    payload layout, so sizes are structural (refinement re-weights the
    partition but never re-derives the token layout). Zero-load experts
    are allowed (a cold expert still owns a slot). Fingerprint eager,
    arrays copied on first use."""

    _kind = "expert-load"

    def __init__(self, counts: np.ndarray):
        counts = np.asarray(counts)
        if counts.ndim != 1 or counts.size < 1:
            raise ValueError(
                f"expert loads must be 1-D non-empty, got {counts.shape}")
        if not np.issubdtype(counts.dtype, np.integer):
            raise TypeError(
                f"expert loads are token counts, expected an integer "
                f"array, got {counts.dtype}")
        if (counts < 0).any():
            raise ValueError("expert loads must be non-negative")
        self._counts = counts
        self._sizes = None
        self._fp = f"{self._kind}:{_digest(counts)}"

    def sizes(self) -> np.ndarray:
        if self._sizes is None:
            self._sizes = self._counts.astype(np.int64)  # astype copies
            self._counts = None
        return self._sizes

    def costs(self) -> np.ndarray:
        return self.sizes().astype(np.float64)

    def fingerprint(self) -> str:
        return self._fp

    @property
    def sizes_are_structural(self) -> bool:
        """Token counts ARE the dispatch payload layout; refinement keeps
        them."""
        return True


class RemainingTokensCosts:
    """Per-request REMAINING prompt tokens — the serving engine's cost
    provider (DESIGN.md §2.10): item = an in-flight request's prefill
    stream, work units = prompt tokens not yet prefilled. The continuous
    batcher re-presents this every engine step as chunks complete, and the
    measured step wall-clock flows back through `Schedule.observe/refine`
    so the per-request cost estimates track the machine, not the token
    count alone.

    Zero-remaining requests are allowed (a request that finished prefill
    but still holds a batch slot). Token counts ARE the chunk layout the
    batcher slices, so sizes are structural. Fingerprint eager, arrays
    copied on first use — same cache-hit economics and no-aliasing
    guarantees as the other providers."""

    _kind = "remaining-tokens"

    def __init__(self, remaining: np.ndarray):
        remaining = np.asarray(remaining)
        if remaining.ndim != 1 or remaining.size < 1:
            raise ValueError(
                f"remaining tokens must be 1-D non-empty, got "
                f"{remaining.shape}")
        if not np.issubdtype(remaining.dtype, np.integer):
            raise TypeError(
                f"remaining tokens are counts, expected an integer array, "
                f"got {remaining.dtype}")
        if (remaining < 0).any():
            raise ValueError("remaining token counts must be non-negative")
        self._remaining = remaining
        self._sizes = None
        self._fp = f"{self._kind}:{_digest(remaining)}"

    def sizes(self) -> np.ndarray:
        if self._sizes is None:
            self._sizes = self._remaining.astype(np.int64)  # astype copies
            self._remaining = None
        return self._sizes

    def costs(self) -> np.ndarray:
        return self.sizes().astype(np.float64)

    def fingerprint(self) -> str:
        return self._fp

    @property
    def sizes_are_structural(self) -> bool:
        """Token counts ARE the prefill chunk layout; refinement keeps
        them."""
        return True


class RefinedCosts:
    """Measured-cost refinement output: refreshed per-item costs, with the
    work-unit sizes either KEPT from the parent schedule (structural —
    payload layouts must not drift) or re-derived by quantization. Carries
    the refinement `generation` in its fingerprint so a refined schedule
    can never alias a stale cache entry."""

    def __init__(self, sizes: np.ndarray, costs: np.ndarray, *,
                 generation: int, structural: bool):
        costs = np.asarray(costs, np.float64)
        if costs.ndim != 1:
            raise ValueError(f"per-item costs must be 1-D, got {costs.shape}")
        self._costs = costs.copy()
        self._structural = bool(structural)
        self._gen = int(generation)
        if self._structural:
            sizes = np.asarray(sizes, np.int64)
            if sizes.shape != costs.shape:
                raise ValueError(f"sizes {sizes.shape} != costs {costs.shape}")
            self._sizes = sizes.copy()
        else:
            self._sizes = quantize_costs(self._costs)
        self._fp = (f"refined:g{self._gen}:"
                    f"{_digest(self._sizes, self._costs)}")

    def sizes(self) -> np.ndarray:
        return self._sizes

    def costs(self) -> np.ndarray:
        return self._costs

    def fingerprint(self) -> str:
        return self._fp

    @property
    def sizes_are_structural(self) -> bool:
        return self._structural

    @property
    def generation(self) -> int:
        return self._gen


def as_cost_provider(costs) -> CostProvider:
    """Coerce facade inputs: a provider passes through, an array wraps."""
    if isinstance(costs, CostProvider):
        return costs
    return ExplicitCosts(costs)
