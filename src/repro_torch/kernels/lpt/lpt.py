"""The device schedule pipeline's two CUDA kernels: wrappers and their plain
PyTorch versions.

* `segment_fold` — float64 sums of the runs of a non-decreasing segment-id
  stream, each a left fold from 0.0 in index order: the addition order of
  `np.bincount(ids, weights=values)`, which the numpy construction's block
  and chain costs use (`core/tiling.py: partition_tiles`). On the card each
  warp loads a span of 128 values coalesced and the thread at each run's
  head folds it with a count it knows from the warp's ballots (the warp
  together goes on with a run longer than its span); the kernel writes the
  zeros of empty segments too. `index_add_` / `scatter_add_` would add
  with atomics in an order that changes from run to run.
* `lpt_assign` — the LPT loop of `partition_tiles`: chains in `order`
  (heaviest first) each go to the worker of least float64 load, ties to
  the smallest worker id, as heapq's (load, worker) tuples order them.
  Chain ids at or past `n_real` (a one-element tensor, read on the card so
  the pipeline need not sync) are phantom chains: they are skipped and
  their entries stay -1. On the card one CTA places the chains in exact
  rounds (`csrc/lpt.cu`: with the workers sorted by (load, id), chain t of
  a round goes to the t-th worker while no earlier chain's new load lies
  below that worker's), up to min(p, ROUND_WINDOW) chains a round; it
  writes its round count to `LAST_ROUNDS`, which nothing on the main path
  reads.

The plain versions (`segment_fold_plain`: a vectorised fold over each
run's k-th element; `lpt_assign_plain`: a loop of `torch.argmin`) compute
the same bits by another route. A wrapper given CPU tensors runs the plain
version; given CUDA tensors it launches the kernel of `csrc/lpt.cu` or
raises: there is no fallback. Each wrapper counts its launches in
`LAUNCHES`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._common import check, on_cpu, raise_on

__all__ = ["LAUNCHES", "LAST_ROUNDS", "MAX_WORKERS", "ROUND_WINDOW",
           "lpt_assign", "lpt_assign_plain", "reset_launches", "segment_fold",
           "segment_fold_plain"]

# kernel launches per wrapper since the last reset_launches()
LAUNCHES = {"segment_fold": 0, "lpt_assign": 0}

MAX_WORKERS = 4096   # sorted worker keys in lpt_assign's shared memory
ROUND_WINDOW = 1024  # chains an lpt_assign round looks at, at most
# (1,) int64 on the card: the rounds of the last lpt_assign launch
LAST_ROUNDS: torch.Tensor | None = None


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# --------------------------------------------------------- plain versions
def segment_fold_plain(values: torch.Tensor, seg: torch.Tensor,
                       n_segments: int) -> torch.Tensor:
    """Plain version of `segment_fold`: step k adds every run's k-th value
    to that run's sum, so each sum is the left fold from 0.0 in index
    order. Ids outside [0, n_segments) are dropped."""
    out = torch.zeros(int(n_segments), dtype=torch.float64,
                      device=values.device)
    n = values.numel()
    if n == 0:
        return out
    head = torch.ones(n, dtype=torch.bool, device=values.device)
    head[1:] = seg[1:] != seg[:-1]
    start = torch.nonzero(head).reshape(-1)
    length = torch.diff(start, append=start.new_tensor([n]))
    acc = torch.zeros(start.numel(), dtype=torch.float64,
                      device=values.device)
    for k in range(int(length.max())):
        live = length > k
        acc[live] = acc[live] + values[start[live] + k]
    ids = seg[start]
    ok = (ids >= 0) & (ids < n_segments)
    out[ids[ok]] = acc[ok]
    return out


def lpt_assign_plain(cost: torch.Tensor, order: torch.Tensor,
                     n_real: torch.Tensor, p: int) -> torch.Tensor:
    """Plain version of `lpt_assign`: one `torch.argmin` a chain (the first
    minimum, so ties go to the smallest worker id) and a float64 add."""
    out = torch.full((order.numel(),), -1, dtype=torch.int32,
                     device=cost.device)
    loads = torch.zeros(int(p), dtype=torch.float64, device=cost.device)
    real = int(n_real.reshape(-1)[0])
    for c in order.tolist():
        if 0 <= c < real:
            w = int(torch.argmin(loads))
            loads[w] += cost[c]
            out[c] = w
    return out


# --------------------------------------------------------------- wrappers
def _lib() -> ctypes.CDLL:
    lib = _build.load("lpt")
    if not getattr(lib, "_typed", False):
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.segment_fold_launch.argtypes = [ptr, ptr, i64, i64, ptr, ptr]
        lib.segment_fold_launch.restype = i32
        lib.lpt_assign_launch.argtypes = [ptr, ptr, ptr, i64, i32, ptr, ptr,
                                          ptr, ptr]
        lib.lpt_assign_launch.restype = i32
        lib._typed = True
    return lib


def segment_fold(values: torch.Tensor, seg: torch.Tensor,
                 n_segments: int) -> torch.Tensor:
    """(n_segments,) float64: out[s] = the left fold from 0.0, in index
    order, of the float64 `values` whose int64 id in `seg` is s. `seg` must
    be non-decreasing (the kernel folds runs; it does not sort)."""
    if on_cpu(values, seg):
        return segment_fold_plain(values, seg, n_segments)
    check("values", values, torch.float64)
    check("seg", seg, torch.int64, tuple(values.shape))
    if values.ndim != 1:
        raise ValueError(f"values must be 1-D, got {tuple(values.shape)}")
    if values.numel() == 0 or n_segments == 0:
        return torch.zeros(int(n_segments), dtype=torch.float64,
                           device=values.device)
    out = torch.empty(int(n_segments), dtype=torch.float64,
                      device=values.device)   # the kernel writes every entry
    stream = torch.cuda.current_stream(values.device).cuda_stream
    raise_on(_lib().segment_fold_launch(
        values.data_ptr(), seg.data_ptr(), values.numel(), int(n_segments),
        out.data_ptr(), stream), "segment_fold")
    LAUNCHES["segment_fold"] += 1
    return out


def lpt_assign(cost: torch.Tensor, order: torch.Tensor,
               n_real: torch.Tensor, p: int) -> torch.Tensor:
    """(n,) int32 worker of every chain: `cost` (n,) float64 chain costs,
    `order` (n,) int64 the chains heaviest first, `n_real` a one-element
    int64 tensor, the number of real chains (ids at or past it are skipped
    and stay -1), over `p` workers. On the card the launch's round count
    is left in `LAST_ROUNDS`."""
    global LAST_ROUNDS
    p = int(p)
    if p < 1:
        raise ValueError(f"worker count must be positive, got {p}")
    if on_cpu(cost, order, n_real):
        return lpt_assign_plain(cost, order, n_real, p)
    check("cost", cost, torch.float64)
    check("order", order, torch.int64, tuple(cost.shape))
    check("n_real", n_real, torch.int64, (1,))
    if p > MAX_WORKERS:
        raise ValueError(f"lpt_assign keeps at most {MAX_WORKERS} worker "
                         f"loads in shared memory, got p={p}")
    n = order.numel()
    if n >= 2 ** 31:
        raise ValueError(f"lpt_assign takes fewer than 2^31 chains, got {n}")
    out = torch.full((n,), -1, dtype=torch.int32, device=cost.device)
    if n == 0:
        return out
    # the compacted costs, their count, ids and placements
    scratch = torch.empty(2 * n + 1, dtype=torch.int64, device=cost.device)
    rounds = torch.empty(1, dtype=torch.int64, device=cost.device)
    stream = torch.cuda.current_stream(cost.device).cuda_stream
    raise_on(_lib().lpt_assign_launch(
        cost.data_ptr(), order.data_ptr(), n_real.data_ptr(), n, p,
        out.data_ptr(), scratch.data_ptr(), rounds.data_ptr(), stream),
        "lpt_assign")
    LAUNCHES["lpt_assign"] += 1
    LAST_ROUNDS = rounds
    return out
