"""iCh-scheduled pull-direction BFS frontier step: the CUDA kernels'
wrappers and their plain PyTorch versions.

* `ich_bfs_step` — the flat walk over the (T, R, W) payload, the
  cross-check path, run at every level. It replaces the sequential
  (T,)-grid Pallas kernel `src/repro/kernels/ich_bfs/ich_bfs.py:90`
  (`ich_bfs_step`) with SpMV's two launches over the whole card
  (`csrc/flat_walk.cuh`): phase A computes every slot's increment in
  parallel (a persistent grid filling every SM, chunks of slots streamed
  through a two-stage shared-memory ring), phase B gives each vertex to
  the one thread at the head of its run of slots, which max-folds the run
  and writes the vertex once. One owner a vertex keeps the bits, with no
  atomics. What bounds it: bytes (8·W a slot of payload). The serial part
  left is the longest run (2,091 slots, the heaviest vertex of the
  1,000,000-vertex scale-free graph at W = 8). It reads only the flat
  payload and rowid, never the shard layout.
* `ich_bfs_step_sharded` — the main path: one worker per CTA over the
  (p, S_B) superstep layout of `core.tiling.WorkerShards`, reading blocks
  of B tiles straight out of the flat (T_pad, R, W) payload, with the
  optional (p, S_B) cost stream the measured-cost refiner consumes. It
  replaces `ich_bfs.py:195` (`ich_bfs_step_sharded`) with one launch of
  SpMV's sharded walk (`csrc/sharded_walk.cuh`) with a max fold: still
  exactly one CTA per worker, of 768 threads in three pipelines that take
  the worker's windows of whole tiles in turn, each through its own
  three-stage shared-memory ring filled ahead with cp.async.bulk; lanes,
  then slot maxes masked by the visited bits, then each run max-folded by
  the thread at its head, a run crossing windows handed on in order. It
  takes every width. `sharded_launch_shape` reports the launch.

The graph's row u lists u's in-neighbors; `mask` is the all-ones CSR
payload packed like SpMV's values (1.0 on real edge lanes, 0.0 on
padding). Frontier, visited and the result are (n,) float32 0/1
indicators, so every version gives the same bits.

A wrapper given CPU tensors runs the plain version (`ich_bfs_step_plain`,
`ich_bfs_step_sharded_plain`); given CUDA tensors it launches the kernels
of `csrc/ich_bfs.cu` or raises: there is no fallback. Each wrapper counts
its calls that launched in `LAUNCHES` (a flat walk is two CUDA kernels a
call).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.segmented import (emit_step_cost, segmented_apply,
                                        worker_reduce)
from repro_torch.kernels import _build
from repro_torch.kernels._common import (check, check_shard_layout,
                                         flat_shape, on_cpu, raise_on,
                                         shard_tiles, sharded_shape)

__all__ = ["LAUNCHES", "flat_launch_shape", "ich_bfs_step",
           "ich_bfs_step_plain",
           "ich_bfs_step_sharded", "ich_bfs_step_sharded_plain",
           "reset_launches", "sharded_launch_shape"]

# kernel launches per wrapper since the last reset_launches()
LAUNCHES = {"ich_bfs_step": 0, "ich_bfs_step_sharded": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# --------------------------------------------------------- plain versions
def slot_increments(mask, cols, rows, frontier, visited) -> torch.Tensor:
    """(N, R) slot values of (N, R, W) tiles on vertices `rows` (N, R):
    `hit = max_w mask * frontier[cols]`, `inc = hit * (1 - visited[row])`
    (padding slots, row -1, are left to the fold, which skips them)."""
    hit = (mask * frontier[cols.long()]).amax(dim=2)
    valid = rows >= 0
    seen = torch.zeros_like(hit)
    seen[valid] = visited[rows[valid].long()]
    return hit * (1.0 - seen)


def ich_bfs_step_plain(mask, cols, rowid, frontier, visited,
                       n_vertices: int) -> torch.Tensor:
    """Plain version of `ich_bfs_step`: mask/cols (T, R, W), rowid (T, R),
    frontier/visited (n,) -> next frontier (n_vertices,)."""
    out = torch.zeros(n_vertices, dtype=torch.float32, device=frontier.device)
    inc = slot_increments(mask, cols, rowid, frontier, visited)
    return segmented_apply(out, rowid, inc, combine="max")


def ich_bfs_step_sharded_plain(mask, cols, rowid, blkid, frontier, visited,
                               n_vertices: int, p: int, superstep: int, *,
                               slot_cost=None):
    """Plain version of `ich_bfs_step_sharded`, written as the reference
    is: each worker max-folds its tiles into its own row of a
    (p, n_vertices) accumulator, and `worker_reduce` folds the rows."""
    B = int(superstep)
    S_B = blkid.numel() // p
    tiles = shard_tiles(blkid, B)
    inc = slot_increments(mask[tiles], cols[tiles], rowid, frontier, visited)
    owner = torch.arange(p, device=frontier.device).repeat_interleave(S_B * B)
    rows = torch.where(rowid >= 0, rowid.long() + owner[:, None] * n_vertices,
                       -1)
    acc = torch.zeros(p * n_vertices, dtype=torch.float32,
                      device=frontier.device)
    out = worker_reduce(segmented_apply(acc, rows, inc, combine="max")
                        .view(p, n_vertices), "max")
    if slot_cost is None:
        return out
    R = rowid.shape[1]
    costs = emit_step_cost(rowid.reshape(p * S_B, B * R),
                           slot_cost[tiles].reshape(p * S_B, B * R))
    return out, costs.view(p, S_B)


# --------------------------------------------------------------- wrappers
def _lib() -> ctypes.CDLL:
    lib = _build.load("ich_bfs")
    if not getattr(lib, "_typed", False):
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.ich_bfs_step_sharded_launch.argtypes = [ptr] * 9 + [i32] * 5 \
            + [ptr]
        lib.ich_bfs_step_sharded_launch.restype = i32
        lib.ich_bfs_step_launch.argtypes = [ptr] * 6 + [i64, ptr, i64, i32,
                                                         i32, ptr]
        lib.ich_bfs_step_launch.restype = i32
        lib.ich_bfs_flat_shape.argtypes = [i64, i32, i32,
                                           ctypes.POINTER(i32)]
        lib.ich_bfs_flat_shape.restype = i32
        lib.ich_bfs_sharded_shape.argtypes = [i32] * 6 + [
            ctypes.POINTER(i32)]
        lib.ich_bfs_sharded_shape.restype = i32
        lib._typed = True
    return lib


def _check_indicators(frontier, visited, n_vertices: int) -> None:
    check("frontier", frontier, torch.float32, (n_vertices,))
    check("visited", visited, torch.float32, (n_vertices,))


def flat_launch_shape(T: int, R: int, W: int) -> dict:
    """The launch shape `ich_bfs_step` takes on the card for T tiles of R
    slots and W lanes (16-byte-aligned payloads): see
    `_common.flat_shape`."""
    return flat_shape(_lib().ich_bfs_flat_shape, T, R, W, "ich_bfs_step")


def sharded_launch_shape(p: int, S_B: int, B: int, R: int, W: int, *,
                         bulk: bool = True) -> dict:
    """The launch `ich_bfs_step_sharded` makes on the card for p workers
    of S_B supersteps of B tiles of R slots and W lanes: see
    `_common.sharded_shape`."""
    return sharded_shape(_lib().ich_bfs_sharded_shape, p, S_B, B, R, W,
                         bulk, "ich_bfs_step_sharded")


def ich_bfs_step(mask, cols, rowid, frontier, visited,
                 n_vertices: int) -> torch.Tensor:
    """Flat walk. mask/cols (T, R, W) f32/i32, rowid (T, R) i32,
    frontier/visited (n,) f32 -> next frontier (n_vertices,) f32."""
    if on_cpu(mask, cols, rowid, frontier, visited):
        return ich_bfs_step_plain(mask, cols, rowid, frontier, visited,
                                  n_vertices)
    T, R, W = mask.shape
    check("mask", mask, torch.float32)
    check("cols", cols, torch.int32, (T, R, W))
    check("rowid", rowid, torch.int32, (T, R))
    _check_indicators(frontier, visited, n_vertices)
    dev = frontier.device
    if T == 0:
        return torch.zeros(n_vertices, dtype=torch.float32, device=dev)
    # phase A zeroes `out`
    out = torch.empty(n_vertices, dtype=torch.float32, device=dev)
    partial = torch.empty(T * R, dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = _lib().ich_bfs_step_launch(mask.data_ptr(), cols.data_ptr(),
                                      rowid.data_ptr(), frontier.data_ptr(),
                                      visited.data_ptr(), out.data_ptr(),
                                      n_vertices, partial.data_ptr(), T, R, W,
                                      stream)
    raise_on(code, "ich_bfs_step")
    LAUNCHES["ich_bfs_step"] += 1
    return out


def ich_bfs_step_sharded(mask, cols, rowid, blkid, frontier, visited,
                         n_vertices: int, p: int, superstep: int, *,
                         slot_cost=None):
    """Worker-sharded walk. mask/cols (T_pad, R, W): the FLAT payload with
    T padded to whole supersteps (`pack_csr(..., pad_tiles_to=B)`); rowid
    (p*S, R) and blkid (p*S_B,) from `WorkerShards`; frontier/visited
    (n,). Returns the next frontier (n_vertices,), or (frontier, costs)
    with costs (p, S_B) when `slot_cost`, the (T_pad, R) per-slot cost
    stream, is given."""
    T_pad, R, W = mask.shape
    p, B = int(p), int(superstep)
    S_B = check_shard_layout(T_pad, rowid, blkid, p, B)
    cpu = on_cpu(mask, cols, rowid, blkid, frontier, visited, slot_cost)
    if T_pad == 0:  # an empty graph: nothing to run
        out = torch.zeros(n_vertices, dtype=torch.float32,
                          device=frontier.device)
        return out if slot_cost is None else (
            out, torch.zeros((p, S_B), dtype=torch.float32,
                             device=frontier.device))
    if cpu:
        return ich_bfs_step_sharded_plain(mask, cols, rowid, blkid, frontier,
                                          visited, n_vertices, p, B,
                                          slot_cost=slot_cost)
    check("mask", mask, torch.float32)
    check("cols", cols, torch.int32, (T_pad, R, W))
    check("rowid", rowid, torch.int32, (p * S_B * B, R))
    check("blkid", blkid, torch.int32, (p * S_B,))
    _check_indicators(frontier, visited, n_vertices)
    if slot_cost is not None:
        check("slot_cost", slot_cost, torch.float32, (T_pad, R))
    out = torch.zeros(n_vertices, dtype=torch.float32, device=frontier.device)
    costs = (None if slot_cost is None else
             torch.empty((p, S_B), dtype=torch.float32,
                         device=frontier.device))
    stream = torch.cuda.current_stream(frontier.device).cuda_stream
    code = _lib().ich_bfs_step_sharded_launch(
        mask.data_ptr(), cols.data_ptr(), rowid.data_ptr(), blkid.data_ptr(),
        None if slot_cost is None else slot_cost.data_ptr(),
        frontier.data_ptr(), visited.data_ptr(), out.data_ptr(),
        None if costs is None else costs.data_ptr(), p, S_B, B, R, W, stream)
    raise_on(code, "ich_bfs_step_sharded")
    LAUNCHES["ich_bfs_step_sharded"] += 1
    return out if costs is None else (out, costs)
