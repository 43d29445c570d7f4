"""iCh-scheduled segmented SpMV: the CUDA kernels' wrappers and their plain
PyTorch versions.

* `ich_spmv` — the flat walk over the (T, R, W) payload, the cross-check
  path. It replaces the sequential (T,)-grid Pallas kernel
  `src/repro/kernels/ich_spmv/ich_spmv.py:109` (`ich_spmv`) with two
  launches over the whole card (`csrc/flat_walk.cuh`): phase A computes
  every slot partial in parallel (a persistent grid filling every SM,
  chunks of slots streamed through a two-stage shared-memory ring), phase
  B gives each row to the one thread at the head of its run of slots,
  which folds the run in tile order and writes y once. The TPU grid's
  order only binds the slots of one row, and each row has one owner, so
  the bits are those of the sequential order, with no atomics. What
  bounds it: bytes (8·W a slot of payload). The serial part left is the
  longest run of one row (27 slots on `wikipedia` at W = 32). It reads
  only the flat payload and rowid, never the shard layout.
* `ich_spmv_sharded` — the main path: one worker per CTA over the (p, S_B)
  superstep layout of `core.tiling.WorkerShards`, reading blocks of B tiles
  straight out of the flat (T_pad, R, W) payload, with the optional
  (p, S_B) cost stream the measured-cost refiner consumes. It replaces
  `ich_spmv.py:215` (`ich_spmv_sharded`) with one launch
  (`csrc/sharded_walk.cuh`): still exactly one CTA per worker, now of
  768 threads in three pipelines that take the worker's windows of
  whole tiles in turn, each through its own three-stage shared-memory
  ring filled ahead with cp.async.bulk; lanes, then slot folds, then each
  run folded by the thread at its head, a run crossing windows handed on
  in order. It takes every width (a slot wider than a stage streams in
  pieces). `sharded_launch_shape` reports the launch.

A wrapper given CPU tensors runs the plain version (`ich_spmv_plain`,
`ich_spmv_sharded_plain`), which does the same per-slot partials in the
same order and the same ordered fold (`core/segmented.py`). Given CUDA
tensors it launches the kernels of `csrc/ich_spmv.cu` or raises: there is
no fallback. Each wrapper counts its calls that launched in `LAUNCHES`
(a flat walk is two CUDA kernels a call).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.segmented import (emit_step_cost, segmented_apply,
                                        worker_reduce)
from repro_torch.kernels import _build
from repro_torch.kernels._common import check as _check
from repro_torch.kernels._common import check_shard_layout
from repro_torch.kernels._common import flat_shape as _flat_shape
from repro_torch.kernels._common import on_cpu as _on_cpu
from repro_torch.kernels._common import raise_on as _raise_on
from repro_torch.kernels._common import shard_tiles as _shard_tiles
from repro_torch.kernels._common import sharded_shape as _sharded_shape

__all__ = ["LAUNCHES", "flat_launch_shape", "ich_spmv", "ich_spmv_plain",
           "ich_spmv_sharded", "ich_spmv_sharded_plain", "reset_launches",
           "sharded_launch_shape"]

# kernel launches per wrapper since the last reset_launches()
LAUNCHES = {"ich_spmv": 0, "ich_spmv_sharded": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# --------------------------------------------------------- plain versions
def tile_partials(vals: torch.Tensor, cols: torch.Tensor,
                  x: torch.Tensor) -> torch.Tensor:
    """(N, R) slot partials of (N, R, W) tiles: the left fold over w of
    vals * x[cols], in ascending w — the kernel's order."""
    acc = torch.zeros(vals.shape[:2], dtype=torch.float32, device=vals.device)
    for w in range(vals.shape[2]):
        acc = acc + vals[:, :, w] * x[cols[:, :, w].long()]
    return acc


def ich_spmv_plain(vals, cols, rowid, x, n_rows: int) -> torch.Tensor:
    """Plain version of `ich_spmv`: vals/cols (T, R, W), rowid (T, R),
    x (n,) -> y (n_rows,)."""
    y = torch.zeros(n_rows, dtype=torch.float32, device=x.device)
    return segmented_apply(y, rowid, tile_partials(vals, cols, x))


def ich_spmv_sharded_plain(vals, cols, rowid, blkid, x, n_rows: int, p: int,
                           superstep: int, *, slot_cost=None):
    """Plain version of `ich_spmv_sharded`, written as the reference is:
    each worker folds its tiles, in shard order, into its own row of a
    (p, n_rows) accumulator, and `worker_reduce` folds the rows."""
    T_pad, R, _ = vals.shape
    B = int(superstep)
    S_B = blkid.numel() // p
    tiles = _shard_tiles(blkid, B)
    partial = tile_partials(vals, cols, x)[tiles]           # (p*S, R)
    owner = torch.arange(p, device=x.device).repeat_interleave(S_B * B)
    rows = torch.where(rowid >= 0, rowid.long() + owner[:, None] * n_rows,
                       -1)
    acc = torch.zeros(p * n_rows, dtype=torch.float32, device=x.device)
    y = worker_reduce(segmented_apply(acc, rows, partial).view(p, n_rows))
    if slot_cost is None:
        return y
    costs = emit_step_cost(rowid.reshape(p * S_B, B * R),
                           slot_cost[tiles].reshape(p * S_B, B * R))
    return y, costs.view(p, S_B)


# --------------------------------------------------------------- wrappers
def _lib() -> ctypes.CDLL:
    lib = _build.load("ich_spmv")
    if not getattr(lib, "_typed", False):
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.ich_spmv_sharded_launch.argtypes = [ptr] * 8 + [i32] * 5 + [ptr]
        lib.ich_spmv_sharded_launch.restype = i32
        lib.ich_spmv_launch.argtypes = [ptr] * 5 + [i64, ptr, i64, i32, i32,
                                                     ptr]
        lib.ich_spmv_launch.restype = i32
        lib.ich_spmv_flat_shape.argtypes = [i64, i32, i32,
                                            ctypes.POINTER(i32)]
        lib.ich_spmv_flat_shape.restype = i32
        lib.ich_spmv_sharded_shape.argtypes = [i32] * 6 + [
            ctypes.POINTER(i32)]
        lib.ich_spmv_sharded_shape.restype = i32
        lib._typed = True
    return lib


def flat_launch_shape(T: int, R: int, W: int) -> dict:
    """The launch shape `ich_spmv` takes on the card for T tiles of R slots
    and W lanes (16-byte-aligned payloads): see `_common.flat_shape`."""
    return _flat_shape(_lib().ich_spmv_flat_shape, T, R, W, "ich_spmv")


def sharded_launch_shape(p: int, S_B: int, B: int, R: int, W: int, *,
                         bulk: bool = True) -> dict:
    """The launch `ich_spmv_sharded` makes on the card for p workers of
    S_B supersteps of B tiles of R slots and W lanes: see
    `_common.sharded_shape`."""
    return _sharded_shape(_lib().ich_spmv_sharded_shape, p, S_B, B, R, W,
                          bulk, "ich_spmv_sharded")


def ich_spmv(vals, cols, rowid, x, n_rows: int) -> torch.Tensor:
    """Flat walk. vals/cols (T, R, W) f32/i32, rowid (T, R) i32,
    x (n,) f32 -> y (n_rows,) f32."""
    if _on_cpu(vals, cols, rowid, x):
        return ich_spmv_plain(vals, cols, rowid, x, n_rows)
    T, R, W = vals.shape
    _check("vals", vals, torch.float32)
    _check("cols", cols, torch.int32, (T, R, W))
    _check("rowid", rowid, torch.int32, (T, R))
    _check("x", x, torch.float32)
    if T == 0:
        return torch.zeros(n_rows, dtype=torch.float32, device=x.device)
    # phase A zeroes y
    y = torch.empty(n_rows, dtype=torch.float32, device=x.device)
    partial = torch.empty(T * R, dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    code = _lib().ich_spmv_launch(vals.data_ptr(), cols.data_ptr(),
                                  rowid.data_ptr(), x.data_ptr(),
                                  y.data_ptr(), n_rows, partial.data_ptr(),
                                  T, R, W, stream)
    _raise_on(code, "ich_spmv")
    LAUNCHES["ich_spmv"] += 1
    return y


def ich_spmv_sharded(vals, cols, rowid, blkid, x, n_rows: int, p: int,
                     superstep: int, *, slot_cost=None):
    """Worker-sharded walk. vals/cols (T_pad, R, W): the FLAT payload with
    T padded to whole supersteps (`pack_csr(..., pad_tiles_to=B)`); rowid
    (p*S, R) and blkid (p*S_B,) from `WorkerShards` (`shard_item_id` /
    `kernel_block_ids`); x (n,). Returns y (n_rows,), or (y, costs) with
    costs (p, S_B) when `slot_cost`, the (T_pad, R) per-slot cost stream,
    is given."""
    T_pad, R, W = vals.shape
    p, B = int(p), int(superstep)
    S_B = check_shard_layout(T_pad, rowid, blkid, p, B)
    if _on_cpu(vals, cols, rowid, blkid, x, slot_cost):
        return ich_spmv_sharded_plain(vals, cols, rowid, blkid, x, n_rows,
                                      p, B, slot_cost=slot_cost)
    _check("vals", vals, torch.float32)
    _check("cols", cols, torch.int32, (T_pad, R, W))
    _check("rowid", rowid, torch.int32, (p * S_B * B, R))
    _check("blkid", blkid, torch.int32, (p * S_B,))
    _check("x", x, torch.float32)
    if slot_cost is not None:
        _check("slot_cost", slot_cost, torch.float32, (T_pad, R))
    y = torch.zeros(n_rows, dtype=torch.float32, device=x.device)
    if T_pad == 0:  # no tiles: nothing to run
        return y if slot_cost is None else (
            y, torch.zeros((p, S_B), dtype=torch.float32, device=x.device))
    costs = (None if slot_cost is None else
             torch.empty((p, S_B), dtype=torch.float32, device=x.device))
    stream = torch.cuda.current_stream(x.device).cuda_stream
    code = _lib().ich_spmv_sharded_launch(
        vals.data_ptr(), cols.data_ptr(), rowid.data_ptr(), blkid.data_ptr(),
        None if slot_cost is None else slot_cost.data_ptr(), x.data_ptr(),
        y.data_ptr(), None if costs is None else costs.data_ptr(),
        p, S_B, B, R, W, stream)
    _raise_on(code, "ich_spmv_sharded")
    LAUNCHES["ich_spmv_sharded"] += 1
    return y if costs is None else (y, costs)
