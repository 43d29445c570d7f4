"""iCh-scheduled K-Means assignment: the CUDA kernels' wrappers and their
plain PyTorch versions.

* `ich_kmeans_assign` — the flat walk over the (T, R) schedule, the
  cross-check path (counterpart of `repro`'s (T,)-grid kernel): one launch
  over the whole card, chunks of slots whose point rows are staged through
  shared memory with coalesced loads (`assign_launch_shape` reports it);
* `ich_kmeans_assign_sharded` — the main path: one worker per CTA over the
  (p*S, R) shard layout of `core.tiling.WorkerShards`, with the optional
  (p, S_B) cost stream; `rowid` and `slot_cost` both come in the shard
  layout (this kernel has no flat payload, so no block-index stream).

Each slot on point i computes `argmin_k sum_d (points[i, d] - c[k, d])^2`,
the sum a left fold over d and the argmin the first minimum, and "stores"
it as i's id; the slots of a split point agree. The plain versions
(`ich_kmeans_assign_plain`, `ich_kmeans_assign_sharded_plain`) do the same
fold in the same order, unfused, so kernel == plain holds exactly. A
wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel of `csrc/ich_kmeans.cu` or raises: there is no
fallback. Each wrapper counts its launches in `LAUNCHES`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.segmented import (emit_step_cost, segmented_apply,
                                        worker_reduce)
from repro_torch.kernels import _build
from repro_torch.kernels._common import (MAX_DYNAMIC_SMEM, check, on_cpu,
                                         raise_on)

__all__ = ["LAUNCHES", "assign_launch_shape", "ich_kmeans_assign",
           "ich_kmeans_assign_plain",
           "ich_kmeans_assign_sharded", "ich_kmeans_assign_sharded_plain",
           "reset_launches"]

# kernel launches per wrapper since the last reset_launches()
LAUNCHES = {"ich_kmeans_assign": 0, "ich_kmeans_assign_sharded": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# --------------------------------------------------------- plain versions
def slot_assign(points, centroids, rows) -> torch.Tensor:
    """int32 nearest-centroid id of the point each slot of `rows` names
    (any shape; padding slots, -1, get the id of point 0 and are left to
    the store, which skips them). The squared distance is the left fold
    over d of (p_d - c_kd)^2 — the kernel's order — and the argmin the
    first minimum over ascending k."""
    flat = rows.reshape(-1).long()
    sel = points[torch.where(flat >= 0, flat, 0)]
    d2 = torch.zeros((flat.numel(), centroids.shape[0]), dtype=torch.float32,
                     device=points.device)
    for d in range(points.shape[1]):
        diff = sel[:, d, None] - centroids[None, :, d]
        d2 = d2 + diff * diff
    return d2.argmin(dim=1).to(torch.int32).reshape(rows.shape)


def ich_kmeans_assign_plain(points, centroids, rowid) -> torch.Tensor:
    """Plain version of `ich_kmeans_assign`: points (n, D), centroids
    (K, D), rowid (T, R) -> ids (n,) int32."""
    out = torch.zeros(points.shape[0], dtype=torch.int32,
                      device=points.device)
    return segmented_apply(out, rowid, slot_assign(points, centroids, rowid),
                           combine="store")


def ich_kmeans_assign_sharded_plain(points, centroids, rowid, p: int,
                                    superstep: int, *, slot_cost=None):
    """Plain version of `ich_kmeans_assign_sharded`, written as the
    reference is: each worker stores into its own row of a zeroed (p, n)
    accumulator and `worker_reduce` folds the rows ("store" as max)."""
    n = points.shape[0]
    PS, R = rowid.shape
    S, B = PS // p, int(superstep)
    owner = torch.arange(p, device=points.device).repeat_interleave(S)
    rows = torch.where(rowid >= 0, rowid.long() + owner[:, None] * n, -1)
    acc = torch.zeros(p * n, dtype=torch.int32, device=points.device)
    ids = worker_reduce(
        segmented_apply(acc, rows, slot_assign(points, centroids, rowid),
                        combine="store").view(p, n), "store")
    if slot_cost is None:
        return ids
    S_B = S // B
    costs = emit_step_cost(rowid.reshape(p * S_B, B * R),
                           slot_cost.reshape(p * S_B, B * R))
    return ids, costs.view(p, S_B)


# --------------------------------------------------------------- wrappers
def _lib() -> ctypes.CDLL:
    lib = _build.load("ich_kmeans")
    if not getattr(lib, "_typed", False):
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.ich_kmeans_assign_sharded_launch.argtypes = [ptr] * 6 \
            + [i32] * 6 + [ptr]
        lib.ich_kmeans_assign_sharded_launch.restype = i32
        lib.ich_kmeans_assign_launch.argtypes = [ptr] * 4 \
            + [i64, i32, i32, ptr]
        lib.ich_kmeans_assign_launch.restype = i32
        lib.ich_kmeans_assign_shape.argtypes = [i64, i32, i32,
                                                ctypes.POINTER(i32)]
        lib.ich_kmeans_assign_shape.restype = i32
        lib._typed = True
    return lib


def _check_tables(points, centroids) -> tuple[int, int]:
    """(D, K) of the point and centroid tables on the card; raises on what
    the kernel does not take."""
    check("points", points, torch.float32)
    check("centroids", centroids, torch.float32)
    if points.ndim != 2 or centroids.ndim != 2 \
            or centroids.shape[1] != points.shape[1] \
            or centroids.shape[0] < 1:
        raise ValueError(f"points (n, D) and centroids (K >= 1, D) must "
                         f"share D, got {tuple(points.shape)} and "
                         f"{tuple(centroids.shape)}")
    K, D = centroids.shape
    if K * D * 4 > MAX_DYNAMIC_SMEM:
        raise ValueError(f"{K} x {D} centroids need {K * D * 4} bytes of "
                         f"shared memory; a CTA has {MAX_DYNAMIC_SMEM}")
    return D, K


def assign_launch_shape(n_slots: int, D: int, K: int) -> dict:
    """The launch `ich_kmeans_assign` makes on the card for n_slots slots,
    D features and K centroids: slots a CTA stages at a time (0: the
    centroids leave no room, points are read from global memory), CTAs,
    threads and shared memory."""
    out = (ctypes.c_int * 4)()
    raise_on(_lib().ich_kmeans_assign_shape(n_slots, D, K, out),
             "ich_kmeans_assign")
    return {"chunk_slots": out[0], "ctas": out[1], "threads": out[2],
            "smem_bytes": out[3]}


def ich_kmeans_assign(points, centroids, rowid) -> torch.Tensor:
    """Flat walk. points (n, D) f32, centroids (K, D) f32, rowid
    (T, R) i32 -> ids (n,) int32."""
    if on_cpu(points, centroids, rowid):
        return ich_kmeans_assign_plain(points, centroids, rowid)
    D, K = _check_tables(points, centroids)
    check("rowid", rowid, torch.int32)
    out = torch.zeros(points.shape[0], dtype=torch.int32,
                      device=points.device)
    if rowid.numel() == 0:
        return out
    stream = torch.cuda.current_stream(points.device).cuda_stream
    code = _lib().ich_kmeans_assign_launch(
        points.data_ptr(), centroids.data_ptr(), rowid.data_ptr(),
        out.data_ptr(), rowid.numel(), D, K, stream)
    raise_on(code, "ich_kmeans_assign")
    LAUNCHES["ich_kmeans_assign"] += 1
    return out


def ich_kmeans_assign_sharded(points, centroids, rowid, p: int,
                              superstep: int, *, slot_cost=None):
    """Worker-sharded walk. points (n, D), centroids (K, D); rowid (p*S, R)
    in the shard layout (`WorkerShards.shard_item_id`). Returns ids (n,)
    int32, or (ids, costs) with costs (p, S_B) when `slot_cost`, the
    (p*S, R) per-slot cost stream in the same shard layout, is given."""
    PS, R = rowid.shape
    p, B = int(p), int(superstep)
    S = PS // p
    if PS != p * S or S % B:
        raise ValueError(f"shard layout mismatch: {PS} rows, p={p}, B={B}")
    S_B = S // B
    cpu = on_cpu(points, centroids, rowid, slot_cost)
    if points.shape[0] == 0:  # no points: nothing to run
        ids = torch.zeros(0, dtype=torch.int32, device=points.device)
        return ids if slot_cost is None else (
            ids, torch.zeros((p, S_B), dtype=torch.float32,
                             device=points.device))
    if cpu:
        return ich_kmeans_assign_sharded_plain(points, centroids, rowid, p,
                                               B, slot_cost=slot_cost)
    D, K = _check_tables(points, centroids)
    check("rowid", rowid, torch.int32)
    if slot_cost is not None:
        check("slot_cost", slot_cost, torch.float32, (PS, R))
    out = torch.zeros(points.shape[0], dtype=torch.int32,
                      device=points.device)
    costs = (None if slot_cost is None else
             torch.empty((p, S_B), dtype=torch.float32,
                         device=points.device))
    stream = torch.cuda.current_stream(points.device).cuda_stream
    code = _lib().ich_kmeans_assign_sharded_launch(
        points.data_ptr(), centroids.data_ptr(), rowid.data_ptr(),
        None if slot_cost is None else slot_cost.data_ptr(), out.data_ptr(),
        None if costs is None else costs.data_ptr(), p, S_B, B, R, D, K,
        stream)
    raise_on(code, "ich_kmeans_assign_sharded")
    LAUNCHES["ich_kmeans_assign_sharded"] += 1
    return out if costs is None else (out, costs)
