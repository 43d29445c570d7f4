#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `src/repro_torch/csrc/`, holds each
against its plain PyTorch version on the card, drives the SpMV main path
(schedule -> sharded kernel -> observe/refine -> sharded kernel) on the
paper's `wikipedia` matrix at its published size (3,566,907 rows), checks
the result against a float64 host product, times every kernel beside its
plain version, its bound and cuSPARSE, and prints one JSON line per
result. Any failed check raises, so the script exits non-zero and prints
no final line. It needs CUDA and the repository's `src/` beside it.

The last line is `{"ok": true, "device": {...}}`; the line before the
last gives the card's name and power limit as nvidia-smi reports them, and
the line before that lists the kernels with their launches on the main
path and their times.
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import numpy as np

SEED = 0
N_ROWS = 3_566_907          # SuiteSparse Gleich/wikipedia-20070206
MATRIX = "wikipedia"
SMALL_ROWS = 20_000
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
F32_FLOPS = 67e12           # H100 SXM float32 outside the tensor cores
RTOL = ATOL = 1e-5          # kernel vs plain: same adds, other reductions
HOST_RTOL = 1e-4            # vs float64, relative to each row's sum |a*x|
SOURCE = "src/repro_torch/csrc/ich_spmv.cu"
REPLACES = {"ich_spmv": "src/repro/kernels/ich_spmv/ich_spmv.py:109",
            "ich_spmv_sharded": "src/repro/kernels/ich_spmv/ich_spmv.py:215"}


def log(**kw) -> None:
    print(json.dumps(kw), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def random_csr(n: int, seed: int):
    """A Zipf-row-length CSR with ~10% empty rows, values in [-1, 1)."""
    rng = np.random.default_rng(seed)
    row_nnz = np.minimum(rng.zipf(1.8, n), 200).astype(np.int64)
    row_nnz[rng.random(n) < 0.1] = 0
    return _csr_from_row_nnz(row_nnz, n, rng)


def _csr_from_row_nnz(row_nnz, n_cols, rng):
    indptr = np.zeros(row_nnz.size + 1, np.int64)
    np.cumsum(row_nnz, out=indptr[1:])
    nnz = int(indptr[-1])
    indices = rng.integers(0, n_cols, nnz, dtype=np.int32)
    data = rng.uniform(-1.0, 1.0, nnz).astype(np.float32)
    return indptr, indices, data


def timed_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median of `iters` CUDA-event timings of fn(), after `warmup` calls."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return float(np.median(times))


def phase_environment():
    import torch
    from repro_torch.device import card_identity
    from repro_torch.kernels import _build
    props = torch.cuda.get_device_properties(0)
    log(phase="environment", torch=torch.__version__, cuda=torch.version.cuda,
        device=torch.cuda.get_device_name(0), sm_count=props.multi_processor_count,
        card=card_identity())
    t0 = time.perf_counter()
    names = _build.build_all()
    log(phase="build", sources=names, seconds=time.perf_counter() - t0)
    return props.multi_processor_count


def phase_small():
    """Both kernels against their plain versions on a small Zipf CSR, at
    p in {1, 2, 4} x B in {1, 4, 8}; sharded == sequential bit for bit; a
    0-tile schedule returns zeros without a launch."""
    import torch
    from repro_torch.kernels.ich_spmv import ich_spmv as K
    from repro_torch.sched import LoopScheduler
    indptr, indices, data = random_csr(SMALL_ROWS, SEED)
    x = torch.from_numpy(np.random.default_rng(SEED + 1).uniform(
        -1.0, 1.0, SMALL_ROWS).astype(np.float32)).cuda()
    worst = 0.0
    for p in (1, 2, 4):
        for B in (1, 4, 8):
            op = LoopScheduler(p=p, superstep=B, cache_size=0).build(
                "spmv", indptr, indices, data)
            y, costs = K.ich_spmv_sharded(op.vals, op.cols, op.rowid,
                                          op.blkid, x, op.n_rows, p, B,
                                          slot_cost=op.slot_cost)
            y_plain, c_plain = K.ich_spmv_sharded_plain(
                op.vals, op.cols, op.rowid, op.blkid, x, op.n_rows, p, B,
                slot_cost=op.slot_cost)
            T = op.n_tiles
            rowid = torch.from_numpy(op.schedule.item_id).cuda()
            y_seq = K.ich_spmv(op.vals[:T], op.cols[:T], rowid, x, op.n_rows)
            y_seq_plain = K.ich_spmv_plain(op.vals[:T], op.cols[:T], rowid,
                                           x, op.n_rows)
            torch.cuda.synchronize()
            check(torch.allclose(y, y_plain, rtol=RTOL, atol=ATOL),
                  f"sharded kernel == plain at p={p} B={B}")
            check(torch.equal(costs, c_plain),
                  f"cost stream == plain at p={p} B={B}")
            check(torch.allclose(y_seq, y_seq_plain, rtol=RTOL, atol=ATOL),
                  f"sequential kernel == plain at p={p} B={B}")
            check(torch.equal(y, y_seq),
                  f"sharded == sequential bit for bit at p={p} B={B}")
            worst = max(worst, float((y - y_plain).abs().max()),
                        float((y_seq - y_seq_plain).abs().max()))
    # a matrix with no rows lowers to a 0-tile schedule (every row, even
    # an empty one, owns a slot)
    empty = LoopScheduler(p=4).build("spmv", np.zeros(1, np.int64),
                                     np.zeros(0, np.int32),
                                     np.zeros(0, np.float32))
    before = dict(K.LAUNCHES)
    y0 = empty(torch.zeros(0, device="cuda"))
    check(empty.n_tiles == 0 and y0.shape == (0,) and K.LAUNCHES == before
          and not empty.last_costs.any(),
          "0-tile schedule returns zeros with no launch")
    log(phase="small", rows=SMALL_ROWS, nnz=int(indptr[-1]),
        max_abs_err=worst, ok=True)


def _host_reference(indptr, indices, data, x):
    """float64 y and per-row sum |a*x| on the host."""
    row = np.repeat(np.arange(indptr.size - 1), np.diff(indptr))
    prod = data.astype(np.float64) * x.astype(np.float64)[indices]
    n = indptr.size - 1
    return (np.bincount(row, weights=prod, minlength=n),
            np.bincount(row, weights=np.abs(prod), minlength=n))


def _check_run(op, y, y64, absum, label):
    err = np.abs(y.cpu().numpy().astype(np.float64) - y64)
    check(bool(np.all(err <= HOST_RTOL * absum)),
          f"{label}: y within {HOST_RTOL} of each row's sum |a*x| "
          f"(worst excess {float(np.max(err - HOST_RTOL * absum))})")
    emitted = op.last_costs.cpu().numpy().sum(axis=1)
    expect = op.shards.worker_cost(op.schedule.tile_cost()).astype(np.float32)
    check(np.array_equal(emitted, expect),
          f"{label}: per-worker cost sums == worker_cost(tile_cost())")


def phase_main(sm_count):
    import torch
    from repro_torch.core.workloads import TABLE1, matrix_row_nnz
    from repro_torch.kernels.ich_spmv import ich_spmv as K
    from repro_torch.sched import LoopScheduler, NnzCosts, SpmvOp

    t0 = time.perf_counter()
    spec = next(s for s in TABLE1 if s.name == MATRIX)
    row_nnz = matrix_row_nnz(spec, n=N_ROWS, seed=SEED).astype(np.int64)
    rng = np.random.default_rng(SEED)
    indptr, indices, data = _csr_from_row_nnz(row_nnz, N_ROWS, rng)
    x_host = rng.uniform(-1.0, 1.0, N_ROWS).astype(np.float32)
    y64, absum = _host_reference(indptr, indices, data, x_host)
    log(phase="matrix", name=MATRIX, rows=N_ROWS, nnz=int(indptr[-1]),
        seconds=time.perf_counter() - t0)

    scheduler = LoopScheduler(p=sm_count)
    t0 = time.perf_counter()
    s = scheduler.schedule(NnzCosts(indptr))
    t_schedule = time.perf_counter() - t0
    t0 = time.perf_counter()
    shards = s.shard()
    t_shard = time.perf_counter() - t0
    t0 = time.perf_counter()
    op = scheduler.build("spmv", indptr, indices, data)
    torch.cuda.synchronize()
    t_pack = time.perf_counter() - t0
    check(op.schedule is s and op.shards is shards, "build reused the cache")
    x = torch.from_numpy(x_host).cuda()
    T, R, W = op.n_tiles, s.rows_per_tile, s.width
    log(phase="host_construction", schedule_s=t_schedule, shard_s=t_shard,
        pack_and_upload_s=t_pack, tiles=T, rows_per_tile=R, width=W,
        p=op.p, superstep=op.superstep, steps=shards.n_steps,
        slots=T * R * W, slots_per_nnz=T * R * W / int(indptr[-1]))

    # ---- the main path, counted: run -> cross-check -> refine -> run ----
    K.reset_launches()
    t0 = time.perf_counter()
    y = op(x)
    rowid_seq = torch.from_numpy(s.item_id).cuda()
    y_seq = K.ich_spmv(op.vals[:T], op.cols[:T], rowid_seq, x, op.n_rows)
    s2 = op.observe().refine()
    op2 = SpmvOp(s2, indptr, indices, data)
    y2 = op2(x)
    torch.cuda.synchronize()
    t_path = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    log(phase="main_path", seconds=t_path, launches=launches,
        generation=s2.generation)
    for name in REPLACES:
        check(launches[name] > 0, f"{name} launched on the main path")
    _check_run(op, y, y64, absum, "generation 0")
    check(torch.equal(y, y_seq), "full-size sharded == sequential bit for bit")
    _check_run(op2, y2, y64, absum, "generation 1")
    check(torch.equal(y2, y), "refined schedule gives the same y")
    del op2, y2

    # ---- kernels against their plain versions at the main path's shapes ----
    args = (op.vals, op.cols, op.rowid, op.blkid, x, op.n_rows, op.p,
            op.superstep)
    y_k, c_k = K.ich_spmv_sharded(*args, slot_cost=op.slot_cost)
    y_p, c_p = K.ich_spmv_sharded_plain(*args, slot_cost=op.slot_cost)
    check(torch.allclose(y_k, y_p, rtol=RTOL, atol=ATOL),
          "full-size sharded kernel == plain")
    check(torch.equal(c_k, c_p), "full-size cost stream == plain")
    err_sharded = float((y_k - y_p).abs().max())
    seq_args = (op.vals[:T], op.cols[:T], rowid_seq, x, op.n_rows)
    y_sp = K.ich_spmv_plain(*seq_args)
    check(torch.allclose(y_seq, y_sp, rtol=RTOL, atol=ATOL),
          "full-size sequential kernel == plain")
    err_seq = float((y_seq - y_sp).abs().max())
    del y_k, c_k, y_p, c_p, y_sp

    # ---- timings ----
    ms = {
        "ich_spmv_sharded": timed_ms(
            lambda: K.ich_spmv_sharded(*args, slot_cost=op.slot_cost)),
        "ich_spmv": timed_ms(lambda: K.ich_spmv(*seq_args)),
    }
    plain_ms = {
        "ich_spmv_sharded": timed_ms(
            lambda: K.ich_spmv_sharded_plain(*args, slot_cost=op.slot_cost)),
        "ich_spmv": timed_ms(lambda: K.ich_spmv_plain(*seq_args)),
    }
    csr = torch.sparse_csr_tensor(
        torch.from_numpy(indptr.astype(np.int32)).cuda(),
        torch.from_numpy(indices).cuda(), torch.from_numpy(data).cuda(),
        size=(N_ROWS, N_ROWS), check_invariants=False)
    y_lib = csr @ x
    torch.cuda.synchronize()
    check(bool(np.all(np.abs(y_lib.cpu().numpy() - y64)
                      <= HOST_RTOL * absum)), "cuSPARSE y sane")
    library_ms = timed_ms(lambda: csr @ x)
    del csr, y_lib

    # ---- bounds: bytes each input is read once / output written once ----
    real = int((s.item_id >= 0).sum())          # slots the kernels read
    p, S_B = op.shards.block_perm.shape
    common = real * W * 8 + N_ROWS * 4 + N_ROWS * 4   # vals+cols, x, y
    bytes_ = {
        "ich_spmv_sharded": common + real * 4 + op.rowid.numel() * 4
        + p * S_B * 4 * 2,                      # slot_cost, rowid, blkid+costs
        "ich_spmv": common + T * R * 4,         # rowid
    }
    flops = 2 * real * W
    kernels = []
    for name, err in (("ich_spmv_sharded", err_sharded), ("ich_spmv", err_seq)):
        t_bytes = bytes_[name] / HBM_BYTES_PER_S * 1e3
        t_ops = flops / F32_FLOPS * 1e3
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": err, "ms": ms[name], "plain_ms": plain_ms[name],
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms, "bytes": bytes_[name], "flops": flops})
    return kernels


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.device import card_identity
    sm_count = phase_environment()
    phase_small()
    kernels = phase_main(sm_count)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card_identity(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
