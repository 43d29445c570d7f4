#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from `src/repro_torch/csrc/` (one nvcc per
source, all started together), holds each against its plain PyTorch
version on the card, and drives the port's five main paths, each with
its launch counters set to 0 just before it and read just after:

* SpMV (schedule -> sharded kernel -> observe/refine -> sharded kernel) on
  the paper's `wikipedia` matrix at its published size (3,566,907 rows),
  checked against a float64 host product;
* BFS (`levels(0)`, cross-checked against the flat walk at every
  level, then observe/refine and `levels(0)` again) at Rodinia BFS's
  largest published input, 1,000,000 vertices, on both graph kinds of the
  paper's BF workload, checked against a host BFS (scipy);
* K-Means assignment (run, cross-check, observe/refine, run, and two more
  rounds' schedules) at the shape of Rodinia K-Means' `kdd_cup` input,
  494,020 points x 34 features, K = 5, checked against a float64 host
  argmin;
* MoE expert dispatch (plan -> schedule -> sharded kernel -> expert load
  -> `refine_cap_scale` -> next plan, three closed-loop rounds) at the
  width of one OLMoE-1B-7B MoE layer (64 experts, top-8, D = 2048, expert
  F = 1024, float32) over 4,096 tokens, checked against a float64 host
  evaluation of 64 sampled tokens;
* Zamba2-1.2B serving (`Engine.generate`: iCh-chunked prefill, each chunk
  re-running the prefix through 6 flash-attention and 32 SSD-scan
  launches, then 32 decode steps) at full width (38 layers, d_model 2048,
  random float32 weights from a seeded generator) on 4 prompts of 2,048
  tokens, held to three bars: the last chunk's logits equal a one-shot
  prefill bit for bit, decode at position S matches a fresh prefill of
  S + 1 tokens, the logits are finite.

Then two paths of the schedule layer, each counted on its own:

* the schedule pipeline on the card (`LoopScheduler(backend="torch")` ->
  `device_lowering()` -> `pack_csr_torch` -> `ich_spmv_sharded` at
  wikipedia, whose y and costs must equal the host-built op's bit for bit,
  and `device_lowering()` of every other main path's schedule, through
  the `segment_fold` and `lpt_assign` kernels of `csrc/lpt.cu`): every
  lowering element-identical to the host `build_schedule` +
  `shard_schedule` (tile costs bit for bit), with and without `n_steps=`;
  the host path (schedule, shard, pack + upload) and the device path
  (CSR upload, lower, pack) timed per shape; both kernels at wikipedia's
  full size against np.bincount / `partition_tiles` and their plain
  versions;
* sharded recovery (`Schedule.reshard_survivors` -> the completed-prefix
  and survivor layouts through rows 2, 4 and 6 -> `combine`) for SpMV,
  a mid-depth BFS step on both graphs and K-Means, one or two workers
  dead, with a ragged checkpoint or none: the combined output must equal
  the fault-free run's bits and each run's cost stream must sum per
  worker to its layout's `worker_cost`.

For the flat walks (`ich_spmv`, `ich_bfs_step`: two kernels a call over
the whole card) it logs the launch shape, the longest run of one row (the
serial part of their fold) and the device time of each phase. For the
sharded walks (`ich_spmv_sharded`, `ich_bfs_step_sharded`: one CTA per
worker, a ring of supersteps) it logs the launch shape, the worker balance
(the most live slots of one worker over the mean) and the device time
beside the host's enqueue time; for both K-Means walks
(`ich_kmeans_assign` and `ich_kmeans_assign_sharded`, each one launch over
the whole card, the sharded one in chunks of whole supersteps) their grids,
checked to span the card, and the same split; for MoE the device time and
achieved rate of each product, and for flash attention and the SSD scan
(on the tensor cores) the device time of each of their kernels and the
achieved rate of float32 work.

Each sharded kernel that emits a cost stream (SpMV, BFS, K-Means, MoE) is
held against the port's discrete-event simulator at its main path's
shapes: `Schedule.replay_sharded` under zero overhead and jitter runs each
tile on the worker the kernel's shard layout gave it, and its per-worker
busy time must equal the per-worker sums of the emitted stream (within
COST_RTOL), its makespan their max. On the K-Means path the threaded
executor runs the schedule's work units on four host threads
(`parallel_for_units`), its chunk timings are folded in
(`observe(ExecStats)` -> `refine()`), and the refined generation's kernel
must give the main path's ids.

It times every kernel beside its plain version, its bound and PyTorch
computing the same function (cuSPARSE SpMV, `torch.cdist` argmin, MoE's
capacity-buffer `torch.bmm` form, `scaled_dot_product_attention`; the SSD
scan has no single PyTorch call), and prints one JSON line per result.
Any failed check raises, so the script exits non-zero and prints no final
line. It needs CUDA and the repository's `src/` beside it.

The last line is `{"ok": true, "device": {...}}`; the line before the
last gives the card's name and power limit as nvidia-smi reports them, and
the line before that lists the kernels with their launches on the main
path and their times.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

SEED = 0
N_ROWS = 3_566_907          # SuiteSparse Gleich/wikipedia-20070206
MATRIX = "wikipedia"
SMALL_ROWS = 20_000
N_VERTICES = 1_000_000      # Rodinia BFS, largest published input (graph1M)
GRAPHS = ("uniform", "scale_free")   # the paper's BF workload (Fig. 5a)
N_POINTS, N_FEATURES, N_CLUSTERS = 494_020, 34, 5   # Rodinia kdd_cup
KMEANS_ROUNDS = 3
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
F32_FLOPS = 67e12           # H100 SXM float32 outside the tensor cores
F64_FLOPS = 34e12           # H100 SXM float64 outside the tensor cores
TF32_FLOPS = 495e12         # H100 SXM dense TF32 on the tensor cores
RTOL = ATOL = 1e-5          # kernel vs plain: same adds, other reductions
HOST_RTOL = 1e-4            # vs float64, relative to each row's sum |a*x|
COST_RTOL = 1e-6            # float32 cost-stream sums vs float64 totals
EXEC_THREADS = 4            # host threads of the executor phase
TIE_RTOL = 1e-5             # K-Means ids may differ from float64 only here
# MoE: one OLMoE-1B-7B MoE layer (src/repro/configs/olmoe_1b_7b.py)
MOE_EXPERTS, MOE_TOP_K, MOE_D, MOE_F = 64, 8, 2048, 1024
MOE_TOKENS = 4096
MOE_ROWS_PER_TILE = 2       # as the reference's MoE benchmark lowers it
MOE_ROUNDS = 3
MOE_SAMPLE = 64             # tokens checked against float64 on the host
MOE_TOL = 1e-4              # kernel vs plain: 3xTF32 sums vs cuBLAS float32
PASS = "src/repro/kernels/"
KERNELS = {  # name -> (CUDA source, the Pallas kernel it replaces)
    "ich_spmv": ("src/repro_torch/csrc/ich_spmv.cu",
                 PASS + "ich_spmv/ich_spmv.py:109"),
    "ich_spmv_sharded": ("src/repro_torch/csrc/ich_spmv.cu",
                         PASS + "ich_spmv/ich_spmv.py:215"),
    "ich_bfs_step": ("src/repro_torch/csrc/ich_bfs.cu",
                     PASS + "ich_bfs/ich_bfs.py:90"),
    "ich_bfs_step_sharded": ("src/repro_torch/csrc/ich_bfs.cu",
                             PASS + "ich_bfs/ich_bfs.py:195"),
    "ich_kmeans_assign": ("src/repro_torch/csrc/ich_kmeans.cu",
                          PASS + "ich_kmeans/ich_kmeans.py:83"),
    "ich_kmeans_assign_sharded": ("src/repro_torch/csrc/ich_kmeans.cu",
                                  PASS + "ich_kmeans/ich_kmeans.py:163"),
    "ich_moe_sharded": ("src/repro_torch/csrc/ich_moe.cu",
                        PASS + "ich_moe/ich_moe.py:197"),
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        PASS + "flash_attention/flash_attention.py:95"),
    "mamba_scan": ("src/repro_torch/csrc/mamba_scan.cu",
                   PASS + "mamba_scan/mamba_scan.py:83"),
    # the schedule pipeline's two kernels replace XLA code of the reference's
    # jitted pipeline, not a Pallas kernel: its segment sum and LPT loop
    "segment_fold": ("src/repro_torch/csrc/lpt.cu",
                     "src/repro/core/tiling_jax.py:198"),
    "lpt_assign": ("src/repro_torch/csrc/lpt.cu",
                   "src/repro/core/tiling_jax.py:292"),
}
# the schedule pipeline and recovery (this slice's paths) re-use the main
# paths' schedules, ops and inputs, which each phase leaves here by name
SHAPES: dict = {}
PIPELINE_REPS = 3           # synchronized runs a pipeline timing is the median of
# lpt_assign's latency bound: one dependent shared-memory round trip per
# chain, taken as 30 SM cycles (an assumption, not a measurement) at the
# card's maximum SM clock (nvidia-smi clocks.max.sm)
SMEM_ROUND_TRIP_CYCLES = 30
# Zamba2-1.2B serving (src/repro/configs/zamba2_1_2b.py, full width)
LM_ARCH = "zamba2-1.2b"
LM_BATCH, LM_PROMPT, LM_NEW = 4, 2048, 32
LM_MAX_SEQ = 4096
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}   # tests/test_kernels.py:23-24
SCAN_TOL = 2e-4        # tests/test_kernels.py:206-209 (main shape: of sum |terms|)
SCAN_TOL_BF16 = 0.2    # bfloat16 q, k, v and y: 10 x the reference's 2e-2
DECODE_TOL = 2e-3        # decode vs fresh prefill (tests/test_arch_smoke.py)


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
    """Median of `iters` CUDA-event timings of fn(), after `warmup` calls;
    5 timings after one warm-up when a first call takes over 100 ms."""
    import torch
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    if time.perf_counter() - t0 > 0.1:
        iters, warmup = 5, 1
    for _ in range(warmup - 1):
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


def kernel_entry(name, *, launches, err, ms, plain_ms, library_ms,
                 bytes_, flops, peak=F32_FLOPS) -> dict:
    """One kernel's record for the `kernels` line: `bound_ms` is the larger
    of its bytes over the memory rate and its operations over `peak`, the
    rate of the units its arithmetic runs on (float32 CUDA cores unless
    said otherwise)."""
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    source, replaces = KERNELS[name]
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms, "bytes": bytes_, "flops": flops}


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
    p in {1, 2, 4} x B in {1, 4, 8}; sharded == flat walk bit for bit; a
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
                  f"flat walk == plain at p={p} B={B}")
            check(torch.equal(y, y_seq),
                  f"sharded == flat walk bit for bit at p={p} B={B}")
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


def phase_small_bfs_kmeans():
    """The BFS and K-Means kernels against their plain versions at
    p in {1, 2, 4} x B in {1, 4, 8}: BFS on a small uniform graph, K-Means
    on small points with a heavy point split over several tiles; sharded ==
    sequential exactly; a 0-vertex graph and a 0-point K-Means launch
    nothing."""
    import torch
    from repro_torch.core.workloads import bfs_graph
    from repro_torch.kernels.ich_bfs import ich_bfs as KB
    from repro_torch.kernels.ich_kmeans import ich_kmeans as KK
    from repro_torch.sched import LoopScheduler
    rng = np.random.default_rng(SEED + 2)
    indptr, indices = bfs_graph("uniform", SMALL_ROWS, SEED)
    f = torch.from_numpy((rng.random(SMALL_ROWS) < 0.05).astype(
        np.float32)).cuda()
    v = torch.maximum(f, torch.from_numpy(
        (rng.random(SMALL_ROWS) < 0.3).astype(np.float32)).cuda())
    costs = rng.uniform(6.0, 10.0, SMALL_ROWS)
    costs[123] = 20_000.0  # heavier than many slots: split over tiles
    pts = torch.from_numpy(rng.standard_normal(
        (SMALL_ROWS, N_FEATURES)).astype(np.float32)).cuda()
    cent = torch.from_numpy(rng.standard_normal(
        (N_CLUSTERS, N_FEATURES)).astype(np.float32)).cuda()
    for p in (1, 2, 4):
        for B in (1, 4, 8):
            sched = LoopScheduler(p=p, superstep=B, cache_size=0)
            op = sched.build("bfs", indptr, indices)
            args = (op.mask, op.cols, op.rowid, op.blkid, f, v, op.n, p, B)
            nxt, c = KB.ich_bfs_step_sharded(*args, slot_cost=op.slot_cost)
            nxt_p, c_p = KB.ich_bfs_step_sharded_plain(
                *args, slot_cost=op.slot_cost)
            T = op.n_tiles
            seq = (op.mask[:T], op.cols[:T],
                   torch.from_numpy(op.schedule.item_id).cuda(), f, v, op.n)
            nxt_s = KB.ich_bfs_step(*seq)
            torch.cuda.synchronize()
            check(torch.equal(nxt, nxt_p) and torch.equal(c, c_p),
                  f"BFS sharded kernel == plain at p={p} B={B}")
            check(torch.equal(nxt_s, KB.ich_bfs_step_plain(*seq)),
                  f"BFS flat walk == plain at p={p} B={B}")
            check(torch.equal(nxt, nxt_s),
                  f"BFS sharded == flat walk bit for bit at p={p} B={B}")
            km = sched.build("kmeans", costs)
            check(np.unique(np.nonzero(km.schedule.item_id == 123)[0]).size
                  > 1, "the heavy point spans several tiles")
            ids, c = KK.ich_kmeans_assign_sharded(
                pts, cent, km.rowid, p, B, slot_cost=km.slot_cost)
            ids_p, c_p = KK.ich_kmeans_assign_sharded_plain(
                pts, cent, km.rowid, p, B, slot_cost=km.slot_cost)
            rid = torch.from_numpy(km.schedule.item_id).cuda()
            ids_s = KK.ich_kmeans_assign(pts, cent, rid)
            torch.cuda.synchronize()
            check(torch.equal(ids, ids_p) and torch.equal(c, c_p),
                  f"K-Means sharded kernel == plain at p={p} B={B}")
            check(torch.equal(ids_s,
                              KK.ich_kmeans_assign_plain(pts, cent, rid)),
                  f"K-Means sequential kernel == plain at p={p} B={B}")
            check(torch.equal(ids, ids_s),
                  f"K-Means sharded == sequential at p={p} B={B}")
    # the sharded K-Means walk's other paths: 4-byte row copies (odd D, a
    # point table off 8-byte alignment), a superstep wider than a chunk
    for D, misaligned, R in ((33, False, 8), (34, True, 8), (34, False, 64)):
        host = rng.standard_normal((SMALL_ROWS, D)).astype(np.float32)
        pts_d = torch.from_numpy(host).cuda()
        if misaligned:
            pts_d = torch.empty(host.size + 1, device="cuda")[1:].view(
                SMALL_ROWS, D).copy_(pts_d)
        cent_d = torch.from_numpy(rng.standard_normal(
            (N_CLUSTERS, D)).astype(np.float32)).cuda()
        km = LoopScheduler(p=4, superstep=8, rows_per_tile=R,
                           cache_size=0).build("kmeans", costs)
        shape = KK.sharded_launch_shape(4, km.shards.n_steps, 8, R, D,
                                        N_CLUSTERS, aligned=not misaligned)
        ids, c = KK.ich_kmeans_assign_sharded(pts_d, cent_d, km.rowid, 4, 8,
                                              slot_cost=km.slot_cost)
        ids_p, c_p = KK.ich_kmeans_assign_sharded_plain(
            pts_d, cent_d, km.rowid, 4, 8, slot_cost=km.slot_cost)
        rid = torch.from_numpy(km.schedule.item_id).cuda()
        torch.cuda.synchronize()
        label = f"D={D} misaligned={misaligned} R={R}"
        check(shape["copy_bytes"] == (4 if D % 2 or misaligned else 8)
              and shape["chunk_slots"] >= 8 * R,
              f"K-Means sharded launch shape at {label}")
        check(torch.equal(ids, ids_p) and torch.equal(c, c_p),
              f"K-Means sharded kernel == plain at {label}")
        check(torch.equal(ids, KK.ich_kmeans_assign(pts_d, cent_d, rid)),
              f"K-Means sharded == sequential at {label}")
    before = (dict(KB.LAUNCHES), dict(KK.LAUNCHES))
    empty = LoopScheduler(p=4).build("bfs", np.zeros(1, np.int64),
                                     np.zeros(0, np.int32))
    z = torch.zeros(0, device="cuda")
    nxt0 = empty.step(z, z)
    km0 = LoopScheduler(p=4).build("kmeans", np.zeros(0))
    ids0 = km0(torch.zeros((0, 3), device="cuda"),
               torch.zeros((2, 3), device="cuda"))
    check(nxt0.shape == (0,) and nxt0.dtype == torch.float32
          and ids0.shape == (0,) and ids0.dtype == torch.int32
          and not empty.last_costs.any() and not km0.last_costs.any()
          and (dict(KB.LAUNCHES), dict(KK.LAUNCHES)) == before,
          "0-vertex BFS and 0-point K-Means return empty outputs unlaunched")
    log(phase="small_bfs_kmeans", vertices=SMALL_ROWS,
        edges=int(indptr[-1]), points=SMALL_ROWS, ok=True)


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
    for name in launches:
        check(launches[name] > 0, f"{name} launched on the main path")
    _check_run(op, y, y64, absum, "generation 0")
    check(torch.equal(y, y_seq), "full-size sharded == flat walk bit for bit")
    _check_run(op2, y2, y64, absum, "generation 1")
    check(torch.equal(y2, y), "refined schedule gives the same y")
    del op2, y2
    replay_cross_check("spmv", op)

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
          "full-size flat walk == plain")
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
    log_flat_walk("spmv", K, lambda: K.ich_spmv(*seq_args), T, R, W,
                  rowid_seq, sm_count)
    log_sharded_walk("spmv", K, op, op.vals, lambda: K.ich_spmv_sharded(
        *args, slot_cost=op.slot_cost))

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
    SHAPES["wikipedia"] = {
        "workload": "spmv", "inputs": (indptr, indices, data),
        "sched": {"p": sm_count}, "schedule": s, "op": op,
        "csr": (indptr, indices, data), "x": x, "y": y,
        "costs": op.last_costs}
    return [kernel_entry(name, launches=launches[name], err=err,
                         ms=ms[name], plain_ms=plain_ms[name],
                         library_ms=library_ms, bytes_=bytes_[name],
                         flops=flops)
            for name, err in (("ich_spmv_sharded", err_sharded),
                              ("ich_spmv", err_seq))]


def _host_levels(indptr, indices):
    """BFS levels from vertex 0 on the host (scipy): row u of the CSR lists
    u's in-neighbors, so the edges are v -> u; unreached = -1."""
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import shortest_path
    n = indptr.size - 1
    row = np.repeat(np.arange(n), np.diff(indptr))
    g = csr_matrix((np.ones(indices.size, np.float32), (indices, row)),
                   shape=(n, n))
    d = shortest_path(g, unweighted=True, indices=0)
    return np.where(np.isinf(d), -1, d).astype(np.int32)


def _bfs_run(kind, sm_count):
    """One graph's BFS main path, counted; then its kernels against their
    plain versions and their times at the level with the largest
    frontier."""
    import torch
    from repro_torch.core.workloads import bfs_graph
    from repro_torch.kernels.ich_bfs import ich_bfs as K
    from repro_torch.sched import BfsOp, LoopScheduler

    t0 = time.perf_counter()
    indptr, indices = bfs_graph(kind, N_VERTICES, SEED)
    level_host = _host_levels(indptr, indices)
    t_setup = time.perf_counter() - t0
    t0 = time.perf_counter()
    op = LoopScheduler(p=sm_count).build("bfs", indptr, indices)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    s, n, T = op.schedule, op.n, op.n_tiles
    rowid_seq = torch.from_numpy(s.item_id).cuda()

    def seq_args(f, v):
        return (op.mask[:T], op.cols[:T], rowid_seq, f, v, n)

    # ---- the main path, counted: levels -> per-level cross-check ->
    #      refine -> levels ----
    K.reset_launches()
    t0 = time.perf_counter()
    level = op.levels(0)
    torch.cuda.synchronize()
    t_levels = time.perf_counter() - t0
    frontier = torch.zeros(n, device="cuda")
    frontier[0] = 1.0
    visited = frontier.clone()
    level_loop = torch.full((n,), -1, dtype=torch.int32, device="cuda")
    level_loop[0] = 0
    depth, widest, big = 0, -1, None
    while bool(frontier.any()):
        width = int(frontier.sum())
        if width > widest:
            widest, big = width, (frontier, visited)
        nxt = op.step(frontier, visited)
        check(torch.equal(nxt, K.ich_bfs_step(*seq_args(frontier, visited))),
              f"{kind}: sharded == flat frontier at level {depth + 1}")
        depth += 1
        level_loop = torch.where(nxt > 0, depth, level_loop)
        visited = torch.maximum(visited, nxt)
        frontier = nxt
    s2 = op.observe().refine()
    level2 = BfsOp(s2, indptr, indices).levels(0)
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    log(phase="bfs_main_path", graph=kind, vertices=n,
        edges=int(indptr[-1]), max_degree=int(np.diff(indptr).max()),
        width=s.width, tiles=T, steps=op.shards.n_steps, levels=depth,
        widest_frontier=widest, reached=int((level >= 0).sum()),
        traversal_s=t_levels, setup_s=t_setup, build_s=t_build,
        launches=launches, generation=s2.generation)
    check(np.array_equal(level.cpu().numpy(), level_host),
          f"{kind}: levels == host BFS")
    check(torch.equal(level_loop, level), f"{kind}: step loop == levels()")
    emitted = op.last_costs.cpu().numpy().sum(axis=1)
    check(np.array_equal(emitted, op.shards.worker_cost(
        s.tile_cost()).astype(np.float32)),
        f"{kind}: per-worker cost sums == worker_cost(tile_cost())")
    check(s2.generation == 1 and torch.equal(level2, level),
          f"{kind}: refined generation gives the same levels")
    replay_cross_check("bfs", op, graph=kind)
    del level2, level_loop
    # the first traversal above paid for PyTorch's first use of its own
    # kernels; the warm traversal is the median of three more
    warm = []
    for _ in range(3):
        t0 = time.perf_counter()
        op.levels(0)
        torch.cuda.synchronize()
        warm.append(time.perf_counter() - t0)
    log(phase="bfs_traversal", graph=kind, levels=depth,
        first_s=t_levels, warm_median_s=float(np.median(warm)))

    # ---- kernels against their plain versions at the widest level ----
    f, v = big
    args = (op.mask, op.cols, op.rowid, op.blkid, f, v, n, op.p,
            op.superstep)
    y_k, c_k = K.ich_bfs_step_sharded(*args, slot_cost=op.slot_cost)
    y_p, c_p = K.ich_bfs_step_sharded_plain(*args, slot_cost=op.slot_cost)
    check(torch.equal(y_k, y_p) and torch.equal(c_k, c_p),
          f"{kind}: full-size sharded kernel == plain")
    y_s = K.ich_bfs_step(*seq_args(f, v))
    y_sp = K.ich_bfs_step_plain(*seq_args(f, v))
    check(torch.equal(y_s, y_sp), f"{kind}: full-size flat walk == plain")
    err = {"ich_bfs_step_sharded": float((y_k - y_p).abs().max()),
           "ich_bfs_step": float((y_s - y_sp).abs().max())}
    del y_p, c_p, y_sp
    ms = {"ich_bfs_step_sharded": timed_ms(
              lambda: K.ich_bfs_step_sharded(*args, slot_cost=op.slot_cost)),
          "ich_bfs_step": timed_ms(lambda: K.ich_bfs_step(*seq_args(f, v)))}
    plain_ms = {
        "ich_bfs_step_sharded": timed_ms(lambda: K.ich_bfs_step_sharded_plain(
            *args, slot_cost=op.slot_cost)),
        "ich_bfs_step": timed_ms(
            lambda: K.ich_bfs_step_plain(*seq_args(f, v)))}
    # yardstick: cuSPARSE over the 0/1 CSR counts each vertex's frontier
    # in-neighbors; count > 0 on an unvisited vertex is the next frontier
    csr = torch.sparse_csr_tensor(
        torch.from_numpy(indptr.astype(np.int32)).cuda(),
        torch.from_numpy(indices.astype(np.int32)).cuda(),
        torch.ones(indices.size, device="cuda"), size=(n, n),
        check_invariants=False)
    hits = csr @ f
    check(torch.equal((hits > 0).float() * (1.0 - v), y_k),
          f"{kind}: cuSPARSE frontier count agrees")
    library_ms = timed_ms(lambda: csr @ f)
    del csr, hits
    log_flat_walk("bfs", K, lambda: K.ich_bfs_step(*seq_args(f, v)), T,
                  s.rows_per_tile, s.width, rowid_seq, sm_count, graph=kind)
    log_sharded_walk("bfs", K, op, op.mask, lambda: K.ich_bfs_step_sharded(
        *args, slot_cost=op.slot_cost), graph=kind)

    # ---- bounds: bytes each input is read once / output written once ----
    real = int((s.item_id >= 0).sum())        # slots the kernels read
    W = s.width
    p, S_B = op.shards.block_perm.shape
    common = real * W * 8 + 3 * n * 4         # mask+cols; f, visited, out
    bytes_ = {"ich_bfs_step_sharded": common + real * 4
              + op.rowid.numel() * 4 + p * S_B * 4 * 2,
              "ich_bfs_step": common + T * s.rows_per_tile * 4}
    flops = 2 * real * W                      # a multiply and a max a lane
    SHAPES[f"bfs_{kind}"] = {
        "workload": "bfs", "inputs": (indptr, indices),
        "sched": {"p": sm_count}, "schedule": s, "op": op,
        "csr": (indptr, indices, np.ones(indices.size, np.float32)),
        "level": level}
    return {name: kernel_entry(name, launches=launches[name], err=err[name],
                               ms=ms[name], plain_ms=plain_ms[name],
                               library_ms=library_ms, bytes_=bytes_[name],
                               flops=flops)
            for name in ms}


def phase_bfs(sm_count):
    """Both graphs of the paper's BF workload at 1,000,000 vertices. The
    `kernels` line takes the uniform graph's times and both graphs'
    launches; the scale-free graph's times are logged beside them."""
    runs = {kind: _bfs_run(kind, sm_count) for kind in GRAPHS}
    for kind, entries in runs.items():
        log(phase="bfs_kernels", graph=kind, kernels=list(entries.values()))
    kernels = []
    for name, entry in runs[GRAPHS[0]].items():
        entry = dict(entry)
        entry["launches"] = sum(r[name]["launches"] for r in runs.values())
        check(entry["launches"] > 0, f"{name} launched on the main path")
        kernels.append(entry)
    return kernels


def _near_tie_mismatches(points, centroids, ids):
    """Points whose id differs from the float64 host argmin, and whether
    every one of them is a near tie (float64 distances of the two
    centroids within TIE_RTOL)."""
    pts = points.cpu().numpy().astype(np.float64)
    cent = centroids.cpu().numpy().astype(np.float64)
    d2 = np.stack([((pts - c) ** 2).sum(axis=1) for c in cent], axis=1)
    host = d2.argmin(axis=1)
    ours = ids.cpu().numpy()
    diff = np.nonzero(ours != host)[0]
    a, b = d2[diff, ours[diff]], d2[diff, host[diff]]
    return diff.size, bool(np.all(np.abs(a - b) <= TIE_RTOL * b))


def phase_kmeans(sm_count):
    """K-Means assignment at the kdd_cup shape: the round-0 schedule's run,
    its sequential cross-check, observe/refine and the refined run, then
    rounds 1-2 as fresh schedules, all giving the same ids; the simulator
    cross-check of the cost stream; the threaded executor over the
    schedule's work units, observed and refined, and the kernel on that
    generation; the kernels against their plain versions, their launch
    shapes and timings."""
    import torch
    from repro_torch.core.workloads import kmeans_rounds
    from repro_torch.kernels.ich_kmeans import ich_kmeans as K
    from repro_torch.sched import KMeansOp, LoopScheduler

    t0 = time.perf_counter()
    rounds, _ = kmeans_rounds(N_POINTS, rounds=KMEANS_ROUNDS, seed=SEED)
    rng = np.random.default_rng(SEED)
    pts = torch.from_numpy(rng.standard_normal(
        (N_POINTS, N_FEATURES)).astype(np.float32)).cuda()
    cent = torch.from_numpy(rng.standard_normal(
        (N_CLUSTERS, N_FEATURES)).astype(np.float32)).cuda()
    t_setup = time.perf_counter() - t0
    scheduler = LoopScheduler(p=sm_count)
    t0 = time.perf_counter()
    op = scheduler.build("kmeans", rounds[0])
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    s = op.schedule
    rowid_seq = torch.from_numpy(s.item_id).cuda()

    # ---- the main path, counted ----
    K.reset_launches()
    t0 = time.perf_counter()
    ids = op(pts, cent)
    ids_seq = K.ich_kmeans_assign(pts, cent, rowid_seq)
    s2 = op.observe().refine()
    ids2 = KMeansOp(s2, rounds[0])(pts, cent)
    later = [scheduler.build("kmeans", r)(pts, cent) for r in rounds[1:]]
    torch.cuda.synchronize()
    t_path = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    n_ties, ties_ok = _near_tie_mismatches(pts, cent, ids)
    log(phase="kmeans_main_path", points=N_POINTS, features=N_FEATURES,
        clusters=N_CLUSTERS, width=s.width, tiles=s.n_tiles,
        live_slots=int((s.item_id >= 0).sum()), steps=op.shards.n_steps,
        seconds=t_path, setup_s=t_setup, build_s=t_build,
        launches=launches, generation=s2.generation,
        near_tie_mismatches=n_ties)
    for name in launches:
        check(launches[name] > 0, f"{name} launched on the main path")
    check(torch.equal(ids, ids_seq), "K-Means sharded == sequential ids")
    check(ties_ok, "K-Means ids == float64 argmin outside near ties")
    emitted = op.last_costs.cpu().numpy().astype(np.float64).sum(axis=1)
    expect = op.shards.worker_cost(s.tile_cost())
    check(bool(np.allclose(emitted, expect, rtol=COST_RTOL, atol=0)),
          "K-Means per-worker cost sums within 1e-6 of worker_cost")
    check(s2.generation == 1 and torch.equal(ids2, ids),
          "K-Means refined generation gives the same ids")
    check(all(torch.equal(x, ids) for x in later),
          "K-Means rounds 1-2 give the same ids")
    del ids2, later
    replay_cross_check("kmeans", op)

    # ---- the threaded executor over the schedule's work units ----
    t0 = time.perf_counter()
    stats = s.parallel_for_units(lambda u: None, p=EXEC_THREADS,
                                 record_chunks=True)
    t_exec = time.perf_counter() - t0
    ranges = sorted((b, e) for b, e, _, _ in stats.chunk_log)
    check(np.array_equal(np.asarray(ranges), s.unit_ranges()),
          "executor dispatched every tile chunk once")
    t0 = time.perf_counter()
    s3 = s.observe(stats).refine()
    t_refine = time.perf_counter() - t0
    ids3 = KMeansOp(s3, rounds[0])(pts, cent)
    torch.cuda.synchronize()
    log(phase="kmeans_executor", threads=EXEC_THREADS,
        units=int(s.sizes.sum()), chunks=len(stats.chunk_log),
        exec_s=t_exec, observe_refine_s=t_refine, generation=s3.generation,
        tiles=s3.n_tiles)
    check(s3.generation == 1 and torch.equal(ids3, ids),
          "K-Means generation refined from the executor gives the same ids")
    del ids3

    # ---- kernels against their plain versions at the main path's shapes ----
    args = (pts, cent, op.rowid, op.p, op.superstep)
    i_k, c_k = K.ich_kmeans_assign_sharded(*args, slot_cost=op.slot_cost)
    i_p, c_p = K.ich_kmeans_assign_sharded_plain(*args,
                                                 slot_cost=op.slot_cost)
    check(torch.equal(i_k, i_p) and torch.equal(c_k, c_p),
          "full-size K-Means sharded kernel == plain")
    i_sp = K.ich_kmeans_assign_plain(pts, cent, rowid_seq)
    check(torch.equal(ids_seq, i_sp), "full-size K-Means sequential == plain")
    err = {"ich_kmeans_assign_sharded": float((i_k - i_p).abs().max()),
           "ich_kmeans_assign": float((ids_seq - i_sp).abs().max())}
    del i_k, c_k, i_p, c_p, i_sp
    ms = {"ich_kmeans_assign_sharded": timed_ms(
              lambda: K.ich_kmeans_assign_sharded(
                  *args, slot_cost=op.slot_cost)),
          "ich_kmeans_assign": timed_ms(
              lambda: K.ich_kmeans_assign(pts, cent, rowid_seq))}
    plain_ms = {
        "ich_kmeans_assign_sharded": timed_ms(
            lambda: K.ich_kmeans_assign_sharded_plain(
                *args, slot_cost=op.slot_cost)),
        "ich_kmeans_assign": timed_ms(
            lambda: K.ich_kmeans_assign_plain(pts, cent, rowid_seq))}
    # yardstick: cdist's distances take another formula, so its ids may
    # differ on near ties; the count is logged, not held
    lib_ids = torch.cdist(pts, cent).argmin(dim=1)
    log(phase="kmeans_library", cdist_argmin_mismatches=int(
        (lib_ids != ids).sum()))
    library_ms = timed_ms(lambda: torch.cdist(pts, cent).argmin(dim=1))
    shape = K.assign_launch_shape(rowid_seq.numel(), N_FEATURES, N_CLUSTERS)
    check(shape["ctas"] >= min(sm_count, -(-rowid_seq.numel() // max(
        shape["chunk_slots"], 1))), "K-Means flat walk's grid spans the card")
    log(phase="kmeans_flat_grid", sm_count=sm_count,
        slots=rowid_seq.numel(), **shape)
    log_split("kmeans_flat", lambda: K.ich_kmeans_assign(pts, cent, rowid_seq),
              "ich_kmeans_assign_kernel")
    S_B = op.shards.n_steps
    shape = K.sharded_launch_shape(op.p, S_B, op.superstep, s.rows_per_tile,
                                   N_FEATURES, N_CLUSTERS)
    n_chunks = -(-op.p * S_B // shape["chunk_steps"])
    check(shape["chunk_slots"] > 0
          and shape["ctas"] >= min(sm_count, n_chunks),
          "K-Means sharded walk's grid spans the card")
    log(phase="kmeans_sharded_grid", sm_count=sm_count, p=op.p, steps=S_B,
        superstep=op.superstep, rows_per_tile=s.rows_per_tile,
        chunks=n_chunks, **shape)
    log_split("kmeans_sharded", lambda: K.ich_kmeans_assign_sharded(
        *args, slot_cost=op.slot_cost), "ich_kmeans_assign_sharded_kernel")

    # ---- bounds: bytes each input is read once / output written once ----
    live = int((s.item_id >= 0).sum())
    p, S_B = op.shards.block_perm.shape
    common = (N_POINTS * N_FEATURES + N_CLUSTERS * N_FEATURES
              + N_POINTS) * 4                  # points, centroids, ids
    bytes_ = {"ich_kmeans_assign_sharded": common + op.rowid.numel() * 8
              + p * S_B * 4,                   # rowid+slot_cost, costs
              "ich_kmeans_assign": common + rowid_seq.numel() * 4}
    flops = 3 * live * N_CLUSTERS * N_FEATURES   # sub, mul, add
    SHAPES["kmeans"] = {
        "workload": "kmeans", "inputs": (rounds[0],),
        "sched": {"p": sm_count}, "schedule": s, "op": op, "csr": None,
        "pts": pts, "cent": cent}
    return [kernel_entry(name, launches=launches[name], err=err[name],
                         ms=ms[name], plain_ms=plain_ms[name],
                         library_ms=library_ms, bytes_=bytes_[name],
                         flops=flops)
            for name in ms]


def _moe_weights(E, D, F, T, seed):
    """Expert weights (scaled by fan-in) and activations drawn on the card
    from a seeded generator."""
    import torch
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    wi = torch.randn((E, D, F), generator=g, device="cuda") * D ** -0.5
    wg = torch.randn((E, D, F), generator=g, device="cuda") * D ** -0.5
    wo = torch.randn((E, F, D), generator=g, device="cuda") * F ** -0.5
    x = torch.randn((T, D), generator=g, device="cuda")
    return x, wi, wg, wo


def phase_small_moe():
    """The MoE kernel against its plain version at p in {1, 2, 4} x
    B in {1, 4, 8} on a narrow layer whose experts split over several slot
    rows (W = 64) and whose F is no multiple of the kernel's tiles: y
    within MOE_TOL, cost streams exactly, one y bit for bit across every
    lowering (p = 1, B = 1 is the sequential walk); a plan that admits no
    token launches nothing."""
    import torch
    from repro_torch.core.workloads import moe_router
    from repro_torch.kernels.ich_moe import ich_moe as K
    from repro_torch.sched import LoopScheduler, plan_dispatch
    T, E, D, F = 2000, 16, 72, 200
    e_topk, w = moe_router(T, E, 4, seed=SEED + 3, skew=1.2)
    plan = plan_dispatch(e_topk, w, cap_scale=np.ones(E))
    x, wi, wg, wo = _moe_weights(E, D, F, T, SEED + 3)
    first, worst = None, 0.0
    for p in (1, 2, 4):
        for B in (1, 4, 8):
            op = LoopScheduler(p=p, superstep=B, rows_per_tile=2,
                               cache_size=0).build("moe-dispatch", plan,
                                                   width=64)
            args = (op.vals, op.cols, op.rowid, op.blkid, x, wi, wg, wo, p,
                    B, op.slots)
            y, c, ec = K.ich_moe_sharded(*args, slot_cost=op.slot_cost)
            y_p, c_p, ec_p = K.ich_moe_sharded_plain(
                *args, slot_cost=op.slot_cost)
            torch.cuda.synchronize()
            check(torch.allclose(y, y_p, rtol=MOE_TOL, atol=MOE_TOL),
                  f"MoE kernel == plain at p={p} B={B}")
            check(torch.equal(c, c_p) and torch.equal(ec, ec_p),
                  f"MoE cost streams == plain at p={p} B={B}")
            check(np.array_equal(ec.cpu().numpy().sum(axis=0),
                                 plan.counts.astype(np.float32)),
                  f"MoE expert costs sum to the plan at p={p} B={B}")
            first = y if first is None else first
            check(torch.equal(y, first),
                  f"MoE sharded == sequential bit for bit at p={p} B={B}")
            worst = max(worst, float((y - y_p).abs().max()))
    before = dict(K.LAUNCHES)
    empty = plan_dispatch(np.zeros((0, 2), np.int64),
                          np.zeros((0, 2), np.float32))
    op0 = LoopScheduler(p=4).build("moe-dispatch", empty)
    E0 = empty.n_experts
    y0 = op0(torch.zeros((0, 8), device="cuda"),
             torch.zeros((E0, 8, 16), device="cuda"),
             torch.zeros((E0, 8, 16), device="cuda"),
             torch.zeros((E0, 16, 8), device="cuda"))
    check(op0.n_tiles > 0 and tuple(y0.shape) == (0, 8)
          and K.LAUNCHES == before and not op0.last_costs.any()
          and not op0.expert_load().any(),
          "MoE plan with no token returns an empty y unlaunched")
    log(phase="small_moe", tokens=T, experts=E, d=D, f=F,
        kept=int(plan.counts.sum()), max_abs_err=worst, ok=True)


def torch_index(a):
    """An int64 index tensor on the card."""
    import torch
    return torch.from_numpy(np.asarray(a, np.int64)).cuda()


def _moe_host_reference(plan, x, wi, wg, wo, sample):
    """float64 y of the `sample` tokens on the host, and per element the
    sum over each token's entries of |w| * sum_f |a_f * wo[f, d]| (the
    terms of the last product), the scale an error is measured against."""
    keep = plan.keep & np.isin(plan.token, sample)
    row = {int(t): i for i, t in enumerate(sample)}
    xs = x[torch_index(sample)].cpu().numpy().astype(np.float64)
    y64 = np.zeros((sample.size, x.shape[1]))
    absum = np.zeros_like(y64)
    for e in np.unique(plan.expert[keep]):
        sel = keep & (plan.expert == e)
        rows = np.array([row[int(t)] for t in plan.token[sel]])
        wt = plan.weight[sel].astype(np.float64)[:, None]
        a_in = xs[rows]
        h = a_in @ wi[e].cpu().numpy().astype(np.float64)
        g = a_in @ wg[e].cpu().numpy().astype(np.float64)
        a = g / (1.0 + np.exp(-g)) * h
        w_o = wo[e].cpu().numpy().astype(np.float64)
        np.add.at(y64, rows, wt * (a @ w_o))
        np.add.at(absum, rows, wt * (np.abs(a) @ np.abs(w_o)))
    return y64, absum


def capacity_buffer_moe(x, wi, wg, wo, plan):
    """The dense capacity-buffer form of the reference's `moe_local`: kept
    entries gathered into an (E, C, D) buffer (C = the plan's largest
    capacity), three float32 `torch.bmm` with silu, weighted scatter-add
    back to the tokens. Several PyTorch calls; the yardstick, never used
    by the port."""
    import torch
    E, D = wi.shape[0], x.shape[1]
    C = int(plan.cap.max())
    k = plan.keep
    at = torch_index(plan.expert[k].astype(np.int64) * C + plan.pos[k])
    tok = torch_index(plan.token[k])
    wt = torch.from_numpy(plan.weight[k]).cuda()

    def run():
        buf = torch.zeros((E * C, D), device="cuda")
        buf[at] = x[tok]
        buf = buf.view(E, C, D)
        a = torch.nn.functional.silu(torch.bmm(buf, wg)) * torch.bmm(buf, wi)
        yb = torch.bmm(a, wo).view(E * C, D)
        return torch.zeros_like(x).index_add_(0, tok, yb[at] * wt[:, None])
    return run, C


def device_ms_by_kernel(fn) -> dict:
    """Device milliseconds per kernel name over one call of fn (after one
    warm-up call), from torch.profiler's CUDA trace, taken up to three
    times while a trace holds no device time (one has come back empty);
    empty if every trace did."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            # the trace can miss the first kernel it sees: let that be a
            # short spin (left out below), not the first kernel of fn
            torch.cuda._sleep(1000)
            fn()
            torch.cuda.synchronize()
        by_name = {ev.key[:80]: ev.device_time_total / 1e3
                   for ev in prof.key_averages()
                   if ev.device_time_total > 0
                   and "spin_kernel" not in ev.key}
        if by_name:
            return by_name
    return {}


def log_flat_walk(label, K, fn, T, R, W, rowid, sm_count, **extra) -> None:
    """Three lines on a flat walk: its grid (the CTAs of each phase on this
    card), the longest run of one row in slots (one thread folds it), and
    the device milliseconds of each phase over one call of fn beside the
    host's microseconds to enqueue one call (the mean of 20, unsynced)."""
    from repro_torch.core.segmented import longest_run
    shape = K.flat_launch_shape(T, R, W)
    check(shape["ctas_phase_a"] >= min(sm_count, -(-T * R // shape[
        "chunk_slots"])), f"{label}: the phase-A grid spans the card")
    log(phase=f"{label}_flat_grid", sm_count=sm_count, tiles=T,
        rows_per_tile=R, width=W, **shape, **extra)
    log(phase=f"{label}_flat_longest_run", slots=longest_run(rowid),
        **extra)
    by_name = device_ms_by_kernel(fn)
    a = sum(v for k, v in by_name.items() if "flat_slot_partials" in k)
    b = sum(v for k, v in by_name.items() if "flat_fold_rows" in k)
    log(phase=f"{label}_flat_split", phase_a_ms=a, phase_b_ms=b,
        other_ms=sum(by_name.values()) - a - b,
        host_enqueue_us=enqueue_us(fn), device_ms=by_name, **extra)


def enqueue_us(fn) -> float:
    """The host's microseconds to enqueue one call of fn: the mean of 20
    calls, unsynced, from an idle card."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        fn()
    host_us = (time.perf_counter() - t0) / 20 * 1e6
    torch.cuda.synchronize()
    return host_us


def log_split(label, fn, kernel, **extra) -> None:
    """The device milliseconds of one call of fn, the kernel whose name
    holds `kernel` apart from everything else (output fills), beside the
    host's microseconds to enqueue one call."""
    by_name = device_ms_by_kernel(fn)
    k = sum(v for name, v in by_name.items() if kernel in name)
    log(phase=f"{label}_split", kernel_ms=k,
        other_ms=sum(by_name.values()) - k, host_enqueue_us=enqueue_us(fn),
        device_ms=by_name, **extra)


def log_sharded_walk(label, K, op, payload, fn, **extra) -> None:
    """A sharded walk's launch (one CTA per worker, a ring of >= 3 stages:
    checked) over its (T_pad, R, W) payload, the worker balance of this
    schedule (live slots of the busiest worker over the mean: the LPT
    makespan the one-CTA-per-worker rule keeps), and its device time and
    host enqueue."""
    p, B = op.p, op.superstep
    S_B = op.blkid.numel() // p
    T_pad, R, W = payload.shape
    shape = K.sharded_launch_shape(p, S_B, B, R, W)
    check(shape["ctas"] == p and shape["stages"] >= 3,
          f"{label} sharded walk: one CTA per worker, a ring of >= 3 stages")
    live = (op.rowid >= 0).view(p, -1).sum(dim=1).double()
    log(phase=f"{label}_sharded_grid", p=p, steps=S_B, superstep=B,
        rows_per_tile=R, width=W, **shape,
        live_slots_max=int(live.max()), live_slots_mean=float(live.mean()),
        balance=float(live.max() / live.mean()), **extra)
    log_split(f"{label}_sharded", fn, "sharded_walk", **extra)


def replay_cross_check(label, op, **extra) -> None:
    """The simulator's twin of a sharded kernel run: `replay_sharded` under
    zero overhead and jitter dispatches each tile on the worker the op's
    shard layout gave it. Its per-worker busy time must equal the
    per-worker sums of the cost stream the kernel emitted on its last call
    (within COST_RTOL), and its makespan their max."""
    from repro_torch.core.simulator import SimParams
    emitted = op.last_costs.double().sum(dim=1).cpu().numpy()
    t0 = time.perf_counter()
    rep = op.schedule.replay_sharded(
        p=op.p, superstep=op.superstep,
        params=SimParams(dispatch_overhead=0.0, local_dispatch_overhead=0.0,
                         speed_jitter=0.0), record_chunks=False)
    seconds = time.perf_counter() - t0
    diff = np.abs(rep.worker_busy - emitted)
    log(phase=f"{label}_replay_cross_check", workers=op.p, tiles=op.n_tiles,
        chunks=rep.chunks, makespan=rep.makespan,
        emitted_max=float(emitted.max()),
        max_rel_diff=float(np.max(diff / np.maximum(emitted, 1e-300))),
        seconds=seconds, **extra)
    check(rep.chunks == op.n_tiles and bool(np.all(
        diff <= COST_RTOL * emitted)),
        f"{label}: replay_sharded per-worker busy == emitted per-worker sums")
    check(abs(rep.makespan - float(emitted.max()))
          <= COST_RTOL * float(emitted.max()),
          f"{label}: replay_sharded makespan == max emitted per-worker sum")


def phase_moe(sm_count):
    """One OLMoE-1B-7B MoE layer over 4,096 tokens routed by
    `moe_router(seed=0)`, p = SM count, R = 2, B = 8: the counted main path
    (run, then three closed-loop rounds of refine_cap_scale -> plan ->
    rebuilt op -> run), the checks, the kernel against its plain version
    and the timings."""
    import torch
    from repro_torch.core.workloads import moe_router
    from repro_torch.kernels.ich_moe import ich_moe as K
    from repro_torch.sched import (LoopScheduler, plan_dispatch,
                                   refine_cap_scale)
    torch.backends.cuda.matmul.allow_tf32 = False  # plain + library: f32
    E, Kt, D, F, T = MOE_EXPERTS, MOE_TOP_K, MOE_D, MOE_F, MOE_TOKENS
    t0 = time.perf_counter()
    e_topk, w = moe_router(T, E, Kt, seed=SEED)
    plan = plan_dispatch(e_topk, w, cap_scale=np.ones(E))
    kept = int(plan.counts.sum())
    x, wi, wg, wo = _moe_weights(E, D, F, T, SEED)
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    log(phase="moe_plan", tokens=T, experts=E, top_k=Kt, d_model=D,
        expert_ff=F, kept=kept, stolen=plan.stolen,
        dropped=plan.dropped, load_min=int(plan.counts.min()),
        load_max=int(plan.counts.max()), cap_max=int(plan.cap.max()),
        weight_bytes=3 * E * D * F * 4, x_bytes=T * D * 4, setup_s=t_setup)
    scheduler = LoopScheduler(p=sm_count, rows_per_tile=MOE_ROWS_PER_TILE)
    t0 = time.perf_counter()
    op = scheduler.build("moe-dispatch", plan)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    s = op.schedule
    n_slots = op.slots.tok_slot.numel()
    log(phase="moe_lowering", tiles=op.n_tiles, width=s.width,
        rows_per_tile=s.rows_per_tile, p=op.p, superstep=op.superstep,
        blocks=int((op.shards.block_perm >= 0).sum()),
        steps=op.shards.n_steps, live_slots=n_slots,
        slot_buffer_bytes=n_slots * D * 4, scratch_bytes=n_slots * F * 4,
        build_s=t_build)

    # ---- the main path, counted: run -> three closed-loop rounds ----
    K.reset_launches()
    t0 = time.perf_counter()
    y = op(x, wi, wg, wo)
    load = op.expert_load()
    rounds, s_r, op_r, load_r = [], s, op, load
    for r in range(1, MOE_ROUNDS + 1):
        s_r, cap_scale = refine_cap_scale(s_r, load_r)
        plan_r = plan_dispatch(e_topk, w, cap_scale=cap_scale)
        op_r = scheduler.build("moe-dispatch", plan_r)
        y_r = op_r(x, wi, wg, wo)
        load_r = op_r.expert_load()
        check(np.array_equal(load_r, plan_r.counts.astype(np.float64)),
              f"MoE round {r}: expert_load() == plan.counts")
        check(bool(torch.isfinite(y_r).all()), f"MoE round {r}: y finite")
        rounds.append({"round": r, "generation": s_r.generation,
                       "kept": int(plan_r.counts.sum()),
                       "stolen": plan_r.stolen, "dropped": plan_r.dropped,
                       "cap_max": int(plan_r.cap.max()),
                       "tiles": op_r.n_tiles,
                       "blocks": int((op_r.shards.block_perm >= 0).sum())})
    torch.cuda.synchronize()
    t_path = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    log(phase="moe_main_path", seconds=t_path, launches=launches,
        rounds=rounds)
    check(launches["ich_moe_sharded"] > 0, "ich_moe_sharded launched")
    check(all(rd["generation"] == rd["round"] for rd in rounds),
          "MoE refine generations count the rounds")
    SHAPES["moe"] = {
        "workload": "moe-dispatch", "inputs": (plan,),
        "sched": {"p": sm_count, "rows_per_tile": MOE_ROWS_PER_TILE},
        "schedule": s, "csr": None}
    del op_r, y_r

    # ---- checks of round 0 ----
    check(np.array_equal(load, plan.counts.astype(np.float64)),
          "MoE expert_load() == plan.counts")
    emitted = op.last_costs.cpu().numpy().sum(axis=1)
    check(np.array_equal(emitted, op.shards.worker_cost(
        s.tile_cost()).astype(np.float32)),
        "MoE per-worker step costs == worker_cost(tile_cost())")
    replay_cross_check("moe", op)
    check(tuple(y.shape) == (T, D) and bool(torch.isfinite(y).all()),
          "MoE y finite, (n_tokens, D)")
    sample = np.sort(np.random.default_rng(SEED).choice(T, MOE_SAMPLE,
                                                        replace=False))
    t0 = time.perf_counter()
    y64, absum = _moe_host_reference(plan, x, wi, wg, wo, sample)
    err = np.abs(y[torch_index(sample)].cpu().numpy() - y64)
    check(bool(np.all(err <= HOST_RTOL * absum)),
          f"MoE y within {HOST_RTOL} of float64 relative to each token's "
          f"sum |terms| (worst excess {float(np.max(err - HOST_RTOL * absum))})")
    log(phase="moe_host_check", tokens=MOE_SAMPLE,
        max_rel=float(np.max(err / np.maximum(absum, 1e-30))),
        seconds=time.perf_counter() - t0)

    # ---- the kernel against its plain version at the main path's shapes ----
    args = (op.vals, op.cols, op.rowid, op.blkid, x, wi, wg, wo, op.p,
            op.superstep, op.slots)
    y_k, c_k, e_k = K.ich_moe_sharded(*args, slot_cost=op.slot_cost)
    y_p, c_p, e_p = K.ich_moe_sharded_plain(*args, slot_cost=op.slot_cost)
    check(torch.allclose(y_k, y_p, rtol=MOE_TOL, atol=MOE_TOL),
          "full-width MoE kernel == plain")
    check(torch.equal(c_k, c_p) and torch.equal(e_k, e_p),
          "full-width MoE cost streams == plain")
    check(torch.equal(y_k, y), "full-width MoE kernel is deterministic")
    err_k = float((y_k - y_p).abs().max())
    del y_k, c_k, e_k, y_p, c_p, e_p
    library, C = capacity_buffer_moe(x, wi, wg, wo, plan)
    y_lib = library()
    torch.cuda.synchronize()
    lib_err = float((y_lib - y).abs().max())
    check(torch.allclose(y_lib, y, rtol=MOE_TOL, atol=MOE_TOL),
          "capacity-buffer bmm y agrees")
    del y_lib
    ms = timed_ms(lambda: K.ich_moe_sharded(*args, slot_cost=op.slot_cost))
    plain_ms = timed_ms(lambda: K.ich_moe_sharded_plain(
        *args, slot_cost=op.slot_cost))
    library_ms = timed_ms(library)
    log(phase="moe_library", capacity=C, buffer_entries=E * C,
        kept=kept, max_abs_diff=lib_err)
    breakdown = device_ms_by_kernel(
        lambda: K.ich_moe_sharded(*args, slot_cost=op.slot_cost))
    # achieved rate of each product: its float32 operations (up: two
    # products, 4*D*F a kept entry; down: 2*D*F) over its device time; the
    # tensor cores run three TF32 products for each
    rate = {}
    for label, key, per_entry in (("up", "moe_product<true", 4),
                                  ("down", "moe_product<false", 2)):
        k_ms = sum(v for name, v in breakdown.items() if key in name)
        rate[f"{label}_ms"] = k_ms
        rate[f"{label}_tflops"] = (per_entry * D * F * kept / (k_ms * 1e-3)
                                   / 1e12 if k_ms > 0 else None)
    log(phase="moe_breakdown", event_ms=ms, device_ms=breakdown,
        device_total_ms=sum(breakdown.values()), **rate)

    # ---- bound: each input read once, each output written once ----
    inputs = [op.vals, op.cols, op.rowid, op.blkid, op.slot_cost, x, wi, wg,
              wo, *op.slots]
    bytes_ = sum(t.numel() * t.element_size() for t in inputs) \
        + (T * D + op.p * (op.shards.n_steps + E)) * 4   # y, both streams
    flops = 6 * D * F * kept                              # three products
    # each float32 product runs as three TF32 products on the tensor cores
    return [kernel_entry("ich_moe_sharded",
                         launches=launches["ich_moe_sharded"], err=err_k,
                         ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                         bytes_=bytes_, flops=flops, peak=TF32_FLOPS / 3)]


def phase_small_lm():
    """Flash attention and the SSD scan against their plain versions on
    small shapes: flash over causal and not, GQA rep in {1, 2, 4}, ragged
    S, window in {0, 32}, float32 and bfloat16, dh in {64, 128}, then off
    the kernel's tile edges (Sq, Skv in {1, 15, 17, 200}, Sq != Skv, dh in
    {64, 96, 128}); the scan over several (S, H, N, Pd, chunk), ragged S,
    chunks of 1 and 7 steps and 11 chunks among them, with q/k
    materialised and shared across heads (head stride 0), in float32 and
    bfloat16, and chunk = 1024 against the float64 recurrence."""
    import itertools
    import torch
    from repro_torch.kernels.flash_attention import flash_attention as KF
    from repro_torch.kernels.mamba_scan import mamba_scan as KS
    from repro_torch.kernels.mamba_scan.ref import ssd_sequential_ref
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + 4)
    worst = {"float32": 0.0, "bfloat16": 0.0}
    cases = 0

    def flash_case(Sq, Skv, rep, dh, causal, window, dtype):
        q = torch.randn((2, Sq, 2 * rep, dh), generator=g, device="cuda")
        k = torch.randn((2, Skv, 2, dh), generator=g, device="cuda")
        v = torch.randn((2, Skv, 2, dh), generator=g, device="cuda")
        q, k, v = (t.to(getattr(torch, dtype)) for t in (q, k, v))
        out = KF.flash_attention(q, k, v, causal=causal, window=window)
        plain = KF.flash_attention_plain(q, k, v, causal=causal,
                                         window=window)
        torch.cuda.synchronize()
        tol = FLASH_TOL[dtype]
        check(torch.allclose(out.float(), plain.float(), rtol=tol, atol=tol),
              f"flash == plain at Sq={Sq} Skv={Skv} rep={rep} dh={dh} "
              f"causal={causal} window={window} {dtype}")
        worst[dtype] = max(worst[dtype], float(
            (out.float() - plain.float()).abs().max()))

    for causal in (True, False):
        for rep in (1, 2, 4):
            for S in (128, 200):
                for window in (0, 32):
                    for dtype in ("float32", "bfloat16"):
                        flash_case(S, S, rep, 128 if rep == 4 else 64,
                                   causal, window, dtype)
                        cases += 1
    edges = (1, 15, 17, 200)
    for Sq, Skv in itertools.product(edges, edges):
        for dh in (64, 96, 128):
            for causal in (True, False):
                for dtype in ("float32", "bfloat16"):
                    flash_case(Sq, Skv, 2, dh, causal, 0, dtype)
                    cases += 1
    scan_worst = {"float32": 0.0, "bfloat16": 0.0}
    scan_cases = 0
    for S, H, N, Pd, chunk in ((128, 2, 16, 32, 64), (300, 4, 64, 64, 256),
                               (129, 2, 8, 16, 64), (100, 2, 64, 128, 32),
                               (520, 8, 64, 64, 256), (37, 3, 64, 64, 256),
                               (50, 2, 64, 64, 1), (60, 2, 64, 64, 7),
                               (700, 2, 64, 64, 64), (300, 2, 13, 30, 100)):
        for shared in (False, True):
            q = torch.randn((2, S, 1 if shared else H, N), generator=g,
                            device="cuda")
            k = torch.randn((2, S, 1 if shared else H, N), generator=g,
                            device="cuda")
            q, k = q.expand(2, S, H, N), k.expand(2, S, H, N)
            v = torch.randn((2, S, H, Pd), generator=g, device="cuda")
            la = -torch.rand((2, S, H), generator=g, device="cuda") * 0.3
            for dtype, tol in (("float32", SCAN_TOL),
                               ("bfloat16", SCAN_TOL_BF16)):
                qd, kd, vd = (t.to(getattr(torch, dtype)) for t in (q, k, v))
                y, st = KS.mamba_scan(qd, kd, vd, la, chunk=chunk)
                y_p, st_p = KS.mamba_scan_plain(qd, kd, vd, la, chunk=chunk)
                torch.cuda.synchronize()
                check(torch.allclose(y.float(), y_p.float(), rtol=tol,
                                     atol=tol)
                      and torch.allclose(st, st_p, rtol=tol, atol=tol),
                      f"scan == plain at S={S} H={H} N={N} Pd={Pd} "
                      f"chunk={chunk} shared={shared} {dtype}")
                scan_worst[dtype] = max(
                    scan_worst[dtype], float((y.float() - y_p.float())
                                             .abs().max()),
                    float((st - st_p).abs().max()))
                scan_cases += 1
    # chunk = 1024: inside a chunk that long l runs to ~-150 and
    # exp(l_i - l_j) subtracts two large cumulative sums whose rounding
    # depends on their order (torch.cumsum against the kernel's scan), so
    # both versions are held as the serving shape is: within SCAN_TOL of
    # each element's sum of |terms|, against each other and against float64
    long_chunk = {}
    for S, shared in ((1500, True), (1100, False)):
        H, N, Pd = 2, 64, 64
        q = torch.randn((2, S, 1 if shared else H, N), generator=g,
                        device="cuda").expand(2, S, H, N)
        k = torch.randn((2, S, 1 if shared else H, N), generator=g,
                        device="cuda").expand(2, S, H, N)
        v = torch.randn((2, S, H, Pd), generator=g, device="cuda")
        la = -torch.rand((2, S, H), generator=g, device="cuda") * 0.3
        y, st = KS.mamba_scan(q, k, v, la, chunk=1024)
        y_p, st_p = KS.mamba_scan_plain(q, k, v, la, chunk=1024)
        y_a, st_a = KS.mamba_scan_plain(q.abs(), k.abs(), v.abs(), la,
                                        chunk=1024)
        y_64, st_64 = ssd_sequential_ref(q, k, v, la)
        rel = {"kernel_vs_plain": max(_rel_terms(y, y_p, y_a),
                                      _rel_terms(st, st_p, st_a)),
               "kernel_vs_f64": max(_rel_terms(y, y_64, y_a),
                                    _rel_terms(st, st_64, st_a)),
               "plain_vs_f64": max(_rel_terms(y_p, y_64, y_a),
                                   _rel_terms(st_p, st_64, st_a))}
        long_chunk[f"S{S}_shared{shared}"] = rel
        check(rel["kernel_vs_plain"] <= SCAN_TOL
              and rel["kernel_vs_f64"] <= SCAN_TOL,
              f"scan at chunk 1024 (S={S}, shared={shared}) within "
              f"{SCAN_TOL} of each element's sum |terms|")
        scan_cases += 1
    log(phase="small_lm", flash_cases=cases, flash_max_abs_err=worst,
        scan_cases=scan_cases, scan_max_abs_err=scan_worst,
        scan_chunk_1024_max_rel_to_terms=long_chunk, ok=True)


def _rel_terms(a, b, terms) -> float:
    """The largest |a - b| over the sum of |terms| of the same element."""
    return float(((a.double() - b.double()).abs()
                  / (terms.double() + 1e-30)).max())


def _kernel_split(ms_by_name: dict) -> dict:
    """Device milliseconds of one traced call grouped: the two kernels of
    this slice, matrix products (cuBLAS/CUTLASS), everything else."""
    out = {"flash_attention": 0.0, "mamba_scan": 0.0, "matmul": 0.0,
           "other": 0.0}
    for name, ms in ms_by_name.items():
        low = name.lower()
        if "flash_fwd_kernel" in name:
            out["flash_attention"] += ms
        elif "ssd_scan_kernel" in name:
            out["mamba_scan"] += ms
        elif "gemm" in low or "cutlass" in low or "matmul" in low:
            out["matmul"] += ms
        else:
            out["other"] += ms
    return out


def _scan_work(B, S, H, N, Pd, chunk, *, shared_qk: bool):
    """Operations the scan's algebra needs on these shapes. Per chunk of
    length c (the last may be short) and c(c+1)/2 causal pairs: 2N for the
    q.k score of each pair, once per batch row when q and k are shared by
    all heads (Zamba2's C and B, a head stride of 0) and once per head
    otherwise; per head, 2Pd + 1 for each pair's decayed product with v,
    and 4 c N Pd for the inter-chunk term and the state update."""
    score = per_head = 0
    for t0 in range(0, S, chunk):
        c = min(chunk, S - t0)
        pairs = c * (c + 1) // 2
        score += pairs * 2 * N
        per_head += pairs * (2 * Pd + 1) + 4 * c * N * Pd
    return B * (score * (1 if shared_qk else H) + H * per_head)


def phase_zamba2():
    """Zamba2-1.2B at full width (38 layers, d_model 2048, random weights
    from a seeded generator on the card, float32): the counted main path
    `Engine.generate` on 4 prompts of 2,048 tokens with 32 new tokens;
    bars (a) the last chunk's logits == a one-shot prefill bit for bit,
    (b) decode at position S == a fresh prefill of S + 1 tokens within
    DECODE_TOL, (c) finite logits; then both kernels at the main path's
    shapes against their plain versions, timed beside their bounds and
    (flash) scaled_dot_product_attention."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels.flash_attention import flash_attention as KF
    from repro_torch.kernels.mamba_scan import mamba_scan as KS
    from repro_torch.kernels.mamba_scan.ref import ssd_sequential_ref
    from repro_torch.models import model as M
    from repro_torch.serve import Engine, EngineConfig
    torch.backends.cuda.matmul.allow_tf32 = False  # float32 end to end
    cfg = get_arch(LM_ARCH)
    B, S, n_new = LM_BATCH, LM_PROMPT, LM_NEW
    t0 = time.perf_counter()
    params = M.init_params(cfg, SEED, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    prompts = np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int64)
    log(phase="zamba2_setup", arch=cfg.name, layers=cfg.n_layers,
        d_model=cfg.d_model, attention_uses=cfg.block_pattern.count("A"),
        mamba_blocks=cfg.block_pattern.count("M"), params=n_params,
        weight_bytes=n_params * 4, batch=B, prompt=S, new_tokens=n_new,
        init_s=time.perf_counter() - t0)
    # first use of cuBLAS and of both kernel libraries, outside the count
    M.prefill(cfg, params, {"tokens": torch.from_numpy(
        prompts[:, :64]).cuda()})
    torch.cuda.synchronize()

    # ---- the main path, counted ----
    KF.reset_launches()
    KS.reset_launches()
    engine = Engine(cfg, params, EngineConfig(max_seq=LM_MAX_SEQ))
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    ids, stats = engine.generate(prompts, n_new=n_new)
    torch.cuda.synchronize()
    t_generate = time.perf_counter() - t0
    launches = {"flash_attention": KF.LAUNCHES["flash_attention"],
                "mamba_scan": KS.LAUNCHES["mamba_scan"]}
    chunks = stats["chunks"]
    t_prefill = sum(c["dt"] for c in chunks)
    reruns = engine.n_prefill_fallbacks
    log(phase="zamba2_main_path", chunk_log=chunks,
        n_prefill_fallbacks=reruns, launches=launches,
        generate_s=t_generate, time_to_first_token_s=t_prefill,
        decode_ms_per_token=(t_generate - t_prefill) / n_new * 1e3,
        generated_ids=ids.tolist(), peak_gb=torch.cuda.max_memory_allocated()
        / 1e9)
    check(reruns == len(chunks) > 0, "every prefill chunk counted")
    check(launches["flash_attention"] == cfg.block_pattern.count("A") * reruns
          and launches["mamba_scan"] == cfg.block_pattern.count("M") * reruns,
          "flash 6 and scan 32 launches per prefill rerun")
    check(ids.shape == (B, n_new) and bool(np.all((ids >= 0)
                                                  & (ids < cfg.vocab_size))),
          "generated ids in the vocabulary")

    # ---- bars ----
    toks = torch.from_numpy(prompts).cuda()
    last, _, _ = Engine(cfg, params, EngineConfig(
        max_seq=LM_MAX_SEQ)).prefill_chunked(prompts)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    one_shot, cache = M.prefill(cfg, params, {"tokens": toks})
    torch.cuda.synchronize()
    t_one_shot = time.perf_counter() - t0
    check(torch.equal(last, one_shot),
          "(a) last chunk's logits == one-shot prefill bit for bit")
    check(bool(torch.isfinite(one_shot).all()), "(c) prefill logits finite")
    first = torch.from_numpy(ids[:, :1].astype(np.int64)).cuda()
    d_logits, _ = M.decode_step(cfg, params, first, engine._pad_cache(cache),
                                S)
    fresh, _ = M.prefill(cfg, params, {"tokens": torch.cat([toks, first],
                                                           dim=1)})
    torch.cuda.synchronize()
    err = float((d_logits - fresh).abs().max())
    log(phase="zamba2_bars", one_shot_prefill_s=t_one_shot,
        decode_vs_prefill_max_abs=err,
        logits_max_abs=float(fresh.abs().max()),
        decode_argmax_is_second_id=bool(np.array_equal(
            d_logits.argmax(-1).cpu().numpy(), ids[:, 1])))
    check(bool(torch.isfinite(d_logits).all()), "(c) decode logits finite")
    check(torch.allclose(d_logits, fresh, rtol=DECODE_TOL, atol=DECODE_TOL),
          f"(b) decode at S == prefill of S + 1 within {DECODE_TOL}")
    split = _kernel_split(device_ms_by_kernel(
        lambda: M.prefill(cfg, params, {"tokens": toks})))
    total = sum(split.values())
    log(phase="zamba2_prefill_split", device_ms=split, device_total_ms=total,
        share={k_: v_ / total for k_, v_ in split.items()})
    # one decode step (position S, rewritten in place each call): the
    # card's busy time against the host's wall time
    dec_cache = engine._pad_cache(cache)

    def one_decode():
        M.decode_step(cfg, params, first, dec_cache, S)
    dec_split = _kernel_split(device_ms_by_kernel(one_decode))
    wall = []
    for _ in range(5):
        t0 = time.perf_counter()
        one_decode()
        torch.cuda.synchronize()
        wall.append(time.perf_counter() - t0)
    dec_device = sum(dec_split.values())
    dec_wall = float(np.median(wall)) * 1e3
    log(phase="zamba2_decode_split", device_ms=dec_split,
        device_total_ms=dec_device, wall_ms=dec_wall,
        idle_share=1.0 - dec_device / dec_wall)
    del cache, dec_cache, last, one_shot, d_logits, fresh, engine

    # ---- both kernels at the main path's shapes ----
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + 5)
    Hq, Hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.dh
    q = torch.randn((B, S, Hq, dh), generator=g, device="cuda")
    k = torch.randn((B, S, Hkv, dh), generator=g, device="cuda")
    v = torch.randn((B, S, Hkv, dh), generator=g, device="cuda")
    win = cfg.attn_window
    out = KF.flash_attention(q, k, v, causal=True, window=win)
    plain = KF.flash_attention_plain(q, k, v, causal=True, window=win)
    torch.cuda.synchronize()
    check(torch.allclose(out, plain, rtol=FLASH_TOL["float32"],
                         atol=FLASH_TOL["float32"]),
          "main-path-shape flash == plain")
    err_flash = float((out - plain).abs().max())
    del plain
    check(torch.equal(out, KF.flash_attention(q, k, v, causal=True,
                                              window=win)),
          "main-path-shape flash: two calls give the same bits")
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    gqa = Hq != Hkv

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=gqa)
    lib_out = sdpa().transpose(1, 2)
    log(phase="flash_library", sdpa_max_abs_diff=float(
        (lib_out - out).abs().max()))
    del lib_out
    flash_ms = timed_ms(lambda: KF.flash_attention(q, k, v, causal=True,
                                                   window=win))
    flash_plain_ms = timed_ms(lambda: KF.flash_attention_plain(
        q, k, v, causal=True, window=win))
    flash_lib_ms = timed_ms(sdpa)
    pairs = S * (S + 1) // 2                 # S <= window: causal pairs
    flash_flops = 4 * dh * pairs * B * Hq    # q.k and p.v, 2 flops a MAC
    flash_bytes = 4 * (q.numel() + k.numel() + v.numel() + out.numel())
    del q, k, v, out, qt, kt, vt

    d_in = cfg.mamba_expand * cfg.d_model
    H, N, Pd = d_in // cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_head_dim
    chunk = min(cfg.ssm_chunk, S)
    Cm = torch.randn((B, S, N), generator=g, device="cuda")
    Bm = torch.randn((B, S, N), generator=g, device="cuda")
    qs, ks = Cm[:, :, None].expand(B, S, H, N), Bm[:, :, None].expand(
        B, S, H, N)                           # shared across heads
    vs = torch.randn((B, S, H, Pd), generator=g, device="cuda")
    # the model's decay: log_a = -exp(A_log) dt with A_log = 0 and
    # dt = softplus(.), so l reaches ~ -180 inside a 256-step chunk
    la = -torch.nn.functional.softplus(torch.randn((B, S, H), generator=g,
                                                   device="cuda"))
    y, st = KS.mamba_scan(qs, ks, vs, la, chunk=chunk)
    y_p, st_p = KS.mamba_scan_plain(qs, ks, vs, la, chunk=chunk)
    # exp(l_i - l_j) subtracts two large cumulative sums, whose rounding
    # depends on the order they were summed in (a parallel cumsum on each
    # side): the error is measured against each element's sum of |terms|,
    # the scan of |q|, |k|, |v| with the same decays
    y_abs, st_abs = KS.mamba_scan_plain(qs.abs(), ks.abs(), vs.abs(), la,
                                        chunk=chunk)
    torch.cuda.synchronize()
    rel_y = float(((y - y_p).abs() / (y_abs + 1e-30)).max())
    rel_st = float(((st - st_p).abs() / (st_abs + 1e-30)).max())
    log(phase="scan_main_shape_check", max_abs_y=float((y - y_p).abs().max()),
        max_rel_to_terms_y=rel_y, max_rel_to_terms_state=rel_st,
        y_max_abs=float(y_p.abs().max()))
    check(rel_y <= SCAN_TOL and rel_st <= SCAN_TOL,
          f"main-path-shape scan == plain within {SCAN_TOL} of each "
          f"element's sum |terms|")
    # which side drifts: both against the step-by-step recurrence in
    # float64, which has no cumulative sum and no exp(l_i - l_j)
    y_64, st_64 = ssd_sequential_ref(qs, ks, vs, la)

    drift = {"kernel_y": _rel_terms(y, y_64, y_abs),
             "plain_y": _rel_terms(y_p, y_64, y_abs),
             "kernel_state": _rel_terms(st, st_64, st_abs),
             "plain_state": _rel_terms(st_p, st_64, st_abs)}
    log(phase="scan_main_shape_f64", max_rel_to_terms=drift,
        max_abs={"kernel_y": float((y.double() - y_64).abs().max()),
                 "plain_y": float((y_p.double() - y_64).abs().max())})
    check(drift["kernel_y"] <= SCAN_TOL and drift["kernel_state"] <= SCAN_TOL,
          f"main-path-shape scan == float64 recurrence within {SCAN_TOL} "
          f"of each element's sum |terms|")
    del y_64, st_64
    err_scan = max(float((y - y_p).abs().max()),
                   float((st - st_p).abs().max()))
    del y_p, st_p, y_abs, st_abs
    y2, st2 = KS.mamba_scan(qs, ks, vs, la, chunk=chunk)
    check(torch.equal(y, y2) and torch.equal(st, st2),
          "main-path-shape scan: two calls give the same bits")
    del y2, st2
    scan_ms = timed_ms(lambda: KS.mamba_scan(qs, ks, vs, la, chunk=chunk))
    scan_plain_ms = timed_ms(lambda: KS.mamba_scan_plain(qs, ks, vs, la,
                                                         chunk=chunk))
    scan_flops = _scan_work(B, S, H, N, Pd, chunk, shared_qk=True)
    scan_bytes = 4 * (Cm.numel() + Bm.numel() + vs.numel() + la.numel()
                      + y.numel() + st.numel())
    log(phase="lm_kernels", flash_shape=[B, S, Hq, Hkv, dh],
        scan_shape=[B, S, H, N, Pd, chunk], flash_flops=flash_flops,
        scan_flops=scan_flops)
    steps = {}
    for name, ms in device_ms_by_kernel(
            lambda: KS.mamba_scan(qs, ks, vs, la, chunk=chunk)).items():
        step = _scan_step(name)
        steps[step] = steps.get(step, 0.0) + ms
    scan_device = sum(v for k_, v in steps.items() if k_ != "other")
    log(phase="scan_breakdown", device_ms=steps, kernels_ms=scan_device,
        **_rates(scan_flops, scan_device))
    del qs, ks, vs, la, y, st, Cm, Bm
    q = torch.randn((B, S, Hq, dh), generator=g, device="cuda")
    k = torch.randn((B, S, Hkv, dh), generator=g, device="cuda")
    v = torch.randn((B, S, Hkv, dh), generator=g, device="cuda")
    by_name = device_ms_by_kernel(
        lambda: KF.flash_attention(q, k, v, causal=True, window=win))
    flash_device = sum(v_ for n, v_ in by_name.items()
                       if "flash_fwd_kernel" in n)
    log(phase="flash_breakdown", device_ms=by_name, kernel_ms=flash_device,
        **_rates(flash_flops, flash_device))
    # float32 inputs: both products run as three TF32 products on the
    # tensor cores
    return [kernel_entry("flash_attention",
                         launches=launches["flash_attention"], err=err_flash,
                         ms=flash_ms, plain_ms=flash_plain_ms,
                         library_ms=flash_lib_ms, bytes_=flash_bytes,
                         flops=flash_flops, peak=TF32_FLOPS / 3),
            kernel_entry("mamba_scan", launches=launches["mamba_scan"],
                         err=err_scan, ms=scan_ms, plain_ms=scan_plain_ms,
                         library_ms=None, bytes_=scan_bytes,
                         flops=scan_flops, peak=TF32_FLOPS / 3)]


def _rates(flops: int, device_ms: float) -> dict:
    """Achieved TFLOP/s of float32 work and of the TF32 work that runs it
    (three TF32 products a float32 one); None when the trace held no
    device time."""
    if device_ms <= 0:
        return {"float32_tflops": None, "tf32_tflops": None}
    return {"float32_tflops": flops / device_ms / 1e9,
            "tf32_tflops": 3 * flops / device_ms / 1e9}


def _scan_step(name: str) -> str:
    """The step of the SSD scan a CUDA kernel name belongs to
    (csrc/mamba_scan.cu runs five kernels a call), or "other"."""
    for step in ("cumsum", "cb", "states", "pass", "y"):
        if f"ssd_scan_kernel_{step}" in name:
            return step
    return "other"


def _median_steps(steps, reps=PIPELINE_REPS) -> list:
    """Run the callables of `steps` in order, `reps` times, each step ending
    in a synchronize; the median host seconds of each step. A step gets the
    previous step's result."""
    import torch
    times = []
    for _ in range(reps):
        out, row = None, []
        for step in steps:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = step(out)
            torch.cuda.synchronize()
            row.append(time.perf_counter() - t0)
        times.append(row)
    return [float(t) for t in np.median(np.asarray(times), axis=0)]


def _lowering_mismatches(low, s) -> list:
    """The fields of the device lowering `low` that differ from the host
    lowering of schedule `s` (its tiles, `shard()` and the kernels'
    streams) in dtype, shape or any bit."""
    from repro_torch.sched.kernels import _flat_slot_cost
    sh = s.shard(p=low.p, superstep=low.superstep)
    host = {"item_id": s.tiles.item_id, "seg_start": s.tiles.seg_start,
            "seg_len": s.tiles.seg_len, "tile_cost": s.tile_cost(),
            "worker": sh.worker, "block_perm": sh.block_perm,
            "rowid": sh.shard_item_id(s.item_id),
            "blkid": sh.kernel_block_ids(),
            "slot_cost": _flat_slot_cost(s.slot_cost(), sh.n_tiles_padded)}
    dev = {"item_id": low.schedule.item_id,
           "seg_start": low.schedule.seg_start,
           "seg_len": low.schedule.seg_len, "tile_cost": low.tile_cost,
           "worker": low.worker, "block_perm": low.block_perm,
           "rowid": low.rowid, "blkid": low.blkid,
           "slot_cost": low.slot_cost}
    bad = [] if low.schedule.width == s.width else ["width"]
    for name, want in host.items():
        got = dev[name].cpu().numpy()
        want = np.ascontiguousarray(want)
        if got.dtype != want.dtype or got.shape != want.shape \
                or got.tobytes() != want.tobytes():
            bad.append(name)
    return bad


def _sm_clock_mhz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        check=True, capture_output=True, text=True, timeout=60)
    return float(out.stdout.split()[0])


def once_ms(fn):
    """CUDA-event milliseconds of one call of fn, and its result."""
    import torch
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop), out


def phase_pipeline(sm_count):
    """The schedule pipeline on the card. Its main path, counted:
    `LoopScheduler(backend="torch")` -> schedule -> `device_lowering()` ->
    `pack_csr_torch` -> `ich_spmv_sharded` on the device lowering at
    wikipedia (y and costs == the host-built op's, bit for bit), and
    `device_lowering()` of every other main path's schedule. Then each
    lowering against the host's element for element, with and without
    `n_steps=`; the device pack against the host pack; the host and device
    pipelines timed per shape; and `segment_fold` / `lpt_assign` at
    wikipedia's full size against np.bincount / partition_tiles and their
    plain versions, timed."""
    import torch
    from repro_torch.core import tiling_torch as TT
    from repro_torch.core.tiling import block_chains
    from repro_torch.kernels.ich_spmv import ich_spmv as KS
    from repro_torch.kernels.lpt import lpt as L
    from repro_torch.sched import LoopScheduler, NnzCosts, registry

    w = SHAPES["wikipedia"]
    indptr = w["csr"][0]

    # ---- this slice's main path, counted ----
    L.reset_launches()
    KS.reset_launches()
    t0 = time.perf_counter()
    s_t = LoopScheduler(p=sm_count, backend="torch").schedule(
        NnzCosts(indptr))
    low = s_t.device_lowering()
    csr = [torch.from_numpy(a).cuda() for a in w["csr"]]
    vals, cols = TT.pack_csr_torch(*csr, low.schedule,
                                   pad_tiles_to=low.superstep)
    y, costs = KS.ich_spmv_sharded(vals, cols, low.rowid, low.blkid, w["x"],
                                   indptr.size - 1, low.p, low.superstep,
                                   slot_cost=low.slot_cost)
    lows = {"wikipedia": low}
    lows.update({name: sh["schedule"].device_lowering()
                 for name, sh in SHAPES.items() if name != "wikipedia"})
    torch.cuda.synchronize()
    t_path = time.perf_counter() - t0
    launches = {**L.LAUNCHES,
                "ich_spmv_sharded": KS.LAUNCHES["ich_spmv_sharded"]}
    log(phase="pipeline_main_path", seconds=t_path, launches=launches,
        shapes=list(lows), backend=s_t.backend)
    for name, count in launches.items():
        check(count > 0, f"{name} launched on the pipeline path")
    check(np.array_equal(s_t.item_id, w["schedule"].item_id),
          "backend='torch' tiles == host tiles")
    check(torch.equal(y, w["y"]) and torch.equal(costs, w["costs"]),
          "ich_spmv_sharded on the device lowering == the host op, bit "
          "for bit")
    check(torch.equal(vals, w["op"].vals) and torch.equal(cols, w["op"].cols),
          "pack_csr_torch == host pack_csr at wikipedia, bit for bit")
    del vals, cols, y, costs, csr

    # ---- every main path's lowering == the host's, element for element ----
    for name, sh in SHAPES.items():
        s, low = sh["schedule"], lows[name]
        again = TT.lower_schedule_torch(
            s.sizes, s.costs, p=low.p, superstep=low.superstep,
            rows_per_tile=s.rows_per_tile, width=s.width, eps=s.band_eps,
            n_steps=low.n_steps)
        bad, bad_again = _lowering_mismatches(low, s), \
            _lowering_mismatches(again, s)
        log(phase="pipeline_lowering_check", shape=name, items=s.n_items,
            tiles=s.n_tiles, width=s.width, p=low.p, steps=low.n_steps,
            mismatched=bad, mismatched_with_n_steps=bad_again)
        check(not bad and not bad_again,
              f"{name}: device lowering == host lowering element for "
              "element, with and without n_steps=")
    del lows, again

    # ---- host and device pipelines, timed per shape ----
    for name, sh in SHAPES.items():
        s, entry = sh["schedule"], registry.get(sh["workload"])
        B = s.superstep
        host = _median_steps([
            lambda _: LoopScheduler(cache_size=0, **sh["sched"]).schedule(
                entry.costs(*sh["inputs"])),
            lambda s_h: (s_h.shard(), s_h)[1],
            lambda s_h: entry.build(s_h, *sh["inputs"])])

        def lower():
            return TT.lower_schedule_torch(
                s.sizes, s.costs, p=s.p, superstep=B,
                rows_per_tile=s.rows_per_tile, width=s.width,
                eps=s.band_eps)

        upload = (lambda _: [torch.from_numpy(a).cuda() for a in sh["csr"]]) \
            if sh["csr"] is not None else (lambda _: None)
        dev = _median_steps([
            upload, lambda c: (c, lower()),
            lambda c_low: (TT.pack_csr_torch(*c_low[0], c_low[1].schedule,
                                             pad_tiles_to=B)
                           if c_low[0] is not None else None)])
        by_name = device_ms_by_kernel(lower)
        chain = block_chains(s.item_id, B)
        log(phase="pipeline_timing", shape=name, tiles=s.n_tiles,
            blocks=int(chain.size), chains=int(chain[-1]) + 1,
            longest_chain_blocks=int(np.bincount(chain).max()),
            host_schedule_s=host[0], host_shard_s=host[1],
            host_pack_upload_s=host[2], host_total_s=sum(host),
            device_upload_csr_s=dev[0], device_lower_s=dev[1],
            device_pack_s=dev[2] if sh["csr"] is not None else None,
            device_total_s=sum(dev), speedup=sum(host) / sum(dev),
            lowering_device_ms=sum(by_name.values()),
            lpt_assign_ms=sum(v for k, v in by_name.items()
                              if "lpt_assign_kernel" in k),
            segment_fold_ms=sum(v for k, v in by_name.items()
                                if "segment_fold_kernel" in k),
            device_ms=by_name, reps=PIPELINE_REPS)

    # ---- both kernels at wikipedia's full size: against host numpy, their
    #      plain versions, index_add_ and their bounds ----
    s = w["schedule"]
    B, p, T = s.superstep, s.p, s.n_tiles
    tc = s.tile_cost()
    chain = block_chains(s.item_id, B)
    n_blocks, n_real = chain.size, int(chain[-1]) + 1
    blk = np.arange(T) // B
    bcost = np.bincount(blk, weights=tc, minlength=n_blocks)
    ccost = np.bincount(chain, weights=bcost, minlength=n_blocks)
    order = np.argsort(-ccost + 0.0, kind="stable")
    dev = {k: torch.from_numpy(np.ascontiguousarray(a)).cuda() for k, a in
           (("tc", tc), ("blk", blk), ("chain", chain), ("bcost", bcost),
            ("ccost", ccost), ("order", order))}
    fold = (dev["tc"], dev["blk"], n_blocks)
    chain_fold = (dev["bcost"], dev["chain"], n_blocks)
    lpt = (dev["ccost"], dev["order"],
           torch.tensor([n_real]).cuda(), p)
    got_b, got_c = L.segment_fold(*fold), L.segment_fold(*chain_fold)
    got_w = L.lpt_assign(*lpt)
    worker = np.repeat(got_w.cpu().numpy()[chain], B)[:T]
    check(got_b.cpu().numpy().tobytes() == bcost.tobytes()
          and got_c.cpu().numpy().tobytes() == ccost.tobytes(),
          "segment_fold == np.bincount bit for bit at wikipedia")
    check(np.array_equal(worker, s.shard().worker),
          "lpt_assign == partition_tiles at wikipedia")
    plain_b = L.segment_fold_plain(*fold)
    check(torch.equal(got_b, plain_b)
          and torch.equal(got_c, L.segment_fold_plain(*chain_fold)),
          "segment_fold == plain at wikipedia")
    lpt_plain_ms, plain_w = once_ms(lambda: L.lpt_assign_plain(*lpt))
    check(torch.equal(got_w, plain_w), "lpt_assign == plain at wikipedia")
    index_add = torch.zeros_like(dev["ccost"]).index_add_(
        0, dev["blk"], dev["tc"])
    ms = {"segment_fold": timed_ms(lambda: L.segment_fold(*fold)),
          "lpt_assign": timed_ms(lambda: L.lpt_assign(*lpt))}
    log(phase="segment_fold_calls", block_fold_values=T,
        block_fold_ms=ms["segment_fold"], chain_fold_values=n_blocks,
        chain_fold_ms=timed_ms(lambda: L.segment_fold(*chain_fold)),
        longest_chain_blocks=int(np.bincount(chain).max()),
        index_add_bits_equal=bool(torch.equal(index_add, got_b)))
    plain_ms = {"segment_fold": timed_ms(lambda: L.segment_fold_plain(*fold)),
                "lpt_assign": lpt_plain_ms}
    library_ms = {"segment_fold": timed_ms(lambda: torch.zeros_like(
        dev["ccost"]).index_add_(0, dev["blk"], dev["tc"])),
        "lpt_assign": None}
    clock_mhz = _sm_clock_mhz()
    latency_ms = n_real * SMEM_ROUND_TRIP_CYCLES / (clock_mhz * 1e3)
    log(phase="lpt_assign_bound", chains=n_real, workers=p,
        round_trip_cycles=SMEM_ROUND_TRIP_CYCLES,
        sm_clock_mhz=clock_mhz, latency_bound_ms=latency_ms,
        ms=ms["lpt_assign"])
    bytes_ = {"segment_fold": T * 16 + n_blocks * 8,
              "lpt_assign": n_blocks * 12 + n_real * 8 + 8}
    flops = {"segment_fold": T, "lpt_assign": n_real * p}
    out = []
    for name in ("segment_fold", "lpt_assign"):
        entry = kernel_entry(name, launches=launches[name], err=0.0,
                             ms=ms[name], plain_ms=plain_ms[name],
                             library_ms=library_ms[name],
                             bytes_=bytes_[name], flops=flops[name],
                             peak=F64_FLOPS)
        if name == "lpt_assign":
            entry["latency_bound_ms"] = latency_ms
        out.append(entry)
    return out


def phase_recovery(sm_count):
    """Sharded recovery on the card at the main paths' shapes, counted:
    SpMV (wikipedia), a BFS step from the mid-depth frontier of each graph
    and K-Means (kdd_cup), each with two workers' sets dead ((0,) and two)
    and with a ragged checkpoint (worker w done through (7 w) mod (S_B + 1)
    steps) or none. `reshard_survivors` plans; the kernel runs the
    completed-prefix layout (its -1 steps) and the survivor layout (p - k
    rows: p - k CTAs for SpMV and BFS); `combine` must give the fault-free
    output's bits, and each run's cost stream must sum per worker to its
    layout's worker_cost. Logs p_rec, S_rec, the redo share of blocks,
    each run's time and makespan_model."""
    import torch
    from repro_torch.kernels.ich_bfs import ich_bfs as KB
    from repro_torch.kernels.ich_kmeans import ich_kmeans as KK
    from repro_torch.kernels.ich_spmv import ich_spmv as KS
    from repro_torch.robust import CheckpointLog
    from repro_torch.sched.kernels import _sharded_slot_cost

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).cuda()

    def flat(op, kernel, payload, tail):
        """Layout -> a call of a flat-payload sharded kernel (rows 2, 4)."""
        def runner(sh):
            rowid = put(sh.shard_item_id(op.schedule.item_id))
            blkid = put(sh.kernel_block_ids())
            return lambda: kernel(*payload, rowid, blkid, *tail, sh.p,
                                  op.superstep, slot_cost=op.slot_cost)
        return runner

    def kmeans(op, pts, cent):
        """Layout -> a call of the sharded K-Means kernel (row 6)."""
        s = op.schedule

        def runner(sh):
            rowid = put(sh.shard_item_id(s.item_id))
            slot = put(_sharded_slot_cost(s.slot_cost(), sh))
            return lambda: KK.ich_kmeans_assign_sharded(
                pts, cent, rowid, sh.p, op.superstep, slot_cost=slot)
        return runner

    for K in (KS, KB, KK):
        K.reset_launches()
    t0 = time.perf_counter()
    w = SHAPES["wikipedia"]
    op = w["op"]
    cases = [("spmv", op, KS, flat(op, KS.ich_spmv_sharded,
                                   (op.vals, op.cols), (w["x"], op.n_rows)),
              w["y"], op.vals)]
    for kind in GRAPHS:
        b = SHAPES[f"bfs_{kind}"]
        op, level = b["op"], b["level"]
        d = int(level.max()) // 2
        f = (level == d).float()
        v = ((level >= 0) & (level <= d)).float()
        cases.append((f"bfs_{kind}", op, KB, flat(
            op, KB.ich_bfs_step_sharded, (op.mask, op.cols), (f, v, op.n)),
            op.step(f, v), op.mask))
    k = SHAPES["kmeans"]
    cases.append(("kmeans", k["op"], None, kmeans(k["op"], k["pts"],
                                                  k["cent"]),
                  k["op"](k["pts"], k["cent"]), None))
    for label, op, K, runner, full, payload in cases:
        s, sh = op.schedule, op.shards
        tc = s.tile_cost()
        n_blocks = -(-s.n_tiles // sh.superstep)
        clean = float(sh.worker_cost(tc).max())
        full_ms = timed_ms(runner(sh), iters=5)
        for dead in ((0,), (0, sh.p // 2)):
            for ragged in (True, False):
                ckpt = None
                if ragged:
                    ckpt = CheckpointLog()
                    for wk in range(sh.p):
                        ckpt.mark_through(wk, (7 * wk) % (sh.n_steps + 1))
                t1 = time.perf_counter()
                plan = s.reshard_survivors(dead=dead, checkpoint=ckpt)
                t_plan = time.perf_counter() - t1
                outs, run_ms = [], []
                for layout in (plan.done_shards, plan.shards):
                    fn = runner(layout)
                    res, c = fn()
                    expect = layout.worker_cost(tc)
                    if K is None:   # float costs: float32 stream vs float64
                        ok = np.allclose(c.double().sum(dim=1).cpu().numpy(),
                                         expect, rtol=COST_RTOL, atol=0)
                    else:
                        ok = np.array_equal(c.cpu().numpy().sum(axis=1),
                                            expect.astype(np.float32))
                    check(ok, f"recovery {label} dead={dead}: per-worker "
                          "cost sums == the layout's worker_cost")
                    outs.append(res)
                    run_ms.append(timed_ms(fn, iters=5))
                check(torch.equal(plan.combine(*outs), full),
                      f"recovery {label} dead={dead} checkpoint="
                      f"{'ragged' if ragged else 'none'}: combine == the "
                      "fault-free bits")
                extra = {}
                if K is not None:
                    T_pad, R, W = payload.shape
                    extra["ctas_rec"] = K.sharded_launch_shape(
                        plan.p_rec, plan.shards.n_steps, sh.superstep, R,
                        W)["ctas"]
                    check(extra["ctas_rec"] == plan.p_rec,
                          f"recovery {label}: the survivor walk launches "
                          "p - k CTAs")
                mm = plan.makespan_model(tc)
                log(phase="recovery", workload=label, dead=list(dead),
                    checkpoint="ragged" if ragged else "none", p=sh.p,
                    p_rec=plan.p_rec, steps=sh.n_steps,
                    steps_done=plan.done_shards.n_steps,
                    steps_rec=plan.shards.n_steps,
                    redo_share=plan.redo_blocks.size / n_blocks,
                    lost_share=plan.lost_blocks.size / n_blocks,
                    redo_items=int(plan.redo_items.sum()), plan_s=t_plan,
                    full_ms=full_ms, done_ms=run_ms[0], rec_ms=run_ms[1],
                    makespan_model=mm, clean_makespan=clean,
                    model_inflation=mm["makespan"] / clean, **extra)
    torch.cuda.synchronize()
    launches = {"ich_spmv_sharded": KS.LAUNCHES["ich_spmv_sharded"],
                "ich_bfs_step_sharded": KB.LAUNCHES["ich_bfs_step_sharded"],
                "ich_kmeans_assign_sharded":
                    KK.LAUNCHES["ich_kmeans_assign_sharded"]}
    log(phase="recovery_path", seconds=time.perf_counter() - t0,
        launches=launches)
    for name, count in launches.items():
        check(count > 0, f"{name} launched on the recovery path")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.device import card_identity
    sm_count = phase_environment()
    phase_small()
    phase_small_bfs_kmeans()
    phase_small_moe()
    phase_small_lm()
    kernels = phase_main(sm_count)
    kernels += phase_bfs(sm_count)
    kernels += phase_kmeans(sm_count)
    kernels += phase_moe(sm_count)
    sched_kernels = phase_pipeline(sm_count)
    phase_recovery(sm_count)
    SHAPES.clear()
    kernels += phase_zamba2()
    kernels += sched_kernels
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card_identity(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
