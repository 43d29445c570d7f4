#!/usr/bin/env python3
"""Training over a torch.distributed mesh across the cards of one host.

    python3 chip_mesh.py                       # one NCCL rank a card (4)
    python3 chip_mesh.py --device cpu --tiny   # rehearsal: 4 gloo ranks
    python3 chip_mesh.py --witness             # one card: the witness alone

`chip_smoke.py` drives the mesh path on one card (a 1 x 1 NCCL mesh, and
expert parallelism rank by rank in one process); this script runs it
with one rank a card, R = the cards of the host, each rank a process
(spawned, a `file://` store under build/: no port), on olmoe-1b-7b at
full width (64 experts top-8, D 2,048, F 1,024), tokens from the
pipeline's corpus (`synthetic_tokens`), capacity scales drawn in
[0.25, 1.25]:

* parity: cut to 2 layers, one float32 step on a (1, R) ("data",
  "model") mesh (each rank E/R experts) against the unmeshed step on
  rank 0's card from the same state and 4 x 2,048 tokens: the loss
  within 1e-5 relative, every gradient leaf and every new parameter
  (whole leaves gathered) within 1e-4 of the leaf's largest unmeshed
  value, the dropped and stolen entries and the new scales exactly;
* data parallel: the same cut, one bfloat16 step on a (2, R/2) mesh:
  every replicated leaf and the scales the same bits on every rank;
* depth: olmoe-1b-7b at its 16 layers on a (1, R) mesh, DEPTH_STEPS
  bfloat16 steps of 4 x 2,048 tokens: finite losses, the median and
  range of the steps' walls after the first (which warms the cards
  up), one more step traced on every rank (torch.profiler: device ms
  by kernel group, the collectives apart, and the idle share of its
  wall), each rank's train state bytes and peak device memory over the
  steps (and over the state's init, the whole model drawn first; one
  card holds 10 of the 16 layers unsharded); then COMPRESS_STEPS steps
  with `grad_compress` from a fresh state: finite losses and the peak;
* dense parity: glm4-9b (32 heads, 2 KV heads: each rank's query heads
  read one whole KV head) cut to 2 layers, one float32 step on a (1, R)
  mesh (attention heads, MLP columns and rows and the vocabulary split
  over "model") against the unmeshed step on rank 0's card: the loss
  within 1e-6 relative, every gradient leaf and new parameter within
  1e-5 of the leaf's largest unmeshed value;
* dense depth: glm4-9b at its 40 layers on a (1, R) mesh (a model whose
  float32 train state does not fit one card), DEPTH_STEPS bfloat16 steps
  of 4 x 2,048 tokens: the median and range of the steps after the
  first, one traced step (the collectives' share of the card's time),
  each rank's state bytes and peak;
* recurrent parity: zamba2-1.2b cut to its first 6 blocks (MMMMMA: d_in
  and the Mamba2 heads split, the shared attention block's heads),
  xlstm-350m cut to 4 (XXXS: the mLSTM's heads split, the sLSTM
  replicated) and whisper-small cut to 2 encoder and 2 decoder layers
  (its 1,500 frames and 448 tokens a row), one float32 step each on a
  (1, R) mesh against the unmeshed step on rank 0's card: the loss
  within 1e-5 relative, every gradient leaf and new parameter within
  1e-4 of the leaf's largest unmeshed value or within the rounding
  witness below;
* the rounding witness of the recurrent parity (on rank 0's card): the
  unmeshed float32 step again from the same state with every parameter
  moved by one ulp in a random direction, the distance of its gradients
  and new parameters from the unmeshed step's, leaf by leaf: how far
  float32 rounding alone moves each leaf at the parity's size and path.
  A leaf the mesh moves by more than LEAF_TOL passes if it moves by no
  more than WITNESS_FACTOR times the witness (the issue's fixed bar,
  met or not, is logged beside it), and a parameter also within
  ZERO_START_FLOOR lr (a leaf that starts at zero, such as a norm's bias
  or dt_bias, moves by about lr sign(g) in AdamW's first step, so its
  share of its own max is a share of lr: the floor
  `tests/test_torch_mesh_tp.py` holds the meshed steps to);
* recurrent depth: zamba2-1.2b at its 38 blocks on a (1, R) mesh,
  DEPTH_STEPS bfloat16 steps of 4 x 2,048 tokens (`dense_depth`'s
  measures);
* the dry run's prediction (`launch/dryrun.py`, one rank of the (1, R)
  mesh under fake tensors, traced in this process before the ranks
  start): argument + temp bytes for the glm4-9b, olmoe-1b-7b and
  zamba2-1.2b depth steps, beside each one's measured peak.

Rank 0 prints one JSON line a result, each with the card's name and
power limit; the last line is {"ok": true, ...}. A failed check is
logged at once ("check_failed"); every rank runs on to the end (a rank
that stops frees the others within RANK_TIMEOUT_S), then raises, and the
script exits non-zero.
"""
from __future__ import annotations

import argparse
import dataclasses
import datetime
import json
import shutil
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
ARCH, SEED, CAP_RANGE = "olmoe-1b-7b", 0, (0.25, 1.25)
BATCH, SEQ, CUT_LAYERS, DEPTH_STEPS, COMPRESS_STEPS = 4, 2048, 2, 6, 2
# kernel name fragment -> group of a traced step's device time
KERNEL_GROUPS = (("nccl", "collectives"), ("moe_bwd_", "ich_moe_bwd"),
                 ("moe_", "ich_moe"), ("flash_bwd_", "flash_attention_bwd"),
                 ("flash_fwd", "flash_attention"), ("gemm", "matmul"),
                 ("nvjet", "matmul"), ("cutlass", "matmul"))
LOSS_RTOL, LEAF_TOL = 1e-5, 1e-4
PEAKS = {}      # each depth step's peak a rank (GB), by arch
RANK_TIMEOUT_S = 300    # a collective's wait for the other ranks
DENSE_ARCH = "glm4-9b"
DENSE_LOSS_RTOL, DENSE_LEAF_TOL = 1e-6, 1e-5
# (arch, blocks or layers kept) of the recurrent and encoder-decoder
# parity; whisper's rows: its 1,500 frames and a 448-token text context
RECURRENT_CUTS = (("zamba2-1.2b", 6), ("xlstm-350m", 4),
                  ("whisper-small", 2))
RECURRENT_ARCH, WHISPER_SEQ = "zamba2-1.2b", 448
# the recurrent parity's rounding witness: a leaf within WITNESS_FACTOR
# times the distance a one-ulp nudge of the parameters moves it (a fault
# of the layout, a partial sum missed or doubled or a slice misplaced,
# moves a leaf by a share of its max near 1), or a parameter within
# ZERO_START_FLOOR lr
WITNESS_FACTOR, ZERO_START_FLOOR = 10.0, 1e-3


def log(**kw) -> None:
    print(json.dumps(kw), flush=True)


FAILED = []     # this rank's failed checks; raised after the last phase


def check(ok: bool, what: str) -> None:
    """Record a failed check (logged at once); every rank goes on to the
    end, so no rank waits in a collective for one that has stopped, and
    `_rank` raises after the last phase."""
    if not ok:
        FAILED.append(what)
        log(phase="check_failed", what=what)


def _dense_cfg(args):
    from repro_torch.configs import get_arch, reduced
    cfg = get_arch(DENSE_ARCH)
    if args.tiny:       # 4 heads, 2 KV heads (whole on each of 4 ranks)
        cfg = reduced(cfg, d_model=256)
    return cfg


def _recurrent_cfgs(args):
    """The recurrent parity's configs: each of RECURRENT_CUTS cut to its
    first blocks (layers, and as many encoder layers); with `--tiny` the
    reduced configs (Zamba2 with heads of 16 and its shared block once)."""
    from repro_torch.configs import get_arch, reduced
    out = []
    for name, n in RECURRENT_CUTS:
        cfg = get_arch(name)
        over = {"n_layers": n}
        if cfg.block_pattern:
            over["block_pattern"] = cfg.block_pattern[:n]
        if cfg.family == "encdec":
            over["encoder_layers"] = n
        if args.tiny:
            extra = {"ssm_head_dim": 16, "attn_window": 24,
                     "ssm_chunk": 16} if cfg.family == "hybrid" else {}
            cfg = reduced(cfg, **over, **extra)
        else:
            cfg = dataclasses.replace(cfg, **over)
        out.append(cfg)
    return out


def _setup(args):
    import torch
    from repro_torch.configs import get_arch, reduced
    from repro_torch.models import model as M
    cfg = get_arch(ARCH)
    batch, seq = BATCH, SEQ
    if args.tiny:
        cfg = reduced(cfg, n_experts=8, experts_per_token=2, d_model=256)
        batch, seq = 4, 64
    caps = np.random.default_rng(SEED + 70).uniform(
        *CAP_RANGE, (M.n_moe_layers(cfg), cfg.n_experts)).astype(np.float32)
    return cfg, batch, seq, torch.from_numpy(caps)


def _state(cfg, tcfg, caps, dev, dist=None):
    from repro_torch.models import model as M
    from repro_torch.train import train_step as TS
    st = TS.init_train_state(cfg, SEED, tcfg=tcfg, device=dev, dist=dist)
    st["cap_scales"].copy_(caps[:M.n_moe_layers(cfg)])
    return st


def _batch(cfg, batch, seq, dev, dist=None, step=0):
    """Tokens from the pipeline's corpus, and an encdec model's frames
    (standard normal from numpy, seeded), this rank's rows."""
    import torch
    from repro_torch.data.pipeline import synthetic_tokens
    from repro_torch.train import train_step as TS
    b = synthetic_tokens(batch, seq, cfg.padded_vocab, step, SEED)
    if cfg.family == "encdec":
        b["frames"] = np.random.default_rng(SEED + step).standard_normal(
            (batch, cfg.encoder_seq, cfg.d_model), dtype=np.float32)
    return {k: torch.from_numpy(v).to(dev)
            for k, v in TS.batch_shard(b, dist).items()}


def _share(a, b) -> float:
    scale = float(b.abs().max())
    return float((a - b).abs().max()) / scale if scale else \
        float(a.abs().max())


def parity(mesh, cfg, batch, seq, caps, dev, rank, card) -> None:
    import torch
    from repro_torch.launch.mesh import DistContext
    from repro_torch.models import layers as L
    from repro_torch.train import train_step as TS
    cut = dataclasses.replace(cfg, n_layers=CUT_LAYERS)
    dist = DistContext(mesh)
    tcfg = TS.TrainConfig(dtype=torch.float32)
    t0 = time.perf_counter()
    st = _state(cut, tcfg, caps, dev, dist)
    step = TS.make_train_step(cut, tcfg, dist)
    b = _batch(cut, batch, seq, dev, dist)
    _, grads = step.loss_and_grads(st, b)
    st, m = step(st, b)
    placed = L.placements(st["params"])
    whole_g = {n: dist.unshard(g, placed.get(n)) for n, g in grads.items()}
    whole_p = {n: dist.unshard(p.detach(), placed.get(n))
               for n, p in st["params"].named_parameters()}
    del grads
    if rank != 0:
        return
    ref = _state(cut, tcfg, caps, dev)
    ref_step = TS.make_train_step(cut, tcfg)
    rb = _batch(cut, batch, seq, dev)
    _, r_grads = ref_step.loss_and_grads(ref, rb)
    g_share = {n: _share(whole_g[n], g) for n, g in r_grads.items()}
    del r_grads, whole_g
    ref, rm = ref_step(ref, rb)
    p_share = {n: _share(whole_p[n], p.detach())
               for n, p in ref["params"].named_parameters()}
    loss = (float(m["loss"]), float(rm["loss"]))
    log(phase="mesh_parity", mesh=list(mesh.mesh.shape), layers=CUT_LAYERS,
        tokens=batch * seq, loss_meshed_unmeshed=loss,
        grad_worst_share=max(g_share.values()),
        param_worst_share=max(p_share.values()),
        dropped=(float(m["dropped"]), float(rm["dropped"])),
        stolen=(float(m["stolen"]), float(rm["stolen"])),
        card=card, seconds=time.perf_counter() - t0)
    check(abs(loss[0] - loss[1]) <= LOSS_RTOL * abs(loss[1]),
          "mesh parity: loss")
    check(max(g_share.values()) <= LEAF_TOL, "mesh parity: gradients")
    check(max(p_share.values()) <= LEAF_TOL, "mesh parity: parameters")
    check(float(m["dropped"]) == float(rm["dropped"])
          and float(m["stolen"]) == float(rm["stolen"])
          and torch.equal(st["cap_scales"], ref["cap_scales"]),
          "mesh parity: dropped, stolen and the new scales")


def data_parallel(mesh, cfg, batch, seq, caps, dev, rank, card) -> None:
    import torch
    import torch.distributed as tdist
    from repro_torch.launch import collectives as C
    from repro_torch.launch.mesh import DistContext
    from repro_torch.models import layers as L
    from repro_torch.train import checkpoint as CKPT
    from repro_torch.train import train_step as TS
    cut = dataclasses.replace(cfg, n_layers=CUT_LAYERS)
    dist = DistContext(mesh)
    tcfg = TS.TrainConfig()
    t0 = time.perf_counter()
    st = _state(cut, tcfg, caps, dev, dist)
    st, m = TS.make_train_step(cut, tcfg, dist)(
        st, _batch(cut, batch, seq, dev, dist))
    differ = []
    world = tdist.group.WORLD
    placed = L.placements(st)
    for n, t in CKPT.state_leaves(st):
        if L.leaf_axes(placed, n):
            continue
        first = t.detach().clone()
        tdist.broadcast(first, 0, group=world)
        gap = C.all_reduce((t.detach().float() - first.float()).abs().max()
                           .reshape(1), world)
        if float(gap) != 0.0:
            differ.append(n)
    if rank == 0:
        log(phase="mesh_data_parallel", mesh=list(mesh.mesh.shape),
            loss=float(m["loss"]), dropped=float(m["dropped"]),
            replicated_leaves_differ=differ, card=card,
            seconds=time.perf_counter() - t0)
    check(not differ and np.isfinite(float(m["loss"])),
          "mesh data parallel: replicated leaves the same bits on every "
          "rank, a finite loss")


def _traced(fn, dev):
    """fn() once, and on the card its device ms by `KERNEL_GROUPS`
    (torch.profiler's CUDA trace; {} when the trace holds no device
    time) with the wall ms: (fn's result, split, wall ms)."""
    import torch
    if dev.type != "cuda":
        t0 = time.perf_counter()
        return fn(), {}, (time.perf_counter() - t0) * 1e3
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        # the trace can miss the first kernel it sees: a short spin
        torch.cuda._sleep(1000)
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize(dev)
        wall = (time.perf_counter() - t0) * 1e3
    split = {}
    for ev in prof.key_averages():
        if ev.device_time_total <= 0 or "spin_kernel" in ev.key:
            continue
        group = next((g for k, g in KERNEL_GROUPS if k in ev.key.lower()),
                     "other")
        split[group] = split.get(group, 0.0) + ev.device_time_total / 1e3
    return out, split, wall


def _peak(dev) -> float:
    import torch
    return torch.cuda.max_memory_allocated(dev) / 1e9 \
        if dev.type == "cuda" else 0.0


def _fresh(dev) -> None:
    import gc
    import torch
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)


def depth(mesh, cfg, batch, seq, caps, dev, rank, card) -> None:
    import torch
    import torch.distributed as tdist
    from repro_torch.launch.mesh import DistContext
    from repro_torch.train import checkpoint as CKPT
    from repro_torch.train import train_step as TS
    dist = DistContext(mesh)
    tcfg = TS.TrainConfig()
    _fresh(dev)
    t0 = time.perf_counter()
    st = _state(cfg, tcfg, caps, dev, dist)
    state_gb = sum(t.numel() * t.element_size()
                   for _, t in CKPT.state_leaves(st)) / 1e9
    init_s = time.perf_counter() - t0
    init_peak_gb = _peak(dev)       # the whole model drawn, then cut
    _fresh(dev)
    step = TS.make_train_step(cfg, tcfg, dist)
    losses, walls = [], []
    for s in range(DEPTH_STEPS):
        b = _batch(cfg, batch, seq, dev, dist, step=s)
        t1 = time.perf_counter()
        st, m = step(st, b)
        losses.append(float(m["loss"]))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        walls.append((time.perf_counter() - t1) * 1e3)
    b = _batch(cfg, batch, seq, dev, dist, step=DEPTH_STEPS)
    (st, m), split, traced_wall = _traced(lambda: step(st, b), dev)
    losses.append(float(m["loss"]))
    device_ms = sum(split.values())
    mine = {"state_gb": state_gb, "peak_gb": _peak(dev),
            "init_peak_gb": init_peak_gb,
            "traced_step": {"wall_ms": traced_wall, "device_ms": split,
                            "device_total_ms": device_ms,
                            "idle_share": 1.0 - device_ms / traced_wall
                            if split else None}}
    del st, step, b, m
    _fresh(dev)
    ctcfg = TS.TrainConfig(grad_compress=True)
    st = _state(cfg, ctcfg, caps, dev, dist)
    step = TS.make_train_step(cfg, ctcfg, dist)
    compress_losses = []
    for s in range(COMPRESS_STEPS):
        st, m = step(st, _batch(cfg, batch, seq, dev, dist, step=s))
        compress_losses.append(float(m["loss"]))
    mine["grad_compress_peak_gb"] = _peak(dev)
    del st, step, m
    _fresh(dev)
    per_rank = [None] * tdist.get_world_size()
    tdist.all_gather_object(per_rank, mine)
    after = walls[1:]
    PEAKS[cfg.name] = max(r["peak_gb"] for r in per_rank)
    if rank == 0:
        log(phase="mesh_depth", mesh=list(mesh.mesh.shape),
            layers=cfg.n_layers, tokens=batch * seq, losses=losses,
            step_wall_ms=walls, median_wall_ms=float(np.median(after)),
            wall_range_ms=[min(after), max(after)],
            tokens_per_s=batch * seq / (float(np.median(after)) * 1e-3),
            init_s=init_s, grad_compress_losses=compress_losses,
            per_rank=per_rank, card=card,
            seconds=time.perf_counter() - t0)
    check(all(np.isfinite(losses + compress_losses)),
          "mesh depth: finite losses, with and without grad_compress")


def _nudged_step(cut, tcfg, max_seq, dev, batch):
    """The unmeshed float32 step from the parity's state with every
    parameter moved by one ulp in a random direction (seeded): its
    gradients and new parameters, by name."""
    import torch
    from repro_torch.train import train_step as TS
    st = TS.init_train_state(cut, SEED, max_seq, tcfg=tcfg, device=dev)
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 90)
    inf = float("inf")
    with torch.no_grad():
        for p in st["params"].parameters():
            up = torch.rand(p.shape, generator=g, device=dev) < 0.5
            p.copy_(torch.nextafter(p, torch.where(
                up, torch.full_like(p, inf), torch.full_like(p, -inf))))
    step = TS.make_train_step(cut, tcfg)
    metrics, grads = step.loss_and_grads(st, batch)
    st, _ = step.apply(st, metrics, grads)
    return grads, {n: p.detach()
                   for n, p in st["params"].named_parameters()}


def dense_parity(mesh, cfg, batch, seq, caps, dev, rank, card, *,
                 cut=None, label="mesh_dense_parity",
                 loss_rtol=DENSE_LOSS_RTOL, leaf_tol=DENSE_LEAF_TOL,
                 witness: bool = False) -> None:
    """glm4-9b at 2 layers (or the config `cut`), float32: the (1, R) step
    with its layers split over "model" against the unmeshed step. With
    `witness`, a leaf beyond `leaf_tol` passes within WITNESS_FACTOR
    times the rounding witness (`_nudged_step`), a parameter also within
    ZERO_START_FLOOR lr."""
    import torch
    from repro_torch.launch.mesh import DistContext
    from repro_torch.models import layers as L
    from repro_torch.train import train_step as TS
    cut = cut or dataclasses.replace(cfg, n_layers=CUT_LAYERS)
    max_seq = max(cut.encoder_seq, seq) if cut.family == "encdec" else 0
    dist = DistContext(mesh)
    tcfg = TS.TrainConfig(dtype=torch.float32)
    t0 = time.perf_counter()
    st = TS.init_train_state(cut, SEED, max_seq, tcfg=tcfg, device=dev,
                             dist=dist)
    step = TS.make_train_step(cut, tcfg, dist)
    b = _batch(cut, batch, seq, dev, dist)
    _, grads = step.loss_and_grads(st, b)
    st, m = step(st, b)
    placed = L.placements(st["params"])
    whole_g = {n: dist.unshard(g, placed.get(n)) for n, g in grads.items()}
    whole_p = {n: dist.unshard(p.detach(), placed.get(n))
               for n, p in st["params"].named_parameters()}
    split = sorted({n.split(".")[-2] + "." + n.split(".")[-1]
                    for n in placed})
    shapes = {n: list(p.shape) for n, p in st["params"].named_parameters()
              if n.startswith("layers.0.") or n.startswith("embed.")}
    del grads, st
    if rank != 0:
        return
    ref = TS.init_train_state(cut, SEED, max_seq, tcfg=tcfg, device=dev)
    ref_step = TS.make_train_step(cut, tcfg)
    rb = _batch(cut, batch, seq, dev)
    r_metrics, r_grads = ref_step.loss_and_grads(ref, rb)
    g_share = {n: _share(whole_g[n], g) for n, g in r_grads.items()}
    del whole_g
    ref, rm = ref_step.apply(ref, r_metrics, r_grads)
    r_params = {n: p.detach() for n, p in ref["params"].named_parameters()}
    p_share = {n: _share(whole_p[n], p) for n, p in r_params.items()}
    p_abs = {n: float((whole_p[n] - p).abs().max())
             for n, p in r_params.items()}
    loss = (float(m["loss"]), float(rm["loss"]))
    lr = float(rm["lr"])
    worst_g = max(g_share, key=g_share.get)
    worst_p = max(p_share, key=p_share.get)
    rec = {}
    g_bar = p_bar = {n: leaf_tol for n in g_share}
    if witness:
        w_grads, w_params = _nudged_step(cut, tcfg, max_seq, dev, rb)
        w_g = {n: _share(w_grads[n], g) for n, g in r_grads.items()}
        w_p = {n: _share(w_params[n], p) for n, p in r_params.items()}
        del w_grads, w_params
        g_bar = {n: max(leaf_tol, WITNESS_FACTOR * w_g[n]) for n in w_g}
        p_bar = {n: max(leaf_tol, WITNESS_FACTOR * w_p[n]) for n in w_p}
        ratio = {n: g_share[n] / w_g[n] if w_g[n] else float("inf")
                 for n in g_share if g_share[n] > leaf_tol}
        p_ratio = {n: p_share[n] / w_p[n] if w_p[n] else float("inf")
                   for n in p_share if p_share[n] > leaf_tol}
        rec = {"witness_grad_worst_share": max(w_g.values()),
               "witness_grad_worst_leaf": max(w_g, key=w_g.get),
               "witness_param_worst_share": max(w_p.values()),
               "witness_param_worst_leaf": max(w_p, key=w_p.get),
               "witness_at_worst_grad_leaf": w_g[worst_g],
               "witness_at_worst_param_leaf": w_p[worst_p],
               "grad_leaves_past_leaf_tol": len(ratio),
               "grad_worst_ratio_to_witness": max(ratio.values(),
                                                  default=None),
               "param_leaves_past_leaf_tol": len(p_ratio),
               "param_worst_ratio_to_witness": max(p_ratio.values(),
                                                   default=None),
               "witness_factor": WITNESS_FACTOR,
               "zero_start_floor_lr": ZERO_START_FLOOR,
               "issue_bar_met": g_share[worst_g] <= leaf_tol
               and p_share[worst_p] <= leaf_tol}
    del r_grads
    bad_g = sorted(n for n in g_share if g_share[n] > g_bar[n])
    bad_p = sorted(n for n in p_share if p_share[n] > p_bar[n]
                   and not (witness and p_abs[n] <= ZERO_START_FLOOR * lr))
    log(phase=label, arch=cfg.name, mesh=list(mesh.mesh.shape),
        layers=cut.n_layers, block_pattern=list(cut.block_pattern),
        encoder_layers=cut.encoder_layers, tokens=batch * seq,
        loss_meshed_unmeshed=loss, lr=lr,
        grad_worst_share=g_share[worst_g], grad_worst_leaf=worst_g,
        param_worst_share=p_share[worst_p], param_worst_leaf=worst_p,
        param_worst_abs=p_abs[worst_p], **rec,
        grad_leaves_failed=bad_g, param_leaves_failed=bad_p,
        split_leaves=split,
        local_shapes_rank0=shapes, card=card,
        seconds=time.perf_counter() - t0)
    check(abs(loss[0] - loss[1]) <= loss_rtol * abs(loss[1]),
          f"{label}: {cfg.name} loss")
    check(not bad_g, f"{label}: {cfg.name} gradients")
    check(not bad_p, f"{label}: {cfg.name} parameters")


def recurrent_parity(mesh, cfg, batch, seq, caps, dev, rank, card, *,
                     args=None) -> None:
    """Each of `_recurrent_cfgs` (zamba2-1.2b at 6 blocks, xlstm-350m at
    4, whisper-small at 2 + 2 layers), float32: the (1, R) step against
    the unmeshed step (`dense_parity`'s measures) within LOSS_RTOL, and
    LEAF_TOL or the rounding witness."""
    import torch.distributed as tdist
    for cut in _recurrent_cfgs(args):
        rows = min(seq, WHISPER_SEQ) if cut.family == "encdec" else seq
        dense_parity(mesh, cut, batch, rows, caps, dev, rank, card, cut=cut,
                     label="mesh_recurrent_parity", loss_rtol=LOSS_RTOL,
                     leaf_tol=LEAF_TOL, witness=True)
        tdist.barrier()
        _fresh(dev)


def dense_depth(mesh, cfg, batch, seq, caps, dev, rank, card, *,
                label="mesh_dense_depth") -> None:
    """glm4-9b (or zamba2-1.2b) at its full depth on (1, R), bfloat16
    (`depth`'s measures, without the compressed run)."""
    import torch.distributed as tdist
    from repro_torch.launch.mesh import DistContext
    from repro_torch.train import checkpoint as CKPT
    from repro_torch.train import train_step as TS
    dist = DistContext(mesh)
    tcfg = TS.TrainConfig()
    _fresh(dev)
    t0 = time.perf_counter()
    st = TS.init_train_state(cfg, SEED, tcfg=tcfg, device=dev, dist=dist)
    state_gb = sum(t.numel() * t.element_size()
                   for _, t in CKPT.state_leaves(st)) / 1e9
    init_s = time.perf_counter() - t0
    _fresh(dev)
    step = TS.make_train_step(cfg, tcfg, dist)
    losses, walls = [], []
    for s in range(DEPTH_STEPS):
        b = _batch(cfg, batch, seq, dev, dist, step=s)
        t1 = time.perf_counter()
        st, m = step(st, b)
        losses.append(float(m["loss"]))
        _sync(dev)
        walls.append((time.perf_counter() - t1) * 1e3)
    b = _batch(cfg, batch, seq, dev, dist, step=DEPTH_STEPS)
    (st, m), split, traced_wall = _traced(lambda: step(st, b), dev)
    losses.append(float(m["loss"]))
    device_ms = sum(split.values())
    mine = {"state_gb": state_gb, "peak_gb": _peak(dev),
            "traced_step": {"wall_ms": traced_wall, "device_ms": split,
                            "device_total_ms": device_ms,
                            "collectives_share": split.get(
                                "collectives", 0.0) / device_ms
                            if device_ms else None,
                            "idle_share": 1.0 - device_ms / traced_wall
                            if split else None}}
    del st, step, b, m
    _fresh(dev)
    per_rank = [None] * tdist.get_world_size()
    tdist.all_gather_object(per_rank, mine)
    PEAKS[cfg.name] = max(r["peak_gb"] for r in per_rank)
    after = walls[1:]
    if rank == 0:
        log(phase=label, arch=cfg.name,
            mesh=list(mesh.mesh.shape), layers=cfg.n_layers,
            tokens=batch * seq, losses=losses, step_wall_ms=walls,
            median_wall_ms=float(np.median(after)),
            wall_range_ms=[min(after), max(after)],
            tokens_per_s=batch * seq / (float(np.median(after)) * 1e-3),
            init_s=init_s, per_rank=per_rank, card=card,
            seconds=time.perf_counter() - t0)
    check(all(np.isfinite(losses)), f"{label}: finite losses")


def recurrent_depth(mesh, cfg, batch, seq, caps, dev, rank, card) -> None:
    """zamba2-1.2b at its 38 blocks on (1, R), bfloat16 (`dense_depth`)."""
    dense_depth(mesh, cfg, batch, seq, caps, dev, rank, card,
                label="mesh_recurrent_depth")


def _sync(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def dryrun_predictions(args, world) -> dict:
    """The dry run's argument + temp bytes for one rank of the (1, world)
    depth steps (glm4-9b, olmoe-1b-7b: `depth`'s and `dense_depth`'s
    configs, batch and TrainConfig), traced here under fake tensors over
    a fake process group (no device)."""
    import torch.distributed as tdist
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import fake_mesh
    from repro_torch.train import train_step as TS
    moe_cfg, batch, seq, _ = _setup(args)
    shape = ShapeSpec("mesh_depth", seq, batch, "train")
    out = {}
    for cfg in (_dense_cfg(args), moe_cfg, _recurrent_depth_cfg(args)):
        t0 = time.perf_counter()
        try:
            rec = dryrun.trace_step(cfg, shape, fake_mesh(
                (1, world), ("data", "model")), tcfg=TS.TrainConfig())
        finally:
            tdist.destroy_process_group()
        m = rec["memory"]
        out[cfg.name] = {
            "predicted_gb": (m["argument_bytes"] + m["temp_bytes"]) / 1e9,
            "argument_gb": m["argument_bytes"] / 1e9,
            "temp_gb": m["temp_bytes"] / 1e9, "flops": rec["cost"]["flops"],
            "collective_wire_gb": rec["collective_wire_bytes"] / 1e9,
            "seconds": time.perf_counter() - t0}
    return out


def _recurrent_depth_cfg(args):
    from repro_torch.configs import get_arch, reduced
    cfg = get_arch(RECURRENT_ARCH)
    if args.tiny:
        cfg = reduced(cfg, ssm_head_dim=16, block_pattern=("M", "M", "A"),
                      n_layers=3, attn_window=24, ssm_chunk=16)
    return cfg


# the leaves M2's (1, 4) parity missed 1e-4 at (zamba2's, whisper's)
WATCH = ("blocks.2.mamba.out", "blocks.1.mamba.dt_bias", "layers.0.ln1.bias")


def witness_alone(args) -> None:
    """`--witness`: on one device, no mesh, each recurrent parity config's
    unmeshed float32 step and its rounding witness (`_nudged_step`) at
    the parity's batch and rows: how far float32 rounding alone moves
    each leaf at the parity's size and path, logged beside the leaves in
    WATCH."""
    import torch
    from repro_torch.train import train_step as TS
    dev = torch.device("cpu" if args.device == "cpu" else "cuda")
    card = "cpu"
    if dev.type == "cuda":
        from repro_torch.device import card_identity
        card = card_identity().splitlines()[0]
    _, batch, seq, _ = _setup(args)
    tcfg = TS.TrainConfig(dtype=torch.float32)
    for cut in _recurrent_cfgs(args):
        t0 = time.perf_counter()
        rows = min(seq, WHISPER_SEQ) if cut.family == "encdec" else seq
        max_seq = max(cut.encoder_seq, rows) if cut.family == "encdec" \
            else 0
        st = TS.init_train_state(cut, SEED, max_seq, tcfg=tcfg, device=dev)
        step = TS.make_train_step(cut, tcfg)
        b = _batch(cut, batch, rows, dev)
        metrics, grads = step.loss_and_grads(st, b)
        st, m = step.apply(st, metrics, grads)
        params = {n: p.detach() for n, p in st["params"].named_parameters()}
        w_grads, w_params = _nudged_step(cut, tcfg, max_seq, dev, b)
        g = {n: _share(w_grads[n], x) for n, x in grads.items()}
        p = {n: _share(w_params[n], x) for n, x in params.items()}
        p_abs = {n: float((w_params[n] - x).abs().max())
                 for n, x in params.items()}
        top = sorted(g, key=g.get, reverse=True)[:5]
        top_p = sorted(p, key=p.get, reverse=True)[:5]
        log(phase="witness_alone", arch=cut.name,
            layers=cut.n_layers, tokens=batch * rows, lr=float(m["lr"]),
            grad_top=[[n, g[n]] for n in top],
            param_top=[[n, p[n], p_abs[n]] for n in top_p],
            watched={n: {"grad_share": g[n], "param_share": p[n],
                         "param_abs": p_abs[n]}
                     for n in WATCH if n in g},
            card=card, seconds=time.perf_counter() - t0)
        del st, step, grads, w_grads, w_params, params


def _rank(rank, world, store, args, out) -> None:
    import torch
    sys.path.insert(0, str(ROOT / "src"))
    torch.set_num_threads(1 if args.device == "cpu" else 2)
    from repro_torch.launch.mesh import init_process_group, make_mesh
    import torch.distributed as tdist
    # a rank that fails frees the others within RANK_TIMEOUT_S
    dev = init_process_group(f"file://{store}", rank=rank, world_size=world,
                             device=args.device,
                             timeout=datetime.timedelta(
                                 seconds=RANK_TIMEOUT_S))
    card = "cpu"
    if dev.type == "cuda":
        from repro_torch.device import card_identity
        card = card_identity().splitlines()[0]
    cfg, batch, seq, caps = _setup(args)
    try:
        dense = _dense_cfg(args)
        for fn, shape, c in ((parity, (1, world), cfg),
                             (data_parallel, (2, world // 2), cfg),
                             (depth, (1, world), cfg),
                             (dense_parity, (1, world), dense),
                             (dense_depth, (1, world), dense),
                             (recurrent_parity, (1, world), None),
                             (recurrent_depth, (1, world),
                              _recurrent_depth_cfg(args))):
            mesh = make_mesh(shape, ("data", "model"), args.device)
            kw = {"args": args} if fn is recurrent_parity else {}
            fn(mesh, c, batch, seq, caps, dev, rank, card, **kw)
            tdist.barrier()
        tdist.barrier()
        if FAILED:
            raise RuntimeError(f"check failed on rank {rank}: {FAILED}")
        if rank == 0:
            Path(out).write_text(json.dumps(PEAKS))
    finally:
        tdist.destroy_process_group()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help='"cpu" for gloo ranks (default: one card a rank)')
    ap.add_argument("--tiny", action="store_true",
                    help="reduced olmoe (8 experts, d_model 256), 4 x 64 "
                         "tokens: a rehearsal size")
    ap.add_argument("--witness", action="store_true",
                    help="the recurrent parity's rounding witness alone, "
                         "on one device, no mesh")
    args = ap.parse_args()
    import torch
    import torch.multiprocessing as mp
    if args.device != "cpu" and not torch.cuda.is_available():
        print("chip_mesh: CUDA is not available", file=sys.stderr)
        return 1
    if args.witness:
        sys.path.insert(0, str(ROOT / "src"))
        if args.device != "cpu":
            from repro_torch.kernels import _build
            _build.build_all()
        witness_alone(args)
        print(json.dumps({"ok": not FAILED, "witness": True}), flush=True)
        return 0
    world = 4 if args.device == "cpu" else torch.cuda.device_count()
    if world < 2 or world % 2:
        print(f"chip_mesh: needs an even number of ranks, has {world}",
              file=sys.stderr)
        return 1
    tmp = ROOT / "build" / "chip_mesh"
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    out = tmp / "ok"
    t0 = time.perf_counter()
    if args.device != "cpu":     # once, before the ranks load the kernels
        sys.path.insert(0, str(ROOT / "src"))
        from repro_torch.kernels import _build
        log(phase="build", sources=_build.build_all(),
            seconds=time.perf_counter() - t0)
    sys.path.insert(0, str(ROOT / "src"))
    t1 = time.perf_counter()
    predicted = dryrun_predictions(args, world)
    log(phase="dryrun_predictions", ranks=world, predicted=predicted,
        seconds=time.perf_counter() - t1)
    mp.start_processes(_rank, args=(world, str(tmp / "store"), args,
                                    str(out)),
                       nprocs=world, start_method="spawn")
    if not out.exists():
        raise RuntimeError("check failed: every phase ran")
    measured = json.loads(out.read_text())
    log(phase="dryrun_vs_measured", mesh=[1, world], by_arch={
        name: {"predicted_gb": p["predicted_gb"],
               "measured_peak_gb": measured.get(name),
               "rel_gap": p["predicted_gb"] / measured[name] - 1.0
               if measured.get(name) else None}
        for name, p in predicted.items()})
    log(phase="chip_mesh_seconds", ranks=world,
        seconds=time.perf_counter() - t0)
    print(json.dumps({"ok": True, "device": {
        "platform": "cpu" if args.device == "cpu" else "gpu",
        "kind": "cpu" if args.device == "cpu"
        else torch.cuda.get_device_name(0),
        "count": world}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
