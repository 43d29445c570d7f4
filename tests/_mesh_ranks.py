"""Spawned gloo ranks for the mesh tests (`tests/test_torch_mesh_*.py`).

`start(tmp_path, shape, tasks)` starts prod(shape) processes on the
CPU, each a rank of a ("data", "model") mesh of `shape` (a default
process group from a `file://` store under tmp_path: no port), which run
the tasks [(name, kwargs)] in order; its `result()` waits for them and
returns rank 0's results, one per task (`run` does both). Several
meshes' ranks may run at once. The tasks gather what they return (whole expert leaves,
every rank's rows), so rank 0 holds the whole answer. This module
imports no JAX: ranks start faster without it."""
from __future__ import annotations

import copy
import dataclasses
import itertools
import math

import numpy as np
import torch
import torch.distributed as tdist

from repro_torch.configs import get_arch, reduced
from repro_torch.convert import train_state_from_reference
from repro_torch.launch import collectives as C
from repro_torch.launch.mesh import (DistContext, init_process_group,
                                     make_mesh, make_smoke_mesh)
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models import moe as MOE
from repro_torch.optim import grad_compress as GC
from repro_torch.train import checkpoint as CKPT
from repro_torch.train import train_step as TS
from repro_torch.train.trainer import InjectedFailure, RunConfig, train

_SPAWNS = itertools.count()


class start:
    def __init__(self, tmp_path, shape, tasks):
        n = math.prod(shape)
        k = next(_SPAWNS)
        self.out = tmp_path / f"rank0-{k}.pt"
        # the tasks go by file: arguments larger than a pipe's buffer
        # would hold the parent until each child has imported torch
        src = tmp_path / f"tasks-{k}.pt"
        torch.save(tasks, src)
        self.ctx = torch.multiprocessing.start_processes(
            _rank_main, args=(n, str(tmp_path / f"store-{k}"),
                              tuple(shape), str(src), str(self.out)),
            nprocs=n, start_method="spawn", join=False)

    def result(self):
        while not self.ctx.join():   # raises a rank's exception
            pass
        return torch.load(self.out, weights_only=False)


def run(tmp_path, shape, tasks):
    return start(tmp_path, shape, tasks).result()


def _rank_main(rank, n, store, shape, src, out):
    torch.set_num_threads(1)
    tasks = torch.load(src, weights_only=False)
    init_process_group(f"file://{store}", rank=rank, world_size=n,
                       device="cpu")
    try:
        mesh = make_mesh(shape, ("data", "model"), "cpu")
        results = [TASKS[name](mesh, **kw) for name, kw in tasks]
        if rank == 0:
            torch.save(results, out)
    finally:
        tdist.destroy_process_group()


def _cfg(arch, over):
    return reduced(get_arch(arch), **over)


def _t(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _rows(dist, t):
    """Every batch rank's rows of t, in order (whole on every rank)."""
    return C.all_gather(t.detach().contiguous(), 0,
                        dist.group(dist.batch_axes))


def _zeros(tree):
    if isinstance(tree, dict):
        return {k: _zeros(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_zeros(v) for v in tree)
    return np.zeros_like(tree)


def _whole(dist, tree, placed):
    """Every leaf of `tree` gathered whole, at its axes in `placed`
    (`layers.placements`): copies (a whole leaf is the live tensor, which
    a later step updates in place)."""
    return {n: dist.unshard(t.detach(), L.leaf_axes(placed, n))
            .float().numpy().copy() for n, t in tree.items()}


# ------------------------------------------------------------------ tasks
def ep(mesh, *, arch, over, weights, x, r, cap, aux_weight):
    """The expert-parallel MoE block at capacity (with the steal round)
    and dropless: y, the gradients of sum(y * r) + aux_weight * aux loss
    (x's rows, the router's summed over the batch ranks, whole expert
    leaves), the aux values, and the local expert shapes."""
    cfg = _cfg(arch, over)
    dist = DistContext(mesh)
    out = {"tp": dist.tp, "dp": dist.dp}
    for dropless in (False, True):
        moe = MOE.MoE(cfg, torch.Generator().manual_seed(0), "cpu")
        with torch.no_grad():
            for name, w in weights.items():
                getattr(moe, name).copy_(torch.from_numpy(w))
        L.shard_module(moe, dist, {
            leaf: dist.effective(axes)
            for leaf, axes in MOE.moe_pspec(cfg).items()})
        moe.requires_grad_(True)
        xl = TS.batch_shard({"x": torch.from_numpy(x)}, dist)["x"]
        rl = TS.batch_shard({"r": torch.from_numpy(r)}, dist)["r"]
        xl.requires_grad_(True)
        y, aux = MOE.apply_moe(cfg, moe, xl, torch.from_numpy(cap),
                               dist=dist, dropless=dropless)
        loss = (y * rl).sum() + aux_weight * aux["aux_loss"]
        leaves = [xl, moe.router, moe.wi, moe.wg, moe.wo]
        gx, grt, gwi, gwg, gwo = torch.autograd.grad(loss, leaves)
        out[dropless] = {
            "shapes": {n: tuple(getattr(moe, n).shape)
                       for n in ("wi", "wg", "wo")},
            "y": _rows(dist, y).numpy(), "dx": _rows(dist, gx).numpy(),
            "router": C.all_reduce(grt, dist.group(dist.batch_axes)).numpy(),
            **{f"moe.{n}": dist.unshard(g, moe.placement.get(n))
               .float().numpy()
               for n, g in (("wi", gwi), ("wg", gwg), ("wo", gwo))},
            **{k: v.detach().numpy() for k, v in aux.items()}}
    return out


def serve(mesh, *, arch, over, tokens):
    """Prefill and one decode step of the whole model on this rank's rows
    with the experts split over the mesh, against the same calls without
    a mesh: the largest relative differences of the logits."""
    cfg = _cfg(arch, over)
    dist = DistContext(mesh)
    model = M.init_params(cfg, 0, device="cpu")
    whole = copy.deepcopy(model)
    M.shard_model(model, cfg, dist)
    rows = TS.batch_shard({"tokens": torch.from_numpy(tokens)},
                          dist)["tokens"]
    l0, c0 = M.prefill(cfg, whole, {"tokens": rows})
    l1, c1 = M.prefill(cfg, model, {"tokens": rows}, dist=dist)
    nxt = torch.argmax(l0, -1)[:, None]
    d0, _ = M.decode_step(cfg, whole, nxt, _pad_cache(cfg, c0), rows.shape[1])
    d1, _ = M.decode_step(cfg, model, nxt, _pad_cache(cfg, c1), rows.shape[1],
                          dist=dist)

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())
    return {"prefill": rel(l1, l0), "decode": rel(d1, d0)}


def _pad_cache(cfg, cache):
    """The prefill's cache with one more position for a decode step."""
    return [{k: torch.nn.functional.pad(v, (0, 0, 0, 0, 0, 1))
             for k, v in seg.items()} for seg in cache]


def step(mesh, *, arch, over, state, batches, options, with_grads=True):
    """make_train_step on the mesh from the reference's state: the first
    batch's gradients (`step.loss_and_grads`), then a step a batch, each
    with its metrics, whole parameters (and master copies) and capacity
    scales."""
    cfg = _cfg(arch, over)
    dist = DistContext(mesh)
    tcfg = TS.TrainConfig(dtype=torch.float32, **options)
    state = dict(state, opt=dict(state["opt"]))
    if tcfg.bf16_params:    # as the reference's init: params become master
        state["opt"]["master"] = state["params"]
    if tcfg.grad_compress:
        state["grad_err"] = _zeros(state["params"])
    st = train_state_from_reference(cfg, state, device="cpu", dist=dist)
    fn = TS.make_train_step(cfg, tcfg, dist)
    placed = L.placements(st["params"])
    out = {"steps": []}
    for i, batch in enumerate(batches):
        local = TS.batch_shard(_t(batch), dist, tcfg.microbatch)
        if i == 0 and with_grads:
            metrics, grads = fn.loss_and_grads(st, local)
            out["grads"] = _whole(dist, grads, placed)
            out["grad_metrics"] = {k: v.numpy() for k, v in metrics.items()}
        st, metrics = fn(st, local)
        out["steps"].append({
            "metrics": {k: v.detach().numpy() for k, v in metrics.items()},
            "params": _whole(dist, dict(st["params"].named_parameters()),
                             placed),
            "master": _whole(dist, st["opt"].get("master", {}), placed),
            "cap_scales": st["cap_scales"].numpy().copy()})
    return out


def compress(mesh, *, arch, cases, seed):
    """`compress_grads` on the mesh against `tree_compress` of the whole
    trees, for each case {label: config override}: gradients and
    residuals drawn whole from `seed`, this rank's shards compressed and
    gathered again. The names whose bits differ, and the all-gathers the
    compression made."""
    dist = DistContext(mesh)
    out = {}
    for label, over in cases.items():
        cfg = _cfg(arch, over)
        placed = {n: dist.effective(a)
                  for n, a in M.param_pspecs(cfg, dist.tp).items()}
        g = torch.Generator().manual_seed(seed)
        grads, err = {}, {}
        for n, p in M.init_params(cfg, 0, device="meta").named_parameters():
            grads[n] = torch.randn(p.shape, generator=g)
            err[n] = torch.randn(p.shape, generator=g) * 1e-3
        want = GC.tree_compress(grads, err, M.reference_leaves(cfg, grads))
        gathers, gather = [], C.all_gather

        def counted(*a, **kw):
            gathers.append(1)
            return gather(*a, **kw)
        C.all_gather = counted
        try:
            got = TS.compress_grads(
                cfg, {n: dist.shard(t, placed[n]) for n, t in grads.items()},
                {n: dist.shard(t, placed[n]) for n, t in err.items()}, dist,
                placed)
        finally:
            C.all_gather = gather
        out[label] = {"gathers": len(gathers), "differ": [
            f"{kind} {n}" for kind, w, t in zip(("grad", "err"), want, got)
            for n in w
            if not torch.equal(dist.unshard(t[n], placed[n]), w[n])]}
    return out


def dense(mesh, *, arch, over, batch, seed):
    """A dense model's step from `init_train_state(seed)` on this rank's
    rows: the step's loss and the whole new parameters."""
    cfg = _cfg(arch, over)
    dist = DistContext(mesh)
    tcfg = TS.TrainConfig(dtype=torch.float32)
    st = TS.init_train_state(cfg, seed, tcfg=tcfg, device="cpu", dist=dist)
    st, metrics = TS.make_train_step(cfg, tcfg, dist)(
        st, TS.batch_shard(_t(batch), dist))
    return {"loss": float(metrics["loss"]),
            "params": _whole(dist, dict(st["params"].named_parameters()),
                             L.placements(st["params"]))}


def save(mesh, *, arch, over, batch, seed, ckpt_dir):
    """One step from `init_train_state(seed)`, then a checkpoint: the
    state's whole leaves as saved."""
    cfg = _cfg(arch, over)
    dist = DistContext(mesh)
    tcfg = TS.TrainConfig(dtype=torch.float32)
    st = TS.init_train_state(cfg, seed, tcfg=tcfg, device="cpu", dist=dist)
    st, _ = TS.make_train_step(cfg, tcfg, dist)(
        st, TS.batch_shard(_t(batch), dist))
    CKPT.save_state(st, ckpt_dir, 1, dist=dist)
    placed = L.placements(st)
    return {n: dist.unshard(t.detach(), L.leaf_axes(placed, n)).numpy()
            for n, t in CKPT.state_leaves(st)}


def load(mesh, *, arch, over, seed, ckpt_dir):
    """A fresh state from another seed with the checkpoint loaded into its
    shards: whole leaves, and the local expert shapes."""
    cfg = _cfg(arch, over)
    dist = DistContext(mesh)
    st = TS.init_train_state(cfg, seed, device="cpu", dist=dist,
                             tcfg=TS.TrainConfig(dtype=torch.float32))
    st, at = CKPT.load_state(st, ckpt_dir, dist=dist)
    placed = L.placements(st)
    return {"step": at,
            "shapes": {n: tuple(t.shape) for n, t in CKPT.state_leaves(st)},
            "leaves": {n: dist.unshard(t.detach(), L.leaf_axes(placed, n))
                       .numpy() for n, t in CKPT.state_leaves(st)}}


def trainer(mesh, *, arch, over, ckpt_dir, steps, batch, seq):
    """train() on the mesh with a failure after step 2 and a resume, and
    an uninterrupted run: both runs' losses, and whether the two final
    states hold the same bits."""
    cfg = _cfg(arch, over)
    run = RunConfig(steps=steps, batch=batch, seq=seq, ckpt_dir=ckpt_dir,
                    ckpt_every=2, failure_at=2, log_every=100)
    failed = False
    try:
        train(cfg, run, mesh=mesh, verbose=False)
    except InjectedFailure:
        failed = True
    listed = CKPT.list_steps(ckpt_dir)
    state, resumed = train(cfg, dataclasses.replace(run, failure_at=None),
                           mesh=mesh, verbose=False)
    fresh_state, fresh = train(cfg, dataclasses.replace(
        run, failure_at=None, ckpt_dir=ckpt_dir + "-fresh"), mesh=mesh,
        verbose=False)
    same = all(torch.equal(a, b) for (_, a), (_, b) in zip(
        CKPT.state_leaves(state), CKPT.state_leaves(fresh_state)))
    return {"failed": failed, "listed": listed, "resumed": resumed,
            "fresh": fresh, "same_state": same}


def one_rank(mesh, *, arch, over, batches, seed, caps):
    """On a one-rank group: `make_smoke_mesh("cpu")`'s 1 x 1 mesh, and
    `make_train_step` with its DistContext against dist=None, a step a
    batch from the same state: the names of the metrics and state leaves
    whose bits differ (none expected)."""
    cfg = _cfg(arch, over)
    dist = DistContext(make_smoke_mesh("cpu"))
    tcfg = TS.TrainConfig(dtype=torch.float32)
    states = []
    for d in (None, dist):
        st = TS.init_train_state(cfg, seed, tcfg=tcfg, device="cpu", dist=d)
        st["cap_scales"].copy_(torch.from_numpy(caps))
        states.append([st, TS.make_train_step(cfg, tcfg, d)])
    differ = []
    for i, batch in enumerate(batches):
        out = []
        for pair, d in zip(states, (None, dist)):
            pair[0], metrics = pair[1](pair[0],
                                       TS.batch_shard(_t(batch), d))
            out.append(metrics)
        differ += [f"{k} step {i}" for k in out[0]
                   if not torch.equal(out[0][k], out[1][k])]
        differ += [f"{n} step {i}" for (n, a), (_, b) in zip(
            CKPT.state_leaves(states[0][0]), CKPT.state_leaves(states[1][0]))
            if not torch.equal(a, b)]
    return differ


def seq_decode(mesh, *, arch, over, tokens, seed, cache_len):
    """Decode over a KV cache split by sequence (the KV heads do not
    divide the model ranks): the unmeshed prefill's cache of every row,
    padded to `cache_len` positions and cut to this rank's rows and
    positions, then one `decode_step` with the mesh; and the meshed
    prefill's own cache against the unmeshed one's slice. The logits
    (every batch rank's rows) and the cache's largest difference relative
    to its largest value."""
    cfg = _cfg(arch, over)
    dist = DistContext(mesh)
    whole = M.init_params(cfg, seed, device="cpu")
    model = copy.deepcopy(whole)
    M.shard_model(model, cfg, dist)
    assert M.kv_layout(cfg, dist) == "seq"
    toks = torch.from_numpy(tokens)
    rows = TS.batch_shard({"tokens": toks}, dist)["tokens"]
    S = rows.shape[1]
    _, c_whole = M.prefill(cfg, whole, {"tokens": rows})
    l_mesh, c_mesh = M.prefill(cfg, model, {"tokens": rows}, dist=dist)
    r, tp = dist.index(dist.tp_axis), dist.tp
    n = S // tp
    cache_err = max(float((c_mesh[s][kv] - c_whole[s][kv][
        :, :, r * n:(r + 1) * n]).abs().max() / c_whole[s][kv].abs().max())
        for s in range(len(c_whole)) for kv in ("k", "v"))
    m = cache_len // tp
    local = [{kv: torch.nn.functional.pad(
        t, (0, 0, 0, 0, 0, cache_len - S))[:, :, r * m:(r + 1) * m]
        .contiguous() for kv, t in seg.items()} for seg in c_whole]
    nxt = torch.argmax(l_mesh, -1)[:, None]
    d_mesh, _ = M.decode_step(cfg, model, nxt, local, S, dist=dist)
    return {"prefill_logits": _rows(dist, l_mesh).numpy(),
            "decode_logits": _rows(dist, d_mesh).numpy(),
            "next": _rows(dist, nxt).numpy(), "cache_err": cache_err}


def cut_cache(cfg, cache, dist, batch: int):
    """A whole cache (this rank's rows) cut to this rank's slices of every
    dimension that `cache_pspecs` puts on "model"."""
    axes = M.cache_pspecs(cfg, batch, {"data": 1, "model": dist.tp})

    def cut(t, a):
        if isinstance(t, dict):
            return {k: cut(t[k], a[k]) for k in t}
        if isinstance(t, list):
            return [cut(x, y) for x, y in zip(t, a)]
        return dist.shard(t, tuple(dist.tp_axis if x == "model" else None
                                   for x in a))
    return cut(cache, axes)


def pad_cache(cfg, cache, n: int):
    """A prefill's cache with n more positions for decode steps: every
    self-attention cache (Zamba2's "A" ring, whisper's "self" part, a
    stacked model's segments) padded along its sequence."""
    def pad(t, dim):
        widths = [0, 0] * (t.ndim - dim - 1) + [0, n]
        return torch.nn.functional.pad(t, widths)
    if cfg.family == "encdec":
        return {"self": [{k: pad(v, 2) for k, v in cache["self"][0].items()}],
                "cross": cache["cross"]}
    if cfg.family in M.STACKED:
        return [{k: pad(v, 2) for k, v in seg.items()} for seg in cache]
    return [{k: pad(v, 1) for k, v in st.items()}
            if kind == "A" else st
            for kind, st in zip(cfg.block_pattern, cache)]


def family_inputs(cfg, batch: dict) -> dict:
    """The prefill's inputs of a batch: its tokens, and whisper's
    frames."""
    return {k: v for k, v in batch.items() if k in ("tokens", "frames")}


def tp_family(mesh, *, arch, over, batch, seed, max_seq, pad):
    """Any family's whole layout from `init_train_state(seed, max_seq)`:
    the loss and whole gradients of `loss_and_grads` on this rank's rows,
    float32; the prefill's last logits and its cache against the
    unmeshed prefill's cache cut to this rank (largest difference relative
    to each leaf's largest value); then one `decode_step` over the
    unmeshed cache padded by `pad` positions and cut to this rank. Every
    batch rank's rows of the logits."""
    cfg = _cfg(arch, over)
    dist = DistContext(mesh)
    tcfg = TS.TrainConfig(dtype=torch.float32)
    st = TS.init_train_state(cfg, seed, max_seq, tcfg=tcfg, device="cpu",
                             dist=dist)
    local = TS.batch_shard(_t(batch), dist)
    metrics, grads = TS.make_train_step(cfg, tcfg, dist).loss_and_grads(
        st, local)
    whole = M.init_params(cfg, seed, max_seq=max_seq, device="cpu")
    inputs = family_inputs(cfg, local)
    B, S = inputs["tokens"].shape
    logits, c_mesh = M.prefill(cfg, st["params"], inputs, dist=dist)
    _, c_whole = M.prefill(cfg, whole, inputs)
    mine = cut_cache(cfg, c_whole, dist, B)
    errs = [float((a - b).abs().max() / max(float(b.abs().max()), 1e-30))
            for a, b in zip(_flat(c_mesh), _flat(mine))]
    nxt = torch.argmax(logits, -1)[:, None]
    d, _ = M.decode_step(cfg, st["params"], nxt,
                         cut_cache(cfg, pad_cache(cfg, c_whole, pad), dist,
                                   B), S, dist=dist)
    return {"loss": float(metrics["loss"]),
            "grads": _whole(dist, grads, L.placements(st["params"])),
            "logits": _rows(dist, logits).numpy(),
            "decode": _rows(dist, d).numpy(), "next": _rows(dist, nxt).numpy(),
            "cache_err": max(errs), "n_cache": len(errs),
            "shapes": {n: tuple(p.shape) for n, p in
                       st["params"].named_parameters()}}


def ring_cache(cfg, cache, ring: int):
    """A hybrid prefill's cache with each "A" entry cut to a ring of `ring`
    slots, as serving holds it (`cache_specs`: min(cache_len, window)
    slots): slot j holds the last position p with p % ring == j."""
    def cut(t):
        S = t.shape[1]
        return t[:, [S - 1 - (S - 1 - j) % ring for j in range(ring)]]
    return [{k: cut(v) for k, v in st.items()} if kind == "A" else st
            for kind, st in zip(cfg.block_pattern, cache)]


def ring_decode(mesh, *, arch, over, tokens, seed, steps):
    """A hybrid's decode steps past the end of its windowed ring (each
    "A" cache `attn_window` slots, split by sequence where the KV heads
    do not divide the model ranks): the unmeshed prefill's cache of this
    rank's rows cut to the ring, then `steps` `decode_step`s from
    position S on, whole on this rank and with the mesh over the ring cut
    to this rank; each step's logits of both (every batch rank's rows),
    the tokens fed the unmeshed greedy ones."""
    cfg = _cfg(arch, over)
    dist = DistContext(mesh)
    whole = M.init_params(cfg, seed, device="cpu")
    model = copy.deepcopy(whole)
    M.shard_model(model, cfg, dist)
    rows = TS.batch_shard({"tokens": torch.from_numpy(tokens)},
                          dist)["tokens"]
    B, S = rows.shape
    logits, cache = M.prefill(cfg, whole, {"tokens": rows})
    c_whole = ring_cache(cfg, cache, cfg.attn_window)
    c_mesh = cut_cache(cfg, copy.deepcopy(c_whole), dist, B)
    got, want = [], []
    for i in range(steps):
        nxt = torch.argmax(logits, -1)[:, None]
        logits, c_whole = M.decode_step(cfg, whole, nxt, c_whole, S + i)
        d, c_mesh = M.decode_step(cfg, model, nxt, c_mesh, S + i, dist=dist)
        want.append(_rows(dist, logits).numpy())
        got.append(_rows(dist, d).numpy())
    return {"meshed": got, "unmeshed": want,
            "layout": M.kv_layout(cfg, dist), "ring": cfg.attn_window}


def _flat(tree):
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _flat(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _flat(x)]
    return [tree]


TASKS = {f.__name__: f for f in (ep, serve, step, compress, dense, save,
                                 load, trainer, one_rank, seq_decode,
                                 tp_family, ring_decode)}
