"""Dry run on the production mesh — the port's counterpart of
`repro.launch.dryrun`.

For every (architecture x input shape) cell, the step the shape dictates
(`make_train_step`, `prefill`, `decode_step`) runs ONCE for one rank of
the production mesh (`launch/mesh.py`: 32 x 8 H100s, or 2 x 32 x 8),
over PyTorch's fake process group and under `FakeTensorMode`: every
tensor is the rank's local shard at its placement's shape
(`launch/specs.py`), no value is computed, no device is touched, and
nothing is launched (the kernels' wrappers take their shape-only route,
`kernels/shape_only.py`). It records, as the reference's XLA analyses
do for its compiled step:

  memory.argument_bytes — the rank's inputs: exactly its state, batch
                          and cache as the placements cut them;
  memory.temp_bytes     — the peak of the bytes the step allocates that
                          are alive at once (the tensors it makes; its new
                          outputs included);
  memory.output_bytes / alias_bytes — the step's outputs, and those of
                          them that are inputs updated in place (the train
                          state; decode's cache);
  cost.flops            — the step's operations by `torch.utils.
                          flop_counter`'s formulas (`FlopCount`), each
                          kernel counted at its own operations;
  collectives           — every collective the port's collectives issued
                          (`launch/collective_stats.py`), by kind and by
                          mesh axis, with ring wire bytes;
  trace_s               — the wall seconds of the traced step.

Status: OK; SKIP (the reference's rule: a full-attention arch at
long_500k); NOT_PORTED (a NotImplementedError the port raises, not
faked; no cell of the production meshes raises one); FAIL.
A MoE layer takes the "capacity-full" plan (`models.moe.
capacity_full_slots`): fake tensors hold no router choices. The process
exits 1 only on FAIL. The reference's `--save-hlo` has no counterpart
(there is no HLO).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch olmo-1b \\
      --shape decode_32k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import pathlib
import time
import traceback
import weakref

import torch
import torch.distributed as tdist
from torch import nn
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.configs import ARCHS, SHAPES, get_arch
from repro_torch.launch import collective_stats, specs
from repro_torch.launch import collectives as C
from repro_torch.launch.mesh import (DistContext, batch_axes_of,
                                     make_production_mesh)
from repro_torch.models import model as M
from repro_torch.train import train_step as TS

DEVICE_NOTE = "none: fake tensors over a fake process group"


class LiveBytes(TorchDispatchMode):
    """Bytes of the storages the traced ops make, alive at once: `peak`
    (a storage counts once, from its first op output until it is freed);
    storages that existed before (`known`) are not counted."""

    def __init__(self, known=()):
        super().__init__()
        self.live = self.peak = 0
        self._refs = {}
        for t in known:
            self._refs[t.untyped_storage()._cdata] = None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                st = t.untyped_storage()
                key = st._cdata
                if key in self._refs:
                    continue
                n = st.nbytes()
                self.live += n
                self.peak = max(self.peak, self.live)
                self._refs[key] = weakref.ref(st, self._freed(key, n))
        return out

    def _freed(self, key, n):
        def cb(_):
            self.live -= n
            self._refs.pop(key, None)
        return cb


class FlopCount(TorchDispatchMode):
    """Operations of the traced ops by `torch.utils.flop_counter`'s
    formulas (its registry: products, convolutions, attention, and the
    kernels' shape-only ops, `kernels/shape_only.py`), by op:
    `FlopCounterMode`'s count without its module tracker, whose hooks
    keep autograd nodes alive in reference cycles until the garbage
    collector runs, which `LiveBytes` would count as live memory."""

    def __init__(self):
        super().__init__()
        self.by_op = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            self.by_op[str(func._overloadpacket)] += int(
                formula(*args, **kwargs, out_val=out))
        return out


def _tensors(tree) -> list:
    """The tensors of a tree of dicts, lists, modules and tensors."""
    if isinstance(tree, nn.Module):
        return list(tree.parameters())
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _serve_opt(cfg, model, dist) -> None:
    """The reference's optimised serving (`repro/launch/dryrun.py:72-87`)
    on a model drawn whole: placements by `models.model.serve_pspecs`,
    then float32 weights cast to bfloat16."""
    M.shard_model(model, cfg, dist, M.serve_pspecs(cfg, dist.tp))
    TS.cast_bf16(model)


def reference_microbatch(cfg, train_opt: bool = False) -> int:
    """The train cell's microbatch count in the reference's dry run: the
    config's, doubled with `train_opt`."""
    return max(1, cfg.train_microbatch) * (2 if train_opt else 1)


def rank_microbatch(cfg, shape, dist, train_opt: bool = False,
                    microbatch: int = 0) -> int:
    """The microbatch count a rank runs in the train cell: `microbatch`
    when given, else the reference's (`reference_microbatch`). Only where
    that count exceeds the rank's rows (its microbatches would hold fewer
    rows than there are batch ranks, which GSPMD pads and the port's ranks
    cannot split: xlstm-350m and zamba2-1.2b at train_4k, 16 microbatches
    of 256 rows over 32 data ranks, caveat 15) does a rank run one row a
    microbatch, its row count of them: a departure from the reference's
    program that `trace_step` records with its wire."""
    if microbatch:
        return microbatch
    mb = reference_microbatch(cfg, train_opt)
    rows = max(1, shape.global_batch // dist.dp)
    return rows if mb > rows else mb


def build_step(cfg, shape, mesh, *, serve_opt: bool = False,
               train_opt: bool = False, ssm_chunk: int = 0, dist=None,
               tcfg=None, microbatch: int = 0):
    """(cfg, fn, args, donated): fn(*args) runs this rank's step on `mesh`
    (any mesh: the production one, or a small one) with inputs `args`
    built on the meta device (`launch/specs.py`); `donated` are the
    arguments the step updates in place. Call under FakeTensorMode, with
    `dist` (the mesh's `DistContext`) made outside it. `tcfg` replaces
    the train cell's TrainConfig (the reference's: the config's
    microbatch, bfloat16); `microbatch` its count alone."""
    if ssm_chunk:
        cfg = dataclasses.replace(cfg, ssm_chunk=ssm_chunk)
    dist = dist or DistContext(mesh, batch_axes=batch_axes_of(mesh))
    dt = torch.bfloat16
    if shape.kind == "train":
        if train_opt:
            cfg = dataclasses.replace(cfg, moe_cmax_factor=1.25,
                                      remat_policy="dots")
        mb = rank_microbatch(cfg, shape, dist, train_opt, microbatch)
        tcfg = tcfg or TS.TrainConfig(microbatch=mb, bf16_params=train_opt,
                                      dtype=dt)
        inputs = specs.input_specs(cfg, shape, dist, tcfg)
        step = TS.make_train_step(cfg, tcfg, dist)
        return cfg, step, (inputs["state"], inputs["batch"]), (0,)
    if serve_opt:
        model = M.init_params(cfg, max_seq=shape.seq_len, device=specs.META)
        _serve_opt(cfg, model, dist)
    else:
        model = specs.params_specs(cfg, shape.seq_len, dist)
    if shape.kind == "prefill":
        def prefill(params, batch):
            return M.prefill(cfg, params, batch, dist=dist, dtype=dt)
        return cfg, prefill, (model, specs.prefill_batch_specs(
            cfg, shape, dist)), ()
    tokens, cache, pos = specs.decode_input_specs(cfg, shape, dt, dist)

    def decode(params, tokens, cache):
        return M.decode_step(cfg, params, tokens, cache, pos, dist=dist,
                             dtype=dt)
    return cfg, decode, (model, tokens, cache), (2,)


def trace_step(cfg, shape, mesh, **step_kwargs) -> dict:
    """Run one rank's step once under FakeTensorMode on `mesh` (whose
    process group may be fake): the record's memory, cost, collectives
    and trace_s. Raises what the step raises."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    dist = DistContext(mesh, batch_axes=batch_axes_of(mesh))
    with FakeTensorMode(allow_non_fake_inputs=True):
        cfg, fn, args, donated = build_step(cfg, shape, mesh, dist=dist,
                                            **step_kwargs)
        arg_ts = _tensors(args)
        arg_bytes = _nbytes(arg_ts) + (4 if shape.kind == "decode" else 0)
        live = LiveBytes(arg_ts)
        flops = FlopCount()
        t0 = time.perf_counter()
        with C.recording() as rec, flops, live:
            out = fn(*args)
        trace_s = time.perf_counter() - t0
        out_ts = _tensors(out)
        alias = _nbytes(t for i in donated for t in _tensors(args[i]))
    st = collective_stats.summarize(rec.calls)
    coll = {k: {"n": v[0], "result_bytes": v[1], "operand_bytes": v[2],
                "wire_bytes": v[3]} for k, v in st.by_kind.items()}
    rec = {
        "trace_s": round(trace_s, 1),
        "device": DEVICE_NOTE,
        "memory": {"argument_bytes": int(arg_bytes),
                   "output_bytes": int(_nbytes(out_ts)),
                   "temp_bytes": int(live.peak),
                   "alias_bytes": int(alias)},
        "cost": {"flops": float(sum(flops.by_op.values()))},
        "kernel_flops": {op: n for op, n in flops.by_op.items()
                         if op.startswith("repro_torch.")},
        "collectives": coll,
        "collectives_by_axis": {
            k: {"n": v[0], "result_bytes": v[1], "operand_bytes": v[2],
                "wire_bytes": v[3]} for k, v in st.by_axis.items()},
        "collective_operand_bytes": st.total_operand_bytes,
        "collective_wire_bytes": st.total_wire_bytes,
    }
    if shape.kind == "train":
        tcfg = step_kwargs.get("tcfg")
        opt = step_kwargs.get("train_opt", False)
        mb = tcfg.microbatch if tcfg else rank_microbatch(
            cfg, shape, dist, opt, step_kwargs.get("microbatch", 0))
        rec["microbatch"] = mb
        ref_mb = reference_microbatch(cfg, opt)
        if not tcfg and not step_kwargs.get("microbatch") and mb < ref_mb:
            rec["microbatch_departure"] = _departure(
                cfg, shape, mesh, rec, mb, ref_mb, step_kwargs)
    if cfg.moe:
        rec["moe_plan"] = "capacity-full"
    if "S" in cfg.block_pattern:
        rec["slstm_loop"] = ("one shape-only op a block (kernels/"
                             "shape_only.py slstm_fwd, slstm_bwd): S steps "
                             "of 2 B H dh^2 operations forward and 4 B H "
                             "dh^2 backward, and a (B, S, 3, H, dh) float32 "
                             "tensor for what autograd keeps a step")
    return rec


def _departure(cfg, shape, mesh, rec, mb: int, ref_mb: int,
               step_kwargs) -> dict:
    """What a cell that runs `mb` microbatches where the reference runs
    `ref_mb` (`rank_microbatch`) leaves out: each microbatch gathers the
    FSDP leaves and reduce-scatters their gradients, so the reference's
    program moves (ref_mb - mb) microbatches' more wire. A microbatch's
    wire comes from a second trace at mb // 2 microbatches (the rest of
    the step's wire is the same in both)."""
    per = None
    if mb > 1:
        half = trace_step(cfg, shape, mesh, microbatch=mb // 2,
                          **step_kwargs)
        per = (rec["collective_wire_bytes"]
               - half["collective_wire_bytes"]) / (mb - mb // 2)
    return {"reference_microbatch": ref_mb, "traced_microbatch": mb,
            "wire_bytes_a_microbatch": per,
            "reference_wire_bytes": None if per is None else
            rec["collective_wire_bytes"] + (ref_mb - mb) * per,
            "note": f"the reference's {ref_mb} microbatches hold fewer rows "
                    f"than there are batch ranks (GSPMD pads them); this "
                    f"rank runs its rows as {mb} microbatches of one row: "
                    f"collective_wire_bytes counts {mb} microbatches' "
                    f"FSDP gathers and gradient reduce-scatters, "
                    f"reference_wire_bytes {ref_mb} (caveat 15)"}


def run_cell(arch_name: str, shape_name: str, multi_pod: bool = False,
             out_dir: str = "results/dryrun_torch", **step_kwargs) -> dict:
    cfg = get_arch(arch_name)
    shape = SHAPES[shape_name]
    rec = {"arch": arch_name, "shape": shape_name,
           "mesh": "2x32x8" if multi_pod else "32x8",
           "params": cfg.param_count(),
           "active_params": cfg.active_param_count()}
    if not cfg.supports(shape):
        rec["status"] = "SKIP"
        rec["reason"] = ("full-attention arch: long_500k needs "
                         "sub-quadratic attention (DESIGN.md §5)")
        return _save(rec, out_dir)
    started = not tdist.is_initialized()
    try:
        mesh = make_production_mesh(multi_pod=multi_pod)
        rec.update(trace_step(cfg, shape, mesh, **step_kwargs))
        rec["status"] = "OK"
        m = rec["memory"]
        print(f"[dryrun] {arch_name} x {shape_name} ({rec['mesh']}): OK "
              f"flops/dev={rec['cost']['flops']:.3e} "
              f"args={m['argument_bytes']/2**30:.2f}GiB "
              f"temp={m['temp_bytes']/2**30:.2f}GiB "
              f"coll={rec['collective_wire_bytes']/2**20:.1f}MiB/dev "
              f"(trace {rec['trace_s']}s)")
    except NotImplementedError as e:
        rec["status"] = "NOT_PORTED"
        rec["reason"] = str(e)
        print(f"[dryrun] {arch_name} x {shape_name}: NOT_PORTED {e}")
    except Exception as e:  # noqa: BLE001 — record the failure, keep sweeping
        rec["status"] = "FAIL"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
        print(f"[dryrun] {arch_name} x {shape_name}: FAIL {rec['error'][:200]}")
    finally:
        if started and tdist.is_initialized():
            tdist.destroy_process_group()
    return _save(rec, out_dir)


def _save(rec: dict, out_dir: str) -> dict:
    p = pathlib.Path(out_dir)
    p.mkdir(parents=True, exist_ok=True)
    slim = {k: v for k, v in rec.items() if k != "traceback"}
    name = f"{rec['arch']}_{rec['shape']}_{rec['mesh']}.json"
    (p / name).write_text(json.dumps(slim, indent=1))
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--save-hlo", action="store_true",
                    help="not carried over: the port compiles no HLO "
                         "(ROADMAP.md item 6b); giving it is an error")
    ap.add_argument("--serve-opt", action="store_true",
                    help="optimized serving: TP-only bf16 weights")
    ap.add_argument("--train-opt", action="store_true",
                    help="optimized training: bf16 params + master, MoE "
                         "C_max 1.25, remat dots")
    ap.add_argument("--ssm-chunk", type=int, default=0)
    args = ap.parse_args(argv)
    if args.save_hlo:
        ap.error("--save-hlo has no counterpart in the port: there is no HLO")

    archs = list(ARCHS) if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    counts = {"OK": 0, "SKIP": 0, "NOT_PORTED": 0, "FAIL": 0}
    for a in archs:
        for s in shapes:
            for mp in meshes:
                kw = {"serve_opt": args.serve_opt, "train_opt":
                      args.train_opt, "ssm_chunk": args.ssm_chunk}
                rec = run_cell(a, s, multi_pod=mp, out_dir=args.out, **kw)
                counts[rec["status"]] += 1
    print(f"[dryrun] done: {counts['OK']} OK, {counts['SKIP']} SKIP, "
          f"{counts['NOT_PORTED']} NOT_PORTED, {counts['FAIL']} FAIL")
    raise SystemExit(1 if counts["FAIL"] else 0)


if __name__ == "__main__":
    main()
