"""Training step — the port's counterpart of `repro.train.train_step`:
the loss's gradient (`models.model.loss_fn`, the backward kernels of
flash attention, the SSD scan and the MoE expert FFN on the card), an
AdamW update, the MoE capacity scales' update, optional
microbatch accumulation, int8 gradient compression with error feedback,
bfloat16 parameters with a float32 master copy, and a one-time cast of
the parameters.

The train state is a dict: "params" (the model,
`models.model.StackedLM`, `EncDecLM` or `HybridLM`, its parameters
requiring grad), "opt" ({"m", "v", "step"} keyed by parameter name, plus
"master" with `bf16_params`), "cap_scales" ((MoE
layers, E) float32, ones at first: the MoE capacity scales, the paper's
d_i) and, with `grad_compress`, "grad_err" (the residuals). `step`
updates the state's tensors IN PLACE and returns the same dict with the
metrics (the reference returns a new state; in place the step needs no
second copy of the parameters and moments). The port runs eagerly: there
is nothing to jit. It trains every family. For moe
the loss takes the state's "cap_scales", and after the update each MoE
layer's row becomes `ich_update_cap_scale` of that layer's router counts
(in place; under a microbatch split the last microbatch's counts, as the
reference takes `m[-1]` of its scanned metrics).

On a mesh (`make_train_step(cfg, tcfg, dist)`, `dist` a
`launch.mesh.DistContext`: the reference's jitted step with its
`DistContext` and the in_shardings of `train_state_pspecs`) every rank
runs the step on its rows of the batch (`batch_shard`: the reference's
`batch_pspec`) and holds its shards of the train state
(`init_train_state(..., dist=)`, `shard_state`): every leaf in its
placement (`models.model.param_pspecs`: FSDP over "data"; tensor
parallelism of attention, MLP, vocabulary, Mamba2 and mLSTM and expert
parallelism over "model"; the leaves "model" does not split, such as
the sLSTM's, replicated on it). The gradient sync follows each leaf's
placement (as its module records it: `models.layers.placements`): a leaf
replicated over "data" is summed over the batch axes; a "data"-sharded
leaf arrives summed over "data" from `gather_data`'s backward (and is
summed over a pod axis); nothing is summed over "model" here (the
partial gradients of whole KV weights beside split heads are summed
inside the layer, and a leaf replicated on "model" holds its whole
gradient on every model rank already). The clipping norm is global (each element counted
once: the squares of split leaves summed over the ranks they split
over), AdamW steps every shard with it, gradient compression cuts its
blocks from whole reference leaves (`compress_grads`: a shard made of
whole blocks is compressed where it lies, any other leaf is gathered,
one at a time), and the capacity scales update from the global router
counts.
"""
from __future__ import annotations

import copy
import dataclasses
import math
from typing import Any

import torch

from repro_torch.device import resolve_device
from repro_torch.launch import collectives as C
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models import moe as MOE
from repro_torch.optim import adamw
from repro_torch.optim import grad_compress as GC
from repro_torch.sched.defaults import ICH_EPS


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    opt: adamw.AdamWConfig = adamw.AdamWConfig()
    microbatch: int = 0          # 0 = no accumulation
    grad_compress: bool = False  # int8 + error feedback on grads
    ich_eps: float = ICH_EPS     # MoE balancer epsilon (unified default)
    dtype: Any = torch.bfloat16
    cast_params_once: bool = False  # cast the float32 parameters to `dtype`
    # once per step, before the loss (the loss then runs on the cast copy)
    bf16_params: bool = False    # store params bf16 + fp32 master in opt


def cast_bf16(model) -> None:
    """The model's float32 parameters as bfloat16, in place (the
    parameters stay the same objects): `bf16_params`' storage."""
    for p in model.parameters():
        if p.dtype == torch.float32:
            p.data = p.data.to(torch.bfloat16)


def init_train_state(cfg, seed: int = 0, max_seq: int = 0,
                     tcfg: TrainConfig = TrainConfig(), device=None,
                     dist=None) -> dict:
    """The train state of a fresh model from `seed` on `device` (None =
    the card; raises without CUDA): parameters requiring grad, zero
    moments at step 0, the master copy and bfloat16 parameters with
    `bf16_params`, zero residuals with `grad_compress`. With `dist` every
    leaf and everything kept beside it is this rank's shard of its
    placement (the whole model is drawn first, so every mesh starts from
    the same weights)."""
    dev = resolve_device(device)
    model = M.init_params(cfg, seed, max_seq=max_seq, device=dev)
    if dist is not None:
        M.check_trainable(cfg, dist)
        M.shard_model(model, cfg, dist)
    model.requires_grad_(True)
    params = dict(model.named_parameters())
    opt = adamw.init_state(params)
    if tcfg.bf16_params:
        opt["master"] = {n: p.detach().clone() for n, p in params.items()}
        cast_bf16(model)
    state = {"params": model, "opt": opt,
             "cap_scales": torch.ones((M.n_moe_layers(cfg),
                                       max(cfg.n_experts, 1)),
                                      dtype=torch.float32, device=dev)}
    if tcfg.grad_compress:
        state["grad_err"] = GC.init_error_state(params)
    return state


def train_state_pspecs(cfg, tp: int = 16, max_seq: int = 0,
                       tcfg: TrainConfig = TrainConfig()) -> dict:
    """The train state's placement (`repro/train/train_step.py:56-69`):
    "params" `models.model.param_pspecs`, "opt" `adamw.opt_pspecs` (plus
    "master" as the parameters with `bf16_params`), "cap_scales"
    replicated, "grad_err" as the parameters with `grad_compress`."""
    pp = M.param_pspecs(cfg, tp, max_seq)
    op = adamw.opt_pspecs(pp)
    if tcfg.bf16_params:
        op["master"] = dict(pp)
    ps = {"params": pp, "opt": op, "cap_scales": (None, None)}
    if tcfg.grad_compress:
        ps["grad_err"] = dict(pp)
    return ps


def batch_pspec(cfg, batch_axes=("data",)) -> dict:
    """The batch's placement: rows over the batch axes
    (`repro/train/train_step.py:72-79`)."""
    b = M.axes_entry(batch_axes)
    spec = {"tokens": (b, None), "labels": (b, None)}
    if cfg.family in ("encdec", "vlm"):
        spec["frames" if cfg.family == "encdec" else "patches"] = \
            (b, None, None)
    return spec


def shard_state(cfg, state: dict, dist) -> dict:
    """A whole train state cut to this rank's shards of cfg's placements
    on `dist`, in place: the model (`models.model.shard_model`) and its
    moments, master copies and residuals, each as its parameter."""
    M.shard_model(state["params"], cfg, dist)
    placed = L.placements(state["params"])
    opt = state["opt"]
    for tree in (opt["m"], opt["v"], opt.get("master"),
                 state.get("grad_err")):
        for name in tree or ():
            tree[name] = dist.shard(tree[name], L.leaf_axes(placed, name))
    return state


def batch_shard(batch: dict, dist, microbatch: int = 0) -> dict:
    """This rank's rows of a global batch (every entry split along its
    batch axis over the batch ranks: the reference's `batch_pspec`). With
    a `microbatch` split of m, the rows of each of the reference's m
    microbatches (global rows [i B/m, (i+1) B/m)) are split over the
    ranks in turn, so this rank's m pieces of B/(m n) rows follow one
    another. Raises ValueError when B does not divide."""
    if dist is None:
        return batch
    n, r, m = dist.dp, dist.index(dist.batch_axes), max(microbatch, 1)
    out = {}
    for k, v in batch.items():
        if v.shape[0] % (n * m):
            raise ValueError(f"batch {k!r} of {v.shape[0]} rows does not "
                             f"split into {m} microbatches over {n} ranks")
        rows = v.reshape(m, n, v.shape[0] // (m * n), *v.shape[1:])[:, r]
        out[k] = rows.reshape(-1, *v.shape[1:])
    return out


def _global_norm(grads: dict, dist, placed: dict) -> torch.Tensor:
    """`adamw.global_norm` of the whole gradient tree on a mesh: each
    leaf's float32 sum of squares, a split leaf's (`placed`:
    `layers.placements`) summed over the ranks it splits over (one
    all-reduce for each set of axes), folded in leaf order: every element
    counted once."""
    sq = {n: torch.sum(torch.square(g.float())) for n, g in grads.items()}
    by_axes = {}
    for n in grads:
        axes = tuple(a for a in placed.get(n) or () if a)
        if axes:
            by_axes.setdefault(tuple(sorted(set(axes))), []).append(n)
    for axes, names in by_axes.items():
        total = C.all_reduce(torch.stack([sq[n] for n in names]),
                             dist.group(axes))
        sq.update(zip(names, total))
    total = 0
    for v in sq.values():
        total = total + v
    return torch.sqrt(total)


def _whole_blocks(axes, local_shape) -> bool:
    """Whether this rank's shard of a leaf placed at `axes` is made of
    whole int8 blocks of the whole leaf's flat order: the shard is runs
    of local[j] x (the sizes after j) contiguous elements, j its last
    split dimension, each starting at a multiple of that length."""
    split = [d for d, a in enumerate(axes or ()) if a]
    return not split or \
        math.prod(local_shape[split[-1]:]) % GC.BLOCK == 0


def compress_grads(cfg, grads: dict, err: dict, dist=None,
                   placed: dict = None):
    """`grad_compress`: (compressed gradients, new residuals), the int8
    blocks cut from the reference's leaves (`models.model.
    reference_leaves`). On a mesh, one reference leaf at a time: where
    every shard of it is whole blocks (`_whole_blocks`: olmoe-1b-7b's
    experts on up to 8 data ranks) this rank compresses its shards as
    they are, the same blocks as the whole leaf's; else the leaf is
    gathered, compressed whole and cut again, and the whole copy freed
    before the next leaf. `placed` is the model's `layers.placements`.
    The entries of `grads` and `err` are taken out as each leaf is
    done."""
    groups = M.reference_leaves(cfg, grads)
    if dist is None:
        return GC.tree_compress(grads, err, groups)
    out_g, out_e = {}, {}
    for names in groups:
        g = {n: grads.pop(n) for n in names}
        e = {n: err.pop(n) for n in names}
        axes = {n: placed.get(n) for n in names}
        if all(_whole_blocks(axes[n], g[n].shape) for n in names):
            new_g, new_e = GC.tree_compress(g, e, [names])
        else:
            new_g, new_e = (
                {n: dist.shard(t, axes[n]) for n, t in tree.items()}
                for tree in GC.tree_compress(
                    {n: dist.unshard(t, axes[n]) for n, t in g.items()},
                    {n: dist.unshard(t, axes[n]) for n, t in e.items()},
                    [names]))
        del g, e
        out_g.update(new_g)
        out_e.update(new_e)
    return out_g, out_e


def make_train_step(cfg, tcfg: TrainConfig = TrainConfig(), dist=None):
    """Returns step(state, batch) -> (state, metrics {"loss", "n_tokens",
    "grad_norm", "lr"}, for moe also "aux_loss", "dropped", "stolen" and
    "entries"); batch: "tokens" and "labels" (B, S) tensors on
    the state's device, and the family's inputs as
    `repro/launch/specs.py:19-25` shapes them: "patches" (B, P, d) for a
    vlm (optional), "frames" (B, S_enc, d) for encdec. A microbatch split
    cuts every entry along its batch axis. Raises NotImplementedError for
    a config the port does not train, ValueError for a mesh it cannot
    split over (`models.model.check_trainable`). With `dist` the state is
    this rank's (`init_train_state(..., dist=)`) and the batch its rows
    (`batch_shard`). `step.loss_and_grads(state, batch)` -> (metrics,
    gradients) is the step's gradient part alone (summed over the
    ranks), and `step.apply(state, metrics, gradients)` the rest of it
    (compression, AdamW, the capacity scales): step(state, batch) is
    apply(state, *loss_and_grads(state, batch))."""
    M.check_trainable(cfg, dist)
    # cast_params_once: the loss runs on a copy of the model whose float32
    # parameters are cast to tcfg.dtype (leaves of their own), and their
    # gradients are cast back: the chain rule through the reference's
    # astype(dtype) of the parameter tree
    shadow = {}

    def loss_model(model):
        if not tcfg.cast_params_once or tcfg.dtype == torch.float32 or \
                all(p.dtype != torch.float32 for p in model.parameters()):
            return model
        if "model" not in shadow:
            shadow["model"] = copy.deepcopy(model)
            for p in shadow["model"].parameters():
                if p.dtype == torch.float32:
                    p.data = p.data.to(tcfg.dtype)
        with torch.no_grad():
            for c, p in zip(shadow["model"].parameters(),
                            model.parameters()):
                c.copy_(p)
        return shadow["model"]

    def grads_of(model, batch, cap_scales):
        run = loss_model(model)
        loss, metrics = M.loss_fn(cfg, run, batch, cap_scales, dist=dist,
                                  dtype=tcfg.dtype)
        names = [n for n, _ in model.named_parameters()]
        grads = torch.autograd.grad(loss, list(run.parameters()))
        grads = {n: g.to(p.dtype) for n, g, p in
                 zip(names, grads, model.parameters())}
        metrics = {k: v.detach() for k, v in metrics.items()}
        return loss.detach(), metrics, grads

    def sync(grads, placed):
        # a leaf replicated over "data": each batch rank holds its share;
        # a "data"-sharded one arrives summed over "data" and needs the
        # rest of the batch axes (a pod axis) only
        fsdp = (dist.fsdp_axis,) if dist.fsdp_axis else ()
        rest = dist.group([a for a in dist.batch_axes if a not in fsdp])
        out = {}
        for n, g in grads.items():
            group = rest if dist.fsdp_axis in (placed.get(n) or ()) \
                else dist.group(dist.batch_axes)
            out[n] = g if group is None else C.all_reduce(g, group)
        return out

    def loss_and_grads(state, batch):
        model = state["params"]
        if tcfg.microbatch > 1:
            mb = tcfg.microbatch
            b = batch["tokens"].shape[0]
            if b % mb:
                raise ValueError(f"{b} rows do not split into {mb} "
                                 f"microbatches")
            grads = {n: torch.zeros(p.shape, dtype=torch.float32,
                                    device=p.device)
                     for n, p in model.named_parameters()}
            loss_sum = torch.zeros((), dtype=torch.float32,
                                   device=batch["tokens"].device)
            for i in range(mb):
                micro = {k: v.reshape(mb, b // mb, *v.shape[1:])[i]
                         for k, v in batch.items()}
                loss, metrics, g = grads_of(model, micro,
                                            state["cap_scales"])
                grads = {n: grads[n] + g[n] for n in grads}
                loss_sum = loss_sum + loss
            grads = {n: g / mb for n, g in grads.items()}
            metrics["loss"] = loss_sum / mb
        else:
            _, metrics, grads = grads_of(model, batch, state["cap_scales"])
        return metrics, grads if dist is None else \
            sync(grads, L.placements(model))

    def apply(state, metrics, grads):
        model = state["params"]
        placed = None if dist is None else L.placements(model)
        if tcfg.grad_compress:
            grads, state["grad_err"] = compress_grads(
                cfg, grads, state["grad_err"], dist, placed)
        gnorm = None if dist is None else _global_norm(grads, dist, placed)
        params = dict(model.named_parameters())
        opt = state["opt"]
        if tcfg.bf16_params:
            master = opt["master"]
            _, new_opt, opt_metrics = adamw.apply_updates(
                master, grads, opt, tcfg.opt, gnorm=gnorm)
            new_opt["master"] = master
            with torch.no_grad():
                for n, p in params.items():
                    p.copy_(master[n].to(p.dtype))
        else:
            _, new_opt, opt_metrics = adamw.apply_updates(
                params, grads, opt, tcfg.opt, gnorm=gnorm)
        state["opt"] = new_opt
        metrics.update(opt_metrics)
        if cfg.family == "moe":
            counts = metrics.pop("counts")          # (n_moe_layers, E)
            caps = state["cap_scales"]
            with torch.no_grad():
                for layer in range(caps.shape[0]):
                    caps[layer] = MOE.ich_update_cap_scale(
                        counts[layer], caps[layer], eps=tcfg.ich_eps)
        return state, metrics

    def step(state, batch):
        return apply(state, *loss_and_grads(state, batch))

    step.loss_and_grads = loss_and_grads
    step.apply = apply
    return step
