"""Mixture-of-Experts layer of the port — the counterpart of
`repro.models.moe`, on one device or expert-parallel over a mesh
(`launch.mesh.DistContext`).

The paper's loop-scheduling problem reappears in MoE: tokens are loop
iterations, experts are workers, and router imbalance is the irregular
work. The reference computes the expert FFN in-graph over an (E, C_max, D)
slot buffer and trains it by XLA's derivative of those einsums; its host
planner `sched.moe.plan_dispatch` mirrors its `dispatch_decisions` bit
for bit. The port runs the layer THROUGH the scheduler:

    router (softmax -> top-K -> renormalise, per block of TOKEN_BLOCK
    tokens) -> `plan_dispatch` on the host -> `LoopScheduler(p=...)
    .build("moe-dispatch", plan)` -> `MoeExpertsFn`: forward
    `ich_moe_sharded`, backward `ich_moe_backward`

with p the card's SM count (2 on the CPU). On the card the expert FFN is
the hand-written `csrc/ich_moe.cu` and its gradient `csrc/ich_moe_bwd.cu`;
on the CPU the wrappers run their plain versions. Each call copies the
router's top-K choices to the host: the plan is host numpy.

Training (`dropless=False`, `models.model.loss_fn`) gives expert e the
capacity clip(round(C_base * cap_scale[e]), MOE_MIN_CAPACITY, C_max)
with the steal round: capacity is the chunk size, the steal round is
work-stealing, and `cap_scale`, the paper's d_i, is reclassified every
step from the router's counts by `ich_update_cap_scale`
(`train.train_step`). `MoeExpertsFn` is the autograd Function around the
scheduled FFN. Its forward runs the op over the plan's packed combine
weights (the host copy of the router's renormalised top-K weights, the
same values) and keeps the op (its pack and `MoeSlots`), the plan's slot
-> (token, choice) entry map and x (not the up products: the backward
recomputes them). Its backward launches the
backward kernel over the plan's CSR and the forward's token -> slots
index and returns dx, dwi, dwg, dwo and the (T, K) weights' gradient:
each kept entry's, zero for a dropped one (a dropped entry reaches the
router only through the renormalisation's denominator, by autograd
outside the Function): the router's gradient through the combine is
this return value, whatever tensor fed the forward's kernel. Under remat
the layer's rerun plans again, which gives the same plan; the backward
plans nothing and uses the ctx. Without a gradient to take (serving) the
layer calls the op directly and uploads no entry map.

Serving (`dropless=True`, `models.model`'s prefill, extend and decode)
gives every expert capacity for the whole token pool and no steal round,
so no token is dropped and a token's output does not depend on the other
tokens of the call: the kernel computes each slot row on its own (fixed
128-row tiles, a fixed order over D) and folds a token's slots in
ascending slot order, which is expert order; the plain version computes
its products in calls of exactly PLAIN_ROWS rows. So an incremental
prefill gives a one-shot prefill's bits.

Distribution (`apply_moe(..., dist=DistContext(mesh))`, the
reference's `shard_map` branch): tokens stay split over the batch axes and
replicated over "model"; model rank r keeps experts [r E/tp, (r+1) E/tp)
(`moe_local(..., n_local_experts=, local_expert_offset=)`: the router,
the capacity cut and the steal round run over all E experts on the local
token pool, and only the local experts' slots are computed) and their
partial outputs are summed over "model". Expert weights are also stored in
shards over "data" (wi and wg split along D, wo along its last D: the
reference's `moe_pspec`) and gathered whole inside the block. The aux
outputs are replicated: counts summed over the batch axes, the other
values averaged over them (model ranks hold equal values, so this is the
reference's average over every axis). The collectives' backwards
(`launch/collectives.py`) make each rank's gradient its share of the
global loss's: replicated leaves' shares are summed over the batch axes
by the train step, expert shards' over "data" by the gather's backward.

`capacity`, `ich_update_cap_scale`, `_dispatch_positions` and
`dispatch_decisions` are tensor functions held element-identical to the
reference's (and the decisions to `plan_dispatch`'s) by the tests.
"""
from __future__ import annotations

import dataclasses
import types
from typing import Optional

import numpy as np
import torch
from torch import nn

from repro_torch.kernels.ich_moe.ich_moe_bwd import ich_moe_backward
from repro_torch.kernels.shape_only import shape_only
from repro_torch.launch import collectives as C
from repro_torch.launch.mesh import DistContext
from repro_torch.sched.api import LoopScheduler
from repro_torch.sched.defaults import (ICH_EPS, MOE_CAP_SCALE_MAX,
                                        MOE_CAP_SCALE_MIN,
                                        MOE_CAPACITY_FACTOR, MOE_CMAX_FACTOR,
                                        MOE_MIN_CAPACITY)
from repro_torch.sched.moe import expert_capacity, plan_dispatch

from . import layers as L


class MoE(nn.Module):
    """`router` (d, E), `wi`/`wg` (E, d, F), `wo` (E, F, d) and, with
    `cfg.n_shared_experts`, `shared`: the experts every token runs
    (deepseek's), a SwiGLU `layers.MLP` of width n_shared * F (the
    reference's shared experts are SwiGLU whatever `cfg.act`; the moe
    family runs SwiGLU configs only, `models.model._check_family`). The
    reference's leaf names and distributions."""

    def __init__(self, cfg, g: torch.Generator, device=None):
        super().__init__()
        d, f, e = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
        self.router = L.dense_init(g, d, e, device)

        def experts(shape, fan_in):
            w = torch.randn(shape, generator=g, device=device)
            return nn.Parameter(w * fan_in ** -0.5, requires_grad=False)

        self.wi = experts((e, d, f), d)
        self.wg = experts((e, d, f), d)
        self.wo = experts((e, f, d), f)
        if cfg.n_shared_experts:
            self.shared = L.MLP(cfg, g, device,
                                d_ff=cfg.n_shared_experts * f)


# ----------------------------------------------------------------------------
# Layout on a mesh
# ----------------------------------------------------------------------------

def moe_pspec(cfg) -> dict:
    """The routed experts over "model" (expert parallelism) and along D
    over "data", the router replicated, the shared experts as an MLP
    (`repro/models/moe.py:89-99`)."""
    p = {"router": (None, None), "wi": ("model", "data", None),
         "wg": ("model", "data", None), "wo": ("model", None, "data")}
    if cfg.n_shared_experts:
        p["shared"] = {"wi": ("data", "model"), "wg": ("data", "model"),
                       "wo": ("model", "data")}
    return p


_EXPERT_AXES = {k: v for k, v in moe_pspec(
    types.SimpleNamespace(n_shared_experts=0)).items() if k != "router"}


def local_shape(name: str, shape, sizes: dict) -> tuple:
    """The shape on one rank of leaf `name` (`layers.3.moe.wi`,
    `opt.v.layers.1.moe.wg`, ...) under the routed experts' placement
    (`moe_pspec`), `sizes` {"tp": model ranks, "fsdp": data ranks}; a
    leaf that is not a routed expert weight keeps its shape. The whole
    layout of a model is `models.model.param_pspecs`."""
    parts = name.split(".")
    axes = _EXPERT_AXES.get(parts[-1]) if len(parts) >= 2 and \
        parts[-2] == "moe" else None
    if axes is None:
        return tuple(shape)
    split = {"model": sizes.get("tp", 1), "data": sizes.get("fsdp", 1)}
    return tuple(n // split[a] if a else n for n, a in zip(shape, axes))


def check_mesh(cfg, dist: Optional[DistContext]) -> None:
    """Raise ValueError for a mesh the config's experts cannot split
    over: E not a multiple of the model ranks or D of the data ranks."""
    if dist is None or cfg.family != "moe":
        return
    sizes = dist.sizes()
    if cfg.n_experts % sizes["tp"]:
        raise ValueError(f"{cfg.n_experts} experts do not split over "
                         f"{sizes['tp']} {dist.tp_axis!r} ranks")
    if cfg.d_model % sizes["fsdp"]:
        raise ValueError(f"d_model {cfg.d_model} does not split over "
                         f"{sizes['fsdp']} {dist.fsdp_axis!r} ranks")


def capacity(cfg, t_local: int, factor: float = MOE_CAPACITY_FACTOR) -> int:
    """Base per-expert capacity for a local token pool of size t_local."""
    return expert_capacity(t_local, cfg.n_experts, cfg.experts_per_token,
                           factor)


def workers(device) -> int:
    """p of the expert dispatch's schedule: the card's SM count, 2 on the
    CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return torch.cuda.get_device_properties(dev).multi_processor_count
    return 2


# ----------------------------------------------------------------------------
# iCh balancer (paper §3.2 applied to expert load)
# ----------------------------------------------------------------------------

def ich_update_cap_scale(counts: torch.Tensor, cap_scale: torch.Tensor,
                         eps: float = ICH_EPS,
                         step: float = 1.5) -> torch.Tensor:
    """Adapt the per-expert capacity scale with the paper's classification
    (float32): experts loaded above the band mu +- eps*mu grow their scale
    by `step`, those below shrink it (times 1 / step), clipped to
    [MOE_CAP_SCALE_MIN, MOE_CAP_SCALE_MAX]; the total is renormalised
    only when it exceeds the budget E. The total is a left fold, the
    order XLA's CPU reduce takes below 32 elements, so with fewer than 32
    experts the result is the bits of the reference as its jitted train
    step runs it; from 32 on XLA sums in another order and a renormalised
    scale can differ from the reference's in its last bit."""
    counts = torch.as_tensor(counts, dtype=torch.float32)
    cap_scale = torch.as_tensor(cap_scale, dtype=torch.float32,
                                device=counts.device)
    mu = counts.mean()
    delta = eps * mu
    up = counts > mu + delta
    down = counts < mu - delta
    # XLA folds the reference's `cap_scale / step` into a product with the
    # float32 reciprocal of step: the same product here gives its bits
    new = torch.where(up, cap_scale * step,
                      torch.where(down, cap_scale * (1.0 / step), cap_scale))
    new = torch.clamp(new, MOE_CAP_SCALE_MIN, MOE_CAP_SCALE_MAX)
    total = torch.zeros((), dtype=torch.float32, device=new.device)
    for v in new:
        total = total + v
    over = total / float(new.shape[0])
    return torch.where(over > 1.0, new / over, new)


# ----------------------------------------------------------------------------
# Sort-based dispatch with capacity + one steal round
# ----------------------------------------------------------------------------

def _dispatch_positions(experts_flat: torch.Tensor,
                        n_experts: int) -> torch.Tensor:
    """Position of each (token, choice) entry within its expert segment:
    stable argsort, searchsorted segment starts, scattered back."""
    order = torch.argsort(experts_flat, stable=True)
    es = experts_flat[order]
    seg_start = torch.searchsorted(
        es, torch.arange(n_experts, dtype=es.dtype, device=es.device))
    pos_sorted = torch.arange(es.numel(), device=es.device) - seg_start[es]
    pos = torch.empty_like(pos_sorted)
    pos[order] = pos_sorted
    return pos


def dispatch_decisions(e_topk: torch.Tensor, cap_e: torch.Tensor, *,
                       steal: bool = True,
                       counts: Optional[torch.Tensor] = None):
    """The capacity cut and the steal round over the flat (token, choice)
    entries — the reference's in-graph decision pass, which
    `sched.moe.plan_dispatch` mirrors on the host.

    e_topk (T, K) router choices; cap_e (E,) per-expert capacities; counts
    the (E,) router demand (recomputed if absent). Returns (expert, token,
    pos, keep, stolen): final per-entry expert ids (a stolen entry points
    at its steal target), token ids, in-segment dispatch slots, the
    survival mask and the stolen-entry count."""
    T, K = e_topk.shape
    E = cap_e.shape[0]
    dev = e_topk.device
    cap_e = cap_e.long()
    ef = e_topk.reshape(-1).long()
    tf = torch.arange(T, device=dev).repeat_interleave(K)
    pos = _dispatch_positions(ef, E)
    keep = pos < cap_e[ef]
    if steal:
        if counts is None:
            counts = torch.bincount(ef, minlength=E).float()
        slack = torch.clamp(cap_e.float() - counts, min=0.0)
        alt_slack = slack[e_topk.long()]                       # (T, K)
        fallback = e_topk.long()[torch.arange(T, device=dev),
                                 torch.argmax(alt_slack, dim=-1)]
        ef2 = torch.where(keep, ef, fallback[tf])
        used = torch.bincount(ef[keep], minlength=E)
        # rank the stolen entries only: kept ones park on sentinel E + 1
        pos2 = _dispatch_positions(torch.where(keep, E + 1, ef2), E + 2) \
            + used[ef2]
        keep2 = ~keep & (pos2 < cap_e[ef2])
        ef = torch.where(keep2, ef2, ef)
        pos = torch.where(keep2, pos2, pos)
        stolen = keep2.sum()
        keep = keep | keep2
    else:
        stolen = torch.zeros((), dtype=torch.int64, device=dev)
    return ef, tf, pos, keep, stolen


# ----------------------------------------------------------------------------
# The scheduled expert FFN with its gradient
# ----------------------------------------------------------------------------

class MoeExpertsFn(torch.autograd.Function):
    """y (T, D) = the expert FFN of a "moe-dispatch" `op` over its plan,
    each kept entry weighted by its router weight: x (T, D), w_topk (T,
    K) the renormalised top-K weights, wi/wg (E, D, F), wo (E, F, D);
    `entry` (n_slots,) int64 the (token, choice) entry t*K + k of each
    slot of the plan's CSR and `indptr` (E+1,) int32 its expert offsets,
    on x's device. The kernels take float32 only, so the Function casts
    its inputs to float32 and y back to x's dtype (in bfloat16 training
    the products run in float32; the reference runs them in x's dtype).
    Forward: `ich_moe_sharded` through the op over the plan's packed
    combine weights, which are w_topk's values. Backward: `ich_moe_backward` (`csrc/ich_moe_bwd.cu` on
    the card) with g and h recomputed from the kept x; the gradients of
    x, w_topk (zero for dropped entries) and the three weights, each in
    its input's dtype. When x (so dy too) is bfloat16, both go to the
    backward as they are, and its kernels leave out the passes that
    multiply the zero lo parts of their float32 casts."""

    @staticmethod
    def forward(ctx, x, w_topk, wi, wg, wo, op, entry, indptr):
        y = op(x.float().contiguous(), wi.float(), wg.float(), wo.float())
        ctx.op = op
        ctx.save_for_backward(x, w_topk, wi, wg, wo, entry, indptr)
        return y.to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        x, w_topk, wi, wg, wo, entry, indptr = ctx.saved_tensors
        slots = ctx.op.slots
        K = w_topk.shape[1]
        xk, dyk = (x, dy) if x.dtype == dy.dtype == torch.bfloat16 \
            else (x.float(), dy.float())
        dx, dwi, dwg, dwo, dw = ich_moe_backward(
            xk.contiguous(), dyk.contiguous(), wi.float(), wg.float(),
            wo.float(), indptr, (entry // K).int(),
            w_topk.float().reshape(-1)[entry].contiguous(), slots.tok_ptr,
            slots.tok_slot)
        # entries are unique: a plain scatter, no accumulation
        dw_topk = torch.zeros(w_topk.numel(), dtype=torch.float32,
                              device=dw.device).index_put_((entry,), dw)
        return (dx.to(x.dtype), dw_topk.view(w_topk.shape).to(w_topk.dtype),
                dwi.to(wi.dtype), dwg.to(wg.dtype), dwo.to(wo.dtype), None,
                None, None)


class MoeShapeFn(torch.autograd.Function):
    """The expert FFN at shapes alone (fake or meta tensors: the dry run):
    `n` computed slots, forward the shape-only op `moe_fwd`, backward
    `moe_bwd` (`kernels.shape_only`), which count the kernels' own
    operations and launch nothing."""

    @staticmethod
    def forward(ctx, x, w_topk, wi, wg, wo, n):
        ctx.save_for_backward(x, w_topk, wi, wg, wo)
        ctx.n = n
        return torch.ops.repro_torch.moe_fwd(x, wi, wg, wo, n)

    @staticmethod
    def backward(ctx, dy):
        x, w_topk, wi, wg, wo = ctx.saved_tensors
        grads = torch.ops.repro_torch.moe_bwd(x, dy, w_topk, wi, wg, wo,
                                               ctx.n)
        return (*grads, None)


def capacity_full_slots(cfg, T: int, n_local: int, *, dropless: bool,
                        capacity_factor: float = MOE_CAPACITY_FACTOR) -> int:
    """Slots a rank computes under the "capacity-full" plan, the one the
    dry run takes since fake tensors hold no router choices: every local
    expert filled to its capacity (C_max in training, the whole pool T
    dropless), the worst case and what the reference's XLA buffers
    reserve, but never more than the pool's T K entries."""
    cap = T if dropless else capacity_limits(cfg, T, capacity_factor)[1]
    return min(T * cfg.experts_per_token, n_local * cap)


def capacity_limits(cfg, T: int,
                    capacity_factor: float = MOE_CAPACITY_FACTOR) -> tuple:
    """(C_base, C_max) of a pool of T tokens: the base capacity and the
    largest a scale may give (`moe_cmax_factor` times the base)."""
    c_base = capacity(cfg, T, capacity_factor)
    return c_base, max(c_base, int(round(getattr(
        cfg, "moe_cmax_factor", MOE_CMAX_FACTOR) * c_base)))


# ----------------------------------------------------------------------------
# The layer
# ----------------------------------------------------------------------------

def route(p: MoE, x: torch.Tensor, k: int):
    """Router of x (B, S, D): (probs (T, E), w_topk (T, K), e_topk (T, K)),
    T = B*S in (b, s) order — softmax over the float32 logits, top-K,
    weights renormalised to sum 1. Runs per block of TOKEN_BLOCK tokens
    (`layers.by_blocks`): a product's rows change bits with the call's row
    count, and a changed bit can change a top-K choice."""
    def block(xb):
        probs = torch.softmax((xb @ p.router.to(xb.dtype)).float(), dim=-1)
        w, e = torch.topk(probs, k, dim=-1)
        return probs, w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9), e

    probs, w, e = L.by_blocks(block, L.TOKEN_BLOCK, x)
    T = x.shape[0] * x.shape[1]
    return probs.reshape(T, -1), w.reshape(T, k), e.reshape(T, k)


def local_plan(plan, offset: int, n: int):
    """The plan's entries on experts [offset, offset + n), renumbered from
    0: the dispatch a model rank computes (its kept slots are the whole
    plan's slots of those experts, in the same order). The aux values
    (dropped, stolen) stay the whole plan's."""
    if offset == 0 and n == plan.n_experts:
        return plan
    rel = plan.expert.astype(np.int64) - offset
    mine = plan.keep & (rel >= 0) & (rel < n)
    cut = slice(offset, offset + n)
    return dataclasses.replace(
        plan, n_experts=n, expert=np.where(mine, rel, 0).astype(np.int32),
        keep=mine, cap=plan.cap[cut], counts=plan.counts[cut],
        router_counts=plan.router_counts[cut])


def moe_local(cfg, p: MoE, x: torch.Tensor, cap_scale=None, *,
              capacity_factor: float = MOE_CAPACITY_FACTOR,
              steal: bool = True, dropless: bool = False, routing=None,
              n_local_experts: Optional[int] = None,
              local_expert_offset: int = 0, experts=None):
    """MoE forward on a token pool x (T, D). Returns (y (T, D), aux) with
    the reference's aux dict: the Switch load-balance loss, dropped and
    stolen entries, the (E,) router counts and the entry count (float32
    tensors on x's device).

    The router, the capacity cut and the steal round run over all E
    experts; only entries on experts [local_expert_offset,
    local_expert_offset + n_local_experts) (default: all) are computed,
    with `experts` = (wi, wg, wo) of those experts (default p's), so y is
    their part of the output (expert parallelism: the reference's
    `moe_local` under `shard_map`). The expert FFN runs through the
    scheduler: `plan_dispatch` of the router's choices with per-expert
    capacity `cap` -> the local experts' `local_plan` -> `LoopScheduler(
    p=workers(x.device))` -> "moe-dispatch" op -> `MoeExpertsFn`
    (`ich_moe_sharded`; its backward `ich_moe_backward`) when a gradient
    is to be taken, else the op alone: y is x's dtype, and differentiable
    in x, the router (through the combine weights and the aux loss) and
    the experts.
    `dropless` (serving) gives every expert capacity T and no steal;
    otherwise cap = clip(round(C_base * cap_scale), MOE_MIN_CAPACITY,
    C_max), as the reference computes it, with the steal round when
    `steal`. `routing` is `route(p, x_bsd, K)` when the caller has x as
    (B, S, D) (its blocks are then the caller's); by default x is routed
    as one sequence."""
    T, D = x.shape
    E, K = cfg.n_experts, cfg.experts_per_token
    wi, wg, wo = experts if experts is not None else (p.wi, p.wg, p.wo)
    probs, w_topk, e_topk = (routing if routing is not None
                             else route(p, x[None], K))
    if shape_only(x, w_topk):
        return _moe_shapes(cfg, x, probs, w_topk, e_topk, (wi, wg, wo),
                           n_local_experts or E, dropless=dropless,
                           capacity_factor=capacity_factor)
    counts_all = torch.bincount(e_topk.reshape(-1), minlength=E).float()
    aux_loss = E * torch.sum((counts_all / (T * K)) * probs.mean(dim=0))
    if dropless:
        # an expert can hold the whole pool: the cut keeps every entry
        cap = np.full(E, T, np.int32)
        steal = False
    else:
        c_base, c_max = capacity_limits(cfg, T, capacity_factor)
        scale = torch.as_tensor(cap_scale, dtype=torch.float32,
                                device=x.device)
        cap = torch.clamp(torch.round(c_base * scale), MOE_MIN_CAPACITY,
                          c_max).int().cpu().numpy()
    plan = plan_dispatch(e_topk.cpu().numpy(),
                         w_topk.detach().cpu().numpy(), cap=cap, steal=steal)
    mine = local_plan(plan, local_expert_offset, n_local_experts or E)
    op = LoopScheduler(p=workers(x.device), device=x.device,
                       cache_size=0).build("moe-dispatch", mine)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, w_topk, wi, wg, wo)):
        indptr, entry = mine.csr_entries()
        y = MoeExpertsFn.apply(
            x, w_topk, wi, wg, wo, op,
            torch.from_numpy(entry).to(x.device),
            torch.from_numpy(indptr.astype(np.int32)).to(x.device))
    else:
        y = op(x.float().contiguous(), wi.float(), wg.float(),
               wo.float()).to(x.dtype)
    f32 = dict(dtype=torch.float32, device=x.device)
    aux = {"aux_loss": aux_loss,
           "dropped": torch.tensor(float(plan.dropped), **f32),
           "stolen": torch.tensor(float(plan.stolen), **f32),
           "counts": counts_all,
           "entries": torch.tensor(float(T * K), **f32)}
    return y, aux


def _moe_shapes(cfg, x, probs, w_topk, e_topk, experts, n_local: int, *,
                dropless: bool, capacity_factor: float):
    """`moe_local` at shapes alone (the dry run): the aux loss from the
    router as usual (counts by a scatter, not `bincount`, whose size
    would depend on values), the experts through `MoeShapeFn` at
    `capacity_full_slots`; dropped and stolen are zeros."""
    T = x.shape[0]
    E, K = cfg.n_experts, cfg.experts_per_token
    counts_all = torch.zeros(E, dtype=torch.float32, device=x.device)
    counts_all = counts_all.scatter_add(
        0, e_topk.reshape(-1).long(),
        torch.ones(T * K, dtype=torch.float32, device=x.device))
    aux_loss = E * torch.sum((counts_all / (T * K)) * probs.mean(dim=0))
    n = capacity_full_slots(cfg, T, n_local, dropless=dropless,
                            capacity_factor=capacity_factor)
    y = MoeShapeFn.apply(x, w_topk, *experts, n)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    return y, {"aux_loss": aux_loss, "dropped": zero, "stolen": zero,
               "counts": counts_all, "entries": zero + float(T * K)}


def _moe_parallel(cfg, p: MoE, x2, cap_scale, routing, dist: DistContext,
                  **kw):
    """The expert-parallel routed experts on this rank's tokens x2 (T, D):
    the reference's `shard_map` block. Returns (y (T, D) summed over the
    model ranks, aux replicated)."""
    e_loc = cfg.n_experts // dist.tp
    # expert shards gathered whole along D over "data" (backward:
    # reduce-scatter), the expert dimension kept local
    wi, wg, wo = (L.weight(p, leaf, dist, (0,)) for leaf in ("wi", "wg", "wo"))
    model = dist.group(dist.tp_axis)
    probs, w_topk, e_topk = routing
    # x and the combine weights are replicated over "model" and each rank
    # adds only its experts' part of their gradient: summed in backward
    y, aux = moe_local(
        cfg, p, C.to_model(x2, model), cap_scale,
        routing=(probs, C.to_model(w_topk, model), e_topk),
        n_local_experts=e_loc,
        local_expert_offset=dist.index(dist.tp_axis) * e_loc,
        experts=(wi, wg, wo), **kw)
    return C.from_model(y, model), replicate_aux(aux, dist)


def replicate_aux(aux: dict, dist: DistContext) -> dict:
    """The aux values of one rank made equal on all: counts summed over
    the batch axes, the other values averaged over them (the aux loss
    differentiably, `collectives.mean_over`)."""
    batch = dist.group(dist.batch_axes)
    n = dist.dp
    E = aux["counts"].shape[0]
    packed = C.all_reduce(torch.cat([
        aux["counts"], torch.stack([aux[k] for k in
                                    ("dropped", "stolen", "entries")])]),
        batch)
    return {"aux_loss": C.mean_over(aux["aux_loss"], batch),
            "counts": packed[:E],
            **{k: v / n for k, v in zip(("dropped", "stolen", "entries"),
                                        packed[E:])}}


def apply_moe(cfg, p: MoE, x: torch.Tensor, cap_scale=None, *,
              dist: Optional[DistContext] = None, steal: bool = True,
              capacity_factor: float = MOE_CAPACITY_FACTOR,
              dropless: bool = False):
    """MoE block on x (B, S, D) (or (B, 1, D) in decode): the routed
    experts (`moe_local`, routed per block of TOKEN_BLOCK tokens) plus the
    shared experts, also per block. Returns (y (B, S, D), aux).
    `dropless` is the serving mode (`models.model`'s prefill, extend and
    decode). With `dist` x is this rank's batch rows and p's expert
    weights this rank's shards (`models.model.shard_model`): the routed
    experts run expert-parallel (`_moe_parallel`), the shared experts
    tensor-parallel (`layers.MLP`), and aux is replicated."""
    B, S, D = x.shape
    x = x.contiguous()
    kw = dict(capacity_factor=capacity_factor, steal=steal,
              dropless=dropless)
    routing = route(p, x, cfg.experts_per_token)
    if dist is None:
        y, aux = moe_local(cfg, p, x.reshape(B * S, D), cap_scale,
                           routing=routing, **kw)
    else:
        y, aux = _moe_parallel(cfg, p, x.reshape(B * S, D), cap_scale,
                               routing, dist, **kw)
    y = y.reshape(B, S, D)
    if cfg.n_shared_experts:
        y = y + L.by_blocks(lambda xb: p.shared(xb, dist), L.TOKEN_BLOCK, x)
    return y, aux
