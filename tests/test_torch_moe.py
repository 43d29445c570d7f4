"""MoE expert dispatch through both packages: the port's planner, cost
provider and capacity loop against `repro.sched.moe`, and the port's
`MoeDispatchOp` (plain versions, on the CPU) against the reference's op
and Pallas kernel (interpret mode, as tests/test_moe_sched.py runs it) fed
the same lowering through `repro_torch.convert`, plus the bit-identity
bars inside the port.

Tolerances: plans, CSR layouts, schedules, capacity scales and both cost
streams exactly (integer token counts, in float32 for the streams). y at
atol = rtol = 1e-4, the reference's own bar against its numpy oracle
(tests/test_moe_sched.py): the three products sum over D and F in
another order than XLA's. The bridge to the reference's `moe_local` at
2e-4, its own bar (a softmax router and einsum products on that side).
Inside the port y is bit-identical across p, B and refine generations:
each slot is computed in the plan's CSR order and each token's slots are
folded in one fixed order, whatever the lowering. Last, the 3xTF32 split
that the card's kernel runs its products in, modelled in numpy at
OLMoE-1B-7B's widths against float64: it keeps the 1e-4 bars, one TF32
pass does not."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _tf32 import product as _product
from _tf32 import tf32 as _tf32

from repro import sched as RS
from repro.configs import get_arch, reduced
from repro.core.tiling import pack_csr as ref_pack_csr
from repro.kernels.ich_moe.ich_moe import \
    ich_moe_sharded as ref_ich_moe_sharded
from repro.kernels.ich_moe.ref import expert_loads_ref as np_expert_loads_ref
from repro.kernels.ich_moe.ref import moe_dispatch_ref as np_moe_dispatch_ref
from repro.models import moe as MOE
from repro.sched import moe as RM
from repro.sched.kernels import MoeDispatchOp as RefMoeDispatchOp
from repro.sched.kernels import _flat_slot_cost as ref_flat_slot_cost
from repro_torch import convert
from repro_torch import sched as PS
from repro_torch.core.workloads import moe_router
from repro_torch.kernels.ich_moe import ich_moe as K
from repro_torch.kernels.ich_moe.ref import expert_loads_ref, moe_dispatch_ref
from repro_torch.sched import moe as PM

TOL = 1e-4          # y against the reference (see module docstring)
BRIDGE_TOL = 2e-4   # y against the reference's moe_local


def _router(T, E, K_, seed=0, skew=1.2):
    """Zipf-skewed router as tests/test_moe_sched.py draws it."""
    rng = np.random.default_rng(seed)
    pop = np.arange(1, E + 1, dtype=np.float64) ** -float(skew)
    logits = rng.gumbel(size=(T, E)) + 3.0 * np.log(pop)[None]
    e_topk = np.argsort(-logits, axis=1)[:, :K_].astype(np.int32)
    w = rng.random((T, K_)).astype(np.float32) + 0.1
    w /= w.sum(1, keepdims=True)
    return e_topk, w


def _ffn(E, D, F, seed=0):
    rng = np.random.default_rng(seed)
    wi = (rng.standard_normal((E, D, F)) * D ** -0.5).astype(np.float32)
    wg = (rng.standard_normal((E, D, F)) * D ** -0.5).astype(np.float32)
    wo = (rng.standard_normal((E, F, D)) * F ** -0.5).astype(np.float32)
    return wi, wg, wo


def _inputs(T, E, K_, D, F, seed):
    e_topk, w = _router(T, E, K_, seed=seed)
    wi, wg, wo = _ffn(E, D, F, seed=seed)
    x = np.random.default_rng(seed + 100).standard_normal(
        (T, D)).astype(np.float32)
    return e_topk, w, x, wi, wg, wo


def _assert_same_plan(port, ref):
    for f in ("n_tokens", "n_experts", "experts_per_token", "stolen",
              "dropped"):
        assert getattr(port, f) == getattr(ref, f), f
    for f in ("expert", "token", "weight", "pos", "keep", "cap", "counts",
              "router_counts"):
        a, b = getattr(port, f), getattr(ref, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    for a, b in zip(port.csr(), ref.csr()):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------- the planner
@pytest.mark.parametrize("steal", [False, True])
@pytest.mark.parametrize("seed", [0, 7, 42])
def test_plan_dispatch_matches_reference(seed, steal):
    T, E, K_ = 300, 16, 4
    e_topk, w = _router(T, E, K_, seed=seed, skew=1.6)
    scale = np.random.default_rng(seed).uniform(0.25, 2.0, E)
    cap = np.random.default_rng(seed + 1).integers(0, 90, E).astype(np.int32)
    for kw in ({"cap_scale": np.ones(E)}, {"cap_scale": scale},
               {"cap": cap}, {}):
        _assert_same_plan(PM.plan_dispatch(e_topk, w, steal=steal, **kw),
                          RM.plan_dispatch(e_topk, w, steal=steal, **kw))
    # default weights (1/K) and a capacity factor
    _assert_same_plan(
        PM.plan_dispatch(e_topk, steal=steal, capacity_factor=1.0),
        RM.plan_dispatch(e_topk, steal=steal, capacity_factor=1.0))


def test_plan_dispatch_empty_router_and_errors():
    empty = np.zeros((0, 2), np.int64)
    _assert_same_plan(PM.plan_dispatch(empty, np.zeros((0, 2), np.float32)),
                      RM.plan_dispatch(empty, np.zeros((0, 2), np.float32)))
    _assert_same_plan(PM.plan_dispatch(empty, cap=np.full(3, 4, np.int32)),
                      RM.plan_dispatch(empty, cap=np.full(3, 4, np.int32)))
    with pytest.raises(ValueError, match="e_topk"):
        PM.plan_dispatch(np.zeros(4, np.int32))
    with pytest.raises(ValueError, match="weights"):
        PM.plan_dispatch(np.zeros((4, 2), np.int32), np.zeros((4, 3)))
    with pytest.raises(ValueError, match="out of range"):
        PM.plan_dispatch(np.full((4, 2), 5, np.int32),
                         cap=np.full(3, 4, np.int32))


@pytest.mark.parametrize("T,E,K_,factor", [(12, 4, 2, 1.0), (4096, 64, 8,
                                                             1.25),
                                           (3, 64, 1, 1.25), (0, 8, 2, 2.0)])
def test_expert_capacity_matches_reference(T, E, K_, factor):
    assert PM.expert_capacity(T, E, K_, factor) == \
        RM.expert_capacity(T, E, K_, factor)


def test_defaults_equal_reference():
    from repro.sched import defaults as RD
    from repro_torch.sched import defaults as PD
    for name in ("MOE_CAPACITY_FACTOR", "MOE_CMAX_FACTOR",
                 "MOE_MIN_CAPACITY", "MOE_CAP_SCALE_MIN",
                 "MOE_CAP_SCALE_MAX"):
        assert getattr(PD, name) == getattr(RD, name), name


@pytest.mark.parametrize("costs", [np.zeros(4), np.full(6, 7.0),
                                   np.array([1.0, 50.0, 3.0, 0.0, 9.0]),
                                   np.zeros(0)])
def test_cap_scale_from_costs_matches_reference(costs):
    np.testing.assert_array_equal(PM.cap_scale_from_costs(costs),
                                  RM.cap_scale_from_costs(costs))


@pytest.mark.parametrize("seed", [1, 5, 9])
def test_refine_cap_scale_matches_reference(seed):
    rng = np.random.default_rng(seed)
    E = 64
    counts = np.minimum(rng.zipf(1.6, E), 400).astype(np.int64)
    true = counts.astype(np.float64) * rng.uniform(0.5, 2.0, E) + 0.01
    s = PS.LoopScheduler(p=8, cache_size=0, device="cpu").schedule(
        PS.ExpertLoadCosts(counts))
    r = RS.LoopScheduler(p=8, cache_size=0).schedule(
        RS.ExpertLoadCosts(counts))
    for round_ in range(3):
        s, cs = PM.refine_cap_scale(s, true)
        r, rc = RM.refine_cap_scale(r, true)
        assert s.generation == r.generation == round_ + 1
        np.testing.assert_array_equal(s.sizes, counts)  # structural
        np.testing.assert_array_equal(s.costs, r.costs)
        np.testing.assert_array_equal(s.item_id, r.item_id)
        np.testing.assert_array_equal(s.shard().block_perm,
                                      r.shard().block_perm)
        np.testing.assert_array_equal(cs, rc)


def test_expert_load_costs_validation_and_registry():
    assert "moe-dispatch" in PS.registered()
    with pytest.raises(TypeError, match="integer"):
        PS.ExpertLoadCosts(np.ones(4, np.float64))
    with pytest.raises(ValueError, match="non-negative"):
        PS.ExpertLoadCosts(np.array([3, -1], np.int64))
    with pytest.raises(ValueError, match="1-D"):
        PS.ExpertLoadCosts(np.ones((2, 2), np.int64))
    with pytest.raises(ValueError, match="1-D"):
        PS.ExpertLoadCosts(np.zeros(0, np.int64))
    counts = np.array([3, 0, 7], np.int32)
    port, ref = PS.ExpertLoadCosts(counts), RS.ExpertLoadCosts(counts)
    assert port.sizes_are_structural and ref.sizes_are_structural
    np.testing.assert_array_equal(port.sizes(), ref.sizes())
    np.testing.assert_array_equal(port.costs(), ref.costs())
    assert port.fingerprint() == ref.fingerprint()


def test_moe_router_draws_like_the_reference_benchmark():
    # the draw of benchmarks/bench_schedule_build.py:bench_moe_dispatch
    T, E, K_, seed = 500, 64, 8, 7
    rng = np.random.default_rng(seed)
    pop = np.arange(1, E + 1, dtype=np.float64) ** -1.0
    logits = rng.gumbel(size=(T, E)) + np.log(pop)[None]
    e_ref = np.argsort(-logits, axis=1)[:, :K_].astype(np.int32)
    w_ref = (rng.random((T, K_)) + 0.1).astype(np.float32)
    w_ref /= w_ref.sum(1, keepdims=True)
    e_topk, w = moe_router(T, E, K_, seed=seed)
    np.testing.assert_array_equal(e_topk, e_ref)
    np.testing.assert_array_equal(w, w_ref)


# ------------------------------------------------------------ the schedule
@pytest.mark.parametrize("p,R", [(1, 8), (3, 2), (4, 8)])
def test_port_schedule_identical_to_reference(p, R):
    e_topk, w = _router(400, 32, 4, seed=p)
    plan = PM.plan_dispatch(e_topk, w, cap_scale=np.ones(32))
    port = PS.LoopScheduler(p=p, rows_per_tile=R, cache_size=0,
                            device="cpu").build("moe-dispatch", plan)
    ref = RS.LoopScheduler(p=p, rows_per_tile=R, cache_size=0).build(
        "moe-dispatch", RM.plan_dispatch(e_topk, w, cap_scale=np.ones(32)))
    s, r = port.schedule, ref.schedule
    assert s.width == r.width
    for f in ("item_id", "seg_start", "seg_len"):
        np.testing.assert_array_equal(getattr(s.tiles, f),
                                      getattr(r.tiles, f))
    np.testing.assert_array_equal(s.costs, r.costs)
    np.testing.assert_array_equal(port.shards.worker, ref.shards.worker)
    np.testing.assert_array_equal(port.shards.block_perm,
                                  ref.shards.block_perm)
    np.testing.assert_array_equal(port.vals.numpy(), np.asarray(ref.vals))
    np.testing.assert_array_equal(port.cols.numpy(), np.asarray(ref.cols))
    np.testing.assert_array_equal(port.rowid.numpy(), np.asarray(ref.rowid))
    np.testing.assert_array_equal(port.slot_cost.numpy(),
                                  np.asarray(ref.slot_cost))
    # the slot index: one row per segment, CSR bases, every entry once
    base, length = K.slot_layout(s.item_id, plan.counts, s.width,
                                 port.shards.n_tiles_padded)
    T = s.n_tiles
    np.testing.assert_array_equal(length[:T], s.tiles.seg_len)
    indptr, tok, _ = plan.csr()
    live = s.item_id >= 0
    np.testing.assert_array_equal(
        base[:T][live], indptr[s.item_id[live]] + s.tiles.seg_start[live])
    assert not length[T:].any()
    tok_ptr, tok_slot = (port.slots.tok_ptr.numpy(),
                         port.slots.tok_slot.numpy())
    np.testing.assert_array_equal(np.sort(tok_slot), np.arange(tok.size))
    for t in (0, 7, 399):
        mine = tok_slot[tok_ptr[t]:tok_ptr[t + 1]]
        np.testing.assert_array_equal(mine, np.flatnonzero(tok == t))


# --------------------------------------------------------------- the kernel
@pytest.mark.parametrize("p", [1, 2, 4])
def test_op_matches_reference_op_over_the_same_lowering(p):
    """The reference builds and runs its op (interpret mode); the port's op
    is built over the reference's exact lowering bytes."""
    T, E, K_, D, F = 256, 16, 2, 16, 24
    e_topk, w, x, wi, wg, wo = _inputs(T, E, K_, D, F, seed=p)
    plan = RM.plan_dispatch(e_topk, w, cap_scale=np.ones(E))
    ref = RS.LoopScheduler(p=p, rows_per_tile=2, cache_size=0).build(
        "moe-dispatch", plan)
    y_ref = np.asarray(ref(jnp.asarray(x), jnp.asarray(wi), jnp.asarray(wg),
                           jnp.asarray(wo), interpret=True))
    s, shards = ref.schedule, ref.shards
    op = convert.moe_dispatch_op_from_reference(
        item_id=s.item_id, width=s.width, rows_per_tile=s.rows_per_tile,
        worker=shards.worker, block_perm=shards.block_perm,
        superstep=shards.superstep, vals=np.asarray(ref.vals),
        cols=np.asarray(ref.cols), slot_cost=np.asarray(ref.slot_cost),
        counts=plan.counts, n_tokens=T, device="cpu")
    K.reset_launches()
    y = op(x, wi, wg, wo)
    assert y.dtype == torch.float32 and tuple(y.shape) == (T, D)
    np.testing.assert_allclose(y.numpy(), y_ref, atol=TOL, rtol=TOL)
    np.testing.assert_array_equal(op.last_costs.numpy(),
                                  np.asarray(ref.last_costs))
    np.testing.assert_array_equal(op.last_expert_costs.numpy(),
                                  np.asarray(ref.last_expert_costs))
    np.testing.assert_array_equal(op.expert_load(),
                                  plan.counts.astype(np.float64))
    np.testing.assert_array_equal(
        op.last_costs.numpy().sum(axis=1),
        shards.worker_cost(s.tile_cost()).astype(np.float32))
    indptr, tok, wcsr = plan.csr()
    np.testing.assert_allclose(
        y.numpy(), np_moe_dispatch_ref(indptr, tok, wcsr, x, wi, wg, wo),
        atol=TOL, rtol=TOL)
    # on the CPU the wrapper runs the plain version: no kernel launched
    assert K.LAUNCHES == {"ich_moe_sharded": 0}


@pytest.mark.parametrize("p,B", [(1, 1), (2, 4), (4, 8)])
def test_plain_matches_reference_kernel(p, B):
    """The wrappers themselves, on the reference's lowering arrays, with
    split experts (W = 16 against loads up to ~90)."""
    T, E, K_, D, F = 200, 12, 3, 8, 12
    e_topk, w, x, wi, wg, wo = _inputs(T, E, K_, D, F, seed=10 + p)
    plan = RM.plan_dispatch(e_topk, w, cap_scale=np.ones(E))
    s = RS.LoopScheduler(p=p, superstep=B, rows_per_tile=4,
                         cache_size=0).schedule(
        RS.ExpertLoadCosts(plan.counts), width=16)
    shards = s.shard()
    indptr, tok, wcsr = plan.csr()
    vals, cols = ref_pack_csr(indptr, tok, wcsr, s.tiles, pad_tiles_to=B)
    rowid = shards.shard_item_id(s.tiles)
    blkid = shards.kernel_block_ids()
    sc = ref_flat_slot_cost(s, shards.n_tiles_padded)
    y_ref, c_ref, e_ref = ref_ich_moe_sharded(
        jnp.asarray(vals), jnp.asarray(cols), jnp.asarray(rowid),
        jnp.asarray(blkid), jnp.asarray(x), jnp.asarray(wi), jnp.asarray(wg),
        jnp.asarray(wo), p, B, slot_cost=jnp.asarray(sc), interpret=True)
    slots = K.moe_slots(s.item_id, plan.counts, cols, T, "cpu")
    t = torch.from_numpy
    y, c, ec = K.ich_moe_sharded(
        t(vals), t(cols), t(rowid), t(blkid), t(x), t(wi), t(wg), t(wo), p,
        B, slots, slot_cost=t(sc))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), atol=TOL,
                               rtol=TOL)
    np.testing.assert_array_equal(c.numpy(), np.asarray(c_ref))
    np.testing.assert_array_equal(ec.numpy(), np.asarray(e_ref))
    assert torch.equal(K.ich_moe_sharded(
        t(vals), t(cols), t(rowid), t(blkid), t(x), t(wi), t(wg), t(wo), p,
        B, slots), y)


def test_sharded_bit_identical_across_lowerings():
    """p in {1, 2, 4} x B in {1, 4, 8} and two tile widths give the same y
    bit for bit (p = 1, B = 1 is the sequential walk); the cost streams
    always sum to the plan."""
    T, E, K_, D, F = 240, 16, 4, 8, 16
    e_topk, w, x, wi, wg, wo = _inputs(T, E, K_, D, F, seed=3)
    plan = PM.plan_dispatch(e_topk, w, cap_scale=np.ones(E))
    ys = []
    for p in (1, 2, 4):
        for B in (1, 4, 8):
            for width in (None, 16):
                op = PS.LoopScheduler(p=p, superstep=B, rows_per_tile=2,
                                      cache_size=0, device="cpu").build(
                    "moe-dispatch", plan, width=width)
                ys.append(op(x, wi, wg, wo))
                np.testing.assert_array_equal(
                    op.expert_load(), plan.counts.astype(np.float64))
                np.testing.assert_array_equal(
                    op.last_costs.numpy().sum(axis=1),
                    op.shards.worker_cost(
                        op.schedule.tile_cost()).astype(np.float32))
    assert all(torch.equal(y, ys[0]) for y in ys[1:])


def test_observe_refine_keeps_dispatch_and_bits():
    T, E, K_, D, F = 200, 16, 2, 16, 24
    e_topk, w, x, wi, wg, wo = _inputs(T, E, K_, D, F, seed=2)
    plan = PM.plan_dispatch(e_topk, w, cap_scale=np.ones(E))
    scheduler = PS.LoopScheduler(p=4, rows_per_tile=2, cache_size=0,
                                 device="cpu")
    op = scheduler.build("moe-dispatch", plan)
    y0 = op(x, wi, wg, wo)
    refined = op.observe().refine()
    assert refined.generation == 1
    np.testing.assert_array_equal(refined.sizes, plan.counts)  # structural
    op2 = PS.get("moe-dispatch").build(refined, plan, device="cpu")
    assert torch.equal(op2(x, wi, wg, wo), y0)
    np.testing.assert_array_equal(op2.expert_load(), op.expert_load())
    # the closed capacity loop: refined load -> next plan -> rebuilt op
    s, cap_scale = PM.refine_cap_scale(op.schedule, op.expert_load())
    r, r_scale = RM.refine_cap_scale(
        RS.LoopScheduler(p=4, rows_per_tile=2, cache_size=0).schedule(
            RS.ExpertLoadCosts(plan.counts)), op.expert_load())
    np.testing.assert_array_equal(cap_scale, r_scale)
    plan2 = PM.plan_dispatch(e_topk, w, cap_scale=cap_scale)
    op3 = scheduler.build("moe-dispatch", plan2)
    op3(x, wi, wg, wo)
    np.testing.assert_array_equal(op3.expert_load(),
                                  plan2.counts.astype(np.float64))


def test_zero_admitted_tokens_is_a_noop():
    plan = PM.plan_dispatch(np.zeros((0, 2), np.int64),
                            np.zeros((0, 2), np.float32))
    K.reset_launches()
    op = PS.LoopScheduler(p=4, device="cpu").build("moe-dispatch", plan)
    E = plan.n_experts
    assert op.n_tiles > 0  # a zero-count expert still owns a slot
    y = op(np.zeros((0, 8), np.float32), np.zeros((E, 8, 16), np.float32),
           np.zeros((E, 8, 16), np.float32), np.zeros((E, 16, 8), np.float32))
    assert tuple(y.shape) == (0, 8) and y.dtype == torch.float32
    np.testing.assert_array_equal(op.expert_load(), np.zeros(E))
    assert op.last_costs.shape == op.shards.block_perm.shape
    assert not op.last_costs.any()
    assert K.LAUNCHES == {"ich_moe_sharded": 0}


def test_zero_count_experts_and_unrouted_tokens():
    # experts 5..7 receive nothing and tokens 0..9 keep no entry
    T, E, D, F = 40, 8, 4, 6
    e_topk = np.stack([np.arange(T) % 5, (np.arange(T) + 1) % 5],
                      axis=1).astype(np.int32)
    cap = np.array([0, 9, 9, 9, 9, 0, 0, 0], np.int32)
    plan = PM.plan_dispatch(e_topk, cap=cap, steal=False)
    wi, wg, wo = _ffn(E, D, F, seed=4)
    x = np.random.default_rng(4).standard_normal((T, D)).astype(np.float32)
    op = PS.LoopScheduler(p=2, rows_per_tile=2, device="cpu").build(
        "moe-dispatch", plan)
    y = op(x, wi, wg, wo)
    indptr, tok, wcsr = plan.csr()
    np.testing.assert_allclose(
        y.numpy(), np_moe_dispatch_ref(indptr, tok, wcsr, x, wi, wg, wo),
        atol=TOL, rtol=TOL)
    unrouted = np.setdiff1d(np.arange(T), tok)
    assert unrouted.size and not y.numpy()[unrouted].any()
    np.testing.assert_array_equal(op.expert_load(),
                                  plan.counts.astype(np.float64))


def test_oracles_match_reference_oracles():
    T, E, K_, D, F = 120, 8, 2, 8, 12
    e_topk, w, x, wi, wg, wo = _inputs(T, E, K_, D, F, seed=6)
    plan = PM.plan_dispatch(e_topk, w, cap_scale=np.ones(E))
    indptr, tok, wcsr = plan.csr()
    t = torch.from_numpy
    np.testing.assert_allclose(
        moe_dispatch_ref(indptr, tok, wcsr, t(x), t(wi), t(wg), t(wo))
        .numpy(), np_moe_dispatch_ref(indptr, tok, wcsr, x, wi, wg, wo),
        atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(expert_loads_ref(indptr).numpy(),
                                  np_expert_loads_ref(indptr))


def test_bridge_to_reference_moe_local():
    """At equal capacity the port's scheduled op reproduces the reference's
    in-graph layer: same router, capacities and combine weights."""
    cfg = reduced(get_arch("olmoe-1b-7b"), n_experts=8, experts_per_token=2,
                  d_model=32, moe_d_ff=32)
    E, K_ = cfg.n_experts, cfg.experts_per_token
    T = 96
    p = MOE.init_moe(jax.random.PRNGKey(0), cfg)
    p["router"] = p["router"].at[:, 0].add(2.0)  # skew the load
    x = jax.random.normal(jax.random.PRNGKey(1), (T, cfg.d_model),
                          dtype=jnp.float32)
    y_model, aux = MOE.moe_local(cfg, p, x, jnp.ones((E,)),
                                 capacity_factor=1.0)
    probs = jax.nn.softmax((x @ p["router"]).astype(jnp.float32), -1)
    w_topk, e_topk = jax.lax.top_k(probs, K_)
    w_topk = w_topk / jnp.maximum(w_topk.sum(-1, keepdims=True), 1e-9)
    c_base = MOE.capacity(cfg, T, 1.0)
    cap_e = np.clip(np.round(c_base * np.ones(E)), 4,
                    max(c_base, int(round(2.0 * c_base)))).astype(np.int32)
    plan = PM.plan_dispatch(np.asarray(e_topk), np.asarray(w_topk),
                            cap=cap_e)
    assert plan.dropped == int(aux["dropped"])
    assert plan.stolen == int(aux["stolen"])
    op = PS.LoopScheduler(p=2, device="cpu").build("moe-dispatch", plan)
    y = op(np.asarray(x), *(np.asarray(p[k], np.float32)
                            for k in ("wi", "wg", "wo")))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_model),
                               atol=BRIDGE_TOL, rtol=BRIDGE_TOL)
    np.testing.assert_array_equal(op.expert_load(),
                                  plan.counts.astype(np.float64))
    # and the reference's scheduled op on the same plan agrees
    ref = RefMoeDispatchOp(RS.LoopScheduler(p=2).schedule(
        RS.ExpertLoadCosts(plan.counts)), plan)
    np.testing.assert_allclose(
        y.numpy(), np.asarray(ref(x, *(p[k].astype(jnp.float32)
                                       for k in ("wi", "wg", "wo")),
                                  interpret=True)), atol=TOL, rtol=TOL)


def test_wrappers_and_op_refuse_bad_inputs():
    T, E, K_, D, F = 64, 8, 2, 4, 6
    e_topk, w, x, wi, wg, wo = _inputs(T, E, K_, D, F, seed=8)
    plan = PM.plan_dispatch(e_topk, w, cap_scale=np.ones(E))
    op = PS.LoopScheduler(p=2, device="cpu").build("moe-dispatch", plan)
    with pytest.raises(ValueError, match="x must be"):
        op(x[:-1], wi, wg, wo)
    with pytest.raises(ValueError, match="expert weights"):
        op(x, wi[:-1], wg, wo)
    with pytest.raises(ValueError, match="lies on"):
        op(torch.from_numpy(x).to("meta"), wi, wg, wo)
    with pytest.raises(ValueError, match="shard layout"):
        K.ich_moe_sharded(op.vals, op.cols, op.rowid[:-1], op.blkid,
                          torch.from_numpy(x), torch.from_numpy(wi),
                          torch.from_numpy(wg), torch.from_numpy(wo), 2,
                          op.superstep, op.slots)
    with pytest.raises(ValueError, match="all on CUDA"):
        K.ich_moe_sharded(op.vals, op.cols, op.rowid, op.blkid,
                          torch.from_numpy(x).to("meta"),
                          torch.from_numpy(wi), torch.from_numpy(wg),
                          torch.from_numpy(wo), 2, op.superstep, op.slots)
    with pytest.raises(ValueError, match="do not match"):
        convert.moe_dispatch_op_from_reference(
            item_id=op.schedule.item_id, width=op.schedule.width,
            rows_per_tile=op.schedule.rows_per_tile,
            worker=op.shards.worker, block_perm=op.shards.block_perm,
            superstep=op.superstep, vals=op.vals.numpy(),
            cols=op.cols.numpy(), slot_cost=op.slot_cost.numpy(),
            counts=plan.counts * 3, n_tokens=T, device="cpu")
    with pytest.raises(ValueError, match="token ids"):
        K.token_slots(np.array([0, 5]), 4)
    with pytest.raises(ValueError, match="ascending"):
        K.slot_layout(np.array([[1, 0]], np.int32), np.array([3, 3]), 4, 1)


# ---------------------------------- the 3xTF32 split of the card's products
# csrc/ich_moe.cu runs both products on the tensor cores in the 3xTF32 split
# (csrc/mma_tf32.cuh); tests/_tf32.py models it in numpy. These tests hold
# the model at OLMoE-1B-7B's widths against float64.
MOE_BAR = 1e-4     # chip_smoke.py's bars: kernel == plain, and vs float64


def _olmoe_expert(M=256, D=2048, F=1024, seed=0):
    """M token rows and one expert's weights at OLMoE-1B-7B's widths, scaled
    by fan-in as chip_smoke.py draws them."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, D)).astype(np.float32)
    wi, wg = ((rng.standard_normal((D, F)) * D ** -0.5).astype(np.float32)
              for _ in range(2))
    wo = (rng.standard_normal((F, D)) * F ** -0.5).astype(np.float32)
    return x, wi, wg, wo


def test_tf32_rounding_is_round_to_nearest_ties_away():
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)                 # TF32's step at 1.0
    v = np.array([1 + 2.0 ** -11, 1 + 2.0 ** -11 - 2.0 ** -23,
                  -(1 + 2.0 ** -11), 1 + 3 * 2.0 ** -11, 3.0], np.float32)
    np.testing.assert_array_equal(
        _tf32(v), np.array([one + ulp, one, -(one + ulp), one + 2 * ulp,
                            3.0], np.float32))
    # hi + lo keeps ~22 bits of every float32
    w = np.random.default_rng(0).standard_normal(10_000).astype(np.float32)
    hi = _tf32(w)
    lo = _tf32(w - hi)
    assert not (hi.view(np.uint32) & 0x1FFF).any()
    assert not (lo.view(np.uint32) & 0x1FFF).any()
    rest = np.abs(w.astype(np.float64) - hi - lo)
    assert np.all(rest <= 2.0 ** -22 * np.abs(w))


@pytest.mark.parametrize("product", ["up", "down"])
def test_3xtf32_product_keeps_the_float32_bar(product):
    """One product at OLMoE's depth (up: K = D = 2048, down: K = F = 1024):
    the 3xTF32 split stays within 1e-4 of float64 (allclose, as kernel ==
    plain is held) and far under 1e-4 of each element's sum of |terms|;
    one TF32 pass breaks the allclose bar."""
    x, wi, wg, wo = _olmoe_expert()
    if product == "up":
        a, b = x, wg
    else:
        g = x.astype(np.float64) @ wg
        a = (g / (1.0 + np.exp(-g)) * (x.astype(np.float64) @ wi)).astype(
            np.float32)
        b = wo
    y64 = a.astype(np.float64) @ b.astype(np.float64)
    terms = np.abs(a).astype(np.float64) @ np.abs(b).astype(np.float64)
    three, one = _product(a, b, 3), _product(a, b, 1)
    assert np.allclose(three, y64, rtol=MOE_BAR, atol=MOE_BAR)
    assert np.max(np.abs(three - y64) / terms) < MOE_BAR / 100
    assert not np.allclose(one, y64, rtol=MOE_BAR, atol=MOE_BAR)


def test_3xtf32_expert_ffn_keeps_the_host_bar_one_pass_does_not():
    """The expert FFN at OLMoE's widths, y = (silu(x.wg) * (x.wi)) . wo,
    held as chip_smoke.py holds the card's y against float64: within 1e-4
    of each element's sum of |terms| of the last product. With the 3xTF32
    split in every product it holds with a wide margin; with one TF32 pass
    it does not."""
    x, wi, wg, wo = _olmoe_expert()
    X = x.astype(np.float64)
    g64 = X @ wg
    a64 = g64 / (1.0 + np.exp(-g64)) * (X @ wi)
    y64 = a64 @ wo
    terms = np.abs(a64) @ np.abs(wo.astype(np.float64))

    def ffn(passes):
        g = _product(x, wg, passes)
        a = (g / (1.0 + np.exp(-g)) * _product(x, wi, passes)).astype(
            np.float32)
        return _product(a, wo, passes)
    rel3 = np.max(np.abs(ffn(3) - y64) / terms)
    rel1 = np.max(np.abs(ffn(1) - y64) / terms)
    assert rel3 < MOE_BAR / 100
    assert rel1 > MOE_BAR
