"""The port's discrete-event simulator, its fault injection and the
`Schedule`'s simulator surface against the reference (`repro.core.simulator`,
`repro.robust.faults`, `repro.sched.api`): the same seeded numpy costs go
through both packages and every result is compared.

Tolerance: exact wherever the port is compared with the reference — both
run the same float64 and integer operations in the same order, so
makespans, `worker_busy`, chunk logs, assignments, fault logs and refined
costs must be equal, not close. Two checks compare the simulator with
other arithmetic and carry the reference's own tolerances: per-worker
dispatched work against `WorkerShards.worker_cost` (a float64 bincount of
tile costs against differences of a cumulative sum: 1e-12 relative,
tests/test_sharding.py uses 1e-9 absolute), and the MoE op's float32
cost stream against the float64 replay (`pytest.approx`'s 1e-6, as
tests/test_moe_sched.py holds it)."""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

import _paper_grid as GRID
from repro import sched as RS
from repro.core import policies as RP
from repro.core import simulator as RSIM
from repro.core import tiling as RT
from repro.robust import faults as RF
from repro_torch import sched as PS
from repro_torch.core import policies as PP
from repro_torch.core import simulator as PSIM
from repro_torch.core import tiling as PT
from repro_torch.core import workloads as PW
from repro_torch.robust import faults as PF
from repro_torch.sched import moe as PM


def _zero(S):
    return S.SimParams(dispatch_overhead=0.0, local_dispatch_overhead=0.0,
                       speed_jitter=0.0)


PARAMS = {"zero": (_zero(RSIM), _zero(PSIM)),
          "default": (RSIM.SimParams(), PSIM.SimParams()),
          "jitter": (RSIM.SimParams(speed_jitter=0.2, seed=3),
                     PSIM.SimParams(speed_jitter=0.2, seed=3))}


def _costs(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    costs = rng.uniform(0.5, 5.0, n)
    costs[rng.choice(n, max(n // 40, 1), replace=False)] += \
        rng.exponential(80.0, max(n // 40, 1))
    return costs


def _assert_same(a, b) -> None:
    """Two SimResults (or ExecStats) equal field for field."""
    for f in dataclasses.fields(a):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if isinstance(va, np.ndarray) or isinstance(vb, np.ndarray):
            assert va is not None and vb is not None, f.name
            np.testing.assert_array_equal(va, vb, err_msg=f.name)
        else:
            assert va == vb, f.name


def _schedules(costs, p, B=4, R=8):
    ref = RS.LoopScheduler(p=p, superstep=B, rows_per_tile=R,
                           cache_size=0).schedule(RS.ExplicitCosts(costs))
    port = PS.LoopScheduler(p=p, superstep=B, rows_per_tile=R, cache_size=0,
                            device="cpu").schedule(costs)
    np.testing.assert_array_equal(ref.item_id, port.item_id)
    return ref, port


# ------------------------------------------------------------ simulate()
@pytest.mark.parametrize("p", [4, 28])
def test_paper_policy_grid_matches_reference(p):
    ref, port = RP.paper_policy_grid(p), PP.paper_policy_grid(p)
    assert [dataclasses.astuple(x) for x in ref] == \
        [dataclasses.astuple(x) for x in port]


@pytest.mark.parametrize("params", list(PARAMS))
@pytest.mark.parametrize("p", [4, 28])
def test_simulate_matches_reference_for_every_paper_policy(p, params):
    costs = _costs(1500, seed=p)
    stale = costs[::-1].copy()  # binlpt's workload estimate, out of date
    rp, pp = PARAMS[params]
    for pol_r, pol_p in zip(RP.paper_policy_grid(p), PP.paper_policy_grid(p)):
        kw = dict(record_assignment=True, record_chunks=True,
                  estimate=stale if pol_r.name == "binlpt" else None)
        _assert_same(RSIM.simulate(costs, p, pol_r, rp, **kw),
                     PSIM.simulate(costs, p, pol_p, pp, **kw))


def test_paper_metrics_match_reference():
    costs = _costs(800, seed=5)
    for f in ("speedup", "best_time_over_grid"):
        for name in ("ich", "stealing", "binlpt"):
            assert getattr(RSIM, f)(costs, 8, name) == \
                getattr(PSIM, f)(costs, 8, name)
    assert RSIM.eps_sensitivity(costs, 8) == PSIM.eps_sensitivity(costs, 8)
    assert RSIM.worst_stealing(costs, 8) == PSIM.worst_stealing(costs, 8)


FAMILIES = ("synth/exp_dec", "kmeans", "spmv/wikipedia",
            "moe-dispatch/zipf1.4")


@pytest.mark.parametrize("family", FAMILIES)
def test_paper_grid_family_through_the_port_simulator(family):
    """tests/_paper_grid.py's Table-2 sweep (eq.-9 speedups, iCh's rank and
    gap to the best) run through the port's simulator and policy grid
    gives the reference's numbers."""
    loops, ests, p = GRID.families(GRID.SMOKE)[family]

    def best(p_, method):
        return min(sum(PSIM.simulate(np.asarray(c, np.float64), p_, pol,
                                     PSIM.SimParams(),
                                     estimate=None if ests is None
                                     else ests[i]).makespan
                       for i, c in enumerate(loops))
                   for pol in PP.paper_policy_grid(p_) if pol.name == method)

    t1 = best(1, "guided")
    port = {m: t1 / best(p, m) for m in GRID.METHODS}
    ref = GRID.speedup_table(loops, p, ests)
    assert port == ref
    assert GRID.rank_of_ich(port) == GRID.rank_of_ich(ref)
    assert GRID.gap_to_best(port) == GRID.gap_to_best(ref)


# ---------------------------------------------- the Schedule's replays
@pytest.mark.parametrize("p,B", [(1, 1), (3, 2), (8, 4)])
def test_replay_and_replay_sharded_match_reference(p, B):
    costs = _costs(400, seed=10 * p + B)
    ref, port = _schedules(costs, p, B)
    np.testing.assert_array_equal(ref.unit_ranges(), port.unit_ranges())
    np.testing.assert_array_equal(ref.unit_costs(), port.unit_costs())
    np.testing.assert_array_equal(ref.unit_to_item(), port.unit_to_item())
    np.testing.assert_array_equal(ref.tile_work(), port.tile_work())
    assert ref.imbalance() == port.imbalance()
    assert port.lower() is port.tiles
    for rp, pp in PARAMS.values():
        _assert_same(ref.replay(params=rp), port.replay(params=pp))
        _assert_same(ref.replay_sharded(params=rp),
                     port.replay_sharded(params=pp))
        _assert_same(ref.simulate(params=rp, record_chunks=True),
                     port.simulate(params=pp, record_chunks=True))
    # the sharded replay runs every tile on its worker: per-worker busy
    # time is the partition's per-worker cost, the makespan its max
    rep = port.replay_sharded(params=_zero(PSIM))
    wc = port.shard().worker_cost(port.tile_cost())
    np.testing.assert_allclose(rep.worker_busy, wc, rtol=1e-12)
    assert rep.makespan == pytest.approx(float(wc.max()), rel=1e-12)


@pytest.mark.parametrize("sharded", [False, True])
def test_replay_refined_matches_reference(sharded):
    costs = _costs(300, seed=7)
    truth = costs * np.random.default_rng(8).uniform(0.5, 2.0, costs.size)
    ref, port = _schedules(costs, 4)
    _assert_same(ref.replay_refined(truth, sharded=sharded,
                                    record_chunks=True),
                 port.replay_refined(truth, sharded=sharded,
                                     record_chunks=True))
    with pytest.raises(ValueError, match="true costs"):
        port.replay_refined(truth[:-1])


@pytest.mark.parametrize("kind", ["replay", "replay_sharded", "simulate"])
def test_observe_simresult_refines_like_the_reference(kind):
    costs = _costs(250, seed=11)
    ref, port = _schedules(costs, 4)
    truth = costs * np.random.default_rng(12).uniform(0.5, 2.0, costs.size)
    rr = RSIM.simulate(truth, 4, RP.ich(), record_chunks=True) \
        if kind == "simulate" else getattr(ref, kind)()
    pr = PSIM.simulate(truth, 4, PP.ich(), record_chunks=True) \
        if kind == "simulate" else getattr(port, kind)()
    r2 = ref.observe(rr).refine()
    p2 = port.observe(pr).refine()
    np.testing.assert_array_equal(r2.costs, p2.costs)
    np.testing.assert_array_equal(r2.item_id, p2.item_id)
    assert r2.generation == p2.generation == 1
    with pytest.raises(ValueError, match="chunk_log"):
        port.observe(port.replay(record_chunks=False))


# ------------------------------------------------------- fault injection
PLANS = {
    "death": dict(seed=7, deaths=((2, 3),)),
    "stall": dict(seed=5, stalls=((1, 2, 40.0),)),
    "chaos": dict(seed=3, deaths=((0, 1),), stalls=((3, 0, 25.0),),
                  flaky_frac=0.05, cost_noise=0.3),
}


@pytest.mark.parametrize("plan", list(PLANS))
@pytest.mark.parametrize("policy", ["ich", "stealing", "dynamic"])
def test_replay_faulty_matches_reference(plan, policy):
    costs = _costs(500, seed=13)
    ref, port = _schedules(costs, 4)
    kw = {"ich": {}, "stealing": {"chunk": 2}, "dynamic": {"chunk": 4}}
    rr = ref.replay_faulty(RF.FaultPlan(**PLANS[plan]),
                           policy=getattr(RP, policy)(**kw[policy]),
                           record_chunks=True, record_assignment=True)
    pr = port.replay_faulty(PF.FaultPlan(**PLANS[plan]),
                            policy=getattr(PP, policy)(**kw[policy]),
                            record_chunks=True, record_assignment=True)
    assert isinstance(pr, PF.FaultReport)
    _assert_same(rr.faulty, pr.faulty)
    _assert_same(rr.clean, pr.clean)
    assert rr.inflation == pr.inflation
    assert (pr.faulty.assignment >= 0).all()  # every item dispatched


def test_fault_plan_streams_and_serialization_match_reference():
    kw = dict(seed=9, deaths=((1, 2),), stalls=((0, 1, 3.0),),
              flaky_frac=0.1, flaky_failures=2, poison=(17,), cost_noise=0.4)
    r, p = RF.FaultPlan(**kw), PF.FaultPlan(**kw)
    np.testing.assert_array_equal(r.flaky_items(400), p.flaky_items(400))
    costs = _costs(400, seed=1)
    np.testing.assert_array_equal(r.corrupt_costs(costs),
                                  p.corrupt_costs(costs))
    np.testing.assert_array_equal(r.death_after(4), p.death_after(4))
    assert r.to_json() == p.to_json()
    assert r.fingerprint() == p.fingerprint()
    assert PF.FaultPlan.from_json(p.to_json()) == p
    with pytest.raises(ValueError):
        PF.FaultPlan(seed=0, deaths=((9, 1),)).validate_workers(4)
    with pytest.raises(PF.FaultError):
        PSIM.simulate(costs, 2, PP.ich(),
                      faults=PF.FaultPlan(deaths=((0, 1), (1, 1))))


# ------------------------------------------------ the MoE cross-check
@pytest.mark.parametrize("p", [2, 4])
def test_moe_kernel_costs_match_sharded_replay(p):
    """The cross-check PR 13 left out (tests/test_moe_sched.py:219-224) on
    the port's `moe-dispatch` op: the zero-overhead sharded replay's
    makespan is the partition's max per-worker cost, the number the
    kernel's cost stream sums to."""
    T, E, K, D, F = 96, 8, 2, 8, 12
    e_topk, w = PW.moe_router(T, E, K, seed=p)
    plan = PM.plan_dispatch(e_topk, w)
    rng = np.random.default_rng(p)
    x = rng.standard_normal((T, D)).astype(np.float32)
    wi, wg = (rng.standard_normal((E, D, F)).astype(np.float32)
              for _ in range(2))
    wo = rng.standard_normal((E, F, D)).astype(np.float32)
    op = PS.LoopScheduler(p=p, rows_per_tile=2, cache_size=0,
                          device="cpu").build("moe-dispatch", plan)
    op(x, wi, wg, wo)
    emitted_w = op.last_costs.numpy()
    shards = op.schedule.shard()
    wc = shards.worker_cost(op.schedule.tile_cost())
    np.testing.assert_array_equal(emitted_w.sum(axis=1),
                                  wc.astype(np.float32))
    rep = op.schedule.replay_sharded(params=_zero(PSIM))
    assert rep.makespan == pytest.approx(float(wc.max()))
    assert rep.makespan == pytest.approx(float(emitted_w.sum(axis=1).max()))
    np.testing.assert_allclose(rep.worker_busy, wc, rtol=1e-12)


# ------------------------------------------------ tiling additions
def test_tiling_additions_match_reference():
    sizes = np.random.default_rng(3).integers(0, 40, 300)
    ref, port = RT.build_schedule(sizes), PT.build_schedule(sizes)
    np.testing.assert_array_equal(ref.slot_ranges(), port.slot_ranges())
    costs = _costs(300, seed=2)
    np.testing.assert_array_equal(ref.unit_costs(costs, sizes),
                                  port.unit_costs(costs, sizes))
    cov = PT.coverage_counts(port, sizes)
    np.testing.assert_array_equal(cov, RT.coverage_counts(ref, sizes))
    assert (cov == 1).all()
    for bp in ([[0, 2, -1], [1, -1, -1]], [[3, -1], [-1, -1]]):
        bp = np.asarray(bp, np.int32)
        r = RT.shards_from_block_perm(bp, ref.n_tiles, 2)
        q = PT.shards_from_block_perm(bp, port.n_tiles, 2)
        np.testing.assert_array_equal(r.worker, q.worker)
        np.testing.assert_array_equal(r.block_perm, q.block_perm)
        np.testing.assert_array_equal(r.perm, q.perm)
    with pytest.raises(ValueError, match="more than once"):
        PT.shards_from_block_perm(np.array([[1, 1]], np.int32),
                                  port.n_tiles, 2)


def test_workload_generators_match_reference():
    from repro.core import workloads as RW
    for f, args in (("synth_linear", (500,)), ("synth_exp", (500, True)),
                    ("synth_exp", (500, False)), ("lavamd_costs", (4,))):
        np.testing.assert_array_equal(getattr(RW, f)(*args),
                                      getattr(PW, f)(*args))
    for kind in ("uniform", "scale_free"):
        rl, rs = RW.bfs_levels(kind, 6000, seed=2)
        pl, ps_ = PW.bfs_levels(kind, 6000, seed=2)
        assert len(rl) == len(pl)
        for a, b in zip(rl, pl):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(rs, ps_)
    nnz = np.array([0.0, 3.0, 9.0])
    assert RW.achieved_stats(nnz) == PW.achieved_stats(nnz)


def test_remaining_tokens_costs_match_reference():
    rem = np.array([5, 0, 17, 3])
    r, p = RS.RemainingTokensCosts(rem), PS.RemainingTokensCosts(rem)
    assert r.fingerprint() == p.fingerprint()
    np.testing.assert_array_equal(r.sizes(), p.sizes())
    np.testing.assert_array_equal(r.costs(), p.costs())
    assert p.sizes_are_structural
    for bad, err in ((np.array([1.5]), TypeError),
                     (np.array([-1]), ValueError),
                     (np.zeros(0, np.int64), ValueError)):
        with pytest.raises(err):
            PS.RemainingTokensCosts(bad)
