"""The port's threaded self-scheduling executor (`repro_torch.core.executor`)
and the `Schedule`'s executor surface against the reference
(`repro.core.executor`, `repro.sched.api`).

Threaded runs interleave differently every time, so they are held to the
executor's invariant — every item or work unit runs exactly once — and
the deterministic driver (`deterministic=True`, one dispatch-or-steal
attempt per worker per turn, single thread) is held to the reference's
chunk, steal and fault traces exactly. `observe(ExecStats)` is compared on
stats carrying the same fixed seconds in both packages, so the refined
costs must be equal. Retries and injected stalls go through `sleep_fn`,
so no test waits on the wall clock for them; the watchdog test waits only
for the watchdog's own 20 ms heartbeat budget. Tolerance: exact
everywhere (integer traces, float64 refined costs from the same
operations in the same order)."""
from __future__ import annotations

import threading

import numpy as np
import pytest
import torch

from repro import sched as RS
from repro.core import executor as RE
from repro.core import policies as RP
from repro.robust import faults as RF
from repro_torch import sched as PS
from repro_torch.core import executor as PE
from repro_torch.core import policies as PP
from repro_torch.core import simulator as PSIM
from repro_torch.robust import faults as PF

POLICIES = {  # name -> constructor kwargs, the same in both packages
    "dynamic": {"chunk": 3}, "guided": {"chunk": 2}, "taskloop": {},
    "static": {}, "binlpt": {"nchunks": 16}, "stealing": {"chunk": 2},
    "ich": {},
}


def _policy(pkg, name, p):
    kw = dict(POLICIES[name])
    if name == "taskloop":
        kw = {"num_tasks": p}
    return getattr(pkg, name)(**kw)


class _Hits:
    """A body counting how often each index ran."""

    def __init__(self, n):
        self.hits = np.zeros(n, np.int64)
        self._lock = threading.Lock()

    def __call__(self, i):
        with self._lock:
            self.hits[i] += 1


def _costs(n, seed):
    rng = np.random.default_rng(seed)
    costs = rng.uniform(1.0, 6.0, n)
    costs[rng.choice(n, 5, replace=False)] += 60.0
    return costs


def _schedules(costs, p=4):
    ref = RS.LoopScheduler(p=p, cache_size=0).schedule(
        RS.ExplicitCosts(costs))
    port = PS.LoopScheduler(p=p, cache_size=0, device="cpu").schedule(costs)
    np.testing.assert_array_equal(ref.item_id, port.item_id)
    return ref, port


@pytest.mark.parametrize("name", list(POLICIES))
def test_parallel_for_runs_every_item_once(name):
    p, n = 4, 257
    body = _Hits(n)
    stats = PE.parallel_for(n, body, p, _policy(PP, name, p), seed=1,
                            record_chunks=True)
    assert (body.hits == 1).all()
    covered = np.zeros(n, np.int64)
    for b, e, w, dt in stats.chunk_log:
        covered[b:e] += 1
        assert 0 <= w < p and dt >= 0.0
    assert (covered == 1).all() and stats.chunks == len(stats.chunk_log)


def test_parallel_for_units_runs_every_unit_once_in_tile_chunks():
    _, port = _schedules(_costs(150, seed=2))
    n_units = int(port.sizes.sum())
    body = _Hits(n_units)
    stats = port.parallel_for_units(body, record_chunks=True)
    assert (body.hits == 1).all()
    ranges = sorted((b, e) for b, e, _, _ in stats.chunk_log)
    np.testing.assert_array_equal(np.array(ranges), port.unit_ranges())
    items = _Hits(port.n_items)
    port.parallel_for(items, record_chunks=True)
    assert (items.hits == 1).all()


@pytest.mark.parametrize("name", list(POLICIES))
def test_deterministic_traces_match_reference(name):
    p, n = 4, 301
    runs = []
    for E, pkg in ((RE, RP), (PE, PP)):
        runs.append(E.parallel_for(n, lambda i: None, p,
                                   _policy(pkg, name, p), seed=3,
                                   record_chunks=True, deterministic=True))
    ref, port = runs
    assert [c[:3] for c in ref.chunk_log] == [c[:3] for c in port.chunk_log]
    assert ref.steal_log == port.steal_log
    assert (ref.chunks, ref.steals, ref.failed_steals) == \
        (port.chunks, port.steals, port.failed_steals)
    for f in ("ks", "ds"):
        if getattr(ref, f) is None:
            assert getattr(port, f) is None
        else:
            np.testing.assert_array_equal(getattr(ref, f), getattr(port, f))


@pytest.mark.parametrize("space", ["items", "units"])
def test_observe_execstats_refines_like_the_reference(space):
    costs = _costs(120, seed=4)
    ref, port = _schedules(costs)
    fn = "parallel_for" if space == "items" else "parallel_for_units"
    trace = getattr(port, fn)(lambda i: None, record_chunks=True,
                              deterministic=True).chunk_log
    secs = np.random.default_rng(5).uniform(1e-4, 1e-3, len(trace))
    log = [(b, e, w, float(s)) for (b, e, w, _), s in zip(trace, secs)]
    r2 = ref.observe(RE.ExecStats(chunk_log=list(log)), space=space).refine()
    p2 = port.observe(PE.ExecStats(chunk_log=list(log)), space=space).refine()
    np.testing.assert_array_equal(r2.costs, p2.costs)
    np.testing.assert_array_equal(r2.item_id, p2.item_id)
    with pytest.raises(ValueError, match="chunk_log"):
        port.observe(PE.ExecStats())


def test_observe_execstats_then_simresult_compound_like_the_reference():
    costs = _costs(200, seed=6)
    ref, port = _schedules(costs)
    trace = port.parallel_for_units(lambda u: None, record_chunks=True,
                                    deterministic=True).chunk_log
    log = [(b, e, w, 1e-3 * (e - b)) for (b, e, w, _) in trace]
    r = ref.observe(RE.ExecStats(chunk_log=log)).observe(ref.replay())
    q = port.observe(PE.ExecStats(chunk_log=log)).observe(port.replay())
    np.testing.assert_array_equal(r.refiner.refined_costs(),
                                  q.refiner.refined_costs())


# ------------------------------------------------------ faults, retries
def test_retries_go_through_sleep_fn_and_match_reference():
    plan = dict(seed=11, flaky_frac=0.1, flaky_failures=2)
    out = []
    for E, pkg, F in ((RE, RP, RF), (PE, PP, PF)):
        body, sleeps = _Hits(300), []
        stats = E.parallel_for(300, body, 4, pkg.ich(), seed=3,
                               faults=F.FaultPlan(**plan), retries=2,
                               retry_backoff_s=0.5, sleep_fn=sleeps.append,
                               deterministic=True, record_chunks=True)
        assert (body.hits == 1).all()
        out.append((stats, sleeps))
    (r, rs), (q, qs) = out
    assert q.retries > 0 and len(qs) == q.retries
    assert all(0.0 < s <= PE.RETRY_BACKOFF_CAP_S for s in qs)
    assert rs == qs
    assert (r.retries, r.faults_observed, r.faults_recovered) == \
        (q.retries, q.faults_observed, q.faults_recovered)


@pytest.mark.parametrize("policy", ["ich", "dynamic"])
def test_injected_death_and_stall_match_reference(policy):
    plan = dict(seed=7, deaths=((2, 3),), stalls=((0, 2, 5.0),))
    out = []
    for E, pkg, F in ((RE, RP, RF), (PE, PP, PF)):
        body, sleeps = _Hits(400), []
        stats = E.parallel_for(400, body, 4, _policy(pkg, policy, 4),
                               seed=3, faults=F.FaultPlan(**plan),
                               record_chunks=True, deterministic=True,
                               sleep_fn=sleeps.append)
        assert (body.hits == 1).all()
        out.append(stats)
    ref, port = out
    assert port.deaths == 1 and port.stall_events == 1
    assert ref.fault_log == port.fault_log
    assert [c[:3] for c in ref.chunk_log] == [c[:3] for c in port.chunk_log]
    # threaded, a stall (due at worker 0's first step, which every worker
    # takes) waits on sleep_fn, not on the clock
    sleeps = []
    body = _Hits(400)
    PE.parallel_for(400, body, 4, _policy(PP, policy, 4), seed=3,
                    faults=PF.FaultPlan(seed=7, deaths=((2, 3),),
                                        stalls=((0, 0, 5.0),)),
                    sleep_fn=sleeps.append)
    assert (body.hits == 1).all() and sleeps == [5.0]


def test_unrecoverable_faults_raise():
    with pytest.raises(PF.InjectedFault, match="poisoned item 150"):
        PE.parallel_for(300, lambda i: None, 4, PP.ich(),
                        faults=PF.FaultPlan(poison=(150,)), retries=5,
                        sleep_fn=lambda s: None)
    with pytest.raises(PF.InjectedFault):
        PE.parallel_for(300, lambda i: None, 4, PP.ich(),
                        faults=PF.FaultPlan(seed=11, flaky_frac=0.1))
    all_dead = PF.FaultPlan(deaths=tuple((w, 1) for w in range(4)))
    for pol in (PP.ich(), PP.dynamic(8)):
        with pytest.raises(PF.FaultError):
            PE.parallel_for(400, lambda i: None, 4, pol, faults=all_dead,
                            deterministic=True)
    with pytest.raises(ValueError):
        PE.parallel_for(10, lambda i: None, 2, PP.ich(),
                        faults=PF.FaultPlan(deaths=((5, 1),)))


def test_body_exception_reraised_in_caller():
    def body(i):
        if i == 77:
            raise KeyError("boom")
    for pol in (PP.ich(), PP.dynamic(4)):
        with pytest.raises(KeyError, match="boom"):
            PE.parallel_for(200, body, 4, pol)


def test_watchdog_reclaims_a_stalled_worker():
    """Worker 1 stalls before its first chunk; its `sleep_fn` stall blocks
    until the survivor has run worker 1's last item, which only a reclaim
    can hand over (steal-half never takes an owner's last item). So the run
    finishes exactly once only if the watchdog declared worker 1 dead."""
    n, p = 200, 2
    first_of_w1 = n // p  # the item steal-half leaves to its owner
    done = threading.Event()
    hits = _Hits(n)

    def body(i):
        hits(i)
        if i == first_of_w1:
            done.set()

    def sleep_fn(seconds):
        done.wait(timeout=10.0)

    stats = PE.parallel_for(n, body, p, PP.ich(), seed=3,
                            faults=PF.FaultPlan(stalls=((1, 0, 5.0),)),
                            watchdog_s=0.02, sleep_fn=sleep_fn)
    assert done.is_set() and (hits.hits == 1).all()
    assert stats.stall_events == 1 and stats.deaths == 1
    assert ("watchdog_kill", 1) in stats.fault_log
    assert stats.reclaims >= 1


# ------------------------------------------------------- the facade
def test_loop_scheduler_passthroughs():
    costs = _costs(300, seed=9)
    ref = RS.LoopScheduler(p=4, cache_size=0)
    port = PS.LoopScheduler(p=4, cache_size=0, device="cpu")
    a = ref.simulate(costs, record_chunks=True)
    b = port.simulate(costs, record_chunks=True)
    assert a.makespan == b.makespan and a.chunk_log == b.chunk_log
    prm = PSIM.SimParams(speed_jitter=0.0)
    sch = PS.LoopScheduler(p=4, cache_size=0, device="cpu", sim_params=prm)
    assert sch.schedule(costs).sim_params is prm
    body = _Hits(90)
    stats = port.parallel_for(90, body, policy=PP.stealing(3))
    assert (body.hits == 1).all() and stats.chunks >= 30


def test_default_scheduler_runs_on_the_card():
    if torch.cuda.is_available():
        s = PS.default_scheduler()
        assert s is PS.default_scheduler() and s.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            PS.default_scheduler()
