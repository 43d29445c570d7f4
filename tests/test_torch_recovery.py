"""Sharded recovery on the port (`repro_torch.robust.recovery`,
`Schedule.reshard_survivors`) against the reference's
`repro.robust.recovery`, mirroring tests/test_recovery.py on the CPU: the
checkpoint log (its JSON read across the two packages), the plans' structure
and validation, the plans element-identical to the reference's (the keep,
redo and lost blocks, both layouts, the redo items) over the kill cases and
the seeded recovery matrix, `combine` bit-identical to the fault-free run
through the port's plain kernels (SpMV, BFS, K-Means at k in {1, 2} of p in
{2, 4}) with each recovery run's cost stream summing per worker to its
layout's `worker_cost`, the port's combined outputs against the reference's
interpret-mode kernels, and the recovery-vs-steal inflation check on the
port's simulator.

Tolerances: exact everywhere inside the port, and for the plans and the
BFS/K-Means outputs against the reference; SpMV's y against the reference's
interpret-mode kernel at rtol = atol = 1e-5 (XLA sums a tile's slots in
another order than the port's left folds). The matrix's checkpoint records
go to pytest's tmp_path, never into the repository."""
import json

import numpy as np
import pytest
import torch
from conftest import random_csr

from repro import sched as RS
from repro.robust import recovery as RR
from repro_torch import sched as PS
from repro_torch.core import tiling as PT
from repro_torch.kernels.ich_bfs.ich_bfs import ich_bfs_step_sharded
from repro_torch.kernels.ich_kmeans.ich_kmeans import \
    ich_kmeans_assign_sharded
from repro_torch.kernels.ich_spmv.ich_spmv import ich_spmv_sharded
from repro_torch.robust import (CheckpointLog, Death, FaultPlan,
                                RecoveryPlan, plan_recovery)
from repro_torch.sched.kernels import _flat_slot_cost, _sharded_slot_cost

KILL_CASES = [(2, (1,)), (4, (1,)), (4, (0, 2))]
RECOVERY_SEEDS = list(range(12))
B = 4


def _schedules(n=160, *, p=4, seed=0):
    """The port's and the reference's schedule of one random CSR."""
    indptr, indices, data = random_csr(n, seed=seed)
    sizes = np.diff(indptr)
    port = PS.LoopScheduler(p=p, cache_size=0, device="cpu").schedule(sizes)
    ref = RS.LoopScheduler(p=p, cache_size=0).schedule(sizes)
    return port, ref, (indptr, indices, data)


def _checkpoint(log_cls, p, steps):
    """A log where worker w completed its first steps[w] grid steps."""
    log = log_cls()
    for w in range(p):
        log.mark_through(w, steps[w])
    return log


def _assert_plans_equal(port, ref):
    assert port.dead == ref.dead and port.survivors == ref.survivors
    assert port.superstep == ref.superstep and port.p_rec == ref.p_rec
    for name in ("keep_blocks", "redo_blocks", "lost_blocks", "redo_items"):
        a, b = getattr(port, name), getattr(ref, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    for name in ("shards", "done_shards"):
        a, b = getattr(port, name), getattr(ref, name)
        np.testing.assert_array_equal(a.block_perm, b.block_perm, name)
        np.testing.assert_array_equal(a.worker, b.worker, name)
        assert a.superstep == b.superstep


def _check_costs(costs, shards, tile_cost):
    """The port's cost-stream bar on a recovery layout: per-worker sums of
    the emitted stream equal the layout's worker_cost."""
    np.testing.assert_array_equal(
        costs.numpy().sum(axis=1),
        shards.worker_cost(tile_cost).astype(np.float32))


def _spmv_runner(s, csr):
    indptr, indices, data = csr
    n = len(indptr) - 1
    vp, cp = PT.pack_csr(indptr, indices, data, s.tiles, pad_tiles_to=B)
    x = np.random.default_rng(9).standard_normal(n).astype(np.float32)
    slot = torch.from_numpy(_flat_slot_cost(s.slot_cost(),
                                            vp.shape[0]))
    args = (torch.from_numpy(vp), torch.from_numpy(cp))

    def run(sh):
        y, c = ich_spmv_sharded(
            *args, torch.from_numpy(sh.shard_item_id(s.item_id)),
            torch.from_numpy(sh.kernel_block_ids()), torch.from_numpy(x),
            n, sh.p, B, slot_cost=slot)
        _check_costs(c, sh, s.tile_cost())
        return y

    return run, (vp, cp, x)


def _ref_spmv_runner(s, vp, cp, x):
    import jax.numpy as jnp
    from repro.kernels.ich_spmv.ich_spmv import ich_spmv_sharded as ref

    def run(sh):
        return np.asarray(ref(jnp.asarray(vp), jnp.asarray(cp),
                              jnp.asarray(sh.shard_item_id(s.tiles)),
                              jnp.asarray(sh.kernel_block_ids()),
                              jnp.asarray(x), x.size, sh.p, B,
                              interpret=True))

    return run


# ------------------------------------------------- checkpoint log basics

class TestCheckpointLog:
    def test_json_roundtrip(self):
        log = _checkpoint(CheckpointLog, 3, [2, 0, 1])
        log.mark(2, 5)
        back = CheckpointLog.from_json(log.to_json())
        assert back.entries == log.entries
        assert json.loads(back.to_json()) == json.loads(log.to_json())
        assert CheckpointLog.from_json(json.loads(log.to_json())).entries \
            == log.entries

    def test_reads_the_reference_log(self):
        ref = _checkpoint(RR.CheckpointLog, 4, [3, 0, 2, 1])
        ref.mark(1, 9)
        back = CheckpointLog.from_json(ref.to_json())
        assert back.entries == ref.entries
        assert back.to_json() == ref.to_json()

    def test_rejects_negative_entries(self):
        with pytest.raises(ValueError):
            CheckpointLog().mark(-1, 0)
        with pytest.raises(ValueError):
            CheckpointLog().mark(0, -2)
        with pytest.raises(ValueError):
            CheckpointLog.from_json('{"entries": [[0, -1]]}')

    def test_completed_blocks_ignores_out_of_range_and_padding(self):
        s, ref, _ = _schedules(80, p=3)
        shards = s.shard(superstep=4)
        log, rlog = CheckpointLog(), RR.CheckpointLog()
        for lg in (log, rlog):
            lg.mark(0, 0)
            lg.mark(99, 0)                    # unknown worker: ignored
            lg.mark(0, shards.n_steps + 7)    # past the grid: ignored
            for st in range(shards.n_steps):
                lg.mark(1, st)                # includes padding steps
        done = log.completed_blocks(shards)
        expect = {int(shards.block_perm[0, 0])}
        expect |= {int(b) for b in shards.block_perm[1] if b >= 0}
        assert set(done.tolist()) == expect
        np.testing.assert_array_equal(
            done, rlog.completed_blocks(ref.shard(superstep=4)))


# ------------------------------------------------------ plan structure

class TestRecoveryPlanStructure:
    def test_dead_out_of_range_and_all_dead_rejected(self):
        s, _, _ = _schedules(60, p=2)
        with pytest.raises(ValueError, match="out of range"):
            s.reshard_survivors(dead=[5], superstep=4)
        with pytest.raises(ValueError, match="all 2 workers dead"):
            s.reshard_survivors(dead=[0, 1], superstep=4)

    @pytest.mark.parametrize("p,k", [(2, 1), (4, 1), (4, 2)])
    def test_partition_is_chain_closed(self, p, k):
        """keep/redo partition the blocks; every redo chain is included
        whole; every keep block's chain is fully checkpointed; the plan is
        the reference's."""
        s, ref, _ = _schedules(200, p=p, seed=p)
        shards = s.shard(superstep=B)
        steps = [(w * 7 + 3) % (shards.n_steps + 1) for w in range(p)]
        plan = s.reshard_survivors(
            dead=range(k), checkpoint=_checkpoint(CheckpointLog, p, steps),
            superstep=B)
        _assert_plans_equal(plan, ref.reshard_survivors(
            dead=range(k), checkpoint=_checkpoint(RR.CheckpointLog, p,
                                                  steps), superstep=B))
        n_blocks = -(-s.n_tiles // B)
        both = np.concatenate([plan.keep_blocks, plan.redo_blocks])
        np.testing.assert_array_equal(np.sort(both), np.arange(n_blocks))
        chain = PT.block_chains(s.item_id, B)
        redo_chains = set(chain[plan.redo_blocks].tolist())
        assert not (redo_chains & set(chain[plan.keep_blocks].tolist()))
        for c in redo_chains:
            assert set(np.flatnonzero(chain == c)) <= \
                set(plan.redo_blocks.tolist())
        log = _checkpoint(CheckpointLog, p, steps)
        assert set(plan.keep_blocks.tolist()) <= \
            set(log.completed_blocks(shards).tolist())
        assert plan.p_rec == p - k
        rec_blocks = plan.shards.block_perm[plan.shards.block_perm >= 0]
        np.testing.assert_array_equal(np.sort(rec_blocks), plan.redo_blocks)
        idx = (plan.redo_blocks[:, None] * B + np.arange(B)).reshape(-1)
        idx = idx[idx < s.n_tiles]
        ids = s.item_id[idx]
        expect = np.zeros(s.n_items, bool)
        expect[ids[ids >= 0]] = True
        np.testing.assert_array_equal(plan.redo_items, expect)

    def test_empty_checkpoint_is_full_restart(self):
        s, ref, _ = _schedules(100, p=4)
        plan = s.reshard_survivors(dead=[2], superstep=4)
        _assert_plans_equal(plan, ref.reshard_survivors(dead=[2],
                                                        superstep=4))
        assert plan.keep_blocks.size == 0 and plan.redo_items.all()
        assert float(plan.makespan_model(s.tile_cost())["t_done"]) == 0.0
        assert plan.makespan_model(s.tile_cost()) == \
            ref.reshard_survivors(dead=[2], superstep=4).makespan_model(
                ref.tile_cost())

    def test_plan_recovery_is_exported_and_direct(self):
        s, _, _ = _schedules(90, p=4)
        sh = s.shard(superstep=B)
        plan = plan_recovery(s.tiles, s.tile_cost(), sh, dead=[3])
        assert isinstance(plan, RecoveryPlan) and plan.survivors == (0, 1, 2)


# ----------------------------------------- bit-identical kill-k recovery

@pytest.mark.parametrize("p,dead", KILL_CASES)
def test_spmv_recovery_bit_identical(p, dead):
    """Interrupted sharded SpMV + survivor re-execution == fault-free run,
    bitwise, across ragged per-worker checkpoint positions; the combined y
    also agrees with the reference's interpret-mode recovery."""
    s, ref, csr = _schedules(170, p=p, seed=11 + p)
    shards = s.shard(superstep=B)
    run, (vp, cp, x) = _spmv_runner(s, csr)
    y_full = run(shards)
    ref_run = _ref_spmv_runner(ref, vp, cp, x)
    for shift in range(3):
        steps = [(w + shift) % (shards.n_steps + 1) for w in range(p)]
        plan = s.reshard_survivors(
            dead=dead, checkpoint=_checkpoint(CheckpointLog, p, steps),
            superstep=B)
        y = plan.combine(run(plan.done_shards), run(plan.shards))
        assert isinstance(y, torch.Tensor) and torch.equal(y, y_full)
        if shift == 0:
            rplan = ref.reshard_survivors(
                dead=dead, checkpoint=_checkpoint(RR.CheckpointLog, p, steps),
                superstep=B)
            _assert_plans_equal(plan, rplan)
            y_ref = rplan.combine(ref_run(rplan.done_shards),
                                  ref_run(rplan.shards))
            np.testing.assert_allclose(y.numpy(), y_ref, rtol=1e-5,
                                       atol=1e-5)


@pytest.mark.parametrize("p,dead", KILL_CASES)
def test_bfs_recovery_bit_identical(p, dead):
    import jax.numpy as jnp
    from repro.kernels.ich_bfs.ich_bfs import ich_bfs_step_sharded as ref_k

    s, ref, (indptr, indices, _) = _schedules(150, p=p, seed=23 + p)
    n = len(indptr) - 1
    shards = s.shard(superstep=B)
    ones = np.ones(int(indptr[-1]), np.float32)
    mp, cp = PT.pack_csr(indptr, indices, ones, s.tiles, pad_tiles_to=B)
    rng = np.random.default_rng(23 + p)
    frontier = (rng.random(n) < 0.1).astype(np.float32)
    visited = frontier.copy()
    slot = torch.from_numpy(_flat_slot_cost(s.slot_cost(), mp.shape[0]))
    t = [torch.from_numpy(a) for a in (mp, cp, frontier, visited)]

    def run(sh):
        y, c = ich_bfs_step_sharded(
            t[0], t[1], torch.from_numpy(sh.shard_item_id(s.item_id)),
            torch.from_numpy(sh.kernel_block_ids()), t[2], t[3], n, sh.p, B,
            slot_cost=slot)
        _check_costs(c, sh, s.tile_cost())
        return y

    def ref_run(sh):
        return np.asarray(ref_k(
            jnp.asarray(mp), jnp.asarray(cp),
            jnp.asarray(sh.shard_item_id(ref.tiles)),
            jnp.asarray(sh.kernel_block_ids()), jnp.asarray(frontier),
            jnp.asarray(visited), n, sh.p, B, interpret=True))

    nxt_full = run(shards)
    steps = [shards.n_steps // 2] * p
    plan = s.reshard_survivors(
        dead=dead, checkpoint=_checkpoint(CheckpointLog, p, steps),
        superstep=B)
    nxt = plan.combine(run(plan.done_shards), run(plan.shards))
    assert torch.equal(nxt, nxt_full)
    rplan = ref.reshard_survivors(
        dead=dead, checkpoint=_checkpoint(RR.CheckpointLog, p, steps),
        superstep=B)
    _assert_plans_equal(plan, rplan)
    np.testing.assert_array_equal(
        nxt.numpy(), rplan.combine(ref_run(rplan.done_shards),
                                   ref_run(rplan.shards)))


@pytest.mark.parametrize("p,dead", KILL_CASES)
def test_kmeans_recovery_bit_identical(p, dead):
    import jax.numpy as jnp
    from repro.kernels.ich_kmeans.ich_kmeans import \
        ich_kmeans_assign_sharded as ref_k

    rng = np.random.default_rng(31 + p)
    n = 140
    costs = rng.uniform(1.0, 9.0, n)
    s = PS.LoopScheduler(p=p, cache_size=0, device="cpu").schedule(costs)
    ref = RS.LoopScheduler(p=p, cache_size=0).schedule(costs)
    shards = s.shard(superstep=B)
    pts = rng.standard_normal((n, 5)).astype(np.float32)
    cent = rng.standard_normal((6, 5)).astype(np.float32)
    tp, tc = torch.from_numpy(pts), torch.from_numpy(cent)

    def run(sh):
        ids, c = ich_kmeans_assign_sharded(
            tp, tc, torch.from_numpy(sh.shard_item_id(s.item_id)), sh.p, B,
            slot_cost=torch.from_numpy(_sharded_slot_cost(s.slot_cost(),
                                                          sh)))
        # float costs: the float32 stream folds in another order than the
        # float64 bincount of worker_cost
        np.testing.assert_allclose(c.numpy().sum(axis=1),
                                   sh.worker_cost(s.tile_cost()), rtol=1e-6)
        return ids

    def ref_run(sh):
        return np.asarray(ref_k(jnp.asarray(pts), jnp.asarray(cent),
                                jnp.asarray(sh.shard_item_id(ref.tiles)),
                                sh.p, B, interpret=True))

    a_full = run(shards)
    steps = [1 + (w % max(shards.n_steps - 1, 1)) for w in range(p)]
    plan = s.reshard_survivors(
        dead=dead, checkpoint=_checkpoint(CheckpointLog, p, steps),
        superstep=B)
    a = plan.combine(run(plan.done_shards), run(plan.shards))
    assert torch.equal(a, a_full)
    rplan = ref.reshard_survivors(
        dead=dead, checkpoint=_checkpoint(RR.CheckpointLog, p, steps),
        superstep=B)
    _assert_plans_equal(plan, rplan)
    np.testing.assert_array_equal(
        a.numpy(), rplan.combine(ref_run(rplan.done_shards),
                                 ref_run(rplan.shards)))


def test_combine_shape_validation():
    s, _, _ = _schedules(60, p=2)
    plan = s.reshard_survivors(dead=[0], superstep=4)
    n = s.n_items
    with pytest.raises(ValueError, match="shapes"):
        plan.combine(np.zeros(n), np.zeros(n + 1))
    with pytest.raises(ValueError, match="does not match"):
        plan.combine(np.zeros(n + 3), np.zeros(n + 3))
    with pytest.raises(ValueError, match="shapes"):
        plan.combine(torch.zeros(n), torch.zeros(n + 1))
    with pytest.raises(ValueError, match="does not match"):
        plan.combine(torch.zeros(n + 3), torch.zeros(n + 3))
    with pytest.raises(ValueError, match="two tensors"):
        plan.combine(torch.zeros(n), np.zeros(n))
    # per-item leading axis: trailing axes broadcast the mask
    a, b = torch.zeros((n, 3)), torch.ones((n, 3))
    out = plan.combine(a, b)
    assert torch.equal(out[:, 0], torch.from_numpy(plan.redo_items).float())


# --------------------------------------- recovery vs steal-only inflation

def test_reshard_inflation_not_worse_than_steal_reclaim():
    """Finishing an interrupted run by RE-LOWERING the incomplete chains
    onto survivors (barrier-time model: completed prefix + re-execution)
    costs no more than the dynamic steal-path reclaim of the same early
    deaths, on the port's simulator; every number equals the reference's."""
    from repro.core.policies import ich as ref_ich
    from repro.core.simulator import simulate as ref_simulate
    from repro.robust.faults import FaultPlan as RefFaultPlan
    from repro_torch.core.policies import ich
    from repro_torch.core.simulator import simulate

    p, seed = 4, 100
    rng = np.random.default_rng(seed)
    n = 400
    sizes = rng.integers(8, 13, n)
    s = PS.LoopScheduler(p=p, cache_size=0, device="cpu").schedule(sizes)
    ref = RS.LoopScheduler(p=p, cache_size=0).schedule(sizes)
    tc = s.tile_cost()
    clean_static = float(s.shard().worker_cost(tc).max())
    clean_steal = simulate(s.costs, p, ich())
    for k in (1, 2, 3):
        deaths = tuple(Death(w, 1) for w in range(k))
        faulty = simulate(s.costs, p, ich(),
                          faults=FaultPlan(seed=seed, deaths=deaths))
        ref_faulty = ref_simulate(
            ref.costs, p, ref_ich(),
            faults=RefFaultPlan(seed=seed,
                                deaths=tuple((w, 1) for w in range(k))))
        assert faulty.makespan == ref_faulty.makespan
        steal_inflation = faulty.makespan / clean_steal.makespan
        plan = s.reshard_survivors(
            dead=range(k), checkpoint=_checkpoint(CheckpointLog, p, [1] * p))
        mm = plan.makespan_model(tc)
        assert mm == ref.reshard_survivors(
            dead=range(k), checkpoint=_checkpoint(RR.CheckpointLog, p,
                                                  [1] * p)
        ).makespan_model(ref.tile_cost())
        assert mm["makespan"] / clean_static <= steal_inflation, k


# -------------------------------------------------- seeded recovery matrix

@pytest.mark.parametrize("seed", RECOVERY_SEEDS)
def test_recovery_matrix(seed, tmp_path):
    """One seeded kill scenario per seed: seed-derived (p, k, ragged
    checkpoint), the plan equal to the reference's, SpMV recovery
    bit-identical, and the scenario's record written under tmp_path."""
    rng = np.random.default_rng(seed)
    p = int(rng.choice([2, 4]))
    k = 1 if p == 2 else int(rng.integers(1, 3))
    dead = tuple(sorted(rng.choice(p, size=k, replace=False).tolist()))
    s, ref, csr = _schedules(120, p=p, seed=seed)
    shards = s.shard(superstep=B)
    steps = rng.integers(0, shards.n_steps + 1, p).tolist()
    log = _checkpoint(CheckpointLog, p, steps)
    plan = s.reshard_survivors(dead=dead, checkpoint=log, superstep=B)
    _assert_plans_equal(plan, ref.reshard_survivors(
        dead=dead, checkpoint=RR.CheckpointLog.from_json(log.to_json()),
        superstep=B))

    record = tmp_path / f"sharded_seed{seed}.json"
    record.write_text(json.dumps({
        "seed": seed, "p": p, "dead": list(dead), "steps": steps,
        "checkpoint": json.loads(log.to_json()),
        "keep_blocks": plan.keep_blocks.tolist(),
        "redo_blocks": plan.redo_blocks.tolist(),
        "makespan_model": plan.makespan_model(s.tile_cost()),
    }, indent=2) + "\n")
    back = CheckpointLog.from_json(json.loads(record.read_text())[
        "checkpoint"])
    assert back.entries == log.entries

    run, _ = _spmv_runner(s, csr)
    y = plan.combine(run(plan.done_shards), run(plan.shards))
    assert torch.equal(y, run(shards))
    # the plan is a pure function of its inputs: replanning is identical
    again = s.reshard_survivors(dead=dead, checkpoint=log, superstep=B)
    np.testing.assert_array_equal(again.redo_blocks, plan.redo_blocks)
    np.testing.assert_array_equal(again.keep_blocks, plan.keep_blocks)
