"""Kernel parity for the iCh K-Means assignment: the reference's Pallas
kernels (interpret mode, as tests/test_kernels.py and tests/test_sharding.py
run them) against the port's plain versions fed the same lowering through
`repro_torch.convert`, plus the bit-identity bars inside the port.

Tolerances: ids are compared exactly. XLA sums a point's squared distance
over D in another order than the port's left fold, so a point within an
ulp of two centroids could flip; at these sizes none is, as in the
reference's own tests. The cost stream is compared at rtol 1e-6: K-Means
costs are floats (quantized per point by `ExplicitCosts`), so the order of
a superstep's sum moves its last bits. Inside the port the kernels and the
plain versions run one left fold, so sharded == sequential is exact."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.core import workloads as RW
from repro.core.segmented import worker_reduce as ref_worker_reduce
from repro.kernels.ich_kmeans.ich_kmeans import \
    ich_kmeans_assign as ref_ich_kmeans_assign
from repro.kernels.ich_kmeans.ich_kmeans import \
    ich_kmeans_assign_sharded as ref_ich_kmeans_assign_sharded
from repro.kernels.ich_kmeans.ref import \
    kmeans_assign_ref as np_kmeans_assign_ref
from repro import sched as RS
from repro.sched.kernels import _sharded_slot_cost as ref_sharded_slot_cost
from repro_torch import convert
from repro_torch import sched as PS
from repro_torch.core import segmented as PSEG
from repro_torch.core.workloads import kmeans_rounds
from repro_torch.kernels.ich_kmeans import ich_kmeans as K
from repro_torch.kernels.ich_kmeans.ref import kmeans_assign_ref

RTOL = 1e-6  # float cost streams: summation order (see module docstring)


def _inputs(n, D, K_, seed):
    rng = np.random.default_rng(seed)
    pts = rng.standard_normal((n, D)).astype(np.float32)
    cent = rng.standard_normal((K_, D)).astype(np.float32)
    costs = rng.uniform(6.0, 10.0, n)
    heavy = rng.choice(n, max(n // 50, 1), replace=False)
    costs[heavy] += rng.exponential(120.0, heavy.size)
    return pts, cent, costs


@pytest.mark.parametrize("p,B", [(1, 1), (1, 8), (4, 1), (4, 8)])
def test_sharded_plain_matches_reference_kernel(p, B):
    pts, cent, costs = _inputs(240, 6, 5, seed=p * 10 + B)
    s = RS.LoopScheduler(p=p, superstep=B, cache_size=0).schedule(
        RS.ExplicitCosts(costs))
    shards = s.shard()
    rid = shards.shard_item_id(s.tiles)
    sc = ref_sharded_slot_cost(s, shards)
    ids_ref, c_ref = ref_ich_kmeans_assign_sharded(
        jnp.asarray(pts), jnp.asarray(cent), jnp.asarray(rid), p, B,
        slot_cost=jnp.asarray(sc), interpret=True)
    op = convert.kmeans_op_from_reference(
        item_id=s.item_id, rows_per_tile=s.rows_per_tile,
        worker=shards.worker, block_perm=shards.block_perm, superstep=B,
        slot_cost=sc, n_points=240, device="cpu")
    ids = op(pts, cent)
    assert ids.dtype == torch.int32
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ids_ref))
    np.testing.assert_allclose(op.last_costs.numpy(), np.asarray(c_ref),
                               rtol=RTOL)
    np.testing.assert_allclose(op.last_costs.numpy().sum(axis=1),
                               shards.worker_cost(s.tile_cost()), rtol=RTOL)
    np.testing.assert_array_equal(ids.numpy(),
                                  np_kmeans_assign_ref(pts, cent))


@pytest.mark.parametrize("n,D,K_,R", [(100, 4, 3, 4), (256, 8, 16, 8),
                                      (333, 2, 5, 8), (64, 16, 2, 16)])
def test_sequential_plain_matches_reference_kernel_and_oracles(n, D, K_, R):
    pts, cent, costs = _inputs(n, D, K_, seed=n)
    s = RS.LoopScheduler(p=1, rows_per_tile=R, cache_size=0).schedule(
        RS.ExplicitCosts(costs))
    ids_ref = ref_ich_kmeans_assign(jnp.asarray(pts), jnp.asarray(cent),
                                    jnp.asarray(s.item_id), interpret=True)
    ids = K.ich_kmeans_assign(torch.from_numpy(pts), torch.from_numpy(cent),
                              torch.from_numpy(s.item_id))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ids_ref))
    np.testing.assert_array_equal(ids.numpy(),
                                  np_kmeans_assign_ref(pts, cent))
    np.testing.assert_array_equal(
        kmeans_assign_ref(torch.from_numpy(pts),
                          torch.from_numpy(cent)).numpy(),
        np_kmeans_assign_ref(pts, cent))


@pytest.mark.parametrize("p", [1, 2, 4])
@pytest.mark.parametrize("B", [1, 4, 8])
def test_sharded_plain_bit_identical_to_sequential(p, B):
    pts, cent, costs = _inputs(150, 6, 7, seed=40 + p)
    s = PS.LoopScheduler(p=p, superstep=B, cache_size=0,
                         device="cpu").schedule(costs)
    shards = s.shard()
    pt, ct = torch.from_numpy(pts), torch.from_numpy(cent)
    seq = K.ich_kmeans_assign(pt, ct, torch.from_numpy(s.item_id))
    sh = K.ich_kmeans_assign_sharded(
        pt, ct, torch.from_numpy(shards.shard_item_id(s.item_id)), p, B)
    assert torch.equal(sh, seq)


def test_heavy_point_split_is_idempotent():
    # a point far heavier than one slot occupies many slots, in several
    # tiles; every slot computes the same id and stores it
    costs = np.full(32, 7.0)
    costs[5] = 10_000.0
    rng = np.random.default_rng(9)
    pts = rng.standard_normal((32, 3)).astype(np.float32)
    cent = rng.standard_normal((4, 3)).astype(np.float32)
    ref = RS.LoopScheduler(p=2).build("kmeans", costs, width=8)
    op = PS.LoopScheduler(p=2, device="cpu").build("kmeans", costs, width=8)
    tiles_of_5 = np.unique(np.nonzero(op.schedule.item_id == 5)[0])
    assert tiles_of_5.size > 1  # genuinely split across tiles
    ids = op(pts, cent)
    np.testing.assert_array_equal(ids.numpy(),
                                  np.asarray(ref(pts, cent, interpret=True)))
    np.testing.assert_array_equal(ids.numpy(),
                                  np_kmeans_assign_ref(pts, cent))


def test_no_points_is_a_noop():
    K.reset_launches()
    op = PS.LoopScheduler(p=2, device="cpu").build("kmeans",
                                                   np.zeros(0, np.float64))
    assert op.n_tiles == 0
    ids = op(np.zeros((0, 3), np.float32), np.zeros((2, 3), np.float32))
    assert ids.shape == (0,) and ids.dtype == torch.int32
    assert op.last_costs.shape == op.shards.block_perm.shape
    assert not op.last_costs.any()
    assert op.observe().refine().n_tiles == 0
    # the wrapper itself runs nothing without points
    ids, costs = K.ich_kmeans_assign_sharded(
        torch.zeros((0, 3)), torch.zeros((2, 3)),
        torch.full((16, 8), -1, dtype=torch.int32), 2, 8,
        slot_cost=torch.zeros((16, 8)))
    assert ids.shape == (0,) and costs.shape == (2, 1) and not costs.any()
    assert K.LAUNCHES == {"ich_kmeans_assign": 0,
                          "ich_kmeans_assign_sharded": 0}


def test_segmented_store_writes_named_rows_last_tile_winning():
    # row 2 is split within and across tiles: the tile's max is stored and
    # the later tile wins; rows no slot names keep their value
    rows = torch.tensor([[0, 2, 2, 2], [2, 5, 5, -1], [5, 6, 6, 7]],
                        dtype=torch.int32)
    vals = torch.tensor([[3, 1, 4, 1], [2, 6, 5, 9], [7, 0, 1, 8]],
                        dtype=torch.int32)
    out = torch.full((8,), 9, dtype=torch.int32)
    PSEG.segmented_apply(out, rows, vals, combine="store")
    np.testing.assert_array_equal(out.numpy(), [3, 9, 2, 9, 9, 7, 1, 8])


@pytest.mark.parametrize("p", [1, 2, 3, 5, 8])
def test_worker_reduce_store_matches_reference_tree(p):
    # store lowers to max over the zero-initialized identity: each column
    # is stored by one worker, the others hold 0
    rng = np.random.default_rng(p)
    acc = np.zeros((p, 40), np.int32)
    owner = rng.integers(0, p, 40)
    acc[owner, np.arange(40)] = rng.integers(0, 9, 40)
    np.testing.assert_array_equal(
        PSEG.worker_reduce(torch.from_numpy(acc), "store").numpy(),
        np.asarray(ref_worker_reduce(jnp.asarray(acc), "store")))


def test_kmeans_rounds_match_reference_draws():
    ours, est = kmeans_rounds(2000, rounds=3, seed=5)
    ref, ref_est = RW.kmeans_rounds(2000, rounds=3, seed=5)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(est, ref_est)


def test_wrappers_refuse_mixed_devices_and_bad_layouts():
    pts, cent, costs = _inputs(64, 3, 4, seed=1)
    op = PS.LoopScheduler(p=2, device="cpu").build("kmeans", costs)
    pt, ct = torch.from_numpy(pts), torch.from_numpy(cent)
    with pytest.raises(ValueError, match="shard layout"):
        K.ich_kmeans_assign_sharded(pt, ct, op.rowid[:-1], 2, op.superstep)
    with pytest.raises(ValueError, match="all on CUDA"):
        K.ich_kmeans_assign(pt, ct.to("meta"), op.rowid)
    with pytest.raises(ValueError, match="points"):
        op(pts[:-1], cent)
    with pytest.raises(ValueError, match="lies on"):
        op(pt.to("meta"), ct)
    with pytest.raises(ValueError, match="shard layout's shape"):
        convert.kmeans_op_from_reference(
            item_id=op.schedule.item_id, rows_per_tile=8,
            worker=op.shards.worker, block_perm=op.shards.block_perm,
            superstep=op.superstep, slot_cost=np.zeros((1, 8)), n_points=64,
            device="cpu")


# the layouts the card's flat K-Means walk is tested on (tests/
# test_torch_cuda.py): name -> (points, D, K, p, B)
WALK_LAYOUTS = {
    "d1": (300, 1, 5, 4, 8),
    "split_points": (300, 6, 5, 4, 8),
    "all_padding_workers": (12, 6, 3, 8, 4),
    "few_slots": (10, 34, 5, 1, 1),
}


@pytest.mark.parametrize("case", list(WALK_LAYOUTS))
def test_plain_matches_reference_on_walk_layouts(case):
    n, D, K_, p, B = WALK_LAYOUTS[case]
    pts, cent, costs = _inputs(n, D, K_, seed=list(WALK_LAYOUTS).index(case))
    costs[n // 2] = 3000.0          # a point split over several tiles
    s = RS.LoopScheduler(p=p, superstep=B, cache_size=0).schedule(
        RS.ExplicitCosts(costs))
    shards = s.shard()
    assert np.unique(np.nonzero(s.item_id == n // 2)[0]).size > 1
    if case == "all_padding_workers":
        assert (shards.block_perm < 0).all(axis=1).any()
    rid = shards.shard_item_id(s.tiles)
    sc = ref_sharded_slot_cost(s, shards)
    ids_ref, c_ref = ref_ich_kmeans_assign_sharded(
        jnp.asarray(pts), jnp.asarray(cent), jnp.asarray(rid), p, B,
        slot_cost=jnp.asarray(sc), interpret=True)
    flat_ref = ref_ich_kmeans_assign(jnp.asarray(pts), jnp.asarray(cent),
                                     jnp.asarray(s.item_id), interpret=True)
    op = convert.kmeans_op_from_reference(
        item_id=s.item_id, rows_per_tile=s.rows_per_tile,
        worker=shards.worker, block_perm=shards.block_perm, superstep=B,
        slot_cost=sc, n_points=n, device="cpu")
    ids = op(pts, cent)
    flat = K.ich_kmeans_assign(torch.from_numpy(pts), torch.from_numpy(cent),
                               torch.from_numpy(s.item_id))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ids_ref))
    np.testing.assert_array_equal(flat.numpy(), np.asarray(flat_ref))
    assert torch.equal(ids, flat)
    np.testing.assert_allclose(op.last_costs.numpy(), np.asarray(c_ref),
                               rtol=RTOL)


# The card's sharded walk (csrc/ich_kmeans.cu) takes the p*S_B supersteps
# in chunks of whole supersteps (as many as fit in 256 slots, at least
# one), chunk c on CTA c mod the grid, and folds each step's cost from the
# slots it staged. `_chunked_walk` is a numpy model of that walk: the same
# float32 left folds (numpy float32 arithmetic rounds each operation as the
# kernel's __fsub_rn/__fmul_rn/__fadd_rn do), visiting steps in the
# kernel's order.
CHUNK_SLOTS = 256


def _nearest(x, cent):
    d2 = np.zeros(cent.shape[0], np.float32)
    for d in range(x.size):
        diff = x[d] - cent[:, d]
        d2 = d2 + diff * diff
    return int(np.argmin(d2))   # the first minimum, as the kernel's strict <


def _chunked_walk(pts, cent, rowid, slot_cost, p, B, ctas):
    PS_, R = rowid.shape
    step = B * R
    n_steps = PS_ // B
    cs = max(1, CHUNK_SLOTS // step)
    rows, sc = rowid.reshape(n_steps, step), slot_cost.reshape(n_steps, step)
    ids = np.zeros(pts.shape[0], np.int32)
    costs = np.zeros(n_steps, np.float32)
    visits = np.zeros(n_steps, np.int64)
    for b in range(ctas):
        for g0 in range(b * cs, n_steps, ctas * cs):
            for g in range(g0, min(g0 + cs, n_steps)):
                visits[g] += 1
                c = np.float32(0.0)
                for k in range(step):
                    i = rows[g, k]
                    if i >= 0:
                        ids[i] = _nearest(pts[i], cent)
                    c = c + (sc[g, k] if i >= 0 else np.float32(0.0))
                costs[g] = c
    assert (visits == 1).all()
    return ids, costs.reshape(p, -1), cs


# name -> (points, D, K, p, B, R): layouts where chunks of whole steps
# split workers and S_B is not a multiple of a chunk's steps, and one
# whose superstep (512 slots) is larger than a chunk
CHUNK_LAYOUTS = {
    "chunk_splits_workers": (900, 6, 5, 3, 2, 8),
    "s_b_off_the_chunk": (600, 6, 5, 4, 8, 8),
    "step_wider_than_chunk": (600, 6, 3, 2, 8, 64),
}


@pytest.mark.parametrize("ctas", [1, 3, 1000])
@pytest.mark.parametrize("case", list(CHUNK_LAYOUTS))
def test_sharded_plain_matches_reference_on_chunked_layouts(case, ctas):
    n, D, K_, p, B, R = CHUNK_LAYOUTS[case]
    pts, cent, costs = _inputs(n, D, K_, seed=list(CHUNK_LAYOUTS).index(case))
    costs[n // 3] = 2000.0          # a point split over several tiles
    s = RS.LoopScheduler(p=p, superstep=B, rows_per_tile=R,
                         cache_size=0).schedule(RS.ExplicitCosts(costs))
    shards = s.shard()
    S_B = shards.n_steps
    rid = shards.shard_item_id(s.tiles)
    sc = ref_sharded_slot_cost(s, shards).astype(np.float32)
    ids_m, costs_m, cs = _chunked_walk(pts, cent, rid, sc, p, B, ctas)
    if case == "step_wider_than_chunk":
        assert B * R > CHUNK_SLOTS and cs == 1
    else:
        assert S_B % cs and p * S_B > cs   # a chunk spans two workers
    ids_ref, c_ref = ref_ich_kmeans_assign_sharded(
        jnp.asarray(pts), jnp.asarray(cent), jnp.asarray(rid), p, B,
        slot_cost=jnp.asarray(sc), interpret=True)
    ids, c = K.ich_kmeans_assign_sharded(
        torch.from_numpy(pts), torch.from_numpy(cent), torch.from_numpy(rid),
        p, B, slot_cost=torch.from_numpy(sc))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ids_ref))
    np.testing.assert_array_equal(ids.numpy(), ids_m)
    np.testing.assert_array_equal(c.numpy(), costs_m)
    np.testing.assert_allclose(c.numpy(), np.asarray(c_ref), rtol=RTOL)
