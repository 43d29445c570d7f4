"""Kernel parity for the iCh BFS: the reference's Pallas kernels (interpret
mode, as tests/test_kernels.py and tests/test_sharding.py run them)
against the port's plain versions fed the same lowering through
`repro_torch.convert`, plus the bit-identity bars inside the port.

Tolerance: none. Frontiers and levels are exact 0/1 and integer values
(a max of products of 0/1 floats is exact in any order), and the BFS cost
stream is a sum of integer degrees in float32, exact in any order at these
sizes, so every comparison here is `equal`."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.core import tiling as RT
from repro.core import workloads as RW
from repro.core.segmented import worker_reduce as ref_worker_reduce
from repro.kernels.ich_bfs.ich_bfs import ich_bfs_step as ref_ich_bfs_step
from repro.kernels.ich_bfs.ich_bfs import \
    ich_bfs_step_sharded as ref_ich_bfs_step_sharded
from repro.kernels.ich_bfs.ref import bfs_levels_ref as np_bfs_levels_ref
from repro.kernels.ich_bfs.ref import bfs_step_ref as np_bfs_step_ref
from repro import sched as RS
from repro.sched.kernels import _flat_slot_cost as ref_flat_slot_cost
from repro_torch import convert
from repro_torch import sched as PS
from repro_torch.core import segmented as PSEG
from repro_torch.core import tiling as PT
from repro_torch.core.workloads import bfs_graph
from repro_torch.kernels.ich_bfs import ich_bfs as K
from repro_torch.kernels.ich_bfs.ref import bfs_levels_ref, bfs_step_ref

N = 200


def _indicators(n, seed):
    rng = np.random.default_rng(seed)
    frontier = (rng.random(n) < 0.1).astype(np.float32)
    visited = np.maximum(frontier, rng.random(n) < 0.3).astype(np.float32)
    return frontier, visited


def _ref_lowering(indptr, indices, p, B):
    s = RS.LoopScheduler(p=p, superstep=B, cache_size=0).schedule(
        RS.DegreeCosts(indptr))
    shards = s.shard()
    mask, cols = RT.pack_csr(indptr, indices,
                             np.ones(len(indices), np.float32), s.tiles,
                             pad_tiles_to=B)
    return s, shards, mask, cols, ref_flat_slot_cost(s,
                                                     shards.n_tiles_padded)


@pytest.mark.parametrize("p,B", [(1, 1), (1, 8), (4, 1), (4, 8)])
def test_sharded_plain_matches_reference_kernel(p, B):
    indptr, indices = bfs_graph("scale_free" if p == 4 else "uniform", N,
                                seed=p * 10 + B)
    frontier, visited = _indicators(N, seed=p + B)
    s, shards, mask, cols, sc = _ref_lowering(indptr, indices, p, B)
    nxt_ref, c_ref = ref_ich_bfs_step_sharded(
        jnp.asarray(mask), jnp.asarray(cols),
        jnp.asarray(shards.shard_item_id(s.tiles)),
        jnp.asarray(shards.kernel_block_ids()), jnp.asarray(frontier),
        jnp.asarray(visited), N, p, B, slot_cost=jnp.asarray(sc),
        interpret=True)
    op = convert.bfs_op_from_reference(
        item_id=s.item_id, width=s.width, rows_per_tile=s.rows_per_tile,
        worker=shards.worker, block_perm=shards.block_perm, superstep=B,
        mask=mask, cols=cols, slot_cost=sc, n_vertices=N, device="cpu")
    nxt = op.step(frontier, visited)
    np.testing.assert_array_equal(nxt.numpy(), np.asarray(nxt_ref))
    np.testing.assert_array_equal(op.last_costs.numpy(), np.asarray(c_ref))
    np.testing.assert_array_equal(
        op.last_costs.numpy().sum(axis=1),
        shards.worker_cost(s.tile_cost()).astype(np.float32))


def test_sequential_plain_matches_reference_kernel_and_oracles():
    indptr, indices = bfs_graph("uniform", N, seed=3)
    frontier, visited = _indicators(N, seed=4)
    s = RS.LoopScheduler(p=1, cache_size=0).schedule(RS.DegreeCosts(indptr))
    mask, cols = RT.pack_csr(indptr, indices,
                             np.ones(len(indices), np.float32), s.tiles)
    nxt_ref = ref_ich_bfs_step(jnp.asarray(mask), jnp.asarray(cols),
                               jnp.asarray(s.item_id), jnp.asarray(frontier),
                               jnp.asarray(visited), N, interpret=True)
    t = [torch.from_numpy(a) for a in (mask, cols, s.item_id, frontier,
                                       visited)]
    nxt = K.ich_bfs_step(*t, N)
    np.testing.assert_array_equal(nxt.numpy(), np.asarray(nxt_ref))
    # both agree with the oracles that do not fold tiles
    expect = np_bfs_step_ref(indptr, indices, frontier, visited)
    np.testing.assert_array_equal(nxt.numpy(), expect)
    np.testing.assert_array_equal(
        bfs_step_ref(torch.from_numpy(indptr), torch.from_numpy(indices),
                     t[3], t[4]).numpy(), expect)


def test_sequential_plain_matches_reference_kernel_on_a_long_run():
    # a hub with 3,000 in-neighbors: its run of slots crosses 25 tiles at
    # W = 16, the input class the flat walk's run owners are built for
    indptr, indices = bfs_graph("uniform", 2000, seed=5)
    nbrs = [indices[indptr[u]:indptr[u + 1]] for u in range(2000)]
    nbrs[5] = np.random.default_rng(6).integers(0, 2000, 3000).astype(
        np.int32)
    indptr = np.concatenate([[0], np.cumsum([a.size for a in nbrs])]
                            ).astype(np.int64)
    indices = np.concatenate(nbrs).astype(np.int32)
    frontier, visited = _indicators(2000, seed=8)
    visited[5] = 0.0   # the hub is unvisited: its OR over 25 tiles decides
    s = RS.LoopScheduler(p=1, cache_size=0).schedule(RS.DegreeCosts(indptr))
    assert np.unique(np.nonzero(s.item_id == 5)[0]).size >= 20
    mask, cols = RT.pack_csr(indptr, indices,
                             np.ones(len(indices), np.float32), s.tiles)
    nxt_ref = ref_ich_bfs_step(jnp.asarray(mask), jnp.asarray(cols),
                               jnp.asarray(s.item_id), jnp.asarray(frontier),
                               jnp.asarray(visited), 2000, interpret=True)
    t = [torch.from_numpy(a) for a in (mask, cols, s.item_id, frontier,
                                       visited)]
    nxt = K.ich_bfs_step_plain(*t, 2000)
    np.testing.assert_array_equal(nxt.numpy(), np.asarray(nxt_ref))
    np.testing.assert_array_equal(
        nxt.numpy(), np_bfs_step_ref(indptr, indices, frontier, visited))
    assert nxt[5] == 1.0


@pytest.mark.parametrize("p", [1, 2, 4])
@pytest.mark.parametrize("B", [1, 4, 8])
def test_sharded_plain_bit_identical_to_sequential(p, B):
    indptr, indices = bfs_graph("scale_free", 160, seed=20 + p)
    frontier, visited = _indicators(160, seed=p)
    tiles = PT.build_schedule(np.diff(indptr))
    sizes = np.diff(indptr)
    shards = PT.shard_schedule(tiles, tiles.tile_cost(sizes, sizes), p,
                               superstep=B)
    mask, cols = PT.pack_csr(indptr, indices,
                             np.ones(len(indices), np.float32), tiles,
                             pad_tiles_to=B)
    f, v = torch.from_numpy(frontier), torch.from_numpy(visited)
    T = tiles.n_tiles
    seq = K.ich_bfs_step(torch.from_numpy(mask[:T]),
                         torch.from_numpy(cols[:T]),
                         torch.from_numpy(tiles.item_id), f, v, 160)
    sh = K.ich_bfs_step_sharded(
        torch.from_numpy(mask), torch.from_numpy(cols),
        torch.from_numpy(shards.shard_item_id(tiles.item_id)),
        torch.from_numpy(shards.kernel_block_ids()), f, v, 160, p, B)
    assert torch.equal(sh, seq)


@pytest.mark.parametrize("n,kind,R", [(100, "uniform", 4),
                                      (256, "scale_free", 8),
                                      (200, "uniform", 8),
                                      (150, "scale_free", 16)])
def test_levels_match_reference(n, kind, R):
    indptr, indices = bfs_graph(kind, n, seed=n)
    ref = RS.LoopScheduler(p=4, rows_per_tile=R).build("bfs", indptr,
                                                        indices)
    op = PS.LoopScheduler(p=4, rows_per_tile=R, device="cpu").build(
        "bfs", indptr, indices)
    level = op.levels(0)
    assert level.dtype == torch.int32 and level.device.type == "cpu"
    np.testing.assert_array_equal(level.numpy(),
                                  ref.levels(0, interpret=True))
    np.testing.assert_array_equal(level.numpy(),
                                  np_bfs_levels_ref(indptr, indices, 0))
    assert torch.equal(level, bfs_levels_ref(torch.from_numpy(indptr),
                                             torch.from_numpy(indices), 0))


def test_isolated_source():
    # v0 has no in-neighbors; v1 <- v0, v2 <- v1: from v2 nothing is reached
    indptr = np.array([0, 0, 1, 2], np.int64)
    indices = np.array([0, 1], np.int32)
    op = PS.LoopScheduler(p=2, rows_per_tile=4, device="cpu").build(
        "bfs", indptr, indices)
    np.testing.assert_array_equal(op.levels(0).numpy(), [0, 1, 2])
    np.testing.assert_array_equal(op.levels(2).numpy(), [-1, -1, 0])


def test_empty_graph_is_a_noop():
    K.reset_launches()
    op = PS.LoopScheduler(p=2, device="cpu").build(
        "bfs", np.zeros(1, np.int64), np.zeros(0, np.int32))
    assert op.n_tiles == 0
    nxt = op.step(np.zeros(0, np.float32), np.zeros(0, np.float32))
    assert nxt.shape == (0,) and nxt.dtype == torch.float32
    assert op.last_costs.shape == op.shards.block_perm.shape
    assert not op.last_costs.any()
    assert op.observe().refine().n_tiles == 0
    # the wrapper itself runs nothing on an empty payload
    z = torch.zeros(0)
    out, costs = K.ich_bfs_step_sharded(
        torch.zeros((0, 8, 8)), torch.zeros((0, 8, 8), dtype=torch.int32),
        torch.full((16, 8), -1, dtype=torch.int32),
        torch.zeros(2, dtype=torch.int32), z, z, 0, 2, 8,
        slot_cost=torch.zeros((0, 8)))
    assert out.shape == (0,) and costs.shape == (2, 1) and not costs.any()
    assert K.LAUNCHES == {"ich_bfs_step": 0, "ich_bfs_step_sharded": 0}


def test_segmented_max_folds_split_rows():
    # rows 2 and 5 are split within and across tiles; max ORs them and
    # leaves rows no slot names untouched
    rows = torch.tensor([[0, 2, 2, 2], [2, 5, 5, -1], [5, 6, 6, 7]],
                        dtype=torch.int32)
    vals = torch.tensor([[0.0, 0.0, 1.0, 0.0], [0.0, 0.0, 0.0, 1.0],
                         [1.0, 0.0, 0.0, 1.0]])
    out = torch.tensor([0.0, 1.0, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0])
    PSEG.segmented_apply(out, rows, vals, combine="max")
    np.testing.assert_array_equal(out.numpy(),
                                  [0.0, 1.0, 1.0, 1.0, 0.0, 1.0, 0.0, 1.0])
    with pytest.raises(ValueError, match="combine"):
        PSEG.segmented_apply(out, rows, vals, combine="min")


@pytest.mark.parametrize("p", [1, 2, 3, 5, 8])
def test_worker_reduce_max_matches_reference_tree(p):
    rng = np.random.default_rng(p)
    acc = (rng.random((p, 40)) < 0.2).astype(np.float32)
    np.testing.assert_array_equal(
        PSEG.worker_reduce(torch.from_numpy(acc), "max").numpy(),
        np.asarray(ref_worker_reduce(jnp.asarray(acc), "max")))


@pytest.mark.parametrize("kind", ["uniform", "scale_free"])
def test_graph_generator_matches_reference_draws(kind):
    indptr, indices = bfs_graph(kind, 3000, seed=7)
    _, static_est = RW.bfs_levels(kind, 3000, seed=7)
    # the reference's static estimate is 0.5 + 1 + degree
    np.testing.assert_array_equal(np.diff(indptr) + 1.5, static_est)
    ref_indptr, ref_indices = RW._random_graph_csr(np.diff(indptr), 8)
    np.testing.assert_array_equal(indptr, ref_indptr)
    np.testing.assert_array_equal(indices, ref_indices)
    assert int(np.diff(indptr).max()) <= 3000 // 10


def test_wrappers_refuse_mixed_devices_and_bad_layouts():
    indptr, indices = bfs_graph("uniform", 64, seed=1)
    op = PS.LoopScheduler(p=2, device="cpu").build("bfs", indptr, indices)
    f = torch.zeros(64)
    with pytest.raises(ValueError, match="shard layout"):
        K.ich_bfs_step_sharded(op.mask, op.cols, op.rowid,
                               torch.zeros(3, dtype=torch.int32), f, f, 64,
                               2, op.superstep)
    with pytest.raises(ValueError, match="all on CUDA"):
        K.ich_bfs_step(op.mask, op.cols, op.rowid,
                       torch.zeros(64, device="meta"), f, 64)
    with pytest.raises(ValueError, match="shape"):
        op.step(torch.zeros(63), torch.zeros(63))
    with pytest.raises(ValueError, match="lies on"):
        op.step(torch.zeros(64, device="meta"), f)
    with pytest.raises(ValueError, match="edge targets"):
        PS.LoopScheduler(p=2, device="cpu").build("bfs", indptr, indices + 64)
