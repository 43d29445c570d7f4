"""Kernel parity for the iCh SpMV: the reference's Pallas kernels (interpret
mode, as tests/test_kernels.py and tests/test_sharding.py run them)
against the port's plain versions fed the same lowering through
`repro_torch.convert`, plus the bit-identity bars inside the port.

Tolerances: y is compared at rtol=atol=1e-5 because XLA sums a tile's
slots in another order than the port's fixed left folds; the cost stream
is compared exactly (nnz slot costs are small integers in float32, so any
summation order gives the same bits)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from conftest import random_csr
from repro.core import tiling as RT
from repro.core.segmented import worker_reduce as ref_worker_reduce
from repro.kernels.ich_spmv.ich_spmv import ich_spmv as ref_ich_spmv
from repro.kernels.ich_spmv.ich_spmv import \
    ich_spmv_sharded as ref_ich_spmv_sharded
from repro.sched import LoopScheduler as RefScheduler
from repro.sched.kernels import _flat_slot_cost as ref_flat_slot_cost
from repro_torch import convert
from repro_torch.core import segmented as PS
from repro_torch.core import tiling as PT
from repro_torch.kernels.ich_spmv import ich_spmv as K
from repro_torch.kernels.ich_spmv.ref import spmv_ref, tiles_ref

N = 240


def _inputs(seed=0, n=N):
    indptr, indices, data = random_csr(n, seed=seed)
    x = np.random.default_rng(seed + 100).standard_normal(n).astype(
        np.float32)
    return indptr, indices, data, x


def _ref_lowering(indptr, indices, data, p, B):
    s = RefScheduler(p=p, superstep=B, cache_size=0).schedule(
        np.diff(indptr))
    shards = s.shard()
    vals, cols = RT.pack_csr(indptr, indices, data, s.tiles, pad_tiles_to=B)
    return s, shards, vals, cols, ref_flat_slot_cost(s,
                                                     shards.n_tiles_padded)


@pytest.mark.parametrize("p,B", [(1, 1), (1, 8), (4, 1), (4, 8)])
def test_sharded_plain_matches_reference_kernel(p, B):
    indptr, indices, data, x = _inputs(seed=p * 10 + B)
    s, shards, vals, cols, sc = _ref_lowering(indptr, indices, data, p, B)
    y_ref, c_ref = ref_ich_spmv_sharded(
        jnp.asarray(vals), jnp.asarray(cols),
        jnp.asarray(shards.shard_item_id(s.tiles)),
        jnp.asarray(shards.kernel_block_ids()), jnp.asarray(x), N, p, B,
        slot_cost=jnp.asarray(sc), interpret=True)
    op = convert.spmv_op_from_reference(
        item_id=s.item_id, width=s.width, rows_per_tile=s.rows_per_tile,
        worker=shards.worker, block_perm=shards.block_perm, superstep=B,
        vals=vals, cols=cols, slot_cost=sc, n_rows=N, device="cpu")
    y = op(x)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(op.last_costs.numpy(), np.asarray(c_ref))


def test_sequential_plain_matches_reference_kernel():
    indptr, indices, data, x = _inputs(seed=7)
    s = RefScheduler(p=1, cache_size=0).schedule(np.diff(indptr))
    vals, cols = RT.pack_csr(indptr, indices, data, s.tiles)
    y_ref = ref_ich_spmv(jnp.asarray(vals), jnp.asarray(cols),
                         jnp.asarray(s.item_id), jnp.asarray(x), N,
                         interpret=True)
    y = K.ich_spmv(torch.from_numpy(vals), torch.from_numpy(cols),
                   torch.from_numpy(s.item_id), torch.from_numpy(x), N)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), rtol=1e-5,
                               atol=1e-5)
    # and both agree with the oracles that do not fold tiles
    t = [torch.from_numpy(a) for a in (indptr, indices, data, x)]
    torch.testing.assert_close(y, spmv_ref(*t), rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(
        y, tiles_ref(torch.from_numpy(vals), torch.from_numpy(cols),
                     torch.from_numpy(s.item_id), t[3], N),
        rtol=1e-5, atol=1e-5)


def test_sequential_plain_matches_reference_kernel_on_a_long_run():
    # the input class the flat walk's run owners are built for: one row
    # whose run of slots crosses many tiles (here 63 at W = 8), folded by
    # one thread on the card, slot by slot, tiles ascending
    rng = np.random.default_rng(11)
    row_nnz = rng.integers(0, 6, 2000)
    row_nnz[3] = 4000
    indptr = np.concatenate([[0], np.cumsum(row_nnz)]).astype(np.int64)
    n = row_nnz.size
    indices = rng.integers(0, n, int(indptr[-1])).astype(np.int32)
    data = rng.standard_normal(int(indptr[-1])).astype(np.float32)
    x = rng.standard_normal(n).astype(np.float32)
    s = RefScheduler(p=1, cache_size=0).schedule(np.diff(indptr))
    assert np.unique(np.nonzero(s.item_id == 3)[0]).size >= 20
    vals, cols = RT.pack_csr(indptr, indices, data, s.tiles)
    y_ref = ref_ich_spmv(jnp.asarray(vals), jnp.asarray(cols),
                         jnp.asarray(s.item_id), jnp.asarray(x), n,
                         interpret=True)
    t = [torch.from_numpy(a) for a in (vals, cols, s.item_id, x)]
    y = K.ich_spmv_plain(*t, n)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), rtol=1e-5,
                               atol=1e-5)
    assert PS.longest_run(t[2]) == int((s.item_id == 3).sum())


@pytest.mark.parametrize("p", [1, 2, 4])
@pytest.mark.parametrize("B", [1, 4, 8])
def test_sharded_plain_bit_identical_to_sequential(p, B):
    indptr, indices, data, x = _inputs(seed=p)
    tiles = PT.build_schedule(np.diff(indptr))
    sizes = np.diff(indptr)
    shards = PT.shard_schedule(tiles, tiles.tile_cost(sizes, sizes), p,
                               superstep=B)
    vals, cols = PT.pack_csr(indptr, indices, data, tiles, pad_tiles_to=B)
    xt = torch.from_numpy(x)
    y_seq = K.ich_spmv(torch.from_numpy(vals[:tiles.n_tiles]),
                       torch.from_numpy(cols[:tiles.n_tiles]),
                       torch.from_numpy(tiles.item_id), xt, N)
    y_sh = K.ich_spmv_sharded(
        torch.from_numpy(vals), torch.from_numpy(cols),
        torch.from_numpy(shards.shard_item_id(tiles.item_id)),
        torch.from_numpy(shards.kernel_block_ids()), xt, N, p, B)
    assert torch.equal(y_sh, y_seq)  # bitwise: same adds in the same order


def test_empty_schedule_returns_zeros():
    from repro_torch.sched import LoopScheduler
    # a matrix with no rows lowers to a 0-tile schedule: zero output, an
    # all-zero cost stream of the layout's shape
    op = LoopScheduler(p=4, device="cpu").build(
        "spmv", np.zeros(1, np.int64), np.zeros(0, np.int32),
        np.zeros(0, np.float32))
    assert op.n_tiles == 0
    assert op(np.zeros(0, np.float32)).shape == (0,)
    assert op.last_costs.shape == op.shards.block_perm.shape
    assert not op.last_costs.any()
    # rows without nonzeros still own a slot each, and come out as zeros
    op = LoopScheduler(p=4, device="cpu").build(
        "spmv", np.zeros(6, np.int64), np.zeros(0, np.int32),
        np.zeros(0, np.float32))
    assert op.n_tiles == 1
    assert torch.equal(op(np.ones(5, np.float32)), torch.zeros(5))


@pytest.mark.parametrize("p", [1, 2, 3, 5, 8])
def test_worker_reduce_matches_reference_tree(p):
    rng = np.random.default_rng(p)
    acc = rng.standard_normal((p, 40)).astype(np.float32)
    acc[rng.random((p, 40)) < 0.5] = 0.0
    np.testing.assert_array_equal(
        PS.worker_reduce(torch.from_numpy(acc)).numpy(),
        np.asarray(ref_worker_reduce(jnp.asarray(acc), "add")))


def test_segmented_apply_folds_split_rows_in_tile_order():
    # rows 2 and 5 are split within and across tiles; the fold must be
    # exactly ((0 + s_tile0) + s_tile1) with slots summed per tile first
    rows = torch.tensor([[0, 2, 2, 2], [2, 5, 5, -1], [5, 6, 6, 7]],
                        dtype=torch.int32)
    vals = torch.tensor([[1.0, 1e8, 1.0, -1e8], [3.0, 0.5, 0.25, 9.0],
                         [4.0, 1.0, 2.0, 8.0]])
    out = PS.segmented_apply(torch.zeros(8), rows, vals)
    f = np.float32
    expect = np.zeros(8, np.float32)
    expect[0] = f(1.0)
    expect[2] = f(f(f(1e8) + f(1.0)) + f(-1e8)) + f(3.0)
    expect[5] = f(f(0.5) + f(0.25)) + f(4.0)
    expect[6] = f(3.0)
    expect[7] = f(8.0)
    np.testing.assert_array_equal(out.numpy(), expect)
    costs = PS.emit_step_cost(rows, torch.ones(3, 4))
    np.testing.assert_array_equal(costs.numpy(), [4.0, 3.0, 4.0])


def test_wrappers_refuse_mixed_devices_and_bad_layouts():
    indptr, indices, data, x = _inputs(seed=3)
    tiles = PT.build_schedule(np.diff(indptr))
    vals, cols = PT.pack_csr(indptr, indices, data, tiles)
    with pytest.raises(ValueError, match="shard layout"):
        K.ich_spmv_sharded(torch.from_numpy(vals), torch.from_numpy(cols),
                           torch.from_numpy(tiles.item_id),
                           torch.zeros(3, dtype=torch.int32),
                           torch.from_numpy(x), N, 2, 8)
    with pytest.raises(ValueError, match="all on CUDA"):
        K._on_cpu(torch.zeros(1), torch.zeros(1, device="meta"))


# the layouts the card's sharded walk is tested on (tests/test_torch_cuda.py
# drives them at larger sizes): name -> (p, B, W)
WALK_LAYOUTS = {
    "run_across_supersteps": (2, 4, 8),
    "all_padding_workers": (8, 4, 8),
    "w1": (2, 4, 1),
    "w3": (4, 1, 3),
}


def _walk_layout_csr(case):
    rng = np.random.default_rng(list(WALK_LAYOUTS).index(case))
    if case == "run_across_supersteps":
        row_nnz = rng.integers(0, 6, 300)
        row_nnz[11] = 2000          # a run of 250 slots, 32 tiles
    elif case == "all_padding_workers":
        row_nnz = rng.integers(1, 5, 30)   # one block for 8 workers
    else:
        row_nnz = np.minimum(rng.zipf(1.8, 200), 40)
        row_nnz[rng.random(200) < 0.1] = 0
    n = row_nnz.size
    indptr = np.concatenate([[0], np.cumsum(row_nnz)]).astype(np.int64)
    indices = rng.integers(0, n, int(indptr[-1])).astype(np.int32)
    data = rng.standard_normal(int(indptr[-1])).astype(np.float32)
    x = rng.standard_normal(n).astype(np.float32)
    return indptr, indices, data, x


@pytest.mark.parametrize("case", list(WALK_LAYOUTS))
def test_sharded_plain_matches_reference_on_walk_layouts(case):
    p, B, W = WALK_LAYOUTS[case]
    indptr, indices, data, x = _walk_layout_csr(case)
    n = indptr.size - 1
    s = RefScheduler(p=p, superstep=B, cache_size=0).schedule(
        np.diff(indptr), width=W)
    shards = s.shard()
    assert s.width == W
    if case == "run_across_supersteps":
        tiles = np.unique(np.nonzero(s.item_id == 11)[0])
        assert tiles.size > 2 * B
        assert np.unique(shards.worker[tiles]).size == 1
    if case == "all_padding_workers":
        assert (shards.block_perm < 0).all(axis=1).any()
    vals, cols = RT.pack_csr(indptr, indices, data, s.tiles, pad_tiles_to=B)
    sc = ref_flat_slot_cost(s, shards.n_tiles_padded)
    y_ref, c_ref = ref_ich_spmv_sharded(
        jnp.asarray(vals), jnp.asarray(cols),
        jnp.asarray(shards.shard_item_id(s.tiles)),
        jnp.asarray(shards.kernel_block_ids()), jnp.asarray(x), n, p, B,
        slot_cost=jnp.asarray(sc), interpret=True)
    op = convert.spmv_op_from_reference(
        item_id=s.item_id, width=W, rows_per_tile=s.rows_per_tile,
        worker=shards.worker, block_perm=shards.block_perm, superstep=B,
        vals=vals, cols=cols, slot_cost=sc, n_rows=n, device="cpu")
    y = op(x)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(op.last_costs.numpy(), np.asarray(c_ref))
    # inside the port: the flat walk's plain version, bit for bit
    T = s.n_tiles
    y_flat = K.ich_spmv(torch.from_numpy(vals[:T]), torch.from_numpy(cols[:T]),
                        torch.from_numpy(s.item_id), torch.from_numpy(x), n)
    assert torch.equal(y, y_flat)
