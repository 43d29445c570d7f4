"""The port's schedule pipeline on tensors (`repro_torch.core.tiling_torch`)
and its two kernels' plain versions (`repro_torch.kernels.lpt`), held to the
reference's numpy construction (`repro.core.tiling`) on the CPU.

The bar is the reference's own for its jitted pipeline
(tests/test_tiling_jax.py, which cannot import on this jax): ELEMENT-
IDENTICAL outputs, float64 tile costs and float32 slot costs bit for bit,
never close. The cases mirror that suite — hypothesis properties (skipped
where hypothesis is absent), the zipf twin seeds through the full lowering
at several (p, B), int32/int64 sizes x float32/float64 costs, the paper-grid
families, empty sizes, the `n_steps=` path, `pack_csr_torch`, and the
backend seam's cache generations with `backend="torch"` — and add the
cases where the tensor formulation could part from numpy's: one R per
branch of numpy's pairwise sum (5, 12, 136), chains of equal cost (LPT ties
to the smallest worker id), chains of zero cost (signed zeros in the sort),
one item spanning many blocks (a long chain), widths at exact powers of
two, and `segment_fold` / `lpt_assign` against `np.bincount` / heapq."""
import heapq

import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st
from _lpt_rounds import ROUND_WINDOW, round_lpt

from repro.core import tiling as T
from repro.core import workloads as WL
from repro.sched.costs import ExplicitCosts as RefExplicitCosts
from repro_torch.core import tiling_torch as TT
from repro_torch.kernels.lpt import lpt as L
from repro_torch.sched import ExplicitCosts, LoopScheduler, Schedule

CPU = "cpu"


def _random_sizes(n, zipf_a, seed, max_size=300):
    rng = np.random.default_rng(seed)
    return np.minimum(rng.zipf(zipf_a, n), max_size).astype(np.int64)


def _random_costs(sizes, seed):
    rng = np.random.default_rng(seed + 1000)
    return (1.0 + sizes) * rng.uniform(0.5, 2.0, sizes.size)


def _numpy_lowering(sizes, costs, *, p, superstep, rows_per_tile=8,
                    width=None):
    """The reference's host arrays, in the layout DeviceLowering mirrors
    (shard_item_id / kernel_block_ids / padded slot cost)."""
    sched = T.build_schedule(sizes, rows_per_tile=rows_per_tile, width=width)
    tile_cost = sched.tile_cost(costs, sizes)
    shards = T.shard_schedule(sched, tile_cost, p, superstep=superstep)
    slot = np.zeros((shards.n_tiles_padded, sched.rows_per_tile), np.float32)
    slot[:sched.n_tiles] = sched.slot_cost(costs, sizes)
    return sched, tile_cost, shards, slot


def _eq(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.dtype == np.asarray(want).dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


def assert_lowering_matches(low, sizes, costs, *, p, superstep,
                            rows_per_tile=8, width=None):
    sched, tile_cost, shards, slot = _numpy_lowering(
        sizes, costs, p=p, superstep=superstep, rows_per_tile=rows_per_tile,
        width=width)
    host = low.schedule.to_host()
    assert host.width == sched.width and host.n_items == sched.n_items
    _eq(host.item_id, sched.item_id)
    _eq(host.seg_start, sched.seg_start)
    _eq(host.seg_len, sched.seg_len)
    # float costs: bit-identical, not merely close
    _eq(low.tile_cost, tile_cost)
    _eq(low.worker, shards.worker)
    _eq(low.block_perm, shards.block_perm)
    _eq(low.rowid, shards.shard_item_id(sched))
    _eq(low.blkid, shards.kernel_block_ids())
    _eq(low.slot_cost, slot)
    back = low.to_host_shards()
    _eq(back.worker, shards.worker)
    _eq(back.block_perm, shards.block_perm)
    assert back.superstep == shards.superstep


def _lower(sizes, costs, **kw):
    return TT.lower_schedule_torch(sizes, costs, device=CPU, **kw)


# --------------------------------------------------------------- hypothesis
# sizes mix zeros, band-sized items, and heavy outliers so splitting,
# padding, and the zero-item slot rule all get exercised
_SIZES = st.lists(st.one_of(st.just(0), st.integers(0, 40),
                            st.integers(200, 3000)),
                  min_size=1, max_size=120)


@settings(max_examples=30, deadline=None)
@given(sizes=_SIZES, R=st.integers(1, 17),
       W=st.one_of(st.none(), st.integers(1, 600)),
       dtype=st.sampled_from([np.int32, np.int64]))
def test_build_matches_numpy(sizes, R, W, dtype):
    sizes = np.asarray(sizes, dtype)
    ref = T.build_schedule(sizes, rows_per_tile=R, width=W)
    dev = TT.build_schedule_torch(sizes, rows_per_tile=R, width=W,
                                  device=CPU).to_host()
    assert dev.width == ref.width and dev.n_items == ref.n_items
    _eq(dev.item_id, ref.item_id)
    _eq(dev.seg_start, ref.seg_start)
    _eq(dev.seg_len, ref.seg_len)
    item, start, length = T.split_items(sizes, ref.width)
    titem, tstart, tlen = TT.split_items_torch(sizes, ref.width, device=CPU)
    _eq(titem, item)
    _eq(tstart, start)
    _eq(tlen, length)
    assert int(TT.ich_tile_width_torch(sizes, device=CPU)) == \
        T.ich_tile_width(sizes)


def _csr_for(sizes, seed, dtype):
    rng = np.random.default_rng(seed)
    indptr = np.concatenate([[0], np.cumsum(sizes)])
    nnz = int(indptr[-1])
    indices = rng.integers(0, max(sizes.size, 1), nnz).astype(np.int32)
    data = (rng.integers(1, 100, nnz).astype(dtype)
            if np.issubdtype(dtype, np.integer)
            else rng.standard_normal(nnz).astype(dtype))
    return indptr, indices, data


@settings(max_examples=20, deadline=None)
@given(sizes=_SIZES, R=st.integers(1, 17), seed=st.integers(0, 99),
       pad=st.integers(1, 5),
       dtype=st.sampled_from([np.float32, np.float64, np.int32]))
def test_pack_matches_numpy(sizes, R, seed, pad, dtype):
    _check_pack(np.asarray(sizes, np.int64), R, seed, pad, dtype)


def _check_pack(sizes, R, seed, pad, dtype):
    sched = T.build_schedule(sizes, rows_per_tile=R)
    indptr, indices, data = _csr_for(sizes, seed, dtype)
    ref_v, ref_c = T.pack_csr(indptr, indices, data, sched,
                              pad_tiles_to=pad)
    dev = TT.build_schedule_torch(sizes, rows_per_tile=R, device=CPU)
    tv, tc = TT.pack_csr_torch(indptr, indices, data, dev, pad_tiles_to=pad)
    _eq(tv, ref_v)
    _eq(tc, ref_c)
    # a host TileSchedule and tensor CSR inputs pack the same bytes
    hv, hc = TT.pack_csr_torch(torch.from_numpy(indptr),
                               torch.from_numpy(indices),
                               torch.from_numpy(data), sched,
                               pad_tiles_to=pad, device=CPU)
    _eq(hv, ref_v)
    _eq(hc, ref_c)


@settings(max_examples=20, deadline=None)
@given(sizes=_SIZES, p=st.integers(1, 8), B=st.integers(1, 4),
       seed=st.integers(0, 99))
def test_partition_and_lowering_match_numpy(sizes, p, B, seed):
    sizes = np.asarray(sizes, np.int64)
    costs = _random_costs(sizes, seed)
    sched = T.build_schedule(sizes)
    tile_cost = sched.tile_cost(costs, sizes)
    ref = T.partition_tiles(tile_cost, sched.item_id, p, block=B)
    dev = TT.partition_tiles_torch(tile_cost, sched.item_id, p, block=B,
                                   device=CPU)
    _eq(dev, ref)
    low = _lower(sizes, costs, p=p, superstep=B)
    assert_lowering_matches(low, sizes, costs, p=p, superstep=B)


# ------------------------------------------------- deterministic twin seeds
@pytest.mark.parametrize("n,zipf_a,seed", [
    (500, 1.3, 0), (500, 2.0, 1), (2000, 1.3, 2), (2000, 1.6, 3),
    (97, 1.5, 4), (4096, 2.2, 5),
])
@pytest.mark.parametrize("p", [1, 3, 4, 8])
def test_pipeline_matches_numpy_twin_seeds(n, zipf_a, seed, p):
    sizes = _random_sizes(n, zipf_a, seed)
    costs = _random_costs(sizes, seed)
    low = _lower(sizes, costs, p=p)
    assert_lowering_matches(low, sizes, costs, p=p, superstep=low.superstep)


@pytest.mark.parametrize("p,B", [(2, 1), (3, 2), (5, 3), (8, 4), (16, 8)])
def test_pipeline_matches_numpy_across_supersteps(p, B):
    sizes = _random_sizes(1500, 1.4, 17)
    costs = _random_costs(sizes, 17)
    low = _lower(sizes, costs, p=p, superstep=B)
    assert_lowering_matches(low, sizes, costs, p=p, superstep=B)


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
@pytest.mark.parametrize("cdtype", [np.float32, np.float64])
def test_pipeline_matches_numpy_across_dtypes(dtype, cdtype):
    sizes = _random_sizes(1200, 1.5, 7).astype(dtype)
    costs = _random_costs(sizes.astype(np.int64), 7).astype(cdtype)
    low = _lower(sizes, costs, p=4)
    assert_lowering_matches(low, sizes, costs, p=4, superstep=low.superstep)


def test_pipeline_no_sync_path_identical():
    """Passing n_steps= (the refine-loop steady state, no device->host
    sync) must produce the identical lowering."""
    sizes = _random_sizes(1500, 1.4, 11)
    costs = _random_costs(sizes, 11)
    low = _lower(sizes, costs, p=4)
    low2 = _lower(sizes, costs, p=4, n_steps=low.n_steps)
    assert low2.n_steps == low.n_steps
    for name in ("tile_cost", "worker", "block_perm", "rowid", "blkid",
                 "slot_cost"):
        assert torch.equal(getattr(low2, name), getattr(low, name)), name
    # a larger S_B only pads the layout; the blocks stay where they were
    wide = _lower(sizes, costs, p=4, n_steps=low.n_steps + 2)
    assert torch.equal(wide.block_perm[:, :low.n_steps], low.block_perm)
    assert (wide.block_perm[:, low.n_steps:] == -1).all()


@pytest.mark.parametrize("family", ["FullChip", "road_usa", "arabic-2005",
                                    "scale_free_bfs"])
def test_pipeline_matches_numpy_paper_grid(family):
    """The lowering equality over paper-grid cost families (SpMV Table-1
    matrices, BFS frontier degrees)."""
    if family == "scale_free_bfs":
        levels, _ = WL.bfs_levels("scale_free", 3000)
        sizes = np.maximum(np.asarray(levels[0], np.int64), 1)
        costs = sizes.astype(np.float64)
    else:
        spec = next(s for s in WL.TABLE1 if s.name == family)
        nnz = WL.matrix_row_nnz(spec, 4000).astype(np.int64)
        sizes, costs = np.maximum(nnz, 1), 1.0 + nnz
    low = _lower(sizes, costs, p=8)
    assert_lowering_matches(low, sizes, costs, p=8, superstep=low.superstep)


def test_empty_sizes_zero_tile_lowering():
    low = _lower(np.zeros(0, np.int64), np.zeros(0), p=4)
    assert low.schedule.n_tiles == 0 and low.n_steps == 1
    assert (low.block_perm == -1).all() and (low.rowid == -1).all()
    assert tuple(low.slot_cost.shape) == (0, 8)
    host = low.schedule.to_host()
    assert host.n_tiles == 0 and host.n_items == 0
    assert _lower(np.zeros(0, np.int64), np.zeros(0), p=4,
                  n_steps=3).n_steps == 3
    assert TT.build_schedule_torch(np.zeros(0, np.int64),
                                   device=CPU).n_tiles == 0
    for t in TT.split_items_torch(np.zeros(0, np.int64), 8, device=CPU):
        assert t.numel() == 0


# ------------------------------------------ where tensors could part from numpy
@pytest.mark.parametrize("R", [5, 12, 136])
def test_pairwise_rowsum_branches_bit_identical(R):
    """One R per branch of numpy's pairwise sum: sequential (< 8), eight
    accumulators (8..128), halved recursion (> 128)."""
    rng = np.random.default_rng(R)
    x = rng.uniform(0.0, 1.0, (400, R)) * rng.uniform(1.0, 1e6, (400, 1))
    _eq(TT._pairwise_rowsum(torch.from_numpy(x)), x.sum(axis=1))
    sizes = _random_sizes(900, 1.5, R)
    costs = _random_costs(sizes, R)
    low = _lower(sizes, costs, p=4, superstep=2, rows_per_tile=R)
    assert_lowering_matches(low, sizes, costs, p=4, superstep=2,
                            rows_per_tile=R)


def test_equal_cost_chains_tie_to_smallest_worker():
    """Every chain costs the same: each LPT step is a tie, broken to the
    smallest worker id as heapq's (load, worker) tuples break it."""
    sizes = np.full(640, 8, np.int64)
    costs = np.full(640, 3.0)
    for p in (3, 4, 7):
        low = _lower(sizes, costs, p=p, superstep=2, width=8)
        assert_lowering_matches(low, sizes, costs, p=p, superstep=2,
                                width=8)
        assert int(low.worker[0]) == 0


def test_zero_cost_chains_keep_their_order():
    """Zero-cost chains (and -0.0 costs) sort as equals, after every
    costed chain, in chain order — as numpy's stable argsort puts them."""
    rng = np.random.default_rng(5)
    sizes = rng.integers(1, 30, 700).astype(np.int64)
    costs = rng.uniform(1.0, 5.0, 700)
    costs[rng.random(700) < 0.4] = 0.0
    costs[rng.random(700) < 0.1] = -0.0
    for p in (2, 5):
        low = _lower(sizes, costs, p=p, superstep=4)
        assert_lowering_matches(low, sizes, costs, p=p, superstep=4)


def test_one_item_spanning_many_blocks():
    """A hub item split over hundreds of tiles: one chain of many blocks,
    the segment fold's longest run."""
    rng = np.random.default_rng(9)
    sizes = rng.integers(1, 20, 900).astype(np.int64)
    sizes[450] = 40_000
    costs = 1.0 + sizes * rng.uniform(0.5, 2.0, 900)
    low = _lower(sizes, costs, p=6, superstep=4, width=16)
    assert_lowering_matches(low, sizes, costs, p=6, superstep=4, width=16)
    chain = T.block_chains(low.schedule.to_host().item_id, 4)
    assert np.bincount(chain).max() > 50


@pytest.mark.parametrize("W", [1, 8, 16, 64, 512])
def test_widths_at_exact_powers_of_two(W):
    """Items of exactly W units fill one segment each; the band of a mean
    at a power of two resolves the same W on both paths."""
    sizes = np.full(300, W, np.int64)
    sizes[::7] = 2 * W
    costs = _random_costs(sizes, W)
    low = _lower(sizes, costs, p=4, width=W)
    assert_lowering_matches(low, sizes, costs, p=4, superstep=8, width=W)
    flat = np.full(64, W, np.int64)
    for eps in (0.0, 0.33):
        assert int(TT.ich_tile_width_torch(flat, eps, 1, 4096,
                                           device=CPU)) == \
            T.ich_tile_width(flat, eps, 1, 4096)
        low = _lower(flat, flat.astype(np.float64), p=2, eps=eps, min_w=1,
                     max_w=4096)
        assert low.schedule.width == T.ich_tile_width(flat, eps, 1, 4096)


@pytest.mark.parametrize("R,pad,dtype", [(8, 1, np.float32),
                                         (3, 4, np.float64),
                                         (17, 5, np.int32)])
def test_pack_csr_torch_matches_numpy(R, pad, dtype):
    sizes = _random_sizes(700, 1.4, R)
    sizes[::11] = 0
    _check_pack(sizes, R, R, pad, dtype)


def test_pack_csr_torch_without_payload():
    sizes = np.zeros(5, np.int64)
    sched = TT.build_schedule_torch(sizes, device=CPU)
    v, c = TT.pack_csr_torch(np.zeros(6, np.int64), np.zeros(0, np.int32),
                             np.zeros(0, np.float32), sched, pad_tiles_to=4)
    assert tuple(v.shape) == (4, 8, 8) and not v.any() and not c.any()


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sizes = _random_sizes(50, 1.5, 0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TT.lower_schedule_torch(sizes, sizes.astype(float), p=2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TT.build_schedule_torch(sizes)
    s = LoopScheduler(p=2, device=CPU).schedule(sizes.astype(float))
    hand = Schedule(sizes=s.sizes, costs=s.costs, policy=s.policy, p=2,
                    tiles=s.tiles)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        hand.device_lowering()
    with pytest.raises(ValueError, match="backend"):
        LoopScheduler(p=2, device=CPU, backend="jax")


# ------------------------------------------------------- the two kernels
@pytest.mark.parametrize("seed", range(4))
def test_segment_fold_plain_matches_bincount(seed):
    rng = np.random.default_rng(seed)
    runs = rng.integers(0, 9, 300)           # empty segments included
    seg = np.repeat(np.arange(300), runs)
    values = rng.uniform(-1.0, 1.0, seg.size) * 10.0 ** rng.integers(
        -8, 8, seg.size)
    got = L.segment_fold(torch.from_numpy(values), torch.from_numpy(seg),
                         320)
    want = np.bincount(seg, weights=values, minlength=320)
    _eq(got, want)
    assert L.LAUNCHES["segment_fold"] == 0   # the CPU ran the plain version
    assert not L.segment_fold(torch.zeros(0, dtype=torch.float64),
                              torch.zeros(0, dtype=torch.int64), 3).any()


def _heapq_lpt(cost, order, n_real, p):
    heap = [(0.0, w) for w in range(p)]
    out = np.full(order.size, -1, np.int32)
    for c in order:
        if c < n_real:
            load, w = heapq.heappop(heap)
            out[c] = w
            heapq.heappush(heap, (load + float(cost[c]), w))
    return out


@pytest.mark.parametrize("p", [1, 2, 5, 33])
def test_lpt_assign_plain_matches_heapq(p):
    rng = np.random.default_rng(p)
    n, n_real = 400, 350
    cost = np.zeros(n)
    cost[:n_real] = np.round(rng.uniform(0.0, 4.0, n_real), 1)  # many ties
    order = np.argsort(-cost + 0.0, kind="stable")
    got = L.lpt_assign(torch.from_numpy(cost), torch.from_numpy(order),
                       torch.tensor([n_real]), p)
    _eq(got, _heapq_lpt(cost, order, n_real, p))
    assert (got[n_real:] == -1).all()
    # phantom ids interleaved with the real ones, anywhere in `order`
    mixed = rng.permutation(n)
    got = L.lpt_assign(torch.from_numpy(cost), torch.from_numpy(mixed),
                       torch.tensor([n_real]), p)
    _eq(got, _heapq_lpt(cost, mixed, n_real, p))
    assert (got[n_real:] == -1).all()
    assert L.LAUNCHES["lpt_assign"] == 0


def _round_rule_case(n, n_real, seed, *, zeros, negative, sort):
    """Costs on a 0.1 grid (many ties), a share of 0.0 and -0.0, and
    negative costs when asked (sorted heaviest first, zeros then stand in
    the middle); the order sorted or shuffled, with a zero-cost run placed
    inside it; phantom ids (>= n_real) wherever the order puts them."""
    rng = np.random.default_rng(seed)
    cost = np.round(rng.uniform(-1.0 if negative else 0.0, 4.0, n), 1)
    cost[rng.random(n) < zeros] = 0.0
    cost[rng.random(n) < 0.05] = -0.0
    if sort:
        order = np.argsort(-cost + 0.0, kind="stable")
    else:
        order = rng.permutation(n)
        at = int(rng.integers(0, n + 1))
        cost[order[at:at + int(rng.integers(0, 60))]] = 0.0
    return cost, order, n_real


@settings(max_examples=40, deadline=None)
@given(p=st.integers(1, L.MAX_WORKERS), n=st.integers(0, 3000),
       real=st.floats(0.0, 1.0), seed=st.integers(0, 2 ** 32 - 1),
       zeros=st.sampled_from([0.0, 0.2, 0.9]), negative=st.booleans(),
       sort=st.booleans())
def test_round_rule_matches_heapq(p, n, real, seed, zeros, negative, sort):
    """The mirror of `lpt_assign`'s rounds (tests/_lpt_rounds.py) gives
    heapq's assignment, in at least one round per min(p, ROUND_WINDOW)
    real chains and at most one round per chain."""
    cost, order, n_real = _round_rule_case(
        n, int(real * n), seed, zeros=zeros, negative=negative, sort=sort)
    got, rounds = round_lpt(cost, order, n_real, p)
    np.testing.assert_array_equal(got, _heapq_lpt(cost, order, n_real, p))
    assert -(-n_real // min(p, ROUND_WINDOW)) <= rounds <= n_real


@pytest.mark.parametrize("case, p, n, want", [
    ("equal", 132, 5000, 38),      # every round places min(p, left) chains
    ("zeros", 132, 5000, 38),      # one run that leaves the load a round
    ("zeros", 2000, 5000, 5),      # ... at most ROUND_WINDOW chains a round
    ("equal", 2000, 5000, 5),      # p > ROUND_WINDOW: full windows
    ("one-worker", 1, 300, 300),   # p = 1: one chain a round
    ("halving", 2, 1000, 526),     # costs 2^-i: one a round, then pairs
                                   # once 2^-i no longer moves the load
])
def test_round_rule_round_counts(case, p, n, want):
    cost = {"equal": np.full(n, 3.0), "zeros": np.zeros(n),
            "one-worker": np.arange(n, 0, -1.0),
            "halving": 2.0 ** -np.arange(n)}[case]
    order = np.argsort(-cost + 0.0, kind="stable")
    got, rounds = round_lpt(cost, order, n, p)
    np.testing.assert_array_equal(got, _heapq_lpt(cost, order, n, p))
    assert rounds == want


def test_round_rule_at_wikipedia():
    """wikipedia's chains (the paper's matrix at its published 3,566,907
    rows; the construction of chip_smoke.py's schedule pipeline phase) at
    p = 132: the mirror equals the reference's partition_tiles in 430
    rounds, the count `lpt_assign` reports on the card."""
    from repro_torch.core.tiling import block_chains
    from repro_torch.core.workloads import TABLE1, matrix_row_nnz
    from repro_torch.sched import NnzCosts
    spec = next(m for m in TABLE1 if m.name == "wikipedia")
    row_nnz = matrix_row_nnz(spec, n=3_566_907, seed=0).astype(np.int64)
    indptr = np.concatenate([[0], np.cumsum(row_nnz)])
    s = LoopScheduler(p=132, device=CPU).schedule(NnzCosts(indptr))
    B, tc = s.superstep, s.tile_cost()
    chain = block_chains(s.item_id, B)
    bcost = np.bincount(np.arange(tc.size) // B, weights=tc,
                        minlength=chain.size)
    ccost = np.bincount(chain, weights=bcost, minlength=chain.size)
    order = np.argsort(-ccost + 0.0, kind="stable")
    n_real = int(chain[-1]) + 1
    got, rounds = round_lpt(ccost, order, n_real, 132)
    worker = np.repeat(got[chain], B)[:tc.size]
    np.testing.assert_array_equal(
        worker, T.partition_tiles(tc, s.item_id, 132, block=B))
    assert (n_real, rounds) == (55_856, 430)


# ------------------------------------------ backend seam cache generations
class TestDeviceCacheGenerations:
    """`LoopScheduler(backend='torch')`: device-backed cache entries must
    invalidate under a new refine generation exactly like host-backed
    ones (sched/cache.py's no-stale-lowering rule)."""

    def _sched(self, backend):
        ls = LoopScheduler(p=4, backend=backend, device=CPU)
        sizes = _random_sizes(600, 1.5, 3)
        return ls, ExplicitCosts(_random_costs(sizes, 3))

    def test_backend_tiles_element_identical(self):
        ls_np, prov = self._sched("numpy")
        ls_t = LoopScheduler(p=4, backend="torch", device=CPU)
        a, b = ls_np.schedule(prov), ls_t.schedule(prov)
        _eq(b.item_id, a.item_id)
        _eq(b.tiles.seg_len, a.tiles.seg_len)
        assert a.width == b.width
        # and both equal the reference's numpy tiles
        from repro.sched.api import LoopScheduler as RefLoopScheduler
        ref = RefLoopScheduler(p=4).schedule(RefExplicitCosts(prov.costs()))
        _eq(b.item_id, ref.item_id)
        _eq(b.tiles.seg_start, ref.tiles.seg_start)

    def test_backend_part_of_cache_key(self):
        ls, prov = self._sched("torch")
        s1 = ls.schedule(prov)
        ls.backend = "numpy"
        s2 = ls.schedule(prov)
        assert s1 is not s2 and s1.backend == "torch" \
            and s2.backend == "numpy"

    def test_device_lowering_memoized_per_key(self):
        ls, prov = self._sched("torch")
        s = ls.schedule(prov)
        low = s.device_lowering()
        assert s.device_lowering() is low
        assert s.device_lowering(p=2) is not low
        assert s.device_lowering(p=2).p == 2
        assert low.worker.device.type == "cpu"
        assert_lowering_matches(low, s.sizes, s.costs, p=s.p,
                                superstep=s.superstep)
        # the host and device lowerings of one schedule agree
        _eq(low.block_perm, s.shard().block_perm)

    @pytest.mark.parametrize("backend", ["numpy", "torch"])
    def test_refine_generation_invalidates_lowerings(self, backend):
        """After observe+refine the new generation must build fresh
        lowerings while the old schedule's memo stays untouched — for
        the device path exactly as for the host path."""
        ls, prov = self._sched(backend)
        s0 = ls.schedule(prov)
        host0 = s0.shard()
        dev0 = s0.device_lowering() if backend == "torch" else None
        rng = np.random.default_rng(42)
        measured = s0.costs * rng.uniform(0.25, 4.0, s0.n_items)
        s1 = s0.observe(measured, level="item").refine()
        assert s1 is not s0 and s1.generation == s0.generation + 1
        # fresh memo dicts, empty until first use
        assert s1._shards is not s0._shards and not s1._shards
        assert s1._device is not s0._device and not s1._device
        host1 = s1.shard()
        assert host1 is not host0
        # old entries survive unchanged (no aliasing, no eviction)
        assert s0.shard() is host0
        if backend == "torch":
            dev1 = s1.device_lowering()
            assert dev1 is not dev0
            assert s0.device_lowering() is dev0
            # the refined lowering reflects the refined costs, and stays
            # element-identical to ITS OWN generation's host pipeline
            assert_lowering_matches(dev1, s1.sizes, s1.costs, p=s1.p,
                                    superstep=s1.superstep)
            assert not torch.equal(dev1.tile_cost, dev0.tile_cost)

    def test_same_generation_is_cache_hit(self):
        """Re-presenting the same provider at the same generation returns
        the SAME schedule object with its device memo intact; the refined
        generation keys separately (a cache miss, never an overwrite)."""
        ls, prov = self._sched("torch")
        s0 = ls.schedule(prov)
        low = s0.device_lowering()
        assert ls.schedule(prov) is s0
        assert ls.schedule(prov).device_lowering() is low
        s1 = s0.observe(s0.costs * 2.0, level="item").refine()
        assert ls.schedule(prov) is s0  # gen 0 entry undisturbed
        assert s1._scheduler is ls and s1.generation == 1

    def test_hand_assembled_refine_clears_the_device_memo(self, monkeypatch):
        """A Schedule without a scheduler rebuilds its tiles itself on
        refine (the torch pipeline for backend="torch") and starts with an
        empty device memo."""
        ls, prov = self._sched("torch")
        s = ls.schedule(prov)
        s.device_lowering()
        hand = Schedule(sizes=s.sizes, costs=s.costs, policy=s.policy, p=4,
                        tiles=s.tiles, backend="torch",
                        _device=dict(s._device))
        real = TT.build_schedule_torch
        monkeypatch.setattr(TT, "build_schedule_torch",
                            lambda *a, **k: real(*a, **{**k, "device": CPU}))
        s1 = hand.observe(s.costs * 1.5, level="item").refine()
        assert s1.generation == 1 and not s1._device and hand._device
        _eq(s1.item_id, T.build_schedule(s.sizes).item_id)
