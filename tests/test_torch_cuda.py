"""The port's CUDA kernels on the card: each against its plain version, the
sharded kernel against the flat walk bit for bit, the flat walks of SpMV
and BFS (two kernels over the whole card) on inputs built for their
design (a run of slots far longer than a chunk, T = 1, ragged chunks, an
all-padding tail tile, W in {1, 2} and a misaligned payload on the 4-byte
cp.async path, T = 0, -0.0 products), the sharded walk of SpMV and BFS
(one CTA per worker, a ring of supersteps) on layouts built for its design
(p and B grids, W in {1, 2, 3, 8, 32}, a misaligned payload, slots wider
than a stage, a run across supersteps and windows, all-padding workers, p
above the SM count), the MoE products on the tensor cores (D and F off
the 16-byte path and off the tiles, a slot row of one token, OLMoE's
K = 2048 against float64), the flat K-Means walk over the whole card (D in {1, 34}, centroids
near the shared-memory limit, fewer slots than one CTA, the kdd_cup
shape) and the sharded one (D in {1, 33, 34}, a misaligned point table,
chunks of supersteps that split workers, a superstep wider than a chunk,
centroids too large to stage, p above the SM count, empty and
all-padding layouts, the kdd_cup shape), the launch counters, and the Zamba2 serving path through the
flash attention and SSD scan kernels (on the tensor cores: shapes off
their tile edges, dh 96, chunks of 1, 7 and 1,024 steps, and the same bits
from two calls at the serving shapes), and the schedule
pipeline on the card (each lowering element-identical to the numpy one,
tile costs bit for bit: one R per branch of numpy's pairwise sum, LPT
ties, zero and -0.0 costs, a long chain, p = 132, the `n_steps=` path;
the device pack; `segment_fold` and `lpt_assign` against their plain
versions, np.bincount and heapq; a device lowering feeding the sharded
SpMV kernel) and sharded recovery (`combine` of the completed-prefix and
survivor runs of rows 2, 4 and 6 == the fault-free bits). A CUDA
kernel has no CPU mode, so these tests need an NVIDIA GPU and skip
without one; run them there with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerance: SpMV's y at rtol=atol=1e-5 against the plain version (the
plain version does the same adds; the margin covers PyTorch's own
kernels), except in the flat-walk tests, which hold y to the plain
version's bits, as are the sharded-walk tests: there the plain version's
eager multiplies and adds are the kernel's, one IEEE operation each, in
the same order; MoE's y at
rtol=atol=1e-4 (the kernel's products are 3xTF32 tensor-core sums over
ascending k, float32-level, the plain version's are cuBLAS float32
products, which sum in another order), and against float64 at 1e-4 of
each element's sum of |terms|, as chip_smoke.py holds the main path. Everything else exactly: BFS frontiers are 0/1, K-Means ids come
from the same left fold over D in both versions, and every cost stream is
the same left fold. Flash attention and the SSD scan use the reference's
kernel-test tolerances, stated at each test."""
import numpy as np
import pytest
import torch

from conftest import random_csr

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("p", [1, 2, 4])
@pytest.mark.parametrize("B", [1, 4, 8])
def test_kernels_match_plain_and_each_other(cuda, p, B):
    from repro_torch.kernels.ich_spmv import ich_spmv as K
    from repro_torch.sched import LoopScheduler
    n = 3000
    indptr, indices, data = random_csr(n, seed=p * 10 + B, max_nnz=200)
    x = torch.from_numpy(np.random.default_rng(p).standard_normal(n).astype(
        np.float32)).to(cuda)
    op = LoopScheduler(p=p, superstep=B, cache_size=0).build(
        "spmv", indptr, indices, data)
    K.reset_launches()
    y = op(x)
    rowid = torch.from_numpy(op.schedule.item_id).to(cuda)
    T = op.n_tiles
    y_seq = K.ich_spmv(op.vals[:T], op.cols[:T], rowid, x, n)
    torch.cuda.synchronize()
    assert K.LAUNCHES == {"ich_spmv": 1, "ich_spmv_sharded": 1}
    y_plain, c_plain = K.ich_spmv_sharded_plain(
        op.vals, op.cols, op.rowid, op.blkid, x, n, p, B,
        slot_cost=op.slot_cost)
    torch.testing.assert_close(y, y_plain, rtol=1e-5, atol=1e-5)
    assert torch.equal(op.last_costs, c_plain)
    torch.testing.assert_close(
        y_seq, K.ich_spmv_plain(op.vals[:T], op.cols[:T], rowid, x, n),
        rtol=1e-5, atol=1e-5)
    assert torch.equal(y, y_seq)
    np.testing.assert_array_equal(
        op.last_costs.cpu().numpy().sum(axis=1),
        op.shards.worker_cost(op.schedule.tile_cost()).astype(np.float32))


def test_wrapper_raises_instead_of_falling_back(cuda):
    from repro_torch.kernels.ich_spmv import ich_spmv as K
    vals = torch.zeros((8, 8, 8), device=cuda)
    cols = torch.zeros((8, 8, 8), dtype=torch.int64, device=cuda)
    rowid = torch.zeros((8, 8), dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError, match="cols"):
        K.ich_spmv(vals, cols, rowid, torch.zeros(8, device=cuda), 8)
    with pytest.raises(ValueError, match="all on CUDA"):
        K.ich_spmv(vals, cols.int(), rowid, torch.zeros(8), 8)


@pytest.mark.parametrize("p", [1, 2, 4])
@pytest.mark.parametrize("B", [1, 4, 8])
def test_bfs_kernels_match_plain_and_each_other(cuda, p, B):
    from repro_torch.core.workloads import bfs_graph
    from repro_torch.kernels.ich_bfs import ich_bfs as K
    from repro_torch.sched import LoopScheduler
    n = 3000
    indptr, indices = bfs_graph("scale_free" if p > 1 else "uniform", n,
                                seed=p * 10 + B)
    rng = np.random.default_rng(p)
    f = torch.from_numpy((rng.random(n) < 0.05).astype(np.float32)).to(cuda)
    v = torch.maximum(f, torch.from_numpy(
        (rng.random(n) < 0.3).astype(np.float32)).to(cuda))
    op = LoopScheduler(p=p, superstep=B, cache_size=0).build(
        "bfs", indptr, indices)
    K.reset_launches()
    nxt = op.step(f, v)
    rowid = torch.from_numpy(op.schedule.item_id).to(cuda)
    T = op.n_tiles
    seq = K.ich_bfs_step(op.mask[:T], op.cols[:T], rowid, f, v, n)
    torch.cuda.synchronize()
    assert K.LAUNCHES == {"ich_bfs_step": 1, "ich_bfs_step_sharded": 1}
    plain, c_plain = K.ich_bfs_step_sharded_plain(
        op.mask, op.cols, op.rowid, op.blkid, f, v, n, p, B,
        slot_cost=op.slot_cost)
    assert torch.equal(nxt, plain) and torch.equal(op.last_costs, c_plain)
    assert torch.equal(seq, K.ich_bfs_step_plain(op.mask[:T], op.cols[:T],
                                                 rowid, f, v, n))
    assert torch.equal(nxt, seq)
    np.testing.assert_array_equal(
        op.last_costs.cpu().numpy().sum(axis=1),
        op.shards.worker_cost(op.schedule.tile_cost()).astype(np.float32))


@pytest.mark.parametrize("p", [1, 2, 4])
@pytest.mark.parametrize("B", [1, 4, 8])
def test_kmeans_kernels_match_plain_and_each_other(cuda, p, B):
    from repro_torch.kernels.ich_kmeans import ich_kmeans as K
    from repro_torch.sched import LoopScheduler
    n, D, k = 3000, 34, 5
    rng = np.random.default_rng(p * 10 + B)
    costs = rng.uniform(6.0, 10.0, n)
    costs[7] = 5000.0  # a heavy point split over several tiles
    pts = torch.from_numpy(rng.standard_normal((n, D)).astype(
        np.float32)).to(cuda)
    cent = torch.from_numpy(rng.standard_normal((k, D)).astype(
        np.float32)).to(cuda)
    op = LoopScheduler(p=p, superstep=B, cache_size=0).build("kmeans", costs)
    assert (op.schedule.item_id == 7).sum() > 1
    K.reset_launches()
    ids = op(pts, cent)
    seq = K.ich_kmeans_assign(pts, cent,
                              torch.from_numpy(op.schedule.item_id).to(cuda))
    torch.cuda.synchronize()
    assert K.LAUNCHES == {"ich_kmeans_assign": 1,
                          "ich_kmeans_assign_sharded": 1}
    plain, c_plain = K.ich_kmeans_assign_sharded_plain(
        pts, cent, op.rowid, p, B, slot_cost=op.slot_cost)
    assert torch.equal(ids, plain) and torch.equal(op.last_costs, c_plain)
    assert torch.equal(seq, K.ich_kmeans_assign_plain(
        pts, cent, torch.from_numpy(op.schedule.item_id).to(cuda)))
    assert torch.equal(ids, seq)
    np.testing.assert_allclose(
        op.last_costs.cpu().numpy().sum(axis=1),
        op.shards.worker_cost(op.schedule.tile_cost()), rtol=1e-6)


def test_bfs_and_kmeans_wrappers_raise_instead_of_falling_back(cuda):
    from repro_torch.kernels.ich_bfs import ich_bfs as KB
    from repro_torch.kernels.ich_kmeans import ich_kmeans as KK
    mask = torch.zeros((8, 8, 8), device=cuda)
    cols = torch.zeros((8, 8, 8), dtype=torch.int32, device=cuda)
    rowid = torch.zeros((8, 8), dtype=torch.int32, device=cuda)
    f = torch.zeros(8, device=cuda)
    with pytest.raises(TypeError, match="frontier"):
        KB.ich_bfs_step(mask, cols, rowid, f.double(), f, 8)
    with pytest.raises(ValueError, match="all on CUDA"):
        KB.ich_bfs_step(mask, cols, rowid, torch.zeros(8), f, 8)
    pts = torch.zeros((8, 3), device=cuda)
    with pytest.raises(ValueError, match="share D"):
        KK.ich_kmeans_assign(pts, torch.zeros((2, 4), device=cuda), rowid)
    with pytest.raises(ValueError, match="shared memory"):
        KK.ich_kmeans_assign(torch.zeros((8, 20000), device=cuda),
                             torch.zeros((3, 20000), device=cuda), rowid)
    with pytest.raises(ValueError, match="all on CUDA"):
        KK.ich_kmeans_assign(pts, torch.zeros((2, 3)), rowid)


def test_moe_kernel_matches_plain_and_is_lowering_independent(cuda):
    """p in {1, 2, 4} x B in {1, 4, 8} over one plan, with experts split
    across slot rows and a width that is not a multiple of the kernel's
    tiles: kernel == plain, cost streams exactly, and one y bit for bit
    across every lowering (p = 1, B = 1 is the sequential walk)."""
    from repro_torch.core.workloads import moe_router
    from repro_torch.kernels.ich_moe import ich_moe as K
    from repro_torch.sched import LoopScheduler, plan_dispatch
    T, E, D, F = 600, 16, 72, 200
    e_topk, w = moe_router(T, E, 4, seed=3, skew=1.2)
    plan = plan_dispatch(e_topk, w, cap_scale=np.ones(E))
    rng = np.random.default_rng(3)
    wi, wg = (torch.from_numpy((rng.standard_normal((E, D, F)) * D ** -0.5)
                               .astype(np.float32)).to(cuda)
              for _ in range(2))
    wo = torch.from_numpy((rng.standard_normal((E, F, D)) * F ** -0.5)
                          .astype(np.float32)).to(cuda)
    x = torch.from_numpy(rng.standard_normal((T, D)).astype(
        np.float32)).to(cuda)
    first = None
    for p in (1, 2, 4):
        for B in (1, 4, 8):
            op = LoopScheduler(p=p, superstep=B, rows_per_tile=2,
                               cache_size=0).build("moe-dispatch", plan,
                                                   width=64)
            K.reset_launches()
            y = op(x, wi, wg, wo)
            torch.cuda.synchronize()
            assert K.LAUNCHES == {"ich_moe_sharded": 1}
            y_p, c_p, e_p = K.ich_moe_sharded_plain(
                op.vals, op.cols, op.rowid, op.blkid, x, wi, wg, wo, p, B,
                op.slots, slot_cost=op.slot_cost)
            torch.testing.assert_close(y, y_p, rtol=1e-4, atol=1e-4)
            assert torch.equal(op.last_costs, c_p)
            assert torch.equal(op.last_expert_costs, e_p)
            np.testing.assert_array_equal(op.expert_load(),
                                          plan.counts.astype(np.float64))
            np.testing.assert_array_equal(
                op.last_costs.cpu().numpy().sum(axis=1),
                op.shards.worker_cost(
                    op.schedule.tile_cost()).astype(np.float32))
            first = y if first is None else first
            assert torch.equal(y, first)


def test_moe_zero_tokens_and_bad_inputs_on_the_card(cuda):
    from repro_torch.kernels.ich_moe import ich_moe as K
    from repro_torch.sched import LoopScheduler, plan_dispatch
    plan = plan_dispatch(np.zeros((0, 2), np.int64),
                         np.zeros((0, 2), np.float32))
    op = LoopScheduler(p=4).build("moe-dispatch", plan)
    K.reset_launches()
    E = plan.n_experts
    y = op(torch.zeros((0, 8), device=cuda),
           torch.zeros((E, 8, 16), device=cuda),
           torch.zeros((E, 8, 16), device=cuda),
           torch.zeros((E, 16, 8), device=cuda))
    assert tuple(y.shape) == (0, 8) and K.LAUNCHES == {"ich_moe_sharded": 0}
    np.testing.assert_array_equal(op.expert_load(), np.zeros(E))
    e_topk = np.arange(16, dtype=np.int32).reshape(8, 2) % 4
    op = LoopScheduler(p=2).build("moe-dispatch", plan_dispatch(e_topk))
    x = torch.zeros((8, 4), device=cuda)
    wi = torch.zeros((4, 4, 6), device=cuda)
    wo = torch.zeros((4, 6, 4), device=cuda)
    with pytest.raises(TypeError, match="wg"):
        K.ich_moe_sharded(op.vals, op.cols, op.rowid, op.blkid, x, wi,
                          wi.double(), wo, 2, op.superstep, op.slots)
    with pytest.raises(ValueError, match="all on CUDA"):
        K.ich_moe_sharded(op.vals, op.cols, op.rowid, op.blkid, x.cpu(), wi,
                          wi, wo, 2, op.superstep, op.slots)


def _moe_case(T, E, D, F, e_topk, seed, cuda, cap=None):
    """A plan over e_topk (T, K) and seeded float32 weights on the card."""
    from repro_torch.sched import plan_dispatch
    rng = np.random.default_rng(seed)
    w = (rng.random(e_topk.shape) + 0.1).astype(np.float32)
    plan = (plan_dispatch(e_topk, w, cap=cap) if cap is not None else
            plan_dispatch(e_topk, w, cap_scale=np.ones(E)))

    def put(a):
        return torch.from_numpy(a.astype(np.float32)).to(cuda)
    wi = put(rng.standard_normal((E, D, F)) * D ** -0.5)
    wg = put(rng.standard_normal((E, D, F)) * D ** -0.5)
    wo = put(rng.standard_normal((E, F, D)) * F ** -0.5)
    x = put(rng.standard_normal((T, D)))
    return plan, x, wi, wg, wo


def _moe_float64(plan, x, wi, wg, wo):
    """y in float64 on the host and, per element, the sum over each
    token's entries of |w| * sum_f |a_f * wo[f, d]|."""
    X, Wi, Wg, Wo = (t.double().cpu().numpy() for t in (x, wi, wg, wo))
    y64, absum = np.zeros(X.shape), np.zeros(X.shape)
    keep = plan.keep
    for e in np.unique(plan.expert[keep]):
        sel = keep & (plan.expert == e)
        tok, wt = plan.token[sel], plan.weight[sel].astype(np.float64)
        g = X[tok] @ Wg[e]
        a = g / (1.0 + np.exp(-g)) * (X[tok] @ Wi[e])
        np.add.at(y64, tok, wt[:, None] * (a @ Wo[e]))
        np.add.at(absum, tok, np.abs(wt)[:, None] * (np.abs(a) @ np.abs(Wo[e])))
    return y64, absum


MOE_SHAPES = {  # name -> (T, E, D, F, width)
    "d_f_off_16_bytes": (400, 8, 37, 53, 64),   # 4-byte cp.async
    "off_the_tiles": (400, 8, 200, 100, 96),    # D, F, W past tile edges
    "row_of_one": (200, 4, 64, 96, 64),         # rows of 64, 64, 1, 1, ...
    "olmoe_k2048": (256, 4, 2048, 1024, 128),   # OLMoE's D and F
}


@pytest.mark.parametrize("case", list(MOE_SHAPES))
def test_moe_products_take_every_shape(cuda, case):
    """The tensor-core products against the plain version (1e-4) and
    against float64 (1e-4 of each element's sum of |terms|), the cost
    streams exactly, y the same bits at p = 1, B = 1 and p = 4, B = 8, on
    shapes off the kernel's 16-byte path and tiles, slot rows of one token
    and OLMoE's widths."""
    from repro_torch.kernels.ich_moe import ich_moe as K
    from repro_torch.sched import LoopScheduler
    T, E, D, F, width = MOE_SHAPES[case]
    rng = np.random.default_rng(list(MOE_SHAPES).index(case))
    if case == "row_of_one":
        # expert 0: 129 tokens (rows of 64, 64, 1), expert 1: 1 token,
        # expert 2: 70 (rows of 64, 6), expert 3: none
        e_topk = np.full((T, 1), 2, np.int32)
        e_topk[:129, 0] = 0
        e_topk[129, 0] = 1
        cap = np.bincount(e_topk[:, 0], minlength=E)
    else:
        e_topk = np.stack([rng.permutation(E)[:2] for _ in range(T)]
                          ).astype(np.int32)
        cap = None
    plan, x, wi, wg, wo = _moe_case(T, E, D, F, e_topk, 7, cuda, cap=cap)
    if case == "row_of_one":
        assert plan.counts[0] == 129 and plan.counts[1] == 1
    y64, absum = _moe_float64(plan, x, wi, wg, wo)
    first = None
    for p, B in ((1, 1), (4, 8)):
        op = LoopScheduler(p=p, superstep=B, rows_per_tile=2,
                           cache_size=0).build("moe-dispatch", plan,
                                               width=width)
        assert op.vals.shape[2] == width
        if case == "row_of_one":
            assert (op.slots.length == 1).sum() == 2
        K.reset_launches()
        y = op(x, wi, wg, wo)
        torch.cuda.synchronize()
        assert K.LAUNCHES == {"ich_moe_sharded": 1}
        y_p, c_p, e_p = K.ich_moe_sharded_plain(
            op.vals, op.cols, op.rowid, op.blkid, x, wi, wg, wo, p, B,
            op.slots, slot_cost=op.slot_cost)
        torch.testing.assert_close(y, y_p, rtol=1e-4, atol=1e-4)
        assert torch.equal(op.last_costs, c_p)
        assert torch.equal(op.last_expert_costs, e_p)
        err = np.abs(y.double().cpu().numpy() - y64)
        assert np.all(err <= 1e-4 * absum), float(np.max(err / absum))
        first = y if first is None else first
        assert torch.equal(y, first)


# ------------------------------------------------- flash attention, SSD scan
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("Sq,Skv,rep,dh,causal,window", [
    (128, 128, 1, 64, True, 0), (200, 200, 2, 64, True, 0),
    (77, 77, 4, 128, True, 0), (96, 150, 2, 64, False, 0),
    (130, 130, 2, 64, True, 32), (100, 140, 1, 128, False, 32),
    (64, 64, 4, 64, False, 0), (300, 300, 1, 64, True, 32),
    # off the tile edges (64-row query tiles, 64-key blocks, 16-row warp
    # strips, n8 fragments), Sq != Skv without the causal mask, dh 96
    (1, 1, 1, 64, True, 0), (15, 15, 2, 64, True, 0),
    (17, 17, 1, 96, True, 0), (200, 200, 2, 96, True, 32),
    (1, 200, 2, 64, False, 0), (15, 17, 4, 96, False, 0),
    (17, 15, 1, 128, False, 0), (200, 17, 2, 96, False, 0),
    (17, 200, 1, 64, False, 0), (200, 15, 4, 64, False, 0)])
def test_flash_attention_kernel_matches_plain(cuda, dtype, tol, Sq, Skv,
                                              rep, dh, causal, window):
    """Tolerances of the reference's own kernel tests (test_kernels.py:
    23-24): both versions compute in float32 and differ in summation order;
    in bfloat16 the output's rounding adds up to half an ulp."""
    from repro_torch.kernels.flash_attention import flash_attention as K
    g = torch.Generator(device=cuda).manual_seed(Sq + rep + dh)
    Hkv = 2
    q = torch.randn((2, Sq, Hkv * rep, dh), generator=g, device=cuda)
    k = torch.randn((2, Skv, Hkv, dh), generator=g, device=cuda)
    v = torch.randn((2, Skv, Hkv, dh), generator=g, device=cuda)
    q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    K.reset_launches()
    out = K.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert K.LAUNCHES == {"flash_attention": 1} and out.dtype == dtype
    plain = K.flash_attention_plain(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(out.float(), plain.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("S,H,N,Pd,chunk", [
    (128, 2, 16, 32, 64), (256, 3, 16, 32, 64), (256, 1, 64, 64, 128),
    (300, 2, 64, 64, 256), (129, 2, 8, 16, 64), (100, 2, 64, 128, 32),
    (520, 4, 64, 64, 256), (37, 3, 64, 64, 256),
    # chunks of one and seven steps, 11 chunks, N and Pd off the 4-float
    # copies (the plain-load path) and off the tiles
    (50, 2, 64, 64, 1), (60, 2, 64, 64, 7), (700, 2, 64, 64, 64),
    (300, 2, 13, 30, 100), (90, 3, 64, 70, 16)])
def test_mamba_scan_kernel_matches_plain(cuda, S, H, N, Pd, chunk):
    """2e-4 in float32, the reference's tolerance for its kernel against
    the chunked oracle (test_kernels.py:206-209)."""
    from repro_torch.kernels.mamba_scan import mamba_scan as K
    g = torch.Generator(device=cuda).manual_seed(S + N + Pd)
    q = torch.randn((2, S, H, N), generator=g, device=cuda)
    k = torch.randn((2, S, H, N), generator=g, device=cuda)
    v = torch.randn((2, S, H, Pd), generator=g, device=cuda)
    la = -torch.rand((2, S, H), generator=g, device=cuda) * 0.3
    K.reset_launches()
    y, st = K.mamba_scan(q, k, v, la, chunk=chunk)
    torch.cuda.synchronize()
    assert K.LAUNCHES == {"mamba_scan": 1}
    y_p, st_p = K.mamba_scan_plain(q, k, v, la, chunk=chunk)
    torch.testing.assert_close(y, y_p, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(st, st_p, rtol=2e-4, atol=2e-4)
    # B/C shared by all heads, read with a head stride of 0
    qs, ks = q[:, :, :1].expand_as(q), k[:, :, :1].expand_as(k)
    y_s, st_s = K.mamba_scan(qs, ks, v, la, chunk=chunk)
    y_sp, st_sp = K.mamba_scan_plain(qs.contiguous(), ks.contiguous(), v, la,
                                     chunk=chunk)
    torch.testing.assert_close(y_s, y_sp, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(st_s, st_sp, rtol=2e-4, atol=2e-4)
    # bfloat16 inputs: float32 math, y rounded to bfloat16 (the reference's
    # bfloat16 tolerance, 10 x 2e-2)
    yb, _ = K.mamba_scan(q.bfloat16(), k.bfloat16(), v.bfloat16(), la,
                         chunk=chunk)
    yb_p, _ = K.mamba_scan_plain(q.bfloat16(), k.bfloat16(), v.bfloat16(),
                                 la, chunk=chunk)
    torch.testing.assert_close(yb.float(), yb_p.float(), rtol=0.2, atol=0.2)


def _scan_terms_error(y, y_ref, terms):
    return float(((y.double() - y_ref.double()).abs()
                  / (terms.double() + 1e-30)).max())


@pytest.mark.parametrize("S,chunk,shared", [(1500, 1024, True),
                                            (1100, 1024, False)])
def test_mamba_scan_kernel_long_chunks(cuda, S, chunk, shared):
    """chunk = 1024, the longest the kernel takes. Inside a chunk that long
    l runs to ~-150, and exp(l_i - l_j) subtracts two large cumulative
    sums whose rounding depends on the order they were summed in (the
    plain version's torch.cumsum differs from the kernel's scan), so the
    two versions are held as chip_smoke.py holds the serving shape: within
    2e-4 of each element's sum of |terms|, against each other and against
    the float64 recurrence."""
    from repro_torch.kernels.mamba_scan import mamba_scan as K
    from repro_torch.kernels.mamba_scan.ref import ssd_sequential_ref
    g = torch.Generator(device=cuda).manual_seed(S)
    H, N, Pd = 2, 64, 64
    q = torch.randn((2, S, 1 if shared else H, N), generator=g, device=cuda)
    k = torch.randn((2, S, 1 if shared else H, N), generator=g, device=cuda)
    q, k = q.expand(2, S, H, N), k.expand(2, S, H, N)
    v = torch.randn((2, S, H, Pd), generator=g, device=cuda)
    la = -torch.rand((2, S, H), generator=g, device=cuda) * 0.3
    y, st = K.mamba_scan(q, k, v, la, chunk=chunk)
    y_p, st_p = K.mamba_scan_plain(q, k, v, la, chunk=chunk)
    y_a, st_a = K.mamba_scan_plain(q.abs(), k.abs(), v.abs(), la,
                                   chunk=chunk)
    y_64, st_64 = ssd_sequential_ref(q, k, v, la)
    for got in ((y, st), (y_p, st_p)):
        assert _scan_terms_error(got[0], y_64, y_a) <= 2e-4
        assert _scan_terms_error(got[1], st_64, st_a) <= 2e-4
    assert _scan_terms_error(y, y_p, y_a) <= 2e-4
    assert _scan_terms_error(st, st_p, st_a) <= 2e-4


def test_flash_and_scan_repeat_bit_identical(cuda):
    """At the serving path's shapes (Zamba2-1.2B, 4 x 2,048 tokens) two
    calls give the same bits: fixed order, no atomics, whatever the SMs
    run first. The scan also gives the same bits with B/C shared by all
    heads (its score tiles computed once a batch row) and materialised."""
    from repro_torch.kernels.flash_attention import flash_attention as KF
    from repro_torch.kernels.mamba_scan import mamba_scan as KS
    g = torch.Generator(device=cuda).manual_seed(5)
    q = torch.randn((4, 2048, 32, 64), generator=g, device=cuda)
    k, v = torch.randn_like(q), torch.randn_like(q)
    a = KF.flash_attention(q, k, v, causal=True, window=4096)
    assert torch.equal(a, KF.flash_attention(q, k, v, causal=True,
                                             window=4096))
    del q, k, v, a
    Cm = torch.randn((4, 2048, 1, 64), generator=g, device=cuda)
    Bm = torch.randn((4, 2048, 1, 64), generator=g, device=cuda)
    qs, ks = Cm.expand(4, 2048, 64, 64), Bm.expand(4, 2048, 64, 64)
    vs = torch.randn((4, 2048, 64, 64), generator=g, device=cuda)
    la = -torch.nn.functional.softplus(
        torch.randn((4, 2048, 64), generator=g, device=cuda))
    y, st = KS.mamba_scan(qs, ks, vs, la, chunk=256)
    y2, st2 = KS.mamba_scan(qs, ks, vs, la, chunk=256)
    assert torch.equal(y, y2) and torch.equal(st, st2)
    y3, st3 = KS.mamba_scan(qs.contiguous(), ks.contiguous(), vs, la,
                            chunk=256)
    assert torch.equal(y, y3) and torch.equal(st, st3)


def test_flash_and_scan_refuse_what_they_do_not_take(cuda):
    from repro_torch.configs import get_arch, reduced
    from repro_torch.kernels.flash_attention import flash_attention as KF
    from repro_torch.kernels.mamba_scan import mamba_scan as KS
    from repro_torch.models import model as M
    from repro_torch.models import ssm as SS
    q = torch.zeros((1, 8, 2, 32), device=cuda)
    with pytest.raises(ValueError, match="head width"):
        KF.flash_attention(q, q, q)
    q = torch.zeros((1, 8, 2, 96), device=cuda)   # 96 is built
    assert KF.flash_attention(q, q, q).shape == q.shape
    q = torch.zeros(1 + 8 * 2 * 64, device=cuda)[1:].view(1, 8, 2, 64)
    with pytest.raises(ValueError, match="16-byte aligned"):
        KF.flash_attention(q, q, q)
    q = torch.zeros((1, 8, 2, 64), device=cuda)
    with pytest.raises(TypeError, match="share one of"):
        KF.flash_attention(q.double(), q.double(), q.double())
    with pytest.raises(ValueError, match="contiguous"):
        KF.flash_attention(q.transpose(1, 2), q.transpose(1, 2),
                           q.transpose(1, 2))
    with pytest.raises(ValueError, match="all on CUDA"):
        KF.flash_attention(q, q.cpu(), q)
    qs = torch.zeros((1, 8, 2, 128), device=cuda)
    la = torch.zeros((1, 8, 2), device=cuda)
    with pytest.raises(ValueError, match="N <= 64"):
        KS.mamba_scan(qs, qs, qs, la, chunk=4)
    with pytest.raises(TypeError, match="log_a"):
        KS.mamba_scan(q, q, q, la.double(), chunk=4)
    # a chunked scan from a state has no kernel yet: raise, never the
    # plain version
    cfg = reduced(get_arch("zamba2-1.2b"), d_model=256, n_heads=4)
    model = M.init_params(cfg, 0, device=cuda)
    x = torch.zeros((1, 4, 256), device=cuda)
    _, st = SS.apply_mamba2(cfg, model.blocks[0].mamba, x)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        SS.apply_mamba2(cfg, model.blocks[0].mamba, x, state=st)


def test_zamba2_serving_on_the_card_matches_the_cpu(cuda):
    """A reduced Zamba2 with dh = 64 (so the flash kernel takes it):
    prefill on the card through both kernels against the plain versions on
    the CPU within 1e-4; generate gives the same ids; decode at S matches a
    fresh prefill of S + 1 tokens within 2e-3 (test_arch_smoke.py's bar)."""
    from repro_torch.configs import get_arch, reduced
    from repro_torch.kernels.flash_attention import flash_attention as KF
    from repro_torch.kernels.mamba_scan import mamba_scan as KS
    from repro_torch.models import model as M
    from repro_torch.serve import Engine, EngineConfig
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = reduced(get_arch("zamba2-1.2b"), d_model=256, n_heads=4,
                  block_pattern=("M", "A", "M", "A"), n_layers=4,
                  ssm_chunk=16)
    model = M.init_params(cfg, 1, device=cuda)
    cpu_model = M.init_params(cfg, 1, device="cpu")
    cpu_model.load_state_dict({n: t.cpu() for n, t in
                               model.state_dict().items()})
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 41)))
    KF.reset_launches()
    KS.reset_launches()
    logits, _ = M.prefill(cfg, model, {"tokens": toks[:, :40].to(cuda)})
    torch.cuda.synchronize()
    assert KF.LAUNCHES == {"flash_attention": 2}
    assert KS.LAUNCHES == {"mamba_scan": 2}
    cpu_logits, _ = M.prefill(cfg, cpu_model, {"tokens": toks[:, :40]})
    torch.testing.assert_close(logits.cpu(), cpu_logits, rtol=1e-4,
                               atol=1e-4)
    prompts = toks[:, :24].numpy()
    ids, _ = Engine(cfg, model, EngineConfig(max_seq=64)).generate(
        prompts, n_new=8)
    cpu_ids, _ = Engine(cfg, cpu_model, EngineConfig(max_seq=64),
                        device="cpu").generate(prompts, n_new=8)
    np.testing.assert_array_equal(ids, cpu_ids)
    eng = Engine(cfg, model, EngineConfig(max_seq=64))
    _, cache = M.prefill(cfg, model, {"tokens": toks[:, :40].to(cuda)})
    d_logits, _ = M.decode_step(cfg, model, toks[:, 40:].to(cuda),
                                eng._pad_cache(cache), 40)
    full, _ = M.prefill(cfg, model, {"tokens": toks.to(cuda)})
    torch.testing.assert_close(d_logits, full, rtol=2e-3, atol=2e-3)


# ---- the flat walks (two kernels over the whole card) on inputs built
#      for their design: bit for bit against the plain versions and the
#      sharded kernels ----
FLAT_CASES = ["long_run", "one_tile", "ragged_chunks", "w1", "w2",
              "misaligned", "padding_tail", "neg_zero"]


def _flat_csr(case):
    """(indptr, indices, data, x, width) of one flat-walk case."""
    rng = np.random.default_rng(FLAT_CASES.index(case))
    if case == "long_run":
        # one row of 50,000 nonzeros at W = 8: a run of 6,250 slots,
        # far more than a phase-A chunk (256 slots at W = 8)
        row_nnz = rng.integers(0, 6, 600)
        row_nnz[17] = 50_000
        width = 8
    elif case == "one_tile":
        row_nnz, width = np.array([3, 0, 5]), None
    elif case == "neg_zero":
        # rows 0-99 multiply negative values by x == 0: every product is
        # -0.0, so a fold that starts from a product instead of 0.0f
        # leaves -0.0 where the sequential order gives +0.0
        row_nnz = rng.integers(1, 12, 300)
        width = 4
    else:
        row_nnz = np.minimum(rng.zipf(1.8, 5000), 200)
        row_nnz[rng.random(5000) < 0.1] = 0
        width = {"w1": 1, "w2": 2, "ragged_chunks": 16}.get(case, 8)
    n = row_nnz.size
    indptr = np.concatenate([[0], np.cumsum(row_nnz)]).astype(np.int64)
    indices = rng.integers(0, n, int(indptr[-1])).astype(np.int32)
    data = rng.standard_normal(int(indptr[-1])).astype(np.float32)
    x = rng.standard_normal(n).astype(np.float32)
    if case == "neg_zero":
        x[:50] = 0.0
        first = slice(0, int(indptr[100]))
        indices[first] = rng.integers(0, 50, int(indptr[100]))
        data[first] = -np.abs(data[first]) - 0.5
    return indptr, indices, data, x, width


def _flat_inputs(case, kernel, cuda, p=4, B=4):
    """The flat arguments and the sharded arguments of one case, on the
    card: (flat, sharded) tuples for the kernel's wrapper."""
    from repro_torch.core import tiling as PT
    indptr, indices, data, x, width = _flat_csr(case)
    n = indptr.size - 1
    sizes = np.diff(indptr)
    tiles = PT.build_schedule(sizes, width=width)
    shards = PT.shard_schedule(tiles, tiles.tile_cost(sizes, sizes), p,
                               superstep=B)
    if kernel == "bfs":
        data = np.ones_like(data)
    vals, cols = PT.pack_csr(indptr, indices, data, tiles, pad_tiles_to=B)
    T = tiles.n_tiles
    dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda)
    fv, fc, rowid = vals[:T], cols[:T], tiles.item_id
    if case == "padding_tail":
        # an all-padding tail tile whose lanes are NaN: it writes nothing
        fv = np.concatenate([fv, np.full((1,) + fv.shape[1:], np.nan,
                                         np.float32)])
        fc = np.concatenate([fc, np.zeros((1,) + fc.shape[1:], np.int32)])
        rowid = np.concatenate([rowid, np.full((1, rowid.shape[1]), -1,
                                               np.int32)])
    fv, fc = dev(fv), dev(fc)
    if case == "misaligned":
        # a W % 4 == 0 payload 4 bytes off a 16-byte boundary: the 4-byte
        # cp.async path
        def shift(t):
            buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=cuda)
            out = buf[1:].view(t.shape)
            out.copy_(t)
            return out
        fv, fc = shift(fv), shift(fc)
        assert fv.data_ptr() % 16 and fc.data_ptr() % 16
    if kernel == "spmv":
        xs = (dev(x),)
    else:
        f = (rng_ind := np.random.default_rng(7)).random(n) < 0.2
        v = np.maximum(f, rng_ind.random(n) < 0.3)
        xs = (dev(f.astype(np.float32)), dev(v.astype(np.float32)))
    flat = (fv, fc, dev(rowid), *xs, n)
    sharded = (dev(vals), dev(cols), dev(shards.shard_item_id(tiles.item_id)),
               dev(shards.kernel_block_ids()), *xs, n, p, B)
    return flat, sharded, tiles


def _bits(t):
    return t.view(torch.int32)


@pytest.mark.parametrize("kernel", ["spmv", "bfs"])
@pytest.mark.parametrize("case", FLAT_CASES)
def test_flat_walk_bit_identical_to_plain_and_sharded(cuda, case, kernel):
    from repro_torch.core.segmented import longest_run
    from repro_torch.kernels.ich_bfs import ich_bfs as KB
    from repro_torch.kernels.ich_spmv import ich_spmv as KS
    flat, sharded, tiles = _flat_inputs(case, kernel, cuda)
    if kernel == "spmv":
        mod, run, plain, sh = (KS, KS.ich_spmv, KS.ich_spmv_plain,
                               KS.ich_spmv_sharded)
    else:
        mod, run, plain, sh = (KB, KB.ich_bfs_step, KB.ich_bfs_step_plain,
                               KB.ich_bfs_step_sharded)
    T, R, W = flat[0].shape
    shape = mod.flat_launch_shape(T, R, W)
    if case == "long_run":
        assert longest_run(flat[2]) > 20 * shape["chunk_slots"]
    if case == "one_tile":
        assert T == 1
    if case == "ragged_chunks":
        assert (T * R) % shape["chunk_slots"]
    assert shape["load_path"] == ("cp.async 4-byte" if W % 4 else
                                  "cp.async.bulk")
    mod.reset_launches()
    y = run(*flat)
    torch.cuda.synchronize()
    assert sum(mod.LAUNCHES.values()) == 1
    y_plain = plain(*flat)
    y_sh = sh(*sharded)
    torch.cuda.synchronize()
    assert torch.equal(_bits(y), _bits(y_plain))
    assert torch.equal(_bits(y), _bits(y_sh))
    if case == "neg_zero" and kernel == "spmv":
        assert not _bits(y[:100]).any()   # +0.0, never -0.0


@pytest.mark.parametrize("kernel", ["spmv", "bfs"])
def test_flat_walk_of_no_tiles_launches_nothing(cuda, kernel):
    from repro_torch.kernels.ich_bfs import ich_bfs as KB
    from repro_torch.kernels.ich_spmv import ich_spmv as KS
    a = torch.zeros((0, 8, 8), device=cuda)
    c = torch.zeros((0, 8, 8), dtype=torch.int32, device=cuda)
    r = torch.zeros((0, 8), dtype=torch.int32, device=cuda)
    z = torch.zeros(5, device=cuda)
    mod = KS if kernel == "spmv" else KB
    mod.reset_launches()
    y = (KS.ich_spmv(a, c, r, z, 5) if kernel == "spmv"
         else KB.ich_bfs_step(a, c, r, z, z, 5))
    assert y.shape == (5,) and not y.any()
    assert not any(mod.LAUNCHES.values())


def test_flat_walk_grid_spans_the_card(cuda):
    """At the uniform 1M-vertex graph's size the phase-A grid has a CTA on
    every SM (and several on each), phase B as many as it has blocks of
    slots up to 8 a SM."""
    from repro_torch.kernels.ich_bfs import ich_bfs as KB
    from repro_torch.kernels.ich_spmv import ich_spmv as KS
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for shape in (KS.flat_launch_shape(481_631, 8, 32),
                  KB.flat_launch_shape(150_019, 8, 16)):
        assert shape["ctas_phase_a"] >= 2 * sms
        assert shape["ctas_phase_a"] % sms == 0
        assert shape["ctas_phase_b"] == 8 * sms
        assert shape["smem_bytes"] <= 232_448
    with pytest.raises(ValueError, match="shared memory"):
        KS.flat_launch_shape(4, 8, 20_000)


# ---- the sharded SpMV walk (one CTA per worker, a ring of supersteps):
#      bit for bit against the plain version and the flat walk ----
def _walk_csr(kind, seed):
    """(indptr, indices, data, x) of one sharded-walk layout."""
    rng = np.random.default_rng(seed)
    if kind == "long_run":
        # one row of 50,000 nonzeros: at W = 8 a run of 782 tiles, across
        # many supersteps and windows of its worker
        row_nnz = rng.integers(0, 6, 600)
        row_nnz[17] = 50_000
    elif kind == "tiny":
        row_nnz = rng.integers(1, 5, 30)     # one block of 4 tiles
    else:
        n = 5000 if kind == "zipf" else 200
        row_nnz = np.minimum(rng.zipf(1.8, n), 200)
        row_nnz[rng.random(n) < 0.1] = 0
    n = row_nnz.size
    indptr = np.concatenate([[0], np.cumsum(row_nnz)]).astype(np.int64)
    indices = rng.integers(0, n, int(indptr[-1])).astype(np.int32)
    data = rng.standard_normal(int(indptr[-1])).astype(np.float32)
    x = rng.standard_normal(n).astype(np.float32)
    return indptr, indices, data, x


SHARDED_CASES = {  # name -> (matrix, p (None: SM count + 40), B, W, shift)
    **{f"p{p}-B{B}": ("zipf", p, B, None, False)
       for p in (1, 2, 4) for B in (1, 4, 8)},
    "w1": ("zipf", 4, 4, 1, False),
    "w2": ("zipf", 4, 4, 2, False),
    "w3": ("zipf", 4, 4, 3, False),
    "w8": ("zipf", 4, 4, 8, False),
    "w32": ("zipf", 4, 8, 32, False),
    "misaligned": ("zipf", 4, 8, 32, True),
    "whole_slot_chunks": ("zipf_small", 2, 4, 1024, False),
    "slot_pieces": ("zipf_small", 2, 2, 6000, False),
    "slot_pieces_4byte": ("zipf_small", 2, 2, 6001, False),
    "run_across_windows": ("long_run", 2, 4, 8, False),
    "padding_workers": ("tiny", 8, 4, 8, False),
    "p_above_sms": ("zipf", None, 1, 8, False),
}
# the BFS step on the same walk: 0/1 frontiers and visited masks
BFS_SHARDED_CASES = ["p1-B1", "p4-B8", "w1", "w2", "w8", "whole_slot_chunks",
                     "slot_pieces_4byte", "misaligned", "run_across_windows",
                     "padding_workers"]


def _shifted(t):
    """A copy of t 4 bytes off a 16-byte boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    assert out.data_ptr() % 16
    return out


def _walk_kernel(kernel):
    """(module, sharded wrapper, its plain version, flat walk) of one
    kernel of the sharded walk."""
    from repro_torch.kernels.ich_bfs import ich_bfs as KB
    from repro_torch.kernels.ich_spmv import ich_spmv as KS
    if kernel == "spmv":
        return KS, KS.ich_spmv_sharded, KS.ich_spmv_sharded_plain, KS.ich_spmv
    return (KB, KB.ich_bfs_step_sharded, KB.ich_bfs_step_sharded_plain,
            KB.ich_bfs_step)


@pytest.mark.parametrize("kernel,case",
                         [("spmv", c) for c in SHARDED_CASES]
                         + [("bfs", c) for c in BFS_SHARDED_CASES])
def test_sharded_walk_bit_identical_to_plain_and_flat(cuda, kernel, case):
    from repro_torch.sched import LoopScheduler
    mod, run, plain, flat = _walk_kernel(kernel)
    kind, p, B, width, shift = SHARDED_CASES[case]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    p = sms + 40 if p is None else p
    indptr, indices, data, x = _walk_csr(kind, list(SHARDED_CASES).index(case))
    n = indptr.size - 1
    sched = LoopScheduler(p=p, superstep=B, cache_size=0)
    if kernel == "spmv":
        op = sched.build("spmv", indptr, indices, data, width=width)
        a = op.vals
        xs = (torch.from_numpy(x).to(cuda),)
    else:
        op = sched.build("bfs", indptr, indices, width=width)
        a = op.mask
        rng = np.random.default_rng(n)
        f = rng.random(n) < 0.2
        v = np.maximum(f, rng.random(n) < 0.3)
        xs = tuple(torch.from_numpy(t.astype(np.float32)).to(cuda)
                   for t in (f, v))
    cols = op.cols
    if shift:
        a, cols = _shifted(a), _shifted(cols)
    T_pad, R, W = a.shape
    S_B = op.blkid.numel() // p
    shape = mod.sharded_launch_shape(p, S_B, B, R, W, bulk=not shift)
    assert shape["ctas"] == p and shape["stages"] >= 3
    assert shape["load_path"] == (
        "cp.async.bulk" if W % 4 == 0 and R % 4 == 0 and not shift
        else "cp.async 4-byte")
    item = op.schedule.item_id
    if case == "run_across_windows":
        tiles = np.unique(np.nonzero(item == 17)[0])
        assert tiles.size > shape["window_tiles"] + B
        assert np.unique(op.shards.worker[tiles]).size == 1
    if case == "padding_workers":
        assert (op.shards.block_perm < 0).all(axis=1).any()
    if case in ("whole_slot_chunks", "slot_pieces", "slot_pieces_4byte"):
        assert shape["chunks_per_window"] > 1
    mod.reset_launches()
    y, c = run(a, cols, op.rowid, op.blkid, *xs, n, p, B,
               slot_cost=op.slot_cost)
    torch.cuda.synchronize()
    assert mod.LAUNCHES == {k: int(k.endswith("_sharded"))
                            for k in mod.LAUNCHES}
    y_p, c_p = plain(a, cols, op.rowid, op.blkid, *xs, n, p, B,
                     slot_cost=op.slot_cost)
    T = op.n_tiles
    src = op.vals if kernel == "spmv" else op.mask
    y_f = flat(src[:T], op.cols[:T], torch.from_numpy(item).to(cuda), *xs,
               n)
    torch.cuda.synchronize()
    assert torch.equal(_bits(y), _bits(y_p))
    assert torch.equal(_bits(y), _bits(y_f))
    assert torch.equal(c, c_p)
    if kernel == "bfs":
        assert bool(((y == 0) | (y == 1)).all())
    np.testing.assert_array_equal(
        c.cpu().numpy().sum(axis=1),
        op.shards.worker_cost(op.schedule.tile_cost()).astype(np.float32))


def test_sharded_walk_of_no_tiles_launches_nothing(cuda):
    """A 0-tile payload (every step padding) returns zeros and an all-zero
    cost stream with no launch: the walk would read block 0 of the
    payload at each worker's first step."""
    from repro_torch.kernels.ich_spmv import ich_spmv as K
    p, B, R = 4, 8, 8
    vals = torch.zeros((0, R, 8), device=cuda)
    cols = torch.zeros((0, R, 8), dtype=torch.int32, device=cuda)
    rowid = torch.full((p * B, R), -1, dtype=torch.int32, device=cuda)
    blkid = torch.zeros(p, dtype=torch.int32, device=cuda)
    K.reset_launches()
    y, c = K.ich_spmv_sharded(vals, cols, rowid, blkid,
                              torch.ones(5, device=cuda), 5, p, B,
                              slot_cost=torch.zeros((0, R), device=cuda))
    assert y.shape == (5,) and not y.any()
    assert c.shape == (p, 1) and not c.any()
    assert not any(K.LAUNCHES.values())


@pytest.mark.parametrize("kernel", ["spmv", "bfs"])
def test_sharded_walk_keeps_one_cta_per_worker(cuda, kernel):
    """At the main paths' shapes (wikipedia: p = 132, S_B = 460, B = R = 8,
    W = 32; the uniform 1M-vertex graph: S_B = 150, W = 16) the walk is
    one CTA per worker with a ring of at least three stages; it takes any
    width (a slot wider than a stage streams in pieces) and refuses only
    tiles of thousands of slots."""
    mod = _walk_kernel(kernel)[0]
    S_B, W = (460, 32) if kernel == "spmv" else (150, 16)
    shape = mod.sharded_launch_shape(132, S_B, 8, 8, W)
    assert shape["ctas"] == 132 and shape["threads"] >= 512
    assert shape["stages"] >= 3 and shape["smem_bytes"] <= 232_448
    assert shape["load_path"] == "cp.async.bulk"
    for W in (1, 3, 11_600, 50_000):
        assert mod.sharded_launch_shape(4, 10, 8, 8, W)["ctas"] == 4
    with pytest.raises(ValueError, match="shared memory"):
        mod.sharded_launch_shape(4, 10, 8, 4096, 8)


# ---- the flat K-Means walk (one launch over the whole card) ----
KMEANS_CASES = {  # name -> (points, D, K, p, B)
    "d1": (3000, 1, 5, 4, 8),
    "d34": (3000, 34, 5, 4, 8),
    "smem_limit": (2000, 34, 1700, 2, 4),  # 231,200 bytes of centroids
    "few_slots": (10, 34, 5, 1, 1),        # fewer slots than one CTA
}


@pytest.mark.parametrize("case", list(KMEANS_CASES))
def test_kmeans_flat_walk_matches_plain_and_sharded(cuda, case):
    from repro_torch.kernels.ich_kmeans import ich_kmeans as K
    from repro_torch.sched import LoopScheduler
    n, D, k, p, B = KMEANS_CASES[case]
    rng = np.random.default_rng(list(KMEANS_CASES).index(case))
    costs = rng.uniform(6.0, 10.0, n)
    costs[n // 2] = 5000.0  # a heavy point split over several tiles
    pts = torch.from_numpy(rng.standard_normal((n, D)).astype(
        np.float32)).to(cuda)
    cent = torch.from_numpy(rng.standard_normal((k, D)).astype(
        np.float32)).to(cuda)
    op = LoopScheduler(p=p, superstep=B, cache_size=0).build("kmeans", costs)
    item = op.schedule.item_id
    assert np.unique(np.nonzero(item == n // 2)[0]).size > 1
    shape = K.assign_launch_shape(item.size, D, k)
    assert (shape["chunk_slots"] == 0) == (case == "smem_limit")
    if case == "few_slots":
        assert item.size < shape["chunk_slots"] and shape["ctas"] == 1
    rid = torch.from_numpy(item).to(cuda)
    K.reset_launches()
    ids = K.ich_kmeans_assign(pts, cent, rid)
    torch.cuda.synchronize()
    assert K.LAUNCHES == {"ich_kmeans_assign": 1,
                          "ich_kmeans_assign_sharded": 0}
    assert torch.equal(ids, K.ich_kmeans_assign_plain(pts, cent, rid))
    assert torch.equal(ids, K.ich_kmeans_assign_sharded(pts, cent, op.rowid,
                                                        p, B))


def test_kmeans_flat_walk_at_kdd_cup_shape_spans_the_card(cuda):
    """494,020 points x 34 features, K = 5, lowered with p = SM count: the
    flat kernel's grid fills every SM (several CTAs each) and its ids equal
    the plain version's and the sharded kernel's."""
    from repro_torch.core.workloads import kmeans_rounds
    from repro_torch.kernels.ich_kmeans import ich_kmeans as K
    from repro_torch.sched import LoopScheduler
    n, D, k = 494_020, 34, 5
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rounds, _ = kmeans_rounds(n, rounds=1, seed=0)
    rng = np.random.default_rng(0)
    pts = torch.from_numpy(rng.standard_normal((n, D)).astype(
        np.float32)).to(cuda)
    cent = torch.from_numpy(rng.standard_normal((k, D)).astype(
        np.float32)).to(cuda)
    op = LoopScheduler(p=sms).build("kmeans", rounds[0])
    item = op.schedule.item_id
    shape = K.assign_launch_shape(item.size, D, k)
    assert shape["chunk_slots"] > 0
    assert shape["ctas"] >= 2 * sms and shape["ctas"] % sms == 0
    rid = torch.from_numpy(item).to(cuda)
    ids = K.ich_kmeans_assign(pts, cent, rid)
    assert torch.equal(ids, K.ich_kmeans_assign_plain(pts, cent, rid))
    assert torch.equal(ids, K.ich_kmeans_assign_sharded(
        pts, cent, op.rowid, op.p, op.superstep))


# ---- the sharded K-Means walk (one launch over the whole card) ----
# name -> (points, D, K, p, B, R, misaligned points)
KMEANS_SHARDED_CASES = {
    "d1": (3000, 1, 5, 4, 8, 8, False),
    "d33": (3000, 33, 7, 4, 8, 8, False),          # 4-byte copies: odd D
    "d34": (3000, 34, 5, 4, 8, 8, False),          # 8-byte copies
    "misaligned": (3000, 34, 5, 4, 8, 8, True),    # 4-byte copies
    "chunk_splits_workers": (9000, 34, 5, 3, 2, 8, False),
    "step_wider_than_chunk": (3000, 34, 5, 2, 8, 64, False),
    "smem_limit": (2000, 34, 1700, 2, 4, 8, False),  # read from global
    "p_above_sms": (3000, 34, 5, 300, 1, 8, False),
}


def _points(n, D, rng, device, misaligned):
    pts = rng.standard_normal((n, D)).astype(np.float32)
    if not misaligned:
        return torch.from_numpy(pts).to(device)
    buf = torch.empty(n * D + 1, device=device)[1:]
    buf.copy_(torch.from_numpy(pts.reshape(-1)))
    return buf.view(n, D)


@pytest.mark.parametrize("case", list(KMEANS_SHARDED_CASES))
def test_kmeans_sharded_walk_matches_plain_and_flat(cuda, case):
    from repro_torch.kernels.ich_kmeans import ich_kmeans as K
    from repro_torch.sched import LoopScheduler
    n, D, k, p, B, R, misaligned = KMEANS_SHARDED_CASES[case]
    rng = np.random.default_rng(list(KMEANS_SHARDED_CASES).index(case))
    costs = rng.uniform(6.0, 10.0, n)
    costs[n // 2] = 5000.0  # a heavy point split over several tiles
    pts = _points(n, D, rng, cuda, misaligned)
    assert (pts.data_ptr() % 8 != 0) == misaligned
    cent = torch.from_numpy(rng.standard_normal((k, D)).astype(
        np.float32)).to(cuda)
    op = LoopScheduler(p=p, superstep=B, rows_per_tile=R,
                       cache_size=0).build("kmeans", costs)
    S_B = op.shards.n_steps
    shape = K.sharded_launch_shape(p, S_B, B, R, D, k,
                                   aligned=not misaligned)
    assert (shape["chunk_slots"] == 0) == (case == "smem_limit")
    if shape["chunk_slots"]:
        assert shape["chunk_slots"] == shape["chunk_steps"] * B * R
        assert shape["copy_bytes"] == (8 if D % 2 == 0 and not misaligned
                                       else 4)
    if case == "chunk_splits_workers":
        assert S_B % shape["chunk_steps"] and S_B > shape["chunk_steps"]
    if case == "step_wider_than_chunk":
        assert shape["chunk_steps"] == 1 and B * R > 256
    K.reset_launches()
    ids, c = K.ich_kmeans_assign_sharded(pts, cent, op.rowid, p, B,
                                         slot_cost=op.slot_cost)
    bare = K.ich_kmeans_assign_sharded(pts, cent, op.rowid, p, B)
    rid = torch.from_numpy(op.schedule.item_id).to(cuda)
    flat = K.ich_kmeans_assign(pts, cent, rid)
    torch.cuda.synchronize()
    assert K.LAUNCHES == {"ich_kmeans_assign": 1,
                          "ich_kmeans_assign_sharded": 2}
    ids_p, c_p = K.ich_kmeans_assign_sharded_plain(pts, cent, op.rowid, p, B,
                                                   slot_cost=op.slot_cost)
    assert torch.equal(ids, ids_p) and torch.equal(c, c_p)
    assert torch.equal(bare, ids) and torch.equal(flat, ids)


def test_kmeans_sharded_walk_of_empty_and_all_padding_layouts(cuda):
    from repro_torch.kernels.ich_kmeans import ich_kmeans as K
    pts = torch.randn((50, 34), device=cuda)
    cent = torch.randn((5, 34), device=cuda)
    K.reset_launches()
    # no supersteps: nothing is launched
    empty = torch.zeros((0, 8), dtype=torch.int32, device=cuda)
    ids, c = K.ich_kmeans_assign_sharded(
        pts, cent, empty, 4, 8, slot_cost=torch.zeros((0, 8), device=cuda))
    assert K.LAUNCHES["ich_kmeans_assign_sharded"] == 0
    assert ids.shape == (50,) and not ids.any() and c.shape == (4, 0)
    # every slot padding: one launch, no id written, every cost 0
    pad = torch.full((4 * 3 * 8, 8), -1, dtype=torch.int32, device=cuda)
    ids, c = K.ich_kmeans_assign_sharded(
        pts, cent, pad, 4, 8, slot_cost=torch.ones((96, 8), device=cuda))
    torch.cuda.synchronize()
    assert K.LAUNCHES["ich_kmeans_assign_sharded"] == 1
    assert not ids.any() and c.shape == (4, 3) and not c.any()


def test_kmeans_sharded_walk_at_kdd_cup_shape_spans_the_card(cuda):
    """494,020 points x 34 features, K = 5, p = SM count: one launch of
    several CTAs on every SM in chunks of whole supersteps, 8-byte row
    copies; ids and costs equal the plain version's, ids the flat walk's."""
    from repro_torch.core.workloads import kmeans_rounds
    from repro_torch.kernels.ich_kmeans import ich_kmeans as K
    from repro_torch.sched import LoopScheduler
    n, D, k = 494_020, 34, 5
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rounds, _ = kmeans_rounds(n, rounds=1, seed=0)
    rng = np.random.default_rng(0)
    pts = torch.from_numpy(rng.standard_normal((n, D)).astype(
        np.float32)).to(cuda)
    cent = torch.from_numpy(rng.standard_normal((k, D)).astype(
        np.float32)).to(cuda)
    op = LoopScheduler(p=sms).build("kmeans", rounds[0])
    B, R = op.superstep, op.schedule.rows_per_tile
    shape = K.sharded_launch_shape(sms, op.shards.n_steps, B, R, D, k)
    assert shape["chunk_slots"] > 0 and shape["copy_bytes"] == 8
    assert shape["ctas"] >= 2 * sms and shape["ctas"] % sms == 0
    ids, c = K.ich_kmeans_assign_sharded(pts, cent, op.rowid, sms, B,
                                         slot_cost=op.slot_cost)
    ids_p, c_p = K.ich_kmeans_assign_sharded_plain(pts, cent, op.rowid, sms,
                                                   B, slot_cost=op.slot_cost)
    assert torch.equal(ids, ids_p) and torch.equal(c, c_p)
    rid = torch.from_numpy(op.schedule.item_id).to(cuda)
    assert torch.equal(ids, K.ich_kmeans_assign(pts, cent, rid))


# ------------------------- the schedule pipeline and recovery on the card
def _zipf_sizes(n, a, seed):
    rng = np.random.default_rng(seed)
    return np.minimum(rng.zipf(a, n), 300).astype(np.int64), \
        rng.uniform(0.5, 2.0, n)


def _host_lowering(sizes, costs, p, B, R=8, width=None):
    from repro_torch.core import tiling as PT
    sched = PT.build_schedule(sizes, rows_per_tile=R, width=width)
    tc = sched.tile_cost(costs, sizes)
    sh = PT.shard_schedule(sched, tc, p, superstep=B)
    slot = np.zeros((sh.n_tiles_padded, R), np.float32)
    slot[:sched.n_tiles] = sched.slot_cost(costs, sizes)
    return {"item_id": sched.item_id, "seg_start": sched.seg_start,
            "seg_len": sched.seg_len, "tile_cost": tc, "worker": sh.worker,
            "block_perm": sh.block_perm,
            "rowid": sh.shard_item_id(sched.item_id),
            "blkid": sh.kernel_block_ids(), "slot_cost": slot}


def _assert_device_lowering(low, want):
    got = {"item_id": low.schedule.item_id, "seg_start":
           low.schedule.seg_start, "seg_len": low.schedule.seg_len,
           "tile_cost": low.tile_cost, "worker": low.worker,
           "block_perm": low.block_perm, "rowid": low.rowid,
           "blkid": low.blkid, "slot_cost": low.slot_cost}
    for name, a in got.items():
        assert a.is_cuda, name
        a = a.cpu().numpy()
        assert a.dtype == want[name].dtype, name
        np.testing.assert_array_equal(a, want[name], err_msg=name)


@pytest.mark.parametrize("case", ["zipf-p4-B8", "zipf-p132-B8", "R5", "R12",
                                  "R136", "ties", "zeros", "long-chain",
                                  "one-tile"])
def test_device_lowering_equals_numpy(cuda, case):
    """lower_schedule_torch on the card == the host numpy lowering, float64
    tile costs bit for bit, with and without n_steps=."""
    from repro_torch.core import tiling_torch as TT
    from repro_torch.kernels.lpt import lpt as L
    sizes, unit = _zipf_sizes(5000, 1.5, 3)
    p, B, R, width = 4, 8, 8, None
    if case == "zipf-p132-B8":
        sizes, unit = _zipf_sizes(60_000, 1.3, 4)
        p = 132
    elif case.startswith("R"):
        R, B = int(case[1:]), 2
    elif case == "ties":
        sizes, unit, width = np.full(4000, 8, np.int64), np.ones(4000), 8
        p, B = 7, 2
    elif case == "zeros":
        unit[np.random.default_rng(1).random(unit.size) < 0.4] = 0.0
        unit[::13] = -0.0
    elif case == "long-chain":
        sizes[2500] = 400_000
        width = 16
    elif case == "one-tile":
        sizes, unit = sizes[:3], unit[:3]
    costs = (1.0 + sizes) * unit
    want = _host_lowering(sizes, costs, p, B, R, width)
    L.reset_launches()
    low = TT.lower_schedule_torch(sizes, costs, p=p, superstep=B,
                                  rows_per_tile=R, width=width, device=cuda)
    torch.cuda.synchronize()
    _assert_device_lowering(low, want)
    if p > 1:
        assert L.LAUNCHES["lpt_assign"] == 1
        assert L.LAUNCHES["segment_fold"] == (2 if B > 1 else 1)
    again = TT.lower_schedule_torch(sizes, costs, p=p, superstep=B,
                                    rows_per_tile=R, width=width,
                                    n_steps=low.n_steps, device=cuda)
    _assert_device_lowering(again, want)


def test_device_pack_equals_numpy(cuda):
    from repro_torch.core import tiling as PT
    from repro_torch.core import tiling_torch as TT
    indptr, indices, data = random_csr(5000, seed=5, max_nnz=400)
    sched = PT.build_schedule(np.diff(indptr))
    vals, cols = PT.pack_csr(indptr, indices, data, sched, pad_tiles_to=8)
    dev = TT.build_schedule_torch(np.diff(indptr), device=cuda)
    tv, tc = TT.pack_csr_torch(indptr, indices, data, dev, pad_tiles_to=8)
    assert tv.is_cuda and torch.equal(tv.cpu(), torch.from_numpy(vals))
    assert torch.equal(tc.cpu(), torch.from_numpy(cols))


@pytest.mark.parametrize("seed", range(3))
def test_segment_fold_kernel_matches_plain(cuda, seed):
    """One thread a run: the same bits as the plain fold and np.bincount,
    runs of 0 to thousands of values, values across 16 decades, and
    identical bits from two calls (no atomics)."""
    from repro_torch.kernels.lpt import lpt as L
    rng = np.random.default_rng(seed)
    runs = rng.integers(0, 12, 5000)
    runs[100] = 5000                     # one long run
    seg = np.repeat(np.arange(5000), runs)
    values = rng.uniform(-1.0, 1.0, seg.size) * 10.0 ** rng.integers(
        -8, 8, seg.size)
    v, s = torch.from_numpy(values), torch.from_numpy(seg)
    L.reset_launches()
    got = L.segment_fold(v.to(cuda), s.to(cuda), 5003)
    again = L.segment_fold(v.to(cuda), s.to(cuda), 5003)
    torch.cuda.synchronize()
    assert L.LAUNCHES["segment_fold"] == 2
    assert torch.equal(got, again)
    assert torch.equal(got.cpu(), L.segment_fold_plain(v, s, 5003))
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  np.bincount(seg, weights=values,
                                              minlength=5003))


@pytest.mark.parametrize("p", [1, 2, 31, 33, 132, 1000])
def test_lpt_assign_kernel_matches_plain(cuda, p):
    """Ties on every step (costs on a 0.1 grid, many equal), phantom
    chains past n_real, p below, at and above one warp's 32 lanes."""
    import heapq
    from repro_torch.kernels.lpt import lpt as L
    rng = np.random.default_rng(p)
    n, n_real = 3000, 2600
    cost = np.zeros(n)
    cost[:n_real] = np.round(rng.uniform(0.0, 4.0, n_real), 1)
    order = np.argsort(-cost + 0.0, kind="stable")
    args = (torch.from_numpy(cost), torch.from_numpy(order),
            torch.tensor([n_real]))
    L.reset_launches()
    got = L.lpt_assign(*(a.to(cuda) for a in args), p)
    torch.cuda.synchronize()
    assert L.LAUNCHES["lpt_assign"] == 1
    assert torch.equal(got.cpu(), L.lpt_assign_plain(*args, p))
    heap, want = [(0.0, w) for w in range(p)], np.full(n, -1, np.int32)
    for c in order[order < n_real]:
        load, w = heapq.heappop(heap)
        want[c] = w
        heapq.heappush(heap, (load + cost[c], w))
    np.testing.assert_array_equal(got.cpu().numpy(), want)


def test_lpt_kernels_refuse_what_they_do_not_take(cuda):
    from repro_torch.kernels.lpt import lpt as L
    v = torch.zeros(8, dtype=torch.float64, device=cuda)
    s = torch.zeros(8, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError, match="seg"):
        L.segment_fold(v, s, 1)
    with pytest.raises(ValueError, match="all on CUDA"):
        L.segment_fold(v, s.long().cpu(), 1)
    order = torch.arange(8, device=cuda)
    with pytest.raises(ValueError, match="at most"):
        L.lpt_assign(v, order, torch.tensor([8], device=cuda),
                     L.MAX_WORKERS + 1)
    with pytest.raises(TypeError, match="cost"):
        L.lpt_assign(v.float(), order, torch.tensor([8], device=cuda), 4)


def test_device_lowering_feeds_the_sharded_kernel(cuda):
    """LoopScheduler(backend="torch"): device_lowering() + pack_csr_torch
    give the host-built op's y and costs bit for bit."""
    from repro_torch.core import tiling_torch as TT
    from repro_torch.kernels.ich_spmv import ich_spmv as K
    from repro_torch.sched import LoopScheduler, NnzCosts
    n = 20_000
    indptr, indices, data = random_csr(n, seed=8, max_nnz=300)
    x = torch.from_numpy(np.random.default_rng(8).standard_normal(n).astype(
        np.float32)).to(cuda)
    ls = LoopScheduler(p=16, backend="torch")
    s = ls.schedule(NnzCosts(indptr))
    op = ls.build("spmv", indptr, indices, data)
    assert op.schedule is s
    low = s.device_lowering()
    vals, cols = TT.pack_csr_torch(indptr, indices, data, low.schedule,
                                   pad_tiles_to=low.superstep)
    y, c = K.ich_spmv_sharded(vals, cols, low.rowid, low.blkid, x, n,
                              low.p, low.superstep, slot_cost=low.slot_cost)
    assert torch.equal(y, op(x)) and torch.equal(c, op.last_costs)


@pytest.mark.parametrize("dead", [(0,), (1, 5)])
@pytest.mark.parametrize("with_log", [True, False])
def test_recovery_combine_bit_identical_on_the_card(cuda, dead, with_log):
    """Rows 2, 4 and 6 on the completed-prefix layout (-1 steps) and the
    survivor layout (p - k rows): combine == the fault-free run bit for
    bit, and each recovery cost stream sums per worker to its layout's
    worker_cost."""
    from repro_torch.core.workloads import bfs_graph
    from repro_torch.kernels.ich_bfs import ich_bfs as KB
    from repro_torch.kernels.ich_kmeans import ich_kmeans as KK
    from repro_torch.kernels.ich_spmv import ich_spmv as KS
    from repro_torch.robust import CheckpointLog
    from repro_torch.sched import LoopScheduler
    from repro_torch.sched.kernels import _sharded_slot_cost
    p = 8

    def plan_for(s):
        sh = s.shard()
        log = None
        if with_log:
            log = CheckpointLog()
            for w in range(p):
                log.mark_through(w, (7 * w) % (sh.n_steps + 1))
        return s.reshard_survivors(dead=dead, checkpoint=log)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(cuda)

    def flat_run(op, kernel, payload, tail):
        """Run a flat-payload sharded kernel (rows 2, 4) on a layout."""
        tc = op.schedule.tile_cost()

        def run(sh):
            y, c = kernel(*payload, put(sh.shard_item_id(op.schedule.item_id)),
                          put(sh.kernel_block_ids()), *tail, sh.p,
                          op.superstep, slot_cost=op.slot_cost)
            np.testing.assert_array_equal(
                c.cpu().numpy().sum(axis=1),
                sh.worker_cost(tc).astype(np.float32))
            return y
        return run

    n = 20_000
    indptr, indices, data = random_csr(n, seed=2, max_nnz=300)
    op = LoopScheduler(p=p).build("spmv", indptr, indices, data)
    x = put(np.random.default_rng(2).standard_normal(n).astype(np.float32))
    run = flat_run(op, KS.ich_spmv_sharded, (op.vals, op.cols), (x, n))
    plan = plan_for(op.schedule)
    assert torch.equal(plan.combine(run(plan.done_shards), run(plan.shards)),
                       op(x))

    gi, gx = bfs_graph("scale_free", n, 2)
    op = LoopScheduler(p=p).build("bfs", gi, gx)
    f = (torch.rand(n, device=cuda) < 0.05).float()
    run = flat_run(op, KB.ich_bfs_step_sharded, (op.mask, op.cols),
                   (f, f, n))
    plan = plan_for(op.schedule)
    assert torch.equal(plan.combine(run(plan.done_shards), run(plan.shards)),
                       op.step(f, f))

    rng = np.random.default_rng(3)
    op = LoopScheduler(p=p).build("kmeans", rng.uniform(1.0, 9.0, n))
    pts = put(rng.standard_normal((n, 34)).astype(np.float32))
    cent = put(rng.standard_normal((5, 34)).astype(np.float32))
    s = op.schedule

    def run_k(sh):
        ids, c = KK.ich_kmeans_assign_sharded(
            pts, cent, put(sh.shard_item_id(s.item_id)), sh.p, op.superstep,
            slot_cost=put(_sharded_slot_cost(s.slot_cost(), sh)))
        np.testing.assert_allclose(c.cpu().numpy().sum(axis=1),
                                   sh.worker_cost(s.tile_cost()), rtol=1e-6)
        return ids

    plan = plan_for(s)
    assert torch.equal(plan.combine(run_k(plan.done_shards),
                                    run_k(plan.shards)), op(pts, cent))
