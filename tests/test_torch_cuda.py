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
from two calls at the serving shapes), the SSD scan from a given state
(N 16 to 512, Pd 33 to 513; one call == two calls split at a chunk
boundary, bit for bit), a reduced xLSTM served on the card against the
CPU (its incremental prefill == a one-shot prefill, bit for bit), the
flash kernel from a query offset (dh 64, 96, 128, GQA ratios 1 to 16,
float32 and bfloat16; its rows == one call's rows bit for bit; bad
offsets refused), a reduced qwen2-1.5b at dh 128 served on the card
(incremental prefill == one-shot bit for bit, the batcher's tokens ==
each request alone), reduced olmoe-1b-7b and deepseek-moe-16b at dh 128
served the same way through the expert kernel (and its rows of a token
planned alone == among all), a reduced whisper-small at dh 64 (the
encoder's and the cross-attention's non-causal flash calls over ragged
keys, 3 x layers launches a prefill) and a reduced phi-3-vision at dh 96
(a patch prefill, decode from S + P, incremental == one-shot bits)
served on the card against the CPU, training (the flash backward
kernel's three launches against their plain formulas at dh 64, 96, 128,
GQA 1 and 6, causal, non-causal and windowed, ragged, float32 and
bfloat16, the same bits twice; the forward's bits with and without the
log-sum-exp; the autograd Function and a reduced qwen2-1.5b train step
at dh 128 on the card against the CPU), and the
schedule
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


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("dh", [64, 96, 128])
@pytest.mark.parametrize("rep", [1, 4, 6, 16])
def test_flash_attention_from_an_offset_matches_plain(cuda, dtype, tol, dh,
                                                      rep):
    """A chunk of queries at q_offset against the whole cache (an
    incremental prefill's call), offsets on and off the 64-row tiles, with
    and without a window: the reference's kernel-test tolerances, as
    above; and the chunk's rows equal the same rows of one call over all
    queries, bit for bit."""
    from repro_torch.kernels.flash_attention import flash_attention as K
    g = torch.Generator(device=cuda).manual_seed(dh + rep)
    Skv, Hkv = 300, 2
    q = torch.randn((2, Skv, Hkv * rep, dh), generator=g, device=cuda)
    k = torch.randn((2, Skv, Hkv, dh), generator=g, device=cuda)
    v = torch.randn((2, Skv, Hkv, dh), generator=g, device=cuda)
    q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    for window in (0, 48):
        whole = K.flash_attention(q, k, v, causal=True, window=window)
        for off, n in ((0, 300), (64, 100), (128, 172), (37, 50), (250, 50),
                       (299, 1)):
            qc = q[:, off:off + n].contiguous()
            K.reset_launches()
            out = K.flash_attention(qc, k, v, causal=True, window=window,
                                    q_offset=off)
            torch.cuda.synchronize()
            assert K.LAUNCHES == {"flash_attention": 1}
            plain = K.flash_attention_plain(qc, k, v, causal=True,
                                            window=window, q_offset=off)
            torch.testing.assert_close(out.float(), plain.float(), rtol=tol,
                                       atol=tol)
            assert torch.equal(out, whole[:, off:off + n]), (off, window)


def test_flash_attention_refuses_a_bad_offset(cuda):
    from repro_torch.kernels.flash_attention import flash_attention as K
    q = torch.zeros((1, 8, 2, 64), device=cuda)
    k = torch.zeros((1, 16, 2, 64), device=cuda)
    with pytest.raises(ValueError, match="q_offset must be >= 0"):
        K.flash_attention(q, k, k, q_offset=-1)
    with pytest.raises(ValueError, match="q_offset \\+ Sq <= Skv"):
        K.flash_attention(q, k, k, causal=True, q_offset=9)
    with pytest.raises(ValueError, match="q_offset \\+ Sq <= Skv"):
        K.flash_attention(q, k, k, causal=False, window=4, q_offset=9)
    # the last position the cache holds, no mask, or causal from 0 with
    # more queries than keys (each keeps key 0): no refusal
    assert K.flash_attention(q, k, k, causal=True, q_offset=8).shape \
        == q.shape
    assert K.flash_attention(q, k, k, causal=False, q_offset=100).shape \
        == q.shape
    assert K.flash_attention(q, k[:, :3], k[:, :3], causal=True).shape \
        == q.shape


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
    qs = torch.zeros((1, 8, 2, 513), device=cuda)
    la = torch.zeros((1, 8, 2), device=cuda)
    with pytest.raises(ValueError, match="N <= 512"):
        KS.mamba_scan(qs, qs, qs, la, chunk=4)
    with pytest.raises(TypeError, match="log_a"):
        KS.mamba_scan(q, q, q, la.double(), chunk=4)
    with pytest.raises(ValueError, match="state must be float32"):
        KS.mamba_scan(q, q, q, la, chunk=4,
                      state=torch.zeros((1, 2, 64, 63), device=cuda))
    # a chunked scan from a state runs the kernel (never the plain
    # version) and matches the plain version
    cfg = reduced(get_arch("zamba2-1.2b"), d_model=256, n_heads=4)
    model = M.init_params(cfg, 0, device=cuda)
    x = torch.randn((1, 20, 256), device=cuda)
    _, st = SS.apply_mamba2(cfg, model.blocks[0].mamba, x)
    KS.reset_launches()
    out, st2 = SS.apply_mamba2(cfg, model.blocks[0].mamba, x, state=st,
                               exact_chunk=True)
    torch.cuda.synchronize()
    assert KS.LAUNCHES == {"mamba_scan": 1}
    cpu_model = M.init_params(cfg, 0, device="cpu")
    cpu_model.load_state_dict({n: t.cpu() for n, t in
                               model.state_dict().items()})
    cpu_st = {n: t.cpu() for n, t in st.items()}
    out_p, st2_p = SS.apply_mamba2(cfg, cpu_model.blocks[0].mamba, x.cpu(),
                                   state=cpu_st, exact_chunk=True)
    torch.testing.assert_close(out.cpu(), out_p, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(st2["ssm"].cpu(), st2_p["ssm"], rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("chunk", [64, 256])
@pytest.mark.parametrize("Pd", [33, 64, 65, 513])
@pytest.mark.parametrize("N", [16, 64, 128, 512])
def test_mamba_scan_kernel_from_a_state_matches_plain(cuda, N, Pd, chunk):
    """The kernel from a given state (its first chunk's inter-chunk term
    reads it) against the plain version, 2e-4, on a ragged S; N over 64
    takes the slices of N, Pd over 64 the score tiles per head."""
    from repro_torch.kernels.mamba_scan import mamba_scan as K
    g = torch.Generator(device=cuda).manual_seed(N * 1000 + Pd + chunk)
    S, H = 300, 2
    q = torch.randn((2, S, H, N), generator=g, device=cuda)
    k = torch.randn((2, S, H, N), generator=g, device=cuda) / N ** 0.5
    v = torch.randn((2, S, H, Pd), generator=g, device=cuda)
    la = -torch.rand((2, S, H), generator=g, device=cuda) * 0.3
    st0 = torch.randn((2, H, N, Pd), generator=g, device=cuda)
    K.reset_launches()
    y, st = K.mamba_scan(q, k, v, la, chunk=chunk, state=st0)
    torch.cuda.synchronize()
    assert K.LAUNCHES == {"mamba_scan": 1}
    y_p, st_p = K.mamba_scan_plain(q, k, v, la, chunk=chunk, state=st0)
    torch.testing.assert_close(y, y_p, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(st, st_p, rtol=2e-4, atol=2e-4)
    y0, st0_out = K.mamba_scan(q, k, v, la, chunk=chunk)
    y0_p, st0_p = K.mamba_scan_plain(q, k, v, la, chunk=chunk)
    torch.testing.assert_close(y0, y0_p, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(st0_out, st0_p, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("N,Pd,shared", [(64, 64, True), (512, 513, False),
                                         (128, 33, False), (16, 64, False)])
def test_mamba_scan_split_calls_bit_identical(cuda, N, Pd, shared):
    """One call equals two calls split at a chunk boundary, the second
    from the first's final state, bit for bit; a zero state gives the bits
    of no state."""
    from repro_torch.kernels.mamba_scan import mamba_scan as K
    g = torch.Generator(device=cuda).manual_seed(N + Pd)
    B, S, H, chunk, cut = 2, 700, 3, 64, 256
    q = torch.randn((B, S, 1 if shared else H, N), generator=g,
                    device=cuda).expand(B, S, H, N)
    k = torch.randn((B, S, 1 if shared else H, N), generator=g,
                    device=cuda).expand(B, S, H, N)
    v = torch.randn((B, S, H, Pd), generator=g, device=cuda)
    la = -torch.rand((B, S, H), generator=g, device=cuda) * 0.3
    y, st = K.mamba_scan(q, k, v, la, chunk=chunk)
    ya, sa = K.mamba_scan(q[:, :cut], k[:, :cut], v[:, :cut].contiguous(),
                          la[:, :cut].contiguous(), chunk=chunk)
    yb, sb = K.mamba_scan(q[:, cut:], k[:, cut:], v[:, cut:].contiguous(),
                          la[:, cut:].contiguous(), chunk=chunk, state=sa)
    assert torch.equal(y, torch.cat([ya, yb], 1)) and torch.equal(st, sb)
    yz, sz = K.mamba_scan(q, k, v, la, chunk=chunk,
                          state=torch.zeros_like(st))
    assert torch.equal(y, yz) and torch.equal(st, sz)


def test_mamba_scan_at_zamba2_shape_keeps_its_path(cuda):
    """Zamba2-1.2B's serving shape (q and k shared by the 64 heads, N = Pd
    = 64) with state=None: the score tiles once a batch row, N in one
    slice; a zero state and a split at a chunk boundary give its bits."""
    from repro_torch.kernels.mamba_scan import mamba_scan as K
    g = torch.Generator(device=cuda).manual_seed(7)
    Cm = torch.randn((4, 2048, 1, 64), generator=g, device=cuda)
    Bm = torch.randn((4, 2048, 1, 64), generator=g, device=cuda)
    qs, ks = Cm.expand(4, 2048, 64, 64), Bm.expand(4, 2048, 64, 64)
    vs = torch.randn((4, 2048, 64, 64), generator=g, device=cuda)
    la = -torch.nn.functional.softplus(
        torch.randn((4, 2048, 64), generator=g, device=cuda))
    assert K._score_heads(qs, ks, 64, 64) == 1
    y, st = K.mamba_scan(qs, ks, vs, la, chunk=256)
    yz, sz = K.mamba_scan(qs, ks, vs, la, chunk=256,
                          state=torch.zeros_like(st))
    assert torch.equal(y, yz) and torch.equal(st, sz)
    ya, sa = K.mamba_scan(qs[:, :1024], ks[:, :1024],
                          vs[:, :1024].contiguous(),
                          la[:, :1024].contiguous(), chunk=256)
    yb, sb = K.mamba_scan(qs[:, 1024:], ks[:, 1024:],
                          vs[:, 1024:].contiguous(),
                          la[:, 1024:].contiguous(), chunk=256, state=sa)
    assert torch.equal(y, torch.cat([ya, yb], 1)) and torch.equal(st, sb)


def test_xlstm_serving_on_the_card_matches_the_cpu(cuda):
    """A reduced xLSTM (an sLSTM block in the pattern, dh 64 so the scan
    runs N = 64, Pd = 65): prefill on the card through the scan kernel
    against the plain version on the CPU within 1e-4; generate gives the
    same ids; the engine's incremental prefill equals a one-shot prefill
    bit for bit on the card."""
    from repro_torch.configs import get_arch, reduced
    from repro_torch.kernels.mamba_scan import mamba_scan as KS
    from repro_torch.models import model as M
    from repro_torch.serve import Engine, EngineConfig
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = reduced(get_arch("xlstm-350m"), d_model=128, n_heads=4,
                  block_pattern=("X", "X", "X", "S"), n_layers=4,
                  ssm_chunk=16)
    model = M.init_params(cfg, 1, device=cuda)
    cpu_model = M.init_params(cfg, 1, device="cpu")
    cpu_model.load_state_dict({n: t.cpu() for n, t in
                               model.state_dict().items()})
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 41)))
    KS.reset_launches()
    logits, cache = M.prefill(cfg, model, {"tokens": toks[:, :40].to(cuda)})
    torch.cuda.synchronize()
    assert KS.LAUNCHES == {"mamba_scan": 3}
    cpu_logits, _ = M.prefill(cfg, cpu_model, {"tokens": toks[:, :40]})
    torch.testing.assert_close(logits.cpu(), cpu_logits, rtol=1e-4,
                               atol=1e-4)
    prompts = toks[:, :40].numpy()
    eng = Engine(cfg, model, EngineConfig(max_seq=64, min_chunk=16))
    ids, stats = eng.generate(prompts, n_new=8)
    cpu_ids, _ = Engine(cfg, cpu_model, EngineConfig(max_seq=64),
                        device="cpu").generate(prompts, n_new=8)
    np.testing.assert_array_equal(ids, cpu_ids)
    assert eng.n_prefill_fallbacks == 0
    last, ext, log = Engine(cfg, model, EngineConfig(
        max_seq=64, min_chunk=1, init_divisor=3.0)).prefill_chunked(prompts)
    assert len(log) > 1 and all(c["chunk"] % 16 == 0 for c in log[:-1])
    assert torch.equal(last, logits)
    for ours, theirs in zip(ext, cache):
        if isinstance(ours, dict):
            assert all(torch.equal(ours[n], theirs[n]) for n in ours)
        else:
            assert torch.equal(ours, theirs)
    d_logits, _ = M.decode_step(cfg, model, toks[:, 40:].to(cuda), cache, 40)
    full, _ = M.prefill(cfg, model, {"tokens": toks.to(cuda)})
    torch.testing.assert_close(d_logits, full, rtol=2e-3, atol=2e-3)


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


def test_dense_incremental_prefill_on_the_card_is_one_shot(cuda):
    """A reduced qwen2-1.5b widened to dh = 128 (the kernel's width), its
    qkv biases drawn at random: on the card, the engine's incremental
    prefill (chunks on multiples of 256 tokens, one flash launch a layer
    from each chunk's offset) gives the one-shot prefill's last
    logits and KV cache bit for bit; the one-shot logits match the CPU's
    plain versions within 1e-4; generate gives the CPU's ids; the
    continuous batcher's tokens equal each request served alone."""
    from repro_torch.configs import get_arch, reduced
    from repro_torch.kernels.flash_attention import flash_attention as KF
    from repro_torch.models import model as M
    from repro_torch.serve import (AdmissionQueue, ContinuousBatcher, Engine,
                                   EngineBackend, EngineConfig, Request,
                                   RoundRobin, SimClock)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = reduced(get_arch("qwen2-1.5b"), d_model=512, n_heads=4,
                  n_kv_heads=2, n_layers=3)
    model = M.init_params(cfg, 2, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(3)
    with torch.no_grad():
        for layer in model.layers:
            for bias in (layer.attn.bq, layer.attn.bk, layer.attn.bv):
                bias.copy_(torch.randn(bias.shape, generator=g,
                                       device=cuda))
    cpu_model = M.init_params(cfg, 2, device="cpu")
    cpu_model.load_state_dict({n: t.cpu() for n, t in
                               model.state_dict().items()})
    prompts = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 700))
    ecfg = EngineConfig(max_seq=768, min_chunk=4)
    KF.reset_launches()
    eng = Engine(cfg, model, ecfg)
    logits, cache, log = eng.prefill_chunked(prompts)
    torch.cuda.synchronize()
    assert len(log) > 1 and all(c["chunk"] % 256 == 0 for c in log[:-1])
    assert KF.LAUNCHES == {"flash_attention": 3 * len(log)}
    one, one_cache = M.prefill(cfg, model, {"tokens": torch.from_numpy(
        prompts).to(cuda)})
    assert torch.equal(logits, one)
    assert all(torch.equal(cache[0][n], one_cache[0][n]) for n in "kv")
    cpu_one, _ = M.prefill(cfg, cpu_model, {"tokens": torch.from_numpy(
        prompts)})
    torch.testing.assert_close(one.cpu(), cpu_one, rtol=1e-4, atol=1e-4)
    ids, _ = Engine(cfg, model, ecfg).generate(prompts, n_new=6)
    cpu_ids, _ = Engine(cfg, cpu_model, ecfg, device="cpu").generate(
        prompts, n_new=6)
    np.testing.assert_array_equal(ids, cpu_ids)
    b = ContinuousBatcher(RoundRobin(chunk=256, min_chunk=4),
                          queue=AdmissionQueue(max_running=4),
                          backend=EngineBackend(Engine(cfg, model, ecfg)),
                          clock=SimClock())
    sts = [b.submit(Request(req_id=i, tokens=prompts[i:i + 1, :n], n_new=5,
                            t_arrival=0.0))
           for i, n in enumerate((700, 300))]
    while b.step():
        pass
    alone = Engine(cfg, model, ecfg)
    for st in sts:
        out, _ = alone.generate(st.request.tokens, n_new=5)
        assert st.out_tokens == out[0].tolist()



@pytest.mark.parametrize("name", ["olmoe-1b-7b", "deepseek-moe-16b"])
def test_moe_incremental_prefill_on_the_card_is_one_shot(cuda, name):
    """A reduced MoE config widened to dh = 128 (olmoe: 3 MoE layers;
    deepseek: its dense layer 0, then 2 MoE layers with shared experts):
    on the card, the engine's incremental prefill (one flash launch a
    layer and one expert kernel launch a MoE layer per chunk) gives the
    one-shot prefill's last logits and every segment's KV cache bit for
    bit; a token's expert rows planned alone equal its rows planned among
    all; the one-shot logits match the CPU's plain versions within 1e-4;
    generate gives the CPU's ids; the batcher's tokens equal each request
    served alone."""
    from repro_torch.configs import get_arch, reduced
    from repro_torch.kernels.flash_attention import flash_attention as KF
    from repro_torch.kernels.ich_moe import ich_moe as KM
    from repro_torch.models import model as M
    from repro_torch.models import moe as MOE
    from repro_torch.serve import (AdmissionQueue, ContinuousBatcher, Engine,
                                   EngineBackend, EngineConfig, Request,
                                   RoundRobin, SimClock)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = reduced(get_arch(name), d_model=512, n_heads=4, n_kv_heads=4,
                  n_layers=3, n_experts=8, moe_d_ff=256)
    n_moe = cfg.n_layers - cfg.moe_layer_start
    model = M.init_params(cfg, 2, device=cuda)
    cpu_model = M.init_params(cfg, 2, device="cpu")
    cpu_model.load_state_dict({n: t.cpu() for n, t in
                               model.state_dict().items()})
    prompts = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 700))
    ecfg = EngineConfig(max_seq=768, min_chunk=4)
    KF.reset_launches()
    KM.reset_launches()
    eng = Engine(cfg, model, ecfg)
    logits, cache, log = eng.prefill_chunked(prompts)
    torch.cuda.synchronize()
    assert len(log) > 1 and all(c["chunk"] % 256 == 0 for c in log[:-1])
    assert KF.LAUNCHES == {"flash_attention": 3 * len(log)}
    assert KM.LAUNCHES == {"ich_moe_sharded": n_moe * len(log)}
    one, one_cache = M.prefill(cfg, model, {"tokens": torch.from_numpy(
        prompts).to(cuda)})
    assert torch.equal(logits, one)
    assert all(torch.equal(a[n], b[n]) for a, b in zip(cache, one_cache)
               for n in "kv")
    p = model.layers[-1].moe
    x = torch.randn((2, 700, cfg.d_model), device=cuda)
    routing = MOE.route(p, x, cfg.experts_per_token)
    y_all, _ = MOE.moe_local(cfg, p, x.reshape(1400, -1), dropless=True,
                             routing=routing)
    for n in (1, 3, 256):
        y_n, _ = MOE.moe_local(cfg, p, x.reshape(1400, -1)[:n],
                               dropless=True,
                               routing=tuple(r[:n] for r in routing))
        assert torch.equal(y_n, y_all[:n])
    cpu_one, _ = M.prefill(cfg, cpu_model, {"tokens": torch.from_numpy(
        prompts)})
    torch.testing.assert_close(one.cpu(), cpu_one, rtol=1e-4, atol=1e-4)
    ids, _ = Engine(cfg, model, ecfg).generate(prompts, n_new=6)
    cpu_ids, _ = Engine(cfg, cpu_model, ecfg, device="cpu").generate(
        prompts, n_new=6)
    np.testing.assert_array_equal(ids, cpu_ids)
    b = ContinuousBatcher(RoundRobin(chunk=256, min_chunk=4),
                          queue=AdmissionQueue(max_running=4),
                          backend=EngineBackend(Engine(cfg, model, ecfg)),
                          clock=SimClock())
    sts = [b.submit(Request(req_id=i, tokens=prompts[i:i + 1, :n], n_new=5,
                            t_arrival=0.0))
           for i, n in enumerate((700, 300))]
    while b.step():
        pass
    alone = Engine(cfg, model, ecfg)
    for st in sts:
        out, _ = alone.generate(st.request.tokens, n_new=5)
        assert st.out_tokens == out[0].tolist()

def test_whisper_serving_on_the_card_matches_the_cpu(cuda):
    """A reduced whisper-small widened to dh = 64 (d_model 256, 4 heads, 4
    KV heads) over 300 frames (ragged against the kernel's 64-key
    blocks): on the card, one prefill launches the flash kernel 3 x
    layers times (the encoder's non-causal blocks, the decoder's causal
    self-attention without RoPE, its non-causal cross-attention of 40
    queries against 300 keys); its logits and both caches match the CPU's
    plain versions within 1e-4, and so do 4 greedy decode steps, with the
    same ids."""
    from repro_torch.configs import get_arch, reduced
    from repro_torch.kernels.flash_attention import flash_attention as KF
    from repro_torch.models import model as M
    from repro_torch.serve import Engine, EngineConfig
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = reduced(get_arch("whisper-small"), d_model=256, n_heads=4,
                  n_kv_heads=4, encoder_seq=300)
    model = M.init_params(cfg, 5, max_seq=320, device=cuda)
    cpu_model = M.init_params(cfg, 5, max_seq=320, device="cpu")
    cpu_model.load_state_dict({n: t.cpu() for n, t in
                               model.state_dict().items()})
    rng = np.random.default_rng(6)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 40)))
    frames = torch.from_numpy(rng.standard_normal(
        (2, 300, cfg.d_model)).astype(np.float32))
    KF.reset_launches()
    logits, cache = M.prefill(cfg, model, {"tokens": tokens.to(cuda),
                                           "frames": frames.to(cuda)})
    torch.cuda.synchronize()
    assert KF.LAUNCHES == {"flash_attention": cfg.encoder_layers
                           + 2 * cfg.n_layers} == {"flash_attention": 6}
    cpu_logits, cpu_cache = M.prefill(cfg, cpu_model, {"tokens": tokens,
                                                       "frames": frames})
    torch.testing.assert_close(logits.cpu(), cpu_logits, rtol=1e-4,
                               atol=1e-4)
    for ours, theirs in ((cache["self"][0], cpu_cache["self"][0]),
                         (cache["cross"], cpu_cache["cross"])):
        for n in "kv":
            torch.testing.assert_close(ours[n].cpu(), theirs[n], rtol=1e-4,
                                       atol=1e-4)
    cache = Engine(cfg, model, EngineConfig(max_seq=64))._pad_cache(cache)
    cpu_cache = Engine(cfg, cpu_model, EngineConfig(max_seq=64),
                       device="cpu")._pad_cache(cpu_cache)
    for i in range(4):
        tok = torch.argmax(cpu_logits, -1)[:, None]
        assert torch.equal(torch.argmax(logits, -1).cpu()[:, None], tok)
        logits, cache = M.decode_step(cfg, model, tok.to(cuda), cache,
                                      40 + i)
        cpu_logits, cpu_cache = M.decode_step(cfg, cpu_model, tok,
                                              cpu_cache, 40 + i)
        torch.testing.assert_close(logits.cpu(), cpu_logits, rtol=1e-4,
                                   atol=1e-4)
    assert KF.LAUNCHES == {"flash_attention": 6}     # decode is plain


def test_vlm_serving_on_the_card_matches_the_cpu(cuda):
    """A reduced phi-3-vision widened to dh = 96 (d_model 384, 4 heads, 4
    KV heads), 64 patch rows before 300 tokens: on the card the patch
    prefill (one flash launch a layer) and decode from S + P match the
    CPU's plain versions within 1e-4; text only, the engine's incremental
    prefill gives the one-shot prefill's bits, and generate the CPU's
    ids."""
    from repro_torch.configs import get_arch, reduced
    from repro_torch.kernels.flash_attention import flash_attention as KF
    from repro_torch.models import model as M
    from repro_torch.serve import Engine, EngineConfig
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = reduced(get_arch("phi-3-vision-4.2b"), d_model=384, n_heads=4,
                  n_kv_heads=4, num_patches=64)
    assert cfg.dh == 96
    model = M.init_params(cfg, 7, device=cuda)
    cpu_model = M.init_params(cfg, 7, device="cpu")
    cpu_model.load_state_dict({n: t.cpu() for n, t in
                               model.state_dict().items()})
    rng = np.random.default_rng(8)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 302)))
    patches = torch.from_numpy(rng.standard_normal(
        (2, 64, cfg.d_model)).astype(np.float32))
    KF.reset_launches()
    logits, cache = M.prefill(cfg, model, {"tokens": tokens[:, :300].to(
        cuda), "patches": patches.to(cuda)})
    torch.cuda.synchronize()
    assert KF.LAUNCHES == {"flash_attention": cfg.n_layers}
    cpu_logits, cpu_cache = M.prefill(cfg, cpu_model, {
        "tokens": tokens[:, :300], "patches": patches})
    torch.testing.assert_close(logits.cpu(), cpu_logits, rtol=1e-4,
                               atol=1e-4)
    for n in "kv":
        assert cache[0][n].shape[2] == 364
        torch.testing.assert_close(cache[0][n].cpu(), cpu_cache[0][n],
                                   rtol=1e-4, atol=1e-4)
    eng = Engine(cfg, model, EngineConfig(max_seq=384))
    cpu_eng = Engine(cfg, cpu_model, EngineConfig(max_seq=384),
                     device="cpu")
    cache, cpu_cache = eng._pad_cache(cache), cpu_eng._pad_cache(cpu_cache)
    for i in range(2):
        tok = tokens[:, 300 + i:301 + i]
        logits, cache = M.decode_step(cfg, model, tok.to(cuda), cache,
                                      364 + i)
        cpu_logits, cpu_cache = M.decode_step(cfg, cpu_model, tok,
                                              cpu_cache, 364 + i)
        torch.testing.assert_close(logits.cpu(), cpu_logits, rtol=1e-4,
                                   atol=1e-4)
    prompts = tokens[:, :300].numpy()
    last, ext, log = Engine(cfg, model, EngineConfig(
        max_seq=384, min_chunk=4, init_divisor=3.0)).prefill_chunked(prompts)
    assert len(log) > 1 and all(c["chunk"] % 256 == 0 for c in log[:-1])
    one, one_cache = M.prefill(cfg, model, {"tokens": torch.from_numpy(
        prompts).to(cuda)})
    assert torch.equal(last, one)
    assert all(torch.equal(ext[0][n], one_cache[0][n]) for n in "kv")
    ids, _ = eng.generate(prompts, n_new=6)
    cpu_ids, _ = cpu_eng.generate(prompts, n_new=6)
    np.testing.assert_array_equal(ids, cpu_ids)


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


def _fold_streams(seed):
    """(values, ids, n_segments) streams for `segment_fold`: runs of 0 to
    thousands of values across 16 decades, then runs around the kernel's
    spans (a warp's 128 values, a CTA's 1,024): lengths 127 to 1,025 and
    one from inside a span across many, with empty segments before the
    first id, between runs and after the last id, and ids below 0 and at
    or past n_segments (dropped)."""
    rng = np.random.default_rng(seed)
    runs = rng.integers(0, 12, 5000)
    runs[100] = 5000                     # one long run
    seg = np.repeat(np.arange(5000), runs)
    yield seg, 5003
    lengths = [127, 128, 129, 1, 1023, 1024, 1025, 3, 2500, 128]
    ids = np.cumsum(rng.integers(1, 4, len(lengths))) + 4   # gaps, from 5
    seg = np.repeat(ids, lengths)
    yield seg, int(ids[-1]) + 9                              # empty tail
    seg = np.concatenate([np.full(70, -3), np.repeat(ids, lengths),
                          np.full(200, ids[-1] + 20)])
    yield seg, int(ids[-1]) + 5                              # dropped ids


@pytest.mark.parametrize("seed", range(3))
def test_segment_fold_kernel_matches_plain(cuda, seed):
    """Runs folded by the thread at their head and, past a span, by the
    whole warp: the same bits as the plain fold and np.bincount, with the
    empty segments' zeros written by the kernel, and identical bits from
    two calls (no atomics)."""
    from repro_torch.kernels.lpt import lpt as L
    rng = np.random.default_rng(seed)
    for seg, n_seg in _fold_streams(seed):
        values = rng.uniform(-1.0, 1.0, seg.size) * 10.0 ** rng.integers(
            -8, 8, seg.size)
        v, s = torch.from_numpy(values), torch.from_numpy(seg)
        L.reset_launches()
        got = L.segment_fold(v.to(cuda), s.to(cuda), n_seg)
        again = L.segment_fold(v.to(cuda), s.to(cuda), n_seg)
        torch.cuda.synchronize()
        assert L.LAUNCHES["segment_fold"] == 2
        assert torch.equal(got, again)
        assert torch.equal(got.cpu(), L.segment_fold_plain(v, s, n_seg))
        keep = (seg >= 0) & (seg < n_seg)
        np.testing.assert_array_equal(
            got.cpu().numpy(), np.bincount(seg[keep], weights=values[keep],
                                           minlength=n_seg))


def _lpt_cases(p):
    """(name, cost, order, n_real) inputs for `lpt_assign` at p workers."""
    rng = np.random.default_rng(p)
    n, n_real = 3000, 2600
    cost = np.zeros(n)
    cost[:n_real] = np.round(rng.uniform(0.0, 4.0, n_real), 1)
    yield "sorted", cost, np.argsort(-cost + 0.0, kind="stable"), n_real
    yield "unsorted", cost, np.concatenate(
        [rng.permutation(n_real), np.arange(n_real, n)]), n_real
    yield "phantoms-interleaved", cost, rng.permutation(n), n_real
    mid = cost.copy()
    order = np.argsort(-mid + 0.0, kind="stable")
    mid[order[1000:1400]] = 0.0          # a zero-cost run in the middle
    mid[order[1400]] = -0.0
    yield "zero-run-middle", mid, order, n_real
    if p == 2:                           # one chain a round, then pairs
        half = 2.0 ** -np.arange(1500.0)
        yield "halving", half, np.arange(1500), 1500
    if p == 132:                         # wikipedia-like chain costs
        zipf = np.minimum(rng.zipf(1.5, 50_000), 250) * rng.integers(
            463, 1610, 50_000).astype(np.float64)
        yield "zipf", zipf, np.argsort(-zipf + 0.0, kind="stable"), 50_000
    if p > 1024:                         # a round sees 1,024 of p workers
        many = np.round(rng.uniform(0.0, 4.0, 3 * p), 1)
        yield "windowed", many, np.argsort(-many + 0.0, kind="stable"), 3 * p
        yield "windowed-unsorted", many, rng.permutation(3 * p), 3 * p


@pytest.mark.parametrize("p", [1, 2, 31, 33, 132, 1000, 1025, 4096])
def test_lpt_assign_kernel_matches_plain(cuda, p):
    """Ties on every step (costs on a 0.1 grid, many equal), phantom
    chains past n_real and interleaved, an unsorted order, a zero-cost
    run in the middle, p below, at and above one warp's 32 lanes, and
    past the round window (1,025 and MAX_WORKERS: the 1,024-thread CTA
    holds more keys than threads): the kernel's rounds give the plain
    version's and heapq's workers, the same bits twice, in the rounds the
    numpy mirror counts."""
    from _lpt_rounds import heapq_lpt, round_lpt
    from repro_torch.kernels.lpt import lpt as L
    assert p <= L.MAX_WORKERS
    for name, cost, order, n_real in _lpt_cases(p):
        args = (torch.from_numpy(cost), torch.from_numpy(order),
                torch.tensor([n_real]))
        L.reset_launches()
        got = L.lpt_assign(*(a.to(cuda) for a in args), p)
        rounds = int(L.LAST_ROUNDS)
        again = L.lpt_assign(*(a.to(cuda) for a in args), p)
        torch.cuda.synchronize()
        assert L.LAUNCHES["lpt_assign"] == 2, name
        assert torch.equal(got, again), name
        want, want_rounds = round_lpt(cost, order, n_real, p)
        np.testing.assert_array_equal(got.cpu().numpy(),
                                      heapq_lpt(cost, order, n_real, p))
        np.testing.assert_array_equal(want, got.cpu().numpy())
        assert rounds == want_rounds, (name, rounds, want_rounds)
        assert torch.equal(got.cpu(), L.lpt_assign_plain(*args, p)), name


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


# ------------------------------------------------- training (flash backward)
def _bwd_inputs(cuda, Sq, Skv, rep, dh, dtype, seed, Hkv=2, B=2):
    g = torch.Generator(device=cuda).manual_seed(seed)
    q = torch.randn((B, Sq, Hkv * rep, dh), generator=g, device=cuda)
    k = torch.randn((B, Skv, Hkv, dh), generator=g, device=cuda)
    v = torch.randn((B, Skv, Hkv, dh), generator=g, device=cuda)
    dout = torch.randn(q.shape, generator=g, device=cuda)
    return [t.to(dtype) for t in (q, k, v, dout)]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("Sq,Skv,rep,dh,causal,window", [
    (128, 128, 1, 64, True, 0), (200, 200, 6, 128, True, 0),
    (77, 77, 6, 96, True, 0), (96, 150, 1, 64, False, 0),
    (150, 96, 6, 128, False, 0), (130, 130, 6, 64, True, 32),
    (100, 140, 1, 96, False, 32), (300, 200, 6, 128, True, 0),
    (17, 17, 1, 128, True, 0), (1, 65, 6, 64, False, 0),
    (65, 3, 1, 96, False, 0), (129, 129, 1, 128, False, 5),
    # the dK/dV grid pairs key blocks j and nKB - 1 - j: an odd nKB (5),
    # one key block, and a ragged last block at B 1
    (320, 320, 6, 128, True, 0), (40, 40, 6, 64, True, 0),
    (2065, 2065, 6, 128, True, 0),
    # windows that cut the walks at both ends (causal from one end, the
    # window from the other)
    (700, 700, 6, 128, True, 200), (333, 333, 1, 96, True, 100)])
def test_flash_backward_kernel_matches_plain(cuda, dtype, tol, Sq, Skv, rep,
                                             dh, causal, window):
    """dq, dk, dv of the three kernels against the plain formulas within
    `tol` of each gradient's largest element (float32: both sum in float32,
    in other orders; bfloat16: the same bfloat16 inputs, the outputs
    rounded to bfloat16 — the reference's bfloat16 kernel bar; the tensor
    cores' products also round P and dS to bfloat16), the forward's
    log-sum-exp within 1e-5 of torch.logsumexp, one counted launch a call,
    and the same bits from a second call (no atomics)."""
    from repro_torch.kernels.flash_attention import flash_attention as K
    from repro_torch.kernels.flash_attention import flash_attention_bwd as KB
    q, k, v, dout = _bwd_inputs(cuda, Sq, Skv, rep, dh, dtype,
                                Sq + Skv + rep + dh, B=1 if Sq > 2048 else 2)
    out, lse = K.flash_attention_lse(q, k, v, causal=causal, window=window)
    p_out, p_lse = K.flash_attention_lse_plain(q, k, v, causal=causal,
                                               window=window)
    torch.testing.assert_close(lse, p_lse, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(out.float(), p_out.float(), rtol=2e-2 if
                               dtype == torch.bfloat16 else 2e-5,
                               atol=2e-2 if dtype == torch.bfloat16 else 2e-5)
    KB.reset_launches()
    grads = KB.flash_attention_backward(q, k, v, out, dout, lse,
                                        causal=causal, window=window)
    torch.cuda.synchronize()
    assert KB.LAUNCHES == {"flash_attention_bwd": 1}
    plain = KB.flash_attention_backward_plain(q, k, v, out, dout, lse,
                                              causal=causal, window=window)
    for a, b in zip(grads, plain):
        assert a.dtype == dtype and a.shape == b.shape
        err = float((a.float() - b.float()).abs().max())
        assert err <= tol * float(b.float().abs().max()) + 1e-6, err
    again = KB.flash_attention_backward(q, k, v, out, dout, lse,
                                        causal=causal, window=window)
    assert all(torch.equal(a, b) for a, b in zip(grads, again))


def _block_share(a, b, rows=64) -> float:
    """The largest max |a - b| of a block of `rows` rows (dim 1) of one
    (batch, head) of (B, S, H, dh) tensors, as a share of that block's max
    |b| (a block whose b is all zero must match exactly)."""
    B, S, H, dh = b.shape

    def block_max(t):
        return t.abs().reshape(B, S // rows, rows, H, dh).amax(dim=(2, 4))
    diff, ref = block_max(a.float() - b.float()), block_max(b.float())
    return float(torch.where(ref > 0, diff / ref, torch.where(
        diff > 0, torch.inf, 0.0)).max())


def test_flash_backward_at_the_training_shape(cuda):
    """qwen2-1.5b's training shape at B 1 (2,048 tokens, 12 / 2 heads of
    128, causal), bfloat16: dq, dk, dv within 1e-2 of each 64-row block's
    max |plain| per (batch, head) (one bfloat16 ulp is at most 2^-7 of
    the block's max), and the same bits from a second call."""
    from repro_torch.kernels.flash_attention import flash_attention as K
    from repro_torch.kernels.flash_attention import flash_attention_bwd as KB
    q, k, v, dout = _bwd_inputs(cuda, 2048, 2048, 6, 128, torch.bfloat16,
                                26, B=1)
    out, lse = K.flash_attention_lse(q, k, v, causal=True)
    grads = KB.flash_attention_backward(q, k, v, out, dout, lse)
    plain = KB.flash_attention_backward_plain(q, k, v, out, dout, lse)
    for a, b in zip(grads, plain):
        assert _block_share(a, b) <= 1e-2
    again = KB.flash_attention_backward(q, k, v, out, dout, lse)
    assert all(torch.equal(a, b) for a, b in zip(grads, again))


def test_flash_backward_takes_views_off_the_16_byte_grid(cuda):
    """Contiguous bfloat16 views that start one element past an aligned
    address (the kernels copy 16 bytes at a time) give the bits of the
    same values in aligned buffers."""
    from repro_torch.kernels.flash_attention import flash_attention as K
    from repro_torch.kernels.flash_attention import flash_attention_bwd as KB
    q, k, v, dout = _bwd_inputs(cuda, 130, 130, 6, 64, torch.bfloat16, 31)
    out, lse = K.flash_attention_lse(q, k, v, causal=True)

    def shifted(t):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        assert view.is_contiguous() and view.data_ptr() % 16 != 0
        return view
    aligned = KB.flash_attention_backward(q, k, v, out, dout, lse)
    off = KB.flash_attention_backward(shifted(q), shifted(k), shifted(v),
                                      out, shifted(dout), lse)
    assert all(torch.equal(a, b) for a, b in zip(aligned, off))


def test_flash_forward_bits_do_not_depend_on_the_lse(cuda):
    """Serving calls (no log-sum-exp) give the bits of the same call that
    writes it, at rows 8b's and 8g's extend shapes and from position 0."""
    from repro_torch.kernels.flash_attention import flash_attention as K
    g = torch.Generator(device=cuda).manual_seed(9)
    for dtype in (torch.float32, torch.bfloat16):
        for Hq, Hkv, dh, off in ((12, 2, 128, 1536), (32, 32, 96, 1536),
                                 (12, 2, 128, 0)):
            Sq = 512 if off else 2048
            q = torch.randn((1, Sq, Hq, dh), generator=g,
                            device=cuda).to(dtype)
            k = torch.randn((1, 2048, Hkv, dh), generator=g,
                            device=cuda).to(dtype)
            served = K.flash_attention(q, k, k, causal=True, q_offset=off)
            with_lse, lse = K._launch(q, k, k, causal=True, window=0,
                                      q_offset=off, lse=True)
            assert torch.equal(served, with_lse)
            assert lse.shape == (1, Hq, Sq) and bool(torch.isfinite(lse).all())


def test_flash_function_on_the_card_matches_the_cpu(cuda):
    """The autograd Function on CUDA tensors (the kernels) against the
    same Function on the CPU (the plain versions) from the same inputs."""
    from repro_torch.kernels.flash_attention import flash_attention as K
    from repro_torch.kernels.flash_attention import flash_attention_bwd as KB
    q, k, v, dout = _bwd_inputs(cuda, 150, 150, 6, 128, torch.float32, 4)
    res = {}
    for dev in (cuda, torch.device("cpu")):
        leaves = [t.detach().to(dev).requires_grad_() for t in (q, k, v)]
        K.reset_launches()
        KB.reset_launches()
        out = K.flash_attention(*leaves, causal=True)
        grads = torch.autograd.grad(out, leaves, dout.to(dev))
        res[dev.type] = [out, *grads]
        launched = (K.LAUNCHES["flash_attention"],
                    KB.LAUNCHES["flash_attention_bwd"])
        assert launched == ((1, 1) if dev.type == "cuda" else (0, 0))
    for a, b in zip(res["cuda"], res["cpu"]):
        torch.testing.assert_close(a.detach().cpu(), b.detach(), rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("remat", [False, True])
def test_train_step_on_the_card_matches_the_cpu(cuda, remat):
    """One float32 step of a reduced qwen2-1.5b at dh 128 (d_model 256, 2
    heads, 1 KV head) on the card and on the CPU from the same state and
    batch: loss within 1e-5 and grad norm within 1e-4 relative (float32
    sums in other orders), every parameter within 2 lr + 1e-6 |p| (Adam's
    first step moves an element by +-lr whatever its gradient's size);
    then three bfloat16 steps on the card with finite, falling losses."""
    from repro_torch.configs import get_arch, reduced
    from repro_torch.data.pipeline import synthetic_tokens
    from repro_torch.kernels.flash_attention import flash_attention as K
    from repro_torch.kernels.flash_attention import flash_attention_bwd as KB
    from repro_torch.optim import adamw
    from repro_torch.train import checkpoint as CKPT
    from repro_torch.train import train_step as TS
    cfg = reduced(get_arch("qwen2-1.5b"), d_model=256, n_heads=2,
                  n_kv_heads=1, remat=remat)
    tcfg = TS.TrainConfig(dtype=torch.float32, opt=adamw.AdamWConfig(
        warmup_steps=2, total_steps=10))
    cpu = TS.init_train_state(cfg, 0, tcfg=tcfg, device="cpu")
    card = TS.init_train_state(cfg, 1, tcfg=tcfg, device=cuda)
    with torch.no_grad():
        for (_, a), (_, b) in zip(CKPT.state_leaves(cpu),
                                  CKPT.state_leaves(card)):
            b.copy_(a)
    batch = synthetic_tokens(2, 200, cfg.padded_vocab, 0, 5)
    K.reset_launches()
    KB.reset_launches()
    card, mc = TS.make_train_step(cfg, tcfg)(
        card, {k: torch.from_numpy(v).to(cuda) for k, v in batch.items()})
    torch.cuda.synchronize()
    assert K.LAUNCHES["flash_attention"] == cfg.n_layers * (1 + remat)
    assert KB.LAUNCHES["flash_attention_bwd"] == cfg.n_layers
    cpu, mp = TS.make_train_step(cfg, tcfg)(
        cpu, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(mc["loss"]), float(mp["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(mc["grad_norm"]),
                               float(mp["grad_norm"]), rtol=1e-4)
    lr = float(mp["lr"])
    for (n, a), (_, b) in zip(card["params"].named_parameters(),
                              cpu["params"].named_parameters()):
        diff = (a.detach().cpu() - b.detach()).abs()
        assert bool((diff <= 2 * lr + 1e-6 * b.detach().abs()).all()), n
    bf = TS.TrainConfig(opt=adamw.AdamWConfig(warmup_steps=1,
                                              total_steps=10))
    state, step = TS.init_train_state(cfg, 2, device=cuda, tcfg=bf), \
        TS.make_train_step(cfg, bf)
    toks = {k: torch.from_numpy(v).to(cuda) for k, v in
            synthetic_tokens(4, 256, cfg.padded_vocab, 1, 5).items()}
    losses = [float(step(state, toks)[1]["loss"]) for _ in range(3)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
