"""The port's CUDA kernels on the card: each against its plain version, the
sharded kernel against the sequential one bit for bit, and the launch
counters. A CUDA kernel has no CPU mode, so these tests need an NVIDIA GPU
and skip without one; run them there with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerance: y at rtol=atol=1e-5 against the plain version (the plain
version does the same adds; the margin covers PyTorch's own kernels),
the cost stream exactly."""
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
