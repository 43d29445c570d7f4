"""Construction parity: the port's host schedule construction against the
reference's. Tiles, shard layouts, packed payloads and slot-cost streams
must be element-identical — the port copies this code and both kernels
walk these arrays."""
import dataclasses

import numpy as np
import pytest

from conftest import random_csr
from repro.core import policies as RP
from repro.core import tiling as RT
from repro.core import welford as RW
from repro.core import workloads as RWL
from repro_torch.core import policies as PP
from repro_torch.core import tiling as PT
from repro_torch.core import welford as PW
from repro_torch.core import workloads as PWL

CASES = [(220, 1.8, 0), (500, 1.5, 1), (64, 2.5, 2), (1000, 1.3, 3)]


def dataclasses_equal(a, b):
    return dataclasses.asdict(a) == dataclasses.asdict(b)


@pytest.mark.parametrize("n,zipf_a,seed", CASES)
@pytest.mark.parametrize("R", [4, 8])
def test_build_and_pack_element_identical(n, zipf_a, seed, R):
    indptr, indices, data = random_csr(n, zipf_a, seed=seed)
    sizes = np.diff(indptr)
    ref = RT.build_schedule(sizes, rows_per_tile=R)
    port = PT.build_schedule(sizes, rows_per_tile=R)
    assert port.width == ref.width
    for a, b in zip(PT.split_items(sizes, port.width),
                    RT.split_items(sizes, ref.width)):
        np.testing.assert_array_equal(a, b)
    for f in ("item_id", "seg_start", "seg_len"):
        np.testing.assert_array_equal(getattr(port, f), getattr(ref, f))
    np.testing.assert_array_equal(port.slot_cost(sizes, sizes),
                                  ref.slot_cost(sizes, sizes))
    for B in (1, 8):
        rv, rc = RT.pack_csr(indptr, indices, data, ref, pad_tiles_to=B)
        pv, pc = PT.pack_csr(indptr, indices, data, port, pad_tiles_to=B)
        np.testing.assert_array_equal(pv, rv)
        np.testing.assert_array_equal(pc, rc)
    # the loop oracles agree with the vectorized construction
    oracle = PT._reference_build_schedule(sizes, rows_per_tile=R)
    np.testing.assert_array_equal(oracle.item_id, port.item_id)
    ov, oc = PT._reference_pack_csr(indptr, indices, data, port)
    pv, pc = PT.pack_csr(indptr, indices, data, port)
    np.testing.assert_array_equal(ov, pv)
    np.testing.assert_array_equal(oc, pc)


@pytest.mark.parametrize("n,zipf_a,seed", CASES)
@pytest.mark.parametrize("p,B", [(1, 1), (3, 4), (4, 8), (8, 1)])
def test_shard_layout_element_identical(n, zipf_a, seed, p, B):
    indptr, _, _ = random_csr(n, zipf_a, seed=seed)
    sizes = np.diff(indptr)
    rng = np.random.default_rng(seed)
    costs = sizes * rng.uniform(0.5, 2.0, sizes.size)  # float tile costs
    ref = RT.build_schedule(sizes)
    port = PT.build_schedule(sizes)
    rs = RT.shard_schedule(ref, ref.tile_cost(costs, sizes), p, superstep=B)
    ps = PT.shard_schedule(port, port.tile_cost(costs, sizes), p,
                           superstep=B)
    np.testing.assert_array_equal(ps.worker, rs.worker)
    np.testing.assert_array_equal(ps.block_perm, rs.block_perm)
    np.testing.assert_array_equal(ps.kernel_block_ids(),
                                  rs.kernel_block_ids())
    np.testing.assert_array_equal(ps.shard_item_id(port.item_id),
                                  rs.shard_item_id(ref))
    np.testing.assert_array_equal(ps.worker_cost(port.tile_cost(costs, sizes)),
                                  rs.worker_cost(ref.tile_cost(costs, sizes)))


def test_empty_sizes_give_a_zero_tile_schedule():
    ref = RT.build_schedule(np.zeros(0, np.int64))
    port = PT.build_schedule(np.zeros(0, np.int64))
    assert port.n_tiles == ref.n_tiles == 0 and port.width == ref.width
    ps = PT.shard_schedule(port, port.tile_cost(np.zeros(0), np.zeros(0)), 4)
    rs = RT.shard_schedule(ref, ref.tile_cost(np.zeros(0), np.zeros(0)), 4)
    np.testing.assert_array_equal(ps.block_perm, rs.block_perm)
    np.testing.assert_array_equal(ps.shard_item_id(port.item_id),
                                  rs.shard_item_id(ref))


@pytest.mark.parametrize("name", ["wikipedia", "circuit5M_dc", "uk-2005"])
def test_table1_synthesis_identical(name):
    spec = next(s for s in PWL.TABLE1 if s.name == name)
    rspec = next(s for s in RWL.TABLE1 if s.name == name)
    assert dataclasses_equal(spec, rspec)
    for seed in (0, 1):
        np.testing.assert_array_equal(
            PWL.matrix_row_nnz(spec, n=20_000, seed=seed),
            RWL.matrix_row_nnz(rspec, n=20_000, seed=seed))
        np.testing.assert_array_equal(
            PWL.spmv_costs(spec, n=5_000, seed=seed),
            RWL.spmv_costs(rspec, n=5_000, seed=seed))


def test_policies_and_welford_match_reference():
    for make in ("ich", "dynamic", "guided", "stealing", "static"):
        assert dataclasses_equal(getattr(PP, make)(), getattr(RP, make)())
        assert getattr(PP, make)().label() == getattr(RP, make)().label()
    rng = np.random.default_rng(0)
    pw, rw = PW.WelfordVec.zeros(50), RW.WelfordVec.zeros(50)
    for _ in range(5):
        xs = rng.standard_normal(50)
        mask = rng.random(50) < 0.7
        pw.update(xs, mask)
        rw.update(xs, mask)
    for f in ("count", "mean", "m2", "variance"):
        np.testing.assert_array_equal(getattr(pw, f), getattr(rw, f))
