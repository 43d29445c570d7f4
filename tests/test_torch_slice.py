"""The SpMV, BFS and K-Means slices end to end through both packages (MoE
dispatch's is in tests/test_torch_moe.py, Zamba2 serving's in
tests/test_torch_lm.py), and
the port's boundaries: it imports nothing of JAX or of `repro`, its entry
points run on the card unless asked for the CPU, and its kernel libraries
are rebuilt when a source or a shared header changes.

Tolerances: SpMV's y at rtol = atol = 1e-5 (XLA sums a tile's slots in
another order than the port's left folds); BFS levels and K-Means ids
exactly (0/1 maxima and argmins of well-separated distances); integer cost
streams exactly, K-Means' float cost stream at rtol 1e-6 (summation
order)."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from conftest import random_csr
from repro import sched as RS
from repro.sched.kernels import BfsOp as RefBfsOp
from repro.sched.kernels import KMeansOp as RefKMeansOp
from repro_torch import sched as PS
from repro_torch.core.workloads import bfs_graph, kmeans_rounds
from repro_torch.kernels import _build
from repro_torch.kernels.ich_bfs import ich_bfs as KB
from repro_torch.kernels.ich_kmeans import ich_kmeans as KK
from repro_torch.kernels.ich_spmv import ich_spmv as K

ROOT = Path(__file__).resolve().parents[1]
N = 260


def _assert_same_schedule(port, ref, cost_rtol=0.0):
    assert port.width == ref.width and port.generation == ref.generation
    np.testing.assert_array_equal(port.item_id, ref.item_id)
    np.testing.assert_allclose(port.costs, ref.costs, rtol=cost_rtol, atol=0)
    np.testing.assert_array_equal(port.shard().worker, ref.shard().worker)
    np.testing.assert_array_equal(port.shard().block_perm,
                                  ref.shard().block_perm)


def test_slice_end_to_end_matches_reference():
    indptr, indices, data = random_csr(N, seed=11)
    rng = np.random.default_rng(12)
    x = rng.standard_normal(N).astype(np.float32)
    ref_op = RS.LoopScheduler(p=4).build("spmv", indptr, indices, data)
    port_op = PS.LoopScheduler(p=4, device="cpu").build(
        "spmv", indptr, indices, data)
    K.reset_launches()
    for round_ in range(2):
        _assert_same_schedule(port_op.schedule, ref_op.schedule)
        y_ref = np.asarray(ref_op(x, interpret=True))
        y = port_op(x)
        np.testing.assert_allclose(y.numpy(), y_ref, rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(port_op.last_costs.numpy(),
                                      np.asarray(ref_op.last_costs))
        np.testing.assert_array_equal(
            port_op.last_costs.numpy().sum(axis=1),
            port_op.shards.worker_cost(
                port_op.schedule.tile_cost()).astype(np.float32))
        if round_ == 0:
            ref_s2 = ref_op.observe().refine()
            port_s2 = port_op.observe().refine()
            _assert_same_schedule(port_s2, ref_s2)
            from repro.sched.kernels import SpmvOp as RefSpmvOp
            ref_op = RefSpmvOp(ref_s2, indptr, indices, data)
            port_op = PS.SpmvOp(port_s2, indptr, indices, data,
                                device="cpu")
    # on the CPU the wrapper runs the plain version: no kernel launched
    assert K.LAUNCHES == {"ich_spmv": 0, "ich_spmv_sharded": 0}


@pytest.mark.parametrize("kind", ["uniform", "scale_free"])
def test_bfs_slice_end_to_end_matches_reference(kind):
    indptr, indices = bfs_graph(kind, N, seed=13)
    ref_op = RS.LoopScheduler(p=4).build("bfs", indptr, indices)
    port_op = PS.LoopScheduler(p=4, device="cpu").build("bfs", indptr,
                                                         indices)
    KB.reset_launches()
    levels = []
    for round_ in range(2):
        _assert_same_schedule(port_op.schedule, ref_op.schedule)
        level = port_op.levels(0)
        np.testing.assert_array_equal(level.numpy(),
                                      ref_op.levels(0, interpret=True))
        np.testing.assert_array_equal(port_op.last_costs.numpy(),
                                      np.asarray(ref_op.last_costs))
        levels.append(level)
        if round_ == 0:
            ref_op = RefBfsOp(ref_op.observe().refine(), indptr, indices)
            port_op = PS.BfsOp(port_op.observe().refine(), indptr, indices,
                               device="cpu")
    # the degree cost stream does not depend on the frontier: the refined
    # generation traverses identically
    assert port_op.schedule.generation == 1
    assert torch.equal(levels[0], levels[1])
    assert KB.LAUNCHES == {"ich_bfs_step": 0, "ich_bfs_step_sharded": 0}


def test_kmeans_slice_end_to_end_matches_reference():
    rounds, _ = kmeans_rounds(N, rounds=2, seed=3)
    rng = np.random.default_rng(4)
    pts = rng.standard_normal((N, 5)).astype(np.float32)
    cent = rng.standard_normal((4, 5)).astype(np.float32)
    ref_op = RS.LoopScheduler(p=4).build("kmeans", rounds[0])
    port_op = PS.LoopScheduler(p=4, device="cpu").build("kmeans", rounds[0])
    KK.reset_launches()
    for round_ in range(2):
        # refined costs come from each package's float32 cost stream, whose
        # sums differ in their last bits: the tiles and shards still agree
        _assert_same_schedule(port_op.schedule, ref_op.schedule,
                              cost_rtol=1e-6)
        ids = port_op(pts, cent)
        np.testing.assert_array_equal(
            ids.numpy(), np.asarray(ref_op(pts, cent, interpret=True)))
        np.testing.assert_allclose(port_op.last_costs.numpy(),
                                   np.asarray(ref_op.last_costs), rtol=1e-6)
        np.testing.assert_allclose(
            port_op.last_costs.numpy().sum(axis=1),
            port_op.shards.worker_cost(port_op.schedule.tile_cost()),
            rtol=1e-6)
        if round_ == 0:
            ref_op = RefKMeansOp(ref_op.observe().refine(), rounds[0])
            port_op = PS.KMeansOp(port_op.observe().refine(), rounds[0],
                                  device="cpu")
    assert port_op.schedule.generation == 1
    assert KK.LAUNCHES == {"ich_kmeans_assign": 0,
                           "ich_kmeans_assign_sharded": 0}


def test_schedule_cache_and_observe_levels():
    indptr, indices, data = random_csr(N, seed=5)
    scheduler = PS.LoopScheduler(p=2, device="cpu")
    s = scheduler.schedule(PS.NnzCosts(indptr))
    assert scheduler.schedule(PS.NnzCosts(indptr)) is s
    assert scheduler.cache_stats.hits == 1
    ref = RS.LoopScheduler(p=2).schedule(RS.NnzCosts(indptr))
    tiles_measured = s.tile_cost() * 1.5
    s2 = s.observe(tiles_measured, level="tile").refine()
    r2 = ref.observe(tiles_measured, level="tile").refine()
    _assert_same_schedule(s2, r2)
    items_measured = np.arange(N, dtype=np.float64)
    s3 = s2.observe(items_measured, level="item").refine()
    r3 = r2.observe(items_measured, level="item").refine()
    _assert_same_schedule(s3, r3)
    with pytest.raises(ValueError, match="does not match"):
        s.observe(np.zeros((3, 3)))


def test_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    indptr, indices, data = random_csr(40, seed=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PS.LoopScheduler(p=2)
    s = PS.LoopScheduler(p=2, device="cpu").schedule(np.diff(indptr))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PS.SpmvOp(s, indptr, indices, data)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PS.LoopScheduler(p=2, device="cuda")
    assert PS.SpmvOp(s, indptr, indices, data, device="cpu")(
        np.ones(40, np.float32)).device.type == "cpu"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PS.BfsOp(s, indptr, indices)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PS.KMeansOp(s, np.diff(indptr))
    assert PS.BfsOp(s, indptr, indices, device="cpu").levels(0).device.type \
        == "cpu"
    # the Zamba2 serving path: init_params and Engine
    from repro_torch.configs import get_arch, reduced
    from repro_torch.models.model import init_params
    from repro_torch.serve import Engine, EngineConfig
    cfg = reduced(get_arch("zamba2-1.2b"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_params(cfg, 0)
    model = init_params(cfg, 0, device="cpu")
    assert {p.device.type for p in model.parameters()} == {"cpu"}
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Engine(cfg, model, EngineConfig(max_seq=32))
    ids, _ = Engine(cfg, model, EngineConfig(max_seq=32),
                    device="cpu").generate(np.ones((1, 6), np.int32),
                                           n_new=2)
    assert ids.shape == (1, 2)


def test_importing_the_port_loads_no_jax_and_no_reference():
    code = ("import sys; import repro_torch, repro_torch.sched, "
            "repro_torch.convert, repro_torch.sched.kernels, "
            "repro_torch.kernels.ich_spmv.ref, "
            "repro_torch.kernels.ich_bfs.ich_bfs, "
            "repro_torch.kernels.ich_bfs.ref, "
            "repro_torch.kernels.ich_kmeans.ich_kmeans, "
            "repro_torch.kernels.ich_kmeans.ref, "
            "repro_torch.kernels.ich_moe.ich_moe, "
            "repro_torch.kernels.ich_moe.ref, repro_torch.sched.moe, "
            "repro_torch.core.workloads, repro_torch.configs, "
            "repro_torch.kernels.flash_attention.flash_attention, "
            "repro_torch.kernels.flash_attention.ref, "
            "repro_torch.kernels.mamba_scan.mamba_scan, "
            "repro_torch.kernels.mamba_scan.ref, repro_torch.models.model, "
            "repro_torch.serve, repro_torch.serve.engine, "
            "repro_torch.core, repro_torch.core.simulator, "
            "repro_torch.core.executor, repro_torch.robust, "
            "repro_torch.robust.faults, repro_torch.sched.api, "
            "repro_torch.core.tiling_torch, repro_torch.kernels.lpt.lpt, "
            "repro_torch.robust.recovery; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')); print(bad); "
            "sys.exit(1 if bad else 0)")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_port_file_imports_jax_or_the_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    for f in files:
        bad = {r for r in _imported_roots(f)
               if r in ("jax", "jaxlib", "repro")}
        assert not bad, f"{f.relative_to(ROOT)} imports {sorted(bad)}"


def test_host_modules_import_no_torch():
    # the numpy host side is copied as numpy: the simulator, executor,
    # fault injection and construction import no torch, as in the reference
    core = ROOT / "src" / "repro_torch" / "core"
    files = [core / f"{m}.py" for m in ("simulator", "executor", "policies",
                                         "welford", "workloads", "tiling")]
    files.append(ROOT / "src" / "repro_torch" / "robust" / "faults.py")
    for f in files:
        assert "torch" not in set(_imported_roots(f)), f.name


def test_library_name_covers_shared_headers(tmp_path, monkeypatch):
    # an edited shared header must give a new library, so a stale build of
    # a source that includes it is never loaded
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    (tmp_path / "k.cu").write_text('#include "shared.cuh"\n')
    (tmp_path / "shared.cuh").write_text("// version 1\n")
    first = _build.library_path("k")
    assert _build.library_path("k") == first
    (tmp_path / "shared.cuh").write_text("// version 2\n")
    second = _build.library_path("k")
    assert second != first and second.name.startswith("k-")
    (tmp_path / "other.cuh").write_text("// another header\n")
    assert _build.library_path("k") not in (first, second)
    # the real sources each name their own library
    monkeypatch.undo()
    names = ("ich_spmv", "ich_bfs", "ich_kmeans", "ich_moe",
             "flash_attention", "mamba_scan", "lpt")
    paths = {_build.library_path(n) for n in names}
    assert len(paths) == len(names)
    assert sorted(names) == sorted(p.stem for p in _build.CSRC.glob("*.cu"))
