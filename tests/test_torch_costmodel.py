"""The port's analytic cost model, collective statistics and roofline
against the reference's (`repro/launch/{costmodel,hlo_stats,roofline}.py`):
`cell_cost`'s flops, hbm_bytes, wire_bytes and useful_flops equal the
reference's exactly for every arch x shape x mesh (1, 16, 16), (2, 16,
16), (1, 32, 8), (2, 32, 8), (1, 1, 4) x each lever; `wire_by_axis` sums
to wire_bytes; the reference's levers test (`tests/test_system.py`)
holds for the port's copy, and `port_knobs` moves the terms the same
way; the ring formulas give `hlo_stats`' numbers on the reference's
parser test; `roofline.analyze` reads a dry-run record with the H100's
constants."""
import dataclasses

import pytest

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import SHAPES as REF_SHAPES
from repro.launch import costmodel as RC
from repro.launch import hlo_stats
from repro_torch.configs import ARCHS, SHAPES, get_arch
from repro_torch.launch import collective_stats as CS
from repro_torch.launch import costmodel as C
from repro_torch.launch import mesh as MESH
from repro_torch.launch import roofline as R

MESHES = [(1, 16, 16), (2, 16, 16), (1, 32, 8), (2, 32, 8), (1, 1, 4)]
KNOBS = [{}, {"causal_skip": True}, {"remat_factor": 3.2},
         {"decode_fsdp": False}, {"bf16_gather": True}, {"ssm_kernel": True},
         {"causal_skip": True, "bf16_gather": True, "remat_factor": 4.0,
          "ssm_kernel": True}]


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(map(str, m)))
@pytest.mark.parametrize("name", sorted(ARCHS))
def test_cell_cost_equals_the_reference_exactly(name, mesh):
    for shape in SHAPES:
        for knobs in KNOBS:
            got = C.cell_cost(ARCHS[name], SHAPES[shape], C.MeshShape(*mesh),
                              **knobs)
            want = RC.cell_cost(REF_ARCHS[name], REF_SHAPES[shape],
                                RC.MeshShape(*mesh), **knobs)
            assert (got.flops, got.hbm_bytes, got.wire_bytes,
                    got.useful_flops) == (want.flops, want.hbm_bytes,
                                          want.wire_bytes,
                                          want.useful_flops), (shape, knobs)
            assert sum(got.wire_by_axis.values()) == got.wire_bytes
            assert all(v >= 0 for v in got.wire_by_axis.values())


def test_levers_move_the_terms_as_the_reference_s():
    """`tests/test_system.py`'s levers test, on the port's copy; and the
    port's own levers (`port_knobs`) cut a train cell's compute."""
    cfg, shape = get_arch("olmoe-1b-7b"), SHAPES["train_4k"]
    base = C.cell_cost(cfg, shape, C.MeshShape())
    assert all(v > 0 for v in base.terms().values())
    opt = C.cell_cost(dataclasses.replace(cfg, moe_cmax_factor=1.25), shape,
                      C.MeshShape(), bf16_gather=True, causal_skip=True)
    assert opt.flops < base.flops
    assert opt.wire_bytes < base.wire_bytes
    d = SHAPES["decode_32k"]
    db = C.cell_cost(get_arch("phi3-medium-14b"), d, C.MeshShape())
    do = C.cell_cost(get_arch("phi3-medium-14b"), d, C.MeshShape(),
                     decode_fsdp=False)
    assert do.wire_bytes < db.wire_bytes / 100
    mesh = C.MeshShape(dp=32, tp=8)
    port = C.cell_cost(cfg, shape, mesh, **C.port_knobs(shape))
    assert port.flops < C.cell_cost(cfg, shape, mesh).flops
    t = port.terms()
    by = port.wire_by_axis
    assert t["collective"] == by["data"] / MESH.IB_BW + \
        by["model"] / MESH.NVLINK_BW + by["pod"] / MESH.IB_BW
    assert t["compute"] == port.flops / 989e12
    assert t["memory"] == port.hbm_bytes / 3.35e12


def test_ring_formulas_give_hlo_stats_numbers():
    txt = """
  %ag = bf16[16,1024]{1,0} all-gather(%p0), replica_groups={{0,1,2,3}}, dimensions={0}
  %ar = f32[512]{0} all-reduce(%p1), replica_groups=[4,2]<=[8]
  %rs = f32[128]{0} reduce-scatter(%p2), replica_groups={{0,1}}, dimensions={0}
"""
    ref = hlo_stats.parse_collectives(txt)
    got = CS.summarize([
        {"kind": "all-gather", "result_bytes": 16 * 1024 * 2,
         "group_size": 4, "axis": "data"},
        {"kind": "all-reduce", "result_bytes": 512 * 4, "group_size": 2,
         "axis": "model"},
        {"kind": "reduce-scatter", "result_bytes": 128 * 4, "group_size": 2,
         "axis": "data"}])
    assert got.by_kind == {k: list(v) for k, v in ref.by_kind.items()}
    assert got.total_wire_bytes == ref.total_wire_bytes
    assert got.total_operand_bytes == ref.total_operand_bytes
    assert got.by_axis["model"] == ref.by_kind["all-reduce"]
    for kind in ("all-to-all", "collective-permute"):
        assert CS.ring_bytes(kind, 100.0, 4) == ((100.0, 75.0) if kind ==
                                                 "all-to-all"
                                                 else (100.0, 100.0))


def test_roofline_reads_a_record_with_the_h100_constants():
    rec = {"arch": "olmo-1b", "shape": "train_4k", "mesh": "32x8",
           "status": "OK", "cost": {"flops": 4.0e13},
           "memory": {"argument_bytes": 5e7, "temp_bytes": 1.2e10,
                      "output_bytes": 5e7, "alias_bytes": 5e7}}
    row = R.analyze(rec)
    cost = C.cell_cost(get_arch("olmo-1b"), SHAPES["train_4k"],
                       C.MeshShape(dp=32, tp=8))
    assert row["t_compute_s"] == cost.flops / 989e12
    assert row["fits_hbm"] and row["mem_per_dev_bytes"] == 5e7 + 1.2e10
    assert row["dominant"] in ("compute", "memory", "collective")
    assert 0 < row["mfu_bound"] <= 1
    opt = R.analyze(rec, **C.port_knobs(SHAPES["train_4k"]))
    assert opt["t_compute_s"] < row["t_compute_s"]
    assert not R.analyze(dict(rec, memory=dict(
        rec["memory"], temp_bytes=9e10)))["fits_hbm"]
    assert MESH.HBM_BYTES == 80e9
