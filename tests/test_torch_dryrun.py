"""The port's dry run (`launch/dryrun.py`), each cell in a process of its
own (it starts a fake process group, which must not outlive it in a test
worker): olmo-1b x decode_32k on the 32 x 8 production mesh exits 0 with
OK, operations, temporaries and collectives on both mesh axes, and its
argument bytes are exactly the rank's parameters, tokens, cache and
position as the placements cut them (`param_pspecs`, `cache_pspecs`);
olmoe-1b-7b x train_4k on a (1, 4) fake mesh holds in its arguments the
parameters and both AdamW moments of its placements (float32, 12 bytes a
local element), takes the capacity-full MoE plan and counts the kernels'
own operations; an ssm cell (xlstm-350m x decode_32k) runs OK on the
production mesh with its arguments exactly the rank's parameters,
tokens, recurrent states (`cache_pspecs`: the mLSTM's and sLSTM's heads
whole at tp 8, which 4 heads do not divide) and position. On a (1, 4) fake
mesh a train step of zamba2-1.2b cut to its first 6 blocks and of
xlstm-350m cut to 4 counts the SSD scan's shape-only ops at each rank's
H/4 heads (the kernels' own formulas) and the sLSTM loop as one op of S
steps. A step on real tensors never takes the capacity-full plan. A
rank runs the reference's microbatch count unless it exceeds the rank's
rows (then one row a microbatch)."""
import json
import math
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from repro_torch.configs import SHAPES, get_arch, reduced
from repro_torch.models import model as M
from repro_torch.models import moe as MOE

ROOT = pathlib.Path(__file__).resolve().parents[1]
MOE_SCRIPT = """
import json, sys
from repro_torch.configs import get_arch, SHAPES
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import fake_mesh
rec = dryrun.trace_step(get_arch("olmoe-1b-7b"), SHAPES["train_4k"],
                        fake_mesh((1, 4), ("data", "model")))
print(json.dumps(rec))
"""


REC_SCRIPT = """
import dataclasses, json
from repro_torch.configs import get_arch
from repro_torch.configs.base import ShapeSpec
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import fake_mesh
from repro_torch.train.train_step import TrainConfig
shape = ShapeSpec("train_small", 512, 4, "train")
out = {}
for name, n in (("zamba2-1.2b", 6), ("xlstm-350m", 4)):
    cfg = get_arch(name)
    cfg = dataclasses.replace(cfg, n_layers=n,
                              block_pattern=cfg.block_pattern[:n])
    out[name] = dryrun.trace_step(cfg, shape, fake_mesh((1, 4), (
        "data", "model")), tcfg=TrainConfig())
print(json.dumps(out))
"""


def _env():
    return dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dryrun")
    procs = {}
    for arch, shape in (("olmo-1b", "decode_32k"),
                        ("xlstm-350m", "decode_32k")):
        procs[arch] = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape, "--out", str(tmp)], env=_env(),
            cwd=str(ROOT), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)
    for key, script in (("moe", MOE_SCRIPT), ("recurrent", REC_SCRIPT)):
        procs[key] = subprocess.Popen(
            [sys.executable, "-c", script], env=_env(), cwd=str(ROOT),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    out = {}
    for key, p in procs.items():
        stdout, stderr = p.communicate(timeout=300)
        out[key] = (p.returncode, stdout, stderr)
    out["dir"] = tmp
    return out


def test_olmo_decode_cell_runs_on_the_production_mesh(cells):
    rc, stdout, stderr = cells["olmo-1b"]
    assert rc == 0, stderr[-3000:]
    assert "1 OK" in stdout
    rec = json.loads((cells["dir"] / "olmo-1b_decode_32k_32x8.json")
                     .read_text())
    assert rec["status"] == "OK" and rec["mesh"] == "32x8"
    assert rec["memory"]["temp_bytes"] > 0
    assert rec["cost"]["flops"] > 0
    assert rec["collective_wire_bytes"] > 0
    assert {"data", "model"} <= set(rec["collectives_by_axis"])
    assert "v5e" not in json.dumps(rec) and "TPU" not in json.dumps(rec)
    # the arguments: the rank's parameters, tokens, cache and position
    cfg, shape = get_arch("olmo-1b"), SHAPES["decode_32k"]
    split = {"data": 32, "model": 8, None: 1}
    params = sum(4 * math.prod(d // split[a] for d, a in zip(s, axes))
                 for s, axes in M.param_leaves(cfg, 8).values())
    B = shape.global_batch // 32
    cache_axes = M.cache_pspecs(cfg, shape.global_batch,
                                {"data": 32, "model": 8})
    cache = 0
    for seg, specs in zip(cache_axes, M.cache_specs(cfg, shape.global_batch,
                                                    shape.seq_len)):
        for kv in ("k", "v"):
            dims, _ = specs[kv]
            cache += 2 * math.prod(d // split[a] for d, a in
                                   zip(dims, seg[kv]))
    assert rec["memory"]["argument_bytes"] == params + 4 * B + cache + 4


def test_olmoe_train_cell_on_a_1x4_mesh_holds_its_placed_state(cells):
    rc, stdout, stderr = cells["moe"]
    assert rc == 0, stderr[-3000:]
    rec = json.loads(stdout.strip().splitlines()[-1])
    cfg, shape = get_arch("olmoe-1b-7b"), SHAPES["train_4k"]
    split = {"data": 1, "model": 4, None: 1}
    local = sum(math.prod(d // split[a] for d, a in zip(s, axes))
                for s, axes in M.param_leaves(cfg, 4).values())
    tokens = 2 * 4 * shape.global_batch * shape.seq_len
    caps = 4 * M.n_moe_layers(cfg) * cfg.n_experts
    assert rec["memory"]["argument_bytes"] == 12 * local + tokens + caps + 4
    assert 18e9 < 12 * local < 25.05e9     # the experts and, now, attention
    assert rec["moe_plan"] == "capacity-full"
    kernels = rec["kernel_flops"]
    assert {"repro_torch.moe_fwd", "repro_torch.moe_bwd",
            "repro_torch.flash_fwd", "repro_torch.flash_bwd"} <= set(kernels)
    assert rec["memory"]["temp_bytes"] > 0
    by_axis = rec["collectives_by_axis"]
    assert by_axis["model"]["wire_bytes"] > 0
    # one data rank: its groups move nothing
    assert by_axis.get("data", {}).get("wire_bytes", 0.0) == 0.0


def test_an_ssm_cell_is_not_ported(cells):
    # the name predates the ssm layouts: the cell now runs, and its
    # arguments are the rank's shards
    rc, stdout, stderr = cells["xlstm-350m"]
    assert rc == 0, stderr[-3000:]
    rec = json.loads((cells["dir"] / "xlstm-350m_decode_32k_32x8.json")
                     .read_text())
    assert rec["status"] == "OK" and rec["mesh"] == "32x8", rec
    cfg, shape = get_arch("xlstm-350m"), SHAPES["decode_32k"]
    split = {"data": 32, "model": 8, None: 1}
    params = sum(4 * math.prod(d // split[a] for d, a in zip(s, axes))
                 for s, axes in M.param_leaves(cfg, 8).values())
    B = shape.global_batch // 32
    cache = 0
    axes = M.cache_pspecs(cfg, shape.global_batch, {"data": 32, "model": 8})
    for spec, ax in zip(M.cache_specs(cfg, shape.global_batch,
                                      shape.seq_len), axes):
        leaves = [(spec, ax)] if isinstance(spec, tuple) else \
            [(spec[k], ax[k]) for k in spec]
        for (dims, dt), a in leaves:
            assert "model" not in a      # 4 heads do not divide 8 ranks
            cache += torch.empty((), dtype=dt).element_size() * math.prod(
                d // split[x] for d, x in zip(dims, a))
    assert rec["memory"]["argument_bytes"] == params + 4 * B + cache + 4
    assert rec["slstm_loop"].startswith("one shape-only op")


def test_recurrent_train_steps_count_their_kernels_at_the_ranks_heads(
        cells):
    from repro_torch.kernels.shape_only import (scan_backward_flops,
                                                scan_forward_flops)
    rc, stdout, stderr = cells["recurrent"]
    assert rc == 0, stderr[-3000:]
    recs = json.loads(stdout.strip().splitlines()[-1])
    B, S = 4, 512
    zamba = recs["zamba2-1.2b"]
    cfg = get_arch("zamba2-1.2b")
    H = cfg.mamba_expand * cfg.d_model // cfg.ssm_head_dim // 4
    args = (B, S, H, cfg.ssm_state, cfg.ssm_head_dim, cfg.ssm_chunk, True)
    k = zamba["kernel_flops"]
    # 5 "M" blocks, forward twice under remat, backward once
    assert k["repro_torch.scan_fwd"] == 2 * 5 * scan_forward_flops(*args)
    assert k["repro_torch.scan_bwd"] == 5 * scan_backward_flops(*args)
    assert {"repro_torch.flash_fwd", "repro_torch.flash_bwd"} <= set(k)
    assert zamba["collectives_by_axis"]["model"]["wire_bytes"] > 0
    xl = recs["xlstm-350m"]
    cfg = get_arch("xlstm-350m")
    dh = cfg.d_model // cfg.n_heads
    k = xl["kernel_flops"]
    assert k["repro_torch.slstm_fwd"] == 2 * 2 * S * B * cfg.n_heads * dh ** 2
    assert k["repro_torch.slstm_bwd"] == 4 * S * B * cfg.n_heads * dh ** 2
    d_mlstm = cfg.mamba_expand * cfg.d_model // cfg.n_heads
    assert k["repro_torch.scan_fwd"] == 2 * 3 * scan_forward_flops(
        B, S, 1, d_mlstm, d_mlstm + 1, min(cfg.ssm_chunk, S), False)
    assert "slstm_loop" in xl and "microbatch" in xl


def test_a_real_step_never_takes_the_capacity_full_plan(monkeypatch):
    cfg = reduced(get_arch("olmoe-1b-7b"), n_experts=8, experts_per_token=2)
    taken = []
    monkeypatch.setattr(MOE, "capacity_full_slots",
                        lambda *a, **k: taken.append(1) or 0)
    p = MOE.MoE(cfg, torch.Generator().manual_seed(0), "cpu")
    p.requires_grad_(True)
    x = torch.randn(2, 16, cfg.d_model, requires_grad=True)
    y, aux = MOE.apply_moe(cfg, p, x, torch.ones(cfg.n_experts))
    y.sum().backward()
    assert not taken and torch.isfinite(y).all()
    assert float(aux["entries"]) == 2 * 16 * 2


@pytest.mark.parametrize("arch, dp, train_opt, want", [
    ("zamba2-1.2b", 32, False, 8), ("xlstm-350m", 32, False, 8),
    ("phi3-medium-14b", 32, True, 8), ("phi3-medium-14b", 32, False, 8),
    ("glm4-9b", 32, False, 4), ("xlstm-350m", 1, False, 16),
    ("deepseek-moe-16b", 32, True, 4)])
def test_a_rank_departs_from_the_reference_microbatches_only_past_its_rows(
        arch, dp, train_opt, want):
    # 256 rows over dp batch ranks: the reference's count stands unless it
    # exceeds the rank's rows (then one row a microbatch, caveat 15)
    import types
    from repro_torch.launch import dryrun
    cfg, shape = get_arch(arch), SHAPES["train_4k"]
    dist = types.SimpleNamespace(dp=dp)
    assert dryrun.rank_microbatch(cfg, shape, dist, train_opt) == want
    ref = dryrun.reference_microbatch(cfg, train_opt)
    assert ref == cfg.train_microbatch * (2 if train_opt else 1)
    assert (want < ref) == (ref > shape.global_batch // dp)
    assert dryrun.rank_microbatch(cfg, shape, dist, train_opt, 2) == 2
