"""Checkpoints and the trainer over a torch.distributed mesh (gloo ranks
spawned on the CPU: `tests/_mesh_ranks.py`), and the port's launchers.

* A checkpoint written at (2, 2) ("data", "model") after a step of
  reduced olmoe-1b-7b (8 experts top-2) holds whole leaves: loaded at
  (1, 2), and in one process, into a state drawn from another seed, it
  gives the saved bits, and each rank holds its shards of the experts
  (the reference's mesh-agnostic checkpoint: a restart may use another
  mesh).
* `train()` on a (2, 1) mesh with a failure after step 2 resumes from its
  checkpoint to the uninterrupted run's losses and final state bit for
  bit (gloo's sums and every kernel's plain version are deterministic).
* `python -m repro_torch.launch.train` and `launch.serve` at
  `--preset tiny --device cpu` print the reference's lines; without
  `--device` they run on the card and fail where there is none. (The
  tiny preset is `reduced()` with heads 64 wide, what the card's flash
  kernels take.)
* `chip_mesh.py --device cpu --tiny` (the four-card script's rehearsal:
  four gloo ranks, parity at (1, 4), data parallel at (2, 2), the depth
  run) passes its checks and prints its last line."""
import json
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from _mesh_ranks import start
from repro_torch.configs import get_arch, reduced
from repro_torch.models import moe as MOE
from repro_torch.train import checkpoint as CKPT
from repro_torch.train import train_step as TS

ARCH = "olmoe-1b-7b"
OVER = dict(n_experts=8, experts_per_token=2)
B, S = 4, 32
ROOT = pathlib.Path(__file__).resolve().parents[1]


def _batch(cfg):
    rng = np.random.default_rng(7)
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(
                np.int32),
            "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(
                np.int32)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_launch")
    cfg = reduced(get_arch(ARCH), **OVER)
    ckpt = str(tmp / "ckpt")
    common = dict(arch=ARCH, over=OVER)
    trainer = start(tmp, (2, 1), [("trainer", dict(
        common, ckpt_dir=str(tmp / "run"), steps=4, batch=B, seq=S))])
    saved = start(tmp, (2, 2), [("save", dict(
        common, batch=_batch(cfg), seed=1, ckpt_dir=ckpt))]).result()[0]
    loaded = start(tmp, (1, 2), [("load", dict(
        common, seed=2, ckpt_dir=ckpt))]).result()[0]
    return {"cfg": cfg, "ckpt": ckpt, "saved": saved, "loaded": loaded,
            "trainer": trainer}


def test_a_checkpoint_moves_between_meshes_with_the_same_bits(runs):
    cfg, saved, loaded = runs["cfg"], runs["saved"], runs["loaded"]
    assert CKPT.list_steps(runs["ckpt"]) == [1] and loaded["step"] == 1
    like = TS.init_train_state(cfg, 2, device="cpu",
                               tcfg=TS.TrainConfig(dtype=torch.float32))
    one, _ = CKPT.load_state(like, runs["ckpt"])
    one = {n: t.detach().numpy() for n, t in CKPT.state_leaves(one)}
    assert set(saved) == set(loaded["leaves"]) == set(one)
    moved = 0
    for n, a in saved.items():
        np.testing.assert_array_equal(loaded["leaves"][n], a, err_msg=n)
        np.testing.assert_array_equal(one[n], a, err_msg=n)
        moved += n.startswith("opt.m.") and bool(np.any(a))
    assert moved > 0      # the step wrote its moments
    E, D, F = cfg.n_experts, cfg.d_model, cfg.moe_d_ff
    shapes = loaded["shapes"]
    for prefix in ("params.", "opt.m.", "opt.v."):
        assert shapes[f"{prefix}layers.0.moe.wi"] == (E // 2, D, F)
        assert shapes[f"{prefix}layers.1.moe.wo"] == (E // 2, F, D)
        assert shapes[f"{prefix}layers.0.moe.router"] == (D, E)
    assert MOE.local_shape("opt.v.layers.1.moe.wg", (E, D, F),
                           {"tp": 2, "fsdp": 2}) == (E // 2, D // 2, F)


def test_trainer_on_a_mesh_resumes_bit_for_bit(runs):
    got = runs["trainer"].result()[0]
    assert got["failed"] and got["listed"] == [2]
    assert len(got["resumed"]) == 2 and len(got["fresh"]) == 4
    assert got["resumed"] == got["fresh"][2:]
    assert got["same_state"]
    assert all(np.isfinite(got["fresh"]))


def _launch(module, *args):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    return subprocess.run([sys.executable, "-m", module, *args],
                          capture_output=True, text=True, timeout=300,
                          env=env, cwd=str(ROOT))


@pytest.mark.parametrize("module, args, line", [
    ("repro_torch.launch.train",
     ["--arch", "olmoe-1b-7b", "--steps", "2", "--batch", "2",
      "--seq", "32"],
     r"^\[train\] olmoe-1b-7b: loss \d+\.\d{3} -> \d+\.\d{3}$"),
    ("repro_torch.launch.serve",
     ["--arch", "qwen2-1.5b", "--requests", "2", "--prompt-len", "24",
      "--new-tokens", "4"],
     r"^\[serve\] 2 reqs x 4 new tokens; chunks \[24\]; d=\S+$"),
], ids=["train", "serve"])
def test_launchers_print_their_lines(tmp_path, module, args, line):
    extra = ["--ckpt-dir", str(tmp_path)] if module.endswith("train") \
        else []
    r = _launch(module, *args, *extra, "--preset", "tiny", "--device",
                "cpu")
    assert r.returncode == 0, r.stderr[-3000:]
    assert re.match(line, r.stdout.strip().splitlines()[-1]), r.stdout
    if torch.cuda.is_available():
        return
    r = _launch(module, *args, *extra, "--preset", "tiny")
    assert r.returncode != 0 and "CUDA is not available" in r.stderr


def test_the_four_card_script_rehearses_on_gloo():
    r = subprocess.run([sys.executable, str(ROOT / "chip_mesh.py"),
                        "--device", "cpu", "--tiny"], capture_output=True,
                       text=True, timeout=300, cwd=str(ROOT))
    assert r.returncode == 0, r.stderr[-3000:]
    lines = [json.loads(l) for l in r.stdout.strip().splitlines()]
    phases = {d.get("phase"): d for d in lines}
    assert phases["mesh_parity"]["grad_worst_share"] <= 1e-4
    assert phases["mesh_data_parallel"]["replicated_leaves_differ"] == []
    assert len(phases["mesh_depth"]["per_rank"]) == 4
    assert lines[-1] == {"ok": True, "device": {
        "platform": "cpu", "kind": "cpu", "count": 4}}
