"""The port's train step over a torch.distributed mesh (gloo ranks spawned
on the CPU: `tests/_mesh_ranks.py`) against the JAX reference's meshed
train step: `make_train_step(cfg, tcfg, DistContext(mesh))` under
`jax.jit` on four host devices, run in a process of its own
(`tests/_mesh_reference.py`, the XLA flag set before JAX starts), on the
meshes (2, 2), (1, 2) and (2, 1) ("data", "model"). The case: reduced
olmoe-1b-7b with 8 experts top-2, 2 layers, float32, 2 steps of 4 x 48
tokens (a fifth of the labels masked) from the reference's
`init_train_state` with capacity scales drawn in [0.3, 2]. Capacity is
per local token pool, so each mesh is held to the reference under the
same mesh, never to the unmeshed step.

Bars: the first batch's loss within 1e-5 relative, its every gradient
leaf within 1e-4 of the leaf's largest reference value (float32, other
summation orders: the ranks' partial sums); after each step the loss and
grad norm within 1e-5 and 1e-4 relative, dropped, stolen, entries and
n_tokens exactly, every new parameter within 1e-4 of the leaf's largest
value, and the new capacity scales exactly. Also at (2, 2): microbatch 2
with int8 gradient compression (blocks cut from whole reference leaves),
the same bars on loss, parameters and scales; and the compression alone
gives the bits of the whole trees' compression, gathering only leaves
whose shards straddle its blocks. At (1, 2) the data is not
split, so the meshed port equals the unmeshed port: with bfloat16
parameters and their float32 master, loss within 1e-5, master within
1e-4, scales exactly. The dense family (reduced qwen2-1.5b) at (2, 1)
equals the single-process port's step on the whole batch: loss within
1e-5, every new parameter within 1e-4. On one rank (`make_smoke_mesh`'s
1 x 1 mesh) the meshed step reduces in the unmeshed step's order: two
steps give its bits, every metric and state leaf. A mesh or batch the
config cannot split raises."""
import os
import pathlib
import pickle
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from _mesh_ranks import start
from repro.configs import get_arch as ref_get_arch
from repro.configs import reduced as ref_reduced
from repro.train import train_step as RTS
from repro_torch.configs import get_arch, reduced
from repro_torch.convert import _by_name, train_state_from_reference
from repro_torch.models import model as M
from repro_torch.train import train_step as TS

ARCH = "olmoe-1b-7b"
OVER = dict(n_experts=8, experts_per_token=2)
DENSE = "qwen2-1.5b"
B, S = 4, 48
OPTIONS = {"microbatch": 2, "grad_compress": True}
# at (2, 2) a shard of wo is runs of D / 2 elements, and one of wk or wv
# (KV heads over "model") runs of Hkv dh / 2: 32 straddle the int8 blocks
# of 256 (the leaf is gathered), 256 do not (nothing is)
COMPRESS_CASES = {"straddling": OVER,
                  "aligned": dict(OVER, d_model=512, n_kv_heads=4)}
# the reference's jobs, in two processes that run at once
REF_JOBS = [[((2, 2), {}, True), ((2, 2), OPTIONS, False)],
            [((1, 2), {}, True), ((2, 1), {}, True)]]
HERE = pathlib.Path(__file__).resolve().parent


def _batch(vocab, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (B, S)).astype(np.int32)
    labels = rng.integers(0, vocab, (B, S)).astype(np.int32)
    labels[rng.random((B, S)) < 0.2] = -1
    return {"tokens": toks, "labels": labels}


def _state():
    cfg = ref_reduced(ref_get_arch(ARCH), **OVER)
    state = jax.tree.map(np.asarray, RTS.init_train_state(
        cfg, jax.random.PRNGKey(0), 64, RTS.TrainConfig()))
    state["cap_scales"] = np.random.default_rng(5).uniform(
        0.3, 2.0, state["cap_scales"].shape).astype(np.float32)
    return state


class _Reference:
    """The reference's meshed steps, computing in the background."""

    def __init__(self, tmp, state, batches):
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   XLA_FLAGS="--xla_force_host_platform_device_count=4",
                   PYTHONPATH=os.pathsep.join(
                       [str(HERE.parent / "src"),
                        os.environ.get("PYTHONPATH", "")]))
        self.procs = []
        for i, jobs in enumerate(REF_JOBS):
            src, dst = tmp / f"ref-in-{i}.pkl", tmp / f"ref-out-{i}.pkl"
            with open(src, "wb") as f:
                pickle.dump({"arch": ARCH, "over": OVER, "state": state,
                             "batches": batches, "jobs": jobs}, f)
            self.procs.append((subprocess.Popen(
                [sys.executable, str(HERE / "_mesh_reference.py"),
                 str(src), str(dst)], env=env, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True), dst, jobs))
        self.results = None

    def get(self, shape, options):
        if self.results is None:
            self.results = {}
            for proc, dst, jobs in self.procs:
                out, _ = proc.communicate(timeout=600)
                assert proc.returncode == 0, out[-4000:]
                with open(dst, "rb") as f:
                    for (sh, opt, _), res in zip(jobs, pickle.load(f)):
                        self.results[sh, tuple(sorted(opt))] = res
        return self.results[shape, tuple(sorted(options))]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_train")
    state = _state()
    batches = [_batch(ref_reduced(ref_get_arch(ARCH), **OVER).vocab_size,
                      10 + i) for i in range(2)]
    ref = _Reference(tmp, state, batches)
    common = dict(arch=ARCH, over=OVER, state=state, batches=batches)
    dense_batch = _batch(reduced(get_arch(DENSE)).vocab_size, 20)
    port = {
        (1, 1): start(tmp, (1, 1), [("one_rank", dict(
            arch=ARCH, over=OVER, batches=batches, seed=4,
            caps=state["cap_scales"]))]),
        (2, 2): start(tmp, (2, 2), [
            ("step", dict(common, options={})),
            ("step", dict(common, options=OPTIONS, with_grads=False)),
            ("compress", dict(arch=ARCH, cases=COMPRESS_CASES, seed=6))]),
        (1, 2): start(tmp, (1, 2), [
            ("step", dict(common, options={})),
            ("step", dict(common, options={"bf16_params": True},
                          with_grads=False))]),
        (2, 1): start(tmp, (2, 1), [
            ("step", dict(common, options={})),
            ("dense", dict(arch=DENSE, over={}, batch=dense_batch,
                           seed=3))]),
    }
    done = {}

    def get(shape):
        if shape not in done:
            done[shape] = port[shape].result()
        return done[shape]
    return {"port": get, "ref": ref, "state": state, "batches": batches,
            "dense_batch": dense_batch}


def _close(a, b, what, tol=1e-4):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    scale = np.abs(b).max()
    err = np.abs(a - b).max() / scale if scale else np.abs(a).max()
    assert err <= tol, (what, err)


def _hold_steps(got, ref, params=True):
    for i, (g, r) in enumerate(zip(got["steps"], ref["steps"])):
        gm, rm = g["metrics"], r["metrics"]
        np.testing.assert_allclose(float(gm["loss"]), float(rm["loss"]),
                                   rtol=1e-5, err_msg=f"loss step {i}")
        np.testing.assert_allclose(float(gm["grad_norm"]),
                                   float(rm["grad_norm"]), rtol=1e-4,
                                   err_msg=f"grad_norm step {i}")
        for key in ("dropped", "stolen", "entries", "n_tokens"):
            assert float(gm[key]) == float(rm[key]), (key, i)
        np.testing.assert_array_equal(g["cap_scales"], r["cap_scales"])
        if params:
            ref_params = _by_name(r["params"])
            assert set(g["params"]) == set(ref_params)
            for n, p in g["params"].items():
                _close(p, ref_params[n], f"{n} step {i}")


@pytest.mark.parametrize("shape", [(2, 2), (1, 2), (2, 1)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_meshed_step_matches_the_reference_meshed_step(runs, shape):
    got = runs["port"](shape)[0]
    ref = runs["ref"].get(shape, {})
    np.testing.assert_allclose(float(got["grad_metrics"]["loss"]),
                               float(ref["grad_metrics"]["loss"]),
                               rtol=1e-5)
    ref_grads = _by_name(ref["grads"])
    assert set(got["grads"]) == set(ref_grads)
    for n, g in got["grads"].items():
        _close(g, ref_grads[n], n)
    _hold_steps(got, ref)
    moved = [not np.array_equal(s["cap_scales"], runs["state"]["cap_scales"])
             for s in got["steps"]]
    assert all(moved)
    assert any(float(s["metrics"]["dropped"]) > 0 for s in got["steps"])


def test_microbatch_and_compression_on_the_mesh(runs):
    got = runs["port"]((2, 2))[1]
    _hold_steps(got, runs["ref"].get((2, 2), OPTIONS))


@pytest.mark.parametrize("case", list(COMPRESS_CASES))
def test_compression_on_the_mesh_cuts_the_whole_leaves_blocks(runs, case):
    """`compress_grads` at (2, 2) gives the bits of the whole trees'
    compression, and gathers a leaf only where a shard straddles blocks."""
    got = runs["port"]((2, 2))[2][case]
    assert got["differ"] == []
    assert (got["gathers"] > 0) == (case == "straddling"), got["gathers"]


def test_bf16_params_on_a_model_only_mesh_equal_one_device(runs):
    """At (1, 2) nothing of the batch is split: the meshed step equals the
    port's unmeshed step."""
    got = runs["port"]((1, 2))[1]
    cfg = reduced(get_arch(ARCH), **OVER)
    tcfg = TS.TrainConfig(dtype=torch.float32, bf16_params=True)
    state = train_state_from_reference(cfg, runs["state"], device="cpu")
    state["opt"]["master"] = {n: p.detach().clone() for n, p in
                              state["params"].named_parameters()}
    TS.cast_bf16(state["params"])
    step = TS.make_train_step(cfg, tcfg)
    for i, batch in enumerate(runs["batches"]):
        state, m = step(state, {k: torch.from_numpy(v)
                                for k, v in batch.items()})
        g = got["steps"][i]
        np.testing.assert_allclose(float(g["metrics"]["loss"]),
                                   float(m["loss"]), rtol=1e-5)
        np.testing.assert_array_equal(g["cap_scales"],
                                      state["cap_scales"].numpy())
        for n, p in state["opt"]["master"].items():
            _close(g["master"][n], p.numpy(), f"{n} step {i}")


def test_dense_data_parallel_step_equals_one_process(runs):
    got = runs["port"]((2, 1))[1]
    cfg = reduced(get_arch(DENSE))
    tcfg = TS.TrainConfig(dtype=torch.float32)
    state = TS.init_train_state(cfg, 3, tcfg=tcfg, device="cpu")
    state, m = TS.make_train_step(cfg, tcfg)(
        state, {k: torch.from_numpy(v)
                for k, v in runs["dense_batch"].items()})
    np.testing.assert_allclose(got["loss"], float(m["loss"]), rtol=1e-5)
    for n, p in state["params"].named_parameters():
        _close(got["params"][n], p.detach().numpy(), n)


def test_one_rank_mesh_gives_the_unmeshed_bits(runs):
    assert runs["port"]((1, 1))[0] == []


class _Dist:
    """A mesh's sizes without a process group."""
    tp_axis, fsdp_axis, batch_axes = "model", "data", ("data",)

    def __init__(self, dp, tp):
        self.dp, self.tp = dp, tp

    def sizes(self):
        return {"tp": self.tp, "fsdp": self.dp}

    def index(self, axes):
        return 0


@pytest.mark.parametrize("dp, tp, what", [
    (1, 3, "experts do not split"), (3, 1, "d_model"),
    (8, 1, "does not split into")], ids=["experts", "d_model", "batch"])
def test_a_mesh_the_config_cannot_split_raises(dp, tp, what):
    cfg = reduced(get_arch(ARCH), **OVER)
    with pytest.raises(ValueError, match=what):
        M.check_trainable(cfg, _Dist(dp, tp))
        TS.batch_shard({"tokens": torch.zeros((B, S))}, _Dist(dp, tp))
