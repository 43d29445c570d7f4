"""Tensor parallelism of the dense layers over a torch.distributed mesh
(gloo ranks spawned on the CPU: `tests/_mesh_ranks.py`): the whole
layout of `models.model.param_pspecs` — FSDP over "data", attention
heads, MLP columns and rows and the vocabulary over "model" (a
vocab-parallel lookup and cross-entropy), the experts expert-parallel.

Cases, float32, 4 x 32 tokens (a fifth of the labels masked):
reduced qwen2-1.5b (4 heads, 2 KV heads: local KV heads at tp 2, whole
ones at tp 4) and reduced olmo-1b with 4 KV heads, at (1, 2), (2, 2) and
(1, 4) ("data", "model"), against the unmeshed port from the same seed:
the loss within 1e-5 relative, the prefill's last logits within 1e-5 of
their max, every gradient (whole leaves gathered) within 1e-4 of its
max; each rank holds its placement's shards. At (2, 2) the train step
(2 steps) against the reference's step jitted with the in_shardings of
its `train_state_pspecs` (GSPMD's tensor parallelism, on four host
devices: `tests/_mesh_reference.py`): the first batch's loss within
1e-5 and every gradient within 1e-4 of its max, then each step's loss
and every new parameter (within 1e-4 of its max, or within 1e-3 of the
steps' summed learning rates: AdamW normalises each element's gradient,
so an element whose gradients are rounding-sized — the key bias's, whose
exact gradient is nearly cancelled by the softmax's shift invariance —
carries their relative rounding into a step of about lr); the same for
reduced olmoe-1b-7b (8 experts
top-2), where tensor-parallel attention meets the expert-parallel block
(capacity scales drawn in [0.3, 2], the new scales exactly). Decode over
a cache split by sequence (qwen2 at (1, 4)) equals the unmeshed decode
within 1e-5 of the logits' max, and the meshed prefill writes its slice
of the cache within 1e-5 of the cache's max (its keys come from products
of other shapes). A checkpoint saved at (2, 2) loads into one
process with the same bits. `attention.kv_for` maps a slice of query
heads that straddles a KV group onto the KV heads it reads.

The recurrent and encoder-decoder families (`models.ssm`, whisper),
float32, 4 x 32 tokens: reduced zamba2-1.2b with heads of 16 (8 Mamba2
heads; 4 query and 2 KV heads) over ("M", "A", "M", "A"), the shared
attention block used twice (window 24); reduced xlstm-350m over ("X",
"S"); reduced whisper-small (16 frames, GQA 2 of 4), at (1, 2), (2, 2)
and (1, 4), and xlstm with 2 heads at (1, 4), where every mLSTM and sLSTM
leaf is whole on "model" while the vocabulary splits (a second sum of
their gradients over "model" would show). Against the unmeshed port from
the same seed: the loss within 1e-5 relative, every gradient within 1e-4
of its max, the prefill's last logits, its cache against the unmeshed
cache cut to the rank (`cache_pspecs`) and one decode step over that cut
cache padded by 4 positions (Zamba2's ring and whisper's self-attention
split by sequence where the KV heads do not divide) within 1e-4; each
rank holds its placement's shards. At (2, 2) each family's train step
against the reference's in-sharded step, the bars above; and a Zamba2
checkpoint saved at (2, 2) loads into one process with the same bits.
Zamba2 at (1, 4) decodes 6 steps past the end of its ring of 24 slots
(the cache split by sequence, each step written at pos % 24 on the rank
that holds the slot) within 1e-4 of the unmeshed decode.
The ranks run in the pools the dense cases use, and the reference's
steps in their two processes."""
import os
import pathlib
import pickle
import subprocess
import sys
import types

import jax
import numpy as np
import pytest
import torch

from _mesh_ranks import pad_cache, start
from repro.configs import get_arch as ref_get_arch
from repro.configs import reduced as ref_reduced
from repro.train import train_step as RTS
from repro_torch.configs import get_arch, reduced
from repro_torch.convert import _by_name
from repro_torch.models import attention as A
from repro_torch.models import model as M
from repro_torch.train import checkpoint as CKPT
from repro_torch.train import train_step as TS

B, S = 4, 32
CASES = {"qwen2": ("qwen2-1.5b", {}), "olmo": ("olmo-1b", {"n_kv_heads": 4})}
MESHES = [(1, 2), (2, 2), (1, 4)]
# (arch, overrides, the position table's rows) of the recurrent and
# encoder-decoder families
FAMILIES = {
    "zamba2": ("zamba2-1.2b", dict(ssm_head_dim=16, block_pattern=(
        "M", "A", "M", "A"), n_layers=4, ssm_chunk=16, attn_window=24), 0),
    "xlstm": ("xlstm-350m", dict(block_pattern=("X", "S"), ssm_chunk=16), 0),
    "whisper": ("whisper-small", {}, 48)}
# the partly replicated case: 2 heads at tp 4
XLSTM2 = ("xlstm-350m", dict(block_pattern=("X", "S"), ssm_chunk=16,
                             n_heads=2), 0)
FAMILY_CASES = [(k, sh) for k in FAMILIES for sh in MESHES] + \
    [("xlstm2", (1, 4))]
PAD = 4
# Zamba2's decode steps past its ring of 24 slots (from position S = 32:
# slots 8..13, on model ranks 1 and 2 at tp 4)
RING_STEPS = 6
MOE = ("olmoe-1b-7b", dict(n_experts=8, experts_per_token=2))
HERE = pathlib.Path(__file__).resolve().parent


def _batch(vocab, seed, frames=None):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (B, S)).astype(np.int32)
    labels = rng.integers(0, vocab, (B, S)).astype(np.int32)
    labels[rng.random((B, S)) < 0.2] = -1
    out = {"tokens": toks, "labels": labels}
    if frames:      # whisper's (encoder_seq, d_model) frame embeddings
        out["frames"] = rng.standard_normal((B, *frames)).astype(np.float32)
    return out


def _family(key):
    return XLSTM2 if key == "xlstm2" else FAMILIES[key]


def _family_batch(key, seed):
    arch, over, _ = _family(key)
    cfg = reduced(get_arch(arch), **over)
    return _batch(cfg.vocab_size, seed, (cfg.encoder_seq, cfg.d_model)
                  if cfg.family == "encdec" else None)


def _ref_state(arch, over, caps: bool):
    cfg = ref_reduced(ref_get_arch(arch), **over)
    state = jax.tree.map(np.asarray, RTS.init_train_state(
        cfg, jax.random.PRNGKey(0), 64, RTS.TrainConfig()))
    if caps:
        state["cap_scales"] = np.random.default_rng(5).uniform(
            0.3, 2.0, state["cap_scales"].shape).astype(np.float32)
    return state


class _Reference:
    """The reference's in-sharded steps at (2, 2), computing in the
    background: `procs` {process: [case keys]}, each process running its
    cases in turn."""

    def __init__(self, tmp, jobs, procs):
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   XLA_FLAGS="--xla_force_host_platform_device_count=4",
                   PYTHONPATH=os.pathsep.join(
                       [str(HERE.parent / "src"),
                        os.environ.get("PYTHONPATH", "")]))
        self.procs, self.where = {}, {}
        for name, keys in procs.items():
            src, dst = tmp / f"ref-in-{name}.pkl", tmp / f"ref-out-{name}.pkl"
            with open(src, "wb") as f:
                pickle.dump({"cases": [dict(jobs[k], jobs=[(
                    (2, 2), {"in_sharded": True}, True)]) for k in keys]}, f)
            self.procs[name] = (subprocess.Popen(
                [sys.executable, str(HERE / "_mesh_reference.py"), str(src),
                 str(dst)], env=env, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True), dst)
            self.where.update({k: (name, i) for i, k in enumerate(keys)})
        self.results = {}

    def get(self, key):
        name, i = self.where[key]
        if name not in self.results:
            proc, dst = self.procs[name]
            out, _ = proc.communicate(timeout=600)
            assert proc.returncode == 0, out[-4000:]
            with open(dst, "rb") as f:
                self.results[name] = pickle.load(f)
        return self.results[name][i][0]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_tp")
    batches = {k: _batch(512, 30 + i) for i, k in enumerate(CASES)}
    ref_jobs, steps = {}, {}
    for key, (arch, over), caps in (("qwen2", CASES["qwen2"], False),
                                    ("olmoe", MOE, True)):
        state = _ref_state(arch, over, caps)
        bs = [_batch(512, 40 + i) for i in range(2)]
        ref_jobs[key] = {"arch": arch, "over": over, "state": state,
                         "batches": bs}
        steps[key] = ("step", dict(arch=arch, over=over, state=state,
                                   batches=bs, options={}))
    for i, (key, (arch, over, _)) in enumerate(FAMILIES.items()):
        state = _ref_state(arch, over, False)
        bs = [_family_batch(key, 50 + 2 * i + j) for j in range(2)]
        ref_jobs[key] = {"arch": arch, "over": over, "state": state,
                         "batches": bs}
        steps[key] = ("step", dict(arch=arch, over=over, state=state,
                                   batches=bs, options={}))
    ref = _Reference(tmp, ref_jobs, {"a": ["qwen2", "zamba2", "whisper"],
                                     "b": ["olmoe", "xlstm"]})
    batches.update({k: _family_batch(k, 60 + i) for i, k in
                    enumerate([*FAMILIES, "xlstm2"])})
    tokens = np.random.default_rng(9).integers(1, 500, (B, 16)).astype(
        np.int32)
    ckpt, ckpt_z = str(tmp / "ckpt"), str(tmp / "ckpt-zamba2")
    port, index = {}, {}
    for shape in MESHES:
        tasks = {k: ("tp_family", dict(arch=CASES[k][0], over=CASES[k][1],
                                       batch=batches[k], seed=3, max_seq=0,
                                       pad=PAD))
                 for k in CASES}
        for k, sh in FAMILY_CASES:
            if sh == shape:
                arch, over, max_seq = _family(k)
                tasks[f"family {k}"] = ("tp_family", dict(
                    arch=arch, over=over, batch=batches[k], seed=3,
                    max_seq=max_seq, pad=PAD))
        if shape == (2, 2):
            tasks.update({f"step {k}": steps[k] for k in steps})
            tasks["save"] = ("save", dict(arch="qwen2-1.5b", over={},
                                          batch=batches["qwen2"], seed=1,
                                          ckpt_dir=ckpt))
            arch, over, _ = FAMILIES["zamba2"]
            tasks["save zamba2"] = ("save", dict(
                arch=arch, over=over, batch=batches["zamba2"], seed=1,
                ckpt_dir=ckpt_z))
        if shape == (1, 4):
            tasks["seq_decode"] = ("seq_decode", dict(
                arch="qwen2-1.5b", over={}, tokens=tokens, seed=4,
                cache_len=20))
            arch, over, _ = FAMILIES["zamba2"]
            tasks["ring_decode"] = ("ring_decode", dict(
                arch=arch, over=over, tokens=batches["zamba2"]["tokens"],
                seed=5, steps=RING_STEPS))
        index[shape] = list(tasks)
        port[shape] = start(tmp, shape, list(tasks.values()))
    done = {}

    def get(shape, name):
        if shape not in done:
            done[shape] = dict(zip(index[shape], port[shape].result()))
        return done[shape][name]
    return {"port": get, "ref": ref, "batches": batches, "tokens": tokens,
            "ckpt": ckpt, "ckpt_zamba2": ckpt_z, "ref_jobs": ref_jobs}


def _close(a, b, what, tol=1e-4, floor=0.0):
    """max |a - b| within tol of max |b|, or within `floor`."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    diff = np.abs(a - b).max()
    if diff <= floor:
        return
    scale = np.abs(b).max()
    err = diff / scale if scale else np.abs(a).max()
    assert err <= tol, (what, err)


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("case", list(CASES))
def test_tensor_parallel_loss_and_gradients_equal_one_device(runs, case,
                                                              shape):
    arch, over = CASES[case]
    got = runs["port"](shape, case)
    cfg = reduced(get_arch(arch), **over)
    tcfg = TS.TrainConfig(dtype=torch.float32)
    st = TS.init_train_state(cfg, 3, tcfg=tcfg, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in runs["batches"][case].items()}
    metrics, grads = TS.make_train_step(cfg, tcfg).loss_and_grads(st, batch)
    logits, _ = M.prefill(cfg, st["params"], {"tokens": batch["tokens"]})
    np.testing.assert_allclose(got["loss"], float(metrics["loss"]),
                               rtol=1e-5)
    _close(got["logits"], logits.numpy(), "logits", tol=1e-5)
    assert set(got["grads"]) == set(grads)
    for n, g in grads.items():
        _close(got["grads"][n], g.numpy(), n)
    dp, tp = shape
    places = M.param_pspecs(cfg, tp)
    for n, p in st["params"].named_parameters():
        split = {"data": dp, "model": tp}
        want = tuple(d // split[a] if a else d
                     for d, a in zip(p.shape, places[n]))
        assert got["shapes"][n] == want, n


def _hold_steps(got, ref):
    np.testing.assert_allclose(float(got["grad_metrics"]["loss"]),
                               float(ref["grad_metrics"]["loss"]),
                               rtol=1e-5)
    ref_grads = _by_name(ref["grads"])
    assert set(got["grads"]) == set(ref_grads)
    for n, g in got["grads"].items():
        _close(g, ref_grads[n], n)
    lr_sum = 0.0
    for i, (g, r) in enumerate(zip(got["steps"], ref["steps"])):
        np.testing.assert_allclose(float(g["metrics"]["loss"]),
                                   float(r["metrics"]["loss"]), rtol=1e-5,
                                   err_msg=f"loss step {i}")
        np.testing.assert_array_equal(g["cap_scales"], r["cap_scales"])
        lr_sum += float(r["metrics"]["lr"])
        ref_params = _by_name(r["params"])
        for n, p in g["params"].items():
            _close(p, ref_params[n], f"{n} step {i}", floor=1e-3 * lr_sum)


@pytest.mark.parametrize("case", ["qwen2", "olmoe"])
def test_step_matches_the_reference_in_sharded_step(runs, case):
    got = runs["port"]((2, 2), f"step {case}")
    _hold_steps(got, runs["ref"].get(case))


def test_decode_over_a_sequence_split_cache_equals_one_device(runs):
    got = runs["port"]((1, 4), "seq_decode")
    cfg = reduced(get_arch("qwen2-1.5b"))
    model = M.init_params(cfg, 4, device="cpu")
    toks = torch.from_numpy(runs["tokens"])
    logits, cache = M.prefill(cfg, model, {"tokens": toks})
    _close(got["prefill_logits"], logits.numpy(), "prefill", tol=1e-5)
    assert got["cache_err"] <= 1e-5
    nxt = torch.from_numpy(got["next"])
    pad = [{k: torch.nn.functional.pad(v, (0, 0, 0, 0, 0, 4))
            for k, v in seg.items()} for seg in cache]
    d, _ = M.decode_step(cfg, model, nxt, pad, toks.shape[1])
    _close(got["decode_logits"], d.numpy(), "decode", tol=1e-5)


def test_a_checkpoint_saved_on_a_2x2_mesh_loads_on_one_process(runs):
    _loads_on_one_process(runs["port"]((2, 2), "save"),
                          reduced(get_arch("qwen2-1.5b")), runs["ckpt"])


def test_a_zamba2_checkpoint_saved_on_a_2x2_mesh_loads_on_one_process(
        runs):
    arch, over, _ = FAMILIES["zamba2"]
    _loads_on_one_process(runs["port"]((2, 2), "save zamba2"),
                          reduced(get_arch(arch), **over),
                          runs["ckpt_zamba2"])


def _loads_on_one_process(saved, cfg, ckpt):
    like = TS.init_train_state(cfg, 2, device="cpu",
                               tcfg=TS.TrainConfig(dtype=torch.float32))
    one, step = CKPT.load_state(like, ckpt)
    assert step == 1
    leaves = {n: t.detach().numpy() for n, t in CKPT.state_leaves(one)}
    assert set(leaves) == set(saved)
    for n, a in saved.items():
        np.testing.assert_array_equal(leaves[n], a, err_msg=n)


@pytest.mark.parametrize("case, shape", FAMILY_CASES,
                         ids=[f"{k}-{s[0]}x{s[1]}" for k, s in FAMILY_CASES])
def test_recurrent_and_encdec_layouts_equal_one_device(runs, case, shape):
    got = runs["port"](shape, f"family {case}")
    arch, over, max_seq = _family(case)
    cfg = reduced(get_arch(arch), **over)
    tcfg = TS.TrainConfig(dtype=torch.float32)
    st = TS.init_train_state(cfg, 3, max_seq, tcfg=tcfg, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in runs["batches"][case].items()}
    metrics, grads = TS.make_train_step(cfg, tcfg).loss_and_grads(st, batch)
    np.testing.assert_allclose(got["loss"], float(metrics["loss"]),
                               rtol=1e-5)
    assert set(got["grads"]) == set(grads)
    for n, g in grads.items():
        _close(got["grads"][n], g.numpy(), n)
    inputs = {k: v for k, v in batch.items() if k in ("tokens", "frames")}
    logits, cache = M.prefill(cfg, st["params"], inputs)
    _close(got["logits"], logits.numpy(), "logits")
    assert got["cache_err"] <= 1e-4, got["cache_err"]
    d, _ = M.decode_step(cfg, st["params"], torch.from_numpy(got["next"]),
                         pad_cache(cfg, cache, PAD), S)
    _close(got["decode"], d.numpy(), "decode")
    dp, tp = shape
    places = M.param_pspecs(cfg, tp, max_seq)
    split = {"data": dp, "model": tp}
    for n, p in st["params"].named_parameters():
        want = tuple(d // split[a] if a else d
                     for d, a in zip(p.shape, places[n]))
        assert got["shapes"][n] == want, n
    if case == "xlstm2":    # every recurrent leaf whole on "model"
        assert all(got["shapes"][n] == tuple(p.shape) for n, p in
                   st["params"].named_parameters() if n.startswith("blocks"))


def test_zamba2_decode_past_its_ring_equals_one_device(runs):
    got = runs["port"]((1, 4), "ring_decode")
    assert got["layout"] == "seq" and got["ring"] == 24
    assert S > got["ring"]
    for i, (a, b) in enumerate(zip(got["meshed"], got["unmeshed"])):
        _close(a, b, f"decode step {i} at position {S + i}")


@pytest.mark.parametrize("case", list(FAMILIES))
def test_recurrent_and_encdec_steps_match_the_reference_in_sharded_step(
        runs, case):
    _hold_steps(runs["port"]((2, 2), f"step {case}"), runs["ref"].get(case))


@pytest.mark.parametrize("hq_total, hkv, tp", [(12, 2, 4), (12, 2, 3),
                                               (8, 4, 2), (4, 2, 4)])
def test_kv_for_maps_each_query_head_to_its_kv_head(hq_total, hkv, tp):
    cfg = types.SimpleNamespace(n_heads=hq_total, n_kv_heads=hkv)
    rep = hq_total // hkv
    hq = hq_total // tp
    k = torch.arange(hkv, dtype=torch.float32).reshape(1, 1, hkv, 1)
    for r in range(tp):
        dist = types.SimpleNamespace(tp_axis="model",
                                     index=lambda axes, r=r: r)
        q = torch.zeros(1, 1, hq, 1)
        ks, vs = A.kv_for(cfg, q, k, k, dist)
        per = hq // ks.shape[2]
        got = [int(ks[0, 0, i // per, 0]) for i in range(hq)]
        assert got == [(r * hq + i) // rep for i in range(hq)], (r, got)
