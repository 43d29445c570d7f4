"""The port's training path against the JAX reference on the CPU:
`loss_fn` and its gradients for the dense configurations (reduced, the
reference's own weights with seeded biases: tests/test_torch_dense.py's
CASES), AdamW (`schedule`, `apply_updates` fed the reference's
gradients, weight decay by the reference leaf's rank), `make_train_step`
from the converted reference state under each TrainConfig option, int8
gradient compression, the data pipeline and its dispatcher, the trainer
with checkpoint, failure and resume, and the refusal of a moe config in
a shape the port does not run (the vlm and encdec families' training in
tests/test_torch_train_vlm_encdec.py, the ssm and hybrid families' in
tests/test_torch_train_ssm.py, the moe family's in
tests/test_torch_train_moe.py).

Tolerances, each stated with its reason:
- loss within 1e-5 relative, every gradient within 1e-4 of its leaf's
  largest reference gradient (float32 on both sides, other summation
  orders); bfloat16 loss within 2e-2 (the reference's bfloat16 bar);
- schedule within 1e-7 (float32 cos and pow of two libraries);
  apply_updates' m, v, grad_norm and lr within 1e-6 relative and its
  params within 1e-6 relative or 1e-6 * lr (a parameter the step nearly
  cancels keeps the update's rounding), fed IDENTICAL gradients (Adam's
  first step moves an element by +-lr whatever its gradient's size, so
  the sign of a near-zero gradient that two implementations compute
  differently would decide the parameter);
- make_train_step's losses and grad norms within 1e-4 relative over 3
  steps (1e-3 with bfloat16 parameters: a master value near a bfloat16
  rounding edge can round the other way after a sign flip of that
  kind; 2e-2 with a bfloat16 loss);
- grad_compress, synthetic_tokens, Pipeline and the weighted chunk lists
  element-identical; the trainer's resumed losses equal an uninterrupted
  run's bit for bit (one process on the CPU: every sum in a fixed
  order).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_dense import CASES, _tree
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_arch as ref_get_arch
from repro.configs import reduced as ref_reduced
from repro.core import policies as RP
from repro.data import pipeline as RPIPE
from repro.models import model as RM
from repro.optim import adamw as RADAM
from repro.optim import grad_compress as RGC
from repro.train import train_step as RTS
from repro_torch.configs import get_arch, reduced
from repro_torch.convert import (_by_name, lm_params_from_reference,
                                 train_state_from_reference)
from repro_torch.data import pipeline as PIPE
from repro_torch.models import layers as L_
from repro_torch.models import model as M
from repro_torch.optim import adamw
from repro_torch.optim import grad_compress as GC
from repro_torch.sched.api import LoopScheduler
from repro_torch.sched.data_sched import ShardDispatcher
from repro_torch.train import checkpoint as CKPT
from repro_torch.train import train_step as TS
from repro_torch.train.trainer import InjectedFailure, RunConfig, train

B, S = 4, 16


def _batch(cfg, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels[rng.random((B, S)) < 0.2] = -1          # masked labels
    return {"tokens": toks, "labels": labels}


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _cfgs(name, **over):
    base, extra = CASES[name]
    extra = {**extra, **over}
    return (ref_reduced(ref_get_arch(base), **extra),
            reduced(get_arch(base), **extra))


def _remat(remat) -> dict:
    """Config fields of a `remat` case: False, True (policy "nothing") or
    a policy name."""
    policy = remat if isinstance(remat, str) else "nothing"
    return {"remat": bool(remat), "remat_policy": policy}


@functools.lru_cache(maxsize=None)
def _ref_loss_and_grad_tree(name, remat, seed=1):
    """The reference's float32 loss and gradient tree (numpy, stacked) of
    case `name` on `_tree`'s weights and batch `seed`: one JAX compile a
    case, shared by the tests of this module."""
    ref_cfg, cfg = _cfgs(name, **_remat(remat))
    params = jax.tree.map(jnp.asarray, _tree(ref_cfg))
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p: RM.loss_fn(ref_cfg, p, _j(_batch(cfg, seed)),
                             dtype=jnp.float32), has_aux=True))(params)
    return float(loss), jax.tree.map(np.asarray, grads)


def _port_loss_and_grads(name, remat, seed=1):
    """The port's float32 loss, metrics and gradients (by name) of the
    same case."""
    ref_cfg, cfg = _cfgs(name, **_remat(remat))
    model = lm_params_from_reference(cfg, _tree(ref_cfg), device="cpu")
    model.requires_grad_(True)
    loss, metrics = M.loss_fn(cfg, model, _t(_batch(cfg, seed)),
                              dtype=torch.float32)
    grads = torch.autograd.grad(loss, list(model.parameters()))
    return loss, metrics, {n: g for (n, _), g in
                           zip(model.named_parameters(), grads)}


# every case as `reduced` gives it (remat off), and qwen2 with remat on
# under each policy
@pytest.mark.parametrize("name,remat", [(name, False) for name in
                                        sorted(CASES)]
                         + [("qwen2-1.5b", True), ("qwen2-1.5b", "dots")])
def test_loss_and_gradients_match_the_reference(name, remat):
    _, cfg = _cfgs(name, **_remat(remat))
    batch = _batch(cfg, seed=1)
    loss, metrics, grads = _port_loss_and_grads(name, remat)
    r_loss, r_tree = _ref_loss_and_grad_tree(name, remat)
    r_grads = _by_name(r_tree)
    assert int(metrics["n_tokens"]) == int((batch["labels"] >= 0).sum())
    np.testing.assert_allclose(loss.item(), r_loss, rtol=1e-5)
    assert set(grads) == set(r_grads)
    for n, g in grads.items():
        ref = r_grads[n]
        np.testing.assert_allclose(g.numpy(), ref, rtol=0,
                                   atol=1e-4 * np.abs(ref).max() + 1e-30,
                                   err_msg=n)


# ------------------------------------------------------------ remat_policy
def test_remat_dots_gives_the_bits_of_nothing():
    """Under "dots" the loss and every gradient leaf equal "nothing"'s bit
    for bit: the saved projections are the values a rerun computes."""
    loss, _, grads = _port_loss_and_grads("qwen2-1.5b", "dots")
    n_loss, _, n_grads = _port_loss_and_grads("qwen2-1.5b", True)
    assert torch.equal(loss, n_loss)
    for n, g in grads.items():
        assert torch.equal(g, n_grads[n]), n


class _CountProducts(TorchDispatchMode):
    """Counts the aten.mm / aten.addmm calls dispatched under it."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
            self.n += 1
        return func(*args, **(kwargs or {}))


def _backward_products(cfg, model, batch) -> int:
    loss, _ = M.loss_fn(cfg, model, batch, dtype=torch.float32)
    with _CountProducts() as bwd:
        torch.autograd.grad(loss, list(model.parameters()))
    return bwd.n


@pytest.mark.parametrize("policy", ["nothing", "dots"])
def test_remat_policy_decides_which_products_the_backward_reruns(policy):
    """The backward's count of 2-D products is that of no remat under
    "dots" (no projection rerun) and that plus every layer's projections
    but the last under "nothing" (the layer rerun: torch's non-reentrant
    checkpoint stops its rerun at the last tensor the backward saved,
    before the MLP's down projection, whose output only the residual add
    reads)."""
    ref_cfg, cfg = _cfgs("qwen2-1.5b", **_remat(policy))
    model = lm_params_from_reference(cfg, _tree(ref_cfg), device="cpu")
    model.requires_grad_(True)
    batch = _t(_batch(cfg, seed=1))
    x = L_.embed_tokens(model.embed, batch["tokens"]).float()
    with torch.no_grad(), _CountProducts() as layer:
        M._train_layer(cfg, model.layers[0], x)
    assert layer.n == 7               # q, k, v, o, gate, up, down
    plain = _backward_products(dataclasses.replace(cfg, remat=False), model,
                               batch)
    rerun = 0 if policy == "dots" else cfg.n_layers * (layer.n - 1)
    assert _backward_products(cfg, model, batch) == plain + rerun


def test_an_unknown_remat_policy_is_refused():
    _, cfg = _cfgs("qwen2-1.5b", remat=True, remat_policy="offload")
    with pytest.raises(ValueError, match="remat_policy"):
        M.check_trainable(cfg)
    with pytest.raises(ValueError, match="remat_policy"):
        TS.make_train_step(cfg)


def test_bfloat16_loss_matches_the_reference():
    ref_cfg, cfg = _cfgs("qwen2-1.5b")
    tree = _tree(ref_cfg)
    batch = _batch(cfg, seed=2)
    model = lm_params_from_reference(cfg, tree, device="cpu")
    loss, _ = M.loss_fn(cfg, model, _t(batch), dtype=torch.bfloat16)
    r_loss = RM.loss_fn(ref_cfg, jax.tree.map(jnp.asarray, tree),
                        _j(batch), dtype=jnp.bfloat16)[0]
    np.testing.assert_allclose(float(loss), float(r_loss), rtol=2e-2)


# ---------------------------------------------------------------- AdamW
def test_schedule_matches_the_reference():
    cfg = adamw.AdamWConfig(warmup_steps=100, total_steps=1000)
    r_cfg = RADAM.AdamWConfig(warmup_steps=100, total_steps=1000)
    for step in (0, 1, 7, 50, 99, 100, 101, 333, 999, 1000, 1500):
        ours = adamw.schedule(cfg, torch.tensor(step, dtype=torch.int32))
        ref = RADAM.schedule(r_cfg, jnp.asarray(step, jnp.int32))
        assert ours.dtype == torch.float32
        np.testing.assert_allclose(float(ours), float(ref), rtol=0,
                                   atol=1e-7)


def _rel(a, b, tol=1e-6):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=tol,
                               atol=1e-30)


def test_apply_updates_matches_the_reference_on_its_gradients():
    ref_cfg, cfg = _cfgs("qwen2-layernorm-gelu")
    tree = _tree(ref_cfg)
    ref_params = jax.tree.map(jnp.asarray, tree)
    r_state = RADAM.init_state(ref_params)
    ocfg = adamw.AdamWConfig(warmup_steps=2, total_steps=10)
    r_ocfg = RADAM.AdamWConfig(warmup_steps=2, total_steps=10)
    # the reference's gradients: one tree for it, the same numbers by the
    # port's names for the port
    r_gtree = jax.jit(jax.grad(
        lambda p: RM.loss_fn(ref_cfg, p, _j(_batch(cfg, 3)),
                             dtype=jnp.float32)[0]))(ref_params)
    grads = {n: torch.from_numpy(np.array(a)) for n, a in
             _by_name(jax.tree.map(np.asarray, r_gtree)).items()}
    params = {n: torch.from_numpy(np.array(a, np.float32))
              for n, a in _by_name(tree).items()}
    state = adamw.init_state(params)
    for _ in range(2):   # the second step from non-zero moments
        params, state, metrics = adamw.apply_updates(params, grads, state,
                                                     ocfg)
        ref_params, r_state, r_metrics = jax.jit(
            RADAM.apply_updates, static_argnums=3)(ref_params, r_gtree,
                                                   r_state, r_ocfg)
        _rel(float(metrics["grad_norm"]), float(r_metrics["grad_norm"]))
        _rel(float(metrics["lr"]), float(r_metrics["lr"]))
        assert int(state["step"]) == int(r_state["step"])
        for ours, ref in ((state["m"], r_state["m"]),
                          (state["v"], r_state["v"])):
            ref = _by_name(jax.tree.map(np.asarray, ref))
            for n, t in ours.items():
                _rel(t.numpy(), ref[n])
        # a parameter that the step nearly cancels (p ~ lr * update) keeps
        # the update's own rounding: within 1e-6 of the update's size lr
        # (the grad norms differ in their last bit: the two packages sum
        # the leaves in other orders, and the clip scale follows)
        ref = _by_name(jax.tree.map(np.asarray, ref_params))
        lr = float(r_metrics["lr"])
        for n, t in params.items():
            np.testing.assert_allclose(t.numpy(), ref[n], rtol=1e-6,
                                       atol=1e-6 * lr, err_msg=n)


def test_weight_decay_follows_the_reference_leaf_rank():
    """A stacked layer's norm scale and bias and its q/k/v biases are 2-D
    in the reference ((L, d)) and decayed; the final norm is not."""
    ref_cfg, cfg = _cfgs("qwen2-layernorm-gelu")
    tree = _tree(ref_cfg)
    params = {n: torch.from_numpy(np.array(a, np.float32))
              for n, a in _by_name(tree).items()}
    before = {n: t.clone() for n, t in params.items()}
    zero = {n: torch.zeros_like(t) for n, t in params.items()}
    ocfg = adamw.AdamWConfig(warmup_steps=1)
    adamw.apply_updates(params, zero, adamw.init_state(params), ocfg)
    moved = {n for n in params if not torch.equal(params[n], before[n])}
    r_params, _, _ = jax.jit(RADAM.apply_updates, static_argnums=3)(
        jax.tree.map(jnp.asarray, tree),
        jax.tree.map(jnp.zeros_like, jax.tree.map(jnp.asarray, tree)),
        RADAM.init_state(jax.tree.map(jnp.asarray, tree)),
        RADAM.AdamWConfig(warmup_steps=1))
    r_after = _by_name(jax.tree.map(np.asarray, r_params))
    r_moved = {n for n, a in _by_name(tree).items()
               if not np.array_equal(r_after[n], a)}
    assert moved == r_moved
    for n in ("layers.0.ln1.scale", "layers.0.ln1.bias", "layers.1.ln2.scale",
              "layers.0.attn.bq", "layers.1.attn.bv", "embed.tok"):
        assert n in moved and adamw.decays(n, params[n])
    for n in ("final_norm.scale", "final_norm.bias"):
        assert n not in moved and not adamw.decays(n, params[n])


# ------------------------------------------------------ make_train_step
STEP_CONFIGS = {
    "plain": ({}, 1e-4),
    "microbatch": ({"microbatch": 2}, 1e-4),
    "grad_compress": ({"grad_compress": True}, 1e-4),
    "bf16_params": ({"bf16_params": True}, 1e-3),
    "cast_params_once": ({"cast_params_once": True, "dtype": "bfloat16"},
                         2e-2),
}


@pytest.mark.parametrize("option", sorted(STEP_CONFIGS))
def test_train_step_matches_the_reference(option):
    over, tol = STEP_CONFIGS[option]
    dtype = over.pop("dtype", "float32") if "dtype" in over else "float32"
    over = {k: v for k, v in over.items() if k != "dtype"}
    ref_cfg, cfg = _cfgs("qwen2-1.5b")
    r_tcfg = RTS.TrainConfig(dtype=getattr(jnp, dtype), **over)
    tcfg = TS.TrainConfig(dtype=getattr(torch, dtype), **over)
    r_state = RTS.init_train_state(ref_cfg, jax.random.PRNGKey(0), 0,
                                   r_tcfg)
    # the reference's weights with seeded biases (its own are zeros)
    seeded = jax.tree.map(jnp.asarray, _tree(ref_cfg))
    if over.get("bf16_params"):
        r_state["opt"]["master"] = seeded
        seeded = jax.tree.map(lambda t: t.astype(jnp.bfloat16), seeded)
    r_state["params"] = seeded
    state = train_state_from_reference(cfg, jax.tree.map(np.asarray,
                                                         r_state),
                                       device="cpu")
    r_step = jax.jit(RTS.make_train_step(ref_cfg, r_tcfg))
    step = TS.make_train_step(cfg, tcfg)
    for i in range(3):
        batch = _batch(cfg, seed=10 + i)
        r_state, r_m = r_step(r_state, _j(batch))
        state, m = step(state, _t(batch))
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(m[key]), float(r_m[key]),
                                       rtol=tol, err_msg=f"{key} step {i}")
        assert int(m["n_tokens"]) == int(r_m["n_tokens"])
        np.testing.assert_allclose(float(m["lr"]), float(r_m["lr"]),
                                   rtol=1e-6)
    dtypes = {p.dtype for p in state["params"].parameters()}
    assert dtypes == {torch.bfloat16 if over.get("bf16_params")
                      else torch.float32}


def test_train_state_from_reference_carries_every_leaf():
    ref_cfg, cfg = _cfgs("olmo-1b")
    r_tcfg = RTS.TrainConfig(bf16_params=True, grad_compress=True)
    r_state = jax.tree.map(np.asarray, RTS.init_train_state(
        ref_cfg, jax.random.PRNGKey(3), 0, r_tcfg))
    state = train_state_from_reference(cfg, r_state, device="cpu")
    params = _by_name(r_state["params"])
    for n, p in state["params"].named_parameters():
        assert p.dtype == torch.bfloat16 and p.requires_grad
        np.testing.assert_array_equal(p.detach().float().numpy(),
                                      params[n].astype(np.float32))
    master = _by_name(r_state["opt"]["master"])
    for n, t in state["opt"]["master"].items():
        np.testing.assert_array_equal(t.numpy(), master[n])
    assert set(state["grad_err"]) == set(params)
    assert int(state["opt"]["step"]) == 0
    assert tuple(state["cap_scales"].shape) == r_state["cap_scales"].shape


# ------------------------------------------------------- grad_compress
@pytest.mark.parametrize("shape", [(300,), (2, 256), (7, 33), (1,)])
def test_grad_compress_is_element_identical(shape):
    rng = np.random.default_rng(len(shape) + shape[0])
    g = (rng.standard_normal(shape) * 10 ** rng.uniform(-3, 1, shape)
         ).astype(np.float32)
    if g.size >= 256:
        g.reshape(-1)[:256] = 0.0            # an all-zero block
    err = (rng.standard_normal(shape) * 1e-3).astype(np.float32)
    q, s, n = GC.quantize(torch.from_numpy(g))
    rq, rs, rn = RGC.quantize(jnp.asarray(g))
    assert n == rn and q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(rs))
    np.testing.assert_array_equal(
        GC.dequantize(q, s, n, shape).numpy(),
        np.asarray(RGC.dequantize(rq, rs, rn, shape)))
    out, new_err = GC.compress_with_feedback(torch.from_numpy(g),
                                             torch.from_numpy(err))
    r_out, r_err = RGC.compress_with_feedback(jnp.asarray(g),
                                              jnp.asarray(err))
    np.testing.assert_array_equal(out.numpy(), np.asarray(r_out))
    np.testing.assert_array_equal(new_err.numpy(), np.asarray(r_err))


def test_tree_compress_is_element_identical():
    rng = np.random.default_rng(0)
    grads = {"a": rng.standard_normal((5, 70)).astype(np.float32),
             "b": rng.standard_normal((513,)).astype(np.float32)}
    errs = {k: (rng.standard_normal(v.shape) * 1e-2).astype(np.float32)
            for k, v in grads.items()}
    out, new = GC.tree_compress({k: torch.from_numpy(v)
                                 for k, v in grads.items()},
                                {k: torch.from_numpy(v)
                                 for k, v in errs.items()})
    r_out, r_new = RGC.tree_compress(
        {k: jnp.asarray(v) for k, v in grads.items()},
        {k: jnp.asarray(v) for k, v in errs.items()})
    for k in grads:
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(r_out[k]))
        np.testing.assert_array_equal(new[k].numpy(), np.asarray(r_new[k]))
    zeros = GC.init_error_state({k: torch.from_numpy(v)
                                 for k, v in grads.items()})
    assert all(not t.any() and t.dtype == torch.float32
               for t in zeros.values())


def _compress_both(r_tree, groups_cfg, seed):
    """The reference's `tree_compress` on stacked tree `r_tree` (numpy)
    with a seeded residual, and the port's on the same numbers by name
    with `reference_leaves(groups_cfg, ...)`; asserts the compressed
    gradients and the new residuals element-identical."""
    rng = np.random.default_rng(seed)
    r_err = jax.tree.map(lambda a: (rng.standard_normal(a.shape) * 1e-2
                                    * np.abs(a).max()).astype(np.float32),
                         r_tree)
    r_out, r_new = RGC.tree_compress(jax.tree.map(jnp.asarray, r_tree),
                                     jax.tree.map(jnp.asarray, r_err))
    grads = {n: torch.from_numpy(np.array(a))
             for n, a in _by_name(r_tree).items()}
    errs = {n: torch.from_numpy(np.array(a))
            for n, a in _by_name(r_err).items()}
    out, new = GC.tree_compress(grads, errs,
                                M.reference_leaves(groups_cfg, grads))
    for ours, ref in ((out, r_out), (new, r_new)):
        ref = _by_name(jax.tree.map(np.asarray, ref))
        assert set(ours) == set(ref)
        for n, t in ours.items():
            np.testing.assert_array_equal(t.numpy(), ref[n], err_msg=n)


def test_tree_compress_cuts_blocks_per_reference_leaf():
    """The reference compresses each stacked leaf (L, ...) as one flat
    array, its int8 blocks of 256 running across layers. At reduced qwen2
    (2 layers, d 64) the norm scales (2, 64) and the q/k/v biases are
    not multiples of 256: on the reference's own gradients, with layer 1
    of ln1's scale made 100x layer 0 (the case of ROADMAP's F1), the
    port's compressed gradients and residuals equal the reference's."""
    _, cfg = _cfgs("qwen2-1.5b")
    _, r_tree = _ref_loss_and_grad_tree("qwen2-1.5b", False)
    r_tree = jax.tree.map(np.copy, r_tree)
    scale = r_tree["segments"][0]["ln1"]["scale"]
    assert scale.shape == (2, 64)
    scale[1] = 100 * scale[0]
    _compress_both(r_tree, cfg, seed=5)


def test_tree_compress_groups_layers_by_segment_and_encoder():
    """A two-segment grouping (deepseek-moe's dense first layers, then its
    MoE layers; synthetic leaves) and an encoder leaf: each segment's
    layers and the encoder's are one reference leaf apiece."""
    cfg = reduced(get_arch("deepseek-moe-16b"), n_layers=5,
                  moe_layer_start=2)
    assert M.segments_of(cfg) == [("densffn", 2), ("moe", 3)]
    rng = np.random.default_rng(11)

    def leaf(*shape):
        return (rng.standard_normal(shape) * rng.uniform(0.1, 10, shape[:1])
                .reshape(-1, *([1] * (len(shape) - 1)))).astype(np.float32)
    r_tree = {"segments": [{"w": leaf(2, 40), "ln": {"scale": leaf(2, 7)}},
                           {"w": leaf(3, 40), "big": leaf(3, 300)}],
              "enc": {"wq": leaf(2, 30)},
              "final_norm": {"scale": leaf(70)}}
    names = _by_name(r_tree)
    groups = M.reference_leaves(cfg, names)
    assert sorted(map(tuple, groups)) == sorted([
        ("layers.0.w", "layers.1.w"), ("layers.0.ln.scale",
                                       "layers.1.ln.scale"),
        ("layers.2.w", "layers.3.w", "layers.4.w"),
        ("layers.2.big", "layers.3.big", "layers.4.big"),
        ("enc.0.wq", "enc.1.wq"), ("final_norm.scale",)])
    _compress_both(r_tree, cfg, seed=12)


# ------------------------------------------------------------------ data
@pytest.mark.parametrize("batch,seq,vocab,step,seed",
                         [(4, 32, 512, 0, 0), (3, 17, 151936, 5, 7),
                          (1, 1, 2, 2, 1)])
def test_synthetic_tokens_equal_the_reference(batch, seq, vocab, step, seed):
    ours = PIPE.synthetic_tokens(batch, seq, vocab, step, seed)
    ref = RPIPE.synthetic_tokens(batch, seq, vocab, step, seed)
    for key in ("tokens", "labels"):
        assert ours[key].dtype == ref[key].dtype
        np.testing.assert_array_equal(ours[key], ref[key])


def test_pipeline_batches_equal_the_reference():
    cfg = reduced(get_arch("olmo-1b"))
    ours = PIPE.Pipeline(cfg, 5, 24, seed=3, device="cpu")
    ref = RPIPE.Pipeline(ref_reduced(ref_get_arch("olmo-1b")), 5, 24, seed=3)
    for t in range(4):
        (b, stats), (rb, _) = ours.get_batch(t), ref.get_batch(t)
        for key in ("tokens", "labels"):
            np.testing.assert_array_equal(b[key], rb[key])
        assert stats.chunks >= 1
    ours.close()
    ref.get_batch(4)
    # a jump (a resumed trainer's first step) gets that step's batch
    jump = PIPE.Pipeline(cfg, 5, 24, seed=3, device="cpu")
    b, _ = jump.get_batch(6)
    np.testing.assert_array_equal(
        b["tokens"], PIPE.synthetic_tokens(5, 24, cfg.padded_vocab, 6,
                                           3)["tokens"])
    jump.close()


def test_shard_dispatcher_runs_each_shard_once():
    costs = np.random.default_rng(0).zipf(1.5, 97).astype(np.float64)
    d = ShardDispatcher(n_hosts=3, scheduler=LoopScheduler(device="cpu"))
    for run in (lambda f: d.dispatch(len(costs), f),
                lambda f: d.dispatch_weighted(costs, f)):
        hits = np.zeros(len(costs), np.int64)

        def read(i, hits=hits):
            hits[i] += 1
        stats = run(read)
        np.testing.assert_array_equal(hits, np.ones_like(hits))
        assert stats.chunks >= 1
    ref_chunks = tuple(RP.pretile(RP.binlpt(12), costs, 3))
    assert d.weighted_chunks(costs) == ref_chunks
    hits = d.scheduler.cache_stats.hits
    d.weighted_chunks(costs)                  # memoized in the cache
    assert d.scheduler.cache_stats.hits == hits + 1


# ------------------------------------------------- trainer, checkpoints
def test_trainer_checkpoint_restart_and_loss_decreases(tmp_path):
    cfg = reduced(get_arch("olmo-1b"))
    run = RunConfig(steps=14, batch=4, seq=32, ckpt_dir=str(tmp_path),
                    ckpt_every=5, failure_at=7, log_every=100)
    with pytest.raises(InjectedFailure):
        train(cfg, run, device="cpu", verbose=False)
    assert CKPT.list_steps(str(tmp_path)) == [5]
    state, losses = train(cfg, dataclasses.replace(run, failure_at=None),
                          device="cpu", verbose=False)
    assert len(losses) == 9  # resumed from step 5
    full_run = RunConfig(steps=14, batch=4, seq=32,
                         ckpt_dir=str(tmp_path / "fresh"), log_every=100)
    fresh_state, fresh_losses = train(cfg, full_run, device="cpu",
                                      verbose=False)
    assert fresh_losses[-1] < fresh_losses[0]  # learning happens
    # the resumed run is the uninterrupted one, bit for bit
    assert losses == fresh_losses[5:]
    for (n, a), (_, b) in zip(CKPT.state_leaves(state),
                              CKPT.state_leaves(fresh_state)):
        assert torch.equal(a, b), n


@pytest.mark.parametrize("bf16", [False, True])
def test_checkpoint_round_trip_bits(tmp_path, bf16):
    cfg = reduced(get_arch("olmo-1b"))
    tcfg = TS.TrainConfig(bf16_params=bf16, grad_compress=True)
    state = TS.init_train_state(cfg, 0, 32, tcfg, device="cpu")
    CKPT.save_state(state, str(tmp_path), 7)
    like = TS.init_train_state(cfg, 1, 32, tcfg, device="cpu")
    loaded, step = CKPT.load_state(like, str(tmp_path))
    assert step == 7 and loaded is like
    leaves = list(CKPT.state_leaves(state))
    assert len(leaves) == len(list(CKPT.state_leaves(loaded)))
    for (n, a), (m, b) in zip(leaves, CKPT.state_leaves(loaded)):
        assert n == m and a.dtype == b.dtype and torch.equal(a, b), n
    assert any(t.dtype == torch.bfloat16 for _, t in leaves) == bf16
    with pytest.raises(ValueError, match="another state"):
        CKPT.load_state(TS.init_train_state(cfg, 0, 32, TS.TrainConfig(),
                                            device="cpu"), str(tmp_path))


def test_bf16_master_training_state():
    cfg = reduced(get_arch("olmo-1b"))
    tcfg = TS.TrainConfig(bf16_params=True)
    state = TS.init_train_state(cfg, 0, 32, tcfg, device="cpu")
    assert all(p.dtype == torch.bfloat16
               for p in state["params"].parameters())
    assert all(t.dtype == torch.float32
               for t in state["opt"]["master"].values())
    before = [p.detach().clone() for p in state["params"].parameters()]
    step = TS.make_train_step(cfg, tcfg)
    state2, metrics = step(state, _t(PIPE.synthetic_tokens(
        4, 32, cfg.padded_vocab, 0)))
    assert bool(torch.isfinite(metrics["loss"]))
    params = list(state2["params"].parameters())
    assert all(p.dtype == torch.bfloat16 for p in params)
    assert any(not torch.equal(a, b) for a, b in zip(params, before))


# -------------------------------------------------------------- refusals
@pytest.mark.parametrize("name", ["olmoe-1b-7b", "deepseek-moe-16b"])
def test_families_not_trained_yet_are_refused(name, tmp_path):
    """Every family trains; a config in a shape the port does not run yet
    (here MoE experts with GELU) is refused by the loss, the step and the
    trainer before anything is written."""
    cfg = reduced(get_arch(name), act="gelu")
    with pytest.raises(NotImplementedError, match="later slice"):
        M.loss_fn(cfg, None, {})
    with pytest.raises(NotImplementedError, match="later slice"):
        TS.make_train_step(cfg)
    with pytest.raises(NotImplementedError, match="later slice"):
        train(cfg, RunConfig(steps=1, ckpt_dir=str(tmp_path)), device="cpu",
              verbose=False)
    assert not CKPT.list_steps(str(tmp_path))
