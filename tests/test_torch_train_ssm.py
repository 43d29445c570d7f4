"""The port's training path for the ssm family (xlstm-350m: mLSTM "X" and
sLSTM "S" blocks) and the hybrid family (zamba2-1.2b: Mamba2 "M" blocks
and one attention block shared by every "A" position) against the JAX
reference on the CPU: `loss_fn` and every gradient leaf against
`jax.value_and_grad(repro.models.model.loss_fn)` with remat off and on,
remat "dots" against "nothing", the bfloat16 loss, `make_train_step` from
`convert.train_state_from_reference` (plain and with gradient
compression) against the reference's step, AdamW's weight decay by the
reference leaf's rank, the grouping of the unstacked blocks by reference
leaf, the converter over both states, `train()` with a failure and a
resume, and `check_trainable`.

`reduced()` keeps the first two entries of `block_pattern` ("X", "X" and
"M", "M") and a scan chunk of 256, so a short sequence would run one
chunk, no sLSTM and no shared block: the cases run xlstm with ("X",
"S"), Zamba2 with ("M", "A", "M", "A") (the shared block used twice),
`ssm_chunk` 16 over 40 tokens (three chunks, the last ragged) and
Zamba2's `attn_window` 24, under the sequence, so that the window's mask
reaches the flash backward. The reference's weights come from its
`init_params`, with every constant vector (the norms' scales, Mamba2's
A_log, D, dt_bias and norm) redrawn from a seed so that it carries
weight.

Tolerances (tests/test_torch_train.py's, with their reasons): loss
within 1e-5 relative, every gradient within 1e-4 of its leaf's largest
reference gradient (float32 on both sides, other summation orders);
bfloat16 loss within 2e-2; a step's loss and grad norm within 1e-4
relative; "dots" and the resumed trainer equal "nothing" and an
uninterrupted run bit for bit (one process on the CPU)."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_get_arch
from repro.configs import reduced as ref_reduced
from repro.models import model as RM
from repro.optim import adamw as RADAM
from repro.train import train_step as RTS
from repro_torch.configs import get_arch, reduced
from repro_torch.convert import (_by_name, lm_params_from_reference,
                                 train_state_from_reference)
from repro_torch.models import model as M
from repro_torch.optim import adamw
from repro_torch.train import checkpoint as CKPT
from repro_torch.train import train_step as TS
from repro_torch.train.trainer import InjectedFailure, RunConfig, train

B, S = 2, 40
CASES = {
    "xlstm": ("xlstm-350m", dict(block_pattern=("X", "S"), n_layers=2,
                                 ssm_chunk=16)),
    "zamba2": ("zamba2-1.2b", dict(block_pattern=("M", "A", "M", "A"),
                                   n_layers=4, ssm_chunk=16,
                                   attn_window=24)),
}


def _remat(remat) -> dict:
    """Config fields of a `remat` case: False, True (policy "nothing") or
    a policy name."""
    policy = remat if isinstance(remat, str) else "nothing"
    return {"remat": bool(remat), "remat_policy": policy}


def _cfgs(case, remat=False):
    name, over = CASES[case]
    over = {**over, **_remat(remat)}
    return (ref_reduced(ref_get_arch(name), **over),
            reduced(get_arch(name), **over))


@functools.lru_cache(maxsize=None)
def _tree_of(case):
    ref_cfg, _ = _cfgs(case)
    params = jax.tree.map(np.asarray, RM.init_params(
        ref_cfg, jax.random.PRNGKey(3), max_seq=64))
    rng = np.random.default_rng(11)

    def redraw(a):   # a constant vector: ones -> 1 + noise, zeros -> noise
        if a.ndim != 1 or not np.all(a == a.flat[0]):
            return a
        noise = rng.standard_normal(a.shape).astype(np.float32)
        return (a + (0.1 if a.flat[0] else 0.5) * noise).astype(a.dtype)
    return jax.tree.map(redraw, params)


def _tree(case):
    return jax.tree.map(np.copy, _tree_of(case))


def _batch(cfg, seed, b=B):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, S)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (b, S)).astype(np.int32)
    labels[rng.random((b, S)) < 0.2] = -1          # masked labels
    return {"tokens": toks, "labels": labels}


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def _ref_loss_and_grad_tree(case, remat, seed=1):
    """The reference's float32 loss and gradient tree (numpy) of `case`
    on `_tree`'s weights and batch `seed`: one JAX compile a case."""
    ref_cfg, cfg = _cfgs(case, remat)
    params = jax.tree.map(jnp.asarray, _tree(case))
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p: RM.loss_fn(ref_cfg, p, _j(_batch(cfg, seed)),
                             dtype=jnp.float32), has_aux=True))(params)
    return float(loss), jax.tree.map(np.asarray, grads)


def _model(case, remat=False):
    _, cfg = _cfgs(case, remat)
    model = lm_params_from_reference(cfg, _tree(case), device="cpu")
    return cfg, model.requires_grad_(True)


def _port_loss_and_grads(case, remat, seed=1):
    cfg, model = _model(case, remat)
    loss, metrics = M.loss_fn(cfg, model, _t(_batch(cfg, seed)),
                              dtype=torch.float32)
    grads = torch.autograd.grad(loss, list(model.parameters()))
    return loss.detach(), metrics, {n: g for (n, _), g in
                                    zip(model.named_parameters(), grads)}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_gradients_match_the_reference(case, remat):
    """Every leaf: each block's (Mamba2's conv_x, A_log, D, dt_bias, norm;
    the mLSTM's gates; the sLSTM's recurrent r), the shared attention
    block's (its gradient summed over the "A" positions), the tied token
    table's and the final norm's."""
    _, cfg = _cfgs(case, remat)
    batch = _batch(cfg, seed=1)
    loss, metrics, grads = _port_loss_and_grads(case, remat)
    r_loss, r_tree = _ref_loss_and_grad_tree(case, remat)
    r_grads = _by_name(r_tree)
    assert int(metrics["n_tokens"]) == int((batch["labels"] >= 0).sum())
    np.testing.assert_allclose(loss.item(), r_loss, rtol=1e-5)
    assert set(grads) == set(r_grads)
    for n, g in grads.items():
        ref = r_grads[n]
        assert float(np.abs(ref).max()) > 0, n   # every leaf takes a part
        np.testing.assert_allclose(g.numpy(), ref, rtol=0,
                                   atol=1e-4 * np.abs(ref).max() + 1e-30,
                                   err_msg=n)


@pytest.mark.parametrize("case", sorted(CASES))
def test_remat_dots_gives_the_bits_of_nothing(case):
    loss, _, grads = _port_loss_and_grads(case, "dots")
    n_loss, _, n_grads = _port_loss_and_grads(case, True)
    assert torch.equal(loss, n_loss)
    for n, g in grads.items():
        assert torch.equal(g, n_grads[n]), n


@pytest.mark.parametrize("case", sorted(CASES))
def test_bfloat16_loss_matches_the_reference(case):
    ref_cfg, cfg = _cfgs(case)
    tree = _tree(case)
    batch = _batch(cfg, seed=2)
    model = lm_params_from_reference(cfg, tree, device="cpu")
    loss, _ = M.loss_fn(cfg, model, _t(batch), dtype=torch.bfloat16)
    r_loss = RM.loss_fn(ref_cfg, jax.tree.map(jnp.asarray, tree),
                        _j(batch), dtype=jnp.bfloat16)[0]
    np.testing.assert_allclose(float(loss), float(r_loss), rtol=2e-2)


# ------------------------------------------------------ make_train_step
def _reference_state(case, r_tcfg):
    ref_cfg, _ = _cfgs(case)
    r_state = RTS.init_train_state(ref_cfg, jax.random.PRNGKey(0), 64,
                                   r_tcfg)
    r_state["params"] = jax.tree.map(jnp.asarray, _tree(case))
    return r_state


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("option", ["remat-off", "remat-on",
                                    "grad_compress"])
def test_train_step_matches_the_reference(case, option):
    """Two steps of each from the converted reference state: remat off,
    remat on, and int8 gradient compression (its blocks cut per reference
    leaf: each unstacked block's tensor and the shared block's its own
    leaf)."""
    remat = option == "remat-on"
    over = {"grad_compress": True} if option == "grad_compress" else {}
    ref_cfg, cfg = _cfgs(case, remat)
    r_tcfg = RTS.TrainConfig(dtype=jnp.float32, **over)
    tcfg = TS.TrainConfig(dtype=torch.float32, **over)
    r_state = _reference_state(case, r_tcfg)
    state = train_state_from_reference(cfg, jax.tree.map(np.asarray,
                                                         r_state),
                                       device="cpu")
    r_step = jax.jit(RTS.make_train_step(ref_cfg, r_tcfg))
    step = TS.make_train_step(cfg, tcfg)
    for i in range(2):
        batch = _batch(cfg, seed=10 + i)
        r_state, r_m = r_step(r_state, _j(batch))
        state, m = step(state, _t(batch))
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(m[key]), float(r_m[key]),
                                       rtol=1e-4, err_msg=f"{key} step {i}")
        assert int(m["n_tokens"]) == int(r_m["n_tokens"])
        np.testing.assert_allclose(float(m["lr"]), float(r_m["lr"]),
                                   rtol=1e-6)


@pytest.mark.parametrize("case", sorted(CASES))
def test_weight_decay_and_compression_groups_follow_the_reference(case):
    """The reference keeps the blocks as an unstacked list and the shared
    block as a leaf of its own: every port parameter is one reference
    leaf of the same rank (`reference_ndim`), its own group in
    `reference_leaves`, and AdamW decays exactly the parameters the
    reference decays (its matrices: conv_x, the projections, the sLSTM's
    r, the token table)."""
    ref_cfg, cfg = _cfgs(case)
    tree = _tree(case)
    leaves = _by_name(tree)
    model = lm_params_from_reference(cfg, tree, device="cpu")
    names = [n for n, _ in model.named_parameters()]
    assert M.reference_leaves(cfg, names) == [[n] for n in names]
    for n, p in model.named_parameters():
        assert M.reference_ndim(n, p.ndim) == np.ndim(leaves[n]), n
    params = {n: torch.from_numpy(np.array(a, np.float32))
              for n, a in leaves.items()}
    before = {n: t.clone() for n, t in params.items()}
    zero = {n: torch.zeros_like(t) for n, t in params.items()}
    adamw.apply_updates(params, zero, adamw.init_state(params),
                        adamw.AdamWConfig(warmup_steps=1))
    moved = {n for n in params if not torch.equal(params[n], before[n])}
    r_params, _, _ = jax.jit(RADAM.apply_updates, static_argnums=3)(
        jax.tree.map(jnp.asarray, tree),
        jax.tree.map(jnp.zeros_like, jax.tree.map(jnp.asarray, tree)),
        RADAM.init_state(jax.tree.map(jnp.asarray, tree)),
        RADAM.AdamWConfig(warmup_steps=1))
    r_after = _by_name(jax.tree.map(np.asarray, r_params))
    r_moved = {n for n, a in leaves.items()
               if not np.array_equal(r_after[n], a)}
    assert moved == r_moved
    want = {"xlstm": ("blocks.0.mlstm.wq", "blocks.1.slstm.r",
                      "embed.tok"),
            "zamba2": ("blocks.0.mamba.conv_x", "shared_attn.attn.wq",
                       "shared_attn.mlp.wi")}[case]
    assert set(want) <= moved
    assert not {n for n in moved if n.endswith(("A_log", "dt_bias",
                                                "scale"))}


@pytest.mark.parametrize("case", sorted(CASES))
def test_train_state_from_reference_carries_every_leaf(case):
    """The reference's state with a bfloat16 master and residuals: every
    parameter (the "A" positions' empty blocks hold none; the shared
    block's leaves once), master, residual, the step and the capacity
    scales."""
    ref_cfg, cfg = _cfgs(case)
    r_tcfg = RTS.TrainConfig(bf16_params=True, grad_compress=True)
    r_state = jax.tree.map(np.asarray, RTS.init_train_state(
        ref_cfg, jax.random.PRNGKey(3), 64, r_tcfg))
    state = train_state_from_reference(cfg, r_state, device="cpu")
    params = _by_name(r_state["params"])
    names = {n for n, _ in state["params"].named_parameters()}
    assert names == set(params)
    if cfg.family == "hybrid":
        assert not any(n.startswith(("blocks.1.", "blocks.3."))
                       for n in names)
        assert "shared_attn.attn.wq" in names
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


# ------------------------------------------------ trainer, check_trainable
def test_trainer_resumes_zamba2_bit_for_bit(tmp_path):
    """train() on the reduced hybrid (the shared block twice, a window
    under the sequence, three scan chunks a block): a failure after step
    2, a resume from its checkpoint, and the resumed losses and final
    state equal an uninterrupted run's bit for bit; the loss falls."""
    _, cfg = _cfgs("zamba2")
    run = RunConfig(steps=4, batch=2, seq=S, ckpt_dir=str(tmp_path),
                    ckpt_every=2, failure_at=2, log_every=100)
    with pytest.raises(InjectedFailure):
        train(cfg, run, device="cpu", verbose=False)
    assert CKPT.list_steps(str(tmp_path)) == [2]
    state, losses = train(cfg, dataclasses.replace(run, failure_at=None),
                          device="cpu", verbose=False)
    assert len(losses) == 2
    fresh_state, fresh = train(cfg, dataclasses.replace(
        run, failure_at=None, ckpt_dir=str(tmp_path / "fresh")),
        device="cpu", verbose=False)
    assert all(np.isfinite(fresh)) and fresh[-1] < fresh[0]
    assert losses == fresh[2:]
    for (n, a), (_, b) in zip(CKPT.state_leaves(state),
                              CKPT.state_leaves(fresh_state)):
        assert torch.equal(a, b), n


@pytest.mark.parametrize("name", ["xlstm-350m", "zamba2-1.2b"])
def test_check_trainable_admits_ssm_and_hybrid(name):
    for policy in M.REMAT_POLICIES:
        M.check_trainable(reduced(get_arch(name), remat=True,
                                  remat_policy=policy))
        TS.make_train_step(reduced(get_arch(name), remat_policy=policy))
    with pytest.raises(ValueError, match="remat_policy"):
        M.check_trainable(reduced(get_arch(name), remat_policy="offload"))
