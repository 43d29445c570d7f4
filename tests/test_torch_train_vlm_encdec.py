"""The port's training path for the vlm family (phi-3-vision-4.2b: patch
embeddings before the tokens, the loss over the text positions) and the
encdec family (whisper-small: the encoder over frames, each decoder
layer's cross-attention, one learned position table) against the JAX
reference on the CPU: `loss_fn` and every gradient leaf against
`jax.value_and_grad(repro.models.model.loss_fn)` with remat off and on,
a vlm batch without patches, whisper at 1,030 frames (the reference's
`blockwise_attention` masks the ragged key block), the bfloat16 loss,
`make_train_step` from `convert.train_state_from_reference` (patches and
frames split by microbatch; gradient compression over the encoder's
stacked leaves), remat "dots" on whisper (the reference checkpoints its
layers with no policy: ROADMAP.md queue 3 caveat 12), the converter over
both states, `train()` on a vlm (text alone) and its refusal of encdec
(caveat 13), and `check_trainable` on the moe family (admitted; a shape
the port does not run labelled for a later slice).

The reference's weights are carried over by the converter on `reduced()`
configs: phi-3-vision's as `init_params` draws them (rmsnorm, no biases),
whisper's with every layernorm's scale and bias drawn from a seed
(tests/test_torch_encdec.py) so that they carry weight.

Tolerances (tests/test_torch_train.py's, with their reasons): loss
within 1e-5 relative, every gradient within 1e-4 of its leaf's largest
reference gradient (float32 on both sides, other summation orders);
bfloat16 loss within 2e-2; a step's loss and grad norm within 1e-4
relative; the trainer's losses equal an in-memory run's bit for bit (one
process on the CPU)."""
import dataclasses
import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_dense import _tree as _dense_tree
from test_torch_encdec import _tree as _whisper_tree
from test_torch_train import _CountProducts

from repro.configs import get_arch as ref_get_arch
from repro.configs import reduced as ref_reduced
from repro.models import model as RM
from repro.train import train_step as RTS
from repro_torch.configs import get_arch, reduced
from repro_torch.convert import (_by_name, lm_params_from_reference,
                                 train_state_from_reference)
from repro_torch.data import pipeline as PIPE
from repro_torch.models import model as M
from repro_torch.train import checkpoint as CKPT
from repro_torch.train import train_step as TS
from repro_torch.train.trainer import RunConfig, train

VLM, WHISPER = "phi-3-vision-4.2b", "whisper-small"
B, S = 4, 16
MAX_SEQ = 48          # whisper's position table at 16 frames
# name -> (architecture, config fields, whether a vlm batch has patches)
CASES = {
    "vlm": (VLM, {}, True),
    "vlm-text": (VLM, {}, False),
    "whisper": (WHISPER, {}, True),
    # from 1,024 tokens on the reference's attention is blockwise: its
    # last key block of 1,024 holds 6 keys and masks the rest
    "whisper-1030": (WHISPER, dict(encoder_seq=1030, n_layers=1,
                                   encoder_layers=1), True),
}


def _remat(remat) -> dict:
    """Config fields of a `remat` case: False, True (policy "nothing") or
    a policy name."""
    policy = remat if isinstance(remat, str) else "nothing"
    return {"remat": bool(remat), "remat_policy": policy}


def _cfgs(case, remat=False):
    name, over, _ = CASES[case]
    over = {**over, **_remat(remat)}
    return (ref_reduced(ref_get_arch(name), **over),
            reduced(get_arch(name), **over))


def _max_seq(cfg) -> int:
    return max(MAX_SEQ, cfg.encoder_seq)


def _tree(ref_cfg):
    if ref_cfg.family == "encdec":
        return _whisper_tree(ref_cfg, _max_seq(ref_cfg))
    return _dense_tree(ref_cfg)


def _batch(case, cfg, seed, b=B):
    """Tokens and labels (b, S) (a fifth of the labels masked), and the
    family's inputs, standard normal: patches (b, P, d) for a vlm case
    with patches, frames (b, S_enc, d) for whisper."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, S)).astype(
        np.int32)}
    labels = rng.integers(0, cfg.vocab_size, (b, S)).astype(np.int32)
    labels[rng.random((b, S)) < 0.2] = -1
    batch["labels"] = labels
    if cfg.family == "vlm" and CASES[case][2]:
        batch["patches"] = rng.standard_normal(
            (b, cfg.num_patches, cfg.d_model)).astype(np.float32)
    if cfg.family == "encdec":
        batch["frames"] = rng.standard_normal(
            (b, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return batch


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def _ref_loss_and_grad_tree(case, remat, seed=1):
    """The reference's float32 loss and gradient tree (numpy, stacked) of
    `case` on `_tree`'s weights and batch `seed`: one JAX compile a case,
    shared by the tests of this module."""
    ref_cfg, cfg = _cfgs(case, remat)
    params = jax.tree.map(jnp.asarray, _tree(ref_cfg))
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p: RM.loss_fn(ref_cfg, p, _j(_batch(case, cfg, seed)),
                             dtype=jnp.float32), has_aux=True))(params)
    return float(loss), jax.tree.map(np.asarray, grads)


def _model(case, remat=False):
    ref_cfg, cfg = _cfgs(case, remat)
    model = lm_params_from_reference(cfg, _tree(ref_cfg), device="cpu")
    return cfg, model.requires_grad_(True)


def _port_loss_and_grads(case, remat, seed=1):
    """The port's float32 loss, metrics and gradients (by name) of the
    same case."""
    cfg, model = _model(case, remat)
    loss, metrics = M.loss_fn(cfg, model, _t(_batch(case, cfg, seed)),
                              dtype=torch.float32)
    grads = torch.autograd.grad(loss, list(model.parameters()))
    return loss, metrics, {n: g for (n, _), g in
                           zip(model.named_parameters(), grads)}


@pytest.mark.parametrize("case,remat", [
    ("vlm", False), ("vlm", True), ("vlm-text", True),
    ("whisper", False), ("whisper", True), ("whisper-1030", True)])
def test_loss_and_gradients_match_the_reference(case, remat):
    """Every leaf, whisper's position table (gradient from the encoder's
    rows and the decoder's) and its tied token table (from the embedding
    and the head) among them. At 1,030 frames the reference's encoder
    takes `blockwise_attention` (ragged keys masked) and its gradient;
    the port's plain version keeps every key, as the kernel does."""
    _, cfg = _cfgs(case, remat)
    batch = _batch(case, cfg, seed=1)
    loss, metrics, grads = _port_loss_and_grads(case, remat)
    r_loss, r_tree = _ref_loss_and_grad_tree(case, remat)
    r_grads = _by_name(r_tree)
    assert int(metrics["n_tokens"]) == int((batch["labels"] >= 0).sum())
    np.testing.assert_allclose(loss.item(), r_loss, rtol=1e-5)
    assert set(grads) == set(r_grads)
    for n, g in grads.items():
        ref = r_grads[n]
        np.testing.assert_allclose(g.numpy(), ref, rtol=0,
                                   atol=1e-4 * np.abs(ref).max() + 1e-30,
                                   err_msg=n)


@pytest.mark.parametrize("case", ["vlm", "whisper"])
def test_bfloat16_loss_matches_the_reference(case):
    ref_cfg, cfg = _cfgs(case)
    tree = _tree(ref_cfg)
    batch = _batch(case, cfg, seed=2)
    model = lm_params_from_reference(cfg, tree, device="cpu")
    loss, _ = M.loss_fn(cfg, model, _t(batch), dtype=torch.bfloat16)
    r_loss = RM.loss_fn(ref_cfg, jax.tree.map(jnp.asarray, tree),
                        _j(batch), dtype=jnp.bfloat16)[0]
    np.testing.assert_allclose(float(loss), float(r_loss), rtol=2e-2)


# ---------------------------------------------------------- remat on encdec
def _backward_products(cfg, model, batch) -> int:
    loss, _ = M.loss_fn(cfg, model, batch, dtype=torch.float32)
    with _CountProducts() as bwd:
        torch.autograd.grad(loss, list(model.parameters()))
    return bwd.n


def test_whisper_remat_dots_reruns_whole_layers():
    """The reference checkpoints whisper's encoder and decoder layers with
    no policy, so "dots" saves no product there: the backward runs as
    many 2-D products as under "nothing", more than without remat (the
    reruns), and the loss and every gradient equal "nothing"'s bits."""
    batch = _t(_batch("whisper", _cfgs("whisper")[1], seed=1))
    counts = {}
    for remat in (False, True, "dots"):
        cfg, model = _model("whisper", remat)
        counts[remat] = _backward_products(cfg, model, batch)
    assert counts["dots"] == counts[True] > counts[False]
    loss, _, grads = _port_loss_and_grads("whisper", "dots")
    n_loss, _, n_grads = _port_loss_and_grads("whisper", True)
    assert torch.equal(loss, n_loss)
    for n, g in grads.items():
        assert torch.equal(g, n_grads[n]), n


# ------------------------------------------------------ make_train_step
STEP_CASES = {
    # the vlm batch's patches split along with its tokens
    "vlm-microbatch": ("vlm", {"microbatch": 2}),
    "whisper-microbatch": ("whisper", {"microbatch": 2}),
    # int8 blocks run across the encoder's layers, one reference leaf
    "whisper-grad_compress": ("whisper", {"grad_compress": True}),
}


def _reference_state(case, r_tcfg):
    ref_cfg, _ = _cfgs(case)
    r_state = RTS.init_train_state(ref_cfg, jax.random.PRNGKey(0),
                                   _max_seq(ref_cfg), r_tcfg)
    r_state["params"] = jax.tree.map(jnp.asarray, _tree(ref_cfg))
    return r_state


@pytest.mark.parametrize("option", sorted(STEP_CASES))
def test_train_step_matches_the_reference(option):
    case, over = STEP_CASES[option]
    ref_cfg, cfg = _cfgs(case)
    r_tcfg = RTS.TrainConfig(dtype=jnp.float32, **over)
    tcfg = TS.TrainConfig(dtype=torch.float32, **over)
    r_state = _reference_state(case, r_tcfg)
    state = train_state_from_reference(cfg, jax.tree.map(np.asarray,
                                                         r_state),
                                       device="cpu")
    r_step = jax.jit(RTS.make_train_step(ref_cfg, r_tcfg))
    step = TS.make_train_step(cfg, tcfg)
    for i in range(2):
        batch = _batch(case, cfg, seed=10 + i)
        r_state, r_m = r_step(r_state, _j(batch))
        state, m = step(state, _t(batch))
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(m[key]), float(r_m[key]),
                                       rtol=1e-4, err_msg=f"{key} step {i}")
        assert int(m["n_tokens"]) == int(r_m["n_tokens"])
        np.testing.assert_allclose(float(m["lr"]), float(r_m["lr"]),
                                   rtol=1e-6)


@pytest.mark.parametrize("case", ["vlm", "whisper"])
def test_train_state_from_reference_carries_every_leaf(case):
    """The reference's state with a bfloat16 master and residuals: every
    parameter (whisper's unstacked `enc.<l>.*` and its position table of
    max_seq rows), master, residual, the step and the capacity scales."""
    ref_cfg, cfg = _cfgs(case)
    r_tcfg = RTS.TrainConfig(bf16_params=True, grad_compress=True)
    r_state = jax.tree.map(np.asarray, RTS.init_train_state(
        ref_cfg, jax.random.PRNGKey(3), _max_seq(ref_cfg), r_tcfg))
    state = train_state_from_reference(cfg, r_state, device="cpu")
    params = _by_name(r_state["params"])
    names = {n for n, _ in state["params"].named_parameters()}
    assert names == set(params)
    if cfg.family == "encdec":
        assert tuple(state["params"].embed.pos.shape) == (_max_seq(cfg),
                                                          cfg.d_model)
        assert {f"enc.{l_}.attn.wq" for l_ in range(cfg.encoder_layers)} \
            <= names
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


# ------------------------------------------------------ trainer, refusals
def test_trainer_runs_a_vlm_on_text_alone(tmp_path):
    """train() feeds the pipeline's tokens and labels: a vlm trains on
    text alone, as the reference's trainer runs it; its losses equal an
    in-memory run of make_train_step over the same batches, bit for
    bit."""
    cfg = reduced(get_arch(VLM))
    run = RunConfig(steps=3, batch=2, seq=16, ckpt_dir=str(tmp_path),
                    ckpt_every=2, log_every=100)
    state, losses = train(cfg, run, device="cpu", verbose=False)
    assert CKPT.list_steps(str(tmp_path)) == [2, 3]
    tcfg = TS.TrainConfig(opt=dataclasses.replace(
        TS.TrainConfig().opt, warmup_steps=10, total_steps=run.steps))
    mem = TS.init_train_state(cfg, run.seed, max_seq=run.seq, tcfg=tcfg,
                              device="cpu")
    step = TS.make_train_step(cfg, tcfg)
    pipe = PIPE.Pipeline(cfg, run.batch, run.seq, seed=run.seed,
                         device="cpu")
    mem_losses = []
    for t in range(run.steps):
        batch, _ = pipe.get_batch(t)
        assert set(batch) == {"tokens", "labels"}
        mem, m = step(mem, _t(batch))
        mem_losses.append(float(m["loss"]))
    pipe.close()
    assert losses == mem_losses and all(np.isfinite(losses))


def test_trainer_refuses_encdec_and_writes_nothing(tmp_path):
    cfg = reduced(get_arch(WHISPER))
    with pytest.raises(NotImplementedError, match="caveat 13"):
        train(cfg, RunConfig(steps=1, ckpt_dir=str(tmp_path)),
              device="cpu", verbose=False)
    assert not CKPT.list_steps(str(tmp_path))
    assert not any(tmp_path.iterdir())


@pytest.mark.parametrize("name,item", [
    ("olmoe-1b-7b", "5(b)"), ("deepseek-moe-16b", "5(b)")])
def test_check_trainable_labels_the_families_not_trained_yet(name, item):
    """The moe family trains since ROADMAP.md queue 1 item `item`:
    check_trainable admits it, and labels a shape of the family that the
    port does not run yet (GELU experts) for a later slice."""
    M.check_trainable(reduced(get_arch(name)))
    TS.make_train_step(reduced(get_arch(name)))
    with pytest.raises(NotImplementedError,
                       match=re.escape("later slice (ROADMAP.md)")):
        M.check_trainable(reduced(get_arch(name), act="gelu"))


@pytest.mark.parametrize("name", [VLM, WHISPER])
def test_check_trainable_admits_vlm_and_encdec(name):
    for policy in M.REMAT_POLICIES:
        M.check_trainable(reduced(get_arch(name), remat=True,
                                  remat_policy=policy))
        TS.make_train_step(reduced(get_arch(name), remat_policy=policy))
    with pytest.raises(ValueError, match="remat_policy"):
        M.check_trainable(reduced(get_arch(name), remat_policy="offload"))
