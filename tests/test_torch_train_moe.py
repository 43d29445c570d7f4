"""The port's training path for the moe family (olmoe-1b-7b; deepseek-moe-16b
with its dense first layer and shared experts) against the JAX reference
on the CPU: `moe_local` at capacity and its VJP against `jax.vjp` of the
reference's, the expert FFN's backward (the kernel's plain version)
against the autograd of `kernels/ich_moe/ref.py:moe_dispatch_ref`, bit for
bit across lowerings and calls, `loss_fn` and every gradient leaf against
`jax.value_and_grad(repro.models.model.loss_fn)` with the capacity scales,
remat off and on, "dots" against "nothing", the aux metrics and counts,
the bfloat16 loss, `make_train_step` from
`convert.train_state_from_reference` (plain, with gradient compression,
with a microbatch split) against the reference's step, the capacity
scales' update included, `train()` with a failure and a resume, the
grouping of the unstacked layers by reference leaf, AdamW's weight decay
by the reference leaf's rank, the converter, and `check_trainable`.

The cases: `reduced()` of each config with 8 experts top-2 (under 32, so
that `ich_update_cap_scale`'s left-fold total is the reference's bits:
ROADMAP.md queue 3 caveat 8), 2 layers (deepseek: its "densffn" layer,
then one MoE layer with shared experts), 2 x 48 tokens: C_base = 30 an
expert against a demand of ~24, and capacity scales drawn in [0.3, 2],
not ones, so the capacity cut drops entries and the steal round steals
some in every case (asserted): the gradients of dropped and stolen
entries are exercised. The reference's weights come from its
`init_params` with every constant vector (the norms' scales) redrawn
from a seed.

Tolerances (tests/test_torch_train.py's, with their reasons): loss
within 1e-5 relative, every gradient within 1e-4 of its leaf's largest
reference gradient (float32 on both sides, other summation orders);
bfloat16 loss within 2e-2 (the port runs the expert products in float32,
the reference in bfloat16); a step's loss and grad norm within 1e-4
relative; dispatch decisions, counts, dropped and stolen entries and the
new capacity scales exactly; "dots", the lowerings and the resumed
trainer bit for bit (one process on the CPU)."""
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
from repro.models import moe as RMOE
from repro.optim import adamw as RADAM
from repro.train import train_step as RTS
from repro_torch.configs import get_arch, reduced
from repro_torch.convert import (_by_name, lm_params_from_reference,
                                 train_state_from_reference)
from repro_torch.core.workloads import moe_router
from repro_torch.kernels.ich_moe import ich_moe_bwd as KB
from repro_torch.kernels.ich_moe.ich_moe import token_slots
from repro_torch.kernels.ich_moe.ref import moe_dispatch_backward_ref
from repro_torch.models import model as M
from repro_torch.models import moe as MOE
from repro_torch.optim import adamw
from repro_torch.sched import LoopScheduler, plan_dispatch
from repro_torch.train import checkpoint as CKPT
from repro_torch.train import train_step as TS
from repro_torch.train.trainer import InjectedFailure, RunConfig, train

B, S = 2, 48
EXPERTS = dict(n_experts=8, experts_per_token=2)
CASES = {"olmoe": "olmoe-1b-7b", "deepseek": "deepseek-moe-16b"}


def _remat(remat) -> dict:
    policy = remat if isinstance(remat, str) else "nothing"
    return {"remat": bool(remat), "remat_policy": policy}


def _cfgs(case, remat=False):
    over = {**EXPERTS, **_remat(remat)}
    name = CASES[case]
    return (ref_reduced(ref_get_arch(name), **over),
            reduced(get_arch(name), **over))


@functools.lru_cache(maxsize=None)
def _tree_of(case):
    ref_cfg, _ = _cfgs(case)
    params = jax.tree.map(np.asarray, RM.init_params(
        ref_cfg, jax.random.PRNGKey(3), max_seq=64))
    rng = np.random.default_rng(11)

    def redraw(a):   # a constant vector or stack of them: ones -> 1 + noise
        if a.ndim > 2 or not np.all(a == a.flat[0]):
            return a
        noise = rng.standard_normal(a.shape).astype(np.float32)
        return (a + 0.1 * noise).astype(a.dtype)
    return jax.tree.map(redraw, params)


def _tree(case):
    return jax.tree.map(np.copy, _tree_of(case))


def _caps(cfg, seed=5):
    rng = np.random.default_rng(seed)
    return rng.uniform(0.3, 2.0, (M.n_moe_layers(cfg), cfg.n_experts)
                       ).astype(np.float32)


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


def _close_to(port, ref, what, tol=1e-4):
    ref = np.asarray(ref, np.float32)
    scale = float(np.abs(ref).max())
    assert scale > 0, what                    # every leaf takes a part
    np.testing.assert_allclose(np.asarray(port, np.float32), ref, rtol=0,
                               atol=tol * scale, err_msg=what)


@functools.lru_cache(maxsize=None)
def _ref_loss_and_grad_tree(case, remat, seed=1):
    """The reference's float32 loss, metrics and gradient tree (numpy) of
    `case` on `_tree`'s weights, batch `seed` and `_caps`: one JAX
    compile a case."""
    ref_cfg, cfg = _cfgs(case, remat)
    params = jax.tree.map(jnp.asarray, _tree(case))
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p: RM.loss_fn(ref_cfg, p, _j(_batch(cfg, seed)),
                             jnp.asarray(_caps(cfg)), dtype=jnp.float32),
        has_aux=True))(params)
    return (float(loss), jax.tree.map(np.asarray, metrics),
            jax.tree.map(np.asarray, grads))


def _model(case, remat=False):
    _, cfg = _cfgs(case, remat)
    model = lm_params_from_reference(cfg, _tree(case), device="cpu")
    return cfg, model.requires_grad_(True)


def _port_loss_and_grads(case, remat, seed=1):
    cfg, model = _model(case, remat)
    loss, metrics = M.loss_fn(cfg, model, _t(_batch(cfg, seed)),
                              torch.from_numpy(_caps(cfg)),
                              dtype=torch.float32)
    grads = torch.autograd.grad(loss, list(model.parameters()))
    metrics = {k: v.detach() for k, v in metrics.items()}
    return loss.detach(), metrics, {n: g for (n, _), g in
                                    zip(model.named_parameters(), grads)}


# ------------------------------------------------------- the capacity cut
@pytest.mark.parametrize("case", sorted(CASES))
def test_the_capacity_cut_drops_and_steals(case):
    """The cases are built so that entries are dropped and stolen, in the
    reference and identically in the port."""
    _, r_metrics, _ = _ref_loss_and_grad_tree(case, False)
    _, metrics, _ = _port_loss_and_grads(case, False)
    assert float(r_metrics["dropped"]) > 0 and float(r_metrics["stolen"]) > 0
    for key in ("dropped", "stolen", "entries"):
        assert float(metrics[key]) == float(r_metrics[key]), key


# --------------------------------------------------- the module on its own
def _moe_module(cfg, seed):
    rng = np.random.default_rng(seed)
    E, D, F = cfg.n_experts, cfg.d_model, cfg.moe_d_ff
    p = {"router": rng.standard_normal((D, E)) * D ** -0.5,
         "wi": rng.standard_normal((E, D, F)) * D ** -0.5,
         "wg": rng.standard_normal((E, D, F)) * D ** -0.5,
         "wo": rng.standard_normal((E, F, D)) * F ** -0.5}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    mod = MOE.MoE(cfg, torch.Generator().manual_seed(0), "cpu")
    for k, v in p.items():
        getattr(mod, k).data = torch.from_numpy(v.copy())
    return p, mod.requires_grad_(True)


@pytest.mark.parametrize("steal", [True, False])
def test_moe_local_and_its_vjp_match_the_reference(steal):
    """`moe_local` at capacity (drawn scales): y, the aux loss, dropped
    and stolen entries and the counts; then its VJP with cotangents on y
    and the aux loss: dx, d router (through the combine weights, the
    top-K renormalisation and the aux loss), dwi, dwg and dwo against
    `jax.vjp` of the reference's."""
    ref_cfg, cfg = _cfgs("olmoe")
    T = 96
    rng = np.random.default_rng(7)
    x = rng.standard_normal((T, cfg.d_model)).astype(np.float32)
    dy = rng.standard_normal((T, cfg.d_model)).astype(np.float32)
    daux = np.float32(0.7)
    # scales under 1: the router's near-uniform demand overflows
    cap = np.random.default_rng(9).uniform(0.25, 1.0, cfg.n_experts
                                           ).astype(np.float32)
    p, mod = _moe_module(cfg, seed=8)

    def ref_fn(xx, pp):
        y, aux = RMOE.moe_local(ref_cfg, pp, xx, jnp.asarray(cap),
                                steal=steal)
        return y, aux["aux_loss"]
    (y_r, aux_r), vjp = jax.vjp(ref_fn, jnp.asarray(x),
                                jax.tree.map(jnp.asarray, p))
    dx_r, dp_r = vjp((jnp.asarray(dy), jnp.asarray(daux)))
    _, r_aux = RMOE.moe_local(ref_cfg, jax.tree.map(jnp.asarray, p),
                              jnp.asarray(x), jnp.asarray(cap), steal=steal)

    xt = torch.from_numpy(x).requires_grad_(True)
    y, aux = MOE.moe_local(cfg, mod, xt, torch.from_numpy(cap), steal=steal)
    assert float(aux["dropped"]) == float(r_aux["dropped"]) > 0
    assert float(aux["stolen"]) == float(r_aux["stolen"])
    assert (float(aux["stolen"]) > 0) == steal
    np.testing.assert_array_equal(aux["counts"].numpy(),
                                  np.asarray(r_aux["counts"]))
    _close_to(y.detach(), y_r, "y")
    np.testing.assert_allclose(float(aux["aux_loss"].detach()), float(aux_r),
                               rtol=1e-5)
    grads = torch.autograd.grad(
        (y, aux["aux_loss"]), [xt, mod.router, mod.wi, mod.wg, mod.wo],
        (torch.from_numpy(dy), torch.tensor(daux)))
    _close_to(grads[0], dx_r, "dx")
    for name, g in zip(("router", "wi", "wg", "wo"), grads[1:]):
        _close_to(g, dp_r[name], f"d{name}")


# ------------------------------------------------ the kernel's plain version
def _plan_case(T=300, E=8, K=2, D=40, F=24, seed=3):
    """A skewed router over E experts with one expert never chosen, drawn
    capacity scales (drops and steals), and seeded float32 tensors."""
    e_topk, w = moe_router(T, E - 1, K, seed=seed, skew=1.2)
    rng = np.random.default_rng(seed)
    plan = plan_dispatch(e_topk, w, cap=np.round(
        rng.uniform(0.3, 2.0, E) * T * K / E).astype(np.int32))
    assert plan.dropped > 0 and plan.stolen > 0

    def randn(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale)
                                .astype(np.float32))
    x, dy = randn(T, D), randn(T, D)
    wi, wg = randn(E, D, F, scale=D ** -0.5), randn(E, D, F, scale=D ** -0.5)
    wo = randn(E, F, D, scale=F ** -0.5)
    return plan, x, dy, wi, wg, wo, torch.from_numpy(w)


def _backward_of(op, plan, x, dy, wi, wg, wo, w_topk):
    """The gradients of (x, w_topk, wi, wg, wo) through `MoeExpertsFn`
    over `op`."""
    leaves = [t.clone().requires_grad_(True) for t in (x, w_topk, wi, wg,
                                                       wo)]
    indptr, entry = plan.csr_entries()
    y = MOE.MoeExpertsFn.apply(*leaves, op, torch.from_numpy(entry),
                               torch.from_numpy(indptr.astype(np.int32)))
    return torch.autograd.grad(y, leaves, dy)


def test_backward_plain_version_matches_the_autograd_oracle():
    """`ich_moe_backward` on CPU tensors (its plain version) against the
    autograd of `moe_dispatch_ref` over the same CSR: every output within
    1e-5 of its largest value; the expert with no kept slot gets exact
    zeros."""
    plan, x, dy, wi, wg, wo, _ = _plan_case()
    indptr, tok, w = plan.csr()
    tok_ptr, tok_slot = (torch.from_numpy(a)
                         for a in token_slots(tok, plan.n_tokens))
    KB.reset_launches()
    got = KB.ich_moe_backward(
        x, dy, wi, wg, wo, torch.from_numpy(indptr.astype(np.int32)),
        torch.from_numpy(tok), torch.from_numpy(w), tok_ptr, tok_slot)
    assert KB.LAUNCHES == {"ich_moe_bwd": 0}      # the CPU ran plain
    want = moe_dispatch_backward_ref(indptr, tok, w, x, wi, wg, wo, dy)
    for name, a, b in zip(("dx", "dwi", "dwg", "dwo", "dw"), got, want):
        _close_to(a, b, name, tol=1e-5)
    assert plan.counts[-1] == 0
    for g in got[1:4]:
        assert torch.equal(g[-1], torch.zeros_like(g[-1]))


def test_backward_is_the_same_bits_across_lowerings_and_calls():
    """Through `MoeExpertsFn`: the gradients over p in {1, 2, 4} x B in
    {1, 4} are one set of bits, and a second call gives them again; the
    plan's combine weights, which the forward's kernel reads, are the
    router's tensor's values at the entry map; a dropped entry's weight
    gets a zero gradient, a kept one's its slot's."""
    plan, x, dy, wi, wg, wo, w_topk = _plan_case()
    _, entry = plan.csr_entries()
    assert np.array_equal(plan.csr()[2], w_topk.reshape(-1).numpy()[entry])
    first = None
    for p in (1, 2, 4):
        for B_ in (1, 4):
            op = LoopScheduler(p=p, superstep=B_, rows_per_tile=2,
                               cache_size=0, device="cpu").build(
                                   "moe-dispatch", plan, width=32)
            grads = _backward_of(op, plan, x, dy, wi, wg, wo, w_topk)
            if first is None:
                first = grads
                again = _backward_of(op, plan, x, dy, wi, wg, wo, w_topk)
                assert all(torch.equal(a, b) for a, b in zip(grads, again))
            assert all(torch.equal(a, b) for a, b in zip(grads, first)), \
                (p, B_)
    dw = first[1].reshape(-1).numpy()
    assert not dw[~plan.keep].any() and dw[plan.keep].any()


# ------------------------------------------------------------- loss_fn
@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_gradients_match_the_reference(case, remat):
    """Every leaf (the routers, experts and, for deepseek, the dense first
    layer's MLP and the shared experts among them), the loss with the aux
    term, the aux metrics, and the counts exactly."""
    _, cfg = _cfgs(case, remat)
    batch = _batch(cfg, seed=1)
    loss, metrics, grads = _port_loss_and_grads(case, remat)
    r_loss, r_metrics, r_tree = _ref_loss_and_grad_tree(case, remat)
    r_grads = _by_name(r_tree)
    assert int(metrics["n_tokens"]) == int((batch["labels"] >= 0).sum())
    np.testing.assert_allclose(loss.item(), r_loss, rtol=1e-5)
    for key in ("loss", "aux_loss"):
        np.testing.assert_allclose(float(metrics[key]),
                                   float(r_metrics[key]), rtol=1e-5)
    for key in ("dropped", "stolen", "entries"):
        assert float(metrics[key]) == float(r_metrics[key]), key
    np.testing.assert_array_equal(metrics["counts"].numpy(),
                                  r_metrics["counts"])
    assert set(grads) == set(r_grads)
    for n, g in grads.items():
        _close_to(g, r_grads[n], n)


@pytest.mark.parametrize("case", sorted(CASES))
def test_remat_dots_gives_the_bits_of_nothing(case):
    loss, metrics, grads = _port_loss_and_grads(case, "dots")
    n_loss, n_metrics, n_grads = _port_loss_and_grads(case, True)
    assert torch.equal(loss, n_loss)
    assert torch.equal(metrics["counts"], n_metrics["counts"])
    for n, g in grads.items():
        assert torch.equal(g, n_grads[n]), n


@pytest.mark.parametrize("case", sorted(CASES))
def test_bfloat16_loss_matches_the_reference(case):
    ref_cfg, cfg = _cfgs(case)
    tree = _tree(case)
    batch = _batch(cfg, seed=2)
    caps = _caps(cfg)
    model = lm_params_from_reference(cfg, tree, device="cpu")
    loss, _ = M.loss_fn(cfg, model, _t(batch), torch.from_numpy(caps),
                        dtype=torch.bfloat16)
    r_loss = RM.loss_fn(ref_cfg, jax.tree.map(jnp.asarray, tree),
                        _j(batch), jnp.asarray(caps),
                        dtype=jnp.bfloat16)[0]
    np.testing.assert_allclose(float(loss), float(r_loss), rtol=2e-2)


# ------------------------------------------------------ make_train_step
def _reference_state(case, r_tcfg):
    ref_cfg, cfg = _cfgs(case)
    r_state = RTS.init_train_state(ref_cfg, jax.random.PRNGKey(0), 64,
                                   r_tcfg)
    r_state["params"] = jax.tree.map(jnp.asarray, _tree(case))
    r_state["cap_scales"] = jnp.asarray(_caps(cfg))
    return r_state


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("option", ["plain", "grad_compress", "microbatch"])
def test_train_step_matches_the_reference(case, option):
    """Two steps from the converted reference state (drawn capacity
    scales): loss and grad norm, and the new capacity scales exactly
    (`ich_update_cap_scale` of each MoE layer's counts: under a
    microbatch split of 2 the last microbatch's); plain, with int8
    gradient compression (blocks cut per reference leaf), and with
    microbatch = 2."""
    over = {"plain": {}, "grad_compress": {"grad_compress": True},
            "microbatch": {"microbatch": 2}}[option]
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
        batch = _batch(cfg, seed=10 + i)
        before = state["cap_scales"].clone()
        r_state, r_m = r_step(r_state, _j(batch))
        state, m = step(state, _t(batch))
        for key in ("loss", "grad_norm", "aux_loss"):
            np.testing.assert_allclose(float(m[key]), float(r_m[key]),
                                       rtol=1e-4, err_msg=f"{key} step {i}")
        for key in ("dropped", "stolen", "entries", "n_tokens"):
            assert float(m[key]) == float(r_m[key]), (key, i)
        assert "counts" not in m and "counts" not in r_m
        np.testing.assert_array_equal(state["cap_scales"].numpy(),
                                      np.asarray(r_state["cap_scales"]))
        assert not torch.equal(state["cap_scales"], before)


# ------------------------------------------------ trainer, leaves, converter
def test_trainer_resumes_olmoe_bit_for_bit(tmp_path):
    """train() on the reduced olmoe: a failure after step 2, a resume from
    its checkpoint, and the resumed losses and final state (the capacity
    scales included, which the balancer moved) equal an uninterrupted
    run's bit for bit; the loss falls."""
    _, cfg = _cfgs("olmoe")
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
    assert not torch.equal(state["cap_scales"],
                           torch.ones_like(state["cap_scales"]))
    for (n, a), (_, b) in zip(CKPT.state_leaves(state),
                              CKPT.state_leaves(fresh_state)):
        assert torch.equal(a, b), n


@pytest.mark.parametrize("case", sorted(CASES))
def test_weight_decay_and_compression_groups_follow_the_reference(case):
    """The reference stacks each segment's layers (deepseek: "densffn",
    then "moe"): `segments.<s>.moe.wi` is (L_s, E, d, F). Each port
    parameter's reference rank is its leaf's (`reference_ndim`), the
    layers of a segment form one group of `reference_leaves` in layer
    order, and AdamW decays exactly the parameters the reference decays
    (every stacked leaf, the norms' scales too; not the final norm)."""
    ref_cfg, cfg = _cfgs(case)
    tree = _tree(case)
    leaves = _by_name(tree)
    model = lm_params_from_reference(cfg, tree, device="cpu")
    names = [n for n, _ in model.named_parameters()]
    for n, p in model.named_parameters():
        assert M.reference_ndim(n, p.ndim) == np.ndim(
            _reference_leaf(cfg, tree, n)), n
    groups = {tuple(g) for g in M.reference_leaves(cfg, names)}
    moe_layers = [i for i in range(cfg.n_layers) if i >= cfg.moe_layer_start]
    for leaf in ("moe.wi", "moe.wg", "moe.wo", "moe.router"):
        assert tuple(f"layers.{i}.{leaf}" for i in moe_layers) in groups
    if cfg.n_shared_experts:
        assert ("layers.1.moe.shared.wi",) in groups
        assert ("layers.0.mlp.wi",) in groups
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
    assert {f"layers.{moe_layers[0]}.moe.wi",
            f"layers.{moe_layers[0]}.moe.router",
            "layers.0.ln1.scale"} <= moved
    assert "final_norm.scale" not in moved


def _reference_leaf(cfg, tree, name: str):
    """The reference leaf that the port's parameter `name` comes from:
    `layers.<l>.<rest>` is `segments.<s>.<rest>`, stacked over segment
    s's layers; any other name is its own path."""
    head, *rest = name.split(".")
    path = [head, *rest]
    if head == "layers":
        path = ["segments", M._layer_slots(cfg)[int(rest[0])][0], *rest[1:]]
    node = tree
    for part in path:
        node = node[part]
    return node


@pytest.mark.parametrize("case", sorted(CASES))
def test_train_state_from_reference_carries_every_leaf(case):
    """The reference's state with a bfloat16 master and residuals: every
    parameter of every segment (the dense first layer's MLP and the
    shared experts for deepseek), master, residual, the step and the
    capacity scales."""
    ref_cfg, cfg = _cfgs(case)
    r_tcfg = RTS.TrainConfig(bf16_params=True, grad_compress=True)
    r_state = jax.tree.map(np.asarray, RTS.init_train_state(
        ref_cfg, jax.random.PRNGKey(3), 64, r_tcfg))
    r_state["cap_scales"] = _caps(cfg)
    state = train_state_from_reference(cfg, r_state, device="cpu")
    params = _by_name(r_state["params"])
    names = {n for n, _ in state["params"].named_parameters()}
    assert names == set(params)
    assert {"layers.1.moe.wi", "layers.1.moe.router"} <= names
    if cfg.n_shared_experts:
        assert {"layers.0.mlp.wi", "layers.1.moe.shared.wo"} <= names
    for n, p in state["params"].named_parameters():
        assert p.dtype == torch.bfloat16 and p.requires_grad
        np.testing.assert_array_equal(p.detach().float().numpy(),
                                      params[n].astype(np.float32))
    master = _by_name(r_state["opt"]["master"])
    for n, t in state["opt"]["master"].items():
        np.testing.assert_array_equal(t.numpy(), master[n])
    assert set(state["grad_err"]) == set(params)
    assert int(state["opt"]["step"]) == 0
    np.testing.assert_array_equal(state["cap_scales"].numpy(),
                                  r_state["cap_scales"])


@pytest.mark.parametrize("name", sorted(CASES.values()))
def test_check_trainable_admits_moe(name):
    for policy in M.REMAT_POLICIES:
        M.check_trainable(reduced(get_arch(name), remat=True,
                                  remat_policy=policy))
        TS.make_train_step(reduced(get_arch(name), remat_policy=policy))
    with pytest.raises(ValueError, match="remat_policy"):
        M.check_trainable(reduced(get_arch(name), remat_policy="offload"))
