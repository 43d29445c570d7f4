"""The port's MoE family against the JAX reference on the CPU: olmoe-1b-7b
and deepseek-moe-16b reduced (E = 4 experts, top-2, d 64; deepseek with 3
layers: its dense first layer, then 2 MoE layers with shared experts) on
the reference's own weights (`convert.lm_params_from_reference`, every
segment), numpy-seeded inputs through both packages.

* `capacity`, `_dispatch_positions`, `dispatch_decisions` and
  `ich_update_cap_scale`: element-identical to the reference's, and the
  decisions to the port's host planner `sched.moe.plan_dispatch`;
* `moe_local`, dropless and at capacity with the steal round, and
  `apply_moe` with shared experts: y within 2e-4 (`BRIDGE_TOL`, the bar
  of tests/test_torch_moe.py's bridge: a softmax router and einsum
  products on the reference's side, the scheduled op's plain version on
  the port's), the aux counts, dropped and stolen entries exactly;
* `prefill`, `decode_step`, the caches and `prefill_extend`: within 1e-4;
  decode at S == a fresh prefill of S + 1 within 2e-3
  (tests/test_arch_smoke.py's bar); the generated ids equal the
  reference `Engine`'s;
* inside the port: chunked prefill (chunks on multiples of TOKEN_BLOCK)
  bit-identical to one-shot prefill, a token's expert rows independent of
  how many tokens share its expert (one token alone, at 2,048 wide, is
  the trap: a float32 product's rows change bits with the call's row
  count), and `EngineBackend` giving each request the tokens it gets
  served alone.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_get_arch
from repro.configs import reduced as ref_reduced
from repro.models import model as RM
from repro.models import moe as RMOE
from repro.serve.engine import Engine as RefEngine
from repro.serve.engine import EngineConfig as RefEngineConfig
from repro_torch.configs import get_arch, reduced
from repro_torch.convert import lm_params_from_reference
from repro_torch.kernels.flash_attention import flash_attention as KF
from repro_torch.kernels.ich_moe import ich_moe as K
from repro_torch.models import model as M
from repro_torch.models import moe as MOE
from repro_torch.sched import LoopScheduler
from repro_torch.sched import moe as PM
from repro_torch.serve import Engine, EngineConfig
from repro_torch.serve import batcher as B
from repro_torch.serve import policies as P
from repro_torch.serve import queue as Q

TOL = 1e-4          # logits and caches against the reference
BRIDGE_TOL = 2e-4   # moe_local / apply_moe against the reference
DECODE_TOL = 2e-3   # decode at S against a fresh prefill of S + 1
ARCHS = ("olmoe-1b-7b", "deepseek-moe-16b")
LAYERS = {"olmoe-1b-7b": 2, "deepseek-moe-16b": 3}
ECFG = dict(max_seq=640, min_chunk=4)


@pytest.fixture(scope="module", params=ARCHS)
def moe(request):
    over = dict(n_layers=LAYERS[request.param])
    ref_cfg = ref_reduced(ref_get_arch(request.param), **over)
    cfg = reduced(get_arch(request.param), **over)
    tree = jax.tree.map(np.asarray, RM.init_params(ref_cfg,
                                                   jax.random.PRNGKey(0)))
    caps = jnp.ones((RM.n_moe_layers(ref_cfg), ref_cfg.n_experts))
    return (ref_cfg, cfg, jax.tree.map(jnp.asarray, tree), caps,
            lm_params_from_reference(cfg, tree, device="cpu"))


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(port, ref, tol=TOL):
    np.testing.assert_allclose(port.detach().numpy(),
                               np.asarray(ref, np.float32),
                               rtol=tol, atol=tol)


def _prompts(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S))


def _layer_params(model, ref_params, cfg, layer):
    """Layer `layer`'s MoE module of the port and its reference dict."""
    seg = layer - cfg.moe_layer_start
    return (model.layers[layer].moe,
            jax.tree.map(lambda a: a[seg], ref_params["segments"][-1]["moe"]))


# ----------------------------------------------------------- configs


@pytest.mark.parametrize("name", ARCHS)
def test_configs_equal_the_reference(name):
    assert dataclasses.asdict(get_arch(name)) == dataclasses.asdict(
        ref_get_arch(name))
    assert get_arch(name).param_count() == ref_get_arch(name).param_count()
    assert dataclasses.asdict(reduced(get_arch(name))) == \
        dataclasses.asdict(ref_reduced(ref_get_arch(name)))
    cfg = get_arch(name)
    assert [MOE.capacity(cfg, t, f) for t in (1, 7, 96, 8192)
            for f in (1.0, 1.25)] == [RMOE.capacity(cfg, t, f)
                                      for t in (1, 7, 96, 8192)
                                      for f in (1.0, 1.25)]


# ------------------------------------------------------ dispatch decisions


def _router(T, E, K_, seed, skew=1.5):
    rng = np.random.default_rng(seed)
    pop = np.arange(1, E + 1, dtype=np.float64) ** -skew
    logits = rng.gumbel(size=(T, E)) + 3.0 * np.log(pop)[None]
    e_topk = np.argsort(-logits, axis=1)[:, :K_].astype(np.int32)
    w = rng.random((T, K_)).astype(np.float32) + 0.1
    return e_topk, w / w.sum(1, keepdims=True)


def test_dispatch_positions_match_the_reference():
    ef = np.random.default_rng(0).integers(0, 6, 200).astype(np.int32)
    np.testing.assert_array_equal(
        MOE._dispatch_positions(_t(ef), 6).numpy(),
        np.asarray(RMOE._dispatch_positions(jnp.asarray(ef), 6)))


@pytest.mark.parametrize("steal", [True, False])
@pytest.mark.parametrize("T,E,K_,cap,seed", [
    (96, 4, 2, 40, 0), (120, 8, 2, 12, 1), (64, 16, 4, 9, 2),
    (50, 8, 2, 100, 3), (33, 64, 8, 5, 4)])
def test_dispatch_decisions_match_reference_and_planner(T, E, K_, cap, seed,
                                                        steal):
    e_topk, w = _router(T, E, K_, seed)
    cap_e = np.full(E, cap, np.int32)
    cap_e[::3] += 2                      # uneven capacities
    ours = MOE.dispatch_decisions(_t(e_topk), _t(cap_e), steal=steal)
    ref = RMOE.dispatch_decisions(jnp.asarray(e_topk), jnp.asarray(cap_e),
                                  steal=steal)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    plan = PM.plan_dispatch(e_topk, w, cap=cap_e, steal=steal)
    ef, tf, pos, keep, stolen = (a.numpy() for a in ours)
    np.testing.assert_array_equal(ef, plan.expert)
    np.testing.assert_array_equal(tf, plan.token)
    np.testing.assert_array_equal(pos, plan.pos)
    np.testing.assert_array_equal(keep, plan.keep)
    assert int(stolen) == plan.stolen and int((~keep).sum()) == plan.dropped
    # with the router demand given, the same decisions
    counts = torch.bincount(_t(e_topk).reshape(-1).long(),
                            minlength=E).float()
    again = MOE.dispatch_decisions(_t(e_topk), _t(cap_e), steal=steal,
                                   counts=counts)
    assert all(torch.equal(a, b) for a, b in zip(again, ours))


@pytest.mark.parametrize("E,seed", [(4, 0), (4, 1), (8, 2), (16, 3),
                                    (31, 4)])
def test_ich_update_cap_scale_matches_the_reference(E, seed):
    """Element-identical over several rounds, through the renormalisation
    (the scale total above the budget E) and the clip, to the reference
    compiled as its train step runs it (under jit XLA folds `cap_scale /
    step` into a product with step's float32 reciprocal; eager JAX
    divides)."""
    update = jax.jit(RMOE.ich_update_cap_scale)
    rng = np.random.default_rng(seed)
    scale = np.ones(E, np.float32)
    ref = jnp.asarray(scale)
    # round 0: more than half the experts above the band, so the grown
    # total exceeds the budget E and is renormalised
    hot = E // 2 + 1
    rounds = [np.r_[np.full(hot, 200.0), np.ones(E - hot)].astype(
        np.float32)]
    rounds += [rng.zipf(1.6, E).clip(max=300).astype(np.float32)
               for _ in range(6)]
    for counts in rounds:
        scale = MOE.ich_update_cap_scale(_t(counts), _t(scale)).numpy()
        ref = update(jnp.asarray(counts), ref)
        np.testing.assert_array_equal(scale, np.asarray(ref))
        if counts is rounds[0]:
            assert np.isclose(scale.sum(), E, rtol=1e-6) and scale[0] < 1.5
    assert scale.min() >= 0.25 and scale.max() <= 2.0


def test_ich_update_cap_scale_at_olmoe_width():
    """At E = 64 XLA sums the total in another order than the left fold:
    the scale agrees to the last bit of float32 (rtol 2 ulp)."""
    rng = np.random.default_rng(7)
    scale, ref = np.ones(64, np.float32), jnp.ones(64)
    for _ in range(6):
        counts = rng.zipf(1.4, 64).clip(max=400).astype(np.float32)
        scale = MOE.ich_update_cap_scale(_t(counts), _t(scale)).numpy()
        ref = RMOE.ich_update_cap_scale(jnp.asarray(counts), ref)
        np.testing.assert_allclose(scale, np.asarray(ref), rtol=2.4e-7,
                                   atol=0)
        ref = jnp.asarray(scale)


# ------------------------------------------------------------- the layer


def _bridge_cfg():
    return reduced(get_arch("olmoe-1b-7b"), n_experts=8, experts_per_token=2,
                   d_model=32, moe_d_ff=32), \
        ref_reduced(ref_get_arch("olmoe-1b-7b"), n_experts=8,
                    experts_per_token=2, d_model=32, moe_d_ff=32)


def _moe_module(cfg, tree):
    """The port's MoE module holding the reference dict's weights."""
    m = MOE.MoE(cfg, torch.Generator().manual_seed(0), device="cpu")
    m.load_state_dict({k: _t(v) for k, v in
                       (("router", tree["router"]), ("wi", tree["wi"]),
                        ("wg", tree["wg"]), ("wo", tree["wo"]))}
                      | {f"shared.{k}": _t(v) for k, v in
                         tree.get("shared", {}).items()})
    return m


@pytest.mark.parametrize("dropless", [True, False])
def test_moe_local_matches_the_reference(dropless):
    """Dropless, and at capacity (factor 1.0, one hot expert, uneven
    cap_scale) with the steal round: y within BRIDGE_TOL, the aux dict's
    counts, dropped and stolen exactly, its loss within 1e-6."""
    cfg, ref_cfg = _bridge_cfg()
    E, T = cfg.n_experts, 96
    tree = RMOE.init_moe(jax.random.PRNGKey(0), ref_cfg)
    tree["router"] = tree["router"].at[:, 0].add(2.0)   # skew the load
    tree = jax.tree.map(np.asarray, tree)
    x = np.random.default_rng(1).standard_normal((T, cfg.d_model)) \
        .astype(np.float32)
    cap_scale = np.linspace(0.6, 1.6, E).astype(np.float32)
    kw = dict(capacity_factor=1.0, dropless=dropless)
    y, aux = MOE.moe_local(cfg, _moe_module(cfg, tree), _t(x),
                           _t(cap_scale), **kw)
    r_y, r_aux = RMOE.moe_local(ref_cfg, jax.tree.map(jnp.asarray, tree),
                                jnp.asarray(x), jnp.asarray(cap_scale), **kw)
    _close(y, r_y, BRIDGE_TOL)
    for k in ("dropped", "stolen", "counts", "entries"):
        np.testing.assert_array_equal(aux[k].numpy(), np.asarray(r_aux[k]))
    _close(aux["aux_loss"], r_aux["aux_loss"], 1e-6)
    if dropless:
        assert float(aux["dropped"]) == float(aux["stolen"]) == 0
    else:
        assert float(aux["dropped"]) > 0 and float(aux["stolen"]) > 0


def test_apply_moe_with_shared_experts_matches_the_reference(moe):
    ref_cfg, cfg, ref_params, caps, model = moe
    layer = cfg.n_layers - 1
    p, r_p = _layer_params(model, ref_params, cfg, layer)
    assert hasattr(p, "shared") == bool(cfg.n_shared_experts)
    x = np.random.default_rng(2).standard_normal((2, 37, cfg.d_model)) \
        .astype(np.float32)
    for dropless in (True, False):
        y, aux = MOE.apply_moe(cfg, p, _t(x), _t(np.ones(cfg.n_experts)),
                               dropless=dropless)
        r_y, r_aux = RMOE.apply_moe(ref_cfg, r_p, jnp.asarray(x),
                                    jnp.ones(cfg.n_experts),
                                    dropless=dropless)
        _close(y, r_y, BRIDGE_TOL)
        for k in ("dropped", "stolen", "counts"):
            np.testing.assert_array_equal(aux[k].numpy(),
                                          np.asarray(r_aux[k]))


def _one_token_expert_case(D, F):
    """Expert 1 gets token 0 alone in the small pool (tokens 1 and 2 choose
    experts 0 and 2) and all 31 tokens in the large one; every token's
    other choice is expert 0."""
    rng = np.random.default_rng(9)
    E, T = 3, 31
    wi = (rng.standard_normal((E, D, F)) * D ** -0.5).astype(np.float32)
    wg = (rng.standard_normal((E, D, F)) * D ** -0.5).astype(np.float32)
    wo = (rng.standard_normal((E, F, D)) * F ** -0.5).astype(np.float32)
    x = rng.standard_normal((T, D)).astype(np.float32)
    e_large = np.tile(np.array([[0, 1]], np.int32), (T, 1))
    e_small = e_large[:3].copy()
    e_small[1:, 1] = 2
    w = np.full((T, 2), 0.5, np.float32)
    return x, (wi, wg, wo), e_small, e_large, w


@pytest.mark.parametrize("D,F", [(64, 64), (2048, 1024)])
def test_a_token_alone_on_its_expert_keeps_its_bits(D, F):
    """Regression: a token's y does not depend on how many tokens share
    its expert — one token alone (a one-row product), or 31 (at 2,048
    wide a float32 product's rows can change bits at some tens of
    rows)."""
    x, weights, e_small, e_large, w = _one_token_expert_case(D, F)
    T = e_large.shape[0]
    ys = []
    for e_topk, n in ((e_small, 3), (e_large, T)):
        plan = PM.plan_dispatch(e_topk, w[:n], cap=np.full(3, n, np.int32),
                                steal=False)
        assert plan.counts[1] == (1 if n == 3 else T)
        op = LoopScheduler(p=MOE.workers("cpu"), device="cpu",
                           cache_size=0).build("moe-dispatch", plan)
        ys.append(op(x[:n], *weights))
    assert torch.equal(ys[0][0], ys[1][0])
    # and the rows of one product call do not depend on their place in it
    xs = torch.from_numpy(x)
    rows = K.expert_rows(xs, *(torch.from_numpy(a[1]) for a in weights))
    one = K.expert_rows(xs[5:6], *(torch.from_numpy(a[1]) for a in weights))
    assert torch.equal(rows[5:6], one)


def test_moe_local_rows_do_not_depend_on_the_pool(moe):
    """Through the layer: the first 5 tokens, with their routing,
    dispatched alone give the bits they get among 300 (dropless), whatever
    the experts' token counts."""
    _, cfg, _, _, model = moe
    p = model.layers[cfg.n_layers - 1].moe
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (1, 300, cfg.d_model)).astype(np.float32))
    routing = MOE.route(p, x, cfg.experts_per_token)
    y_all, _ = MOE.moe_local(cfg, p, x[0], dropless=True, routing=routing)
    y_few, aux = MOE.moe_local(cfg, p, x[0, :5], dropless=True,
                               routing=tuple(r[:5] for r in routing))
    assert torch.equal(y_few, y_all[:5])
    assert (aux["counts"].numpy() <= 5).all()


# ------------------------------------------------------------- the model


def test_prefill_and_decode_match_the_reference(moe):
    ref_cfg, cfg, ref_params, caps, model = moe
    toks = _prompts(cfg, 2, 21, seed=1)
    logits, cache = M.prefill(cfg, model, {"tokens": _t(toks[:, :20])})
    r_logits, r_cache = RM.prefill(ref_cfg, ref_params,
                                   {"tokens": jnp.asarray(toks[:, :20])},
                                   caps, dtype=jnp.float32)
    _close(logits, r_logits)
    segs = M.segments_of(cfg)
    assert len(cache) == len(r_cache) == len(segs)
    for seg, r_seg, (_, count) in zip(cache, r_cache, segs):
        for name in ("k", "v"):
            assert tuple(seg[name].shape) == (count, 2, 20, cfg.n_kv_heads,
                                              cfg.dh)
            _close(seg[name], r_seg[name])
    pad = [{n: torch.nn.functional.pad(t, (0, 0, 0, 0, 0, 12))
            for n, t in seg.items()} for seg in cache]
    r_pad = [{n: jnp.pad(t, ((0, 0), (0, 0), (0, 12), (0, 0), (0, 0)))
              for n, t in seg.items()} for seg in r_cache]
    d_logits, d_cache = M.decode_step(cfg, model, _t(toks[:, 20:]), pad, 20,
                                      caps)
    r_d, r_dc = RM.decode_step(ref_cfg, ref_params, jnp.asarray(toks[:, 20:]),
                               r_pad, 20, caps, dtype=jnp.float32)
    _close(d_logits, r_d)
    assert d_cache[-1]["k"] is pad[-1]["k"]       # written in place
    for seg, r_seg in zip(d_cache, r_dc):
        for name in ("k", "v"):
            _close(seg[name], r_seg[name])
    # decode at S matches a fresh prefill of S + 1 (test_arch_smoke's bar)
    full, _ = M.prefill(cfg, model, {"tokens": _t(toks)})
    torch.testing.assert_close(d_logits, full, rtol=DECODE_TOL,
                               atol=DECODE_TOL)
    assert [{n: (tuple(t.shape), t.dtype) for n, t in seg.items()}
            for seg in d_cache] == M.cache_specs(cfg, 2, 32)
    assert KF.LAUNCHES == {"flash_attention": 0}
    assert K.LAUNCHES == {"ich_moe_sharded": 0}


def test_decode_matches_a_fresh_prefill_as_in_arch_smoke():
    """tests/test_arch_smoke.py's olmoe case on the port: the reference's
    reduced config and weights, B = 2, S = 12, decode at position 12
    against caches of 64 positions == prefill of 13 tokens."""
    ref_cfg = ref_reduced(ref_get_arch("olmoe-1b-7b"))
    cfg = reduced(get_arch("olmoe-1b-7b"))
    tree = jax.tree.map(np.asarray, RM.init_params(
        ref_cfg, jax.random.PRNGKey(1), max_seq=64))
    model = lm_params_from_reference(cfg, tree, device="cpu")
    toks = np.asarray(jax.random.randint(jax.random.PRNGKey(2), (2, 13), 0,
                                         cfg.vocab_size))
    full, _ = M.prefill(cfg, model, {"tokens": _t(toks)})
    _, cache = M.prefill(cfg, model, {"tokens": _t(toks[:, :12])})
    pad = [{n: torch.nn.functional.pad(t, (0, 0, 0, 0, 0, 52))
            for n, t in seg.items()} for seg in cache]
    d_logits, _ = M.decode_step(cfg, model, _t(toks[:, 12:]), pad, 12)
    np.testing.assert_allclose(d_logits.numpy(), full.numpy(),
                               rtol=DECODE_TOL, atol=DECODE_TOL)


def test_generate_ids_equal_the_reference(moe):
    ref_cfg, cfg, ref_params, _, model = moe
    prompts = _prompts(cfg, 2, 600, seed=2)
    eng = Engine(cfg, model, EngineConfig(**ECFG), device="cpu")
    ids, stats = eng.generate(prompts, n_new=8)
    r_ids, _ = RefEngine(ref_cfg, ref_params, RefEngineConfig(
        **ECFG)).generate(prompts, n_new=8)
    np.testing.assert_array_equal(ids, np.asarray(r_ids))
    sizes = [c["chunk"] for c in stats["chunks"]]
    assert eng.n_prefill_fallbacks == 0 and sum(sizes) == 600
    assert len(sizes) > 1 and all(c % M.TOKEN_BLOCK == 0
                                  for c in sizes[:-1])


@pytest.mark.parametrize("cuts", [(256,), (256, 512), (512,), ()])
def test_prefill_extend_equals_one_shot(moe, cuts):
    """Chunked at multiples of the token block (256): the last logits and
    every segment's cache equal the port's one-shot prefill bit for bit,
    and the reference's prefill_extend over the same chunks within
    1e-4."""
    ref_cfg, cfg, ref_params, caps, model = moe
    S = 600
    toks = _prompts(cfg, 2, S, seed=3)
    bounds = (0, *cuts, S)
    cache = M.empty_extend_cache(cfg, 2, S, device="cpu")
    r_cache = RM.empty_extend_cache(ref_cfg, 2, S, dtype=jnp.float32)
    for a, b in zip(bounds, bounds[1:]):
        logits, cache = M.prefill_extend(cfg, model, _t(toks[:, a:b]),
                                         cache, a, caps)
        r_logits, r_cache = RM.prefill_extend(
            ref_cfg, ref_params, jnp.asarray(toks[:, a:b]), r_cache, a,
            caps, dtype=jnp.float32)
    one, one_cache = M.prefill(cfg, model, {"tokens": _t(toks)})
    assert torch.equal(logits, one)
    for seg, one_seg, r_seg in zip(cache, one_cache, r_cache):
        for name in ("k", "v"):
            assert torch.equal(seg[name], one_seg[name])
            _close(seg[name], r_seg[name])
    _close(logits, r_logits)


def test_engine_prefill_chunked_equals_one_shot(moe):
    _, cfg, _, _, model = moe
    prompts = _prompts(cfg, 2, 700, seed=4)
    eng = Engine(cfg, model, EngineConfig(max_seq=768, min_chunk=4,
                                          init_divisor=6.0), device="cpu")
    logits, cache, log = eng.prefill_chunked(prompts)
    assert [c["chunk"] for c in log] == [256, 256, 188]
    one, one_cache = M.prefill(cfg, model, {"tokens": _t(prompts)})
    assert torch.equal(logits, one)
    assert all(torch.equal(seg[n], one_seg[n])
               for seg, one_seg in zip(cache, one_cache) for n in "kv")
    grown = eng._pad_cache(cache)
    assert all(seg["k"].shape[2] == 768 for seg in grown)
    assert not grown[-1]["v"][:, :, 700:].any()


def test_converter_carries_every_segment(moe):
    ref_cfg, cfg, ref_params, _, model = moe
    tree = jax.tree.map(np.asarray, ref_params)
    state = model.state_dict()
    first = 0
    for seg, (kind, count) in zip(tree["segments"], M.segments_of(cfg)):
        leaves = jax.tree_util.tree_leaves_with_path(seg)
        for path, arr in leaves:
            name = ".".join(str(getattr(k, "key", k)) for k in path)
            back = np.stack([state[f"layers.{first + i}.{name}"].numpy()
                             for i in range(count)])
            np.testing.assert_array_equal(back, arr)
        first += count
    assert first == cfg.n_layers
    if cfg.moe_layer_start:
        assert "layers.0.mlp.wi" in state and "layers.0.moe.wi" not in state
        assert state["layers.0.mlp.wi"].shape[1] == cfg.dense_d_ff
    if cfg.n_shared_experts:
        assert state[f"layers.{cfg.n_layers - 1}.moe.shared.wi"].shape[1] \
            == cfg.n_shared_experts * cfg.moe_d_ff
    bad = jax.tree.map(lambda a: a, tree)
    bad["segments"][-1]["moe"]["wi"] = tree["segments"][-1]["moe"]["wi"][:1]
    with pytest.raises(ValueError, match="layer count"):
        lm_params_from_reference(cfg, bad, device="cpu")


def test_engine_backend_tokens_equal_each_request_served_alone():
    """Three olmoe requests interleaved through the continuous batcher on
    the real engine: each request's tokens are the ones it gets served
    alone through `Engine.generate`."""
    ref_cfg = ref_reduced(ref_get_arch("olmoe-1b-7b"))
    cfg = reduced(get_arch("olmoe-1b-7b"))
    tree = jax.tree.map(np.asarray, RM.init_params(ref_cfg,
                                                   jax.random.PRNGKey(3)))
    model = lm_params_from_reference(cfg, tree, device="cpu")
    rng = np.random.default_rng(5)
    toks = [rng.integers(0, cfg.vocab_size, (1, s), dtype=np.int64)
            for s in (600, 300, 420)]
    eng = Engine(cfg, model, EngineConfig(**ECFG), device="cpu")
    b = B.ContinuousBatcher(P.RoundRobin(chunk=256, min_chunk=4),
                            queue=Q.AdmissionQueue(max_running=4),
                            backend=B.EngineBackend(eng), clock=B.SimClock())
    sts = [b.submit(Q.Request(req_id=i, tokens=t, n_new=6, t_arrival=0.0))
           for i, t in enumerate(toks)]
    while b.step():
        pass
    assert all(len(st.chunk_log) > 1 for st in sts)
    alone = Engine(cfg, model, EngineConfig(**ECFG), device="cpu")
    for st, t in zip(sts, toks):
        ids, _ = alone.generate(t, n_new=6)
        assert st.out_tokens == ids[0].tolist()
    assert eng.n_prefill_fallbacks == 0 and b.metrics.n_prefill_fallback == 0


def test_family_checks():
    cfg = reduced(get_arch("olmoe-1b-7b"))
    assert M.extend_cache_specs_ok(cfg)
    with pytest.raises(NotImplementedError, match="later slice"):
        M.init_params(dataclasses.replace(cfg, moe=False), device="cpu")
    with pytest.raises(NotImplementedError, match="later slice"):
        M.init_params(dataclasses.replace(reduced(get_arch("qwen2-1.5b")),
                                          moe=True), device="cpu")
    eng = Engine(cfg, M.init_params(cfg, 0, device="cpu"),
                 EngineConfig(max_seq=16), device="cpu")
    with pytest.raises(ValueError, match="exceeds the attention cache"):
        eng.generate(np.zeros((1, 12), np.int64), n_new=8)
    assert eng._chunk_q(1000) == M.TOKEN_BLOCK and eng._chunk_q(40) == 40
