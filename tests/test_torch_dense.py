"""The port's dense family against the JAX reference on the CPU: the four
dense configurations (qwen2-1.5b, olmo-1b, glm4-9b, phi3-medium-14b)
reduced, plus qwen2 with layernorm and GELU, their `prefill`,
`decode_step`, `Engine.generate` and incremental `prefill_extend` on the
reference's own weights (`convert.lm_params_from_reference`, qkv biases
drawn at random: the reference initializes them to zeros, which would
leave the bias path untested), and the flash kernel's plain version from
a query offset.

`reduced` gives dh 16 (the plain versions take any width; the card tests
in tests/test_torch_cuda.py widen to dh 128).

Tolerances: logits and caches within 1e-4 (float32 on both sides, summed
in other orders); generated ids equal; the port's chunked prefill equal
to its one-shot prefill bit for bit (its token-wise parts run per block
of TOKEN_BLOCK = 256 tokens and the engine's chunks are multiples of it,
so the prompts that chunk are longer than 256 tokens);
flash from an offset within 2e-5, the reference's kernel tolerance
(tests/test_kernels.py:23-24)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_get_arch
from repro.configs import reduced as ref_reduced
from repro.models import attention as RA
from repro.models import layers as RL
from repro.models import model as RM
from repro.serve.engine import Engine as RefEngine
from repro.serve.engine import EngineConfig as RefEngineConfig
from repro_torch.configs import get_arch, reduced
from repro_torch.convert import lm_params_from_reference
from repro_torch.kernels.flash_attention import flash_attention as KF
from repro_torch.models import model as M
from repro_torch.serve import Engine, EngineConfig

TOL = 1e-4
DENSE = ("qwen2-1.5b", "olmo-1b", "glm4-9b", "phi3-medium-14b")
# the four configurations reduced, and qwen2 with the norm and the MLP no
# dense configuration of the repo uses (layernorm's scale and bias, GELU)
CASES = {name: (name, {}) for name in DENSE}
CASES["qwen2-layernorm-gelu"] = ("qwen2-1.5b", dict(norm="layernorm",
                                                    act="gelu"))
ECFG = dict(max_seq=640, min_chunk=4)


def _tree(ref_cfg, seed=0):
    """The reference's parameters as numpy, biases and layernorm's affine
    drawn from a seeded generator."""
    tree = jax.tree.map(np.asarray, RM.init_params(ref_cfg,
                                                   jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed + 100)
    seg = tree["segments"][0]
    names = [("attn", b) for b in ("bq", "bk", "bv") if b in seg["attn"]]
    names += [(ln, "bias") for ln in ("ln1", "ln2") if "bias" in seg[ln]]
    names += [(ln, "scale") for ln in ("ln1", "ln2") if ref_cfg.norm ==
              "layernorm"]
    for mod, leaf in names:
        a = seg[mod][leaf]
        seg[mod][leaf] = (rng.standard_normal(a.shape) * 0.5
                          + (leaf == "scale")).astype(np.float32)
    return tree


@pytest.fixture(scope="module", params=sorted(CASES))
def dense(request):
    name, over = CASES[request.param]
    ref_cfg = ref_reduced(ref_get_arch(name), **over)
    cfg = reduced(get_arch(name), **over)
    tree = _tree(ref_cfg)
    return (ref_cfg, cfg, jax.tree.map(jnp.asarray, tree),
            lm_params_from_reference(cfg, tree, device="cpu"))


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(port, ref, tol=TOL):
    np.testing.assert_allclose(port.detach().numpy(),
                               np.asarray(ref, np.float32),
                               rtol=tol, atol=tol)


def _prompts(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S))


@pytest.mark.parametrize("name", DENSE)
def test_configs_equal_the_reference(name):
    assert dataclasses.asdict(get_arch(name)) == dataclasses.asdict(
        ref_get_arch(name))
    assert get_arch(name).param_count() == ref_get_arch(name).param_count()
    assert dataclasses.asdict(reduced(get_arch(name))) == \
        dataclasses.asdict(ref_reduced(ref_get_arch(name)))


def test_prefill_and_decode_match_the_reference(dense):
    ref_cfg, cfg, ref_params, model = dense
    toks = _prompts(cfg, 2, 21, seed=1)
    logits, cache = M.prefill(cfg, model, {"tokens": _t(toks[:, :20])})
    r_logits, r_cache = RM.prefill(ref_cfg, ref_params,
                                   {"tokens": jnp.asarray(toks[:, :20])},
                                   dtype=jnp.float32)
    _close(logits, r_logits)
    assert len(cache) == len(r_cache) == 1
    for name in ("k", "v"):
        assert tuple(cache[0][name].shape) == (cfg.n_layers, 2, 20,
                                               cfg.n_kv_heads, cfg.dh)
        _close(cache[0][name], r_cache[0][name])
    # decode at position 20 against caches of 32 positions
    pad = [{n: torch.nn.functional.pad(t, (0, 0, 0, 0, 0, 12))
            for n, t in cache[0].items()}]
    r_pad = [{n: jnp.pad(t, ((0, 0), (0, 0), (0, 12), (0, 0), (0, 0)))
              for n, t in r_cache[0].items()}]
    d_logits, d_cache = M.decode_step(cfg, model, _t(toks[:, 20:]), pad, 20)
    r_d, r_dc = RM.decode_step(ref_cfg, ref_params, jnp.asarray(toks[:, 20:]),
                               r_pad, 20, dtype=jnp.float32)
    _close(d_logits, r_d)
    assert d_cache[0]["k"] is pad[0]["k"]        # written in place
    for name in ("k", "v"):
        _close(d_cache[0][name], r_dc[0][name])
    # decode at S matches a fresh prefill of S + 1 (the reference's bar)
    full, _ = M.prefill(cfg, model, {"tokens": _t(toks)})
    torch.testing.assert_close(d_logits, full, rtol=2e-3, atol=2e-3)
    specs = M.cache_specs(cfg, 2, 32)
    assert [{n: (tuple(t.shape), t.dtype) for n, t in d_cache[0].items()}] \
        == specs


def test_generate_ids_equal_the_reference(dense):
    ref_cfg, cfg, ref_params, model = dense
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
    assert KF.LAUNCHES == {"flash_attention": 0}


@pytest.mark.parametrize("cuts", [(256,), (256, 512), (512,), ()])
def test_prefill_extend_equals_one_shot(dense, cuts):
    """Chunked at multiples of the token block (256): the last logits and
    the whole cache equal the port's one-shot prefill bit for bit, and
    the reference's prefill_extend over the same chunks within 1e-4."""
    ref_cfg, cfg, ref_params, model = dense
    S = 600
    toks = _prompts(cfg, 2, S, seed=3)
    bounds = (0, *cuts, S)
    cache = M.empty_extend_cache(cfg, 2, S, device="cpu")
    r_cache = RM.empty_extend_cache(ref_cfg, 2, S, dtype=jnp.float32)
    for a, b in zip(bounds, bounds[1:]):
        logits, cache = M.prefill_extend(cfg, model, _t(toks[:, a:b]),
                                         cache, a)
        r_logits, r_cache = RM.prefill_extend(
            ref_cfg, ref_params, jnp.asarray(toks[:, a:b]), r_cache, a,
            dtype=jnp.float32)
    one, one_cache = M.prefill(cfg, model, {"tokens": _t(toks)})
    assert torch.equal(logits, one)
    for name in ("k", "v"):
        assert torch.equal(cache[0][name], one_cache[0][name])
        _close(cache[0][name], r_cache[0][name])
    _close(logits, r_logits)


def test_engine_prefill_chunked_equals_one_shot(dense):
    """The engine's iCh chunks (quantum 256) through prefill_extend give
    the one-shot prefill's bits, and the cache grows to max_seq for
    decode."""
    _, cfg, _, model = dense
    prompts = _prompts(cfg, 2, 700, seed=4)
    eng = Engine(cfg, model, EngineConfig(max_seq=768, min_chunk=4,
                                          init_divisor=6.0), device="cpu")
    logits, cache, log = eng.prefill_chunked(prompts)
    assert [c["chunk"] for c in log] == [256, 256, 188]
    one, one_cache = M.prefill(cfg, model, {"tokens": _t(prompts)})
    assert torch.equal(logits, one)
    assert all(torch.equal(cache[0][n], one_cache[0][n]) for n in "kv")
    grown = eng._pad_cache(cache)
    assert grown[0]["k"].shape[2] == 768
    assert torch.equal(grown[0]["k"][:, :, :700], cache[0]["k"])
    assert not grown[0]["k"][:, :, 700:].any()


@pytest.mark.parametrize("q_offset,Sq,Skv,rep", [
    (0, 16, 16, 1), (5, 11, 16, 2), (24, 8, 40, 4), (39, 1, 40, 6),
    (64, 36, 100, 2), (100, 20, 300, 16)])
def test_flash_plain_from_an_offset_matches_the_reference(q_offset, Sq, Skv,
                                                          rep):
    rng = np.random.default_rng(q_offset + Sq)
    q = rng.standard_normal((2, Sq, 2 * rep, 64)).astype(np.float32)
    k = rng.standard_normal((2, Skv, 2, 64)).astype(np.float32)
    v = rng.standard_normal((2, Skv, 2, 64)).astype(np.float32)
    ours = KF.flash_attention_plain(_t(q), _t(k), _t(v), causal=True,
                                    q_offset=q_offset)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    _close(ours, RA.full_attention(jq, jk, jv, causal=True,
                                   q_offset=q_offset), 2e-5)
    _close(ours, RA.blockwise_attention(jq, jk, jv, causal=True,
                                        q_offset=q_offset, q_block=16,
                                        kv_block=24), 2e-5)
    # the wrapper on CPU tensors: the plain version, no launch
    KF.reset_launches()
    assert torch.equal(KF.flash_attention(_t(q), _t(k), _t(v), causal=True,
                                          q_offset=q_offset), ours)
    assert KF.LAUNCHES == {"flash_attention": 0}


def test_flash_refuses_a_bad_offset():
    q, k = torch.zeros((1, 8, 2, 64)), torch.zeros((1, 16, 2, 64))
    with pytest.raises(ValueError, match="q_offset must be >= 0"):
        KF.flash_attention(q, k, k, q_offset=-1)
    with pytest.raises(ValueError, match="q_offset \\+ Sq <= Skv"):
        KF.flash_attention(q, k, k, causal=True, q_offset=9)
    assert KF.flash_attention(q, k, k, causal=True, q_offset=8).shape \
        == q.shape
    # causal from position 0 with more queries than keys: each keeps key 0
    out = KF.flash_attention(q, k[:, :3], k[:, :3], causal=True)
    assert torch.equal(out, KF.flash_attention_plain(q, k[:, :3], k[:, :3],
                                                     causal=True))


def test_converter_round_trip_and_refusals(dense):
    """The reference's stacked leaves load one slice a layer, biases and
    all, and stack back to the same arrays; a wrong name or shape
    raises."""
    ref_cfg, cfg, ref_params, model = dense
    tree = jax.tree.map(np.asarray, ref_params)
    state = model.state_dict()
    seg = tree["segments"][0]
    for mod, leaves in seg.items():
        for leaf, arr in leaves.items():
            back = np.stack([state[f"layers.{i}.{mod}.{leaf}"].numpy()
                             for i in range(cfg.n_layers)])
            np.testing.assert_array_equal(back, arr)
    if cfg.qkv_bias:
        assert np.abs(seg["attn"]["bq"]).max() > 0
    if cfg.tie_embeddings:
        assert "embed.head" not in state
    else:
        np.testing.assert_array_equal(state["embed.head"].numpy(),
                                      tree["embed"]["head"])
    if cfg.norm == "nonparametric_ln":
        assert not any(".ln" in n or "final_norm" in n for n in state)
    bad = jax.tree.map(lambda a: a, tree)
    bad["segments"][0]["attn"]["wq"] = seg["attn"]["wq"][:, :, :-1]
    with pytest.raises(ValueError, match="shape"):
        lm_params_from_reference(cfg, bad, device="cpu")
    bad = jax.tree.map(lambda a: a, tree)
    bad["segments"][0]["attn"]["extra"] = seg["attn"]["wq"]
    with pytest.raises(ValueError, match="names disagree"):
        lm_params_from_reference(cfg, bad, device="cpu")


def test_norms_and_tied_head_match_the_reference(dense):
    ref_cfg, cfg, ref_params, model = dense
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 7, cfg.d_model)).astype(np.float32) * 3 + 1
    layer = model.layers[1]
    r_layer = jax.tree.map(lambda a: a[1], ref_params["segments"][0])
    _close(layer.ln1(_t(x)), RL.apply_norm(ref_cfg, r_layer["ln1"],
                                           jnp.asarray(x)), 1e-5)
    _close(layer.mlp(_t(x)), RL.apply_mlp(ref_cfg, r_layer["mlp"],
                                          jnp.asarray(x)))
    from repro_torch.models import layers as L
    _close(L.lm_logits(model.embed, _t(x)),
           RL.lm_logits(ref_cfg, ref_params["embed"], jnp.asarray(x)))


def test_engine_refuses_a_dense_request_past_max_seq(dense):
    _, cfg, _, model = dense
    eng = Engine(cfg, model, EngineConfig(max_seq=16), device="cpu")
    with pytest.raises(ValueError, match="exceeds the attention cache"):
        eng.generate(np.zeros((1, 12), np.int64), n_new=8)
    ids, _ = eng.generate(np.zeros((1, 12), np.int64), n_new=4)
    assert ids.shape == (1, 4)
