"""The port's encoder-decoder family (whisper-small) against the JAX
reference on the CPU: the encoder (`_encode`, also at 1,100 frames, where
the reference takes `blockwise_attention` over ragged key blocks and the
port's plain version keeps every key), `prefill` with frames (logits, the
self-attention cache and the cross cache), `decode_step` (self and
cross-attention), greedy ids, `cache_specs`, the refusals the reference
shares (a position table shorter than the encoder's frames; an engine
that passes no frames, ROADMAP.md queue 3 caveat 9), the converter over
the encoder stack, and the neighbours: attention without RoPE and the
cross-attention branches of `attention` / `decode_attention` against
`repro.models.attention`.

The reference's weights are carried over by
`convert.lm_params_from_reference` on `reduced()` configs, every
layernorm's scale and bias (ones and zeros at init) drawn at random so
that they carry weight. `reduced` gives dh 16 (the plain versions take
any width; the card tests in tests/test_torch_cuda.py widen to dh 64).

Tolerances: 1e-4 for logits, caches and encoder outputs (float32 on both
sides, summed in other orders); generated ids equal; decode at S against
a fresh prefill of S + 1 within 2e-3 (tests/test_arch_smoke.py)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_get_arch
from repro.configs import reduced as ref_reduced
from repro.models import attention as RA
from repro.models import model as RM
from repro.serve.engine import Engine as RefEngine
from repro.serve.engine import EngineConfig as RefEngineConfig
from repro_torch.configs import get_arch, reduced
from repro_torch.convert import lm_params_from_reference
from repro_torch.kernels.flash_attention import flash_attention as KF
from repro_torch.models import attention as A
from repro_torch.models import model as M
from repro_torch.serve import Engine, EngineConfig

TOL = 1e-4
NAME = "whisper-small"
MAX_SEQ = 48


def _tree(ref_cfg, max_seq, seed=0):
    """The reference's parameters as numpy, every layernorm's scale and
    bias drawn from a seeded generator."""
    tree = jax.tree.map(np.asarray, RM.init_params(
        ref_cfg, jax.random.PRNGKey(seed), max_seq=max_seq))
    rng = np.random.default_rng(seed + 100)
    norms = [blk[ln] for blk in (tree["enc"], tree["segments"][0])
             for ln in blk if ln.startswith("ln")]
    norms += [tree["enc_norm"], tree["final_norm"]]
    for norm in norms:
        norm["scale"] = (rng.standard_normal(norm["scale"].shape) * 0.5
                         + 1).astype(np.float32)
        norm["bias"] = (rng.standard_normal(norm["bias"].shape)
                        * 0.5).astype(np.float32)
    return tree


def _models(encoder_seq=None, max_seq=MAX_SEQ, **over):
    if encoder_seq:
        over["encoder_seq"] = encoder_seq
    ref_cfg = ref_reduced(ref_get_arch(NAME), **over)
    cfg = reduced(get_arch(NAME), **over)
    tree = _tree(ref_cfg, max_seq)
    return (ref_cfg, cfg, jax.tree.map(jnp.asarray, tree),
            lm_params_from_reference(cfg, tree, device="cpu"))


@pytest.fixture(scope="module")
def whisper():
    return _models()


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(port, ref, tol=TOL):
    np.testing.assert_allclose(port.detach().numpy(),
                               np.asarray(ref, np.float32),
                               rtol=tol, atol=tol)


def _inputs(cfg, B, S, seed, n_frames=None):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (B, S))
    frames = rng.standard_normal((B, n_frames or cfg.encoder_seq,
                                  cfg.d_model)).astype(np.float32)
    return tokens, frames


def _batches(tokens, frames):
    return ({"tokens": _t(tokens), "frames": _t(frames)},
            {"tokens": jnp.asarray(tokens), "frames": jnp.asarray(frames)})


def test_config_equals_the_reference():
    assert dataclasses.asdict(get_arch(NAME)) == dataclasses.asdict(
        ref_get_arch(NAME))
    assert get_arch(NAME).param_count() == ref_get_arch(NAME).param_count()
    assert dataclasses.asdict(reduced(get_arch(NAME))) == \
        dataclasses.asdict(ref_reduced(ref_get_arch(NAME)))
    cfg = get_arch(NAME)
    assert (cfg.family, cfg.rope_theta, cfg.encoder_seq) == ("encdec", 0.0,
                                                             1500)
    assert not M.extend_cache_specs_ok(cfg) and cfg.family not in M.STACKED


@pytest.mark.parametrize("encoder_seq", [16, 1100])
def test_encode_matches_the_reference(encoder_seq):
    """At 1,100 frames the reference's attention takes
    `blockwise_attention` (from 1,024 tokens on), whose last key block is
    ragged and masked; the port's plain version keeps every key."""
    ref_cfg, cfg, ref_params, model = _models(encoder_seq,
                                              max_seq=encoder_seq + 8)
    _, frames = _inputs(cfg, 2, 1, seed=encoder_seq)
    ours = M._encode(cfg, model, _t(frames))
    theirs = RM._encode(ref_cfg, ref_params, jnp.asarray(frames),
                        jnp.float32)
    assert tuple(ours.shape) == (2, encoder_seq, cfg.d_model)
    _close(ours, theirs)


def test_prefill_matches_the_reference(whisper):
    ref_cfg, cfg, ref_params, model = whisper
    tokens, frames = _inputs(cfg, 2, 11, seed=1)
    ours, theirs = _batches(tokens, frames)
    KF.reset_launches()
    logits, cache = M.prefill(cfg, model, ours)
    r_logits, r_cache = RM.prefill(ref_cfg, ref_params, theirs,
                                   dtype=jnp.float32)
    assert KF.LAUNCHES == {"flash_attention": 0}     # plain on the CPU
    _close(logits, r_logits)
    assert set(cache) == {"self", "cross"} and len(cache["self"]) == 1
    for name in ("k", "v"):
        assert tuple(cache["self"][0][name].shape) == (
            cfg.n_layers, 2, 11, cfg.n_kv_heads, cfg.dh)
        assert tuple(cache["cross"][name].shape) == (
            cfg.n_layers, 2, cfg.encoder_seq, cfg.n_kv_heads, cfg.dh)
        _close(cache["self"][0][name], r_cache["self"][0][name])
        _close(cache["cross"][name], r_cache["cross"][name])


def test_decode_step_matches_the_reference(whisper):
    """Three decode steps from a prefill of 9 tokens, on caches grown to
    max_seq by each package's engine (self cache padded, cross as is);
    the port writes its self cache in place."""
    ref_cfg, cfg, ref_params, model = whisper
    tokens, frames = _inputs(cfg, 2, 12, seed=2)
    ours, theirs = _batches(tokens[:, :9], frames)
    _, cache = M.prefill(cfg, model, ours)
    _, r_cache = RM.prefill(ref_cfg, ref_params, theirs, dtype=jnp.float32)
    cache = Engine(cfg, model, EngineConfig(max_seq=MAX_SEQ),
                   device="cpu")._pad_cache(cache)
    r_cache = RefEngine(ref_cfg, ref_params, RefEngineConfig(
        max_seq=MAX_SEQ))._pad_cache(r_cache, 9)
    assert tuple(cache["self"][0]["k"].shape) == tuple(
        r_cache["self"][0]["k"].shape)
    for pos in range(9, 12):
        logits, new = M.decode_step(cfg, model, _t(tokens[:, pos:pos + 1]),
                                    cache, pos)
        r_logits, r_cache = RM.decode_step(
            ref_cfg, ref_params, jnp.asarray(tokens[:, pos:pos + 1]),
            r_cache, pos, dtype=jnp.float32)
        assert new["self"][0]["k"] is cache["self"][0]["k"]
        _close(logits, r_logits)
    for name in ("k", "v"):
        _close(cache["self"][0][name], r_cache["self"][0][name])
        _close(cache["cross"][name], r_cache["cross"][name])
    # decode at S continues a prefill as a fresh prefill of S + 1 would
    full, _ = M.prefill(cfg, model, _batches(tokens, frames)[0])
    torch.testing.assert_close(logits, full, rtol=2e-3, atol=2e-3)


def test_greedy_ids_equal_the_reference(whisper):
    ref_cfg, cfg, ref_params, model = whisper
    tokens, frames = _inputs(cfg, 3, 6, seed=3)
    ours, theirs = _batches(tokens, frames)
    logits, cache = M.prefill(cfg, model, ours)
    r_logits, r_cache = RM.prefill(ref_cfg, ref_params, theirs,
                                   dtype=jnp.float32)
    cache = Engine(cfg, model, EngineConfig(max_seq=16),
                   device="cpu")._pad_cache(cache)
    r_cache = RefEngine(ref_cfg, ref_params, RefEngineConfig(
        max_seq=16))._pad_cache(r_cache, 6)
    ids, r_ids = [], []
    for i in range(4):
        tok = torch.argmax(logits, -1)[:, None]
        r_tok = jnp.argmax(r_logits, -1).astype(jnp.int32)[:, None]
        ids.append(tok[:, 0].numpy()), r_ids.append(np.asarray(r_tok)[:, 0])
        logits, cache = M.decode_step(cfg, model, tok, cache, 6 + i)
        r_logits, r_cache = RM.decode_step(ref_cfg, ref_params, r_tok,
                                           r_cache, 6 + i, dtype=jnp.float32)
    np.testing.assert_array_equal(np.stack(ids, 1), np.stack(r_ids, 1))


def test_cache_specs_equal_the_reference(whisper):
    ref_cfg, cfg, _, model = whisper
    specs = M.cache_specs(cfg, 2, 24)
    r_specs = RM.cache_specs(ref_cfg, 2, 24, dtype=jnp.float32)
    assert len(specs["self"]) == len(r_specs["self"]) == 1
    for name in ("k", "v"):
        assert specs["self"][0][name] == (r_specs["self"][0][name].shape,
                                          torch.float32)
        assert specs["cross"][name] == (r_specs["cross"][name].shape,
                                        torch.float32)
    tokens, frames = _inputs(cfg, 2, 10, seed=4)
    _, cache = M.prefill(cfg, model, _batches(tokens, frames)[0])
    grown = Engine(cfg, model, EngineConfig(max_seq=24),
                   device="cpu")._pad_cache(cache)
    assert grown["cross"] is cache["cross"]
    for name in ("k", "v"):
        assert (tuple(grown["self"][0][name].shape), grown["self"][0][
            name].dtype) == specs["self"][0][name]
        assert (tuple(grown["cross"][name].shape), grown["cross"][
            name].dtype) == specs["cross"][name]
        assert torch.equal(grown["self"][0][name][:, :, :10],
                           cache["self"][0][name])
        assert not grown["self"][0][name][:, :, 10:].any()


def test_a_position_table_shorter_than_the_frames_raises():
    """The encoder and the decoder share one learned position table of
    max_seq rows: below encoder_seq the port refuses to build the model,
    and the reference fails in `_encode`'s add."""
    cfg = reduced(get_arch(NAME))
    for max_seq in (0, cfg.encoder_seq - 1):
        with pytest.raises(ValueError, match="max_seq"):
            M.init_params(cfg, 0, max_seq=max_seq, device="cpu")
    ref_cfg = ref_reduced(ref_get_arch(NAME))
    r_params = RM.init_params(ref_cfg, jax.random.PRNGKey(0), max_seq=8)
    _, frames = _inputs(cfg, 1, 1, seed=5)
    with pytest.raises(TypeError):
        RM.prefill(ref_cfg, r_params, {"tokens": jnp.zeros((1, 2), jnp.int32),
                                       "frames": jnp.asarray(frames)})
    # decoder positions past the table raise too
    model = M.init_params(cfg, 0, max_seq=cfg.encoder_seq, device="cpu")
    with pytest.raises(ValueError, match="position table"):
        M.prefill(cfg, model, {"tokens": torch.zeros((1, 17),
                                                    dtype=torch.long),
                               "frames": _t(frames)})


def test_the_engine_refuses_encdec_as_the_reference_cannot_serve_it(
        whisper):
    ref_cfg, cfg, ref_params, model = whisper
    eng = Engine(cfg, model, EngineConfig(max_seq=MAX_SEQ), device="cpu")
    prompts = np.ones((1, 5), np.int64)
    for call in (lambda: eng.generate(prompts, n_new=2),
                 lambda: eng.prefill_chunked(prompts),
                 lambda: eng.start_request(None)):
        with pytest.raises(NotImplementedError, match="caveat 9"):
            call()
    with pytest.raises(KeyError, match="frames"):
        RefEngine(ref_cfg, ref_params, RefEngineConfig(
            max_seq=MAX_SEQ)).generate(prompts, n_new=2)
    for ext in (lambda: M.empty_extend_cache(cfg, 1, 4, device="cpu"),
                lambda: M.prefill_extend(cfg, model, _t(prompts), {}, 0)):
        with pytest.raises(NotImplementedError, match="does not extend"):
            ext()
    assert not RM.extend_cache_specs_ok(ref_cfg)
    with pytest.raises(NotImplementedError):
        RM.prefill_extend(ref_cfg, ref_params, jnp.ones((1, 5), jnp.int32),
                          [], 0)


def test_converter_unstacks_the_encoder(whisper):
    ref_cfg, cfg, ref_params, model = whisper
    tree = jax.tree.map(np.asarray, ref_params)
    state = model.state_dict()
    for stack, prefix, count in ((tree["enc"], "enc", cfg.encoder_layers),
                                 (tree["segments"][0], "layers",
                                  cfg.n_layers)):
        for mod, leaves in stack.items():
            for leaf, arr in leaves.items():
                back = np.stack([state[f"{prefix}.{i}.{mod}.{leaf}"].numpy()
                                 for i in range(count)])
                np.testing.assert_array_equal(back, arr)
    np.testing.assert_array_equal(state["embed.pos"].numpy(),
                                  tree["embed"]["pos"])
    assert state["embed.pos"].shape == (MAX_SEQ, cfg.d_model)
    assert "embed.head" not in state                 # tied
    bad = jax.tree.map(lambda a: a, tree)
    bad["enc"]["attn"]["wq"] = tree["enc"]["attn"]["wq"][:1]
    with pytest.raises(ValueError, match="layer count"):
        lm_params_from_reference(cfg, bad, device="cpu")
    fresh = M.init_params(cfg, 0, max_seq=MAX_SEQ, device="cpu")
    assert set(fresh.state_dict()) == set(state)


# ---- the neighbours: attention without RoPE, and cross-attention ----

def _attention_params(cfg, seed):
    """One attention block's weights as the reference's dict of numpy
    arrays (biases drawn) and the port's `Attention` holding them."""
    rng = np.random.default_rng(seed)
    d, hq, hkv = cfg.d_model, cfg.n_heads * cfg.dh, cfg.n_kv_heads * cfg.dh
    shapes = {"wq": (d, hq), "wk": (d, hkv), "wv": (d, hkv), "wo": (hq, d)}
    if cfg.qkv_bias:
        shapes.update(bq=(hq,), bk=(hkv,), bv=(hkv,))
    arrs = {n: (rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)
            for n, s in shapes.items()}
    p = A.Attention(cfg, torch.Generator().manual_seed(0), "cpu")
    p.load_state_dict({n: _t(a) for n, a in arrs.items()})
    return {n: jnp.asarray(a) for n, a in arrs.items()}, p


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("qkv_bias", [False, True])
def test_attention_without_rope_matches_the_reference(causal, qkv_bias):
    cfg = reduced(get_arch(NAME), qkv_bias=qkv_bias)
    ref_cfg = ref_reduced(ref_get_arch(NAME), qkv_bias=qkv_bias)
    r_p, p = _attention_params(cfg, seed=6)
    x = np.random.default_rng(7).standard_normal(
        (2, 13, cfg.d_model)).astype(np.float32)
    out, (k, v) = A.attention(cfg, p, _t(x), causal=causal)
    r_out, (r_k, r_v) = RA.attention(ref_cfg, r_p, jnp.asarray(x),
                                     causal=causal)
    _close(out, r_out)
    _close(k, r_k), _close(v, r_v)
    # no RoPE: k is the plain projection
    _close(k.reshape(2, 13, -1), x @ np.asarray(r_p["wk"]) + (
        np.asarray(r_p["bk"]) if qkv_bias else 0))


@pytest.mark.parametrize("qkv_bias", [False, True])
def test_cross_attention_matches_the_reference(qkv_bias):
    """q from the decoder (plus bq with qkv biases), k and v from the
    encoder's output without bias, every key kept; in prefill through
    `attention(cross_kv=)`, in decode through `decode_attention(
    cross=True)`, which writes nothing."""
    cfg = reduced(get_arch(NAME), qkv_bias=qkv_bias)
    ref_cfg = ref_reduced(ref_get_arch(NAME), qkv_bias=qkv_bias)
    r_p, p = _attention_params(cfg, seed=8)
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 5, cfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((2, 19, cfg.d_model)).astype(np.float32)
    ek, ev = A.encoder_kv(cfg, p, _t(enc))
    B, Se = enc.shape[:2]
    r_ek = (jnp.asarray(enc) @ r_p["wk"]).reshape(B, Se, cfg.n_kv_heads,
                                                  cfg.dh)
    r_ev = (jnp.asarray(enc) @ r_p["wv"]).reshape(B, Se, cfg.n_kv_heads,
                                                  cfg.dh)
    _close(ek, r_ek), _close(ev, r_ev)
    out, kv = A.attention(cfg, p, _t(x), causal=False, cross_kv=(ek, ev))
    r_out, r_kv = RA.attention(ref_cfg, r_p, jnp.asarray(x), causal=False,
                               cross_kv=(r_ek, r_ev))
    assert kv is None and r_kv is None
    _close(out, r_out)
    before = (ek.clone(), ev.clone())
    d_out, ck, cv = A.decode_attention(cfg, p, _t(x[:, :1]), ek, ev, 3,
                                       cross=True)
    r_d, _, _ = RA.decode_attention(ref_cfg, r_p, jnp.asarray(x[:, :1]),
                                    r_ek, r_ev, 3, cross=True)
    _close(d_out, r_d)
    assert ck is ek and torch.equal(ek, before[0]) and torch.equal(
        ev, before[1])
    # a decode query attends as the same query of a prefill does
    _close(d_out[:, 0], out[:, 0].numpy())


def test_decode_attention_without_rope_matches_the_reference():
    cfg = reduced(get_arch(NAME))
    ref_cfg = ref_reduced(ref_get_arch(NAME))
    r_p, p = _attention_params(cfg, seed=10)
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    ck = rng.standard_normal((2, 12, cfg.n_kv_heads, cfg.dh)).astype(
        np.float32)
    cv = rng.standard_normal(ck.shape).astype(np.float32)
    out, k, v = A.decode_attention(cfg, p, _t(x), _t(ck), _t(cv), 7)
    r_out, r_k, r_v = RA.decode_attention(ref_cfg, r_p, jnp.asarray(x),
                                          jnp.asarray(ck), jnp.asarray(cv),
                                          7)
    _close(out, r_out)
    _close(k, r_k), _close(v, r_v)
