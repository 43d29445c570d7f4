"""The port's Zamba2 serving path against the JAX reference on the CPU:
layers, attention prefill and decode, the Mamba2 block, `prefill`,
`decode_step` and `Engine.generate` on a reduced Zamba2 whose weights are
the reference's own (`convert.lm_params_from_reference`).

The reduced config keeps the shared attention block: `repro.configs.
reduced` alone cuts the pattern to ("M", "M"), which has none, so the
tests use block_pattern ("M", "A", "M", "A") — the shared block reused
twice, GQA with rep 2 — and ssm_chunk 16, so that the scan carries its
state across chunks.

Tolerances: logits and activations within 1e-4 (float32 on both sides,
summed in other orders: XLA's einsums against PyTorch's, the port's
materialised softmax against the reference's); generated ids equal; the
decode-vs-prefill bar at 2e-3, the reference's own
(tests/test_arch_smoke.py)."""
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
from repro.models import ssm as RSS
from repro.serve.engine import Engine as RefEngine
from repro.serve.engine import EngineConfig as RefEngineConfig
from repro_torch.configs import get_arch, reduced
from repro_torch.convert import lm_params_from_reference
from repro_torch.kernels.flash_attention import flash_attention as KF
from repro_torch.kernels.mamba_scan import mamba_scan as KS
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models import ssm as SS
from repro_torch.serve import Engine, EngineConfig

TOL = 1e-4
PATTERN = dict(block_pattern=("M", "A", "M", "A"), n_layers=4, ssm_chunk=16)


def _cfgs():
    return (ref_reduced(ref_get_arch("zamba2-1.2b"), **PATTERN),
            reduced(get_arch("zamba2-1.2b"), **PATTERN))


@pytest.fixture(scope="module")
def lm():
    ref_cfg, cfg = _cfgs()
    ref_params = RM.init_params(ref_cfg, jax.random.PRNGKey(3), max_seq=64)
    np_params = jax.tree.map(np.asarray, ref_params)
    return ref_cfg, cfg, ref_params, lm_params_from_reference(
        cfg, np_params, device="cpu")


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(port, ref, tol=TOL):
    np.testing.assert_allclose(port.detach().numpy(),
                               np.asarray(ref, np.float32),
                               rtol=tol, atol=tol)


def test_configs_equal_the_reference():
    for name in ("zamba2-1.2b",):
        assert dataclasses.asdict(get_arch(name)) == dataclasses.asdict(
            ref_get_arch(name))
        assert get_arch(name).param_count() == ref_get_arch(name).param_count()
    ref_cfg, cfg = _cfgs()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_cfg)
    assert dataclasses.asdict(reduced(get_arch("zamba2-1.2b"))) == \
        dataclasses.asdict(ref_reduced(ref_get_arch("zamba2-1.2b")))


def test_param_names_and_shapes_follow_the_reference(lm):
    ref_cfg, cfg, ref_params, model = lm
    ref_shapes = {".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                           for k in path): tuple(leaf.shape)
                  for path, leaf in jax.tree_util.tree_leaves_with_path(
                      ref_params)}
    ours = {n: tuple(t.shape) for n, t in model.state_dict().items()}
    assert ours == ref_shapes
    fresh = M.init_params(cfg, 7, device="cpu")
    assert {n: tuple(t.shape) for n, t in fresh.state_dict().items()} == ours
    # the shared block is one module, reused at every "A" position
    assert model.block(1) is model.block(3) is model.shared_attn


def test_layers_match_reference(lm):
    ref_cfg, cfg, ref_params, model = lm
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 7, cfg.d_model)).astype(np.float32)
    blk = ref_params["shared_attn"]
    _close(model.shared_attn.ln1(_t(x)),
           RL.apply_norm(ref_cfg, blk["ln1"], jnp.asarray(x)))
    _close(model.shared_attn.mlp(_t(x)),
           RL.apply_mlp(ref_cfg, blk["mlp"], jnp.asarray(x)))
    _close(L.lm_logits(model.embed, _t(x)),
           RL.lm_logits(ref_cfg, ref_params["embed"], jnp.asarray(x)))
    toks = rng.integers(0, cfg.vocab_size, (2, 7))
    _close(L.embed_tokens(model.embed, _t(toks)),
           RL.embed_tokens(ref_cfg, ref_params["embed"], jnp.asarray(toks)))
    xr = rng.standard_normal((2, 7, 4, cfg.dh)).astype(np.float32)
    pos = np.arange(7)
    cos, sin = L.rope_freqs(_t(pos), cfg.dh, cfg.rope_theta)
    rcos, rsin = RL.rope_freqs(jnp.asarray(pos), cfg.dh, cfg.rope_theta)
    _close(cos, rcos, 1e-6)
    _close(L.apply_rope(_t(xr), cos, sin), RL.apply_rope(jnp.asarray(xr),
                                                        rcos, rsin))


@pytest.mark.parametrize("S,window", [(9, 0), (20, 0), (20, 6)])
def test_attention_prefill_and_decode_match_reference(lm, S, window):
    ref_cfg, cfg, ref_params, model = lm
    rng = np.random.default_rng(S + window)
    x = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
    p, rp = model.shared_attn.attn, ref_params["shared_attn"]["attn"]
    out, (k, v) = A.attention(cfg, p, _t(x), window=window)
    r_out, (rk, rv) = RA.attention(ref_cfg, rp, jnp.asarray(x),
                                   window=window)
    _close(out, r_out)
    _close(k, rk)
    _close(v, rv)
    # decode at position S against a 32-slot cache holding the prefix
    x1 = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    ck = np.zeros((2, 32, cfg.n_kv_heads, cfg.dh), np.float32)
    cv = np.zeros_like(ck)
    ck[:, :S], cv[:, :S] = np.asarray(rk), np.asarray(rv)
    d_out, d_k, d_v = A.decode_attention(cfg, p, _t(x1), _t(ck), _t(cv), S,
                                         window=window)
    r_out, r_k, r_v = RA.decode_attention(ref_cfg, rp, jnp.asarray(x1),
                                          jnp.asarray(ck), jnp.asarray(cv),
                                          S, window=window)
    _close(d_out, r_out)
    _close(d_k, r_k)
    _close(d_v, r_v)
    q1 = rng.standard_normal((2, 1, cfg.n_heads, cfg.dh)).astype(np.float32)
    _close(KF.flash_attention_plain(_t(q1), d_k, d_v, causal=True,
                                    q_offset=S, window=window),
           RA.full_attention(jnp.asarray(q1), r_k, r_v, causal=True,
                             q_offset=S, window=window))


@pytest.mark.parametrize("S", [5, 16, 37])
def test_mamba2_block_matches_reference(lm, S):
    ref_cfg, cfg, ref_params, model = lm
    rng = np.random.default_rng(S)
    x = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
    p, rp = model.blocks[0].mamba, ref_params["blocks"][0]["mamba"]
    out, st = SS.apply_mamba2(cfg, p, _t(x))
    r_out, r_st = RSS.apply_mamba2(ref_cfg, rp, jnp.asarray(x))
    _close(out, r_out)
    _close(st["conv"], r_st["conv"])
    _close(st["ssm"], r_st["ssm"])
    # one decode token from that state
    x1 = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    out1, st1 = SS.apply_mamba2(cfg, p, _t(x1), state=st)
    r_out1, r_st1 = RSS.apply_mamba2(ref_cfg, rp, jnp.asarray(x1),
                                     state=r_st)
    _close(out1, r_out1)
    _close(st1["ssm"], r_st1["ssm"])
    # a chunk from that state (the plain chunked scan), exact_chunk
    x2 = rng.standard_normal((2, 8, cfg.d_model)).astype(np.float32)
    out2, st2 = SS.apply_mamba2(cfg, p, _t(x2), state=st, exact_chunk=True)
    r_out2, r_st2 = RSS.apply_mamba2(ref_cfg, rp, jnp.asarray(x2),
                                     state=r_st, exact_chunk=True)
    _close(out2, r_out2)
    _close(st2["ssm"], r_st2["ssm"])
    assert KS.LAUNCHES == {"mamba_scan": 0}


def test_prefill_and_decode_step_match_reference(lm):
    ref_cfg, cfg, ref_params, model = lm
    KF.reset_launches()
    KS.reset_launches()
    rng = np.random.default_rng(5)
    B, S = 2, 21
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    logits, cache = M.prefill(cfg, model, {"tokens": _t(toks[:, :S])})
    r_logits, r_cache = RM.prefill(ref_cfg, ref_params,
                                   {"tokens": jnp.asarray(toks[:, :S])},
                                   dtype=jnp.float32)
    _close(logits, r_logits)
    for ours, theirs in zip(cache, r_cache):
        for name in ours:
            _close(ours[name], theirs[name])
    # decode at position S against the reference's decode_step
    def pad(c, lib):
        out = []
        for kind, st in zip(cfg.block_pattern, c):
            if kind == "A":
                out.append({n: lib(np.pad(np.asarray(t), ((0, 0), (0, 40 - S),
                                                          (0, 0), (0, 0))))
                            for n, t in st.items()})
            else:
                out.append(st)
        return out
    d_logits, _ = M.decode_step(cfg, model, _t(toks[:, S:]), pad(cache, _t),
                                S)
    r_d, _ = RM.decode_step(ref_cfg, ref_params, jnp.asarray(toks[:, S:]),
                            pad(r_cache, jnp.asarray), S, dtype=jnp.float32)
    _close(d_logits, r_d)
    # inside the port: decode at S == a fresh prefill of S + 1 tokens
    full, _ = M.prefill(cfg, model, {"tokens": _t(toks)})
    np.testing.assert_allclose(d_logits.numpy(), full.numpy(), rtol=2e-3,
                               atol=2e-3)
    # on the CPU the wrappers ran their plain versions
    assert KF.LAUNCHES == {"flash_attention": 0}
    assert KS.LAUNCHES == {"mamba_scan": 0}


def test_engine_generate_matches_reference(lm):
    ref_cfg, cfg, ref_params, model = lm
    KF.reset_launches()
    KS.reset_launches()
    rng = np.random.default_rng(9)
    prompts = rng.integers(0, cfg.vocab_size, (2, 14)).astype(np.int32)
    ecfg = dict(max_seq=32, min_chunk=4)
    eng = Engine(cfg, model, EngineConfig(**ecfg), device="cpu")
    ids, stats = eng.generate(prompts, n_new=6)
    r_eng = RefEngine(ref_cfg, ref_params, RefEngineConfig(**ecfg))
    r_ids, r_stats = r_eng.generate(prompts, n_new=6)
    np.testing.assert_array_equal(ids, np.asarray(r_ids))
    assert ids.shape == (2, 6) and not stats["degraded"]
    # every chunk re-ran the prefix, counted; chunk sizes follow the
    # wall clock, so they are not compared
    assert eng.n_prefill_fallbacks == len(stats["chunks"]) > 1
    assert sum(c["chunk"] for c in stats["chunks"]) == 14
    # the last chunk is a one-shot prefill of the whole prompt
    logits, _, _ = Engine(cfg, model, EngineConfig(**ecfg),
                          device="cpu").prefill_chunked(prompts)
    one_shot, _ = M.prefill(cfg, model, {"tokens": _t(prompts).long()})
    assert torch.equal(logits, one_shot)
    assert KF.LAUNCHES == {"flash_attention": 0}
    assert KS.LAUNCHES == {"mamba_scan": 0}


def test_engine_refuses_what_it_cannot_serve(lm):
    _, cfg, _, model = lm
    eng = Engine(cfg, model, EngineConfig(max_seq=16), device="cpu")
    with pytest.raises(ValueError, match="exceeds the attention cache"):
        eng.generate(np.zeros((1, 12), np.int32), n_new=8)
    windowed = dataclasses.replace(cfg, attn_window=10)
    eng = Engine(windowed, model, EngineConfig(max_seq=64), device="cpu")
    with pytest.raises(ValueError, match="attn_window 10"):
        eng.generate(np.zeros((1, 8), np.int32), n_new=4)
    with pytest.raises(NotImplementedError, match="prefill_extend"):
        eng.start_request(None)
    # learned positions outside the encoder-decoder family come with a
    # later slice
    with pytest.raises(NotImplementedError, match="later slice"):
        M.init_params(dataclasses.replace(cfg, rope_theta=0.0),
                      device="cpu")
    # an encoder-decoder config is served through prefill with its frames
    # and decode_step: the engine passes no frames (ROADMAP.md queue 3,
    # caveat 9)
    encdec = reduced(get_arch("whisper-small"))
    eng = Engine(encdec, M.init_params(encdec, 0, max_seq=32, device="cpu"),
                 EngineConfig(max_seq=32), device="cpu")
    with pytest.raises(NotImplementedError, match="caveat 9"):
        eng.generate(np.zeros((1, 4), np.int32), n_new=2)


def test_engine_deadline_sheds_decode(lm):
    _, cfg, _, model = lm
    eng = Engine(cfg, model, EngineConfig(max_seq=32), device="cpu")
    ids, stats = eng.generate(np.ones((1, 8), np.int32), n_new=5,
                              deadline_s=0.0)
    assert ids.shape == (1, 1) and stats["degraded"] and stats["n_shed"] == 4


def test_cache_specs_describe_the_decode_cache(lm):
    ref_cfg, cfg, ref_params, model = lm
    eng = Engine(cfg, model, EngineConfig(max_seq=24), device="cpu")
    _, cache = M.prefill(cfg, model, {"tokens": torch.ones((2, 10),
                                                          dtype=torch.long)})
    specs = M.cache_specs(cfg, 2, 24)
    r_specs = RM.cache_specs(ref_cfg, 2, 24, dtype=jnp.float32)
    for ours, spec, r_spec in zip(eng._pad_cache(cache), specs, r_specs):
        assert set(ours) == set(spec) == set(r_spec)
        for name, t in ours.items():
            assert tuple(t.shape) == spec[name][0] == r_spec[name].shape
            assert t.dtype == spec[name][1]
