"""The port's vlm family (phi-3-vision-4.2b: the dense phi3-mini stack with
patch embeddings before the tokens) against the JAX reference on the
CPU: `prefill` with patches (logits and the KV cache of P + S
positions), decode from position S + P, `Engine.generate` text-only
(the reference's engine serves it so: incremental, no patches), the
port's incremental prefill equal to its one-shot prefill bit for bit,
and the converter.

The reference's weights are carried over by
`convert.lm_params_from_reference` on `reduced()` configs (dh 16; the
card tests in tests/test_torch_cuda.py widen to dh 96, phi-3-vision's).

Tolerances: logits and caches within 1e-4 (float32 on both sides, summed
in other orders); generated ids equal; the port's chunked prefill equal
to its one-shot prefill bit for bit (chunks on multiples of 256 tokens,
so the prompts that chunk are longer than 256); decode at S + P against a
fresh prefill of S + 1 tokens with the same patches within 1e-4."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_get_arch
from repro.configs import reduced as ref_reduced
from repro.models import model as RM
from repro.serve.engine import Engine as RefEngine
from repro.serve.engine import EngineConfig as RefEngineConfig
from repro_torch.configs import get_arch, reduced
from repro_torch.convert import lm_params_from_reference
from repro_torch.kernels.flash_attention import flash_attention as KF
from repro_torch.models import model as M
from repro_torch.serve import Engine, EngineConfig

TOL = 1e-4
NAME = "phi-3-vision-4.2b"
ECFG = dict(max_seq=640, min_chunk=4)


@pytest.fixture(scope="module")
def vlm():
    ref_cfg = ref_reduced(ref_get_arch(NAME))
    cfg = reduced(get_arch(NAME))
    tree = jax.tree.map(np.asarray, RM.init_params(ref_cfg,
                                                   jax.random.PRNGKey(0)))
    return (ref_cfg, cfg, jax.tree.map(jnp.asarray, tree),
            lm_params_from_reference(cfg, tree, device="cpu"))


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(port, ref, tol=TOL):
    np.testing.assert_allclose(port.detach().numpy(),
                               np.asarray(ref, np.float32),
                               rtol=tol, atol=tol)


def _inputs(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (B, S))
    patches = rng.standard_normal((B, cfg.num_patches,
                                   cfg.d_model)).astype(np.float32)
    return tokens, patches


def test_config_equals_the_reference():
    assert dataclasses.asdict(get_arch(NAME)) == dataclasses.asdict(
        ref_get_arch(NAME))
    assert get_arch(NAME).param_count() == ref_get_arch(NAME).param_count()
    assert dataclasses.asdict(reduced(get_arch(NAME))) == \
        dataclasses.asdict(ref_reduced(ref_get_arch(NAME)))
    cfg = get_arch(NAME)
    assert cfg.family == "vlm" and cfg.dh == 96 and cfg.num_patches == 576
    assert cfg.family in M.STACKED and M.extend_cache_specs_ok(cfg)
    assert M.segments_of(cfg) == [("dense", 32)]


def test_patch_prefill_and_decode_match_the_reference(vlm):
    """Patches (B, P, d) go before the tokens: the cache holds P + S
    positions (RoPE 0..P+S-1) and decode continues at position S + P."""
    ref_cfg, cfg, ref_params, model = vlm
    B, S, P = 2, 13, cfg.num_patches
    tokens, patches = _inputs(cfg, B, S + 3, seed=1)
    logits, cache = M.prefill(cfg, model, {"tokens": _t(tokens[:, :S]),
                                           "patches": _t(patches)})
    r_logits, r_cache = RM.prefill(
        ref_cfg, ref_params, {"tokens": jnp.asarray(tokens[:, :S]),
                              "patches": jnp.asarray(patches)},
        dtype=jnp.float32)
    _close(logits, r_logits)
    for name in ("k", "v"):
        assert tuple(cache[0][name].shape) == (cfg.n_layers, B, P + S,
                                               cfg.n_kv_heads, cfg.dh)
        _close(cache[0][name], r_cache[0][name])
    cache = Engine(cfg, model, EngineConfig(max_seq=32),
                   device="cpu")._pad_cache(cache)
    r_cache = RefEngine(ref_cfg, ref_params, RefEngineConfig(
        max_seq=32))._pad_cache(r_cache, P + S)
    for i in range(3):
        tok = tokens[:, S + i:S + i + 1]
        logits, cache = M.decode_step(cfg, model, _t(tok), cache, S + P + i)
        r_logits, r_cache = RM.decode_step(ref_cfg, ref_params,
                                           jnp.asarray(tok), r_cache,
                                           S + P + i, dtype=jnp.float32)
        _close(logits, r_logits)
    for name in ("k", "v"):
        _close(cache[0][name], r_cache[0][name])
    # decode at S + P continues the patch prefill as a fresh prefill of
    # the longer prompt with the same patches would
    full, _ = M.prefill(cfg, model, {"tokens": _t(tokens),
                                     "patches": _t(patches)})
    _close(logits, full.numpy())


def test_prefill_without_patches_is_the_text_path(vlm):
    """Text only, a vlm prefill is the dense stack's: the same bits as
    prefill_extend from position 0, and the reference's logits."""
    ref_cfg, cfg, ref_params, model = vlm
    tokens, _ = _inputs(cfg, 2, 9, seed=2)
    logits, cache = M.prefill(cfg, model, {"tokens": _t(tokens)})
    ext, ext_cache = M.prefill_extend(
        cfg, model, _t(tokens), M.empty_extend_cache(cfg, 2, 9,
                                                     device="cpu"), 0)
    assert torch.equal(logits, ext)
    assert all(torch.equal(cache[0][n], ext_cache[0][n]) for n in "kv")
    r_logits, _ = RM.prefill(ref_cfg, ref_params,
                             {"tokens": jnp.asarray(tokens)},
                             dtype=jnp.float32)
    _close(logits, r_logits)


def test_generate_text_only_ids_equal_the_reference_engine(vlm):
    ref_cfg, cfg, ref_params, model = vlm
    prompts, _ = _inputs(cfg, 2, 600, seed=3)
    KF.reset_launches()
    eng = Engine(cfg, model, EngineConfig(**ECFG), device="cpu")
    ids, stats = eng.generate(prompts, n_new=8)
    r_ids, _ = RefEngine(ref_cfg, ref_params, RefEngineConfig(
        **ECFG)).generate(prompts, n_new=8)
    np.testing.assert_array_equal(ids, np.asarray(r_ids))
    sizes = [c["chunk"] for c in stats["chunks"]]
    assert eng.n_prefill_fallbacks == 0 and sum(sizes) == 600
    assert all(c % M.TOKEN_BLOCK == 0 for c in sizes[:-1])
    assert KF.LAUNCHES == {"flash_attention": 0}


@pytest.mark.parametrize("divisor", [1.0, 3.0, 6.0])
def test_incremental_prefill_equals_one_shot_bits(vlm, divisor):
    """The engine's iCh chunks (quantum 256) through prefill_extend give
    the one-shot prefill's last logits and KV cache bit for bit."""
    _, cfg, _, model = vlm
    prompts, _ = _inputs(cfg, 2, 700, seed=4)
    eng = Engine(cfg, model, EngineConfig(max_seq=768, min_chunk=4,
                                          init_divisor=divisor),
                 device="cpu")
    logits, cache, log = eng.prefill_chunked(prompts)
    sizes = [c["chunk"] for c in log]
    assert sum(sizes) == 700 and all(c % 256 == 0 for c in sizes[:-1])
    assert (len(sizes) > 1) == (divisor > 1)
    one, one_cache = M.prefill(cfg, model, {"tokens": _t(prompts)})
    assert torch.equal(logits, one)
    assert all(torch.equal(cache[0][n], one_cache[0][n]) for n in "kv")


def test_converter_loads_the_dense_tree(vlm):
    ref_cfg, cfg, ref_params, model = vlm
    tree = jax.tree.map(np.asarray, ref_params)
    state = model.state_dict()
    for mod, leaves in tree["segments"][0].items():
        for leaf, arr in leaves.items():
            back = np.stack([state[f"layers.{i}.{mod}.{leaf}"].numpy()
                             for i in range(cfg.n_layers)])
            np.testing.assert_array_equal(back, arr)
    np.testing.assert_array_equal(state["embed.head"].numpy(),
                                  tree["embed"]["head"])
    assert "embed.pos" not in state                  # RoPE, no table
    assert set(M.init_params(cfg, 0, device="cpu").state_dict()) \
        == set(state)
