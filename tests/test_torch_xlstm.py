"""The port's ssm family (xlstm-350m) against the JAX reference on the CPU:
the config, the parameter tree, the mLSTM and sLSTM blocks, the SSD scan
from a given state, `prefill`, `decode_step`, `prefill_extend` and
`Engine.generate` on a reduced xLSTM whose weights are the reference's own
(`convert.lm_params_from_reference`); then, inside the port, the engine's
incremental chunked prefill against a one-shot prefill, bit for bit.

The reduced config keeps an sLSTM block: `repro.configs.reduced` alone
cuts the pattern to ("X", "X"), which has none, so the tests use
block_pattern ("X", "X", "X", "S") and ssm_chunk 4, so that every scan
carries its state across chunks and an incremental prefill crosses
several chunk boundaries.

Tolerances: the scan within 2e-4 (tests/test_torch_mamba_scan.py, the
reference's own for float32 scans); blocks and logits within 1e-4
(tests/test_torch_lm.py: float32 on both sides, summed in other orders);
generated ids equal; decode against a fresh prefill at 2e-3, the
reference's bar (tests/test_arch_smoke.py). Inside the port the chunked
prefill is held bit for bit, the reference's own ssm bar
(tests/test_serve_engine.py::TestSSMIncrementalPrefill)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_get_arch
from repro.configs import reduced as ref_reduced
from repro.models import model as RM
from repro.models import ssm as RSS
from repro.serve.engine import Engine as RefEngine
from repro.serve.engine import EngineConfig as RefEngineConfig
from repro_torch.configs import get_arch, reduced
from repro_torch.convert import lm_params_from_reference
from repro_torch.kernels.mamba_scan import mamba_scan as KS
from repro_torch.models import model as M
from repro_torch.models import ssm as SS
from repro_torch.serve import Engine, EngineConfig
from repro_torch.serve.queue import Request, RequestState

SCAN_TOL = 2e-4
TOL = 1e-4
DECODE_TOL = 2e-3
PATTERN = dict(block_pattern=("X", "X", "X", "S"), n_layers=4, ssm_chunk=4)


def _cfgs():
    return (ref_reduced(ref_get_arch("xlstm-350m"), **PATTERN),
            reduced(get_arch("xlstm-350m"), **PATTERN))


@pytest.fixture(scope="module")
def lm():
    ref_cfg, cfg = _cfgs()
    ref_params = RM.init_params(ref_cfg, jax.random.PRNGKey(5), max_seq=64)
    np_params = jax.tree.map(np.asarray, ref_params)
    return ref_cfg, cfg, ref_params, lm_params_from_reference(
        cfg, np_params, device="cpu")


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(port, ref, tol=TOL):
    np.testing.assert_allclose(port.detach().numpy(),
                               np.asarray(ref, np.float32),
                               rtol=tol, atol=tol)


def _trees_close(ours, theirs, tol=TOL):
    if isinstance(ours, dict):
        assert set(ours) == set(theirs)
        for name in ours:
            _trees_close(ours[name], theirs[name], tol)
    elif isinstance(ours, (list, tuple)):
        assert len(ours) == len(theirs)
        for a, b in zip(ours, theirs):
            _trees_close(a, b, tol)
    else:
        _close(ours, theirs, tol)


def _trees_equal(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for name in a:
            _trees_equal(a[name], b[name])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _trees_equal(x, y)
    else:
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)


def test_configs_equal_the_reference():
    full, ref_full = get_arch("xlstm-350m"), ref_get_arch("xlstm-350m")
    assert dataclasses.asdict(full) == dataclasses.asdict(ref_full)
    assert full.param_count() == ref_full.param_count()
    assert full.n_layers == 24 and full.d_model == 1024 \
        and full.n_heads == 4 and full.d_ff == 0 \
        and full.vocab_size == 50304 and full.family == "ssm"
    assert full.block_pattern.count("X") == 18 \
        and full.block_pattern.count("S") == 6 \
        and all(k == "S" for k in full.block_pattern[3::4])
    small, ref_small = reduced(full), ref_reduced(ref_full)
    assert dataclasses.asdict(small) == dataclasses.asdict(ref_small)
    assert small.block_pattern == ("X", "X")
    assert small.param_count() == ref_small.param_count()
    ref_cfg, cfg = _cfgs()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_cfg)
    assert cfg.param_count() == ref_cfg.param_count()


def test_param_names_and_shapes_follow_the_reference(lm):
    """`lm_params_from_reference` takes the reference's xLSTM tree
    unchanged: the same names (`blocks.0.mlstm.wq`, `blocks.3.slstm.r`),
    shapes and values."""
    ref_cfg, cfg, ref_params, model = lm
    ref_leaves = {".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                           for k in path): np.asarray(leaf)
                  for path, leaf in jax.tree_util.tree_leaves_with_path(
                      ref_params)}
    ours = model.state_dict()
    assert {n: tuple(t.shape) for n, t in ours.items()} == \
        {n: a.shape for n, a in ref_leaves.items()}
    for name, arr in ref_leaves.items():
        np.testing.assert_array_equal(ours[name].numpy(), arr)
    assert tuple(ours["blocks.0.mlstm.wq"].shape) == (128, 128)
    assert tuple(ours["blocks.3.slstm.r"].shape) == (4, 16, 16)
    fresh = M.init_params(cfg, 7, device="cpu")
    assert {n: tuple(t.shape) for n, t in fresh.state_dict().items()} == \
        {n: tuple(t.shape) for n, t in ours.items()}


@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("S", [1, 7, 16, 37])
def test_mlstm_matches_reference(lm, S, exact):
    """From scratch, then a second input from the first's state (at S = 1
    without `exact_chunk`: the decode recurrence)."""
    ref_cfg, cfg, ref_params, model = lm
    rng = np.random.default_rng(S + 100 * exact)
    p, rp = model.blocks[0].mlstm, ref_params["blocks"][0]["mlstm"]
    x = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
    out, st = SS.apply_mlstm(cfg, p, _t(x), exact_chunk=exact)
    r_out, r_st = RSS.apply_mlstm(ref_cfg, rp, jnp.asarray(x),
                                  exact_chunk=exact)
    _close(out, r_out)
    _close(st, r_st)
    assert (tuple(st.shape), st.dtype) == M.cache_specs(cfg, 2, 1)[0]
    x2 = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
    out2, st2 = SS.apply_mlstm(cfg, p, _t(x2), state=st, exact_chunk=exact)
    r_out2, r_st2 = RSS.apply_mlstm(ref_cfg, rp, jnp.asarray(x2),
                                    state=r_st, exact_chunk=exact)
    _close(out2, r_out2)
    _close(st2, r_st2)
    assert KS.LAUNCHES == {"mamba_scan": 0}


@pytest.mark.parametrize("S", [1, 7, 16, 37])
def test_slstm_matches_reference(lm, S):
    ref_cfg, cfg, ref_params, model = lm
    rng = np.random.default_rng(S)
    p, rp = model.blocks[3].slstm, ref_params["blocks"][3]["slstm"]
    x = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
    out, st = SS.apply_slstm(cfg, p, _t(x))
    r_out, r_st = RSS.apply_slstm(ref_cfg, rp, jnp.asarray(x))
    _close(out, r_out)
    _trees_close(st, r_st)
    x2 = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
    out2, st2 = SS.apply_slstm(cfg, p, _t(x2), state=st)
    r_out2, r_st2 = RSS.apply_slstm(ref_cfg, rp, jnp.asarray(x2),
                                    state=r_st)
    _close(out2, r_out2)
    _trees_close(st2, r_st2)


@pytest.mark.parametrize("S,H,N,Pd,chunk,exact", [
    (37, 2, 16, 17, 8, False), (16, 3, 8, 9, 4, True), (5, 2, 16, 33, 8, True),
    (40, 1, 32, 64, 16, False)])
def test_scan_from_a_state_matches_reference(S, H, N, Pd, chunk, exact):
    """`mamba_scan(state=)` on the CPU against the reference's
    `chunked_gated_scan(state=)`, the states in their two layouts (the
    kernel's (B,H,N,Pd), the model's (B,H,Pd,N)); the model's
    `chunked_gated_scan` against both."""
    rng = np.random.default_rng(S * N)
    q, k = (rng.standard_normal((2, S, H, N)).astype(np.float32)
            for _ in range(2))
    v = rng.standard_normal((2, S, H, Pd)).astype(np.float32)
    la = (-np.abs(rng.standard_normal((2, S, H))) * 0.3).astype(np.float32)
    st0 = rng.standard_normal((2, H, Pd, N)).astype(np.float32)
    r_y, r_st = RSS.chunked_gated_scan(*(jnp.asarray(a) for a in
                                         (q, k, v, la)),
                                       state=jnp.asarray(st0), chunk=chunk,
                                       exact_chunk=exact)
    Q = SS.scan_block(chunk, S, exact)
    y, st = KS.mamba_scan(_t(q), _t(k), _t(v), _t(la), chunk=Q,
                          state=_t(st0).transpose(-1, -2).contiguous())
    _close(y, r_y, SCAN_TOL)
    _close(st.transpose(-1, -2), r_st, SCAN_TOL)
    y2, st2 = SS.chunked_gated_scan(_t(q), _t(k), _t(v), _t(la),
                                    state=_t(st0), chunk=chunk,
                                    exact_chunk=exact)
    assert torch.equal(y2, y) and torch.equal(st2, st.transpose(-1, -2))


def test_prefill_decode_and_extend_match_reference(lm):
    ref_cfg, cfg, ref_params, model = lm
    KS.reset_launches()
    rng = np.random.default_rng(5)
    B, S = 2, 22
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    logits, cache = M.prefill(cfg, model, {"tokens": _t(toks[:, :S])})
    r_logits, r_cache = RM.prefill(ref_cfg, ref_params,
                                   {"tokens": jnp.asarray(toks[:, :S])},
                                   dtype=jnp.float32)
    _close(logits, r_logits)
    _trees_close(cache, r_cache)
    d_logits, d_cache = M.decode_step(cfg, model, _t(toks[:, S:]), cache, S)
    r_d, r_d_cache = RM.decode_step(ref_cfg, ref_params,
                                    jnp.asarray(toks[:, S:]), r_cache, S,
                                    dtype=jnp.float32)
    _close(d_logits, r_d)
    _trees_close(d_cache, r_d_cache)
    # inside the port: decode at S == a fresh prefill of S + 1 tokens
    full, _ = M.prefill(cfg, model, {"tokens": _t(toks)})
    np.testing.assert_allclose(d_logits.numpy(), full.numpy(),
                               rtol=DECODE_TOL, atol=DECODE_TOL)
    # prefill_extend over chunks of 8, 8, 6 from the empty cache
    ext = M.empty_extend_cache(cfg, B, S, device="cpu")
    r_ext = RM.empty_extend_cache(ref_cfg, B, S, dtype=jnp.float32)
    _trees_close(ext, r_ext)
    done = 0
    for c in (8, 8, 6):
        e_logits, ext = M.prefill_extend(cfg, model,
                                         _t(toks[:, done:done + c]), ext,
                                         done, ssm_chunk=4)
        r_e, r_ext = RM.prefill_extend(
            ref_cfg, ref_params, jnp.asarray(toks[:, done:done + c]), r_ext,
            done, dtype=jnp.float32, ssm_chunk=4)
        _close(e_logits, r_e)
        _trees_close(ext, r_ext)
        done += c
    assert torch.equal(e_logits, logits)
    _trees_equal(ext, cache)
    # on the CPU the wrapper ran its plain version
    assert KS.LAUNCHES == {"mamba_scan": 0}


def test_engine_generate_matches_reference(lm):
    ref_cfg, cfg, ref_params, model = lm
    rng = np.random.default_rng(9)
    prompts = rng.integers(0, cfg.vocab_size, (2, 22)).astype(np.int32)
    ecfg = dict(max_seq=32, min_chunk=4)
    eng = Engine(cfg, model, EngineConfig(**ecfg), device="cpu")
    ids, stats = eng.generate(prompts, n_new=6)
    r_eng = RefEngine(ref_cfg, ref_params, RefEngineConfig(**ecfg))
    r_ids, _ = r_eng.generate(prompts, n_new=6)
    np.testing.assert_array_equal(ids, np.asarray(r_ids))
    assert ids.shape == (2, 6) and not stats["degraded"]
    # incremental: no prefix rerun, chunks on multiples of Q = 4
    assert eng.n_prefill_fallbacks == 0 == r_eng.n_prefill_fallbacks
    assert sum(c["chunk"] for c in stats["chunks"]) == 22
    assert all(c["chunk"] % 4 == 0 for c in stats["chunks"][:-1])


@pytest.mark.parametrize("divisor", [1.0, 3.0, 8.0])
def test_chunked_prefill_is_one_shot_bit_for_bit(lm, divisor):
    """Logits and every block state of the engine's incremental prefill
    equal a one-shot prefill's bits, with a last chunk that is no multiple
    of Q (S = 22, Q = 4)."""
    _, cfg, _, model = lm
    toks = np.random.default_rng(int(divisor)).integers(
        0, cfg.vocab_size, (2, 22))
    eng = Engine(cfg, model, EngineConfig(max_seq=32, min_chunk=1,
                                          init_divisor=divisor),
                 device="cpu")
    logits, cache, log = eng.prefill_chunked(toks)
    one_shot, one_cache = M.prefill(cfg, model, {"tokens": _t(toks)})
    assert torch.equal(logits, one_shot)
    _trees_equal(cache, one_cache)
    assert eng.n_prefill_fallbacks == 0
    assert (len(log) > 1) == (divisor > 1.0)
    assert sum(c["chunk"] for c in log) == 22
    assert all(c["chunk"] % 4 == 0 for c in log[:-1])


def test_engine_serves_ssm_past_max_seq_and_refuses_the_batcher(lm):
    """A recurrent-only pattern has no attention cache for `max_seq` to
    bound, so a prompt longer than it is served, through `generate` and
    through the per-request batcher surface alike (the same tokens); that
    surface refuses a decode before the prefill's first token."""
    _, cfg, _, model = lm
    eng = Engine(cfg, model, EngineConfig(max_seq=8), device="cpu")
    prompt = np.ones((1, 12), np.int32)
    ids, _ = eng.generate(prompt, n_new=3)
    assert ids.shape == (1, 3)
    st = RequestState(request=Request(req_id=0, tokens=prompt, n_new=3))
    with pytest.raises(ValueError, match="decode_one before prefill"):
        eng.decode_one(st)
    eng.start_request(st)
    while st.remaining_prefill:
        eng.prefill_chunk_step(st, 5)
    while len(st.out_tokens) < 3:
        eng.decode_one(st)
    assert st.out_tokens == ids[0].tolist()


def test_extend_refuses_what_it_does_not_run():
    _, zamba = reduced(get_arch("zamba2-1.2b")), get_arch("zamba2-1.2b")
    assert not M.extend_cache_specs_ok(zamba)
    assert M.extend_cache_specs_ok(get_arch("xlstm-350m"))
    with pytest.raises(NotImplementedError, match="does not extend"):
        M.empty_extend_cache(zamba, 1, 8, device="cpu")
    with pytest.raises(NotImplementedError, match="does not extend"):
        M.prefill_extend(zamba, None, torch.zeros((1, 4), dtype=torch.long),
                         [], 0)
    with pytest.raises(NotImplementedError, match="later slice"):
        M.init_params(dataclasses.replace(get_arch("xlstm-350m"),
                                          block_pattern=("X", "A")),
                      device="cpu")
