"""The gradient of the port's flash attention on the CPU: its
`torch.autograd.Function` (forward `flash_attention_lse`, backward
`flash_attention_backward`, both their plain versions here: the CUDA
kernels run in tests/test_torch_cuda.py) against autograd through
`flash_attention_plain` and against `jax.grad` through the reference's
`full_attention` and `blockwise_attention`, the two functions whose
automatic derivative the reference's training loss takes.

Inputs come from numpy seeds. Tolerance 1e-5 in float32, absolute and
relative (every side computes in float32 and differs in summation order
only; the gradients are O(1)); 2e-2 in bfloat16 (the reference's
bfloat16 kernel bar, tests/test_kernels.py:23-24: the outputs' rounding).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.attention import blockwise_attention, full_attention
from repro_torch.kernels.flash_attention import flash_attention as K
from repro_torch.kernels.flash_attention import flash_attention_bwd as KB

TOL = 1e-5
# name: (B, Sq, Skv, Hq, Hkv, dh, causal, window)
CASES = {
    "gqa2-causal": (2, 40, 40, 4, 2, 16, True, 0),
    "gqa4-noncausal": (1, 33, 33, 4, 1, 16, False, 0),
    "mha-causal": (1, 29, 29, 3, 3, 16, True, 0),
    "window-causal": (2, 50, 50, 4, 2, 16, True, 7),
    "window-noncausal": (1, 30, 44, 2, 1, 16, False, 9),
    "ragged-noncausal": (2, 24, 37, 6, 2, 16, False, 0),
    "ragged-causal-short-q": (1, 30, 45, 4, 2, 16, True, 0),
    "ragged-causal-long-q": (1, 45, 30, 4, 2, 16, True, 0),
    "dh64-gqa6": (1, 70, 70, 6, 1, 64, True, 0),
    "dh64-noncausal": (2, 20, 26, 2, 2, 64, False, 0),
}


def _inputs(case, seed):
    B, Sq, Skv, Hq, Hkv, dh, _, _ = CASES[case]
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in
            ((B, Sq, Hq, dh), (B, Skv, Hkv, dh), (B, Skv, Hkv, dh),
             (B, Sq, Hq, dh))]


def _port_grads(arrays, fn, dtype=torch.float32, **kw):
    q, k, v, g = (torch.from_numpy(a).to(dtype) for a in arrays)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    out = fn(q, k, v, **kw)
    return [out] + list(torch.autograd.grad(out, (q, k, v), g))


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(a.detach().float().numpy(),
                               np.asarray(b, np.float32), rtol=tol, atol=tol)


@pytest.mark.parametrize("case", sorted(CASES))
def test_function_matches_autograd_through_plain(case):
    *_, causal, window = CASES[case]
    arrays = _inputs(case, seed=len(case))
    K.reset_launches()
    KB.reset_launches()
    ours = _port_grads(arrays, K.flash_attention, causal=causal,
                       window=window)
    plain = _port_grads(arrays, K.flash_attention_plain, causal=causal,
                        window=window)
    assert ours[0].grad_fn is not None and \
        type(ours[0].grad_fn).__name__ == "FlashAttentionFnBackward"
    for a, b in zip(ours, plain):
        _close(a, b.detach().numpy())
    # plain versions on the CPU: no kernel launched
    assert K.LAUNCHES == {"flash_attention": 0}
    assert KB.LAUNCHES == {"flash_attention_bwd": 0}


def _ref_grads(arrays, impl, causal, window):
    q, k, v, g = (jnp.asarray(a) for a in arrays)
    if impl == "full":
        def f(q, k, v):
            return full_attention(q, k, v, causal=causal, window=window)
    else:
        def f(q, k, v):
            return blockwise_attention(q, k, v, causal=causal, window=window,
                                       q_block=16, kv_block=16)

    @jax.jit
    def out_and_grads(q, k, v, g):
        out, vjp = jax.vjp(f, q, k, v)
        return (out, *vjp(g))
    return list(out_and_grads(q, k, v, g))


# the reference's full_attention applies a window only with the causal
# mask: a non-causal window is held against blockwise_attention alone
@pytest.mark.parametrize("case,impl", [
    (case, impl) for case in sorted(CASES) for impl in ("full", "blockwise")
    if impl == "blockwise" or CASES[case][6] or not CASES[case][7]])
def test_function_matches_jax_grad_of_the_reference(case, impl):
    *_, causal, window = CASES[case]
    arrays = _inputs(case, seed=len(case) + 1)
    ours = _port_grads(arrays, K.flash_attention, causal=causal,
                       window=window)
    for a, b in zip(ours, _ref_grads(arrays, impl, causal, window)):
        _close(a, b)


@pytest.mark.parametrize("case", ["gqa2-causal", "window-causal",
                                  "ragged-noncausal"])
def test_bfloat16_function_matches_autograd_through_plain(case):
    *_, causal, window = CASES[case]
    arrays = _inputs(case, seed=3)
    ours = _port_grads(arrays, K.flash_attention, torch.bfloat16,
                       causal=causal, window=window)
    plain = _port_grads(arrays, K.flash_attention_plain, torch.bfloat16,
                        causal=causal, window=window)
    for a, b in zip(ours, plain):
        assert a.dtype == torch.bfloat16
        _close(a, b.detach().float().numpy(), tol=2e-2)


@pytest.mark.parametrize("case", ["gqa2-causal", "window-noncausal",
                                  "ragged-causal-long-q"])
def test_plain_lse_is_the_logsumexp_of_the_kept_scores(case):
    B, Sq, Skv, Hq, Hkv, dh, causal, window = CASES[case]
    q, k, v, _ = _inputs(case, seed=5)
    out, lse = K.flash_attention_lse(*(torch.from_numpy(a)
                                       for a in (q, k, v)),
                                     causal=causal, window=window)
    assert lse.shape == (B, Hq, Sq) and lse.dtype == torch.float32
    # float64 on the host, K/V repeated to Hq heads
    rep = Hq // Hkv
    s = np.einsum("bqhd,bkhd->bhqk", q.astype(np.float64),
                  np.repeat(k, rep, axis=2).astype(np.float64)) * dh ** -0.5
    i, j = np.arange(Sq)[:, None], np.arange(Skv)[None, :]
    keep = np.ones((Sq, Skv), bool)
    if causal:
        keep &= j <= i
    if window:
        keep &= j > i - window
    s = np.where(keep, s, -np.inf)
    mx = s.max(-1, keepdims=True)
    ref = np.log(np.exp(s - mx).sum(-1)) + mx[..., 0]
    np.testing.assert_allclose(lse.numpy(), ref, rtol=TOL, atol=TOL)
    _close(out, K.flash_attention_plain(
        *(torch.from_numpy(a) for a in (q, k, v)), causal=causal,
        window=window).numpy())


def test_backward_refuses_a_query_offset_and_bad_shapes():
    q, k, v, g = (torch.from_numpy(a) for a in _inputs("gqa2-causal", 0))
    out, lse = K.flash_attention_lse(q, k, v)
    with pytest.raises(ValueError, match="q_offset=3"):
        KB.flash_attention_backward(q, k, v, out, g, lse, q_offset=3)
    with pytest.raises(ValueError, match="lse must have shape"):
        KB.flash_attention_backward(q, k, v, out, g, lse[:, :1])
    with pytest.raises(ValueError, match="dout must have"):
        KB.flash_attention_backward(q, k, v, out, g[:, 1:], lse)
    qg = q.clone().requires_grad_()
    with pytest.raises(ValueError, match="no query offset"):
        K.flash_attention(qg, k, v, causal=False, q_offset=2)


def test_serving_calls_take_no_gradient_path():
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs("gqa2-causal", 1))
    plain = K.flash_attention_plain(q, k, v)
    # grad mode on, nothing requires grad: the plain forward, no graph
    out = K.flash_attention(q, k, v)
    assert out.grad_fn is None and torch.equal(out, plain)
    # an input that requires grad under no_grad: the same, from an offset
    with torch.no_grad():
        out = K.flash_attention(q.requires_grad_(), k, v)
        assert out.grad_fn is None and torch.equal(out, plain)
        off = K.flash_attention(q[:, 30:], k, v, q_offset=30)
    assert torch.equal(off, plain[:, 30:])
