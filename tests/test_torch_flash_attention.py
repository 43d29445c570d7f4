"""The port's flash attention (its plain version: these tests run on the
CPU) against the JAX reference: the Pallas kernel in interpret mode,
`attention_ref`, the ragged `flash_attention_op` and the sliding-window
`blockwise_attention` the reference's model path calls.

Inputs come from numpy seeds and go to both packages. Tolerance 2e-5 in
float32 and 2e-2 in bfloat16, the reference's own
(tests/test_kernels.py:23-24): both sides compute in float32 and differ
in summation order only; 3e-5 against the ragged op, as the reference's
own test of it."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _tf32 import product, tf32

from repro.kernels.flash_attention.flash_attention import \
    flash_attention as ref_flash
from repro.kernels.flash_attention.ops import flash_attention_op
from repro.kernels.flash_attention.ref import attention_ref as ref_attention
from repro.models.attention import blockwise_attention
from repro_torch.kernels.flash_attention import flash_attention as K
from repro_torch.kernels.flash_attention.ref import attention_ref

SHAPES = [(1, 64, 2, 2, 64), (2, 128, 4, 2, 64), (1, 256, 8, 8, 128),
          (2, 192, 6, 3, 64), (1, 512, 4, 1, 128)]   # test_kernels.py:28-34


def _tol(dtype):
    return 2e-2 if dtype == "bfloat16" else 2e-5


def _qkv(B, Sq, Skv, Hq, Hkv, dh, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, Hq, dh)).astype(np.float32),
            rng.standard_normal((B, Skv, Hkv, dh)).astype(np.float32),
            rng.standard_normal((B, Skv, Hkv, dh)).astype(np.float32))


def _port(arrays, dtype="float32", **kw):
    t = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]
    return K.flash_attention(*t, **kw).float().numpy()


@pytest.mark.parametrize("B,S,Hq,Hkv,dh", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_reference_kernel(B, S, Hq, Hkv, dh, dtype):
    arrays = _qkv(B, S, S, Hq, Hkv, dh, seed=S + Hq)
    jx = [jnp.asarray(a, getattr(jnp, dtype)) for a in arrays]
    ref = ref_flash(*jx, causal=True, q_block=64, kv_block=64,
                    interpret=True)
    np.testing.assert_allclose(_port(arrays, dtype), np.asarray(ref,
                                                                np.float32),
                               rtol=_tol(dtype), atol=_tol(dtype))


@pytest.mark.parametrize("causal", [True, False])
def test_plain_matches_reference_oracles(causal):
    arrays = _qkv(2, 128, 128, 4, 2, 64, seed=1)
    ours = _port(arrays, causal=causal)
    jx = [jnp.asarray(a) for a in arrays]
    np.testing.assert_allclose(ours, np.asarray(ref_attention(
        *jx, causal=causal)), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(ours, np.asarray(ref_flash(
        *jx, causal=causal, q_block=64, kv_block=64, interpret=True)),
        rtol=2e-5, atol=2e-5)
    # the port's own oracle (K/V repeated, no blocking) agrees too
    np.testing.assert_allclose(ours, attention_ref(
        *(torch.from_numpy(a) for a in arrays), causal=causal).numpy(),
        rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("S", [100, 37])
def test_ragged_sequence_matches_reference_op(S):
    arrays = _qkv(1, S, S, 4, 2, 64, seed=S)
    ref = flash_attention_op(*(jnp.asarray(a) for a in arrays), q_block=32,
                             kv_block=32, interpret=True)
    np.testing.assert_allclose(_port(arrays), np.asarray(ref), rtol=3e-5,
                               atol=3e-5)


@pytest.mark.parametrize("Sq,Skv,rep,window,causal", [
    (96, 96, 1, 32, True), (150, 150, 2, 32, True), (150, 150, 4, 7, True),
    (64, 100, 2, 32, False), (80, 80, 1, 0, False), (80, 120, 2, 0, True)])
def test_window_matches_blockwise_attention(Sq, Skv, rep, window, causal):
    arrays = _qkv(2, Sq, Skv, 2 * rep, 2, 64, seed=Sq + window)
    ref = blockwise_attention(*(jnp.asarray(a) for a in arrays),
                              causal=causal, window=window, q_block=32,
                              kv_block=48)
    np.testing.assert_allclose(_port(arrays, causal=causal, window=window),
                               np.asarray(ref), rtol=2e-5, atol=2e-5)


def test_plain_refuses_what_it_does_not_define():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 8, 8, 4, 2, 64, 0))
    with pytest.raises(ValueError, match="Hq % Hkv"):
        K.flash_attention(q, k[:, :, :1].expand(1, 8, 3, 64), v)
    with pytest.raises(ValueError, match="window must be"):
        K.flash_attention(q, k, v, window=-1)
    with pytest.raises(ValueError, match="Sq <= Skv"):
        K.flash_attention(q, k[:, :4], v[:, :4], window=2)
    K.reset_launches()
    K.flash_attention(q, k, v)
    assert K.LAUNCHES == {"flash_attention": 0}


# ------------------------------------ the card's float32 path, in numpy
# csrc/flash_attention.cu runs q.k^T and p.v on the tensor cores in the
# 3xTF32 split (tests/_tf32.py models it) over blocks of 64 keys: each
# block's scores, an online softmax, the block's p.v summed from zero and
# then added to the rescaled accumulator. These tests hold that algorithm,
# at Zamba2's head width (64) and S >= 512, against float64 within the
# float32 bar of 2e-5; one TF32 pass would not keep it.
KEY_BLOCK = 64


def _flash_blocks(q, k, v, *, causal, passes):
    """One (S, dh) head as the card's kernel computes it, products by
    `_tf32.product` with `passes` TF32 passes; float32 elsewhere."""
    Sq, dh = q.shape
    Skv = k.shape[0]
    scale = np.float32(dh ** -0.5)
    m = np.full(Sq, -1e30, np.float32)
    l = np.zeros(Sq, np.float32)
    acc = np.zeros((Sq, dh), np.float32)
    rows = np.arange(Sq)[:, None]
    for k0 in range(0, Skv, KEY_BLOCK):
        kb, vb = k[k0:k0 + KEY_BLOCK], v[k0:k0 + KEY_BLOCK]
        s = product(q, kb.T, passes).astype(np.float32) * scale
        if causal:
            cols = k0 + np.arange(kb.shape[0])[None, :]
            s = np.where(cols <= rows, s, np.float32(-1e30))
        m_new = np.maximum(m, s.max(axis=1))
        corr = np.exp(m - m_new)
        p = np.exp(s - m_new[:, None]).astype(np.float32)
        l = l * corr + p.sum(axis=1, dtype=np.float32)
        pv = product(p, vb, passes).astype(np.float32)   # from zero
        acc = (acc * corr[:, None] + pv).astype(np.float32)
        m = m_new
    return acc / np.maximum(l, np.float32(1e-20))[:, None]


def _attention64(q, k, v, *, causal):
    q, k, v = (a.astype(np.float64) for a in (q, k, v))
    s = q @ k.T * q.shape[1] ** -0.5
    if causal:
        s = np.where(np.tril(np.ones(s.shape, bool)), s, -np.inf)
    p = np.exp(s - s.max(axis=1, keepdims=True))
    return (p / p.sum(axis=1, keepdims=True)) @ v


@pytest.mark.parametrize("S,causal", [(512, True), (512, False),
                                      (1024, True), (2048, True)])
def test_3xtf32_blocks_keep_the_float32_bar(S, causal):
    q, k, v = (a[0, :, 0] for a in _qkv(1, S, S, 1, 1, 64, seed=S))
    ref = _attention64(q, k, v, causal=causal)
    three = _flash_blocks(q, k, v, causal=causal, passes=3)
    assert np.abs(three - ref).max() < 2e-5 / 4
    np.testing.assert_allclose(three, ref, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_one_tf32_pass_breaks_the_float32_bar(causal):
    q, k, v = (a[0, :, 0] for a in _qkv(1, 512, 512, 1, 1, 64, seed=7))
    one = _flash_blocks(q, k, v, causal=causal, passes=1)
    ref = _attention64(q, k, v, causal=causal)
    assert not np.allclose(one, ref, rtol=2e-5, atol=2e-5)


def test_bfloat16_values_are_exact_in_tf32():
    """The bfloat16 path takes one TF32 pass: its inputs lose nothing."""
    x = torch.randn(4096, generator=torch.Generator().manual_seed(0))
    b = x.bfloat16().float().numpy()
    np.testing.assert_array_equal(tf32(b), b)
    # while float32 values do lose their low 13 bits
    assert not np.array_equal(tf32(x.numpy()), x.numpy())
