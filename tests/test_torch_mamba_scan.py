"""The port's SSD scan (its plain version: these tests run on the CPU)
against the JAX reference: the Pallas kernel in interpret mode, `ssd_ref`
(the XLA chunked scan) with its state layout, the padded `mamba_scan_op`,
the sequential recurrence of tests/test_kernels.py:211, and the model's
`chunked_gated_scan` with `state=` and `exact_chunk=`.

Inputs come from numpy seeds and go to both packages. Tolerance 2e-4,
the reference's own for float32 (tests/test_kernels.py:206-209): both
sides compute in float32 and differ in summation order (and, against the
sequential recurrence, in association)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.mamba_scan.mamba_scan import mamba_scan as ref_scan
from repro.kernels.mamba_scan.ops import mamba_scan_op
from repro.kernels.mamba_scan.ref import ssd_ref
from repro.models.ssm import chunked_gated_scan as ref_chunked
from repro_torch.kernels.mamba_scan import mamba_scan as K
from repro_torch.kernels.mamba_scan.ref import ssd_sequential_ref
from repro_torch.models.ssm import chunked_gated_scan

TOL = 2e-4
SHAPES = [(1, 128, 2, 16, 32, 64), (2, 256, 3, 16, 32, 64),
          (1, 256, 1, 64, 64, 128), (2, 128, 4, 8, 16, 128)]


def _inputs(B, S, H, N, Pd, seed, decay=0.2):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, H, N)).astype(np.float32),
            rng.standard_normal((B, S, H, N)).astype(np.float32),
            rng.standard_normal((B, S, H, Pd)).astype(np.float32),
            (-np.abs(rng.standard_normal((B, S, H))) * decay).astype(
                np.float32))


def _t(arrays):
    return [torch.from_numpy(a) for a in arrays]


def _close(port, ref, tol=TOL):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("B,S,H,N,Pd,chunk", SHAPES)
def test_plain_matches_reference_kernel_and_oracle(B, S, H, N, Pd, chunk):
    arrays = _inputs(B, S, H, N, Pd, seed=S + N)
    y, st = K.mamba_scan(*_t(arrays), chunk=chunk)
    jx = [jnp.asarray(a) for a in arrays]
    y_ref, st_ref = ref_scan(*jx, chunk=chunk, interpret=True)
    _close(y, y_ref)
    _close(st, st_ref)       # kernel layout (B, H, N, Pd)
    y_o, st_o = ssd_ref(*jx, chunk=chunk)
    _close(y, y_o)
    _close(st, st_o)
    assert st.dtype == torch.float32 and tuple(st.shape) == (B, H, N, Pd)


@pytest.mark.parametrize("S,chunk", [(100, 32), (37, 16), (5, 8)])
def test_ragged_sequence_matches_reference_op(S, chunk):
    arrays = _inputs(2, S, 3, 8, 16, seed=S)
    y, st = K.mamba_scan(*_t(arrays), chunk=chunk)
    y_ref, st_ref = mamba_scan_op(*(jnp.asarray(a) for a in arrays),
                                  chunk=chunk, interpret=True)
    _close(y, y_ref)
    _close(st, st_ref)


def test_plain_matches_sequential_recurrence():
    """The reference's end-to-end oracle (test_kernels.py:211): y and the
    state of the step-by-step recurrence, here in float64."""
    arrays = _inputs(1, 64, 2, 8, 16, seed=11, decay=0.3)
    y, st = K.mamba_scan(*_t(arrays), chunk=32)
    y64, st64 = ssd_sequential_ref(*_t(arrays))
    np.testing.assert_allclose(y.numpy(), y64.numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(st.numpy(), st64.numpy(), rtol=1e-4,
                               atol=1e-4)
    # and the reference kernel meets the same oracle
    y_ref, _ = ref_scan(*(jnp.asarray(a) for a in arrays), chunk=32,
                        interpret=True)
    np.testing.assert_allclose(np.asarray(y_ref), y64.numpy(), rtol=1e-4,
                               atol=1e-4)


def test_shared_heads_broadcast_as_the_model_passes_them():
    """Zamba2 shares B/C across heads: q/k expanded with a head stride of
    0 give the same result as materialised copies."""
    q, k, v, la = _inputs(2, 48, 4, 8, 16, seed=3)
    qs, ks = _t([q[:, :, :1], k[:, :, :1]])
    y, st = K.mamba_scan(qs.expand(2, 48, 4, 8), ks.expand(2, 48, 4, 8),
                         *_t([v, la]), chunk=16)
    y_m, st_m = K.mamba_scan(qs.expand(2, 48, 4, 8).contiguous(),
                             ks.expand(2, 48, 4, 8).contiguous(),
                             *_t([v, la]), chunk=16)
    assert torch.equal(y, y_m) and torch.equal(st, st_m)


@pytest.mark.parametrize("S,chunk,exact", [(40, 16, False), (40, 16, True),
                                           (10, 16, True), (10, 16, False)])
def test_chunked_gated_scan_matches_reference(S, chunk, exact):
    q, k, v, la = _inputs(2, S, 3, 8, 16, seed=S + chunk)
    state = np.random.default_rng(1).standard_normal(
        (2, 3, 16, 8)).astype(np.float32)            # (B, H, Pd, N)
    for st in (None, state):
        y, s_out = chunked_gated_scan(
            *_t([q, k, v, la]), state=None if st is None else
            torch.from_numpy(st), chunk=chunk, exact_chunk=exact)
        y_ref, s_ref = ref_chunked(
            *(jnp.asarray(a) for a in (q, k, v, la)),
            state=None if st is None else jnp.asarray(st), chunk=chunk,
            exact_chunk=exact)
        _close(y, y_ref)
        _close(s_out, s_ref)       # model layout (B, H, Pd, N)


def test_plain_refuses_bad_shapes_and_launches_nothing():
    q, k, v, la = _t(_inputs(1, 8, 2, 4, 4, seed=0))
    with pytest.raises(ValueError, match="log_a"):
        K.mamba_scan(q, k, v, la[:, :4], chunk=4)
    with pytest.raises(ValueError, match="chunk"):
        K.mamba_scan(q, k, v, la, chunk=0)
    K.reset_launches()
    K.mamba_scan(q, k, v, la, chunk=4)
    assert K.LAUNCHES == {"mamba_scan": 0}


# ------------------------------------ the card's chunk decomposition, in numpy
# csrc/mamba_scan.cu computes the scan in four steps that are parallel over
# (batch row, head, chunk) but for the third, an elementwise walk over the
# chunks: (1) l per chunk and the raw score tiles q_i . k_j (once per batch
# row when q and k are shared by all heads); (2) per chunk, the intra-chunk
# y and the chunk's own state dS_c; (3) S_c = exp(total_c) S_{c-1} + dS_c;
# (4) y_i += exp(l_i) q_i . S_{c-1}. This is that algebra in float32
# numpy, held against the reference kernel (interpret mode) and ssd_ref.
def _decomposed(q, k, v, log_a, chunk, shared):
    B, S, H, N = q.shape
    Pd = v.shape[-1]
    Q = chunk
    nc = -(-S // Q)
    pad = nc * Q - S
    padded = [np.pad(a, [(0, 0), (0, pad)] + [(0, 0)] * (a.ndim - 2))
              for a in (q, k, v, log_a)]
    qc, kc, vc, lac = (a.reshape(B, nc, Q, *a.shape[2:]) for a in padded)
    l = np.cumsum(lac, axis=2, dtype=np.float32)          # (B, nc, Q, H)
    total = l[:, :, -1]                                    # (B, nc, H)
    causal = np.tril(np.ones((Q, Q), bool))
    if shared:   # step 1: the raw scores once per (b, chunk), head 0
        cb = np.einsum("bcin,bcjn->bcij", qc[:, :, :, 0], kc[:, :, :, 0])
        cb = np.broadcast_to(cb[:, :, None], (B, nc, H, Q, Q))
    else:
        cb = np.einsum("bcihn,bcjhn->bchij", qc, kc)
    lh = l.transpose(0, 1, 3, 2)                           # (B, nc, H, Q)
    decay = np.exp(np.clip(lh[..., :, None] - lh[..., None, :], -60, 0))
    s = np.where(causal, cb * decay, 0).astype(np.float32)
    y = np.einsum("bchij,bcjhp->bcihp", s, vc)             # step 2: intra
    w = np.exp(np.clip(total[:, :, None] - l, -60, 0))     # (B, nc, Q, H)
    dS = np.einsum("bcjhn,bcjhp->bchnp", kc * w[..., None], vc)
    S_prev = np.zeros((B, nc, H, N, Pd), np.float32)       # step 3
    st = np.zeros((B, H, N, Pd), np.float32)
    for c in range(nc):
        S_prev[:, c] = st
        st = st * np.exp(total[:, c])[..., None, None] + dS[:, c]
    y = y + np.einsum("bcihn,bchnp->bcihp", qc, S_prev) \
        * np.exp(l)[..., None]                             # step 4: inter
    return y.reshape(B, nc * Q, H, Pd)[:, :S].astype(np.float32), st


@pytest.mark.parametrize("S,H,N,Pd,chunk,shared", [
    (128, 2, 16, 32, 64, True), (128, 2, 16, 32, 64, False),
    (256, 3, 16, 32, 64, True), (100, 2, 8, 16, 32, False),
    (37, 3, 8, 16, 16, True), (60, 2, 8, 16, 7, False),
    (20, 2, 8, 16, 1, True), (144, 2, 8, 16, 16, True)])
def test_chunk_decomposition_matches_reference(S, H, N, Pd, chunk, shared):
    q, k, v, la = _inputs(2, S, H, N, Pd, seed=S + chunk)
    if shared:
        q, k = (np.ascontiguousarray(np.broadcast_to(a[:, :, :1], a.shape))
                for a in (q, k))
    y, st = _decomposed(q, k, v, la, chunk, shared)
    jx = [jnp.asarray(a) for a in (q, k, v, la)]
    y_op, st_op = mamba_scan_op(*jx, chunk=chunk, interpret=True)
    _close(torch.from_numpy(y), y_op)
    _close(torch.from_numpy(st), st_op)
    if S % chunk == 0:
        y_o, st_o = ssd_ref(*jx, chunk=chunk)
        _close(torch.from_numpy(y), y_o)
        _close(torch.from_numpy(st), st_o)
