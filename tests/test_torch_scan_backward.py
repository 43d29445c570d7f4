"""The SSD scan's gradient on the CPU: `MambaScanFn` (which runs
`mamba_scan_backward_plain`, the backward kernel's formulas) against
`jax.vjp` of the reference's `repro.models.ssm.chunked_gated_scan` and
against autograd of the float64 step-by-step oracle
`kernels/mamba_scan/ref.py:ssd_sequential_ref`, on the same numpy-seeded
inputs and output gradient.

Cases: several chunks, a ragged last chunk, q and k shared by the heads
((B, S, 1, N), and expanded with a head stride of 0), N = 32 with Pd = 33
(mLSTM's ones channel), and log_a that reaches the -60 clip of the
decays. Tolerance: every gradient within 1e-4 of its largest reference
element (float32 on both sides in other summation orders; the float64
oracle has no clip, and a clipped decay is below exp(-60) of its term).

The bfloat16 kernels' arithmetic: `tests/_scan_bwd_bf16.py` mirrors their
rounding of float32 operands (split in two bfloat16 values, or rounded
once) on bfloat16 inputs at a Zamba2-like shape (q and k shared, N = Pd =
64) and an xlstm-like one (N 128, Pd 129), both with a ragged last chunk:
the split holds every gradient within 1e-4 of `mamba_scan_backward_plain`
's max, and one rounding puts dlog_a past that bar.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _scan_bwd_bf16 import mirror_backward
from repro.models.ssm import chunked_gated_scan as ref_scan
from repro_torch.kernels.mamba_scan import mamba_scan as K
from repro_torch.kernels.mamba_scan import mamba_scan_bwd as KB
from repro_torch.kernels.mamba_scan.ref import ssd_sequential_ref
from repro_torch.models.ssm import chunked_gated_scan

TOL = 1e-4
# name -> (B, S, H, N, Pd, chunk, q and k shared, largest -log_a a step)
CASES = {
    "chunks": (2, 64, 3, 8, 16, 16, False, 0.5),
    "ragged": (2, 37, 2, 8, 9, 16, False, 0.5),
    "shared": (2, 40, 4, 8, 16, 16, True, 0.5),
    "mlstm-ones-channel": (1, 48, 2, 32, 33, 16, False, 0.5),
    "clip": (2, 37, 2, 8, 8, 16, False, 8.0),   # l down to ~-128
    "one-chunk": (1, 12, 2, 4, 5, 16, False, 0.5),
}


def _inputs(B, S, H, N, Pd, shared, decay, seed):
    rng = np.random.default_rng(seed)
    hq = 1 if shared else H
    return (rng.standard_normal((B, S, hq, N)).astype(np.float32),
            rng.standard_normal((B, S, hq, N)).astype(np.float32),
            rng.standard_normal((B, S, H, Pd)).astype(np.float32),
            -rng.uniform(0.01, decay, (B, S, H)).astype(np.float32),
            rng.standard_normal((B, S, H, Pd)).astype(np.float32))


def _ref_grads(case, arrays):
    """jax.vjp of the reference's chunked_gated_scan (shared q and k
    broadcast to every head inside, so their gradient sums over heads)."""
    B, S, H, N, _, chunk, shared, _ = CASES[case]
    q, k, v, la, dy = (jnp.asarray(a) for a in arrays)

    def f(q_, k_, v_, la_):
        if shared:
            q_ = jnp.broadcast_to(q_, (B, S, H, N))
            k_ = jnp.broadcast_to(k_, (B, S, H, N))
        return ref_scan(q_, k_, v_, la_, chunk=chunk)[0]
    _, vjp = jax.vjp(f, q, k, v, la)
    return [np.asarray(g) for g in vjp(dy)]


def _oracle_grads(case, arrays):
    """Autograd of the float64 sequential recurrence."""
    B, S, H, N = CASES[case][:4]
    xs = [torch.from_numpy(a).double().requires_grad_() for a in arrays[:4]]
    q, k = xs[0].expand(B, S, H, N), xs[1].expand(B, S, H, N)
    y, _ = ssd_sequential_ref(q, k, xs[2], xs[3])
    return [g.numpy() for g in torch.autograd.grad(
        y, xs, torch.from_numpy(arrays[4]).double())]


def _port_grads(case, arrays, expand=False):
    B, S, H, N, _, chunk = CASES[case][:6]
    xs = [torch.from_numpy(a).requires_grad_() for a in arrays[:4]]
    q, k = xs[0], xs[1]
    if expand:   # a head stride of 0, as a (B, S, H, N) view
        q, k = q.expand(B, S, H, N), k.expand(B, S, H, N)
    KB.reset_launches()
    y, st = K.mamba_scan(q, k, xs[2], xs[3], chunk=chunk)
    assert y.grad_fn is not None and not st.requires_grad
    grads = torch.autograd.grad(y, xs, torch.from_numpy(arrays[4]))
    assert KB.LAUNCHES == {"mamba_scan_bwd": 0}   # the plain formulas
    return [g.numpy() for g in grads]


def _close(ours, refs, label):
    for name, a, b in zip(("dq", "dk", "dv", "dlog_a"), ours, refs):
        assert a.shape == b.shape, (label, name)
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=TOL * np.abs(b).max() + 1e-30,
                                   err_msg=f"{label} {name}")


@pytest.mark.parametrize("case", sorted(CASES))
def test_gradients_match_jax_vjp_and_the_float64_oracle(case):
    arrays = _inputs(*CASES[case][:5], *CASES[case][6:], seed=len(case))
    ours = _port_grads(case, arrays)
    _close(ours, _ref_grads(case, arrays), f"{case} vs jax.vjp")
    _close(ours, _oracle_grads(case, arrays), f"{case} vs float64")
    if CASES[case][6]:   # the same gradients through a head-stride-0 view
        _close(_port_grads(case, arrays, expand=True), ours,
               f"{case} expanded")


def test_clip_case_reaches_the_clip():
    """The clip case's decays run below -60 inside a chunk, so the clip
    (and its zero gradient) is exercised."""
    B, S, H, N, Pd, chunk, shared, decay = CASES["clip"]
    la = _inputs(B, S, H, N, Pd, shared, decay, seed=len("clip"))[3]
    l = np.cumsum(la[:, :chunk], axis=1)
    assert float((l[:, -1] - l[:, 0]).min()) < -60.0


def test_plain_backward_takes_the_saved_states():
    """`mamba_scan_backward_plain` from the forward's kept states and l
    equals the Function's gradients bit for bit (the Function's backward
    is that call), and the chunked model wrapper trains through it."""
    case = "ragged"
    B, S, H, N, Pd, chunk, shared, decay = CASES[case]
    arrays = _inputs(B, S, H, N, Pd, shared, decay, seed=1)
    q, k, v, la, dy = (torch.from_numpy(a) for a in arrays)
    y, final, st, lc = K._plain_chunks(q, k, v, la, chunk, None)
    assert tuple(st.shape) == (B, H, 3, N, Pd)
    assert tuple(lc.shape) == (B, H, 3, chunk)
    assert torch.equal(st[:, :, 0], torch.zeros_like(st[:, :, 0]))
    plain = KB.mamba_scan_backward_plain(q, k, v, dy, st, lc, chunk=chunk)
    ours = _port_grads(case, arrays)
    for a, b in zip(plain, ours):
        assert np.array_equal(a.numpy(), b)
    # the model's layout: chunked_gated_scan carries the gradient too
    xs = [t.clone().requires_grad_() for t in (q, k, v, la)]
    y_m, _ = chunked_gated_scan(*xs, chunk=chunk)
    g_m = torch.autograd.grad(y_m, xs, dy)
    for a, b in zip(g_m, ours):
        assert np.array_equal(a.numpy(), b)


def test_a_state_in_grad_mode_raises_and_no_grad_takes_it():
    B, S, H, N, Pd, chunk, shared, decay = CASES["chunks"]
    q, k, v, la, _ = (torch.from_numpy(a) for a in
                      _inputs(B, S, H, N, Pd, shared, decay, seed=2))
    state = torch.zeros((B, H, N, Pd))
    with pytest.raises(ValueError, match="zero state"):
        K.mamba_scan(q.requires_grad_(), k, v, la, chunk=chunk, state=state)
    with torch.no_grad():
        y, _ = K.mamba_scan(q, k, v, la, chunk=chunk, state=state)
    assert y.grad_fn is None
    y0, _ = K.mamba_scan(q.detach(), k, v, la, chunk=chunk, state=state)
    assert torch.equal(y, y0)


def test_backward_refuses_bad_shapes():
    B, S, H, N, Pd, chunk, shared, decay = CASES["chunks"]
    q, k, v, la, dy = (torch.from_numpy(a) for a in
                       _inputs(B, S, H, N, Pd, shared, decay, seed=3))
    _, _, st, lc = K._plain_chunks(q, k, v, la, chunk, None)
    with pytest.raises(ValueError, match="st must be"):
        KB.mamba_scan_backward(q, k, v, dy, st[:, :, :1], lc, chunk=chunk)
    with pytest.raises(ValueError, match="dy"):
        KB.mamba_scan_backward(q, k, v, dy[..., :1], st, lc, chunk=chunk)
    with pytest.raises(ValueError, match="all on CUDA"):
        KB.mamba_scan_backward(q, k, v, dy, st.to("meta"), lc, chunk=chunk)


# name -> (B, S, H, N, Pd, chunk, q and k shared) for the bfloat16 mirror
BF16_CASES = {
    "zamba2-like": (1, 300, 4, 64, 64, 128, True),
    "xlstm-like": (1, 300, 2, 128, 129, 128, False),
}


def _bf16_case(case):
    """bfloat16 inputs from a numpy seed, the forward's kept states and l,
    the mirror's float32 gradients split and rounded once, and the plain
    version's on the same values in float32."""
    B, S, H, N, Pd, chunk, shared = BF16_CASES[case]
    rng = np.random.default_rng(len(case))
    hq = 1 if shared else H

    def bf16(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale)
                                .astype(np.float32)).bfloat16()
    q, k = bf16(B, S, hq, N, scale=N ** -0.5), bf16(B, S, hq, N,
                                                    scale=N ** -0.5)
    v, dy = bf16(B, S, H, Pd), bf16(B, S, H, Pd)
    la = torch.from_numpy(-rng.uniform(0.0, 0.3, (B, S, H)).astype(
        np.float32))
    _, _, st, lc = K._plain_chunks(q, k, v, la, chunk, None)
    plain = KB.mamba_scan_backward_plain(q.float(), k.float(), v.float(),
                                         dy.float(), st, lc, chunk=chunk)
    return ({split: mirror_backward(q, k, v, dy, st, lc, chunk=chunk,
                                    split=split) for split in (True, False)},
            plain)


def _share_of_max(a, b):
    return float((a - b).abs().max()) / float(b.abs().max())


@pytest.mark.parametrize("case", sorted(BF16_CASES))
def test_bf16_split_mirror_holds_the_float32_bars(case):
    """The kernels' split (hi + lo) of every float32 operand keeps dq, dk,
    dv and dlog_a within 1e-4 of the plain version's max."""
    mirrors, plain = _bf16_case(case)
    for name, a, b in zip(("dq", "dk", "dv", "dlog_a"), mirrors[True],
                          plain):
        assert a.shape == b.shape and a.dtype == torch.float32, name
        assert _share_of_max(a, b) <= TOL, (case, name, _share_of_max(a, b))


@pytest.mark.parametrize("case", sorted(BF16_CASES))
def test_bf16_single_rounding_misses_the_dlog_a_bar(case):
    """Rounding each float32 operand once to bfloat16 puts dlog_a (a
    reverse sum of q.dq - k.dk, which cancels) past 1e-4 of its max: why
    the kernels split."""
    mirrors, plain = _bf16_case(case)
    assert _share_of_max(mirrors[False][3], plain[3]) > TOL
