"""The split arithmetic of the expert FFN's backward kernels
(csrc/ich_moe_bwd.cu), mirrored on the CPU by `tests/_moe_bwd_split.py`:
each float32 operand split in two bfloat16 parts, the passes lo.hi,
hi.lo, hi.hi with lo.lo left out, and the passes of x's and dy's zero lo
parts left out when they hold bfloat16 values.

Held against `ich_moe_backward_plain` run in float64 (its outputs
rounded once to float32), each output within 1e-4 of its largest value:
the kernels' bar against the plain version on the card. The case is a
reduced width with deep sums: D 512, F 256, 1,600 tokens, expert 0 holds
every token (1,600 kept slots, so the weight gradients sum over as many
slots as the largest of olmoe-1b-7b's record, 1,584 at its capacity),
experts 2 and 3 a quarter of the tokens each, expert 1 none. One
bfloat16 pass alone (hi.hi) misses that bar, so the test guards the
split. With bfloat16 x and dy the passes left out give the same values
as the full passes, bit for bit.
"""
import numpy as np
import pytest
import torch

from _moe_bwd_split import mirror_backward
from repro_torch.kernels.ich_moe import ich_moe_bwd as KB
from repro_torch.kernels.ich_moe.ich_moe import token_slots

NAMES = ("dx", "dwi", "dwg", "dwo", "dw")
TOL = 1e-4
T, E, D, F = 1600, 4, 512, 256


def _case(seed: int, bf16: bool):
    """The CSR (expert 0 every token; 2 and 3 the tokens t % 4 == 1 and
    2; expert 1 empty) and seeded float32 inputs; x and dy rounded to
    bfloat16 values when `bf16`."""
    rng = np.random.default_rng(seed)
    tokens = np.arange(T)
    tok = np.concatenate([tokens, tokens[tokens % 4 == 1],
                          tokens[tokens % 4 == 2]]).astype(np.int32)
    indptr = np.array([0, T, T, T + T // 4, T + T // 2], np.int32)
    tok_ptr, tok_slot = token_slots(tok, T)

    def f32(a):
        return torch.from_numpy(np.asarray(a, np.float32))
    x, dy = f32(rng.standard_normal((T, D))), f32(rng.standard_normal((T, D)))
    if bf16:
        x, dy = x.bfloat16().float(), dy.bfloat16().float()
    wi = f32(rng.standard_normal((E, D, F)) * D ** -0.5)
    wg = f32(rng.standard_normal((E, D, F)) * D ** -0.5)
    wo = f32(rng.standard_normal((E, F, D)) * F ** -0.5)
    w = f32(rng.uniform(0.05, 1.0, tok.size))
    return (x, dy, wi, wg, wo, torch.from_numpy(indptr),
            torch.from_numpy(tok), w, torch.from_numpy(tok_ptr),
            torch.from_numpy(tok_slot))


def _plain64(args):
    x, dy, wi, wg, wo, indptr, tok, w, tok_ptr, tok_slot = args
    return KB.ich_moe_backward_plain(
        x.double(), dy.double(), wi.double(), wg.double(), wo.double(),
        indptr, tok, w.double(), tok_ptr, tok_slot)


def _rel_errs(got, want):
    return {n: float((a - b).abs().max()) / float(b.abs().max())
            for n, a, b in zip(NAMES, got, want)}


@pytest.fixture(scope="module")
def f32_case():
    args = _case(0, bf16=False)
    return args, _plain64(args)


@pytest.fixture(scope="module")
def bf16_case():
    args = _case(1, bf16=True)
    return args, _plain64(args)


@pytest.fixture(scope="module")
def split_errs(f32_case):
    args, want = f32_case
    return _rel_errs(mirror_backward(*args), want)


def test_case_has_a_deep_expert_and_an_empty_one(f32_case):
    (_, _, _, _, _, indptr, *_), want = f32_case
    counts = np.diff(indptr.numpy())
    assert counts.max() > 1500 and counts[1] == 0
    for g in want[1:4]:
        assert torch.equal(g[1], torch.zeros_like(g[1]))


@pytest.mark.parametrize("name", NAMES)
def test_split_passes_hold_the_bar(split_errs, name):
    """The three passes: each output within 1e-4 of its largest value of
    the float64 plain version (measured 7.7e-6 to 9.1e-6: ~16 bits of
    each operand)."""
    assert split_errs[name] <= TOL, split_errs


def test_one_bfloat16_pass_misses_the_bar(f32_case, split_errs):
    """hi.hi alone keeps 8 bits of each operand: every output misses 1e-4
    (measured 3.9e-3 to 5.0e-3), by far more than the split's worst."""
    args, want = f32_case
    hi = _rel_errs(mirror_backward(*args, passes="hi"), want)
    assert max(hi.values()) > TOL, hi
    assert max(hi.values()) > 20 * max(split_errs.values()), (hi, split_errs)


def test_bf16_inputs_skip_gives_the_full_passes_values(bf16_case):
    """x and dy hold bfloat16 values: leaving out the passes of their lo
    parts (zeros) gives the full passes' values, output for output, and
    both hold the bar."""
    args, want = bf16_case
    skip = mirror_backward(*args, bf16_exact=True)
    full = mirror_backward(*args, bf16_exact=False)
    for n, a, b in zip(NAMES, skip, full):
        assert torch.equal(a, b), n
    errs = _rel_errs(skip, want)
    assert max(errs.values()) <= TOL, errs


def test_wrapper_takes_bfloat16_x_and_dy_on_the_cpu(bf16_case):
    """On CPU tensors `ich_moe_backward` given x and dy in bfloat16 (the
    case the kernels run with fewer passes) is the plain version of their
    float32 casts, in float32, and launches nothing."""
    args, _ = bf16_case
    x, dy, *rest = args
    KB.reset_launches()
    a = KB.ich_moe_backward(x.bfloat16(), dy.bfloat16(), *rest)
    b = KB.ich_moe_backward_plain(*args)
    assert KB.LAUNCHES == {"ich_moe_bwd": 0}
    for n, u, v in zip(NAMES, a, b):
        assert u.dtype == torch.float32 and torch.equal(u, v), n
