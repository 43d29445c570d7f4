"""Plain-PyTorch mirror of the operand rounding of the expert FFN's backward
kernels (csrc/ich_moe_bwd.cu), shared by the CPU tests.

The kernels run every product on the bfloat16 tensor cores with float32
accumulators. Each float32 operand v is split as hi = bf16(v) and lo =
bf16(v - hi) (both rounded to nearest even), and a product A . B runs as
the passes lo.hi, hi.lo, hi.hi, in that order (lo.lo is left out). With
`bf16_exact` x and dy are bfloat16 values, their lo parts are zeros, and
the passes that multiply them are left out: lo.hi of the up products, v,
dwi and dwg (x or dy is A), hi.lo of dwo (dy is B). dx's product, whose
operands are dh, dg and the weights, always runs all three.

Here each pass is a float64 product of the bfloat16 parts (exact
products, sums in float64), so the mirror models the operands' rounding,
not the tensor cores' truncating float32 accumulation. The elementwise
part is the kernels' float32 arithmetic on the products rounded to
float32. `passes="hi"` runs hi.hi alone: one bfloat16 pass, the design the
split exists to avoid.
"""
import torch

from repro_torch.kernels.ich_moe.ich_moe import token_combine


def parts(v, exact: bool = False):
    """(lo, hi) of a float32 v as float64 values; lo is None when v holds
    bfloat16 values (`exact`: it would be zeros)."""
    hi = v.to(torch.bfloat16).float()
    lo = None if exact else (v - hi).to(torch.bfloat16).double()
    return lo, hi.double()


def split_mm(a, b, *, a_exact=False, b_exact=False, passes="split"):
    """a @ b (float32 operands) as the kernels' passes, in float64."""
    al, ah = parts(a, a_exact)
    bl, bh = parts(b, b_exact)
    if passes == "hi":
        return ah @ bh
    out = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.float64)
    if al is not None:
        out = out + al @ bh
    if bl is not None:
        out = out + ah @ bl
    return out + ah @ bh


def mirror_backward(x, dy, wi, wg, wo, indptr, tok, w, tok_ptr, tok_slot, *,
                    bf16_exact: bool = False, passes: str = "split"):
    """(dx, dwi, dwg, dwo, dw) in float32 from float32 inputs, as
    `ich_moe_backward` takes them, with the kernels' operand rounding."""
    n_tokens, D = x.shape
    E, _, F = wi.shape
    ptr = [int(v) for v in indptr.tolist()]
    tok = tok.long()
    ex = dict(a_exact=bf16_exact, passes=passes)
    dxs = torch.zeros((tok.numel(), D))
    dw = torch.zeros((tok.numel(),))
    dwi, dwg, dwo = (torch.zeros_like(t) for t in (wi, wg, wo))
    for e in range(E):
        lo, hi = ptr[e], ptr[e + 1]
        if hi == lo:
            continue
        xs, dys, ws = x[tok[lo:hi]], dy[tok[lo:hi]], w[lo:hi, None]
        h = split_mm(xs, wi[e], **ex).float()
        g = split_mm(xs, wg[e], **ex).float()
        v = split_mm(dys, wo[e].T, **ex).float()
        sg = 1.0 / (1.0 + torch.exp(-g))
        silu = g * sg
        a = silu * h
        da = ws * v
        dh = da * silu
        dg = da * h * (sg * (1.0 + g * (1.0 - sg)))
        dw[lo:hi] = (a * v).double().sum(dim=1).float()
        dxs[lo:hi] = split_mm(torch.cat([dh, dg], 1),
                              torch.cat([wi[e], wg[e]], 1).T,
                              passes=passes).float()
        dwi[e] = split_mm(xs.T, dh, **ex).float()
        dwg[e] = split_mm(xs.T, dg, **ex).float()
        dwo[e] = split_mm((ws * a).T, dys, b_exact=bf16_exact,
                          passes=passes).float()
    dx = token_combine(dxs, tok_ptr, tok_slot, n_tokens)
    return dx, dwi, dwg, dwo, dw
