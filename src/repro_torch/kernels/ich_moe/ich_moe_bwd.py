"""The backward of the iCh-scheduled MoE expert FFN: the CUDA kernel's
wrapper and its plain PyTorch version.

`ich_moe_backward(x, dy, wi, wg, wo, indptr, tok, w, tok_ptr, tok_slot)`
returns (dx, dwi, dwg, dwo, dw), the gradient of `ich_moe_sharded`'s y
given its gradient dy, over a dispatch plan's expert-major CSR: expert
e's kept slots are [indptr[e], indptr[e+1]), slot s holds token tok[s]
and combine weight w[s]; tok_ptr / tok_slot are the forward's token ->
slots index (`MoeSlots`). For every slot s of expert e, t = tok[s]:

    g = x[t].wg[e]   h = x[t].wi[e]   a = silu(g) * h   v = dy[t].wo[e]^T
    dw[s] = sum_f a * v
    da = w[s] v      dh = da * silu(g)      dg = da * h * silu'(g)
    dx_s = dh.wi[e]^T + dg.wg[e]^T
    dwo[e] = sum_s (w[s] a)^T dy[t]
    dwi[e] = sum_s x[t]^T dh       dwg[e] = sum_s x[t]^T dg
    dx[t]  = the left fold, ascending slot order, of dx_s over t's slots

g and h are recomputed from x. Everything is float32. The result reads the
CSR and the token index only, never the schedule's tiles or shards, so it
does not depend on p, B, W or the refine generation; an expert with no
kept slot gets exact zeros.

Given CPU tensors the wrapper runs the plain version
(`ich_moe_backward_plain`: the formulas expert by expert with torch
products, the same token fold); given CUDA tensors it launches the five
kernels of `csrc/ich_moe_bwd.cu` (six launches: the weight-gradient kernel
runs once for dwi and dwg, once for dwo) or raises: there is no fallback.
Their products run on the bfloat16 tensor cores with each float32 operand
split in two bfloat16 parts (three passes a product). x and dy may
also come both in bfloat16 (bfloat16 training): the wrapper casts them
to float32, whose lo parts are then zeros, and the kernels leave out the
passes that multiply them, which adds the same exact zeros. Each call
that launches the kernels adds one to `LAUNCHES["ich_moe_bwd"]`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._common import check, on_cpu, raise_on

from .ich_moe import token_combine

__all__ = ["LAUNCHES", "backward_flops", "ich_moe_backward",
           "ich_moe_backward_plain", "reset_launches"]

# wrapper calls that launched the kernels since the last reset_launches()
LAUNCHES = {"ich_moe_bwd": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def backward_flops(n_slots: int, D: int, F: int) -> int:
    """Operations the kernels run for n_slots kept slots: 16 D F a slot
    (the two recomputed up products, v, the two dx products, the three
    weight products; 2 D F each)."""
    return 16 * int(n_slots) * int(D) * int(F)


def _silu_parts(g):
    """(sigmoid(g), silu(g)) as the kernel computes them."""
    sg = 1.0 / (1.0 + torch.exp(-g))
    return sg, g * sg


def ich_moe_backward_plain(x, dy, wi, wg, wo, indptr, tok, w, tok_ptr,
                           tok_slot):
    """Plain version: the module docstring's formulas expert by expert
    (torch products over each expert's slots), then the token fold."""
    n_tokens, D = x.shape
    E, _, F = wi.shape
    n_slots = tok.numel()
    ptr = [int(v) for v in indptr.tolist()]
    tok = tok.long()
    dxs = torch.zeros((n_slots, D), dtype=torch.float32, device=x.device)
    dw = torch.zeros((n_slots,), dtype=torch.float32, device=x.device)
    dwi, dwg, dwo = (torch.zeros_like(t, dtype=torch.float32)
                     for t in (wi, wg, wo))
    for e in range(E):
        lo, hi = ptr[e], ptr[e + 1]
        if hi == lo:
            continue
        xs, dys, ws = x[tok[lo:hi]], dy[tok[lo:hi]], w[lo:hi, None]
        g, h = xs @ wg[e], xs @ wi[e]
        v = dys @ wo[e].T
        sg, silu = _silu_parts(g)
        a = silu * h
        dw[lo:hi] = (a * v).sum(dim=1)
        da = ws * v
        dh = da * silu
        dg = da * h * (sg * (1.0 + g * (1.0 - sg)))
        dxs[lo:hi] = dh @ wi[e].T + dg @ wg[e].T
        dwi[e] = xs.T @ dh
        dwg[e] = xs.T @ dg
        dwo[e] = (ws * a).T @ dys
    dx = token_combine(dxs, tok_ptr, tok_slot, n_tokens)
    return dx, dwi, dwg, dwo, dw


def _lib() -> ctypes.CDLL:
    lib = _build.load("ich_moe_bwd")
    if not getattr(lib, "_typed", False):
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.ich_moe_bwd_launch.argtypes = [ptr] * 20 + [i32] * 6 + [ptr]
        lib.ich_moe_bwd_launch.restype = i32
        lib._typed = True
    return lib


def ich_moe_backward(x, dy, wi, wg, wo, indptr, tok, w, tok_ptr, tok_slot):
    """The gradient of the expert FFN (module docstring): x, dy (n_tokens,
    D) float32 or both bfloat16, wi/wg (E, D, F), wo (E, F, D), w
    (n_slots,) float32; indptr (E+1,), tok (n_slots,), tok_ptr
    (n_tokens+1,), tok_slot (n_slots,) int32. Returns (dx (n_tokens, D),
    dwi, dwg, dwo, dw (n_slots,)), float32: for bfloat16 x and dy, the
    values of their float32 casts' gradient, with fewer passes on the
    card."""
    exact = x.dtype == dy.dtype == torch.bfloat16
    if exact:
        x, dy = x.float(), dy.float()
    if on_cpu(x, dy, wi, wg, wo, indptr, tok, w, tok_ptr, tok_slot):
        return ich_moe_backward_plain(x, dy, wi, wg, wo, indptr, tok, w,
                                      tok_ptr, tok_slot)
    n_tokens, D = x.shape
    if wi.ndim != 3 or wi.shape[1] != D or wi.shape[2] < 1 or D < 1:
        raise ValueError(f"x (n_tokens, D) and wi (E, D, F >= 1) disagree: "
                         f"{tuple(x.shape)}, {tuple(wi.shape)}")
    E, _, F = wi.shape
    n_slots = tok.numel()
    check("x", x, torch.float32)
    check("dy", dy, torch.float32, (n_tokens, D))
    check("wi", wi, torch.float32)
    check("wg", wg, torch.float32, (E, D, F))
    check("wo", wo, torch.float32, (E, F, D))
    check("indptr", indptr, torch.int32, (E + 1,))
    check("tok", tok, torch.int32, (n_slots,))
    check("w", w, torch.float32, (n_slots,))
    check("tok_ptr", tok_ptr, torch.int32, (n_tokens + 1,))
    check("tok_slot", tok_slot, torch.int32, (n_slots,))
    dev = x.device

    def empty(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)
    # dh, dg, w a; dw's partial sums of each 64-column tile; dx_s
    dhbuf, dgbuf, wabuf = (empty(n_slots, F) for _ in range(3))
    dwpart = empty(-(-F // 64), n_slots)
    dxs = empty(n_slots, D)
    dx, dw = empty(n_tokens, D), empty(n_slots)
    dwi, dwg, dwo = empty(E, D, F), empty(E, D, F), empty(E, F, D)
    stream = torch.cuda.current_stream(dev).cuda_stream
    code = _lib().ich_moe_bwd_launch(
        x.data_ptr(), dy.data_ptr(), wi.data_ptr(), wg.data_ptr(),
        wo.data_ptr(), indptr.data_ptr(), tok.data_ptr(), w.data_ptr(),
        tok_ptr.data_ptr(), tok_slot.data_ptr(), dhbuf.data_ptr(),
        dgbuf.data_ptr(), wabuf.data_ptr(), dwpart.data_ptr(),
        dxs.data_ptr(), dx.data_ptr(), dwi.data_ptr(), dwg.data_ptr(),
        dwo.data_ptr(), dw.data_ptr(), n_tokens, n_slots, D, F, E,
        int(exact), stream)
    raise_on(code, "ich_moe_bwd")
    LAUNCHES["ich_moe_bwd"] += 1
    return dx, dwi, dwg, dwo, dw
