"""Flash attention backward: the CUDA kernel's wrapper and its plain
PyTorch version.

`flash_attention_backward(q, k, v, out, dout, lse, causal=, window=)`
returns (dq, dk, dv), the gradient of `flash_attention` from position 0
(q (B,Sq,Hq,dh), k, v (B,Skv,Hkv,dh), KV head h // rep for query head h)
given its output `out`, the output's gradient `dout` and the rows'
log-sum-exp `lse` (B,Hq,Sq) that `flash_attention_lse` returns, by
FlashAttention-2's formulas (scale = dh^-1/2):

    P  = exp(q.k * scale - lse)   on the kept (query, key) pairs, else 0
    D  = rowsum(dout * out)
    dv = P^T dout                 (summed over the rep query heads)
    dS = P * (dout v^T - D)
    dk = dS^T q * scale           (summed over the rep query heads)
    dq = dS k * scale

under the forward's masks. Training has no query offset: q_offset other
than 0 raises ValueError. Math is float32; dq, dk, dv have q's type.

Given CPU tensors the wrapper runs the plain version
(`flash_attention_backward_plain`: the formulas on the materialised
(B, Hkv, rep, Sq, Skv) scores, not autograd); given CUDA tensors it
launches the three kernels of `csrc/flash_attention_bwd.cu` or raises:
there is no fallback. Bfloat16 runs its products on the tensor cores
(bfloat16 MMAs with float32 accumulators; P and dS are rounded to
bfloat16 before the products that take them), float32 on the CUDA cores.
Each call that launches them adds one to
`LAUNCHES["flash_attention_bwd"]`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._common import on_cpu, raise_on
from repro_torch.kernels.shape_only import shape_only

from .flash_attention import (_DTYPES, HEAD_DIMS, _check_call,
                              _check_shapes, masked_scores)

__all__ = ["LAUNCHES", "flash_attention_backward",
           "flash_attention_backward_plain", "reset_launches"]

# wrapper calls that launched the kernels since the last reset_launches()
LAUNCHES = {"flash_attention_bwd": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check(q, k, v, out, dout, lse, window: int, q_offset: int,
           causal: bool) -> None:
    if q_offset != 0:
        raise ValueError(f"the backward runs from position 0 (training has "
                         f"no query offset), got q_offset={q_offset}")
    _check_shapes(q, k, v)
    _check_call(q, k, causal=causal, window=window, q_offset=0)
    B, Sq, Hq, _ = q.shape
    if out.shape != q.shape or dout.shape != q.shape:
        raise ValueError(f"out and dout must have q's shape {tuple(q.shape)},"
                         f" got {tuple(out.shape)}, {tuple(dout.shape)}")
    if tuple(lse.shape) != (B, Hq, Sq):
        raise ValueError(f"lse must have shape {(B, Hq, Sq)}, got "
                         f"{tuple(lse.shape)}")


def flash_attention_backward_plain(q, k, v, out, dout, lse, *,
                                   causal: bool = True, window: int = 0):
    """Plain version: the formulas of the module docstring on the
    materialised float32 scores, from `lse` (not autograd)."""
    rep = q.shape[2] // k.shape[2]
    B, Sq, Hq, dh = q.shape
    Hkv = k.shape[2]
    scale = dh ** -0.5
    s = masked_scores(q, k, causal=causal, window=window)
    # a masked score is -1e30, so its P is exactly 0
    p = torch.exp(s - lse.float().reshape(B, Hkv, rep, Sq)[..., None])
    qg = q.float().reshape(B, Sq, Hkv, rep, dh)
    do = dout.float().reshape(B, Sq, Hkv, rep, dh)
    d_rows = (do * out.float().reshape(B, Sq, Hkv, rep, dh)).sum(-1)
    dv = torch.einsum("bgrqk,bqgrd->bkgd", p, do)
    dp = torch.einsum("bqgrd,bkgd->bgrqk", do, v.float())
    ds = p * (dp - d_rows.permute(0, 2, 3, 1)[..., None])
    dq = torch.einsum("bgrqk,bkgd->bqgrd", ds, k.float()) * scale
    dk = torch.einsum("bgrqk,bqgrd->bkgd", ds, qg) * scale
    return (dq.reshape(B, Sq, Hq, dh).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention_bwd")
    if not getattr(lib, "_typed", False):
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.flash_attention_bwd_launch.argtypes = \
            [ptr] * 10 + [i32] * 9 + [ptr]
        lib.flash_attention_bwd_launch.restype = i32
        lib._typed = True
    return lib


def flash_attention_backward(q, k, v, out, dout, lse, *, causal: bool = True,
                             window: int = 0, q_offset: int = 0):
    """(dq, dk, dv) of `flash_attention(q, k, v, causal=, window=)` from
    its output `out`, the output's gradient `dout` and the rows'
    log-sum-exp `lse` (B, Hq, Sq) float32. On CUDA: q, k, v, out, dout of
    one type (float32 or bfloat16), contiguous, dh in {64, 96, 128}; lse
    float32 and contiguous."""
    window, q_offset = int(window), int(q_offset)
    _check(q, k, v, out, dout, lse, window, q_offset, causal)
    if shape_only(q, k, v, out, dout, lse):
        return torch.ops.repro_torch.flash_bwd(q, k, v, out, dout, lse,
                                               bool(causal), window)
    if on_cpu(q, k, v, out, dout, lse):
        return flash_attention_backward_plain(q, k, v, out, dout, lse,
                                              causal=causal, window=window)
    B, Sq, Hq, dh = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    if q.dtype not in _DTYPES or any(t.dtype != q.dtype
                                     for t in (k, v, out, dout)):
        raise TypeError(f"q, k, v, out, dout must share one of "
                        f"{list(_DTYPES)}, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}, {out.dtype}, {dout.dtype}")
    if lse.dtype != torch.float32:
        raise TypeError(f"lse must be float32, got {lse.dtype}")
    if dh not in HEAD_DIMS:
        raise ValueError(f"head width {dh} not in {HEAD_DIMS}")
    for name, t in (("q", q), ("k", k), ("v", v), ("out", out),
                    ("dout", dout), ("lse", lse)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if q.numel() == 0:
        return dq, dk.zero_(), dv.zero_()
    # the bfloat16 kernels copy q, k, v, dout 16 bytes at a time: a view
    # that starts off that grid is copied to a fresh (aligned) buffer
    q, k, v, dout = (t if t.data_ptr() % 16 == 0 else t.clone()
                     for t in (q, k, v, dout))
    d_rows = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    code = _lib().flash_attention_bwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), d_rows.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), B, Sq, Skv, Hq, Hkv, dh,
        int(bool(causal)), window, _DTYPES[q.dtype], stream)
    raise_on(code, "flash_attention_bwd")
    LAUNCHES["flash_attention_bwd"] += 1
    return dq, dk, dv
