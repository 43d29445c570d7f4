"""Causal GQA flash attention (forward): the CUDA kernel's wrapper and its
plain PyTorch version.

`flash_attention(q, k, v, causal=, window=)` computes, per batch row and
query head h (KV head h // rep, rep = Hq // Hkv; K/V are never repeated),

    out[i] = sum_j softmax_j(q_i . k_j / sqrt(dh)) v_j

over the keys j the masks keep: j < Skv always; j <= p when causal; and
j > p - window when window > 0 (the sliding window of
`repro.models.attention.blockwise_attention`, which the reference's model
path calls), where p = q_offset + i is query i's position: key positions
start at 0, query positions at `q_offset` (0 for a whole prompt; an
incremental prefill's chunk starts at its offset into the cache, as the
reference's `full_attention(q_offset=)` places it). Masked scores are
-1e30, so a query row with no kept key averages all of its values, as the
reference's online softmax does; with a window, q_offset + Sq <= Skv, so
that every query keeps a key, and so with a causal mask from an offset
(an incremental prefill's chunk: the cache holds every position of it).
Math is float32; the output has q's type.

The kernel's rows do not depend on the call: a query row of a call from
`q_offset` gives the bits of the same position's row of one call over
all queries (key blocks are walked from position 0 in ascending order,
and a block past a row's position adds exactly nothing to it).

Given CPU tensors the wrapper runs the plain version
(`flash_attention_plain`, the scores materialised); given CUDA tensors it
launches the kernel of `csrc/flash_attention.cu` or raises: there is no
fallback. Each launch adds one to `LAUNCHES["flash_attention"]`. Given
fake or meta tensors (the dry run) it calls the shape-only op
`kernels.shape_only.flash_fwd`, which launches nothing.

Training: `flash_attention_lse` also returns each query row's log-sum-exp
of its scaled scores (B, Hq, Sq), float32, which the kernel writes when
asked (serving calls do not ask, and their output keeps its bits). When
grad mode is on and q, k or v requires grad, `flash_attention` goes
through `FlashAttentionFn`, a `torch.autograd.Function`: its forward is
`flash_attention_lse` (saving q, k, v, out and lse), its backward
`flash_attention_bwd.flash_attention_backward` — on CUDA tensors the
hand-written backward kernel (`csrc/flash_attention_bwd.cu`), on CPU
tensors its plain version. A query offset has no gradient path (training
runs whole sequences from position 0): it raises ValueError there.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._common import on_cpu, raise_on
from repro_torch.kernels.shape_only import shape_only

__all__ = ["LAUNCHES", "NEG_INF", "FlashAttentionFn", "flash_attention",
           "flash_attention_lse", "flash_attention_lse_plain",
           "flash_attention_plain", "masked_scores", "reset_launches"]

NEG_INF = -1e30
HEAD_DIMS = (64, 96, 128)  # the head widths the kernel is built for
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches since the last reset_launches()
LAUNCHES = {"flash_attention": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check_shapes(q, k, v) -> tuple[int, int]:
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape \
            or k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3] \
            or q.shape[2] % k.shape[2]:
        raise ValueError(f"q (B,Sq,Hq,dh), k/v (B,Skv,Hkv,dh) with Hq % Hkv "
                         f"== 0; got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    return q.shape[2] // k.shape[2], q.shape[3]


def mask(Sq: int, Skv: int, *, causal: bool, window: int, device,
         q_offset: int = 0) -> torch.Tensor:
    """(Sq, Skv) bool: which keys each query keeps; query i sits at
    position q_offset + i."""
    qp = q_offset + torch.arange(Sq, device=device)[:, None]
    kp = torch.arange(Skv, device=device)[None, :]
    keep = torch.ones((Sq, Skv), dtype=torch.bool, device=device)
    if causal:
        keep = keep & (kp <= qp)
    if window > 0:
        keep = keep & (kp > qp - window)
    return keep


def masked_scores(q, k, *, causal: bool, window: int,
                  q_offset: int = 0) -> torch.Tensor:
    """The (B, Hkv, rep, Sq, Skv) scaled scores q.k * dh^-1/2 in float32,
    -1e30 where the masks drop a key."""
    rep, dh = _check_shapes(q, k, k)
    B, Sq = q.shape[:2]
    Skv, Hkv = k.shape[1], k.shape[2]
    qg = q.float().reshape(B, Sq, Hkv, rep, dh)
    s = torch.einsum("bqgrd,bkgd->bgrqk", qg, k.float()) * dh ** -0.5
    keep = mask(Sq, Skv, causal=causal, window=window, device=q.device,
                q_offset=q_offset)
    return torch.where(keep, s, torch.full_like(s, NEG_INF))


def flash_attention_plain(q, k, v, *, causal: bool = True, window: int = 0,
                          q_offset: int = 0) -> torch.Tensor:
    """Plain version: the (B, Hkv, rep, Sq, Skv) scores materialised in
    float32, masked with -1e30, softmax, product with v. Query i sits at
    position q_offset + i, as in the kernel; decode calls it with
    q_offset = the token's position."""
    rep, dh = _check_shapes(q, k, v)
    B, Sq, Hq, _ = q.shape
    p = torch.softmax(masked_scores(q, k, causal=causal, window=window,
                                    q_offset=q_offset), dim=-1)
    out = torch.einsum("bgrqk,bkgd->bqgrd", p, v.float())
    return out.reshape(B, Sq, Hq, dh).to(q.dtype)


def flash_attention_lse_plain(q, k, v, *, causal: bool = True,
                              window: int = 0):
    """Plain version of `flash_attention_lse`: (`flash_attention_plain`'s
    output, torch.logsumexp of the masked scaled scores as (B, Hq, Sq)
    float32)."""
    B, Sq, Hq, _ = q.shape
    lse = torch.logsumexp(masked_scores(q, k, causal=causal, window=window),
                          dim=-1)
    return (flash_attention_plain(q, k, v, causal=causal, window=window),
            lse.reshape(B, Hq, Sq))


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    if not getattr(lib, "_typed", False):
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.flash_attention_launch.argtypes = [ptr] * 5 + [i32] * 10 + [ptr]
        lib.flash_attention_launch.restype = i32
        lib._typed = True
    return lib


def _check_call(q, k, *, causal: bool, window: int, q_offset: int) -> None:
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    if q_offset < 0:
        raise ValueError(f"q_offset must be >= 0, got {q_offset}")
    if k.shape[1] == 0:
        raise ValueError("no keys: Skv must be > 0")
    if q_offset + q.shape[1] > k.shape[1] and (
            window > 0 or (causal and q_offset > 0)):
        # with a window a late query could keep no key at all; a causal
        # call from an offset is an incremental prefill's chunk, and the
        # reference's extend contract sizes the cache to hold every
        # position of it (from position 0, causal, any Sq: each query
        # keeps key 0)
        raise ValueError(f"a window, or a causal mask from an offset, needs "
                         f"q_offset + Sq <= Skv, got {q_offset} + "
                         f"{q.shape[1]} > {k.shape[1]}")


def _launch(q, k, v, *, causal: bool, window: int, q_offset: int,
            lse: bool):
    """The kernel on CUDA tensors: (out, the rows' log-sum-exp (B, Hq, Sq)
    float32 when `lse`, else None)."""
    rep, dh = _check_shapes(q, k, v)
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share one of {list(_DTYPES)}, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if dh not in HEAD_DIMS:
        raise ValueError(f"head width {dh} not in {HEAD_DIMS}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (the kernel "
                             "copies rows by 16-byte cp.async)")
    B, Sq, Hq, _ = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    rows = (torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
            if lse else None)
    if out.numel() == 0:
        return out, rows
    stream = torch.cuda.current_stream(q.device).cuda_stream
    code = _lib().flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        rows.data_ptr() if lse else None, B, Sq, Skv, Hq, Hkv, dh,
        int(bool(causal)), window, q_offset, _DTYPES[q.dtype], stream)
    raise_on(code, "flash_attention")
    LAUNCHES["flash_attention"] += 1
    return out, rows


def flash_attention_lse(q, k, v, *, causal: bool = True, window: int = 0):
    """`flash_attention` from position 0 that also returns each query
    row's log-sum-exp of its scaled scores: (out (B,Sq,Hq,dh), lse
    (B,Hq,Sq) float32). On CUDA one launch of the same kernel, which
    writes lse beside out; on the CPU `flash_attention_lse_plain`. The
    forward of training's gradient path."""
    window = int(window)
    _check_call(q, k, causal=causal, window=window, q_offset=0)
    if shape_only(q, k, v):
        return torch.ops.repro_torch.flash_fwd(q, k, v, bool(causal), window,
                                               0)
    if on_cpu(q, k, v):
        return flash_attention_lse_plain(q, k, v, causal=causal,
                                         window=window)
    return _launch(q, k, v, causal=causal, window=window, q_offset=0,
                   lse=True)


class FlashAttentionFn(torch.autograd.Function):
    """Flash attention with a gradient: forward `flash_attention_lse`,
    backward `flash_attention_bwd.flash_attention_backward` from the saved
    q, k, v, out and lse (the kernel on CUDA tensors, the plain formulas on
    CPU tensors)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int):
        out, lse = flash_attention_lse(q, k, v, causal=causal, window=window)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        from .flash_attention_bwd import flash_attention_backward
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(
            q, k, v, out, dout.contiguous(), lse, causal=ctx.causal,
            window=ctx.window)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    q_offset: int = 0) -> torch.Tensor:
    """q (B,Sq,Hq,dh); k, v (B,Skv,Hkv,dh), Hq % Hkv == 0; query i at
    position q_offset + i. Returns (B,Sq,Hq,dh) in q's type. Any Sq, Skv
    (ragged edges are masked in the kernel, not padded). On CUDA: float32
    or bfloat16, one type for all three, contiguous and 16-byte aligned,
    dh in {64, 96, 128}. With grad mode on and an input that requires
    grad it runs `FlashAttentionFn`, which takes no query offset."""
    window, q_offset = int(window), int(q_offset)
    _check_call(q, k, causal=causal, window=window, q_offset=q_offset)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        if q_offset:
            raise ValueError(f"the gradient path runs from position 0 "
                             f"(training has no query offset), got "
                             f"q_offset={q_offset}")
        return FlashAttentionFn.apply(q, k, v, bool(causal), window)
    if shape_only(q, k, v):
        return torch.ops.repro_torch.flash_fwd(q, k, v, bool(causal), window,
                                               q_offset)[0]
    if on_cpu(q, k, v):
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     q_offset=q_offset)
    return _launch(q, k, v, causal=causal, window=window, q_offset=q_offset,
                   lse=False)[0]
