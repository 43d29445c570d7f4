"""Chunked SSD scan backward: the CUDA kernel's wrapper and its plain
PyTorch version.

`mamba_scan_backward(q, k, v, dy, st, lc, chunk=)` returns (dq, dk, dv,
dlog_a), the gradient of `mamba_scan(q, k, v, log_a, chunk=)` from a zero
state given the gradient dy of its output y (none of its final state),
from what the forward keeps: `st` (B, H, nc, N, Pd), the state before each
chunk, and `lc` (B, H, nc, Q), l of each chunk. Per batch row and head,
with l the inclusive cumulative sum of log_a inside a chunk, total its
last entry, e_ij = exp(clip(l_i - l_j, -60, 0)), w_j = exp(clip(total -
l_j, -60, 0)) and G_c the gradient of the state after chunk c (0 after the
last):

    G_{c-1} = exp(total_c) G_c + sum_i exp(l_i) q_i (x) dy_i
    dq_i = sum_{j<=i} e_ij (dy_i . v_j) k_j + exp(l_i) S_{c-1} dy_i
    dk_j = sum_{i>=j} e_ij (dy_i . v_j) q_i + w_j G_c v_j
    dv_j = sum_{i>=j} e_ij (q_i . k_j) dy_i + w_j G_c^T k_j
    dl_i = q_i . dq_i - k_i . dk_i  (+ <G_c, S_c> at the chunk's last step)
    dlog_a_t = sum of dl over the steps s >= t of t's chunk

with dq_i, dk_i each head's own in dl. q and k of shape (B, S, 1, N) are
one for every head of v (Zamba2's C and B): their gradients are summed
over the heads. dq, dk and dv come back in their inputs' types, dlog_a in
float32.

Given CPU tensors the wrapper runs the plain version
(`mamba_scan_backward_plain`: the formulas chunk by chunk in eager
PyTorch, not autograd); given CUDA tensors it launches the kernels of
`csrc/mamba_scan_bwd.cu` or raises: there is no fallback; given fake or
meta tensors (the dry run) `kernels.shape_only.scan_bwd`, which launches
nothing. Each call that launches them adds one to
`LAUNCHES["mamba_scan_bwd"]`. In bfloat16 the
kernels copy every tile by 16-byte cp.async, so where N or Pd is not a
multiple of 8 (xlstm's Pd = 513) the wrapper pads q, k, v, dy and the
kept states with zeros to the next multiple (520) and hands back views
of the padded gradients; Zamba2's inputs are taken as they are.
`kernel_occupancy` reports what each of a call's CUDA kernels holds on
the card.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._common import on_cpu, raise_on
from repro_torch.kernels.shape_only import shape_only

from .mamba_scan import _DTYPES, MAX_STATE, _by_heads

__all__ = ["KERNEL_SLOTS", "LAUNCHES", "MAX_CHUNK", "kernel_occupancy",
           "mamba_scan_backward", "mamba_scan_backward_plain",
           "reset_launches"]

MAX_CHUNK = 256   # chunk lengths the backward kernel takes
# the CUDA kernels of a call, in launch order (the head sum only with q and
# k shared), as `mamba_scan_bwd_occupancy` reports them
KERNEL_SLOTS = ("dstates", "pass", "gdot", "pair_dq", "pair_dk", "pair_dv",
                "dl", "headsum")

# wrapper calls that launched the kernels since the last reset_launches()
LAUNCHES = {"mamba_scan_bwd": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check(q, k, v, dy, st, lc, chunk: int) -> None:
    if q.ndim != 4 or k.shape != q.shape or v.ndim != 4 \
            or v.shape[:2] != q.shape[:2] \
            or q.shape[2] not in (1, v.shape[2]) or dy.shape != v.shape:
        raise ValueError(f"q, k (B,S,H,N) or (B,S,1,N), v and dy (B,S,H,Pd);"
                         f" got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}, {tuple(dy.shape)}")
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    B, S, H, Pd = v.shape
    N, nc = q.shape[3], -(-S // chunk)
    if tuple(st.shape) != (B, H, nc, N, Pd) \
            or tuple(lc.shape) != (B, H, nc, chunk):
        raise ValueError(f"st must be (B,H,nc,N,Pd) = {(B, H, nc, N, Pd)} "
                         f"and lc (B,H,nc,chunk) = {(B, H, nc, chunk)}, got "
                         f"{tuple(st.shape)}, {tuple(lc.shape)}")


def mamba_scan_backward_plain(q, k, v, dy, st, lc, *, chunk: int):
    """Plain version: the formulas of the module docstring, one chunk at a
    time from the last, in float32 (not autograd)."""
    _check(q, k, v, dy, st, lc, chunk)
    shared = q.shape[2] != v.shape[2]
    qh, kh = _by_heads(q, k, v)
    B, S, H, N = qh.shape
    Pd = v.shape[-1]
    Q = int(chunk)
    nc = -(-S // Q)
    pad = nc * Q - S

    def chunks(t):  # (B, S, H, *) float32, padded -> (B, nc, Q, H, *)
        t = torch.nn.functional.pad(t.float(), (0, 0, 0, 0, 0, pad))
        return t.reshape(B, nc, Q, H, t.shape[-1])

    qc, kc, vc, dc = chunks(qh), chunks(kh), chunks(v), chunks(dy)
    causal = torch.ones((Q, Q), dtype=torch.bool, device=v.device).tril()
    G = torch.zeros((B, H, N, Pd), dtype=torch.float32, device=v.device)
    dqs, dks, dvs, dls = [], [], [], []
    for c in reversed(range(nc)):
        qb, kb, vb, db = qc[:, c], kc[:, c], vc[:, c], dc[:, c]  # (B,Q,H,*)
        l = lc[:, :, c].float().transpose(1, 2)                   # (B,Q,H)
        total = l[:, -1]                                          # (B,H)
        s_prev = st[:, :, c].float()                              # (B,H,N,Pd)
        e = torch.exp(torch.clamp(l[:, :, None] - l[:, None, :], -60.0,
                                  0.0)).permute(0, 3, 1, 2)       # (B,H,i,j)
        e = torch.where(causal, e, torch.zeros_like(e))
        w = torch.exp(torch.clamp(total[:, None] - l, -60.0, 0.0))
        dyv = torch.einsum("bihp,bjhp->bhij", db, vb) * e
        qk = torch.einsum("bihn,bjhn->bhij", qb, kb) * e
        dq = torch.einsum("bhij,bjhn->bihn", dyv, kb) + torch.einsum(
            "bhnp,bihp->bihn", s_prev, db) * torch.exp(l)[..., None]
        dk = torch.einsum("bhij,bihn->bjhn", dyv, qb) + torch.einsum(
            "bhnp,bjhp->bjhn", G, vb) * w[..., None]
        dv = torch.einsum("bhij,bihp->bjhp", qk, db) + torch.einsum(
            "bhnp,bjhn->bjhp", G, kb) * w[..., None]
        dl = (qb * dq).sum(-1) - (kb * dk).sum(-1)                # (B,Q,H)
        if c + 1 < nc:   # <G_c, S_c>, S_c the state before chunk c + 1
            tail = (G * st[:, :, c + 1].float()).sum((-1, -2))
            dl = torch.cat([dl[:, :-1], dl[:, -1:] + tail[:, None]], 1)
        dls.append(torch.flip(torch.cumsum(torch.flip(dl, (1,)), 1), (1,)))
        dqs.append(dq)
        dks.append(dk)
        dvs.append(dv)
        G = G * torch.exp(total)[:, :, None, None] + torch.einsum(
            "bihn,bihp->bhnp", qb * torch.exp(l)[..., None], db)

    def whole(parts):  # chunks last first -> (B, S, H, *)
        t = torch.stack(parts[::-1], 1)
        return t.reshape(B, nc * Q, *t.shape[3:])[:, :S]
    dq, dk = whole(dqs), whole(dks)
    if shared:
        dq, dk = dq.sum(2, keepdim=True), dk.sum(2, keepdim=True)
    dla = whole([d[..., None] for d in dls])[..., 0]
    return (dq.to(q.dtype), dk.to(k.dtype), whole(dvs).to(v.dtype),
            dla.contiguous())


def _lib() -> ctypes.CDLL:
    lib = _build.load("mamba_scan_bwd")
    if not getattr(lib, "_typed", False):
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.mamba_scan_bwd_launch.argtypes = [ptr] * 16 + [i32] * 7 \
            + [i64] * 6 + [i32, ptr]
        lib.mamba_scan_bwd_launch.restype = i32
        lib.mamba_scan_bwd_occupancy.argtypes = [i32] * 8 + [ptr]
        lib.mamba_scan_bwd_occupancy.restype = i32
        lib._typed = True
    return lib


def _round8(n: int) -> int:
    return -(-n // 8) * 8


def _rows16(t, width: int):
    """t (*, W) with rows as the bfloat16 kernels copy them: `width` (a
    multiple of 8, >= W) values at 16-byte-aligned starts, zeros past W;
    t itself when it already is, else a padded contiguous copy."""
    if t.shape[-1] == width and t.stride(-1) == 1 \
            and all(s % 8 == 0 for s in t.stride()[:-1]) \
            and t.data_ptr() % 16 == 0:
        return t
    out = t.new_zeros((*t.shape[:-1], width))
    out[..., :t.shape[-1]] = t
    return out


def kernel_occupancy(B: int, S: int, H: int, N: int, Pd: int, *,
                     chunk: int, shared: bool, dtype) -> dict:
    """What each CUDA kernel of a `mamba_scan_backward` call at these
    shapes holds on the current card (`cudaFuncGetAttributes`,
    `cudaOccupancyMaxActiveBlocksPerMultiprocessor`): KERNEL_SLOTS name ->
    {registers, smem_bytes (static and dynamic, a CTA), threads,
    ctas_per_sm, local_bytes (spills, a thread)}; the head sum only with q
    and k shared. In bfloat16 at the padded widths the call runs."""
    if dtype == torch.bfloat16:
        N, Pd = _round8(N), _round8(Pd)
    out = (ctypes.c_int * (5 * len(KERNEL_SLOTS)))()
    raise_on(_lib().mamba_scan_bwd_occupancy(
        B, S, H, N, Pd, int(chunk), int(shared), _DTYPES[dtype], out),
        "mamba_scan_bwd")
    keys = ("registers", "smem_bytes", "threads", "ctas_per_sm",
            "local_bytes")
    return {name: dict(zip(keys, out[5 * i:5 * i + 5]))
            for i, name in enumerate(KERNEL_SLOTS) if out[5 * i] >= 0}


def mamba_scan_backward(q, k, v, dy, st, lc, *, chunk: int):
    """(dq, dk, dv, dlog_a) of `mamba_scan(q, k, v, log_a, chunk=)` from a
    zero state, given dy (v's shape) and the forward's `st` (B,H,nc,N,Pd)
    and `lc` (B,H,nc,chunk). On CUDA: q, k, v, dy of one type (float32 or
    bfloat16), N <= 512, chunk <= 256; v and dy contiguous, q and k with a
    unit stride over N (copied otherwise), st and lc float32 and
    contiguous."""
    chunk = int(chunk)
    _check(q, k, v, dy, st, lc, chunk)
    if all(shape_only(t) for t in (q, k, v, dy, st, lc)):
        return tuple(torch.ops.repro_torch.scan_bwd(q, k, v, dy, st, lc,
                                                    chunk))
    if on_cpu(q, k, v, dy, st, lc):
        return mamba_scan_backward_plain(q, k, v, dy, st, lc, chunk=chunk)
    if q.dtype not in _DTYPES or any(t.dtype != q.dtype for t in (k, v, dy)):
        raise TypeError(f"q, k, v, dy must share one of {list(_DTYPES)}, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}, {dy.dtype}")
    if st.dtype != torch.float32 or lc.dtype != torch.float32:
        raise TypeError(f"st and lc must be float32, got {st.dtype}, "
                        f"{lc.dtype}")
    B, S, H, Pd = v.shape
    N = q.shape[3]
    if N > MAX_STATE or chunk > MAX_CHUNK:
        raise ValueError(f"the backward kernel takes N <= {MAX_STATE} and "
                         f"chunk <= {MAX_CHUNK}, got N={N}, chunk={chunk}")
    for name, t in (("v", v), ("dy", dy), ("st", st), ("lc", lc)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if v.numel() == 0 or q.numel() == 0:
        return (torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v),
                torch.zeros((B, S, H), dtype=torch.float32, device=v.device))
    q, k = (t if t.stride(3) == 1 else t.contiguous() for t in (q, k))
    return _launch(q, k, v, dy, st, lc, chunk)


def _launch(q, k, v, dy, st, lc, chunk: int):
    """The kernels' call on checked tensors: in bfloat16 the operands
    first padded to the rows the kernels copy (`_rows16`), the gradients
    cut back to their inputs' widths."""
    if q.dtype != torch.bfloat16:
        return _call(q, k, v, dy, st, lc, chunk)
    N, Pd = q.shape[3], v.shape[3]
    Np, Pp = _round8(N), _round8(Pd)
    q, k = _rows16(q, Np), _rows16(k, Np)
    v, dy = _rows16(v, Pp), _rows16(dy, Pp)
    if (Np, Pp) != (N, Pd):
        st = torch.nn.functional.pad(st, (0, Pp - Pd, 0, Np - N))
    elif st.data_ptr() % 16:
        st = st.clone()
    dq, dk, dv, dla = _call(q, k, v, dy, st, lc, chunk)
    return dq[..., :N], dk[..., :N], dv[..., :Pd], dla


def _call(q, k, v, dy, st, lc, chunk: int):
    B, S, H, Pd = v.shape
    N = q.shape[3]
    shared = q.shape[2] != H
    dq, dk = (torch.empty(t.shape, dtype=t.dtype, device=t.device)
              for t in (q, k))
    dv = torch.empty_like(v)
    dla = torch.empty((B, S, H), dtype=torch.float32, device=v.device)
    nc = -(-S // chunk)
    # float32 scratch in one allocation, written before it is read, on the
    # caller's stream: the adjoint states g (B, H, nc, N, Pd) first (the
    # bfloat16 path copies it by 16 bytes), then the rows' q.dq and k.dk
    # (B, S, H) each, <G_c, S_c> (B, H, nc), and with shared q and k the
    # per-head dq and dk (B, S, H, N) each
    sizes = (B * H * nc * N * Pd, B * S * H, B * S * H, B * H * nc) \
        + ((B * S * H * N,) * 2 if shared else ())
    scratch = torch.empty(sum(sizes), dtype=torch.float32, device=v.device)
    ptrs, at = [], scratch.data_ptr()
    for n in sizes:
        ptrs.append(at)
        at += 4 * n
    g, qdq, kdk, gs, *parts = ptrs
    stream = torch.cuda.current_stream(v.device).cuda_stream
    code = _lib().mamba_scan_bwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dy.data_ptr(),
        st.data_ptr(), lc.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), dla.data_ptr(), g, qdq, kdk, gs,
        *(parts or (None, None)),
        B, S, H, N, Pd, chunk, int(shared), *q.stride()[:3], *k.stride()[:3],
        _DTYPES[v.dtype], stream)
    raise_on(code, "mamba_scan_bwd")
    LAUNCHES["mamba_scan_bwd"] += 1
    return dq, dk, dv, dla
