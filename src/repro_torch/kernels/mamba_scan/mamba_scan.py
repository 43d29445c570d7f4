"""Chunked SSD scan (the Mamba2 mixer's recurrence): the CUDA kernel's
wrapper and its plain PyTorch version.

Per batch row and head, with state S (N, Pd) in float32,

    S_t = a_t * S_{t-1} + k_t (x) v_t,      y_t = q_t . S_t,

a_t = exp(log_a_t) <= 1, computed in chunks of Q steps: with l the
inclusive cumulative sum of log_a inside a chunk and `total` its last
entry,

    y_i   = sum_{j<=i} (q_i . k_j) exp(clip(l_i - l_j, -60, 0)) v_j
            + exp(l_i) q_i . S_prev
    S_new = exp(total) S_prev + sum_j exp(clip(total - l_j, -60, 0)) k_j (x) v_j

— the algebra of `repro`'s `_ssd_kernel` and `chunked_gated_scan`, from a
given state before the first step (zeros when none is given). A sequence
that is no multiple of Q is padded with zeros (log_a = 0 and k = 0 leave
the state unchanged), as `mamba_scan_op` pads it.

Given CPU tensors the wrapper runs the plain version (`mamba_scan_plain`,
one chunk at a time in eager PyTorch); given CUDA tensors it launches the
kernels of `csrc/mamba_scan.cu` (five in turn: the chunk decomposition,
parallel over batch row, head and chunk) or raises: there is no fallback.
Each call adds one to `LAUNCHES["mamba_scan"]`, however many CUDA kernels
it runs.

q and k may also come as (B, S, 1, N), one for every head of v (Zamba2's
C and B): the wrapper expands them with a head stride of 0. Given fake or
meta tensors (the dry run) it calls `kernels.shape_only.scan_fwd`, which
launches nothing and counts nothing in LAUNCHES.

Training: when grad mode is on and q, k, v or log_a requires grad,
`mamba_scan` goes through `MambaScanFn`, a `torch.autograd.Function`, from
a zero state (training has none; a given state raises ValueError there).
Its forward is the same kernels (or plain version), keeping each chunk's
starting state and its l for the backward; its backward is
`mamba_scan_bwd.mamba_scan_backward` — on CUDA tensors the hand-written
backward kernel (`csrc/mamba_scan_bwd.cu`), on CPU tensors its plain
version. The final state it returns takes no gradient. With (B, S, 1, N)
q and k the backward sums their gradient over the heads itself.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._common import on_cpu, raise_on
from repro_torch.kernels.shape_only import shape_only

__all__ = ["LAUNCHES", "MAX_CHUNK", "MAX_STATE", "MambaScanFn",
           "mamba_scan", "mamba_scan_plain", "reset_launches"]

MAX_STATE = 512   # state rows N the kernel takes
MAX_CHUNK = 1024  # chunk lengths the kernel takes
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches since the last reset_launches()
LAUNCHES = {"mamba_scan": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check_shapes(q, k, v, log_a, chunk: int) -> None:
    if q.ndim != 4 or k.shape != q.shape or v.ndim != 4 \
            or v.shape[:2] != q.shape[:2] \
            or q.shape[2] not in (1, v.shape[2]) \
            or tuple(log_a.shape) != v.shape[:3]:
        raise ValueError(f"q, k (B,S,H,N) or (B,S,1,N), v (B,S,H,Pd), log_a "
                         f"(B,S,H); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}, {tuple(log_a.shape)}")
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")


def _by_heads(q, k, v):
    """q and k at every head of v: a (B, S, 1, N) pair expanded with a head
    stride of 0."""
    H = v.shape[2]
    if q.shape[2] == H:
        return q, k
    shape = (*q.shape[:2], H, q.shape[3])
    return q.expand(shape), k.expand(shape)


def _plain_chunks(q, k, v, log_a, chunk: int, state):
    """The plain version's chunks: (y (B,S,H,Pd) in v's type, final state
    (B,H,N,Pd) float32, the state before each chunk (B,H,nc,N,Pd) and l of
    each chunk (B,H,nc,Q), float32)."""
    _check_shapes(q, k, v, log_a, chunk)
    q, k = _by_heads(q, k, v)
    B, S, H, N = q.shape
    Pd = v.shape[-1]
    Q = int(chunk)
    pad = (-S) % Q
    if pad:
        zf = lambda t: torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad))
        q, k, v = zf(q), zf(k), zf(v)
        log_a = torch.nn.functional.pad(log_a, (0, 0, 0, pad))
    nc = (S + pad) // Q

    def chunks(t):  # (B, nc*Q, H, *) -> (B, nc, Q, H, *)
        return t.reshape(B, nc, Q, *t.shape[2:])

    qc, kc, vc = chunks(q.float()), chunks(k.float()), chunks(v.float())
    lc = chunks(log_a.float())
    st = (torch.zeros((B, H, N, Pd), dtype=torch.float32, device=q.device)
          if state is None else state.float())
    causal = torch.ones((Q, Q), dtype=torch.bool, device=q.device).tril()
    ys, befores, ls = [], [], []
    for c in range(nc):
        qb, kb, vb = qc[:, c], kc[:, c], vc[:, c]        # (B,Q,H,*)
        l = torch.cumsum(lc[:, c], dim=1)                 # (B,Q,H)
        total = l[:, -1]                                  # (B,H)
        s_qk = torch.einsum("bihn,bjhn->bhij", qb, kb)
        decay = torch.exp(torch.clamp(l[:, :, None] - l[:, None, :],
                                      -60.0, 0.0)).permute(0, 3, 1, 2)
        s_qk = torch.where(causal, s_qk * decay, torch.zeros_like(s_qk))
        y = torch.einsum("bhij,bjhp->bihp", s_qk, vb)
        y = y + torch.einsum("bihn,bhnp->bihp", qb, st) \
            * torch.exp(l)[..., None]
        w = torch.exp(torch.clamp(total[:, None] - l, -60.0, 0.0))
        befores.append(st)
        ls.append(l.transpose(1, 2))
        st = st * torch.exp(total)[:, :, None, None] + torch.einsum(
            "bjhn,bjhp->bhnp", kb * w[..., None], vb)
        ys.append(y)
    y = torch.stack(ys, 1).reshape(B, nc * Q, H, Pd)[:, :S]
    return (y.to(v.dtype), st, torch.stack(befores, 2),
            torch.stack(ls, 2).contiguous())


def mamba_scan_plain(q, k, v, log_a, *, chunk: int, state=None):
    """Plain version, one chunk of `chunk` steps at a time. `state`
    (B,H,N,Pd), when given, is the state before the first step (zeros
    otherwise). Returns (y (B,S,H,Pd) in v's type, final state (B,H,N,Pd)
    float32)."""
    return _plain_chunks(q, k, v, log_a, chunk, state)[:2]


def _shared_heads(q, k) -> bool:
    """True when q and k are the same for every head (a head stride of 0,
    or one head): the kernel then computes the q.k tiles once per batch
    row and chunk, not once per head."""
    return q.shape[2] == 1 or (q.stride(2) == 0 and k.stride(2) == 0)


def _lib() -> ctypes.CDLL:
    lib = _build.load("mamba_scan")
    if not getattr(lib, "_typed", False):
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.mamba_scan_launch.argtypes = [ptr] * 10 + [i32] * 7 + [i64] * 6 \
            + [i32, ptr]
        lib.mamba_scan_launch.restype = i32
        lib._typed = True
    return lib


def _score_heads(q, k, N: int, Pd: int) -> int:
    """How many heads the kernel's score tiles (q.k of each chunk) are
    computed for ahead of the y kernel: 1 when q and k are shared by all
    heads; H when they differ by head and the y kernel would otherwise
    compute a tile more than once (Pd over 64) or over more than 64 of N;
    else 0 (the y kernel computes each tile once, in place)."""
    if _shared_heads(q, k):
        return 1
    return q.shape[2] if N > 64 or Pd > 64 else 0


def _launch(q, k, v, log_a, *, chunk: int, state=None, keep: bool = False):
    """The kernels on CUDA tensors: (y, final state) and, with `keep`, the
    state before each chunk (B,H,nc,N,Pd) and l of each chunk (B,H,nc,Q)
    (the scratch the kernels write them to, kept for the backward)."""
    _check_shapes(q, k, v, log_a, chunk)
    q, k = _by_heads(q, k, v)
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share one of {list(_DTYPES)}, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if log_a.dtype != torch.float32:
        raise TypeError(f"log_a must be float32, got {log_a.dtype}")
    B, S, H, N = q.shape
    Pd = v.shape[-1]
    if N > MAX_STATE or chunk > MAX_CHUNK:
        raise ValueError(f"the kernel takes N <= {MAX_STATE} and chunk <= "
                         f"{MAX_CHUNK}, got N={N}, chunk={chunk}")
    if q.stride(3) != 1 or k.stride(3) != 1:
        raise ValueError("q and k need a unit stride over N")
    for name, t in (("v", v), ("log_a", log_a), ("state", state)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if state is not None and (tuple(state.shape) != (B, H, N, Pd)
                              or state.dtype != torch.float32):
        raise ValueError(f"state must be float32 (B, H, N, Pd) = "
                         f"{(B, H, N, Pd)}, got {state.dtype} "
                         f"{tuple(state.shape)}")
    nc = -(-S // chunk)
    # scratch, written before it is read, on the caller's stream: l per
    # chunk, each chunk's state (then the state before it: with `keep`
    # both are returned for the backward), and the raw q.k tiles of each
    # chunk for `heads` heads
    f32 = dict(dtype=torch.float32, device=v.device)
    lc = torch.empty((B, H, nc, chunk), **f32)
    st = torch.empty((B, H, nc, N, Pd), **f32)
    y = torch.empty_like(v)
    if y.numel() == 0:
        final = (torch.zeros((B, H, N, Pd), **f32) if state is None
                 else state.clone())
        out = (y, final, st.zero_(), lc.zero_())
        return out if keep else out[:2]
    state_out = torch.empty((B, H, N, Pd), **f32)
    heads = _score_heads(q, k, N, Pd)
    cb = torch.empty(B * heads * nc * chunk * chunk, **f32) if heads else None
    stream = torch.cuda.current_stream(v.device).cuda_stream
    code = _lib().mamba_scan_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), log_a.data_ptr(),
        None if state is None else state.data_ptr(), y.data_ptr(),
        state_out.data_ptr(), lc.data_ptr(),
        None if cb is None else cb.data_ptr(), st.data_ptr(),
        B, S, H, N, Pd, chunk, heads, *q.stride()[:3], *k.stride()[:3],
        _DTYPES[v.dtype], stream)
    raise_on(code, "mamba_scan")
    LAUNCHES["mamba_scan"] += 1
    out = (y, state_out, st, lc)
    return out if keep else out[:2]


class MambaScanFn(torch.autograd.Function):
    """The SSD scan with a gradient, from a zero state: forward the kernels
    (or the plain version on CPU tensors), keeping the state before each
    chunk and each chunk's l; backward `mamba_scan_bwd.mamba_scan_backward`
    from them (the kernel on CUDA tensors, the plain formulas on CPU
    tensors). Returns (y, final state); the final state takes no
    gradient."""

    @staticmethod
    def forward(ctx, q, k, v, log_a, chunk: int):
        if all(shape_only(t) for t in (q, k, v, log_a)):
            y, final, st, lc = torch.ops.repro_torch.scan_fwd(
                q, k, v, log_a, chunk, None)
        elif on_cpu(q, k, v, log_a):
            y, final, st, lc = _plain_chunks(q, k, v, log_a, chunk, None)
        else:
            y, final, st, lc = _launch(q, k, v, log_a, chunk=chunk,
                                       keep=True)
        ctx.save_for_backward(q, k, v, st, lc)
        ctx.chunk = chunk
        ctx.mark_non_differentiable(final)
        return y, final

    @staticmethod
    def backward(ctx, dy, _dfinal):
        from .mamba_scan_bwd import mamba_scan_backward
        q, k, v, st, lc = ctx.saved_tensors
        dq, dk, dv, dla = mamba_scan_backward(q, k, v, dy.contiguous(), st,
                                              lc, chunk=ctx.chunk)
        return dq, dk, dv, dla, None


def mamba_scan(q, k, v, log_a, *, chunk: int = 128, state=None):
    """q, k (B,S,H,N), or (B,S,1,N) for every head; v (B,S,H,Pd); log_a
    (B,S,H) <= 0; `state` (B,H,N,Pd) float32, the state before the first
    step, or None (zeros). Returns (y (B,S,H,Pd) in v's type, final state
    (B,H,N,Pd) float32). Any S: a ragged last chunk is zero-padded (in the
    kernel: masked, not copied).

    On CUDA: q, k, v float32 or bfloat16 (one type), log_a float32,
    N <= 512, chunk <= 1024; v, log_a and the state contiguous, q and k
    with a unit stride over N and any other strides — a head stride of 0
    serves B/C shared by all heads without materialising them.

    With grad mode on and an input that requires grad it runs
    `MambaScanFn` (chunk <= 256 on CUDA), which takes no state."""
    chunk = int(chunk)
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (q, k, v, log_a)):
        if state is not None:
            raise ValueError("the gradient path runs from a zero state "
                             "(training has none), got a state")
        return MambaScanFn.apply(q, k, v, log_a, chunk)
    if all(shape_only(t) for t in (q, k, v, log_a)):
        _check_shapes(q, k, v, log_a, chunk)
        return tuple(torch.ops.repro_torch.scan_fwd(
            q, k, v, log_a, chunk, state)[:2])
    if on_cpu(q, k, v, log_a, state):
        return mamba_scan_plain(q, k, v, log_a, chunk=chunk, state=state)
    return _launch(q, k, v, log_a, chunk=chunk, state=state)
