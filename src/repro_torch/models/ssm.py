"""Recurrent sequence mixers of the port: Mamba2 (SSD) and xLSTM (mLSTM,
sLSTM) — the counterpart of `repro.models.ssm`.

Mamba2 and mLSTM share one recurrence, S_t = a_t S_{t-1} + k_t (x) v_t,
y_t = q_t . S_t, run in chunked form by `chunked_gated_scan` through the
hand-written SSD scan kernel's wrapper (`kernels/mamba_scan`): the kernel
on the card, its plain version on the CPU, from a given state or from
zeros, and in training (from zeros) with a gradient through the
hand-written backward kernel (`MambaScanFn`). The kernel's state layout
is (B, H, N, Pd); the model keeps the reference's (B, H, Pd, N) and
transposes at the wrapper's edge. mLSTM's
normalizer is the ones-channel of v (Pd = head width + 1), and its output
is num / max(|den|, 1). `gated_scan_step` is the single-token recurrence
of decode, plain PyTorch.

sLSTM is sequential (its recurrent weights act on h_{t-1}): a length-S
loop of small PyTorch operations, as the reference's `lax.scan` is — no
Pallas kernel in the reference; training differentiates it by autograd
through the loop.

On a mesh (`dist`, the placements of `mamba2_pspec`, `mlstm_pspec` and
`slstm_pspec` recorded by `layers.shard_module`) every weight is
gathered over "data" inside the block (FSDP), and "model" splits:
* Mamba2, where d_in and its heads divide the model ranks: in_z, in_x and
  in_dt column-parallel behind `to_model`, the depthwise conv and the
  conv state by channel, A_log, D, dt_bias, norm and the SSM state by
  head; in_B and in_C stay whole, shared by every head (their gradient on
  a rank covers its heads only: `to_model` on the weights sums it); the
  scan kernel runs on the rank's H/tp heads; the gated RMSNorm's mean over
  the whole d_in sums the ranks' squares (`psum`); out row-parallel into
  `from_model`.
* mLSTM, where its heads divide the model ranks: up_z and up_x
  column-parallel, so xm arrives split over d_in; wq, wk, wv, w_i and
  w_f are split by their rows, so xm's slice times the rank's rows is a
  partial sum of every head, reduce-scattered onto the rank's heads
  (`scatter_sum`, one call for the five); the scan kernel on those heads;
  down row-parallel. Elsewhere every model rank computes every head.
* sLSTM: FSDP only; every model rank runs the same loop. Its h/c state
  is cut by heads where the cache placement cuts it (the mLSTM's rule,
  `models.model.cache_pspecs`): a call from a state gathers it whole and
  the rank keeps its heads of the new one.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels.mamba_scan.mamba_scan import mamba_scan
from repro_torch.kernels.shape_only import shape_only
from repro_torch.launch import collectives as C

from . import layers as L


# ----------------------------------------------------------------------------
# Generic chunked gated scan
# ----------------------------------------------------------------------------

def chunked_gated_scan(q, k, v, log_a, state=None, chunk: int = 256, *,
                       exact_chunk: bool = False):
    """q,k (B,S,H,N), or (B,S,1,N) for every head; v (B,S,H,Pd); log_a
    (B,S,H) (<= 0); state None or (B,H,Pd,N). Returns y (B,S,H,Pd), final
    state (B,H,Pd,N), float32 state math: the SSD scan kernel on the card,
    its plain version on the CPU. With grad mode on and an input requiring
    grad (training, no state) the scan's autograd Function runs: its
    backward is the hand-written backward kernel on the card.

    The scan-block length Q is min(chunk, S), or `chunk` exactly with
    `exact_chunk` (S padded up to it), as in the reference: then calls on
    Q-aligned slices, each from the last one's state, give the bits of one
    call over the whole sequence."""
    Q = scan_block(chunk, q.shape[1], exact_chunk)
    y, st = mamba_scan(
        q, k, v.contiguous(), log_a.contiguous(), chunk=max(Q, 1),
        state=None if state is None
        else state.transpose(-1, -2).contiguous())
    return y, st.transpose(-1, -2)


def scan_block(chunk: int, S: int, exact_chunk: bool) -> int:
    """The scan-block length Q of a call over S steps: min(chunk, S), or
    `chunk` exactly with `exact_chunk`, as in the reference."""
    return int(chunk) if exact_chunk else min(int(chunk), S)


def gated_scan_step(q, k, v, log_a, state):
    """Single-token recurrence (decode). q,k (B,H,N); v (B,H,Pd);
    log_a (B,H); state (B,H,Pd,N)."""
    a = torch.exp(log_a.float())[..., None, None]
    state = state * a + torch.einsum("bhn,bhp->bhpn", k.float(), v.float())
    y = torch.einsum("bhn,bhpn->bhp", q.float(), state)
    return y.to(v.dtype), state


def causal_conv(x, w, conv_state=None):
    """x (B,S,C), w (K,C) depthwise. Returns (y, new_state (B,K-1,C))."""
    K = w.shape[0]
    if conv_state is None:
        xp = F.pad(x, (0, 0, K - 1, 0))
    else:
        xp = torch.cat([conv_state.to(x.dtype), x], dim=1)
    S = x.shape[1]
    y = xp[:, 0:S] * w[0]
    for i in range(1, K):
        y = y + xp[:, i:i + S] * w[i]
    return y, xp[:, -(K - 1):] if K > 1 else None


# ----------------------------------------------------------------------------
# Mamba2 block (zamba2)
# ----------------------------------------------------------------------------

def mamba2_pspec(cfg, tp: int = 16) -> dict:
    """The reference's placement (`repro/models/ssm.py:142-154`): d_in
    and its heads over "model" where both divide tp."""
    d_in = cfg.mamba_expand * cfg.d_model
    H = d_in // cfg.ssm_head_dim
    m = "model" if (d_in % tp == 0 and H % tp == 0) else None
    return {"in_z": ("data", m), "in_x": ("data", m),
            "in_B": ("data", None), "in_C": ("data", None),
            "in_dt": ("data", m), "conv_x": (None, m),
            "A_log": (m,), "D": (m,), "dt_bias": (m,), "norm": (m,),
            "out": (m, "data")}


class Mamba2(nn.Module):
    """The reference's Mamba2 parameters by name: `in_z`, `in_x` (d, d_in),
    `in_B`, `in_C` (d, N), `in_dt` (d, H), `conv_x` (K, d_in), `A_log`,
    `D`, `dt_bias` (H,), `norm` (d_in,), `out` (d_in, d)."""

    def __init__(self, cfg, g: torch.Generator, device=None):
        super().__init__()
        d = cfg.d_model
        d_in = cfg.mamba_expand * d
        N = cfg.ssm_state
        H = d_in // cfg.ssm_head_dim
        self.in_z = L.dense_init(g, d, d_in, device)
        self.in_x = L.dense_init(g, d, d_in, device)
        self.in_B = L.dense_init(g, d, N, device)
        self.in_C = L.dense_init(g, d, N, device)
        self.in_dt = L.dense_init(g, d, H, device)
        self.conv_x = nn.Parameter(
            torch.randn((cfg.conv_kernel, d_in), generator=g, device=device)
            * 0.2, requires_grad=False)
        self.A_log = L.const((H,), 0.0, device)
        self.D = L.const((H,), 1.0, device)
        self.dt_bias = L.const((H,), 0.0, device)
        self.norm = L.const((d_in,), 1.0, device)
        self.out = L.dense_init(g, d_in, d, device)


def apply_mamba2(cfg, p: Mamba2, x, state=None, *, chunk: int = None,
                 exact_chunk: bool = False, dist=None):
    """x (B,S,D). state: None (prefill from scratch) or a dict with
    'conv' (B,K-1,d_in) and 'ssm' (B,H,hd,N) (decode, incremental
    prefill). Returns (out, {"conv", "ssm"}).

    A single decode token from a state runs `gated_scan_step`; every other
    call runs `chunked_gated_scan` from the state (or zeros) with
    chunk = min(cfg.ssm_chunk, S), exactly `chunk` with `exact_chunk`.
    With `dist` this rank's channels and heads where "model" splits them
    (the states too), as the module docstring sets out."""
    B, S, D = x.shape
    d_in = cfg.mamba_expand * D
    N, hd = cfg.ssm_state, cfg.ssm_head_dim
    chunk = chunk or getattr(cfg, "ssm_chunk", 256)
    group = L.model_group(p, "in_x", 1, dist)
    cols, rows = ((1,), (0,)) if group is not None else ((), ())
    xin = x if group is None else C.to_model(x, group)

    def w(leaf, local=()):
        return L.weight(p, leaf, dist, local)

    def shared(leaf):
        # whole B/C projections beside a slice of the heads: each rank adds
        # only its heads' part of their gradient
        t = w(leaf)
        return t if group is None else C.to_model(t, group)

    z = xin @ w("in_z", cols).to(x.dtype)
    xs = xin @ w("in_x", cols).to(x.dtype)
    Bm = xin @ shared("in_B").to(x.dtype)
    Cm = xin @ shared("in_C").to(x.dtype)
    dt = F.softplus((xin @ w("in_dt", cols).to(x.dtype)).float()
                    + w("dt_bias", rows))                          # (B,S,H)
    xs, conv_state = causal_conv(xs, w("conv_x", cols).to(x.dtype),
                                 None if state is None else state["conv"])
    xs = F.silu(xs)
    H = dt.shape[-1]
    xh = xs.reshape(B, S, H, hd)
    log_a = -torch.exp(w("A_log", rows))[None, None] * dt  # (B,S,H), <= 0
    # B/C shared across heads (MQA-style): one (B,S,1,N) for every head,
    # which the scan broadcasts with a head stride of 0 (never
    # materialised; its gradient sums over the heads); dt folded into v
    k = Bm[:, :, None, :]
    q = Cm[:, :, None, :]
    v = xh * dt.to(xh.dtype)[..., None]
    ssm_prev = None if state is None else state["ssm"]
    if S == 1 and ssm_prev is not None and not exact_chunk:
        y, ssm = gated_scan_step(q[:, 0].expand(B, H, N),
                                 k[:, 0].expand(B, H, N), v[:, 0],
                                 log_a[:, 0], ssm_prev)
        y = y[:, None]
    else:
        y, ssm = chunked_gated_scan(q, k, v, log_a, state=ssm_prev,
                                    chunk=chunk, exact_chunk=exact_chunk)
    y = y + xh * w("D", rows)[None, None, :, None]
    y = y.reshape(B, S, H * hd) * F.silu(z)
    yf = y.float()
    if group is None:
        ms = torch.mean(yf * yf, -1, keepdim=True)
    else:   # the mean over the whole d_in: every rank's squares summed
        ms = C.psum(torch.sum(yf * yf, -1, keepdim=True), group) / d_in
    y = (yf * torch.rsqrt(ms + 1e-6) * w("norm", rows)).to(x.dtype)
    out = y @ w("out", rows).to(x.dtype)
    out = out if group is None else C.from_model(out, group)
    return out, {"conv": conv_state, "ssm": ssm}


def mamba2_state_spec(cfg, batch: int, dtype=torch.float32) -> dict:
    """{"conv": (shape, dtype), "ssm": (shape, float32)} of the decode
    state (the reference returns ShapeDtypeStructs)."""
    d_in = cfg.mamba_expand * cfg.d_model
    H = d_in // cfg.ssm_head_dim
    return {"conv": ((batch, cfg.conv_kernel - 1, d_in), dtype),
            "ssm": ((batch, H, cfg.ssm_head_dim, cfg.ssm_state),
                    torch.float32)}


# ----------------------------------------------------------------------------
# mLSTM block (xlstm)
# ----------------------------------------------------------------------------

def mlstm_pspec(cfg, tp: int = 16) -> dict:
    """The reference's placement (`repro/models/ssm.py:233-241`): d_in
    over "model" (up_z, up_x by column, the head projections by row)
    where the heads divide tp."""
    m = "model" if cfg.n_heads % tp == 0 else None
    return {"up_z": ("data", m), "up_x": ("data", m), "wq": (m, None),
            "wk": (m, None), "wv": (m, None), "w_i": (m, None),
            "w_f": (m, None), "down": (m, "data")}


class MLSTM(nn.Module):
    """The reference's mLSTM parameters by name: `up_z`, `up_x` (d, d_in),
    `wq`, `wk`, `wv` (d_in, d_in), `w_i`, `w_f` (d_in, H), `down`
    (d_in, d)."""

    def __init__(self, cfg, g: torch.Generator, device=None):
        super().__init__()
        d = cfg.d_model
        d_in = cfg.mamba_expand * d
        H = cfg.n_heads
        self.up_z = L.dense_init(g, d, d_in, device)
        self.up_x = L.dense_init(g, d, d_in, device)
        self.wq = L.dense_init(g, d_in, d_in, device)
        self.wk = L.dense_init(g, d_in, d_in, device)
        self.wv = L.dense_init(g, d_in, d_in, device)
        self.w_i = L.dense_init(g, d_in, H, device)
        self.w_f = L.dense_init(g, d_in, H, device)
        self.down = L.dense_init(g, d_in, d, device)


_MLSTM_HEADS = ("wq", "wk", "wv", "w_i", "w_f")


def mlstm_weights(p: MLSTM, dist=None, group=None) -> dict:
    """The mLSTM's weights as this rank computes with them, gathered over
    "data" once a call (the token-wise parts run per block of tokens):
    up_z and up_x by their columns and the head projections and down by
    their rows where a model `group` splits them, else whole."""
    cols, rows = ((1,), (0,)) if group is not None else ((), ())
    w = {n: L.weight(p, n, dist, cols) for n in ("up_z", "up_x")}
    w.update({n: L.weight(p, n, dist, rows) for n in (*_MLSTM_HEADS,
                                                      "down")})
    return w


def _mlstm_tokens(w: dict, x, H: int, dh: int, tp: int = 1, group=None):
    """The token-wise part of an mLSTM block ahead of its scan, on x
    (B,T,D) with the weights `w` (`mlstm_weights`): silu(z), q, k * i, v
    with the ones channel, log f. With a model `group` (the heads split
    over its tp ranks; x has passed `to_model`) this rank's H/tp heads:
    the head projections' partial sums of every head reduce-scattered
    onto them."""
    B, T, _ = x.shape
    z = x @ w["up_z"].to(x.dtype)
    xm = x @ w["up_x"].to(x.dtype)
    qkv = [xm @ w[n].to(x.dtype) for n in _MLSTM_HEADS]
    if group is not None:
        qkv = _scatter_heads(qkv, group, tp)
        H = H // tp
    q = qkv[0].reshape(B, T, H, dh) * (dh ** -0.5)
    k = qkv[1].reshape(B, T, H, dh) * (dh ** -0.5)
    v = qkv[2].reshape(B, T, H, dh)
    ig = torch.sigmoid(qkv[3].float())
    fg = torch.sigmoid(qkv[4].float() + 1.0)
    kk = k * ig.to(k.dtype)[..., None]
    v1 = torch.cat([v, v.new_ones((B, T, H, 1))], dim=-1)
    return F.silu(z), q, kk, v1, torch.log(fg + 1e-9)


def _scatter_heads(parts, group, tp: int):
    """Partial sums (B,T,n_j) of every head, each this rank's slice
    n_j/tp of their sum over `group` (its heads), in one reduce-scatter."""
    B, T = parts[0].shape[:2]
    widths = [t.shape[-1] // tp for t in parts]
    both = torch.cat([t.reshape(B, T, tp, n) for t, n in zip(parts, widths)],
                     dim=-1)
    mine = C.scatter_sum(both, 2, group)[:, :, 0]
    return list(torch.split(mine, widths, dim=-1))


def _mlstm_out(w: dict, y1, gz, dh: int):
    """The token-wise part of an mLSTM block after its scan: y1 (B,T,H,Pd)
    -> num / max(|den|, 1) * silu(z) @ down (this rank's part of it where
    down's rows are split)."""
    B, T = y1.shape[:2]
    num, den = y1[..., :dh], y1[..., dh:]
    y = num / torch.clamp(torch.abs(den), min=1.0)
    return (y.reshape(B, T, -1) * gz) @ w["down"].to(gz.dtype)


def apply_mlstm(cfg, p: MLSTM, x, state=None, *, chunk: int = None,
                exact_chunk: bool = False, dist=None):
    """x (B,S,D) -> (y, state). state: None or (B,H,dh+1,dh) float32 (the
    normalizer folded in as the extra v channel). A single decode token
    from a state runs `gated_scan_step`; every other call
    `chunked_gated_scan` at N = dh, Pd = dh + 1 (`exact_chunk` as in
    `apply_mamba2`). The token-wise parts before and after the scan run
    `layers.by_blocks` of the scan's Q, so an incremental prefill gives
    the bits of a one-shot one. With `dist` this rank's heads where
    "model" splits them (the state too)."""
    B, S, D = x.shape
    H = cfg.n_heads
    dh = cfg.mamba_expand * D // H
    chunk = chunk or cfg.ssm_chunk
    Q = scan_block(chunk, S, exact_chunk)
    group = L.model_group(p, "up_x", 1, dist)
    w = mlstm_weights(p, dist, group)
    tp = 1 if group is None else dist.tp
    xin = x if group is None else C.to_model(x, group)
    gz, q, kk, v1, log_a = L.by_blocks(
        lambda xb: _mlstm_tokens(w, xb, H, dh, tp, group), Q, xin)
    if S == 1 and state is not None and not exact_chunk:
        y1, st = gated_scan_step(q[:, 0], kk[:, 0], v1[:, 0], log_a[:, 0],
                                 state)
        y1 = y1[:, None]
    else:
        y1, st = chunked_gated_scan(q, kk, v1, log_a, state=state,
                                    chunk=chunk, exact_chunk=exact_chunk)
    out = L.by_blocks(lambda yb, gb: _mlstm_out(w, yb, gb, dh), Q, y1, gz)
    return (out if group is None else C.from_model(out, group)), st


def mlstm_state_spec(cfg, batch: int) -> tuple:
    """(shape, float32) of the mLSTM state: (B, H, dh + 1, dh)."""
    dh = cfg.mamba_expand * cfg.d_model // cfg.n_heads
    return (batch, cfg.n_heads, dh + 1, dh), torch.float32


# ----------------------------------------------------------------------------
# sLSTM block (xlstm) — sequential
# ----------------------------------------------------------------------------

def slstm_pspec(cfg, tp: int = 16) -> dict:
    """The reference's placement (`repro/models/ssm.py:298-301`): FSDP
    only, replicated on "model"."""
    return {"wz": ("data", None), "wi": ("data", None), "wf": ("data", None),
            "wo": ("data", None), "r": (None, None, None),
            "down": ("data", None)}


class SLSTM(nn.Module):
    """The reference's sLSTM parameters by name: `wz`, `wo` (d, d), `wi`,
    `wf` (d, H), `r` (H, dh, dh), `down` (d, d)."""

    def __init__(self, cfg, g: torch.Generator, device=None):
        super().__init__()
        d = cfg.d_model
        H = cfg.n_heads
        dh = d // H
        self.wz = L.dense_init(g, d, d, device)
        self.wi = L.dense_init(g, d, H, device)
        self.wf = L.dense_init(g, d, H, device)
        self.wo = L.dense_init(g, d, d, device)
        self.r = nn.Parameter(
            torch.randn((H, dh, dh), generator=g, device=device)
            * (dh ** -0.5), requires_grad=False)
        self.down = L.dense_init(g, d, d, device)


def _slstm_tokens(w: dict, x, H: int, dh: int):
    """The token-wise part of an sLSTM block on x (B,T,D) with its weights
    `w`, float32: z and the output gate sigmoid(o) (B,T,H,dh), the input
    and forget gates sigmoid(i), sigmoid(f + 1) (B,T,H)."""
    B, T, _ = x.shape
    return ((x @ w["wz"].to(x.dtype)).reshape(B, T, H, dh).float(),
            torch.sigmoid((x @ w["wo"].to(x.dtype)).reshape(B, T, H, dh)
                          .float()),
            torch.sigmoid((x @ w["wi"].to(x.dtype)).float()),
            torch.sigmoid((x @ w["wf"].to(x.dtype)).float() + 1.0))


def slstm_state_group(cfg, dist):
    """The model group when the sLSTM's h/c state is cut by heads over it
    (the cache placement's rule: the heads divide the model ranks), else
    None."""
    if dist is None or dist.tp == 1 or cfg.n_heads % dist.tp:
        return None
    return dist.group(dist.tp_axis)


def apply_slstm(cfg, p: SLSTM, x, state=None, *, chunk: int = None,
                exact_chunk: bool = False, dist=None):
    """x (B,S,D). state: None (zeros) or {"h", "c"} (B,H,dh) float32.
    Returns (out, {"h", "c"}). The recurrence runs one step at a time, a
    few small operations a step, as the reference's `lax.scan` does; every
    step has the same shapes. The token-wise parts before and after it
    run `layers.by_blocks` of the scan-block length (`chunk`,
    `exact_chunk` as in `apply_mlstm`), so calls split on its multiples
    give the bits of one call. With `dist` every model rank runs the whole
    block (FSDP weights gathered); the state is this rank's heads where
    `slstm_state_group` cuts it."""
    B, S, D = x.shape
    H = cfg.n_heads
    dh = D // H
    Q = scan_block(chunk or cfg.ssm_chunk, S, exact_chunk)
    # whole weights, gathered over "data" once a call
    w = {n: L.weight(p, n, dist) for n in ("wz", "wo", "wi", "wf", "r",
                                            "down")}
    zs, og, ig, fg = L.by_blocks(lambda xb: _slstm_tokens(w, xb, H, dh), Q,
                                 x)
    group = slstm_state_group(cfg, dist)
    if state is None:
        h = x.new_zeros((B, H, dh), dtype=torch.float32)
        c = torch.zeros_like(h)
    elif group is None:
        h, c = state["h"], state["c"]
    else:
        h, c = (C.all_gather(state[n], 1, group) for n in ("h", "c"))
    ys, h, c = slstm_recurrence(w["r"], zs, og, ig, fg, h, c)
    out = L.by_blocks(lambda yb: yb.reshape(B, yb.shape[1], D).to(x.dtype)
                      @ w["down"].to(x.dtype), Q, ys)
    if group is not None:
        n = H // dist.tp
        h, c = (t.narrow(1, dist.index(dist.tp_axis) * n, n).contiguous()
                for t in (h, c))
    return out, {"h": h, "c": c}


def slstm_recurrence(r, zs, og, ig, fg, h, c):
    """The sLSTM recurrence over the steps of z and the output gate
    (B,S,H,dh) and the input and forget gates (B,S,H), from h, c (B,H,dh)
    with recurrent weights r (H,dh,dh): (h of every step (B,S,H,dh), last
    h, last c). One step at a time, eight small operations a step:
    zr = tanh(z_t + h r), c = f_t c + i_t zr, h = o_t tanh(c). The inputs
    are unbound into their steps once, not indexed a step at a time: the
    values are the same, and under autograd their gradients are stacked
    once at the end instead of each step's being added into a zeroed
    tensor of the whole sequence (S full-size adds a block). Given fake
    or meta tensors (the dry run) the loop is one shape-only op
    (`SlstmShapeFn`)."""
    if shape_only(zs):
        keep = torch.is_grad_enabled() and any(
            t.requires_grad for t in (r, zs, og, ig, fg, h, c))
        return SlstmShapeFn.apply(r, zs, og, ig, fg, h, c, keep)
    ys = []
    for z_t, o_t, i_t, f_t in zip(zs.unbind(1), og.unbind(1),
                                  ig[..., None].unbind(1),
                                  fg[..., None].unbind(1)):
        hr = torch.bmm(h.transpose(0, 1), r).transpose(0, 1)
        zr = torch.tanh(z_t + hr)
        c = f_t * c + i_t * zr
        h = o_t * torch.tanh(c)
        ys.append(h)
    return torch.stack(ys, 1), h, c


class SlstmShapeFn(torch.autograd.Function):
    """The sLSTM loop under fake tensors: `kernels.shape_only.slstm_fwd`
    (the S steps' outputs, operations and, in grad mode, what autograd
    keeps of each step) and its backward `slstm_bwd`, each one op."""

    @staticmethod
    def forward(ctx, r, zs, og, ig, fg, h, c, keep: bool):
        ys, h, c, saved = torch.ops.repro_torch.slstm_fwd(
            r, zs, og, ig, fg, h, c, keep)
        ctx.save_for_backward(r, zs, saved)
        return ys, h, c

    @staticmethod
    def backward(ctx, dys, dh, dc):
        r, zs, saved = ctx.saved_tensors
        dr, dz, do, di, df, dh0, dc0 = torch.ops.repro_torch.slstm_bwd(
            r, zs, saved, dys.contiguous(), dh.contiguous(), dc.contiguous())
        return dr, dz, do, di, df, dh0, dc0, None


def slstm_state_spec(cfg, batch: int) -> dict:
    """{"h", "c"}: (shape, float32) of the sLSTM state, (B, H, dh) each."""
    dh = cfg.d_model // cfg.n_heads
    shape = (batch, cfg.n_heads, dh)
    return {"h": (shape, torch.float32), "c": (shape, torch.float32)}
