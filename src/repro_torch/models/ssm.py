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
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels.mamba_scan.mamba_scan import mamba_scan

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
    and its heads over "model" where both divide tp. The port does not
    run it split yet (ROADMAP.md item 6c): the tree only."""
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
                 exact_chunk: bool = False):
    """x (B,S,D). state: None (prefill from scratch) or a dict with
    'conv' (B,K-1,d_in) and 'ssm' (B,H,hd,N) (decode, incremental
    prefill). Returns (out, {"conv", "ssm"}).

    A single decode token from a state runs `gated_scan_step`; every other
    call runs `chunked_gated_scan` from the state (or zeros) with
    chunk = min(cfg.ssm_chunk, S), exactly `chunk` with `exact_chunk`."""
    B, S, D = x.shape
    d_in = cfg.mamba_expand * D
    N, hd = cfg.ssm_state, cfg.ssm_head_dim
    H = d_in // hd
    chunk = chunk or getattr(cfg, "ssm_chunk", 256)
    z = x @ p.in_z.to(x.dtype)
    xs = x @ p.in_x.to(x.dtype)
    Bm = x @ p.in_B.to(x.dtype)
    Cm = x @ p.in_C.to(x.dtype)
    dt = F.softplus((x @ p.in_dt.to(x.dtype)).float() + p.dt_bias)  # (B,S,H)
    xs, conv_state = causal_conv(xs, p.conv_x.to(x.dtype),
                                 None if state is None else state["conv"])
    xs = F.silu(xs)
    xh = xs.reshape(B, S, H, hd)
    log_a = -torch.exp(p.A_log)[None, None] * dt  # (B,S,H), <= 0
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
    y = y + xh * p.D[None, None, :, None]
    y = y.reshape(B, S, d_in) * F.silu(z)
    yf = y.float()
    y = (yf * torch.rsqrt(torch.mean(yf * yf, -1, keepdim=True) + 1e-6)
         * p.norm).to(x.dtype)
    out = y @ p.out.to(x.dtype)
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
    """The reference's placement (`repro/models/ssm.py:233-241`); the tree
    only (item 6c)."""
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


def _mlstm_tokens(p: MLSTM, x, H: int, dh: int):
    """The token-wise part of an mLSTM block ahead of its scan, on x
    (B,T,D): silu(z), q, k * i, v with the ones channel, log f."""
    B, T, _ = x.shape
    z = x @ p.up_z.to(x.dtype)
    xm = x @ p.up_x.to(x.dtype)
    q = (xm @ p.wq.to(x.dtype)).reshape(B, T, H, dh) * (dh ** -0.5)
    k = (xm @ p.wk.to(x.dtype)).reshape(B, T, H, dh) * (dh ** -0.5)
    v = (xm @ p.wv.to(x.dtype)).reshape(B, T, H, dh)
    ig = torch.sigmoid((xm @ p.w_i.to(x.dtype)).float())
    fg = torch.sigmoid((xm @ p.w_f.to(x.dtype)).float() + 1.0)
    kk = k * ig.to(k.dtype)[..., None]
    v1 = torch.cat([v, v.new_ones((B, T, H, 1))], dim=-1)
    return F.silu(z), q, kk, v1, torch.log(fg + 1e-9)


def _mlstm_out(p: MLSTM, y1, gz, dh: int):
    """The token-wise part of an mLSTM block after its scan: y1 (B,T,H,Pd)
    -> num / max(|den|, 1) * silu(z) @ down."""
    B, T = y1.shape[:2]
    num, den = y1[..., :dh], y1[..., dh:]
    y = num / torch.clamp(torch.abs(den), min=1.0)
    return (y.reshape(B, T, -1) * gz) @ p.down.to(gz.dtype)


def apply_mlstm(cfg, p: MLSTM, x, state=None, *, chunk: int = None,
                exact_chunk: bool = False):
    """x (B,S,D) -> (y, state). state: None or (B,H,dh+1,dh) float32 (the
    normalizer folded in as the extra v channel). A single decode token
    from a state runs `gated_scan_step`; every other call
    `chunked_gated_scan` at N = dh, Pd = dh + 1 (`exact_chunk` as in
    `apply_mamba2`). The token-wise parts before and after the scan run
    `layers.by_blocks` of the scan's Q, so an incremental prefill gives
    the bits of a one-shot one."""
    B, S, D = x.shape
    H = cfg.n_heads
    dh = cfg.mamba_expand * D // H
    chunk = chunk or cfg.ssm_chunk
    Q = scan_block(chunk, S, exact_chunk)
    gz, q, kk, v1, log_a = L.by_blocks(
        lambda xb: _mlstm_tokens(p, xb, H, dh), Q, x)
    if S == 1 and state is not None and not exact_chunk:
        y1, st = gated_scan_step(q[:, 0], kk[:, 0], v1[:, 0], log_a[:, 0],
                                 state)
        y1 = y1[:, None]
    else:
        y1, st = chunked_gated_scan(q, kk, v1, log_a, state=state,
                                    chunk=chunk, exact_chunk=exact_chunk)
    return L.by_blocks(lambda yb, gb: _mlstm_out(p, yb, gb, dh), Q, y1,
                       gz), st


def mlstm_state_spec(cfg, batch: int) -> tuple:
    """(shape, float32) of the mLSTM state: (B, H, dh + 1, dh)."""
    dh = cfg.mamba_expand * cfg.d_model // cfg.n_heads
    return (batch, cfg.n_heads, dh + 1, dh), torch.float32


# ----------------------------------------------------------------------------
# sLSTM block (xlstm) — sequential
# ----------------------------------------------------------------------------

def slstm_pspec(cfg, tp: int = 16) -> dict:
    """The reference's placement (`repro/models/ssm.py:298-301`); the tree
    only (item 6c)."""
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


def _slstm_tokens(p: SLSTM, x, H: int, dh: int):
    """The token-wise part of an sLSTM block on x (B,T,D), float32: z and
    the output gate sigmoid(o) (B,T,H,dh), the input and forget gates
    sigmoid(i), sigmoid(f + 1) (B,T,H)."""
    B, T, _ = x.shape
    return ((x @ p.wz.to(x.dtype)).reshape(B, T, H, dh).float(),
            torch.sigmoid((x @ p.wo.to(x.dtype)).reshape(B, T, H, dh)
                          .float()),
            torch.sigmoid((x @ p.wi.to(x.dtype)).float()),
            torch.sigmoid((x @ p.wf.to(x.dtype)).float() + 1.0))


def apply_slstm(cfg, p: SLSTM, x, state=None, *, chunk: int = None,
                exact_chunk: bool = False):
    """x (B,S,D). state: None (zeros) or {"h", "c"} (B,H,dh) float32.
    Returns (out, {"h", "c"}). The recurrence runs one step at a time, a
    few small operations a step, as the reference's `lax.scan` does; every
    step has the same shapes. The token-wise parts before and after it
    run `layers.by_blocks` of the scan-block length (`chunk`,
    `exact_chunk` as in `apply_mlstm`), so calls split on its multiples
    give the bits of one call."""
    B, S, D = x.shape
    H = cfg.n_heads
    dh = D // H
    Q = scan_block(chunk or cfg.ssm_chunk, S, exact_chunk)
    zs, og, ig, fg = L.by_blocks(lambda xb: _slstm_tokens(p, xb, H, dh), Q, x)
    if state is None:
        h = x.new_zeros((B, H, dh), dtype=torch.float32)
        c = torch.zeros_like(h)
    else:
        h, c = state["h"], state["c"]
    ys, h, c = slstm_recurrence(p.r, zs, og, ig, fg, h, c)
    out = L.by_blocks(lambda yb: yb.reshape(B, yb.shape[1], D).to(x.dtype)
                      @ p.down.to(x.dtype), Q, ys)
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
    tensor of the whole sequence (S full-size adds a block)."""
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


def slstm_state_spec(cfg, batch: int) -> dict:
    """{"h", "c"}: (shape, float32) of the sLSTM state, (B, H, dh) each."""
    dh = cfg.d_model // cfg.n_heads
    shape = (batch, cfg.n_heads, dh)
    return {"h": (shape, torch.float32), "c": (shape, torch.float32)}
