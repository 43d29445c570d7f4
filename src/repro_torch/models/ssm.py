"""Mamba2 (SSD) mixer of the port — the counterpart of the Mamba2 part of
`repro.models.ssm` (mLSTM and sLSTM come with the xLSTM slice).

The recurrence S_t = a_t S_{t-1} + k_t (x) v_t, y_t = q_t . S_t runs in
chunked form. On the card a prefill from scratch (`state is None`) goes
through the hand-written SSD scan kernel (`kernels/mamba_scan`), whose
state layout is (B, H, N, Pd); the model keeps the reference's
(B, H, Pd, N). `chunked_gated_scan` is the plain chunked scan with an
initial state and `exact_chunk`, and `gated_scan_step` the single-token
recurrence of decode; both are plain PyTorch.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels.mamba_scan.mamba_scan import (mamba_scan,
                                                       mamba_scan_plain)

from . import layers as L


# ----------------------------------------------------------------------------
# Generic chunked gated scan (plain)
# ----------------------------------------------------------------------------

def chunked_gated_scan(q, k, v, log_a, state=None, chunk: int = 256, *,
                       exact_chunk: bool = False):
    """q,k (B,S,H,N); v (B,S,H,Pd); log_a (B,S,H) (<= 0); state None or
    (B,H,Pd,N). Returns y (B,S,H,Pd), final state (B,H,Pd,N), float32
    state math — plain PyTorch on any device.

    The scan-block length Q is min(chunk, S), or `chunk` exactly with
    `exact_chunk` (S padded up to it), as in the reference."""
    S = q.shape[1]
    Q = int(chunk) if exact_chunk else min(int(chunk), S)
    y, st = mamba_scan_plain(
        q, k, v, log_a, chunk=max(Q, 1),
        state=None if state is None else state.transpose(-1, -2))
    return y, st.transpose(-1, -2)


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
    'conv' (B,K-1,d_in) and 'ssm' (B,H,hd,N) (decode). Returns
    (out, {"conv", "ssm"}).

    A prefill from scratch runs the SSD scan kernel's wrapper with
    chunk = min(cfg.ssm_chunk, S) (exactly `chunk` with `exact_chunk`):
    the kernel on the card, its plain
    version on the CPU. A single decode token runs `gated_scan_step`. A
    chunked call with a state runs the plain `chunked_gated_scan` on the
    CPU and raises on the card: the kernel takes no initial state yet
    (ROADMAP.md)."""
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
    # B/C shared across heads (MQA-style), broadcast with a head stride of
    # 0 (never materialised); dt folded into v
    k = Bm[:, :, None, :].expand(B, S, H, N)
    q = Cm[:, :, None, :].expand(B, S, H, N)
    v = xh * dt.to(xh.dtype)[..., None]
    ssm_prev = None if state is None else state["ssm"]
    if S == 1 and ssm_prev is not None and not exact_chunk:
        y, ssm = gated_scan_step(q[:, 0], k[:, 0], v[:, 0], log_a[:, 0],
                                 ssm_prev)
        y = y[:, None]
    elif ssm_prev is None:
        y, st = mamba_scan(q, k, v.contiguous(), log_a.contiguous(),
                           chunk=chunk if exact_chunk else min(chunk, S))
        ssm = st.transpose(-1, -2)
    else:
        if x.is_cuda:
            raise NotImplementedError(
                "a chunked scan from a given state has no kernel on the card "
                "yet (incremental prefill; see ROADMAP.md)")
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
