"""Shared building blocks of the port's language models: rmsnorm, RoPE
(split-half layout), the SwiGLU MLP, token embedding and the LM head —
the port's counterpart of `repro.models.layers`, cut to what the hybrid
family runs (other norms, GELU, tied heads and learned positions come
with their families).

Blocks are `nn.Module`s whose parameters carry the reference's names
(`scale`, `wi`/`wg`/`wo`, `tok`/`head`), so a reference parameter tree
loads into them by name (`repro_torch.convert.lm_params_from_reference`).
Weights are drawn from a `torch.Generator` with the reference's
distributions: dense normal * 1/sqrt(d_in), embeddings normal * 0.02 (the
two packages' random streams differ, so the parity tests load the
reference's weights instead).
"""
from __future__ import annotations

import math

import torch
from torch import nn


# ---------------------------------------------------------------- helpers

def dense_init(g: torch.Generator, d_in: int, d_out: int, device) -> nn.Parameter:
    w = torch.randn((d_in, d_out), generator=g, device=device)
    return nn.Parameter(w * (1.0 / math.sqrt(d_in)), requires_grad=False)


def embed_init(g: torch.Generator, vocab: int, d: int, device) -> nn.Parameter:
    w = torch.randn((vocab, d), generator=g, device=device)
    return nn.Parameter(w * 0.02, requires_grad=False)


def const(shape, value: float, device) -> nn.Parameter:
    return nn.Parameter(torch.full(shape, value, device=device),
                        requires_grad=False)


# ------------------------------------------------------------------ norms

class Norm(nn.Module):
    """rmsnorm with its `scale` (the norm of the families ported so far)."""

    def __init__(self, cfg, device=None):
        super().__init__()
        self.scale = const((cfg.d_model,), 1.0, device)

    def forward(self, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
        xf = x.float()
        xf = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
        return (xf * self.scale).to(x.dtype)


# ------------------------------------------------------------------- RoPE

def rope_freqs(positions: torch.Tensor, dh: int,
               theta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """positions (..., S) -> cos/sin (..., S, dh//2), float32."""
    inv = 1.0 / (theta ** (torch.arange(0, dh, 2, dtype=torch.float32,
                                        device=positions.device) / dh))
    ang = positions.float()[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x (B,S,H,dh) in the split-half layout; cos/sin (B,S,dh//2) or
    (S,dh//2)."""
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    if cos.ndim == 2:
        cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    else:
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


# ------------------------------------------------------------------- MLPs

class MLP(nn.Module):
    """SwiGLU: `wi`, `wg` (d, f), `wo` (f, d)."""

    def __init__(self, cfg, g: torch.Generator, device=None):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff
        self.wi = dense_init(g, d, f, device)
        self.wg = dense_init(g, d, f, device)
        self.wo = dense_init(g, f, d, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = torch.nn.functional.silu(x @ self.wg.to(x.dtype)) \
            * (x @ self.wi.to(x.dtype))
        return h @ self.wo.to(x.dtype)


# -------------------------------------------------------------- embeddings

class Embed(nn.Module):
    """Token table `tok` (padded vocab, d) and the LM head `head`
    (d, padded vocab)."""

    def __init__(self, cfg, g: torch.Generator, device=None):
        super().__init__()
        self.tok = embed_init(g, cfg.padded_vocab, cfg.d_model, device)
        self.head = dense_init(g, cfg.d_model, cfg.padded_vocab, device)


def embed_tokens(p: Embed, tokens: torch.Tensor) -> torch.Tensor:
    return p.tok[tokens.long()]


def lm_logits(p: Embed, x: torch.Tensor) -> torch.Tensor:
    return x @ p.head.to(x.dtype)
