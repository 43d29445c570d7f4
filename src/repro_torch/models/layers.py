"""Shared building blocks of the port's language models: the norms
(rmsnorm, layernorm, OLMo's nonparametric LN), RoPE (split-half layout),
the SwiGLU and GELU MLPs, token embedding with learned positions
(whisper) and the LM head (its own or the embedding's, tied) — the port's
counterpart of `repro.models.layers` — and
`by_blocks`, which runs a token-wise function per block of tokens
(`TOKEN_BLOCK` of them in the stacked families' layers).

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
    """`cfg.norm`: rmsnorm (`scale`), layernorm (`scale`, `bias`) or
    nonparametric_ln (OLMo: no parameters), float32 math."""

    def __init__(self, cfg, device=None):
        super().__init__()
        if cfg.norm not in ("rmsnorm", "layernorm", "nonparametric_ln"):
            raise ValueError(f"unknown norm {cfg.norm!r}")
        self.kind = cfg.norm
        if self.kind != "nonparametric_ln":
            self.scale = const((cfg.d_model,), 1.0, device)
        if self.kind == "layernorm":
            self.bias = const((cfg.d_model,), 0.0, device)

    def forward(self, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
        xf = x.float()
        if self.kind == "rmsnorm":
            xf = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True)
                                  + eps)
            return (xf * self.scale).to(x.dtype)
        mean = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
        xf = (xf - mean) * torch.rsqrt(var + eps)
        if self.kind == "layernorm":
            xf = xf * self.scale + self.bias
        return xf.to(x.dtype)


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
    """SwiGLU (`wi`, `wg` (d, f), `wo` (f, d)) or, with `cfg.act` "gelu",
    `wi` and `wo` around the tanh-approximated GELU (jax.nn.gelu's
    default). f is `d_ff` when given (deepseek's dense first layer:
    `cfg.dense_d_ff`), else `cfg.d_ff`."""

    def __init__(self, cfg, g: torch.Generator, device=None, d_ff=None):
        super().__init__()
        d, f = cfg.d_model, d_ff or cfg.d_ff
        self.swiglu = cfg.act == "swiglu"
        self.wi = dense_init(g, d, f, device)
        if self.swiglu:
            self.wg = dense_init(g, d, f, device)
        self.wo = dense_init(g, f, d, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x @ self.wi.to(x.dtype)
        if self.swiglu:
            h = torch.nn.functional.silu(x @ self.wg.to(x.dtype)) * h
        else:
            h = torch.nn.functional.gelu(h, approximate="tanh")
        return h @ self.wo.to(x.dtype)


# -------------------------------------------------------------- embeddings

class Embed(nn.Module):
    """Token table `tok` (padded vocab, d) and the LM head `head`
    (d, padded vocab), which a tied config (`cfg.tie_embeddings`) does not
    have: its head is `tok` transposed. With learned positions
    (`cfg.rope_theta == 0`, whisper) and `max_seq > 0`, also the position
    table `pos` (max_seq, d), drawn as `tok` is; whisper's encoder and
    decoder share it."""

    def __init__(self, cfg, g: torch.Generator, device=None,
                 max_seq: int = 0):
        super().__init__()
        self.tied = bool(cfg.tie_embeddings)
        self.tok = embed_init(g, cfg.padded_vocab, cfg.d_model, device)
        if not self.tied:
            self.head = dense_init(g, cfg.d_model, cfg.padded_vocab, device)
        if cfg.rope_theta == 0.0 and max_seq > 0:
            self.pos = embed_init(g, max_seq, cfg.d_model, device)


def embed_tokens(p: Embed, tokens: torch.Tensor) -> torch.Tensor:
    return p.tok[tokens.long()]


def lm_logits(p: Embed, x: torch.Tensor) -> torch.Tensor:
    w = p.tok.t() if p.tied else p.head
    return x @ w.to(x.dtype)


# ------------------------------------------------------- token-wise blocks

# tokens a call of a stacked layer's token-wise products holds (`by_blocks`;
# an incremental prefill's chunk boundaries are multiples of it)
TOKEN_BLOCK = 256


def by_blocks(fn, block: int, *xs):
    """fn(*xs) for a token-wise fn of tensors xs (B,S,...) that returns a
    (B,S,...) tensor or a tuple of them, run on one block of `block`
    tokens at a time (a contiguous copy of each, when S > block) and
    concatenated along S.
    Matrix products and the CPU's vectorised exp/log/sigmoid/cos give bits
    that depend on how many rows a call holds: cuBLAS splits a product
    over K by its row count and takes a batched product for a strided
    input, and the CPU leaves a scalar tail whose place depends on the
    tensor's size. Per block a token's bits depend on its block alone, so
    calls on slices that start on multiples of `block` give the bits of
    one call over the whole sequence (the incremental prefills of the ssm
    and dense families rely on it)."""
    S = xs[0].shape[1]
    if S <= block:
        return fn(*xs)
    parts = [fn(*(x[:, t:t + block].contiguous() for x in xs))
             for t in range(0, S, block)]
    if isinstance(parts[0], torch.Tensor):
        return torch.cat(parts, dim=1)
    return tuple(torch.cat(ts, dim=1) for ts in zip(*parts))
