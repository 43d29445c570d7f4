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

from repro_torch.launch import collectives as C


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


def norm_pspec(cfg) -> dict:
    """The norm's placement: replicated."""
    if cfg.norm == "rmsnorm":
        return {"scale": (None,)}
    if cfg.norm == "layernorm":
        return {"scale": (None,), "bias": (None,)}
    return {}


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

def mlp_pspec(cfg) -> dict:
    """wi/wg split along d over "data" and along f over "model", wo the
    transpose (`repro/models/layers.py:93-96`)."""
    p = {"wi": ("data", "model"), "wo": ("model", "data")}
    if cfg.act == "swiglu":
        p["wg"] = ("data", "model")
    return p


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

    def forward(self, x: torch.Tensor, dist=None) -> torch.Tensor:
        """With `dist` and f split over "model": x enters through
        `to_model`, each rank computes its columns of h and its rows' part
        of the output, summed by `from_model`."""
        group = model_group(self, "wi", 1, dist)
        local = (1,) if group is not None else ()
        xin = x if group is None else C.to_model(x, group)
        h = xin @ weight(self, "wi", dist, local).to(x.dtype)
        if self.swiglu:
            h = torch.nn.functional.silu(
                xin @ weight(self, "wg", dist, local).to(x.dtype)) * h
        else:
            h = torch.nn.functional.gelu(h, approximate="tanh")
        out = h @ weight(self, "wo", dist, (0,) if local else ()).to(x.dtype)
        return out if group is None else C.from_model(out, group)


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


def embeddings_pspec(cfg, max_seq: int = 0) -> dict:
    """The token table's vocabulary over "model" and d over "data", the
    head the transpose, learned positions d over "data"
    (`repro/models/layers.py:121-127`)."""
    p = {"tok": ("model", "data")}
    if not cfg.tie_embeddings:
        p["head"] = ("data", "model")
    if cfg.rope_theta == 0.0 and max_seq > 0:
        p["pos"] = (None, "data")
    return p


def embed_tokens(p: Embed, tokens: torch.Tensor, dist=None) -> torch.Tensor:
    """The rows of `tok` for tokens. With the vocabulary split over
    "model" the lookup is vocab-parallel: ids outside this rank's range
    give zeros, and `from_model` sums the ranks' rows."""
    group = model_group(p, "tok", 0, dist)
    if group is None:
        return weight(p, "tok", dist)[tokens.long()]
    tok = weight(p, "tok", dist, (0,))
    ids, keep = vocab_ids(tokens, tok.shape[0], dist)
    rows = torch.where(keep[..., None], tok[ids], tok.new_zeros(()))
    return C.from_model(rows, group)


def vocab_ids(ids: torch.Tensor, n: int, dist):
    """(ids relative to this rank's vocabulary slice of n entries,
    clamped into it; whether each id lies in the slice)."""
    rel = ids.long() - dist.index(dist.tp_axis) * n
    keep = (rel >= 0) & (rel < n)
    return rel.clamp(0, n - 1), keep


def head_group(p: Embed, dist):
    """The model group when the head's vocabulary is split over "model"
    (the logits are then vocabulary-sharded), else None."""
    return model_group(p, "tok", 0, dist) if p.tied else \
        model_group(p, "head", 1, dist)


def lm_logits(p: Embed, x: torch.Tensor, dist=None,
              whole: bool = True) -> torch.Tensor:
    """x . head (tok transposed when tied). With the vocabulary split over
    "model": x enters through `to_model` and each rank computes its
    vocabulary slice, gathered whole when `whole` (serving's last-token
    logits; the loss keeps the slice)."""
    group = head_group(p, dist)
    local = () if group is None else ((0,) if p.tied else (1,))
    w = weight(p, "tok", dist, local).t() if p.tied else \
        weight(p, "head", dist, local)
    if group is None:
        return x @ w.to(x.dtype)
    out = C.to_model(x, group) @ w.to(x.dtype)
    return C.all_gather(out, out.ndim - 1, group) if whole else out


# ------------------------------------------------------ layout on a mesh

def placement(p: nn.Module, leaf: str):
    """The axes this rank holds `p.<leaf>` split over (one entry a
    dimension; None for a whole leaf or a module that is not placed)."""
    return getattr(p, "placement", {}).get(leaf)


def placements(tree) -> dict:
    """{parameter name: its split axes} of every leaf that the modules in
    `tree` (a module, or a dict or list holding modules: a train state)
    hold split, as `shard_module` recorded them: the one record of a
    sharded model's layout."""
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return {k: v for t in tree for k, v in placements(t).items()}
    if not isinstance(tree, nn.Module):
        return {}
    return {f"{name}.{leaf}" if name else leaf: axes
            for name, m in tree.named_modules()
            for leaf, axes in getattr(m, "placement", {}).items()}


def leaf_axes(placed: dict, name: str):
    """The axes in `placed` (`placements`) of `name` or of the longest
    parameter name it ends in (`opt.m.`, `opt.v.`, `opt.master.`,
    `grad_err.`, `params.` prefixes); None (whole) for any other leaf."""
    parts = name.split(".")
    for i in range(len(parts)):
        key = ".".join(parts[i:])
        if key in placed:
            return placed[key]
    return None


def model_group(p: nn.Module, leaf: str, dim: int, dist):
    """The model ranks' group when dimension `dim` of `p.<leaf>` is split
    over them (the caller then computes on its slice), else None."""
    if dist is None:
        return None
    axes = placement(p, leaf)
    if axes and axes[dim] == dist.tp_axis:
        return dist.group(dist.tp_axis)
    return None


def weight(p: nn.Module, leaf: str, dist, local: tuple = ()) -> torch.Tensor:
    """`p.<leaf>` as this rank computes with it: gathered whole along every
    dimension its placement splits except those in `local` — over "data"
    by `gather_data` (backward: reduce-scatter, summing the batch ranks'
    shares), over "model" by `gather_whole` (serving's layouts that put
    "model" where the caller cannot compute on a slice)."""
    t = getattr(p, leaf)
    if dist is None:
        return t
    axes = placement(p, leaf)
    if not any(a for d, a in enumerate(axes or ()) if d not in local):
        return t
    cache = getattr(p, "_gathered", None)
    if cache is not None and (leaf, local) in cache:
        return cache[leaf, local]
    for dim, axis in enumerate(axes):
        if axis is None or dim in local:
            continue
        gather = C.gather_whole if axis == dist.tp_axis else C.gather_data
        t = gather(t, dim, dist.group(axis))
    if cache is not None:
        cache[leaf, local] = t
    return t


def shard_module(module: nn.Module, dist, axes_of: dict) -> None:
    """Replace each of the module's own parameters that `axes_of` {leaf:
    the axes it splits over on this mesh (`DistContext.effective`)}
    splits by this rank's shard, in place (the whole tensor is freed),
    and record those axes as the module's `placement` (read by
    `weight`)."""
    placed = {}
    for leaf, axes in axes_of.items():
        old = getattr(module, leaf, None)
        if not axes or not isinstance(old, nn.Parameter):
            continue
        setattr(module, leaf, nn.Parameter(dist.shard(old.data, axes),
                                           requires_grad=old.requires_grad))
        placed[leaf] = axes
    if placed:
        module.placement = placed


class gathered:
    """Context (serving, no gradient): inside it `weight` gathers each
    leaf of the modules' trees once and reuses it — a layer's token-wise
    parts run per block of tokens (`by_blocks`), and its weights would
    otherwise be gathered once a block. Nothing to do without `dist`."""

    def __init__(self, dist, *modules):
        self.modules = [] if dist is None else [
            m for mod in modules for m in mod.modules()
            if getattr(m, "placement", None)]

    def __enter__(self):
        for m in self.modules:
            m._gathered = {}
        return self

    def __exit__(self, *exc):
        for m in self.modules:
            del m._gathered


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
