"""Model assembly of the port — the counterpart of `repro.models.model`
for every family of `repro.configs`: dense (a stack of attention layers:
qwen2, OLMo, GLM-4, Phi-3), vlm (phi-3-vision: the dense stack, with
patch embeddings before the tokens), moe (attention layers whose FFN is a
mixture of experts: OLMoE, DeepSeekMoE with its dense first layers),
encdec (whisper: an encoder over frame embeddings, a decoder with
cross-attention, learned positions), hybrid (Zamba2: a Mamba2 backbone
with one attention block whose weights are shared by every "A" position)
and ssm (xLSTM: mLSTM "X" and sLSTM "S" blocks, or Mamba2 "M").

Entry points:
  init_params           — the model (`StackedLM`, `EncDecLM` or
                          `HybridLM`), weights from a seeded
                          torch.Generator on the device
  loss_fn               — the training loss of every family, with a
                          gradient (the backward kernels of flash
                          attention, the SSD scan and the MoE expert
                          FFN)
  prefill / decode_step — the serving paths with their caches
                          (`batch["frames"]` for encdec,
                          `batch["patches"]` optional for vlm)
  cache_specs           — shapes and types of decode_step's cache
  extend_cache_specs_ok / empty_extend_cache / prefill_extend
                        — incremental chunked prefill (dense, vlm, moe,
                          ssm)

Parameters carry the reference tree's names (`embed.tok`,
`blocks.0.mamba.in_x`, `blocks.0.mlstm.wq`, `blocks.3.slstm.r`,
`shared_attn.attn.wq`, ...): the "A" positions of `blocks` are empty, as
the reference's `{}` entries are, and their weights live in
`shared_attn`. A stacked model (dense, vlm, moe) keeps one module a
layer (`layers.3.attn.wq`, `layers.3.moe.wi`) where the reference stacks
each segment's leaves along a leading axis (`segments.1.moe.wi[2]`, layer
count of segment 0 + 2), and so does whisper's (`enc.5.attn.wq` for the
reference's `enc.attn.wq[5]`, `layers.5.xattn.wq`);
`convert.lm_params_from_reference` maps one onto the other. A stacked
model's KV cache keeps the reference's per-segment layout, {"k", "v"} of
(L_segment, B, S, Hkv, dh) for each segment of `segments_of`; whisper's
is {"self": [{"k", "v"} (L, B, S, Hkv, dh)], "cross": {"k", "v"}
(L, B, S_enc, Hkv, dh)}. A config outside these families' shapes raises
NotImplementedError (ROADMAP.md).

Placements: `param_pspecs(cfg, tp, max_seq)` maps every parameter name
to the reference's PartitionSpec of its leaf (`repro/models/model.py:
161-182`; a stacked leaf loses its leading None) and `cache_pspecs` does
the same for the cache (`:785-827`). On a mesh (`dist`, a
`launch.mesh.DistContext`) every family runs the whole layout
(`shard_model` cuts each parameter to this rank's shard, and each module
records its leaves' axes, which the layers read): FSDP over "data"
(weights gathered whole inside the layer), attention heads, MLP columns
and rows, the vocabulary and the routed experts over "model"; Mamba2's
and mLSTM's channels and heads (`models.ssm`); whisper's encoder and
decoder attention and MLPs, its cross-attention cache whole on every
model rank; every cache in its `cache_pspecs` placement (`local_cache_
specs`): a KV cache split by heads or, where the KV heads do not divide
tp, by sequence (Zamba2's windowed ring by slot), the conv state by
channel, the SSM and mLSTM states by heads, the sLSTM's h/c by heads
where the mLSTM's rule splits them.
"""
from __future__ import annotations

import functools
import math

import torch
import torch.distributed as tdist
import torch.utils.checkpoint
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.kernels.flash_attention.flash_attention import \
    flash_attention

from repro_torch.launch import collectives as C

from . import attention as A
from . import layers as L
from . import moe as MOE
from . import ssm as SS


# tokens a call of a stacked layer's token-wise products holds (`by_blocks`;
# an incremental prefill's chunk boundaries are multiples of it)
TOKEN_BLOCK = L.TOKEN_BLOCK
# families whose layers are stacked attention blocks with a per-segment
# (L, B, S, Hkv, dh) KV cache
STACKED = ("dense", "moe", "vlm")


def _check_family(cfg) -> None:
    """Raise for a config the port does not run yet. It runs the dense and
    vlm families (no MoE), the moe family (its routed and shared experts,
    its dense first layers; SwiGLU), the encdec family (an encoder, no
    MoE), the hybrid family with "M" blocks and one shared "A" block, and
    the ssm family with "M", "X" and "S" blocks; with any of the three
    norms, SwiGLU or GELU, qkv biases or not, tied heads or not; learned
    positions (`rope_theta == 0`) in the encdec family, RoPE in the
    others."""
    pattern = set(cfg.block_pattern)
    if cfg.family == "moe":
        ok = cfg.moe and cfg.act == "swiglu"
    elif cfg.family in ("dense", "vlm"):
        ok = not cfg.moe
    elif cfg.family == "encdec":
        ok = not cfg.moe and cfg.encoder_layers > 0 and cfg.encoder_seq > 0
    elif cfg.family == "hybrid":
        ok = cfg.shared_attention and pattern <= {"A", "M"}
    else:
        ok = cfg.family == "ssm" and pattern <= {"M", "X", "S"}
    if not ok or (cfg.rope_theta <= 0) != (cfg.family == "encdec"):
        raise NotImplementedError(
            f"the port runs the dense, vlm, moe, encdec (whisper), hybrid "
            f"(Zamba2) and ssm (xLSTM) families; {cfg.name!r} "
            f"({cfg.family}) in this shape comes with a later slice "
            f"(ROADMAP.md)")


def n_moe_layers(cfg) -> int:
    return (cfg.n_layers - cfg.moe_layer_start) if cfg.moe else 0


def segments_of(cfg) -> list[tuple[str, int]]:
    """Homogeneous (kind, count) segments of a stacked decoder (the
    reference's; the port runs the "dense", "densffn" and "moe" kinds)."""
    if cfg.family in ("dense", "vlm"):
        return [("dense", cfg.n_layers)]
    if cfg.family == "moe":
        segs = []
        if cfg.moe_layer_start > 0:
            segs.append(("densffn", cfg.moe_layer_start))
        segs.append(("moe", cfg.n_layers - cfg.moe_layer_start))
        return segs
    if cfg.family == "encdec":
        return [("dec", cfg.n_layers)]
    raise ValueError(cfg.family)


class AttnBlock(nn.Module):
    """An attention block: ln1, attn, ln2 and its FFN — `mlp` for the
    "dense" kind (every layer of a dense stack, and Zamba2's shared
    block) and "densffn" (of width `cfg.dense_d_ff`), `moe` for the "moe"
    kind."""

    def __init__(self, cfg, g, device=None, kind: str = "dense"):
        super().__init__()
        self.ln1 = L.Norm(cfg, device)
        self.attn = A.Attention(cfg, g, device)
        self.ln2 = L.Norm(cfg, device)
        if kind == "moe":
            self.moe = MOE.MoE(cfg, g, device)
        else:
            self.mlp = L.MLP(cfg, g, device, d_ff=cfg.dense_d_ff
                             if kind == "densffn" else None)


class DecBlock(nn.Module):
    """A whisper decoder block ("dec"): ln1, attn (causal self-attention),
    lnx, xattn (cross-attention over the encoder's output), ln2, mlp. The
    encoder's blocks are `AttnBlock`s (ln1, attn, ln2, mlp)."""

    def __init__(self, cfg, g, device=None):
        super().__init__()
        self.ln1 = L.Norm(cfg, device)
        self.attn = A.Attention(cfg, g, device)
        self.lnx = L.Norm(cfg, device)
        self.xattn = A.Attention(cfg, g, device)
        self.ln2 = L.Norm(cfg, device)
        self.mlp = L.MLP(cfg, g, device)


class MambaBlock(nn.Module):
    """A Mamba2 block ("M"): ln1, mamba."""

    def __init__(self, cfg, g, device=None):
        super().__init__()
        self.ln1 = L.Norm(cfg, device)
        self.mamba = SS.Mamba2(cfg, g, device)


class MLSTMBlock(nn.Module):
    """An mLSTM block ("X"): ln1, mlstm."""

    def __init__(self, cfg, g, device=None):
        super().__init__()
        self.ln1 = L.Norm(cfg, device)
        self.mlstm = SS.MLSTM(cfg, g, device)


class SLSTMBlock(nn.Module):
    """An sLSTM block ("S"): ln1, slstm."""

    def __init__(self, cfg, g, device=None):
        super().__init__()
        self.ln1 = L.Norm(cfg, device)
        self.slstm = SS.SLSTM(cfg, g, device)


_BLOCKS = {"M": MambaBlock, "X": MLSTMBlock, "S": SLSTMBlock}


class HybridLM(nn.Module):
    """embed, blocks (one per `cfg.block_pattern` entry; empty at shared
    "A" positions), shared_attn (when the pattern has "A"), final_norm —
    the reference's parameter tree of both its hybrid and ssm families."""

    def __init__(self, cfg, g: torch.Generator, device=None):
        super().__init__()
        _check_family(cfg)
        self.cfg = cfg
        self.embed = L.Embed(cfg, g, device)
        blocks = []
        for kind in cfg.block_pattern:
            if kind == "A":
                if not hasattr(self, "shared_attn"):
                    self.shared_attn = AttnBlock(cfg, g, device)
                blocks.append(nn.Module())  # weights in shared_attn
            else:
                blocks.append(_BLOCKS[kind](cfg, g, device))
        self.blocks = nn.ModuleList(blocks)
        self.final_norm = L.Norm(cfg, device)

    def block(self, i: int) -> nn.Module:
        """The module holding block i's weights."""
        if self.cfg.block_pattern[i] == "A":
            return self.shared_attn
        return self.blocks[i]


class StackedLM(nn.Module):
    """embed, layers (`cfg.n_layers` attention blocks, each of its
    segment's kind in `segments_of` order), final_norm — the reference's
    dense, vlm and moe trees, each segment's stacked leaves one module a
    layer."""

    def __init__(self, cfg, g: torch.Generator, device=None):
        super().__init__()
        _check_family(cfg)
        self.cfg = cfg
        self.embed = L.Embed(cfg, g, device)
        self.layers = nn.ModuleList([
            AttnBlock(cfg, g, device, kind)
            for kind, count in segments_of(cfg) for _ in range(count)])
        self.final_norm = L.Norm(cfg, device)


class EncDecLM(nn.Module):
    """embed (with the learned position table `pos` of `max_seq` rows,
    which the encoder's frames and the decoder's tokens share), enc
    (`cfg.encoder_layers` `AttnBlock`s), enc_norm, layers (`cfg.n_layers`
    `DecBlock`s), final_norm — the reference's encdec tree, each stacked
    leaf one module a layer. Raises ValueError when `max_seq <
    cfg.encoder_seq`: the encoder's positions would run past the table
    (the reference fails there too)."""

    def __init__(self, cfg, g: torch.Generator, device=None,
                 max_seq: int = 0):
        super().__init__()
        _check_family(cfg)
        if max_seq < cfg.encoder_seq:
            raise ValueError(
                f"{cfg.name!r}: max_seq {max_seq} < encoder_seq "
                f"{cfg.encoder_seq}; the encoder and the decoder share one "
                f"learned position table of max_seq rows")
        self.cfg = cfg
        self.embed = L.Embed(cfg, g, device, max_seq)
        self.enc = nn.ModuleList([AttnBlock(cfg, g, device)
                                  for _ in range(cfg.encoder_layers)])
        self.enc_norm = L.Norm(cfg, device)
        self.layers = nn.ModuleList([DecBlock(cfg, g, device)
                                     for _ in range(cfg.n_layers)])
        self.final_norm = L.Norm(cfg, device)


# the first names of parameters that the reference stacks along a leading
# layer axis: a stacked model's layers and whisper's encoder
STACKED_PREFIXES = ("layers", "enc")


def reference_ndim(name: str, ndim: int) -> int:
    """The rank of the reference leaf that the port's parameter `name` of
    rank `ndim` comes from: one more under `STACKED_PREFIXES` (the
    reference's `segments/<i>/...` and `enc/...` leaves carry the layer
    axis), the same elsewhere (the name map of
    `convert.lm_params_from_reference`)."""
    return ndim + (name.split(".", 1)[0] in STACKED_PREFIXES)


def _layer_slots(cfg) -> list[tuple[int, int]]:
    """(segment, index within the segment) of each layer of a stacked
    model: where its keys and values lie in the per-segment cache."""
    return [(s, j) for s, (_, count) in enumerate(segments_of(cfg))
            for j in range(count)]


def reference_leaves(cfg, names) -> list[list[str]]:
    """The port's parameter `names` grouped by the reference leaf each
    comes from, each group in that leaf's flat order (the layer axis
    leads): `layers.<l>.<rest>` of segment s's layers form the leaf
    `segments.<s>.<rest>`, in layer order; `enc.<l>.<rest>` form
    `enc.<rest>`; every other name is a leaf of its own."""
    slots = _layer_slots(cfg) if cfg.family in (*STACKED, "encdec") else []
    groups: dict = {}
    for name in names:
        head, *rest = name.split(".", 2)
        if head in STACKED_PREFIXES:
            layer, leaf = int(rest[0]), rest[1]
            seg = slots[layer][0] if head == "layers" else 0
            groups.setdefault((head, seg, leaf), []).append((layer, name))
        else:
            groups[(name,)] = [(0, name)]
    return [[n for _, n in sorted(g)] for g in groups.values()]


# ----------------------------------------------------------------------------
# Placements
# ----------------------------------------------------------------------------

def _block_pspec(cfg, kind: str, tp: int) -> dict:
    """The placement tree of one block of `kind` (the reference's
    `_block_pspec`), keyed by the port's module names."""
    n = L.norm_pspec(cfg)
    if kind in ("dense", "densffn", "moe", "enc", "A"):
        p = {"ln1": n, "attn": A.attention_pspec(cfg, tp), "ln2": n}
        if kind == "moe":
            p["moe"] = MOE.moe_pspec(cfg)
        else:
            p["mlp"] = L.mlp_pspec(cfg)
        return p
    if kind == "dec":
        return {"ln1": n, "attn": A.attention_pspec(cfg, tp), "lnx": n,
                "xattn": A.attention_pspec(cfg, tp), "ln2": n,
                "mlp": L.mlp_pspec(cfg)}
    if kind == "M":
        return {"ln1": n, "mamba": SS.mamba2_pspec(cfg, tp)}
    if kind == "X":
        return {"ln1": n, "mlstm": SS.mlstm_pspec(cfg, tp)}
    return {"ln1": n, "slstm": SS.slstm_pspec(cfg, tp)}


def _pspec_tree(cfg, tp: int, max_seq: int) -> dict:
    tree = {"embed": L.embeddings_pspec(cfg, max_seq),
            "final_norm": L.norm_pspec(cfg)}
    if cfg.family in ("hybrid", "ssm"):
        tree["blocks"] = {str(i): _block_pspec(cfg, kind, tp)
                          for i, kind in enumerate(cfg.block_pattern)
                          if kind != "A"}
        tree["shared_attn"] = _block_pspec(cfg, "A", tp)
    elif cfg.family == "encdec":
        tree["enc"] = {str(i): _block_pspec(cfg, "enc", tp)
                       for i in range(cfg.encoder_layers)}
        tree["enc_norm"] = L.norm_pspec(cfg)
        tree["layers"] = {str(i): _block_pspec(cfg, "dec", tp)
                          for i in range(cfg.n_layers)}
    else:
        kinds = [kind for kind, count in segments_of(cfg)
                 for _ in range(count)]
        tree["layers"] = {str(i): _block_pspec(cfg, kind, tp)
                          for i, kind in enumerate(kinds)}
    return tree


@functools.lru_cache(maxsize=64)
def _param_shapes(cfg, max_seq: int) -> tuple:
    """((name, shape), ...) of `init_params(cfg, max_seq=max_seq)`'s
    parameters, from the meta device (an encdec model's table of
    positions is drawn at `cfg.encoder_seq` rows at least and left out
    when max_seq is 0, as the reference's tree has no "pos" then)."""
    rows = max(max_seq, cfg.encoder_seq) if cfg.family == "encdec" \
        else max_seq
    model = init_params(cfg, max_seq=rows, device="meta")
    return tuple((n, tuple(p.shape)) for n, p in model.named_parameters()
                 if max_seq or n != "embed.pos")


def param_leaves(cfg, tp: int = 16, max_seq: int = 0) -> dict:
    """{parameter name: (whole shape, placement)} of the model
    `init_params(cfg, max_seq=max_seq)` builds."""
    tree = _pspec_tree(cfg, tp, max_seq)
    out = {}
    for name, shape in _param_shapes(cfg, max_seq):
        node = tree
        for part in name.split("."):
            node = node[part]
        out[name] = (shape, node)
    return out


def param_pspecs(cfg, tp: int = 16, max_seq: int = 0) -> dict:
    """{parameter name: placement}: for each dimension the axis it splits
    over ("data", "model") or None — the reference's `param_pspecs` tree
    at `tp` model ranks, leaf for leaf (its stacked leaves without their
    leading None)."""
    return {n: axes for n, (_, axes) in param_leaves(cfg, tp,
                                                     max_seq).items()}


def serve_pspec(axes: tuple, shape: tuple, tp: int) -> tuple:
    """The reference's optimised-serving placement of one leaf
    (`repro/launch/dryrun.py:72-87`): "data" dropped; a leaf that "model"
    does not split stays whole under 32 MiB of float32, else "model" goes
    on its largest dimension that tp divides."""
    names = tuple(None if a == "data" else a for a in axes)
    if "model" in names or not shape:
        return names
    if math.prod(shape) * 4 < 32 * 2 ** 20:
        return names
    names = list(names) + [None] * (len(shape) - len(names))
    for d in sorted(range(len(shape)), key=lambda d: -shape[d]):
        if shape[d] % tp == 0:
            names[d] = "model"
            break
    return tuple(names)


def serve_pspecs(cfg, tp: int, max_seq: int = 0) -> dict:
    """{parameter name: placement} under `serve_pspec`, applied to each
    reference leaf as the reference holds it (a layer's leaf stacked over
    its segment's layers), the layer axis then dropped."""
    counts = [count for _, count in segments_of(cfg)] \
        if cfg.family in (*STACKED, "encdec") else []
    slots = _layer_slots(cfg) if counts else []
    out = {}
    for name, (shape, axes) in param_leaves(cfg, tp, max_seq).items():
        head, *rest = name.split(".", 2)
        if head not in STACKED_PREFIXES:
            out[name] = serve_pspec(axes, shape, tp)
            continue
        n = cfg.encoder_layers if head == "enc" else \
            counts[slots[int(rest[0])][0]]
        full = serve_pspec((None, *axes), (n, *shape), tp)
        if full[0] is not None:
            raise ValueError(f"{name}: the serving rule splits the layer "
                             f"axis, which the port does not")
        out[name] = full[1:]
    return out


def _axis_sizes(mesh) -> dict:
    """{axis name: ranks} of a DeviceMesh, or the mapping itself."""
    if isinstance(mesh, dict):
        return mesh
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def _div(n: int, k: int) -> bool:
    return k > 0 and n % k == 0


def axes_entry(axes) -> object:
    """A placement's entry for several axes: their tuple, or the one
    name (as a PartitionSpec normalises it)."""
    axes = tuple(axes)
    return axes[0] if len(axes) == 1 else axes


def cache_pspecs(cfg, batch: int, mesh, batch_axes=("data",)):
    """The cache's placement tree, in `cache_specs`' structure (the
    reference's `cache_pspecs`): the batch over the batch axes when they
    divide it, KV heads over "model" when they divide tp, else the KV
    sequence over "model"; Mamba2 and mLSTM heads over "model" when they
    divide. `mesh` is a DeviceMesh or {axis: ranks}."""
    sizes = _axis_sizes(mesh)
    dp = math.prod(sizes[a] for a in batch_axes)
    tp = sizes["model"]
    b_ax = axes_entry(batch_axes) if _div(batch, dp) else None

    def kv(stacked: bool):
        lead = (None,) if stacked else ()
        if _div(cfg.n_kv_heads, tp):
            return (*lead, b_ax, None, "model", None)
        return (*lead, b_ax, "model", None, None)

    if cfg.family in ("hybrid", "ssm"):
        d_in = cfg.mamba_expand * cfg.d_model
        m_ax = "model" if _div(d_in // cfg.ssm_head_dim, tp) else None
        x_ax = "model" if _div(cfg.n_heads, tp) else None
        out = []
        for kind in cfg.block_pattern:
            if kind == "A":
                out.append({"k": kv(False), "v": kv(False)})
            elif kind == "M":
                out.append({"conv": (b_ax, None,
                                     m_ax if _div(d_in, tp) else None),
                            "ssm": (b_ax, m_ax, None, None)})
            elif kind == "X":
                out.append((b_ax, x_ax, None, None))
            else:
                out.append({"h": (b_ax, x_ax, None), "c": (b_ax, x_ax, None)})
        return out
    if cfg.family == "encdec":
        cross = (None, b_ax, None, None, None)
        return {"self": [{"k": kv(True), "v": kv(True)}],
                "cross": {"k": cross, "v": cross}}
    return [{"k": kv(True), "v": kv(True)} for _ in segments_of(cfg)]


def kv_layout(cfg, dist) -> str:
    """How a stacked model's KV cache splits over the model ranks here:
    "heads" (the KV heads divide tp), "seq" (they do not: the sequence is
    split) or "" (one model rank, or no mesh)."""
    if dist is None or dist.tp == 1:
        return ""
    return "heads" if cfg.n_kv_heads % dist.tp == 0 else "seq"


def check_mesh(cfg, dist) -> None:
    """Raise ValueError for a mesh this config cannot run on: a dimension
    that a placement splits over ranks that do not divide it (every
    family's leaves)."""
    if dist is None:
        return
    sizes = dist.sizes()
    split = {"model": sizes["tp"], "data": sizes["fsdp"]}
    for name, (shape, axes) in param_leaves(cfg, sizes["tp"]).items():
        for dim, (n, axis) in enumerate(zip(shape, axes)):
            if axis and n % split[axis]:
                raise ValueError(
                    f"{name}: dimension {dim} of {n} does not split over "
                    f"{split[axis]} {axis!r} ranks")


def shard_model(model: nn.Module, cfg, dist, pspecs: dict = None) -> None:
    """Cut every parameter of the model to this rank's shard of its
    placement, in place, each module recording its leaves' split axes
    (`layers.shard_module`; `layers.placements` reads them back).
    `pspecs` {name: logical axes}: `param_pspecs` at the model's own
    position table (checked first: `check_mesh`) when None."""
    MOE.check_mesh(cfg, dist)
    check_mesh(cfg, dist)
    if pspecs is None:
        pos = getattr(getattr(model, "embed", None), "pos", None)
        pspecs = param_pspecs(cfg, dist.tp,
                              0 if pos is None else pos.shape[0])
    for mod_name, module in model.named_modules():
        prefix = f"{mod_name}." if mod_name else ""
        L.shard_module(module, dist, {
            leaf: dist.effective(pspecs.get(prefix + leaf))
            for leaf, _ in module.named_parameters(recurse=False)})


def init_params(cfg, seed: int = 0, *, max_seq: int = 0,
                device=None) -> nn.Module:
    """The model with random weights drawn from a torch.Generator seeded
    with `seed`, on `device` (None = the card; raises without CUDA):
    `StackedLM` for the dense, vlm and moe families, `EncDecLM` for
    encdec (its position table of `max_seq` rows; ValueError below
    `cfg.encoder_seq`), else `HybridLM`. `max_seq` is the reference's
    argument: only learned positions use it."""
    dev = resolve_device(device)
    # the meta device (shapes only) draws from no generator of its own
    g = torch.Generator(device="cpu" if dev.type == "meta" else dev)
    g.manual_seed(int(seed))
    if cfg.family == "encdec":
        return EncDecLM(cfg, g, dev, int(max_seq)).eval()
    lm = StackedLM if cfg.family in STACKED else HybridLM
    return lm(cfg, g, dev).eval()


def _positions(params, start: int, n: int, dist=None):
    """Rows start..start+n-1 of the learned position table, (1, n, d)
    (gathered over "data" with `dist`)."""
    table = L.weight(params.embed, "pos", dist)
    if start + n > table.shape[0]:
        raise ValueError(f"positions {start}..{start + n - 1} run past the "
                         f"learned position table of {table.shape[0]} rows "
                         f"(max_seq)")
    return table[start:start + n][None]


def _embed(params, tokens, start: int, dtype, dist=None):
    """Token embeddings of tokens (B, S) at positions start.., plus their
    learned position rows when the model has a table (whisper);
    vocab-parallel with `dist` where the table is split."""
    x = L.embed_tokens(params.embed, tokens, dist).to(dtype)
    if hasattr(params.embed, "pos"):
        x = x + _positions(params, start, x.shape[1], dist).to(dtype)
    return x


def _embed_inputs(cfg, params, batch, dtype, dist=None):
    """The reference's `_embed_inputs`: (x, n_prefix). The tokens'
    embeddings in `dtype` at positions 0.. (plus their learned position
    rows with a table: whisper's decoder); a vlm batch with `"patches"`
    (B, P, d) puts them, cast to `dtype`, before the tokens (n_prefix =
    P); without them a vlm runs on text alone, as the reference's does."""
    x = _embed(params, batch["tokens"], 0, dtype, dist)
    if cfg.family == "vlm" and "patches" in batch:
        patches = batch["patches"].to(dtype)
        return torch.cat([patches, x], dim=1), patches.shape[1]
    return x, 0


def _run_layer(cfg, fn, p, *args, remat: bool = False, **kwargs):
    """fn(cfg, p, *args, **kwargs), one layer; under
    `torch.utils.checkpoint` (non-reentrant) when `remat`, with
    `cfg.remat_policy`'s choice of what to save (`_remat_context`)."""
    if not remat:
        return fn(cfg, p, *args, **kwargs)
    return torch.utils.checkpoint.checkpoint(
        fn, cfg, p, *args, use_reentrant=False, **_remat_context(cfg),
        **kwargs)


def _encode(cfg, params: EncDecLM, frames, dtype=torch.float32, *,
            remat: bool = False, dist=None):
    """Whisper's encoder over frame embeddings (B, S_enc, d): cast to
    `dtype`, plus position rows 0..S_enc-1, the non-causal blocks (flash,
    every key kept; its gradient Function when x requires grad), each
    under `torch.utils.checkpoint` when `remat` (the reference's
    jax.checkpoint of `_encode`'s body), the encoder's norm;
    tensor-parallel with `dist` where the layers are placed."""
    x = frames.to(dtype)
    x = x + _positions(params, 0, x.shape[1], dist).to(dtype)
    for p in params.enc:
        x = _run_layer(cfg, _train_layer, p, x, causal=False,
                       remat=remat, dist=dist)
    return params.enc_norm(x)


def _dec_layer(cfg, p: DecBlock, x, enc_out, dist=None):
    """A whisper decoder layer over the whole sequence: causal
    self-attention, cross-attention against keys and values of the
    encoder's output built here (`A.encoder_kv`, so under remat their
    gradient reaches `enc_out` through the rerun), the MLP. Returns (x,
    (k, v) of the self-attention, (k, v) of the cross-attention): with
    `dist` the KV heads this rank holds."""
    h, kv = A.attention(cfg, p.attn, p.ln1(x), causal=True, dist=dist)
    x = x + h
    cross_kv = A.encoder_kv(cfg, p.xattn, enc_out, dist)
    h, _ = A.attention(cfg, p.xattn, p.lnx(x), causal=False,
                       cross_kv=cross_kv, dist=dist)
    x = x + h
    return x + p.mlp(p.ln2(x), dist), kv, cross_kv


def _cache_kv(cfg, k, v, dist):
    """A prefill's self-attention keys and values (B, S, Hkv', dh) as its
    cache holds them on this rank: as computed (whole, or this rank's
    heads where they split), or this rank's 1/tp of the positions where
    the cache is split by sequence (`kv_layout` "seq"; S must divide)."""
    if kv_layout(cfg, dist) != "seq":
        return k, v
    S = k.shape[1]
    if S % dist.tp:
        raise ValueError(f"a cache of {S} positions does not split over "
                         f"{dist.tp} model ranks")
    n = S // dist.tp
    r = dist.index(dist.tp_axis)
    return k[:, r * n:(r + 1) * n], v[:, r * n:(r + 1) * n]


def _prefill_encdec(cfg, params: EncDecLM, batch, dtype, dist=None):
    """Whisper's prefill: the encoder over `batch["frames"]`, then each
    decoder layer's causal self-attention over the tokens and its
    cross-attention against keys and values of the encoder's output,
    computed once a layer and kept in the cache's "cross" part. With
    `dist` the self part in its `cache_pspecs` placement (`_cache_kv`)
    and the cross part whole on every model rank (gathered where this
    rank computed its heads only)."""
    enc_out = _encode(cfg, params, batch["frames"], dtype, dist=dist)
    x, _ = _embed_inputs(cfg, params, batch, dtype, dist)
    ks, vs, cks, cvs = [], [], [], []
    for p in params.layers:
        x, kv, (ek, ev) = _dec_layer(cfg, p, x, enc_out, dist)
        k, v = _cache_kv(cfg, *kv, dist)
        if ek.shape[2] != cfg.n_kv_heads:
            group = dist.group(dist.tp_axis)
            ek, ev = (C.all_gather(t, 2, group) for t in (ek, ev))
        ks.append(k), vs.append(v), cks.append(ek), cvs.append(ev)
    cache = {"self": [{"k": torch.stack(ks), "v": torch.stack(vs)}],
             "cross": {"k": torch.stack(cks), "v": torch.stack(cvs)}}
    x = params.final_norm(x)
    return L.lm_logits(params.embed, x[:, -1], dist), cache


def _dec_layer_step(cfg, p: DecBlock, x, self_k, self_v, cross_k, cross_v,
                    pos: int, dist=None):
    """One decode step of a whisper decoder layer: self-attention over
    its cache (written at pos in place; over a sequence-split cache
    `decode_attention_seqsharded`), cross-attention over the encoder's
    keys and values, the MLP."""
    if kv_layout(cfg, dist) == "seq":
        h, _, _ = A.decode_attention_seqsharded(cfg, p.attn, p.ln1(x),
                                                self_k, self_v, pos, dist)
    else:
        h, _, _ = A.decode_attention(cfg, p.attn, p.ln1(x), self_k, self_v,
                                     pos, dist=dist)
    x = x + h
    h, _, _ = A.decode_attention(cfg, p.xattn, p.lnx(x), cross_k, cross_v,
                                 pos, cross=True, dist=dist)
    x = x + h
    return x + p.mlp(p.ln2(x), dist)


def _apply_recurrent(cfg, kind: str, p, x, state=None, dist=None, **scan):
    """One "M", "X" or "S" block on x from `state`: (x, new state).
    `scan` (chunk, exact_chunk) goes to the chunked scans; with `dist`
    the block's layout on the mesh (`models.ssm`)."""
    xin = p.ln1(x)
    if kind == "M":
        h, st = SS.apply_mamba2(cfg, p.mamba, xin, state=state, dist=dist,
                                **scan)
    elif kind == "X":
        h, st = SS.apply_mlstm(cfg, p.mlstm, xin, state=state, dist=dist,
                               **scan)
    else:
        h, st = SS.apply_slstm(cfg, p.slstm, xin, state=state, dist=dist,
                               **scan)
    return x + h, st


def _apply_block_full(cfg, kind: str, p, x, *, window: int = 0, dist=None):
    """Full-sequence block (prefill). Returns (x, cache entry), with
    `dist` in the cache's placement (`_cache_kv`)."""
    if kind == "A":
        h, kv = A.attention(cfg, p.attn, p.ln1(x), window=window, dist=dist)
        x = x + h
        x = x + p.mlp(p.ln2(x), dist)
        k, v = _cache_kv(cfg, *kv, dist)
        return x, {"k": k, "v": v}
    return _apply_recurrent(cfg, kind, p, x, dist=dist)


@torch.no_grad()
def prefill(cfg, params, batch, cap_scales=None, *, dist=None,
            dtype=torch.float32):
    """Process the whole prompt (`batch["tokens"]` (B, S) int); return
    (last-token logits (B, V), cache). Dense, vlm and moe: per segment
    {"k", "v"} of (L, B, S, Hkv, dh), the prompt run as one
    `prefill_extend` call from position 0 (its token-wise parts per block
    of TOKEN_BLOCK tokens); a vlm batch with `"patches"` (B, P, d) puts
    them before the tokens' embeddings, as the reference does, so the
    cache holds P + S positions (RoPE 0..P+S-1) and decode continues at
    position P + S. Encdec: `batch["frames"]` (B, S_enc, d) through the
    encoder, the cache {"self": [{"k", "v"} (L, B, S, Hkv, dh)], "cross":
    {"k", "v"} (L, B, S_enc, Hkv, dh)}. Hybrid and ssm: per layer {"k",
    "v"} (B,S,Hkv,dh) at "A" positions, {"conv", "ssm"} at "M", the
    (B,H,dh+1,dh) mLSTM state at "X" and {"h", "c"} at "S".

    `cap_scales` ((n_moe_layers, E), the reference's argument) is not
    used: MoE layers serve dropless, as in the reference. With `dist`
    (`launch.mesh.DistContext`) the batch is this rank's rows and the MoE
    layers run expert-parallel over the mesh; a model cut by
    `shard_model` runs its whole layout and writes the cache in its
    placement (`cache_pspecs`: this rank's KV heads, or its 1/tp of the
    positions, which then must divide; this rank's channels and heads of
    the recurrent states; whisper's cross part whole), the logits whole."""
    _check_family(cfg)
    tokens = batch["tokens"]
    if cfg.family == "encdec":
        return _prefill_encdec(cfg, params, batch, dtype, dist)
    if cfg.family in STACKED:
        x, _ = _embed_inputs(cfg, params, batch, dtype, dist)
        cache = empty_extend_cache(cfg, x.shape[0], x.shape[1], dtype,
                                   device=x.device, dist=dist)
        return _stacked_extend(cfg, params, x, cache, 0, dist)
    x = L.embed_tokens(params.embed, tokens, dist).to(dtype)
    cache = []
    for i, kind in enumerate(cfg.block_pattern):
        window = cfg.attn_window if kind == "A" else 0
        p = params.block(i)
        with L.gathered(dist, p):
            x, st = _apply_block_full(cfg, kind, p, x, window=window,
                                      dist=dist)
        cache.append(st)
    x = params.final_norm(x)
    return L.lm_logits(params.embed, x[:, -1], dist), cache


@torch.no_grad()
def decode_step(cfg, params, tokens, cache, pos: int, cap_scales=None, *,
                dist=None, dtype=torch.float32):
    """One decode step. tokens (B, 1) int; pos: the current write position,
    the same across the batch. Returns (logits (B, V), new cache); the
    attention caches are written in place. MoE layers dispatch dropless,
    as in prefill (`cap_scales` is not used), so decode at S continues a
    prefill of S tokens as a fresh prefill of S + 1 would. `dist` as in
    `prefill`: the cache is this rank's (`cache_pspecs`); over a cache
    split by sequence, attention is `attention.decode_attention_seqsharded`
    (a ring by slot for Zamba2's windowed block).
    """
    _check_family(cfg)
    x = _embed(params, tokens, pos, dtype, dist)
    if cfg.family == "encdec":
        self_kv, cross = cache["self"][0], cache["cross"]
        for j, p in enumerate(params.layers):
            with L.gathered(dist, p):
                x = _dec_layer_step(cfg, p, x, self_kv["k"][j],
                                    self_kv["v"][j], cross["k"][j],
                                    cross["v"][j], pos, dist)
        return L.lm_logits(params.embed, params.final_norm(x[:, -1]),
                           dist), cache
    if cfg.family in STACKED:
        seq = kv_layout(cfg, dist) == "seq"
        for p, (s, j) in zip(params.layers, _layer_slots(cfg)):
            ck, cv = cache[s]["k"][j], cache[s]["v"][j]
            if seq:
                h, _, _ = A.decode_attention_seqsharded(
                    cfg, p.attn, p.ln1(x), ck, cv, pos, dist)
            else:
                h, _, _ = A.decode_attention(cfg, p.attn, p.ln1(x), ck, cv,
                                             pos, dist=dist)
            x = x + h
            x = x + _ffn(cfg, p, p.ln2(x), dist)
        return L.lm_logits(params.embed, params.final_norm(x[:, -1]),
                           dist), cache
    new_cache = []
    for i, kind in enumerate(cfg.block_pattern):
        p, st = params.block(i), cache[i]
        with L.gathered(dist, p):
            if kind == "A":
                x, ns = _shared_attn_step(cfg, p, x, st, pos, dist)
            else:
                x, ns = _apply_recurrent(cfg, kind, p, x, state=st,
                                         dist=dist)
        new_cache.append(ns)
    x = params.final_norm(x)
    return L.lm_logits(params.embed, x[:, -1], dist), new_cache


def _shared_attn_step(cfg, p: AttnBlock, x, st, pos: int, dist=None):
    """One decode step of a hybrid's "A" block at position `pos` over its
    windowed ring cache st {"k", "v"} (written in place; over a cache
    split by sequence `decode_attention_seqsharded`), then the MLP: (x,
    the cache entry)."""
    if kv_layout(cfg, dist) == "seq":
        h, ck, cv = A.decode_attention_seqsharded(
            cfg, p.attn, p.ln1(x), st["k"], st["v"], pos, dist,
            window=cfg.attn_window)
    else:
        h, ck, cv = A.decode_attention(cfg, p.attn, p.ln1(x), st["k"],
                                       st["v"], pos, window=cfg.attn_window,
                                       dist=dist)
    x = x + h
    return x + p.mlp(p.ln2(x), dist), {"k": ck, "v": cv}


def _state_spec(cfg, kind: str, batch: int, dtype=torch.float32):
    """(shape, dtype) tree of one recurrent block's state; `dtype` is the
    Mamba2 conv state's."""
    if kind == "M":
        return SS.mamba2_state_spec(cfg, batch, dtype)
    if kind == "X":
        return SS.mlstm_state_spec(cfg, batch)
    return SS.slstm_state_spec(cfg, batch)


def cache_specs(cfg, batch: int, cache_len: int, dtype=torch.float32):
    """(shape, dtype) tree matching decode_step's cache argument."""
    _check_family(cfg)
    hkv, dh = cfg.n_kv_heads, cfg.dh
    if cfg.family == "encdec":
        n = cfg.n_layers
        return {"self": [{name: ((n, batch, cache_len, hkv, dh), dtype)
                          for name in ("k", "v")}],
                "cross": {name: ((n, batch, cfg.encoder_seq, hkv, dh),
                                 dtype) for name in ("k", "v")}}
    if cfg.family in STACKED:
        return [{name: ((cnt, batch, cache_len, hkv, dh), dtype)
                 for name in ("k", "v")} for _, cnt in segments_of(cfg)]
    specs = []
    for kind in cfg.block_pattern:
        if kind == "A":
            w = min(cache_len, cfg.attn_window) if cfg.attn_window \
                else cache_len
            specs.append({"k": ((batch, w, hkv, dh), dtype),
                          "v": ((batch, w, hkv, dh), dtype)})
        else:
            specs.append(_state_spec(cfg, kind, batch))
    return specs


# ----------------------------------------------------------------------------
# Incremental chunked prefill
# ----------------------------------------------------------------------------

def extend_cache_specs_ok(cfg) -> bool:
    """True when `prefill_extend` runs this config: the dense, vlm and moe
    families, whose stacked (L, B, S, Hkv, dh) K/V caches grow chunk by
    chunk (a vlm's text tokens only: patches enter through `prefill`), and
    the ssm family, whose O(1) block states (Mamba2 conv + ssm, the mLSTM
    matrix, sLSTM h/c) thread from chunk to chunk. An "A" block in the
    pattern would need a windowed KV extension: the hybrid family stays on
    the prefix rerun, as in the reference; an encoder-decoder's cache does
    not extend either (the reference's does not)."""
    if cfg.family in STACKED:
        return True
    return cfg.family == "ssm" and \
        all(k in ("M", "X", "S") for k in cfg.block_pattern)


def _zeros(spec, device):
    if isinstance(spec, dict):
        return {name: _zeros(s, device) for name, s in spec.items()}
    shape, dtype = spec
    return torch.zeros(shape, dtype=dtype, device=device)


def local_cache_specs(cfg, batch: int, cache_len: int, dtype, dist):
    """`cache_specs` as this rank holds it (`batch` its rows): every
    dimension that `cache_pspecs` puts on "model" cut to 1/tp (KV heads,
    or positions; Mamba2's conv channels and SSM heads, the mLSTM's and
    sLSTM's heads). ValueError where tp does not divide a cut one."""
    return _local_specs(cfg, cache_specs(cfg, batch, cache_len, dtype),
                        batch, dist)


def _local_specs(cfg, specs, batch: int, dist):
    if dist is None or dist.tp == 1:
        return specs
    axes = cache_pspecs(cfg, batch, {"data": 1, "model": dist.tp})
    return _cut_model(specs, axes, dist.tp)


def _cut_model(spec, axes, tp: int):
    if isinstance(spec, dict):
        return {k: _cut_model(spec[k], axes[k], tp) for k in spec}
    if isinstance(spec, list):
        return [_cut_model(s, a, tp) for s, a in zip(spec, axes)]
    shape, dt = spec
    for n, a in zip(shape, axes):
        if a == "model" and n % tp:
            raise ValueError(f"a cache dimension of {n} does not split "
                             f"over {tp} model ranks")
    return (tuple(n // tp if a == "model" else n
                  for n, a in zip(shape, axes)), dt)


def empty_extend_cache(cfg, batch: int, seq: int, dtype=torch.float32, *,
                       device=None, dist=None):
    """The cache an incremental prefill of `seq` tokens starts from, zeros.
    Dense, vlm and moe: per segment {"k", "v"} of (L, batch, seq, Hkv,
    dh), sized to the PROMPT (not max_seq), as the reference sizes it, so
    that every chunk's attention runs over the same keys as a one-shot
    prefill's, the positions not written yet masked. Ssm: the block
    states a scan from scratch starts from, so the first chunk replays a
    one-shot prefill's opening steps. With `dist`, this rank's part
    (`local_cache_specs`)."""
    if not extend_cache_specs_ok(cfg):
        raise NotImplementedError(
            f"empty_extend_cache runs the dense, vlm, moe and ssm families, "
            f"not {cfg.family!r}: a hybrid's or an encoder-decoder's "
            f"attention cache does not extend")
    dev = resolve_device(device)
    specs = cache_specs(cfg, batch, seq, dtype) if cfg.family in STACKED \
        else [_state_spec(cfg, kind, batch, dtype)
              for kind in cfg.block_pattern]
    return [_zeros(spec, dev)
            for spec in _local_specs(cfg, specs, batch, dist)]


@torch.no_grad()
def prefill_extend(cfg, params, tokens, cache, done: int, cap_scales=None,
                   *, dist=None, dtype=torch.float32, ssm_chunk: int = None):
    """Incremental chunked prefill: run ONLY the new chunk `tokens`
    (B, C), which starts at absolute position `done`, from the cache
    (`empty_extend_cache` for the first chunk). Returns (last-token
    logits, new cache).

    Dense, vlm and moe families: each layer writes the chunk's keys and
    values into the cache at [done, done + C) IN PLACE (the returned cache
    is the same tensors; the reference returns updated copies) and attends
    over it from q_offset = done in one flash call, the positions after
    the chunk masked. Its token-wise parts (norms, q/k/v products with bias
    and RoPE, the output product, the MLP; a MoE layer's router and
    shared experts) run per block of TOKEN_BLOCK tokens
    (`layers.by_blocks`): a row of a product changes bits with the call's
    row count, on the card and the CPU. A MoE layer's routed experts run
    once over the chunk's tokens, dropless (`cap_scales` is not used),
    and each token's expert rows do not depend on the other tokens
    (`models.moe`). With every chunk boundary a multiple of
    min(TOKEN_BLOCK, prompt length) — the serving engine keeps it — each
    block replays the one-shot prefill's block, the flash kernel's rows do
    not depend on the call, and the last logits and the whole cache are a
    one-shot `prefill`'s bits. The reference chunks at any boundary; this
    quantum is the port's.

    ssm family: every scan runs with scan-block length exactly
    Q = `ssm_chunk` (default cfg.ssm_chunk). With Q the one-shot prefill's
    min(cfg.ssm_chunk, prompt length) and every chunk boundary a multiple
    of it — the serving engine keeps both — each call replays exactly the
    scan steps of the one-shot prefill, and the "X" and "S" blocks run
    their token-wise products per block of Q tokens (`layers.by_blocks`),
    so the last logits and the final states are its bits. ("M" blocks run
    theirs per call, as Zamba2's prefill does: no ssm config of the repo
    has them.) `dist` as in `prefill`."""
    if not extend_cache_specs_ok(cfg):
        raise NotImplementedError(
            f"prefill_extend runs the dense, vlm, moe and ssm families, not "
            f"{cfg.family!r}: a hybrid's or an encoder-decoder's attention "
            f"cache does not extend")
    if cfg.family in STACKED:
        return _stacked_extend(cfg, params,
                               L.embed_tokens(params.embed, tokens,
                                              dist).to(dtype),
                               cache, int(done), dist)
    Q = int(ssm_chunk or cfg.ssm_chunk)
    x = L.embed_tokens(params.embed, tokens, dist).to(dtype)
    new_cache = []
    for i, kind in enumerate(cfg.block_pattern):
        with L.gathered(dist, params.blocks[i]):
            x, ns = _apply_recurrent(cfg, kind, params.blocks[i], x,
                                     state=cache[i], dist=dist, chunk=Q,
                                     exact_chunk=True)
        new_cache.append(ns)
    x = params.final_norm(x)
    return L.lm_logits(params.embed, x[:, -1], dist), new_cache


def _stacked_extend(cfg, params: StackedLM, x, cache, done: int,
                    dist=None):
    """The dense, vlm and moe branch of `prefill_extend` (and `prefill`,
    from 0) on the chunk's embeddings x (B, C, d) at positions done..
    With `dist`, this rank's heads and cache (`local_cache_specs`); over
    a cache split by sequence only a whole prompt from position 0 runs
    (the rank computes every position's keys, attends over them and
    keeps its slice): a later chunk raises NotImplementedError."""
    B, C = x.shape[:2]
    pos = torch.arange(done, done + C, device=x.device)[None]
    seq = kv_layout(cfg, dist) == "seq"
    for p, (s, j) in zip(params.layers, _layer_slots(cfg)):
        with L.gathered(dist, p):
            x = _extend_layer(cfg, p, x, cache[s]["k"][j], cache[s]["v"][j],
                              pos, done, seq, dist)
    logits = L.lm_logits(params.embed, params.final_norm(x[:, -1]), dist)
    return logits, cache


def _extend_layer(cfg, p: AttnBlock, x, ck, cv, pos, done: int, seq: bool,
                  dist):
    """One layer of `_stacked_extend`: writes its keys and values into the
    layer's cache ck, cv and returns x."""
    B, C = x.shape[:2]
    q, k, v = L.by_blocks(
        lambda xb, pb: A.qkv_at(cfg, p.attn, p.ln1(xb), pb[0], dist),
        TOKEN_BLOCK, x, pos)
    if seq:
        n = ck.shape[1]
        if done or C != n * dist.tp:
            raise NotImplementedError(
                "a cache split by sequence is written by one prefill "
                "of the whole prompt from position 0")
        r = dist.index(dist.tp_axis)
        ck.copy_(k[:, r * n:(r + 1) * n].to(ck.dtype))
        cv.copy_(v[:, r * n:(r + 1) * n].to(cv.dtype))
        ks, vs = A.kv_for(cfg, q, k, v, dist)
        o = flash_attention(q, ks, vs, causal=True)
    else:
        ck[:, done:done + C] = k.to(ck.dtype)
        cv[:, done:done + C] = v.to(cv.dtype)
        # the chunk's queries against the cache, which holds every
        # position up to the chunk's last (the later ones masked)
        ks, vs = A.kv_for(cfg, q, ck, cv, dist)
        o = flash_attention(q, ks, vs, causal=True, q_offset=done)
    o = o.reshape(B, C, -1)
    if hasattr(p, "moe"):
        x, h = L.by_blocks(lambda xb, ob: _attn_out(p, xb, ob, dist),
                           TOKEN_BLOCK, x, o)
        x = x + _ffn(cfg, p, h, dist)
    else:
        x = L.by_blocks(lambda xb, ob: _dense_out(p, xb, ob, dist),
                        TOKEN_BLOCK, x, o)
    return x


def _attn_out(p: AttnBlock, x, o, dist=None):
    """The attention output product and residual, then the FFN's input:
    (x + o . wo, ln2 of it)."""
    x = x + A.out_proj(p.attn, o, dist)
    return x, p.ln2(x)


def _dense_out(p: AttnBlock, x, o, dist=None):
    """The token-wise rest of a layer with an MLP: output product,
    residual, MLP, residual."""
    x, h = _attn_out(p, x, o, dist)
    return x + p.mlp(h, dist)


def _ffn(cfg, p: AttnBlock, h, dist=None):
    """A layer's FFN on its normed input h (B, S, D): the MLP, or the MoE
    dispatched dropless (serving), expert-parallel with `dist`."""
    if hasattr(p, "moe"):
        return MOE.apply_moe(cfg, p.moe, h, dist=dist, dropless=True)[0]
    return p.mlp(h, dist)


# ----------------------------------------------------------------------------
# Training loss
# ----------------------------------------------------------------------------

def _ce(logits, lab, group, dist):
    """(log-sum-exp of each row's logits, its label's logit), float32: the
    row max detached, (logits - max) in the logits' type then float32
    (the reference's CE, `repro/models/model.py:382-388`). With the
    vocabulary split over `group` (logits (..., V/tp)): the max is
    all-reduced, the sums of exponentials and the label's logit (zero on
    the ranks that do not hold it) summed by `from_model`; nothing of
    size tokens x vocabulary is gathered."""
    m = torch.amax(logits, dim=-1, keepdim=True).detach()
    if group is not None:
        m = C.all_reduce(m, group, op=tdist.ReduceOp.MAX)
    shifted = (logits - m).float()
    sums = torch.sum(torch.exp(shifted), dim=-1)
    if group is None:
        true = torch.gather(logits, -1, lab[..., None])[..., 0].float()
        return torch.log(sums) + m[..., 0].float(), true
    ids, keep = L.vocab_ids(lab, logits.shape[-1], dist)
    true = torch.where(keep, torch.gather(logits, -1, ids[..., None])[..., 0],
                       logits.new_zeros(())).float()
    return (torch.log(C.from_model(sums, group)) + m[..., 0].float(),
            C.from_model(true, group))


# the MoE aux values that `loss_fn` sums over the MoE layers
AUX_SUMS = ("aux_loss", "dropped", "stolen", "entries")


# remat_policy names (the reference's REMAT_POLICIES): "nothing" recomputes
# a layer's whole forward in the backward; "dots" keeps the outputs of its
# products without batch dimensions (the projections) and recomputes the
# rest, attention's batched products (the flash Function) included
REMAT_POLICIES = ("nothing", "dots")
_SAVED_BY_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    """Selective checkpointing's choice for "dots": save the 2-D products'
    outputs (every projection reaches aten.mm / addmm), recompute the
    rest."""
    from torch.utils.checkpoint import CheckpointPolicy
    return CheckpointPolicy.MUST_SAVE if op in _SAVED_BY_DOTS else \
        CheckpointPolicy.PREFER_RECOMPUTE


def _remat_context(cfg) -> dict:
    """`torch.utils.checkpoint`'s keyword arguments for a layer of cfg:
    selective checkpointing under "dots", nothing (the whole layer rerun)
    under "nothing" and for encdec under either name: the reference
    checkpoints whisper's encoder and decoder layers with no policy
    (`repro/models/model.py:345, 418`; ROADMAP.md queue 3 caveat 12)."""
    if cfg.remat_policy != "dots" or cfg.family == "encdec":
        return {}
    return {"context_fn": functools.partial(
        torch.utils.checkpoint.create_selective_checkpoint_contexts,
        _dots_policy)}


def check_trainable(cfg, dist=None) -> None:
    """Raise NotImplementedError unless the port trains this config: the
    port trains every config it runs (`_check_family`; moe with its
    capacity and steal dispatch and the expert FFN's backward kernel).
    Raise ValueError for a `remat_policy` outside `REMAT_POLICIES` (the
    reference falls back to "nothing" without a word), and for a mesh
    `dist` that the config's experts cannot split over
    (`models.moe.check_mesh`) or that a placement cannot split over
    (`check_mesh`)."""
    _check_family(cfg)
    MOE.check_mesh(cfg, dist)
    check_mesh(cfg, dist)
    if cfg.remat_policy not in REMAT_POLICIES:
        raise ValueError(f"remat_policy {cfg.remat_policy!r} not in "
                         f"{REMAT_POLICIES}")


def _train_layer(cfg, p: AttnBlock, x, causal: bool = True,
                 window: int = 0, dist=None):
    """An attention layer over the whole sequence (the reference's
    `_apply_block_full` for "dense", "enc" and "A"): attention through
    the flash kernel (its autograd Function when x requires grad), causal
    or not (whisper's encoder), with a sliding `window` (Zamba2's shared
    block), then the MLP; no `by_blocks` (the reference runs whole
    products; the serving quantum is not a training concern);
    tensor-parallel with `dist` where the module is placed."""
    h, _ = A.attention(cfg, p.attn, p.ln1(x), causal=causal, window=window,
                       dist=dist)
    x = x + h
    return x + p.mlp(p.ln2(x), dist)


def _train_moe_layer(cfg, p: AttnBlock, x, cap_scale, dist=None):
    """A "moe" layer over the whole sequence (the reference's
    `_apply_block_full` for "moe"): causal attention through the flash
    kernel, then the routed experts at capacity with the steal round
    (`MOE.apply_moe`, dropless=False) under the layer's `cap_scale` (E,),
    and the shared experts; expert-parallel with `dist`. Returns (x, the
    layer's aux dict)."""
    h, _ = A.attention(cfg, p.attn, p.ln1(x), causal=True, dist=dist)
    x = x + h
    h, aux = MOE.apply_moe(cfg, p.moe, p.ln2(x), cap_scale, dist=dist,
                           dropless=False)
    return x + h, aux


def _train_moe_stack(cfg, params: StackedLM, x, cap_scales, remat: bool,
                     dist=None):
    """A moe stack's layers over the whole sequence: "densffn" layers by
    `_train_layer`, "moe" layers by `_train_moe_layer` with their row of
    `cap_scales` (n_moe_layers, E) (ones when None), each under
    `_run_layer`. Returns (x, the aux values of `AUX_SUMS` summed over
    the MoE layers in layer order from float32 zeros, the router counts
    stacked (n_moe_layers, E)), as the reference's `_run_segments`; with
    `dist` each MoE layer's aux values are replicated over the mesh."""
    if cap_scales is None:
        cap_scales = torch.ones((n_moe_layers(cfg), cfg.n_experts),
                                dtype=torch.float32, device=x.device)
    sums = {k: torch.zeros((), dtype=torch.float32, device=x.device)
            for k in AUX_SUMS}
    counts = []
    for p in params.layers:
        if not hasattr(p, "moe"):
            x = _run_layer(cfg, _train_layer, p, x, remat=remat, dist=dist)
            continue
        x, aux = _run_layer(cfg, _train_moe_layer, p, x,
                            cap_scales[len(counts)], dist, remat=remat)
        sums = {k: sums[k] + aux[k] for k in AUX_SUMS}
        counts.append(aux["counts"])
    return x, sums, torch.stack(counts)


def _train_block(cfg, p, x, kind: str, dist=None):
    """Block `kind` of a hybrid or ssm pattern over the whole sequence
    from a zero state (the reference's `_apply_block_full`): "A" is
    `_train_layer` with `cfg.attn_window`; "M", "X" and "S" are
    `_apply_recurrent` (the scans through the SSD scan's autograd
    Function, the sLSTM's loop by autograd); with `dist` each in its
    layout on the mesh. Returns x."""
    if kind == "A":
        return _train_layer(cfg, p, x, window=cfg.attn_window, dist=dist)
    return _apply_recurrent(cfg, kind, p, x, dist=dist)[0]


def loss_fn(cfg, params, batch, cap_scales=None, *, dist=None,
            dtype=torch.bfloat16, aux_weight: float = 0.01):
    """batch: tokens (B, S), labels (B, S) int (-1 = masked); vlm:
    optional patches (B, P, d); encdec: frames (B, S_enc, d). Returns
    (loss, metrics {"loss", "n_tokens"}), the reference's
    (`repro/models/model.py:252-318, 350-395`) for every family: the
    inputs embedded in `dtype`
    (`_embed_inputs`: a vlm's patches before its tokens, RoPE over
    positions 0..P+S-1; whisper's tokens plus their position rows); for
    encdec the encoder over the frames (`_encode`) and each decoder
    layer's self-attention, cross-attention and MLP (`_dec_layer`); for
    ssm and hybrid `cfg.block_pattern` over `params.block(i)`
    (`_train_block`: every "A" position runs the one shared block, whose
    gradient sums over them); for moe its layers with their aux values
    (`_train_moe_stack`); else every layer full-sequence; each layer
    or block under `torch.utils.checkpoint`,
    non-reentrant, when `cfg.remat`: the counterpart of the reference's
    jax.checkpoint with `cfg.remat_policy` (under "nothing" the backward
    reruns each layer's forward, flash included; under "dots" selective
    checkpointing keeps the projections' outputs and reruns the rest,
    flash included; encdec reruns whole layers under either name, as the
    reference's policy-free jax.checkpoint does). Then the final norm,
    the text positions only (`x[:, P:]` after a patch prefix), logits in
    `dtype`, and the reference's cross-entropy: the row max detached,
    (logits - max) in `dtype` then float32, the true logit gathered (the
    reference's one-hot sum gives the same value), the mean over labels
    >= 0. For moe (`_train_moe_stack`) each MoE layer dispatches at
    capacity under its row of `cap_scales` (n_moe_layers, E), and the
    loss adds `aux_weight` times the summed aux loss; the metrics add the
    sums of `AUX_SUMS` and "counts" (n_moe_layers, E), the router counts
    that `ich_update_cap_scale` reads, and "loss" stays the
    cross-entropy, as the reference's do. A config the port does not
    train raises NotImplementedError (`check_trainable`).

    With `dist` (`launch.mesh.DistContext`) the batch is this rank's rows
    (`train.train_step.batch_shard`) and the MoE layers run
    expert-parallel. The cross-entropy stays the reference's global mean:
    this rank's sum over its valid labels divided by the count of valid
    labels over the batch axes (one all-reduce) is this rank's share, and
    the returned loss has the global loss's value (the shares summed) and
    the share's gradient, which the train step sums over the batch ranks;
    the aux loss enters as its mean over them (`models.moe.
    replicate_aux`). The metrics are global: "n_tokens" the global count,
    the aux values replicated. A model cut by `shard_model` runs
    tensor-parallel over "model" (every family: `models.ssm` for the
    recurrent blocks, whisper's encoder and decoder through `attention`
    and `MLP`): every model rank computes the same loss, its weights'
    gradients complete through the collectives' backwards. With the vocabulary split the logits stay split
    (B, S, V/tp) and the cross-entropy is vocab-parallel (`_ce`)."""
    check_trainable(cfg, dist)
    x, n_prefix = _embed_inputs(cfg, params, batch, dtype, dist)
    if cfg.family == "encdec":
        enc_out = _encode(cfg, params, batch["frames"], dtype,
                          remat=cfg.remat, dist=dist)
        for p in params.layers:
            x = _run_layer(cfg, _dec_layer, p, x, enc_out, dist,
                           remat=cfg.remat)[0]
    elif cfg.family in ("hybrid", "ssm"):
        for i, kind in enumerate(cfg.block_pattern):
            x = _run_layer(cfg, _train_block, params.block(i), x, kind,
                           dist, remat=cfg.remat)
    elif cfg.family == "moe":
        x, aux, counts = _train_moe_stack(cfg, params, x, cap_scales,
                                          cfg.remat, dist)
    else:
        for p in params.layers:
            x = _run_layer(cfg, _train_layer, p, x, remat=cfg.remat,
                           dist=dist)
    x = params.final_norm(x)
    logits = L.lm_logits(params.embed, x[:, n_prefix:], dist, whole=False)
    labels = batch["labels"]
    valid = labels >= 0
    lab = torch.where(valid, labels, torch.zeros_like(labels)).long()
    lse, true_logit = _ce(logits, lab, L.head_group(params.embed, dist),
                          dist)
    n_tokens = valid.sum()
    if dist is not None:
        n_tokens = C.all_reduce(n_tokens, dist.group(dist.batch_axes))
    loss = torch.sum((lse - true_logit) * valid) / torch.clamp(n_tokens,
                                                              min=1)
    if dist is not None:    # the shares' sum as value, this share's gradient
        loss = loss + (C.all_reduce(loss.detach(),
                                    dist.group(dist.batch_axes))
                       - loss.detach())
    metrics = {"loss": loss, "n_tokens": n_tokens}
    if cfg.family == "moe":
        loss = loss + aux_weight * aux["aux_loss"]
        metrics.update(aux)
        metrics["counts"] = counts
    return loss, metrics
