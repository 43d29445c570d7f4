"""Gradient compression — the port's counterpart of
`repro.optim.grad_compress`: int8 block quantisation (blocks of 256, one
float32 scale a block) with error feedback: the residual is carried in
the train state and added back next step. Plain tensor code, as the
reference's is XLA, not a Pallas kernel. `torch.round` and `jnp.round`
both round half to even, so the int8 blocks, scales and residuals are
element-identical to the reference's. Gradient trees are dicts keyed by
parameter name, one tensor a layer; the reference compresses each of its
stacked leaves (L, ...) as ONE flat array, its blocks running across
layer boundaries, so `tree_compress` takes the groups of names that form
one reference leaf (`models.model.reference_leaves`) and compresses each
group's tensors concatenated in layer order."""
from __future__ import annotations

import torch

BLOCK = 256


def _pad_to_block(x: torch.Tensor):
    flat = x.reshape(-1)
    n = flat.numel()
    return torch.nn.functional.pad(flat, (0, (-n) % BLOCK)), n


def quantize(g: torch.Tensor):
    """g (any shape) -> (int8 blocks (n_blocks, 256), float32 scales
    (n_blocks, 1), element count)."""
    flat, n = _pad_to_block(g.float())
    blocks = flat.reshape(-1, BLOCK)
    scale = torch.amax(torch.abs(blocks), dim=1, keepdim=True) / 127.0
    q = torch.clamp(torch.round(blocks / torch.clamp(scale, min=1e-12)),
                    -127, 127)
    return q.to(torch.int8), scale, n


def dequantize(q, scale, n: int, shape) -> torch.Tensor:
    return (q.float() * scale).reshape(-1)[:n].reshape(shape)


def compress_with_feedback(g: torch.Tensor, err: torch.Tensor):
    """(g compressed, in g's type; the new residual, float32)."""
    target = g.float() + err
    q, s, n = quantize(target)
    deq = dequantize(q, s, n, g.shape)
    return deq.to(g.dtype), target - deq


def tree_compress(grads: dict, err_tree: dict, groups=()):
    """(compressed grads, new residuals), both keyed as `grads`. Each
    group of `groups` (lists of names) is compressed as one flat array,
    its tensors flattened and concatenated in list order, then split back
    (the reference's stacked leaf: `models.model.reference_leaves`); a
    name in no group is compressed alone."""
    grouped = {n for g in groups for n in g}
    out = {}
    for names in [*groups, *([n] for n in grads if n not in grouped)]:
        gs = [grads[n] for n in names]
        flat, res = compress_with_feedback(
            torch.cat([g.reshape(-1) for g in gs]),
            torch.cat([err_tree[n].reshape(-1) for n in names]))
        sizes = [g.numel() for g in gs]
        for n, g, d, r in zip(names, gs, flat.split(sizes),
                              res.split(sizes)):
            out[n] = (d.reshape(g.shape), r.reshape(g.shape))
    return ({n: out[n][0] for n in grads}, {n: out[n][1] for n in grads})


def init_error_state(params: dict) -> dict:
    return {n: torch.zeros_like(p, dtype=torch.float32)
            for n, p in params.items()}
