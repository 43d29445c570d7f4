"""Gradient compression — the port's counterpart of
`repro.optim.grad_compress`: int8 block quantisation (blocks of 256, one
float32 scale a block) with error feedback: the residual is carried in
the train state and added back next step. Plain tensor code, as the
reference's is XLA, not a Pallas kernel. `torch.round` and `jnp.round`
both round half to even, so the int8 blocks, scales and residuals are
element-identical to the reference's. Gradient trees are dicts keyed by
parameter name."""
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


def tree_compress(grads: dict, err_tree: dict):
    out = {name: compress_with_feedback(g, err_tree[name])
           for name, g in grads.items()}
    return ({n: o[0] for n, o in out.items()},
            {n: o[1] for n, o in out.items()})


def init_error_state(params: dict) -> dict:
    return {n: torch.zeros_like(p, dtype=torch.float32)
            for n, p in params.items()}
