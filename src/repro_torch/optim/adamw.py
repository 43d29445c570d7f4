"""AdamW with float32 state, global-norm clipping and a linear-warmup
cosine schedule — the port's counterpart of `repro.optim.adamw`.

Parameters, gradients and the moments are dicts keyed by the port's
parameter names (`embed.tok`, `layers.3.attn.wq`, ...); the state is
{"m", "v", "step"}. The arithmetic is the reference's, in float32 tensors
(the schedule too, from the int32 step), one parameter at a time.

Weight decay applies to the parameters whose REFERENCE leaf has rank >= 2
(`repro/optim/adamw.py:68`). The reference stacks the layers of a dense,
vlm or moe model (and whisper's encoder) along a leading axis, so every
layer leaf is at least 2-D there and is decayed — a layer's norm scales
and its q/k/v biases too — while the port keeps one module a layer: the
rank is taken from `models.model.reference_ndim`, not from the port's
tensor. Only unstacked 1-D leaves (`final_norm`, a hybrid block's norms
and vectors) are not decayed.

`apply_updates` writes the new parameters and moments INTO the given
tensors (the reference returns new trees): at full width that saves a
copy of the parameters and both moments.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.models.model import reference_ndim


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at `step` (an int32 tensor), float32: linear
    warmup, then cosine decay to min_lr_frac * lr."""
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * t))
    return cfg.lr * warm * cos


def init_state(params: dict) -> dict:
    """{"m", "v"}: float32 zeros like each parameter; "step": int32 0."""
    dev = next(iter(params.values())).device
    return {"m": {n: torch.zeros_like(p, dtype=torch.float32)
                  for n, p in params.items()},
            "v": {n: torch.zeros_like(p, dtype=torch.float32)
                  for n, p in params.items()},
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def opt_pspecs(param_pspecs: dict) -> dict:
    """The optimizer state's placement: each moment as its parameter,
    the step replicated (`repro/optim/adamw.py:41-44`)."""
    return {"m": dict(param_pspecs), "v": dict(param_pspecs), "step": ()}


def global_norm(tree: dict) -> torch.Tensor:
    """sqrt of the sum over leaves of their float32 sums of squares."""
    total = 0
    for x in tree.values():
        total = total + torch.sum(torch.square(x.float()))
    return torch.sqrt(total)


def decays(name: str, p: torch.Tensor) -> bool:
    """Whether `name` takes weight decay: its reference leaf is a matrix."""
    return reference_ndim(name, p.ndim) >= 2


@torch.no_grad()
def apply_updates(params: dict, grads: dict, state: dict, cfg: AdamWConfig,
                  gnorm: torch.Tensor = None):
    """One AdamW step. Writes the new parameters into `params`' tensors and
    the new moments into state["m"] and state["v"]; returns (params, new
    state, {"grad_norm", "lr"}). `gnorm` is the clipping norm when the
    caller has it (on a mesh: the whole tree's, of which `grads` holds
    this rank's shards), else `global_norm(grads)`."""
    step = state["step"] + 1
    if gnorm is None:
        gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    lr = schedule(cfg, step)
    stepf = step.float()
    b1c = 1 - torch.pow(torch.full_like(stepf, cfg.b1), stepf)
    b2c = 1 - torch.pow(torch.full_like(stepf, cfg.b2), stepf)
    for name, p in params.items():
        m, v = state["m"][name], state["v"][name]
        g = grads[name].float() * scale
        m.copy_(cfg.b1 * m + (1 - cfg.b1) * g)
        v.copy_(cfg.b2 * v + (1 - cfg.b2) * g * g)
        update = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
        if decays(name, p):
            update = update + cfg.weight_decay * p.float()
        p.copy_((p.float() - lr * update).to(p.dtype))
    return params, {"m": state["m"], "v": state["v"], "step": step}, {
        "grad_norm": gnorm, "lr": lr}
