"""Training step — the port's counterpart of `repro.train.train_step`:
the loss's gradient (`models.model.loss_fn`, the backward kernels of
flash attention, the SSD scan and the MoE expert FFN on the card), an
AdamW update, the MoE capacity scales' update, optional
microbatch accumulation, int8 gradient compression with error feedback,
bfloat16 parameters with a float32 master copy, and a one-time cast of
the parameters.

The train state is a dict: "params" (the model,
`models.model.StackedLM`, `EncDecLM` or `HybridLM`, its parameters
requiring grad), "opt" ({"m", "v", "step"} keyed by parameter name, plus
"master" with `bf16_params`), "cap_scales" ((MoE
layers, E) float32, ones at first: the MoE capacity scales, the paper's
d_i) and, with `grad_compress`, "grad_err" (the residuals). `step`
updates the state's tensors IN PLACE and returns the same dict with the
metrics (the reference returns a new state; in place the step needs no
second copy of the parameters and moments). The port runs eagerly: there
is nothing to jit, and `train_state_pspecs` / `batch_pspec` come with
`launch/` (ROADMAP.md queue 1 item 6). It trains every family. For moe
the loss takes the state's "cap_scales", and after the update each MoE
layer's row becomes `ich_update_cap_scale` of that layer's router counts
(in place; under a microbatch split the last microbatch's counts, as the
reference takes `m[-1]` of its scanned metrics).
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Any

import torch

from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.models import moe as MOE
from repro_torch.optim import adamw
from repro_torch.optim import grad_compress as GC
from repro_torch.sched.defaults import ICH_EPS


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    opt: adamw.AdamWConfig = adamw.AdamWConfig()
    microbatch: int = 0          # 0 = no accumulation
    grad_compress: bool = False  # int8 + error feedback on grads
    ich_eps: float = ICH_EPS     # MoE balancer epsilon (unified default)
    dtype: Any = torch.bfloat16
    cast_params_once: bool = False  # cast the float32 parameters to `dtype`
    # once per step, before the loss (the loss then runs on the cast copy)
    bf16_params: bool = False    # store params bf16 + fp32 master in opt


def cast_bf16(model) -> None:
    """The model's float32 parameters as bfloat16, in place (the
    parameters stay the same objects): `bf16_params`' storage."""
    for p in model.parameters():
        if p.dtype == torch.float32:
            p.data = p.data.to(torch.bfloat16)


def init_train_state(cfg, seed: int = 0, max_seq: int = 0,
                     tcfg: TrainConfig = TrainConfig(), device=None) -> dict:
    """The train state of a fresh model from `seed` on `device` (None =
    the card; raises without CUDA): parameters requiring grad, zero
    moments at step 0, the master copy and bfloat16 parameters with
    `bf16_params`, zero residuals with `grad_compress`."""
    dev = resolve_device(device)
    model = M.init_params(cfg, seed, max_seq=max_seq, device=dev)
    model.requires_grad_(True)
    params = dict(model.named_parameters())
    opt = adamw.init_state(params)
    if tcfg.bf16_params:
        opt["master"] = {n: p.detach().clone() for n, p in params.items()}
        cast_bf16(model)
    state = {"params": model, "opt": opt,
             "cap_scales": torch.ones((M.n_moe_layers(cfg),
                                       max(cfg.n_experts, 1)),
                                      dtype=torch.float32, device=dev)}
    if tcfg.grad_compress:
        state["grad_err"] = GC.init_error_state(params)
    return state


def make_train_step(cfg, tcfg: TrainConfig = TrainConfig()):
    """Returns step(state, batch) -> (state, metrics {"loss", "n_tokens",
    "grad_norm", "lr"}, for moe also "aux_loss", "dropped", "stolen" and
    "entries"); batch: "tokens" and "labels" (B, S) tensors on
    the state's device, and the family's inputs as
    `repro/launch/specs.py:19-25` shapes them: "patches" (B, P, d) for a
    vlm (optional), "frames" (B, S_enc, d) for encdec. A microbatch split
    cuts every entry along its batch axis. Raises NotImplementedError for
    a config the port does not train (`models.model.check_trainable`)."""
    M.check_trainable(cfg)
    # cast_params_once: the loss runs on a copy of the model whose float32
    # parameters are cast to tcfg.dtype (leaves of their own), and their
    # gradients are cast back: the chain rule through the reference's
    # astype(dtype) of the parameter tree
    shadow = {}

    def loss_model(model):
        if not tcfg.cast_params_once or tcfg.dtype == torch.float32 or \
                all(p.dtype != torch.float32 for p in model.parameters()):
            return model
        if "model" not in shadow:
            shadow["model"] = copy.deepcopy(model)
            for p in shadow["model"].parameters():
                if p.dtype == torch.float32:
                    p.data = p.data.to(tcfg.dtype)
        with torch.no_grad():
            for c, p in zip(shadow["model"].parameters(),
                            model.parameters()):
                c.copy_(p)
        return shadow["model"]

    def grads_of(model, batch, cap_scales):
        run = loss_model(model)
        loss, metrics = M.loss_fn(cfg, run, batch, cap_scales,
                                  dtype=tcfg.dtype)
        names = [n for n, _ in model.named_parameters()]
        grads = torch.autograd.grad(loss, list(run.parameters()))
        grads = {n: g.to(p.dtype) for n, g, p in
                 zip(names, grads, model.parameters())}
        metrics = {k: v.detach() for k, v in metrics.items()}
        return loss.detach(), metrics, grads

    def step(state, batch):
        model = state["params"]
        if tcfg.microbatch > 1:
            mb = tcfg.microbatch
            b = batch["tokens"].shape[0]
            grads = {n: torch.zeros(p.shape, dtype=torch.float32,
                                    device=p.device)
                     for n, p in model.named_parameters()}
            loss_sum = torch.zeros((), dtype=torch.float32,
                                   device=batch["tokens"].device)
            for i in range(mb):
                micro = {k: v.reshape(mb, b // mb, *v.shape[1:])[i]
                         for k, v in batch.items()}
                loss, metrics, g = grads_of(model, micro,
                                            state["cap_scales"])
                grads = {n: grads[n] + g[n] for n in grads}
                loss_sum = loss_sum + loss
            grads = {n: g / mb for n, g in grads.items()}
            metrics["loss"] = loss_sum / mb
        else:
            _, metrics, grads = grads_of(model, batch, state["cap_scales"])

        if tcfg.grad_compress:
            grads, state["grad_err"] = GC.tree_compress(
                grads, state["grad_err"], M.reference_leaves(cfg, grads))
        params = dict(model.named_parameters())
        opt = state["opt"]
        if tcfg.bf16_params:
            master = opt["master"]
            _, new_opt, opt_metrics = adamw.apply_updates(
                master, grads, opt, tcfg.opt)
            new_opt["master"] = master
            with torch.no_grad():
                for n, p in params.items():
                    p.copy_(master[n].to(p.dtype))
        else:
            _, new_opt, opt_metrics = adamw.apply_updates(params, grads, opt,
                                                          tcfg.opt)
        state["opt"] = new_opt
        metrics.update(opt_metrics)
        if cfg.family == "moe":
            counts = metrics.pop("counts")          # (n_moe_layers, E)
            caps = state["cap_scales"]
            with torch.no_grad():
                for layer in range(caps.shape[0]):
                    caps[layer] = MOE.ich_update_cap_scale(
                        counts[layer], caps[layer], eps=tcfg.ich_eps)
        return state, metrics

    return step
