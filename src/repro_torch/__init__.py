"""`repro_torch` — the iCh loop scheduler in PyTorch, with hand-written
CUDA kernels for NVIDIA Hopper (sm_90a).

This package is the PyTorch/CUDA counterpart of `repro`. Its layout mirrors
`repro` (`core/`, `sched/`, `configs/`, `models/`, `serve/`,
`kernels/{ich_spmv,ich_bfs,ich_kmeans,ich_moe,flash_attention,mamba_scan}/`)
so each module's twin is easy to find, but it imports nothing of `repro`
and nothing of JAX: the numpy host code it needs is copied, not shared.

It runs the paper's three applications, each schedule -> sharded CUDA
kernel -> observe/refine, and MoE expert dispatch (plan -> sharded kernel
-> measured expert load -> next plan's capacities):

    from repro_torch import sched

    scheduler = sched.LoopScheduler(p=132)          # device defaults to "cuda"
    op = scheduler.build("spmv", indptr, indices, data)
    y = op(x)                                       # ich_spmv_sharded kernel
    op2 = sched.SpmvOp(op.observe().refine(), indptr, indices, data)
    level = scheduler.build("bfs", indptr, indices).levels(0)
    ids = scheduler.build("kmeans", point_costs)(points, centroids)
    moe = scheduler.build("moe-dispatch", sched.plan_dispatch(e_topk, w))
    y = moe(x, wi, wg, wo)                          # ich_moe_sharded kernel

and serves Zamba2-1.2B (its prefill runs the flash attention and SSD
scan kernels), xlstm-350m (the SSD scan from a state) and the dense
family (qwen2-1.5b, olmo-1b, glm4-9b, phi3-medium-14b: flash attention
from a query offset), request by request through the continuous batcher
of `repro_torch.serve` for the dense and ssm families:

    from repro_torch.configs import get_arch
    from repro_torch.models.model import init_params
    from repro_torch.serve import Engine, EngineConfig

    cfg = get_arch("zamba2-1.2b")
    engine = Engine(cfg, init_params(cfg, seed=0), EngineConfig(max_seq=4096))
    ids, stats = engine.generate(prompts, n_new=32)

It trains the dense family (`repro_torch.train`): the attention gradient
comes from a hand-written flash-attention backward kernel
(`kernels/flash_attention/flash_attention_bwd.py`), and the loop keeps
the reference's checkpoints, failure injection and resume:

    from repro_torch.train import train_step as TS
    from repro_torch.train.trainer import RunConfig, train

    state = TS.init_train_state(get_arch("qwen2-1.5b"), seed=0)
    step = TS.make_train_step(get_arch("qwen2-1.5b"), TS.TrainConfig())
    state, metrics = step(state, {"tokens": tokens, "labels": labels})
    state, losses = train(cfg, RunConfig(steps=50, ckpt_dir="ckpt"))

Entry points run on the card unless the caller passes `device="cpu"`, which
selects each kernel's plain PyTorch version (`repro_torch.device`).
"""
from .device import resolve_device

__all__ = ["resolve_device"]
