"""`repro_torch` — the iCh loop scheduler in PyTorch, with hand-written
CUDA kernels for NVIDIA Hopper (sm_90a).

This package is the PyTorch/CUDA counterpart of `repro`. Its layout mirrors
`repro` (`core/`, `sched/`, `kernels/ich_{spmv,bfs,kmeans,moe}/`) so each
module's twin is easy to find, but it imports nothing of `repro` and
nothing of JAX: the numpy host code it needs is copied, not shared.

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

Entry points run on the card unless the caller passes `device="cpu"`, which
selects each kernel's plain PyTorch version (`repro_torch.device`).
"""
from .device import resolve_device

__all__ = ["resolve_device"]
