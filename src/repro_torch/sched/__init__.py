"""`repro_torch.sched` — the port's public entry point for loop scheduling.

    from repro_torch import sched

    scheduler = sched.LoopScheduler(p=132)        # device defaults to "cuda"
    s = scheduler.schedule(costs)                 # -> Schedule (cached, LRU)
    spmv = scheduler.build("spmv", indptr, indices, data)
    y = spmv(x)                                   # sharded CUDA kernel
    s2 = spmv.observe().refine()                  # measured cost -> new gen
    bfs = scheduler.build("bfs", indptr, indices)
    level = bfs.levels(0)                         # (n,) int32, -1 unreached
    km = scheduler.build("kmeans", point_costs)
    ids = km(points, centroids)                   # (n,) int32 argmin
    plan = sched.plan_dispatch(e_topk, weights)   # MoE routing, host side
    moe = scheduler.build("moe-dispatch", plan)
    y = moe(x, wi, wg, wo)                        # (n_tokens, D) expert FFN
    s2, cap_scale = sched.refine_cap_scale(moe.schedule, moe.expert_load())
    res = s.replay_sharded()                      # simulator twin of shard()
    stats = s.parallel_for_units(body, record_chunks=True)  # host threads
    s3 = s.observe(stats).refine()                # executor's wall clock

Pass ``device="cpu"`` to `LoopScheduler` to run the kernels' plain
PyTorch versions instead.

Exports are lazy (PEP 562): `repro_torch.core` imports
`repro_torch.sched.defaults`, so this init must not import core back
while it is itself being imported.
"""
from .defaults import (ICH_EPS, MAX_WIDTH, MIN_WIDTH, ROWS_PER_TILE,
                       SUPERSTEP)

_LAZY = {
    "LoopScheduler": "api",
    "Schedule": "api",
    "default_scheduler": "api",
    "CostRefiner": "adaptive",
    "BfsOp": "kernels",
    "CostProvider": "costs",
    "DegreeCosts": "costs",
    "ExpertLoadCosts": "costs",
    "ExplicitCosts": "costs",
    "KMeansOp": "kernels",
    "MoeDispatchOp": "kernels",
    "NnzCosts": "costs",
    "RefinedCosts": "costs",
    "RemainingTokensCosts": "costs",
    "as_cost_provider": "costs",
    "CacheStats": "cache",
    "ScheduleCache": "cache",
    "SpmvOp": "kernels",
    "DispatchPlan": "moe",
    "cap_scale_from_costs": "moe",
    "expert_capacity": "moe",
    "plan_dispatch": "moe",
    "refine_cap_scale": "moe",
    "WorkloadSpec": "registry",
    "get": "registry",
    "register": "registry",
    "registered": "registry",
}

__all__ = ["ICH_EPS", "MAX_WIDTH", "MIN_WIDTH", "ROWS_PER_TILE", "SUPERSTEP",
           *sorted(_LAZY)]


def __getattr__(name):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib
    return getattr(importlib.import_module(f".{mod}", __name__), name)


def __dir__():
    return sorted(__all__)
