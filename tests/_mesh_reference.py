"""The JAX reference's meshed train step, run in a process of its own:

    XLA_FLAGS=--xla_force_host_platform_device_count=4 \
        python tests/_mesh_reference.py IN.pkl OUT.pkl

(the flag must be set before JAX is imported, so this cannot run inside
a test process). IN.pkl holds {"arch", "over", "state" (the reference's
train state with numpy leaves), "batches", "jobs": [(shape, options,
with_grads)], optionally "max_seq" (the state's position table, 64 by
default)}, or {"cases": [such dicts]} to run several in one process (OUT
then holds a list of results a case); for each job the script builds `jax.make_mesh(shape,
("data", "model"))` with Auto axes, `DistContext(mesh, batch_axes=
batch_axes_of(mesh))` and `make_train_step(cfg, tcfg, dist)`, and writes
the gradients of the first batch's loss (`jax.value_and_grad` of
`loss_fn` with the same `dist`, when asked) and, after each batch's
step, the metrics, the parameters and the capacity scales. With
"in_sharded" among a job's options the step is jitted as the
reference's dry run builds it (`repro/launch/dryrun.py:52-63`, without
importing that module, which sets XLA_FLAGS): in_shardings from
`train_state_pspecs` and `batch_pspec`, so GSPMD lays out the tensor
parallelism of the dense layers, and the gradients are taken with the
parameters in that layout. Axes are Auto
because `jax.make_mesh`'s default (Explicit, since jax 0.7) is refused by
the reference's `_constrain` (ROADMAP.md queue 3 caveat 14)."""
import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from repro.configs import get_arch, reduced
from repro.launch.mesh import batch_axes_of
from repro.models import model as M
from repro.models.moe import DistContext
from repro.train import train_step as TS


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _shardings(mesh, tree):
    return jax.tree.map(lambda s: NamedSharding(mesh, s), tree,
                        is_leaf=lambda x: isinstance(x, P))


def run_job(cfg, state, batches, shape, options, with_grads,
            max_seq=64):
    mesh = jax.make_mesh(shape, ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2,
                         devices=jax.devices()[:int(np.prod(shape))])
    dist = DistContext(mesh, batch_axes=batch_axes_of(mesh))
    options = dict(options)
    in_sharded = options.pop("in_sharded", False)
    tcfg = TS.TrainConfig(dtype=jnp.float32, **options)
    shard = {}
    if in_sharded:
        st = _shardings(mesh, TS.train_state_pspecs(cfg, shape[1], max_seq,
                                                     tcfg))
        shard = {"state": st, "batch": _shardings(
            mesh, TS.batch_pspec(cfg, batch_axes_of(mesh)))}
    state = jax.tree.map(jnp.asarray, state)
    if tcfg.bf16_params:
        state["opt"]["master"] = state["params"]
        state["params"] = jax.tree.map(lambda t: t.astype(jnp.bfloat16),
                                       state["params"])
    if tcfg.grad_compress:
        state["grad_err"] = jax.tree.map(jnp.zeros_like, state["params"])
    out = {"steps": []}
    if with_grads:
        def loss(params, batch):
            return M.loss_fn(cfg, params, batch, state["cap_scales"],
                             dist=dist, dtype=jnp.float32)
        kw = {"in_shardings": (shard["state"]["params"], shard["batch"])} \
            if shard else {}
        (_, metrics), grads = jax.jit(jax.value_and_grad(
            loss, has_aux=True), **kw)(state["params"], batches[0])
        out["grads"] = _np(grads)
        out["grad_metrics"] = _np(metrics)
    kw = {"in_shardings": (shard["state"], shard["batch"]),
          "out_shardings": (shard["state"], None)} if shard else {}
    step = jax.jit(TS.make_train_step(cfg, tcfg, dist), **kw)
    for batch in batches:
        state, metrics = step(state, batch)
        out["steps"].append({"metrics": _np(metrics),
                             "params": _np(state["params"]),
                             "master": _np(state["opt"].get("master", {})),
                             "cap_scales": np.asarray(state["cap_scales"])})
    return out


def run_case(job):
    cfg = reduced(get_arch(job["arch"]), **job["over"])
    batches = [{k: jnp.asarray(v) for k, v in b.items()}
               for b in job["batches"]]
    return [run_job(cfg, job["state"], batches, tuple(shape), options,
                    with_grads, job.get("max_seq", 64))
            for shape, options, with_grads in job["jobs"]]


def main(src, dst):
    with open(src, "rb") as f:
        job = pickle.load(f)
    # one case, or {"cases": [...]}: several in this one process
    results = [run_case(j) for j in job["cases"]] if "cases" in job \
        else run_case(job)
    with open(dst, "wb") as f:
        pickle.dump(results, f)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
