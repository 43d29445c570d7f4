"""Training loop with checkpoint/restart and failure injection — the
port's counterpart of `repro.train.trainer`:

* auto-resume from the newest fully-published checkpoint;
* `failure_at` injects a crash after that step (tests restart end to end);
* the async checkpoint writer stays off the critical path;
* the data pipeline (iCh dispatcher) prefetches the next batch while a
  step trains.

On a mesh (`train(..., mesh=)`, a `DeviceMesh` of `launch/mesh.py`
with more than one rank; every rank calls `train`) the step runs
data parallel, moe's routed experts expert-parallel
(`train_step.make_train_step(cfg, tcfg, dist)`): each rank takes its
rows of the pipeline's global batch, checkpoints hold whole leaves
(written by rank 0) and load onto any mesh, so a restart may use
another mesh (elastic), and rank 0 prints the logs. A one-rank mesh is
no mesh, as in the reference. The
batches are tokens and labels, as the reference's pipeline makes them:
the dense, moe, ssm and hybrid families train (moe with its capacity
scales, which the checkpoints carry), a vlm trains on text alone (no
patches), as the reference's trainer runs it; encdec raises
NotImplementedError (its loss needs frames, which the reference's trainer
never feeds: ROADMAP.md queue 3 caveat 13).
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Optional

import torch
import torch.distributed as tdist

from repro_torch.data.pipeline import Pipeline
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import batch_axes_of, mesh_size
from repro_torch.models import model as M
from repro_torch.launch.mesh import DistContext

from . import checkpoint as CKPT
from . import train_step as TS


@dataclasses.dataclass
class RunConfig:
    steps: int = 50
    batch: int = 8
    seq: int = 128
    ckpt_dir: str = dataclasses.field(default_factory=lambda: os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ckpt_every: int = 20
    log_every: int = 10
    seed: int = 0
    failure_at: Optional[int] = None  # inject a crash AFTER this step


class InjectedFailure(RuntimeError):
    pass


def train(cfg, run: RunConfig, tcfg: TS.TrainConfig = None, device=None,
          mesh=None, verbose: bool = True):
    """Returns (final state, losses of the steps this call ran). Call again
    after a crash to resume. `device` None is the card (raises without
    CUDA), or the mesh's device type when a `mesh` is given (this rank's
    card, or the CPU); "cpu" runs every kernel's plain version. Raises
    NotImplementedError for encdec before it writes anything, ValueError
    for a mesh the config or the batch cannot split over."""
    dist = None
    if mesh is not None and mesh_size(mesh) > 1:
        dist = DistContext(mesh, batch_axes=batch_axes_of(mesh))
    M.check_trainable(cfg, dist)
    if cfg.family == "encdec":
        raise NotImplementedError(
            f"train() feeds tokens and labels only, as the reference's "
            f"trainer does; {cfg.name!r} (encdec) needs frames of "
            f"{cfg.encoder_seq} rows, which the reference's trainer never "
            f"makes (ROADMAP.md queue 3 caveat 13): train it with "
            f"make_train_step on batches that carry \"frames\"")
    if device is None and mesh is not None:
        device = "cpu" if mesh.device_type == "cpu" else torch.device(
            "cuda", torch.cuda.current_device())
    dev = resolve_device(device)
    verbose = verbose and (dist is None or tdist.get_rank() == 0)
    tcfg = tcfg or TS.TrainConfig(opt=dataclasses.replace(
        TS.TrainConfig().opt, warmup_steps=10, total_steps=run.steps))
    state = TS.init_train_state(cfg, run.seed, max_seq=run.seq, tcfg=tcfg,
                                device=dev, dist=dist)
    start_step = 0
    if CKPT.list_steps(run.ckpt_dir):
        state, start_step = CKPT.load_state(state, run.ckpt_dir, dist=dist)
        if verbose:
            print(f"[trainer] resumed from step {start_step}")

    step_fn = TS.make_train_step(cfg, tcfg, dist)
    pipe = Pipeline(cfg, run.batch, run.seq, seed=run.seed, device=dev)
    ckpt = CKPT.AsyncCheckpointer(run.ckpt_dir, dist=dist)

    losses = []
    t0 = time.time()
    try:
        for step in range(start_step, run.steps):
            batch_np, ingest = pipe.get_batch(step)
            batch = {k: v.to(dev) for k, v in TS.batch_shard(
                {k: torch.from_numpy(v) for k, v in batch_np.items()},
                dist, tcfg.microbatch).items()}
            state, metrics = step_fn(state, batch)
            loss = float(metrics["loss"])
            losses.append(loss)
            if verbose and (step % run.log_every == 0
                            or step == run.steps - 1):
                print(f"[trainer] step {step} loss {loss:.4f} "
                      f"gnorm {float(metrics['grad_norm']):.3f} "
                      f"ingest_steals {ingest.steals} "
                      f"({time.time() - t0:.1f}s)")
            if (step + 1) % run.ckpt_every == 0 or step == run.steps - 1:
                ckpt.save(state, step + 1)
            if run.failure_at is not None and step + 1 == run.failure_at:
                ckpt.wait()
                raise InjectedFailure(
                    f"injected failure after step {step + 1}")
    finally:
        pipe.close()
        ckpt.wait()
        if verbose and ckpt.saves:
            print(f"[trainer] checkpoint writes (step, bytes, seconds): "
                  f"{ckpt.saves}")
    return state, losses
