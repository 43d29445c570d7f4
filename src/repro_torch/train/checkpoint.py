"""Fault-tolerant checkpointing — the port's counterpart of
`repro.train.checkpoint`, with the reference's on-disk contract:

* the state is saved as one flat npz shard (`shard_0.npz`, arrays
  `a0`, `a1`, ... in the order of `state_leaves`) plus a JSON manifest
  (step, leaf count, names, dtypes, shapes, time);
* writes go to a temp dir (`.tmp_step_<n>`) and are published with an
  atomic rename (`step_<n>`), so a failure mid-write never corrupts the
  latest checkpoint, and only published steps are listed;
* `AsyncCheckpointer` copies the state to host numpy arrays on the
  caller's thread (one synchronize) and writes on a thread of its own,
  one save in flight, keeping the newest `keep`.

Tensors go to numpy on save (bfloat16, which numpy lacks, as its raw
16 bits; the manifest says "bfloat16") and onto the like-state's devices
on load: `load_state` writes the saved values INTO the like-state's
tensors (the model's parameters, the moments) and returns it.

On a mesh (`dist`, a `launch.mesh.DistContext`) the checkpoint holds whole
leaves, as on one device: every rank gathers its shards (`DistContext.
unshard` at each leaf's axes as its module records them), rank 0 writes, and the ranks meet at a barrier
once the write is published. Loading on any mesh, or on one device,
cuts each whole leaf to the loading rank's shard: the reference's
mesh-agnostic checkpoint, and a restart may use another mesh.
"""
from __future__ import annotations

import json
import pathlib
import shutil
import threading
import time

import numpy as np
import torch
import torch.distributed as tdist
from torch import nn

from repro_torch.models import layers as L


def state_leaves(state, prefix: str = ""):
    """The state's tensors as (name, tensor) pairs in a fixed order: dict
    keys sorted, a model's parameters in its own order
    (`params.embed.tok`, `opt.m.layers.0.attn.wq`, `opt.step`, ...)."""
    if isinstance(state, nn.Module):
        for name, t in state.state_dict(keep_vars=True).items():
            yield f"{prefix}{name}", t
    elif isinstance(state, dict):
        for key in sorted(state):
            yield from state_leaves(state[key], f"{prefix}{key}.")
    else:
        yield prefix[:-1], state


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _writes(dist) -> bool:
    """Whether this rank writes checkpoints: rank 0, or the one process."""
    return dist is None or tdist.get_rank() == 0


def _host(state, dist=None) -> list:
    """[(name, array, dtype name)] of the state's whole leaves, copied to
    the host; on a mesh gathered by every rank (collective) and kept by
    the writing rank alone (others get [])."""
    out = []
    placed = L.placements(state)
    for n, t in state_leaves(state):
        if dist is not None:
            t = dist.unshard(t.detach(), L.leaf_axes(placed, n))
        if _writes(dist):
            out.append((n, _to_numpy(t), str(t.dtype).replace("torch.", "")))
    return out


def _barrier(dist) -> None:
    if dist is not None:
        tdist.barrier()


def _write(leaves: list, ckpt_dir: str, step: int) -> str:
    root = pathlib.Path(ckpt_dir)
    tmp = root / f".tmp_step_{step}"
    final = root / f"step_{step}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    np.savez(tmp / "shard_0.npz",
             **{f"a{i}": a for i, (_, a, _) in enumerate(leaves)})
    manifest = {
        "step": step,
        "n_leaves": len(leaves),
        "names": [n for n, _, _ in leaves],
        "time": time.time(),
        "dtypes": [d for _, _, d in leaves],
        "shapes": [list(a.shape) for _, a, _ in leaves],
    }
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)  # atomic publish
    return str(final)


def save_state(state, ckpt_dir: str, step: int, dist=None) -> str:
    """Synchronous atomic save (on a mesh: every rank calls it). Returns
    the published directory."""
    leaves = _host(state, dist)
    final = str(pathlib.Path(ckpt_dir) / f"step_{step}")
    if _writes(dist):
        final = _write(leaves, ckpt_dir, step)
    _barrier(dist)
    return final


class AsyncCheckpointer:
    """Fire-and-forget checkpoint writer (one in flight at a time). On a
    mesh every rank calls `save` and `wait`; rank 0 writes."""

    def __init__(self, ckpt_dir: str, keep: int = 3, dist=None):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self.dist = dist
        self._thread: threading.Thread | None = None
        # (step, bytes, seconds) of each save: the host copy and the write
        self.saves: list[tuple[int, int, float]] = []

    def save(self, state, step: int):
        self.wait()
        t0 = time.perf_counter()
        # snapshot off the device, on this thread
        leaves = _host(state, self.dist)
        if not _writes(self.dist):
            return

        def _run():
            _write(leaves, self.ckpt_dir, step)
            self._gc()
            self.saves.append((step, sum(a.nbytes for _, a, _ in leaves),
                               time.perf_counter() - t0))

        self._thread = threading.Thread(target=_run, daemon=True)
        self._thread.start()

    def wait(self):
        """Until the save in flight is published (on a mesh: on every
        rank)."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        _barrier(self.dist)

    def _gc(self):
        steps = sorted(list_steps(self.ckpt_dir))
        for s in steps[:-self.keep]:
            shutil.rmtree(pathlib.Path(self.ckpt_dir) / f"step_{s}",
                          ignore_errors=True)


def list_steps(ckpt_dir: str) -> list[int]:
    root = pathlib.Path(ckpt_dir)
    if not root.exists():
        return []
    out = []
    for p in root.glob("step_*"):
        if (p / "manifest.json").exists():  # only fully-published ckpts
            out.append(int(p.name.split("_")[1]))
    return sorted(out)


@torch.no_grad()
def load_state(like_state, ckpt_dir: str, step: int | None = None,
               dist=None):
    """Restore the newest (or `step`'s) checkpoint into `like_state`'s
    tensors, on their devices; returns (like_state, step). With `dist`
    the like-state holds this rank's shards and each whole leaf is cut to
    them (`DistContext.shard`). Raises when the names, shapes or types
    disagree."""
    steps = list_steps(ckpt_dir)
    if not steps:
        raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    step = steps[-1] if step is None else step
    d = pathlib.Path(ckpt_dir) / f"step_{step}"
    manifest = json.loads((d / "manifest.json").read_text())
    leaves = list(state_leaves(like_state))
    placed = L.placements(like_state)
    names = [n for n, _ in leaves]
    if manifest["names"] != names:
        raise ValueError(f"checkpoint step {step} holds another state: "
                         f"{len(manifest['names'])} leaves against "
                         f"{len(names)}")
    with np.load(d / "shard_0.npz") as data:
        for i, ((name, t), dtype) in enumerate(zip(leaves,
                                                   manifest["dtypes"])):
            a = data[f"a{i}"]
            src = (torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
                   if dtype == "bfloat16" else torch.from_numpy(a))
            if dist is not None:
                src = dist.shard(src, L.leaf_axes(placed, name))
            if src.dtype != t.dtype or tuple(src.shape) != tuple(t.shape):
                raise ValueError(f"{name}: saved {src.dtype} "
                                 f"{tuple(src.shape)}, like-state {t.dtype} "
                                 f"{tuple(t.shape)}")
            t.copy_(src)
    return like_state, step
