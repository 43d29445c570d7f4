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
"""
from __future__ import annotations

import json
import pathlib
import shutil
import threading
import time

import numpy as np
import torch
from torch import nn


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


def _host(state) -> list:
    """[(name, array, dtype name)] of the state, copied to the host."""
    return [(n, _to_numpy(t), str(t.dtype).replace("torch.", ""))
            for n, t in state_leaves(state)]


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


def save_state(state, ckpt_dir: str, step: int) -> str:
    """Synchronous atomic save. Returns the published directory."""
    return _write(_host(state), ckpt_dir, step)


class AsyncCheckpointer:
    """Fire-and-forget checkpoint writer (one in flight at a time)."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: threading.Thread | None = None
        # (step, bytes, seconds) of each save: the host copy and the write
        self.saves: list[tuple[int, int, float]] = []

    def save(self, state, step: int):
        self.wait()
        t0 = time.perf_counter()
        leaves = _host(state)  # snapshot off the device, on this thread

        def _run():
            _write(leaves, self.ckpt_dir, step)
            self._gc()
            self.saves.append((step, sum(a.nbytes for _, a, _ in leaves),
                               time.perf_counter() - t0))

        self._thread = threading.Thread(target=_run, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

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
def load_state(like_state, ckpt_dir: str, step: int | None = None):
    """Restore the newest (or `step`'s) checkpoint into `like_state`'s
    tensors, on their devices; returns (like_state, step). Raises when
    the names, shapes or types disagree."""
    steps = list_steps(ckpt_dir)
    if not steps:
        raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    step = steps[-1] if step is None else step
    d = pathlib.Path(ckpt_dir) / f"step_{step}"
    manifest = json.loads((d / "manifest.json").read_text())
    leaves = list(state_leaves(like_state))
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
            if src.dtype != t.dtype or tuple(src.shape) != tuple(t.shape):
                raise ValueError(f"{name}: saved {src.dtype} "
                                 f"{tuple(src.shape)}, like-state {t.dtype} "
                                 f"{tuple(t.shape)}")
            t.copy_(src)
    return like_state, step
