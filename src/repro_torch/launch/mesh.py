"""Device meshes — the port's counterpart of `repro.launch.mesh`.

A mesh is a `torch.distributed.device_mesh.DeviceMesh` with named
dimensions, ("data", "model") as the reference's, or ("pod", "data",
"model"). It needs a default process group: `init_process_group` starts
one from a `file://` store (tests: ranks spawned on one machine) or from
torchrun's environment (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT).
NCCL serves CUDA ranks, gloo CPU ranks.

The reference's TPU constants (`PEAK_FLOPS`, `HBM_BW`, `ICI_BW`) and
`make_production_mesh` belong to its compile-only dry run, which is not
ported yet (ROADMAP.md queue 1 item 6b).
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.device import resolve_device


def _backend(dev: torch.device) -> str:
    return "nccl" if dev.type == "cuda" else "gloo"


def init_process_group(init_method: str = None, *, rank: int = None,
                       world_size: int = None, device=None) -> torch.device:
    """Start the default process group and return this rank's device.
    `init_method` "file://<path>" (a store file that the ranks share; give
    `rank` and `world_size`) or None: torchrun's environment ("env://",
    RANK and WORLD_SIZE from it). On CUDA each rank takes the card of its
    LOCAL_RANK (its rank when that is unset). Raises without CUDA unless
    `device` names the CPU."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        local = int(os.environ.get("LOCAL_RANK", rank or 0))
        dev = torch.device("cuda", local)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kw = {} if init_method is None else {"rank": rank,
                                          "world_size": world_size}
    dist.init_process_group(_backend(dev), init_method=init_method or
                            "env://", **kw)
    return dev


def make_mesh(shape, axes, device=None) -> DeviceMesh:
    """A mesh of `shape` with dimension names `axes` over every rank of
    the default process group (whose size must be the product of shape),
    on the card (None) or the CPU (device="cpu")."""
    dev = resolve_device(device)
    return init_device_mesh(dev.type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_smoke_mesh(device=None) -> DeviceMesh:
    """1 x 1 ("data", "model") mesh over this process's one device: NCCL
    on the card (None), gloo on the CPU (device="cpu"). Starts a
    one-rank default process group on an in-memory store when none is
    running: no file, no port."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        if dev.type == "cuda":
            torch.cuda.set_device(dev.index or 0)
        dist.init_process_group(_backend(dev), store=dist.HashStore(),
                                rank=0, world_size=1)
    return make_mesh((1, 1), ("data", "model"), dev)


def batch_axes_of(mesh: DeviceMesh) -> tuple:
    """The axes the batch is split over: ("pod", "data") where present."""
    return tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))


def mesh_size(mesh: DeviceMesh) -> int:
    return mesh.mesh.numel()
