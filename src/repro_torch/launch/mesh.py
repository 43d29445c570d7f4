"""Device meshes — the port's counterpart of `repro.launch.mesh`.

A mesh is a `torch.distributed.device_mesh.DeviceMesh` with named
dimensions, ("data", "model") as the reference's, or ("pod", "data",
"model"). It needs a default process group: `init_process_group` starts
one from a `file://` store (tests: ranks spawned on one machine) or from
torchrun's environment (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT).
NCCL serves CUDA ranks, gloo CPU ranks.

`make_production_mesh` is the dry run's (`launch/dryrun.py`): one
process stands for one rank of a 256- or 512-card H100 mesh over a fake
process group, and nothing runs on a device. The constants below are
the H100's, for the cost model and the roofline (`launch/costmodel.py`,
`launch/roofline.py`); they replace the reference's TPU v5e figures
(`repro/launch/mesh.py:35-38`).
"""
from __future__ import annotations

import dataclasses
import math
import os
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.device import resolve_device
from repro_torch.launch import collectives as C


def _backend(dev: torch.device) -> str:
    return "nccl" if dev.type == "cuda" else "gloo"


def init_process_group(init_method: str = None, *, rank: int = None,
                       world_size: int = None, device=None,
                       timeout=None) -> torch.device:
    """Start the default process group and return this rank's device.
    `init_method` "file://<path>" (a store file that the ranks share; give
    `rank` and `world_size`) or None: torchrun's environment ("env://",
    RANK and WORLD_SIZE from it). On CUDA each rank takes the card of its
    LOCAL_RANK (its rank when that is unset). Raises without CUDA unless
    `device` names the CPU. `timeout` (a `datetime.timedelta`; PyTorch's
    default when None): how long a collective waits for the other ranks
    before this rank fails."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        local = int(os.environ.get("LOCAL_RANK", rank or 0))
        dev = torch.device("cuda", local)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kw = {} if init_method is None else {"rank": rank,
                                          "world_size": world_size}
    if timeout is not None:
        kw["timeout"] = timeout
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


def fake_mesh(shape, axes) -> DeviceMesh:
    """A mesh of `shape` (dimension names `axes`) as its rank 0 sees it,
    over PyTorch's fake process group (its test backend "fake":
    collectives return at once and move nothing), started when no group
    runs: one process traces one rank's step under fake tensors, and
    nothing runs on a device. The caller destroys the group when done."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    n = math.prod(shape)
    if not dist.is_initialized():
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=n)
    if dist.get_world_size() != n:
        raise RuntimeError(f"a {shape} mesh needs {n} ranks; the running "
                           f"process group has {dist.get_world_size()}")
    return init_device_mesh("cpu", tuple(shape), mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    """The production mesh (`fake_mesh`): ("data" 32, "model" 8), 256
    ranks, 32 nodes of 8 H100 SXM5; with `multi_pod` ("pod" 2, "data"
    32, "model" 8), 512 ranks. "model" stays inside a node's NVLink
    domain: the reference's 16 x 16 (`repro/launch/mesh.py:11-22`) would
    put it across two nodes, at 1/9 of the bandwidth; the rank counts
    stay the reference's."""
    if multi_pod:
        return fake_mesh((2, 32, 8), ("pod", "data", "model"))
    return fake_mesh((32, 8), ("data", "model"))


def batch_axes_of(mesh: DeviceMesh) -> tuple:
    """The axes the batch is split over: ("pod", "data") where present."""
    return tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))


def mesh_size(mesh: DeviceMesh) -> int:
    return mesh.mesh.numel()



def _rank_groups(mesh, axes: tuple):
    """This rank's process group over `axes` of the mesh (the ranks that
    differ only in those coordinates). Every rank creates every such
    group, in one order."""
    names = mesh.mesh_dim_names
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    dims = [names.index(a) for a in axes]
    rest = [i for i in range(len(names)) if i not in dims]
    ranks = mesh.mesh.permute(*rest, *dims).reshape(
        -1, math.prod(mesh.mesh.shape[i] for i in dims))
    me = dist.get_rank()
    mine = None
    for row in ranks.tolist():
        g = dist.new_group(row)
        if me in row:
            mine = g
    return mine


@dataclasses.dataclass(frozen=True)
class DistContext:
    """How a model step is laid out on the mesh: the batch split over
    `batch_axes`, the placements' "model" dimensions over `tp_axis` and
    their "data" dimensions over `fsdp_axis` (None: nothing split over
    the data ranks). Builds its process groups when made: every rank of
    the mesh makes it, at the same point.

    The layout of the weights is not kept here: each module records the
    axes of the leaves it holds split when it is sharded
    (`models.layers.shard_module`, `placements`). `shard` / `unshard` cut
    a whole leaf placed at `axes` to this rank's shard and gather it
    back."""
    mesh: object
    batch_axes: tuple = ("data",)
    tp_axis: str = "model"
    fsdp_axis: Optional[str] = "data"
    groups: dict = dataclasses.field(default_factory=dict, compare=False,
                                     repr=False)
    axis_sizes: dict = dataclasses.field(default_factory=dict,
                                         compare=False, repr=False)

    def __post_init__(self):
        names = self.mesh.mesh_dim_names
        self.axis_sizes.update(zip(names, self.mesh.mesh.shape))
        fsdp = (self.fsdp_axis,) if self.fsdp_axis else ()
        wanted = (self.batch_axes, (self.tp_axis,), fsdp,
                  (self.tp_axis, *fsdp),
                  tuple(a for a in self.batch_axes if a not in fsdp))
        for axes in wanted:
            axes = tuple(a for a in names if a in axes)
            if axes and axes not in self.groups:
                self.groups[axes] = _rank_groups(self.mesh, axes)
                C.name_group(self.groups[axes], axes)

    def _key(self, axes) -> tuple:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return tuple(a for a in self.mesh.mesh_dim_names if a in axes)

    def group(self, axes):
        """The process group over `axes` (an axis name or several), None
        for no axis."""
        key = self._key(axes)
        return self.groups[key] if key else None

    def size(self, axes) -> int:
        return math.prod(self.axis_sizes[a] for a in self._key(axes))

    def index(self, axes) -> int:
        """This rank's coordinate over `axes` (row-major)."""
        g = self.group(axes)
        return 0 if g is None else dist.get_rank(g)

    @property
    def tp(self) -> int:
        return self.size(self.tp_axis)

    @property
    def dp(self) -> int:
        """Ranks the batch is split over."""
        return self.size(self.batch_axes)

    def _axis(self, role: str):
        return {"tp": self.tp_axis, "fsdp": self.fsdp_axis}[role]

    def sizes(self) -> dict:
        """{"tp": ranks the model axis splits over, "fsdp": ranks the data
        axis of the placements splits over}."""
        return {r: self.size(self._axis(r)) if self._axis(r) else 1
                for r in ("tp", "fsdp")}

    def effective(self, axes) -> Optional[tuple]:
        """A placement's logical axes ("model", "data") as this mesh splits
        them: `tp_axis`, `fsdp_axis`, or None where the axis is absent or
        one rank wide. None when nothing is split."""
        if axes is None:
            return None
        roles = {"model": self.tp_axis, "data": self.fsdp_axis}
        out = tuple(roles.get(a) if a in roles and roles.get(a) and
                    self.size(roles[a]) > 1 else None for a in axes)
        return out if any(out) else None

    def shard(self, t: torch.Tensor, axes) -> torch.Tensor:
        """This rank's shard (a copy) of the whole leaf t placed at `axes`
        (effective axes, `effective`), or t itself when nothing splits
        it."""
        if not axes:
            return t
        for dim, axis in enumerate(axes):
            if axis:
                n = t.shape[dim] // self.size(axis)
                t = t.narrow(dim, self.index(axis) * n, n)
        return t.contiguous().clone()

    def unshard(self, t: torch.Tensor, axes) -> torch.Tensor:
        """The whole leaf placed at `axes` from every rank's shard t
        (collective: every rank calls it), or t itself when nothing
        splits it."""
        for dim, axis in enumerate(axes or ()):
            if axis:
                t = C.all_gather(t, dim, self.group(axis))
        return t



# One H100 SXM5 80 GB at 700 W (NVIDIA H100 Tensor Core GPU datasheet)
PEAK_FLOPS = 989e12      # dense bfloat16 FLOP/s on the tensor cores
HBM_BW = 3.35e12         # HBM3 bytes/s
HBM_BYTES = 80e9         # HBM3 capacity, bytes
NVLINK_BW = 450e9        # NVLink 4 bytes/s a direction (900 GB/s both ways)
IB_BW = 50e9             # one 400 Gb/s NDR InfiniBand port a card (DGX H100)
