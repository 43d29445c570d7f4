"""What every kernel wrapper of the port does around its launch: pick the
plain version or the kernel from where the tensors lie, check what the
kernel takes, and raise on a failed launch."""
from __future__ import annotations

import ctypes

import torch

MAX_DYNAMIC_SMEM = 232_448   # what one CTA can have on Hopper (227 KB)


def on_cpu(*tensors) -> bool:
    """True when every tensor lies on the CPU (plain version); False when
    all lie on CUDA (kernel). Anything else is an error."""
    devs = {t.device.type for t in tensors if t is not None}
    if devs == {"cpu"}:
        return True
    if devs == {"cuda"}:
        return False
    raise ValueError(f"tensors must all lie on the CPU or all on CUDA, "
                     f"got {sorted(devs)}")


def check(name: str, t: torch.Tensor, dtype, shape=None) -> None:
    """Raise unless `t` is a contiguous CUDA tensor of `dtype` (and
    `shape`, when given)."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor when x is")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")


SMEM_TOO_LARGE = -1  # a launcher's code: the shapes need more shared memory


def raise_on(code: int, kernel: str) -> None:
    if code == SMEM_TOO_LARGE:
        raise ValueError(f"{kernel}: the tile width needs more shared "
                         "memory than one CTA has")
    if code != 0:
        raise RuntimeError(f"{kernel} launch failed with CUDA error {code}")


def flat_shape(shape_fn, T: int, R: int, W: int, kernel: str) -> dict:
    """The launch shape of a flat walk (csrc/flat_walk.cuh) over T tiles of
    R slots and W lanes, from its C `*_flat_shape` function: slots per
    phase-A chunk, the CTAs of phase A (the slot values) and phase B (the
    ordered row fold), phase A's shared memory, and its load path."""
    out = (ctypes.c_int * 5)()
    raise_on(shape_fn(T, R, W, out), kernel)
    return {"chunk_slots": out[0], "ctas_phase_a": out[1],
            "ctas_phase_b": out[2], "smem_bytes": out[3],
            "load_path": "cp.async.bulk" if out[4] else "cp.async 4-byte"}


def sharded_shape(shape_fn, p: int, S_B: int, B: int, R: int, W: int,
                  bulk: bool, kernel: str) -> dict:
    """The launch of a sharded walk (csrc/sharded_walk.cuh) for p workers of
    S_B supersteps of B tiles of R slots and W lanes, from its C
    `*_sharded_shape` function: CTAs (always p), threads, ring stages of
    each pipeline, shared memory, load path (`bulk`: 16-byte-aligned
    pointers), tiles a window, chunks a window and pipelines a CTA."""
    out = (ctypes.c_int * 8)()
    raise_on(shape_fn(p, S_B, B, R, W, int(bulk), out), kernel)
    return {"ctas": out[0], "threads": out[1], "stages": out[2],
            "smem_bytes": out[3],
            "load_path": "cp.async.bulk" if out[4] else "cp.async 4-byte",
            "window_tiles": out[5], "chunks_per_window": out[6],
            "pipelines": out[7]}


def shard_tiles(blkid: torch.Tensor, B: int) -> torch.Tensor:
    """Flat tile index of every tile slot of the shard layout, (p*S,)."""
    b = torch.arange(B, device=blkid.device)
    return (blkid.long()[:, None] * B + b[None, :]).reshape(-1)


def check_shard_layout(T_pad: int, rowid, blkid, p: int, B: int) -> int:
    """S_B of a flat-payload shard layout; raises when rowid (p*S, R),
    blkid (p*S_B,) and the payload's T_pad do not fit p workers and
    supersteps of B tiles."""
    S_B = blkid.shape[0] // p
    if blkid.shape[0] != p * S_B or rowid.shape[0] != p * S_B * B \
            or T_pad % B:
        raise ValueError(f"shard layout mismatch: blkid {tuple(blkid.shape)},"
                         f" rowid {tuple(rowid.shape)}, T_pad={T_pad}, p={p},"
                         f" B={B}")
    return S_B
