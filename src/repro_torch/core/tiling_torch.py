"""The schedule pipeline on the card: `core/tiling.py` as PyTorch tensor
programs (the port's counterpart of the reference's jitted
`repro.core.tiling_jax`).

The numpy construction path (band width -> item splitting -> packing into
(T, R) tiles -> tile costs -> LPT sharding -> the kernels' streams ->
payload pack) is loop-free cumsum/repeat/gather programs, so it ports
nearly term for term. Run on the card, build -> cost -> partition -> shard
layout -> pack leaves everything the sharded kernels read on the device, so
a refine generation does not round-trip its arrays through host numpy.

Conformance bar: ELEMENT-IDENTICAL outputs to the numpy `core/tiling.py`,
float64 tile costs bit for bit (tests/test_torch_schedule_pipeline.py
holds the port to the reference's numpy `repro.core.tiling`). The integer
streams are exact by construction: the same index arithmetic and the same
gathers. The LPT partition compares float64 partial sums, so one ulp in a
tile cost can flip a worker; three rules keep the costs exact:

* every cost tensor is float64, explicitly (PyTorch has no global x64
  switch to scope, and needs none);
* reductions keep numpy's association order: `_pairwise_rowsum` is
  numpy's pairwise_sum (8 accumulators, a fixed combine tree, halving
  above 128) written as separate elementwise adds, and the block and
  chain folds are `np.bincount`'s left folds, run by the `segment_fold`
  kernel (`kernels/lpt`) because `index_add_` / `scatter_add_` add
  float64 with atomics on the card, in no fixed order;
* the LPT loop itself is the `lpt_assign` kernel: one warp places every
  chain, reading the chain count on the device.

Shapes come from a host `SchedulePlan` (one numpy pass over sizes: width,
segment and tile counts, the int32 bound checks), as in the reference. The
one device -> host sync of the whole pipeline is the per-worker block
count that sizes the (p, S_B) layout; a caller that knows S_B (a refine
round at the same shape) passes `n_steps=` and skips it. A too small
`n_steps` drops the blocks that do not fit, as the reference's does.

The port runs eagerly: the reference's `jax.jit` executables, their
`functools.cache` per plan shape and its input-buffer donation
(`tiling_jax.py:364-420`) have no counterpart here. Every entry point takes
`device` (None: the card, raising without CUDA; "cpu" runs the kernels'
plain versions). Zero-tile schedules (empty sizes) mirror
`build_schedule`'s 0-tile semantics: there is nothing to launch.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.lpt.lpt import lpt_assign, segment_fold
from repro_torch.sched.defaults import ICH_EPS, SUPERSTEP

from .tiling import TileSchedule, WorkerShards, _check_width, ich_tile_width

_I32, _I64, _F64 = torch.int32, torch.int64, torch.float64


# ---------------------------------------------------------------------------
# Host-side shape plan: every shape the tensor programs need, from one cheap
# numpy pass over sizes.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SchedulePlan:
    """Static shapes of one schedule construction."""

    n_items: int        # len(sizes)
    width: int          # W (band width, host-resolved like the numpy path)
    total_segs: int     # real segments before padding
    n_tiles: int        # T = ceil(max(total, 1) / R)
    rows_per_tile: int  # R


def plan_schedule(sizes: np.ndarray, *, rows_per_tile: int = 8,
                  width: int | None = None, eps: float = ICH_EPS,
                  min_w: int = 8, max_w: int = 512) -> SchedulePlan:
    """Resolve the static shapes `build_schedule` would produce."""
    sizes = np.asarray(sizes)
    width = _check_width(width)
    W = width if width else ich_tile_width(sizes, eps, min_w, max_w)
    R = int(rows_per_tile)
    if sizes.size == 0:
        return SchedulePlan(0, W, 0, 0, R)
    if int(sizes.max()) > np.iinfo(np.int32).max - W:
        raise ValueError("per-item sizes must fit int32; largest item is "
                         f"{int(sizes.max())} work units")
    total = int(np.maximum(-(-sizes.astype(np.int64) // W), 1).sum())
    if total > np.iinfo(np.int32).max:
        raise ValueError(f"schedule would need {total} segments, which "
                         "exceeds the int32 construction bound")
    T = -(-max(total, 1) // R)
    return SchedulePlan(int(sizes.size), W, total, T, R)


# ---------------------------------------------------------------------------
# Device-side containers (tensor twins of TileSchedule / WorkerShards)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DeviceSchedule:
    """`TileSchedule` with its arrays as tensors on one device."""

    item_id: torch.Tensor    # (T, R) int32, -1 = padding slot
    seg_start: torch.Tensor  # (T, R) int32
    seg_len: torch.Tensor    # (T, R) int32
    width: int
    n_items: int

    @property
    def n_tiles(self) -> int:
        return int(self.item_id.shape[0])

    @property
    def rows_per_tile(self) -> int:
        return int(self.item_id.shape[1])

    @property
    def device(self) -> torch.device:
        return self.item_id.device

    def to_host(self) -> TileSchedule:
        return TileSchedule(self.item_id.cpu().numpy(),
                            self.seg_start.cpu().numpy(),
                            self.seg_len.cpu().numpy(),
                            self.width, self.n_items)


@dataclasses.dataclass(frozen=True)
class DeviceLowering:
    """One schedule fully lowered on a device: tiles + costs + the (p, S_B)
    shard layout + the exact streams the sharded kernels read. What a
    `backend="torch"` Schedule memoizes per (p, superstep)."""

    schedule: DeviceSchedule
    tile_cost: torch.Tensor   # (T,) float64, numpy-identical order
    worker: torch.Tensor      # (T,) int32
    block_perm: torch.Tensor  # (p, S_B) int32, -1 = padding step
    rowid: torch.Tensor       # (p*S, R) int32 shard item-id stream
    blkid: torch.Tensor       # (p*S_B,) int32 kernel block-id stream
    slot_cost: torch.Tensor   # (T_pad, R) float32 flat kernel cost stream
    superstep: int

    @property
    def p(self) -> int:
        return int(self.block_perm.shape[0])

    @property
    def n_steps(self) -> int:
        return int(self.block_perm.shape[1])

    def to_host_shards(self) -> WorkerShards:
        return WorkerShards(worker=self.worker.cpu().numpy(),
                            block_perm=self.block_perm.cpu().numpy(),
                            superstep=self.superstep)


def _tensor(a, dtype, device) -> torch.Tensor:
    """`a` (an array or a tensor) as a `dtype` tensor on `device`."""
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=dtype)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device=device,
                                                        dtype=dtype)


# ---------------------------------------------------------------------------
# Bit-exact float reductions
# ---------------------------------------------------------------------------

def _pairwise_rowsum(x: torch.Tensor) -> torch.Tensor:
    """Sum (T, R) over axis 1 in EXACTLY numpy's pairwise_sum association
    order (sequential under 8 columns; 8 accumulators then a fixed
    4-2-1 combine tree up to 128; halved recursion above), so LPT sees
    bit-identical tile costs to the numpy path. Each add is its own
    elementwise float64 operation: no reduction kernel chooses the order."""
    R = int(x.shape[1])
    if R == 0:
        return torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
    if R < 8:
        res = x[:, 0]
        for i in range(1, R):
            res = res + x[:, i]
        return res
    if R <= 128:
        r = [x[:, j] for j in range(8)]
        i = 8
        while i + 8 <= R:
            for j in range(8):
                r[j] = r[j] + x[:, i + j]
            i += 8
        res = ((r[0] + r[1]) + (r[2] + r[3])) + ((r[4] + r[5]) + (r[6] + r[7]))
        while i < R:
            res = res + x[:, i]
            i += 1
        return res
    half = (R // 2) - ((R // 2) % 8)
    return _pairwise_rowsum(x[:, :half]) + _pairwise_rowsum(x[:, half:])


# ---------------------------------------------------------------------------
# Tensor mirrors of the construction stages
# ---------------------------------------------------------------------------

def ich_tile_width_torch(sizes, eps: float = ICH_EPS, min_w: int = 8,
                         max_w: int = 512, *, device=None) -> torch.Tensor:
    """Tensor twin of `ich_tile_width` (a 0-d int32 tensor on the device;
    the pipeline itself resolves W on the host because tile shapes must be
    known before any tensor is made)."""
    dev = resolve_device(device)
    sizes = _tensor(sizes, _F64, dev)
    mu = sizes.mean() if sizes.numel() else torch.zeros((), dtype=_F64,
                                                        device=dev)
    upper = mu * (1.0 + eps)
    # an integer shift, not exp2: exp2 may be lowered through exp(x*ln2),
    # which can return 15.999... for exp2(4.0)
    e = torch.ceil(torch.log2(torch.clamp(upper, min=1.0))).to(_I64)
    w = torch.ones((), dtype=_I64, device=dev) << torch.clamp(e, 0, 30)
    return torch.clamp(w, min_w, max_w).to(_I32)


def _split_build(sizes: torch.Tensor, *, width: int, total: int,
                 n_tiles: int,
                 rows_per_tile: int) -> tuple[torch.Tensor, torch.Tensor,
                                              torch.Tensor]:
    """`_split_segments` + the (T, R) reshape of `build_schedule`. The
    segment -> item map repeats to exactly `total` (what
    `repeat_interleave(output_size=)` demands) and is padded with -1 to the
    T*R capacity afterwards."""
    n = sizes.shape[0]
    R, cap = rows_per_tile, n_tiles * rows_per_tile
    dev = sizes.device
    s64 = sizes.to(_I64)
    n_segs = torch.clamp((s64 + (width - 1)) // width, min=1)
    first = torch.cumsum(n_segs, 0) - n_segs  # exclusive-prefix seg counts
    item = torch.full((cap,), -1, dtype=_I64, device=dev)
    item[:total] = torch.repeat_interleave(
        torch.arange(n, dtype=_I64, device=dev), n_segs, output_size=total)
    pos = torch.arange(cap, dtype=_I64, device=dev)
    valid = pos < total
    safe = torch.clamp(item, min=0)
    start = (pos - first[safe]) * width
    length = torch.clamp(s64[safe] - start, 0, width)
    start = torch.where(valid, start, 0)
    length = torch.where(valid, length, 0)
    return (item.to(_I32).reshape(n_tiles, R),
            start.to(_I32).reshape(n_tiles, R),
            length.to(_I32).reshape(n_tiles, R))


def _slot_tile_cost(costs: torch.Tensor, sizes: torch.Tensor,
                    item_id: torch.Tensor,
                    seg_len: torch.Tensor) -> tuple[torch.Tensor,
                                                    torch.Tensor]:
    """`TileSchedule.slot_cost` / `tile_cost` twins (float64, numpy
    order)."""
    costs = costs.to(_F64)
    sizes_f = sizes.to(_F64)
    unit = torch.where(sizes_f > 0,
                       costs / torch.where(sizes_f > 0, sizes_f, 1.0), 0.0)
    safe = torch.clamp(item_id, min=0).to(_I64)
    per_slot = torch.where(item_id >= 0, unit[safe], 0.0)
    slot_cost = per_slot * seg_len.to(_F64)
    return slot_cost, _pairwise_rowsum(slot_cost)


def _partition(tile_cost: torch.Tensor, item_id: torch.Tensor, *, p: int,
               block: int) -> torch.Tensor:
    """`partition_tiles` twin: item-closed chain merge + LPT assignment.

    The folds run on `segment_fold` (np.bincount's order) and the LPT loop
    on `lpt_assign` (heapq's tie order), so assignments match bit for bit.
    The chain count is data-dependent: the folds and the sort run over the
    n_blocks bound, where the phantom chains past the real ones fold to
    zero cost and sort after every real chain (a stable sort, higher ids);
    `lpt_assign` reads the real count on the device and skips them."""
    T = int(item_id.shape[0])
    blk = int(block)
    n_blocks = -(-T // blk)
    dev = item_id.device
    first = item_id[:, 0]
    last = item_id.max(dim=1).values
    spans = (last[:-1] == first[1:]) & (first[1:] >= 0) & (last[:-1] >= 0)
    merge = spans if blk == 1 else spans[blk - 1:T - 1:blk]
    chain = torch.zeros(n_blocks, dtype=_I64, device=dev)
    chain[1:] = torch.cumsum((~merge).to(_I64), 0)
    bcost = tile_cost = tile_cost.contiguous()
    if blk > 1:
        bcost = segment_fold(
            tile_cost, torch.arange(T, dtype=_I64, device=dev) // blk,
            n_blocks)
    ccost = segment_fold(bcost, chain, n_blocks)
    # + 0.0 turns -0.0 into +0.0, so no sort can put signed zeros apart
    order = torch.sort(-ccost + 0.0, stable=True).indices
    chain_worker = lpt_assign(ccost, order, chain[-1:] + 1, p)
    block_worker = chain_worker[chain]
    return torch.repeat_interleave(block_worker, blk,
                                   output_size=n_blocks * blk)[:T]


def _shard_layout(worker: torch.Tensor, item_id: torch.Tensor,
                  slot_cost: torch.Tensor, *, p: int, superstep: int,
                  n_steps: int) -> tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor, torch.Tensor]:
    """`make_shards` + the kernels' block and row streams, at a given S_B.
    A block whose position in its worker's row is past S_B is dropped (it
    lands in a spare slot that is cut off), as the reference's
    out-of-bounds update drops it."""
    T = int(worker.shape[0])
    B, S_B = int(superstep), int(n_steps)
    n_blocks = -(-T // B)
    R = int(item_id.shape[1])
    dev = worker.device
    block_worker = worker[::B].to(_I64)
    order = torch.sort(block_worker, stable=True).indices
    w_sorted = block_worker[order]
    pos = (torch.arange(n_blocks, dtype=_I64, device=dev)
           - torch.searchsorted(w_sorted, w_sorted))
    slot = torch.where(pos < S_B, w_sorted * S_B + pos, p * S_B)
    flat_perm = torch.full((p * S_B + 1,), -1, dtype=_I64, device=dev)
    flat_perm[slot] = order
    block_perm = flat_perm[:p * S_B].reshape(p, S_B).to(_I32)
    # tile-granular perm -> shard item-id stream (WorkerShards.shard_item_id)
    tiles = (block_perm[:, :, None].to(_I64) * B
             + torch.arange(B, dtype=_I64, device=dev)[None, None, :])
    tiles = torch.where((block_perm[:, :, None] >= 0) & (tiles < T), tiles,
                        -1)
    flat = tiles.reshape(-1)
    rowid = torch.where((flat >= 0)[:, None],
                        item_id[torch.clamp(flat, min=0)], -1)
    blkid = torch.clamp(block_perm, min=0).reshape(-1)
    # flat (T_pad, R) float32 cost stream (sched/kernels._flat_slot_cost)
    flat_cost = torch.zeros((n_blocks * B, R), dtype=torch.float32,
                            device=dev)
    flat_cost[:T] = slot_cost.to(torch.float32)
    return block_perm, rowid.to(_I32), blkid, flat_cost


def _pack_gather(indptr: torch.Tensor, indices: torch.Tensor,
                 data: torch.Tensor, item_id: torch.Tensor,
                 seg_start: torch.Tensor, seg_len: torch.Tensor, *,
                 width: int,
                 pad_tiles_to: int) -> tuple[torch.Tensor, torch.Tensor]:
    """`pack_csr` twin as the rectangular gather (the numpy fast path is a
    masked sequential reshape of the same element stream). Offsets are
    int64: a payload past 2**31 elements still packs."""
    T, R = item_id.shape
    W = int(width)
    T_pad = -(-T // int(pad_tiles_to)) * int(pad_tiles_to)
    dev = data.device
    item = torch.clamp(item_id.reshape(-1), min=0).to(_I64)
    base = indptr.to(_I64)[item] + seg_start.reshape(-1).to(_I64)
    lane = torch.arange(W, dtype=_I64, device=dev)
    src = torch.clamp(base[:, None] + lane[None, :], 0, data.shape[0] - 1)
    keep = lane[None, :] < seg_len.reshape(-1).to(_I64)[:, None]
    vals = torch.zeros((T_pad, R, W), dtype=data.dtype, device=dev)
    cols = torch.zeros((T_pad, R, W), dtype=_I32, device=dev)
    vals[:T] = torch.where(keep, data[src], 0).reshape(T, R, W)
    cols[:T] = torch.where(keep, indices[src].to(_I32), 0).reshape(T, R, W)
    return vals, cols


# ---------------------------------------------------------------------------
# Public mirrors
# ---------------------------------------------------------------------------

def split_items_torch(sizes: np.ndarray, width: int, *,
                      device=None) -> tuple[torch.Tensor, torch.Tensor,
                                            torch.Tensor]:
    """`split_items` twin: (item, start, length) tensors, real segments
    only."""
    if int(width) <= 0:
        raise ValueError(f"tile width must be positive, got {width}")
    dev = resolve_device(device)
    plan = plan_schedule(sizes, rows_per_tile=1, width=int(width))
    if plan.n_items == 0:
        z = torch.zeros(0, dtype=_I32, device=dev)
        return z, z.clone(), z.clone()
    item, start, length = _split_build(
        _tensor(sizes, _I64, dev), width=plan.width, total=plan.total_segs,
        n_tiles=plan.n_tiles, rows_per_tile=1)
    t = plan.total_segs
    return item.reshape(-1)[:t], start.reshape(-1)[:t], length.reshape(-1)[:t]


def build_schedule_torch(sizes: np.ndarray, *, rows_per_tile: int = 8,
                         width: int | None = None, eps: float = ICH_EPS,
                         min_w: int = 8, max_w: int = 512,
                         device=None) -> DeviceSchedule:
    """`build_schedule` twin with the tiles on the device."""
    dev = resolve_device(device)
    plan = plan_schedule(sizes, rows_per_tile=rows_per_tile, width=width,
                         eps=eps, min_w=min_w, max_w=max_w)
    R = plan.rows_per_tile
    if plan.n_items == 0:
        z = torch.zeros((0, R), dtype=_I32, device=dev)
        return DeviceSchedule(z, z.clone(), z.clone(), plan.width, 0)
    item_id, seg_start, seg_len = _split_build(
        _tensor(sizes, _I64, dev), width=plan.width, total=plan.total_segs,
        n_tiles=plan.n_tiles, rows_per_tile=R)
    return DeviceSchedule(item_id, seg_start, seg_len, plan.width,
                          plan.n_items)


def pack_csr_torch(indptr, indices, data, schedule, *, pad_tiles_to: int = 1,
                   device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """`pack_csr` twin over a `DeviceSchedule` or a host `TileSchedule`:
    (vals, cols) of shape (T_pad, R, W) on the device. The CSR arrays may
    be numpy arrays or tensors; `data` keeps its dtype. With no `device`,
    a `DeviceSchedule`'s own device is used, else the card."""
    if int(pad_tiles_to) < 1:
        raise ValueError(f"pad_tiles_to must be positive, got {pad_tiles_to}")
    if device is None and isinstance(schedule, DeviceSchedule):
        dev = schedule.device
    else:
        dev = resolve_device(device)
    T, R, W = schedule.n_tiles, schedule.rows_per_tile, schedule.width
    T_pad = -(-T // int(pad_tiles_to)) * int(pad_tiles_to)
    data = (data.to(dev) if isinstance(data, torch.Tensor)
            else torch.from_numpy(np.ascontiguousarray(data)).to(dev))
    if data.shape[0] == 0:  # no payload: every slot is padding
        return (torch.zeros((T_pad, R, W), dtype=data.dtype, device=dev),
                torch.zeros((T_pad, R, W), dtype=_I32, device=dev))
    return _pack_gather(
        _tensor(indptr, _I64, dev), _tensor(indices, _I32, dev), data,
        _tensor(schedule.item_id, _I32, dev),
        _tensor(schedule.seg_start, _I32, dev),
        _tensor(schedule.seg_len, _I32, dev), width=W,
        pad_tiles_to=int(pad_tiles_to))


def partition_tiles_torch(tile_cost, item_id, p: int, block: int = 1, *,
                          device=None) -> torch.Tensor:
    """`partition_tiles` twin: the (T,) int32 worker map on the device."""
    p, blk = int(p), int(block)
    if p < 1:
        raise ValueError(f"worker count must be positive, got {p}")
    if blk < 1:
        raise ValueError(f"block must be positive, got {block}")
    dev = resolve_device(device)
    T = int(item_id.shape[0])
    if T == 0 or p == 1:
        return torch.zeros(T, dtype=_I32, device=dev)
    return _partition(_tensor(tile_cost, _F64, dev),
                      _tensor(item_id, _I32, dev), p=p, block=blk)


def lower_schedule_torch(sizes: np.ndarray, costs: np.ndarray, *, p: int,
                         superstep: int = SUPERSTEP, rows_per_tile: int = 8,
                         width: int | None = None, eps: float = ICH_EPS,
                         min_w: int = 8, max_w: int = 512,
                         n_steps: int | None = None,
                         device=None) -> DeviceLowering:
    """The pipeline: upload sizes and costs -> build -> cost -> partition
    -> shard layout + the kernels' streams, all on the device.

    `n_steps` (S_B) sizes the (p, S_B) layout; when omitted it is read
    back from the device block counts — the pipeline's single scalar sync.
    Pass the previous generation's `lowering.n_steps` in a refine loop to
    stay on the device.
    """
    p = int(p)
    if p < 1:
        raise ValueError(f"worker count must be positive, got {p}")
    B = int(superstep)
    if B < 1:
        raise ValueError(f"superstep must be positive, got {superstep}")
    dev = resolve_device(device)
    plan = plan_schedule(sizes, rows_per_tile=rows_per_tile, width=width,
                         eps=eps, min_w=min_w, max_w=max_w)
    R = plan.rows_per_tile
    if plan.n_items == 0:
        z2 = torch.zeros((0, R), dtype=_I32, device=dev)
        S_B = max(int(n_steps or 0), 1)
        return DeviceLowering(
            schedule=DeviceSchedule(z2, z2.clone(), z2.clone(), plan.width,
                                    0),
            tile_cost=torch.zeros(0, dtype=_F64, device=dev),
            worker=torch.zeros(0, dtype=_I32, device=dev),
            block_perm=torch.full((p, S_B), -1, dtype=_I32, device=dev),
            rowid=torch.full((p * S_B * B, R), -1, dtype=_I32, device=dev),
            blkid=torch.zeros(p * S_B, dtype=_I32, device=dev),
            slot_cost=torch.zeros((0, R), dtype=torch.float32, device=dev),
            superstep=B)
    sizes_t = _tensor(sizes, _I64, dev)
    costs_t = _tensor(costs, _F64, dev)
    item_id, seg_start, seg_len = _split_build(
        sizes_t, width=plan.width, total=plan.total_segs,
        n_tiles=plan.n_tiles, rows_per_tile=R)
    slot_cost, tile_cost = _slot_tile_cost(costs_t, sizes_t, item_id,
                                           seg_len)
    if p == 1:
        worker = torch.zeros(plan.n_tiles, dtype=_I32, device=dev)
    else:
        worker = _partition(tile_cost, item_id, p=p, block=B)
    if n_steps is None:
        # integer counts: exact whatever order the atomics take
        counts = torch.zeros(p, dtype=_I64, device=dev).scatter_add_(
            0, worker[::B].to(_I64),
            torch.ones(-(-plan.n_tiles // B), dtype=_I64, device=dev))
        n_steps = max(int(counts.max().item()), 1)  # the one scalar sync
    block_perm, rowid, blkid, flat_cost = _shard_layout(
        worker, item_id, slot_cost, p=p, superstep=B, n_steps=int(n_steps))
    return DeviceLowering(
        schedule=DeviceSchedule(item_id, seg_start, seg_len, plan.width,
                                plan.n_items),
        tile_cost=tile_cost, worker=worker, block_perm=block_perm,
        rowid=rowid, blkid=blkid, slot_cost=flat_cost, superstep=B)
