"""iCh schedule construction: the paper's band heuristic as a tiling layer.

The port's copy of the numpy construction in `repro.core.tiling`, cut to
what the kernel paths and the simulator need. Given per-item work sizes
(nnz per CSR row) it

1. picks a tile width W with the paper's variance band (eqs. 1-3, 8):
   W = pow2-roundup of mu * (1 + eps) (`ich_tile_width`);
2. splits items wider than W into W-sized segments (`split_items`), the
   work-stealing analogue: a heavy item's overflow migrates to later tiles;
3. packs segments, in order, into fixed-shape tiles of R segment slots
   (`build_schedule`), yielding a `TileSchedule` whose `item_id` array is
   the schedule the kernels walk.

`pack_csr` packs the CSR payload into the flat (T_pad, R, W) layout, and
the sharding layer (`partition_tiles`, `make_shards`, `shard_schedule`)
LPT-assigns item-closed chains of superstep blocks to p workers and lays
the result out as the (p, S_B) block permutation whose blocks the sharded
kernel reads straight out of the flat payload: lowering moves no payload
bytes. `shards_from_block_perm` lays an explicit, possibly partial block
layout out the same way. `TileSchedule.slot_ranges` / `unit_costs` give
the schedule as the simulator's pretiled chunk list, and
`coverage_counts` checks that it covers every work unit once. Host
construction stays numpy; the outputs must be element-identical
to the reference's (tests/test_torch_tiling.py). The loop formulations are
kept as `_reference_*` oracles.
"""
from __future__ import annotations

import dataclasses
import heapq
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from repro_torch.sched.defaults import ICH_EPS, SUPERSTEP

# ---------------------------------------------------------------------------
# Construction workspace: schedule construction is a per-request operation in
# a serving path, so its temporaries (a few MB per million items) are reused
# across calls instead of being re-allocated (and re-page-faulted) every
# time. Only scratch lives here — every array handed back to a caller is
# freshly allocated. Guarded by a lock: construction is thread-safe, calls
# just serialize over the scratch. The helper pool overlaps the two
# independent gather passes on a second core (NumPy's take/repeat release
# the GIL).
# ---------------------------------------------------------------------------
_WS: dict[str, np.ndarray] = {}
_WS_LOCK = threading.Lock()
_POOL = ThreadPoolExecutor(max_workers=1,
                           thread_name_prefix="tiling-gather")


def _ws(name: str, n: int, dtype) -> np.ndarray:
    """A reusable scratch vector of at least n elements (prefix view)."""
    buf = _WS.get(name)
    if buf is None or buf.size < n or buf.dtype != np.dtype(dtype):
        grow = 0 if buf is None else buf.size * 2
        buf = np.empty(max(n, grow, 1024), dtype)
        _WS[name] = buf
    return buf[:n]


def _ws_iota(n: int, dtype=np.int32) -> np.ndarray:
    """Persistent [0, 1, 2, ...] prefix (never recomputed), one per dtype —
    callers indexing past 2**31 units must ask for the int64 variant (an
    int32 arange would silently wrap)."""
    key = f"iota_{np.dtype(dtype).name}"
    buf = _WS.get(key)
    if buf is None or buf.size < n:
        grow = 0 if buf is None else buf.size * 2
        buf = np.arange(max(n, grow, 1024), dtype=dtype)
        _WS[key] = buf
    return buf[:n]


def ich_tile_width(sizes: np.ndarray, eps: float = ICH_EPS,
                   min_w: int = 8, max_w: int = 512) -> int:
    """Pick the tile width with the paper's band (eqs. 1-3, 8).

    W = the band's UPPER edge mu*(1+eps), rounded up to a power of two:
    every "normal"-classified item (within mu +- eps*mu) fits in one segment;
    only "high" items split across tiles — the work-stealing analogue (their
    overflow migrates to later tiles).
    """
    sizes = np.asarray(sizes)
    mu = float(np.mean(sizes)) if sizes.size else 0.0
    upper = mu * (1.0 + eps)
    w = 2 ** int(np.ceil(np.log2(max(upper, 1.0))))
    return int(min(max(w, min_w), max_w))


def split_items(
        sizes: np.ndarray, width: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Cut items into width-W segments: (item, start_in_item, length) arrays.

    Segments are emitted in item order; a zero-size item still emits one
    zero-length segment so every item owns at least one slot (kernels rely on
    this to e.g. zero an empty CSR row's output).

    Vectorized: item i emits max(ceil(sizes[i]/W), 1) segments, so the
    segment->item map is one `repeat` of iota; every other per-segment
    stream is a `take` through that map (a segment's rank within its item is
    its global rank minus its item's exclusive-prefix segment count, one
    `cumsum`), and start/length follow with in-place int32 arithmetic.
    Per-item sizes and the total segment count must fit int32 (a single item
    is bounded at 2**31-1 work units). `_reference_split_items` is the loop
    oracle.
    """
    if int(width) <= 0:
        raise ValueError(f"tile width must be positive, got {width}")
    if np.asarray(sizes).size == 0:
        empty = np.empty(0, np.int32)
        return empty, empty.copy(), empty.copy()
    item, start, length, _ = _split_segments(sizes, width, 1)
    return item, start, length


def _split_segments(
        sizes: np.ndarray, width: int, round_to: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """Segment streams padded to a multiple of `round_to` slots.

    Returns (item, start, length, n_segs): the first n_segs entries are real
    segments in item order, the (< round_to) tail is padding with item -1
    and start/length 0 — exactly the slot layout `build_schedule` reshapes
    to (T, R). The returned arrays are caller-owned; only scratch comes from
    the shared workspace (see the module comment on `_WS`).
    """
    sizes_arr = np.asarray(sizes)
    if sizes_arr.size and \
            int(sizes_arr.max()) > np.iinfo(np.int32).max - max(int(width), 1):
        raise ValueError("per-item sizes must fit int32; largest item is "
                         f"{int(sizes_arr.max())} work units")
    s32 = sizes_arr.astype(np.int32, copy=False)
    w = np.int32(width)
    n = s32.size
    with _WS_LOCK:
        n_segs = _ws("n_segs", n, np.int32)
        np.add(s32, np.int32(width - 1), out=n_segs)
        np.floor_divide(n_segs, w, out=n_segs)
        np.maximum(n_segs, np.int32(1), out=n_segs)
        total = int(n_segs.sum(dtype=np.int64))
        if total > np.iinfo(np.int32).max:
            raise ValueError(f"schedule would need {total} segments, which "
                             "exceeds the int32 construction bound")
        cum = _ws("cum", n, np.int32)
        np.cumsum(n_segs, out=cum)
        padded = -(-max(total, 1) // round_to) * round_to
        first = _ws("first", n, np.int32)
        np.subtract(cum, n_segs, out=first)  # exclusive-prefix seg counts
        item = np.repeat(_ws_iota(n), n_segs)
        start = np.empty(padded, np.int32)
        length = np.empty(padded, np.int32)
        # the two gathers through `item` are independent: run one on the
        # helper thread while this thread does the other (below the
        # threshold the pool handoff costs more than it overlaps)
        first_rep = _ws("first_rep", total, np.int32)
        fut = (_POOL.submit(np.take, first, item, out=first_rep, mode="clip")
               if total >= 65_536 else
               np.take(first, item, out=first_rep, mode="clip"))
        np.take(s32, item, out=length[:total], mode="clip")
        if fut is not first_rep:
            fut.result()
        np.subtract(_ws_iota(total), first_rep, out=start[:total])
        np.multiply(start[:total], w, out=start[:total])
        # length = clip(size - start, 0, W)
        np.subtract(length[:total], start[:total], out=length[:total])
        np.clip(length[:total], 0, w, out=length[:total])
    item.resize(padded, refcheck=False)  # zero-fills the (< round_to) tail
    item[total:] = -1
    start[total:] = 0
    length[total:] = 0
    return item, start, length, total


def _reference_split_items(sizes: np.ndarray,
                           width: int) -> list[tuple[int, int, int]]:
    """Loop oracle for `split_items` (one tuple per segment, same order)."""
    if int(width) <= 0:
        raise ValueError(f"tile width must be positive, got {width}")
    segs: list[tuple[int, int, int]] = []
    for i, size in enumerate(np.asarray(sizes)):
        size = int(size)
        for s in range(0, max(size, 1), width):
            segs.append((i, s, min(width, size - s) if size else 0))
    return segs


@dataclasses.dataclass(frozen=True)
class TileSchedule:
    """An iCh-constructed static schedule: T tiles x R segment slots.

    `item_id[t, j]` is the item whose segment occupies slot (t, j), or -1 for
    a padding slot; `seg_start`/`seg_len` locate the segment within the item
    (in work units: nonzeros, edges, cost quanta). `item_id` is the
    scatter schedule a kernel walks.
    """

    item_id: np.ndarray    # (T, R) int32, -1 = padding slot
    seg_start: np.ndarray  # (T, R) int32
    seg_len: np.ndarray    # (T, R) int32
    width: int             # W: work-unit capacity of one slot
    n_items: int

    @property
    def n_tiles(self) -> int:
        return int(self.item_id.shape[0])

    @property
    def rows_per_tile(self) -> int:
        return int(self.item_id.shape[1])

    def tile_work(self) -> np.ndarray:
        """Work units (e.g. nonzeros) packed into each tile, shape (T,)."""
        return self.seg_len.sum(axis=1).astype(np.int64)

    def slot_cost(self, costs: np.ndarray, sizes: np.ndarray) -> np.ndarray:
        """Per-SLOT cost decomposition, shape (T, R): item i's cost spread
        evenly over its `sizes[i]` work units, times the units each slot
        holds (padding slots and zero-size items are 0). Rows sum to
        `tile_cost`; this is the granularity the sharded kernels' cost
        output accounts at and the measured-cost refiner distributes
        tile-level observations with (`sched/adaptive.py`)."""
        costs = np.asarray(costs, np.float64)
        sizes = np.asarray(sizes, np.float64)
        unit = np.divide(costs, sizes, out=np.zeros_like(costs),
                         where=sizes > 0)
        per_slot = np.where(self.item_id >= 0,
                            unit[np.clip(self.item_id, 0, self.n_items - 1)],
                            0.0)
        return per_slot * self.seg_len

    def tile_cost(self, costs: np.ndarray, sizes: np.ndarray) -> np.ndarray:
        """Per-tile cost when item i's cost is spread evenly over its
        `sizes[i]` work units (zero-size items carry no units)."""
        return self.slot_cost(costs, sizes).sum(axis=1)

    def slot_ranges(self) -> np.ndarray:
        """(T, 2) [begin, end) chunks in flattened work-unit space.

        Greedy packing keeps segments in item order, so each tile covers a
        contiguous run of work units — i.e. the schedule IS a pretiled
        central-queue chunking, directly consumable by
        `simulate(unit_costs, p, policies.pretiled(ranges))`.
        """
        cum = np.concatenate([[0], np.cumsum(self.seg_len.reshape(-1))])
        bounds = cum[::self.rows_per_tile]  # len T*R+1 strided by R -> T+1
        return np.stack([bounds[:-1], bounds[1:]], axis=1).astype(np.int64)

    def unit_costs(self, costs: np.ndarray, sizes: np.ndarray) -> np.ndarray:
        """Expand per-item costs to the flattened work-unit cost array that
        `slot_ranges` indexes into (item i -> sizes[i] units of equal cost)."""
        costs = np.asarray(costs, np.float64)
        sizes = np.asarray(sizes, np.int64)
        unit = np.divide(costs, sizes, out=np.zeros_like(costs),
                         where=sizes > 0)
        return np.repeat(unit, sizes)



# ---------------------------------------------------------------------------
# Worker sharding: lower the schedule's parallelism p onto the card. Tiles
# are partitioned across p workers by tile cost and each worker's shard is
# walked by one CTA of the sharded kernel, so tiles run concurrently across
# SMs instead of serially in one walk.
# ---------------------------------------------------------------------------

def tile_spans(item_id: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(first_item, last_item) per tile, -1 for all-padding tiles.

    Greedy packing emits segments in item order, so within a tile the item
    ids are nondecreasing with any -1 padding confined to the tail — the
    first real item is slot 0 and the last is the row max.
    """
    first = item_id[:, 0].astype(np.int32)
    last = item_id.max(axis=1).astype(np.int32)
    return first, last


def block_chains(item_id: np.ndarray, block: int = 1) -> np.ndarray:
    """(n_blocks,) chain id per `block`-tile superstep block: consecutive
    blocks share a chain exactly when an item has segments on both sides of
    their boundary (the cut is not item-closed). This is the merge step of
    `partition_tiles`: a chain is the smallest unit that can move between
    workers without breaking the one-worker-per-item fold order."""
    T = int(item_id.shape[0])
    blk = int(block)
    if blk < 1:
        raise ValueError(f"block must be positive, got {block}")
    if T == 0:
        return np.empty(0, np.int64)
    first, last = tile_spans(item_id)
    # cut between tiles t-1 and t is item-closed unless an item spans it
    spans = (last[:-1] == first[1:]) & (first[1:] >= 0) & (last[:-1] >= 0)
    if blk == 1:
        merge = spans
    else:
        # block boundaries sit at tiles blk, 2*blk, ...: blocks b-1 and b
        # merge when the tile-level cut there is not item-closed
        merge = spans[blk - 1:T - 1:blk]
    return np.concatenate([[0], np.cumsum(~merge)]).astype(np.int64)


def partition_tiles(tile_cost: np.ndarray, item_id: np.ndarray,
                    p: int, block: int = 1) -> np.ndarray:
    """Cost-balanced (LPT) tile -> worker map, shape (T,) int32.

    Tiles are grouped at `block` granularity (`block` = the kernel
    superstep B, so a worker's shard is a list of whole B-tile blocks the
    sharded kernel reads straight out of the FLAT payload — no payload
    reorder). Blocks are further merged into *item-closed chains*: a chain
    boundary is only allowed where no item has segments on both sides
    (split items span contiguous tile runs, so the check is last-item !=
    first-item across the cut). Chains are then assigned to workers by LPT
    (heaviest chain to the least-loaded worker), which is BinLPT's
    placement rule applied to iCh-constructed tiles.

    Keeping every item's tiles on ONE worker is what makes the sharded
    kernel bit-identical to the sequential one: each output row is
    accumulated by exactly one worker, in ascending tile order (the same
    fold order the sequential walk uses), so the sharded kernel can write
    rows straight into one output with no race and no atomics.
    """
    tile_cost = np.asarray(tile_cost, np.float64)
    T = int(tile_cost.size)
    p, blk = int(p), int(block)
    if p < 1:
        raise ValueError(f"worker count must be positive, got {p}")
    if blk < 1:
        raise ValueError(f"block must be positive, got {block}")
    if T == 0:
        return np.empty(0, np.int32)
    if p == 1:
        return np.zeros(T, np.int32)
    n_blocks = -(-T // blk)
    chain = block_chains(item_id, blk)
    n_chains = int(chain[-1]) + 1
    bcost = tile_cost
    if blk > 1:
        bcost = np.bincount(np.arange(T) // blk, weights=tile_cost,
                            minlength=n_blocks)
    ccost = np.bincount(chain, weights=bcost, minlength=n_chains)
    order = np.argsort(-ccost, kind="stable")
    heap = [(0.0, w) for w in range(p)]
    chain_worker = np.empty(n_chains, np.int32)
    for c in order:
        load, w = heapq.heappop(heap)
        chain_worker[c] = w
        heapq.heappush(heap, (load + float(ccost[c]), w))
    block_worker = chain_worker[chain]
    return np.repeat(block_worker, blk)[:T]


@dataclasses.dataclass(frozen=True)
class WorkerShards:
    """A tile -> worker partition lowered to a padded (p, S_B) BLOCK layout.

    `worker[t]` is tile t's worker (constant within each superstep block);
    `block_perm[w, s]` is the B-tile block worker w executes at step s
    (-1 = padding step), each worker's blocks in ascending order — block
    b covers tiles [b*B, (b+1)*B). Because blocks are contiguous runs of
    the FLAT tile sequence, the sharded kernel reads them directly from the
    flat (T_pad, R, W) payload through a block-index stream
    (`kernel_block_ids`) — lowering to the shard layout moves NO payload
    bytes. `perm` is the tile-granular expansion (p, S_B*B) used for the
    sharded item-id schedule and for tests.
    """

    worker: np.ndarray      # (T,) int32 tile -> worker
    block_perm: np.ndarray  # (p, S_B) int32 block index, -1 = padding
    superstep: int          # tiles per block / kernel step (B)

    @property
    def p(self) -> int:
        return int(self.block_perm.shape[0])

    @property
    def n_steps(self) -> int:
        """S_B: kernel steps per worker (blocks, incl. padding)."""
        return int(self.block_perm.shape[1])

    @property
    def tiles_per_worker(self) -> int:
        """S = S_B * B: tile slots per worker's shard (incl. padding)."""
        return self.n_steps * self.superstep

    @property
    def n_tiles_padded(self) -> int:
        """Flat tile count rounded up to whole blocks — the first axis the
        kernels' payload must have (`pack_csr(..., pad_tiles_to=B)`)."""
        T = int(self.worker.size)
        return -(-T // self.superstep) * self.superstep

    @property
    def perm(self) -> np.ndarray:
        """Tile-granular shard layout (p, S): tile at worker w's slot s,
        -1 padding (block_perm expanded; the last real block's tail past T
        is padding)."""
        B = self.superstep
        T = int(self.worker.size)
        tiles = (self.block_perm[:, :, None] * B
                 + np.arange(B, dtype=np.int32)[None, None, :])
        tiles = np.where((self.block_perm[:, :, None] >= 0) & (tiles < T),
                         tiles, -1)
        return tiles.reshape(self.p, -1).astype(np.int32)

    def kernel_block_ids(self) -> np.ndarray:
        """(p*S_B,) int32 block-index stream the sharded kernel reads
        its blocks through, padding steps clamped to block 0 (their item
        ids are -1, so that block is never applied)."""
        return np.maximum(self.block_perm, 0).reshape(-1)

    def worker_cost(self, tile_cost: np.ndarray) -> np.ndarray:
        """Per-worker assigned cost, shape (p,) — what the sharded
        kernel's per-worker cost stream must sum to. Tiles with worker -1
        carry no cost."""
        tile_cost = np.asarray(tile_cost, np.float64)
        live = self.worker >= 0
        return np.bincount(self.worker[live], weights=tile_cost[live],
                           minlength=self.p)

    def shard_item_id(self, item_id: np.ndarray) -> np.ndarray:
        """The (p*S, R) row schedule for the sharded kernel: tile
        perm[w, s]'s item ids (from the (T, R) `item_id`) at row w*S + s,
        -1 rows on padding. Takes the item-id array rather than the whole
        `TileSchedule`, so a lowering handed over without its segment
        arrays (`repro_torch.convert`) lays out the same way."""
        item_id = np.asarray(item_id)
        flat = self.perm.reshape(-1)
        if item_id.shape[0] == 0:  # 0-tile schedule: every row is padding
            return np.full((flat.size, item_id.shape[1]), -1, np.int32)
        out = np.where((flat >= 0)[:, None],
                       item_id[np.clip(flat, 0, None)],
                       np.int32(-1))
        return np.ascontiguousarray(out, np.int32)


def make_shards(worker: np.ndarray, p: int,
                superstep: int = SUPERSTEP) -> WorkerShards:
    """Lay a (block-aligned) tile -> worker map out as the shard layout."""
    worker = np.asarray(worker, np.int32)
    p, B = int(p), int(superstep)
    if B < 1:
        raise ValueError(f"superstep must be positive, got {superstep}")
    if worker.size and not (0 <= int(worker.min())
                            and int(worker.max()) < p):
        raise ValueError(f"worker ids must lie in [0, {p}), got "
                         f"[{int(worker.min())}, {int(worker.max())}]")
    T = worker.size
    n_blocks = -(-T // B)
    block_worker = worker[::B]
    if not np.array_equal(np.repeat(block_worker, B)[:T], worker):
        raise ValueError("worker map is not constant within superstep "
                         f"blocks of {B} tiles; partition with "
                         f"partition_tiles(..., block={B})")
    counts = np.bincount(block_worker, minlength=p)
    S_B = max(int(counts.max(initial=0)), 1)
    block_perm = np.full((p, S_B), -1, np.int32)
    order = np.argsort(block_worker, kind="stable")  # ascending per worker
    w_sorted = block_worker[order]
    pos = np.arange(order.size) - np.searchsorted(w_sorted, w_sorted)
    block_perm[w_sorted, pos] = order.astype(np.int32)
    return WorkerShards(worker=worker, block_perm=block_perm, superstep=B)

def shards_from_block_perm(block_perm: np.ndarray, n_tiles: int,
                           superstep: int = SUPERSTEP) -> WorkerShards:
    """A `WorkerShards` over an EXPLICIT (p, S_B) block layout that may
    cover only a subset of the blocks — how recovery runs the standard
    sharded kernels over partial block sets (the completed prefix of an
    interrupted run, or the survivor re-execution layout). Tiles of
    unlisted blocks get worker -1 ("not executed in this layout"); padding
    steps stay -1 as usual. Listed block ids must be in range and
    pairwise distinct."""
    bp = np.ascontiguousarray(block_perm, np.int32)
    if bp.ndim != 2:
        raise ValueError(f"block_perm must be 2-D (p, S_B), got {bp.shape}")
    T, B = int(n_tiles), int(superstep)
    if B < 1:
        raise ValueError(f"superstep must be positive, got {superstep}")
    n_blocks = -(-T // B)
    flat = bp.reshape(-1)
    sel = flat >= 0
    ids = flat[sel]
    if ids.size and (int(ids.max()) >= n_blocks):
        raise ValueError(f"block id {int(ids.max())} out of range for "
                         f"{n_blocks} blocks of {B} tiles")
    if np.unique(ids).size != ids.size:
        raise ValueError("block_perm lists a block more than once")
    w_of_block = np.full(n_blocks, -1, np.int32)
    rows = np.repeat(np.arange(bp.shape[0], dtype=np.int32), bp.shape[1])
    w_of_block[ids] = rows[sel]
    worker = np.repeat(w_of_block, B)[:T]
    return WorkerShards(worker=worker, block_perm=bp, superstep=B)


def shard_schedule(schedule: TileSchedule, tile_cost: np.ndarray, p: int,
                   superstep: int = SUPERSTEP) -> WorkerShards:
    """Partition tiles by cost (at superstep-block granularity) and lower
    to the zero-copy shard layout."""
    worker = partition_tiles(tile_cost, schedule.item_id, p,
                             block=superstep)
    return make_shards(worker, p, superstep)


def _check_width(width: int | None) -> int | None:
    if width is not None and int(width) <= 0:
        raise ValueError(f"explicit tile width must be positive, got {width}")
    return None if width is None else int(width)


def build_schedule(sizes: np.ndarray, *, rows_per_tile: int = 8,
                   width: int | None = None, eps: float = ICH_EPS,
                   min_w: int = 8, max_w: int = 512) -> TileSchedule:
    """Band -> W -> segments -> greedy packing into (T, R) slots.

    Packing is a reshape: segments are already in pack order, so tile t's
    slots are segments [t*R, (t+1)*R) and the only real work is padding the
    segment axis out to T*R. `_reference_build_schedule` is the loop oracle.

    An EMPTY sizes array yields a valid 0-tile schedule (width from the
    band's floor): a zero-item workload schedules as a no-op — sharding
    and kernel lowering degenerate cleanly and the op launches nothing.
    """
    sizes = np.asarray(sizes)
    width = _check_width(width)
    W = width if width else ich_tile_width(sizes, eps, min_w, max_w)
    R = int(rows_per_tile)
    if sizes.size == 0:
        empty = np.zeros((0, R), np.int32)
        return TileSchedule(empty, empty.copy(), empty.copy(), W, 0)
    item_id, seg_start, seg_len, _ = _split_segments(sizes, W, R)
    T = item_id.size // R
    return TileSchedule(item_id.reshape(T, R), seg_start.reshape(T, R),
                        seg_len.reshape(T, R), W, len(sizes))


def _reference_build_schedule(sizes: np.ndarray, *, rows_per_tile: int = 8,
                              width: int | None = None, eps: float = ICH_EPS,
                              min_w: int = 8,
                              max_w: int = 512) -> TileSchedule:
    """Loop oracle for `build_schedule` (per-segment placement loop)."""
    sizes = np.asarray(sizes)
    width = _check_width(width)
    W = width if width else ich_tile_width(sizes, eps, min_w, max_w)
    R = int(rows_per_tile)
    segs = _reference_split_items(sizes, W)
    T = -(-len(segs) // R)
    item_id = np.full((T, R), -1, np.int32)
    seg_start = np.zeros((T, R), np.int32)
    seg_len = np.zeros((T, R), np.int32)
    for i, (item, s, ln) in enumerate(segs):
        t, j = divmod(i, R)
        item_id[t, j] = item
        seg_start[t, j] = s
        seg_len[t, j] = ln
    return TileSchedule(item_id, seg_start, seg_len, W, len(sizes))


def pack_csr(indptr: np.ndarray, indices: np.ndarray, data: np.ndarray,
             schedule: TileSchedule, *,
             pad_tiles_to: int = 1) -> tuple[np.ndarray, np.ndarray]:
    """Gather CSR payloads into the schedule's (T, R, W) layout.

    Returns (vals, cols); padding slots/tails are zero, so sum-reductions
    over W need no masking. `pad_tiles_to` rounds the tile axis
    up to a multiple (all-zero pad tiles) — the worker-sharded kernel
    reads whole supersteps of B tiles straight out of this FLAT array
    (`WorkerShards.kernel_block_ids`), so they need T padded to B; the
    pad tiles cost nothing beyond their zero pages.

    Fast path (canonical CSR, schedule built from its row lengths): slots
    in flat tile order name the work units in exactly CSR order (items
    ascending, seg_start ascending within an item, coverage exactly once),
    so the whole packing is a ragged-to-padded reshape of the SEQUENTIAL
    payload stream — `out[lane < seg_len] = payload` — with no index
    streams at all. Inputs that break the sequential-stream precondition
    (indptr not starting at 0, schedule total != nnz) fall back to a
    rectangular per-slot gather (indptr[item] + seg_start + [0, W) per
    slot, masked past seg_len). Either way the two payload chains (vals,
    cols) overlap on the helper thread and index/mask scratch is reused
    across calls through the construction workspace.
    `_reference_pack_csr` is the loop oracle.
    """
    indices = np.asarray(indices)
    data = np.asarray(data)
    R, W = schedule.rows_per_tile, schedule.width
    T = schedule.n_tiles
    if int(pad_tiles_to) < 1:
        raise ValueError(f"pad_tiles_to must be positive, got {pad_tiles_to}")
    T_pad = -(-T // int(pad_tiles_to)) * int(pad_tiles_to)
    length = schedule.seg_len.reshape(-1)
    if data.size == 0:  # no payload at all: every slot is padding
        return (np.zeros((T_pad, R, W), data.dtype),
                np.zeros((T_pad, R, W), np.int32))
    if indices.dtype != np.int32:
        indices = indices.astype(np.int32)
    with _WS_LOCK:
        sequential = (int(indptr[0]) == 0
                      and int(length.sum(dtype=np.int64)) == data.size)
        lane = _ws_iota(W)
        if sequential:
            # mask[k, l] = lane l of slot k is a real unit; True positions
            # in C-order are exactly the CSR payload stream, in order
            # (pad tiles' rows stay all-False -> calloc zeros untouched)
            mask = _ws("pk_mask", T * R * W, np.bool_).reshape(T * R, W)
            np.less(lane[None, :], length[:, None], out=mask)

            def _chain(payload):
                out = np.zeros((T_pad * R, W), payload.dtype)  # calloc
                out[:T * R][mask] = payload
                return out
        else:
            n_slots = T * R
            dt = (np.int32 if max(n_slots * W, int(indptr[-1]) + W) < 2 ** 31
                  else np.int64)
            # per-slot CSR base: indptr[item] + seg_start (padding slots
            # have len 0, so their wrapped base is never kept)
            base = _ws("pk_base", n_slots, dt)
            np.take(np.asarray(indptr).astype(dt, copy=False),
                    schedule.item_id.reshape(-1), out=base, mode="wrap")
            base += schedule.seg_start.reshape(-1)
            src = _ws("pk_src", n_slots * W, dt).reshape(n_slots, W)
            np.add(base[:, None], _ws_iota(W, dt)[None, :], out=src)
            pad = _ws("pk_pad", n_slots * W, np.bool_).reshape(n_slots, W)
            np.greater_equal(lane[None, :], length[:, None], out=pad)

            def _chain(payload):
                out = np.zeros((T_pad * R, W), payload.dtype)
                np.take(payload, src, out=out[:n_slots], mode="clip")
                np.copyto(out[:n_slots], 0, where=pad)
                return out

        fut = (_POOL.submit(_chain, data)
               if T_pad * R * W >= 65_536 else None)
        vals = _chain(data) if fut is None else None
        cols = _chain(indices)
        if fut is not None:
            vals = fut.result()
    return (vals.reshape(T_pad, R, W), cols.reshape(T_pad, R, W))


def _reference_pack_csr(indptr: np.ndarray, indices: np.ndarray,
                        data: np.ndarray,
                        schedule: TileSchedule) -> tuple[np.ndarray,
                                                         np.ndarray]:
    """Loop oracle for `pack_csr` (per-slot copy loop)."""
    T, R, W = schedule.n_tiles, schedule.rows_per_tile, schedule.width
    vals = np.zeros((T, R, W), np.asarray(data).dtype)
    cols = np.zeros((T, R, W), np.int32)
    for t in range(T):
        for j in range(R):
            item, s, ln = (int(schedule.item_id[t, j]),
                           int(schedule.seg_start[t, j]),
                           int(schedule.seg_len[t, j]))
            if item >= 0 and ln > 0:
                base = int(indptr[item]) + s
                vals[t, j, :ln] = data[base:base + ln]
                cols[t, j, :ln] = indices[base:base + ln]
    return vals, cols


def _unit_coords(schedule: TileSchedule) -> tuple[np.ndarray, np.ndarray]:
    """De-flatten the schedule to work-unit granularity: (slot, pos) where
    `slot` is the flat (t*R + j) slot owning each unit and `pos` the unit's
    rank within its segment. One `repeat` + one `cumsum`. Used by
    `coverage_counts`."""
    seg_len = schedule.seg_len.reshape(-1).astype(np.int64)
    slot = np.repeat(np.arange(seg_len.size, dtype=np.int64), seg_len)
    first = np.repeat(np.cumsum(seg_len) - seg_len, seg_len)
    pos = np.arange(int(seg_len.sum()), dtype=np.int64) - first
    return slot, pos


def coverage_counts(schedule: TileSchedule, sizes: np.ndarray) -> np.ndarray:
    """How many times each item's work units appear in the schedule; a valid
    schedule covers every unit exactly once.

    Vectorized: each scheduled unit's global position is
    offsets[item] + seg_start + pos; the histogram is one `bincount`."""
    sizes = np.asarray(sizes, np.int64)
    offsets = np.concatenate([[0], np.cumsum(sizes)])
    total = int(offsets[-1])
    item_f = schedule.item_id.reshape(-1).astype(np.int64)
    start_f = schedule.seg_start.reshape(-1).astype(np.int64)
    slot, pos = _unit_coords(schedule)
    where = offsets[item_f[slot]] + start_f[slot] + pos
    return np.bincount(where, minlength=total).astype(np.int64)
