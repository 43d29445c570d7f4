// The worker-sharded walk of the iCh kernels for Hopper (sm_90a): the
// counterpart of the (p, S_B) grids of src/repro/kernels/ich_spmv/ich_spmv.py
// (`ich_spmv_sharded`, an add fold: ich_spmv.cu) and
// src/repro/kernels/ich_bfs/ich_bfs.py (`ich_bfs_step_sharded`, a max fold:
// ich_bfs.cu), with core/pipelining.py's fetch_double_buffered as rings of
// asynchronous copies.
//
// The schedule gives worker w the S_B supersteps w*S_B .. w*S_B + S_B - 1;
// step j runs the B tiles of block blkid[w*S_B + j] out of the FLAT
// (T_pad, R, W) payload, with their row ids in the shard layout (p*S, R)
// (-1 = padding slot). A kernel computes one value per slot, a left fold
// over its W lanes in ascending w from 0.0f, and folds the slot values of
// each row into y in tile order: the row's slots of one tile first
// (Fold::within, ascending slot order), then the per-tile values, tiles
// ascending (Fold::across). The iCh shard is item-closed (every row lies
// in one worker) and a worker's blocks ascend, so a row's slots are one
// contiguous run of its worker's stream.
//
// The unit the schedule balances is the worker, so the walk keeps ONE CTA
// PER WORKER (gridDim.x == p), and makes that CTA fill an SM:
//   * Windows. The worker's S_B*B tiles are cut into windows of U whole
//     tiles (whole steps, or a divisor of B when a step is wider than a
//     stage: one step of B = R = 8 at W = 32). A window's lanes come in
//     one chunk, or, when one tile does not fit a stage, in chunks of
//     whole slots, or of pieces of one slot: every W is taken.
//   * Pipelines. The CTA's kGroups pipelines of kGroupThreads threads take
//     the windows in turn (pipeline g: windows g, g + kGroups, ...), each
//     with its own ring of kStages shared-memory stages and its own named
//     barrier, so one pipeline's barrier waits and gathers overlap the
//     others' work, as separate CTAs would on the flat walk.
//   * Rings. A pipeline's warp 0 issues each of its chunks kStages - 1
//     chunks ahead: lane g copies the chunk's g-th contiguous piece of vals
//     and cols with cp.async.bulk (completion on the stage's mbarrier,
//     evict-first in L2) when W and R are multiples of 4 and the pointers
//     16-byte aligned, else the pipeline's threads copy 4-byte cp.async
//     granules; lane 0 also copies the window's row ids. The block ids of a
//     chunk are read one chunk earlier still, into a register. A padding
//     step (blkid clamped to 0 at step j > 0: a worker's real blocks come
//     first, ascending) fetches no payload.
//   * Lanes, slots, runs (the flat walk's phase A, then its phase B inside
//     the CTA). A pipeline's threads evaluate a chunk's lanes into an
//     odd-stride table (the stage is then free for the next fetch); one
//     thread per slot continues that slot's fold over the chunk's lanes;
//     at the window's end the thread at each run head folds the run with
//     segmented.cuh's fold_run and writes y[row] once.
//   * The carry. Only two runs of a window depend on other windows: the
//     run reaching the window's end is handed on (row and value, through
//     a `Link` in shared memory) to window i + 1, and the run at slot 0
//     goes on from the run window i - 1 handed over, or, if its row
//     differs, writes that one. Warp 0 of window i's pipeline takes the
//     hand-over before its second barrier, so window i hands its own on
//     only after taking window i - 1's: the links are reused safely, and
//     every row sees the same IEEE operations in the same order as in the
//     flat walk, with no atomics and y never read.
//   * Cost stream. Before the windows, one thread a step folds the step's
//     slot_cost over its live slots in slot order (masked_cost's order)
//     straight from global memory, while the rings fill.
//
// What bounds it: bytes (8*W a slot streamed once, plus rowid, slot_cost
// and the x gathers, which come mostly from L2). What the design does
// about that: up to kGroups*(kStages-1) chunks in flight per SM while
// kGroups pipelines gather and fold. On the H100 the gathers of x set the
// pace, as on the flat walk (PERF.md §7).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "flat_walk.cuh"
#include "segmented.cuh"

namespace ich {
namespace sharded {

constexpr int kGroups = 3;          // pipelines a CTA
constexpr int kGroupThreads = 256;  // threads a pipeline
constexpr int kThreads = kGroups * kGroupThreads;
constexpr int kStages = 3;          // ring stages a pipeline
constexpr int kMaxChunkLanes = 2048;
constexpr int kWindowSlots = 256;   // slots a window holds (at most)
constexpr int kMaxPieces = 32;      // contiguous pieces a chunk: one warp
constexpr int kRunAhead = 8;        // slots a run owner loads at a time
constexpr int kCostAhead = 16;      // slots a cost fold loads at a time
constexpr int kHeader = 672;        // mbarriers, carry links, block ids
constexpr int kMaxSmem = 232448;
constexpr int kErrSmem = -1;

static_assert(kGroupThreads % 32 == 0 && kThreads <= 1024, "CTA");

// The walk's geometry, computed on the host (make_plan) for one launch.
struct Plan {
  int S_B, B, R, W;
  int U;       // tiles a window
  int pt;      // tiles a payload piece: min(U, B)
  int cs;      // slots a chunk
  int cl;      // lanes of a slot a chunk holds (W, or the chunk's lanes)
  int q;       // chunks a slot (ceil(W / cl))
  int cpw;     // chunks a window
  int n_win;   // windows a worker
  int lanes_cap, slots_cap, tab_cap;   // multiples of 4
  int group_bytes;                     // shared memory of one pipeline
  int smem;
};

inline int round4(int64_t v) { return (int)((v + 3) / 4 * 4); }

// The geometry for chunks of at most C lanes; false if it needs more
// shared memory than a CTA has.
inline bool plan_for(int C, int S_B, int B, int R, int W, Plan* pl) {
  pl->S_B = S_B;
  pl->B = B;
  pl->R = R;
  pl->W = W;
  const int64_t tile_lanes = (int64_t)R * W;
  if (tile_lanes <= C) {                    // whole tiles a chunk
    int64_t ut = C / tile_lanes;
    if (ut > kWindowSlots / R) ut = kWindowSlots / R;
    if (ut < 1) ut = 1;
    if (ut >= B) {
      const int64_t g = ut / B < kMaxPieces ? ut / B : kMaxPieces;
      pl->U = (int)(g * B);
    } else {
      int u = (int)ut;
      while (B % u) --u;                    // a divisor of B
      pl->U = u;
    }
    pl->cs = pl->U * R;
    pl->cl = W;
    pl->q = 1;
    pl->cpw = 1;
  } else if (W <= C) {                      // whole slots a chunk
    pl->U = 1;
    pl->cs = C / W;
    pl->cl = W;
    pl->q = 1;
    pl->cpw = (R + pl->cs - 1) / pl->cs;
  } else {                                  // pieces of one slot
    pl->U = 1;
    pl->cs = 1;
    pl->cl = C;
    pl->q = (W + C - 1) / C;
    pl->cpw = R * pl->q;
  }
  pl->pt = pl->U < B ? pl->U : B;
  pl->n_win = (int)(((int64_t)S_B * B + pl->U - 1) / pl->U);
  pl->lanes_cap = round4((int64_t)pl->cs * pl->cl);
  pl->slots_cap = round4((int64_t)pl->U * R);
  pl->tab_cap = round4((int64_t)pl->cs * (pl->cl | 1));
  const int64_t group = 4 * ((int64_t)kStages * (2 * pl->lanes_cap +
                                                 pl->slots_cap) +
                             4 * (int64_t)pl->slots_cap + pl->tab_cap);
  const int64_t smem = kHeader + kGroups * group;
  if (smem > kMaxSmem) return false;
  pl->group_bytes = (int)group;
  pl->smem = (int)smem;
  return true;
}

// Returns 0, kErrSmem (R too large for a window in shared memory), or
// cudaErrorInvalidValue when a worker's stream passes 32-bit indices.
inline int make_plan(int S_B, int B, int R, int W, Plan* pl) {
  if ((int64_t)S_B * B >= INT32_MAX / 2) return (int)cudaErrorInvalidValue;
  for (int C = kMaxChunkLanes; C >= 32; C /= 2) {
    if (plan_for(C, S_B, B, R, W, pl)) {
      if ((int64_t)pl->n_win * pl->cpw >= INT32_MAX / 2) {
        return (int)cudaErrorInvalidValue;
      }
      return 0;
    }
  }
  return kErrSmem;
}

// One window's carry: the row whose run reached the window's end and its
// value there (-1: none), published once window `seq` has folded it.
struct Link {
  int row;
  float val;
  int seq;
};

static_assert(kGroups * kStages * 8 + kGroups * sizeof(Link) +
                  kGroups * 32 * 4 <= kHeader, "header");

__device__ inline void group_sync(int g) {
  __syncwarp();
  asm volatile("bar.sync %0, %1;" ::"r"(g + 1), "n"(kGroupThreads)
               : "memory");
}

// Op supplies the arithmetic of one kernel:
//   float lane(float a, int c) const            one lane's value
//   float step(float acc, const float* lanes, int n) const
//                                               the slot fold continued
//                                               over n lanes, ascending
//   float finish(float acc, int row) const      the slot's value
// Indices inside a worker's stream (tiles, chunks) are 32-bit (make_plan
// checks); offsets into the payload and the shard layout are 64-bit.
template <class Op, class Fold, bool kBulk>
__global__ void __launch_bounds__(kThreads, 1)
    sharded_walk(const float* __restrict__ a, const int* __restrict__ cols,
                 const int* __restrict__ rowid,
                 const int* __restrict__ blkid,
                 const float* __restrict__ slot_cost, Op op, float* y,
                 float* costs, Plan pl) {
  extern __shared__ __align__(16) unsigned char walk_smem[];
  const int tid = threadIdx.x;
  const int g = tid / kGroupThreads, gt = tid % kGroupThreads;
  const int gw = gt >> 5, lane = tid & 31;
  uint64_t* bar = reinterpret_cast<uint64_t*>(walk_smem) + g * kStages;
  Link* link = reinterpret_cast<Link*>(walk_smem + kGroups * kStages * 8);
  int* sblk = reinterpret_cast<int*>(walk_smem + kGroups * kStages * 8 +
                                     kGroups * sizeof(Link)) + g * 32;
  unsigned char* mine = walk_smem + kHeader + (size_t)g * pl.group_bytes;
  float* st_a = reinterpret_cast<float*>(mine);
  int* st_c = reinterpret_cast<int*>(st_a + kStages * pl.lanes_cap);
  int* st_rows = st_c + kStages * pl.lanes_cap;
  int* srows = st_rows + kStages * pl.slots_cap;          // 2 windows
  float* partials = reinterpret_cast<float*>(srows + 2 * pl.slots_cap);
  float* tab = partials + 2 * pl.slots_cap;

  const int w = blockIdx.x;
  const int B = pl.B, R = pl.R, W = pl.W, U = pl.U, pt = pl.pt;
  const int S = pl.S_B * B;                   // tiles a worker
  const int64_t blk0 = (int64_t)w * pl.S_B;   // the worker's block ids
  const int64_t row0 = (int64_t)w * S * R;    // the worker's row ids
  // this pipeline's windows: g, g + kGroups, ...; its chunks lc = 0, 1, ...
  const int my_win = pl.n_win > g ? (pl.n_win - g + kGroups - 1) / kGroups
                                  : 0;
  const int n_lc = my_win * pl.cpw;

  if (tid == 0) {
    if constexpr (kBulk) {
      uint64_t* all = reinterpret_cast<uint64_t*>(walk_smem);
      for (int s = 0; s < kGroups * kStages; ++s) flat::mbar_init(all + s, 1);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    for (int k = 0; k < kGroups; ++k) link[k] = Link{-1, 0.0f, -1};
  }
  __syncthreads();

  // local chunk lc: its window and the window's first tile
  auto window_of = [&](int lc) { return g + kGroups * (lc / pl.cpw); };
  // piece p of chunk lc: its first tile in the worker's stream; -1 past
  // the stream or the window's pieces
  auto piece_tile = [&](int lc, int p) -> int {
    if (lc >= n_lc || p * pt >= U) return -1;
    const int t0 = window_of(lc) * U + p * pt;
    return t0 < S ? t0 : -1;
  };
  // block id of piece p of chunk lc (0 when there is none)
  auto load_blk = [&](int lc, int p) -> int {
    const int t0 = piece_tile(lc, p);
    return t0 >= 0 ? __ldg(blkid + blk0 + t0 / B) : 0;
  };
  // a chunk's slot range [k0, k0 + ns) of its window (n slots) and lane
  // range [w0, w0 + wn) of each of those slots
  auto geometry = [&](int c, int n, int* k0, int* ns, int* w0, int* wn) {
    *k0 = (c / pl.q) * pl.cs;
    *ns = n - *k0 < pl.cs ? n - *k0 : pl.cs;
    *w0 = (c % pl.q) * pl.cl;
    *wn = W - *w0 < pl.cl ? W - *w0 : pl.cl;
  };
  // Visit every copy chunk lc needs: fn(dst, src, n_words). Piece p's
  // payload, and (p == 0, first chunk of a window) the window's row ids.
  auto copies = [&](int lc, int p, int blk, auto&& fn) {
    const int t0 = piece_tile(lc, p);
    if (t0 < 0) return;
    const int s = lc % kStages;
    const int i = window_of(lc), c = lc % pl.cpw;
    const int nt = S - i * U < U ? S - i * U : U;
    int k0, ns, w0, wn;
    geometry(c, nt * R, &k0, &ns, &w0, &wn);
    if (p == 0 && c == 0) {
      fn(st_rows + s * pl.slots_cap, rowid + row0 + (int64_t)i * U * R,
         nt * R);
    }
    if (t0 >= B && blk == 0) return;           // a padding step (j > 0)
    const int64_t slot0 = ((int64_t)blk * B + t0 % B) * R;
    const int pslots = pl.cpw == 1 ? pt * R : ns;
    const int64_t src = (slot0 + k0) * W + w0;
    const int dst = s * pl.lanes_cap + p * pslots * wn;
    fn(st_a + dst, a + src, pslots * wn);
    fn(st_c + dst, cols + src, pslots * wn);
  };
  // bring chunk lc into its stage: the pipeline's warp 0, one piece a
  // lane, bulk copies
  auto fetch_bulk = [&](int lc, int blk) {
    uint32_t bytes = 0;
    copies(lc, lane, blk, [&](void*, const void*, int n) { bytes += 4 * n; });
    const uint32_t total = __reduce_add_sync(0xffffffffu, bytes);
    if (lc >= n_lc) return;
    uint64_t* b = bar + lc % kStages;
    if (lane == 0) flat::mbar_expect_tx(b, total);
    __syncwarp();
    if (bytes == 0) return;
    // the generic-proxy reads of this stage are done (a barrier precedes
    // every fetch); order them before the async writes
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    const uint64_t policy = flat::evict_first_policy();
    copies(lc, lane, blk, [&](void* dst, const void* src, int n) {
      flat::bulk_load(dst, src, 4 * n, b, policy);
    });
  };
  // bring chunk lc into its stage: the pipeline's threads, 4-byte
  // granules; the block ids of its pieces are in sblk
  auto fetch_async = [&](int lc) {
    const int np = pl.cpw == 1 ? U / pt : 1;
    for (int p = 0; p < np; ++p) {
      copies(lc, p, sblk[p], [&](void* dst, const void* src, int n) {
        for (int e = gt; e < n; e += kGroupThreads) {
          flat::cp_async4(static_cast<int*>(dst) + e,
                          static_cast<const int*>(src) + e);
        }
      });
    }
    flat::cp_async_commit();   // one group per chunk, empty ones included
  };

  // ---- prologue: each pipeline's first kStages chunks, then the cost
  //      stream (a thread a step, its slots in order) while they load
  int pf = 0;   // warp 0, lane p: block of piece p of the next fetch
  for (int s = 0; s < kStages; ++s) {
    if (gw == 0) pf = load_blk(s, lane);
    if constexpr (kBulk) {
      if (gw == 0) fetch_bulk(s, pf);
    } else {
      if (gw == 0) sblk[lane] = pf;
      group_sync(g);
      fetch_async(s);
      group_sync(g);
    }
  }
  if (gw == 0) pf = load_blk(kStages, lane);
  if (costs != nullptr) {
    const int m = B * R;
    for (int j = tid; j < pl.S_B; j += kThreads) {
      const int blk = __ldg(blkid + blk0 + j);
      float acc = 0.0f;
      if (j == 0 || blk != 0) {   // a padding step's rows are all -1
        const int* r = rowid + row0 + (int64_t)j * m;
        const float* sc = slot_cost + (int64_t)blk * m;
        for (int k = 0; k < m; k += kCostAhead) {
          int rr[kCostAhead];
          float vv[kCostAhead];
#pragma unroll
          for (int u = 0; u < kCostAhead; ++u) {
            const int kk = k + u < m ? k + u : m - 1;
            rr[u] = __ldg(r + kk);
            vv[u] = __ldg(sc + kk);
          }
#pragma unroll
          for (int u = 0; u < kCostAhead; ++u) {
            if (k + u < m) acc = __fadd_rn(acc, rr[u] >= 0 ? vv[u] : 0.0f);
          }
        }
      }
      costs[blk0 + j] = acc;
    }
  }

  int c = 0;   // the chunk's place in its window
  for (int lc = 0; lc < n_lc; ++lc) {
    const int s = lc % kStages;
    const int i = window_of(lc);
    const int nt = S - i * U < U ? S - i * U : U;
    const int n = nt * R;
    // the window's rows and slot values, double-buffered by window so that
    // this window's copy and slot fold never meet the previous one's runs
    int* srow = srows + ((lc / pl.cpw) & 1) * pl.slots_cap;
    float* partial = partials + ((lc / pl.cpw) & 1) * pl.slots_cap;
    int k0, ns, w0, wn;
    geometry(c, n, &k0, &ns, &w0, &wn);
    if constexpr (kBulk) {
      flat::mbar_wait(bar + s, (uint32_t)(lc / kStages) & 1u);
    } else {
      flat::cp_async_wait<kStages - 1>();
      group_sync(g);
    }
    const int* rws = c == 0 ? st_rows + s * pl.slots_cap : srow;
    const float* ca = st_a + s * pl.lanes_cap;
    const int* cc = st_c + s * pl.lanes_cap;
    const int P = wn | 1;
    if (c == 0) {    // the window's rows outlive stage s
      for (int k = gt; k < n; k += kGroupThreads) srow[k] = rws[k];
    }
    // every lane of the chunk, one thread a lane (lanes of padding slots
    // are never read)
#pragma unroll 4
    for (int e = gt; e < ns * wn; e += kGroupThreads) {
      const int kk = e / wn;
      float v = 0.0f;
      if (rws[k0 + kk] >= 0) v = op.lane(ca[e], cc[e]);
      tab[kk * P + (e - kk * wn)] = v;
    }
    if (!kBulk && gw == 0) sblk[lane] = pf;
    group_sync(g);   // the lane table and rows are in place; stage s is free
    if constexpr (kBulk) {
      if (gw == 0) fetch_bulk(lc + kStages, pf);
    } else {
      fetch_async(lc + kStages);
    }
    if (gw == 0) pf = load_blk(lc + kStages + 1, lane);
    // every slot of the chunk, one thread a slot, w ascending
    for (int kk = gt; kk < ns; kk += kGroupThreads) {
      const int k = k0 + kk;
      const int row = srow[k];
      float acc = w0 == 0 ? 0.0f : partial[k];
      if (row >= 0) {
        acc = op.step(acc, tab + kk * P, wn);
        if (w0 + wn == W) acc = op.finish(acc, row);
      }
      partial[k] = row >= 0 ? acc : 0.0f;
    }
    const bool fold = c == pl.cpw - 1;
    // the run that reached the end of window i - 1 (folded by another
    // pipeline): warp 0 waits for it before the pipeline's barrier, so
    // window i hands its own run on only after taking this one
    Link in{-1, 0.0f, 0};
    if (fold && gw == 0 && i > 0) {
      volatile Link* l = link + (i - 1) % kGroups;
      while (l->seq != i - 1) {
      }
      __threadfence_block();
      in.row = l->row;
      in.val = l->val;
    }
    group_sync(g);   // the slot values are in place
    if (fold) {
      // the window's runs, in tile order, each by the thread at its head.
      // A run reaching the window's end hands its value to window i + 1
      // (unless i is the last window), which goes on with it or writes
      // it; every other run writes its row once.
      const bool last = i == pl.n_win - 1;
      auto publish = [&](int row, float v) {
        Link* l = link + i % kGroups;
        l->row = row;
        l->val = v;
        __threadfence_block();
        *reinterpret_cast<volatile int*>(&l->seq) = i;
      };
      for (int k = gt; k < n; k += kGroupThreads) {
        const int row = srow[k];
        if (k == 0 && in.row >= 0 && in.row != row) y[in.row] = in.val;
        if (row < 0 || (k > 0 && srow[k - 1] == row)) continue;
        const float start = k == 0 && row == in.row ? in.val : 0.0f;
        const float v = fold_run<Fold, kRunAhead, int>(srow, partial, k, n,
                                                       R, row, start);
        if (srow[n - 1] == row && !last) {
          publish(row, v);
        } else {
          y[row] = v;
        }
      }
      if (gt == 0 && srow[n - 1] < 0 && !last) publish(-1, 0.0f);
    }
    // the next window's copy and slot fold use the other buffers; this
    // window's buffers are rewritten two windows on, after two barriers
    if (++c == pl.cpw) c = 0;
  }
}

// The launch shape for a caller to log.
struct Shape {
  int ctas, threads, stages, smem_bytes, bulk, window_tiles,
      chunks_per_window, pipelines;
};

template <class Op, class Fold, bool kBulk>
int prepare(const Plan& pl) {
  auto kernel = sharded_walk<Op, Fold, kBulk>;
  cudaError_t e = cudaSuccess;
  if (pl.smem > 48 * 1024) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             pl.smem);
  }
  int per_sm = 0;
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, pl.smem);
  }
  if (e != cudaSuccess) return (int)e;
  return per_sm < 1 ? (int)cudaErrorInvalidConfiguration : 0;
}

// The shape of the walk for p workers of S_B steps of B tiles of R slots
// and W lanes; `bulk`: the copies take cp.async.bulk.
template <class Op, class Fold>
int shape(int p, int S_B, int B, int R, int W, bool bulk, Shape* sh) {
  Plan pl;
  int err = make_plan(S_B, B, R, W, &pl);
  if (err != 0) return err;
  err = bulk ? prepare<Op, Fold, true>(pl) : prepare<Op, Fold, false>(pl);
  if (err != 0) return err;
  *sh = Shape{p, kThreads, kStages, pl.smem, bulk ? 1 : 0, pl.U, pl.cpw,
              kGroups};
  return 0;
}

inline bool takes_bulk(const void* a, const void* cols, const void* rowid,
                       int R, int W) {
  auto al = [](const void* ptr) { return (uintptr_t)ptr % 16 == 0; };
  return W % 4 == 0 && R % 4 == 0 && al(a) && al(cols) && al(rowid);
}

// Run the walk on `stream` (p workers, S_B >= 1, a payload of at least
// one block): y (zeroed; the walk writes every row a slot names), costs
// (p*S_B,) or null (slot_cost then unread). Returns 0, a CUDA error code,
// or kErrSmem.
template <class Op, class Fold>
int walk(const float* a, const int* cols, const int* rowid, const int* blkid,
         const float* slot_cost, const Op& op, float* y, float* costs, int p,
         int S_B, int B, int R, int W, cudaStream_t stream) {
  Plan pl;
  int err = make_plan(S_B, B, R, W, &pl);
  if (err != 0) return err;
  if (takes_bulk(a, cols, rowid, R, W)) {
    err = prepare<Op, Fold, true>(pl);
    if (err != 0) return err;
    sharded_walk<Op, Fold, true><<<p, kThreads, pl.smem, stream>>>(
        a, cols, rowid, blkid, slot_cost, op, y, costs, pl);
  } else {
    err = prepare<Op, Fold, false>(pl);
    if (err != 0) return err;
    sharded_walk<Op, Fold, false><<<p, kThreads, pl.smem, stream>>>(
        a, cols, rowid, blkid, slot_cost, op, y, costs, pl);
  }
  return (int)cudaGetLastError();
}

// Shape as eight ints for a C caller.
inline void to_ints(const Shape& sh, int* out) {
  out[0] = sh.ctas;
  out[1] = sh.threads;
  out[2] = sh.stages;
  out[3] = sh.smem_bytes;
  out[4] = sh.bulk;
  out[5] = sh.window_tiles;
  out[6] = sh.chunks_per_window;
  out[7] = sh.pipelines;
}

}  // namespace sharded
}  // namespace ich
