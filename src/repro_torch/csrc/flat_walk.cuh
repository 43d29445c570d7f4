// The flat-order walk of the iCh kernels for Hopper (sm_90a), in two
// launches over the whole card: the counterpart of the sequential (T,) grid
// of src/repro/kernels/ich_spmv/ich_spmv.py (`ich_spmv`) and
// src/repro/kernels/ich_bfs/ich_bfs.py (`ich_bfs_step`).
//
// The payload is the flat (T, R, W) pack of a schedule: slot k = t*R + r
// holds W lanes of row rowid[k] (-1 = padding slot). A kernel computes one
// value per slot, a left fold over its lanes in ascending w, and folds the
// slot values of each row into y in the order of the TPU grid: the row's
// slots of one tile first (Fold::within, ascending slot order), then the
// per-tile values, tiles ascending (Fold::across), from the zeroed y.
//
// That order only binds the slots of one row. So the walk is split in two:
//   * phase A (`flat_slot_partials`): every slot value, fully parallel. A
//     persistent grid (as many CTAs as fit on all SMs) walks chunks of S
//     consecutive slots through a ring of kStages shared-memory stages:
//     while chunk i is computed, chunk i+1's lanes and column ids are in
//     flight, brought by cp.async.bulk (TMA's bulk copy, completion on an
//     mbarrier, tagged evict-first in L2 so that the stream, read once, does
//     not push the gathered vector out) when W is a multiple of 4 and the
//     payload 16-byte aligned, else by 4-byte cp.async (W = 1, 2, 3, ...:
//     a chunk's byte range is then not always a multiple of 16, nor is a
//     misaligned payload's). This is the Hopper counterpart of
//     src/repro/core/pipelining.py's fetch_double_buffered. The lanes are
//     first evaluated (one thread per lane: the gathers of x or of the
//     frontier, from L2) into a padded (S, W|1) table — odd row stride, so
//     the thread-per-slot fold that follows reads it without bank
//     conflicts — then one thread per slot folds its W lanes in ascending
//     w and writes one float into the (T*R,) scratch `partial`. No shuffle
//     tree over w: it would change the association of the adds. Phase A
//     also zeroes y, so a call is these two kernels and nothing else.
//   * phase B (`flat_fold_rows`): one owner per row. The thread at a run
//     head (a slot k with rowid[k] >= 0 and k == 0 or rowid[k-1] !=
//     rowid[k], over the whole flat stream, across tile boundaries) folds
//     the run with segmented.cuh's fold_runs — the same fold the sharded
//     kernels run per superstep — and writes y[row] once. Distinct runs name
//     distinct rows (construction emits an item's segments consecutively),
//     so no two threads write one row: no atomics.
// Every row thus sees the same IEEE operations in the same order as in the
// single-CTA walk it replaces, so the result is the same bits, and the same
// bits as the sharded kernels. The serial part left is the longest run: a
// row's slots all go through its one owner, which loads kFoldAhead slots
// at a time so that it waits on one load latency per kFoldAhead slots.
//
// What bounds it: bytes. Phase A streams the W lanes and column ids once
// (8*W bytes a slot) and gathers x/frontier from L2; the scratch adds 4
// bytes a slot written and read back (it stays in the 50 MB L2 at the
// sizes the main paths run), phase B reads rowid and writes y once.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "segmented.cuh"

namespace ich {
namespace flat {

constexpr int kThreads = 256;       // phase A CTA
constexpr int kStages = 2;          // ring depth
constexpr int kChunkLanes = 1024;   // lanes of one stage: 8 KB of payload
constexpr int kFoldThreads = 256;   // phase B CTA
constexpr int kFoldCtasPerSm = 8;
constexpr int kFoldAhead = 8;       // slots a run owner loads at a time
constexpr int kMaxSmem = 232448;    // what one CTA can have on Hopper
constexpr int kErrSmem = -1;        // the width needs more than kMaxSmem

// The launch the walk makes for a payload, for the caller to log.
struct Shape {
  int chunk_slots;   // S: slots per phase-A chunk
  int ctas_a;        // phase A grid
  int ctas_b;        // phase B grid
  int smem_bytes;    // phase A dynamic shared memory
  int bulk;          // 1: cp.async.bulk ring, 0: 4-byte cp.async ring
};

inline int chunk_slots(int W) {
  const int s = kChunkLanes / W;
  return s < 1 ? 1 : s;
}

inline int64_t smem_bytes(int W) {
  const int64_t S = chunk_slots(W);
  return 16 + kStages * S * W * 8 + S * (int64_t)(W | 1) * 4;
}

// ---------------------------------------------------------------- PTX
__device__ inline uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ inline void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ inline void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ inline void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

// An L2 policy that evicts the lines it tags first: the streamed payload,
// read once, should not push x (or the frontier) out of L2.
__device__ inline uint64_t evict_first_policy() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;"
               : "=l"(policy));
  return policy;
}

// bytes: a multiple of 16; dst and src 16-byte aligned
__device__ inline void bulk_load(void* dst, const void* src, uint32_t bytes,
                                 uint64_t* bar, uint64_t policy) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".L2::cache_hint [%0], [%1], %2, [%3], %4;" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar)), "l"(policy)
      : "memory");
}

__device__ inline void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_u32(dst)),
               "l"(src)
               : "memory");
}

// dst and src 8-byte aligned
__device__ inline void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ inline void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ inline void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// ------------------------------------------------------------ phase A
// Op supplies the arithmetic of one kernel:
//   float lane(float a, int c) const            one lane's value
//   float slot(const float* lanes, int W, int row) const
//                                               the left fold of a slot's
//                                               W lane values, w ascending
// It also zeroes the (n_out,) output, which phase B, the next launch on the
// stream, folds into.
template <class Op, bool kBulk>
__global__ void __launch_bounds__(kThreads)
    flat_slot_partials(const float* __restrict__ a,
                       const int* __restrict__ cols,
                       const int* __restrict__ rowid, Op op,
                       float* __restrict__ partial, int64_t n_slots, int W,
                       int S, float* __restrict__ y, int64_t n_out) {
  extern __shared__ __align__(16) unsigned char flat_smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(flat_smem);  // kStages of them
  const int E = S * W;                                  // lanes a chunk
  float* sa = reinterpret_cast<float*>(flat_smem + 16);  // kStages x E
  int* sc = reinterpret_cast<int*>(sa + kStages * E);  // kStages x E
  float* lanes = reinterpret_cast<float*>(sc + kStages * E);  // S x P
  const int P = W | 1;
  const int64_t n_chunks = (n_slots + S - 1) / S;

  for (int64_t i = blockIdx.x * (int64_t)kThreads + threadIdx.x; i < n_out;
       i += (int64_t)gridDim.x * kThreads) {
    y[i] = 0.0f;
  }
  if (kBulk && threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(bar + s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // bring chunk c into stage s (nothing past the last chunk)
  auto fetch = [&](int64_t c, int s) {
    const int64_t s0 = c * S;
    const int ns = c < n_chunks ? (int)(n_slots - s0 < S ? n_slots - s0 : S)
                                : 0;
    if constexpr (kBulk) {
      if (threadIdx.x == 0 && ns > 0) {
        const uint32_t bytes = (uint32_t)ns * W * 4;   // W % 4 == 0
        // the generic-proxy reads of this stage are done (a barrier
        // precedes every fetch); order them before the async writes
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        const uint64_t policy = evict_first_policy();
        mbar_expect_tx(bar + s, 2 * bytes);
        bulk_load(sa + s * E, a + s0 * W, bytes, bar + s, policy);
        bulk_load(sc + s * E, cols + s0 * W, bytes, bar + s, policy);
      }
    } else {
      for (int e = threadIdx.x; e < ns * W; e += kThreads) {
        cp_async4(sa + s * E + e, a + s0 * W + e);
        cp_async4(sc + s * E + e, cols + s0 * W + e);
      }
      cp_async_commit();   // one group per chunk, empty ones included
    }
  };

  int64_t c = blockIdx.x;
  for (int s = 0; s < kStages; ++s) fetch(c + (int64_t)s * gridDim.x, s);
  for (int it = 0; c < n_chunks; c += gridDim.x, ++it) {
    const int s = it % kStages;
    if constexpr (kBulk) {
      mbar_wait(bar + s, (uint32_t)(it / kStages) & 1u);
    } else {
      cp_async_wait<kStages - 1>();
      __syncthreads();
    }
    const int64_t s0 = c * S;
    const int ns = (int)(n_slots - s0 < S ? n_slots - s0 : S);
    const float* ca = sa + s * E;
    const int* cc = sc + s * E;
    const int* rows = rowid + s0;
    // every lane of the chunk: one thread per lane (padding slots' lanes
    // are never read past shared memory)
#pragma unroll 4
    for (int e = threadIdx.x; e < ns * W; e += kThreads) {
      const int k = e / W;
      float v = 0.0f;
      if (__ldg(rows + k) >= 0) v = op.lane(ca[e], cc[e]);
      lanes[k * P + (e - k * W)] = v;
    }
    __syncthreads();   // the lane table is complete; stage s is free
    fetch(c + (int64_t)kStages * gridDim.x, s);
    // every slot of the chunk: one thread per slot, w ascending
    for (int k = threadIdx.x; k < ns; k += kThreads) {
      const int row = __ldg(rows + k);
      partial[s0 + k] = row >= 0 ? op.slot(lanes + k * P, W, row) : 0.0f;
    }
    __syncthreads();   // the next chunk rewrites the lane table
  }
}

// ------------------------------------------------------------ phase B
template <class Fold>
__global__ void __launch_bounds__(kFoldThreads)
    flat_fold_rows(const int* __restrict__ rowid,
                   const float* __restrict__ partial, float* y,
                   int64_t n_slots, int R) {
  fold_runs<Fold, kFoldAhead, int64_t>(
      rowid, partial, n_slots, R, y,
      blockIdx.x * (int64_t)blockDim.x + threadIdx.x,
      (int64_t)gridDim.x * blockDim.x);
}

// ------------------------------------------------------------- host
template <class Op, bool kBulk>
int plan(int64_t n_slots, int W, Shape* sh) {
  const int64_t smem = smem_bytes(W);
  if (smem > kMaxSmem) return kErrSmem;
  sh->chunk_slots = chunk_slots(W);
  sh->smem_bytes = (int)smem;
  sh->bulk = kBulk ? 1 : 0;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess && smem > 48 * 1024)   // above the static limit
    e = cudaFuncSetAttribute(flat_slot_partials<Op, kBulk>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             sh->smem_bytes);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, flat_slot_partials<Op, kBulk>, kThreads, sh->smem_bytes);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int64_t chunks = (n_slots + sh->chunk_slots - 1) / sh->chunk_slots;
  const int64_t full_a = (int64_t)sms * per_sm;
  sh->ctas_a = (int)(chunks < full_a ? chunks : full_a);
  const int64_t blocks_b = (n_slots + kFoldThreads - 1) / kFoldThreads;
  const int64_t full_b = (int64_t)sms * kFoldCtasPerSm;
  sh->ctas_b = (int)(blocks_b < full_b ? blocks_b : full_b);
  return 0;
}

// The shape of the walk over T tiles of R slots and W lanes; `aligned`:
// both payload pointers are 16-byte aligned.
template <class Op>
int shape(int64_t T, int R, int W, bool aligned, Shape* sh) {
  if (aligned && W % 4 == 0) return plan<Op, true>(T * R, W, sh);
  return plan<Op, false>(T * R, W, sh);
}

// Run both phases on `stream` (T > 0): `partial` is (T*R,) scratch, y the
// (n_out,) output (phase A zeroes it). Returns 0, a CUDA error code, or
// kErrSmem.
template <class Op, class Fold>
int walk(const float* a, const int* cols, const int* rowid, const Op& op,
         float* partial, float* y, int64_t n_out, int64_t T, int R, int W,
         cudaStream_t stream) {
  const bool aligned =
      (uintptr_t)a % 16 == 0 && (uintptr_t)cols % 16 == 0;
  Shape sh;
  int err = shape<Op>(T, R, W, aligned, &sh);
  if (err != 0) return err;
  const int64_t n = T * R;
  if (sh.bulk) {
    flat_slot_partials<Op, true><<<sh.ctas_a, kThreads, sh.smem_bytes,
                                   stream>>>(a, cols, rowid, op, partial, n,
                                             W, sh.chunk_slots, y, n_out);
  } else {
    flat_slot_partials<Op, false><<<sh.ctas_a, kThreads, sh.smem_bytes,
                                    stream>>>(a, cols, rowid, op, partial, n,
                                              W, sh.chunk_slots, y, n_out);
  }
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  flat_fold_rows<Fold><<<sh.ctas_b, kFoldThreads, 0, stream>>>(
      rowid, partial, y, n, R);
  return (int)cudaGetLastError();
}

// Shape as five ints for a C caller: chunk_slots, ctas_a, ctas_b,
// smem_bytes, bulk.
inline void to_ints(const Shape& sh, int* out) {
  out[0] = sh.chunk_slots;
  out[1] = sh.ctas_a;
  out[2] = sh.ctas_b;
  out[3] = sh.smem_bytes;
  out[4] = sh.bulk;
}

}  // namespace flat
}  // namespace ich
