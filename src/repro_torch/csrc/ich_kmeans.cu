// iCh-scheduled K-Means assignment for NVIDIA Hopper (sm_90a).
//
// Replaces the two Pallas kernels of src/repro/kernels/ich_kmeans/ich_kmeans.py:
//   * ich_kmeans_assign_kernel          <- ich_kmeans_assign (sequential
//                                          (T,) grid, _kmeans_kernel,
//                                          ich_kmeans.py:83)
//   * ich_kmeans_assign_sharded_kernel  <- ich_kmeans_assign_sharded
//                                          ((p, S/B) grid,
//                                          _kmeans_sharded_body, with its
//                                          cost stream and the host-side
//                                          worker_reduce "store" folded away)
//
// What they compute. The schedule's slots name points (rowid, -1 =
// padding); a point heavier than one slot's capacity occupies several
// slots. For each slot on point i,
//   d2[k] = sum_d (points[i, d] - centroids[k, d])^2   (left fold over d)
//   out[i] = argmin_k d2[k]                            (first minimum)
// with __fsub_rn/__fmul_rn/__fadd_rn so no FMA contraction changes the
// fold, and a strict < over ascending k, so the first minimum wins as with
// torch.argmin: the plain version's left fold gives the same ids exactly.
// "store" writes out[i] straight: every slot of a split point computes the
// same id from the same bits, so no fold and no order is needed, and any
// CTA may take any slot. The sharded kernel reads rowid and slot_cost in
// the SHARD layout (p*S, R) directly: this kernel has no flat payload, so
// there is no block-index stream.
//
// Cost stream: costs[g] for step g = w*S_B + j (worker w's superstep j, the
// B*R contiguous slots from g*B*R) is the left fold in slot order of
// slot_cost over the step's slots whose point is >= 0 (segmented.cuh).
//
// What bounds it. Bytes: the (n, D) point table read once and the (n,)
// ids written once, plus 4 bytes of rowid (and 4 of slot_cost) per slot;
// the centroids sit in shared memory, loaded once per CTA. Operations:
// 3*K*D per live slot (sub, mul, add), about 0.4 per byte at D = 34,
// K = 5, far below the card's ratio: the kernel is bound by bytes.
//
// Both kernels run on the whole card: a grid of as many 256-thread CTAs as
// fit on all SMs walks the slots in chunks. Each CTA loads the centroids
// into shared memory once; per chunk it stages the slots' point rows into
// shared memory (`stage_rows`, shared by both kernels: one warp a row,
// lanes on consecutive floats, cp.async of 8 bytes when D is even and the
// table 8-byte aligned, as a 136-byte row is, else of 4 bytes; no thread
// waits on one row before asking for the next) into a table whose row
// stride is odd in the copy's words, so one thread a slot reads it without
// bank conflicts, while the next chunk's point ids load, and then computes
// one slot a thread from shared memory. Padding slots are neither loaded
// nor written. When the centroids leave no room for a chunk of rows (K*D
// near the 227 KB a CTA can have), the threads read their points straight
// from global memory instead.
//
// The flat kernel's chunks are 256 slots. The sharded kernel's are whole
// supersteps (B*R slots each, as many as fit in 256 slots, at least one):
// the CTA that stages a step also folds its cost from the staged ids and
// slot costs (which load by cp.async beside the ids), so the cost stream
// needs no second pass and no atomics. Its CTAs walk the p*S_B steps
// grid-stride, chunk c on CTA c mod grid.

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <vector>

#include "flat_walk.cuh"
#include "segmented.cuh"

namespace {

constexpr int kThreads = 256;        // both kernels' CTAs
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 256;          // slots a CTA stages at a time, at most
constexpr int kMinChunk = 32;        // room for fewer rows: read global
constexpr int kMaxSmem = 232448;     // what one CTA can have on Hopper

// The staged table's row stride in floats: odd in words of the copy
// (kVec floats), so consecutive rows start in different banks.
template <int kVec>
__host__ __device__ inline int row_stride(int D) {
  return kVec == 2 ? 2 * ((D / 2) | 1) : (D | 1);
}

// The nearest centroid of point p (D floats): the first minimum over
// ascending k of the left fold over d of (p[d] - c[k, d])^2. kVec = 2
// reads p and the centroids two floats at a time (D even, both 8-byte
// aligned); the fold is the same.
template <int kVec>
__device__ inline int nearest(const float* p, const float* cent, int D,
                              int K) {
  int best = 0;
  float best_d2 = 0.0f;
  for (int k = 0; k < K; ++k) {
    const float* c = cent + k * D;
    float d2 = 0.0f;
    if constexpr (kVec == 2) {
      const float2* p2 = reinterpret_cast<const float2*>(p);
      const float2* c2 = reinterpret_cast<const float2*>(c);
      for (int h = 0; h < D / 2; ++h) {
        const float2 v = p2[h], w = c2[h];
        const float a = __fsub_rn(v.x, w.x);
        d2 = __fadd_rn(d2, __fmul_rn(a, a));
        const float b = __fsub_rn(v.y, w.y);
        d2 = __fadd_rn(d2, __fmul_rn(b, b));
      }
    } else {
      for (int d = 0; d < D; ++d) {
        const float diff = __fsub_rn(p[d], c[d]);
        d2 = __fadd_rn(d2, __fmul_rn(diff, diff));
      }
    }
    if (k == 0 || d2 < best_d2) {
      best = k;
      best_d2 = d2;
    }
  }
  return best;
}

// Ask for the point rows of the ns slots whose ids are `ids` (shared
// memory) into `rows` (stride P): one warp a row, lanes on consecutive
// floats, kVec floats a cp.async; padding slots (-1) are skipped. The
// caller commits and waits.
template <int kVec>
__device__ inline void stage_rows(const float* __restrict__ points,
                                  const int* ids, int ns, int D, int P,
                                  float* rows) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int k = warp; k < ns; k += kWarps) {
    const int id = ids[k];
    if (id < 0) continue;
    const float* src = points + (int64_t)id * D;
    float* dst = rows + k * P;
    for (int d = lane * kVec; d < D; d += 32 * kVec) {
      if constexpr (kVec == 2) {
        ich::flat::cp_async8(dst + d, src + d);
      } else {
        ich::flat::cp_async4(dst + d, src + d);
      }
    }
  }
}

__device__ inline void load_centroids(const float* __restrict__ centroids,
                                      int KD, float* cent) {
  for (int i = threadIdx.x; i < KD; i += blockDim.x) cent[i] = centroids[i];
  __syncthreads();
}

// The flat walk over all n_slots slots on a card-spanning grid. chunk > 0:
// chunks of `chunk` slots with their point rows staged in shared memory
// while the next chunk's point ids load; chunk = 0: a grid-stride loop
// reading points from global memory. Shared memory: rows (chunk x P),
// centroids (K*D), ids (2 x chunk).
template <int kVec>
__global__ void __launch_bounds__(kThreads)
    ich_kmeans_assign_kernel(const float* __restrict__ points,
                             const float* __restrict__ centroids,
                             const int* __restrict__ rowid, int* out,
                             int64_t n_slots, int D, int K, int chunk) {
  extern __shared__ __align__(16) float smem[];
  const int P = row_stride<kVec>(D);
  float* rows = smem;
  float* cent = rows + chunk * P;
  load_centroids(centroids, K * D, cent);
  if (chunk == 0) {
    for (int64_t s = blockIdx.x * (int64_t)kThreads + threadIdx.x;
         s < n_slots; s += (int64_t)gridDim.x * kThreads) {
      const int id = __ldg(rowid + s);
      if (id >= 0) {
        out[id] = nearest<1>(points + (int64_t)id * D, cent, D, K);
      }
    }
    return;
  }
  int* sid = reinterpret_cast<int*>(cent + K * D);
  auto load_ids = [&](int64_t c, int* dst) {
    const int64_t s0 = c * chunk;
    for (int k = threadIdx.x; k < chunk && s0 + k < n_slots; k += kThreads) {
      dst[k] = __ldg(rowid + s0 + k);
    }
  };
  int64_t c = blockIdx.x;
  load_ids(c, sid);
  __syncthreads();
  for (int it = 0; c * chunk < n_slots; c += gridDim.x, ++it) {
    int* cur = sid + (it & 1) * chunk;
    const int64_t s0 = c * chunk;
    const int ns = (int)(n_slots - s0 < chunk ? n_slots - s0 : chunk);
    stage_rows<kVec>(points, cur, ns, D, P, rows);
    ich::flat::cp_async_commit();
    load_ids(c + gridDim.x, sid + ((it + 1) & 1) * chunk);
    ich::flat::cp_async_wait<0>();
    __syncthreads();
    for (int k = threadIdx.x; k < ns; k += kThreads) {
      const int id = cur[k];
      if (id >= 0) out[id] = nearest<kVec>(rows + k * P, cent, D, K);
    }
    __syncthreads();   // the next chunk rewrites rows and this sid half
  }
}

// The sharded walk: the n_steps = p*S_B supersteps of step_slots slots
// each, in chunks of chunk_steps whole steps, chunk c on CTA c mod grid.
// stage = 0: points read from global memory. Shared memory when staged:
// rows (chunk x P), centroids (K*D), ids (2 x chunk), slot costs
// (2 x chunk, with costs).
template <int kVec>
__global__ void __launch_bounds__(kThreads)
    ich_kmeans_assign_sharded_kernel(
        const float* __restrict__ points, const float* __restrict__ centroids,
        const int* __restrict__ rowid, const float* __restrict__ slot_cost,
        int* out, float* costs, int64_t n_steps, int step_slots,
        int chunk_steps, int stage, int D, int K) {
  extern __shared__ __align__(16) float smem[];
  const int chunk = chunk_steps * step_slots;
  const int P = stage ? row_stride<kVec>(D) : 0;
  float* rows = smem;
  float* cent = rows + (int64_t)chunk * P;
  load_centroids(centroids, K * D, cent);
  const int64_t lo = (int64_t)blockIdx.x * chunk_steps, hi = n_steps;
  const int64_t stride = (int64_t)gridDim.x * chunk_steps;
  if (!stage) {
    for (int64_t g0 = lo; g0 < hi; g0 += stride) {
      const int64_t g1 = g0 + chunk_steps < hi ? g0 + chunk_steps : hi;
      const int64_t s0 = g0 * step_slots;
      const int ns = (int)(g1 - g0) * step_slots;
      for (int k = threadIdx.x; k < ns; k += kThreads) {
        const int id = __ldg(rowid + s0 + k);
        if (id >= 0) {
          out[id] = nearest<1>(points + (int64_t)id * D, cent, D, K);
        }
      }
      if (costs != nullptr) {
        for (int64_t g = g0 + threadIdx.x; g < g1; g += kThreads) {
          const int64_t s = g * step_slots;
          costs[g] = ich::masked_cost(rowid + s, slot_cost + s, step_slots);
        }
      }
    }
    return;
  }
  int* sid = reinterpret_cast<int*>(cent + K * D);
  float* scost = reinterpret_cast<float*>(sid + 2 * chunk);
  // ask for the ids (and slot costs) of the chunk at g0 into half b
  auto fetch_ids = [&](int64_t g0, int b) {
    const int64_t g1 = g0 + chunk_steps < hi ? g0 + chunk_steps : hi;
    const int64_t s0 = g0 * step_slots;
    const int ns = (int)(g1 - g0) * step_slots;
    for (int k = threadIdx.x; k < ns; k += kThreads) {
      ich::flat::cp_async4(sid + b * chunk + k, rowid + s0 + k);
      if (costs != nullptr) {
        ich::flat::cp_async4(scost + b * chunk + k, slot_cost + s0 + k);
      }
    }
  };
  int64_t g0 = lo;
  if (g0 < hi) fetch_ids(g0, 0);
  ich::flat::cp_async_commit();
  ich::flat::cp_async_wait<0>();
  __syncthreads();
  for (int it = 0; g0 < hi; g0 += stride, ++it) {
    const int b = it & 1;
    const int* cur = sid + b * chunk;
    const int64_t g1 = g0 + chunk_steps < hi ? g0 + chunk_steps : hi;
    const int ns = (int)(g1 - g0) * step_slots;
    stage_rows<kVec>(points, cur, ns, D, P, rows);
    ich::flat::cp_async_commit();
    if (g0 + stride < hi) fetch_ids(g0 + stride, b ^ 1);
    ich::flat::cp_async_commit();
    ich::flat::cp_async_wait<1>();   // the rows; the next ids may fly on
    __syncthreads();
    for (int k = threadIdx.x; k < ns; k += kThreads) {
      const int id = cur[k];
      if (id >= 0) out[id] = nearest<kVec>(rows + k * P, cent, D, K);
    }
    if (costs != nullptr) {
      const float* sc = scost + b * chunk;
      for (int j = threadIdx.x; j < g1 - g0; j += kThreads) {
        costs[g0 + j] = ich::masked_cost(cur + j * step_slots,
                                         sc + j * step_slots, step_slots);
      }
    }
    ich::flat::cp_async_wait<0>();
    __syncthreads();   // the next chunk rewrites rows and this half
  }
}

// SMs and the CTAs of `kernel` one SM holds with `smem` bytes, on the
// current device; the kernel's shared-memory limit is raised to the most a
// CTA can have the first time. Cached per (device, kernel, smem), so a
// launch pays no driver queries after the first.
int occupancy(const void* kernel, int smem, int* sms, int* per_sm) {
  struct Entry {
    int dev;
    const void* kernel;
    int smem, sms, per_sm;
  };
  static std::mutex mu;
  static std::vector<Entry> cache;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  std::lock_guard<std::mutex> lock(mu);
  for (const Entry& c : cache) {
    if (c.dev == dev && c.kernel == kernel && c.smem == smem) {
      *sms = c.sms;
      *per_sm = c.per_sm;
      return 0;
    }
  }
  e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kMaxSmem);
  }
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel,
                                                      kThreads, smem);
  }
  if (e != cudaSuccess) return (int)e;
  if (*per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  cache.push_back(Entry{dev, kernel, smem, *sms, *per_sm});
  return 0;
}

// A launch of either kernel: slots a CTA stages at a time (0: points read
// from global memory), CTAs, shared memory, floats a copy (kVec), and for
// the sharded kernel the whole steps a chunk.
struct Shape {
  int chunk, ctas, smem, vec, chunk_steps;
};

// Staged chunk slots for the centroid table and `row` bytes of shared
// memory a staged slot: at most kChunk, whole multiples of `unit` slots
// (at least one), 0 when they do not fit or leave room for fewer than
// kMinChunk rows.
int64_t staged_chunk(int D, int K, int64_t row, int64_t unit) {
  const int64_t room = (kMaxSmem - (int64_t)K * D * 4) / row;
  const int64_t cap = room < kChunk ? room : kChunk;
  int64_t chunk = cap / unit * unit;
  if (chunk == 0) chunk = unit;
  return room >= kMinChunk && chunk <= room ? chunk : 0;
}

template <int kVec>
const void* flat_kernel() {
  return (const void*)ich_kmeans_assign_kernel<kVec>;
}

template <int kVec>
const void* sharded_kernel() {
  return (const void*)ich_kmeans_assign_sharded_kernel<kVec>;
}

// Plan the flat kernel for n_slots slots, D features, K centroids; vec2:
// the point table allows 8-byte copies.
int flat_plan(int64_t n_slots, int D, int K, bool vec2, Shape* sh) {
  if ((int64_t)K * D * 4 > kMaxSmem) return -1;
  const int vec = vec2 && D % 2 == 0 ? 2 : 1;
  const int P = vec == 2 ? row_stride<2>(D) : row_stride<1>(D);
  const int64_t chunk = staged_chunk(D, K, (int64_t)P * 4 + 8, 1);
  const int smem = (int)(K * D * 4 + chunk * ((int64_t)P * 4 + 8));
  const int use = chunk ? vec : 1;
  int sms = 0, per_sm = 0;
  const int e = occupancy(use == 2 ? flat_kernel<2>() : flat_kernel<1>(),
                          smem, &sms, &per_sm);
  if (e != 0) return e;
  const int64_t per_cta = chunk ? chunk : kThreads;
  const int64_t blocks = (n_slots + per_cta - 1) / per_cta;
  const int64_t full = (int64_t)sms * per_sm;
  *sh = Shape{(int)chunk, (int)(blocks < full ? (blocks > 0 ? blocks : 1)
                                              : full),
              smem, use, 0};
  return 0;
}

// Plan the sharded kernel for p workers of S_B steps of step_slots slots.
int sharded_plan(int p, int S_B, int step_slots, int D, int K,
                 bool with_costs, bool vec2, Shape* sh) {
  if ((int64_t)K * D * 4 > kMaxSmem) return -1;
  const int vec = vec2 && D % 2 == 0 ? 2 : 1;
  const int P = vec == 2 ? row_stride<2>(D) : row_stride<1>(D);
  const int64_t row = (int64_t)P * 4 + (with_costs ? 16 : 8);
  const int64_t chunk = staged_chunk(D, K, row, step_slots);
  const int64_t chunk_steps =
      chunk ? chunk / step_slots
            : (kChunk / step_slots > 0 ? kChunk / step_slots : 1);
  const int smem = (int)(K * D * 4 + chunk * row);
  const int use = chunk ? vec : 1;
  int sms = 0, per_sm = 0;
  const int e = occupancy(use == 2 ? sharded_kernel<2>()
                                   : sharded_kernel<1>(),
                          smem, &sms, &per_sm);
  if (e != 0) return e;
  const int64_t full = (int64_t)sms * per_sm;
  const int64_t n_chunks = ((int64_t)p * S_B + chunk_steps - 1) / chunk_steps;
  const int64_t ctas = n_chunks < full ? n_chunks : full;
  *sh = Shape{(int)chunk, (int)(ctas > 0 ? ctas : 1), smem, use,
              (int)chunk_steps};
  return 0;
}

bool aligned8(const void* p) { return ((uintptr_t)p & 7) == 0; }

void to_ints(const Shape& sh, int* out) {
  out[0] = sh.chunk;
  out[1] = sh.ctas;
  out[2] = kThreads;
  out[3] = sh.smem;
  out[4] = sh.vec * 4;
  out[5] = sh.chunk_steps;
}

}  // namespace

extern "C" {

// Launch the sharded kernel on `stream` (p*S_B > 0); out must be zeroed
// (n,) int32 and costs (p*S_B,) or null (then slot_cost is ignored).
// Returns 0, a CUDA error code, or -1 when the centroids need more shared
// memory than one CTA has.
int ich_kmeans_assign_sharded_launch(const float* points,
                                     const float* centroids, const int* rowid,
                                     const float* slot_cost, int* out,
                                     float* costs, int p, int S_B, int B,
                                     int R, int D, int K, void* stream) {
  Shape sh;
  const int err = sharded_plan(p, S_B, B * R, D, K, costs != nullptr,
                               aligned8(points), &sh);
  if (err != 0) return err;
  const int64_t n_steps = (int64_t)p * S_B;
  auto kernel = sh.vec == 2 ? ich_kmeans_assign_sharded_kernel<2>
                            : ich_kmeans_assign_sharded_kernel<1>;
  kernel<<<sh.ctas, kThreads, sh.smem, (cudaStream_t)stream>>>(
      points, centroids, rowid, slot_cost, out, costs, n_steps, B * R,
      sh.chunk_steps, sh.chunk > 0, D, K);
  return (int)cudaGetLastError();
}

// The sharded kernel's launch shape as six ints: staged slots a chunk (0:
// points read from global memory), CTAs, threads, shared memory, bytes a
// row copy, whole steps a chunk.
// aligned: the point table is 8-byte aligned. Returns as the launch does.
int ich_kmeans_assign_sharded_shape(int p, int S_B, int B, int R, int D,
                                    int K, int with_costs, int aligned,
                                    int* out) {
  Shape sh;
  const int err =
      sharded_plan(p, S_B, B * R, D, K, with_costs != 0, aligned != 0, &sh);
  if (err == 0) to_ints(sh, out);
  return err;
}

// Launch the flat kernel on `stream` (n_slots > 0); out must be zeroed
// (n,) int32. Returns 0, a CUDA error code, or -1 when the centroids need
// more shared memory than one CTA has.
int ich_kmeans_assign_launch(const float* points, const float* centroids,
                             const int* rowid, int* out, int64_t n_slots,
                             int D, int K, void* stream) {
  Shape sh;
  const int err = flat_plan(n_slots, D, K, aligned8(points), &sh);
  if (err != 0) return err;
  auto kernel = sh.vec == 2 ? ich_kmeans_assign_kernel<2>
                            : ich_kmeans_assign_kernel<1>;
  kernel<<<sh.ctas, kThreads, sh.smem, (cudaStream_t)stream>>>(
      points, centroids, rowid, out, n_slots, D, K, sh.chunk);
  return (int)cudaGetLastError();
}

// The flat kernel's launch shape as five ints: chunk slots (0: points read
// from global memory), CTAs, threads, shared memory, bytes a row copy.
// Returns as ich_kmeans_assign_launch does.
int ich_kmeans_assign_shape(int64_t n_slots, int D, int K, int aligned,
                            int* out) {
  Shape sh;
  const int err = flat_plan(n_slots, D, K, aligned != 0, &sh);
  if (err == 0) {
    int all[6];
    to_ints(sh, all);
    for (int i = 0; i < 5; ++i) out[i] = all[i];
  }
  return err;
}

}  // extern "C"
