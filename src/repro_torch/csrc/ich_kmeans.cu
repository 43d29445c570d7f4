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
// same id from the same bits, and by item closure all of them lie in one
// worker, so no fold and no order is needed. The sharded kernel reads
// rowid and slot_cost in the SHARD layout (p*S, R) directly: this kernel
// has no flat payload, so there is no block-index stream.
//
// Cost stream: costs[w, j] is the left fold in slot order of slot_cost over
// the slots of worker w's step j whose point is >= 0 (segmented.cuh).
//
// What bounds it. Bytes: the (n, D) point table read once and the (n,)
// ids written once, plus 8 bytes of rowid and slot_cost per slot; the
// centroids sit in shared memory, loaded once per CTA. Operations: 3*K*D
// per live slot (sub, mul, add), about 0.4 per byte at D = 34, K = 5, far
// below the card's ratio: the kernel is bound by bytes.
//
// The flat kernel (the cross-check path) runs on the whole card: a grid of
// as many 256-thread CTAs as fit on all SMs walks the T*R slots in chunks
// of up to 256. Each CTA loads the centroids into shared memory once; per
// chunk it stages the slots' point rows into shared memory with one warp a
// row, lanes on consecutive floats (4-byte cp.async: a 136-byte row is
// 8-byte aligned, not 16; no thread waits on one row before asking for
// the next), into an odd-stride table, while the next chunk's point ids
// load, and then computes one slot a thread from shared memory. Padding
// slots are neither loaded nor written. When the centroids leave no room
// for a chunk of rows (K*D near the 227 KB a CTA can have), the threads
// read their points straight from global memory instead. The sharded
// kernel keeps one CTA per worker (each of a worker's slots is one thread:
// the store needs no step order) and reads its points from global memory.

#include <cuda_runtime.h>
#include <stdint.h>

#include "flat_walk.cuh"
#include "segmented.cuh"

namespace {

constexpr int kThreads = 256;        // both kernels' CTAs
constexpr int kChunk = 256;          // flat kernel: slots a CTA stages
constexpr int kMinChunk = 32;        // fewer rows than this: read global
constexpr int kMaxSmem = 232448;     // what one CTA can have on Hopper

// The nearest centroid of point p (D floats): the first minimum over
// ascending k of the left fold over d of (p[d] - c[k, d])^2.
__device__ inline int nearest(const float* p, const float* cent, int D,
                              int K) {
  int best = 0;
  float best_d2 = 0.0f;
  for (int k = 0; k < K; ++k) {
    const float* c = cent + k * D;
    float d2 = 0.0f;
    for (int d = 0; d < D; ++d) {
      const float diff = __fsub_rn(p[d], c[d]);
      d2 = __fadd_rn(d2, __fmul_rn(diff, diff));
    }
    if (k == 0 || d2 < best_d2) {
      best = k;
      best_d2 = d2;
    }
  }
  return best;
}

// Assign the n_slots slots whose point ids start at `rows`; `cent` is the
// (K, D) centroid table in shared memory.
__device__ void assign_slots(const float* __restrict__ points,
                             const float* cent, const int* __restrict__ rows,
                             int64_t n_slots, int D, int K, int* out) {
  for (int64_t s = threadIdx.x; s < n_slots; s += blockDim.x) {
    const int id = rows[s];
    if (id < 0) continue;
    out[id] = nearest(points + (int64_t)id * D, cent, D, K);
  }
}

__device__ void load_centroids(const float* __restrict__ centroids, int KD,
                               float* cent) {
  for (int i = threadIdx.x; i < KD; i += blockDim.x) cent[i] = centroids[i];
  __syncthreads();
}

// One CTA per worker w: its S_B steps of B*R slots.
__global__ void ich_kmeans_assign_sharded_kernel(
    const float* __restrict__ points, const float* __restrict__ centroids,
    const int* __restrict__ rowid, const float* __restrict__ slot_cost,
    int* out, float* costs, int D, int K, int S_B, int B, int R) {
  extern __shared__ float cent[];
  load_centroids(centroids, K * D, cent);
  const int step_slots = B * R;
  const int64_t slot0 = (int64_t)blockIdx.x * S_B * step_slots;
  assign_slots(points, cent, rowid + slot0, (int64_t)S_B * step_slots, D, K,
               out);
  if (costs != nullptr) {
    for (int j = threadIdx.x; j < S_B; j += blockDim.x) {
      const int64_t s = slot0 + (int64_t)j * step_slots;
      costs[(int64_t)blockIdx.x * S_B + j] =
          ich::masked_cost(rowid + s, slot_cost + s, step_slots);
    }
  }
}

// The flat walk over all n_slots slots on a card-spanning grid. kStage:
// chunks of `chunk` slots with their point rows staged in shared memory
// (4-byte cp.async, so no thread waits on a row before asking for the
// next, while the next chunk's point ids load); else a grid-stride loop
// reading points from global memory.
template <bool kStage>
__global__ void __launch_bounds__(kThreads)
    ich_kmeans_assign_kernel(const float* __restrict__ points,
                             const float* __restrict__ centroids,
                             const int* __restrict__ rowid, int* out,
                             int64_t n_slots, int D, int K, int chunk) {
  extern __shared__ __align__(16) float smem[];
  float* cent = smem;                                   // K*D
  load_centroids(centroids, K * D, cent);
  if constexpr (!kStage) {
    for (int64_t s = blockIdx.x * (int64_t)kThreads + threadIdx.x;
         s < n_slots; s += (int64_t)gridDim.x * kThreads) {
      const int id = __ldg(rowid + s);
      if (id >= 0) {
        out[id] = nearest(points + (int64_t)id * D, cent, D, K);
      }
    }
  } else {
    int* sid = reinterpret_cast<int*>(cent + K * D);      // 2 x chunk
    float* rows = reinterpret_cast<float*>(sid + 2 * chunk);  // chunk x P
    const int P = D | 1;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    auto load_ids = [&](int64_t c, int* dst) {
      const int64_t s0 = c * chunk;
      for (int k = threadIdx.x; k < chunk && s0 + k < n_slots;
           k += kThreads) {
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
      // one warp a row, lanes on consecutive floats; padding slots skip
      for (int k = warp; k < ns; k += kThreads / 32) {
        const int id = cur[k];
        if (id < 0) continue;
        const float* p = points + (int64_t)id * D;
        for (int d = lane; d < D; d += 32) {
          ich::flat::cp_async4(rows + k * P + d, p + d);
        }
      }
      ich::flat::cp_async_commit();
      load_ids(c + gridDim.x, sid + ((it + 1) & 1) * chunk);
      ich::flat::cp_async_wait<0>();
      __syncthreads();
      for (int k = threadIdx.x; k < ns; k += kThreads) {
        const int id = cur[k];
        if (id >= 0) out[id] = nearest(rows + k * P, cent, D, K);
      }
      __syncthreads();   // the next chunk rewrites rows and this sid half
    }
  }
}

// Raise the kernel's dynamic shared-memory limit when it needs more than
// the default 48 KB.
template <typename Kernel>
int allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// The flat kernel's launch: chunk slots (0: points read from global), CTAs,
// shared memory.
struct FlatShape {
  int chunk, ctas, smem;
};

template <bool kStage>
int flat_grid(int64_t n_slots, int chunk, int smem, FlatShape* sh) {
  auto kernel = ich_kmeans_assign_kernel<kStage>;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = (cudaError_t)allow_smem(kernel, smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int64_t per_cta = kStage ? chunk : kThreads;
  const int64_t blocks = (n_slots + per_cta - 1) / per_cta;
  const int64_t full = (int64_t)sms * per_sm;
  *sh = FlatShape{kStage ? chunk : 0,
                  (int)(blocks < full ? (blocks > 0 ? blocks : 1) : full),
                  smem};
  return 0;
}

// Plan the flat kernel for n_slots slots, D features, K centroids.
int flat_plan(int64_t n_slots, int D, int K, FlatShape* sh) {
  const int64_t cent = (int64_t)K * D * 4;
  if (cent > kMaxSmem) return -1;
  const int64_t row = (int64_t)(D | 1) * 4 + 8;   // a staged row, 2 ids
  int64_t chunk = (kMaxSmem - cent) / row;
  if (chunk > kChunk) chunk = kChunk;
  if (chunk >= kMinChunk) {
    return flat_grid<true>(n_slots, (int)chunk, (int)(cent + chunk * row),
                           sh);
  }
  return flat_grid<false>(n_slots, 0, (int)cent, sh);
}

}  // namespace

extern "C" {

// Launch the sharded kernel on `stream`; out must be zeroed (n,) int32 and
// costs (p*S_B,) or null (then slot_cost is ignored). Returns a CUDA error
// code (0 = success).
int ich_kmeans_assign_sharded_launch(const float* points,
                                     const float* centroids, const int* rowid,
                                     const float* slot_cost, int* out,
                                     float* costs, int p, int S_B, int B,
                                     int R, int D, int K, void* stream) {
  const size_t smem = (size_t)K * D * sizeof(float);
  const int err = allow_smem(ich_kmeans_assign_sharded_kernel, smem);
  if (err != 0) return err;
  ich_kmeans_assign_sharded_kernel<<<p, kThreads, smem,
                                     (cudaStream_t)stream>>>(
      points, centroids, rowid, slot_cost, out, costs, D, K, S_B, B, R);
  return (int)cudaGetLastError();
}

// Launch the flat kernel on `stream` (n_slots > 0); out must be zeroed
// (n,) int32. Returns 0, a CUDA error code, or -1 when the centroids need
// more shared memory than one CTA has.
int ich_kmeans_assign_launch(const float* points, const float* centroids,
                             const int* rowid, int* out, int64_t n_slots,
                             int D, int K, void* stream) {
  FlatShape sh;
  const int err = flat_plan(n_slots, D, K, &sh);
  if (err != 0) return err;
  if (sh.chunk > 0) {
    ich_kmeans_assign_kernel<true><<<sh.ctas, kThreads, sh.smem,
                                     (cudaStream_t)stream>>>(
        points, centroids, rowid, out, n_slots, D, K, sh.chunk);
  } else {
    ich_kmeans_assign_kernel<false><<<sh.ctas, kThreads, sh.smem,
                                      (cudaStream_t)stream>>>(
        points, centroids, rowid, out, n_slots, D, K, 0);
  }
  return (int)cudaGetLastError();
}

// The flat kernel's launch shape as four ints: chunk slots (0: points read
// from global memory), CTAs, threads, shared memory. Returns as
// ich_kmeans_assign_launch does.
int ich_kmeans_assign_shape(int64_t n_slots, int D, int K, int* out) {
  FlatShape sh;
  const int err = flat_plan(n_slots, D, K, &sh);
  if (err == 0) {
    out[0] = sh.chunk;
    out[1] = sh.ctas;
    out[2] = kThreads;
    out[3] = sh.smem;
  }
  return err;
}

}  // extern "C"
