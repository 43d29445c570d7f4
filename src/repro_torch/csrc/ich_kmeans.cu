// iCh-scheduled K-Means assignment for NVIDIA Hopper (sm_90a).
//
// Replaces the two Pallas kernels of src/repro/kernels/ich_kmeans/ich_kmeans.py:
//   * ich_kmeans_assign_kernel          <- ich_kmeans_assign (sequential
//                                          (T,) grid, _kmeans_kernel)
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
// What this simple design does about that: the centroids live in shared
// memory (dynamic above 48 KB; the wrapper raises above the 227 KB a block
// can have), each of a worker's slots is one thread (the store needs no
// step order, so a CTA runs all of its worker's slots at once), and a
// point's D features are re-read from L1 for each centroid. Point rows are
// gathered one thread per point, not coalesced across a warp; the aim of
// this version is to be right.

#include <cuda_runtime.h>
#include <stdint.h>

#include "segmented.cuh"

namespace {

constexpr int kThreads = 256;

// Assign the n_slots slots whose point ids start at `rows`; `cent` is the
// (K, D) centroid table in shared memory.
__device__ void assign_slots(const float* __restrict__ points,
                             const float* cent, const int* __restrict__ rows,
                             int64_t n_slots, int D, int K, int* out) {
  for (int64_t s = threadIdx.x; s < n_slots; s += blockDim.x) {
    const int id = rows[s];
    if (id < 0) continue;
    const float* p = points + (int64_t)id * D;
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
    out[id] = best;
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

// One CTA over all T*R slots.
__global__ void ich_kmeans_assign_kernel(const float* __restrict__ points,
                                         const float* __restrict__ centroids,
                                         const int* __restrict__ rowid,
                                         int* out, int64_t n_slots, int D,
                                         int K) {
  extern __shared__ float cent[];
  load_centroids(centroids, K * D, cent);
  assign_slots(points, cent, rowid, n_slots, D, K, out);
}

// Raise the kernel's dynamic shared-memory limit when it needs more than
// the default 48 KB.
template <typename Kernel>
int allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
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

// Launch the sequential kernel on `stream`; out must be zeroed (n,) int32.
int ich_kmeans_assign_launch(const float* points, const float* centroids,
                             const int* rowid, int* out, int64_t n_slots,
                             int D, int K, void* stream) {
  const size_t smem = (size_t)K * D * sizeof(float);
  const int err = allow_smem(ich_kmeans_assign_kernel, smem);
  if (err != 0) return err;
  ich_kmeans_assign_kernel<<<1, kThreads, smem, (cudaStream_t)stream>>>(
      points, centroids, rowid, out, n_slots, D, K);
  return (int)cudaGetLastError();
}

}  // extern "C"
