// iCh-scheduled segmented CSR SpMV for NVIDIA Hopper (sm_90a).
//
// Replaces the two Pallas kernels of src/repro/kernels/ich_spmv/ich_spmv.py:
//   * ich_spmv_kernel          <- ich_spmv (sequential (T,) grid, _spmv_kernel)
//   * ich_spmv_sharded_kernel  <- ich_spmv_sharded ((p, S_B) grid,
//                                 _spmv_sharded_body, with its cost stream and
//                                 the host-side worker_reduce folded away)
//
// What they compute. The payload is the flat (T_pad, R, W) pack of the CSR
// matrix built by the iCh schedule: slot (t, r) holds up to W nonzeros of
// row rowid[t, r] (-1 = padding slot). For each tile,
//   partial[r] = sum_w vals[t, r, w] * x[cols[t, r, w]]      (w ascending)
// and the R partials fold into y: the slots of one tile that share a row
// are summed first (ascending slot order), and that sum is added to y[row]
// once, tiles in ascending order. Both kernels run every tile through the
// one __device__ function `fold_tiles`, so within a row the arithmetic is
// the same sequence of IEEE float adds and multiplies however tiles are
// batched into steps: the sharded kernel equals the sequential one bit for
// bit. Adds and multiplies use __fadd_rn/__fmul_rn so that no FMA
// contraction changes that sequence. The fold into y and the cost stream
// are the shared epilogue of segmented.cuh (AddFold).
//
// Ordering without races. The TPU grid runs its steps in order on one core;
// here one CTA stands for one worker and walks that worker's S_B supersteps
// in ascending order, with a barrier between steps. The shard partition is
// item-closed (every row is owned by exactly one worker), so the sharded
// kernel writes straight into one zeroed (n_rows,) y with no float atomics,
// and only the rows that a tile's slots name are written: the reference's
// length-R window write-back would also rewrite rows another worker owns.
// Within a step, one thread folds each row's run of slots, and distinct
// runs of a step name distinct rows.
//
// Cost stream. With slot_cost, the sharded kernel writes costs[w, j] = the
// left fold in slot order of slot_cost over the slots of step j whose row
// is >= 0 (padding steps read block 0, clamped, whose rows are all -1).
//
// What bounds it. Bytes: each real slot moves W*(4 + 4) bytes of vals and
// cols plus 4 of slot_cost and 4 of rowid; x is gathered (n floats, mostly
// from the 50 MB L2) and y written once. The multiply-adds are ~1 FLOP per
// byte, far below the card's ratio of compute to bandwidth. The padded pack
// carries more slots than the matrix has nonzeros (iCh pads each row's last
// segment to W), so the bound is stated on the bytes of this pack.
//
// What this simple design does about that: nothing yet. One CTA per worker
// (p CTAs, 128 threads, one thread per slot) issues its gathers with no
// cp.async/TMA double buffering of the next superstep and no more CTAs than
// workers, so it cannot reach the bandwidth bound; the aim of this version
// is to be right and to keep the sharded == sequential bit identity.
// Payload offsets are computed in 64 bits (blk * B * R * W exceeds 2^31
// slots on large matrices).

#include <cuda_runtime.h>
#include <stdint.h>

#include "segmented.cuh"

namespace {

constexpr int kThreads = 128;
// tiles per step of the sequential walk (any value gives the same bits)
constexpr int kSeqTiles = 32;

// Fold `ntiles` consecutive tiles of the flat payload, starting at flat
// tile `tile0`, into y. `rows` points at their ntiles*R row ids. When
// `cost_out` is set, thread 0 also writes the masked slot-cost fold of
// these tiles there (`slot_cost` points at tile0's first slot cost).
// Shared scratch: `partial` and `srow`, ntiles*R entries each.
__device__ void fold_tiles(const float* __restrict__ vals,
                           const int* __restrict__ cols,
                           const int* __restrict__ rows, int64_t tile0,
                           int ntiles, int R, int W,
                           const float* __restrict__ x, float* y,
                           const float* __restrict__ slot_cost,
                           float* cost_out, float* partial, int* srow) {
  const int n = ntiles * R;
  const int64_t slot0 = tile0 * (int64_t)R;
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    const int row = rows[k];
    float acc = 0.0f;
    if (row >= 0) {
      const int64_t off = (slot0 + k) * (int64_t)W;
      const float* v = vals + off;
      const int* c = cols + off;
      for (int w = 0; w < W; ++w) {
        acc = __fadd_rn(acc, __fmul_rn(v[w], x[c[w]]));
      }
    }
    srow[k] = row;
    partial[k] = acc;
  }
  __syncthreads();
  ich::fold_runs<ich::AddFold>(srow, partial, n, R, y);
  if (cost_out != nullptr && threadIdx.x == 0) {
    *cost_out = ich::masked_cost(srow, slot_cost + slot0, n);
  }
  // the next step overwrites the scratch and may read rows stored here
  __syncthreads();
}

// One CTA per worker w: walk its S_B supersteps in ascending order.
__global__ void ich_spmv_sharded_kernel(
    const float* __restrict__ vals, const int* __restrict__ cols,
    const int* __restrict__ rowid, const int* __restrict__ blkid,
    const float* __restrict__ slot_cost, const float* __restrict__ x,
    float* y, float* costs, int S_B, int B, int R, int W) {
  extern __shared__ unsigned char smem[];
  float* partial = reinterpret_cast<float*>(smem);
  int* srow = reinterpret_cast<int*>(partial + B * R);
  const int64_t w = blockIdx.x;
  for (int j = 0; j < S_B; ++j) {
    const int64_t step = w * S_B + j;
    const int64_t tile0 = (int64_t)blkid[step] * B;
    const int* rows = rowid + step * B * (int64_t)R;
    fold_tiles(vals, cols, rows, tile0, B, R, W, x, y, slot_cost,
               costs != nullptr ? costs + step : nullptr, partial, srow);
  }
}

// One CTA walks all T tiles in order.
__global__ void ich_spmv_kernel(const float* __restrict__ vals,
                                const int* __restrict__ cols,
                                const int* __restrict__ rowid,
                                const float* __restrict__ x, float* y,
                                int64_t T, int R, int W) {
  extern __shared__ unsigned char smem[];
  float* partial = reinterpret_cast<float*>(smem);
  int* srow = reinterpret_cast<int*>(partial + kSeqTiles * R);
  for (int64_t t0 = 0; t0 < T; t0 += kSeqTiles) {
    const int nt = (int)(T - t0 < kSeqTiles ? T - t0 : kSeqTiles);
    fold_tiles(vals, cols, rowid + t0 * R, t0, nt, R, W, x, y, nullptr,
               nullptr, partial, srow);
  }
}

}  // namespace

extern "C" {

// Launch the sharded kernel on `stream`; y must be zeroed (n_rows,) and
// costs (p*S_B,) or null (then slot_cost is ignored). Returns the launch's
// cudaGetLastError() code (0 = success).
int ich_spmv_sharded_launch(const float* vals, const int* cols,
                            const int* rowid, const int* blkid,
                            const float* slot_cost, const float* x, float* y,
                            float* costs, int p, int S_B, int B, int R, int W,
                            void* stream) {
  const size_t smem = (size_t)B * R * (sizeof(float) + sizeof(int));
  ich_spmv_sharded_kernel<<<p, kThreads, smem, (cudaStream_t)stream>>>(
      vals, cols, rowid, blkid, slot_cost, x, y, costs, S_B, B, R, W);
  return (int)cudaGetLastError();
}

// Launch the sequential kernel on `stream`; y must be zeroed (n_rows,).
int ich_spmv_launch(const float* vals, const int* cols, const int* rowid,
                    const float* x, float* y, int64_t T, int R, int W,
                    void* stream) {
  const size_t smem = (size_t)kSeqTiles * R * (sizeof(float) + sizeof(int));
  ich_spmv_kernel<<<1, kThreads, smem, (cudaStream_t)stream>>>(
      vals, cols, rowid, x, y, T, R, W);
  return (int)cudaGetLastError();
}

// Tiles per step of the sequential walk, so the caller can check the
// shared-memory size before launching.
int ich_spmv_seq_tiles(void) { return kSeqTiles; }

}  // extern "C"
