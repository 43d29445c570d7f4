// iCh-scheduled pull-direction BFS frontier step for NVIDIA Hopper (sm_90a).
//
// Replaces the two Pallas kernels of src/repro/kernels/ich_bfs/ich_bfs.py:
//   * ich_bfs_step_kernel          <- ich_bfs_step (sequential (T,) grid,
//                                     _bfs_kernel)
//   * ich_bfs_step_sharded_kernel  <- ich_bfs_step_sharded ((p, S_B) grid,
//                                     _bfs_sharded_body, with its cost stream
//                                     and the host-side worker_reduce "max"
//                                     folded away)
//
// What they compute. The graph is a CSR whose row u lists u's in-neighbors,
// packed by the iCh schedule into the flat (T_pad, R, W) layout: slot
// (t, r) holds up to W in-neighbors of vertex rowid[t, r] (-1 = padding
// slot), and `mask` is 1.0 on real edge lanes, 0.0 on padding lanes. For
// each slot
//   hit = max_w mask[t, r, w] * frontier[cols[t, r, w]]
//   inc = hit * (1 - visited[row])
// and the slots' values fold into the next frontier with "max": vertex u
// joins iff some in-neighbor is on the frontier and u is unvisited. A
// split adjacency list (a heavy vertex over several slots, possibly over
// several tiles) ORs together through the shared fold of segmented.cuh
// (MaxFold). The indicators are exact 0/1 floats, so every order of the
// max gives the same bits: sharded == sequential == plain, exactly.
//
// Ordering without races: as in ich_spmv.cu, one CTA per worker walks that
// worker's S_B supersteps in ascending order with a barrier between steps,
// and the item-closed partition makes every vertex one worker's, so the
// sharded kernel writes straight into one zeroed (n,) output — no (p, n)
// accumulators (0.5 GB at p = 132 and a million vertices), no atomics —
// and only the vertices its slots name. The cost stream is SpMV's: the
// masked left fold of slot_cost over each step's slots.
//
// What bounds it. Bytes: each real slot moves W*(4 + 4) bytes of mask and
// cols plus 4 of rowid and 4 of slot_cost; frontier and visited are
// gathered (n floats each, mostly from the 50 MB L2) and the output
// written once. A multiply and a max per edge lane are far below the
// card's ratio of compute to bandwidth.
//
// What this simple design does about that: nothing yet, as for SpMV. One
// 128-thread CTA per worker, one thread per slot, no cp.async/TMA double
// buffering of the next superstep, and the 0/1 mask is read as float where
// a bit would do; the aim of this version is to be right. It does not stop
// a slot's lane loop at the first hit, so its time does not depend on the
// frontier.

#include <cuda_runtime.h>
#include <stdint.h>

#include "segmented.cuh"

namespace {

constexpr int kThreads = 128;
// tiles per step of the sequential walk (any value gives the same bits)
constexpr int kSeqTiles = 32;

// Expand `ntiles` consecutive tiles of the flat payload, starting at flat
// tile `tile0`, into `out`. `rows` points at their ntiles*R vertex ids.
// When `cost_out` is set, thread 0 also writes the masked slot-cost fold
// of these tiles there (`slot_cost` is the flat (T_pad, R) stream).
// Shared scratch: `partial` and `srow`, ntiles*R entries each.
__device__ void expand_tiles(const float* __restrict__ mask,
                             const int* __restrict__ cols,
                             const int* __restrict__ rows, int64_t tile0,
                             int ntiles, int R, int W,
                             const float* __restrict__ frontier,
                             const float* __restrict__ visited, float* out,
                             const float* __restrict__ slot_cost,
                             float* cost_out, float* partial, int* srow) {
  const int n = ntiles * R;
  const int64_t slot0 = tile0 * (int64_t)R;
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    const int row = rows[k];
    float inc = 0.0f;
    if (row >= 0) {
      const int64_t off = (slot0 + k) * (int64_t)W;
      const float* m = mask + off;
      const int* c = cols + off;
      float hit = 0.0f;
      for (int w = 0; w < W; ++w) {
        hit = fmaxf(hit, __fmul_rn(m[w], frontier[c[w]]));
      }
      inc = __fmul_rn(hit, __fsub_rn(1.0f, visited[row]));
    }
    srow[k] = row;
    partial[k] = inc;
  }
  __syncthreads();
  ich::fold_runs<ich::MaxFold>(srow, partial, n, R, out);
  if (cost_out != nullptr && threadIdx.x == 0) {
    *cost_out = ich::masked_cost(srow, slot_cost + slot0, n);
  }
  // the next step overwrites the scratch and may read vertices stored here
  __syncthreads();
}

// One CTA per worker w: walk its S_B supersteps in ascending order.
__global__ void ich_bfs_step_sharded_kernel(
    const float* __restrict__ mask, const int* __restrict__ cols,
    const int* __restrict__ rowid, const int* __restrict__ blkid,
    const float* __restrict__ slot_cost, const float* __restrict__ frontier,
    const float* __restrict__ visited, float* out, float* costs, int S_B,
    int B, int R, int W) {
  extern __shared__ unsigned char smem[];
  float* partial = reinterpret_cast<float*>(smem);
  int* srow = reinterpret_cast<int*>(partial + B * R);
  const int64_t w = blockIdx.x;
  for (int j = 0; j < S_B; ++j) {
    const int64_t step = w * S_B + j;
    const int64_t tile0 = (int64_t)blkid[step] * B;
    const int* rows = rowid + step * B * (int64_t)R;
    expand_tiles(mask, cols, rows, tile0, B, R, W, frontier, visited, out,
                 slot_cost, costs != nullptr ? costs + step : nullptr,
                 partial, srow);
  }
}

// One CTA walks all T tiles in order.
__global__ void ich_bfs_step_kernel(const float* __restrict__ mask,
                                    const int* __restrict__ cols,
                                    const int* __restrict__ rowid,
                                    const float* __restrict__ frontier,
                                    const float* __restrict__ visited,
                                    float* out, int64_t T, int R, int W) {
  extern __shared__ unsigned char smem[];
  float* partial = reinterpret_cast<float*>(smem);
  int* srow = reinterpret_cast<int*>(partial + kSeqTiles * R);
  for (int64_t t0 = 0; t0 < T; t0 += kSeqTiles) {
    const int nt = (int)(T - t0 < kSeqTiles ? T - t0 : kSeqTiles);
    expand_tiles(mask, cols, rowid + t0 * R, t0, nt, R, W, frontier, visited,
                 out, nullptr, nullptr, partial, srow);
  }
}

}  // namespace

extern "C" {

// Launch the sharded kernel on `stream`; out must be zeroed (n,) and costs
// (p*S_B,) or null (then slot_cost is ignored). Returns the launch's
// cudaGetLastError() code (0 = success).
int ich_bfs_step_sharded_launch(const float* mask, const int* cols,
                                const int* rowid, const int* blkid,
                                const float* slot_cost, const float* frontier,
                                const float* visited, float* out,
                                float* costs, int p, int S_B, int B, int R,
                                int W, void* stream) {
  const size_t smem = (size_t)B * R * (sizeof(float) + sizeof(int));
  ich_bfs_step_sharded_kernel<<<p, kThreads, smem, (cudaStream_t)stream>>>(
      mask, cols, rowid, blkid, slot_cost, frontier, visited, out, costs, S_B,
      B, R, W);
  return (int)cudaGetLastError();
}

// Launch the sequential kernel on `stream`; out must be zeroed (n,).
int ich_bfs_step_launch(const float* mask, const int* cols, const int* rowid,
                        const float* frontier, const float* visited,
                        float* out, int64_t T, int R, int W, void* stream) {
  const size_t smem = (size_t)kSeqTiles * R * (sizeof(float) + sizeof(int));
  ich_bfs_step_kernel<<<1, kThreads, smem, (cudaStream_t)stream>>>(
      mask, cols, rowid, frontier, visited, out, T, R, W);
  return (int)cudaGetLastError();
}

// Tiles per step of the sequential walk, so the caller can check the
// shared-memory size before launching.
int ich_bfs_seq_tiles(void) { return kSeqTiles; }

}  // extern "C"
