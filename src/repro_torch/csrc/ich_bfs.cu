// iCh-scheduled pull-direction BFS frontier step for NVIDIA Hopper (sm_90a).
//
// Replaces the two Pallas kernels of src/repro/kernels/ich_bfs/ich_bfs.py:
//   * the flat walk (ich_bfs_step_launch: flat_slot_partials +
//     flat_fold_rows)          <- ich_bfs_step (sequential (T,) grid,
//                                 _bfs_kernel, ich_bfs.py:90)
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
//   hit = max_w mask[t, r, w] * frontier[cols[t, r, w]]   (from 0.0f)
//   inc = hit * (1 - visited[row])
// and the slots' values fold into the next frontier with "max": vertex u
// joins iff some in-neighbor is on the frontier and u is unvisited. A
// split adjacency list (a heavy vertex over several slots, possibly over
// several tiles) ORs together through the shared fold of segmented.cuh
// (MaxFold). The indicators are exact 0/1 floats, so every order of the
// max gives the same bits: sharded == flat == plain, exactly.
//
// The flat walk (the cross-check path, run at every BFS level) is SpMV's
// two-phase walk over the whole card (flat_walk.cuh; see ich_spmv.cu):
// phase A computes every slot's inc in parallel through a two-stage
// shared-memory ring (cp.async.bulk with an mbarrier; 4-byte cp.async
// when W is not a multiple of 4) into a (T*R,) scratch, and phase B gives
// each vertex to the one thread at the head of its run of slots, which
// max-folds the run in tile order and writes the vertex once, from the
// zeroed output: one owner a vertex, no atomics, the same bits as the
// single-CTA walk it replaces. The serial part left is the longest run:
// the scale-free graph's heaviest vertex, 2,091 slots at W = 8 at
// 1,000,000 vertices, all folded by one thread. It reads only the flat
// payload and flat rowid, never the shard layout.
//
// The sharded kernel: as in ich_spmv.cu, one CTA per worker walks that
// worker's S_B supersteps in ascending order with a barrier between steps,
// and the item-closed partition makes every vertex one worker's, so it
// writes straight into one zeroed (n,) output — no (p, n) accumulators
// (0.5 GB at p = 132 and a million vertices), no atomics — and only the
// vertices its slots name. The cost stream is SpMV's: the masked left fold
// of slot_cost over each step's slots.
//
// What bounds them. Bytes: each real slot moves W*(4 + 4) bytes of mask
// and cols plus 4 of rowid (and 4 of slot_cost for the sharded kernel);
// frontier and visited are gathered (n floats each, mostly from the 50 MB
// L2) and the output written once. A multiply and a max per edge lane are
// far below the card's ratio of compute to bandwidth. Neither kernel stops
// a slot's lane loop at the first hit, so the time does not depend on the
// frontier; the 0/1 mask is read as float where a bit would do. The
// sharded kernel is still the simple design (one 128-thread CTA per
// worker, no double buffering), so it tracks steps per worker, not bytes.

#include <cuda_runtime.h>
#include <stdint.h>

#include "flat_walk.cuh"
#include "segmented.cuh"

namespace {

constexpr int kThreads = 128;   // sharded kernel: one CTA per worker

// The flat walk's arithmetic (flat_walk.cuh): a lane's product and a
// slot's max over its lanes, exactly as expand_tiles below does them.
struct BfsLanes {
  const float* frontier;
  const float* visited;
  __device__ float lane(float m, int c) const {
    return __fmul_rn(m, __ldg(frontier + c));
  }
  __device__ float slot(const float* lanes, int W, int row) const {
    float hit = 0.0f;
#pragma unroll 4
    for (int w = 0; w < W; ++w) hit = fmaxf(hit, lanes[w]);
    return __fmul_rn(hit, __fsub_rn(1.0f, __ldg(visited + row)));
  }
};

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
  ich::fold_runs<ich::MaxFold, 1, int>(srow, partial, n, R, out,
                                     (int)threadIdx.x, (int)blockDim.x);
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

// Launch the flat walk on `stream` (T > 0) into out (n,), which it zeroes;
// partial is (T*R,) scratch. Two kernels: the slot values over the whole
// card, then the ordered max-fold of each vertex by its owner. Returns 0,
// a CUDA error code, or -1 when W needs more shared memory than one CTA
// has.
int ich_bfs_step_launch(const float* mask, const int* cols, const int* rowid,
                        const float* frontier, const float* visited,
                        float* out, int64_t n, float* partial, int64_t T,
                        int R, int W, void* stream) {
  return ich::flat::walk<BfsLanes, ich::MaxFold>(
      mask, cols, rowid, BfsLanes{frontier, visited}, partial, out, n, T, R,
      W, (cudaStream_t)stream);
}

// The flat walk's launch shape for 16-byte-aligned payloads, as five ints
// (see ich_spmv_flat_shape). Returns as ich_bfs_step_launch does.
int ich_bfs_flat_shape(int64_t T, int R, int W, int* out) {
  ich::flat::Shape sh;
  const int err = ich::flat::shape<BfsLanes>(T, R, W, true, &sh);
  if (err == 0) ich::flat::to_ints(sh, out);
  return err;
}

}  // extern "C"
