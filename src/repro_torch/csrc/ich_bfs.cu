// iCh-scheduled pull-direction BFS frontier step for NVIDIA Hopper (sm_90a).
//
// Replaces the two Pallas kernels of src/repro/kernels/ich_bfs/ich_bfs.py:
//   * the flat walk (ich_bfs_step_launch: flat_slot_partials +
//     flat_fold_rows)          <- ich_bfs_step (sequential (T,) grid,
//                                 _bfs_kernel, ich_bfs.py:90)
//   * the sharded walk (ich_bfs_step_sharded_launch: sharded_walk)
//                              <- ich_bfs_step_sharded ((p, S_B) grid,
//                                 _bfs_sharded_body, ich_bfs.py:195, with
//                                 its cost stream and the host-side
//                                 worker_reduce "max" folded away)
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
// The sharded walk (sharded_walk.cuh, the walk ich_spmv.cu's sharded
// kernel runs): one CTA of 768 threads per worker, so the schedule's LPT
// balance is the card's; its three pipelines take the worker's windows of
// whole tiles in turn, each through its own three-stage shared-memory ring
// that its warp 0 fills ahead with cp.async.bulk (4-byte cp.async when W
// or R is not a multiple of 4 or a pointer is not 16-byte aligned). Lanes
// (mask * frontier[col]) go to a table, one thread per slot max-folds them
// and masks the slot with its vertex's visited bit (BfsLanes::finish), and
// the thread at each run head max-folds the run (fold_run with MaxFold); a
// heavy vertex's run that crosses windows is handed on through the walk's
// carry links, so each vertex is written once, with no atomics and the
// output never read. The item-closed partition makes every vertex one
// worker's, so it writes straight into one zeroed (n,) output (no (p, n)
// accumulators: 0.5 GB at p = 132 and a million vertices) and only the
// vertices its slots name. The cost stream is SpMV's: the masked left fold
// of slot_cost over each step's slots, one thread a step.
//
// What bounds them. Bytes: each real slot moves W*(4 + 4) bytes of mask
// and cols plus 4 of rowid (and 4 of slot_cost for the sharded walk);
// frontier and visited are gathered (n floats each, mostly from the 50 MB
// L2) and the output written once. A multiply and a max per edge lane are
// far below the card's ratio of compute to bandwidth. Neither walk stops a
// slot's lane loop at the first hit, so the time does not depend on the
// frontier; the 0/1 mask is read as float where a bit would do. What the
// sharded walk does about the bytes: up to 3 x 2 chunks of 2,048 lanes in
// flight per SM while the pipelines gather frontier bits and fold, the
// barriers of one pipeline hidden behind the other two's work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "flat_walk.cuh"
#include "segmented.cuh"
#include "sharded_walk.cuh"

namespace {

// The walks' arithmetic (flat_walk.cuh, sharded_walk.cuh): a lane's
// product, a slot's max over its lanes continued from `acc` (w ascending;
// the max of 0/1 values is exact in any order) and the slot's increment,
// masked by its vertex's visited bit.
struct BfsLanes {
  const float* frontier;
  const float* visited;
  __device__ float lane(float m, int c) const {
    return __fmul_rn(m, __ldg(frontier + c));
  }
  __device__ float step(float acc, const float* lanes, int n) const {
#pragma unroll 4
    for (int w = 0; w < n; ++w) acc = fmaxf(acc, lanes[w]);
    return acc;
  }
  __device__ float finish(float acc, int row) const {
    return __fmul_rn(acc, __fsub_rn(1.0f, __ldg(visited + row)));
  }
  __device__ float slot(const float* lanes, int W, int row) const {
    return finish(step(0.0f, lanes, W), row);
  }
};

}  // namespace

extern "C" {

// Launch the sharded walk on `stream` (T_pad > 0): out must be zeroed
// (n,) and costs (p*S_B,) or null (then slot_cost is ignored). Returns 0,
// a CUDA error code, or -1 when the shapes need more shared memory than
// one CTA has (a tile of thousands of slots).
int ich_bfs_step_sharded_launch(const float* mask, const int* cols,
                                const int* rowid, const int* blkid,
                                const float* slot_cost, const float* frontier,
                                const float* visited, float* out,
                                float* costs, int p, int S_B, int B, int R,
                                int W, void* stream) {
  return ich::sharded::walk<BfsLanes, ich::MaxFold>(
      mask, cols, rowid, blkid, slot_cost, BfsLanes{frontier, visited}, out,
      costs, p, S_B, B, R, W, (cudaStream_t)stream);
}

// The sharded walk's launch shape as eight ints (see
// ich_spmv_sharded_shape). Returns as ich_bfs_step_sharded_launch does.
int ich_bfs_sharded_shape(int p, int S_B, int B, int R, int W, int bulk,
                          int* out) {
  ich::sharded::Shape sh;
  const int err = ich::sharded::shape<BfsLanes, ich::MaxFold>(
      p, S_B, B, R, W, bulk != 0 && W % 4 == 0 && R % 4 == 0, &sh);
  if (err == 0) ich::sharded::to_ints(sh, out);
  return err;
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
