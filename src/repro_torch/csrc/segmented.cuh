// The segmented epilogue shared by the iCh kernels for Hopper (sm_90a):
// the counterpart of src/repro/core/segmented.py's segmented_apply[_batch]
// and emit_step_cost, inside a kernel instead of after it.
//
// A stretch of n slots, starting at a tile boundary, has one value per
// slot, partial[k] for slot k on row srow[k] (-1 = padding slot): in
// shared memory for one window of the sharded walk (sharded_walk.cuh,
// which starts a run that goes on from the previous window from the value
// that window left), in global memory for the whole flat stream in the
// flat walk's phase B (flat_walk.cuh).
// Same-row slots are consecutive (construction emits segments in item
// order), and a row's run may cross tile boundaries (a split row).
// `fold_runs` gives each run to one thread, which folds the run's slots of
// one tile first, in ascending slot order, and then folds that per-tile
// value into y[row] once per tile, tiles in ascending order, starting from
// 0.0f (the flat walk's zeroed y) or from the value the previous window
// handed over (the sharded walk). The fold is templated on the combine:
//   * AddFold — the SpMV "add": adds with __fadd_rn, so no FMA contraction
//     changes the sequence of IEEE adds;
//   * MaxFold — the BFS "max": exact in any order.
// (The K-Means "store" needs no fold: every slot of a point computes the
// same id, so ich_kmeans.cu writes it straight.) Only the rows the slots
// name are written; the reference's window write-back of uncovered rows
// would race the row's owning CTA on a card.
//
// `masked_cost` is one superstep's executed cost: the left fold in slot
// order of slot_cost over the slots whose row is >= 0.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace ich {

struct AddFold {
  __device__ static float within(float a, float b) { return __fadd_rn(a, b); }
  __device__ static float across(float out, float g) {
    return __fadd_rn(out, g);
  }
};

struct MaxFold {
  __device__ static float within(float a, float b) { return fmaxf(a, b); }
  __device__ static float across(float out, float g) { return fmaxf(out, g); }
};

// Fold the run of `row` that starts at slot k (a run head) into `out`:
// the run's slots of one tile with Fold::within in ascending slot order,
// each tile's value with Fold::across, tiles ascending. The walk reads
// kAhead slots (row id and value) at a time, all in flight before any is
// tested, so a long run waits on one load latency per kAhead slots, not
// per slot; the operations and their order do not depend on kAhead.
template <class Fold, int kAhead, class Index>
__device__ inline float fold_run(const int* srow, const float* partial,
                                 Index k, Index n, int R, int row,
                                 float out) {
  Index tile_end = k - k % R + R;
  float g = partial[k];
  for (Index i = k + 1;; i += kAhead) {
    int r[kAhead];
    float v[kAhead];
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      r[j] = i + j < n ? srow[i + j] : -1;
      v[j] = i + j < n ? partial[i + j] : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < kAhead; ++j) {
      if (r[j] != row) return Fold::across(out, g);
      if (i + j == tile_end) {
        out = Fold::across(out, g);
        g = v[j];
        tile_end += R;
      } else {
        g = Fold::within(g, v[j]);
      }
    }
  }
}

// Fold the n slot values into y (see above): the thread that sees slot
// k = first, first + stride, ... at a run head owns that run's row.
template <class Fold, int kAhead, class Index>
__device__ inline void fold_runs(const int* srow, const float* partial,
                                 Index n, int R, float* y, Index first,
                                 Index stride) {
  for (Index k = first; k < n; k += stride) {
    const int row = srow[k];
    if (row < 0 || (k > 0 && srow[k - 1] == row)) continue;
    y[row] = fold_run<Fold, kAhead>(srow, partial, k, n, R, row, y[row]);
  }
}

// Left fold in slot order of slot_cost[k] over the n slots with
// rows[k] >= 0 (padding steps read a clamped block whose rows are -1).
__device__ inline float masked_cost(const int* rows, const float* slot_cost,
                                    int n) {
  float c = 0.0f;
  for (int k = 0; k < n; ++k) {
    c = __fadd_rn(c, rows[k] >= 0 ? slot_cost[k] : 0.0f);
  }
  return c;
}

}  // namespace ich
