// The segmented epilogue shared by the iCh kernels for Hopper (sm_90a):
// the counterpart of src/repro/core/segmented.py's segmented_apply[_batch]
// and emit_step_cost, inside a kernel instead of after it.
//
// A step of B tiles has computed one value per slot, partial[k] for slot k
// on row srow[k] (-1 = padding slot), both in shared memory. Same-row
// slots are consecutive (construction emits segments in item order), and a
// row's run may cross tile boundaries (a split row). `fold_runs` gives
// each run to one thread, which folds the run's slots of one tile first,
// in ascending slot order, and then folds that per-tile value into
// y[row] once per tile, tiles in ascending order. The fold is templated on
// the combine:
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

// Fold the n = ntiles*R slot values of one step into y (see above). The
// caller synchronizes the block before (partial/srow written) and after
// (the next step overwrites them and may read rows stored here).
template <class Fold>
__device__ inline void fold_runs(const int* srow, const float* partial, int n,
                                 int R, float* y) {
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    const int row = srow[k];
    if (row < 0 || (k > 0 && srow[k - 1] == row)) continue;
    float out = y[row];
    int i = k;
    while (i < n && srow[i] == row) {
      const int tile_end = (i / R + 1) * R;
      float g = partial[i++];
      while (i < tile_end && i < n && srow[i] == row) {
        g = Fold::within(g, partial[i++]);
      }
      out = Fold::across(out, g);
    }
    y[row] = out;
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
