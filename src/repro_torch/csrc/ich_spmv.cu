// iCh-scheduled segmented CSR SpMV for NVIDIA Hopper (sm_90a).
//
// Replaces the two Pallas kernels of src/repro/kernels/ich_spmv/ich_spmv.py:
//   * the flat walk (ich_spmv_launch: flat_slot_partials + flat_fold_rows)
//                              <- ich_spmv (sequential (T,) grid,
//                                 _spmv_kernel, ich_spmv.py:109)
//   * the sharded walk (ich_spmv_sharded_launch: sharded_walk)
//                              <- ich_spmv_sharded ((p, S_B) grid,
//                                 _spmv_sharded_body, ich_spmv.py:215, with
//                                 its cost stream and the host-side
//                                 worker_reduce folded away)
//
// What they compute. The payload is the flat (T_pad, R, W) pack of the CSR
// matrix built by the iCh schedule: slot (t, r) holds up to W nonzeros of
// row rowid[t, r] (-1 = padding slot). For each tile,
//   partial[r] = sum_w vals[t, r, w] * x[cols[t, r, w]]      (w ascending)
// and the R partials fold into y: the slots of one tile that share a row
// are summed first (ascending slot order), and that sum is added to y[row]
// once, tiles in ascending order, from y's 0.0f. Within a row this is one
// fixed sequence of IEEE float adds and multiplies, however the work is
// spread over the card: the flat walk, the sharded kernel and the plain
// versions give the same bits. Adds and multiplies use __fadd_rn/__fmul_rn
// so that no FMA contraction changes that sequence.
//
// The flat walk (the cross-check path) runs on the whole card in two
// launches (flat_walk.cuh): phase A computes every slot partial in
// parallel — a persistent grid of as many 256-thread CTAs as fit on the
// 132 SMs streams chunks of consecutive slots through a two-stage
// shared-memory ring (cp.async.bulk with an mbarrier; 4-byte cp.async when
// W is not a multiple of 4) and writes one float a slot to a (T*R,)
// scratch; phase B gives each row to the one thread at the head of its run
// of slots, which folds the run in the order above (segmented.cuh's
// fold_runs with AddFold) and writes y[row] once. The order that the TPU
// grid imposed only binds the slots of one row, and each row has one
// owner, so the bits are kept with no atomics. The serial part left is the
// longest run of one row: 27 slots on the `wikipedia` matrix at W = 32.
// The flat walk reads only the flat payload and the flat (T, R) rowid,
// never the shard layout, so it stays an independent check of sharding.
//
// The sharded kernel (sharded_walk.cuh). The TPU grid runs its steps in
// order on one core; here one CTA of 768 threads stands for one worker.
// Its three pipelines of 256 threads take the worker's windows (whole
// tiles, in order) in turn, each through its own three-stage
// shared-memory ring that its warp 0 fills ahead with cp.async.bulk
// (4-byte cp.async when W or R is not a multiple of 4 or a pointer is not
// 16-byte aligned): all its threads evaluate a window's lanes, one thread
// per slot folds them, and the thread at each run head folds the run
// (fold_run with AddFold). A run that goes on from the previous window
// starts from the value that window's pipeline handed over, so each row
// is folded in tile order and written once. The shard partition is
// item-closed (every row is owned by exactly one worker), so it writes
// straight into one (n_rows,) y with no float atomics, and only the rows
// that a tile's slots name are written: the reference's length-R window
// write-back would also rewrite rows another worker owns. Both kernels
// compute a slot partial with the same left fold and fold a row's slots
// in the same order, so sharded == flat bit for bit.
//
// Cost stream. With slot_cost, the sharded kernel writes costs[w, j] = the
// left fold in slot order of slot_cost over the slots of step j whose row
// is >= 0, one thread a step (a padding step, blkid clamped to block 0,
// has rows all -1: it fetches no payload and emits 0).
//
// What bounds them. Bytes: each real slot moves W*(4 + 4) bytes of vals
// and cols plus 4 of rowid (and 4 of slot_cost for the sharded kernel); x
// is gathered (n floats, mostly from the 50 MB L2) and y written once. The
// multiply-adds are ~1 FLOP per 4 bytes, far below the card's ratio of
// compute to bandwidth. The padded pack carries more slots than the matrix
// has nonzeros (iCh pads each row's last segment to W), so the bound is
// stated on the bytes of this pack. The flat walk's scratch adds 8 bytes a
// slot (written, read back from L2).
//
// Payload offsets are computed in 64 bits (blk * B * R * W exceeds 2^31
// slots on large matrices).

#include <cuda_runtime.h>
#include <stdint.h>

#include "flat_walk.cuh"
#include "segmented.cuh"
#include "sharded_walk.cuh"

namespace {

// The walks' arithmetic (flat_walk.cuh, sharded_walk.cuh): a lane's
// product and a slot's left fold over its lanes, w ascending from 0.0f.
struct SpmvLanes {
  const float* x;
  __device__ float lane(float v, int c) const {
    return __fmul_rn(v, __ldg(x + c));
  }
  __device__ float step(float acc, const float* lanes, int n) const {
#pragma unroll 4
    for (int w = 0; w < n; ++w) acc = __fadd_rn(acc, lanes[w]);
    return acc;
  }
  __device__ float finish(float acc, int) const { return acc; }
  __device__ float slot(const float* lanes, int W, int row) const {
    return finish(step(0.0f, lanes, W), row);
  }
};

}  // namespace

extern "C" {

// Launch the sharded walk on `stream` (T_pad > 0): y must be zeroed
// (n_rows,) and costs (p*S_B,) or null (then slot_cost is ignored).
// Returns 0, a CUDA error code, or -1 when the shapes need more shared
// memory than one CTA has (a tile of thousands of slots).
int ich_spmv_sharded_launch(const float* vals, const int* cols,
                            const int* rowid, const int* blkid,
                            const float* slot_cost, const float* x, float* y,
                            float* costs, int p, int S_B, int B, int R, int W,
                            void* stream) {
  return ich::sharded::walk<SpmvLanes, ich::AddFold>(
      vals, cols, rowid, blkid, slot_cost, SpmvLanes{x}, y, costs, p, S_B, B,
      R, W, (cudaStream_t)stream);
}

// The sharded walk's launch shape as eight ints: CTAs (= p), threads,
// ring stages a pipeline, shared memory, bulk copies (1) or 4-byte
// cp.async (0), tiles a window, chunks a window, pipelines a CTA. `bulk` says which copies the pointers
// allow. Returns as ich_spmv_sharded_launch does.
int ich_spmv_sharded_shape(int p, int S_B, int B, int R, int W, int bulk,
                           int* out) {
  ich::sharded::Shape sh;
  const int err = ich::sharded::shape<SpmvLanes, ich::AddFold>(
      p, S_B, B, R, W, bulk != 0 && W % 4 == 0 && R % 4 == 0, &sh);
  if (err == 0) ich::sharded::to_ints(sh, out);
  return err;
}

// Launch the flat walk on `stream` (T > 0) into y (n_rows,), which it
// zeroes; partial is (T*R,) scratch. Two kernels: the slot partials over
// the whole card, then the ordered fold of each row by its owner. Returns
// 0, a CUDA error code, or -1 when W needs more shared memory than one CTA
// has.
int ich_spmv_launch(const float* vals, const int* cols, const int* rowid,
                    const float* x, float* y, int64_t n_rows, float* partial,
                    int64_t T, int R, int W, void* stream) {
  return ich::flat::walk<SpmvLanes, ich::AddFold>(
      vals, cols, rowid, SpmvLanes{x}, partial, y, n_rows, T, R, W,
      (cudaStream_t)stream);
}

// The flat walk's launch shape for 16-byte-aligned payloads, as five ints:
// chunk slots, phase-A CTAs, phase-B CTAs, phase-A shared memory, bulk
// copies (1) or 4-byte cp.async (0). Returns as ich_spmv_launch does.
int ich_spmv_flat_shape(int64_t T, int R, int W, int* out) {
  ich::flat::Shape sh;
  const int err = ich::flat::shape<SpmvLanes>(T, R, W, true, &sh);
  if (err == 0) ich::flat::to_ints(sh, out);
  return err;
}

}  // extern "C"
