// iCh-scheduled segmented CSR SpMV for NVIDIA Hopper (sm_90a).
//
// Replaces the two Pallas kernels of src/repro/kernels/ich_spmv/ich_spmv.py:
//   * the flat walk (ich_spmv_launch: flat_slot_partials + flat_fold_rows)
//                              <- ich_spmv (sequential (T,) grid,
//                                 _spmv_kernel, ich_spmv.py:109)
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
// The sharded kernel. The TPU grid runs its steps in order on one core;
// here one CTA stands for one worker and walks that worker's S_B
// supersteps in ascending order, with a barrier between steps. The shard
// partition is item-closed (every row is owned by exactly one worker), so
// it writes straight into one zeroed (n_rows,) y with no float atomics,
// and only the rows that a tile's slots name are written: the reference's
// length-R window write-back would also rewrite rows another worker owns.
// Within a step, one thread folds each row's run of slots (fold_runs), and
// distinct runs of a step name distinct rows. Both kernels compute a slot
// partial with the same left fold, so sharded == flat bit for bit.
//
// Cost stream. With slot_cost, the sharded kernel writes costs[w, j] = the
// left fold in slot order of slot_cost over the slots of step j whose row
// is >= 0 (padding steps read block 0, clamped, whose rows are all -1).
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
// The sharded kernel is still the simple design: one CTA per worker (p
// CTAs, 128 threads, one thread per slot) makes its gathers with no
// double buffering of the next superstep, so it tracks steps per worker,
// not bytes. Payload offsets are computed in 64 bits (blk * B * R * W
// exceeds 2^31 slots on large matrices).

#include <cuda_runtime.h>
#include <stdint.h>

#include "flat_walk.cuh"
#include "segmented.cuh"

namespace {

constexpr int kThreads = 128;   // sharded kernel: one CTA per worker

// The flat walk's arithmetic (flat_walk.cuh): a lane's product and a
// slot's left fold, exactly as fold_tiles below does them.
struct SpmvLanes {
  const float* x;
  __device__ float lane(float v, int c) const {
    return __fmul_rn(v, __ldg(x + c));
  }
  __device__ float slot(const float* lanes, int W, int) const {
    float acc = 0.0f;
#pragma unroll 4
    for (int w = 0; w < W; ++w) acc = __fadd_rn(acc, lanes[w]);
    return acc;
  }
};

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
  ich::fold_runs<ich::AddFold, 1, int>(srow, partial, n, R, y,
                                     (int)threadIdx.x, (int)blockDim.x);
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
