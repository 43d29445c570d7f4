// Two steps of the device schedule pipeline (repro_torch/core/tiling_torch.py)
// for NVIDIA Hopper (sm_90a).
//
// They replace no Pallas kernel: the reference runs both steps as XLA inside
// its jitted pipeline (src/repro/core/tiling_jax.py):
//   * segment_fold_kernel <- _segment_sum (tiling_jax.py:198-208), the
//                            block and chain folds of _partition (:286-289)
//   * lpt_assign_kernel   <- the lax.fori_loop of _partition (:292-300),
//                            itself the heapq loop of core/tiling.py's
//                            partition_tiles
// Eager PyTorch on the card can do neither exactly or fast: index_add_ and
// scatter_add_ add float64 with atomics, in an order that changes from run
// to run (one ulp in a chain cost can flip an LPT assignment), and the LPT
// loop is sequential (a Python loop of launches would take seconds).
//
// segment_fold. out[s] = the left fold from 0.0, in index order, of the
// values whose segment id is s, over a NON-DECREASING id stream: exactly
// np.bincount(ids, weights=values)'s addition order. One thread per element;
// the thread at the head of a run (the merge boundary: its id differs from
// its left neighbour's) walks the run with __dadd_rn and writes its segment;
// every other thread returns at once. Segments with no element keep the
// zero the wrapper filled. What bounds it: bytes (8 of value and 8 of id per
// element read once, 8 a segment written); the longest run is its serial
// part (a chain of many superstep blocks under one heavy item).
//
// lpt_assign. The LPT placement of partition_tiles: for each chain in
// `order` (heaviest first; ids >= n_real are phantom chains and are
// skipped), take the worker of least load, ties to the smallest worker id
// (heapq's (load, worker) tuple order), add the chain's cost to its load
// with __dadd_rn and record the worker. One warp keeps the p float64 loads
// in shared memory; per chain each lane takes the minimum over its workers
// (lane, lane + 32, ...; ascending, so a tie keeps the smaller id) and three
// warp reductions (__reduce_min_sync, one instruction each) give every lane
// the lexicographic minimum: the high then the low word of an
// order-preserving 64-bit key of the load, then the worker id among the
// lanes that hold that key. The owner lane adds the cost. The chain ids and
// costs of the next 32 chains load while the current 32 are placed, so only
// the dependent chain of minima is left on the critical path. The real
// chain count is read on the device, so the pipeline needs no host sync.
// What bounds it: latency (a shared-memory round trip and three dependent
// reductions per chain), not bytes.
//
// Both are built with explicit round-to-nearest intrinsics (and no product
// to contract), so no FMA can change a bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kFoldThreads = 256;
constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxWorkers = 48 * 1024 / 8;  // loads in static-size shared memory

__global__ void segment_fold_kernel(const double* __restrict__ values,
                                    const int64_t* __restrict__ seg,
                                    int64_t n, int64_t n_segments,
                                    double* __restrict__ out) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int64_t s = seg[i];
  if (i > 0 && seg[i - 1] == s) return;  // not the head of its run
  if (s < 0 || s >= n_segments) return;
  double acc = 0.0;
  for (int64_t j = i; j < n && seg[j] == s; ++j)
    acc = __dadd_rn(acc, values[j]);
  out[s] = acc;
}

// An unsigned key that orders like the double it encodes (NaN aside):
// negative values have every bit flipped, the others only the sign bit.
__device__ __forceinline__ unsigned long long order_key(double x) {
  const long long bits = __double_as_longlong(x);
  return bits < 0 ? ~(unsigned long long)bits
                  : (unsigned long long)bits | 0x8000000000000000ULL;
}

// The chain id (or -1: none, or phantom) and cost lane `lane` holds for
// position base + lane of `order`.
__device__ __forceinline__ void fetch(const int64_t* __restrict__ order,
                                      const double* __restrict__ cost,
                                      int64_t n, int64_t n_real, int64_t base,
                                      int lane, int64_t& c, double& v) {
  const int64_t i = base + lane;
  c = -1;
  v = 0.0;
  if (i < n) {
    const int64_t id = order[i];
    if (id >= 0 && id < n_real) {
      c = id;
      v = cost[id];
    }
  }
}

__global__ void lpt_assign_kernel(const double* __restrict__ cost,
                                  const int64_t* __restrict__ order,
                                  const int64_t* __restrict__ n_real_ptr,
                                  int64_t n, int p, int* __restrict__ worker) {
  __shared__ double loads[kMaxWorkers];
  const int lane = threadIdx.x;
  for (int w = lane; w < p; w += kWarp) loads[w] = 0.0;
  __syncwarp();
  const int64_t n_real = *n_real_ptr;
  int64_t c_next;
  double v_next;
  fetch(order, cost, n, n_real, 0, lane, c_next, v_next);
  for (int64_t base = 0; base < n; base += kWarp) {
    const int64_t c_cur = c_next;
    const double v_cur = v_next;
    fetch(order, cost, n, n_real, base + kWarp, lane, c_next, v_next);
    const int m = (int)((n - base) < kWarp ? (n - base) : kWarp);
    for (int j = 0; j < m; ++j) {
      const int64_t c = __shfl_sync(kFull, c_cur, j);
      if (c < 0) continue;  // uniform: every lane got the same id
      const double v = __shfl_sync(kFull, v_cur, j);
      // this lane's least (key, worker): ascending workers, strict <
      unsigned long long key = ~0ULL;
      double load = 0.0;
      unsigned w_min = 0xffffffffu;
      for (int w = lane; w < p; w += kWarp) {
        const double l = loads[w];
        const unsigned long long k = order_key(l);
        if (k < key) {
          key = k;
          load = l;
          w_min = (unsigned)w;
        }
      }
      // the warp's: high word, then low word, then worker among the equal
      const unsigned hi = __reduce_min_sync(kFull, (unsigned)(key >> 32));
      const unsigned lo = __reduce_min_sync(
          kFull, (unsigned)(key >> 32) == hi ? (unsigned)key : 0xffffffffu);
      const bool tied = key == (((unsigned long long)hi << 32) | lo);
      const unsigned best_w =
          __reduce_min_sync(kFull, tied ? w_min : 0xffffffffu);
      if (w_min == best_w) {  // the owner lane: its load is the minimum
        loads[best_w] = __dadd_rn(load, v);
        worker[c] = (int)best_w;
      }
      __syncwarp();
    }
  }
}

}  // namespace

extern "C" {

// Launch segment_fold on `stream` (n > 0); out (n_segments,) must be zeroed.
// Returns 0 or a CUDA error code.
int segment_fold_launch(const double* values, const int64_t* seg, int64_t n,
                        int64_t n_segments, double* out, void* stream) {
  const int64_t blocks = (n + kFoldThreads - 1) / kFoldThreads;
  segment_fold_kernel<<<(unsigned)blocks, kFoldThreads, 0,
                        (cudaStream_t)stream>>>(values, seg, n, n_segments,
                                                out);
  return (int)cudaGetLastError();
}

// Launch lpt_assign on `stream` (n > 0): one warp. worker (n,) must be
// filled with -1; chains that are not placed (phantom ids >= *n_real) keep
// it. Returns 0, a CUDA error code, or -1 when p loads do not fit in the
// kernel's shared memory.
int lpt_assign_launch(const double* cost, const int64_t* order,
                      const int64_t* n_real, int64_t n, int p, int* worker,
                      void* stream) {
  if (p < 1 || p > kMaxWorkers) return -1;
  lpt_assign_kernel<<<1, kWarp, 0, (cudaStream_t)stream>>>(cost, order,
                                                           n_real, n, p,
                                                           worker);
  return (int)cudaGetLastError();
}

}  // extern "C"
