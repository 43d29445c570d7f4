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
// np.bincount(ids, weights=values)'s addition order. Each warp owns a span
// of 128 elements and loads its ids and values coalesced (4 rows of 32),
// the values into shared memory. A head (an element whose id differs from
// its left neighbour's) is found by a shuffle; where each run ends inside
// the span comes from the warp's ballots of heads, so the thread at a head
// folds its run from shared memory with a known trip count, its loads
// issued ahead of the dependent __dadd_rn chain. Only the span's last run
// can go on past it (the id right of the span says whether it does); the
// whole warp then continues that one fold, 128 values at a time: it loads
// them coalesced, a ballot counts those still in the run, and each value
// is shuffled in order into the same left fold. The head of each run also
// writes the zeros of the empty segments before it, and the last CTA those
// after the last id, so `out` needs no fill. What bounds it: bytes (8 of
// value and 8 of id per element read once, 8 a segment written); the
// longest run is its serial part, one dependent add a value.
//
// lpt_assign. The LPT placement of partition_tiles: for each chain in
// `order` (ids >= n_real are phantom chains and are skipped), take the
// worker of least load, ties to the smallest worker id (heapq's (load,
// worker) tuple order), add the chain's cost to its load with __dadd_rn and
// record the worker. heapq takes one chain a step; this kernel places them
// in exact rounds. The workers stay sorted by (load, id) in shared memory,
// pi_0 < pi_1 < ...; a round takes the next m = min(p, 1024, chains left)
// chains, c_0, c_1, ..., thread t the t-th. Chain t goes to pi_t exactly
// when no earlier chain's updated key (L(pi_j) + c_j, pi_j), j < t, lies
// below pi_t's key: once chains 0..t-1 are placed on pi_0..pi_{t-1}, the
// least untouched key is pi_t's and the updated keys are those on the
// left, so the condition is heapq's choice. It needs no order of the costs
// and no sign. Thread t counts the old keys below its updated key (a
// search); the first t where the rule fails is the least such count over
// the earlier threads (a block minimum), k >= 1. Chains 0..k-1 go to
// pi_0..pi_{k-1}. The k updated keys fall into sorted segments at their
// descents (a ballot); with at most 3 descents (most rounds) every key
// finds its new place by searching the segments, else by counting against
// all k updated keys 32 at a time. A round whose first chain leaves pi_0's
// load unchanged (L + c == L, e.g. cost 0) leaves the heap as it was: the
// run of such chains (the same block minimum) all go to pi_0 in one round.
// Keys compare as (order-preserving 64-bit image of the load, id), 16
// bytes a key. Three CUDA kernels a call: a gather of the costs in
// `order`'s order (random reads, spread over the card); the rounds on one
// CTA (256 threads up to p = 256, else 1,024), which first compacts the
// real chains stably in place, loads the next round's costs while a round
// merges, and records each placement by position (coalesced); a scatter of
// the placements by chain id. The real chain count is read on the device,
// so the pipeline needs no host sync. What bounds it: latency, the rounds
// times one round's two or three __syncthreads, two block minima and the
// searches' dependent shared-memory loads; wikipedia's 55,856 chains at
// p = 132 take 430 rounds where heapq takes 55,856 steps. The round count
// is written to `rounds`.
//
// Both are built with explicit round-to-nearest intrinsics (and no product
// to contract), so no FMA can change a bit; neither uses float atomics (the
// only atomics are integer counts), so every call gives the same bits.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;

// ------------------------------------------------------------ segment_fold
constexpr int kFoldWarps = 8;
constexpr int kFoldThreads = kFoldWarps * kWarp;
constexpr int kFoldRows = 4;                  // a warp's span: 4 rows of 32
constexpr int kFoldSpan = kFoldRows * kWarp;  // 128 elements a warp
constexpr int kFoldCta = kFoldWarps * kFoldSpan;

// zeros into out[lo, hi) clipped to [0, n_segments), stride `step`
__device__ __forceinline__ void zero_fill(double* out, int64_t lo, int64_t hi,
                                          int64_t n_segments, int first,
                                          int step) {
  if (lo < 0) lo = 0;
  if (hi > n_segments) hi = n_segments;
  for (int64_t s = lo + first; s < hi; s += step) out[s] = 0.0;
}

__global__ void __launch_bounds__(kFoldThreads)
segment_fold_kernel(const double* __restrict__ values,
                    const int64_t* __restrict__ seg, int64_t n,
                    int64_t n_segments, double* __restrict__ out) {
  __shared__ double span[kFoldWarps][kFoldSpan];
  __shared__ int64_t tail_from;
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int64_t base = ((int64_t)blockIdx.x * kFoldWarps + warp) * kFoldSpan;
  const int len =
      base < n ? (int)(n - base < kFoldSpan ? n - base : kFoldSpan) : 0;
  const bool goes_on = len == kFoldSpan && base + kFoldSpan < n;
  double* sv = span[warp];

  // every load at once: the span's rows, and the ids left and right of it
  int64_t id[kFoldRows];
  double v[kFoldRows];
#pragma unroll
  for (int j = 0; j < kFoldRows; ++j) {
    const int q = j * kWarp + lane;
    id[j] = q < len ? seg[base + q] : 0;
    v[j] = q < len ? values[base + q] : 0.0;
  }
  int64_t left = 0, right = 0;
  if (lane == 0 && len > 0 && base > 0) left = seg[base - 1];
  if (lane == 0 && goes_on) right = seg[base + kFoldSpan];
  left = __shfl_sync(kFull, left, 0);
  right = __shfl_sync(kFull, right, 0);
#pragma unroll
  for (int j = 0; j < kFoldRows; ++j) sv[j * kWarp + lane] = v[j];

  // heads, and the id left of each element
  int64_t prev[kFoldRows];
  unsigned heads[kFoldRows];
#pragma unroll
  for (int j = 0; j < kFoldRows; ++j) {
    const int64_t up = __shfl_up_sync(kFull, id[j], 1);
    const int64_t row_end = __shfl_sync(kFull, id[j > 0 ? j - 1 : 0], 31);
    prev[j] = lane > 0 ? up : (j > 0 ? row_end : left);
    const int q = j * kWarp + lane;
    heads[j] = __ballot_sync(
        kFull, q < len && (base + q == 0 || prev[j] != id[j]));
  }
  __syncwarp();

  // each head folds its run inside the span, a known count of values; only
  // the span's last run can go on past it
  double carry = 0.0;
  bool crosses = false;
#pragma unroll
  for (int j = 0; j < kFoldRows; ++j) {
    if (!((heads[j] >> lane) & 1u)) continue;
    const int q = j * kWarp + lane;
    int end = len;  // the next head, or the span's end
#pragma unroll
    for (int r = kFoldRows - 1; r >= j; --r) {
      const unsigned later =
          r > j ? heads[r]
                : (lane == kWarp - 1 ? 0u : heads[r] & (kFull << (lane + 1)));
      if (later) end = r * kWarp + __ffs(later) - 1;
    }
    double acc = 0.0;
#pragma unroll 8
    for (int x = q; x < end; ++x) acc = __dadd_rn(acc, sv[x]);
    const int64_t s = id[j];
    zero_fill(out, base + q == 0 ? 0 : prev[j] + 1, s, n_segments, 0, 1);
    if (end == len && goes_on && right == s) {
      carry = acc;
      crosses = true;
    } else if (s >= 0 && s < n_segments) {
      out[s] = acc;
    }
  }

  // that run, if it goes on: the whole warp folds the rest, 128 values a
  // step loaded at once, each shuffled in order into the same left fold
  const unsigned who = __ballot_sync(kFull, crosses);
  if (who) {
    const int owner = __ffs(who) - 1;
    double acc = __shfl_sync(kFull, carry, owner);
    const int64_t s = right;
    bool more = true;
    for (int64_t at = base + kFoldSpan; more; at += kFoldSpan) {
      int64_t cid[kFoldRows];
      double cv[kFoldRows];
#pragma unroll
      for (int j = 0; j < kFoldRows; ++j) {
        const int64_t i = at + j * kWarp + lane;
        cid[j] = i < n ? seg[i] : 0;
        cv[j] = i < n ? values[i] : 0.0;
      }
#pragma unroll
      for (int j = 0; j < kFoldRows; ++j) {
        if (!more) break;
        const int64_t i = at + j * kWarp + lane;
        // ids do not decrease: the lanes still in the run are a prefix
        const unsigned in = __ballot_sync(kFull, i < n && cid[j] == s);
        const int c = in == kFull ? kWarp : __ffs(~in) - 1;
        for (int l = 0; l < c; ++l)
          acc = __dadd_rn(acc, __shfl_sync(kFull, cv[j], l));
        more = c == kWarp;
      }
    }
    if (lane == 0 && s >= 0 && s < n_segments) out[s] = acc;
  }

  // the empty segments after the last id: the last CTA writes them
  if (blockIdx.x == gridDim.x - 1) {
#pragma unroll
    for (int j = 0; j < kFoldRows; ++j)
      if (len > 0 && base + len == n && j * kWarp + lane == len - 1)
        tail_from = id[j] < n_segments ? id[j] + 1 : n_segments;
    __syncthreads();
    zero_fill(out, tail_from, n_segments, n_segments, threadIdx.x,
              kFoldThreads);
  }
}

// ---------------------------------------------------------------- lpt_assign
constexpr int kWindow = 1024;       // chains a round, at most
constexpr int kMaxWorkers = 4096;   // sorted keys in shared memory
constexpr int kSideThreads = 256;   // the gather and the scatter
constexpr int kMaxSegments = 4;     // sorted runs a round merges by search
constexpr int kCompactSpan = 4096;  // order entries a compaction step

// a worker's key (the order-preserving image of its load, its id): one
// 16-byte load or store
struct __align__(16) Entry {
  unsigned long long key;
  int w, pad;
};

// An unsigned key that orders like the double it encodes (NaN aside):
// negative values have every bit flipped, the others only the sign bit.
__device__ __forceinline__ unsigned long long order_key(double x) {
  const long long bits = __double_as_longlong(x);
  return bits < 0 ? ~(unsigned long long)bits
                  : (unsigned long long)bits | 0x8000000000000000ULL;
}

__device__ __forceinline__ double key_load(unsigned long long k) {
  return __longlong_as_double(
      (long long)(k >> 63 ? k & 0x7fffffffffffffffULL : ~k));
}

// (key a, worker a) < (key b, worker b), without branches
__device__ __forceinline__ bool key_less(unsigned long long ka, int wa,
                                         unsigned long long kb, int wb) {
  return (ka < kb) | ((ka == kb) & (wa < wb));
}

// lo[j] = how many keys below (k, w) the sorted run a[base[j] ..
// base[j] + len[j]) holds, for S runs at once: four-way lifting, three
// loads a run a step (from indices clamped into [0, last]), issued side by
// side, each adding its step or 0, so no load waits behind a branch. `cap`
// bounds every len.
template <int S>
__device__ __forceinline__ void count_below(const Entry* a,
                                            const int (&base)[S],
                                            const int (&len)[S], int cap,
                                            int last, unsigned long long k,
                                            int w, int (&lo)[S]) {
#pragma unroll
  for (int j = 0; j < S; ++j) lo[j] = 0;
  if (cap <= 0) return;
  for (int step = 1 << (2 * ((31 - __clz(cap)) >> 1)); step > 0; step >>= 2) {
    int add[S];
#pragma unroll
    for (int j = 0; j < S; ++j) {
      add[j] = 0;
#pragma unroll
      for (int q = 1; q < 4; ++q) {
        const int to = lo[j] + q * step;
        const Entry o = a[max(0, min(base[j] + min(to, len[j]) - 1, last))];
        add[j] += (to <= len[j]) & key_less(o.key, o.w, k, w);
      }
    }
#pragma unroll
    for (int j = 0; j < S; ++j) lo[j] += add[j] * step;
  }
}

// Every key's place in the next order when the k updated keys (ent) fall
// into S sorted segments, segment j = [start[j], start[j + 1]): an updated
// key goes after the untouched keys below it (the old keys below it, less
// the k updated workers') and the updated keys below it (its offset in its
// own segment, a search of each other one); an untouched key after the
// untouched keys before it and the updated keys below it (a search of
// each segment). Thread e < k holds its updated key (uk, uw).
template <int S, int NT>
__device__ __forceinline__ void place_keys(const Entry* K, const Entry* ent,
                                           Entry* N, const int* start, int p,
                                           int k, int tid,
                                           unsigned long long uk, int uw,
                                           int below_old) {
  for (int e = tid; e < p; e += NT) {
    const bool updated = e < k;  // then e == tid: k <= NT
    const Entry me = updated ? Entry{uk, uw, 0} : K[e];
    int at = updated ? (below_old > k ? below_old - k : 0) : e - k;
    if (S > 1 || !updated) {
      int base[S], len[S], lo[S];
#pragma unroll
      for (int j = 0; j < S; ++j) {
        base[j] = start[j];
        len[j] = start[j + 1] - start[j];
        if (e >= base[j] && e < base[j] + len[j]) {  // its own segment
          at += e - base[j];
          len[j] = 0;
        }
      }
      count_below<S>(ent, base, len, k, k - 1, me.key, me.w, lo);
#pragma unroll
      for (int j = 0; j < S; ++j) at += lo[j];
    } else {
      at += e;  // one segment, its own
    }
    N[at] = me;
  }
}

__device__ __forceinline__ int warp_inclusive_sum(int v, int lane) {
#pragma unroll
  for (int o = 1; o < kWarp; o <<= 1) {
    const int u = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += u;
  }
  return v;
}

// Shared memory of a CTA of nt threads for p workers: this round's updated
// keys, the sorted keys twice (this round's and the next's), the compacted
// count, the updated keys below each key, block scratch.
__host__ __device__ constexpr size_t lpt_smem_bytes(int p, int nt) {
  return (size_t)(nt + 2 * p) * sizeof(Entry) + 8
         + (size_t)(p + 3 * (nt / kWarp) + kCompactSpan / kWarp) * 4;
}

// gcost[q] = cost[order[q]] for the real ids of `order`: the random reads,
// spread over the card
__global__ void __launch_bounds__(kSideThreads)
lpt_assign_gather_kernel(const double* __restrict__ cost,
                         const int64_t* __restrict__ order,
                         const int64_t* __restrict__ n_real_ptr, int64_t n,
                         double* __restrict__ gcost) {
  const int64_t q = (int64_t)blockIdx.x * kSideThreads + threadIdx.x;
  if (q >= n) return;
  const int64_t c = order[q];
  gcost[q] = c >= 0 && c < *n_real_ptr ? cost[c] : 0.0;
}

// The rounds, on one CTA of NT threads. It compacts the real ids of `order`
// and their gathered costs (real_cost, in place over the gathered costs: a
// chain only moves down), then places them: chain q of the compacted list
// goes to worker placed[q]; *real_count gets the list's length.
template <int NT>
__global__ void __launch_bounds__(NT)
lpt_assign_rounds_kernel(const int64_t* __restrict__ order,
                         const int64_t* __restrict__ n_real_ptr, int64_t n,
                         int p, double* real_cost, int* real_id,
                         int* placed, int64_t* __restrict__ real_count,
                         int64_t* __restrict__ rounds_out) {
  constexpr int kWarps = NT / kWarp;
  constexpr int kRows = kCompactSpan / NT;  // a compaction step's rows
  constexpr int kPer = kRows * kWarps / kWarp;
  static_assert(kWarps <= kWarp && kPer * kWarp == kRows * kWarps,
                "one warp scans the compaction counts and the warp minima");
  extern __shared__ Entry smem[];
  Entry* const ent = smem;                  // updated keys, by position
  Entry* const srt = smem + NT;             // two buffers of p sorted keys
  long long* const total = (long long*)(srt + 2 * p);
  int* const below_new = (int*)(total + 1); // updated keys below each key
  int* const red = below_new + p;           // 3 x kWarps
  int* const offs = red + 3 * kWarps;       // kRows x kWarps

  const int tid = threadIdx.x, warp = tid / kWarp, lane = tid % kWarp;
  const int64_t n_real = *n_real_ptr;

  // ---- compaction, stable. Row j of a step is positions b + j NT + tid:
  // loads and stores coalesce.
  int64_t R = 0;
  for (int64_t b = 0; b < n; b += kCompactSpan) {
    int id[kRows];
    double cs[kRows];
    unsigned real[kRows];
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const int64_t q = b + (int64_t)j * NT + tid;
      const int64_t c = q < n ? order[q] : -1;
      cs[j] = q < n ? real_cost[q] : 0.0;
      id[j] = c >= 0 && c < n_real ? (int)c : -1;
    }
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      real[j] = __ballot_sync(kFull, id[j] >= 0);
      if (lane == 0) offs[j * kWarps + warp] = __popc(real[j]);
    }
    __syncthreads();
    if (warp == 0) {  // exclusive scan of the counts, rows then warps
      int v[kPer], sum = 0;
#pragma unroll
      for (int e = 0; e < kPer; ++e) sum += v[e] = offs[lane * kPer + e];
      const int incl = warp_inclusive_sum(sum, lane);
      int at = incl - sum;
#pragma unroll
      for (int e = 0; e < kPer; ++e) {
        offs[lane * kPer + e] = at;
        at += v[e];
      }
      if (lane == kWarp - 1) *total = incl;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kRows; ++j)
      if (id[j] >= 0) {
        const int64_t at = R + offs[j * kWarps + warp]
                           + __popc(real[j] & ((1u << lane) - 1u));
        real_id[at] = id[j];
        real_cost[at] = cs[j];
      }
    R += *total;
    __syncthreads();
  }

  // ---- rounds
  for (int w = tid; w < p; w += NT) srt[w] = Entry{order_key(0.0), w, 0};
  const int window = p < kWindow ? p : kWindow;  // <= NT
  int64_t i = 0, rounds = 0;
  int cur = 0;
  int m = (int)(R < window ? R : window);
  double my_c = tid < m ? real_cost[tid] : 0.0;
  double next_c = lane == kWarp - 1 && tid + 1 < m ? real_cost[tid + 1] : 0.0;
  __syncthreads();

  while (i < R) {
    ++rounds;
    const Entry* K = srt + cur * p;
    // thread t < m: chain t's updated key, how many old keys lie below it,
    // and whether chain t + 1's lies below it (a descent)
    for (int e = tid; e < p; e += NT) below_new[e] = 0;
    const double l0 = key_load(K[0].key);
    unsigned long long uk = 0;
    int uw = 0, below_old = 0, fail = m, moves = m;
    unsigned descents = 0;
    if (warp * kWarp < m) {
      const Entry o = K[tid < m ? tid : 0];
      uk = order_key(__dadd_rn(key_load(o.key), my_c));
      uw = o.w;
      unsigned long long nk = __shfl_down_sync(kFull, uk, 1);
      int nw = __shfl_down_sync(kFull, uw, 1);
      if (lane == kWarp - 1 && tid + 1 < m) {  // chain t + 1 is the next warp's
        const Entry o1 = K[tid + 1];
        nk = order_key(__dadd_rn(key_load(o1.key), next_c));
        nw = o1.w;
      }
      if (tid < m) {
        ent[tid] = Entry{uk, uw, 0};
        if (__dadd_rn(l0, my_c) != l0) moves = tid;
        const int base[1] = {0}, len[1] = {p};
        int lo[1];
        count_below<1>(K, base, len, p, p - 1, uk, uw, lo);
        below_old = lo[0];
        fail = below_old > tid + 1 ? below_old : tid + 1;
      }
      descents = __ballot_sync(kFull, tid + 1 < m && key_less(nk, nw, uk, uw));
      fail = __reduce_min_sync(kFull, fail);
      moves = __reduce_min_sync(kFull, moves);
    }
    if (lane == 0) {
      red[warp] = fail;
      red[kWarps + warp] = moves;
      red[2 * kWarps + warp] = (int)descents;
    }
    __syncthreads();
    int k = __reduce_min_sync(kFull, lane < kWarps ? red[lane] : m);
    const int run =
        __reduce_min_sync(kFull, lane < kWarps ? red[kWarps + lane] : m);
    const bool still = run > 0;  // chain 0 leaves pi_0's load unchanged
    k = still ? run : (k < m ? k : m);
    if (tid < k) placed[i + tid] = still ? K[0].w : K[tid].w;

    // the next round's costs load while this one merges
    const int64_t i2 = i + k;
    const int m2 = (int)(R - i2 < window ? R - i2 : window);
    const double c2 = tid < m2 ? real_cost[i2 + tid] : 0.0;
    const double nc2 = lane == kWarp - 1 && tid + 1 < m2
                           ? real_cost[i2 + tid + 1] : 0.0;

    if (!still) {
      // the updated keys of positions < k fall into sorted segments at the
      // descents below k - 1; lane l holds word l of their bits
      const int lo_bit = lane * kWarp, left = k - 1 - lo_bit;
      const unsigned word =
          left <= 0 || lane >= kWarps
              ? 0u
              : (unsigned)red[2 * kWarps + lane]
                    & (left >= kWarp ? kFull : (1u << left) - 1u);
      const int ones = __popc(word);
      const int n_desc = __reduce_add_sync(kFull, ones);
      Entry* const N = srt + (cur ^ 1) * p;
      if (n_desc < kMaxSegments) {
        // segment j starts after descent j - 1
        int start[kMaxSegments + 1];
#pragma unroll
        for (int j = 0; j <= kMaxSegments; ++j) start[j] = j == 0 ? 0 : k;
        if (n_desc > 0) {
          const int before =
              n_desc > 1 ? warp_inclusive_sum(ones, lane) - ones : 0;
#pragma unroll
          for (int j = 1; j < kMaxSegments; ++j) {
            if (j > n_desc) break;
            const bool has = j - 1 >= before && j - 1 < before + ones;
            unsigned rest = word;  // drop the lane's descents before this one
            for (int c = before; c < j - 1; ++c) rest &= rest - 1u;
            const unsigned who = __ballot_sync(kFull, has);
            start[j] = __shfl_sync(kFull, lo_bit + __ffs(rest) - 1,
                                   __ffs(who) - 1) + 1;
          }
        }
        switch (n_desc) {
          case 0:
            place_keys<1, NT>(K, ent, N, start, p, k, tid, uk, uw, below_old);
            break;
          case 1:
            place_keys<2, NT>(K, ent, N, start, p, k, tid, uk, uw, below_old);
            break;
          case 2:
            place_keys<3, NT>(K, ent, N, start, p, k, tid, uk, uw, below_old);
            break;
          default:
            place_keys<4, NT>(K, ent, N, start, p, k, tid, uk, uw, below_old);
        }
      } else {
        // many descents: every key's count of the updated keys below it, a
        // warp taking 32 keys against 32 updated keys read by broadcast
        const int runs = (k + kWarp - 1) / kWarp,
                  rows = (p + kWarp - 1) / kWarp;
        for (int pair = warp; pair < runs * rows; pair += kWarps) {
          const int r = pair / rows, e = (pair % rows) * kWarp + lane;
          const int len = min(kWarp, k - r * kWarp);
          const Entry* u = ent + r * kWarp;
          const Entry me = e < k ? ent[e] : e < p ? K[e] : Entry{0, 0, 0};
          int below = 0;
#pragma unroll 8
          for (int j = 0; j < len; ++j) {
            const Entry o = u[j];
            below += key_less(o.key, o.w, me.key, me.w);
          }
          if (e < p && below) atomicAdd(below_new + e, below);
        }
        __syncthreads();
        for (int e = tid; e < p; e += NT) {
          if (e < k)  // e == tid
            N[below_new[e] + (below_old > k ? below_old - k : 0)] =
                Entry{uk, uw, 0};
          else
            N[e - k + below_new[e]] = K[e];
        }
      }
      cur ^= 1;
    }
    __syncthreads();
    i = i2;
    m = m2;
    my_c = c2;
    next_c = nc2;
  }
  if (tid == 0) {
    *rounds_out = rounds;
    *real_count = R;
  }
}

template <int NT>
int lpt_rounds_launch(const int64_t* order, const int64_t* n_real, int64_t n,
                      int p, double* costs, int* ids, int64_t* count,
                      int64_t* rounds, cudaStream_t stream) {
  const size_t smem = lpt_smem_bytes(p, NT);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        lpt_assign_rounds_kernel<NT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  lpt_assign_rounds_kernel<NT><<<1, NT, smem, stream>>>(
      order, n_real, n, p, costs, ids, ids + n, count, rounds);
  return (int)cudaGetLastError();
}

// worker[real_id[q]] = placed[q] for the compacted chains q
__global__ void __launch_bounds__(kSideThreads)
lpt_assign_scatter_kernel(const int* __restrict__ real_id,
                          const int* __restrict__ placed,
                          const int64_t* __restrict__ real_count, int64_t n,
                          int* __restrict__ worker) {
  const int64_t q = (int64_t)blockIdx.x * kSideThreads + threadIdx.x;
  if (q < n && q < *real_count) worker[real_id[q]] = placed[q];
}

}  // namespace

extern "C" {

// Launch segment_fold on `stream` (n > 0, n_segments > 0). It writes every
// entry of out (n_segments,): no fill needed. Returns 0 or a CUDA error.
int segment_fold_launch(const double* values, const int64_t* seg, int64_t n,
                        int64_t n_segments, double* out, void* stream) {
  const int64_t blocks = (n + kFoldCta - 1) / kFoldCta;
  segment_fold_kernel<<<(unsigned)blocks, kFoldThreads, 0,
                        (cudaStream_t)stream>>>(values, seg, n, n_segments,
                                                out);
  return (int)cudaGetLastError();
}

// Launch lpt_assign on `stream` (0 < n < 2^31): a gather of the chains'
// costs in `order`'s order, the rounds on one CTA (256 threads up to p =
// 256, else 1,024), then a scatter of the placements by chain id; three
// kernels. worker (n,) must be
// filled with -1; chains that are not placed (phantom ids >= *n_real) keep
// it. scratch holds 2n + 1 int64 (the compacted costs, their count, ids and
// workers); rounds (1,) gets the round count. Returns 0, a CUDA error code,
// or -1 when p is outside [1, kMaxWorkers].
int lpt_assign_launch(const double* cost, const int64_t* order,
                      const int64_t* n_real, int64_t n, int p, int* worker,
                      int64_t* scratch, int64_t* rounds, void* stream) {
  if (p < 1 || p > kMaxWorkers) return -1;
  const cudaStream_t s = (cudaStream_t)stream;
  const unsigned grid = (unsigned)((n + kSideThreads - 1) / kSideThreads);
  double* const costs = (double*)scratch;
  int64_t* const count = scratch + n;
  int* const ids = (int*)(scratch + n + 1);
  lpt_assign_gather_kernel<<<grid, kSideThreads, 0, s>>>(cost, order,
                                                         n_real, n, costs);
  const int e = p <= 256 ? lpt_rounds_launch<256>(order, n_real, n, p, costs,
                                                 ids, count, rounds, s)
                         : lpt_rounds_launch<1024>(order, n_real, n, p, costs,
                                                   ids, count, rounds, s);
  if (e != 0) return e;
  lpt_assign_scatter_kernel<<<grid, kSideThreads, 0, s>>>(ids, ids + n,
                                                          count, n, worker);
  return (int)cudaGetLastError();
}

}  // extern "C"
