// Chunked SSD scan (Mamba2) for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas kernel of src/repro/kernels/mamba_scan/mamba_scan.py
// (mamba_scan, _ssd_kernel), which src/repro/models/ssm.py's
// chunked_gated_scan mirrors on the reference's model path.
//
// What it computes. Per batch row b and head h, a float32 state S (N, Pd)
// walks the sequence in chunks of Q steps, from a given initial state S_0
// (zeros when none is given). With l the inclusive cumulative sum of log_a
// inside the chunk and total = l[Q-1]:
//   y_i   = sum_{j<=i} (q_i . k_j) exp(clip(l_i - l_j, -60, 0)) v_j
//           + exp(l_i) q_i . S_prev
//   S_new = exp(total) S_prev + sum_j exp(clip(total - l_j, -60, 0)) k_j (x) v_j
// It returns y (B, S, H, Pd) in v's type and the final state (B, H, N, Pd).
// Steps past the end of the sequence read q = k = v = 0 and log_a = 0, so
// a ragged last chunk behaves as the reference's zero padding: the state is
// unchanged by them and their y is not stored. A chunk's y and state depend
// only on its own inputs and the state before it, so a call over a
// sequence gives the same bits as two calls split at a chunk boundary, the
// second from the first's final state.
//
// What bounds it. Operations: per chunk, Q(Q+1)/2 causal pairs need 2N
// for their q.k score (once per batch row when q and k are shared across
// heads, once per head otherwise), and per head 2Pd + 1 for each pair's
// decayed product with v plus 4 Q N Pd for the inter-chunk term and the
// state update. At Zamba2-1.2B's serving shape (B = 4, S = 2048, H = 64,
// N = Pd = 64, Q = 256, q and k shared: head stride 0) 17.42 GFLOP against
// 0.28 GB of inputs and outputs. On the float32 CUDA cores that is
// 0.260 ms; on the tensor cores in 3xTF32, 3 x 17.42 GFLOP at 495 TFLOP/s
// = 0.106 ms, beside 0.083 ms for the bytes: bound by operations. At
// xlstm-350m's mLSTM shape (B = 4, S = 2048, H = 4, N = 512, Pd = 513: the
// head width plus the normalizer channel, Q = 256, q and k per head)
// 43.05 GFLOP, 80 % of it the inter-chunk term and the state update,
// against 0.17 GB: 3 x 43.05 GFLOP at 495 TFLOP/s = 0.261 ms.
//
// The design: the SSD chunk decomposition, so that the work is parallel
// over (b, h, chunk) and not a walk of the chunks of one (b, h) in a CTA.
// On the TPU the chunk axis is a sequential grid dimension with the state
// in VMEM scratch; here the only sequential part is step 4 below, an
// elementwise walk over the chunks' states. One call runs five kernels in
// turn on the caller's stream, each reading only what the ones before it
// wrote, into scratch buffers the wrapper allocates:
//   1. ssd_scan_kernel_cumsum — l for every (b, h, chunk), one warp each
//      (lane runs, then a warp scan of the lane totals): lc (B, H, nc, Q).
//   2. ssd_scan_kernel_cb — the raw score tiles q_i . k_j of each chunk,
//      64 x 64 tiles at or below the diagonal, into cb. When q and k are
//      shared by all heads (head stride 0, Zamba2's C and B, or H = 1) once
//      per (b, chunk) for all heads: cb (B, nc, Q, Q) (8.4 MB at Zamba2's
//      shape, which stays in L2; recomputed in each of the 64 heads this
//      tile would be a third of the work there). When they differ by head
//      and step 5 would otherwise compute the tile more than once (Pd
//      spans more than one 64-column tile) or over more than one slice of
//      N, once per (b, h, chunk): cb (B, H, nc, Q, Q) (33.5 MB at xlstm's
//      shape; recomputed in each of its 9 column tiles the tile would add
//      39 GFLOP to 43). Else (N <= 64, Pd <= 64) step 5 computes it.
//   3. ssd_scan_kernel_states — each chunk's own state
//      dS_c = sum_j exp(clip(total - l_j)) k_j (x) v_j, (N, Pd) per
//      (b, h, chunk), 64 rows of N by 64 columns of Pd a block, into st
//      (B, H, nc, N, Pd) (33.5 MB at Zamba2's shape, 134 MB at xlstm's).
//   4. ssd_scan_kernel_pass — one thread per state element walks the
//      chunks in ascending order from S_0 (the given state, or 0): st[c] <-
//      S_{c-1} (the state before chunk c, in place of dS_c), S_c =
//      exp(total_c) S_{c-1} + dS_c; the last is the final state.
//   5. ssd_scan_kernel_y — per (b, h, chunk, 64-row tile, 64 columns of
//      Pd): the intra-chunk term over the key tiles at or before the row
//      tile (scores from cb, or q.k computed in place), decayed and
//      causally masked in registers, times v; then the inter-chunk term
//      exp(l_i) q_i . S_prev over N in slices of 64 (skipped in the first
//      chunk when no state is given); the heaviest row tiles are launched
//      first.
// Every product (q.k, scores . v, k^T . v, q . S) runs on the tensor cores
// as mma.sync m16n8k8 TF32 in the 3xTF32 split (mma_tf32.cuh), which keeps
// the float32 bars (2e-4, and 2e-4 of each element's sum of |terms|
// against a float64 recurrence); score rows are used as A fragments where
// they lie, by the k-slot order of mma_tf32.cuh, and the three passes run
// over 8 accumulators at a time (mma_row). Sums over the chunk
// (scores . v, k^T . v) are made per 64-key tile, and sums over N (q.k,
// q . S_prev) per 64-wide slice of N after the first, from a zero fragment
// and added into a float32 accumulator with a rounded add, so the tensor
// cores' truncating accumulation never runs over more than 64 terms. The
// decays use the fast exponential (__expf, a relative error near 1e-6 at
// the -60 clip, far inside the bars). In kernels 3 and 5 the key tiles come
// through a two-stage ring, the next tile's copy in flight while this one
// is multiplied: by 16-byte cp.async when the inputs are float32 with
// 16-byte aligned rows (Zamba2's path), by 4-byte cp.async for other
// float32 strides (xlstm's Pd = 513), by plain loads for bfloat16
// (converted to float32 in shared memory). q and k are
// read through their (b, s, h) strides, so a head stride of 0 serves B and
// C shared by all heads without materialising them. Shared-memory rows are
// padded to 68 or 72 floats so every fragment read of a warp hits
// distinct banks. Fixed order everywhere and no atomics: y and the state
// are the same bits from call to call, whatever the number of SMs, and the
// same whether q and k come shared (kernel 2) or per head.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "mma_tf32.cuh"

namespace {

constexpr int kT = 64;          // rows of a tile (64 rows, 64 columns)
constexpr int kNMax = 512;      // state rows taken (in slices of kT)
constexpr int kMaxChunk = 1024; // the longest chunk taken
constexpr int kThreads = 128;   // 4 warps, 16 tile rows each
constexpr int kRow = kT + 8;    // rows read along the row (q, k for q.k)
constexpr int kCol = kT + 4;    // tiles read down a column (v, k^T, S)
constexpr int kTile = kT * kRow;   // floats of a staged tile (>= kT * kCol)

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ float decay(float x) {
  return __expf(fminf(fmaxf(x, -60.0f), 0.0f));
}

// Stage a 64 x 64 tile: dst[r * ss + c] = src[r * rs + c] for r < rows,
// c < cols; zeros elsewhere. Each thread starts all 32 of its loads before
// it stores any, so the tile costs one memory latency, not 32.
template <typename T>
__device__ __forceinline__ void stage(float* dst, int ss, const T* src,
                                      int64_t rs, int rows, int cols) {
  constexpr int kPer = kT * kT / kThreads;
  const int c = threadIdx.x % kT, r0 = threadIdx.x / kT;
  constexpr int kStep = kThreads / kT;   // rows a pass
  float x[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int r = r0 + i * kStep;
    x[i] = r < rows && c < cols ? to_f(src[(int64_t)r * rs + c]) : 0.0f;
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int r = r0 + i * kStep;
    dst[r * ss + c] = x[i];
  }
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// stage() by 16-byte cp.async, for float32 rows whose starts are 16-byte
// aligned (rs a multiple of 4): the copies land while the thread goes on.
__device__ __forceinline__ void stage_async(float* dst, int ss,
                                            const float* src, int64_t rs,
                                            int rows, int cols) {
  constexpr int kChunks = kT / 4;   // 16-byte copies a row
#pragma unroll
  for (int i = 0; i < kT * kChunks / kThreads; ++i) {
    const int e = threadIdx.x + i * kThreads;
    const int r = e / kChunks, c = (e % kChunks) * 4;
    const int n = r < rows ? min(4, max(0, cols - c)) : 0;   // floats read
    const float* from = n > 0 ? src + (int64_t)r * rs + c : src;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                     (uint32_t)__cvta_generic_to_shared(dst + r * ss + c)),
                 "l"(from), "r"(4 * n)
                 : "memory");
  }
}

// stage() by 4-byte cp.async, for float32 rows at any stride: each
// thread's 32 copies land while it goes on.
__device__ __forceinline__ void stage_async4(float* dst, int ss,
                                             const float* src, int64_t rs,
                                             int rows, int cols) {
  constexpr int kPer = kT * kT / kThreads;
  const int c = threadIdx.x % kT, r0 = threadIdx.x / kT;
  constexpr int kStep = kThreads / kT;   // rows a pass
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int r = r0 + i * kStep;
    const int n = r < rows && c < cols ? 4 : 0;   // bytes read
    const float* from = n > 0 ? src + (int64_t)r * rs + c : src;
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(
                     (uint32_t)__cvta_generic_to_shared(dst + r * ss + c)),
                 "l"(from), "r"(n)
                 : "memory");
  }
}

// A 64 x 64 tile by 16-byte cp.async (kCopy 16: float32, 16-byte aligned
// rows), by 4-byte cp.async (kCopy 4: float32, any strides) or by plain
// loads (kCopy 0: bfloat16, converted to float32)
template <int kCopy, typename T>
__device__ __forceinline__ void load_tile(float* dst, int ss, const T* src,
                                          int64_t rs, int rows, int cols) {
  if constexpr (kCopy == 16) {
    static_assert(std::is_same<T, float>::value, "cp.async path is float32");
    stage_async(dst, ss, src, rs, rows, cols);
  } else if constexpr (kCopy == 4) {
    static_assert(std::is_same<T, float>::value, "cp.async path is float32");
    stage_async4(dst, ss, src, rs, rows, cols);
  } else {
    stage(dst, ss, src, rs, rows, cols);
  }
}

__device__ __forceinline__ void zero(float (*f)[4]) {
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) f[n][e] = 0.0f;
}

// acc += p, element by element, with a rounded add
__device__ __forceinline__ void add_rn(float (*acc)[4], const float (*p)[4]) {
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = __fadd_rn(acc[n][e], p[n][e]);
}

// s += this warp's 16 rows of A (a [64][kRow] tile) . B^T (B a [64][kRow]
// tile) over the first np columns (a multiple of 8): a 16 x 64 tile of
// the warp, in accumulator fragments s[n] (columns n*8 + 2 tig, + 1).
__device__ __forceinline__ void row_product(const float* A, const float* B,
                                            int np, float (*s)[4]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const float* ar = A + (warp * 16 + gid) * kRow + 2 * tig;
  for (int kk = 0; kk < np; kk += 8) {
    const float2 a0 = *reinterpret_cast<const float2*>(ar + kk);
    const float2 a1 = *reinterpret_cast<const float2*>(ar + 8 * kRow + kk);
    ich::FragA a;
    a.set(a0.x, a1.x, a0.y, a1.y);
    ich::FragB bf[8];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float2 b = *reinterpret_cast<const float2*>(
          B + (n * 8 + gid) * kRow + kk + 2 * tig);
      bf[n].set(b.x, b.y);
    }
    ich::mma_row<8>(s, a, bf);
  }
}

// acc += p . V for the warp's 16 rows, p given as accumulator fragments
// p[ks] over 64 keys (key ks*8 + 2 tig, + 1) and V a [64][kCol] tile (key
// rows): the 8 k8 steps from a zero fragment, then one rounded add.
__device__ __forceinline__ void key_product(const float (*p)[4],
                                            const float* V,
                                            float (*acc)[4]) {
  const int lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  float pv[8][4];
  zero(pv);
#pragma unroll
  for (int ks = 0; ks < 8; ++ks) {
    ich::FragA a;
    a.set(p[ks][0], p[ks][2], p[ks][1], p[ks][3]);
    const float* vr = V + (ks * 8 + 2 * tig) * kCol + gid;
    ich::FragB bf[8];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) bf[nt].set(vr[nt * 8], vr[kCol + nt * 8]);
    ich::mma_row<8>(pv, a, bf);
  }
  add_rn(acc, pv);
}

// 1. l: inclusive cumulative sum of log_a inside each chunk; one warp per
// (b, h, chunk); steps past S add 0.
__global__ void ssd_scan_kernel_cumsum(const float* __restrict__ log_a,
                                       float* __restrict__ lc, int B, int S,
                                       int H, int Q, int nc) {
  const int64_t unit = blockIdx.x * (int64_t)(kThreads / 32) +
                       (threadIdx.x >> 5);   // (b * H + h) * nc + c
  if (unit >= (int64_t)B * H * nc) return;
  const int lane = threadIdx.x & 31;
  const int c = (int)(unit % nc);
  const int64_t bh = unit / nc;
  const int b = (int)(bh / H), h = (int)(bh % H);
  const float* la = log_a + (int64_t)b * S * H + h;
  float* l = lc + unit * Q;
  const int t0 = c * Q;
  const int per = (Q + 31) / 32;
  const int lo = min(lane * per, Q), hi = min(lo + per, Q);
  float run = 0.0f;
  for (int i = lo; i < hi; ++i) {
    const int t = t0 + i;
    run += t < S ? la[(int64_t)t * H] : 0.0f;
    l[i] = run;
  }
  float incl = run;
  for (int o = 1; o < 32; o <<= 1) {
    const float u = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += u;
  }
  const float base = incl - run;
  for (int i = lo; i < hi; ++i) l[i] += base;
}

// Which (row tile, key tile) at or below the diagonal the linear index u
// names: u = it (it + 1) / 2 + jt, jt <= it.
__device__ __forceinline__ void lower_tile(int u, int* it, int* jt) {
  int i = (int)((sqrtf(8.0f * u + 1.0f) - 1.0f) * 0.5f);
  while (i * (i + 1) / 2 > u) --i;
  while ((i + 1) * (i + 2) / 2 <= u) ++i;
  *it = i;
  *jt = u - i * (i + 1) / 2;
}

// 2. cb[b, hc, c, i, j] = q_i . k_j for the tiles at or below the diagonal
// of each (b, chunk) and, with cb_heads = H, each head (cb_heads = 1: q
// and k read at head 0, shared by all). Grid (tiles, nc, B * cb_heads). N
// is taken in 64-wide slices staged in turn: the first multiplied straight
// into the scores, each later one from a zero fragment and a rounded add.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    ssd_scan_kernel_cb(const T* __restrict__ q, const T* __restrict__ k,
                       float* __restrict__ cb, int S, int N, int Q,
                       int cb_heads, int64_t q_sb, int64_t q_ss, int64_t q_sh,
                       int64_t k_sb, int64_t k_ss, int64_t k_sh) {
  __shared__ __align__(16) float Qs[kTile];
  __shared__ __align__(16) float Ks[kTile];
  int it, jt;
  lower_tile(blockIdx.x, &it, &jt);
  const int c = blockIdx.y;
  const int b = blockIdx.z / cb_heads, h = blockIdx.z % cb_heads;
  const int i0 = it * kT, j0 = jt * kT;
  const int t0 = c * Q;
  const int rows_i = min(Q - i0, S - (t0 + i0));
  const int rows_j = min(Q - j0, S - (t0 + j0));
  const T* qr = q + b * q_sb + h * q_sh + (int64_t)(t0 + i0) * q_ss;
  const T* kr = k + b * k_sb + h * k_sh + (int64_t)(t0 + j0) * k_ss;
  float s[8][4];
  zero(s);
  for (int n0 = 0; n0 < N; n0 += kT) {
    const int cols = min(kT, N - n0);
    if (n0 > 0) __syncthreads();   // the last slice's readers are done
    stage(Qs, kRow, qr + n0, q_ss, rows_i, cols);
    stage(Ks, kRow, kr + n0, k_ss, rows_j, cols);
    __syncthreads();
    if (n0 == 0) {
      row_product(Qs, Ks, (cols + 7) / 8 * 8, s);
    } else {
      float part[8][4];
      zero(part);
      row_product(Qs, Ks, (cols + 7) / 8 * 8, part);
      add_rn(s, part);
    }
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  float* out = cb + ((int64_t)blockIdx.z * gridDim.y + c) * Q * Q;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int i = i0 + warp * 16 + gid + (e >> 1) * 8;
    if (i >= Q) continue;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int j = j0 + n * 8 + 2 * tig + (e & 1);
      if (j < Q) out[(int64_t)i * Q + j] = s[n][e];
    }
  }
}

// 4. For each state element, the chunks in ascending order from state_in
// (null: zeros): st[c] <- the state before chunk c; state_out <- the state
// after the last. Batches of 8 chunks have their loads in flight together;
// the adds run in chunk order whatever the batches, so a call split at a
// chunk boundary gives the same bits.
__global__ void ssd_scan_kernel_pass(float* __restrict__ st,
                                     const float* __restrict__ lc,
                                     const float* __restrict__ state_in,
                                     float* __restrict__ state_out,
                                     int64_t BH, int NP, int Q, int nc) {
  constexpr int kBatch = 8;   // chunks whose loads are in flight together
  const int64_t e = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (e >= BH * NP) return;
  const int64_t bh = e / NP, np = e % NP;
  float s = state_in != nullptr ? state_in[e] : 0.0f;
  for (int c0 = 0; c0 < nc; c0 += kBatch) {
    float d[kBatch], lt[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int64_t u = bh * nc + c0 + i;
      d[i] = c0 + i < nc ? st[u * NP + np] : 0.0f;
      lt[i] = c0 + i < nc ? lc[u * Q + Q - 1] : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      if (c0 + i >= nc) break;
      st[(bh * nc + c0 + i) * NP + np] = s;
      s = __fadd_rn(__fmul_rn(s, expf(lt[i])), d[i]);
    }
  }
  state_out[e] = s;
}

// 3. st[b, h, c] = dS_c = sum_j exp(clip(total - l_j)) k_j (x) v_j over the
// chunk, rows n0 .. n0 + 63 of N and columns p0 .. p0 + 63 of Pd. Grid
// (B * H * nc, ceil(Pd / 64), ceil(N / 64)).
// The k and v tiles of 64 keys come through a two-stage ring, the next
// tile's copy in flight while this one is multiplied; the weights multiply
// k at the fragment read.
template <typename T, int kCopy>
__global__ void __launch_bounds__(kThreads)
    ssd_scan_kernel_states(const T* __restrict__ k, const T* __restrict__ v,
                           const float* __restrict__ lc,
                           float* __restrict__ st, int S, int H, int N,
                           int Pd, int Q, int nc, int64_t k_sb, int64_t k_ss,
                           int64_t k_sh) {
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;                   // 2 x ([key][n], [key][p]), kCol
  float* w = ring + 4 * kT * kCol;      // [Q rounded up to kT] weights
  const int64_t unit = blockIdx.x;   // (b * H + h) * nc + c
  const int c = (int)(unit % nc);
  const int b = (int)(unit / nc / H), h = (int)(unit / nc % H);
  const int p0 = blockIdx.y * kT, n0 = blockIdx.z * kT;
  const int t0 = c * Q;
  const float* l = lc + unit * Q;
  const T* kb = k + b * k_sb + h * k_sh + n0;
  const int64_t v_tok = (int64_t)H * Pd;
  const T* vb = v + (int64_t)b * S * v_tok + (int64_t)h * Pd + p0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int len = min(Q, S - t0);   // steps of this chunk in the sequence
  const int n_kt = (len + kT - 1) / kT;
  const float total = l[Q - 1];
  for (int j = threadIdx.x; j < n_kt * kT; j += kThreads)
    w[j] = j < len ? decay(total - l[j]) : 0.0f;
  auto fetch = [&](int jt) {
    float* Ks = ring + (jt & 1) * 2 * kT * kCol;
    const int j0 = jt * kT, rows = min(kT, len - j0);
    load_tile<kCopy>(Ks, kCol, kb + (int64_t)(t0 + j0) * k_ss, k_ss, rows,
                      N - n0);
    load_tile<kCopy>(Ks + kT * kCol, kCol, vb + (int64_t)(t0 + j0) * v_tok,
                      v_tok, rows, Pd - p0);
    cp_commit();
  };
  float acc[8][4];
  zero(acc);
  fetch(0);
  for (int jt = 0; jt < n_kt; ++jt) {
    cp_wait<0>();
    __syncthreads();   // tile jt is in (and w); tile jt - 1's readers done
    if (jt + 1 < n_kt) fetch(jt + 1);
    const float* Ks = ring + (jt & 1) * 2 * kT * kCol;
    const float* Vs = Ks + kT * kCol;
    const float* wt = w + jt * kT;
    // A = (w k)^T: row n, key slot ks*8 + 2 tig (+1)
    float pv[8][4];
    zero(pv);
#pragma unroll
    for (int ks = 0; ks < 8; ++ks) {
      const int j = ks * 8 + 2 * tig;
      const float* kr = Ks + j * kCol + warp * 16 + gid;
      const float w0 = wt[j], w1 = wt[j + 1];
      ich::FragA a;
      a.set(kr[0] * w0, kr[8] * w0, kr[kCol] * w1, kr[kCol + 8] * w1);
      const float* vr = Vs + j * kCol + gid;
      ich::FragB bf[8];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
        bf[nt].set(vr[nt * 8], vr[kCol + nt * 8]);
      ich::mma_row<8>(pv, a, bf);
    }
    add_rn(acc, pv);
  }
  float* out = st + unit * N * Pd;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int n = n0 + warp * 16 + gid + (e >> 1) * 8;
    if (n >= N) continue;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int p = p0 + nt * 8 + 2 * tig + (e & 1);
      if (p < Pd) out[(int64_t)n * Pd + p] = acc[nt][e];
    }
  }
}

constexpr int states_smem_bytes(int Q) {
  return (int)sizeof(float) * (4 * kT * kCol + (Q + kT - 1) / kT * kT);
}

// out += this warp's 16 rows of Qt (a [64][kRow] tile of q over 64 of N)
// . St (a [64][kCol] tile of S_prev, rows of N) over the first np rows of
// St (a multiple of 8): a 16 x 64 tile of the warp in accumulator fragments.
__device__ __forceinline__ void state_product(const float* Qt,
                                              const float* St, int np,
                                              float (*out)[4]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const float* ar = Qt + (warp * 16 + gid) * kRow + 2 * tig;
  for (int kk = 0; kk < np; kk += 8) {
    const float2 a0 = *reinterpret_cast<const float2*>(ar + kk);
    const float2 a1 = *reinterpret_cast<const float2*>(ar + 8 * kRow + kk);
    ich::FragA a;
    a.set(a0.x, a1.x, a0.y, a1.y);
    const float* sr = St + (kk + 2 * tig) * kCol + gid;
    ich::FragB bf[8];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) bf[nt].set(sr[nt * 8], sr[kCol + nt * 8]);
    ich::mma_row<8>(out, a, bf);
  }
}

// 5. y for one (b, h, chunk, 64-row tile, 64 columns of Pd). kShared: the
// raw scores come from cb (cb_heads = 1: one tile for all heads; H: one per
// head); else q.k is computed here from this head's q, k (N <= 64 only).
// Grid (n_tiles * B * H * nc, ceil(Pd / 64)), row tiles heaviest first.
// The key tiles (a tile of scores or of k, and a tile of v) come through a
// two-stage ring, the next one's copy in flight while this one is
// multiplied. The inter-chunk term takes N in 64-wide slices: the first
// (q and S_prev staged before the key tiles) straight into its
// accumulator, the others through the ring once the key tiles are done,
// each from a zero fragment and a rounded add (kWideN: N may exceed 64;
// else the slice loop is not compiled, and the kernel keeps the registers
// of one slice). has_state: the first chunk has a state before it too
// (st[0], the given state).
template <typename T, bool kShared, int kCopy, bool kWideN>
__global__ void __launch_bounds__(kThreads)
    ssd_scan_kernel_y(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const float* __restrict__ lc,
                      const float* __restrict__ cb,
                      const float* __restrict__ st, T* __restrict__ y,
                      int S, int H, int N, int Pd, int Q, int nc,
                      int cb_heads, int has_state, int64_t q_sb, int64_t q_ss,
                      int64_t q_sh, int64_t k_sb, int64_t k_ss,
                      int64_t k_sh) {
  extern __shared__ __align__(16) float smem[];
  constexpr int kStage = kTile + kT * kCol;
  float* Qs = smem;                 // [row][n], kRow
  float* ring = Qs + kTile;         // 2 x ([row][key] or [key][n], kRow;
                                    //      [key][p], kCol)
  float* Sp = ring + 2 * kStage;    // [n][p], kCol: S_prev
  float* l = Sp + kT * kCol;        // [Q] this chunk's l
  const int n_tiles = (Q + kT - 1) / kT;
  const int64_t units = (int64_t)gridDim.x / n_tiles;
  const int rt = n_tiles - 1 - (int)(blockIdx.x / units);
  const int64_t unit = blockIdx.x % units;   // (b * H + h) * nc + c
  const int c = (int)(unit % nc);
  const int b = (int)(unit / nc / H), h = (int)(unit / nc % H);
  const int p0 = blockIdx.y * kT;
  const int t0 = c * Q, i0 = rt * kT;
  const int len = min(Q, S - t0);
  if (i0 >= len) return;   // a row tile past the end of the sequence
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const T* qb = q + b * q_sb + h * q_sh + (int64_t)(t0 + i0) * q_ss;
  const T* kb = k + b * k_sb + h * k_sh;
  const int64_t v_tok = (int64_t)H * Pd;
  const int64_t vy0 = (int64_t)b * S * v_tok + (int64_t)h * Pd + p0;
  const float* cbb =
      kShared ? cb + (((int64_t)b * cb_heads + (cb_heads > 1 ? h : 0)) * nc +
                      c) * Q * Q
              : cb;
  const float* sp = st + unit * N * Pd + p0;   // S_prev, columns from p0
  const int rows_i = min(kT, len - i0);
  const int n0_cols = min(kT, N);
  const int np = (n0_cols + 7) / 8 * 8;
  const bool prev = c > 0 || has_state;   // S_prev != 0

  for (int i = threadIdx.x; i < Q; i += kThreads) l[i] = lc[unit * Q + i];
  load_tile<kCopy>(Qs, kRow, qb, q_ss, rows_i, n0_cols);
  if (prev)   // the state before this chunk, rows 0 .. 63 of N
    load_tile<kCopy>(Sp, kCol, sp, (int64_t)Pd, n0_cols, Pd - p0);
  auto fetch = [&](int jt) {
    float* A = ring + (jt & 1) * kStage;
    const int j0 = jt * kT, rows = min(kT, len - j0);
    if constexpr (kShared)
      load_tile<kCopy>(A, kRow, cbb + (int64_t)i0 * Q + j0, (int64_t)Q,
                        min(kT, Q - i0), min(kT, Q - j0));
    else
      load_tile<kCopy>(A, kRow, kb + (int64_t)(t0 + j0) * k_ss, k_ss, rows,
                        N);
    load_tile<kCopy>(A + kTile, kCol, v + vy0 + (int64_t)(t0 + j0) * v_tok,
                      v_tok, rows, Pd - p0);
    cp_commit();
  };
  fetch(0);
  float li[2];   // l of this thread's rows
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = i0 + warp * 16 + gid + 8 * r;
    li[r] = i < Q ? lc[unit * Q + i] : 0.0f;
  }
  float acc[8][4];
  zero(acc);
  for (int jt = 0; jt <= rt; ++jt) {
    cp_wait<0>();
    __syncthreads();   // tile jt is in (and l, Qs, Sp); tile jt - 1 is free
    if (jt < rt) fetch(jt + 1);
    const float* A = ring + (jt & 1) * kStage;
    const int j0 = jt * kT;
    float s[8][4];
    if constexpr (kShared) {   // the scores as they lie in the tile
      const float* sr = A + (warp * 16 + gid) * kRow + 2 * tig;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const float2 u = *reinterpret_cast<const float2*>(sr + n * 8);
        const float2 d = *reinterpret_cast<const float2*>(sr + 8 * kRow +
                                                          n * 8);
        s[n][0] = u.x;
        s[n][1] = u.y;
        s[n][2] = d.x;
        s[n][3] = d.y;
      }
    } else {
      zero(s);
      row_product(Qs, A, np, s);
    }
    // decay and causal mask, in registers (entries above the diagonal
    // are never read: cb holds no value there)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = i0 + warp * 16 + gid + (e >> 1) * 8;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int j = j0 + n * 8 + 2 * tig + (e & 1);
        s[n][e] = (j <= i && i < Q) ? s[n][e] * decay(li[e >> 1] - l[j])
                                    : 0.0f;
      }
    }
    key_product(s, A + kTile, acc);
  }

  // inter-chunk term: exp(l_i) q_i . S_prev (S_prev = 0 in the first chunk
  // when no state is given)
  float inter[8][4];
  zero(inter);
  if (prev) {
    state_product(Qs, Sp, np, inter);
    const int n_slices = (N + kT - 1) / kT;
    if (kWideN && n_slices > 1) {
      auto fetch_n = [&](int ns) {   // q and S_prev over N slice ns
        float* A = ring + (ns & 1) * kStage;
        const int n0 = ns * kT, cols = min(kT, N - n0);
        load_tile<kCopy>(A, kRow, qb + n0, q_ss, rows_i, cols);
        load_tile<kCopy>(A + kTile, kCol, sp + (int64_t)n0 * Pd,
                          (int64_t)Pd, cols, Pd - p0);
        cp_commit();
      };
      __syncthreads();   // every warp is past its last key tile
      fetch_n(1);
      for (int ns = 1; ns < n_slices; ++ns) {
        cp_wait<0>();
        __syncthreads();   // slice ns is in; slice ns - 1 is free
        if (ns + 1 < n_slices) fetch_n(ns + 1);
        const float* A = ring + (ns & 1) * kStage;
        float part[8][4];
        zero(part);
        state_product(A, A + kTile, (min(kT, N - ns * kT) + 7) / 8 * 8,
                      part);
        add_rn(inter, part);
      }
    }
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int i = i0 + warp * 16 + gid + (e >> 1) * 8;
    if (i >= len) continue;
    const float el = expf(li[e >> 1]);
    T* yr = y + vy0 + (int64_t)(t0 + i) * v_tok;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int p = nt * 8 + 2 * tig + (e & 1);
      if (p0 + p < Pd)
        store(yr + p, __fadd_rn(acc[nt][e], __fmul_rn(inter[nt][e], el)));
    }
  }
}

constexpr int y_smem_bytes(int Q) {
  return (int)sizeof(float) * (kTile + 2 * (kTile + kT * kCol) + kT * kCol +
                               Q);
}

int launched() { return (int)cudaGetLastError(); }

// Raise a kernel's dynamic shared-memory limit to `bytes` once per device
// (at the longest chunk, so one setting serves every call):
// cudaFuncSetAttribute costs more than a small launch, and the serving
// path calls the kernels hundreds of times.
template <auto Kernel>
int allow_smem(int bytes) {
  constexpr int kMaxDevices = 64;
  static bool done[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < kMaxDevices && done[dev]) return 0;
  e = cudaFuncSetAttribute(Kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return (int)e;
}


// The chunk states, the state pass and y, once the path is chosen.
template <typename T, int kCopy>
int launch_rest(const T* q, const T* k, const T* v, const float* state_in,
                T* y, float* state, float* lc, float* cb, float* st, int B,
                int S, int H, int N, int Pd, int Q, int nc, int cb_heads,
                int64_t q_sb, int64_t q_ss, int64_t q_sh, int64_t k_sb,
                int64_t k_ss, int64_t k_sh, cudaStream_t s) {
  const int n_tiles = (Q + kT - 1) / kT;
  const int p_tiles = (Pd + kT - 1) / kT;
  const int n_slices = (N + kT - 1) / kT;
  const int64_t units = (int64_t)B * H * nc;
  int err = allow_smem<ssd_scan_kernel_states<T, kCopy>>(
      states_smem_bytes(kMaxChunk));
  if (err != 0) return err;
  ssd_scan_kernel_states<T, kCopy>
      <<<dim3((unsigned)units, p_tiles, n_slices), kThreads,
          states_smem_bytes(Q), s>>>(k, v, lc, st, S, H, N, Pd, Q, nc, k_sb,
                                     k_ss, k_sh);
  if ((err = launched()) != 0) return err;
  const int64_t elems = (int64_t)B * H * N * Pd;
  ssd_scan_kernel_pass<<<(unsigned)((elems + 255) / 256), 256, 0, s>>>(
      st, lc, state_in, state, (int64_t)B * H, N * Pd, Q, nc);
  if ((err = launched()) != 0) return err;
  // y: scores from cb, N in one slice or more; or q.k in place (N <= 64,
  // checked by launch)
  auto kernel = ssd_scan_kernel_y<T, true, kCopy, true>;
  if (cb == nullptr) {
    kernel = ssd_scan_kernel_y<T, false, kCopy, false>;
    err = allow_smem<ssd_scan_kernel_y<T, false, kCopy, false>>(
        y_smem_bytes(kMaxChunk));
  } else if (N > kT) {
    err = allow_smem<ssd_scan_kernel_y<T, true, kCopy, true>>(
        y_smem_bytes(kMaxChunk));
  } else {
    kernel = ssd_scan_kernel_y<T, true, kCopy, false>;
    err = allow_smem<ssd_scan_kernel_y<T, true, kCopy, false>>(
        y_smem_bytes(kMaxChunk));
  }
  if (err != 0) return err;
  kernel<<<dim3((unsigned)(units * n_tiles), p_tiles), kThreads,
           y_smem_bytes(Q), s>>>(q, k, v, lc, cb, st, y, S, H, N, Pd, Q, nc,
                                 cb_heads, state_in != nullptr, q_sb, q_ss,
                                 q_sh, k_sb, k_ss, k_sh);
  return launched();
}

template <typename T>
int launch(const T* q, const T* k, const T* v, const float* log_a,
           const float* state_in, T* y, float* state, float* lc, float* cb,
           float* st, int B, int S, int H, int N, int Pd, int Q,
           int cb_heads, int64_t q_sb, int64_t q_ss, int64_t q_sh,
           int64_t k_sb, int64_t k_ss, int64_t k_sh, cudaStream_t s) {
  const int nc = (S + Q - 1) / Q;
  const int n_tiles = (Q + kT - 1) / kT;
  const int p_tiles = (Pd + kT - 1) / kT;
  const int64_t units = (int64_t)B * H * nc;
  if (units * n_tiles > INT32_MAX || nc > 65535 ||
      (int64_t)B * (cb_heads > 1 ? cb_heads : 1) > 65535 || p_tiles > 65535)
    return (int)cudaErrorInvalidConfiguration;
  // step 5 computes q.k in place over one slice of N only
  if (cb == nullptr ? N > kT : (cb_heads != 1 && cb_heads != H))
    return (int)cudaErrorInvalidValue;
  const int warps = kThreads / 32;
  ssd_scan_kernel_cumsum<<<(unsigned)((units + warps - 1) / warps), kThreads,
                           0, s>>>(log_a, lc, B, S, H, Q, nc);
  int err = launched();
  if (err != 0) return err;
  if (cb != nullptr) {
    ssd_scan_kernel_cb<T><<<dim3(n_tiles * (n_tiles + 1) / 2, nc,
                                 B * cb_heads),
                            kThreads, 0, s>>>(q, k, cb, S, N, Q, cb_heads,
                                              q_sb, q_ss, q_sh, k_sb, k_ss,
                                              k_sh);
    if ((err = launched()) != 0) return err;
  }
  // the 16-byte copy path: float32, every row start of q, k, v, cb and the
  // state 16-byte aligned; other float32 strides take 4-byte copies
  auto al = [](const void* ptr) { return (uintptr_t)ptr % 16 == 0; };
  auto al4 = [](int64_t x) { return x % 4 == 0; };
  const bool vec = std::is_same<T, float>::value && al(q) && al(k) &&
                   al(v) && al(cb) && al(st) && al4(Q) && al4(Pd) &&
                   al4(q_sb) && al4(q_ss) && al4(q_sh) && al4(k_sb) &&
                   al4(k_ss) && al4(k_sh);
  if constexpr (std::is_same<T, float>::value) {
    if (vec)
      return launch_rest<T, 16>(q, k, v, state_in, y, state, lc, cb, st, B,
                                S, H, N, Pd, Q, nc, cb_heads, q_sb, q_ss,
                                q_sh, k_sb, k_ss, k_sh, s);
    return launch_rest<T, 4>(q, k, v, state_in, y, state, lc, cb, st, B, S,
                             H, N, Pd, Q, nc, cb_heads, q_sb, q_ss, q_sh,
                             k_sb, k_ss, k_sh, s);
  }
  return launch_rest<T, 0>(q, k, v, state_in, y, state, lc, cb, st, B, S, H,
                           N, Pd, Q, nc, cb_heads, q_sb, q_ss, q_sh, k_sb,
                           k_ss, k_sh, s);
}

}  // namespace

extern "C" {

// Launch the five kernels on `stream`. dtype 0 = float32, 1 = bfloat16 (q,
// k, v and y); log_a and the states are float32; 1 <= N <= 512;
// 1 <= chunk <= 1024; strides of q and k in elements over (b, s, h), unit
// over N; v, log_a, y and the states contiguous. state_in (B, H, N, Pd) is
// the state before the first step, or null for zeros. Scratch: lc (B, H,
// nc, chunk), st (B, H, nc, N, Pd), and cb (B, cb_heads, nc, chunk,
// chunk): cb_heads = 1 when q and k are shared by all heads (their head
// strides are then ignored), H for score tiles per head, or cb null (only
// for N <= 64). Returns a CUDA error code (0 = success).
int mamba_scan_launch(const void* q, const void* k, const void* v,
                      const float* log_a, const float* state_in, void* y,
                      float* state, float* lc, float* cb, float* st, int B,
                      int S, int H, int N, int Pd, int chunk, int cb_heads,
                      int64_t q_sb, int64_t q_ss, int64_t q_sh, int64_t k_sb,
                      int64_t k_ss, int64_t k_sh, int dtype, void* stream) {
  if (N > kNMax || N < 1 || chunk < 1 || chunk > kMaxChunk)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>((const float*)q, (const float*)k, (const float*)v,
                         log_a, state_in, (float*)y, state, lc, cb, st, B, S,
                         H, N, Pd, chunk, cb_heads, q_sb, q_ss, q_sh, k_sb,
                         k_ss, k_sh, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
        (const __nv_bfloat16*)v, log_a, state_in, (__nv_bfloat16*)y, state,
        lc, cb, st, B, S, H, N, Pd, chunk, cb_heads, q_sb, q_ss, q_sh, k_sb,
        k_ss, k_sh, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
