// Chunked SSD scan backward (Mamba2, mLSTM) for NVIDIA Hopper (sm_90a).
//
// The gradient of csrc/mamba_scan.cu's forward from a zero state. The
// reference has no Pallas kernel for it: XLA differentiates the jnp scan of
// src/repro/models/ssm.py's chunked_gated_scan (its lax.scan of einsums),
// whose algebra the forward kernel computes.
//
// What it computes. Per batch row b and head h, with l the inclusive
// cumulative sum of log_a inside a chunk of Q steps, total = l[Q-1],
// e_ij = exp(clip(l_i - l_j, -60, 0)), w_j = exp(clip(total - l_j, -60, 0)),
// S_{c-1} the state before chunk c (kept by the forward) and G_c the
// gradient of the state after chunk c (G_{nc-1} = 0: the final state takes
// no gradient), given dy:
//   G_{c-1} = exp(total_c) G_c + sum_i exp(l_i) q_i (x) dy_i
//   dq_i = sum_{j<=i} e_ij (dy_i . v_j) k_j + exp(l_i) S_{c-1} dy_i
//   dk_j = sum_{i>=j} e_ij (dy_i . v_j) q_i + w_j G_c v_j
//   dv_j = sum_{i>=j} e_ij (q_i . k_j) dy_i + w_j G_c^T k_j
//   dl_i = q_i . dq_i - k_i . dk_i (+ <G_c, S_c> at the chunk's last step)
//   dlog_a_t = sum_{s >= t in t's chunk} dl_s
// dq_i and dk_i in dl are each head's own (before a sum over heads when q
// and k are shared by all heads). Their pair terms give the row sum minus
// the column sum of e_ij (q_i . k_j)(dy_i . v_j): the gradient through
// e_ij, whose clipped pairs (below exp(-60) = 8.8e-27 of their term) the
// reference gives none. Steps past the end of the sequence read q = k =
// v = dy = 0 and take no gradient.
//
// What bounds it. Operations: per chunk of c steps and c(c+1)/2 causal
// pairs, 2N for each pair's q.k score (once per batch row when q and k are
// shared by the heads) and, per head, 2Pd for dy.v, 2N each for the pair
// terms of dq and dk, 2Pd for dv's, and 8 c N Pd for the four products
// with a chunk state (dq's, dk's and dv's terms and the adjoint state). At
// Zamba2-1.2B's training shape (B = 4, S = 2048, H = 64, N = Pd = 64,
// Q = 256, q and k shared) 51.8 GFLOP against 0.24 GB of bfloat16 q, k,
// v, dy and gradients plus the float32 kept chunk states and l: 0.073 ms
// for the bytes. In float32 (3xTF32) 3 x 51.8 GFLOP at 495 TFLOP/s =
// 0.314 ms; in bfloat16 the design below runs 112.0 GFLOP of bfloat16
// products (two for a float32 operand, one for q.k, per head, and dy.v,
// in dq's and dk's kernels) at 989 TFLOP/s, 0.113 ms: bound by
// operations either way. At xlstm-350m's mLSTM shape (B = 4, S = 2048,
// H = 4, N = 512, Pd = 513, q and k per head) 90.4 GFLOP, 76 % of it the
// products with a chunk state, against 0.37 GB in bfloat16 (0.110 ms):
// 0.548 ms in 3xTF32, 176.5 GFLOP and 0.179 ms in the bfloat16 split.
//
// The design: the forward's chunk decomposition run backwards, parallel
// over (b, h, chunk); the only sequential part is step 2, an elementwise
// walk over the chunks. One call runs six kernels in turn (seven when q
// and k are shared) on the caller's stream, each reading only what the
// ones before it wrote:
//   1. dstates — each chunk's sum_i exp(l_i) q_i (x) dy_i, 64 rows of N by
//      64 columns of Pd a CTA, into g (B, H, nc, N, Pd); chunk 0's is not
//      needed.
//   2. ssd_bwd_kernel_pass — one thread per state element walks the chunks
//      from the last down: g[c] <- G_c, G_{c-1} = exp(total_c) G_c + g[c],
//      loading 8 chunks' sums before it walks them.
//   3. ssd_bwd_kernel_gdot — <G_c, S_c> per (b, h, chunk) (S_c is the saved
//      state before chunk c + 1): one CTA of 512 threads, four strided sums
//      a thread by 16-byte loads, then a tree.
//   4. pair, three times: one kernel for the three gradients, each of the
//      form out_r = sum_t sigma_rt (a_r . b_t) c_t + omega_r a_r . M over
//      the chunk's rows r and keys t:
//        dq: a = dy, b = v, c = k, t <= r, M = S_{c-1}, omega = exp(l_r);
//        dk: a = v, b = dy, c = q, t >= r, M = G_c, omega = w_r;
//        dv: a = k, b = q, c = dy, t >= r, M = G_c^T, omega = w_r.
//      dq and dk also fold q_i . dq_i and k_i . dk_i per row (float32,
//      before any rounding to the output's type).
//   5. ssd_bwd_kernel_dl — dl and its reverse cumulative sum inside each
//      chunk, one warp per (b, h, chunk).
//   6. ssd_bwd_kernel_headsum (q and k shared by all heads) — dq and dk
//      summed over the heads' float32 partials in head order.
// Fixed order everywhere and no atomics: the same inputs give the same
// bits, whatever the number of SMs; with q and k shared, dv and dlog_a are
// the bits of q and k given per head, and dq and dk the head-order sums of
// their per-head values.
//
// Float32 (the parity checks' type): ssd_bwd_kernel_dstates and
// ssd_bwd_kernel_pair, every product on the tensor cores as the forward's,
// mma.sync m16n8k8 TF32 in the 3xTF32 split (mma_tf32.cuh); tiles staged
// by plain loads, any stride; per (b, h, chunk, 64-row tile), heaviest
// tiles first, the pair kernel computes the row tile's strip of decayed,
// masked scores (at most 64 x 256) into shared memory once and walks it
// for each 64-column tile of the output.
//
// Bfloat16 (training's type): ssd_bwd_kernel_dstates_bf16 and
// ssd_bwd_kernel_pair_bf16, every product on the bfloat16 tensor cores,
// mma.sync m16n8k16 with float32 accumulators (mma_bf16.cuh):
//   * A product of two bfloat16 inputs (the scores q.k and dy.v) is one
//     mma: its terms are exact in float32. A float32 operand (the decayed
//     masked scores, the chunk states S_{c-1} and G_c, exp(l_i) q_i) is
//     split in two, hi = bf16(x) and lo = bf16(x - hi), and multiplies its
//     exact bfloat16 partner twice, lo then hi, into one accumulator:
//     ~2^-16 of a term, where one rounding (2^-8) puts dlog_a, a reverse
//     sum of q.dq - k.dk that cancels, ~20x over its 1e-4 bar
//     (tests/_scan_bwd_bf16.py mirrors both). A warp issues the lo
//     products of its 4 or 8 accumulators before their hi ones, so no mma
//     waits on the one before it. Every sum over 64 keys or 64 of N or Pd
//     starts from a zero fragment and is added into its float32 total with
//     one rounded add.
//   * Every tile comes raw (bfloat16 as it lies, chunk states as float32)
//     through a ring of slots in shared memory filled by 16-byte cp.async
//     (cp_async.cuh), the next tiles' copies in flight while this one is
//     multiplied, one __syncthreads a step. Fragments come from bfloat16
//     tiles by ldmatrix; a chunk state's fragments are split from its
//     float32 tile as they are read. 16-byte copies need rows of a
//     multiple of 8 values at 16-byte-aligned starts: the wrapper pads q,
//     k, v, dy and the states with zeros to such widths where they are
//     not (xlstm's Pd = 513 runs as 520; dv comes back through the padded
//     buffer), timed inside the call.
//   * The pair kernel takes one (b, h, chunk, 64-row tile) a CTA, heaviest
//     row tiles first, keeps the row tile's a resident in shared memory
//     (all of K) and streams b, c and the chunk state; where a resident a
//     would not fit a CTA beside the ring and strip (K = Pd > 672, or >
//     1,360 in the narrow kernel), each 64-wide slice of a comes through
//     the ring with the slice of b or M it multiplies, staged again for
//     every key tile and column tile. Where the output is one column
//     tile (X <= 64: Zamba2's N = Pd = 64) a key tile's 64 x 64
//     decayed, masked scores stay in registers, from their product into
//     the product with c, as the forward's ssd_scan_kernel_y does: 4 warps
//     of 16 rows, 3 slots, ~65 KB at Zamba2's shape, 3 CTAs an SM. Where
//     X > 64 (xlstm: 8 or 9 column tiles) the scores of the whole row tile
//     go once into a strip in shared memory as bfloat16 hi/lo pairs (the
//     split made once, 64 x 256 x 4 bytes, the size of float32), and each
//     column tile walks it: 8 warps (16 rows x 32 columns each), 4 slots,
//     one CTA an SM (~207 KB at xlstm's shape).
//   * Off the diagonal a pair's decay exp(clip(l_i - l_j)) is the product
//     of a row factor and a key factor through the key tile's edge, both
//     <= 1 (the key factors once a CTA in shared memory): two multiplies,
//     not an exponential, per score. On the diagonal key tile the decay is
//     computed per pair, and a warp skips the 16-key steps its causal mask
//     zeroes.
// mamba_scan_bwd_occupancy reports each kernel's registers, shared memory
// and CTAs an SM for a call's shapes. Q <= 256.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "cp_async.cuh"
#include "mma_bf16.cuh"
#include "mma_tf32.cuh"

namespace {

constexpr int kT = 64;          // rows of a tile (64 rows, 64 columns)
constexpr int kNMax = 512;      // state rows taken
constexpr int kMaxChunk = 256;  // the longest chunk taken
constexpr int kThreads = 128;   // 4 warps, 16 tile rows each
constexpr int kRow = kT + 8;    // tiles read along the row (a, b, M^T)
constexpr int kCol = kT + 4;    // tiles read down a column (c, M, q, dy)
constexpr int kTile = kT * kRow;   // floats of a staged tile (>= kT * kCol)

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ float decay(float x) {
  return __expf(fminf(fmaxf(x, -60.0f), 0.0f));
}

// Stage a 64 x 64 float32 tile: dst[r * ss + c] = src[r * rs + c] for
// r < rows, c < cols; zeros elsewhere. Each thread starts all 32 of its
// loads before it stores any, so the tile costs one memory latency, not 32.
__device__ __forceinline__ void stage(float* dst, int ss, const float* src,
                                      int64_t rs, int rows, int cols) {
  constexpr int kPer = kT * kT / kThreads;
  const int c = threadIdx.x % kT, r0 = threadIdx.x / kT;
  constexpr int kStep = kThreads / kT;   // rows a pass
  float x[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int r = r0 + i * kStep;
    x[i] = r < rows && c < cols ? src[(int64_t)r * rs + c] : 0.0f;
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int r = r0 + i * kStep;
    dst[r * ss + c] = x[i];
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

// out += this warp's 16 rows of At (a [64][kRow] tile over 64 of the
// reduction) . Mt (a [64][kCol] tile, reduction rows) over the first np
// rows of Mt (a multiple of 8): a 16 x 64 tile in accumulator fragments.
__device__ __forceinline__ void state_product(const float* At,
                                              const float* Mt, int np,
                                              float (*out)[4]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const float* ar = At + (warp * 16 + gid) * kRow + 2 * tig;
  for (int kk = 0; kk < np; kk += 8) {
    const float2 a0 = *reinterpret_cast<const float2*>(ar + kk);
    const float2 a1 = *reinterpret_cast<const float2*>(ar + 8 * kRow + kk);
    ich::FragA a;
    a.set(a0.x, a1.x, a0.y, a1.y);
    const float* sr = Mt + (kk + 2 * tig) * kCol + gid;
    ich::FragB bf[8];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) bf[nt].set(sr[nt * 8], sr[kCol + nt * 8]);
    ich::mma_row<8>(out, a, bf);
  }
}

// 1. g[b, h, c] = sum_i exp(l_i) q_i (x) dy_i over chunk c >= 1, rows
// n0 .. n0 + 63 of N and columns p0 .. p0 + 63 of Pd. Grid (B * H * nc,
// ceil(Pd / 64), ceil(N / 64)).
__global__ void __launch_bounds__(kThreads)
    ssd_bwd_kernel_dstates(const float* __restrict__ q,
                           const float* __restrict__ dy,
                           const float* __restrict__ lc,
                           float* __restrict__ g, int S, int H, int N, int Pd,
                           int Q, int nc, int64_t q_sb, int64_t q_ss,
                           int64_t q_sh) {
  __shared__ __align__(16) float Qs[kT * kCol];   // [step][n]
  __shared__ __align__(16) float Ds[kT * kCol];   // [step][p]
  __shared__ float w[kMaxChunk];                  // exp(l_i), 0 past S
  const int64_t unit = blockIdx.x;   // (b * H + h) * nc + c
  const int c = (int)(unit % nc);
  if (c == 0) return;   // the gradient of the state before chunk 0
  const int b = (int)(unit / nc / H), h = (int)(unit / nc % H);
  const int p0 = blockIdx.y * kT, n0 = blockIdx.z * kT;
  const int t0 = c * Q;
  const float* l = lc + unit * Q;
  const float* qb = q + b * q_sb + h * q_sh + n0;
  const int64_t d_tok = (int64_t)H * Pd;
  const float* db = dy + (int64_t)b * S * d_tok + (int64_t)h * Pd + p0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int len = min(Q, S - t0);   // steps of this chunk in the sequence
  const int n_it = (len + kT - 1) / kT;
  for (int i = threadIdx.x; i < n_it * kT; i += kThreads)
    w[i] = i < len ? expf(l[i]) : 0.0f;
  float acc[8][4];
  zero(acc);
  for (int it = 0; it < n_it; ++it) {
    const int i0 = it * kT, rows = min(kT, len - i0);
    __syncthreads();   // w is in; the last tile's readers are done
    stage(Qs, kCol, qb + (int64_t)(t0 + i0) * q_ss, q_ss, rows, N - n0);
    stage(Ds, kCol, db + (int64_t)(t0 + i0) * d_tok, d_tok, rows, Pd - p0);
    __syncthreads();
    const float* wt = w + i0;
    // A = (w q)^T: row n, step slot ks*8 + 2 tig (+1)
    float pv[8][4];
    zero(pv);
#pragma unroll
    for (int ks = 0; ks < 8; ++ks) {
      const int j = ks * 8 + 2 * tig;
      const float* qr = Qs + j * kCol + warp * 16 + gid;
      const float w0 = wt[j], w1 = wt[j + 1];
      ich::FragA a;
      a.set(qr[0] * w0, qr[8] * w0, qr[kCol] * w1, qr[kCol + 8] * w1);
      const float* dr = Ds + j * kCol + gid;
      ich::FragB bf[8];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
        bf[nt].set(dr[nt * 8], dr[kCol + nt * 8]);
      ich::mma_row<8>(pv, a, bf);
    }
    add_rn(acc, pv);
  }
  float* out = g + unit * N * Pd;
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

// 2. For each state element, the chunks in descending order: g[c] <- G_c,
// the gradient of the state after chunk c (0 after the last), and
// G_{c-1} = exp(total_c) G_c + g[c] (kernel 1's sum). A thread loads
// kPassBatch chunks' sums and decays before it walks them, so that many
// loads are in flight, not one.
constexpr int kPassBatch = 8;
__global__ void ssd_bwd_kernel_pass(float* __restrict__ g,
                                    const float* __restrict__ lc,
                                    int64_t BH, int NP, int Q, int nc) {
  const int64_t e = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (e >= BH * NP) return;
  const int64_t bh = e / NP, np = e % NP;
  float G = 0.0f;
  for (int c1 = nc - 1; c1 >= 0; c1 -= kPassBatch) {
    float d[kPassBatch], a[kPassBatch];
#pragma unroll
    for (int j = 0; j < kPassBatch; ++j) {
      const int c = c1 - j;
      const int64_t u = bh * nc + c;
      d[j] = c > 0 ? g[u * NP + np] : 0.0f;
      a[j] = c > 0 ? expf(lc[u * Q + Q - 1]) : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < kPassBatch; ++j) {
      const int c = c1 - j;
      if (c < 0) break;
      g[(bh * nc + c) * NP + np] = G;
      if (c > 0) G = __fadd_rn(__fmul_rn(G, a[j]), d[j]);
    }
  }
}

// 3. gs[b, h, c] = <G_c, S_c>, S_c the state after chunk c = st[c + 1],
// the saved state before chunk c + 1 (0 for the last chunk: G = 0). One
// CTA of kGdotThreads per (b, h, c): each thread four strided sums (by
// 16-byte loads when N Pd is a multiple of 4), then a tree.
constexpr int kGdotThreads = 512;
__global__ void __launch_bounds__(kGdotThreads)
    ssd_bwd_kernel_gdot(const float* __restrict__ g,
                        const float* __restrict__ st, float* __restrict__ gs,
                        int NP, int nc) {
  __shared__ float part[kGdotThreads];
  const int64_t unit = blockIdx.x;
  float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if ((int)(unit % nc) + 1 < nc) {
    const float* a = g + unit * NP;
    const float* b = st + (unit + 1) * NP;
    if (NP % 4 == 0) {
      const float4* a4 = reinterpret_cast<const float4*>(a);
      const float4* b4 = reinterpret_cast<const float4*>(b);
#pragma unroll 4
      for (int i = threadIdx.x; i < NP / 4; i += kGdotThreads) {
        const float4 x = a4[i], y = b4[i];
        s[0] = __fmaf_rn(x.x, y.x, s[0]);
        s[1] = __fmaf_rn(x.y, y.y, s[1]);
        s[2] = __fmaf_rn(x.z, y.z, s[2]);
        s[3] = __fmaf_rn(x.w, y.w, s[3]);
      }
    } else {
      for (int i = threadIdx.x; i < NP; i += kGdotThreads)
        s[0] = __fmaf_rn(a[i], b[i], s[0]);
    }
  }
  part[threadIdx.x] = __fadd_rn(__fadd_rn(s[0], s[1]), __fadd_rn(s[2], s[3]));
  __syncthreads();
  for (int o = kGdotThreads / 2; o > 0; o >>= 1) {
    if ((int)threadIdx.x < o)
      part[threadIdx.x] = __fadd_rn(part[threadIdx.x], part[threadIdx.x + o]);
    __syncthreads();
  }
  if (threadIdx.x == 0) gs[unit] = part[0];
}

// One operand of a pair kernel: a (B, S, H, width) tensor read at strides
// (b, s, h) in elements, unit over its width.
template <typename T>
struct Side {
  const T* p;
  int64_t sb, ss, sh;
};

// The operands of one pair kernel: out_r = sum_t sigma_rt (a_r . b_t) c_t
// + omega_r a_r . M over rows r and keys t of a chunk. a and b have width
// K, c and d (the row dot's partner; d.p null: none) width X. M is the
// chunk's (N, Pd) matrix of a (B, H, nc, N, Pd) buffer: its rows are X
// (kInterRow: out_r[x] = sum_k a_r[k] M[x][k]) or K (out_r[x] =
// sum_k a_r[k] M[k][x]).
template <typename T, typename TO>
struct Pair {
  Side<T> a, b, c, d;
  const float* m;
  const float* lc;
  TO* out;
  int64_t o_sb, o_ss, o_sh;
  float* dot;   // (B, S, H): sum_x out_r[x] d_r[x], or null
  int S, H, N, Pd, Q, nc, K, X;
};

// 4. One gradient for one (b, h, chunk, 64-row tile). kAnti: the keys
// t >= r meet row r, sigma = exp(clip(l_t - l_r)), omega = w_r and M is
// live below the last chunk (dk, dv); else t <= r, sigma =
// exp(clip(l_r - l_t)), omega = exp(l_r) and M live above the first (dq).
// Grid (n_tiles * B * H * nc), heaviest row tiles first.
template <typename TO, bool kAnti, bool kInterRow>
__global__ void __launch_bounds__(kThreads)
    ssd_bwd_kernel_pair(const Pair<float, TO> p) {
  extern __shared__ __align__(16) float smem[];
  float* As = smem;            // [row][k], kRow: a
  float* Bs = As + kTile;      // [key][k] kRow: b; [key][x] kCol: c; M
  float* l = Bs + kTile;       // [kMaxChunk] this chunk's l
  float* strip = l + kMaxChunk;   // [row][key], sstride: the scores
  const int n_tiles = (p.Q + kT - 1) / kT;
  const int64_t units = (int64_t)gridDim.x / n_tiles;
  const int order = (int)(blockIdx.x / units);
  const int rt = kAnti ? order : n_tiles - 1 - order;
  const int64_t unit = blockIdx.x % units;   // (b * H + h) * nc + c
  const int c = (int)(unit % p.nc);
  const int b = (int)(unit / p.nc / p.H), h = (int)(unit / p.nc % p.H);
  const int t0 = c * p.Q, i0 = rt * kT;
  const int len = min(p.Q, p.S - t0);
  if (i0 >= len) return;   // a row tile past the end of the sequence
  const int n_kt = (len + kT - 1) / kT;
  const int first = kAnti ? rt : 0, last = kAnti ? n_kt - 1 : rt;
  const int sstride = (last - first + 1) * kT + 8;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int rows_i = min(kT, len - i0);

  for (int i = threadIdx.x; i < p.Q; i += kThreads)
    l[i] = p.lc[unit * p.Q + i];
  __syncthreads();
  const float total = l[p.Q - 1];
  float li[2], om[2];   // l and omega of this thread's two rows
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = i0 + warp * 16 + gid + 8 * r;
    li[r] = i < p.Q ? l[i] : 0.0f;
    om[r] = kAnti ? decay(total - li[r]) : expf(li[r]);
  }
  const float* ab =
      p.a.p + b * p.a.sb + h * p.a.sh + (int64_t)(t0 + i0) * p.a.ss;
  const float* bb = p.b.p + b * p.b.sb + h * p.b.sh + (int64_t)t0 * p.b.ss;
  const float* cb = p.c.p + b * p.c.sb + h * p.c.sh + (int64_t)t0 * p.c.ss;
  const int k_slices = (p.K + kT - 1) / kT;
  const bool a_once = k_slices == 1;   // a staged once for the whole CTA
  if (a_once) stage(As, kRow, ab, p.a.ss, rows_i, p.K);

  // the strip: sigma (a_r . b_t), masked, for every key tile it meets
  for (int t = first; t <= last; ++t) {
    const int j0 = t * kT, rows_t = min(kT, len - j0);
    float s[8][4];
    zero(s);
    for (int ks = 0; ks < k_slices; ++ks) {
      const int k0 = ks * kT, cols = min(kT, p.K - k0);
      __syncthreads();   // the last slice's readers are done
      if (!a_once) stage(As, kRow, ab + k0, p.a.ss, rows_i, cols);
      stage(Bs, kRow, bb + (int64_t)j0 * p.b.ss + k0, p.b.ss, rows_t, cols);
      __syncthreads();
      const int np = (cols + 7) / 8 * 8;
      if (ks == 0) {
        row_product(As, Bs, np, s);
      } else {
        float part[8][4];
        zero(part);
        row_product(As, Bs, np, part);
        add_rn(s, part);
      }
    }
    float* sr = strip + (t - first) * kT;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = warp * 16 + gid + (e >> 1) * 8, i = i0 + r;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int col = n * 8 + 2 * tig + (e & 1), j = j0 + col;
        const bool keep = (kAnti ? j >= i : j <= i) && i < len && j < len;
        sr[r * sstride + col] =
            keep ? s[n][e] * decay(kAnti ? l[j] - li[e >> 1]
                                         : li[e >> 1] - l[j])
                 : 0.0f;
      }
    }
  }

  // each 64-column tile of the output: the strip times c, then omega a . M
  const bool inter = kAnti ? c < p.nc - 1 : c > 0;   // M != 0
  const float* mb = p.m + unit * (int64_t)p.N * p.Pd;
  float dsum[2] = {0.0f, 0.0f};   // the row dot, in column order
  for (int x0 = 0; x0 < p.X; x0 += kT) {
    const int xcols = min(kT, p.X - x0);
    float acc[8][4];
    zero(acc);
    for (int t = first; t <= last; ++t) {
      const int j0 = t * kT, rows_t = min(kT, len - j0);
      __syncthreads();   // the last tile's readers are done
      stage(Bs, kCol, cb + (int64_t)j0 * p.c.ss + x0, p.c.ss, rows_t, xcols);
      __syncthreads();
      // this warp's score rows as it wrote them (no other warp's)
      const float* sr = strip + (warp * 16 + gid) * sstride +
                        (t - first) * kT + 2 * tig;
      float s[8][4];
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const float2 u = *reinterpret_cast<const float2*>(sr + n * 8);
        const float2 d = *reinterpret_cast<const float2*>(sr + 8 * sstride +
                                                          n * 8);
        s[n][0] = u.x;
        s[n][1] = u.y;
        s[n][2] = d.x;
        s[n][3] = d.y;
      }
      key_product(s, Bs, acc);
    }
    float in[8][4];
    zero(in);
    if (inter) {
      for (int ks = 0; ks < k_slices; ++ks) {
        const int k0 = ks * kT, cols = min(kT, p.K - k0);
        __syncthreads();   // the last tile's readers are done
        if (!a_once) stage(As, kRow, ab + k0, p.a.ss, rows_i, cols);
        if (kInterRow)   // M's rows are the output's columns
          stage(Bs, kRow, mb + (int64_t)x0 * p.Pd + k0, (int64_t)p.Pd, xcols,
                cols);
        else             // M's rows are the reduction's
          stage(Bs, kCol, mb + (int64_t)k0 * p.Pd + x0, (int64_t)p.Pd, cols,
                xcols);
        __syncthreads();
        const int np = (cols + 7) / 8 * 8;
        float part[8][4];
        zero(part);
        if (kInterRow)
          row_product(As, Bs, np, part);
        else
          state_product(As, Bs, np, part);
        add_rn(in, part);
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = i0 + warp * 16 + gid + (e >> 1) * 8;
      if (i >= len) continue;
      const int64_t tok = t0 + i;
      TO* orow = p.out + b * p.o_sb + h * p.o_sh + tok * p.o_ss + x0;
      const float* drow = p.d.p == nullptr ? nullptr
                                            : p.d.p + b * p.d.sb +
                                                  h * p.d.sh + tok * p.d.ss +
                                                  x0;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int x = nt * 8 + 2 * tig + (e & 1);
        if (x >= xcols) continue;
        const float o =
            __fadd_rn(acc[nt][e], __fmul_rn(in[nt][e], om[e >> 1]));
        store(orow + x, o);
        if (drow != nullptr)
          dsum[e >> 1] = __fmaf_rn(o, drow[x], dsum[e >> 1]);
      }
    }
  }
  if (p.dot == nullptr) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {   // the four lanes of a row, pairwise
    dsum[r] = __fadd_rn(dsum[r], __shfl_xor_sync(0xffffffffu, dsum[r], 1));
    dsum[r] = __fadd_rn(dsum[r], __shfl_xor_sync(0xffffffffu, dsum[r], 2));
    const int i = i0 + warp * 16 + gid + 8 * r;
    if (tig == 0 && i < len)
      p.dot[((int64_t)b * p.S + t0 + i) * p.H + h] = dsum[r];
  }
}

constexpr int pair_smem_bytes(int Q) {
  return (int)sizeof(float) *
         (2 * kTile + kMaxChunk + kT * ((Q + kT - 1) / kT * kT + 8));
}

// 5. dlog_a of every step of one (b, h, chunk): dl_i = qdq_i - kdk_i, plus
// gs at the chunk's last step, and its reverse cumulative sum inside the
// chunk (lane runs from the end, then a warp scan of the lane totals).
// One warp per (b, h, chunk).
__global__ void ssd_bwd_kernel_dl(const float* __restrict__ qdq,
                                  const float* __restrict__ kdk,
                                  const float* __restrict__ gs,
                                  float* __restrict__ dla, int B, int S,
                                  int H, int Q, int nc) {
  const int64_t unit = blockIdx.x * (int64_t)(kThreads / 32) +
                       (threadIdx.x >> 5);   // (b * H + h) * nc + c
  if (unit >= (int64_t)B * H * nc) return;
  const int lane = threadIdx.x & 31;
  const int c = (int)(unit % nc);
  const int64_t bh = unit / nc;
  const int b = (int)(bh / H), h = (int)(bh % H);
  const int t0 = c * Q;
  const float tail = gs[unit];
  auto dl = [&](int i) {
    const int64_t t = t0 + i;
    float v = 0.0f;
    if (t < S) {
      const int64_t at = ((int64_t)b * S + t) * H + h;
      v = __fsub_rn(qdq[at], kdk[at]);
    }
    return i == Q - 1 ? __fadd_rn(v, tail) : v;
  };
  const int per = (Q + 31) / 32;
  const int lo = min(lane * per, Q), hi = min(lo + per, Q);
  float run = 0.0f;
  for (int i = hi - 1; i >= lo; --i) run = __fadd_rn(run, dl(i));
  float incl = run;   // this lane's run and every later lane's
  for (int o = 1; o < 32; o <<= 1) {
    const float u = __shfl_down_sync(0xffffffffu, incl, o);
    if (lane + o < 32) incl = __fadd_rn(incl, u);
  }
  float acc = __shfl_down_sync(0xffffffffu, incl, 1);
  if (lane == 31) acc = 0.0f;
  for (int i = hi - 1; i >= lo; --i) {
    acc = __fadd_rn(acc, dl(i));
    const int64_t t = t0 + i;
    if (t < S) dla[((int64_t)b * S + t) * H + h] = acc;
  }
}

// 6. out[row, n] = sum_h part[row, h, n] in head order, rows = B * S.
template <typename T>
__global__ void ssd_bwd_kernel_headsum(const float* __restrict__ part,
                                       T* __restrict__ out, int64_t rows,
                                       int H, int N) {
  const int64_t e = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (e >= rows * N) return;
  const int64_t row = e / N, n = e % N;
  const float* src = part + row * H * N + n;
  float s = src[0];
  for (int hh = 1; hh < H; ++hh) s = __fadd_rn(s, src[(int64_t)hh * N]);
  store(out + e, s);
}

// ---- bfloat16: split products on the bfloat16 tensor cores ----

using bf16 = __nv_bfloat16;
constexpr int kBS = kT + 8;             // a bfloat16 tile's row (72 values)
constexpr int kTileB = kT * kBS;        // values of a bfloat16 tile
constexpr int kMRow = kT + 8;           // a state tile whose rows are X
constexpr int kMCol = kT + 4;           // a state tile whose rows are K
constexpr int kSlot = 2 * kTileB * 2;   // bytes of a ring slot: two
                                        // bfloat16 tiles or 64 x 72 floats
constexpr int kStagesD = 3;   // ring slots: dstates
constexpr int kStagesN = 3;   // ring slots: the narrow pair kernel
constexpr int kStagesW = 4;   // ring slots: the wide pair kernel
constexpr int kWideThreads = 256;   // the wide pair kernel: 8 warps
constexpr int kMaxSmem = 232448;    // shared memory a CTA can have

// The row of a resident bfloat16 operand of width K (a multiple of 8):
// room for whole 16-value steps (the last reads zeros), and stride / 8
// odd, so the eight rows of an ldmatrix fall in distinct banks.
__host__ __device__ constexpr int res_stride(int K) {
  return (K + 15) / 16 * 16 + 8;
}
// The strip's row: every key of the longest chunk, stride / 8 odd
__host__ __device__ constexpr int strip_stride(int Q) {
  return (Q + kT - 1) / kT * kT + 8;
}

// Queue a bfloat16 tile by 16-byte cp.async: dst[r][8c..8c+7] =
// src[r * rs + 8c..] for r < rows and c < pieces, zeros for the other
// pieces c < n_pieces of the 64 rows.
template <int NT>
__device__ __forceinline__ void tile_async(bf16* dst, int ds, const bf16* src,
                                           int64_t rs, int rows, int pieces,
                                           int n_pieces) {
  for (int e = threadIdx.x; e < kT * n_pieces; e += NT) {
    const int r = e / n_pieces, c = e - r * n_pieces;
    const bool ok = r < rows && c < pieces;
    ich::cp16(dst + r * ds + 8 * c, ok ? src + r * rs + 8 * c : src, ok);
  }
}

// Queue a 64 x 64 float32 tile by 16-byte cp.async: dst[r][c] =
// src[r * rs + c] for r < rows, c < cols (a multiple of 4), zeros
// elsewhere.
template <int NT>
__device__ __forceinline__ void ftile_async(float* dst, int ds,
                                            const float* src, int64_t rs,
                                            int rows, int cols) {
  for (int e = threadIdx.x; e < kT * 16; e += NT) {
    const int r = e >> 4, c = (e & 15) * 4;
    const bool ok = r < rows && c < cols;
    ich::cp16(dst + r * ds + c, ok ? src + r * rs + c : src, ok);
  }
}

template <int NN>
__device__ __forceinline__ void zero_n(float (*f)[4]) {
#pragma unroll
  for (int n = 0; n < NN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) f[n][e] = 0.0f;
}

template <int NN>
__device__ __forceinline__ void add_rn_n(float (*acc)[4],
                                         const float (*p)[4]) {
#pragma unroll
  for (int n = 0; n < NN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = __fadd_rn(acc[n][e], p[n][e]);
}

// s[n] += this warp's rows r0..r0+15 of A (columns ka.., a [64][as] tile)
// . B^T over nk 16-value steps, B a [key][k] tile (kBS): the n8 tiles
// n < NN of keys n0.. One mma a step and tile: both operands exact.
template <int NN>
__device__ __forceinline__ void mma_ab(float (*s)[4], const bf16* A, int as,
                                       int r0, int ka, const bf16* B, int n0,
                                       int nk, int lane) {
  for (int kk = 0; kk < nk; ++kk) {
    uint32_t a[4];
    ich::load_a(a, A, as, r0, ka + 16 * kk, lane);
#pragma unroll
    for (int m = 0; m < NN / 2; ++m) {
      uint32_t b[2][2];
      ich::load_b(b, B, kBS, n0 + 16 * m, 16 * kk, lane);
      ich::mma_bf16(s[2 * m], a, b[0]);
      ich::mma_bf16(s[2 * m + 1], a, b[1]);
    }
  }
}

// acc[n] += hi . b[n], after lo . b[n] for all n < NN: the two products
// of a split operand NN mmas apart, so the tensor pipe need not wait for
// one to finish before the next
template <int NN>
__device__ __forceinline__ void mma_split(float (*acc)[4], const uint32_t* hi,
                                          const uint32_t* lo,
                                          const uint32_t (*b)[2]) {
#pragma unroll
  for (int n = 0; n < NN; ++n) ich::mma_bf16(acc[n], lo, b[n]);
#pragma unroll
  for (int n = 0; n < NN; ++n) ich::mma_bf16(acc[n], hi, b[n]);
}

// acc[n] += P . C over the 16-key steps kk_lo <= kk < kk_hi: P this warp's
// 16 x 64 decayed scores as accumulator fragments p[8] (keys 8n..),
// split hi/lo as A fragments where they lie; C a [key][x] tile (kBS),
// columns n0.. for the n8 tiles n < NN.
template <int NN>
__device__ __forceinline__ void mma_pc_regs(float (*acc)[4],
                                            const float (*p)[4],
                                            const bf16* C, int n0, int kk_lo,
                                            int kk_hi, int lane) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if (kk < kk_lo || kk >= kk_hi) continue;
    uint32_t hi[4], lo[4], b[NN][2];
    ich::split_a_from_c(hi, lo, p[2 * kk], p[2 * kk + 1]);
#pragma unroll
    for (int m = 0; m < NN / 2; ++m)
      ich::load_bt(b + 2 * m, C, kBS, 16 * kk, n0 + 16 * m, lane);
    mma_split<NN>(acc, hi, lo, b);
  }
}

// The same with P from the strip: its hi and lo planes ([row][key], ps),
// this warp's rows r0.., keys kp.. of the key tile
template <int NN>
__device__ __forceinline__ void mma_pc_strip(float (*acc)[4], const bf16* Ph,
                                             const bf16* Pl, int ps, int r0,
                                             int kp, const bf16* C, int n0,
                                             int kk_lo, int kk_hi, int lane) {
  for (int kk = kk_lo; kk < kk_hi; ++kk) {
    uint32_t hi[4], lo[4], b[NN][2];
    ich::load_a(hi, Ph, ps, r0, kp + 16 * kk, lane);
    ich::load_a(lo, Pl, ps, r0, kp + 16 * kk, lane);
#pragma unroll
    for (int m = 0; m < NN / 2; ++m)
      ich::load_bt(b + 2 * m, C, kBS, 16 * kk, n0 + 16 * m, lane);
    mma_split<NN>(acc, hi, lo, b);
  }
}

// out[n] += this warp's rows r0.. of A (columns ka.., a [64][as] tile) . M
// over nk 16-value steps, M a float32 tile of a chunk state whose
// fragments are split hi/lo as they are read: kRowM, M's rows are the
// output's columns (kMRow: out[x] = sum_k a[k] M[x][k]); else they are the
// reduction's (kMCol: out[x] = sum_k a[k] M[k][x]). n8 tiles n < NN of
// columns n0..
template <int NN, bool kRowM>
__device__ __forceinline__ void mma_am(float (*out)[4], const bf16* A, int as,
                                       int r0, int ka, const float* M, int n0,
                                       int nk, int lane) {
  const int gid = lane >> 2, tig = lane & 3;
  for (int kk = 0; kk < nk; ++kk) {
    uint32_t a[4], hi[NN][2], lo[NN][2];
    ich::load_a(a, A, as, r0, ka + 16 * kk, lane);
    const int k = 16 * kk + 2 * tig;
#pragma unroll
    for (int n = 0; n < NN; ++n) {
      const int x = n0 + 8 * n + gid;
      float2 v0, v1;
      if (kRowM) {
        v0 = *reinterpret_cast<const float2*>(M + x * kMRow + k);
        v1 = *reinterpret_cast<const float2*>(M + x * kMRow + k + 8);
      } else {
        v0 = make_float2(M[k * kMCol + x], M[(k + 1) * kMCol + x]);
        v1 = make_float2(M[(k + 8) * kMCol + x], M[(k + 9) * kMCol + x]);
      }
      ich::split_bf16(v0.x, v0.y, &hi[n][0], &lo[n][0]);
      ich::split_bf16(v1.x, v1.y, &hi[n][1], &lo[n][1]);
    }
#pragma unroll
    for (int n = 0; n < NN; ++n) ich::mma_bf16(out[n], a, lo[n]);
#pragma unroll
    for (int n = 0; n < NN; ++n) ich::mma_bf16(out[n], a, hi[n]);
  }
}

// s <- sigma s on the pairs the gradient keeps, 0 elsewhere: this thread's
// fragment rows i and i + 8 (l li[0], li[1]) and keys j + 8n (+1).
// kAnti: keys at or after the row, sigma = exp(clip(l_j - l_i)); else at
// or before it, exp(clip(l_i - l_j)).
template <int NN, bool kAnti>
__device__ __forceinline__ void decay_mask(float (*s)[4], const float* l,
                                           const float* li, int i, int j,
                                           int len) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int ie = i + (e >> 1) * 8;
#pragma unroll
    for (int n = 0; n < NN; ++n) {
      const int je = j + 8 * n + (e & 1);
      const bool keep = (kAnti ? je >= ie : je <= ie) && ie < len && je < len;
      s[n][e] = keep ? s[n][e] * decay(kAnti ? l[je] - li[e >> 1]
                                             : li[e >> 1] - l[je])
                     : 0.0f;
    }
  }
}

// s <- s rf cf on the pairs inside the sequence, 0 elsewhere: an
// off-diagonal key tile's decays as a row factor rf (this thread's rows i
// and i + 8) times a column factor cf[j] (keys j + 8n (+1)), both <= 1
// (see the pair kernel). Their product stands for exp(clip(l_i - l_j)) to
// a few float32 ulps, and below exp(-60) for a clipped pair (0 where a
// factor underflows), 8.8e-27 of the term or less.
template <int NN>
__device__ __forceinline__ void decay_factored(float (*s)[4], const float* cf,
                                               const float* rf, int i, int j,
                                               int len) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int ie = i + (e >> 1) * 8;
#pragma unroll
    for (int n = 0; n < NN; ++n) {
      const int je = j + 8 * n + (e & 1);
      s[n][e] = ie < len && je < len ? s[n][e] * rf[e >> 1] * cf[je] : 0.0f;
    }
  }
}

// 1 (bfloat16). g[b, h, c] = sum_i exp(l_i) q_i (x) dy_i over chunk c >= 1,
// rows n0 .. n0 + 63 of N and columns p0 .. p0 + 63 of Pd: A = (exp(l) q)^T
// from the q tile by ldmatrix.trans, scaled and split hi/lo; B = dy.
// 64-step tiles of q and dy through a ring of kStagesD slots. Grid (B * H *
// nc, ceil(Pd / 64), ceil(N / 64)).
__global__ void __launch_bounds__(kThreads, 4)
    ssd_bwd_kernel_dstates_bf16(const bf16* __restrict__ q,
                                const bf16* __restrict__ dy,
                                const float* __restrict__ lc,
                                float* __restrict__ g, int S, int H, int N,
                                int Pd, int Q, int nc, int64_t q_sb,
                                int64_t q_ss, int64_t q_sh) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* ring = smem_raw;   // slot: q [step][n], dy [step][p]
  float* w = reinterpret_cast<float*>(ring + kStagesD * kSlot);   // exp(l)
  const int64_t unit = blockIdx.x;   // (b * H + h) * nc + c
  const int c = (int)(unit % nc);
  if (c == 0) return;   // the gradient of the state before chunk 0
  const int b = (int)(unit / nc / H), h = (int)(unit / nc % H);
  const int p0 = blockIdx.y * kT, n0 = blockIdx.z * kT;
  const int t0 = c * Q;
  const float* l = lc + unit * Q;
  const bf16* qb = q + b * q_sb + h * q_sh + n0 + t0 * q_ss;
  const int64_t d_tok = (int64_t)H * Pd;
  const bf16* db = dy + ((int64_t)b * S + t0) * d_tok + (int64_t)h * Pd + p0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int len = min(Q, S - t0);   // steps of this chunk in the sequence
  const int n_it = (len + kT - 1) / kT;
  const int q_pieces = (min(kT, N - n0) + 7) / 8;
  const int d_pieces = (min(kT, Pd - p0) + 7) / 8;

  auto issue = [&](int it) {   // step tile it's q and dy into its slot
    if (it >= n_it) return;
    bf16* qs = reinterpret_cast<bf16*>(ring + (it % kStagesD) * kSlot);
    const int rows = min(kT, len - it * kT);
    tile_async<kThreads>(qs, kBS, qb + (int64_t)it * kT * q_ss, q_ss, rows,
                         q_pieces, 8);
    tile_async<kThreads>(qs + kTileB, kBS, db + (int64_t)it * kT * d_tok,
                         d_tok, rows, d_pieces, 8);
  };
#pragma unroll
  for (int it = 0; it < kStagesD - 1; ++it) {
    issue(it);
    ich::cp_commit();
  }
  for (int i = threadIdx.x; i < n_it * kT; i += kThreads)
    w[i] = i < len ? expf(l[i]) : 0.0f;
  float acc[8][4];
  zero(acc);
  for (int it = 0; it < n_it; ++it) {
    ich::cp_wait<kStagesD - 2>();
    __syncthreads();   // tile it (and w) in; tile it - 1's readers done
    issue(it + kStagesD - 1);
    ich::cp_commit();
    const bf16* qs = reinterpret_cast<const bf16*>(ring +
                                                   (it % kStagesD) * kSlot);
    const bf16* ds = qs + kTileB;
    const float* wt = w + it * kT;
    float pv[8][4];
    zero(pv);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t a[4], hi[4], lo[4];
      ich::load_at(a, qs, kBS, 16 * kk, 16 * warp, lane);
      const int k = 16 * kk + 2 * tig;
      const float w0 = wt[k], w1 = wt[k + 1], w8 = wt[k + 8], w9 = wt[k + 9];
#pragma unroll
      for (int r = 0; r < 4; ++r) {   // a0, a1: steps k, k + 1; a2, a3: + 8
        const float2 x = ich::unpack_bf16(a[r]);
        ich::split_bf16(__fmul_rn(x.x, r < 2 ? w0 : w8),
                        __fmul_rn(x.y, r < 2 ? w1 : w9), &hi[r], &lo[r]);
      }
      uint32_t bf[8][2];
#pragma unroll
      for (int m = 0; m < 4; ++m)
        ich::load_bt(bf + 2 * m, ds, kBS, 16 * kk, 16 * m, lane);
      mma_split<8>(pv, hi, lo, bf);
    }
    add_rn(acc, pv);
  }
  float* out = g + unit * N * Pd;
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

// Dynamic shared memory of ssd_bwd_kernel_dstates_bf16
constexpr int dstates_bf16_smem() {
  return kStagesD * kSlot + (int)sizeof(float) * kMaxChunk;
}

// Bytes of a bfloat16 pair kernel's ring slot: two bfloat16 tiles or a
// float32 state tile, and with a streamed (not resident) a its 64 x 64
// slice beside them
__host__ __device__ constexpr int pair_slot(bool resident) {
  return resident ? kSlot : kSlot + 2 * kTileB;
}

// Dynamic shared memory of a bfloat16 pair kernel (reduction width K,
// chunk Q) with the row tile's a resident or streamed
constexpr int pair_bf16_smem(int K, int Q, bool wide, bool resident) {
  return (resident ? 2 * kT * res_stride(K) : 0) +
         (wide ? kStagesW : kStagesN) * pair_slot(resident) +
         2 * (int)sizeof(float) * kMaxChunk +
         (wide ? 2 * 2 * kT * strip_stride(Q) + (int)sizeof(float) * kT : 0);
}

// a stays resident where all of K fits a CTA beside the ring (and strip):
// K <= 672, or <= 1,360 in the narrow kernel; wider, its 64-wide slices
// come through the ring with the tiles they multiply
constexpr bool a_resident(int K, int Q, bool wide) {
  return pair_bf16_smem(K, Q, wide, true) <= kMaxSmem;
}

// 4 (bfloat16). One gradient for one (b, h, chunk, 64-row tile), kAnti and
// kInterRow as in ssd_bwd_kernel_pair. kRes: a resident (else streamed,
// see a_resident). kWide (X > 64): 8 warps, warp w
// rows 16 (w % 4).., columns 32 (w / 4).. of each 64-column tile, the
// scores through the strip; else 4 warps of 16 rows and all 64 columns,
// the scores in registers. The ring's steps, in order: for each key tile,
// the K slices of b (narrow: c with the last); then (wide) for each
// column tile its key tiles' c and the K slices of M, or (narrow) the K
// slices of M. Grid (n_tiles * B * H * nc), heaviest row tiles first.
template <typename TO, bool kAnti, bool kInterRow, bool kWide, bool kRes>
__global__ void __launch_bounds__(kWide ? kWideThreads : kThreads,
                                  kWide ? 1 : 3)
    ssd_bwd_kernel_pair_bf16(const Pair<bf16, TO> p) {
  constexpr int NT = kWide ? kWideThreads : kThreads;
  constexpr int NN = kWide ? 4 : 8;   // n8 tiles of a warp's columns
  constexpr int kStg = kWide ? kStagesW : kStagesN;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int as = kRes ? res_stride(p.K) : kBS;   // a's row in shared memory
  constexpr int sb = pair_slot(kRes);
  bf16* As = reinterpret_cast<bf16*>(smem_raw);   // [64][as]: a, resident
  unsigned char* ring = smem_raw + (kRes ? 2 * kT * as : 0);   // kStg slots
  float* l = reinterpret_cast<float*>(ring + kStg * sb);   // this chunk
  float* cf = l + kMaxChunk;   // each key's decay factor to its tile's edge
  const int ps = strip_stride(p.Q);
  bf16* Ph = reinterpret_cast<bf16*>(cf + kMaxChunk);   // strip [row][key]
  bf16* Pl = Ph + kT * ps;
  float* red = reinterpret_cast<float*>(Pl + kT * ps);   // [64] row dots

  const int n_tiles = (p.Q + kT - 1) / kT;
  const int64_t units = (int64_t)gridDim.x / n_tiles;
  const int order = (int)(blockIdx.x / units);
  const int rt = kAnti ? order : n_tiles - 1 - order;
  const int64_t unit = blockIdx.x % units;   // (b * H + h) * nc + c
  const int c = (int)(unit % p.nc);
  const int b = (int)(unit / p.nc / p.H), h = (int)(unit / p.nc % p.H);
  const int t0 = c * p.Q, i0 = rt * kT;
  const int len = min(p.Q, p.S - t0);
  if (i0 >= len) return;   // a row tile past the end of the sequence
  const int n_kt = (len + kT - 1) / kT;
  const int first = kAnti ? rt : 0, last = kAnti ? n_kt - 1 : rt;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int wr = warp & 3, r0 = 16 * wr;     // this warp's rows
  const int c0 = kWide ? 32 * (warp >> 2) : 0;   // its first column
  const int rows_i = min(kT, len - i0);
  const int ks = (p.K + kT - 1) / kT;   // slices of the reduction
  const int nkt = last - first + 1;
  const bool inter = kAnti ? c < p.nc - 1 : c > 0;   // M != 0
  const int n_inter = inter ? ks : 0;
  const int n_score = nkt * ks;
  const int per_x = nkt + n_inter;   // wide: steps of a column tile
  const int n_steps =
      n_score + (kWide ? (p.X + kT - 1) / kT * per_x : n_inter);

  const bf16* ab =
      p.a.p + b * p.a.sb + h * p.a.sh + (int64_t)(t0 + i0) * p.a.ss;
  const bf16* bb = p.b.p + b * p.b.sb + h * p.b.sh + (int64_t)t0 * p.b.ss;
  const bf16* cb = p.c.p + b * p.c.sb + h * p.c.sh + (int64_t)t0 * p.c.ss;
  const float* mb = p.m + unit * (int64_t)p.N * p.Pd;
  auto slot = [&](int st) { return ring + (st % kStg) * sb; };
  // a's rows for step st's slice of K (its first column ka): resident, or
  // streamed into the slot's tail with the slice's b or M
  auto a_at = [&](int st) -> const bf16* {
    return kRes ? As : reinterpret_cast<const bf16*>(slot(st) + kSlot);
  };
  auto a_slice = [&](int st, int k0) {   // queue the streamed slice k0..
    if (!kRes)
      tile_async<NT>(reinterpret_cast<bf16*>(slot(st) + kSlot), kBS,
                     ab + k0, p.a.ss, rows_i, (min(kT, p.K - k0) + 7) / 8,
                     8);
  };

  auto issue = [&](int st) {   // queue step st's tiles into its slot
    if (st >= n_steps) return;
    bf16* t0s = reinterpret_cast<bf16*>(slot(st));
    if (st < n_score) {   // a slice of b (and c)
      const int j0 = (first + st / ks) * kT, k0 = st % ks * kT;
      const int rows_t = min(kT, len - j0);
      tile_async<NT>(t0s, kBS, bb + (int64_t)j0 * p.b.ss + k0, p.b.ss,
                     rows_t, (min(kT, p.K - k0) + 7) / 8, 8);
      a_slice(st, k0);
      if (!kWide && k0 + kT >= p.K)
        tile_async<NT>(t0s + kTileB, kBS, cb + (int64_t)j0 * p.c.ss, p.c.ss,
                       rows_t, (p.X + 7) / 8, 8);
      return;
    }
    int u = st - n_score, x0 = 0;
    if (kWide) {
      x0 = u / per_x * kT;
      u %= per_x;
      if (u < nkt) {   // c of key tile first + u, columns x0..
        const int j0 = (first + u) * kT;
        tile_async<NT>(t0s, kBS, cb + (int64_t)j0 * p.c.ss + x0, p.c.ss,
                       min(kT, len - j0), (min(kT, p.X - x0) + 7) / 8, 8);
        return;
      }
      u -= nkt;
    }
    // slice u of the chunk state (K rows u * 64..) for columns x0..
    const int k0 = u * kT, kc = min(kT, p.K - k0), xc = min(kT, p.X - x0);
    float* ms = reinterpret_cast<float*>(t0s);
    a_slice(st, k0);
    if (kInterRow)
      ftile_async<NT>(ms, kMRow, mb + (int64_t)x0 * p.Pd + k0, p.Pd, xc, kc);
    else
      ftile_async<NT>(ms, kMCol, mb + (int64_t)k0 * p.Pd + x0, p.Pd, kc, xc);
  };
  auto next = [&](int st) {   // step st's slot in; queue step st + kStg - 1
    ich::cp_wait<kStg - 2>();
    __syncthreads();   // and every thread is done with step st - 1's slot
    issue(st + kStg - 1);
    ich::cp_commit();
  };

  for (int i = tid; i < p.Q; i += NT)
    ich::cp4(l + i, p.lc + unit * p.Q + i, true);
  if (kRes)
    tile_async<NT>(As, as, ab, p.a.ss, rows_i, (p.K + 7) / 8, (as - 8) / 8);
#pragma unroll
  for (int st = 0; st < kStg - 1; ++st) {
    issue(st);
    ich::cp_commit();
  }
  next(0);
  const float total = l[p.Q - 1];
  float li[2], om[2];   // l and omega of this thread's two rows
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = i0 + r0 + gid + 8 * r;
    li[r] = i < p.Q ? l[i] : 0.0f;
    om[r] = kAnti ? decay(total - li[r]) : expf(li[r]);
  }
  // Off the diagonal a pair's decay factors through its key tile's edge
  // m_t, the l nearest the row tile (l falls along the chunk): for keys
  // j <= i, m_t = l at the tile's last key, exp(l_i - l_j) = exp(l_i - m_t)
  // exp(m_t - l_j); for keys j >= i, m_t = l at its first, exp(l_j - l_i)
  // = exp(l_j - m_t) exp(m_t - l_i). Both factors are <= 1: cf holds each
  // key's, a thread computes its rows' once a key tile.
  auto edge = [&](int t) {
    return l[kAnti ? t * kT : min(t * kT + kT - 1, p.Q - 1)];
  };
  for (int j = tid; j < p.Q; j += NT) {
    const float m = edge(j / kT);
    cf[j] = __expf(kAnti ? l[j] - m : m - l[j]);
  }
  __syncthreads();

  // the scores of each key tile: sigma (a_r . b_t), masked
  float acc[NN][4];
  zero_n<NN>(acc);
  int st = 0;
  for (int t = first; t <= last; ++t) {
    float s[NN][4];
    for (int j = 0; j < ks; ++j, ++st) {
      if (st > 0) next(st);
      float sp[NN][4];
      zero_n<NN>(sp);
      mma_ab<NN>(sp, a_at(st), as, r0, kRes ? j * kT : 0,
                 reinterpret_cast<const bf16*>(slot(st)), c0,
                 (min(kT, p.K - j * kT) + 15) / 16, lane);
      if (j == 0) {
#pragma unroll
        for (int n = 0; n < NN; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[n][e] = sp[n][e];
      } else {
        add_rn_n<NN>(s, sp);
      }
    }
    if (t == rt) {
      decay_mask<NN, kAnti>(s, l, li, i0 + r0 + gid, t * kT + c0 + 2 * tig,
                            len);
    } else {
      const float m = edge(t);
      const float rf[2] = {__expf(kAnti ? m - li[0] : li[0] - m),
                           __expf(kAnti ? m - li[1] : li[1] - m)};
      decay_factored<NN>(s, cf, rf, i0 + r0 + gid, t * kT + c0 + 2 * tig,
                         len);
    }
    if (kWide) {   // into the strip, split once
#pragma unroll
      for (int n = 0; n < NN; ++n)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int at = (r0 + gid + 8 * hh) * ps + (t - first) * kT + c0 +
                         8 * n + 2 * tig;
          uint32_t hi, lo;
          ich::split_bf16(s[n][2 * hh], s[n][2 * hh + 1], &hi, &lo);
          *reinterpret_cast<uint32_t*>(Ph + at) = hi;
          *reinterpret_cast<uint32_t*>(Pl + at) = lo;
        }
    } else {   // straight into the product with c (in the last slot),
               // over the 16-key steps this warp's causal mask leaves
      const bool diag = t == rt;
      float pv[NN][4];
      zero_n<NN>(pv);
      mma_pc_regs<NN>(pv, s,
                      reinterpret_cast<const bf16*>(slot(st - 1)) + kTileB,
                      0, diag && kAnti ? wr : 0,
                      diag && !kAnti ? wr + 1 : 4, lane);
      add_rn_n<NN>(acc, pv);
    }
  }

  float dsum[2] = {0.0f, 0.0f};   // the row dot, in column order
  // columns x0.. of the output: acc + omega a . M (when M != 0), stored
  auto finish = [&](int x0) {
    float in[NN][4];
    zero_n<NN>(in);
    for (int j = 0; j < n_inter; ++j, ++st) {
      next(st);
      float ip[NN][4];
      zero_n<NN>(ip);
      mma_am<NN, kInterRow>(ip, a_at(st), as, r0, kRes ? j * kT : 0,
                            reinterpret_cast<const float*>(slot(st)), c0,
                            (min(kT, p.K - j * kT) + 15) / 16, lane);
      add_rn_n<NN>(in, ip);
    }
    const int xcols = min(kT, p.X - x0);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = i0 + r0 + gid + (e >> 1) * 8;
      if (i >= len) continue;
      const int64_t tok = t0 + i;
      TO* orow = p.out + b * p.o_sb + h * p.o_sh + tok * p.o_ss + x0;
      const bf16* drow = p.d.p == nullptr ? nullptr
                                          : p.d.p + b * p.d.sb +
                                                h * p.d.sh + tok * p.d.ss +
                                                x0;
#pragma unroll
      for (int n = 0; n < NN; ++n) {
        const int x = c0 + n * 8 + 2 * tig + (e & 1);
        if (x >= xcols) continue;
        const float o =
            __fadd_rn(acc[n][e], __fmul_rn(in[n][e], om[e >> 1]));
        store(orow + x, o);
        if (drow != nullptr)
          dsum[e >> 1] =
                __fmaf_rn(o, __bfloat162float(drow[x]), dsum[e >> 1]);
      }
    }
  };
  if (kWide) {   // each column tile: the strip times its key tiles' c
    for (int x0 = 0; x0 < p.X; x0 += kT) {
      zero_n<NN>(acc);
      for (int t = first; t <= last; ++t, ++st) {
        next(st);
        const bool diag = t == rt;
        float pv[NN][4];
        zero_n<NN>(pv);
        mma_pc_strip<NN>(pv, Ph, Pl, ps, r0, (t - first) * kT,
                         reinterpret_cast<const bf16*>(slot(st)), c0,
                         diag && kAnti ? wr : 0,
                         diag && !kAnti ? wr + 1 : 4, lane);
        add_rn_n<NN>(acc, pv);
      }
      finish(x0);
    }
  } else {
    finish(0);
  }
  if (p.dot == nullptr) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {   // the four lanes of a row, pairwise
    dsum[r] = __fadd_rn(dsum[r], __shfl_xor_sync(0xffffffffu, dsum[r], 1));
    dsum[r] = __fadd_rn(dsum[r], __shfl_xor_sync(0xffffffffu, dsum[r], 2));
  }
  if (kWide) {   // then the second column half's, through shared memory
    if (warp >= 4 && tig == 0) {
      red[r0 + gid] = dsum[0];
      red[r0 + gid + 8] = dsum[1];
    }
    __syncthreads();
    dsum[0] = __fadd_rn(dsum[0], red[r0 + gid]);
    dsum[1] = __fadd_rn(dsum[1], red[r0 + gid + 8]);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = i0 + r0 + gid + 8 * r;
    if (warp < 4 && tig == 0 && i < len)
      p.dot[((int64_t)b * p.S + t0 + i) * p.H + h] = dsum[r];
  }
}

int launched() { return (int)cudaGetLastError(); }

// Raise a kernel's dynamic shared-memory limit to all a CTA can have, once
// per device.
template <auto Kernel>
int allow_smem() {
  constexpr int kMaxDevices = 64;
  static bool done[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < kMaxDevices && done[dev]) return 0;
  e = cudaFuncSetAttribute(Kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kMaxSmem);
  if (e == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return (int)e;
}

// Where a call's kernels go: launched on `s`; or, with `occ`, not launched
// but described, kOccInts ints a kernel at its slot (KernelSlot order):
// registers a thread, shared memory a CTA (static and dynamic, bytes),
// threads a CTA, CTAs an SM on this device, local memory a thread (bytes).
struct Run {
  cudaStream_t s;
  int* occ;
};
constexpr int kOccInts = 5;
enum KernelSlot { kDstates, kPass, kGdot, kPairDq, kPairDk, kPairDv, kDl,
                  kHeadsum, kSlots };

template <auto Kernel, typename... Args>
int run(const Run& r, int slot, dim3 grid, int threads, int smem,
        Args... args) {
  if (smem > 48 * 1024) {
    const int e = allow_smem<Kernel>();
    if (e != 0) return e;
  }
  if (r.occ != nullptr) {
    cudaFuncAttributes fa;
    cudaError_t e = cudaFuncGetAttributes(&fa, Kernel);
    int ctas = 0;
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, Kernel,
                                                        threads, smem);
    int* o = r.occ + kOccInts * slot;
    o[0] = fa.numRegs;
    o[1] = (int)fa.sharedSizeBytes + smem;
    o[2] = threads;
    o[3] = ctas;
    o[4] = (int)fa.localSizeBytes;
    return (int)e;
  }
  Kernel<<<grid, threads, smem, r.s>>>(args...);
  return launched();
}

// A bfloat16 pair kernel, wide when the output has more than one
// 64-column tile, its a resident or streamed (kRes)
template <typename TO, bool kAnti, bool kInterRow, bool kRes>
int launch_pair_bf16(const Run& r, int slot, const Pair<bf16, TO>& p,
                     unsigned ctas) {
  if (p.X > kT)
    return run<ssd_bwd_kernel_pair_bf16<TO, kAnti, kInterRow, true, kRes>>(
        r, slot, ctas, kWideThreads, pair_bf16_smem(p.K, p.Q, true, kRes),
        p);
  return run<ssd_bwd_kernel_pair_bf16<TO, kAnti, kInterRow, false, kRes>>(
      r, slot, ctas, kThreads, pair_bf16_smem(p.K, p.Q, false, kRes), p);
}

// One pair kernel (slot `slot`): float32 inputs on the 3xTF32 kernel;
// bfloat16 on the bfloat16 kernel. Only dq's and dk's a (K = Pd) can be
// too wide to stay resident: dv's K = N <= 512 always fits.
static_assert(a_resident(kNMax, kMaxChunk, true) &&
              a_resident(kNMax, kMaxChunk, false));
template <typename T, typename TO, bool kAnti, bool kInterRow>
int launch_pair(const Run& r, int slot, const Pair<T, TO>& p,
                int64_t units) {
  const unsigned ctas = (unsigned)(units * ((p.Q + kT - 1) / kT));
  if constexpr (std::is_same_v<T, float>) {
    return run<ssd_bwd_kernel_pair<TO, kAnti, kInterRow>>(
        r, slot, ctas, kThreads, pair_smem_bytes(p.Q), p);
  } else {
    if constexpr (kInterRow)
      if (!a_resident(p.K, p.Q, p.X > kT))
        return launch_pair_bf16<TO, kAnti, kInterRow, false>(r, slot, p,
                                                             ctas);
    return launch_pair_bf16<TO, kAnti, kInterRow, true>(r, slot, p, ctas);
  }
}

// A pair kernel's operands but a, b, c, d, M, the output and the row dot.
template <typename T, typename TO>
Pair<T, TO> pair_shape(const float* lc, int S, int H, int N, int Pd, int Q,
                       int nc, int K, int X) {
  Pair<T, TO> p{};
  p.lc = lc;
  p.S = S;
  p.H = H;
  p.N = N;
  p.Pd = Pd;
  p.Q = Q;
  p.nc = nc;
  p.K = K;
  p.X = X;
  return p;
}

// dq and dk (kernel 4 twice) into `TO` outputs: the gradients' own type,
// or float32 per-head partials (q and k shared) that kernel 6 sums.
template <typename T, typename TO>
int launch_dq_dk(const Run& r, Side<T> q, Side<T> k, Side<T> v, Side<T> dy,
                 const float* st, const float* g, const float* lc, TO* dq,
                 TO* dk, float* qdq, float* kdk, int B, int S, int H, int N,
                 int Pd, int Q, int nc) {
  const int64_t units = (int64_t)B * H * nc;
  Pair<T, TO> p = pair_shape<T, TO>(lc, S, H, N, Pd, Q, nc, Pd, N);
  p.o_sb = (int64_t)S * H * N;   // (B, S, H, N) contiguous
  p.o_ss = (int64_t)H * N;
  p.o_sh = N;
  // dq: rows i, keys j <= i: (dy_i . v_j) k_j and exp(l_i) S_{c-1} dy_i
  p.a = dy;
  p.b = v;
  p.c = k;
  p.d = q;
  p.m = st;
  p.out = dq;
  p.dot = qdq;
  int err = launch_pair<T, TO, false, true>(r, kPairDq, p, units);
  if (err != 0) return err;
  // dk: rows j, keys i >= j: (v_j . dy_i) q_i and w_j G_c v_j
  p.a = v;
  p.b = dy;
  p.c = q;
  p.d = k;
  p.m = g;
  p.out = dk;
  p.dot = kdk;
  return launch_pair<T, TO, true, true>(r, kPairDk, p, units);
}

// The bfloat16 path's limits: widths of whole 16-byte pieces, rows at
// 16-byte-aligned starts
template <typename T>
int bf16_takes(const T* q, const T* k, const T* v, const T* dy,
               const float* st, const float* g, int N, int Pd,
               int64_t q_sb, int64_t q_ss, int64_t q_sh, int64_t k_sb,
               int64_t k_ss, int64_t k_sh) {
  auto a16 = [](const void* ptr) { return ((uintptr_t)ptr & 15) == 0; };
  if (N % 8 || Pd % 8 || q_sb % 8 || q_ss % 8 || q_sh % 8 || k_sb % 8 ||
      k_ss % 8 || k_sh % 8 || !a16(q) || !a16(k) || !a16(v) || !a16(dy) ||
      !a16(st) || !a16(g))
    return (int)cudaErrorInvalidValue;
  return 0;
}

template <typename T>
int launch(const Run& r, const T* q, const T* k, const T* v, const T* dy,
           const float* st, const float* lc, T* dq, T* dk, T* dv, float* dla,
           float* g, float* qdq, float* kdk, float* gs, float* part_q,
           float* part_k, int B, int S, int H, int N, int Pd, int Q,
           int shared, int64_t q_sb, int64_t q_ss, int64_t q_sh,
           int64_t k_sb, int64_t k_ss, int64_t k_sh) {
  constexpr bool kBf16 = std::is_same_v<T, bf16>;
  const int nc = (S + Q - 1) / Q;
  const int n_tiles = (Q + kT - 1) / kT;
  const int p_tiles = (Pd + kT - 1) / kT;
  const int n_slices = (N + kT - 1) / kT;
  const int64_t units = (int64_t)B * H * nc;
  const int64_t elems = (int64_t)B * H * N * Pd;
  if (units * n_tiles > INT32_MAX || units > INT32_MAX || nc > 65535 ||
      p_tiles > 65535 || n_slices > 65535 || elems / 256 + 1 > INT32_MAX)
    return (int)cudaErrorInvalidConfiguration;
  if (shared) q_sh = k_sh = 0;
  int err = 0;
  if constexpr (kBf16) {
    err = bf16_takes(q, k, v, dy, st, g, N, Pd, q_sb, q_ss, q_sh, k_sb,
                     k_ss, k_sh);
    if (err != 0) return err;
  }
  const dim3 ds_grid((unsigned)units, p_tiles, n_slices);
  if constexpr (kBf16)
    err = run<ssd_bwd_kernel_dstates_bf16>(
        r, kDstates, ds_grid, kThreads, dstates_bf16_smem(), q, dy, lc, g, S,
        H, N, Pd, Q, nc, q_sb, q_ss, q_sh);
  else
    err = run<ssd_bwd_kernel_dstates>(r, kDstates, ds_grid, kThreads, 0, q,
                                      dy, lc, g, S, H, N, Pd, Q, nc, q_sb,
                                      q_ss, q_sh);
  if (err != 0) return err;
  err = run<ssd_bwd_kernel_pass>(r, kPass, (unsigned)((elems + 255) / 256),
                                 256, 0, g, lc, (int64_t)B * H, N * Pd, Q,
                                 nc);
  if (err != 0) return err;
  err = run<ssd_bwd_kernel_gdot>(r, kGdot, (unsigned)units, kGdotThreads, 0,
                                 g, st, gs, N * Pd, nc);
  if (err != 0) return err;
  const int64_t v_sb = (int64_t)S * H * Pd, v_ss = (int64_t)H * Pd;
  const Side<T> sq{q, q_sb, q_ss, q_sh}, sk{k, k_sb, k_ss, k_sh};
  const Side<T> sv{v, v_sb, v_ss, Pd}, sdy{dy, v_sb, v_ss, Pd};
  err = shared ? launch_dq_dk<T, float>(r, sq, sk, sv, sdy, st, g, lc, part_q,
                                        part_k, qdq, kdk, B, S, H, N, Pd, Q,
                                        nc)
               : launch_dq_dk<T, T>(r, sq, sk, sv, sdy, st, g, lc, dq, dk,
                                    qdq, kdk, B, S, H, N, Pd, Q, nc);
  if (err != 0) return err;
  // dv: rows j, keys i >= j: (k_j . q_i) dy_i and w_j G_c^T k_j
  Pair<T, T> pv = pair_shape<T, T>(lc, S, H, N, Pd, Q, nc, N, Pd);
  pv.a = sk;
  pv.b = sq;
  pv.c = sdy;
  pv.d = Side<T>{nullptr, 0, 0, 0};
  pv.m = g;
  pv.out = dv;
  pv.o_sb = v_sb;
  pv.o_ss = v_ss;
  pv.o_sh = Pd;
  pv.dot = nullptr;
  err = launch_pair<T, T, true, false>(r, kPairDv, pv, units);
  if (err != 0) return err;
  const int warps = kThreads / 32;
  err = run<ssd_bwd_kernel_dl>(r, kDl, (unsigned)((units + warps - 1) / warps),
                               kThreads, 0, qdq, kdk, gs, dla, B, S, H, Q,
                               nc);
  if (err != 0 || !shared) return err;
  const int64_t rows = (int64_t)B * S;
  const unsigned blocks = (unsigned)((rows * N + 255) / 256);
  err = run<ssd_bwd_kernel_headsum<T>>(r, kHeadsum, blocks, 256, 0, part_q,
                                       dq, rows, H, N);
  if (err != 0) return err;
  return run<ssd_bwd_kernel_headsum<T>>(r, kHeadsum, blocks, 256, 0, part_k,
                                        dk, rows, H, N);
}

template <typename T>
int launch_typed(const Run& r, const void* q, const void* k, const void* v,
                 const void* dy, const float* st, const float* lc, void* dq,
                 void* dk, void* dv, float* dla, float* g, float* qdq,
                 float* kdk, float* gs, float* part_q, float* part_k, int B,
                 int S, int H, int N, int Pd, int chunk, int shared,
                 int64_t q_sb, int64_t q_ss, int64_t q_sh, int64_t k_sb,
                 int64_t k_ss, int64_t k_sh) {
  return launch<T>(r, (const T*)q, (const T*)k, (const T*)v, (const T*)dy,
                   st, lc, (T*)dq, (T*)dk, (T*)dv, dla, g, qdq, kdk, gs,
                   part_q, part_k, B, S, H, N, Pd, chunk, shared, q_sb, q_ss,
                   q_sh, k_sb, k_ss, k_sh);
}

}  // namespace

extern "C" {

// Launch the backward's kernels on `stream`. dtype 0 = float32, 1 =
// bfloat16 (q, k, v, dy and dq, dk, dv); st (B, H, nc, N, Pd), the state
// before each chunk, and lc (B, H, nc, chunk), l of each chunk, are the
// forward's (from a zero state), float32; dla (B, S, H) float32. q and k
// (B, S, H, N) at strides (b, s, h) in elements, unit over N; with
// `shared` they are one (B, S, N) for every head (their head strides are
// ignored) and dq, dk are (B, S, N); else dq, dk are (B, S, H, N)
// contiguous. v, dy, dv contiguous (B, S, H, Pd). 1 <= N <= 512, 1 <=
// chunk <= 256. Bfloat16 also needs N and Pd multiples of 8, q and k
// strides multiples of 8 and 16-byte-aligned q, k, v, dy, st and g (the
// wrapper pads to them).
// Scratch: g (B, H, nc, N, Pd), qdq and kdk (B, S, H), gs (B, H, nc), and
// with `shared` part_q, part_k (B, S, H, N), all float32. Returns a CUDA
// error code (0 = success).
int mamba_scan_bwd_launch(const void* q, const void* k, const void* v,
                          const void* dy, const float* st, const float* lc,
                          void* dq, void* dk, void* dv, float* dla, float* g,
                          float* qdq, float* kdk, float* gs, float* part_q,
                          float* part_k, int B, int S, int H, int N, int Pd,
                          int chunk, int shared, int64_t q_sb, int64_t q_ss,
                          int64_t q_sh, int64_t k_sb, int64_t k_ss,
                          int64_t k_sh, int dtype, void* stream) {
  if (N > kNMax || N < 1 || Pd < 1 || chunk < 1 || chunk > kMaxChunk ||
      (shared && (part_q == nullptr || part_k == nullptr)) ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const Run r{(cudaStream_t)stream, nullptr};
  return (dtype == 0 ? launch_typed<float> : launch_typed<bf16>)(
      r, q, k, v, dy, st, lc, dq, dk, dv, dla, g, qdq, kdk, gs, part_q,
      part_k, B, S, H, N, Pd, chunk, shared, q_sb, q_ss, q_sh, k_sb, k_ss,
      k_sh);
}

// What a call of mamba_scan_bwd_launch at these shapes (N and Pd as it
// would be given them) runs on the current device, kernel by kernel in the
// order dstates, pass, gdot, pair (dq), pair (dk), pair (dv), dl, head
// sum: five ints each at out + 5 * slot, as `Run` says; -1 for a kernel
// the call does not run (the head sum without `shared`). Returns a CUDA
// error code (0 = success).
int mamba_scan_bwd_occupancy(int B, int S, int H, int N, int Pd, int chunk,
                             int shared, int dtype, int* out) {
  for (int i = 0; i < kOccInts * kSlots; ++i) out[i] = -1;
  if (N > kNMax || N < 1 || Pd < 1 || chunk < 1 || chunk > kMaxChunk ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const Run r{nullptr, out};
  float none = 0.0f;   // pointers nothing reads: only the shapes count
  return (dtype == 0 ? launch_typed<float> : launch_typed<bf16>)(
      r, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
      nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, &none,
      &none, B, S, H, N, Pd, chunk, shared, 0, 0, 0, 0, 0, 0);
}

}  // extern "C"
