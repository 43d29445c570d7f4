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
// pairs, 2N for each pair's q.k (once per batch row when q and k are shared
// by the heads) and, per head, 2Pd for dy.v, 2N each for the pair terms of
// dq and dk, 2Pd for dv's, and 8 c N Pd for the four products with a
// chunk state (dq's, dk's and dv's terms and the adjoint state). At
// Zamba2-1.2B's training shape (B = 4, S = 2048, H = 64, N = Pd = 64,
// Q = 256, q and k shared) 51.8 GFLOP against 0.45 GB in float32 (0.24 GB
// with bfloat16 q, k, v, dy and gradients) of inputs (q, k, v, dy, the
// kept chunk states and l) and outputs: 3 x 51.8 GFLOP at 495 TFLOP/s =
// 0.314 ms, beside 0.134 ms for the bytes: bound by operations. At
// xlstm-350m's mLSTM shape (B = 4, S = 2048, H = 4, N = 512, Pd = 513, q
// and k per head) 90.4 GFLOP, 76 % of it the products with a chunk state,
// against 0.60 GB (0.37 GB): 0.548 ms.
//
// The design: the forward's chunk decomposition run backwards, parallel
// over (b, h, chunk); the only sequential part is step 2, an elementwise
// walk over the chunks. One call runs six kernels in turn (seven when q
// and k are shared) on the caller's stream, each reading only what the
// ones before it wrote:
//   1. ssd_bwd_kernel_dstates — each chunk's sum_i exp(l_i) q_i (x) dy_i,
//      64 rows of N by 64 columns of Pd a block (forward kernel 3 with q
//      for k and dy for v), into g (B, H, nc, N, Pd); chunk 0's is not
//      needed.
//   2. ssd_bwd_kernel_pass — one thread per state element walks the chunks
//      from the last down: g[c] <- G_c, G_{c-1} = exp(total_c) G_c + g[c].
//   3. ssd_bwd_kernel_gdot — <G_c, S_c> per (b, h, chunk) (S_c is the saved
//      state before chunk c + 1): one CTA, strided sums and a tree.
//   4. ssd_bwd_kernel_pair, three times: one kernel for the three gradients,
//      each of the form out_r = sum_t sigma_rt (a_r . b_t) c_t + omega_r
//      a_r . M over the chunk's rows r and keys t:
//        dq: a = dy, b = v, c = k, t <= r, M = S_{c-1}, omega = exp(l_r);
//        dk: a = v, b = dy, c = q, t >= r, M = G_c, omega = w_r;
//        dv: a = k, b = q, c = dy, t >= r, M = G_c^T, omega = w_r.
//      Per (b, h, chunk, 64-row tile), heaviest tiles first: the row tile's
//      strip of decayed, masked scores over the keys it meets (at most
//      64 x 256) is computed once into shared memory, then each 64-column
//      tile of the output walks the strip's key tiles and the chunk
//      state's slices. dq and dk also fold q_i . dq_i and k_i . dk_i per
//      row (float32, before any rounding to the output's type).
//   5. ssd_bwd_kernel_dl — dl and its reverse cumulative sum inside each
//      chunk, one warp per (b, h, chunk).
//   6. ssd_bwd_kernel_headsum (q and k shared by all heads) — dq and dk
//      summed over the heads' float32 partials in head order.
// Every product runs on the tensor cores as the forward's: mma.sync
// m16n8k8 TF32 in the 3xTF32 split (mma_tf32.cuh), score rows used as A
// fragments where they lie, sums over 64 keys or 64 of N or Pd from a zero
// fragment and then one rounded add into float32, so the tensor cores'
// truncating accumulation never runs over more than 64 terms. Tiles are
// staged by plain loads (float32 or bfloat16, converted in shared memory;
// any stride, so Pd = 513 needs no special path), each thread starting all
// of its loads before it stores any. Q <= 256. Fixed order everywhere and
// no atomics: the same inputs give the same bits, whatever the number of
// SMs; with q and k shared, dv and dlog_a are the bits of q and k given per
// head, and dq and dk the head-order sums of their per-head values.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tf32.cuh"

namespace {

constexpr int kT = 64;          // rows of a tile (64 rows, 64 columns)
constexpr int kNMax = 512;      // state rows taken
constexpr int kMaxChunk = 256;  // the longest chunk taken
constexpr int kThreads = 128;   // 4 warps, 16 tile rows each
constexpr int kRow = kT + 8;    // tiles read along the row (a, b, M^T)
constexpr int kCol = kT + 4;    // tiles read down a column (c, M, q, dy)
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
template <typename T>
__global__ void __launch_bounds__(kThreads)
    ssd_bwd_kernel_dstates(const T* __restrict__ q, const T* __restrict__ dy,
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
  const T* qb = q + b * q_sb + h * q_sh + n0;
  const int64_t d_tok = (int64_t)H * Pd;
  const T* db = dy + (int64_t)b * S * d_tok + (int64_t)h * Pd + p0;
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
// G_{c-1} = exp(total_c) G_c + g[c] (kernel 1's sum).
__global__ void ssd_bwd_kernel_pass(float* __restrict__ g,
                                    const float* __restrict__ lc,
                                    int64_t BH, int NP, int Q, int nc) {
  const int64_t e = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (e >= BH * NP) return;
  const int64_t bh = e / NP, np = e % NP;
  float G = 0.0f;
  for (int c = nc - 1; c >= 0; --c) {
    const int64_t u = bh * nc + c;
    const float d = c > 0 ? g[u * NP + np] : 0.0f;
    g[u * NP + np] = G;
    if (c > 0) G = __fadd_rn(__fmul_rn(G, expf(lc[u * Q + Q - 1])), d);
  }
}

// 3. gs[b, h, c] = <G_c, S_c>, S_c the state after chunk c = st[c + 1],
// the saved state before chunk c + 1 (0 for the last chunk: G = 0). One
// CTA of 256 threads per (b, h, c): strided sums, then a tree.
__global__ void __launch_bounds__(256)
    ssd_bwd_kernel_gdot(const float* __restrict__ g,
                        const float* __restrict__ st, float* __restrict__ gs,
                        int NP, int nc) {
  __shared__ float part[256];
  const int64_t unit = blockIdx.x;
  float s = 0.0f;
  if ((int)(unit % nc) + 1 < nc) {
    const float* a = g + unit * NP;
    const float* b = st + (unit + 1) * NP;
    for (int i = threadIdx.x; i < NP; i += 256) s = __fmaf_rn(a[i], b[i], s);
  }
  part[threadIdx.x] = s;
  __syncthreads();
  for (int o = 128; o > 0; o >>= 1) {
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
template <typename T, typename TO, bool kAnti, bool kInterRow>
__global__ void __launch_bounds__(kThreads)
    ssd_bwd_kernel_pair(const Pair<T, TO> p) {
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
  const T* ab = p.a.p + b * p.a.sb + h * p.a.sh + (int64_t)(t0 + i0) * p.a.ss;
  const T* bb = p.b.p + b * p.b.sb + h * p.b.sh + (int64_t)t0 * p.b.ss;
  const T* cb = p.c.p + b * p.c.sb + h * p.c.sh + (int64_t)t0 * p.c.ss;
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
      const T* drow = p.d.p == nullptr ? nullptr
                                        : p.d.p + b * p.d.sb + h * p.d.sh +
                                              tok * p.d.ss + x0;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int x = nt * 8 + 2 * tig + (e & 1);
        if (x >= xcols) continue;
        const float o =
            __fadd_rn(acc[nt][e], __fmul_rn(in[nt][e], om[e >> 1]));
        store(orow + x, o);
        if (drow != nullptr)
          dsum[e >> 1] = __fmaf_rn(o, to_f(drow[x]), dsum[e >> 1]);
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

int launched() { return (int)cudaGetLastError(); }

// Raise a kernel's dynamic shared-memory limit to `bytes` once per device
// (at the longest chunk, so one setting serves every call).
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

template <typename T, typename TO, bool kAnti, bool kInterRow>
int launch_pair(const Pair<T, TO>& p, int64_t units, cudaStream_t s) {
  int err = allow_smem<ssd_bwd_kernel_pair<T, TO, kAnti, kInterRow>>(
      pair_smem_bytes(kMaxChunk));
  if (err != 0) return err;
  const int n_tiles = (p.Q + kT - 1) / kT;
  ssd_bwd_kernel_pair<T, TO, kAnti, kInterRow>
      <<<(unsigned)(units * n_tiles), kThreads, pair_smem_bytes(p.Q), s>>>(p);
  return launched();
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
int launch_dq_dk(Side<T> q, Side<T> k, Side<T> v, Side<T> dy,
                 const float* st, const float* g, const float* lc, TO* dq,
                 TO* dk, float* qdq, float* kdk, int B, int S, int H, int N,
                 int Pd, int Q, int nc, cudaStream_t s) {
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
  int err = launch_pair<T, TO, false, true>(p, units, s);
  if (err != 0) return err;
  // dk: rows j, keys i >= j: (v_j . dy_i) q_i and w_j G_c v_j
  p.a = v;
  p.b = dy;
  p.c = q;
  p.d = k;
  p.m = g;
  p.out = dk;
  p.dot = kdk;
  return launch_pair<T, TO, true, true>(p, units, s);
}

template <typename T>
int launch(const T* q, const T* k, const T* v, const T* dy, const float* st,
           const float* lc, T* dq, T* dk, T* dv, float* dla, float* g,
           float* qdq, float* kdk, float* gs, float* part_q, float* part_k,
           int B, int S, int H, int N, int Pd, int Q, int shared,
           int64_t q_sb, int64_t q_ss, int64_t q_sh, int64_t k_sb,
           int64_t k_ss, int64_t k_sh, cudaStream_t s) {
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
  ssd_bwd_kernel_dstates<T><<<dim3((unsigned)units, p_tiles, n_slices),
                              kThreads, 0, s>>>(q, dy, lc, g, S, H, N, Pd, Q,
                                                nc, q_sb, q_ss, q_sh);
  int err = launched();
  if (err != 0) return err;
  ssd_bwd_kernel_pass<<<(unsigned)((elems + 255) / 256), 256, 0, s>>>(
      g, lc, (int64_t)B * H, N * Pd, Q, nc);
  if ((err = launched()) != 0) return err;
  ssd_bwd_kernel_gdot<<<(unsigned)units, 256, 0, s>>>(g, st, gs, N * Pd, nc);
  if ((err = launched()) != 0) return err;
  const int64_t v_sb = (int64_t)S * H * Pd, v_ss = (int64_t)H * Pd;
  const Side<T> sq{q, q_sb, q_ss, q_sh}, sk{k, k_sb, k_ss, k_sh};
  const Side<T> sv{v, v_sb, v_ss, Pd}, sdy{dy, v_sb, v_ss, Pd};
  err = shared ? launch_dq_dk<T, float>(sq, sk, sv, sdy, st, g, lc, part_q,
                                        part_k, qdq, kdk, B, S, H, N, Pd, Q,
                                        nc, s)
               : launch_dq_dk<T, T>(sq, sk, sv, sdy, st, g, lc, dq, dk, qdq,
                                    kdk, B, S, H, N, Pd, Q, nc, s);
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
  if ((err = launch_pair<T, T, true, false>(pv, units, s)) != 0) return err;
  const int warps = kThreads / 32;
  ssd_bwd_kernel_dl<<<(unsigned)((units + warps - 1) / warps), kThreads, 0,
                      s>>>(qdq, kdk, gs, dla, B, S, H, Q, nc);
  if ((err = launched()) != 0) return err;
  if (shared) {
    const int64_t rows = (int64_t)B * S;
    const unsigned blocks = (unsigned)((rows * N + 255) / 256);
    ssd_bwd_kernel_headsum<T><<<blocks, 256, 0, s>>>(part_q, dq, rows, H, N);
    if ((err = launched()) != 0) return err;
    ssd_bwd_kernel_headsum<T><<<blocks, 256, 0, s>>>(part_k, dk, rows, H, N);
    err = launched();
  }
  return err;
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
// chunk <= 256. Scratch: g (B, H, nc, N, Pd), qdq and kdk (B, S, H), gs
// (B, H, nc), and with `shared` part_q, part_k (B, S, H, N), all float32.
// Returns a CUDA error code (0 = success).
int mamba_scan_bwd_launch(const void* q, const void* k, const void* v,
                          const void* dy, const float* st, const float* lc,
                          void* dq, void* dk, void* dv, float* dla, float* g,
                          float* qdq, float* kdk, float* gs, float* part_q,
                          float* part_k, int B, int S, int H, int N, int Pd,
                          int chunk, int shared, int64_t q_sb, int64_t q_ss,
                          int64_t q_sh, int64_t k_sb, int64_t k_ss,
                          int64_t k_sh, int dtype, void* stream) {
  if (N > kNMax || N < 1 || Pd < 1 || chunk < 1 || chunk > kMaxChunk ||
      (shared && (part_q == nullptr || part_k == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>((const float*)q, (const float*)k, (const float*)v,
                         (const float*)dy, st, lc, (float*)dq, (float*)dk,
                         (float*)dv, dla, g, qdq, kdk, gs, part_q, part_k, B,
                         S, H, N, Pd, chunk, shared, q_sb, q_ss, q_sh, k_sb,
                         k_ss, k_sh, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
        (const __nv_bfloat16*)v, (const __nv_bfloat16*)dy, st, lc,
        (__nv_bfloat16*)dq, (__nv_bfloat16*)dk, (__nv_bfloat16*)dv, dla, g,
        qdq, kdk, gs, part_q, part_k, B, S, H, N, Pd, chunk, shared, q_sb,
        q_ss, q_sh, k_sb, k_ss, k_sh, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
