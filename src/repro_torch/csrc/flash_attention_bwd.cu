// Flash attention backward (FlashAttention-2's) for NVIDIA Hopper (sm_90a).
//
// Replaces XLA's automatic differentiation of the reference's attention in
// its training loss: src/repro/models/model.py:loss_fn differentiates
// src/repro/models/attention.py:blockwise_attention (:84, taken from 1,024
// tokens on) and full_attention (:151) under jax.checkpoint. The reference
// has no Pallas kernel and no custom_vjp there: this is the gradient of
// the port's forward kernel (flash_attention.cu), which replaces the
// Pallas flash kernel and the blockwise attention alike.
//
// What it computes. Given q (B,Sq,Hq,dh), k, v (B,Skv,Hkv,dh), the
// forward's output o (B,Sq,Hq,dh), the log-sum-exp lse (B,Hq,Sq) of each
// query row's scaled scores (the forward kernel writes it) and
// dO = dL/do, with scale = dh^-1/2 and KV head h / rep for query head h:
//   P_ij  = exp(q_i . k_j * scale - lse_i) on kept pairs, 0 elsewhere
//   D_i   = sum_d dO_id o_id
//   dV_j  = sum_i P_ij dO_i            (over the rep query heads too)
//   dP_ij = dO_i . v_j
//   dS_ij = P_ij (dP_ij - D_i)
//   dK_j  = scale * sum_i dS_ij q_i    (over the rep query heads too)
//   dQ_i  = scale * sum_j dS_ij k_j
// under the forward's masks from position 0 (training has no query
// offset): j < Skv; j <= i when causal; j > i - window when window > 0.
// dq, dk, dv are written in q's type (float32 or bfloat16).
//
// What bounds it. Operations: 10 * dh flops per kept (query, key) pair
// (S recomputed, dP, dV, dK, dQ). At qwen2-1.5b's training shape (B = 4,
// S = 2,048, Hq = 12, Hkv = 2, dh = 128, causal) that is 128.9 GFLOP
// against ~118 MB of bfloat16 inputs and outputs: 0.130 ms at the
// bfloat16 tensor-core rate (989 TFLOP/s), 0.035 ms for the bytes. The
// kernel is bound by operations.
//
// Three launches a call, no atomics, every sum in a fixed order, so two
// calls give the same bits:
//   (a) flash_bwd_dot_kernel: D, one warp a (b, i, h) row.
//   (b) dK and dV per (b, KV head, key block of 64): the CTA walks the rep
//       query heads of its group and, for each, the query blocks of 64
//       that keep any of its keys, so GQA's rep heads sum into one dK and
//       dV in registers.
//   (c) dQ per (b, query head, query block of 64), heaviest first, walking
//       the key blocks its rows keep.
// S and dP are recomputed in both (b) and (c): 14 dh flops a pair in all,
// not 10, the price of no atomics (atomic float adds into dQ would make
// the bits depend on the order of arrival; writing dS once in bfloat16
// would cost B Hq Sq Skv / 2 values of scratch, ~200 MB and ~0.12 ms of
// memory traffic at the training shape, against ~0.18 ms of recompute at
// the bfloat16 rate).
//
// Bfloat16 (training's type), on the tensor cores:
//   * All five products (S^T = K q^T and dP^T = V dO^T in (b), dV += P^T
//     dO, dK += dS^T q, S = q K^T and dP = dO V^T again in (c), dQ += dS
//     K) run as mma.sync m16n8k16 bfloat16 with float32 accumulators
//     (mma_bf16.cuh), their operands bfloat16 tiles in shared memory read
//     by ldmatrix (.trans for dO and q as the B operand of dV and dK, and
//     for K as the B operand of dQ). Tiles have rows of dh + 8 values (no
//     bank conflicts) and come in by 16-byte cp.async.
//   * (b), flash_bwd_dkdv_bf16_kernel: 8 warps. Warp w owns keys
//     16 (w % 4) .. +15 of the key block and queries 32 (w / 4) .. +31 of
//     each query block: it computes S^T and dP^T with keys as M (16 x 32),
//     P^T and dS^T in registers, and their C fragments, rounded to
//     bfloat16, serve as the A fragments of the dV and dK products as they
//     stand (FlashAttention-2's register reuse; no trip through shared
//     memory). The query-block stream (q, dO, lse, D) is double-buffered:
//     the next block's copies are in flight while this one is multiplied.
//     At the end of a key block the warps of the second query half hand
//     their partial dK and dV to the first half through shared memory, one
//     fixed sum. Causal balance: CTA y of a (b, KV head) owns key blocks
//     y and nKB - 1 - y (y once when they coincide: an odd nKB), so under
//     the causal mask every CTA walks nQB + 1 query blocks a head: at the
//     training shape 8 x 16 = 128 CTAs of equal work, one wave on 132 SMs.
//     Whatever the masks (windows cut the walk from the other end), every
//     key block has exactly one owner.
//   * (c), flash_bwd_dq_bf16_kernel: 4 warps of 16 query rows; the q and
//     dO tiles stay in shared memory, the K/V blocks come through a
//     two-stage ring, dS stays in registers as the A fragment of dS K.
//     Two CTAs an SM.
//   * The one new rounding against float32 math: P and dS are rounded to
//     bfloat16 before the dV, dK and dQ products (2^-9 of each term).
//   * Shared memory at dh = 128: 105 KB for (b), 105 KB for (c).
//
// Float32 (the parity checks only): the same three kernels' float32
// versions on the CUDA cores, float32 FMAs from float32 tiles with odd row
// strides (dh + 1 and 65 floats): (b) one CTA of 256 threads a key block
// (4 keys x dh / 16 columns a thread), (c) one a query block; 166 KB and
// 149 KB of shared memory at dh = 128.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int kB = 64;          // rows of a query block and of a key block
constexpr int kThreads = 256;   // 16 x 16 threads, 4 x 4 of a 64 x 64 tile
constexpr int kPS = kB + 1;     // row stride of a 64 x 64 tile (floats)

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Shared memory of the two tile kernels, in floats: four (64 x dh) tiles
// with rows of dh + 1, n_sq (64 x 64) tiles with rows of 65, and 64 lse
// and 64 D values.
template <int DH>
constexpr int smem_floats(int n_sq) {
  return 4 * kB * (DH + 1) + n_sq * kB * kPS + 2 * kB;
}

// 64 rows of DH floats into a tile with rows of DH + 1: source row r at
// src + r * gs; rows r >= valid fill with zeros (unread).
template <int DH>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int64_t gs, int valid, int tid) {
#pragma unroll 4
  for (int e = tid; e < kB * DH; e += kThreads) {
    const int r = e / DH, c = e % DH;
    dst[r * (DH + 1) + c] = r < valid ? src[(int64_t)r * gs + c] : 0.0f;
  }
}

// 64 values of a (B, Hq, Sq) row into shared memory; zeros past Sq
__device__ __forceinline__ void load_row(float* dst, const float* src,
                                         int valid, int tid) {
  if (tid < kB) dst[tid] = tid < valid ? src[tid] : 0.0f;
}

__device__ __forceinline__ bool kept(int i, int j, int Sq, int Skv,
                                     int causal, int window) {
  bool keep = i < Sq && j < Skv;
  if (causal) keep = keep && j <= i;
  if (window > 0) keep = keep && j > i - window;
  return keep;
}

// (a) D[b, h, i] = sum_d dout[b, i, h, d] * out[b, i, h, d]: one warp a
// row of out's (B, Sq, Hq) rows, lanes over d, a xor-shuffle sum.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dot_kernel(const T* __restrict__ out,
                         const T* __restrict__ dout, float* __restrict__ D,
                         int64_t rows, int Sq, int Hq, int dh) {
  const int64_t row = (int64_t)blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const T* o = out + row * dh;
  const T* g = dout + row * dh;
  float s = 0.0f;
  for (int d = lane; d < dh; d += 32) s = fmaf(to_f(g[d]), to_f(o[d]), s);
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) s += __shfl_xor_sync(0xffffffffu, s, w);
  if (lane == 0) {
    const int h = (int)(row % Hq);
    const int64_t bi = row / Hq;   // b * Sq + i
    const int64_t b = bi / Sq, i = bi % Sq;
    D[(b * Hq + h) * Sq + i] = s;
  }
}

// (b) dK and dV of one (b, KV head, key block). Thread (ty, tx) = (tid /
// 16, tid % 16) owns keys ty + 16 a (a < 4) of the block: in the score
// tiles the queries tx + 16 c (c < 4), in dK and dV the columns tx + 16 c
// (c < dh / 16).
template <int DH>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkdv_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          const float* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ D, float* __restrict__ dk,
                          float* __restrict__ dv, int Sq, int Skv, int Hq,
                          int Hkv, int causal, int window, float scale) {
  constexpr int RS = DH + 1, DC = DH / 16;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + kB * RS;
  float* Qs = Vs + kB * RS;
  float* Os = Qs + kB * RS;   // dO
  float* Ps = Os + kB * RS;   // P^T (keys x queries)
  float* Ss = Ps + kB * kPS;  // dS^T
  float* Ls = Ss + kB * kPS;  // lse of the query block's rows
  float* Ds = Ls + kB;        // D of the query block's rows

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int b = blockIdx.x / Hkv, hk = blockIdx.x % Hkv;
  const int rep = Hq / Hkv;
  const int k0 = blockIdx.y * kB;
  const int64_t q_tok = (int64_t)Hq * DH, kv_tok = (int64_t)Hkv * DH;
  const int k_last = min(k0 + kB, Skv) - 1;
  // the queries that keep any key of this block: i >= k0 when causal,
  // i < k_last + window with a window
  const int q_begin = causal ? k0 : 0;
  const int q_end = window > 0 ? min(Sq, k_last + window) : Sq;

  const int64_t kv_base = (int64_t)b * Skv * kv_tok + (int64_t)hk * DH;
  load_tile<DH>(Ks, k + kv_base + k0 * kv_tok, kv_tok, Skv - k0, tid);
  load_tile<DH>(Vs, v + kv_base + k0 * kv_tok, kv_tok, Skv - k0, tid);

  float adk[4][DC], adv[4][DC];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < DC; ++c) adk[a][c] = adv[a][c] = 0.0f;

  for (int hr = 0; hr < rep; ++hr) {
    const int h = hk * rep + hr;
    const int64_t q_base = (int64_t)b * Sq * q_tok + (int64_t)h * DH;
    const int64_t l_base = ((int64_t)b * Hq + h) * Sq;
    for (int q0 = (q_begin / kB) * kB; q0 < q_end; q0 += kB) {
      __syncthreads();   // the last block's tiles are consumed
      load_tile<DH>(Qs, q + q_base + q0 * q_tok, q_tok, Sq - q0, tid);
      load_tile<DH>(Os, dout + q_base + q0 * q_tok, q_tok, Sq - q0, tid);
      load_row(Ls, lse + l_base + q0, Sq - q0, tid);
      load_row(Ds, D + l_base + q0, Sq - q0, tid);
      __syncthreads();

      // S^T = K q^T and dP^T = V dO^T for keys ty + 16 a, queries tx + 16 c
      float s[4][4], dp[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[a][c] = dp[a][c] = 0.0f;
#pragma unroll 4
      for (int d = 0; d < DH; ++d) {
        float kr[4], vr[4], qc[4], oc[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          kr[a] = Ks[(ty + 16 * a) * RS + d];
          vr[a] = Vs[(ty + 16 * a) * RS + d];
          qc[a] = Qs[(tx + 16 * a) * RS + d];
          oc[a] = Os[(tx + 16 * a) * RS + d];
        }
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            s[a][c] = fmaf(kr[a], qc[c], s[a][c]);
            dp[a][c] = fmaf(vr[a], oc[c], dp[a][c]);
          }
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int kj = k0 + ty + 16 * a, qr = tx + 16 * c;
          const float p = kept(q0 + qr, kj, Sq, Skv, causal, window)
                              ? expf(s[a][c] * scale - Ls[qr])
                              : 0.0f;
          Ps[(ty + 16 * a) * kPS + qr] = p;
          Ss[(ty + 16 * a) * kPS + qr] = p * (dp[a][c] - Ds[qr]);
        }
      __syncthreads();

      // dV += P^T dO and dK += dS^T q over the block's 64 queries
#pragma unroll 2
      for (int i = 0; i < kB; ++i) {
        float pr[4], sr[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          pr[a] = Ps[(ty + 16 * a) * kPS + i];
          sr[a] = Ss[(ty + 16 * a) * kPS + i];
        }
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          const float o = Os[i * RS + tx + 16 * c];
          const float qv = Qs[i * RS + tx + 16 * c];
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            adv[a][c] = fmaf(pr[a], o, adv[a][c]);
            adk[a][c] = fmaf(sr[a], qv, adk[a][c]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int kj = k0 + ty + 16 * a;
    if (kj >= Skv) continue;
    float* dkr = dk + kv_base + (int64_t)kj * kv_tok;
    float* dvr = dv + kv_base + (int64_t)kj * kv_tok;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      dkr[tx + 16 * c] = adk[a][c] * scale;
      dvr[tx + 16 * c] = adv[a][c];
    }
  }
}

// (c) dQ of one (b, query head, query block). Thread (ty, tx) owns query
// rows ty + 16 a of the block: in the score tiles the keys tx + 16 c
// (c < 4), in dQ the columns tx + 16 c (c < dh / 16).
template <int DH>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ D, float* __restrict__ dq,
                        int Sq, int Skv, int Hq, int Hkv, int causal,
                        int window, float scale) {
  constexpr int RS = DH + 1, DC = DH / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Os = Qs + kB * RS;   // dO
  float* Ks = Os + kB * RS;
  float* Vs = Ks + kB * RS;
  float* Ss = Vs + kB * RS;   // dS (queries x keys)
  float* Ls = Ss + kB * kPS;
  float* Ds = Ls + kB;

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int b = blockIdx.x / Hq, h = blockIdx.x % Hq;
  const int hk = h / (Hq / Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kB;   // heaviest first
  const int q_last = min(q0 + kB, Sq) - 1;
  const int kv_end = causal ? min(Skv, q_last + 1) : Skv;
  const int kv_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  const int64_t q_tok = (int64_t)Hq * DH, kv_tok = (int64_t)Hkv * DH;
  const int64_t q_base = (int64_t)b * Sq * q_tok + (int64_t)h * DH;
  const int64_t kv_base = (int64_t)b * Skv * kv_tok + (int64_t)hk * DH;
  const int64_t l_base = ((int64_t)b * Hq + h) * Sq;

  load_tile<DH>(Qs, q + q_base + q0 * q_tok, q_tok, Sq - q0, tid);
  load_tile<DH>(Os, dout + q_base + q0 * q_tok, q_tok, Sq - q0, tid);
  load_row(Ls, lse + l_base + q0, Sq - q0, tid);
  load_row(Ds, D + l_base + q0, Sq - q0, tid);

  float adq[4][DC];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < DC; ++c) adq[a][c] = 0.0f;

  for (int k0 = (kv_begin / kB) * kB; k0 < kv_end; k0 += kB) {
    __syncthreads();   // the last key block is consumed
    load_tile<DH>(Ks, k + kv_base + k0 * kv_tok, kv_tok, Skv - k0, tid);
    load_tile<DH>(Vs, v + kv_base + k0 * kv_tok, kv_tok, Skv - k0, tid);
    __syncthreads();

    // S = q K^T and dP = dO V^T for queries ty + 16 a, keys tx + 16 c
    float s[4][4], dp[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[a][c] = dp[a][c] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < DH; ++d) {
      float qr[4], orow[4], kc[4], vc[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        qr[a] = Qs[(ty + 16 * a) * RS + d];
        orow[a] = Os[(ty + 16 * a) * RS + d];
        kc[a] = Ks[(tx + 16 * a) * RS + d];
        vc[a] = Vs[(tx + 16 * a) * RS + d];
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          s[a][c] = fmaf(qr[a], kc[c], s[a][c]);
          dp[a][c] = fmaf(orow[a], vc[c], dp[a][c]);
        }
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int r = ty + 16 * a, kj = k0 + tx + 16 * c;
        const float p = kept(q0 + r, kj, Sq, Skv, causal, window)
                            ? expf(s[a][c] * scale - Ls[r])
                            : 0.0f;
        Ss[r * kPS + tx + 16 * c] = p * (dp[a][c] - Ds[r]);
      }
    __syncthreads();

    // dQ += dS K over the block's 64 keys
#pragma unroll 2
    for (int j = 0; j < kB; ++j) {
      float sr[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) sr[a] = Ss[(ty + 16 * a) * kPS + j];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const float kv = Ks[j * RS + tx + 16 * c];
#pragma unroll
        for (int a = 0; a < 4; ++a) adq[a][c] = fmaf(sr[a], kv, adq[a][c]);
      }
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = q0 + ty + 16 * a;
    if (i >= Sq) continue;
    float* dqr = dq + q_base + (int64_t)i * q_tok;
#pragma unroll
    for (int c = 0; c < DC; ++c) dqr[tx + 16 * c] = adq[a][c] * scale;
  }
}

// ---------------------------------------------------------------------------
// Bfloat16 on the tensor cores: (b) and (c) of the header.

using bf16 = __nv_bfloat16;

constexpr int kStages = 2;        // the double-buffered stream of each walk
constexpr int kWarpsKV = 8;       // (b): 4 key slices x 2 query halves
constexpr int kWarpsQ = 4;        // (c): 4 x 16 query rows
constexpr float kLog2e = 1.4426950408889634f;

// A 64-row bfloat16 tile with rows of DH + 8 values (mma_bf16.cuh)
template <int DH>
struct Tile {
  static constexpr int RS = DH + 8;
  static constexpr int elems = kB * RS;
  static constexpr int bytes = 2 * elems;
};

// (b): K, V, then kStages x (q, dO) tiles, then kStages x (64 lse, 64 D)
template <int DH>
constexpr int dkdv_bf16_bytes() {
  return (2 + 2 * kStages) * Tile<DH>::bytes + kStages * 2 * kB * 4;
}
// (c): q, dO, then kStages x (K, V) tiles, then 64 lse and 64 D
template <int DH>
constexpr int dq_bf16_bytes() {
  return (2 + 2 * kStages) * Tile<DH>::bytes + 2 * kB * 4;
}

__device__ __forceinline__ void cp16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                   ich::smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp4(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(
                   ich::smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// 64 rows of DH bfloat16 values by 16-byte cp.async, source row r at
// src + r * gs, into a Tile; rows r >= valid fill with zeros (unread).
template <int DH, int NT>
__device__ __forceinline__ void load_tile_async(bf16* dst, const bf16* src,
                                                int64_t gs, int valid,
                                                int tid) {
  constexpr int C = DH / 8;   // 16-byte copies a row
  static_assert((kB * C) % NT == 0, "whole copies a thread");
#pragma unroll
  for (int i = 0; i < kB * C / NT; ++i) {
    const int e = tid + i * NT;
    const int r = e / C, c = (e % C) * 8;
    const bool ok = r < valid;
    cp16(dst + r * Tile<DH>::RS + c, ok ? src + (int64_t)r * gs + c : src, ok);
  }
}

// 64 lse and 64 D values of a (B, Hq, Sq) row by 4-byte cp.async (rows
// start at any float); zeros past Sq. Threads 0..127.
__device__ __forceinline__ void load_rows_async(float* dst, const float* lse,
                                                const float* D, int valid,
                                                int tid) {
  if (tid < 2 * kB) {
    const int r = tid % kB;
    const float* src = tid < kB ? lse : D;
    const bool ok = r < valid;
    cp4(dst + tid, ok ? src + r : src, ok);
  }
}

__device__ __forceinline__ void store2(bf16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// (b) dK and dV of key blocks y and nKB - 1 - y of one (b, KV head).
// Warp w: keys 16 ks .. +15 (ks = w % 4) of the key block, queries
// 32 qh .. +31 (qh = w / 4) of each query block; thread (gid, tig) holds
// keys 16 ks + gid (+8), queries 32 qh + 8 n + 2 tig (+1) of the n8 tiles
// n < 4 of S^T and dP^T, and columns 8 n + 2 tig (+1) of the n8 tiles
// n < DH / 8 of its dK and dV.
template <int DH>
__global__ void __launch_bounds__(kWarpsKV * 32, 1)
    flash_bwd_dkdv_bf16_kernel(const bf16* __restrict__ q,
                               const bf16* __restrict__ k,
                               const bf16* __restrict__ v,
                               const bf16* __restrict__ dout,
                               const float* __restrict__ lse,
                               const float* __restrict__ D,
                               bf16* __restrict__ dk, bf16* __restrict__ dv,
                               int Sq, int Skv, int Hq, int Hkv, int causal,
                               int window, float scale) {
  constexpr int NT = kWarpsKV * 32, RS = Tile<DH>::RS, TE = Tile<DH>::elems;
  constexpr int DN = DH / 8;   // n8 tiles of dK and dV
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + TE;
  bf16* stages = Vs + TE;   // stage s: q at stages + 2 s TE, dO after it
  float* rows = reinterpret_cast<float*>(stages + 2 * kStages * TE);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int ks = warp & 3, qh = warp >> 2;
  const int b = blockIdx.x / Hkv, hk = blockIdx.x % Hkv;
  const int rep = Hq / Hkv;
  const int nKB = (Skv + kB - 1) / kB;
  const int64_t q_tok = (int64_t)Hq * DH, kv_tok = (int64_t)Hkv * DH;
  const int64_t kv_base = (int64_t)b * Skv * kv_tok + (int64_t)hk * DH;
  const float sl2 = scale * kLog2e;
  const int j_lo = blockIdx.y, j_hi = nKB - 1 - blockIdx.y;

  for (int pass = 0; pass < (j_hi > j_lo ? 2 : 1); ++pass) {
    const int k0 = (pass ? j_hi : j_lo) * kB;
    const int k_last = min(k0 + kB, Skv) - 1;
    // the query blocks that keep any key of this block: i >= k0 when
    // causal, i < k_last + window with a window
    const int qb0 = causal ? k0 / kB : 0;
    const int q_end = window > 0 ? min(Sq, k_last + window) : Sq;
    const int nq = max(0, (q_end + kB - 1) / kB - qb0);
    const int T = rep * nq;   // (head, query block) steps of the walk

    auto prefetch = [&](int t) {   // step t's q, dO, lse, D into its stage
      const int h = hk * rep + t / nq, q0 = (qb0 + t % nq) * kB;
      bf16* st = stages + (t % kStages) * 2 * TE;
      const int64_t qo = (int64_t)b * Sq * q_tok + (int64_t)h * DH +
                         q0 * q_tok;
      load_tile_async<DH, NT>(st, q + qo, q_tok, Sq - q0, tid);
      load_tile_async<DH, NT>(st + TE, dout + qo, q_tok, Sq - q0, tid);
      const int64_t lo = ((int64_t)b * Hq + h) * Sq + q0;
      load_rows_async(rows + (t % kStages) * 2 * kB, lse + lo, D + lo,
                      Sq - q0, tid);
    };

    float adk[DN][4], adv[DN][4];
#pragma unroll
    for (int n = 0; n < DN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) adk[n][e] = adv[n][e] = 0.0f;

    if (T > 0) {
      load_tile_async<DH, NT>(Ks, k + kv_base + k0 * kv_tok, kv_tok,
                              Skv - k0, tid);
      load_tile_async<DH, NT>(Vs, v + kv_base + k0 * kv_tok, kv_tok,
                              Skv - k0, tid);
      prefetch(0);
      cp_commit();
    }
    for (int t = 0; t < T; ++t) {
      if (t + 1 < T) {
        prefetch(t + 1);
        cp_commit();
        cp_wait<1>();
      } else {
        cp_wait<0>();
      }
      __syncthreads();
      const bf16* Qs = stages + (t % kStages) * 2 * TE;
      const bf16* Os = Qs + TE;
      const float* Ls = rows + (t % kStages) * 2 * kB;
      const float* Ds = Ls + kB;
      const int q0 = (qb0 + t % nq) * kB;

      // S^T = K q^T and dP^T = V dO^T: 16 keys x 32 queries a warp
      float s[4][4], dp[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        uint32_t ka[4], va[4];
        ich::load_a(ka, Ks, RS, 16 * ks, 16 * kk, lane);
        ich::load_a(va, Vs, RS, 16 * ks, 16 * kk, lane);
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          uint32_t qb[2][2], ob[2][2];
          ich::load_b(qb, Qs, RS, 32 * qh + 16 * p, 16 * kk, lane);
          ich::load_b(ob, Os, RS, 32 * qh + 16 * p, 16 * kk, lane);
          ich::mma_bf16(s[2 * p], ka, qb[0]);
          ich::mma_bf16(s[2 * p + 1], ka, qb[1]);
          ich::mma_bf16(dp[2 * p], va, ob[0]);
          ich::mma_bf16(dp[2 * p + 1], va, ob[1]);
        }
      }

      // P^T and dS^T in place of S^T and dP^T; masks only where the tile
      // crosses an edge
      const bool edge = (causal && q0 < k0 + kB - 1) ||
                        (window > 0 && q0 + kB - 1 - k0 >= window) ||
                        q0 + kB > Sq || k0 + kB > Skv;
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qr = 32 * qh + 8 * n + 2 * tig + (e & 1);
          const int kj = k0 + 16 * ks + gid + 8 * (e >> 1);
          float p = exp2f(s[n][e] * sl2 - Ls[qr] * kLog2e);
          if (edge && !kept(q0 + qr, kj, Sq, Skv, causal, window)) p = 0.0f;
          s[n][e] = p;
          dp[n][e] = p * (dp[n][e] - Ds[qr]);
        }
      uint32_t pa[2][4], sa[2][4];   // A fragments, k over 16 queries
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        ich::a_from_c(pa[kk], s[2 * kk], s[2 * kk + 1]);
        ich::a_from_c(sa[kk], dp[2 * kk], dp[2 * kk + 1]);
      }

      // dV += P^T dO and dK += dS^T q over the warp's 32 queries
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
#pragma unroll
        for (int np = 0; np < DN / 2; ++np) {
          uint32_t ob[2][2], qb[2][2];
          ich::load_bt(ob, Os, RS, 32 * qh + 16 * kk, 16 * np, lane);
          ich::load_bt(qb, Qs, RS, 32 * qh + 16 * kk, 16 * np, lane);
          ich::mma_bf16(adv[2 * np], pa[kk], ob[0]);
          ich::mma_bf16(adv[2 * np + 1], pa[kk], ob[1]);
          ich::mma_bf16(adk[2 * np], sa[kk], qb[0]);
          ich::mma_bf16(adk[2 * np + 1], sa[kk], qb[1]);
        }
      __syncthreads();   // this stage is consumed before step t + 2 fills it
    }

    // the second query half's partial sums to the first through the stage
    // area (free now: every copy has landed and been consumed), lane-major
    float* part = reinterpret_cast<float*>(stages);
    float* mine = part + ks * (2 * DN * 4 * 32);
    if (qh == 1) {
#pragma unroll
      for (int n = 0; n < DN; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          mine[(n * 4 + e) * 32 + lane] = adk[n][e];
          mine[((DN + n) * 4 + e) * 32 + lane] = adv[n][e];
        }
    }
    __syncthreads();
    if (qh == 0) {
#pragma unroll
      for (int n = 0; n < DN; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          adk[n][e] += mine[(n * 4 + e) * 32 + lane];
          adv[n][e] += mine[((DN + n) * 4 + e) * 32 + lane];
        }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int kj = k0 + 16 * ks + gid + 8 * half;
        if (kj >= Skv) continue;
        bf16* dkr = dk + kv_base + (int64_t)kj * kv_tok;
        bf16* dvr = dv + kv_base + (int64_t)kj * kv_tok;
#pragma unroll
        for (int n = 0; n < DN; ++n) {
          const int c = 8 * n + 2 * tig;
          store2(dkr + c, adk[n][2 * half] * scale,
                 adk[n][2 * half + 1] * scale);
          store2(dvr + c, adv[n][2 * half], adv[n][2 * half + 1]);
        }
      }
    }
    __syncthreads();   // the partials are read before the next pass loads
  }
}

// (c) dQ of one (b, query head, query block). Warp w: query rows
// 16 w .. +15; thread (gid, tig) holds rows 16 w + gid (+8), keys
// 8 n + 2 tig (+1) of the n8 tiles n < 8 of S and dP, and columns
// 8 n + 2 tig (+1) of the n8 tiles n < DH / 8 of dQ.
template <int DH>
__global__ void __launch_bounds__(kWarpsQ * 32, 2)
    flash_bwd_dq_bf16_kernel(const bf16* __restrict__ q,
                             const bf16* __restrict__ k,
                             const bf16* __restrict__ v,
                             const bf16* __restrict__ dout,
                             const float* __restrict__ lse,
                             const float* __restrict__ D,
                             bf16* __restrict__ dq, int Sq, int Skv, int Hq,
                             int Hkv, int causal, int window, float scale) {
  constexpr int NT = kWarpsQ * 32, RS = Tile<DH>::RS, TE = Tile<DH>::elems;
  constexpr int DN = DH / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Os = Qs + TE;
  bf16* ring = Os + TE;   // stage s: K at ring + 2 s TE, V after it
  float* rows = reinterpret_cast<float*>(ring + 2 * kStages * TE);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int b = blockIdx.x / Hq, h = blockIdx.x % Hq;
  const int hk = h / (Hq / Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kB;   // heaviest first
  const int q_last = min(q0 + kB, Sq) - 1;
  const int kv_end = causal ? min(Skv, q_last + 1) : Skv;
  const int kb0 = (window > 0 ? max(0, q0 - window + 1) : 0) / kB;
  const int T = max(0, (kv_end + kB - 1) / kB - kb0);
  const int64_t q_tok = (int64_t)Hq * DH, kv_tok = (int64_t)Hkv * DH;
  const int64_t q_base = (int64_t)b * Sq * q_tok + (int64_t)h * DH;
  const int64_t kv_base = (int64_t)b * Skv * kv_tok + (int64_t)hk * DH;
  const int64_t l_base = ((int64_t)b * Hq + h) * Sq + q0;
  const float sl2 = scale * kLog2e;

  auto prefetch = [&](int t) {   // key block kb0 + t into its stage
    const int k0 = (kb0 + t) * kB;
    bf16* st = ring + (t % kStages) * 2 * TE;
    load_tile_async<DH, NT>(st, k + kv_base + k0 * kv_tok, kv_tok, Skv - k0,
                            tid);
    load_tile_async<DH, NT>(st + TE, v + kv_base + k0 * kv_tok, kv_tok,
                            Skv - k0, tid);
  };

  load_tile_async<DH, NT>(Qs, q + q_base + q0 * q_tok, q_tok, Sq - q0, tid);
  load_tile_async<DH, NT>(Os, dout + q_base + q0 * q_tok, q_tok, Sq - q0,
                          tid);
  load_rows_async(rows, lse + l_base, D + l_base, Sq - q0, tid);
  if (T > 0) prefetch(0);
  cp_commit();

  float adq[DN][4];
#pragma unroll
  for (int n = 0; n < DN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) adq[n][e] = 0.0f;
  float l2[2], dd[2];   // lse * log2(e) and D of the thread's two rows

  for (int t = 0; t < T; ++t) {
    if (t + 1 < T) {
      prefetch(t + 1);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    if (t == 0) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = 16 * warp + gid + 8 * half;
        l2[half] = rows[r] * kLog2e;
        dd[half] = rows[kB + r];
      }
    }
    const bf16* Ks = ring + (t % kStages) * 2 * TE;
    const bf16* Vs = Ks + TE;
    const int k0 = (kb0 + t) * kB;

    // S = q K^T and dP = dO V^T: 16 queries x 64 keys a warp
    float s[8][4], dp[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      uint32_t qa[4], oa[4];
      ich::load_a(qa, Qs, RS, 16 * warp, 16 * kk, lane);
      ich::load_a(oa, Os, RS, 16 * warp, 16 * kk, lane);
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        uint32_t kb[2][2], vb[2][2];
        ich::load_b(kb, Ks, RS, 16 * p, 16 * kk, lane);
        ich::load_b(vb, Vs, RS, 16 * p, 16 * kk, lane);
        ich::mma_bf16(s[2 * p], qa, kb[0]);
        ich::mma_bf16(s[2 * p + 1], qa, kb[1]);
        ich::mma_bf16(dp[2 * p], oa, vb[0]);
        ich::mma_bf16(dp[2 * p + 1], oa, vb[1]);
      }
    }

    // dS in place of dP; masks only where the tile crosses an edge
    const bool edge = (causal && q0 < k0 + kB - 1) ||
                      (window > 0 && q0 + kB - 1 - k0 >= window) ||
                      q0 + kB > Sq || k0 + kB > Skv;
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int half = e >> 1;
        const int i = q0 + 16 * warp + gid + 8 * half;
        const int kj = k0 + 8 * n + 2 * tig + (e & 1);
        float p = exp2f(s[n][e] * sl2 - l2[half]);
        if (edge && !kept(i, kj, Sq, Skv, causal, window)) p = 0.0f;
        dp[n][e] = p * (dp[n][e] - dd[half]);
      }

    // dQ += dS K over the block's 64 keys
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t sa[4];
      ich::a_from_c(sa, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
      for (int np = 0; np < DN / 2; ++np) {
        uint32_t kb[2][2];
        ich::load_bt(kb, Ks, RS, 16 * kk, 16 * np, lane);
        ich::mma_bf16(adq[2 * np], sa, kb[0]);
        ich::mma_bf16(adq[2 * np + 1], sa, kb[1]);
      }
    }
    __syncthreads();   // this stage is consumed before step t + 2 fills it
  }
  if (T == 0) cp_wait<0>();

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int i = q0 + 16 * warp + gid + 8 * half;
    if (i >= Sq) continue;
    bf16* dqr = dq + q_base + (int64_t)i * q_tok;
#pragma unroll
    for (int n = 0; n < DN; ++n)
      store2(dqr + 8 * n + 2 * tig, adq[n][2 * half] * scale,
             adq[n][2 * half + 1] * scale);
  }
}

// Raise a kernel's dynamic shared-memory limit to `bytes` once per device
// (cudaFuncSetAttribute costs more than a small launch).
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

// (a) of either type: D into its (B, Hq, Sq) scratch
template <typename T>
int launch_dot(const void* out, const void* dout, float* D, int B, int Sq,
               int Hq, int dh, cudaStream_t stream) {
  const int64_t rows = (int64_t)B * Sq * Hq;
  const int blocks = (int)((rows + kThreads / 32 - 1) / (kThreads / 32));
  flash_bwd_dot_kernel<T><<<blocks, kThreads, 0, stream>>>(
      (const T*)out, (const T*)dout, D, rows, Sq, Hq, dh);
  return (int)cudaGetLastError();
}

// (b) and (c) in float32 on the CUDA cores
template <int DH>
int launch_f32(const float* q, const float* k, const float* v,
               const float* dout, const float* lse, const float* D,
               float* dq, float* dk, float* dv, int B, int Sq, int Skv,
               int Hq, int Hkv, int causal, int window, float scale,
               cudaStream_t stream) {
  const int dkdv_bytes = (int)sizeof(float) * smem_floats<DH>(2);
  int err = allow_smem<flash_bwd_dkdv_kernel<DH>>(dkdv_bytes);
  if (err != 0) return err;
  flash_bwd_dkdv_kernel<DH>
      <<<dim3(B * Hkv, (Skv + kB - 1) / kB), kThreads, dkdv_bytes, stream>>>(
          q, k, v, dout, lse, D, dk, dv, Sq, Skv, Hq, Hkv, causal, window,
          scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  const int dq_bytes = (int)sizeof(float) * smem_floats<DH>(1);
  err = allow_smem<flash_bwd_dq_kernel<DH>>(dq_bytes);
  if (err != 0) return err;
  flash_bwd_dq_kernel<DH>
      <<<dim3(B * Hq, (Sq + kB - 1) / kB), kThreads, dq_bytes, stream>>>(
          q, k, v, dout, lse, D, dq, Sq, Skv, Hq, Hkv, causal, window, scale);
  return (int)cudaGetLastError();
}

// (b) and (c) in bfloat16 on the tensor cores
template <int DH>
int launch_bf16(const bf16* q, const bf16* k, const bf16* v,
                const bf16* dout, const float* lse, const float* D, bf16* dq,
                bf16* dk, bf16* dv, int B, int Sq, int Skv, int Hq, int Hkv,
                int causal, int window, float scale, cudaStream_t stream) {
  static_assert(2 * 4 * (2 * (DH / 8) * 4 * 32) <=
                    2 * kStages * Tile<DH>::bytes,
                "the partial dK and dV fit in the stage area");
  constexpr int dkdv_bytes = dkdv_bf16_bytes<DH>();
  int err = allow_smem<flash_bwd_dkdv_bf16_kernel<DH>>(dkdv_bytes);
  if (err != 0) return err;
  const int nKB = (Skv + kB - 1) / kB;
  flash_bwd_dkdv_bf16_kernel<DH>
      <<<dim3(B * Hkv, (nKB + 1) / 2), kWarpsKV * 32, dkdv_bytes, stream>>>(
          q, k, v, dout, lse, D, dk, dv, Sq, Skv, Hq, Hkv, causal, window,
          scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  constexpr int dq_bytes = dq_bf16_bytes<DH>();
  err = allow_smem<flash_bwd_dq_bf16_kernel<DH>>(dq_bytes);
  if (err != 0) return err;
  flash_bwd_dq_bf16_kernel<DH>
      <<<dim3(B * Hq, (Sq + kB - 1) / kB), kWarpsQ * 32, dq_bytes, stream>>>(
          q, k, v, dout, lse, D, dq, Sq, Skv, Hq, Hkv, causal, window, scale);
  return (int)cudaGetLastError();
}

template <int DH>
int launch(const void* q, const void* k, const void* v, const void* out,
           const void* dout, const float* lse, float* D, void* dq, void* dk,
           void* dv, int B, int Sq, int Skv, int Hq, int Hkv, int causal,
           int window, int dtype, cudaStream_t stream) {
  const float scale = 1.0f / sqrtf((float)DH);
  int err = dtype == 0
                ? launch_dot<float>(out, dout, D, B, Sq, Hq, DH, stream)
                : launch_dot<bf16>(out, dout, D, B, Sq, Hq, DH, stream);
  if (err != 0) return err;
  if (dtype == 0)
    return launch_f32<DH>((const float*)q, (const float*)k, (const float*)v,
                          (const float*)dout, lse, D, (float*)dq, (float*)dk,
                          (float*)dv, B, Sq, Skv, Hq, Hkv, causal, window,
                          scale, stream);
  return launch_bf16<DH>((const bf16*)q, (const bf16*)k, (const bf16*)v,
                         (const bf16*)dout, lse, D, (bf16*)dq, (bf16*)dk,
                         (bf16*)dv, B, Sq, Skv, Hq, Hkv, causal, window,
                         scale, stream);
}

}  // namespace

extern "C" {

// Launch the three kernels on `stream`. dtype 0 = float32, 1 = bfloat16
// (q, k, v, out, dout, dq, dk, dv alike); lse (B, Hq, Sq) float32 from the
// forward; D a float32 (B, Hq, Sq) scratch; dh 64, 96 or 128; Hq % Hkv
// == 0; every buffer contiguous, and with bfloat16 q, k, v, dout 16-byte
// aligned. Returns a CUDA error code (0 = success; cudaErrorInvalidValue
// for a dtype or dh it was not built for).
int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                               const void* out, const void* dout,
                               const void* lse, void* D, void* dq, void* dk,
                               void* dv, int B, int Sq, int Skv, int Hq,
                               int Hkv, int dh, int causal, int window,
                               int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const float* l = (const float*)lse;
  float* d = (float*)D;
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  switch (dh) {
    case 64:
      return launch<64>(q, k, v, out, dout, l, d, dq, dk, dv, B, Sq, Skv, Hq,
                        Hkv, causal, window, dtype, s);
    case 96:
      return launch<96>(q, k, v, out, dout, l, d, dq, dk, dv, B, Sq, Skv, Hq,
                        Hkv, causal, window, dtype, s);
    case 128:
      return launch<128>(q, k, v, out, dout, l, d, dq, dk, dv, B, Sq, Skv,
                         Hq, Hkv, causal, window, dtype, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
