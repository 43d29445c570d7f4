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
// Float32 math; dq, dk, dv are written in q's type (float32 or bfloat16).
//
// What bounds it. Operations: 10 * dh flops per kept (query, key) pair
// (S recomputed, dP, dV, dK, dQ). At qwen2-1.5b's training shape (B = 4,
// S = 2,048, Hq = 12, Hkv = 2, dh = 128, causal) that is 128.9 GFLOP
// against ~235 MB of float32 inputs and outputs: 1.92 ms on the float32
// CUDA cores (67 TFLOP/s), 0.07 ms for the bytes. The kernel is bound by
// operations.
//
// What the design does about that (a simple design that is right; its
// products run on the CUDA cores in float32 FMAs, not on the tensor
// cores: that is later work). Three launches, no atomics, every sum in a
// fixed order, so two calls give the same bits:
//   (a) flash_bwd_dot_kernel: D, one warp a (b, i, h) row.
//   (b) flash_bwd_dkdv_kernel: one CTA of 256 threads a (b, KV head, key
//       block of 64). It keeps its K and V tiles in shared memory and walks
//       the rep query heads of its group and, for each, the query blocks of
//       64 that keep any of its keys (from the first the causal mask lets
//       see it, to the last the window lets see it). Per query block it
//       recomputes S^T and dP^T (64 keys x 64 queries, 4 x 4 a thread),
//       P^T and dS^T from lse and D into shared memory, then adds P^T dO
//       and dS^T q into dV and dK, which stay in registers (4 keys x dh/16
//       columns a thread): GQA's rep heads sum into one dK and dV with no
//       atomics. Key block 0 is the heaviest under the causal mask and
//       runs first (block order).
//   (c) flash_bwd_dq_kernel: one CTA a (b, query head, query block of 64),
//       heaviest first as in the forward. It keeps q, dO, lse and D of its
//       rows in shared memory, walks the key blocks its rows keep,
//       recomputes S and dP, writes dS to shared memory and adds dS k into
//       dQ in registers.
//   Tiles are float32 in shared memory with odd row strides (dh + 1 and
//   65 floats), so a warp's walk down a column and along a row hit 32
//   distinct banks; bfloat16 inputs are widened as they are loaded. dS and
//   dP are recomputed in both (b) and (c) (14 dh flops a pair in all, not
//   10): the price of no atomics. Shared memory: 166 KB for (b) and 149 KB
//   for (c) at dh = 128, one CTA an SM; 98 and 82 KB at dh = 64.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kB = 64;          // rows of a query block and of a key block
constexpr int kThreads = 256;   // 16 x 16 threads, 4 x 4 of a 64 x 64 tile
constexpr int kPS = kB + 1;     // row stride of a 64 x 64 tile (floats)

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Shared memory of the two tile kernels, in floats: four (64 x dh) tiles
// with rows of dh + 1, n_sq (64 x 64) tiles with rows of 65, and 64 lse
// and 64 D values.
template <int DH>
constexpr int smem_floats(int n_sq) {
  return 4 * kB * (DH + 1) + n_sq * kB * kPS + 2 * kB;
}

// 64 rows of DH elements into a float tile with rows of DH + 1: source row
// r at src + r * gs; rows r >= valid fill with zeros (unread).
template <typename T, int DH>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          int64_t gs, int valid, int tid) {
#pragma unroll 4
  for (int e = tid; e < kB * DH; e += kThreads) {
    const int r = e / DH, c = e % DH;
    dst[r * (DH + 1) + c] = r < valid ? to_f(src[(int64_t)r * gs + c]) : 0.0f;
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
template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ D, T* __restrict__ dk,
                          T* __restrict__ dv, int Sq, int Skv, int Hq,
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
  load_tile<T, DH>(Ks, k + kv_base + k0 * kv_tok, kv_tok, Skv - k0, tid);
  load_tile<T, DH>(Vs, v + kv_base + k0 * kv_tok, kv_tok, Skv - k0, tid);

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
      load_tile<T, DH>(Qs, q + q_base + q0 * q_tok, q_tok, Sq - q0, tid);
      load_tile<T, DH>(Os, dout + q_base + q0 * q_tok, q_tok, Sq - q0, tid);
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
    T* dkr = dk + kv_base + (int64_t)kj * kv_tok;
    T* dvr = dv + kv_base + (int64_t)kj * kv_tok;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      store(dkr + tx + 16 * c, adk[a][c] * scale);
      store(dvr + tx + 16 * c, adv[a][c]);
    }
  }
}

// (c) dQ of one (b, query head, query block). Thread (ty, tx) owns query
// rows ty + 16 a of the block: in the score tiles the keys tx + 16 c
// (c < 4), in dQ the columns tx + 16 c (c < dh / 16).
template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ D, T* __restrict__ dq,
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

  load_tile<T, DH>(Qs, q + q_base + q0 * q_tok, q_tok, Sq - q0, tid);
  load_tile<T, DH>(Os, dout + q_base + q0 * q_tok, q_tok, Sq - q0, tid);
  load_row(Ls, lse + l_base + q0, Sq - q0, tid);
  load_row(Ds, D + l_base + q0, Sq - q0, tid);

  float adq[4][DC];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < DC; ++c) adq[a][c] = 0.0f;

  for (int k0 = (kv_begin / kB) * kB; k0 < kv_end; k0 += kB) {
    __syncthreads();   // the last key block is consumed
    load_tile<T, DH>(Ks, k + kv_base + k0 * kv_tok, kv_tok, Skv - k0, tid);
    load_tile<T, DH>(Vs, v + kv_base + k0 * kv_tok, kv_tok, Skv - k0, tid);
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
    T* dqr = dq + q_base + (int64_t)i * q_tok;
#pragma unroll
    for (int c = 0; c < DC; ++c) store(dqr + tx + 16 * c, adq[a][c] * scale);
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

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, const void* out,
           const void* dout, const float* lse, float* D, void* dq, void* dk,
           void* dv, int B, int Sq, int Skv, int Hq, int Hkv, int causal,
           int window, cudaStream_t stream) {
  const float scale = 1.0f / sqrtf((float)DH);
  const int64_t rows = (int64_t)B * Sq * Hq;
  const int dot_blocks = (int)((rows + kThreads / 32 - 1) / (kThreads / 32));
  flash_bwd_dot_kernel<T><<<dot_blocks, kThreads, 0, stream>>>(
      (const T*)out, (const T*)dout, D, rows, Sq, Hq, DH);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  const int dkdv_bytes = (int)sizeof(float) * smem_floats<DH>(2);
  int err = allow_smem<flash_bwd_dkdv_kernel<T, DH>>(dkdv_bytes);
  if (err != 0) return err;
  flash_bwd_dkdv_kernel<T, DH>
      <<<dim3(B * Hkv, (Skv + kB - 1) / kB), kThreads, dkdv_bytes, stream>>>(
          (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, D,
          (T*)dk, (T*)dv, Sq, Skv, Hq, Hkv, causal, window, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  const int dq_bytes = (int)sizeof(float) * smem_floats<DH>(1);
  err = allow_smem<flash_bwd_dq_kernel<T, DH>>(dq_bytes);
  if (err != 0) return err;
  flash_bwd_dq_kernel<T, DH>
      <<<dim3(B * Hq, (Sq + kB - 1) / kB), kThreads, dq_bytes, stream>>>(
          (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, D,
          (T*)dq, Sq, Skv, Hq, Hkv, causal, window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dh(const void* q, const void* k, const void* v, const void* out,
              const void* dout, const float* lse, float* D, void* dq,
              void* dk, void* dv, int B, int Sq, int Skv, int Hq, int Hkv,
              int dh, int causal, int window, cudaStream_t s) {
  switch (dh) {
    case 64:
      return launch<T, 64>(q, k, v, out, dout, lse, D, dq, dk, dv, B, Sq, Skv,
                           Hq, Hkv, causal, window, s);
    case 96:
      return launch<T, 96>(q, k, v, out, dout, lse, D, dq, dk, dv, B, Sq, Skv,
                           Hq, Hkv, causal, window, s);
    case 128:
      return launch<T, 128>(q, k, v, out, dout, lse, D, dq, dk, dv, B, Sq,
                            Skv, Hq, Hkv, causal, window, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Launch the three kernels on `stream`. dtype 0 = float32, 1 = bfloat16
// (q, k, v, out, dout, dq, dk, dv alike); lse (B, Hq, Sq) float32 from the
// forward; D a float32 (B, Hq, Sq) scratch; dh 64, 96 or 128; Hq % Hkv
// == 0; every buffer contiguous. Returns a CUDA error code (0 = success;
// cudaErrorInvalidValue for a dtype or dh it was not built for).
int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                               const void* out, const void* dout,
                               const void* lse, void* D, void* dq, void* dk,
                               void* dv, int B, int Sq, int Skv, int Hq,
                               int Hkv, int dh, int causal, int window,
                               int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const float* l = (const float*)lse;
  float* d = (float*)D;
  if (dtype == 0)
    return launch_dh<float>(q, k, v, out, dout, l, d, dq, dk, dv, B, Sq, Skv,
                            Hq, Hkv, dh, causal, window, s);
  if (dtype == 1)
    return launch_dh<__nv_bfloat16>(q, k, v, out, dout, l, d, dq, dk, dv, B,
                                    Sq, Skv, Hq, Hkv, dh, causal, window, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
