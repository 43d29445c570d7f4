// Causal GQA flash attention (forward) for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas kernel of
// src/repro/kernels/flash_attention/flash_attention.py (flash_attention,
// _flash_kernel), and takes the sliding-window mask of
// src/repro/models/attention.py:blockwise_attention, the function the
// reference's model path calls in its place.
//
// What it computes. For batch row b and query head h (KV head h / rep,
// rep = Hq / Hkv: K and V are read at Hkv width, never repeated),
//   out[i] = sum_j softmax_j(q_i . k_j * dh^-1/2) v_j
// over the keys kept by the masks: j < Skv; j <= i when causal; j > i - w
// when the window w > 0 (query and key positions both start at 0; masked
// scores are -1e30). Float32 math with an online softmax (running max m,
// running sum l, accumulator acc, rescaled by exp(m_old - m_new) per key
// block); the output is acc / max(l, 1e-20) in q's type (float32 or
// bfloat16). q, k, v, out are read and written in the reference's
// (B, S, H, dh) layout, contiguous.
//
// What bounds it. Operations: 4 * dh multiply-adds per kept (query, key)
// pair; at the serving shape (B = 4, S = 2048, Hq = Hkv = 32, dh = 64,
// causal) that is 68.8 GFLOP against 0.27 GB of q, k, v and out, about 256
// operations per byte, far above the card's float32 ratio (67 TFLOP/s over
// 3.35 TB/s = 20): the kernel is bound by operations.
//
// What this simple design does about that. One CTA of 128 threads per
// (64-query block, batch row x query head). The q tile, one 64-key block
// of K and V and the 64 x 64 score tile live in shared memory as float32
// (67 KB at dh = 64); each thread computes an 8 x 4 patch of scores and an
// 8 x dh/16 patch of the accumulator in registers, so every shared-memory
// load feeds 2-4 FMAs. Key blocks wholly above the diagonal (causal) or
// wholly before the window are never loaded, as the TPU kernel skips
// them (flash_attention.py:60-62): at the serving shape this halves the
// work. Ragged Sq and Skv are masked in the kernel (loads past the end
// read 0, scores past Skv are -1e30, rows past Sq are not stored), not
// padded. No tensor cores and no pipelined loads: wgmma and TMA are later
// work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBq = 64;        // query rows per CTA
constexpr int kBk = 64;        // keys per key block
constexpr int kThreads = 128;  // 16 x 8 threads
constexpr int kTP = kBq + 1;   // padded row of the transposed q/k tiles
constexpr int kSP = kBk + 1;   // padded row of the score tile
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <int DH>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (2 * DH * kTP + kBk * DH + kBq * kSP + 3 * kBq);
}

// grid (B * Hq, ceil(Sq / kBq)); thread (tx, ty) = (tid % 16, tid / 16)
// owns score rows ty + 8 i (i < 8) x columns tx + 16 j (j < 4), and the
// same rows x output columns tx + 16 j (j < DH / 16).
template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out, int Sq,
                     int Skv, int Hq, int Hkv, int causal, int window,
                     float scale) {
  constexpr int NC = DH / 16;
  extern __shared__ float smem[];
  float* Qt = smem;              // [DH][kTP] q tile, transposed
  float* Kt = Qt + DH * kTP;     // [DH][kTP] key block, transposed
  float* Vs = Kt + DH * kTP;     // [kBk][DH] value block
  float* Ss = Vs + kBk * DH;     // [kBq][kSP] scores, then probabilities
  float* m_s = Ss + kBq * kSP;   // [kBq] running max
  float* l_s = m_s + kBq;        // [kBq] running sum
  float* c_s = l_s + kBq;        // [kBq] this block's rescale factor

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int b = blockIdx.x / Hq, h = blockIdx.x % Hq;
  const int hk = h / (Hq / Hkv);
  const int q0 = blockIdx.y * kBq;
  const int64_t q_tok = (int64_t)Hq * DH;   // elements between tokens
  const int64_t kv_tok = (int64_t)Hkv * DH;
  const T* qb = q + (int64_t)b * Sq * q_tok + (int64_t)h * DH;
  const T* kb = k + (int64_t)b * Skv * kv_tok + (int64_t)hk * DH;
  const T* vb = v + (int64_t)b * Skv * kv_tok + (int64_t)hk * DH;

  for (int e = tid; e < kBq * DH; e += kThreads) {
    const int r = e / DH, d = e % DH;
    const int i = q0 + r;
    Qt[d * kTP + r] = i < Sq ? to_f(qb[(int64_t)i * q_tok + d]) : 0.0f;
  }
  for (int r = tid; r < kBq; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.0f;
  }
  float acc[8][NC];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[i][j] = 0.0f;

  // the key blocks any row of this tile keeps
  const int q_last = min(q0 + kBq, Sq) - 1;
  const int kv_end = causal ? min(Skv, q_last + 1) : Skv;
  const int kv_begin = window > 0 ? max(0, q0 - window + 1) : 0;

  for (int k0 = (kv_begin / kBk) * kBk; k0 < kv_end; k0 += kBk) {
    __syncthreads();  // the previous block's readers are done
    for (int e = tid; e < kBk * DH; e += kThreads) {
      const int c = e / DH, d = e % DH;
      const int j = k0 + c;
      const bool ok = j < Skv;
      Kt[d * kTP + c] = ok ? to_f(kb[(int64_t)j * kv_tok + d]) : 0.0f;
      Vs[c * DH + d] = ok ? to_f(vb[(int64_t)j * kv_tok + d]) : 0.0f;
    }
    __syncthreads();

    // scores of this thread's 8 x 4 patch, masked
    float s[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < DH; ++d) {
      float qv[8], kv[4];
#pragma unroll
      for (int i = 0; i < 8; ++i) qv[i] = Qt[d * kTP + ty + 8 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Kt[d * kTP + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = ty + 8 * i, qi = q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j, kj = k0 + c;
        bool keep = kj < Skv;
        if (causal) keep = keep && kj <= qi;
        if (window > 0) keep = keep && kj > qi - window;
        Ss[r * kSP + c] = keep ? s[i][j] * scale : kNegInf;
      }
    }
    __syncthreads();

    // online softmax: two neighbouring threads per row, 32 columns each
    {
      const int r = tid / 2, half = tid % 2;
      float* row = Ss + r * kSP + half * 32;
      float mx = kNegInf;
      for (int c = 0; c < 32; ++c) mx = fmaxf(mx, row[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.0f;
      for (int c = 0; c < 32; ++c) {
        const float p = expf(row[c] - m_new);
        row[c] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      __syncwarp();  // both halves have read m_s[r]
      if (half == 0) {
        const float corr = expf(m_old - m_new);
        c_s[r] = corr;
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * corr + P V
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float corr = c_s[ty + 8 * i];
#pragma unroll
      for (int j = 0; j < NC; ++j) acc[i][j] *= corr;
    }
#pragma unroll 4
    for (int c = 0; c < kBk; ++c) {
      float pv[8], vv[NC];
#pragma unroll
      for (int i = 0; i < 8; ++i) pv[i] = Ss[(ty + 8 * i) * kSP + c];
#pragma unroll
      for (int j = 0; j < NC; ++j) vv[j] = Vs[c * DH + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < NC; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }
  __syncthreads();

  T* ob = out + (int64_t)b * Sq * q_tok + (int64_t)h * DH;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = ty + 8 * i, qi = q0 + r;
    if (qi >= Sq) continue;
    const float l = fmaxf(l_s[r], 1e-20f);
#pragma unroll
    for (int j = 0; j < NC; ++j)
      store(ob + (int64_t)qi * q_tok + tx + 16 * j, acc[i][j] / l);
  }
}

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Sq, int Skv, int Hq, int Hkv, int causal, int window,
           cudaStream_t stream) {
  const size_t smem = smem_bytes<DH>();
  auto kernel = flash_fwd_kernel<T, DH>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * Hq, (Sq + kBq - 1) / kBq);
  kernel<<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, Sq, Skv, Hq, Hkv,
      causal, window, 1.0f / sqrtf((float)DH));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch on `stream`. dtype 0 = float32, 1 = bfloat16 (q, k, v and out
// alike); dh 64 or 128; Hq % Hkv == 0. Returns a CUDA error code
// (0 = success; cudaErrorInvalidValue for a dtype or dh it was not built
// for).
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* out, int B, int Sq, int Skv, int Hq,
                           int Hkv, int dh, int causal, int window,
                           int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0 && dh == 64)
    return launch<float, 64>(q, k, v, out, B, Sq, Skv, Hq, Hkv, causal,
                             window, s);
  if (dtype == 0 && dh == 128)
    return launch<float, 128>(q, k, v, out, B, Sq, Skv, Hq, Hkv, causal,
                              window, s);
  if (dtype == 1 && dh == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, out, B, Sq, Skv, Hq, Hkv,
                                     causal, window, s);
  if (dtype == 1 && dh == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, out, B, Sq, Skv, Hq, Hkv,
                                      causal, window, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
