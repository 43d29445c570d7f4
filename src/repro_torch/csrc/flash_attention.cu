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
// over the keys kept by the masks: j < Skv; j <= p when causal; j > p - w
// when the window w > 0, where p = q_offset + i is query i's position (key
// positions start at 0; an incremental prefill's chunk starts at its
// offset into the cache; masked scores are -1e30). Float32 math with an online softmax (running max m,
// running sum l, accumulator acc, rescaled by exp(m_old - m_new) per key
// block); the output is acc / max(l, 1e-20) in q's type (float32 or
// bfloat16). q, k, v, out are read and written in the reference's
// (B, S, H, dh) layout, contiguous, dh in {64, 96, 128}. Given an `lse`
// pointer (training: the backward kernel of flash_attention_bwd.cu
// recomputes the probabilities from it), each query row's log-sum-exp
// m + log(max(l, 1e-20)) of its scaled scores is written at
// lse[(b * Hq + h) * Sq + i] in float32; with lse == nullptr (every
// serving call) nothing else changes and out keeps its bits.
//
// What bounds it. Operations: 4 * dh multiply-adds per kept (query, key)
// pair; at the serving shape (B = 4, S = 2048, Hq = Hkv = 32, dh = 64,
// causal) that is 68.75 GFLOP against 0.27 GB of q, k, v and out. On the
// float32 CUDA cores (67 TFLOP/s) that is 1.026 ms; this kernel runs both
// products on the tensor cores as three TF32 products each (3 x 68.75
// GFLOP at 495 TFLOP/s = 0.417 ms), far above the 0.080 ms the bytes need:
// the kernel is bound by operations.
//
// What the design does about that (FlashAttention-2's layout on mma.sync):
//   * Grid (B * Hq, ceil(Sq / 64)); a CTA of 4 warps owns 64 query rows,
//     16 a warp. The query blocks run in reverse order (blockIdx.y = 0 is
//     the last block), so under the causal mask the heaviest blocks start
//     first and the light ones fill the tail.
//   * Products. q.k^T and p.v run as mma.sync m16n8k8 TF32
//     (mma_tf32.cuh). Float32 inputs take the 3xTF32 split at every
//     fragment (lo*hi, hi*lo, hi*hi), which keeps the float32 bar of 2e-5
//     that one TF32 pass would break. Bfloat16 inputs take one TF32 pass:
//     a bfloat16 value is exact in TF32, so q.k^T is exact per product and
//     only p is rounded (2^-11, far inside the bfloat16 bar of 2e-2). This
//     deviates from an m16n8k16 bfloat16 MMA: it reuses the float32 path's
//     fragments and costs the bfloat16 path (not on the serving path, which
//     runs float32) half the rate it could have.
//     The three passes run over 8 (q.k) or 4 (p.v) accumulators at a time
//     (mma_row), so two MMAs into one accumulator are never back to back.
//   * Softmax in registers. A warp's 16 x 64 score tile stays in its MMA
//     accumulators; row max and row sum reduce over the quad of threads
//     that holds a row (two xor shuffles); exponentials by __expf (relative
//     error ~1e-6 at these arguments, inside the 2e-5 bar). In the p.v
//     MMA, k-slot tig stands for key 2 tig and k-slot tig + 4 for key
//     2 tig + 1 (mma_tf32.cuh), so the accumulator fragment of the scores
//     is the A fragment of the probabilities as it stands: no shuffle, no
//     shared memory.
//   * Accumulation. Each key block's p.v is summed into a zero fragment
//     (8 k8 steps of truncating MMAs) and then added to the float32
//     accumulator with one rounded fmaf(acc, corr, pv), so truncation never
//     runs over more than one key block's sum.
//   * Loads. The q tile and a two-stage ring of K/V blocks (64 keys) come
//     in by 16-byte cp.async, the next block's copy in flight while this
//     one is multiplied; rows past Sq or Skv fill with zeros. Shared
//     memory rows are padded (K and q to dh + 8 elements, V to dh + 4
//     floats) so the fragment reads of a warp hit distinct banks:
//     88 KB at dh = 64 in float32, two CTAs (8 warps) an SM.
//   * Key blocks wholly above the diagonal (causal) or wholly before the
//     window are never loaded, as the TPU kernel skips them
//     (flash_attention.py:60-62); the masks are evaluated only in blocks
//     that cross an edge.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "mma_tf32.cuh"

namespace {

constexpr int kBq = 64;        // query rows per CTA, 16 a warp
constexpr int kBk = 64;        // keys per key block
constexpr int kThreads = 128;  // 4 warps
constexpr int kStages = 2;     // K/V ring
constexpr float kNegInf = -1e30f;

// Shared-memory layout: q (kBq rows) and each stage's K (kBk rows) with a
// row of dh + 8 elements (8-byte fragment reads along a row, conflict
// free), V with dh + 4 floats or dh + 8 bfloat16s (reads down a column,
// conflict free); every row a multiple of 16 bytes.
template <typename T, int DH>
struct Layout {
  static constexpr int QK = DH + 8;
  static constexpr int V = std::is_same<T, float>::value ? DH + 4 : DH + 8;
  static constexpr int q_elems = kBq * QK;
  static constexpr int k_elems = kBk * QK;
  static constexpr int stage = k_elems + kBk * V;
  static constexpr int bytes = (int)sizeof(T) * (q_elems + kStages * stage);
  static_assert((QK * sizeof(T)) % 16 == 0 && (V * sizeof(T)) % 16 == 0,
                "16-byte cp.async rows");
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 ld2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void st2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void st2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ void cp16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Copy 64 rows of DH elements, src row r at src + r * gs, into dst rows of
// ss elements; rows r >= valid fill with zeros (src unread).
template <typename T, int DH>
__device__ __forceinline__ void load_rows(T* dst, int ss, const T* src,
                                          int64_t gs, int valid, int tid) {
  constexpr int E = 16 / sizeof(T);   // elements a copy
  constexpr int C = DH / E;           // copies a row
  static_assert((64 * C) % kThreads == 0, "whole copies a thread");
#pragma unroll
  for (int i = 0; i < 64 * C / kThreads; ++i) {
    const int e = tid + i * kThreads;
    const int r = e / C, c = (e % C) * E;
    const bool ok = r < valid;
    cp16(dst + r * ss + c, ok ? src + (int64_t)r * gs + c : src, ok);
  }
}

// Thread (warp w, gid, tig) holds rows w*16 + gid and + 8 of the query
// tile: score columns n*8 + 2 tig (+1) of each n8 tile, output columns
// nt*8 + 2 tig (+1).
template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out,
                     float* __restrict__ lse, int Sq, int Skv, int Hq,
                     int Hkv, int causal, int window, int q_offset,
                     float scale) {
  using L = Layout<T, DH>;
  constexpr bool kSplit = std::is_same<T, float>::value;
  constexpr int NT = DH / 8;   // n8 tiles of the output, k8 steps of q.k
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);
  T* ring = Qs + L::q_elems;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int b = blockIdx.x / Hq, h = blockIdx.x % Hq;
  const int hk = h / (Hq / Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBq;   // heaviest first
  const int64_t q_tok = (int64_t)Hq * DH;   // elements between tokens
  const int64_t kv_tok = (int64_t)Hkv * DH;
  const T* qb = q + (int64_t)b * Sq * q_tok + (int64_t)h * DH;
  const T* kb = k + (int64_t)b * Skv * kv_tok + (int64_t)hk * DH;
  const T* vb = v + (int64_t)b * Skv * kv_tok + (int64_t)hk * DH;

  // the key blocks any row of this tile keeps; p0 and p_last are the
  // positions of its first and last rows. Key blocks start at multiples of
  // kBk whatever the offset, and a block wholly past a row's position adds
  // exp(-1e30 - m) = 0 to it with a correction of 1, so a row's result
  // does not depend on which tile, or which call, holds it.
  const int q_last = min(q0 + kBq, Sq) - 1;
  const int p0 = q_offset + q0, p_last = q_offset + q_last;
  const int kv_end = causal ? min(Skv, p_last + 1) : Skv;
  const int kv_begin = window > 0 ? max(0, p0 - window + 1) : 0;
  const int first = kv_begin / kBk;
  const int n_kb = (kv_end + kBk - 1) / kBk - first;   // >= 1

  auto load_block = [&](int j) {   // key block first + j into its stage
    T* Ks = ring + (j % kStages) * L::stage;
    const int k0 = (first + j) * kBk;
    load_rows<T, DH>(Ks, L::QK, kb + k0 * kv_tok, kv_tok, Skv - k0, tid);
    load_rows<T, DH>(Ks + L::k_elems, L::V, vb + k0 * kv_tok, kv_tok,
                     Skv - k0, tid);
  };
  load_rows<T, DH>(Qs, L::QK, qb + q0 * q_tok, q_tok, Sq - q0, tid);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_kb) load_block(s);
    cp_commit();
  }

  float o[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nt][e] = 0.0f;
  float m[2] = {kNegInf, kNegInf};   // running max of rows gid, gid + 8
  float l[2] = {0.0f, 0.0f};         // this thread's part of the row sums
  const int row0 = q0 + warp * 16 + gid;           // query index
  const int pos0 = q_offset + row0;                 // its position
  const T* qrow = Qs + (warp * 16 + gid) * L::QK + 2 * tig;

  for (int j = 0; j < n_kb; ++j) {
    cp_wait<kStages - 2>();
    __syncthreads();   // block j is in; block j - 1's stage is free
    if (j + kStages - 1 < n_kb) load_block(j + kStages - 1);
    cp_commit();
    const T* Ks = ring + (j % kStages) * L::stage;
    const T* Vs = Ks + L::k_elems;
    const int k0 = (first + j) * kBk;

    // s = q . k^T over this block's 64 keys
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < DH; kk += 8) {
      const float2 qa = ld2(qrow + kk), qc = ld2(qrow + 8 * L::QK + kk);
      ich::FragA a;
      ich::set_a<kSplit>(&a, qa.x, qc.x, qa.y, qc.y);
      ich::FragB bf[8];
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const float2 kf = ld2(Ks + (n * 8 + gid) * L::QK + kk + 2 * tig);
        ich::set_b<kSplit>(&bf[n], kf.x, kf.y);
      }
      ich::mma_row<8, kSplit>(s, a, bf);
    }

    // scale, and mask where the block crosses an edge of the masks
    const bool edge = k0 + kBk > Skv || (causal && k0 + kBk - 1 > p0) ||
                      (window > 0 && k0 <= p_last - window);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * scale;
        if (edge) {
          const int qi = pos0 + (e >> 1) * 8;
          const int kj = k0 + n * 8 + 2 * tig + (e & 1);
          bool keep = kj < Skv;
          if (causal) keep = keep && kj <= qi;
          if (window > 0) keep = keep && kj > qi - window;
          x = keep ? x : kNegInf;
        }
        s[n][e] = x;
      }

    // online softmax, rows held by the quad of threads with this gid
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = m[r];
#pragma unroll
      for (int n = 0; n < 8; ++n)
        mx = fmaxf(mx, fmaxf(s[n][2 * r], s[n][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      corr[r] = __expf(m[r] - mx);
      m[r] = mx;
      float sum = 0.0f;
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float p = __expf(s[n][2 * r + c] - mx);
          s[n][2 * r + c] = p;
          sum += p;
        }
      l[r] = l[r] * corr[r] + sum;
    }

    // pv = p . v from zero, then acc = acc * corr + pv
    float pv[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) pv[nt][e] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < 8; ++ks) {   // keys ks*8 + 2 tig and + 1
      ich::FragA a;
      ich::set_a<kSplit>(&a, s[ks][0], s[ks][2], s[ks][1], s[ks][3]);
      const T* vr = Vs + (ks * 8 + 2 * tig) * L::V + gid;
#pragma unroll
      for (int g = 0; g < NT; g += 4) {   // 4 n8 tiles at a time
        ich::FragB bf[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          ich::set_b<kSplit>(&bf[j], to_f(vr[(g + j) * 8]),
                             to_f(vr[L::V + (g + j) * 8]));
        ich::mma_row<4, kSplit>(pv + g, a, bf);
      }
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        o[nt][e] = fmaf(o[nt][e], corr[e >> 1], pv[nt][e]);
  }

  T* ob = out + (int64_t)b * Sq * q_tok + (int64_t)h * DH;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float sum = l[r];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const int qi = row0 + 8 * r;
    if (qi >= Sq) continue;
    const float den = fmaxf(sum, 1e-20f);
    if (lse != nullptr && tig == 0)   // m[r] and sum are the quad's
      lse[((int64_t)b * Hq + h) * Sq + qi] = m[r] + logf(den);
    T* orow = ob + (int64_t)qi * q_tok + 2 * tig;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      st2(orow + nt * 8, o[nt][2 * r] / den, o[nt][2 * r + 1] / den);
  }
}

// Raise a kernel's dynamic shared-memory limit to `bytes` once per device:
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

template <typename T, int DH>
int launch(const void* q, const void* k, const void* v, void* out,
           float* lse, int B, int Sq, int Skv, int Hq, int Hkv, int causal,
           int window, int q_offset, cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<T, DH>;
  const int err = allow_smem<flash_fwd_kernel<T, DH>>(Layout<T, DH>::bytes);
  if (err != 0) return err;
  const dim3 grid(B * Hq, (Sq + kBq - 1) / kBq);
  kernel<<<grid, kThreads, Layout<T, DH>::bytes, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, lse, Sq, Skv, Hq,
      Hkv, causal, window, q_offset, 1.0f / sqrtf((float)DH));
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dh(const void* q, const void* k, const void* v, void* out,
              float* lse, int B, int Sq, int Skv, int Hq, int Hkv, int dh,
              int causal, int window, int q_offset, cudaStream_t s) {
  switch (dh) {
    case 64:
      return launch<T, 64>(q, k, v, out, lse, B, Sq, Skv, Hq, Hkv, causal,
                           window, q_offset, s);
    case 96:
      return launch<T, 96>(q, k, v, out, lse, B, Sq, Skv, Hq, Hkv, causal,
                           window, q_offset, s);
    case 128:
      return launch<T, 128>(q, k, v, out, lse, B, Sq, Skv, Hq, Hkv, causal,
                            window, q_offset, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Launch on `stream`. dtype 0 = float32, 1 = bfloat16 (q, k, v and out
// alike); dh 64, 96 or 128; Hq % Hkv == 0; q, k, v and out 16-byte
// aligned; q_offset >= 0 the position of query 0; lse a float32
// (B, Hq, Sq) buffer for the rows' log-sum-exp, or null. Returns a CUDA
// error code (0 = success; cudaErrorInvalidValue for a dtype or dh it was
// not built for).
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* out, void* lse, int B, int Sq, int Skv,
                           int Hq, int Hkv, int dh, int causal, int window,
                           int q_offset, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  float* l = (float*)lse;
  if (dtype == 0)
    return launch_dh<float>(q, k, v, out, l, B, Sq, Skv, Hq, Hkv, dh,
                            causal, window, q_offset, s);
  if (dtype == 1)
    return launch_dh<__nv_bfloat16>(q, k, v, out, l, B, Sq, Skv, Hq, Hkv,
                                    dh, causal, window, q_offset, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
