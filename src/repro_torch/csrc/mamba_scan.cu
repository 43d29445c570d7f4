// Chunked SSD scan (Mamba2) for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas kernel of src/repro/kernels/mamba_scan/mamba_scan.py
// (mamba_scan, _ssd_kernel), which src/repro/models/ssm.py's
// chunked_gated_scan mirrors on the reference's model path.
//
// What it computes. Per batch row b and head h, a float32 state S (N, Pd)
// walks the sequence in chunks of Q steps. With l the inclusive cumulative
// sum of log_a inside the chunk and total = l[Q-1]:
//   y_i   = sum_{j<=i} (q_i . k_j) exp(clip(l_i - l_j, -60, 0)) v_j
//           + exp(l_i) q_i . S_prev
//   S_new = exp(total) S_prev + sum_j exp(clip(total - l_j, -60, 0)) k_j (x) v_j
// It returns y (B, S, H, Pd) in v's type and the final state (B, H, N, Pd).
// Steps past the end of the sequence read q = k = v = 0 and log_a = 0, so
// a ragged last chunk behaves as the reference's zero padding: the state is
// unchanged by them and their y is not stored.
//
// Order. On the TPU the chunk axis is a sequential grid dimension and the
// state persists in VMEM scratch. CTAs on this card run in no order, so one
// CTA walks all chunks of its (b, h) in ascending order and keeps the state
// in shared memory. Each column of the state evolves on its own, so a CTA
// owns a slice of 64 columns of Pd (grid (B*H, ceil(Pd/64))); at Pd = 64 a
// CTA owns the whole head.
//
// What bounds it. Operations: per chunk, Q(Q+1)/2 causal pairs need 2N
// for their q.k score (once per batch row when q and k are shared across
// heads, once per head otherwise), and per head 2Pd + 1 for each pair's
// decayed product with v plus 4 Q N Pd for the inter-chunk term and the
// state update; at the serving shape (B = 4, S = 2048, H = 64,
// N = Pd = 64, Q = 256, q and k shared: head stride 0) 17.4 GFLOP against
// 0.28 GB of inputs and outputs: the kernel is bound by operations.
//
// What this simple design does about that. A (Q, Q) score tile at Q = 256
// is 256 KB in float32, more than a CTA's 227 KB, so the chunk is worked
// through in 64-row tiles: for each row tile, the 64-key tiles at or before
// it are loaded to shared memory, their decayed, causally masked scores
// formed (64 x 64) and multiplied into the row tile's y in registers; the
// key tiles above the diagonal are never touched. The inter-chunk term
// reads the state from shared memory, and after the last row tile the
// state update walks the key tiles once more. 256 threads hold 4 x 4
// patches, so each shared-memory load feeds 2-4 FMAs; 83 KB of shared
// memory lets two CTAs share an SM, and B*H = 256 CTAs fill the 132 SMs in
// one wave. q and k are read through explicit (b, s, h) strides, so B and C
// shared by all heads (Zamba2, ssm.py:182-183) are read with a head stride
// of 0, never materialised. The score tile does not depend on the head when
// q and k are shared, but each CTA recomputes it (a third of the work it
// executes at the serving shape); no tensor cores and no pipelined loads:
// later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kT = 64;         // rows of a row tile and of a key tile
constexpr int kNMax = 64;      // state rows held
constexpr int kPB = 64;        // state columns per CTA
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each
constexpr int kNP = kNMax + 1; // padded row of the q and k tiles
constexpr int kSP = kT + 1;    // padded row of the score tile

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

size_t smem_bytes(int chunk) {
  return sizeof(float) *
         ((size_t)2 * kT * kNP + kT * kPB + kT * kSP + kNMax * kPB + chunk);
}

__device__ __forceinline__ float decay(float x) {
  return expf(fminf(fmaxf(x, -60.0f), 0.0f));
}

// Thread (tx, ty) = (tid % 16, tid / 16) owns rows ty + 16 a and columns
// tx + 16 c (a, c < 4) of every 64 x 64 tile: y rows x state columns,
// score rows x key columns, and state rows x state columns.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    ssd_scan_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const float* __restrict__ log_a,
                    T* __restrict__ y, float* __restrict__ state_out, int S,
                    int H, int N, int Pd, int chunk, int64_t q_sb,
                    int64_t q_ss, int64_t q_sh, int64_t k_sb, int64_t k_ss,
                    int64_t k_sh) {
  extern __shared__ float smem[];
  float* Qs = smem;               // [kT][kNP]  q rows of the row tile
  float* Ks = Qs + kT * kNP;      // [kT][kNP]  k rows of the key tile
  float* Vs = Ks + kT * kNP;      // [kT][kPB]  v rows of the key tile
  float* Ss = Vs + kT * kPB;      // [kT][kSP]  decayed scores
  float* St = Ss + kT * kSP;      // [kNMax][kPB] state, this CTA's columns
  float* l = St + kNMax * kPB;    // [chunk] cumulative log_a in the chunk

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int p0 = blockIdx.y * kPB;
  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + h * k_sh;
  const int64_t v_tok = (int64_t)H * Pd;  // v and y: (B, S, H, Pd)
  const int64_t vy0 = (int64_t)b * S * v_tok + (int64_t)h * Pd + p0;
  const float* lab = log_a + (int64_t)b * S * H + h;

  for (int e = tid; e < kNMax * kPB; e += kThreads) St[e] = 0.0f;

  // load rows [t0, t0 + rows) of q or k (scaled by w[j] when given) into
  // a [kT][kNP] tile; rows past the chunk or the sequence read 0
  auto load_qk = [&](float* dst, const T* src, int64_t ss, int t0, int i0,
                     const float* w, float total) {
    for (int e = tid; e < kT * kNMax; e += kThreads) {
      const int r = e / kNMax, n = e % kNMax;
      const int i = i0 + r;
      const int t = t0 + i;
      float x = 0.0f;
      if (i < chunk && t < S && n < N) {
        x = to_f(src[(int64_t)t * ss + n]);
        if (w != nullptr) x *= decay(total - w[i]);
      }
      dst[r * kNP + n] = x;
    }
  };
  auto load_v = [&](int t0, int j0) {
    for (int e = tid; e < kT * kPB; e += kThreads) {
      const int r = e / kPB, p = e % kPB;
      const int j = j0 + r;
      const int t = t0 + j;
      Vs[r * kPB + p] = (j < chunk && t < S && p0 + p < Pd)
                            ? to_f(v[vy0 + (int64_t)t * v_tok + p])
                            : 0.0f;
    }
  };

  const int n_chunks = (S + chunk - 1) / chunk;
  for (int ci = 0; ci < n_chunks; ++ci) {
    const int t0 = ci * chunk;
    __syncthreads();  // the previous chunk is done with l and the tiles
    // l: inclusive cumulative sum; warp 0, a run of steps per lane, then
    // an exclusive scan of the lane totals
    if (tid < 32) {
      const int per = (chunk + 31) / 32;
      const int lo = min(tid * per, chunk), hi = min(lo + per, chunk);
      float run = 0.0f;
      for (int i = lo; i < hi; ++i) {
        const int t = t0 + i;
        run += t < S ? lab[(int64_t)t * H] : 0.0f;
        l[i] = run;
      }
      float incl = run;
      for (int o = 1; o < 32; o <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, incl, o);
        if (tid >= o) incl += u;
      }
      const float base = incl - run;
      for (int i = lo; i < hi; ++i) l[i] += base;
    }
    __syncthreads();
    const float total = l[chunk - 1];

    for (int i0 = 0; i0 < chunk; i0 += kT) {
      __syncthreads();  // the previous row tile is done with Qs
      load_qk(Qs, qb, q_ss, t0, i0, nullptr, 0.0f);
      float acc[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[a][c] = 0.0f;

      for (int j0 = 0; j0 <= i0; j0 += kT) {
        __syncthreads();  // the previous key tile's readers are done
        load_qk(Ks, kb, k_ss, t0, j0, nullptr, 0.0f);
        load_v(t0, j0);
        __syncthreads();
        float s[4][4];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < 4; ++c) s[a][c] = 0.0f;
#pragma unroll 4
        for (int n = 0; n < N; ++n) {
          float qa[4], kc[4];
#pragma unroll
          for (int a = 0; a < 4; ++a) qa[a] = Qs[(ty + 16 * a) * kNP + n];
#pragma unroll
          for (int c = 0; c < 4; ++c) kc[c] = Ks[(tx + 16 * c) * kNP + n];
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int c = 0; c < 4; ++c) s[a][c] = fmaf(qa[a], kc[c], s[a][c]);
        }
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int r = ty + 16 * a, i = i0 + r;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int cc = tx + 16 * c, j = j0 + cc;
            Ss[r * kSP + cc] = (j <= i && i < chunk)
                                   ? s[a][c] * decay(l[i] - l[j])
                                   : 0.0f;
          }
        }
        __syncthreads();
#pragma unroll 4
        for (int cc = 0; cc < kT; ++cc) {
          float sa[4], vc[4];
#pragma unroll
          for (int a = 0; a < 4; ++a) sa[a] = Ss[(ty + 16 * a) * kSP + cc];
#pragma unroll
          for (int c = 0; c < 4; ++c) vc[c] = Vs[cc * kPB + tx + 16 * c];
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[a][c] = fmaf(sa[a], vc[c], acc[a][c]);
        }
      }

      // inter-chunk term: exp(l_i) q_i . S_prev
      float yi[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) yi[a][c] = 0.0f;
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        float qa[4], sc[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) qa[a] = Qs[(ty + 16 * a) * kNP + n];
#pragma unroll
        for (int c = 0; c < 4; ++c) sc[c] = St[n * kPB + tx + 16 * c];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < 4; ++c) yi[a][c] = fmaf(qa[a], sc[c], yi[a][c]);
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int i = i0 + ty + 16 * a;
        const int t = t0 + i;
        if (i >= chunk || t >= S) continue;
        const float e = expf(l[i]);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int p = tx + 16 * c;
          if (p0 + p < Pd)
            store(y + vy0 + (int64_t)t * v_tok + p, acc[a][c] + yi[a][c] * e);
        }
      }
    }

    // state update: S = exp(total) S + sum_j (w_j k_j) (x) v_j
    float su[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) su[a][c] = 0.0f;
    for (int j0 = 0; j0 < chunk; j0 += kT) {
      __syncthreads();  // every reader of the state and the tiles is done
      load_qk(Ks, kb, k_ss, t0, j0, l, total);
      load_v(t0, j0);
      __syncthreads();
#pragma unroll 4
      for (int cc = 0; cc < kT; ++cc) {
        float ka[4], vc[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) ka[a] = Ks[cc * kNP + ty + 16 * a];
#pragma unroll
        for (int c = 0; c < 4; ++c) vc[c] = Vs[cc * kPB + tx + 16 * c];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < 4; ++c) su[a][c] = fmaf(ka[a], vc[c], su[a][c]);
      }
    }
    const float et = expf(total);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float* s = St + (ty + 16 * a) * kPB + tx + 16 * c;
        *s = *s * et + su[a][c];  // this thread's own entry
      }
  }

  float* so = state_out + ((int64_t)b * H + h) * N * Pd + p0;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int n = ty + 16 * a;
    if (n >= N) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int p = tx + 16 * c;
      if (p0 + p < Pd) so[(int64_t)n * Pd + p] = St[n * kPB + p];
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const float* log_a,
           void* y, float* state, int B, int S, int H, int N, int Pd,
           int chunk, int64_t q_sb, int64_t q_ss, int64_t q_sh, int64_t k_sb,
           int64_t k_ss, int64_t k_sh, cudaStream_t stream) {
  const size_t smem = smem_bytes(chunk);
  auto kernel = ssd_scan_kernel<T>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * H, (Pd + kPB - 1) / kPB);
  kernel<<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, log_a, (T*)y, state, S, H, N,
      Pd, chunk, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch on `stream`. dtype 0 = float32, 1 = bfloat16 (q, k, v and y);
// log_a and the state are float32; N <= 64; 1 <= chunk <= 1024; strides of
// q and k in elements over (b, s, h), unit over N; v, log_a, y and the
// (zeroed) state contiguous. Returns a CUDA error code (0 = success).
int mamba_scan_launch(const void* q, const void* k, const void* v,
                      const float* log_a, void* y, float* state, int B,
                      int S, int H, int N, int Pd, int chunk, int64_t q_sb,
                      int64_t q_ss, int64_t q_sh, int64_t k_sb, int64_t k_ss,
                      int64_t k_sh, int dtype, void* stream) {
  if (N > kNMax || chunk < 1 || chunk > 1024)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(q, k, v, log_a, y, state, B, S, H, N, Pd, chunk,
                         q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, log_a, y, state, B, S, H, N, Pd,
                                 chunk, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
                                 s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
