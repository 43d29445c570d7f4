// The backward of the iCh-scheduled MoE expert FFN for NVIDIA Hopper
// (sm_90a).
//
// Replaces no Pallas kernel: the reference trains its MoE layer by XLA's
// derivative of plain einsums over an (E, C_max) slot buffer
// (src/repro/models/moe.py:244-268). It is the gradient of the port's
// forward, csrc/ich_moe.cu, which runs training's capacity-mode dispatch
// (the capacity cut, the steal round) through the scheduler.
//
// What it computes. The input is the dispatch plan's expert-major CSR:
// expert e's kept slots are [indptr[e], indptr[e+1]), slot s holds token
// tok[s] and combine weight w[s] (a stolen entry's expert is its steal
// target; dropped entries hold no slot). For every slot s of expert e,
// t = tok[s]:
//   g = x[t].wg[e]   h = x[t].wi[e]   a = silu(g) * h        (F values)
//   v = dy[t].wo[e]^T                                         (F values)
//   dw[s] = sum_f a * v          (the combine weight's gradient)
//   da = w[s] v   dh = da * silu(g)   dg = da * h * silu'(g)
//   dx_s = dh.wi[e]^T + dg.wg[e]^T                            (D values)
//   dwo[e] = sum_s (w[s] a)^T dy[t]
//   dwi[e] = sum_s x[t]^T dh      dwg[e] = sum_s x[t]^T dg
//   dx[t]  = the left fold, slots in ascending order, of dx_s over t's
//            slots (tok_ptr / tok_slot: the forward's token -> slots index)
// by six kernels launched in turn by ich_moe_bwd_launch:
//   1. moe_bwd_up: g and h of every slot (x rows gathered; K = D), the
//      forward's up product again (the backward recomputes it from x);
//   2. moe_bwd_v: v (dy rows gathered against wo[e]^T; K = D), whose
//      epilogue reads g and h and writes dg and dh over them, w a and
//      a * v;
//   3. moe_bwd_dx: dx_s = [dh | dg] . [wi[e]^T ; wg[e]^T] (K = 2F);
//   4. moe_bwd_dweights: dwi, dwg and dwo of each expert, a product
//      whose depth is the expert's slots in ascending order;
//   5. moe_bwd_combine: dx, the forward's combine over dx_s;
//   6. moe_bwd_dw: dw[s], the left fold over f of a * v.
// Operations: 16 * D * F per kept slot (the two recomputed up products,
// v, the two dx products, three weight products), 2.15 TFLOP at
// OLMoE-1B-7B's training shape (8,192 tokens, top-8 of 64 experts, D =
// 2,048, F = 1,024, all 65,536 entries kept). Bytes: the weights read
// once and their gradients written once (3.2 GB), x, dy and dx (67 MB
// each). So it is bound by operations: 13.0 ms as 3xTF32 on the tensor
// cores (495 TFLOP/s / 3), 32 ms on the float32 CUDA cores (67 TFLOP/s).
//
// What the design does. It is the simple kernel first: every product is
// one tiled float32 product on the CUDA cores (fmaf), a CTA of 256
// threads owning a 128 x 128 output tile (8 x 8 a thread), stages of
// depth 8 in shared memory, double-buffered through registers. The tensor
// cores (3xTF32 or bfloat16 mma.sync / wgmma) are the redesign's work.
//   * No float atomics. Every output element has one owner thread, which
//     sums its products over ascending k with fmaf. The weight gradients
//     reduce over an expert's slots, contiguous in the CSR, so a dW tile
//     walks them in ascending slot order; an expert with no kept slot
//     runs no step and writes exact zeros. dx_s goes to its own row of a
//     slot-indexed buffer and moe_bwd_combine folds a token's rows in
//     ascending slot order: a token's K slots may lie on different
//     experts, so dx cannot be written per expert.
//   * Deterministic and independent of the lowering. The kernels read the
//     plan's CSR and the token -> slots index, never the schedule's tiles
//     or shards, and every sum has one fixed order: two calls give the
//     same bits, and so do p, B, W and the refine generation.
//   * Operands. Each product reads its A (rows m) and B (columns n)
//     operands through an element map: rows gathered by token
//     (x[tok[s]], dy[tok[s]]), rows of a slot buffer, an expert's
//     weight matrix as it lies or transposed, two matrices concatenated
//     along k or n. A stage copies an operand in the direction it is
//     contiguous (along k or along m / n), so neighbouring threads read
//     neighbouring addresses, and stores it k-major in shared memory, rows
//     padded by 4 floats; the tile's own reads are float4.
//   * Padding lanes and pad tiles do not reach it: the CSR holds kept
//     slots only. Rows past an expert's slots, columns past N and depth
//     past K read zeros and write nothing.
// Scratch (the wrapper's): g, h (rewritten as dg, dh), w a and a * v,
// (n_slots, F) each, and dx_s (n_slots, D): 1.6 GB at the shape above.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TM = 128;      // output rows a CTA
constexpr int TN = 128;      // output columns a CTA
constexpr int TK = 8;        // depth of a shared-memory stage
constexpr int kThreads = 256;  // 16 x 16 threads, 8 x 8 outputs each
constexpr int LDS = TM + 4;  // stage row stride, floats (TM == TN)
constexpr int kCombineThreads = 256;
constexpr int kFoldThreads = 256;

static_assert(TM == TN && TK * TM == 4 * kThreads,
              "a stage is four values a thread for each operand");
static_assert((LDS * 4) % 16 == 0, "float4 stage reads");

// ------------------------------------------------------------- operands
// An operand maps (i, k) to its element: i a row of A (m) or a column of
// B (n), k the depth. kKContig: neighbouring k lie next to each other in
// memory (else neighbouring i do); the stage copies in that direction.

// Row i = slot lo + i of a gathered (., ld) matrix: src[tok[lo + i]][k].
struct GatherRows {
  static constexpr bool kKContig = true;
  const float* src;
  const int* tok;
  int64_t lo;
  int ld;
  __device__ float at(int i, int k) const {
    return src[(int64_t)tok[lo + i] * ld + k];
  }
};

// Row i of two (., ld) matrices side by side along k:
// k < ld ? p0[lo + i][k] : p1[lo + i][k - ld].
struct PairRows {
  static constexpr bool kKContig = true;
  const float* p0;
  const float* p1;
  int64_t lo;
  int ld;
  __device__ float at(int i, int k) const {
    const int64_t r = (lo + i) * (int64_t)ld;
    return k < ld ? p0[r + k] : p1[r + k - ld];
  }
};

// Row i of a row-major (., ld) matrix: src[i][k].
struct Rows {
  static constexpr bool kKContig = true;
  const float* src;
  int ld;
  __device__ float at(int i, int k) const {
    return src[(int64_t)i * ld + k];
  }
};

// Column i, depth k = slot lo + k of a gathered matrix: src[tok[lo+k]][i].
struct GatherCols {
  static constexpr bool kKContig = false;
  const float* src;
  const int* tok;
  int64_t lo;
  int ld;
  __device__ float at(int i, int k) const {
    return src[(int64_t)tok[lo + k] * ld + i];
  }
};

// Column i, depth k = slot lo + k of a slot buffer: src[lo + k][i].
struct SlotCols {
  static constexpr bool kKContig = false;
  const float* src;
  int64_t lo;
  int ld;
  __device__ float at(int i, int k) const {
    return src[(lo + k) * (int64_t)ld + i];
  }
};

// Column i of two (K, n) row-major matrices side by side along n:
// i < n ? p0[k][i] : p1[k][i - n] (the up product's wi[e] | wg[e]).
struct PairCols {
  static constexpr bool kKContig = false;
  const float* p0;
  const float* p1;
  int n;
  __device__ float at(int i, int k) const {
    return i < n ? p0[(int64_t)k * n + i] : p1[(int64_t)k * n + i - n];
  }
};

struct f4 {
  float x, y, z, w;
};

// This thread's four values of a stage at depth k0: zeros outside
// [0, extent) x [0, K). Tile-local index i0 + (its i).
template <class Op>
__device__ __forceinline__ void fetch(const Op& op, int i0, int extent,
                                      int k0, int K, float r[4]) {
  const int tid = threadIdx.x;
  if constexpr (Op::kKContig) {
    const int i = i0 + tid / 2, k = k0 + (tid % 2) * 4;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      r[j] = i < extent && k + j < K ? op.at(i, k + j) : 0.0f;
    }
  } else {
    const int k = k0 + tid / 32, i = i0 + (tid % 32) * 4;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      r[j] = i + j < extent && k < K ? op.at(i + j, k) : 0.0f;
    }
  }
}

// Store fetch()'s four values into the k-major stage s[k][i].
template <class Op>
__device__ __forceinline__ void stash(float (*s)[LDS], const float r[4]) {
  const int tid = threadIdx.x;
  if constexpr (Op::kKContig) {
    const int i = tid / 2, k = (tid % 2) * 4;
#pragma unroll
    for (int j = 0; j < 4; ++j) s[k + j][i] = r[j];
  } else {
    const int k = tid / 32, i = (tid % 32) * 4;
    *reinterpret_cast<f4*>(&s[k][i]) = f4{r[0], r[1], r[2], r[3]};
  }
}

// Tile-local row (or column) of this thread's v-th output, v < 8.
__device__ __forceinline__ int out_idx(int t, int v) {
  return (v < 4 ? 0 : TM / 2) + t * 4 + (v & 3);
}

// acc[u][v] = sum over k ascending of A(m0 + out_idx(ty, u), k) *
// B(n0 + out_idx(tx, v), k), fmaf into float32 from +0; A's rows below
// M, B's columns below N and k below K (zeros elsewhere).
template <class OpA, class OpB>
__device__ void gemm_tile(const OpA& A, const OpB& B, int M, int N, int K,
                          int m0, int n0, float acc[8][8]) {
  __shared__ __align__(16) float As[2][TK][LDS];
  __shared__ __align__(16) float Bs[2][TK][LDS];
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
#pragma unroll
  for (int u = 0; u < 8; ++u)
#pragma unroll
    for (int v = 0; v < 8; ++v) acc[u][v] = 0.0f;
  const int nk = (K + TK - 1) / TK;
  float ra[4], rb[4];
  if (nk > 0) {
    fetch(A, m0, M, 0, K, ra);
    fetch(B, n0, N, 0, K, rb);
    stash<OpA>(As[0], ra);
    stash<OpB>(Bs[0], rb);
  }
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    const bool more = kt + 1 < nk;
    if (more) {   // the next stage's values, in flight during the products
      fetch(A, m0, M, (kt + 1) * TK, K, ra);
      fetch(B, n0, N, (kt + 1) * TK, K, rb);
    }
#pragma unroll
    for (int k = 0; k < TK; ++k) {
      const f4 a0 = *reinterpret_cast<const f4*>(&As[cur][k][ty * 4]);
      const f4 a1 = *reinterpret_cast<const f4*>(&As[cur][k][TM / 2 + ty * 4]);
      const f4 b0 = *reinterpret_cast<const f4*>(&Bs[cur][k][tx * 4]);
      const f4 b1 = *reinterpret_cast<const f4*>(&Bs[cur][k][TN / 2 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int u = 0; u < 8; ++u)
#pragma unroll
        for (int v = 0; v < 8; ++v) acc[u][v] = fmaf(a[u], b[v], acc[u][v]);
    }
    if (more) {   // the other stage was last read before the last barrier
      stash<OpA>(As[cur ^ 1], ra);
      stash<OpB>(Bs[cur ^ 1], rb);
    }
    __syncthreads();
  }
}

// The CTA's row tile of the per-expert slot products: blockIdx.x counts
// the row tiles of expert 0, then expert 1, ...; false past the last
// (the grid is an upper bound). Every thread computes it (no barrier
// before the exit).
__device__ bool row_tile(const int* __restrict__ indptr, int E, int* e,
                         int64_t* lo, int* m0, int* rows) {
  int t = blockIdx.x;
  for (int x = 0; x < E; ++x) {
    const int n = indptr[x + 1] - indptr[x];
    const int tiles = (n + TM - 1) / TM;
    if (t < tiles) {
      *e = x;
      *lo = indptr[x];
      *m0 = t * TM;
      *rows = n;
      return true;
    }
    t -= tiles;
  }
  return false;
}

// 1. g and h: [h | g] = x[tok[s]] . [wi[e] | wg[e]], N = 2F.
__global__ void __launch_bounds__(kThreads, 2) moe_bwd_up(
    const float* __restrict__ x, const float* __restrict__ wi,
    const float* __restrict__ wg, const int* __restrict__ indptr,
    const int* __restrict__ tok, float* __restrict__ gbuf,
    float* __restrict__ hbuf, int D, int F, int E) {
  int e, m0, rows;
  int64_t lo;
  if (!row_tile(indptr, E, &e, &lo, &m0, &rows)) return;
  const int64_t wsize = (int64_t)D * F;
  const int n0 = blockIdx.y * TN;
  float acc[8][8];
  gemm_tile(GatherRows{x, tok, lo, D},
            PairCols{wi + e * wsize, wg + e * wsize, F}, rows, 2 * F, D, m0,
            n0, acc);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    const int m = m0 + out_idx(ty, u);
    if (m >= rows) continue;
    const int64_t row = (lo + m) * (int64_t)F;
#pragma unroll
    for (int v = 0; v < 8; ++v) {
      const int n = n0 + out_idx(tx, v);
      if (n < F) {
        hbuf[row + n] = acc[u][v];
      } else if (n < 2 * F) {
        gbuf[row + n - F] = acc[u][v];
      }
    }
  }
}

// 2. v = dy[tok[s]] . wo[e]^T and the elementwise part: dg and dh over g
// and h, w a into abuf, a * v into pbuf.
__global__ void __launch_bounds__(kThreads, 2) moe_bwd_v(
    const float* __restrict__ dy, const float* __restrict__ wo,
    const int* __restrict__ indptr, const int* __restrict__ tok,
    const float* __restrict__ w, float* __restrict__ gbuf,
    float* __restrict__ hbuf, float* __restrict__ abuf,
    float* __restrict__ pbuf, int D, int F, int E) {
  int e, m0, rows;
  int64_t lo;
  if (!row_tile(indptr, E, &e, &lo, &m0, &rows)) return;
  const int n0 = blockIdx.y * TN;
  float acc[8][8];
  gemm_tile(GatherRows{dy, tok, lo, D}, Rows{wo + e * (int64_t)F * D, D},
            rows, F, D, m0, n0, acc);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    const int m = m0 + out_idx(ty, u);
    if (m >= rows) continue;
    const float ws = w[lo + m];
    const int64_t row = (lo + m) * (int64_t)F;
#pragma unroll
    for (int v = 0; v < 8; ++v) {
      const int n = n0 + out_idx(tx, v);
      if (n >= F) continue;
      const float g = gbuf[row + n], h = hbuf[row + n], vv = acc[u][v];
      const float sg = 1.0f / (1.0f + expf(-g));
      const float silu = g * sg;
      const float a = silu * h;
      const float da = ws * vv;
      pbuf[row + n] = a * vv;
      abuf[row + n] = ws * a;
      hbuf[row + n] = da * silu;
      gbuf[row + n] = da * h * (sg * (1.0f + g * (1.0f - sg)));
    }
  }
}

// 3. dx_s = [dh | dg] . [wi[e]^T ; wg[e]^T] (K = 2F) into dxs.
__global__ void __launch_bounds__(kThreads, 2) moe_bwd_dx(
    const float* __restrict__ hbuf, const float* __restrict__ gbuf,
    const float* __restrict__ wi, const float* __restrict__ wg,
    const int* __restrict__ indptr, float* __restrict__ dxs, int D, int F,
    int E) {
  int e, m0, rows;
  int64_t lo;
  if (!row_tile(indptr, E, &e, &lo, &m0, &rows)) return;
  const int64_t wsize = (int64_t)D * F;
  const int n0 = blockIdx.y * TN;
  float acc[8][8];
  gemm_tile(PairRows{hbuf, gbuf, lo, F},
            PairRows{wi + e * wsize, wg + e * wsize, 0, F}, rows, D, 2 * F,
            m0, n0, acc);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    const int m = m0 + out_idx(ty, u);
    if (m >= rows) continue;
    const int64_t row = (lo + m) * (int64_t)D;
#pragma unroll
    for (int v = 0; v < 8; ++v) {
      const int n = n0 + out_idx(tx, v);
      if (n < D) dxs[row + n] = acc[u][v];
    }
  }
}

// 4. The weight gradients of expert blockIdx.y: z = 0 dwi = x^T dh,
// 1 dwg = x^T dg (D x F), 2 dwo = (w a)^T dy (F x D); the depth is the
// expert's slots, ascending. blockIdx.x is the output tile.
__global__ void __launch_bounds__(kThreads, 2) moe_bwd_dweights(
    const float* __restrict__ x, const float* __restrict__ dy,
    const float* __restrict__ hbuf, const float* __restrict__ gbuf,
    const float* __restrict__ abuf, const int* __restrict__ indptr,
    const int* __restrict__ tok, float* __restrict__ dwi,
    float* __restrict__ dwg, float* __restrict__ dwo, int D, int F) {
  const int e = blockIdx.y, z = blockIdx.z;
  const int64_t lo = indptr[e];
  const int n_e = indptr[e + 1] - indptr[e];
  const int M = z == 2 ? F : D, N = z == 2 ? D : F;
  const int n_nt = (N + TN - 1) / TN;
  const int m0 = (blockIdx.x / n_nt) * TM, n0 = (blockIdx.x % n_nt) * TN;
  if (m0 >= M) return;
  float acc[8][8];
  float* out = (z == 0 ? dwi : z == 1 ? dwg : dwo) + e * (int64_t)D * F;
  if (z == 2) {
    gemm_tile(SlotCols{abuf, lo, F}, GatherCols{dy, tok, lo, D}, M, N, n_e,
              m0, n0, acc);
  } else {
    gemm_tile(GatherCols{x, tok, lo, D},
              SlotCols{z == 0 ? hbuf : gbuf, lo, F}, M, N, n_e, m0, n0, acc);
  }
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    const int m = m0 + out_idx(ty, u);
    if (m >= M) continue;
#pragma unroll
    for (int v = 0; v < 8; ++v) {
      const int n = n0 + out_idx(tx, v);
      if (n < N) out[(int64_t)m * N + n] = acc[u][v];
    }
  }
}

// 5. dx[t] = the left fold from +0, ascending slot order, of dxs over
// token t's slots; zeros for a token with none. One CTA a token.
__global__ void moe_bwd_combine(const float* __restrict__ dxs,
                                const int* __restrict__ tok_ptr,
                                const int* __restrict__ tok_slot,
                                float* __restrict__ dx, int D) {
  const int64_t t = blockIdx.x;
  const int lo = tok_ptr[t], hi = tok_ptr[t + 1];
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float acc = 0.0f;
    for (int i = lo; i < hi; ++i) {
      acc = __fadd_rn(acc, dxs[(int64_t)tok_slot[i] * D + d]);
    }
    dx[t * D + d] = acc;
  }
}

// 6. dw[s] = the left fold from +0 over f ascending of pbuf[s]. One
// thread a slot.
__global__ void moe_bwd_dw(const float* __restrict__ pbuf,
                           float* __restrict__ dw, int64_t n_slots, int F) {
  const int64_t s = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (s >= n_slots) return;
  const float* row = pbuf + s * F;
  float acc = 0.0f;
  for (int f = 0; f < F; ++f) acc = __fadd_rn(acc, row[f]);
  dw[s] = acc;
}

int launched() { return (int)cudaGetLastError(); }

}  // namespace

extern "C" {

// Launch the six kernels on `stream`. x, dy, dx (n_tokens, D); wi, wg,
// dwi, dwg (E, D, F); wo, dwo (E, F, D); indptr (E+1,); tok, w, tok_slot,
// dw (n_slots,); tok_ptr (n_tokens+1,); scratch gbuf, hbuf, abuf, pbuf
// (n_slots, F) and dxs (n_slots, D). Every output element is written.
// D, F >= 1. Returns the first launch's cudaGetLastError() code that is
// not 0, else 0.
int ich_moe_bwd_launch(const float* x, const float* dy, const float* wi,
                       const float* wg, const float* wo, const int* indptr,
                       const int* tok, const float* w, const int* tok_ptr,
                       const int* tok_slot, float* gbuf, float* hbuf,
                       float* abuf, float* pbuf, float* dxs, float* dx,
                       float* dwi, float* dwg, float* dwo, float* dw,
                       int n_tokens, int n_slots, int D, int F, int E,
                       void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  int err;
  if (n_slots > 0) {
    // an upper bound of sum_e ceil(n_e / TM): the CTAs past the last
    // row tile exit at once
    const unsigned row_tiles = (unsigned)((n_slots + TM - 1) / TM + E);
    const dim3 up(row_tiles, (unsigned)((2 * F + TN - 1) / TN));
    moe_bwd_up<<<up, kThreads, 0, st>>>(x, wi, wg, indptr, tok, gbuf, hbuf,
                                        D, F, E);
    if ((err = launched()) != 0) return err;
    const dim3 vg(row_tiles, (unsigned)((F + TN - 1) / TN));
    moe_bwd_v<<<vg, kThreads, 0, st>>>(dy, wo, indptr, tok, w, gbuf, hbuf,
                                       abuf, pbuf, D, F, E);
    if ((err = launched()) != 0) return err;
    const dim3 dg(row_tiles, (unsigned)((D + TN - 1) / TN));
    moe_bwd_dx<<<dg, kThreads, 0, st>>>(hbuf, gbuf, wi, wg, indptr, dxs, D,
                                        F, E);
    if ((err = launched()) != 0) return err;
  }
  if (E > 0) {
    const unsigned tiles = (unsigned)(((D + TM - 1) / TM) *
                                      ((F + TN - 1) / TN));
    const dim3 wgrid(tiles, (unsigned)E, 3);
    moe_bwd_dweights<<<wgrid, kThreads, 0, st>>>(x, dy, hbuf, gbuf, abuf,
                                                 indptr, tok, dwi, dwg, dwo,
                                                 D, F);
    if ((err = launched()) != 0) return err;
  }
  if (n_tokens > 0) {
    moe_bwd_combine<<<n_tokens, kCombineThreads, 0, st>>>(dxs, tok_ptr,
                                                          tok_slot, dx, D);
    if ((err = launched()) != 0) return err;
  }
  if (n_slots > 0) {
    const unsigned blocks = (unsigned)((n_slots + kFoldThreads - 1) /
                                       kFoldThreads);
    moe_bwd_dw<<<blocks, kFoldThreads, 0, st>>>(pbuf, dw, n_slots, F);
    if ((err = launched()) != 0) return err;
  }
  return 0;
}

}  // extern "C"
