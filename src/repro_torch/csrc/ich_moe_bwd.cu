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
// by five kernels, six launches in turn by ich_moe_bwd_launch:
//   1. moe_bwd_upv: a CTA takes 128 slots of one expert and 64 columns f.
//      It computes h, g (x rows against wi[e], wg[e]) and v (dy rows
//      against wo[e]^T), all with K = D, in registers, then the
//      elementwise part in its epilogue: it writes dh, dg and w a, and the
//      tile's partial sum of a * v for each slot. g and h never reach
//      device memory;
//   2. moe_bwd_dx: dx_s = [dh | dg] . [wi[e]^T ; wg[e]^T] (K = 2F);
//   3. moe_bwd_dweights<., ., 0>: dwi and dwg of each expert (a tile of
//      128 rows d and 64 columns f of each, x read once for both), and
//      <., ., 1>: dwo; the depth is the expert's slots in ascending order;
//   4. moe_bwd_combine: dx, the forward's combine over dx_s;
//   5. moe_bwd_dw: dw[s], the left fold of moe_bwd_upv's partials over the
//      column tiles in ascending order (one thread a slot, neighbouring
//      threads on neighbouring slots).
// Operations: 16 * D * F per kept slot (the two recomputed up products,
// v, the two dx products, three weight products). At OLMoE-1B-7B's
// training shape (8,192 tokens, top-8 of 64 experts, D = 2,048, F =
// 1,024; 60,573 kept slots under the record's capacity scales) that is
// 2.03 TFLOP. Bytes: the weights read once and their gradients written
// once (1.0 GB at that shape: 64 x 2,048 x 1,024 x 4 B x 6), x, dy and dx.
// So it is bound by operations: 12.3 ms as 3xTF32 (495 TFLOP/s / 3, the
// float32-level rate the port's other float32 kernels are held to), 6.2
// ms as the three bfloat16 passes below (989 TFLOP/s), 30.3 ms on the
// float32 CUDA cores (67 TFLOP/s).
//
// What the design does about that.
//   * Every product runs on the tensor cores: mma.sync m16n8k16 bfloat16
//     with a float32 accumulator. Each float32 operand is split as hi =
//     bf16(v) and lo = bf16(v - hi), in registers as a fragment is read
//     from the float32 stage; every 16-deep step runs lo.hi, hi.lo, hi.hi
//     into one accumulator, always in that order (lo.lo, below 2^-16 of a
//     term, is left out). That keeps ~16 bits of each operand: ~9e-6 of
//     an output's max at D 512, F 256 and 1,600 slots an expert
//     (tests/_moe_bwd_split.py; one pass alone, ~5e-3), under the 1e-4
//     bar with room for the tensor cores' truncating accumulation. It
//     costs half of 3xTF32's time, as bfloat16 runs at twice TF32's rate.
//     Splitting each value once instead, when its stage lands, into hi and
//     lo planes that ldmatrix reads, gave the same bits 11 % slower at the
//     record's shape (one more pass over shared memory; PERF.md).
//   * bfloat16 x and dy (`exact`): in bfloat16 training x and dy are
//     bfloat16 values cast to float32, so their lo parts are zeros. Then
//     the passes that multiply them are left out (they add exact zeros):
//     the up products, v, dwi, dwg and dwo run two passes, dx three.
//   * Operands through cp.async rings: every kernel fills kStages shared-
//     memory stages of depth BK = 32 by 16-byte cp.async granules,
//     kStages - 1 steps ahead, one __syncthreads a step. Where D or F is
//     not a multiple of 4 or a pointer is not 16-byte aligned the same
//     rings are filled by 4-byte cp.async (kVec false). Outside the edges
//     (slots past the expert's, columns past N, depth past K) the copies
//     fill zeros. The gathered rows' offsets (x[tok[s]], dy[tok[s]]) are
//     computed once a CTA in moe_bwd_upv; in moe_bwd_dweights, where the
//     gathered rows are the depth, each thread loads its stage row's token
//     one step before the copies that need it.
//   * Stage layouts. An operand that is contiguous along the depth is
//     staged with its rows along m (or n) and rows of BK + 8 = 40 floats;
//     one that is contiguous along m (or n) with rows along the depth, of
//     128 + 4 = 132 floats. A fragment
//     reads two neighbours along k: a float2 from a 40-float row (rows
//     gid, 2 tig: banks 8 gid + 2 tig, distinct over a half-warp's 64-bit
//     phase) or two floats from rows 2 tig and 2 tig + 1 of a 132-float
//     tile (banks 8 tig + gid: distinct over the warp).
//   * Tiles: 8 warps, 4 along the rows x 2 along the columns; a warp owns
//     32 rows (two m16 fragments) and 64 stage columns (eight n8). In
//     moe_bwd_upv those are 32 of wi and the same 32 of wg (h and g of the
//     same outputs in one thread) plus 32 of wo^T: 96 accumulators a
//     thread. 1 CTA an SM.
//   * No float atomics. Every output element has one owner thread and one
//     sum over ascending depth. The weight gradients reduce over an
//     expert's slots, contiguous in the CSR, in ascending slot order with
//     no split over the slots (each expert already gives 384 tiles); an
//     expert with no kept slot runs no step and writes exact zeros. dx_s
//     goes to its own row of a slot-indexed buffer and moe_bwd_combine
//     folds a token's rows in ascending slot order: a token's K slots may
//     lie on different experts. dw's partials are summed in a fixed order
//     inside a tile (each thread's columns ascending, then the four
//     threads of a quad by xor shuffles, then the two warp columns) and
//     over the tiles in ascending order.
//   * Deterministic and independent of the lowering. The kernels read the
//     plan's CSR and the token -> slots index, never the schedule's tiles
//     or shards, and every sum has one fixed order: two calls give the
//     same bits, and so do p, B, W and the refine generation.
// Scratch (the wrapper's): dh, dg and w a (n_slots, F) each, dx_s
// (n_slots, D) and dw's partials (ceil(F / 64), n_slots): 1.244 GB at the
// shape above, where the CUDA-core design's g, h, w a, a * v and dx_s took
// 1.489 GB.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"
#include "mma_bf16.cuh"

namespace {

constexpr int kThreads = 256;   // 8 warps: 4 along the rows x 2 across
constexpr int BM = 128;         // rows of a CTA tile
constexpr int BN = 128;         // stage columns of a CTA tile
constexpr int BK = 32;          // depth of a ring stage
constexpr int KS = BK + 8;      // row of a depth-contiguous stage tile, floats
constexpr int MS = BN + 4;      // row of a depth-major stage tile, floats
constexpr int UF = 64;          // moe_bwd_upv's columns f a CTA
constexpr int kStagesUpv = 3;
constexpr int kStages = 4;
constexpr int kUpvStage = 2 * BM * KS + BK * MS + UF * KS;   // floats
constexpr int kDxStage = 2 * BM * KS;
constexpr int kDwStage = 2 * BK * MS;
constexpr int kCombineThreads = 256;
constexpr int kFoldThreads = 256;

static_assert(KS % 32 == 8 && MS % 32 == 4, "bank-conflict-free fragments");
static_assert((KS * 4) % 16 == 0 && (MS * 4) % 16 == 0 &&
                  (BM * KS * 4) % 16 == 0 && (BK * MS * 4) % 16 == 0 &&
                  (kUpvStage * 4) % 16 == 0,
              "16-byte cp.async destinations");
static_assert(kStagesUpv * kUpvStage * 4 <= 220 * 1024 &&
                  kStages * kDxStage * 4 <= 220 * 1024 &&
                  kStages * kDwStage * 4 <= 220 * 1024,
              "rings fit an SM's shared memory beside the static arrays");

// Queue one copy of 16 bytes (kVec) or 4 from src, zeros when !ok.
template <bool kVec>
__device__ __forceinline__ void copy(float* dst, const float* src, bool ok) {
  if constexpr (kVec) {
    ich::cp16(dst, src, ok);
  } else {
    ich::cp4(dst, src, ok);
  }
}

// ------------------------------------------------------------ fragments
// The float32 pairs of an mma.sync m16n8k16 fragment (mma_bf16.cuh gives
// the register layout; gid = lane / 4, tig = lane % 4), read from a
// float32 stage tile with rows of `ld` floats.

// A (16 x 16) of rows r0.., depth k0.., from a tile whose row r holds A[r][.]
__device__ __forceinline__ void frag_a_rows(float2* f, const float* t, int ld,
                                            int r0, int k0, int lane) {
  const float* p = t + (r0 + (lane >> 2)) * ld + k0 + 2 * (lane & 3);
  f[0] = *reinterpret_cast<const float2*>(p);
  f[1] = *reinterpret_cast<const float2*>(p + 8 * ld);
  f[2] = *reinterpret_cast<const float2*>(p + 8);
  f[3] = *reinterpret_cast<const float2*>(p + 8 * ld + 8);
}

// A of rows m0.., depth k0.., from a tile whose row k holds A[.][k]
__device__ __forceinline__ void frag_a_cols(float2* f, const float* t, int ld,
                                            int m0, int k0, int lane) {
  const float* p = t + (k0 + 2 * (lane & 3)) * ld + m0 + (lane >> 2);
  f[0] = make_float2(p[0], p[ld]);
  f[1] = make_float2(p[8], p[ld + 8]);
  f[2] = make_float2(p[8 * ld], p[9 * ld]);
  f[3] = make_float2(p[8 * ld + 8], p[9 * ld + 8]);
}

// B (16 x 8) of columns n0.., depth k0.., from a tile whose row n holds
// B[.][n]
__device__ __forceinline__ void frag_b_rows(float2* f, const float* t, int ld,
                                            int n0, int k0, int lane) {
  const float* p = t + (n0 + (lane >> 2)) * ld + k0 + 2 * (lane & 3);
  f[0] = *reinterpret_cast<const float2*>(p);
  f[1] = *reinterpret_cast<const float2*>(p + 8);
}

// B of columns n0.., depth k0.., from a tile whose row k holds B[k][.]
__device__ __forceinline__ void frag_b_cols(float2* f, const float* t, int ld,
                                            int n0, int k0, int lane) {
  const float* p = t + (k0 + 2 * (lane & 3)) * ld + n0 + (lane >> 2);
  f[0] = make_float2(p[0], p[ld]);
  f[1] = make_float2(p[8 * ld], p[9 * ld]);
}

// A fragment's pairs as bfloat16 registers: hi and lo (split), or hi alone
// when the values are bfloat16 already (kExact: lo would be zeros).
template <int N, bool kExact>
__device__ __forceinline__ void split_frag(const float2* f, uint32_t* hi,
                                           uint32_t* lo) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if constexpr (kExact) {
      hi[i] = ich::pack_bf16(f[i].x, f[i].y);
    } else {
      ich::split_bf16(f[i].x, f[i].y, &hi[i], &lo[i]);
    }
  }
}

// acc[i][j] += A_i . B_j over one 16-deep step in the split passes, in
// their order: lo.hi (left out when A is exact), hi.lo (left out when B
// is exact), hi.hi.
template <int MI, int NJ, bool kAExact, bool kBExact>
__device__ __forceinline__ void mma_passes(float (&acc)[MI][NJ][4],
                                           const uint32_t (&ah)[MI][4],
                                           const uint32_t (&al)[MI][4],
                                           const uint32_t (&bh)[NJ][2],
                                           const uint32_t (&bl)[NJ][2]) {
  if constexpr (!kAExact) {
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) ich::mma_bf16(acc[i][j], al[i], bh[j]);
  }
  if constexpr (!kBExact) {
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) ich::mma_bf16(acc[i][j], ah[i], bl[j]);
  }
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) ich::mma_bf16(acc[i][j], ah[i], bh[j]);
}

template <int MI, int NJ>
__device__ __forceinline__ void zero(float (&acc)[MI][NJ][4]) {
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[i][j][v] = 0.0f;
}

// Stage column of warp column wn's j-th n8 tile: the warp's 64 columns are
// [32 wn, 32 wn + 32) and [64 + 32 wn, 96 + 32 wn), so with two matrices
// side by side (64 columns each) tiles j and j + 4 hold the same column.
__device__ __forceinline__ int tile_col(int wn, int j) {
  return (j < 4 ? 0 : BN / 2) + wn * 32 + (j & 3) * 8;
}

// The ring: stage kt of nk lands in slot kt % S, queued S - 1 steps ahead
// by load(slot, kt, pre), one commit group a step (empty ones included),
// one barrier a step; step(slot) runs the products. pre is prep(kt), a
// value each thread reads from global memory one step before its copies
// need it (its gathered row), so the read is in flight during a step.
template <int S, class Prep, class Load, class Step>
__device__ __forceinline__ void ring(int nk, Prep prep, Load load, Step step) {
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < nk) load(s, s, prep(s));
    ich::cp_commit();
  }
  auto pre = prep(S - 1);
  for (int kt = 0; kt < nk; ++kt) {
    ich::cp_wait<S - 2>();
    __syncthreads();   // stage kt is in; the slot of stage kt - 1 is free
    if (kt + S - 1 < nk) load((kt + S - 1) % S, kt + S - 1, pre);
    ich::cp_commit();
    pre = prep(kt + S);
    step(kt % S);
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
    const int tiles = (n + BM - 1) / BM;
    if (t < tiles) {
      *e = x;
      *lo = indptr[x];
      *m0 = t * BM;
      *rows = n;
      return true;
    }
    t -= tiles;
  }
  return false;
}

// 1. Slots lo + m0 .. (at most 128) of expert e against the columns f0 =
// 64 blockIdx.y ..: h, g, v (K = D), then dh, dg, w a into their buffers
// and the tile's partial sum of a * v into dwpart[blockIdx.y][slot].
template <bool kVec, bool kExact>
__global__ void __launch_bounds__(kThreads, 1) moe_bwd_upv(
    const float* __restrict__ x, const float* __restrict__ dy,
    const float* __restrict__ wi, const float* __restrict__ wg,
    const float* __restrict__ wo, const int* __restrict__ indptr,
    const int* __restrict__ tok, const float* __restrict__ w,
    float* __restrict__ dhbuf, float* __restrict__ dgbuf,
    float* __restrict__ wabuf, float* __restrict__ dwpart, int n_slots,
    int D, int F, int E) {
  int e, m0, rows;
  int64_t lo;
  if (!row_tile(indptr, E, &e, &lo, &m0, &rows)) return;
  extern __shared__ __align__(16) float smem[];
  __shared__ int64_t row_off[BM];    // x / dy row of tile row r; -1: none
  __shared__ float half_sum[2][BM];  // each warp column's part of dw
  const int tid = threadIdx.x;
  for (int r = tid; r < BM; r += kThreads) {
    row_off[r] = m0 + r < rows ? (int64_t)tok[lo + m0 + r] * D : -1;
  }
  const int f0 = blockIdx.y * UF;
  const int64_t wsize = (int64_t)D * F;
  const float* wie = wi + e * wsize;
  const float* wge = wg + e * wsize;
  const float* woe = wo + e * wsize;
  __syncthreads();

  // stage kt: x and dy rows (BM x BK), [wi | wg] columns f0.. (BK x 128),
  // wo rows f0.. (64 x BK)
  auto load = [&](int s, int kt, int) {
    float* Xs = smem + s * kUpvStage;
    float* Ds = Xs + BM * KS;
    float* Ws = Ds + BM * KS;
    float* Os = Ws + BK * MS;
    const int k0 = kt * BK;
    constexpr int g = kVec ? 4 : 1;
#pragma unroll
    for (int i = 0; i < BM * BK / g / kThreads; ++i) {
      const int idx = tid + i * kThreads;
      const int r = idx / (BK / g), c = (idx % (BK / g)) * g;
      const int64_t off = row_off[r];
      const bool ok = off >= 0 && k0 + c < D;
      copy<kVec>(Xs + r * KS + c, ok ? x + off + k0 + c : x, ok);
      copy<kVec>(Ds + r * KS + c, ok ? dy + off + k0 + c : dy, ok);
    }
#pragma unroll
    for (int i = 0; i < BK * BN / g / kThreads; ++i) {
      const int idx = tid + i * kThreads;
      const int kr = idx / (BN / g), c = (idx % (BN / g)) * g;
      const float* mat = c < UF ? wie : wge;
      const int f = f0 + (c & (UF - 1));
      const bool ok = k0 + kr < D && f < F;
      copy<kVec>(Ws + kr * MS + c, ok ? mat + (int64_t)(k0 + kr) * F + f : mat,
                 ok);
    }
#pragma unroll
    for (int i = 0; i < UF * BK / g / kThreads; ++i) {
      const int idx = tid + i * kThreads;
      const int r = idx / (BK / g), c = (idx % (BK / g)) * g;
      const bool ok = f0 + r < F && k0 + c < D;
      copy<kVec>(Os + r * KS + c,
                 ok ? woe + (int64_t)(f0 + r) * D + k0 + c : woe, ok);
    }
  };

  const int warp = tid >> 5, lane = tid & 31;
  const int wm = warp & 3, wn = warp >> 2;
  float hg[2][8][4];   // tiles j < 4: h, j >= 4: g of the same columns
  float vv[2][4][4];
  zero(hg);
  zero(vv);
  auto step = [&](int s) {
    const float* Xs = smem + s * kUpvStage;
    const float* Ds = Xs + BM * KS;
    const float* Ws = Ds + BM * KS;
    const float* Os = Ws + BK * MS;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t ah[2][4], al[2][4], bh[8][2], bl[8][2];
      float2 f[4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        frag_a_rows(f, Xs, KS, wm * 32 + i * 16, kk, lane);
        split_frag<4, kExact>(f, ah[i], al[i]);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        frag_b_cols(f, Ws, MS, tile_col(wn, j), kk, lane);
        split_frag<2, false>(f, bh[j], bl[j]);
      }
      mma_passes<2, 8, kExact, false>(hg, ah, al, bh, bl);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        frag_a_rows(f, Ds, KS, wm * 32 + i * 16, kk, lane);
        split_frag<4, kExact>(f, ah[i], al[i]);
      }
      uint32_t oh[4][2], ol[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        frag_b_rows(f, Os, KS, wn * 32 + j * 8, kk, lane);
        split_frag<2, false>(f, oh[j], ol[j]);
      }
      mma_passes<2, 4, kExact, false>(vv, ah, al, oh, ol);
    }
  };
  ring<kStagesUpv>((D + BK - 1) / BK, [](int) { return 0; }, load, step);

  // hg[i][j][v], vv[i][j][v]: tile row wm*32 + i*16 + gid (+8 for v >= 2),
  // column f0 + wn*32 + (j & 3)*8 + 2 tig (+1 for odd v)
  const int gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = wm * 32 + i * 16 + gid + 8 * hf;
      const bool live = m0 + r < rows;
      const int64_t slot = lo + m0 + r;
      const float ws = live ? w[slot] : 0.0f;
      float part = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int v = 0; v < 2; ++v) {
          const int f = f0 + wn * 32 + j * 8 + 2 * tig + v;
          const float h = hg[i][j][2 * hf + v], g = hg[i][j + 4][2 * hf + v];
          const float vg = vv[i][j][2 * hf + v];
          const float sg = 1.0f / (1.0f + expf(-g));
          const float silu = g * sg;
          const float a = silu * h;
          const float da = ws * vg;
          if (live && f < F) {
            const int64_t o = slot * F + f;
            dhbuf[o] = da * silu;
            dgbuf[o] = da * h * (sg * (1.0f + g * (1.0f - sg)));
            wabuf[o] = ws * a;
            part = __fadd_rn(part, a * vg);
          }
        }
      }
      // the quad's four parts, in a fixed order for every lane
      part = __fadd_rn(part, __shfl_xor_sync(0xffffffffu, part, 1));
      part = __fadd_rn(part, __shfl_xor_sync(0xffffffffu, part, 2));
      if (tig == 0) half_sum[wn][r] = part;
    }
  }
  __syncthreads();
  for (int r = tid; r < BM; r += kThreads) {
    if (m0 + r < rows) {
      dwpart[(int64_t)blockIdx.y * n_slots + lo + m0 + r] =
          __fadd_rn(half_sum[0][r], half_sum[1][r]);
    }
  }
}

// 2. dx_s = [dh | dg] . [wi[e]^T ; wg[e]^T] (K = 2F) into dxs, for the
// slots lo + m0 .. of expert e and the columns d0 = 128 blockIdx.y ...
template <bool kVec>
__global__ void __launch_bounds__(kThreads, 1) moe_bwd_dx(
    const float* __restrict__ dhbuf, const float* __restrict__ dgbuf,
    const float* __restrict__ wi, const float* __restrict__ wg,
    const int* __restrict__ indptr, float* __restrict__ dxs, int D, int F,
    int E) {
  int e, m0, rows;
  int64_t lo;
  if (!row_tile(indptr, E, &e, &lo, &m0, &rows)) return;
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int d0 = blockIdx.y * BN;
  const int64_t wsize = (int64_t)D * F;
  const float* wie = wi + e * wsize;
  const float* wge = wg + e * wsize;
  const int K = 2 * F;

  // stage kt: [dh | dg] rows (BM x BK), [wi | wg] rows d0.. (BN x BK); a
  // 16-byte granule never straddles k = F (F % 4 == 0 when kVec)
  auto load = [&](int s, int kt, int) {
    float* As = smem + s * kDxStage;
    float* Bs = As + BM * KS;
    const int k0 = kt * BK;
    constexpr int g = kVec ? 4 : 1;
#pragma unroll
    for (int i = 0; i < BM * BK / g / kThreads; ++i) {
      const int idx = tid + i * kThreads;
      const int r = idx / (BK / g), c = (idx % (BK / g)) * g;
      const int k = k0 + c;
      const bool ok = m0 + r < rows && k < K;
      const int64_t row = (lo + m0 + r) * F;
      copy<kVec>(As + r * KS + c,
                 !ok ? dhbuf : k < F ? dhbuf + row + k : dgbuf + row + k - F,
                 ok);
      const bool okb = d0 + r < D && k < K;
      const int64_t wrow = (int64_t)(d0 + r) * F;
      copy<kVec>(Bs + r * KS + c,
                 !okb ? wie : k < F ? wie + wrow + k : wge + wrow + k - F,
                 okb);
    }
  };

  const int warp = tid >> 5, lane = tid & 31;
  const int wm = warp & 3, wn = warp >> 2;
  float acc[2][8][4];
  zero(acc);
  auto step = [&](int s) {
    const float* As = smem + s * kDxStage;
    const float* Bs = As + BM * KS;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t ah[2][4], al[2][4], bh[8][2], bl[8][2];
      float2 f[4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        frag_a_rows(f, As, KS, wm * 32 + i * 16, kk, lane);
        split_frag<4, false>(f, ah[i], al[i]);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        frag_b_rows(f, Bs, KS, tile_col(wn, j), kk, lane);
        split_frag<2, false>(f, bh[j], bl[j]);
      }
      mma_passes<2, 8, false, false>(acc, ah, al, bh, bl);
    }
  };
  ring<kStages>((K + BK - 1) / BK, [](int) { return 0; }, load, step);

  const int gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int m = m0 + wm * 32 + i * 16 + gid + 8 * hf;
      if (m >= rows) continue;
      float* out = dxs + (lo + m) * D;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int v = 0; v < 2; ++v) {
          const int d = d0 + tile_col(wn, j) + 2 * tig + v;
          if (d < D) out[d] = acc[i][j][2 * hf + v];
        }
      }
    }
  }
}

// 3. The weight gradients of expert blockIdx.y, the depth its slots in
// ascending order. kRole 0: dwi = x^T dh and dwg = x^T dg, a tile of rows
// d0.. and the columns f0.. of each (A = x[tok[s]], B = dh | dg). kRole 1:
// dwo = (w a)^T dy, rows f0.., columns d0.. (A = w a, B = dy[tok[s]]).
// blockIdx.x is the output tile.
template <bool kVec, bool kExact, int kRole>
__global__ void __launch_bounds__(kThreads, 1) moe_bwd_dweights(
    const float* __restrict__ x, const float* __restrict__ dy,
    const float* __restrict__ dhbuf, const float* __restrict__ dgbuf,
    const float* __restrict__ wabuf, const int* __restrict__ indptr,
    const int* __restrict__ tok, float* __restrict__ dwi,
    float* __restrict__ dwg, float* __restrict__ dwo, int D, int F) {
  extern __shared__ __align__(16) float smem[];
  const int e = blockIdx.y;
  const int64_t lo = indptr[e];
  const int n_e = indptr[e + 1] - indptr[e];
  constexpr int NW = kRole == 0 ? BN / 2 : BN;   // output columns a tile
  const int M = kRole == 0 ? D : F, N = kRole == 0 ? F : D;
  const int n_nt = (N + NW - 1) / NW;
  const int m0 = (blockIdx.x / n_nt) * BM, n0 = (blockIdx.x % n_nt) * NW;
  const int tid = threadIdx.x;
  const int kr = tid >> 3;   // this thread's stage row (a slot)

  // this thread's gathered row of stage kt (x or dy: tok * D), -1 past the
  // expert's slots
  auto prep = [&](int kt) -> int64_t {
    const int k = kt * BK + kr;
    return k < n_e ? (int64_t)tok[lo + k] * D : -1;
  };
  // stage kt: the rows are slots lo + kt*BK .., A's columns m0.., B's n0..
  auto load = [&](int s, int kt, int64_t goff) {
    float* As = smem + s * kDwStage;
    float* Bs = As + BK * MS;
    const int64_t slot = lo + kt * BK + kr;
    const bool live = goff >= 0;
    constexpr int g = kVec ? 4 : 1;
#pragma unroll
    for (int i = 0; i < BN / g / 8; ++i) {
      const int c = ((tid & 7) + 8 * i) * g;
      if constexpr (kRole == 0) {
        const bool oka = live && m0 + c < D;
        copy<kVec>(As + kr * MS + c, oka ? x + goff + m0 + c : x, oka);
        const float* mat = c < NW ? dhbuf : dgbuf;
        const int f = n0 + (c & (NW - 1));
        const bool okb = live && f < F;
        copy<kVec>(Bs + kr * MS + c, okb ? mat + slot * F + f : mat, okb);
      } else {
        const bool oka = live && m0 + c < F;
        copy<kVec>(As + kr * MS + c, oka ? wabuf + slot * F + m0 + c : wabuf,
                   oka);
        const bool okb = live && n0 + c < D;
        copy<kVec>(Bs + kr * MS + c, okb ? dy + goff + n0 + c : dy, okb);
      }
    }
  };

  const int warp = tid >> 5, lane = tid & 31;
  const int wm = warp & 3, wn = warp >> 2;
  float acc[2][8][4];
  zero(acc);
  auto step = [&](int s) {
    const float* As = smem + s * kDwStage;
    const float* Bs = As + BK * MS;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t ah[2][4], al[2][4], bh[8][2], bl[8][2];
      float2 f[4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        frag_a_cols(f, As, MS, wm * 32 + i * 16, kk, lane);
        split_frag<4, kRole == 0 && kExact>(f, ah[i], al[i]);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        frag_b_cols(f, Bs, MS, tile_col(wn, j), kk, lane);
        split_frag<2, kRole == 1 && kExact>(f, bh[j], bl[j]);
      }
      mma_passes<2, 8, kRole == 0 && kExact, kRole == 1 && kExact>(acc, ah,
                                                                   al, bh, bl);
    }
  };
  ring<kStages>((n_e + BK - 1) / BK, prep, load, step);

  const int gid = lane >> 2, tig = lane & 3;
  const int64_t base = e * (int64_t)D * F;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int m = m0 + wm * 32 + i * 16 + gid + 8 * hf;
      if (m >= M) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int v = 0; v < 2; ++v) {
          const float val = acc[i][j][2 * hf + v];
          if constexpr (kRole == 0) {
            const int f = n0 + wn * 32 + (j & 3) * 8 + 2 * tig + v;
            if (f < F) (j < 4 ? dwi : dwg)[base + (int64_t)m * F + f] = val;
          } else {
            const int d = n0 + tile_col(wn, j) + 2 * tig + v;
            if (d < D) dwo[base + (int64_t)m * D + d] = val;
          }
        }
      }
    }
  }
}

// 4. dx[t] = the left fold from +0, ascending slot order, of dxs over
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

// 5. dw[s] = the left fold from +0 over the column tiles ascending of
// dwpart[ct][s]. One thread a slot.
__global__ void moe_bwd_dw(const float* __restrict__ dwpart,
                           float* __restrict__ dw, int n_slots, int n_ct) {
  const int64_t s = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (s >= n_slots) return;
  float acc = 0.0f;
  for (int ct = 0; ct < n_ct; ++ct) {
    acc = __fadd_rn(acc, dwpart[(int64_t)ct * n_slots + s]);
  }
  dw[s] = acc;
}

int launched() { return (int)cudaGetLastError(); }

// Launch `kernel` on grid x kThreads with `smem` bytes of dynamic shared
// memory (its limit raised first); the first CUDA error code, else 0.
template <class Kernel, class... Args>
int launch(Kernel kernel, dim3 grid, int smem, cudaStream_t st,
           Args... args) {
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, kThreads, smem, st>>>(args...);
  return launched();
}

// The three product kernels for one load path and one kind of x and dy.
template <bool kVec, bool kExact>
int launch_products(const float* x, const float* dy, const float* wi,
                    const float* wg, const float* wo, const int* indptr,
                    const int* tok, const float* w, float* dhbuf,
                    float* dgbuf, float* wabuf, float* dwpart, float* dxs,
                    float* dwi, float* dwg, float* dwo, int n_slots, int D,
                    int F, int E, cudaStream_t st) {
  int err;
  if (n_slots > 0) {
    // an upper bound of sum_e ceil(n_e / BM): the CTAs past the last row
    // tile exit at once
    const unsigned row_tiles = (unsigned)((n_slots + BM - 1) / BM + E);
    err = launch(moe_bwd_upv<kVec, kExact>,
                 dim3(row_tiles, (unsigned)((F + UF - 1) / UF)),
                 kStagesUpv * kUpvStage * 4, st, x, dy, wi, wg, wo, indptr,
                 tok, w, dhbuf, dgbuf, wabuf, dwpart, n_slots, D, F, E);
    if (err != 0) return err;
    err = launch(moe_bwd_dx<kVec>,
                 dim3(row_tiles, (unsigned)((D + BN - 1) / BN)),
                 kStages * kDxStage * 4, st, dhbuf, dgbuf, wi, wg, indptr,
                 dxs, D, F, E);
    if (err != 0) return err;
  }
  const int smem = kStages * kDwStage * 4;
  const unsigned in_tiles = (unsigned)(((D + BM - 1) / BM) *
                                       ((F + BN / 2 - 1) / (BN / 2)));
  err = launch(moe_bwd_dweights<kVec, kExact, 0>, dim3(in_tiles, E), smem,
               st, x, dy, dhbuf, dgbuf, wabuf, indptr, tok, dwi, dwg, dwo, D,
               F);
  if (err != 0) return err;
  const unsigned out_tiles = (unsigned)(((F + BM - 1) / BM) *
                                        ((D + BN - 1) / BN));
  return launch(moe_bwd_dweights<kVec, kExact, 1>, dim3(out_tiles, E), smem,
                st, x, dy, dhbuf, dgbuf, wabuf, indptr, tok, dwi, dwg, dwo,
                D, F);
}

}  // namespace

extern "C" {

// Launch the kernels on `stream`. x, dy, dx (n_tokens, D); wi, wg, dwi,
// dwg (E, D, F); wo, dwo (E, F, D); indptr (E+1,); tok, w, tok_slot, dw
// (n_slots,); tok_ptr (n_tokens+1,); scratch dhbuf, dgbuf, wabuf
// (n_slots, F), dwpart (ceil(F / 64), n_slots) and dxs (n_slots, D).
// exact != 0: every value of x and dy is a bfloat16 value (their split
// passes are left out). Every output element is written. D, F >= 1.
// Returns the first launch's cudaGetLastError() code that is not 0, else
// 0.
int ich_moe_bwd_launch(const float* x, const float* dy, const float* wi,
                       const float* wg, const float* wo, const int* indptr,
                       const int* tok, const float* w, const int* tok_ptr,
                       const int* tok_slot, float* dhbuf, float* dgbuf,
                       float* wabuf, float* dwpart, float* dxs, float* dx,
                       float* dwi, float* dwg, float* dwo, float* dw,
                       int n_tokens, int n_slots, int D, int F, int E,
                       int exact, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  int err;
  if (E > 0) {
    auto al = [](const void* p) { return (uintptr_t)p % 16 == 0; };
    const bool vec = D % 4 == 0 && F % 4 == 0 && al(x) && al(dy) &&
                     al(wi) && al(wg) && al(wo) && al(dhbuf) && al(dgbuf) &&
                     al(wabuf);
    auto go = [&](auto products) {
      return products(x, dy, wi, wg, wo, indptr, tok, w, dhbuf, dgbuf, wabuf,
                      dwpart, dxs, dwi, dwg, dwo, n_slots, D, F, E, st);
    };
    err = vec ? (exact ? go(launch_products<true, true>)
                       : go(launch_products<true, false>))
              : (exact ? go(launch_products<false, true>)
                       : go(launch_products<false, false>));
    if (err != 0) return err;
  }
  if (n_tokens > 0) {
    moe_bwd_combine<<<n_tokens, kCombineThreads, 0, st>>>(dxs, tok_ptr,
                                                          tok_slot, dx, D);
    if ((err = launched()) != 0) return err;
  }
  if (n_slots > 0) {
    const unsigned blocks = (unsigned)((n_slots + kFoldThreads - 1) /
                                       kFoldThreads);
    moe_bwd_dw<<<blocks, kFoldThreads, 0, st>>>(dwpart, dw, n_slots,
                                                (F + UF - 1) / UF);
    if ((err = launched()) != 0) return err;
  }
  return 0;
}

}  // extern "C"
