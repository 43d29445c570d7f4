// iCh-scheduled MoE expert dispatch for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas kernel of src/repro/kernels/ich_moe/ich_moe.py:
//   * ich_moe_sharded (grid (p, S_B), _moe_sharded_body, with its (p, S_B)
//     step costs, its (p, E) expert costs and the host-side worker_reduce
//     of its (p, n_tokens, D) token accumulators)
// by four kernels launched in turn by ich_moe_sharded_launch: moe_up_kernel,
// moe_down_kernel, moe_combine_kernel and moe_costs_kernel.
//
// What it computes. The payload is the flat (T_pad, R, W) pack of a
// dispatch plan's expert-major CSR: slot row (t, r) holds up to W kept
// (token, combine weight) entries of expert rowid (-1 = padding row). The
// schedule's shard layout (rowid (p*S, R), blkid (p*S_B,)) names the slot
// rows each worker runs. For every live slot of a named row, in token
// position m < len of its row (padding lanes are skipped by position,
// never by value),
//   a = silu(x[tok] . wg[e]) * (x[tok] . wi[e])        (F values)
//   ybuf[slot] = (a . wo[e]) * weight                   (D values)
// where `slot` = base + m is the entry's index in the plan's CSR. Then
//   y[t] = the left fold, slots in ascending order, of ybuf over token t's
//          slots (at most K: one per kept router choice)
// and, with slot_cost, costs[w, j] = the masked slot-cost fold of worker
// w's step j and ecosts[w, e] = the left fold in shard order of the slot
// costs of worker w's slots on expert e. Summed over workers, the expert
// costs are the plan's per-expert kept token counts, exactly (integers in
// float32).
//
// Why not one CTA per worker. At OLMoE-1B-7B width (E = 64, top-8,
// D = 2048, F = 1024, 4,096 tokens) the schedule has ~43 tiles of R = 2
// slot rows at W = 512, so 6 superstep blocks for p = 132 workers: one CTA
// per worker would leave ~126 SMs idle. The work is inside the rows: each
// is a (<=512 x 2048) . (2048 x 1024) product and back. So the grid covers
// every shard row x token tiles of BM x output-column tiles of BN, a
// grouped GEMM over the rows; rows that are padding, or token tiles past a
// row's count, exit at once. The shard layout still decides which rows
// exist and how the cost streams are summed, and the parallelism does not
// depend on the number of blocks.
//
// Deterministic combine without float atomics. Tokens are not item-closed
// across workers (a token's K experts may lie on different shards), and
// the reference's private (p, n_tokens, D) accumulators would take
// 132 x 4,096 x 2,048 x 4 B = 4.43 GB at this width. Instead each slot's
// weighted output goes to its own row of a slot-indexed (n_slots, D)
// buffer (268 MB here) and moe_combine_kernel folds each token's slots in
// ascending slot order, from a token -> slots index built once at pack
// time. Every output element of the two products is the same sequence of
// fmaf over ascending k whatever tile or row holds it, so y does not depend
// on p, B, W or the refine generation: sharded == sequential bit for bit.
//
// What bounds it. Operations: 6 * D * F per kept entry (three products),
// 32,658 entries at this width = 410.9 GFLOP, 6.13 ms at the card's
// 67 TFLOP/s float32 rate outside the tensor cores. Bytes: 1.61 GB of
// float32 expert weights read once, x and y 33.5 MB each: ~0.5 ms. So it
// is bound by operations.
//
// What this simple design does about that. Float32 FMA on the CUDA cores
// (TF32 would break the kernel == plain bar): 256-thread CTAs, each thread
// holding a 4 x 8 block of outputs (two of them, for wi and wg, in the up
// product), operands staged through shared memory BK = 16 deep, one
// stage at a time. The (n_slots, F) intermediate `a` (134 MB here) goes
// through a device scratch buffer between the two products: at W = 512 one
// row's a is 2 MB, too large for shared memory. Token tiles of one (row,
// column tile) are launched next to each other so they share the weight
// slice in L2. No cp.async/TMA pipelining and no tensor cores yet.

#include <cuda_runtime.h>
#include <stdint.h>

#include "segmented.cuh"

namespace {

constexpr int BM = 64;    // slot-row tokens per CTA tile
constexpr int BN = 128;   // output columns per CTA tile
constexpr int BK = 16;    // reduction depth per shared-memory stage
constexpr int TM = 4;     // outputs per thread along the tokens
constexpr int TN = 8;     // outputs per thread along the columns (2 x 4)
constexpr int kThreads = (BM / TM) * (BN / TN);   // 256
constexpr int kCombineThreads = 256;
constexpr int kCostThreads = 128;

// The slot row of flattened shard-row index q (= s * R + r, s = w*S +
// j*B + b): its expert, its flat row in the (T_pad, R) layout, the CSR
// index of its first token and its token count. False for padding rows.
struct SlotRow {
  int e;
  int64_t flat;
  int64_t base;
  int len;
};

__device__ bool slot_row(const int* __restrict__ rowid,
                         const int* __restrict__ blkid,
                         const int* __restrict__ slot_base,
                         const int* __restrict__ slot_len, int64_t q, int R,
                         int B, int E, SlotRow* out) {
  const int e = rowid[q];
  if (e < 0 || e >= E) return false;
  const int64_t s = q / R;
  const int64_t tile = (int64_t)blkid[s / B] * B + (s % B);
  out->e = e;
  out->flat = tile * R + (q % R);
  out->base = slot_base[out->flat];
  out->len = slot_len[out->flat];
  return true;
}

// Column of the j-th output of thread column group tx within a BN tile:
// two groups of four, 64 apart, so a warp's float4 shared reads do not
// conflict.
__device__ __forceinline__ int tile_col(int tx, int j) {
  return (j < 4 ? tx * 4 + j : BN / 2 + tx * 4 + (j - 4));
}

// Stage the (BK x BN) slice [k0, k0+BK) x [n0, n0+BN) of the row-major
// (K x N) matrix `b` into bs, zeros outside it.
__device__ __forceinline__ void load_b(const float* __restrict__ b, int K,
                                       int N, int k0, int n0,
                                       float (*bs)[BN]) {
  const int t = threadIdx.x;
  const int bk = t / (BN / 8), bn = (t % (BN / 8)) * 8;
  const int k = k0 + bk;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int n = n0 + bn + i;
    bs[bk][bn + i] = (k < K && n < N) ? b[(int64_t)k * N + n] : 0.0f;
  }
}

// Stage the (BM x BK) slice of the A operand, transposed into as[k][m]:
// row m is `a_row[m]` (null = a row past the slot row's count, zeros).
__device__ __forceinline__ void load_a(const float* const* a_row, int K,
                                       int k0, float (*as)[BM]) {
  const int t = threadIdx.x;
  const int am = t % BM, ak = (t / BM) * 4;
  const float* src = a_row[am];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = k0 + ak + i;
    as[ak + i][am] = (src != nullptr && k < K) ? src[k] : 0.0f;
  }
}

// Decode this CTA's (shard row, token tile, column tile) from the 1-D grid:
// token tiles vary fastest, then column tiles, then rows.
__device__ __forceinline__ void cta_tile(int n_mt, int n_nt, int64_t* q,
                                         int* m0, int* n0) {
  const int64_t id = blockIdx.x;
  *m0 = (int)(id % n_mt) * BM;
  *n0 = (int)((id / n_mt) % n_nt) * BN;
  *q = id / ((int64_t)n_mt * n_nt);
}

// a[slot, n] = silu(x[tok] . wg[e])[n] * (x[tok] . wi[e])[n] for the BM
// tokens x BN columns of this CTA's tile of one slot row.
__global__ void __launch_bounds__(kThreads) moe_up_kernel(
    const int* __restrict__ cols, const int* __restrict__ rowid,
    const int* __restrict__ blkid, const int* __restrict__ slot_base,
    const int* __restrict__ slot_len, const float* __restrict__ x,
    const float* __restrict__ wi, const float* __restrict__ wg,
    float* __restrict__ abuf, int R, int B, int W, int D, int F, int E,
    int n_mt, int n_nt) {
  int64_t q;
  int m0, n0;
  cta_tile(n_mt, n_nt, &q, &m0, &n0);
  SlotRow row;
  if (!slot_row(rowid, blkid, slot_base, slot_len, q, R, B, E, &row) ||
      m0 >= row.len) {
    return;
  }
  __shared__ const float* a_row[BM];
  __shared__ __align__(16) float as[BK][BM];
  __shared__ __align__(16) float bi[BK][BN];
  __shared__ __align__(16) float bg[BK][BN];
  for (int m = threadIdx.x; m < BM; m += blockDim.x) {
    a_row[m] = m0 + m < row.len
                   ? x + (int64_t)cols[row.flat * W + m0 + m] * D
                   : nullptr;
  }
  const float* wi_e = wi + (int64_t)row.e * D * F;
  const float* wg_e = wg + (int64_t)row.e * D * F;
  const int tx = threadIdx.x % (BN / TN), ty = threadIdx.x / (BN / TN);
  float h[TM][TN] = {}, g[TM][TN] = {};
  __syncthreads();
  for (int k0 = 0; k0 < D; k0 += BK) {
    load_a(a_row, D, k0, as);
    load_b(wi_e, D, F, k0, n0, bi);
    load_b(wg_e, D, F, k0, n0, bg);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(&as[kk][ty * TM]);
      const float a[TM] = {av.x, av.y, av.z, av.w};
      const float4 i0 = *reinterpret_cast<const float4*>(&bi[kk][tx * 4]);
      const float4 i1 =
          *reinterpret_cast<const float4*>(&bi[kk][BN / 2 + tx * 4]);
      const float4 g0 = *reinterpret_cast<const float4*>(&bg[kk][tx * 4]);
      const float4 g1 =
          *reinterpret_cast<const float4*>(&bg[kk][BN / 2 + tx * 4]);
      const float bvi[TN] = {i0.x, i0.y, i0.z, i0.w, i1.x, i1.y, i1.z, i1.w};
      const float bvg[TN] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
#pragma unroll
      for (int i = 0; i < TM; ++i) {
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          h[i][j] = fmaf(a[i], bvi[j], h[i][j]);
          g[i][j] = fmaf(a[i], bvg[j], g[i][j]);
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty * TM + i;
    if (m >= row.len) continue;
    float* out = abuf + (row.base + m) * F;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tile_col(tx, j);
      if (n < F) out[n] = g[i][j] / (1.0f + expf(-g[i][j])) * h[i][j];
    }
  }
}

// ybuf[slot, n] = (a[slot] . wo[e])[n] * weight[slot] for this CTA's tile.
__global__ void __launch_bounds__(kThreads) moe_down_kernel(
    const float* __restrict__ vals, const int* __restrict__ rowid,
    const int* __restrict__ blkid, const int* __restrict__ slot_base,
    const int* __restrict__ slot_len, const float* __restrict__ abuf,
    const float* __restrict__ wo, float* __restrict__ ybuf, int R, int B,
    int W, int D, int F, int E, int n_mt, int n_nt) {
  int64_t q;
  int m0, n0;
  cta_tile(n_mt, n_nt, &q, &m0, &n0);
  SlotRow row;
  if (!slot_row(rowid, blkid, slot_base, slot_len, q, R, B, E, &row) ||
      m0 >= row.len) {
    return;
  }
  __shared__ const float* a_row[BM];
  __shared__ __align__(16) float as[BK][BM];
  __shared__ __align__(16) float bo[BK][BN];
  for (int m = threadIdx.x; m < BM; m += blockDim.x) {
    a_row[m] = m0 + m < row.len ? abuf + (row.base + m0 + m) * F : nullptr;
  }
  const float* wo_e = wo + (int64_t)row.e * F * D;
  const int tx = threadIdx.x % (BN / TN), ty = threadIdx.x / (BN / TN);
  float acc[TM][TN] = {};
  __syncthreads();
  for (int k0 = 0; k0 < F; k0 += BK) {
    load_a(a_row, F, k0, as);
    load_b(wo_e, F, D, k0, n0, bo);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(&as[kk][ty * TM]);
      const float a[TM] = {av.x, av.y, av.z, av.w};
      const float4 o0 = *reinterpret_cast<const float4*>(&bo[kk][tx * 4]);
      const float4 o1 =
          *reinterpret_cast<const float4*>(&bo[kk][BN / 2 + tx * 4]);
      const float bv[TN] = {o0.x, o0.y, o0.z, o0.w, o1.x, o1.y, o1.z, o1.w};
#pragma unroll
      for (int i = 0; i < TM; ++i) {
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty * TM + i;
    if (m >= row.len) continue;
    const float wt = vals[row.flat * W + m];
    float* out = ybuf + (row.base + m) * D;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tile_col(tx, j);
      if (n < D) out[n] = acc[i][j] * wt;
    }
  }
}

// y[t] = the left fold, ascending slot order, of ybuf over token t's
// slots tok_slot[tok_ptr[t] .. tok_ptr[t+1]); a token with no kept entry
// gets zeros. One CTA per token.
__global__ void moe_combine_kernel(const float* __restrict__ ybuf,
                                   const int* __restrict__ tok_ptr,
                                   const int* __restrict__ tok_slot,
                                   float* __restrict__ y, int D) {
  const int64_t t = blockIdx.x;
  const int lo = tok_ptr[t], hi = tok_ptr[t + 1];
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float acc = 0.0f;
    for (int i = lo; i < hi; ++i) {
      acc = __fadd_rn(acc, ybuf[(int64_t)tok_slot[i] * D + d]);
    }
    y[t * D + d] = acc;
  }
}

// One CTA per worker w: its step costs (one thread per step) and its
// expert costs (thread 0 walks the worker's slots in shard order).
__global__ void moe_costs_kernel(const int* __restrict__ rowid,
                                 const int* __restrict__ blkid,
                                 const float* __restrict__ slot_cost,
                                 float* costs, float* ecosts, int S_B, int B,
                                 int R, int E) {
  const int64_t w = blockIdx.x;
  const int step_slots = B * R;
  for (int j = threadIdx.x; j < S_B; j += blockDim.x) {
    const int64_t step = w * S_B + j;
    costs[step] = ich::masked_cost(rowid + step * step_slots,
                                   slot_cost + blkid[step] * (int64_t)step_slots,
                                   step_slots);
  }
  float* ec = ecosts + w * E;
  for (int e = threadIdx.x; e < E; e += blockDim.x) ec[e] = 0.0f;
  __syncthreads();
  if (threadIdx.x != 0) return;
  for (int j = 0; j < S_B; ++j) {
    const int64_t step = w * S_B + j;
    const int* rows = rowid + step * step_slots;
    const float* sc = slot_cost + blkid[step] * (int64_t)step_slots;
    for (int k = 0; k < step_slots; ++k) {
      const int e = rows[k];
      if (e >= 0 && e < E) ec[e] = __fadd_rn(ec[e], sc[k]);
    }
  }
}

int launched() { return (int)cudaGetLastError(); }

}  // namespace

extern "C" {

// Launch the four kernels on `stream`. abuf is (n_slots, F) scratch, ybuf
// a zeroed (n_slots, D) buffer, y (n_tokens, D) (every row is written);
// costs (p*S_B,) and ecosts (p*E,) or both null (then slot_cost is
// ignored). D, F >= 1. Returns the first launch's cudaGetLastError() code
// that is not 0, else 0.
int ich_moe_sharded_launch(const float* vals, const int* cols,
                           const int* rowid, const int* blkid,
                           const int* slot_base, const int* slot_len,
                           const int* tok_ptr, const int* tok_slot,
                           const float* slot_cost, const float* x,
                           const float* wi, const float* wg, const float* wo,
                           float* abuf, float* ybuf, float* y, float* costs,
                           float* ecosts, int p, int S_B, int B, int R, int W,
                           int n_tokens, int D, int F, int E, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int64_t rows = (int64_t)p * S_B * B * R;
  const int n_mt = (W + BM - 1) / BM;
  if (rows > 0 && W > 0) {
    const int up_nt = (F + BN - 1) / BN;
    const int64_t up_ctas = rows * n_mt * up_nt;
    const int down_nt = (D + BN - 1) / BN;
    const int64_t down_ctas = rows * n_mt * down_nt;
    if (up_ctas > INT32_MAX || down_ctas > INT32_MAX) {
      return (int)cudaErrorInvalidConfiguration;
    }
    moe_up_kernel<<<(unsigned)up_ctas, kThreads, 0, st>>>(
        cols, rowid, blkid, slot_base, slot_len, x, wi, wg, abuf, R, B, W, D,
        F, E, n_mt, up_nt);
    int err = launched();
    if (err != 0) return err;
    moe_down_kernel<<<(unsigned)down_ctas, kThreads, 0, st>>>(
        vals, rowid, blkid, slot_base, slot_len, abuf, wo, ybuf, R, B, W, D,
        F, E, n_mt, down_nt);
    err = launched();
    if (err != 0) return err;
  }
  if (n_tokens > 0) {
    moe_combine_kernel<<<n_tokens, kCombineThreads, 0, st>>>(ybuf, tok_ptr,
                                                             tok_slot, y, D);
    const int err = launched();
    if (err != 0) return err;
  }
  if (costs != nullptr && p > 0) {
    moe_costs_kernel<<<p, kCostThreads, 0, st>>>(rowid, blkid, slot_cost,
                                                 costs, ecosts, S_B, B, R, E);
    return launched();
  }
  return 0;
}

}  // extern "C"
