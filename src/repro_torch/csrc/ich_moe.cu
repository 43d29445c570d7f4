// iCh-scheduled MoE expert dispatch for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas kernel of src/repro/kernels/ich_moe/ich_moe.py:
//   * ich_moe_sharded (grid (p, S_B), _moe_sharded_body, with its (p, S_B)
//     step costs, its (p, E) expert costs and the host-side worker_reduce
//     of its (p, n_tokens, D) token accumulators)
// by five kernels launched in turn by ich_moe_sharded_launch:
// moe_named_kernel, the up product (moe_product<true, ...>), the down
// product (moe_product<false, ...>), moe_combine_kernel and
// moe_costs_kernel.
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
// every flat slot row x token tiles of BM x output-column tiles of BN, a
// grouped GEMM over the rows; rows the shard layout does not name, or
// token tiles past a row's count, exit at once. The shard layout still
// decides which rows run (moe_named_kernel marks them first) and how the
// cost streams are summed, and the parallelism does not depend on the
// number of blocks. The grid spans the flat rows (96 here), not the shard
// rows (p * S_B * B * R = 2,112, 96 % of them padding): each early-exit
// CTA holds its SM's 140 KB of shared memory while it starts and stops.
//
// Deterministic combine without float atomics. Tokens are not item-closed
// across workers (a token's K experts may lie on different shards), and
// the reference's private (p, n_tokens, D) accumulators would take
// 132 x 4,096 x 2,048 x 4 B = 4.43 GB at this width. Instead each slot's
// weighted output goes to its own row of a slot-indexed (n_slots, D)
// buffer (268 MB here) and moe_combine_kernel folds each token's slots in
// ascending slot order, from a token -> slots index built once at pack
// time. Every output element of the two products is the same sequence of
// tensor-core operations over ascending k whatever tile or row holds it
// (below), so y does not depend on p, B, W or the refine generation:
// sharded == sequential bit for bit.
//
// What bounds it. Operations: 6 * D * F per kept entry (three products),
// 32,658 entries at this width = 410.9 GFLOP. On the float32 CUDA cores
// (67 TFLOP/s) that is 6.13 ms; this kernel runs it on the tensor cores as
// three TF32 products (below), 3 x 410.9 GFLOP at 495 TFLOP/s = 2.49 ms.
// Bytes: 1.61 GB of float32 expert weights read once, x and y 33.5 MB
// each: ~0.5 ms. So it is bound by operations.
//
// What the design does about that: both products on the tensor cores
// (mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32) with the 3xTF32
// split, which carries ~22 bits of each operand into the products where
// one TF32 pass carries 11 (one pass errs near 1e-3 at this width and
// would break the kernel == plain bar of 1e-4). The tensor cores add each
// MMA into the float32 accumulator by truncation, not by rounding to
// nearest, so over the 768 MMAs of an up-product element at D = 2048 the
// error comes to ~1e-5 of each element's sum of |terms|: under the 1e-4
// bars against the plain version and against float64, above float32's
// own ~1e-7 (PERF.md).
//   * Split. A fragment is read from shared memory (which holds plain
//     float32) and split as hi = cvt.rna.tf32(v), lo = cvt.rna.tf32(v - hi)
//     for both operands; each k8 step runs lo*hi, hi*lo, then hi*hi into
//     the same float32 accumulator, always in that order (lo*lo, below
//     2^-22 of a term, is left out).
//   * Tiles. A CTA of 8 warps (4 along the tokens x 2 along the columns)
//     owns 128 tokens of one slot row x 128 stage columns: in the up
//     product 64 columns of wi and the same 64 of wg, so each thread holds
//     h and g of the same outputs and the silu(g) * h epilogue stays in
//     registers; in the down product 128 columns of wo, written as
//     acc * weight into ybuf. A warp owns 32 x 64 stage columns: 2 x 8
//     m16n8 accumulators, 64 floats a thread.
//   * Ring. kStages shared-memory stages of BK = 32 (an A tile of 128 x 32
//     and a B tile of 32 x 128, rows padded by 4 and 8 floats so the
//     fragment reads hit 32 distinct banks), filled by cp.async 16-byte
//     granules kStages - 1 k-steps ahead, one __syncthreads a k-step. In
//     the up product the A rows are gathered token rows x[cols[...]]
//     (their offsets computed once a CTA), in the down product contiguous
//     rows of abuf; B is a slice of the expert's row-major (D, F) or
//     (F, D) weight. Where D or F is not a multiple of 4 or a pointer is
//     not 16-byte aligned, the same ring is filled by 4-byte cp.async.
//     Outside the edges (k >= K, columns >= N, tokens past the row's len)
//     the copies fill zeros.
//   * Determinism. Every output element's sum is one fixed sequence: the
//     k-blocks ascending, in each the same three MMAs in the same order,
//     and no split-K; its row or column position in a tile does not change
//     it, so y is the same bits for every lowering, width and generation.
//   * Why mma.sync and not wgmma. PTX's wgmma takes .tf32 operands only
//     K-major in shared memory (its transpose flags are for 16-bit types),
//     while the expert weights are N-major (D, F) / (F, D) row-major
//     tensors handed in on every call; mma.sync fragments are read by the
//     threads in whatever layout the stage has. wgmma with TMA, and a
//     persistent grid, are for a later design.
// The (n_slots, F) intermediate `a` (134 MB here) goes through a device
// scratch buffer between the two products: at W = 512 one row's a is 2 MB,
// too large for shared memory. Token tiles of one (row, column tile) are
// launched next to each other so they share the weight slice in L2.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tf32.cuh"
#include "segmented.cuh"

namespace {

constexpr int BM = 128;   // slot-row tokens per CTA tile
constexpr int BN = 128;   // stage columns per CTA tile (up: 64 of wi + 64 of wg)
constexpr int BK = 32;    // reduction depth per shared-memory stage
constexpr int kStages = 4;
constexpr int kThreads = 256;           // 8 warps: 4 (tokens) x 2 (columns)
constexpr int AS = BK + 4;              // A stage row stride, floats
constexpr int BS = BN + 8;              // B stage row stride, floats
constexpr int kStageFloats = BM * AS + BK * BS;
constexpr int kSmem = kStages * kStageFloats * 4;   // 143,360 bytes
constexpr int kCombineThreads = 256;
constexpr int kCostThreads = 128;

static_assert((AS * 4) % 16 == 0 && (BS * 4) % 16 == 0 &&
                  (BM * AS * 4) % 16 == 0 && (kStageFloats * 4) % 16 == 0,
              "16-byte cp.async destinations");

// Which expert each flat slot row (t, r) of the (T_pad, R) layout runs:
// named[t * R + r] = rowid[q] for every shard row q (= s * R + r, s = w*S +
// j*B + b) that names tile blkid[s / B] * B + s % B with an expert; the
// rest keep the wrapper's -1. The partition is item-closed, so a flat row
// is named at most once.
__global__ void moe_named_kernel(const int* __restrict__ rowid,
                                 const int* __restrict__ blkid,
                                 int* __restrict__ named, int64_t rows, int R,
                                 int B, int E) {
  const int64_t q = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (q >= rows) return;
  const int e = rowid[q];
  if (e < 0 || e >= E) return;
  const int64_t s = q / R;
  named[((int64_t)blkid[s / B] * B + s % B) * R + q % R] = e;
}

// The slot row of flat row q: its expert, the CSR index of its first token
// and its token count. False for rows the shard layout does not name.
struct SlotRow {
  int e;
  int64_t flat;
  int64_t base;
  int len;
};

__device__ bool slot_row(const int* __restrict__ named,
                         const int* __restrict__ slot_base,
                         const int* __restrict__ slot_len, int64_t q,
                         SlotRow* out) {
  const int e = named[q];
  if (e < 0) return false;
  out->e = e;
  out->flat = q;
  out->base = slot_base[q];
  out->len = slot_len[q];
  return true;
}

// Decode this CTA's (flat row, token tile, column tile) from the 1-D grid:
// token tiles vary fastest, then column tiles, then rows.
__device__ __forceinline__ void cta_tile(int n_mt, int n_nt, int64_t* q,
                                         int* mt, int* nt) {
  const int64_t id = blockIdx.x;
  *mt = (int)(id % n_mt);
  *nt = (int)((id / n_mt) % n_nt);
  *q = id / ((int64_t)n_mt * n_nt);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// Copy 16 (kVec) or 4 bytes from src, or zeros when !ok (src unread).
template <bool kVec>
__device__ __forceinline__ void copy_or_zero(float* dst, const float* src,
                                             bool ok) {
  if constexpr (kVec) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "r"(ok ? 16 : 0)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "r"(ok ? 4 : 0)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

using ich::mma_tf32;
using ich::split_tf32;

// Stage column of the j-th n8 tile of warp column wn: the warp's 64 stage
// columns are [32 wn, 32 wn + 32) and [64 + 32 wn, 96 + 32 wn), so in the
// up product tile j < 4 (wi) and tile j + 4 (wg) hold the same output
// column.
__device__ __forceinline__ int tile_col(int wn, int j) {
  return (j < 4 ? 0 : BN / 2) + wn * 32 + (j & 3) * 8;
}

// One grouped product over a CTA tile of one slot row, on the tensor cores
// in 3xTF32.
//   kUp:  A rows = x[cols[...]] (K = D), B = wi[e] | wg[e] (N = F, 64
//         columns of each a CTA); abuf[slot, n] = silu(g) * h.
//   !kUp: A rows = abuf[slot] (K = F), B = wo[e] (N = D, 128 columns a
//         CTA); ybuf[slot, n] = acc * weight[slot].
// kVec: K and N are multiples of 4 and the pointers 16-byte aligned, so
// the stages fill by 16-byte granules; else by 4-byte ones.
template <bool kUp, bool kVec>
__global__ void __launch_bounds__(kThreads, 1) moe_product(
    const float* __restrict__ vals, const int* __restrict__ cols,
    const int* __restrict__ named, const int* __restrict__ slot_base,
    const int* __restrict__ slot_len, const float* __restrict__ a_src,
    const float* __restrict__ b0, const float* __restrict__ b1,
    float* __restrict__ out, int W, int K, int N, int n_mt, int n_nt) {
  int64_t q;
  int mt, nt;
  cta_tile(n_mt, n_nt, &q, &mt, &nt);
  SlotRow row;
  const int m0 = mt * BM;
  if (!slot_row(named, slot_base, slot_len, q, &row) || m0 >= row.len) {
    return;
  }
  extern __shared__ __align__(16) float stage_smem[];
  __shared__ int64_t a_off[BM];   // A row m's offset in a_src; -1: zeros
  const int tid = threadIdx.x;
  for (int m = tid; m < BM; m += kThreads) {
    const int tok = m0 + m;
    a_off[m] = tok >= row.len ? -1
               : kUp ? (int64_t)cols[row.flat * W + tok] * K
                     : (row.base + tok) * (int64_t)K;
  }
  const int64_t wsize = (int64_t)K * N;
  const float* bm0 = b0 + row.e * wsize;            // wi[e] or wo[e]
  const float* bm1 = kUp ? b1 + row.e * wsize : bm0;   // wg[e]
  const int n0 = nt * (kUp ? BN / 2 : BN);          // first output column
  __syncthreads();

  // Fill stage s with k-block kt: A (BM x BK) and B (BK x BN).
  auto load_stage = [&](int s, int kt) {
    float* As = stage_smem + s * kStageFloats;
    float* Bs = As + BM * AS;
    const int k0 = kt * BK;
    constexpr int g = kVec ? 4 : 1;        // floats a copy
    constexpr int a_per = BM * BK / g / kThreads;
    constexpr int b_per = BK * BN / g / kThreads;
#pragma unroll
    for (int i = 0; i < a_per; ++i) {
      const int idx = tid + i * kThreads;
      const int r = idx / (BK / g), c = (idx % (BK / g)) * g;
      const int64_t off = a_off[r];
      const bool ok = off >= 0 && k0 + c < K;
      copy_or_zero<kVec>(As + r * AS + c, ok ? a_src + off + k0 + c : a_src,
                         ok);
    }
#pragma unroll
    for (int i = 0; i < b_per; ++i) {
      const int idx = tid + i * kThreads;
      const int kr = idx / (BN / g), c = (idx % (BN / g)) * g;
      const float* mat = kUp && c >= BN / 2 ? bm1 : bm0;
      const int n = n0 + (kUp ? c % (BN / 2) : c);
      const bool ok = k0 + kr < K && n < N;
      copy_or_zero<kVec>(Bs + kr * BS + c,
                         ok ? mat + (int64_t)(k0 + kr) * N + n : mat, ok);
    }
  };

  const int warp = tid >> 5, lane = tid & 31;
  const int wm = warp & 3, wn = warp >> 2;
  const int gid = lane >> 2, tig = lane & 3;
  float acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[i][j][v] = 0.0f;

  const int nk = (K + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load_stage(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();   // stage kt is in; stage kt - 1 is free
    if (kt + kStages - 1 < nk) {
      load_stage((kt + kStages - 1) % kStages, kt + kStages - 1);
    }
    cp_async_commit();   // one group a k-step, empty ones included
    const float* As = stage_smem + (kt % kStages) * kStageFloats;
    const float* Bs = As + BM * AS;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 8) {
      uint32_t ah[2][4], al[2][4], bh[8][2], bl[8][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float* a = As + (wm * 32 + i * 16 + gid) * AS + kk + tig;
        split_tf32(a[0], &ah[i][0], &al[i][0]);
        split_tf32(a[8 * AS], &ah[i][1], &al[i][1]);
        split_tf32(a[4], &ah[i][2], &al[i][2]);
        split_tf32(a[8 * AS + 4], &ah[i][3], &al[i][3]);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float* b = Bs + (kk + tig) * BS + tile_col(wn, j) + gid;
        split_tf32(b[0], &bh[j][0], &bl[j][0]);
        split_tf32(b[4 * BS], &bh[j][1], &bl[j][1]);
      }
      // lo*hi, hi*lo, hi*hi on every accumulator, in that order
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) mma_tf32(acc[i][j], al[i], bh[j]);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) mma_tf32(acc[i][j], ah[i], bl[j]);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) mma_tf32(acc[i][j], ah[i], bh[j]);
    }
  }

  // acc[i][j][v]: token row wm*32 + i*16 + gid (+8 for v >= 2), stage
  // column tile_col(wn, j) + 2*tig (+1 for odd v)
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int tok = m0 + wm * 32 + i * 16 + gid + 8 * h;
      if (tok >= row.len) continue;
      const int64_t slot = row.base + tok;
      if constexpr (kUp) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
#pragma unroll
          for (int v = 0; v < 2; ++v) {
            const int n = n0 + tile_col(wn, j) + 2 * tig + v;
            const float hv = acc[i][j][2 * h + v];
            const float gv = acc[i][j + 4][2 * h + v];
            if (n < N) out[slot * N + n] = gv / (1.0f + expf(-gv)) * hv;
          }
        }
      } else {
        const float wt = vals[row.flat * W + tok];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int v = 0; v < 2; ++v) {
            const int n = n0 + tile_col(wn, j) + 2 * tig + v;
            if (n < N) out[slot * N + n] = acc[i][j][2 * h + v] * wt;
          }
        }
      }
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

// The products' arguments, shared by both launches.
struct Products {
  const float* vals;
  const int* cols;
  const int* named;
  const int* slot_base;
  const int* slot_len;
  int W, n_mt;
};

// Launch one product over n_flat rows x n_mt token tiles x n_nt column
// tiles, after raising its shared-memory limit; returns the first CUDA
// error code, else 0.
template <bool kUp, bool kVec>
int launch_product(const Products& pr, int64_t n_flat, int n_nt,
                   cudaStream_t st, const float* a_src, const float* b0,
                   const float* b1, float* out, int K, int N) {
  const int64_t ctas = n_flat * pr.n_mt * n_nt;
  if (ctas > INT32_MAX) return (int)cudaErrorInvalidConfiguration;
  auto kernel = moe_product<kUp, kVec>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<(unsigned)ctas, kThreads, kSmem, st>>>(
      pr.vals, pr.cols, pr.named, pr.slot_base, pr.slot_len, a_src, b0, b1,
      out, pr.W, K, N, pr.n_mt, n_nt);
  return launched();
}

// The up product into abuf, then the down product into ybuf.
template <bool kVec>
int launch_products(const Products& pr, int64_t n_flat, cudaStream_t st,
                    const float* x, const float* wi, const float* wg,
                    const float* wo, float* abuf, float* ybuf, int D,
                    int F) {
  const int err = launch_product<true, kVec>(
      pr, n_flat, (F + BN / 2 - 1) / (BN / 2), st, x, wi, wg, abuf, D, F);
  if (err != 0) return err;
  return launch_product<false, kVec>(pr, n_flat, (D + BN - 1) / BN, st, abuf,
                                     wo, wo, ybuf, F, D);
}

}  // namespace

extern "C" {

// Launch the five kernels on `stream`. named is (n_flat,) = (T_pad * R,)
// filled with -1, abuf (n_slots, F) scratch, ybuf a zeroed (n_slots, D)
// buffer, y (n_tokens, D) (every row is written); costs (p*S_B,) and
// ecosts (p*E,) or both null (then slot_cost is ignored). D, F >= 1.
// Returns the first launch's cudaGetLastError() code that is not 0, else
// 0.
int ich_moe_sharded_launch(const float* vals, const int* cols,
                           const int* rowid, const int* blkid,
                           const int* slot_base, const int* slot_len,
                           const int* tok_ptr, const int* tok_slot,
                           const float* slot_cost, const float* x,
                           const float* wi, const float* wg, const float* wo,
                           int* named, float* abuf, float* ybuf, float* y,
                           float* costs, float* ecosts, int p, int S_B, int B,
                           int R, int W, int n_tokens, int D, int F, int E,
                           int64_t n_flat, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int64_t rows = (int64_t)p * S_B * B * R;
  if (rows > 0 && W > 0 && n_flat > 0) {
    moe_named_kernel<<<(unsigned)((rows + 255) / 256), 256, 0, st>>>(
        rowid, blkid, named, rows, R, B, E);
    int err = launched();
    if (err != 0) return err;
    const Products pr{vals, cols, named, slot_base, slot_len, W,
                      (W + BM - 1) / BM};
    auto al = [](const void* ptr) { return (uintptr_t)ptr % 16 == 0; };
    const bool vec = D % 4 == 0 && F % 4 == 0 && al(x) && al(wi) &&
                     al(wg) && al(wo) && al(abuf);
    err = vec ? launch_products<true>(pr, n_flat, st, x, wi, wg, wo, abuf,
                                      ybuf, D, F)
              : launch_products<false>(pr, n_flat, st, x, wi, wg, wo, abuf,
                                       ybuf, D, F);
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
