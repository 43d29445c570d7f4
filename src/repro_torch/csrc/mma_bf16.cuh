// Bfloat16 products on Hopper's tensor cores through mma.sync, with
// fragments loaded from shared memory by ldmatrix; used by
// flash_attention_bwd.cu, mamba_scan_bwd.cu and ich_moe_bwd.cu (which
// reads its fragments from float32 tiles and splits them itself).
//
// Fragments of mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32, with
// gid = lane / 4 and tig = lane % 4. Each 32-bit register of A and B holds
// two bfloat16 values that are neighbours along k, the lower one in its
// low half:
//   A (16 x 16): a0 = A[gid][2 tig, +1],     a1 = A[gid + 8][2 tig, +1],
//                a2 = A[gid][2 tig + 8, +9], a3 = A[gid + 8][2 tig + 8, +9]
//   B (16 x 8):  b0 = B[2 tig, +1][gid],     b1 = B[2 tig + 8, +9][gid]
//   C (16 x 8):  c0, c1 = C[gid][2 tig, +1], c2, c3 = C[gid + 8][2 tig, +1]
// So the float32 C fragments of two neighbouring n8 tiles (n 0-7 and
// 8-15), rounded to bfloat16 pairs, are the A fragment of the 16 x 16
// tile whose k runs over those n, as they stand: {c0c1, c2c3} of the
// first tile, then {c0c1, c2c3} of the second (FlashAttention-2's register
// reuse: a product's output feeds the next product with no trip through
// shared memory). `a_from_c` does that.
//
// ldmatrix.x4 loads four 8 x 8 matrices of 16-bit values; lane l gives the
// shared-memory address of row l % 8 of matrix l / 8 (16 contiguous
// bytes). Register m then holds matrix m's fragment: lane t has row t / 4,
// columns 2 (t % 4) and + 1; with .trans it has column t / 4, rows
// 2 (t % 4) and + 1. The three loaders below pick the rows so that the
// registers come out as A or B fragments:
//   load_a:   A (16 x 16) from a tile stored row-major (rows = M, k along
//             a row): rows r0 + l % 16, columns c0 + 8 (l / 16).
//   load_b:   B of two n8 tiles (n0..n0+15) from a tile stored with n as
//             its rows and k along a row (B = tile^T: K for q k^T).
//   load_bt:  B of two n8 tiles from a tile stored with k as its rows and
//             n along a row (.trans: dO for P^T dO, q for dS^T q).
//   load_at:  A (16 x 16) from a tile stored with k as its rows and m
//             along a row (.trans: q^T of the scan's q (x) dy sums).
// Tiles in shared memory have rows of dh + 8 bfloat16 values (36, 52 and
// 68 words for dh 64, 96, 128: 4, 20 and 4 mod 32), so the eight 16-byte
// row pieces of one matrix fall in eight distinct groups of four banks.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ich {

// c (16 x 8, float32) += a (16 x 16, bfloat16) . b (16 x 8, bfloat16)
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// A fragment of rows r0..r0+15, columns c0..c0+15 of a tile with rows of
// `stride` elements
__device__ __forceinline__ void load_a(uint32_t* a, const __nv_bfloat16* t,
                                       int stride, int r0, int c0,
                                       int lane) {
  ldsm_x4(a, t + (r0 + (lane & 15)) * stride + c0 + 8 * (lane >> 4));
}

// B fragments b[0] (n0..n0+7) and b[1] (n0+8..n0+15) of k0..k0+15 from a
// tile whose row n holds B[k][n] along k
__device__ __forceinline__ void load_b(uint32_t (*b)[2],
                                       const __nv_bfloat16* t, int stride,
                                       int n0, int k0, int lane) {
  uint32_t r[4];
  ldsm_x4(r, t + (n0 + (lane & 7) + 8 * (lane >> 4)) * stride + k0 +
                 8 * ((lane >> 3) & 1));
  b[0][0] = r[0];
  b[0][1] = r[1];
  b[1][0] = r[2];
  b[1][1] = r[3];
}

// The same from a tile whose row k holds B[k][n] along n
__device__ __forceinline__ void load_bt(uint32_t (*b)[2],
                                        const __nv_bfloat16* t, int stride,
                                        int k0, int n0, int lane) {
  uint32_t r[4];
  ldsm_x4_trans(r, t + (k0 + (lane & 7) + 8 * ((lane >> 3) & 1)) * stride +
                       n0 + 8 * (lane >> 4));
  b[0][0] = r[0];
  b[0][1] = r[1];
  b[1][0] = r[2];
  b[1][1] = r[3];
}

// two floats as a bfloat16 pair (rounded to nearest even), x in the low half
__device__ __forceinline__ uint32_t pack_bf16(float x, float y) {
  __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<uint32_t*>(&h);
}

// The A fragment (16 x 16, k over n 0..15) of the C fragments c0 (n 0-7)
// and c1 (n 8-15), rounded to bfloat16
__device__ __forceinline__ void a_from_c(uint32_t* a, const float* c0,
                                         const float* c1) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// A fragment of rows m0..m0+15, k0..k0+15 from a tile whose row k holds
// A[m][k] along m
__device__ __forceinline__ void load_at(uint32_t* a, const __nv_bfloat16* t,
                                        int stride, int k0, int m0,
                                        int lane) {
  ldsm_x4_trans(a, t + (k0 + (lane & 7) + 8 * (lane >> 4)) * stride + m0 +
                       8 * ((lane >> 3) & 1));
}

// the two bfloat16 values of an operand register, the low half first
__device__ __forceinline__ float2 unpack_bf16(uint32_t r) {
  return make_float2(__uint_as_float(r << 16),
                     __uint_as_float(r & 0xffff0000u));
}

// A float32 pair split in two bfloat16 pairs: hi = bf16(x), lo = bf16(x -
// hi), each rounded to nearest even. hi + lo carries ~16 bits of x where
// hi alone carries 8, so a product with an exact bfloat16 operand b runs
// as lo . b then hi . b into one float32 accumulator (2^-16 of a term, as
// against 2^-8 for hi alone).
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t* hi,
                                           uint32_t* lo) {
  *hi = pack_bf16(x, y);
  const float2 h = unpack_bf16(*hi);
  *lo = pack_bf16(__fsub_rn(x, h.x), __fsub_rn(y, h.y));
}

// a_from_c with the split: the hi and lo A fragments of c0 and c1
__device__ __forceinline__ void split_a_from_c(uint32_t* hi, uint32_t* lo,
                                               const float* c0,
                                               const float* c1) {
  split_bf16(c0[0], c0[1], &hi[0], &lo[0]);
  split_bf16(c0[2], c0[3], &hi[1], &lo[1]);
  split_bf16(c1[0], c1[1], &hi[2], &lo[2]);
  split_bf16(c1[2], c1[3], &hi[3], &lo[3]);
}

}  // namespace ich
