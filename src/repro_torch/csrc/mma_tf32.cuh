// Float32 products on Hopper's tensor cores in the 3xTF32 split, shared by
// ich_moe.cu, flash_attention.cu and mamba_scan.cu.
//
// A float32 operand v is split into two TF32 parts, hi = cvt.rna(v) and
// lo = cvt.rna(v - hi), which together carry ~22 bits of v where one TF32
// value carries 11. A product a . b then runs as three TF32 MMAs into one
// float32 accumulator, always in the order lo*hi, hi*lo, hi*hi (lo*lo,
// below 2^-22 of a term, is left out). The tensor cores add each MMA into
// the accumulator by truncation, not by rounding to nearest, so the error
// grows with the number of MMAs summed into one accumulator: callers that
// sum long reductions add short partial sums into a float32 accumulator
// themselves.
//
// Fragments of mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32, with
// gid = lane / 4 and tig = lane % 4:
//   A (16 x 8): a0 = A[gid][tig], a1 = A[gid + 8][tig],
//               a2 = A[gid][tig + 4], a3 = A[gid + 8][tig + 4]
//   B (8 x 8):  b0 = B[tig][gid], b1 = B[tig + 4][gid]
//   C (16 x 8): c0 = C[gid][2 tig], c1 = C[gid][2 tig + 1],
//               c2 = C[gid + 8][2 tig], c3 = C[gid + 8][2 tig + 1]
// The reduction index k of one MMA may stand for any 8 indices of the
// operands, as long as A and B agree. Flash attention and the scan let
// k-slot tig stand for index 2 tig and k-slot tig + 4 for 2 tig + 1: then a
// C fragment (a row of scores) is an A fragment as it stands, and an A
// row read from shared memory is one 8-byte load.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace ich {

// v = hi + lo + (a remainder below 2^-22 |v|), hi and lo TF32, each
// rounded to nearest (ties away from zero) as cvt.rna does
__device__ __forceinline__ void split_tf32(float v, uint32_t* hi,
                                           uint32_t* lo) {
  uint32_t h, l;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(h) : "f"(v));
  const float rest = __fsub_rn(v, __uint_as_float(h));
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(l) : "f"(rest));
  *hi = h;
  *lo = l;
}

// v rounded to TF32 alone (one pass: an operand that is exact in TF32,
// such as a bfloat16 value, or a product that needs no more)
__device__ __forceinline__ uint32_t to_tf32(float v) {
  uint32_t h;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(h) : "f"(v));
  return h;
}

// c (16 x 8, float32) += a (16 x 8, TF32) . b (8 x 8, TF32)
__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// An A fragment split into its TF32 parts
struct FragA {
  uint32_t hi[4], lo[4];
  __device__ __forceinline__ void set(float a0, float a1, float a2,
                                      float a3) {
    split_tf32(a0, &hi[0], &lo[0]);
    split_tf32(a1, &hi[1], &lo[1]);
    split_tf32(a2, &hi[2], &lo[2]);
    split_tf32(a3, &hi[3], &lo[3]);
  }
};

// A B fragment split into its TF32 parts
struct FragB {
  uint32_t hi[2], lo[2];
  __device__ __forceinline__ void set(float b0, float b1) {
    split_tf32(b0, &hi[0], &lo[0]);
    split_tf32(b1, &hi[1], &lo[1]);
  }
};

// Fragments with the number of passes chosen at compile time: kSplit, the
// 3xTF32 split; else one TF32 pass (hi only), for operands exact in TF32
// or products that need no more.
template <bool kSplit>
__device__ __forceinline__ void set_a(FragA* f, float a0, float a1,
                                      float a2, float a3) {
  if constexpr (kSplit) {
    f->set(a0, a1, a2, a3);
  } else {
    f->hi[0] = to_tf32(a0);
    f->hi[1] = to_tf32(a1);
    f->hi[2] = to_tf32(a2);
    f->hi[3] = to_tf32(a3);
  }
}

template <bool kSplit>
__device__ __forceinline__ void set_b(FragB* f, float b0, float b1) {
  if constexpr (kSplit) {
    f->set(b0, b1);
  } else {
    f->hi[0] = to_tf32(b0);
    f->hi[1] = to_tf32(b1);
  }
}

// c[j] += a . b[j] for the G accumulators j < G in 3xTF32 (kSplit; else
// hi*hi alone), pass by pass: lo*hi on all of them, then hi*lo, then
// hi*hi. Each accumulator gets its three MMAs in that order, G MMAs apart,
// so the tensor pipe need not wait for one to finish before the next.
template <int G, bool kSplit = true>
__device__ __forceinline__ void mma_row(float (*c)[4], const FragA& a,
                                        const FragB* b) {
  if constexpr (kSplit) {
#pragma unroll
    for (int j = 0; j < G; ++j) mma_tf32(c[j], a.lo, b[j].hi);
#pragma unroll
    for (int j = 0; j < G; ++j) mma_tf32(c[j], a.hi, b[j].lo);
  }
#pragma unroll
  for (int j = 0; j < G; ++j) mma_tf32(c[j], a.hi, b[j].hi);
}

}  // namespace ich
