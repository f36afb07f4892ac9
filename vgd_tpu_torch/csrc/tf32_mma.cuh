// The 3xTF32 tensor-core pieces of the f32 flash-attention kernels
// (flash_attention.cu, the forward; flash_attention_bwd.cu, dq and dk/dv),
// for Hopper (sm_90a): 8 warps as 4 row groups of 16 resident rows x 2
// halves of D, cp.async copies into rows padded to D + 4 floats, ldmatrix
// fragment loads, the integer hi / lo split, and mma.sync m16n8k8 TF32
// products with f32 accumulators (three passes: hi hi + hi lo + lo hi).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kGroups = 4;                    // row groups of 16 resident rows
constexpr int kResident = 16 * kGroups;       // dq: q rows; dk/dv: keys
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
__host__ __device__ constexpr int row_stride() { return D + 4; }

__device__ __forceinline__ uint32_t smem_ptr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zero-filled when !valid (nothing is read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_ptr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_ptr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// the two warps of row group `group` (ids 1-4; __syncthreads uses 0)
__device__ __forceinline__ void pair_barrier(int group) {
  asm volatile("bar.sync %0, 64;\n" ::"r"(1 + group));
}

// Rows [r0, r0 + R) of a row-major (rows, D) matrix into shared memory with
// row stride D + 4; rows at or past `limit` are zero-filled.
template <int D, int R>
__device__ __forceinline__ void load_rows(float* dst, const float* src, int r0, int limit,
                                          int tid) {
  constexpr int D4 = D / 4;
  for (int idx = tid; idx < R * D4; idx += kThreads) {
    const int r = idx / D4, c4 = idx % D4;
    const bool valid = r0 + r < limit;
    cp_async16(dst + r * row_stride<D>() + 4 * c4,
               valid ? src + size_t(r0 + r) * D + 4 * c4 : src, valid);
  }
}

// x ~ hi + lo: hi = x rounded to TF32 (to nearest, ties away from zero:
// cvt.rna.tf32.f32 for finite x, done in two integer operations, since
// ptxas expands the cvt into a longer sequence that guards NaN and
// infinity), lo = the exact rest x - hi truncated to TF32 (its low 13 bits
// cleared)
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) & 0xffffe000u;
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b in three TF32 products, the two small cross terms first
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ahi)[4],
                                     const uint32_t (&alo)[4], uint32_t bh0, uint32_t bh1,
                                     uint32_t bl0, uint32_t bl1) {
  mma(c, alo, bh0, bh1);
  mma(c, ahi, bl0, bl1);
  mma(c, ahi, bh0, bh1);
}

// big += hi hi and small += the two cross terms. The tensor core truncates
// each accumulation, so the scores keep their small terms apart, and dp its
// large ones in two alternating sums (fewer truncated additions into large
// values): dp - delta must cancel to f32 noise where a row's p is one key
__device__ __forceinline__ void mma3_split(float (&big)[4], float (&small)[4],
                                           const uint32_t (&ahi)[4], const uint32_t (&alo)[4],
                                           uint32_t bh0, uint32_t bh1, uint32_t bl0,
                                           uint32_t bl1) {
  mma(small, alo, bh0, bh1);
  mma(small, ahi, bl0, bl1);
  mma(big, ahi, bh0, bh1);
}

// Four 8 x 4 f32 blocks of a shared tile into registers with one
// ldmatrix.x4 (each block is an 8 x 8 b16 matrix): lane l gives the address
// of row l % 8 of block l / 8, and receives element (g, t) of each block,
// i.e. the TF32 fragment layout of mma.m16n8k8.
__device__ __forceinline__ void ldsm4(const float* p, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_ptr(p)));
}

__device__ __forceinline__ void split4(const uint32_t (&r)[4], uint32_t (&hi)[4],
                                       uint32_t (&lo)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) split(__uint_as_float(r[i]), hi[i], lo[i]);
}

// acc[n] += X B over B's columns c0 + 8n + [0, 8): X is 16 x 16 in the
// accumulator layout of `scores`, B 16 rows of a shared tile (row stride S)
// read in X's column order (k index t <-> row 8kc + 2t, t + 4 <-> 8kc + 2t + 1).
template <int S, int NT>
__device__ __forceinline__ void product(const float (&x)[2][4], const float* b, int c0,
                                        int g, int t, float (&acc)[NT][4]) {
#pragma unroll
  for (int kc = 0; kc < 2; ++kc) {
    uint32_t ah[4], al[4];
    split(x[kc][0], ah[0], al[0]);
    split(x[kc][2], ah[1], al[1]);
    split(x[kc][1], ah[2], al[2]);
    split(x[kc][3], ah[3], al[3]);
    const float* r0 = b + (8 * kc + 2 * t) * S + c0 + g;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      uint32_t bh0, bl0, bh1, bl1;
      split(r0[8 * nt], bh0, bl0);
      split(r0[S + 8 * nt], bh1, bl1);
      mma3(acc[nt], ah, al, bh0, bh1, bl0, bl1);
    }
  }
}

}  // namespace
