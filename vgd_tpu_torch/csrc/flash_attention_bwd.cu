// Single-head FlashAttention-2 backward, f32, for Hopper (sm_90a), with the
// products on the tensor cores in three TF32 passes.
//
// Replaces the TPU kernels vgd_tpu/ops/pallas_kernels.py :
// _flash_bwd_dq_kernel and _flash_bwd_dkv_kernel (called through attention
// -> _flash_attention_diff -> _flash_diff_bwd), the backward of the DDPM
// UNet's attention in the train step. With the forward of
// flash_attention.cu (vgd_flash_attention_fwd_lse), which saves the row
// logsumexp lse, and delta_i = sum_d dO_id O_id (one elementwise pass in
// the wrapper, as the JAX package leaves it to XLA):
//
//   p_ij  = exp(s_ij - lse_i),   s_ij = scale * q_i . k_j
//   dp_ij = dO_i . v_j
//   ds_ij = p_ij (dp_ij - delta_i) scale
//   dq_i  = sum_j ds_ij k_j,   dk_j = sum_i ds_ij q_i,   dv_j = sum_i p_ij dO_i
//
// without materialising the N x M matrices in device memory.
//
// What bounds it on the H100. Inputs and outputs are f32 and the results
// must be f32-accurate, so every product runs as three TF32 tensor-core
// products (CUTLASS's "fast f32"): each operand x is split in registers
// into hi = tf32(x) (round to nearest) and lo = x - hi truncated to TF32,
// and a b ~ hi_a hi_b + hi_a lo_b + lo_a hi_b (the truncation and the
// dropped lo_a lo_b are below 2^-20 of |a b| each). dq does 6 B N M D
// operations (q.k, dO.v, ds.K) and dk/dv 8 B N M D (k.q, v.dO, p^T dO,
// ds^T q); three passes at the 495 TFLOP/s TF32 rate make that 0.35 ms for
// dq and 0.47 ms for dk/dv per 256x256, batch-16 UNet train step (B N M D =
// 9.66e9 over its three attentions). The cross-attentions (M = 64) also
// move q, dO and dq (268 MB each at cross_attn2), about 0.24 ms for dq at
// 3.35 TB/s, so there dq is close to its byte bound.
//
// The design (both kernels: 8 warps, mma.sync m16n8k8 TF32, f32 accumulate):
// * One operand is resident in shared memory for the block's life, the
//   other is streamed in tiles of 16 rows, double-buffered with cp.async so
//   the next tile's load overlaps this tile's products. dq: a 64-row q / dO
//   tile resident, K / V streamed. dk/dv: a 64-key K / V tile resident,
//   q / dO (and their lse / delta) streamed. Rows are padded to D + 4
//   floats, so every fragment load of a warp (8 rows x 4 columns) hits 32
//   distinct banks. 211 KB of dynamic shared memory at D = 256.
// * Fragments of the scores' operands come in with ldmatrix.x4 (one
//   instruction per 16 x 8 A fragment or per two 8 x 8 B fragments), and
//   the hi / lo split is integer and float arithmetic on the fast pipes
//   (ptxas expands cvt.rna.tf32.f32 into a longer compare-and-select
//   sequence that guards NaN and infinity).
// * The warps form 4 row groups (16 resident rows each) x 2 halves of D.
//   The scores s and dp (16 x 16 per warp) are contracted over the warp's
//   half of D and the two halves' partial sums are exchanged through shared
//   memory (a + b on both sides, so both warps hold the same bits); each
//   warp then accumulates its half of the D columns of dq (or dk and dv):
//   64 f32 accumulators per output at D = 256.
// * p and ds never leave registers. dq: S = Q K^T and dP = dO V^T, and dS
//   is the A operand of dQ += dS K. dk/dv: the transposed S^T = K Q^T and
//   dP^T = V dO^T (as FlashAttention-2 does), and P^T and dS^T are the A
//   operands of dV += P^T dO and dK += dS^T Q. The accumulator layout of
//   m16n8k8 gives a lane columns 2t and 2t + 1 of each 8-column tile, so
//   the A fragment's k index t stands for column 2t and t + 4 for 2t + 1,
//   and the B operand's rows are read in that same order: the contraction
//   runs over keys (q rows), and a consistent permutation of them is exact.
// * The 64-key cross-attentions give dk/dv one key block per image (16
//   blocks on 132 SMs): the wrapper splits the q rows so that the card
//   fills; each split writes its partial dk/dv to scratch and a second
//   small kernel sums the splits in a fixed order, so the result is
//   deterministic (no atomics anywhere).
// * Ragged N and M are masked in the kernels: rows past N (or past the
//   split) and keys past M load as zero (cp.async zero-fill) and get
//   p = ds = 0; nothing past N or M is stored.
//
// Plain C interface for ctypes. Each function launches on the given stream,
// does not synchronise and allocates nothing; it returns the CUDA error of
// its launches (cudaErrorInvalidValue for a shape it does not take).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kGroups = 4;                    // row groups of 16 resident rows
constexpr int kResident = 16 * kGroups;       // dq: q rows; dk/dv: keys
constexpr int kTile = 16;                     // streamed rows per tile
constexpr int kExchange = 16;                 // floats per lane: s and dp
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
__host__ __device__ constexpr int row_stride() { return D + 4; }

// resident rows (2 operands), two stages of streamed rows (2 operands),
// two stages of the streamed rows' lse and delta (dk/dv), the exchange
template <int D>
__host__ __device__ constexpr size_t smem_floats() {
  return 2 * size_t(kResident) * row_stride<D>() + 4 * size_t(kTile) * row_stride<D>() +
         4 * size_t(kTile) + size_t(kWarps) * 32 * kExchange;
}

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

// s[j] = A1 B1_j^T and dp[j] = A2 B2_j^T over the columns [c0, c0 + DH):
// A1, A2 are 16 rows, B1, B2 2 x 8 rows of shared tiles (row stride S). The
// result is 16 x 16 in the accumulator layout: lane (g, t) holds rows g and
// g + 8, columns 8j + 2t and 8j + 2t + 1. Per 8 columns one ldmatrix.x4
// loads each operand: an A fragment (blocks: rows 0-7 and 8-15 at columns
// +0, then at +4), or the B fragments of both j (rows 0-7 at +0 and +4,
// then rows 8-15).
template <int S, int DH>
__device__ __forceinline__ void scores(const float* a1, const float* a2, const float* b1,
                                       const float* b2, int c0, int lane,
                                       float (&s)[2][4], float (&dp)[2][4]) {
  const int blk = lane / 8, r = lane % 8;
  const int arow = (r + 8 * (blk & 1)) * S + c0 + 4 * (blk >> 1);
  const int brow = (r + 8 * (blk >> 1)) * S + c0 + 4 * (blk & 1);
  // s: one large and one small sum; dp: two alternating large sums
  float s_big[2][4] = {}, s_small[2][4] = {}, dp_big[2][2][4] = {}, dp_small[2][4] = {};
#pragma unroll
  for (int kk = 0; kk < DH; kk += 8) {
    const int alt = (kk / 8) & 1;
    uint32_t raw[4], xh[4], xl[4], yh[4], yl[4], bh[4], bl[4];
    ldsm4(a1 + arow + kk, raw);
    split4(raw, xh, xl);
    ldsm4(a2 + arow + kk, raw);
    split4(raw, yh, yl);
    ldsm4(b1 + brow + kk, raw);
    split4(raw, bh, bl);
    mma3_split(s_big[0], s_small[0], xh, xl, bh[0], bh[1], bl[0], bl[1]);
    mma3_split(s_big[1], s_small[1], xh, xl, bh[2], bh[3], bl[2], bl[3]);
    ldsm4(b2 + brow + kk, raw);
    split4(raw, bh, bl);
    mma3_split(dp_big[alt][0], dp_small[0], yh, yl, bh[0], bh[1], bl[0], bl[1]);
    mma3_split(dp_big[alt][1], dp_small[1], yh, yl, bh[2], bh[3], bl[2], bl[3]);
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[j][e] = s_big[j][e] + s_small[j][e];
      dp[j][e] = (dp_big[0][j][e] + dp_big[1][j][e]) + dp_small[j][e];
    }
  }
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

// s += the other half's partial s (a + b on both warps: the same bits)
__device__ __forceinline__ void exchange(float* xch, int warp, int lane, int group,
                                         float (&s)[2][4], float (&dp)[2][4]) {
  float* mine = xch + warp * kExchange * 32 + lane;
  const float* other = xch + (warp ^ kGroups) * kExchange * 32 + lane;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    mine[i * 32] = s[i / 4][i % 4];
    mine[(8 + i) * 32] = dp[i / 4][i % 4];
  }
  pair_barrier(group);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    s[i / 4][i % 4] += other[i * 32];
    dp[i / 4][i % 4] += other[(8 + i) * 32];
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    float* __restrict__ dq, int n, int m, float scale) {
  constexpr int S = row_stride<D>();
  constexpr int DH = D / 2;
  constexpr int NT = DH / 8;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* dos = qs + kResident * S;
  float* kv = dos + kResident * S;            // [stage][K, V][kTile][S]
  float* xch = kv + 4 * kTile * S + 4 * kTile;

  const int b = blockIdx.y;
  const int q0 = blockIdx.x * kResident;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int group = warp % kGroups, half = warp / kGroups;
  const size_t qoff = size_t(b) * n;
  const float* kb = k + size_t(b) * m * D;
  const float* vb = v + size_t(b) * m * D;
  const float scale_log2 = scale * kLog2e;

  load_rows<D, kResident>(qs, q + qoff * D, q0, n, tid);
  load_rows<D, kResident>(dos, dout + qoff * D, q0, n, tid);
  load_rows<D, kTile>(kv, kb, 0, m, tid);
  load_rows<D, kTile>(kv + kTile * S, vb, 0, m, tid);
  cp_async_commit();

  // rows past n have q = dO = 0, so ds = 0 whatever lse says; not stored
  float lse2[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + 16 * group + g + 8 * i;
    lse2[i] = row < n ? lse[qoff + row] * kLog2e : 0.f;
    dl[i] = row < n ? delta[qoff + row] : 0.f;
  }
  float acc[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;

  const float* qw = qs + 16 * group * S;
  const float* dow = dos + 16 * group * S;
  const int n_tiles = (m + kTile - 1) / kTile;
  for (int tt = 0; tt < n_tiles; ++tt) {
    if (tt + 1 < n_tiles) {
      float* next = kv + ((tt + 1) & 1) * 2 * kTile * S;
      load_rows<D, kTile>(next, kb, (tt + 1) * kTile, m, tid);
      load_rows<D, kTile>(next + kTile * S, vb, (tt + 1) * kTile, m, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* ks = kv + (tt & 1) * 2 * kTile * S;
    const float* vs = ks + kTile * S;

    float s[2][4], dp[2][4];
    scores<S, DH>(qw, dow, ks, vs, half * DH, lane, s, dp);
    exchange(xch, warp, lane, group, s, dp);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = tt * kTile + 8 * j + 2 * t + (e & 1);
        const float p = key < m ? exp2f(s[j][e] * scale_log2 - lse2[e / 2]) : 0.f;
        s[j][e] = p * (dp[j][e] - dl[e / 2]) * scale;   // ds
      }
    }
    product<S, NT>(s, ks, half * DH, g, t, acc);
    __syncthreads();                          // stage and exchange consumed
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + 16 * group + g + 8 * i;
    if (row < n) {
      float* dqrow = dq + (qoff + row) * D + half * DH + 2 * t;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        *reinterpret_cast<float2*>(dqrow + 8 * nt) =
            make_float2(acc[nt][2 * i], acc[nt][2 * i + 1]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     float* __restrict__ dk, float* __restrict__ dv, int n, int m,
                     int rows_per_split, float scale) {
  constexpr int S = row_stride<D>();
  constexpr int DH = D / 2;
  constexpr int NT = DH / 8;
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);
  float* vs = ks + kResident * S;
  float* qd = vs + kResident * S;             // [stage][q, dO][kTile][S]
  float* ld = qd + 4 * kTile * S;             // [stage][lse, delta][kTile]
  float* xch = ld + 4 * kTile;

  const int k0 = blockIdx.x * kResident;
  const int b = blockIdx.y;
  const int split_id = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int group = warp % kGroups, half = warp / kGroups;
  const size_t qoff = size_t(b) * n;
  const float* qb = q + qoff * D;
  const float* dob = dout + qoff * D;
  const float scale_log2 = scale * kLog2e;
  const int row_begin = split_id * rows_per_split;
  const int row_end = min(n, row_begin + rows_per_split);
  const int n_tiles = row_end > row_begin ? (row_end - row_begin + kTile - 1) / kTile : 0;

  // q rows [r0, r0 + kTile) with their lse and delta into stage `st`
  auto load_q_tile = [&](int st, int r0) {
    float* dst = qd + st * 2 * kTile * S;
    load_rows<D, kTile>(dst, qb, r0, row_end, tid);
    load_rows<D, kTile>(dst + kTile * S, dob, r0, row_end, tid);
    if (tid < 2 * kTile) {
      const int r = tid % kTile;
      const bool valid = r0 + r < row_end;
      const float* src = tid < kTile ? lse : delta;
      cp_async4(ld + st * 2 * kTile + tid, valid ? src + qoff + r0 + r : src, valid);
    }
  };

  load_rows<D, kResident>(ks, k + size_t(b) * m * D, k0, m, tid);
  load_rows<D, kResident>(vs, v + size_t(b) * m * D, k0, m, tid);
  if (n_tiles > 0) load_q_tile(0, row_begin);
  cp_async_commit();

  float dk_acc[NT][4], dv_acc[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) { dk_acc[nt][e] = 0.f; dv_acc[nt][e] = 0.f; }

  const float* kw = ks + 16 * group * S;
  const float* vw = vs + 16 * group * S;
  for (int tt = 0; tt < n_tiles; ++tt) {
    const int r0 = row_begin + tt * kTile;
    if (tt + 1 < n_tiles) {
      load_q_tile((tt + 1) & 1, r0 + kTile);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* qs = qd + (tt & 1) * 2 * kTile * S;
    const float* dos = qs + kTile * S;
    const float* ls = ld + (tt & 1) * 2 * kTile;
    const float* dls = ls + kTile;

    // s^T and dp^T: rows are this group's keys, columns the tile's q rows
    float s[2][4], dp[2][4];
    scores<S, DH>(kw, vw, qs, dos, half * DH, lane, s, dp);
    exchange(xch, warp, lane, group, s, dp);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = 8 * j + 2 * t + (e & 1);
        const float p =
            r0 + r < row_end ? exp2f(s[j][e] * scale_log2 - ls[r] * kLog2e) : 0.f;
        s[j][e] = p;
        dp[j][e] = p * (dp[j][e] - dls[r]) * scale;      // ds
      }
    }
    product<S, NT>(s, dos, half * DH, g, t, dv_acc);
    product<S, NT>(dp, qs, half * DH, g, t, dk_acc);
    __syncthreads();                          // stage and exchange consumed
  }
  cp_async_wait<0>();                         // an empty split's K / V load

  // this split's dk/dv rows: (split, b, key, :) of a (splits, B, M, D) array
  const size_t base = (size_t(split_id) * gridDim.y + b) * m;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = k0 + 16 * group + g + 8 * i;
    if (key < m) {
      const size_t off = (base + key) * D + half * DH + 2 * t;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        *reinterpret_cast<float2*>(dk + off + 8 * nt) =
            make_float2(dk_acc[nt][2 * i], dk_acc[nt][2 * i + 1]);
        *reinterpret_cast<float2*>(dv + off + 8 * nt) =
            make_float2(dv_acc[nt][2 * i], dv_acc[nt][2 * i + 1]);
      }
    }
  }
}

// out[i] = sum over s of part[s][i], s in order: float4 elements, count4 per split
__global__ void sum_splits_kernel(const float4* __restrict__ part, float4* __restrict__ out,
                                  size_t count4, int splits) {
  for (size_t i = size_t(blockIdx.x) * blockDim.x + threadIdx.x; i < count4;
       i += size_t(gridDim.x) * blockDim.x) {
    float4 acc = part[i];
    for (int s = 1; s < splits; ++s) {
      const float4 x = part[size_t(s) * count4 + i];
      acc.x += x.x; acc.y += x.y; acc.z += x.z; acc.w += x.w;
    }
    out[i] = acc;
  }
}

cudaError_t sum_splits(const float* part, float* out, size_t count, int splits,
                       cudaStream_t stream) {
  const size_t count4 = count / 4;
  const int blocks = static_cast<int>(count4 / 256 + 1 < 4096 ? count4 / 256 + 1 : 4096);
  sum_splits_kernel<<<blocks, 256, 0, stream>>>(reinterpret_cast<const float4*>(part),
                                                reinterpret_cast<float4*>(out), count4, splits);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq(const float* q, const float* k, const float* v, const float* dout,
                      const float* lse, const float* delta, float* dq, int b, int n, int m,
                      float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((n + kResident - 1) / kResident, b);
  flash_bwd_dq_kernel<D><<<grid, kThreads, smem, stream>>>(q, k, v, dout, lse, delta, dq, n,
                                                           m, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const float* q, const float* k, const float* v, const float* dout,
                       const float* lse, const float* delta, float* dk, float* dv,
                       float* scratch, int b, int n, int m, int splits, int rows_per_split,
                       float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const size_t count = size_t(b) * m * D;
  float* dk_part = splits == 1 ? dk : scratch;
  float* dv_part = splits == 1 ? dv : scratch + size_t(splits) * count;
  const dim3 grid((m + kResident - 1) / kResident, b, splits);
  flash_bwd_dkv_kernel<D><<<grid, kThreads, smem, stream>>>(
      q, k, v, dout, lse, delta, dk_part, dv_part, n, m, rows_per_split, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  err = sum_splits(dk_part, dk, count, splits, stream);
  if (err != cudaSuccess) return err;
  return sum_splits(dv_part, dv, count, splits, stream);
}

}  // namespace

// dq (B, N, D) from q (B, N, D), k/v (B, M, D), dO (B, N, D), lse and
// delta (B, N).
extern "C" int vgd_flash_attention_bwd_dq(const float* q, const float* k, const float* v,
                                          const float* dout, const float* lse,
                                          const float* delta, float* dq, int b, int n, int m,
                                          int d, float scale, void* stream) {
  if (b <= 0 || b > 65535 || n <= 0 || m <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64: return launch_dq<64>(q, k, v, dout, lse, delta, dq, b, n, m, scale, s);
    case 128: return launch_dq<128>(q, k, v, dout, lse, delta, dq, b, n, m, scale, s);
    case 256: return launch_dq<256>(q, k, v, dout, lse, delta, dq, b, n, m, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

// dk, dv (B, M, D). The q rows are cut into `splits` runs of
// `rows_per_split`; with splits > 1, `scratch` holds 2 * splits * B * M * D
// floats of partial sums, added up in split order into dk and dv.
extern "C" int vgd_flash_attention_bwd_dkv(const float* q, const float* k, const float* v,
                                           const float* dout, const float* lse,
                                           const float* delta, float* dk, float* dv,
                                           float* scratch, int b, int n, int m, int d,
                                           int splits, int rows_per_split, float scale,
                                           void* stream) {
  if (b <= 0 || b > 65535 || n <= 0 || m <= 0 || splits <= 0 || splits > 65535 ||
      rows_per_split <= 0 || static_cast<long long>(splits) * rows_per_split < n ||
      (splits > 1 && scratch == nullptr))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64:
      return launch_dkv<64>(q, k, v, dout, lse, delta, dk, dv, scratch, b, n, m, splits,
                            rows_per_split, scale, s);
    case 128:
      return launch_dkv<128>(q, k, v, dout, lse, delta, dk, dv, scratch, b, n, m, splits,
                             rows_per_split, scale, s);
    case 256:
      return launch_dkv<256>(q, k, v, dout, lse, delta, dk, dv, scratch, b, n, m, splits,
                             rows_per_split, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" const char* vgd_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
