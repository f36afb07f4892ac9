// Single-head flash attention forward, f32, for Hopper (sm_90a), with the
// products on the tensor cores in three TF32 passes.
//
// Replaces two TPU kernels of vgd_tpu/ops/pallas_kernels.py:
// * _flash_kernel (called through flash_attention), which serves the DDPM
//   UNet on its inference paths: cross-attention from pixels to 64 global
//   tokens and the bottleneck self-attention (vgd_flash_attention_fwd);
// * _flash_fwd_lse_kernel (called through attention / _flash_fwd_lse), the
//   forward of the training path, which also writes the row logsumexp that
//   the backward kernels in flash_attention_bwd.cu read
//   (vgd_flash_attention_fwd_lse). Same loop; the logsumexp is one store
//   per row at the end.
// q (B, N, D), k/v (B, M, D), all f32 and contiguous; o = softmax(q k^T *
// scale) v, never materialising the N x M matrix in device memory.
//
// What bounds it on the H100. The model casts q/k/v to f32 (unet.py:123,155)
// and the reference semantics are f32, so every product runs as three TF32
// tensor-core products (hi hi + hi lo + lo hi, f32 accumulate; the split is
// in tf32_mma.cuh): 3 x 4 B N M D operations at 495 TFLOP/s. At 256x256,
// B = 16, D = 256 that is 17.2 GFLOP each for the 1024-token bottleneck and
// cross_attn2 (N = 16384, M = 64), 4.3 for cross_attn3 (N = 4096, M = 64):
// 0.235 ms a UNet forward by operations. The cross-attentions also move q
// and o, 537 MB at cross_attn2, 0.160 ms at 3.35 TB/s, so they sit near
// their byte bound and the bottleneck near its operation bound.
//
// The design (8 warps, mma.sync m16n8k8 TF32, f32 accumulate), the K2
// backward's dq loop with an online softmax in place of dP:
// * One block per (batch, 64-row q tile). The q tile stays in shared memory
//   for the block's life; K and V stream through in tiles of kKeys rows,
//   double-buffered with cp.async so the next tile's load overlaps this
//   tile's products. Rows are padded to D + 4 floats, so a warp's fragment
//   loads hit 32 distinct banks. 211 KB of dynamic shared memory at D = 256
//   (32-key tiles: half the barriers and exchanges a key of 16-key tiles,
//   which took longer).
// * The warps form 4 row groups (16 q rows each) x 2 halves of D. S = Q K^T
//   (16 x kKeys per warp) is contracted over the warp's half of D with
//   ldmatrix.x4 fragment loads, its hi hi products and its cross terms in
//   separate sums, and the two halves' partial sums are exchanged through
//   shared memory (a + b on both warps: both hold the same bits, so both run
//   the same softmax).
// * The online softmax runs in base 2 on the accumulator fragments: a lane
//   holds rows g and g + 8 at keys 8j + 2t, 8j + 2t + 1, so a row's max is
//   its lane's values and two shuffles over the row's 4 lanes. The running
//   sum stays a per-lane partial (rescaled by the same alpha) until the end.
// * O += P V: P never leaves registers; it is the A operand, its columns
//   read in the m16n8k8 accumulator order (k index t <-> key 2t, t + 4 <->
//   2t + 1) and V's rows in the same order. Each warp accumulates its half
//   of D: 64 f32 accumulators at D = 256.
// * At the end o = acc / sum is stored, and lse = (max + log2 sum) ln 2 where
//   the caller asked for it. No atomics: the result is bit-equal run to run.
// * Ragged N and M are masked: q rows past N and keys past M load as zero
//   (cp.async zero-fill), keys past M get a logit of -inf, and nothing past
//   N is stored. The first key of every tile is real, so the running max
//   stays finite.
//
// Plain C interface for ctypes. The function launches on the given stream,
// does not synchronise and allocates nothing; it returns the CUDA error of
// the launch (cudaErrorInvalidValue for a shape it does not take).

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "tf32_mma.cuh"

namespace {

constexpr int kKeys = 32;                     // keys per streamed K/V tile
constexpr int kJ = kKeys / 8;                 // n8 score fragments per warp
constexpr int kExchange = 4 * kJ;             // floats per lane: s

// the resident q tile, two stages of K and V, the exchange
template <int D>
__host__ __device__ constexpr size_t smem_floats() {
  return size_t(kResident) * row_stride<D>() + 4 * size_t(kKeys) * row_stride<D>() +
         size_t(kWarps) * 32 * kExchange;
}

// s[j] = A B_j^T over the columns [c0, c0 + DH): A 16 rows, B kKeys rows of
// shared tiles (row stride S), in the accumulator layout (lane (g, t): rows
// g and g + 8, keys 8j + 2t and 8j + 2t + 1). Per 8 columns one ldmatrix.x4
// loads the A fragment and one the B fragments of each pair of j.
template <int S, int DH>
__device__ __forceinline__ void scores(const float* a, const float* b, int c0, int lane,
                                       float (&s)[kJ][4]) {
  const int blk = lane / 8, r = lane % 8;
  const int arow = (r + 8 * (blk & 1)) * S + c0 + 4 * (blk >> 1);
  const int brow = (r + 8 * (blk >> 1)) * S + c0 + 4 * (blk & 1);
  float big[kJ][4] = {}, small[kJ][4] = {};
#pragma unroll
  for (int kk = 0; kk < DH; kk += 8) {
    uint32_t raw[4], xh[4], xl[4], bh[4], bl[4];
    ldsm4(a + arow + kk, raw);
    split4(raw, xh, xl);
#pragma unroll
    for (int jj = 0; jj < kJ / 2; ++jj) {
      ldsm4(b + brow + 16 * jj * S + kk, raw);
      split4(raw, bh, bl);
      mma3_split(big[2 * jj], small[2 * jj], xh, xl, bh[0], bh[1], bl[0], bl[1]);
      mma3_split(big[2 * jj + 1], small[2 * jj + 1], xh, xl, bh[2], bh[3], bl[2], bl[3]);
    }
  }
#pragma unroll
  for (int j = 0; j < kJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = big[j][e] + small[j][e];
}

// s += the other half's partial s (a + b on both warps: the same bits)
__device__ __forceinline__ void exchange(float* xch, int warp, int lane, int group,
                                         float (&s)[kJ][4]) {
  float* mine = xch + warp * kExchange * 32 + lane;
  const float* other = xch + (warp ^ kGroups) * kExchange * 32 + lane;
#pragma unroll
  for (int i = 0; i < kExchange; ++i) mine[i * 32] = s[i / 4][i % 4];
  pair_barrier(group);
#pragma unroll
  for (int i = 0; i < kExchange; ++i) s[i / 4][i % 4] += other[i * 32];
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, int n, int m, float scale_log2) {
  constexpr int S = row_stride<D>();
  constexpr int DH = D / 2;
  constexpr int NT = DH / 8;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* kv = qs + kResident * S;             // [stage][K, V][kKeys][S]
  float* xch = kv + 4 * kKeys * S;

  const int b = blockIdx.y;
  const int q0 = blockIdx.x * kResident;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int group = warp % kGroups, half = warp / kGroups;
  const size_t qoff = size_t(b) * n;
  const float* kb = k + size_t(b) * m * D;
  const float* vb = v + size_t(b) * m * D;

  load_rows<D, kResident>(qs, q + qoff * D, q0, n, tid);
  load_rows<D, kKeys>(kv, kb, 0, m, tid);
  load_rows<D, kKeys>(kv + kKeys * S, vb, 0, m, tid);
  cp_async_commit();

  float acc[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
  // rows g and g + 8 of the group: running max (base 2) and this lane's
  // share of the running sum
  float row_max[2] = {-CUDART_INF_F, -CUDART_INF_F};
  float row_sum[2] = {0.f, 0.f};

  const float* qw = qs + 16 * group * S;
  const int n_tiles = (m + kKeys - 1) / kKeys;
  for (int tt = 0; tt < n_tiles; ++tt) {
    if (tt + 1 < n_tiles) {
      float* next = kv + ((tt + 1) & 1) * 2 * kKeys * S;
      load_rows<D, kKeys>(next, kb, (tt + 1) * kKeys, m, tid);
      load_rows<D, kKeys>(next + kKeys * S, vb, (tt + 1) * kKeys, m, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* ks = kv + (tt & 1) * 2 * kKeys * S;
    const float* vs = ks + kKeys * S;

    float s[kJ][4];
    scores<S, DH>(qw, ks, half * DH, lane, s);
    exchange(xch, warp, lane, group, s);

    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int j = 0; j < kJ; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = tt * kKeys + 8 * j + 2 * t + (e & 1);
        s[j][e] = key < m ? s[j][e] * scale_log2 : -CUDART_INF_F;
        mx[e / 2] = fmaxf(mx[e / 2], s[j][e]);
      }
    }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(row_max[i], mx[i]);
      alpha[i] = exp2f(row_max[i] - m_new);
      row_max[i] = m_new;
      row_sum[i] *= alpha[i];
    }
#pragma unroll
    for (int j = 0; j < kJ; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = exp2f(s[j][e] - row_max[e / 2]);
        row_sum[e / 2] += s[j][e];
      }
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] *= alpha[e / 2];
#pragma unroll
    for (int jj = 0; jj < kJ / 2; ++jj) {
      const float(&p)[2][4] = *reinterpret_cast<const float(*)[2][4]>(&s[2 * jj]);
      product<S, NT>(p, vs + 16 * jj * S, half * DH, g, t, acc);
    }
    __syncthreads();                          // stage and exchange consumed
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = row_sum[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int row = q0 + 16 * group + g + 8 * i;
    if (row < n) {
      const float inv = 1.f / l;
      float* orow = o + (qoff + row) * D + half * DH + 2 * t;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        *reinterpret_cast<float2*>(orow + 8 * nt) =
            make_float2(acc[nt][2 * i] * inv, acc[nt][2 * i + 1] * inv);
      // natural-log logsumexp of the scaled logits: the running max and sum
      // are in base 2 (log2(e) folded into the scale)
      if (lse != nullptr && half == 0 && t == 0)
        lse[qoff + row] = (row_max[i] + log2f(l)) * 0.6931471805599453f;
    }
  }
}

template <int D>
cudaError_t launch(const float* q, const float* k, const float* v, float* o,
                   float* lse, int b, int n, int m, float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((n + kResident - 1) / kResident, b);
  flash_fwd_kernel<D><<<grid, kThreads, smem, stream>>>(q, k, v, o, lse, n, m,
                                                        scale * kLog2e);
  return cudaGetLastError();
}

cudaError_t dispatch(const float* q, const float* k, const float* v, float* o, float* lse,
                     int b, int n, int m, int d, float scale, void* stream) {
  if (b <= 0 || b > 65535 || n <= 0 || m <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64: return launch<64>(q, k, v, o, lse, b, n, m, scale, s);
    case 128: return launch<128>(q, k, v, o, lse, b, n, m, scale, s);
    case 256: return launch<256>(q, k, v, o, lse, b, n, m, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int vgd_flash_attention_fwd(const float* q, const float* k, const float* v,
                                       float* o, int b, int n, int m, int d,
                                       float scale, void* stream) {
  return dispatch(q, k, v, o, nullptr, b, n, m, d, scale, stream);
}

// The same forward, also writing lse (B, N) f32 = log sum_j exp(s_ij).
extern "C" int vgd_flash_attention_fwd_lse(const float* q, const float* k, const float* v,
                                           float* o, float* lse, int b, int n, int m,
                                           int d, float scale, void* stream) {
  if (lse == nullptr) return cudaErrorInvalidValue;
  return dispatch(q, k, v, o, lse, b, n, m, d, scale, stream);
}

extern "C" const char* vgd_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
