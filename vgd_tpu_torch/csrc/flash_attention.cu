// Single-head flash attention forward, f32, for Hopper (sm_90a).
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
// and the reference semantics are f32, so the products run on the CUDA
// cores: 4*B*N*M*D operations at the 67 TFLOP/s f32 peak. At 256x256,
// B=16, D=256 that is 17.2 GFLOP for the 1024-token bottleneck, 17.2 for
// cross_attn2 (N=16384, M=64) and 4.3 for cross_attn3 (N=4096, M=64):
// about 0.58 ms per UNet forward. cross_attn2 also has to move q and o,
// 537 MB, about 0.16 ms at 3.35 TB/s. So the kernel is bound by operations
// and its design is about feeding the FMA units from shared memory:
//
// * One block per (batch, 64-row q tile), 8 warps; each warp owns 8 query
//   rows. The q tile (64 KB at D=256) stays in shared memory for the whole
//   KV loop; K and V tiles of 32 keys are loaded once per tile by all
//   threads with 16-byte loads. At D=256 the block needs 128.5 KB of
//   dynamic shared memory, above the 48 KB default, so the launch raises
//   the limit with cudaFuncSetAttribute (the SM has 227 KB).
// * A KV tile has 32 keys, one per lane, so each lane computes the logits
//   of its key for the warp's 8 rows in registers (q values are warp-wide
//   broadcasts; K rows are padded by 4 floats so the 16-byte reads of 8
//   lanes hit 32 distinct banks). The online softmax (running max and sum,
//   exp2 with log2(e) folded into the scale) then needs only warp
//   shuffles, no shared-memory round trip.
// * P V: each lane owns D/32 output columns of the warp's 8 rows (64 f32
//   accumulators at D=256); p_ij is broadcast from lane j by a shuffle and
//   V is read row by row, conflict-free.
// * Ragged N and M are masked in the kernel: q rows past N load as zero and
//   are not stored; keys past M get a logit of -inf and zero K/V rows. The
//   first key of every tile is real, so the running max stays finite.
//
// Plain C interface for ctypes. The function launches on the given stream,
// does not synchronise and allocates nothing; it returns the CUDA error of
// the launch (cudaErrorInvalidValue for a shape it does not take).

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kBQ = 64;                       // query rows per block
constexpr int kBK = 32;                       // keys per KV tile, one per lane
constexpr int kWarps = 8;
constexpr int kRows = kBQ / kWarps;           // query rows per warp
constexpr int kThreads = kWarps * 32;
constexpr unsigned kFull = 0xffffffffu;

template <int D>
__host__ __device__ constexpr int k_stride() { return D + 4; }

template <int D>
__host__ __device__ constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t(kBQ) * D + size_t(kBK) * k_stride<D>() + size_t(kBK) * D);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, int n, int m, float scale_log2) {
  constexpr int KS = k_stride<D>();
  constexpr int D4 = D / 4;
  constexpr int CPL = D / 32;                 // output columns per lane
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* ks = qs + kBQ * D;
  float* vs = ks + kBK * KS;

  const int b = blockIdx.y;
  const int q0 = blockIdx.x * kBQ;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const float* qb = q + size_t(b) * n * D;
  const float* kb = k + size_t(b) * m * D;
  const float* vb = v + size_t(b) * m * D;
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int idx = tid; idx < kBQ * D4; idx += kThreads) {
    const int r = idx / D4, c4 = idx % D4;
    float4 val = zero4;
    if (q0 + r < n) val = reinterpret_cast<const float4*>(qb + size_t(q0 + r) * D)[c4];
    reinterpret_cast<float4*>(qs + r * D)[c4] = val;
  }

  float acc[kRows][CPL];
  float row_max[kRows];
  float row_sum[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    row_max[i] = -CUDART_INF_F;
    row_sum[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CPL; ++c) acc[i][c] = 0.f;
  }

  const int n_tiles = (m + kBK - 1) / kBK;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBK;
    __syncthreads();                          // previous tile consumed
    for (int idx = tid; idx < kBK * D4; idx += kThreads) {
      const int r = idx / D4, c4 = idx % D4;
      float4 kv = zero4, vv = zero4;
      if (k0 + r < m) {
        kv = reinterpret_cast<const float4*>(kb + size_t(k0 + r) * D)[c4];
        vv = reinterpret_cast<const float4*>(vb + size_t(k0 + r) * D)[c4];
      }
      reinterpret_cast<float4*>(ks + r * KS)[c4] = kv;
      reinterpret_cast<float4*>(vs + r * D)[c4] = vv;
    }
    __syncthreads();

    // logits of key (k0 + lane) for this warp's rows
    float s[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) s[i] = 0.f;
    const float4* krow = reinterpret_cast<const float4*>(ks + lane * KS);
    const float4* qrow = reinterpret_cast<const float4*>(qs + warp * kRows * D);
#pragma unroll 4
    for (int d4 = 0; d4 < D4; ++d4) {
      const float4 kk = krow[d4];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float4 qq = qrow[i * D4 + d4];
        s[i] = fmaf(qq.x, kk.x, s[i]);
        s[i] = fmaf(qq.y, kk.y, s[i]);
        s[i] = fmaf(qq.z, kk.z, s[i]);
        s[i] = fmaf(qq.w, kk.w, s[i]);
      }
    }

    // online softmax over the tile, one row per step, lanes = keys
    const bool valid = k0 + lane < m;
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const float x = valid ? s[i] * scale_log2 : -CUDART_INF_F;
      float mx = x;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
      const float m_new = fmaxf(row_max[i], mx);
      const float p = exp2f(x - m_new);
      float ps = p;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) ps += __shfl_xor_sync(kFull, ps, off);
      const float alpha = exp2f(row_max[i] - m_new);
      row_sum[i] = row_sum[i] * alpha + ps;
      row_max[i] = m_new;
      s[i] = p;
#pragma unroll
      for (int c = 0; c < CPL; ++c) acc[i][c] *= alpha;
    }

    // acc += P V (masked keys have p = 0 and zero V rows)
#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float vj[CPL];
#pragma unroll
      for (int c = 0; c < CPL; ++c) vj[c] = vs[j * D + lane + 32 * c];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float pij = __shfl_sync(kFull, s[i], j);
#pragma unroll
        for (int c = 0; c < CPL; ++c) acc[i][c] = fmaf(pij, vj[c], acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + warp * kRows + i;
    if (row < n) {
      const float inv = 1.f / row_sum[i];
      float* orow = o + (size_t(b) * n + row) * D;
#pragma unroll
      for (int c = 0; c < CPL; ++c) orow[lane + 32 * c] = acc[i][c] * inv;
      // natural-log logsumexp of the scaled logits: the running max and sum
      // are in base 2 (exp2 with log2(e) folded into the scale)
      if (lse != nullptr && lane == 0)
        lse[size_t(b) * n + row] = (row_max[i] + log2f(row_sum[i])) * 0.6931471805599453f;
    }
  }
}

template <int D>
cudaError_t launch(const float* q, const float* k, const float* v, float* o,
                   float* lse, int b, int n, int m, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((n + kBQ - 1) / kBQ, b);
  flash_fwd_kernel<D><<<grid, kThreads, smem, stream>>>(
      q, k, v, o, lse, n, m, scale * 1.4426950408889634f);
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
