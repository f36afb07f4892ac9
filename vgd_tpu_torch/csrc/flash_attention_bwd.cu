// Single-head FlashAttention-2 backward, f32, for Hopper (sm_90a).
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
// What bounds it on the H100. The model's attention runs in f32, so the
// products run on the CUDA cores at the 67 TFLOP/s f32 peak: dq does
// 6 B N M D operations (q.k, dO.v, ds.K) and dk/dv 8 B N M D (q.k, dO.v,
// p^T dO, ds^T q). Summed over the three attentions of a 256x256, batch-16
// UNet (B N M D = 9.66e9), that is 58.0 GFLOP (0.87 ms) for dq and 77.3
// GFLOP (1.15 ms) for dk/dv per train step. The bytes are below that: the
// largest operands, cross_attn2's q / dO / dq (16 x 16384 x 256 f32), are
// 268 MB each, about 0.08 ms each at 3.35 TB/s. So both kernels are about
// feeding the FMA units from shared memory, as in the forward:
//
// * dq: one block per (batch, 64-row q tile), 8 warps of 8 rows. The q and
//   dO tiles (64 KB each at D=256) stay in shared memory for the whole KV
//   loop; K and V tiles of 32 keys (rows padded by 4 floats) are loaded per
//   tile. Each lane owns one key: s and dp of the warp's 8 rows are
//   register dot products over D (q and dO are warp-wide broadcasts, the
//   padded K/V rows are conflict-free), p and ds stay in registers, and
//   ds K accumulates with ds broadcast by shuffles and K rows read as
//   16-byte vectors. 193 KB of dynamic shared memory at D=256.
// * dk/dv: one block per (batch, 32-key tile, split of the q rows). The K
//   and V tiles stay in shared memory; the block walks its q rows in tiles
//   of 64. Phase 1 computes p and ds for 64 rows x 32 keys as in dq and
//   writes them to shared memory; phase 2 gives each warp 4 keys and each
//   lane D/32 columns of their dk and dv (64 accumulators in registers),
//   reading p/ds as 16-byte broadcasts and the q/dO rows as 16-byte
//   vectors. 209 KB of dynamic shared memory at D=256.
// * The cross-attentions have M = 64 keys: 2 KV tiles per image, only 32
//   blocks on 132 SMs, each walking up to 16384 q rows. The wrapper splits
//   the q rows when there are fewer than two blocks per SM: each split
//   writes its partial dk/dv to scratch and a second small kernel sums the
//   splits in a fixed order, so the result is deterministic (no atomics).
// * Ragged N and M are masked in the kernels: q rows past N (or past the
//   split) and keys past M load as zero and get p = ds = 0; nothing past N
//   or M is stored.
//
// Plain C interface for ctypes. Each function launches on the given stream,
// does not synchronise and allocates nothing; it returns the CUDA error of
// its launches (cudaErrorInvalidValue for a shape it does not take).

#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;                       // q rows per tile
constexpr int kBK = 32;                       // keys per KV tile, one per lane
constexpr int kWarps = 8;
constexpr int kRows = kBQ / kWarps;           // q rows per warp (phase 1)
constexpr int kKeys = kBK / kWarps;           // keys per warp (dk/dv phase 2)
constexpr int kThreads = kWarps * 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
__host__ __device__ constexpr int k_stride() { return D + 4; }

// A lane owns D/32 columns: VW consecutive ones in each of G groups,
// columns VW*lane + 32*VW*g + e, so a warp reads a row as 16-byte
// (8-byte at D=64) vectors on consecutive addresses.
template <int D>
__host__ __device__ constexpr int vec_width() { return D >= 128 ? 4 : 2; }
template <int D>
__host__ __device__ constexpr int col_groups() { return D / (32 * vec_width<D>()); }

template <int D>
__host__ __device__ constexpr size_t dq_smem_bytes() {
  return sizeof(float) * (2 * size_t(kBQ) * D + 2 * size_t(kBK) * k_stride<D>());
}

template <int D>
__host__ __device__ constexpr size_t dkv_smem_bytes() {
  return sizeof(float) * (2 * size_t(kBK) * k_stride<D>() + 2 * size_t(kBQ) * D +
                          2 * size_t(kBQ) * kBK);
}

template <int VW>
__device__ __forceinline__ void load_vec(const float* p, float* out) {
  if constexpr (VW == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    out[0] = t.x; out[1] = t.y; out[2] = t.z; out[3] = t.w;
  } else {
    const float2 t = *reinterpret_cast<const float2*>(p);
    out[0] = t.x; out[1] = t.y;
  }
}

template <int VW>
__device__ __forceinline__ void store_vec(float* p, const float* in) {
  if constexpr (VW == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(in[0], in[1], in[2], in[3]);
  } else {
    *reinterpret_cast<float2*>(p) = make_float2(in[0], in[1]);
  }
}

// Rows [r0, r0 + R) of a row-major (rows, D) matrix into shared memory with
// row stride S floats; rows at or past `limit` load as zero.
template <int D, int R, int S>
__device__ __forceinline__ void load_tile(float* dst, const float* src, int r0, int limit,
                                          int tid) {
  constexpr int D4 = D / 4;
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int idx = tid; idx < R * D4; idx += kThreads) {
    const int r = idx / D4, c4 = idx % D4;
    float4 val = zero4;
    if (r0 + r < limit) val = reinterpret_cast<const float4*>(src + size_t(r0 + r) * D)[c4];
    reinterpret_cast<float4*>(dst + r * S)[c4] = val;
  }
}

// s[i] = q_i . k_lane and dp[i] = dO_i . v_lane for kRows rows starting at
// row0 of the q / dO tiles (row stride D) and key `lane` of the K / V tiles
// (row stride D + 4).
template <int D>
__device__ __forceinline__ void row_key_dots(const float* qs, const float* dos,
                                             const float* ks, const float* vs, int row0,
                                             int lane, float* s, float* dp) {
  constexpr int KS = k_stride<D>();
  constexpr int D4 = D / 4;
#pragma unroll
  for (int i = 0; i < kRows; ++i) { s[i] = 0.f; dp[i] = 0.f; }
  const float4* krow = reinterpret_cast<const float4*>(ks + lane * KS);
  const float4* vrow = reinterpret_cast<const float4*>(vs + lane * KS);
  const float4* qrow = reinterpret_cast<const float4*>(qs + row0 * D);
  const float4* drow = reinterpret_cast<const float4*>(dos + row0 * D);
#pragma unroll 2
  for (int d4 = 0; d4 < D4; ++d4) {
    const float4 kk = krow[d4];
    const float4 vv = vrow[d4];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const float4 qq = qrow[i * D4 + d4];
      const float4 oo = drow[i * D4 + d4];
      s[i] = fmaf(qq.x, kk.x, s[i]);
      s[i] = fmaf(qq.y, kk.y, s[i]);
      s[i] = fmaf(qq.z, kk.z, s[i]);
      s[i] = fmaf(qq.w, kk.w, s[i]);
      dp[i] = fmaf(oo.x, vv.x, dp[i]);
      dp[i] = fmaf(oo.y, vv.y, dp[i]);
      dp[i] = fmaf(oo.z, vv.z, dp[i]);
      dp[i] = fmaf(oo.w, vv.w, dp[i]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    float* __restrict__ dq, int n, int m, float scale) {
  constexpr int KS = k_stride<D>();
  constexpr int VW = vec_width<D>();
  constexpr int G = col_groups<D>();
  constexpr int CPL = D / 32;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* dos = qs + kBQ * D;
  float* ks = dos + kBQ * D;
  float* vs = ks + kBK * KS;

  const int b = blockIdx.y;
  const int q0 = blockIdx.x * kBQ;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const size_t qoff = size_t(b) * n;
  const float* kb = k + size_t(b) * m * D;
  const float* vb = v + size_t(b) * m * D;
  const float scale_log2 = scale * kLog2e;

  load_tile<D, kBQ, D>(qs, q + qoff * D, q0, n, tid);
  load_tile<D, kBQ, D>(dos, dout + qoff * D, q0, n, tid);

  float lse2[kRows], dl[kRows];
  float acc[kRows][CPL];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + warp * kRows + i;
    // rows past n have q = dO = 0, so ds = 0 whatever lse says; not stored
    lse2[i] = row < n ? lse[qoff + row] * kLog2e : 0.f;
    dl[i] = row < n ? delta[qoff + row] : 0.f;
#pragma unroll
    for (int c = 0; c < CPL; ++c) acc[i][c] = 0.f;
  }

  const int n_tiles = (m + kBK - 1) / kBK;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBK;
    __syncthreads();                          // previous tile consumed
    load_tile<D, kBK, KS>(ks, kb, k0, m, tid);
    load_tile<D, kBK, KS>(vs, vb, k0, m, tid);
    __syncthreads();

    float s[kRows], dp[kRows];
    row_key_dots<D>(qs, dos, ks, vs, warp * kRows, lane, s, dp);
    const bool valid = k0 + lane < m;
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const float p = valid ? exp2f(s[i] * scale_log2 - lse2[i]) : 0.f;
      s[i] = p * (dp[i] - dl[i]) * scale;     // ds of (row i, key lane)
    }

    // acc += ds K (masked keys have ds = 0 and zero K rows)
#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float kj[CPL];
#pragma unroll
      for (int g = 0; g < G; ++g) load_vec<VW>(ks + j * KS + VW * lane + 32 * VW * g, kj + g * VW);
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float dsij = __shfl_sync(kFull, s[i], j);
#pragma unroll
        for (int c = 0; c < CPL; ++c) acc[i][c] = fmaf(dsij, kj[c], acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + warp * kRows + i;
    if (row < n) {
      float* dqrow = dq + (qoff + row) * D;
#pragma unroll
      for (int g = 0; g < G; ++g) store_vec<VW>(dqrow + VW * lane + 32 * VW * g, acc[i] + g * VW);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     float* __restrict__ dk, float* __restrict__ dv, int n, int m,
                     int rows_per_split, float scale) {
  constexpr int KS = k_stride<D>();
  constexpr int VW = vec_width<D>();
  constexpr int G = col_groups<D>();
  constexpr int CPL = D / 32;
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);
  float* vs = ks + kBK * KS;
  float* qs = vs + kBK * KS;
  float* dos = qs + kBQ * D;
  float* ps = dos + kBQ * D;                  // (kBQ, kBK) probabilities
  float* dss = ps + kBQ * kBK;                // (kBQ, kBK) ds

  const int k0 = blockIdx.x * kBK;
  const int b = blockIdx.y;
  const int split = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const size_t qoff = size_t(b) * n;
  const float* qb = q + qoff * D;
  const float* dob = dout + qoff * D;
  const float scale_log2 = scale * kLog2e;
  const int row_begin = split * rows_per_split;
  const int row_end = min(n, row_begin + rows_per_split);
  const bool key_valid = k0 + lane < m;

  load_tile<D, kBK, KS>(ks, k + size_t(b) * m * D, k0, m, tid);
  load_tile<D, kBK, KS>(vs, v + size_t(b) * m * D, k0, m, tid);

  float dk_acc[kKeys][CPL], dv_acc[kKeys][CPL];
#pragma unroll
  for (int j = 0; j < kKeys; ++j) {
#pragma unroll
    for (int c = 0; c < CPL; ++c) { dk_acc[j][c] = 0.f; dv_acc[j][c] = 0.f; }
  }

  for (int q0 = row_begin; q0 < row_end; q0 += kBQ) {
    __syncthreads();                          // K/V loaded; previous tile consumed
    load_tile<D, kBQ, D>(qs, qb, q0, row_end, tid);
    load_tile<D, kBQ, D>(dos, dob, q0, row_end, tid);
    __syncthreads();

    // phase 1: p and ds of (this warp's 8 rows, key lane) into shared memory
    float s[kRows], dp[kRows];
    row_key_dots<D>(qs, dos, ks, vs, warp * kRows, lane, s, dp);
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = warp * kRows + i;
      const int row = q0 + r;
      const bool valid = key_valid && row < row_end;
      const float l2 = row < row_end ? lse[qoff + row] * kLog2e : 0.f;
      const float dl = row < row_end ? delta[qoff + row] : 0.f;
      const float p = valid ? exp2f(s[i] * scale_log2 - l2) : 0.f;
      ps[r * kBK + lane] = p;
      dss[r * kBK + lane] = p * (dp[i] - dl) * scale;
    }
    __syncthreads();

    // phase 2: dv_j += p_ij dO_i and dk_j += ds_ij q_i for this warp's keys
#pragma unroll 2
    for (int i = 0; i < kBQ; ++i) {
      const float4 p4 = *reinterpret_cast<const float4*>(ps + i * kBK + warp * kKeys);
      const float4 d4 = *reinterpret_cast<const float4*>(dss + i * kBK + warp * kKeys);
      const float pj[kKeys] = {p4.x, p4.y, p4.z, p4.w};
      const float dsj[kKeys] = {d4.x, d4.y, d4.z, d4.w};
      float o[CPL], qv[CPL];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        load_vec<VW>(dos + i * D + VW * lane + 32 * VW * g, o + g * VW);
        load_vec<VW>(qs + i * D + VW * lane + 32 * VW * g, qv + g * VW);
      }
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
#pragma unroll
        for (int c = 0; c < CPL; ++c) {
          dv_acc[j][c] = fmaf(pj[j], o[c], dv_acc[j][c]);
          dk_acc[j][c] = fmaf(dsj[j], qv[c], dk_acc[j][c]);
        }
      }
    }
  }

  // this split's dk/dv rows: (split, b, key, :) of a (splits, B, M, D) array
  const size_t base = (size_t(split) * gridDim.y + b) * m;
#pragma unroll
  for (int j = 0; j < kKeys; ++j) {
    const int key = k0 + warp * kKeys + j;
    if (key < m) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const int col = VW * lane + 32 * VW * g;
        store_vec<VW>(dk + (base + key) * D + col, dk_acc[j] + g * VW);
        store_vec<VW>(dv + (base + key) * D + col, dv_acc[j] + g * VW);
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
  const size_t smem = dq_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((n + kBQ - 1) / kBQ, b);
  flash_bwd_dq_kernel<D><<<grid, kThreads, smem, stream>>>(q, k, v, dout, lse, delta, dq, n,
                                                           m, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const float* q, const float* k, const float* v, const float* dout,
                       const float* lse, const float* delta, float* dk, float* dv,
                       float* scratch, int b, int n, int m, int splits, int rows_per_split,
                       float scale, cudaStream_t stream) {
  const size_t smem = dkv_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const size_t count = size_t(b) * m * D;
  float* dk_part = splits == 1 ? dk : scratch;
  float* dv_part = splits == 1 ? dv : scratch + size_t(splits) * count;
  const dim3 grid((m + kBK - 1) / kBK, b, splits);
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
