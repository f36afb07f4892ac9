// Conv 4x4 stride 2 (padding 0 or 1) with f32 accumulation, plus the
// per-channel batch mean and biased variance of its output, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel _fused_fwd_kernel of vgd_tpu/ops/fused_conv.py
// (called through _conv_stats_pallas / conv_bn_lrelu): the forward of the
// fused Conv4x4s2 + train-mode BatchNorm + LeakyReLU of the VAE-GAN encoder
// (padding 0) and discriminator (padding 1). x (B, H, W, Cin) NHWC, bf16 or
// f32, contiguous; w (16 * Cin, K) with row (ky * 4 + kx) * Cin + ci (the
// HWIO kernel flattened, prepared by the wrapper); c (B, Ho, Wo, K) f32 and
// mean / var (K,) f32, the variance biased and >= 0. Normalise + LeakyReLU
// stay an elementwise pass outside, as the JAX package leaves them to XLA.
//
// What bounds it on the H100. At 256x256, batch 64 one VAE-GAN train step
// runs it 33 times for about 203 GFLOP and 1.4 GB: with bf16 operands on
// the tensor cores (989 TFLOP/s) the largest layers are bound by
// operations, the first encoder layer (Cin = 3) and the small discriminator
// layers by bytes. The TPU kernel's layout tricks (space-to-depth, the
// row-flattened input with its pad column) exist for the MXU and Mosaic's
// tiling; here the conv is a plain implicit GEMM:
//
// * M = B * Ho * Wo output pixels by N = K channels, reduction depth
//   16 * Cin. One block of 4 warps per 64 x 64 output tile; the depth runs
//   in chunks of 32, staged in shared memory: the A chunk is gathered from
//   x (16-byte loads when Cin is a multiple of 8 for bf16 or 4 for f32, so
//   a vector never crosses a tap; out-of-image taps of the padding, ragged
//   and odd sizes such as the 127x127 input of the second encoder layer are
//   masked to zero), the B chunk is a row slice of w.
// * bf16: each warp owns a 32 x 32 quarter of the tile as 2 x 2 WMMA
//   16x16x16 fragments with f32 accumulators (mma.sync on the tensor
//   cores). f32: the same tiles on the CUDA cores, 4 x 8 outputs a thread,
//   so f32 stays f32 (TF32 would lose the 1e-4 tolerance).
// * Statistics epilogue: the tile goes to shared memory, is written to c
//   with 16-byte stores, and each of the tile's channels gets the exact
//   two-pass (mean, M2) of its <= 64 rows. A second small kernel combines
//   the partials of every row tile of a channel with Chan's formula in a
//   fixed order (a strided pass per thread, then a tree in shared memory):
//   no atomics, so the result is deterministic, and no E[x^2] - E[x]^2
//   cancellation over the 1,032,256 values per channel of the first
//   encoder layer.
//
// Not yet done (later work): wgmma / TMA pipelines, double-buffered loads,
// and the normalise + LeakyReLU pass in the epilogue.
//
// Plain C interface for ctypes. The function launches on the given stream,
// does not synchronise and allocates nothing (the wrapper passes c, the
// partials scratch and the outputs); it returns the CUDA error of the
// launches (cudaErrorInvalidValue for a shape it does not take).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <type_traits>

namespace {

constexpr int kBM = 64;                 // output pixels per tile
constexpr int kBN = 64;                 // output channels per tile
constexpr int kBK = 32;                 // depth per staged chunk
constexpr int kThreads = 128;           // 4 warps
constexpr int kCS = kBN + 4;            // row stride of the f32 C tile
constexpr int kCombineThreads = 256;

template <typename T>
__device__ __forceinline__ T zero_value();
template <>
__device__ __forceinline__ float zero_value<float>() { return 0.0f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero_value<__nv_bfloat16>() {
  return __float2bfloat16(0.0f);
}

template <typename T>
__host__ __device__ constexpr bool tensor_cores() {
  return std::is_same<T, __nv_bfloat16>::value;
}
// row strides of the staged A (kBM x kBK) and B (kBK x kBN) chunks, in
// elements: WMMA wants a multiple of 8 bf16 and 32-byte aligned fragment
// rows; the f32 path pads A by one float so the 4 rows a warp reads at one
// depth fall in 4 banks
template <typename T>
__host__ __device__ constexpr int a_stride() { return tensor_cores<T>() ? kBK + 8 : kBK + 1; }
template <typename T>
__host__ __device__ constexpr int b_stride() { return tensor_cores<T>() ? kBN + 8 : kBN + 4; }

struct Geometry {
  int h, w, cin, k, wo, hwo, pad, m, depth;
};

// Stage depth chunk [k0, k0 + kBK) of the A tile (gathered from x) and of
// the B tile (rows of w) in shared memory. VA / VB: elements per load.
template <typename T, int VA, int VB>
__device__ __forceinline__ void stage_chunk(const T* __restrict__ x, const T* __restrict__ w,
                                            T* as, T* bs, const long long* row_base,
                                            const int* row_iy, const int* row_ix,
                                            const Geometry& g, int k0, int n0) {
  constexpr int AS = a_stride<T>();
  constexpr int BS = b_stride<T>();
  constexpr int AV = kBK / VA;
  for (int v = threadIdx.x; v < kBM * AV; v += kThreads) {
    const int row = v / AV;
    const int kk = (v - row * AV) * VA;
    const int r = k0 + kk;
    T* dst = as + row * AS + kk;
    bool ok = r < g.depth;
    long long off = 0;
    if (ok) {
      const int tap = r / g.cin;
      const int ci = r - tap * g.cin;
      const int iy = row_iy[row] + (tap >> 2);
      const int ix = row_ix[row] + (tap & 3);
      ok = iy >= 0 && iy < g.h && ix >= 0 && ix < g.w;
      off = row_base[row] + (static_cast<long long>(iy) * g.w + ix) * g.cin + ci;
    }
    if constexpr (VA == 1) {
      *dst = ok ? x[off] : zero_value<T>();
    } else {
      static_assert(VA * sizeof(T) == 16, "vector loads are 16 bytes");
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (ok) val = *reinterpret_cast<const uint4*>(x + off);
      if constexpr (tensor_cores<T>()) {
        *reinterpret_cast<uint4*>(dst) = val;
      } else {
        const T* e = reinterpret_cast<const T*>(&val);
#pragma unroll
        for (int j = 0; j < VA; ++j) dst[j] = e[j];
      }
    }
  }
  constexpr int BV = kBN / VB;
  for (int v = threadIdx.x; v < kBK * BV; v += kThreads) {
    const int kr = v / BV;
    const int nn = (v - kr * BV) * VB;
    const int r = k0 + kr;
    const int n = n0 + nn;
    const bool ok = r < g.depth && n < g.k;
    const long long off = static_cast<long long>(r) * g.k + n;
    T* dst = bs + kr * BS + nn;
    if constexpr (VB == 1) {
      *dst = ok ? w[off] : zero_value<T>();
    } else {
      static_assert(VB * sizeof(T) == 16, "vector loads are 16 bytes");
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (ok) val = *reinterpret_cast<const uint4*>(w + off);
      *reinterpret_cast<uint4*>(dst) = val;
    }
  }
}

template <typename T, int VA, int VB>
__global__ void __launch_bounds__(kThreads)
conv_stats_kernel(const T* __restrict__ x, const T* __restrict__ w, float* __restrict__ c,
                  float* __restrict__ part, Geometry g, int n_mtiles) {
  constexpr int AS = a_stride<T>();
  constexpr int BS = b_stride<T>();
  __shared__ __align__(128) T as[kBM * AS];
  __shared__ __align__(128) T bs[kBK * BS];
  __shared__ __align__(128) float cs[kBM * kCS];
  __shared__ long long row_base[kBM];
  __shared__ int row_iy[kBM];
  __shared__ int row_ix[kBM];

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  if (tid < kBM) {
    const int m = m0 + tid;
    if (m < g.m) {
      const int b = m / g.hwo;
      const int rem = m - b * g.hwo;
      const int oy = rem / g.wo;
      const int ox = rem - oy * g.wo;
      row_base[tid] = static_cast<long long>(b) * g.h * g.w * g.cin;
      row_iy[tid] = 2 * oy - g.pad;
      row_ix[tid] = 2 * ox - g.pad;
    } else {                               // past the last pixel: all taps masked
      row_base[tid] = 0;
      row_iy[tid] = -(1 << 28);
      row_ix[tid] = 0;
    }
  }

  const int warp = tid >> 5;
  if constexpr (tensor_cores<T>()) {
    using namespace nvcuda;
    const int wm = warp >> 1, wn = warp & 1;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);
    for (int k0 = 0; k0 < g.depth; k0 += kBK) {
      __syncthreads();                     // row info ready / last chunk consumed
      stage_chunk<T, VA, VB>(x, w, as, bs, row_base, row_iy, row_ix, g, k0, n0);
      __syncthreads();
#pragma unroll
      for (int ks = 0; ks < kBK / 16; ++ks) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(fa[i], as + (wm * 32 + i * 16) * AS + ks * 16, AS);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::load_matrix_sync(fb[j], bs + (ks * 16) * BS + wn * 32 + j * 16, BS);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(cs + (wm * 32 + i * 16) * kCS + wn * 32 + j * 16, acc[i][j],
                                kCS, wmma::mem_row_major);
  } else {
    // 16 x 8 threads; thread (ty, tx) owns rows ty*4 + i and columns tx + 8j
    const int ty = tid >> 3, tx = tid & 7;
    float acc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
    for (int k0 = 0; k0 < g.depth; k0 += kBK) {
      __syncthreads();
      stage_chunk<T, VA, VB>(x, w, as, bs, row_base, row_iy, row_ix, g, k0, n0);
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < kBK; ++kk) {
        float a[4], b[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = as[(ty * 4 + i) * AS + kk];
#pragma unroll
        for (int j = 0; j < 8; ++j) b[j] = bs[kk * BS + tx + 8 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) cs[(ty * 4 + i) * kCS + tx + 8 * j] = acc[i][j];
  }
  __syncthreads();

  // epilogue: the tile to c, and each channel's (mean, M2) over its rows
  const int rows = min(kBM, g.m - m0);
  if (g.k % 4 == 0) {
    for (int v = tid; v < kBM * (kBN / 4); v += kThreads) {
      const int r = v / (kBN / 4);
      const int cc = (v - r * (kBN / 4)) * 4;
      if (r < rows && n0 + cc < g.k)
        *reinterpret_cast<float4*>(c + static_cast<long long>(m0 + r) * g.k + n0 + cc) =
            *reinterpret_cast<const float4*>(cs + r * kCS + cc);
    }
  } else {
    for (int v = tid; v < kBM * kBN; v += kThreads) {
      const int r = v / kBN;
      const int cc = v - r * kBN;
      if (r < rows && n0 + cc < g.k)
        c[static_cast<long long>(m0 + r) * g.k + n0 + cc] = cs[r * kCS + cc];
    }
  }
  if (tid < kBN && n0 + tid < g.k) {
    float s = 0.0f;
    for (int r = 0; r < rows; ++r) s += cs[r * kCS + tid];
    const float mean = s / static_cast<float>(rows);
    float m2 = 0.0f;
    for (int r = 0; r < rows; ++r) {
      const float d = cs[r * kCS + tid] - mean;
      m2 = fmaf(d, d, m2);
    }
    const long long n = n0 + tid;
    part[n * n_mtiles + blockIdx.x] = mean;
    part[(g.k + n) * n_mtiles + blockIdx.x] = m2;
  }
}

// (count, mean, M2) of a joined with (nb, mb, m2b), Chan et al.
__device__ __forceinline__ void chan_merge(float& na, float& ma, float& m2a, float nb, float mb,
                                           float m2b) {
  const float n = na + nb;
  if (nb == 0.0f) return;
  const float delta = mb - ma;
  const float fb = nb / n;
  ma = fmaf(delta, fb, ma);
  m2a = m2a + m2b + delta * delta * na * fb;
  na = n;
}

// One block per channel: every row tile's partial, in a fixed order.
__global__ void __launch_bounds__(kCombineThreads)
combine_stats_kernel(const float* __restrict__ part, float* __restrict__ mean,
                     float* __restrict__ var, int k, int n_mtiles, int m) {
  __shared__ float sn[kCombineThreads], sm[kCombineThreads], sm2[kCombineThreads];
  const int n = blockIdx.x;
  const int tid = threadIdx.x;
  float cnt = 0.0f, mu = 0.0f, m2 = 0.0f;
  const float* pm = part + static_cast<long long>(n) * n_mtiles;
  const float* pm2 = part + static_cast<long long>(k + n) * n_mtiles;
  for (int t = tid; t < n_mtiles; t += kCombineThreads)
    chan_merge(cnt, mu, m2, static_cast<float>(min(kBM, m - t * kBM)), pm[t], pm2[t]);
  sn[tid] = cnt;
  sm[tid] = mu;
  sm2[tid] = m2;
  __syncthreads();
  for (int s = kCombineThreads / 2; s > 0; s >>= 1) {
    if (tid < s) {
      float a = sn[tid], b = sm[tid], d = sm2[tid];
      chan_merge(a, b, d, sn[tid + s], sm[tid + s], sm2[tid + s]);
      sn[tid] = a;
      sm[tid] = b;
      sm2[tid] = d;
    }
    __syncthreads();
  }
  if (tid == 0) {
    mean[n] = sm[0];
    var[n] = fmaxf(sm2[0] / sn[0], 0.0f);
  }
}

template <typename T, int VA, int VB>
cudaError_t launch(const void* x, const void* w, float* c, float* part, const Geometry& g,
                   int n_mtiles, cudaStream_t stream) {
  const dim3 grid(n_mtiles, (g.k + kBN - 1) / kBN);
  conv_stats_kernel<T, VA, VB><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), c, part, g, n_mtiles);
  return cudaGetLastError();
}

template <typename T, int V>
cudaError_t dispatch_vec(const void* x, const void* w, float* c, float* part, const Geometry& g,
                         int n_mtiles, cudaStream_t stream) {
  const bool va = g.cin % V == 0, vb = g.k % V == 0;
  if (va && vb) return launch<T, V, V>(x, w, c, part, g, n_mtiles, stream);
  if (va) return launch<T, V, 1>(x, w, c, part, g, n_mtiles, stream);
  if (vb) return launch<T, 1, V>(x, w, c, part, g, n_mtiles, stream);
  return launch<T, 1, 1>(x, w, c, part, g, n_mtiles, stream);
}

}  // namespace

// Number of 64-pixel row tiles: the scratch `part` holds 2 * k * tiles
// floats (per channel the tiles' means, then their M2).
extern "C" int vgd_conv_stats_row_tiles(int b, int ho, int wo) {
  return static_cast<int>((static_cast<long long>(b) * ho * wo + kBM - 1) / kBM);
}

extern "C" int vgd_conv_bn_stats(const void* x, const void* w, float* c, float* part,
                                 float* mean, float* var, int b, int h, int w_in, int cin,
                                 int k, int pad, int bf16, void* stream) {
  if (b < 1 || cin < 1 || k < 1 || (pad != 0 && pad != 1)) return cudaErrorInvalidValue;
  const int ho = (h + 2 * pad - 4) / 2 + 1;
  const int wo = (w_in + 2 * pad - 4) / 2 + 1;
  if (h + 2 * pad < 4 || w_in + 2 * pad < 4) return cudaErrorInvalidValue;
  const long long m = static_cast<long long>(b) * ho * wo;
  if (m >= (1LL << 31) - kBM || 16LL * cin >= (1LL << 31)) return cudaErrorInvalidValue;
  Geometry g{h, w_in, cin, k, wo, ho * wo, pad, static_cast<int>(m), 16 * cin};
  const int n_mtiles = vgd_conv_stats_row_tiles(b, ho, wo);
  if ((k + kBN - 1) / kBN > 65535) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      bf16 ? dispatch_vec<__nv_bfloat16, 8>(x, w, c, part, g, n_mtiles, s)
           : dispatch_vec<float, 4>(x, w, c, part, g, n_mtiles, s);
  if (err != cudaSuccess) return err;
  combine_stats_kernel<<<k, kCombineThreads, 0, s>>>(part, mean, var, k, n_mtiles, g.m);
  return cudaGetLastError();
}

extern "C" const char* vgd_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
