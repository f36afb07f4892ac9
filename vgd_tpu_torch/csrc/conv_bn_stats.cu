// Conv 4x4 stride 2 (padding 0 or 1) with f32 accumulation, plus the
// per-channel batch mean and biased variance of its output, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel _fused_fwd_kernel of vgd_tpu/ops/fused_conv.py
// (called through _conv_stats_pallas / conv_bn_lrelu): the forward of the
// fused Conv4x4s2 + train-mode BatchNorm + LeakyReLU of the VAE-GAN encoder
// (padding 0) and discriminator (padding 1). x (B, H, W, Cin) NHWC, bf16 or
// f32, contiguous; w, prepared by the wrapper: bf16 (K, 16 * Cin) with
// column (ky * 4 + kx) * Cin + ci (torch's (K, Cin, 4, 4) kernel with its
// taps first), f32 (16 * Cin, K) with that row (the HWIO kernel flattened);
// c (B, Ho, Wo, K) f32, as the TPU kernel writes it, and mean /
// var (K,) f32, the variance biased and >= 0. Normalise + LeakyReLU stay an
// elementwise pass outside, as the JAX package leaves them to XLA.
//
// What bounds it on the H100. At 256x256, batch 64 one VAE-GAN train step
// runs it 33 times over nine shapes (M = B Ho Wo output pixels, N = K
// channels, depth 16 Cin), 0.453 ms in all by its bound: the f32 c dominates
// the bytes, so enc0-enc2 and dis1-dis3 are bound by bytes (enc0: 25 MB of
// x and 132 MB of c, 47 us; enc1 39 us; dis1 20 us) and enc3, dis4 and dis5
// by their operations at 989 TFLOP/s (13.2, 4.3 and 4.3 GFLOP: 13, 4 and
// 4 us). The deep, narrow layers have few output tiles (dis5: M = 1024,
// N = 512, depth 4096) and the shallow ones a short reduction (enc0: 64).
//
// The bf16 design (kernels.conv_stats_plan picks the tile and the splits
// per shape; the C entry point checks and runs that plan):
// * The operands stream through glow_mma.cuh's cp.async ring (K5's): 64-deep
//   XOR-swizzled stages (3; 2 for the K <= 32 tile) filled by 16-byte copies,
//   here with Conv4x4s2Op: A(m, k) is the implicit-GEMM gather over NHWC x
//   with depth (ky, kx, ci), in 16-byte runs along Cin where Cin % 8 == 0
//   (with padding 1 a window starts at an odd column, so only then is a
//   pixel run aligned); the first encoder layer's 3 channels are padded to 4
//   by the wrapper, and with padding 0 and an even width every run of 8 is
//   then two whole taps of one kernel row, 16-byte aligned. Taps outside the
//   image and past the ragged edges copy 0 bytes (zero fill). Other channel
//   counts (ragged shapes) are gathered element by element. B is w read
//   K-major (16-byte runs along the depth), so every B stage has 64-element
//   rows and K needs no padding.
// * A's address: a tile's 128 output pixels are decomposed once into a table
//   in shared memory (window origin, image row base); a 16-byte run then
//   costs a table read, a multiply-shift division of its depth index and a
//   bounds check.
// * Products: K > 32 on wgmma (glow_mma.cuh's wgmma_ring_tile: the ring's swizzled
//   K-major stages are the 128-byte swizzle wgmma reads, so the same copies
//   feed m64n128k16 / m64n64k16 descriptors; 128 x 128 tiles of two
//   warpgroups for K > 64, 128 x 64 of one for K <= 64); K <= 32 (enc0,
//   dis1) on mma_tile's ldmatrix + mma.sync m16n8k16, 128 x 32 tiles of 2
//   warps, so no tile wastes half its columns. On mma.sync the K > 32
//   products took longer at every shape, held by the issue of their MMAs
//   rather than by their loads.
// * Split reduction: where the output tiles leave more than half the SMs
//   idle (dis4: 64 tiles, dis5: 32), the depth is cut into `splits`
//   whole-stage pieces, as many as one wave of resident blocks holds (dis3,
//   128 tiles, ran faster unsplit); each writes its
//   partial tile to scratch and one finishing kernel sums the splits in
//   split order over 16 x 64 pieces of the output (512 blocks at dis5),
//   with the statistics of each piece.
// * Epilogue: the f32 tile in shared memory is written to c with 16-byte
//   stores, and each of its channels gets the exact two-pass (mean, M2) of
//   its rows (two row halves, then their sum). A last kernel combines the
//   tiles of a channel with Chan's formula in a fixed order. No atomics
//   anywhere: K1 is bit-equal over two calls, and there is no E[x^2] -
//   E[x]^2 cancellation over the 1,032,256 values per channel of enc0.
//
// f32 (compute_dtype="float32"): one block of 4 warps per 64 x 64 tile on
// the CUDA cores, 4 x 8 outputs a thread, 32-deep chunks staged in shared
// memory, so f32 stays f32 (TF32 would lose the 1e-4 tolerance); the same
// per-tile statistics and combine.
//
// Plain C interface for ctypes. The function launches on the given stream,
// does not synchronise and allocates nothing (the wrapper passes c, the
// scratch `part` and the outputs); it returns the CUDA error of the
// launches (cudaErrorInvalidValue for a shape or plan it does not take).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "glow_mma.cuh"

namespace {

constexpr int kCombineThreads = 256;

// ---------------------------------------------------------------------------
// f32: CUDA-core FMA tiles
// ---------------------------------------------------------------------------
namespace f32 {

constexpr int kBM = 64;                 // output pixels per tile
constexpr int kBN = 64;                 // output channels per tile
constexpr int kBK = 32;                 // depth per staged chunk
constexpr int kThreads = 128;           // 4 warps
constexpr int kCS = kBN + 4;            // row stride of the f32 C tile
// row strides of the staged A (kBM x kBK) and B (kBK x kBN) chunks: A is
// padded by one float so the 4 rows a warp reads at one depth fall in 4
// banks
constexpr int kAS = kBK + 1;
constexpr int kBS = kBN + 4;

struct Geometry {
  int h, w, cin, k, wo, hwo, pad, m, depth;
};

// Stage depth chunk [k0, k0 + kBK) of the A tile (gathered from x) and of
// the B tile (rows of w) in shared memory. VA / VB: elements per load.
template <int VA, int VB>
__device__ __forceinline__ void stage_chunk(const float* __restrict__ x,
                                            const float* __restrict__ w, float* as, float* bs,
                                            const long long* row_base, const int* row_iy,
                                            const int* row_ix, const Geometry& g, int k0,
                                            int n0) {
  constexpr int AV = kBK / VA;
  for (int v = threadIdx.x; v < kBM * AV; v += kThreads) {
    const int row = v / AV;
    const int kk = (v - row * AV) * VA;
    const int r = k0 + kk;
    float* dst = as + row * kAS + kk;
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
      *dst = ok ? x[off] : 0.0f;
    } else {
      static_assert(VA * sizeof(float) == 16, "vector loads are 16 bytes");
      float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
      if (ok) val = *reinterpret_cast<const float4*>(x + off);
      dst[0] = val.x;
      dst[1] = val.y;
      dst[2] = val.z;
      dst[3] = val.w;
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
    float* dst = bs + kr * kBS + nn;
    if constexpr (VB == 1) {
      *dst = ok ? w[off] : 0.0f;
    } else {
      static_assert(VB * sizeof(float) == 16, "vector loads are 16 bytes");
      float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
      if (ok) val = *reinterpret_cast<const float4*>(w + off);
      *reinterpret_cast<float4*>(dst) = val;
    }
  }
}

template <int VA, int VB>
__global__ void __launch_bounds__(kThreads)
conv_stats_kernel(const float* __restrict__ x, const float* __restrict__ w,
                  float* __restrict__ c, float* __restrict__ part, Geometry g, int n_mtiles) {
  __shared__ __align__(128) float as[kBM * kAS];
  __shared__ __align__(128) float bs[kBK * kBS];
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

  // 16 x 8 threads; thread (ty, tx) owns rows ty*4 + i and columns tx + 8j
  const int ty = tid >> 3, tx = tid & 7;
  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  for (int k0 = 0; k0 < g.depth; k0 += kBK) {
    __syncthreads();                       // row info ready / last chunk consumed
    stage_chunk<VA, VB>(x, w, as, bs, row_base, row_iy, row_ix, g, k0, n0);
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float a[4], b[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = as[(ty * 4 + i) * kAS + kk];
#pragma unroll
      for (int j = 0; j < 8; ++j) b[j] = bs[kk * kBS + tx + 8 * j];
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

template <int VA, int VB>
cudaError_t launch(const float* x, const float* w, float* c, float* part, const Geometry& g,
                   int n_mtiles, cudaStream_t stream) {
  const dim3 grid(n_mtiles, (g.k + kBN - 1) / kBN);
  conv_stats_kernel<VA, VB><<<grid, kThreads, 0, stream>>>(x, w, c, part, g, n_mtiles);
  return cudaGetLastError();
}

cudaError_t run(const float* x, const float* w, float* c, float* part, const Geometry& g,
                int n_mtiles, cudaStream_t stream) {
  const bool va = g.cin % 4 == 0, vb = g.k % 4 == 0;
  if (va && vb) return launch<4, 4>(x, w, c, part, g, n_mtiles, stream);
  if (va) return launch<4, 1>(x, w, c, part, g, n_mtiles, stream);
  if (vb) return launch<1, 4>(x, w, c, part, g, n_mtiles, stream);
  return launch<1, 1>(x, w, c, part, g, n_mtiles, stream);
}

}  // namespace f32

// ---------------------------------------------------------------------------
// bf16: Conv4x4s2Op on the cp.async ring, products on mma.sync or wgmma
// ---------------------------------------------------------------------------

using mma::bf16;
using mma::FastDiv;

// the tiles conv_stats_plan picks from, by index (0 is the f32 tile): 1
// runs mma_tile (mma.sync), 2 and 3 wgmma_ring_tile
using Tile128x32 = mma::Cfg<128, 32, 2, 1, 5, 2>;
using Tile128x64 = mma::Cfg<128, 64, 2, 2, 3, 3>;
using Tile128x128 = mma::Wide;

// The tile's c rows, and each channel's (mean, M2) over the tile's rows into
// part[n * mtiles + mi] and part[(N + n) * mtiles + mi]: thread (half, n)
// sums half of the rows, then both halves' sums give the mean, then the same
// for the squared deviations (rows in a fixed order)
template <class C>
__device__ __forceinline__ void tile_stats(float* cs, const Tile& t, int M, int N, float* c,
                                           float* part) {
  mma::store_f32<C>(cs, c, t, M, N);
  float* red = cs + C::BM * C::kCS;
  const int col = threadIdx.x % C::BN, half = threadIdx.x / C::BN;
  const int rows = min(C::BM, M - t.m0);
  const int r0 = half * (C::BM / 2), r1 = min(rows, r0 + C::BM / 2);
  float s = 0.0f;
  for (int r = r0; r < r1; ++r) s += cs[r * C::kCS + col];
  red[half * C::BN + col] = s;
  __syncthreads();
  const float mean = (red[col] + red[C::BN + col]) / static_cast<float>(rows);
  __syncthreads();
  float m2 = 0.0f;
  for (int r = r0; r < r1; ++r) {
    const float d = cs[r * C::kCS + col] - mean;
    m2 = fmaf(d, d, m2);
  }
  red[half * C::BN + col] = m2;
  __syncthreads();
  const int n = t.n0 + col;
  if (half == 0 && n < N) {
    part[static_cast<long long>(n) * t.mtiles + t.mi] = mean;
    part[static_cast<long long>(N + n) * t.mtiles + t.mi] = red[col] + red[C::BN + col];
  }
}

// A(m, k) = x at output pixel m's tap k / cin, channel k % cin (depth
// (ky, kx, ci)); B(k, n) = w[n, k], read K-major. RUN 8: A in 16-byte runs
// (cin % 8 == 0, or cin == 4 with padding 0 and an even width: two taps a
// run); RUN 0: element by element (wa = 1). The kernel sets `rows` and `m0`:
// its tile's pixel table in shared memory (per row: the window's first
// input row and column, and b * h), so a run costs one table read and one
// division of its depth index.
template <int RUN>
struct Conv4x4s2Op {
  static constexpr bool kAK = true;
  static constexpr int kRunA = RUN;
  static constexpr bool kBKMajor = true;
  const bf16* x;
  const bf16* w;
  float* c;
  float* part;    // per-tile statistics
  float* cpart;   // split partial tiles (splits > 1)
  int h, wd, cin, wo, hwo, pad, depth, splits;
  FastDiv hwod, wod, cind;
  int wa = 1;
  const int4* rows = nullptr;
  int m0 = 0;
  __device__ const void* any() const { return x; }
  // the table entry of output pixel m (past the last pixel: all taps out)
  __device__ int4 row_of(int m, int M) const {
    if (m >= M) return make_int4(-(1 << 28), 0, 0, 0);
    const int b = hwod.div(m), r = m - b * hwo;
    const int oy = wod.div(r), ox = r - oy * wo;
    return make_int4(2 * oy - pad, 2 * ox - pad, b * h, 0);
  }
  __device__ long long a_at(int m, int k) const {
    const int4 e = rows[m - m0];
    const int tap = cind.div(k), ci = k - tap * cin;
    const int iy = e.x + (tap >> 2), ix = e.y + (tap & 3);
    return iy >= 0 && iy < h && ix >= 0 && ix < wd
               ? (static_cast<long long>(e.z + iy) * wd + ix) * cin + ci
               : -1;
  }
  __device__ mma::Src a_src(int m, int k) const {
    const long long o = a_at(m, k);
    return o < 0 ? mma::Src{x, mma::kZero} : mma::Src{x + o, mma::kCopy};
  }
  __device__ bf16 a_elt(int m, int k) const {
    const long long o = a_at(m, k);
    return o < 0 ? __float2bfloat16(0.0f) : x[o];
  }
  __device__ mma::Src b_src(int k, int n) const {
    return mma::Src{w + static_cast<long long>(n) * depth + k, mma::kCopy};
  }
  template <class C>
  __device__ void epilogue(float* cs, const Tile& t, int M, int N) const {
    if (splits == 1) {
      tile_stats<C>(cs, t, M, N, c, part);
    } else {
      mma::store_f32<C>(cs, cpart + static_cast<long long>(t.z) * M * N, t, M, N);
    }
  }
};

__device__ __forceinline__ Tile grid_tile(int bm, int bn) {
  return Tile{static_cast<int>(blockIdx.x) * bm, static_cast<int>(blockIdx.y) * bn,
              static_cast<int>(blockIdx.z), static_cast<int>(blockIdx.x),
              static_cast<int>(gridDim.x)};
}

// wgmma on the same cp.async ring: mma::wgmma_ring_tile (glow_mma.cuh, shared
// with K6)

// the dynamic shared memory of a tile: 1024 bytes of alignment slack (the
// wgmma swizzle), the ring (or the f32 tile), then the pixel table
template <class C>
constexpr int mma_smem() {
  return 1024 + C::kSmemBytes + C::BM * static_cast<int>(sizeof(int4));
}

template <class C, class Op, bool WGMMA>
__global__ void __launch_bounds__(C::kThreads, C::kMinBlocks)
conv_stats_mma_kernel(const Op op, int M, int N, int K, int k_split) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const Tile t = grid_tile(C::BM, C::BN);
  int4* rows = reinterpret_cast<int4*>(smem + C::kSmemBytes);
  for (int r = threadIdx.x; r < C::BM; r += C::kThreads) rows[r] = op.row_of(t.m0 + r, M);
  Op tile_op = op;
  tile_op.rows = rows;
  tile_op.m0 = t.m0;
  if constexpr (WGMMA) {  // both sync before their loads
    mma::wgmma_ring_tile<C>(tile_op, M, N, K, k_split, t, smem);
  } else {
    mma::mma_tile<C>(tile_op, M, N, K, k_split, t, smem);
  }
}

// The split sum works on 16 x 64 pieces of the output, whatever the tile of
// the products (128 threads, two of 8 rows per column for the statistics;
// only the sizes of this Cfg are used), so that even dis5's 1024 x 512
// output makes 512 blocks
using Finish = mma::Cfg<16, 64, 1, 4, 8, 2>;

// One block per 16 x 64 piece: the splits' partial tiles summed in split
// order, then c and the piece's statistics as in the unsplit epilogue
__global__ void __launch_bounds__(Finish::kThreads)
conv_stats_finish_kernel(const float* __restrict__ cpart, float* __restrict__ c,
                         float* __restrict__ part, int M, int N, int splits) {
  __shared__ __align__(16) float cs[Finish::BM * Finish::kCS + 2 * Finish::BN];
  const Tile t = grid_tile(Finish::BM, Finish::BN);
  const long long mn = static_cast<long long>(M) * N;
  for (int v = threadIdx.x; v < Finish::BM * Finish::BN / 4; v += Finish::kThreads) {
    const int r = v / (Finish::BN / 4), cc = (v % (Finish::BN / 4)) * 4;
    const int m = t.m0 + r, n = t.n0 + cc;
    float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (m < M && n < N) {
      const float* p = cpart + static_cast<long long>(m) * N + n;
      if (N % 4 == 0) {
        for (int z = 0; z < splits; ++z) {
          const float4 q = *reinterpret_cast<const float4*>(p + z * mn);
          s[0] += q.x;
          s[1] += q.y;
          s[2] += q.z;
          s[3] += q.w;
        }
      } else {
        for (int z = 0; z < splits; ++z)
          for (int j = 0; j < 4 && n + j < N; ++j) s[j] += p[z * mn + j];
      }
    }
    *reinterpret_cast<float4*>(cs + r * Finish::kCS + cc) = make_float4(s[0], s[1], s[2], s[3]);
  }
  __syncthreads();
  tile_stats<Finish>(cs, t, M, N, c, part);
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

// One block per channel: every row tile's partial (bm rows each, the last
// one ragged), in a fixed order: thread i merges tiles i, i + 256, ... (8
// loads in flight at a time), then a tree over the threads.
__global__ void __launch_bounds__(kCombineThreads)
combine_stats_kernel(const float* __restrict__ part, float* __restrict__ mean,
                     float* __restrict__ var, int k, int n_mtiles, int m, int bm) {
  constexpr int kBatch = 8;
  __shared__ float sn[kCombineThreads], sm[kCombineThreads], sm2[kCombineThreads];
  const int n = blockIdx.x;
  const int tid = threadIdx.x;
  float cnt = 0.0f, mu = 0.0f, m2 = 0.0f;
  const float* pm = part + static_cast<long long>(n) * n_mtiles;
  const float* pm2 = part + static_cast<long long>(k + n) * n_mtiles;
  for (int t0 = tid; t0 < n_mtiles; t0 += kBatch * kCombineThreads) {
    float bmu[kBatch], bm2[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int t = t0 + j * kCombineThreads;
      bmu[j] = t < n_mtiles ? pm[t] : 0.0f;
      bm2[j] = t < n_mtiles ? pm2[t] : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int t = t0 + j * kCombineThreads;
      if (t < n_mtiles)
        chan_merge(cnt, mu, m2, static_cast<float>(min(bm, m - t * bm)), bmu[j], bm2[j]);
    }
  }
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

// The plan kernels.conv_stats_plan makes: the tile (0: the f32 64 x 64
// tile; 1, 2, 3: the bf16 128 x 32, 128 x 64, 128 x 128 tiles), the
// reduction splits and their depth
struct Plan {
  int tile, splits, k_split;
};

struct Shape {
  int b, h, w, cin, k, pad, ho, wo;
  long long m() const { return static_cast<long long>(b) * ho * wo; }
  int depth() const { return 16 * cin; }
};

template <class C>
long long m_tiles(long long m) {
  return (m + C::BM - 1) / C::BM;
}

// floats of `part`: the per-tile statistics (2 K tiles: the product tiles'
// rows, or with splits > 1 the split sum's 16-row pieces), then, with
// splits > 1 and from a 128-byte boundary, the splits' partial tiles
template <class C>
long long part_floats(const Shape& s, int splits) {
  if (splits == 1) return 2LL * s.k * m_tiles<C>(s.m());
  const long long stats = 2LL * s.k * m_tiles<Finish>(s.m());
  return (stats + 31) / 32 * 32 + splits * s.m() * s.k;
}

long long plan_part_floats(const Shape& s, int tile, int splits) {
  switch (tile) {
    case 0: return splits == 1 ? 2LL * s.k * ((s.m() + f32::kBM - 1) / f32::kBM) : -1;
    case 1: return part_floats<Tile128x32>(s, splits);
    case 2: return part_floats<Tile128x64>(s, splits);
    case 3: return part_floats<Tile128x128>(s, splits);
    default: return -1;
  }
}

template <class C, bool WGMMA, class Op>
cudaError_t run_tile(const Op& op, const Shape& s, const Plan& p, float* mean, float* var,
                     cudaStream_t stream) {
  const int m = static_cast<int>(s.m());
  const dim3 grid(static_cast<unsigned>(m_tiles<C>(m)), (s.k + C::BN - 1) / C::BN, p.splits);
  cudaError_t err = cudaFuncSetAttribute(conv_stats_mma_kernel<C, Op, WGMMA>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         mma_smem<C>());
  if (err != cudaSuccess) return err;
  conv_stats_mma_kernel<C, Op, WGMMA><<<grid, C::kThreads, mma_smem<C>(), stream>>>(
      op, m, s.k, s.depth(), p.k_split);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  int stat_tiles = static_cast<int>(grid.x), stat_rows = C::BM;
  if (p.splits > 1) {
    stat_tiles = static_cast<int>(m_tiles<Finish>(m));
    stat_rows = Finish::BM;
    conv_stats_finish_kernel<<<dim3(stat_tiles, (s.k + Finish::BN - 1) / Finish::BN),
                               Finish::kThreads, 0, stream>>>(op.cpart, op.c, op.part, m,
                                                               s.k, p.splits);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  combine_stats_kernel<<<s.k, kCombineThreads, 0, stream>>>(op.part, mean, var, s.k,
                                                           stat_tiles, m, stat_rows);
  return cudaGetLastError();
}

template <int RUN>
cudaError_t run_bf16(const bf16* x, const bf16* w, float* c, float* part, float* mean,
                     float* var, const Shape& s, const Plan& p, cudaStream_t stream) {
  Conv4x4s2Op<RUN> op;
  op.x = x;
  op.w = w;
  op.c = c;
  op.part = part;
  op.cpart = part + (2LL * s.k * m_tiles<Finish>(s.m()) + 31) / 32 * 32;
  op.h = s.h;
  op.wd = s.w;
  op.cin = s.cin;
  op.wo = s.wo;
  op.hwo = s.ho * s.wo;
  op.pad = s.pad;
  op.depth = s.depth();
  op.splits = p.splits;
  op.hwod = FastDiv(static_cast<unsigned>(s.ho * s.wo));
  op.wod = FastDiv(static_cast<unsigned>(s.wo));
  op.cind = FastDiv(static_cast<unsigned>(s.cin));
  switch (p.tile) {
    case 1: return run_tile<Tile128x32, false>(op, s, p, mean, var, stream);
    case 2: return run_tile<Tile128x64, true>(op, s, p, mean, var, stream);
    case 3: return run_tile<Tile128x128, true>(op, s, p, mean, var, stream);
    default: return cudaErrorInvalidValue;
  }
}

bool make_shape(int b, int h, int w, int cin, int k, int pad, Shape& s) {
  if (b < 1 || cin < 1 || k < 1 || (pad != 0 && pad != 1)) return false;
  if (h + 2 * pad < 4 || w + 2 * pad < 4) return false;
  s = Shape{b, h, w, cin, k, pad, (h + 2 * pad - 4) / 2 + 1, (w + 2 * pad - 4) / 2 + 1};
  return s.m() < (1LL << 31) - 128 && 16LL * cin < (1LL << 31) &&
         static_cast<long long>(b) * h * w * cin < (1LL << 62) && (k + 31) / 32 <= 65535;
}

}  // namespace

// Floats of the scratch `part` that vgd_conv_bn_stats writes under a plan's
// tile and splits, or -1 for a shape or plan it does not take.
extern "C" long long vgd_conv_stats_part_floats(int b, int h, int w, int cin, int k, int pad,
                                                int tile, int splits) {
  Shape s;
  if (!make_shape(b, h, w, cin, k, pad, s) || splits < 1) return -1;
  return plan_part_floats(s, tile, splits);
}

// c, mean and var of the conv of x with w under the plan (tile, splits,
// k_split, run: the elements per gather of A, 8 or 1 for bf16, 4 or 1 for
// f32); `part` holds part_size floats of scratch.
extern "C" int vgd_conv_bn_stats(const void* x, const void* w, float* c, float* part,
                                 float* mean, float* var, int b, int h, int w_in, int cin,
                                 int k, int pad, int bf16_operands, int tile, int splits,
                                 int k_split, int run, long long part_size, void* stream) {
  Shape s;
  if (!make_shape(b, h, w_in, cin, k, pad, s)) return cudaErrorInvalidValue;
  const Plan p{tile, splits, k_split};
  const long long need = splits >= 1 ? plan_part_floats(s, tile, splits) : -1;
  if (need < 0 || part_size < need || splits > 65535) return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  if (!bf16_operands) {
    if (tile != 0 || run != (cin % 4 == 0 ? 4 : 1)) return cudaErrorInvalidValue;
    const int m = static_cast<int>(s.m());
    const f32::Geometry g{h, w_in, cin, k, s.wo, s.ho * s.wo, pad, m, s.depth()};
    const int n_mtiles = (m + f32::kBM - 1) / f32::kBM;
    const cudaError_t err = f32::run(static_cast<const float*>(x), static_cast<const float*>(w),
                                     c, part, g, n_mtiles, st);
    if (err != cudaSuccess) return err;
    combine_stats_kernel<<<k, kCombineThreads, 0, st>>>(part, mean, var, k, n_mtiles, m,
                                                        f32::kBM);
    return cudaGetLastError();
  }
  // the splits cover the depth in whole 64-deep stages, none empty
  if (tile < 1 || k_split < mma::kBK || k_split % mma::kBK != 0 ||
      static_cast<long long>(splits) * k_split < s.depth() ||
      static_cast<long long>(splits - 1) * k_split >= s.depth())
    return cudaErrorInvalidValue;
  // 16-byte runs only where each is aligned and inside one kernel row
  const bool aligned = cin % 8 == 0 || (cin == 4 && pad == 0 && w_in % 2 == 0);
  if (run != 1 && !(run == 8 && aligned)) return cudaErrorInvalidValue;
  const auto* xb = static_cast<const bf16*>(x);
  const auto* wb = static_cast<const bf16*>(w);
  return run == 8 ? run_bf16<8>(xb, wb, c, part, mean, var, s, p, st)
                  : run_bf16<0>(xb, wb, c, part, mean, var, s, p, st);
}

extern "C" const char* vgd_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
