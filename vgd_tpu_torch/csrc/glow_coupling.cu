// The Glow additive-coupling network NN(ya) = ZeroConv(ReLU(Conv1x1(ReLU(
// Conv(ya))))) * exp(3 * scale), forward and its two backward passes, for
// Hopper (sm_90a).
//
// Replaces the TPU kernels of vgd_tpu/ops/glow_coupling.py: _fwd_kernel
// (called through _fwd_pallas), _bwd1_kernel and _bwd2_kernel (both through
// _bwd_pallas), the custom VJP of glow_coupling_nn. The math is theirs:
//
// * h1 = cd(ReLU(conv_kh x kw(ya, zero padding) + b1)), cd the compute dtype
//   (bf16 on the main path, f32 for checks), products of cd operands summed
//   in f32, bias and ReLU in f32, then the rounding to cd;
// * h2 = cd(ReLU(h1 @ W2 + b2));
// * convz = conv(h2 padded with the VALUE 1, Wz in cd) + bz, out = convz *
//   exp(3 * scale), f32;
// * backward 1 recomputes h1 and h2 (h1 is written out in cd for backward
//   2), gs = g * exp(3 scale), dscale = 3 sum(g convz exp(3 scale)), dbz =
//   sum(gs), dWz over the padded grid (the value-1 border contributes),
//   dh2 = corr(cd(gs), Wz) on the interior masked by h2 > 0 (the mask from
//   the cd values), db2 = sum(dh2) in f32, dh2 written out in cd;
// * backward 2: dW2 = h1^T dh2, dh1 = dh2 W2^T masked by h1 > 0, db1 =
//   sum(dh1), dW1 = im2col(ya)^T cd(dh1), dya = corr(cd(dh1), W1), f32.
//
// What bounds it on the H100. At the reference Glow (64x64, batch 16, K=32,
// L=4, width 512) one train step sends 1.9 TFLOP through these functions:
// with bf16 operands on the tensor cores (989 TFLOP/s) that is about 1.9 ms,
// while the 512-wide intermediates (16.8 MB per tensor in bf16 at block 0)
// cost 5 us each at 3.35 TB/s, so the work is bound by operations. h1, h2,
// dh2 and dh1 go through device memory (they stay in the 50 MB L2 at the
// smaller blocks); every product runs on the tensor cores.
//
// bf16, the main path (the tiles are in glow_mma.cuh):
// * the f x f products (conv2, dh1, dW2) run on wgmma (wgmma_tile): 128 x
//   128 tiles, two warpgroups, operands brought by TMA into a 3-stage
//   mbarrier ring in the 128-byte swizzle; conv2 takes the mma.sync tile
//   instead where fewer than 128 tiles would run;
// * every other product runs on mma_tile: a 3-stage cp.async ring of
//   swizzled 64-deep stages into ldmatrix and mma.sync m16n8k16 (f32
//   accumulators), 128 x 128 or 64 x 64 tiles;
// * the Op of a product gathers its operands (conv taps with their zero or
//   value-1 padding, transposed weight-gradient operands) and owns the
//   epilogue (bias, ReLU, rounding to cd, masks, per-tile column sums).
// * The ZeroConv and dya use the TPU kernel's shared-LHS N-pack instead of
//   a GEMM with N = 6..48 columns over a depth of 9 * 512: r = [h2; 1] @ Wzr
//   (N = taps * cout, K = f) over the interior pixels plus one row of ones,
//   whose product is the value-1 border's row of r (the column sums of
//   Wzr), then a fixed-order shift-sum over the taps assembles convz (and,
//   in the forward, + bz, x exp(3 scale)); dya = the zero-bordered
//   shift-sum of r2 = cd(dh1) @ W1r. Wzr and W1r are read in place, as
//   K-major B operands, from the (taps * ch, f) packings wzf and w1f.
// * Weight gradients reduce over up to 18,496 pixels on few output tiles:
//   their reductions are split so that about 264 blocks run (the split
//   depends on the shapes only), each split writes its partial tile, and
//   one finishing kernel per pass adds every partial and every per-tile
//   column sum in a fixed order (and, in backward 2, assembles dya). No
//   atomics, so training is deterministic run to run.
// * Launches per call: forward 4 (conv1, conv2, the ZeroConv's N-pack, its
//   shift-sum), backward 1 7 (conv1, conv2, the N-pack, the shift-sum with
//   gs / dscale / dbz partials, dWz, dh2, finish; 6 where dWz and dh2 share
//   a launch, at few pixels), backward 2 3 (dW2 beside dh1, dW1 beside dya's
//   N-pack, finish): independent products share a launch, their blocks side
//   by side.
//
// f32, the checks only: the same math on the CUDA cores through
// glow_gemm.cuh's gemm_tile (shared with K6), ZeroConv and dya as K = 9 *
// f GEMMs with split reductions.
//
// Not yet done (later work): keeping h1/h2 on chip (the TPU design),
// fusing the ZeroConv's N-pack into the conv2 epilogue, wider wgmma tiles
// (conv2 re-reads W2 from L2 once per 128-row tile), gathering the 6 and 12
// flow channels of conv1 and dW1 in 16-byte runs (they take 4-byte copies).
//
// Plain C interface for ctypes. Every entry point launches on the given
// stream, does not synchronise and allocates nothing (the wrapper passes
// outputs and scratch); it returns the CUDA error of its launches
// (cudaErrorInvalidValue for a shape it does not take).

#include "glow_mma.cuh"

namespace {

// ---------------------------------------------------------------------------
// f32: the CUDA-core path (checks only)
// ---------------------------------------------------------------------------

// one launch of one stage: block (x, y, z) computes output tile (x, y) of
// reduction split z
template <typename T, class Op>
__global__ void __launch_bounds__(kThreads)
glow_gemm_kernel(const Op op, int M, int N, int K, int k_split) {
  __shared__ __align__(128) Smem<T> sm;
  gemm_tile<T>(op, M, N, K, k_split,
               Tile{static_cast<int>(blockIdx.x) * kBM, static_cast<int>(blockIdx.y) * kBN,
                    static_cast<int>(blockIdx.z), static_cast<int>(blockIdx.x),
                    static_cast<int>(gridDim.x)},
               sm);
}

// out[i] = sum over splits of part[s][i], in split order, then + bias[c]
// and x exp(3 scale[c]) for column c = i % cols where given
__global__ void glow_sum_splits(const float* __restrict__ part, float* __restrict__ out,
                                long long n, int splits, int cols,
                                const float* __restrict__ bias,
                                const float* __restrict__ scale) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.0f;
  for (int z = 0; z < splits; ++z) s += part[z * n + i];
  const int c = static_cast<int>(i % cols);
  if (bias != nullptr) s += bias[c];
  if (scale != nullptr) s *= expf(scale[c] * 3.0f);
  out[i] = s;
}

// fixed-order tree sum of a block's per-thread values; thread 0 gets it
__device__ __forceinline__ float block_sum(float v, float* red) {
  const int tid = threadIdx.x;
  red[tid] = v;
  __syncthreads();
  for (int s = kReduceThreads / 2; s > 0; s >>= 1) {
    if (tid < s) red[tid] += red[tid + s];
    __syncthreads();
  }
  const float total = red[0];
  __syncthreads();
  return total;
}

// out[n] = sum over row tiles of colpart[n * tiles + t]; one block a column
__global__ void __launch_bounds__(kReduceThreads)
glow_sum_columns(const float* __restrict__ colpart, float* __restrict__ out, int tiles) {
  __shared__ float red[kReduceThreads];
  const float* p = colpart + static_cast<long long>(blockIdx.x) * tiles;
  float s = 0.0f;
  for (int t = threadIdx.x; t < tiles; t += kReduceThreads) s += p[t];
  s = block_sum(s, red);
  if (threadIdx.x == 0) out[blockIdx.x] = s;
}

// One block per ZeroConv output channel c: gs = g exp(3 scale) (written in
// cd), dscale = 3 sum(g convz exp(3 scale)), dbz = sum(gs)
template <typename T>
__global__ void __launch_bounds__(kReduceThreads)
glow_zeroconv_grad(const float* __restrict__ g, const float* __restrict__ convz,
                   const float* __restrict__ scale, T* __restrict__ gs,
                   float* __restrict__ dscale, float* __restrict__ dbz, int p, int cout) {
  __shared__ float red[kReduceThreads];
  const int c = blockIdx.x;
  const float e = expf(scale[c] * 3.0f);
  float s1 = 0.0f, s2 = 0.0f;
  for (int i = threadIdx.x; i < p; i += kReduceThreads) {
    const long long j = static_cast<long long>(i) * cout + c;
    const float gv = g[j];
    const float gsv = gv * e;
    gs[j] = from_float<T>(gsv);
    s1 += gv * convz[j] * e;
    s2 += gsv;
  }
  s1 = block_sum(s1, red);
  s2 = block_sum(s2, red);
  if (threadIdx.x == 0) {
    dscale[c] = 3.0f * s1;
    dbz[c] = s2;
  }
}

template <typename T, class Op>
cudaError_t gemm(const Op& op, int M, int N, int K, const Split& sp, cudaStream_t st) {
  const dim3 grid((M + kBM - 1) / kBM, (N + kBN - 1) / kBN, sp.splits);
  glow_gemm_kernel<T, Op><<<grid, kThreads, 0, st>>>(op, M, N, K, sp.k_split);
  return cudaGetLastError();
}

// split GEMM into `part`, then the fixed-order sum into `out` (M x N),
// with the optional per-column bias and exp(3 scale) factor
template <typename T, class Op>
cudaError_t split_gemm(const Op& op, float* part, float* out, int M, int N, int K,
                       cudaStream_t st, const float* bias = nullptr,
                       const float* scale = nullptr) {
  const Split sp = split_k(M, N, K, true);
  cudaError_t err = gemm<T>(op, M, N, K, sp, st);
  if (err != cudaSuccess) return err;
  const long long n = static_cast<long long>(M) * N;
  glow_sum_splits<<<static_cast<unsigned>((n + 255) / 256), 256, 0, st>>>(
      part, out, n, sp.splits, N, bias, scale);
  return cudaGetLastError();
}

long long part_floats(const Geo& g) {
  const int taps = g.kh * g.kw;
  const int p = g.b * g.h * g.w;
  const int q = g.b * (g.h + 2 * g.ph) * (g.w + 2 * g.pw);
  const long long sizes[6] = {
      static_cast<long long>(split_k(p, g.cout, taps * g.f, true).splits) * p * g.cout,
      static_cast<long long>(split_k(p, g.cin, taps * g.f, true).splits) * p * g.cin,
      static_cast<long long>(split_k(g.f, taps * g.cout, q, true).splits) * g.f * taps * g.cout,
      static_cast<long long>(split_k(g.f, g.f, p, true).splits) * g.f * g.f,
      static_cast<long long>(split_k(taps * g.cin, g.f, p, true).splits) * taps * g.cin * g.f,
      static_cast<long long>(g.f) * ((p + kBM - 1) / kBM)};
  long long most = 0;
  for (long long s : sizes) most = s > most ? s : most;
  return most;
}

template <typename T>
cudaError_t forward_hidden(const Geo& g, const T* ya, const T* w1f, const float* b1, const T* w2,
                           const float* b2, T* h1, T* h2, cudaStream_t st) {
  const int p = g.b * g.h * g.w;
  const int taps = g.kh * g.kw;
  const bool vf = div_vec<T>(g.f);
  cudaError_t err = gemm<T>(vec(Conv1Op<T>{g, ya, w1f, b1, h1}, div_vec<T>(g.cin), vf), p, g.f,
                            taps * g.cin, split_k(p, g.f, taps * g.cin, false), st);
  if (err != cudaSuccess) return err;
  return gemm<T>(vec(Conv2Op<T>{g, h1, w2, b2, h2}, vf, vf), p, g.f, g.f,
                 split_k(p, g.f, g.f, false), st);
}

template <typename T>
cudaError_t fwd(const Geo& g, const void* ya, const void* w1f, const float* b1, const void* w2,
                const float* b2, const void* wz, const float* bz, const float* scale, float* out,
                void* h1, void* h2, float* part, cudaStream_t st) {
  const int p = g.b * g.h * g.w;
  const int kz = g.kh * g.kw * g.f;
  cudaError_t err = forward_hidden<T>(g, static_cast<const T*>(ya), static_cast<const T*>(w1f),
                                      b1, static_cast<const T*>(w2), b2, static_cast<T*>(h1),
                                      static_cast<T*>(h2), st);
  if (err != cudaSuccess) return err;
  return split_gemm<T>(
      vec(ZeroConvOp<T>{g, static_cast<const T*>(h2), static_cast<const T*>(wz), part},
          div_vec<T>(g.f), div_vec<T>(g.cout)),
      part, out, p, g.cout, kz, st, bz, scale);
}

template <typename T>
cudaError_t bwd1(const Geo& g, const void* ya, const void* w1f, const float* b1, const void* w2,
                 const float* b2, const void* wz, const void* wzf, const float* bz,
                 const float* scale, const float* grad, void* h1, void* dh2, float* dwz,
                 float* dbz, float* db2, float* dscale, void* h2, float* convz, void* gs,
                 float* part, cudaStream_t st) {
  const int p = g.b * g.h * g.w;
  const int q = g.b * (g.h + 2 * g.ph) * (g.w + 2 * g.pw);
  const int taps = g.kh * g.kw;
  T* h2t = static_cast<T*>(h2);
  T* gst = static_cast<T*>(gs);
  cudaError_t err = forward_hidden<T>(g, static_cast<const T*>(ya), static_cast<const T*>(w1f),
                                      b1, static_cast<const T*>(w2), b2, static_cast<T*>(h1),
                                      h2t, st);
  if (err != cudaSuccess) return err;
  const bool vf = div_vec<T>(g.f), vc = div_vec<T>(g.cout);
  err = split_gemm<T>(vec(ZeroConvOp<T>{g, h2t, static_cast<const T*>(wz), part}, vf, vc), part,
                      convz, p, g.cout, taps * g.f, st, bz);
  if (err != cudaSuccess) return err;
  glow_zeroconv_grad<T><<<g.cout, kReduceThreads, 0, st>>>(grad, convz, scale, gst, dscale, dbz,
                                                            p, g.cout);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = split_gemm<T>(vec(DwzOp<T>{g, h2t, gst, part}, vf, vc), part, dwz, g.f, taps * g.cout, q,
                      st);
  if (err != cudaSuccess) return err;
  err = gemm<T>(
      vec(Dh2Op<T>{g, gst, static_cast<const T*>(wzf), h2t, static_cast<T*>(dh2), part}, vc, vf),
      p, g.f, taps * g.cout, split_k(p, g.f, taps * g.cout, false), st);
  if (err != cudaSuccess) return err;
  glow_sum_columns<<<g.f, kReduceThreads, 0, st>>>(part, db2, (p + kBM - 1) / kBM);
  return cudaGetLastError();
}

template <typename T>
cudaError_t bwd2(const Geo& g, const void* ya, const void* w1t, const void* w2t, const void* h1,
                 const void* dh2, float* dya, float* dw1, float* db1, float* dw2, void* dh1,
                 float* part, cudaStream_t st) {
  const int p = g.b * g.h * g.w;
  const int taps = g.kh * g.kw;
  const T* h1t = static_cast<const T*>(h1);
  const T* dh2t = static_cast<const T*>(dh2);
  T* dh1t = static_cast<T*>(dh1);
  const bool vf = div_vec<T>(g.f), vi = div_vec<T>(g.cin);
  cudaError_t err =
      split_gemm<T>(vec(Dw2Op<T>{g, h1t, dh2t, part}, vf, vf), part, dw2, g.f, g.f, p, st);
  if (err != cudaSuccess) return err;
  err = gemm<T>(vec(Dh1Op<T>{g, dh2t, static_cast<const T*>(w2t), h1t, dh1t, part}, vf, vf), p,
                g.f, g.f, split_k(p, g.f, g.f, false), st);
  if (err != cudaSuccess) return err;
  glow_sum_columns<<<g.f, kReduceThreads, 0, st>>>(part, db1, (p + kBM - 1) / kBM);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = split_gemm<T>(vec(Dw1Op<T>{g, static_cast<const T*>(ya), dh1t, part}, vi, vf), part,
                      dw1, taps * g.cin, g.f, p, st);
  if (err != cudaSuccess) return err;
  return split_gemm<T>(vec(DyaOp<T>{g, dh1t, static_cast<const T*>(w1t), part}, vf, vi), part,
                       dya, p, g.cin, taps * g.f, st);
}


// ---------------------------------------------------------------------------
// bf16: the tensor-core path
// ---------------------------------------------------------------------------

using mma::bf16;
using mma::Small;
using mma::Wide;

constexpr int kZPix = 32;         // pixels per block of the ZeroConv's shift
constexpr int kFinishThreads = 256;

// One GEMM of a launch: its sizes, reduction split and grid of tiles (x
// along M, y along N, z the splits), as a range of blocks. A launch runs one
// GEMM, or two independent ones side by side (their blocks one after the
// other), so that two small products fill the card together.
struct Job {
  int M = 0, N = 0, K = 0, k_split = 0, tx = 1, ty = 1, blocks = 0;
};

template <class C>
Job job(int M, int N, int K, const mma::KSplit& sp) {
  Job j{M, N, K, sp.k_split, (M + C::BM - 1) / C::BM, (N + C::BN - 1) / C::BN, 0};
  j.blocks = j.tx * j.ty * sp.splits;
  return j;
}

template <class C>
__device__ __forceinline__ Tile tile_of(const Job& j, int b) {
  const int x = b % j.tx, y = (b / j.tx) % j.ty;
  return Tile{x * C::BM, y * C::BN, b / (j.tx * j.ty), x, j.tx};
}

// the second GEMM of a launch that runs one
struct NoOp {};

template <class C, class Op1, class Op2>
__global__ void __launch_bounds__(C::kThreads, C::kMinBlocks)
glow_mma_kernel(const Op1 o1, const Job j1, const Op2 o2, const Job j2) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int b = blockIdx.x;
  if constexpr (std::is_same<Op2, NoOp>::value) {
    mma::mma_tile<C>(o1, j1.M, j1.N, j1.K, j1.k_split, tile_of<C>(j1, b), smem);
  } else if (b < j1.blocks) {
    mma::mma_tile<C>(o1, j1.M, j1.N, j1.K, j1.k_split, tile_of<C>(j1, b), smem);
  } else {
    mma::mma_tile<C>(o2, j2.M, j2.N, j2.K, j2.k_split, tile_of<C>(j2, b - j1.blocks), smem);
  }
}

template <class C, class Op1, class Op2>
cudaError_t mma_launch(const Op1& o1, const Job& j1, const Op2& o2, const Job& j2,
                       cudaStream_t st) {
  const cudaError_t err = cudaFuncSetAttribute(
      glow_mma_kernel<C, Op1, Op2>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmemBytes);
  if (err != cudaSuccess) return err;
  glow_mma_kernel<C, Op1, Op2>
      <<<j1.blocks + j2.blocks, C::kThreads, C::kSmemBytes, st>>>(o1, j1, o2, j2);
  return cudaGetLastError();
}

template <class C, class Op>
cudaError_t mma_gemm(const Op& op, int M, int N, int K, const mma::KSplit& sp,
                     cudaStream_t st) {
  return mma_launch<C>(op, job<C>(M, N, K, sp), NoOp{}, Job{}, st);
}

// the wgmma products, one or two a launch; ta / tb: each GEMM's tensor maps
template <class Op1, class Op2>
__global__ void __launch_bounds__(Wide::kThreads, 2)
glow_wgmma_kernel(const __grid_constant__ CUtensorMap ta1, const __grid_constant__ CUtensorMap tb1,
                  const Op1 o1, const Job j1, const __grid_constant__ CUtensorMap ta2,
                  const __grid_constant__ CUtensorMap tb2, const Op2 o2, const Job j2) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const int b = blockIdx.x;
  if constexpr (std::is_same<Op2, NoOp>::value) {
    mma::wgmma_tile(&ta1, &tb1, o1, j1.M, j1.N, j1.K, j1.k_split, tile_of<Wide>(j1, b), smem);
  } else if (b < j1.blocks) {
    mma::wgmma_tile(&ta1, &tb1, o1, j1.M, j1.N, j1.K, j1.k_split, tile_of<Wide>(j1, b), smem);
  } else {
    mma::wgmma_tile(&ta2, &tb2, o2, j2.M, j2.N, j2.K, j2.k_split,
                    tile_of<Wide>(j2, b - j1.blocks), smem);
  }
}

// the tensor maps of C = A B: a is A's tensor (M x K if Op::kAK, else K x
// M), b is B's (K x N), both row-major bf16
template <class Op>
bool wgmma_maps(const bf16* a, const bf16* b, const Job& j, CUtensorMap* ta, CUtensorMap* tb) {
  const bool ok = Op::kAK ? mma::tensor_map(ta, a, j.M, j.K, mma::kBK, Wide::BM)
                          : mma::tensor_map(ta, a, j.K, j.M, 64, mma::kBK);
  return ok && mma::tensor_map(tb, b, j.K, j.N, 64, mma::kBK);
}

template <class Op1, class Op2>
cudaError_t wgmma_launch(const Op1& o1, const bf16* a1, const bf16* b1, const Job& j1,
                         const Op2& o2, const bf16* a2, const bf16* b2, const Job& j2,
                         cudaStream_t st) {
  CUtensorMap ta1, tb1, ta2, tb2;
  if (!wgmma_maps<Op1>(a1, b1, j1, &ta1, &tb1)) return cudaErrorInvalidValue;
  if constexpr (std::is_same<Op2, NoOp>::value) {
    ta2 = ta1;
    tb2 = tb1;
  } else if (!wgmma_maps<Op2>(a2, b2, j2, &ta2, &tb2)) {
    return cudaErrorInvalidValue;
  }
  const cudaError_t err = cudaFuncSetAttribute(
      glow_wgmma_kernel<Op1, Op2>, cudaFuncAttributeMaxDynamicSharedMemorySize, mma::kWSmemBytes);
  if (err != cudaSuccess) return err;
  glow_wgmma_kernel<Op1, Op2><<<j1.blocks + j2.blocks, Wide::kThreads, mma::kWSmemBytes, st>>>(
      ta1, tb1, o1, j1, ta2, tb2, o2, j2);
  return cudaGetLastError();
}

template <class Op>
cudaError_t wgmma_gemm(const Op& op, const bf16* a, const bf16* b, int M, int N, int K,
                       const mma::KSplit& sp, cudaStream_t st) {
  return wgmma_launch(op, a, b, job<Wide>(M, N, K, sp), NoOp{}, a, b, Job{}, st);
}

// the pixel products (M = p) take 128 x 128 tiles where those give about a
// tile an SM or more, else 64 x 64 ones
bool wide(int p, int n) {
  return static_cast<long long>(mma::mtiles<Wide>(p)) * ((n + Wide::BN - 1) / Wide::BN) >= 128;
}

// row tiles of a pixel product (M = p, N = n): its per-tile column sums
int pixel_tiles(int p, int n) { return wide(p, n) ? mma::mtiles<Wide>(p) : mma::mtiles<Small>(p); }

// conv1 and dh2: the mma.sync tile of either size
template <class Op>
cudaError_t pixel_gemm(const Op& op, int M, int N, int K, cudaStream_t st) {
  if (wide(M, N)) return mma_gemm<Wide>(op, M, N, K, mma::ksplit<Wide>(M, N, K, false), st);
  return mma_gemm<Small>(op, M, N, K, mma::ksplit<Small>(M, N, K, false), st);
}

// the sum over taps of r at pixel p's neighbours (r has taps * ch columns):
// the ZeroConv's (sign +1; a neighbour outside the image takes the border
// row `edge`) or dya's (sign -1; zero outside)
__device__ __forceinline__ float shift_sum(const float* r, const float* edge,
                                           const mma::Geom& g, int p, int c, int ch, int sign) {
  const Pix px = g.pix(p);
  const int taps = g.kh * g.kw, n = taps * ch;
  auto term = [&](int tap) {
    const int dy = g.kwd.div(tap), dx = tap - dy * g.kw;
    const int oy = sign * (dy - g.ph), ox = sign * (dx - g.pw);
    if (inside(px.y + oy, px.x + ox, g))
      return r[static_cast<long long>(p + oy * g.w + ox) * n + tap * ch + c];
    return edge != nullptr ? edge[tap * ch + c] : 0.0f;
  };
  if (taps <= 9) {  // every load in flight before the sums (taps in order)
    float v[9];
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) v[tap] = tap < taps ? term(tap) : 0.0f;
    float s = 0.0f;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap)
      if (tap < taps) s += v[tap];
    return s;
  }
  float s = 0.0f;
  for (int tap = 0; tap < taps; ++tap) s += term(tap);
  return s;
}

// forward: out = (shift-sum of r + bz) x exp(3 scale), one thread an output
__global__ void __launch_bounds__(kFinishThreads)
glow_zeroconv_shift(const float* __restrict__ r, const float* __restrict__ bz,
                    const float* __restrict__ scale, float* __restrict__ out,
                    const mma::Geom g) {
  const int p = g.b * g.h * g.w;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p * g.cout) return;
  const int pix = g.coutd.div(i), c = i - pix * g.cout;
  const float* edge = r + static_cast<long long>(p) * g.kh * g.kw * g.cout;
  out[i] = (shift_sum(r, edge, g, pix, c, g.cout, 1) + bz[c]) * expf(scale[c] * 3.0f);
}

// gs's row length in bf16: cout rounded up to 8, the pad zero, so that dh2
// and dWz read it in 16-byte runs
__host__ __device__ inline int gs_channels(int cout) { return (cout + 7) / 8 * 8; }

// backward 1: convz = shift-sum of r + bz, gs = cd(g exp(3 scale)), and per
// block of kZPix pixels the column sums (pixels in order) of g convz
// exp(3 scale) and of g exp(3 scale) into zpart[blk * cout + c] and
// zpart[(blocks + blk) * cout + c]; dynamic shared memory 2 kZPix cout floats
__global__ void __launch_bounds__(kFinishThreads)
glow_zeroconv_shift_grad(const float* __restrict__ r, const float* __restrict__ bz,
                         const float* __restrict__ scale, const float* __restrict__ grad,
                         float* __restrict__ convz, bf16* __restrict__ gs,
                         float* __restrict__ zpart, const mma::Geom g) {
  extern __shared__ float zs[];
  const int p = g.b * g.h * g.w, cout = g.cout;
  const int blocks = (p + kZPix - 1) / kZPix;
  const int p0 = blockIdx.x * kZPix;
  const int rows = min(kZPix, p - p0);
  const float* edge = r + static_cast<long long>(p) * g.kh * g.kw * cout;
  float* v1 = zs;
  float* v2 = zs + kZPix * cout;
  const int gc = gs_channels(cout);
  for (int j = threadIdx.x; j < rows * cout; j += blockDim.x) {
    const int jp = g.coutd.div(j), c = j - jp * cout;
    const long long i = static_cast<long long>(p0) * cout + j;
    const float z = shift_sum(r, edge, g, p0 + jp, c, cout, 1) + bz[c];
    const float e = expf(scale[c] * 3.0f);
    const float gv = grad[i];
    convz[i] = z;
    gs[static_cast<long long>(p0 + jp) * gc + c] = __float2bfloat16(gv * e);
    v1[j] = gv * z * e;
    v2[j] = gv * e;
  }
  for (int j = threadIdx.x; j < rows * (gc - cout); j += blockDim.x) {
    const int jp = j / (gc - cout);
    gs[static_cast<long long>(p0 + jp) * gc + cout + (j - jp * (gc - cout))] =
        __float2bfloat16(0.0f);
  }
  __syncthreads();
  for (int c = threadIdx.x; c < cout; c += blockDim.x) {
    float s1 = 0.0f, s2 = 0.0f;
    for (int j = 0; j < rows; ++j) {
      s1 += v1[j * cout + c];
      s2 += v2[j * cout + c];
    }
    zpart[static_cast<long long>(blockIdx.x) * cout + c] = s1;
    zpart[static_cast<long long>(blocks + blockIdx.x) * cout + c] = s2;
  }
}

// The finishing sums of a pass, one launch: split partials (out[i] = sum
// over splits of part[s * n + i]), column sums (out[c] = mul x sum over rows
// of part[row * cols + c]) and dya's zero-bordered shift-sum; each job takes
// its own range of blocks, one thread an output, every sum in a fixed order
struct SplitSum {
  const float* part;
  float* out;
  long long n;       // outputs
  long long stride;  // part elements per split
  int splits;
  int cols = 0, ch = 1, ch_in = 1;  // cols > 0: output rows of cols = taps
                                    // x ch columns, read from rows of taps
                                    // x ch_in (dWz from gs's padded width)
};
struct ColSum {
  const float* part;
  float* out;
  int cols, rows;
  float mul;
};
struct Finish {
  SplitSum split[2];
  ColSum col[3];
  int nsplit, ncol;
  const float* r2;  // dya's N-pack product, or null
  float* dya;
  mma::Geom g;
};

constexpr int kFinishWarps = kFinishThreads / 32;  // columns per block of a ColSum

__host__ __device__ inline long long cdiv(long long a, long long b) { return (a + b - 1) / b; }

__host__ __device__ inline long long finish_blocks(const Finish& f) {
  long long n = 0;
  for (int j = 0; j < f.nsplit; ++j) n += cdiv(f.split[j].n, kFinishThreads);
  for (int j = 0; j < f.ncol; ++j) n += cdiv(f.col[j].cols, kFinishWarps);
  if (f.r2 != nullptr) n += cdiv(static_cast<long long>(f.g.b) * f.g.h * f.g.w * f.g.cin,
                                 kFinishThreads);
  return n;
}

__global__ void __launch_bounds__(kFinishThreads) glow_finish(const Finish f) {
  long long blk = blockIdx.x;
  for (int j = 0; j < f.nsplit; ++j) {
    const SplitSum& s = f.split[j];
    const long long nb = cdiv(s.n, kFinishThreads);
    if (blk < nb) {
      const long long i = blk * kFinishThreads + threadIdx.x;
      if (i < s.n) {
        long long in = i;
        if (s.cols > 0) {
          const long long row = i / s.cols;
          const int col = static_cast<int>(i - row * s.cols), tap = col / s.ch;
          in = (row * (s.cols / s.ch) + tap) * s.ch_in + (col - tap * s.ch);
        }
        float v = 0.0f;
#pragma unroll 8
        for (int z = 0; z < s.splits; ++z) v += s.part[z * s.stride + in];
        s.out[i] = v;
      }
      return;
    }
    blk -= nb;
  }
  // a warp a column: lane l sums rows l, l + 32, ..., then a fixed butterfly
  for (int j = 0; j < f.ncol; ++j) {
    const ColSum& c = f.col[j];
    const long long nb = cdiv(c.cols, kFinishWarps);
    if (blk < nb) {
      const int n = static_cast<int>(blk) * kFinishWarps + threadIdx.x / 32;
      const int lane = threadIdx.x % 32;
      if (n < c.cols) {
        float v = 0.0f;
#pragma unroll 4
        for (int r = lane; r < c.rows; r += 32) v += c.part[static_cast<long long>(r) * c.cols + n];
        for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
        if (lane == 0) c.out[n] = c.mul * v;
      }
      return;
    }
    blk -= nb;
  }
  const mma::Geom& g = f.g;
  const long long i = blk * kFinishThreads + threadIdx.x;
  if (f.r2 == nullptr || i >= static_cast<long long>(g.b) * g.h * g.w * g.cin) return;
  const int pix = g.cind.div(static_cast<int>(i));
  f.dya[i] = shift_sum(f.r2, nullptr, g, pix, static_cast<int>(i) - pix * g.cin, g.cin, -1);
}

cudaError_t finish(const Finish& f, cudaStream_t st) {
  glow_finish<<<static_cast<unsigned>(finish_blocks(f)), kFinishThreads, 0, st>>>(f);
  return cudaGetLastError();
}

// `part` of the bf16 passes, in floats: each pass's pieces side by side
struct Parts {
  long long r;      // the ZeroConv's r: (p + 1) x taps * cout
  long long zpart;  // 2 x shift blocks x cout
  long long dwz;    // dWz split partials
  long long db2;    // dh2's per-tile column sums
  long long dw2, dw1, db1, r2;
};

Parts parts(const Geo& g) {
  const int taps = g.kh * g.kw;
  const int p = g.b * g.h * g.w;
  const int q = g.b * (g.h + 2 * g.ph) * (g.w + 2 * g.pw);
  const int gc = gs_channels(g.cout);
  const mma::KSplit swz = mma::ksplit<Small>(g.f, taps * gc, q, true);
  const mma::KSplit sw2 = mma::ksplit<Wide>(g.f, g.f, p, true);
  const mma::KSplit sw1 = mma::ksplit<Small>(taps * g.cin, g.f, p, true);
  // each piece rounded up to 32 floats, so every piece starts 128-byte
  // aligned (the epilogues store 16-byte vectors)
  auto up = [](long long n) { return (n + 31) / 32 * 32; };
  Parts s;
  s.r = up(static_cast<long long>(p + 1) * taps * g.cout);
  s.zpart = up(2 * cdiv(p, kZPix) * g.cout);
  s.dwz = up(static_cast<long long>(swz.splits) * g.f * taps * gc);
  s.db2 = up(static_cast<long long>(mma::mtiles<Small>(p)) * g.f);  // the most tiles
  s.dw2 = up(static_cast<long long>(sw2.splits) * g.f * g.f);
  s.dw1 = up(static_cast<long long>(sw1.splits) * taps * g.cin * g.f);
  s.db1 = s.db2;
  s.r2 = up(static_cast<long long>(p) * taps * g.cin);
  return s;
}

long long part_floats_bf16(const Geo& g) {
  const Parts s = parts(g);
  const long long b1 = s.r + s.zpart + s.dwz + s.db2, b2 = s.dw2 + s.dw1 + s.db1 + s.r2;
  return b1 > b2 ? b1 : b2;
}

cudaError_t hidden_bf16(const Geo& g, const bf16* ya, const bf16* w1f, const float* b1,
                        const bf16* w2, const float* b2, bf16* h1, bf16* h2, cudaStream_t st) {
  const int p = g.b * g.h * g.w;
  cudaError_t err =
      pixel_gemm(mma::run_a(mma::Conv1Op{mma::Geom(g), ya, w1f, b1, h1}, g.cin), p, g.f,
                 g.kh * g.kw * g.cin, st);
  if (err != cudaSuccess) return err;
  mma::Conv2Op c2{};
  c2.g = mma::Geom(g);
  c2.a = h1;
  c2.b = w2;
  c2.bias = b2;
  c2.h2 = h2;
  // wgmma, or the small mma.sync tile where few tiles would run
  if (wide(p, g.f))
    return wgmma_gemm(c2, h1, w2, p, g.f, g.f, mma::ksplit<Wide>(p, g.f, g.f, false), st);
  return mma_gemm<Small>(c2, p, g.f, g.f, mma::ksplit<Small>(p, g.f, g.f, false), st);
}

// the N-pack r = [x; 1 if ones] @ Wr into `r`: M = p (+ 1), N = taps * ch,
// K = f; wk the (taps * ch, f) packing of the conv weight (wzf, w1f)
template <class Op>
Op npack_op(const Geo& g, const bf16* x, const bf16* wk, float* r, bool ones) {
  Op op{};
  op.g = mma::Geom(g);
  op.x = x;
  op.wk = wk;
  op.r = r;
  op.kdim = g.f;
  op.ones = ones;
  return op;
}

template <class Op>
cudaError_t npack(const Geo& g, const bf16* x, const bf16* wk, float* r, int ch, bool ones,
                  cudaStream_t st) {
  const int m = g.b * g.h * g.w + (ones ? 1 : 0);
  const int n = g.kh * g.kw * ch;
  return mma_gemm<Small>(npack_op<Op>(g, x, wk, r, ones), m, n, g.f,
                         mma::ksplit<Small>(m, n, g.f, false), st);
}

cudaError_t fwd_bf16(const Geo& g, const void* ya, const void* w1f, const float* b1,
                     const void* w2, const float* b2, const void* wzf, const float* bz,
                     const float* scale, float* out, void* h1, void* h2, float* part,
                     cudaStream_t st) {
  const int p = g.b * g.h * g.w;
  bf16* h2t = static_cast<bf16*>(h2);
  cudaError_t err = hidden_bf16(g, static_cast<const bf16*>(ya), static_cast<const bf16*>(w1f),
                                b1, static_cast<const bf16*>(w2), b2, static_cast<bf16*>(h1),
                                h2t, st);
  if (err != cudaSuccess) return err;
  err = npack<mma::ZeroConvROp>(g, h2t, static_cast<const bf16*>(wzf), part, g.cout, true, st);
  if (err != cudaSuccess) return err;
  glow_zeroconv_shift<<<static_cast<unsigned>(cdiv(static_cast<long long>(p) * g.cout,
                                                   kFinishThreads)),
                        kFinishThreads, 0, st>>>(part, bz, scale, out, mma::Geom(g));
  return cudaGetLastError();
}

cudaError_t bwd1_bf16(const Geo& g, const void* ya, const void* w1f, const float* b1,
                      const void* w2, const float* b2, const void* wz, const void* wzf,
                      const float* bz, const float* scale, const float* grad, void* h1,
                      void* dh2, float* dwz, float* dbz, float* db2, float* dscale, void* h2,
                      float* convz, void* gs, float* part, cudaStream_t st) {
  const int p = g.b * g.h * g.w;
  const int q = g.b * (g.h + 2 * g.ph) * (g.w + 2 * g.pw);
  const int taps = g.kh * g.kw;
  const Parts s = parts(g);
  float* r = part;
  float* zpart = r + s.r;
  float* dwzp = zpart + s.zpart;
  float* colp = dwzp + s.dwz;
  bf16* h2t = static_cast<bf16*>(h2);
  bf16* gst = static_cast<bf16*>(gs);
  cudaError_t err = hidden_bf16(g, static_cast<const bf16*>(ya), static_cast<const bf16*>(w1f),
                                b1, static_cast<const bf16*>(w2), b2, static_cast<bf16*>(h1),
                                h2t, st);
  if (err != cudaSuccess) return err;
  err = npack<mma::ZeroConvROp>(g, h2t, static_cast<const bf16*>(wzf), r, g.cout, true, st);
  if (err != cudaSuccess) return err;
  const int zblocks = static_cast<int>(cdiv(p, kZPix));
  const size_t zsmem = 2 * kZPix * g.cout * sizeof(float);
  if (zsmem > 48 * 1024) {
    err = cudaFuncSetAttribute(glow_zeroconv_shift_grad,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(zsmem));
    if (err != cudaSuccess) return err;
  }
  glow_zeroconv_shift_grad<<<zblocks, kFinishThreads, zsmem, st>>>(r, bz, scale, grad, convz,
                                                                   gst, zpart, mma::Geom(g));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int gc = gs_channels(g.cout);
  const mma::KSplit swz = mma::ksplit<Small>(g.f, taps * gc, q, true);
  const mma::DwzOp dwz_op{mma::Geom(g), h2t, gst, dwzp, gc, mma::FastDiv(gc)};
  const mma::Dh2Op dh2_op{mma::Geom(g), gst, static_cast<const bf16*>(wzf), h2t,
                          static_cast<bf16*>(dh2), colp, gc, mma::FastDiv(gc)};
  const Job jwz = job<Small>(g.f, taps * gc, q, swz);
  if (wide(p, g.f)) {
    err = mma_gemm<Small>(dwz_op, g.f, taps * gc, q, swz, st);
    if (err != cudaSuccess) return err;
    err = pixel_gemm(dh2_op, p, g.f, taps * gc, st);
  } else {  // few tiles: dWz and dh2 side by side (both read gs)
    err = mma_launch<Small>(
        dwz_op, jwz, dh2_op,
        job<Small>(p, g.f, taps * gc, mma::ksplit<Small>(p, g.f, taps * gc, false)), st);
  }
  if (err != cudaSuccess) return err;
  Finish f{};
  f.split[0] = SplitSum{dwzp, dwz, static_cast<long long>(g.f) * taps * g.cout,
                        static_cast<long long>(g.f) * taps * gc, swz.splits, taps * g.cout,
                        g.cout, gc};
  f.nsplit = 1;
  f.col[0] = ColSum{colp, db2, g.f, pixel_tiles(p, g.f), 1.0f};
  f.col[1] = ColSum{zpart, dscale, g.cout, zblocks, 3.0f};
  f.col[2] = ColSum{zpart + static_cast<long long>(zblocks) * g.cout, dbz, g.cout, zblocks, 1.0f};
  f.ncol = 3;
  f.g = mma::Geom(g);
  return finish(f, st);
}

cudaError_t bwd2_bf16(const Geo& g, const void* ya, const void* w1f, const void* w2t,
                      const void* h1, const void* dh2, float* dya, float* dw1, float* db1,
                      float* dw2, void* dh1, float* part, cudaStream_t st) {
  const int p = g.b * g.h * g.w;
  const int taps = g.kh * g.kw;
  const Parts s = parts(g);
  float* dw2p = part;
  float* dw1p = dw2p + s.dw2;
  float* colp = dw1p + s.dw1;
  float* r2 = colp + s.db1;
  const bf16* h1t = static_cast<const bf16*>(h1);
  const bf16* dh2t = static_cast<const bf16*>(dh2);
  bf16* dh1t = static_cast<bf16*>(dh1);
  // dW2 and dh1 side by side on wgmma (both read dh2), then dW1 and dya's
  // N-pack side by side (both read dh1)
  const mma::KSplit sw2 = mma::ksplit<Wide>(g.f, g.f, p, true);
  mma::Dh1Op d1{};
  d1.g = mma::Geom(g);
  d1.a = dh2t;
  d1.b = static_cast<const bf16*>(w2t);
  d1.h1 = h1t;
  d1.dh1 = dh1t;
  d1.colpart = colp;
  cudaError_t err = wgmma_launch(
      mma::Dw2Op{mma::Geom(g), h1t, dh2t, dw2p}, h1t, dh2t, job<Wide>(g.f, g.f, p, sw2), d1,
      dh2t, d1.b, job<Wide>(p, g.f, g.f, mma::ksplit<Wide>(p, g.f, g.f, false)), st);
  if (err != cudaSuccess) return err;
  const mma::KSplit sw1 = mma::ksplit<Small>(taps * g.cin, g.f, p, true);
  err = mma_launch<Small>(
      mma::run_a(mma::Dw1Op{mma::Geom(g), static_cast<const bf16*>(ya), dh1t, dw1p}, g.cin),
      job<Small>(taps * g.cin, g.f, p, sw1), npack_op<mma::DyaROp>(g, dh1t,
                                                               static_cast<const bf16*>(w1f),
                                                               r2, false),
      job<Small>(p, taps * g.cin, g.f, mma::ksplit<Small>(p, taps * g.cin, g.f, false)), st);
  if (err != cudaSuccess) return err;
  Finish f{};
  const long long n2 = static_cast<long long>(g.f) * g.f;
  const long long n1 = static_cast<long long>(taps) * g.cin * g.f;
  f.split[0] = SplitSum{dw2p, dw2, n2, n2, sw2.splits};
  f.split[1] = SplitSum{dw1p, dw1, n1, n1, sw1.splits};
  f.nsplit = 2;
  f.col[0] = ColSum{colp, db1, g.f, mma::mtiles<Wide>(p), 1.0f};
  f.ncol = 1;
  f.r2 = r2;
  f.dya = dya;
  f.g = mma::Geom(g);
  return finish(f, st);
}

}  // namespace

// Floats of the `part` scratch that the three entry points need in either
// dtype (bf16: the N-pack products, the shift-sum's partials, the split
// partials of the weight gradients and the per-tile column sums of the bias
// gradients, side by side; f32: split partials of the ZeroConv, of dya and of
// the weight gradients, per-tile column sums, one at a time).
extern "C" long long vgd_glow_coupling_part_floats(int b, int h, int w, int cin, int f, int cout,
                                                   int kh, int kw, int ph, int pw) {
  const Geo g{b, h, w, cin, f, cout, kh, kw, ph, pw};
  if (!valid(g)) return -1;
  const long long f32_part = part_floats(g), bf16_part = part_floats_bf16(g);
  return f32_part > bf16_part ? f32_part : bf16_part;
}

// out (B, H, W, cout) f32 = NN(ya). ya (B, H, W, cin) in cd, unpadded (the
// kernel masks the padding); w1f (kh*kw*cin, f), w2 (f, f), wz (kh*kw*f,
// cout) and wzf (kh*kw*cout, f) in cd (the same weight twice: the f32 path
// reads wz, the bf16 path wzf); b1, b2 (f,), bz, scale (cout,) f32; scratch
// h1, h2 (B*H*W*f) in cd and part (vgd_glow_coupling_part_floats) f32.
// bf16 != 0: cd is bf16, else f32.
extern "C" int vgd_glow_coupling_fwd(const void* ya, const void* w1f, const float* b1,
                                     const void* w2, const float* b2, const void* wz,
                                     const void* wzf, const float* bz, const float* scale, float* out, void* h1,
                                     void* h2, float* part, int b, int h, int w, int cin, int f,
                                     int cout, int kh, int kw, int ph, int pw, int bf16,
                                     void* stream) {
  const Geo g{b, h, w, cin, f, cout, kh, kw, ph, pw};
  if (!valid(g)) return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  if (bf16 && g.f % 8 != 0) return cudaErrorInvalidValue;  // 16-byte runs along f
  return bf16 ? fwd_bf16(g, ya, w1f, b1, w2, b2, wzf, bz, scale, out, h1, h2, part, st)
              : fwd<float>(g, ya, w1f, b1, w2, b2, wz, bz, scale, out, h1, h2, part, st);
}

// Backward 1. Inputs as the forward, plus wzf (kh*kw*cout, f) in cd (wzf[(tap,
// c), k] = Wz[tap, k, c]) and g (B, H, W, cout) f32. Outputs: h1, dh2 (B*H*W*f)
// in cd; dwz (f, kh*kw*cout), dbz (cout,), db2 (f,), dscale (cout,) f32.
// Scratch: h2 (B*H*W*f) in cd, gs (B*H*W*cout in f32; B*H*W*gc in bf16,
// gc = cout rounded up to 8), convz (B*H*W*cout) f32, part
// (vgd_glow_coupling_part_floats) f32.
extern "C" int vgd_glow_coupling_bwd1(const void* ya, const void* w1f, const float* b1,
                                      const void* w2, const float* b2, const void* wz,
                                      const void* wzf, const float* bz, const float* scale,
                                      const float* grad, void* h1, void* dh2, float* dwz,
                                      float* dbz, float* db2, float* dscale, void* h2,
                                      float* convz, void* gs, float* part, int b, int h, int w,
                                      int cin, int f, int cout, int kh, int kw, int ph, int pw,
                                      int bf16, void* stream) {
  const Geo g{b, h, w, cin, f, cout, kh, kw, ph, pw};
  if (!valid(g)) return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  if (bf16 && g.f % 8 != 0) return cudaErrorInvalidValue;  // 16-byte runs along f
  return bf16 ? bwd1_bf16(g, ya, w1f, b1, w2, b2, wz, wzf, bz, scale, grad, h1, dh2, dwz, dbz,
                           db2, dscale, h2, convz, gs, part, st)
              : bwd1<float>(g, ya, w1f, b1, w2, b2, wz, wzf, bz, scale, grad, h1, dh2, dwz, dbz,
                            db2, dscale, h2, convz, gs, part, st);
}

// Backward 2. ya as the forward; w1f as the forward and w1t (kh*kw*f, cin)
// (w1t[(tap, k), ci] = W1[tap, ci, k]), the same weight twice (the bf16 path
// reads w1f, the f32 path w1t), and w2t (f, f) = W2^T in cd; h1, dh2 from
// backward 1.
// Outputs: dya (B, H, W, cin), dw1 (kh*kw*cin, f), db1 (f,), dw2 (f, f) f32.
// Scratch: dh1 (B*H*W*f) in cd, part f32.
extern "C" int vgd_glow_coupling_bwd2(const void* ya, const void* w1f, const void* w1t,
                                      const void* w2t,
                                      const void* h1, const void* dh2, float* dya, float* dw1,
                                      float* db1, float* dw2, void* dh1, float* part, int b,
                                      int h, int w, int cin, int f, int cout, int kh, int kw,
                                      int ph, int pw, int bf16, void* stream) {
  const Geo g{b, h, w, cin, f, cout, kh, kw, ph, pw};
  if (!valid(g)) return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  if (bf16 && g.f % 8 != 0) return cudaErrorInvalidValue;  // 16-byte runs along f
  return bf16 ? bwd2_bf16(g, ya, w1f, w2t, h1, dh2, dya, dw1, db1, dw2, dh1, part, st)
              : bwd2<float>(g, ya, w1t, w2t, h1, dh2, dya, dw1, db1, dw2, dh1, part, st);
}

extern "C" const char* vgd_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
