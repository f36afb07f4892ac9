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
// cost 5 us each at 3.35 TB/s, so the work is bound by operations. The TPU
// kernel keeps h1/h2 in VMEM and packs the tiny flow channels (6..48) into
// MXU lanes; here every stage is one tiled implicit GEMM with the
// intermediates going through device memory (they stay in the 50 MB L2 at
// the smaller blocks):
//
// * one templated kernel, glow_gemm_kernel<T, Op> (its tile, gemm_tile, and
//   the Ops live in glow_gemm.cuh, shared with K6): C (M x N) = sum_k A(m, k)
//   B(k, n) over 64 x 64 output tiles and 32-deep chunks staged in shared
//   memory; the Op gathers A and B (the conv taps with their zero or value-1
//   padding, transposed reads for the weight gradients) and owns the
//   epilogue (bias, ReLU, rounding to cd, masks, per-tile column sums);
// * bf16: each of 4 warps owns a 32 x 32 quarter of the tile as 2 x 2 WMMA
//   16x16x16 fragments with f32 accumulators; f32: the same tile on the CUDA
//   cores, 4 x 8 outputs a thread (no TF32), so f32 stays f32;
// * tiny channel counts (ch 6 gives a conv1 depth of 54, a ZeroConv output
//   of 6) are zero-filled up to the tile in shared memory;
// * a thread gathers its share of a chunk into registers before writing it
//   to shared memory, so its loads are in flight together: 16-byte vectors
//   (8 bf16) along the operand's contiguous axis where the channel count
//   allows (the 512-wide operands always; the conv1 input and the ZeroConv
//   output from 24 channels on in bf16), else single elements;
// * weight gradients reduce over up to 18,496 pixels, and the ZeroConv and
//   dya (N = 5..48 columns, one tile, over a depth of 9 * 512) would run
//   few blocks: these reductions are split so that about 264 blocks run
//   (the split depends on the shapes only), each split writes its partial
//   tile, and a second kernel adds the partials in a fixed order (then the
//   ZeroConv's bias and exp(3 scale)); bias gradients are per-tile column
//   sums added in a fixed order; no atomics, so training is deterministic
//   run to run.
//
// Not yet done (later work): keeping h1/h2 on chip (the TPU design),
// vectorised or TMA loads, wgmma, fusing the ZeroConv into the conv2
// epilogue.
//
// Plain C interface for ctypes. Every entry point launches on the given
// stream, does not synchronise and allocates nothing (the wrapper passes
// outputs and scratch); it returns the CUDA error of its launches
// (cudaErrorInvalidValue for a shape it does not take).

#include "glow_gemm.cuh"

namespace {

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

}  // namespace

// Floats of the `part` scratch that the three entry points need (split
// partials of the ZeroConv, of dya and of the weight gradients, per-tile
// column sums of the bias gradients).
extern "C" long long vgd_glow_coupling_part_floats(int b, int h, int w, int cin, int f, int cout,
                                                   int kh, int kw, int ph, int pw) {
  const Geo g{b, h, w, cin, f, cout, kh, kw, ph, pw};
  return valid(g) ? part_floats(g) : -1;
}

// out (B, H, W, cout) f32 = NN(ya). ya (B, H, W, cin) in cd, unpadded (the
// kernel masks the padding); w1f (kh*kw*cin, f), w2 (f, f), wz (kh*kw*f,
// cout) in cd; b1, b2 (f,), bz, scale (cout,) f32; scratch h1, h2 (B*H*W*f)
// in cd and part (vgd_glow_coupling_part_floats) f32. bf16 != 0: cd is
// bf16, else f32.
extern "C" int vgd_glow_coupling_fwd(const void* ya, const void* w1f, const float* b1,
                                     const void* w2, const float* b2, const void* wz,
                                     const float* bz, const float* scale, float* out, void* h1,
                                     void* h2, float* part, int b, int h, int w, int cin, int f,
                                     int cout, int kh, int kw, int ph, int pw, int bf16,
                                     void* stream) {
  const Geo g{b, h, w, cin, f, cout, kh, kw, ph, pw};
  if (!valid(g)) return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  return bf16 ? fwd<__nv_bfloat16>(g, ya, w1f, b1, w2, b2, wz, bz, scale, out, h1, h2, part, st)
              : fwd<float>(g, ya, w1f, b1, w2, b2, wz, bz, scale, out, h1, h2, part, st);
}

// Backward 1. Inputs as the forward, plus wzf (kh*kw*cout, f) in cd (wzf[(tap,
// c), k] = Wz[tap, k, c]) and g (B, H, W, cout) f32. Outputs: h1, dh2 (B*H*W*f)
// in cd; dwz (f, kh*kw*cout), dbz (cout,), db2 (f,), dscale (cout,) f32.
// Scratch: h2 (B*H*W*f) and gs (B*H*W*cout) in cd, convz (B*H*W*cout) f32,
// part (vgd_glow_coupling_part_floats) f32.
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
  return bf16 ? bwd1<__nv_bfloat16>(g, ya, w1f, b1, w2, b2, wz, wzf, bz, scale, grad, h1, dh2,
                                    dwz, dbz, db2, dscale, h2, convz, gs, part, st)
              : bwd1<float>(g, ya, w1f, b1, w2, b2, wz, wzf, bz, scale, grad, h1, dh2, dwz, dbz,
                            db2, dscale, h2, convz, gs, part, st);
}

// Backward 2. ya as the forward; w1t (kh*kw*f, cin) (w1t[(tap, k), ci] =
// W1[tap, ci, k]) and w2t (f, f) = W2^T in cd; h1, dh2 from backward 1.
// Outputs: dya (B, H, W, cin), dw1 (kh*kw*cin, f), db1 (f,), dw2 (f, f) f32.
// Scratch: dh1 (B*H*W*f) in cd, part f32.
extern "C" int vgd_glow_coupling_bwd2(const void* ya, const void* w1t, const void* w2t,
                                      const void* h1, const void* dh2, float* dya, float* dw1,
                                      float* db1, float* dw2, void* dh1, float* part, int b,
                                      int h, int w, int cin, int f, int cout, int kh, int kw,
                                      int ph, int pw, int bf16, void* stream) {
  const Geo g{b, h, w, cin, f, cout, kh, kw, ph, pw};
  if (!valid(g)) return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  return bf16 ? bwd2<__nv_bfloat16>(g, ya, w1t, w2t, h1, dh2, dya, dw1, db1, dw2, dh1, part, st)
              : bwd2<float>(g, ya, w1t, w2t, h1, dh2, dya, dw1, db1, dw2, dh1, part, st);
}

extern "C" const char* vgd_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
