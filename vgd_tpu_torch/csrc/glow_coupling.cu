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
// * one templated kernel, glow_gemm_kernel<T, Op>: C (M x N) = sum_k A(m, k)
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <type_traits>

namespace {

constexpr int kBM = 64;                 // output rows per tile
constexpr int kBN = 64;                 // output columns per tile
constexpr int kBK = 32;                 // reduction depth per staged chunk
constexpr int kThreads = 128;           // 4 warps
constexpr int kCS = kBN + 4;            // row stride of the f32 C tile
constexpr int kReduceThreads = 256;
constexpr int kTargetBlocks = 264;      // blocks a split reduction aims for

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__host__ __device__ constexpr bool tensor_cores() {
  return std::is_same<T, __nv_bfloat16>::value;
}
// row strides of the staged A (kBM x kBK) and B (kBK x kBN) chunks: WMMA
// wants a multiple of 8 bf16 and 32-byte aligned fragment rows; the f32 path
// pads A by one float so the rows a warp reads at one depth fall in
// different banks
template <typename T>
__host__ __device__ constexpr int a_stride() { return tensor_cores<T>() ? kBK + 8 : kBK + 1; }
template <typename T>
__host__ __device__ constexpr int b_stride() { return tensor_cores<T>() ? kBN + 8 : kBN + 4; }

struct Geo {
  int b, h, w, cin, f, cout, kh, kw, ph, pw;
};

struct Pix {
  int b, y, x;
};

__device__ __forceinline__ Pix pixel(int i, int h, int w) {
  const int b = i / (h * w);
  const int r = i - b * h * w;
  const int y = r / w;
  return Pix{b, y, r - y * w};
}

__device__ __forceinline__ bool inside(int y, int x, const Geo& g) {
  return y >= 0 && y < g.h && x >= 0 && x < g.w;
}

__device__ __forceinline__ long long at(const Geo& g, int b, int y, int x, int c, int ch) {
  return ((static_cast<long long>(b) * g.h + y) * g.w + x) * ch + c;
}

// 16-byte vectors: 8 bf16 or 4 f32 consecutive elements
template <typename T>
__host__ __device__ constexpr int vec_len() { return 16 / static_cast<int>(sizeof(T)); }

template <typename T>
__device__ __forceinline__ uint4 splat(float v) {
  uint4 r;
  T* e = reinterpret_cast<T*>(&r);
#pragma unroll
  for (int j = 0; j < vec_len<T>(); ++j) e[j] = from_float<T>(v);
  return r;
}

template <typename T>
__device__ __forceinline__ uint4 load16(const T* p) {
  return *reinterpret_cast<const uint4*>(p);
}

// which axis of the GEMM runs over pixels (its decomposition is cached in
// shared memory): none, the output rows, or the reduction
constexpr int kPixNone = 0, kPixM = 1, kPixK = 2;

// Each Op gives: kPix, kAMajorM (A is contiguous along m in memory, so it is
// staged with m fastest), pix(i), a(m, k, pm, pk), b(k, n, pk), the 16-byte
// loads av (along A's contiguous axis) and bv (along n), used where the
// host set vec_a / vec_b (the contiguous extent is a multiple of the vector
// and the vector never crosses a tap), and the epilogue over the f32 tile in
// shared memory (all threads call it).

__device__ __forceinline__ void store_tile(const float* cs, float* dst, int m0, int n0, int M,
                                           int N) {
  for (int v = threadIdx.x; v < kBM * kBN; v += kThreads) {
    const int r = v / kBN, c = v - (v / kBN) * kBN;
    if (m0 + r < M && n0 + c < N)
      dst[static_cast<long long>(m0 + r) * N + n0 + c] = cs[r * kCS + c];
  }
}

// Masked store of a gradient tile in cd (the mask from the cd activation),
// then per-column sums of the masked f32 values into colpart[n * tiles + t].
template <typename T>
__device__ __forceinline__ void masked_grad_epilogue(float* cs, const T* act, T* out,
                                                     float* colpart, int m0, int n0, int M, int N) {
  for (int v = threadIdx.x; v < kBM * kBN; v += kThreads) {
    const int r = v / kBN, c = v - (v / kBN) * kBN;
    if (m0 + r < M && n0 + c < N) {
      const long long i = static_cast<long long>(m0 + r) * N + n0 + c;
      const float val = to_float(act[i]) > 0.0f ? cs[r * kCS + c] : 0.0f;
      cs[r * kCS + c] = val;
      out[i] = from_float<T>(val);
    }
  }
  __syncthreads();
  const int tid = threadIdx.x;
  if (tid < kBN && n0 + tid < N) {
    const int rows = min(kBM, M - m0);
    float s = 0.0f;
    for (int r = 0; r < rows; ++r) s += cs[r * kCS + tid];
    colpart[static_cast<long long>(n0 + tid) * gridDim.x + blockIdx.x] = s;
  }
}

// h1 = cd(relu(conv(ya) + b1)): M pixels, N = f, K = kh*kw*cin (tap, ci)
template <typename T>
struct Conv1Op {
  static constexpr int kPix = kPixM;
  static constexpr bool kAMajorM = false;
  Geo g;
  const T* ya;
  const T* w1f;
  const float* b1;
  T* h1;
  bool vec_a = false, vec_b = false;
  __device__ Pix pix(int i) const { return pixel(i, g.h, g.w); }
  __device__ T a(int, int k, const Pix& pm, const Pix&) const {
    const int tap = k / g.cin, ci = k - tap * g.cin;
    const int dy = tap / g.kw, dx = tap - dy * g.kw;
    const int iy = pm.y + dy - g.ph, ix = pm.x + dx - g.pw;
    return inside(iy, ix, g) ? ya[at(g, pm.b, iy, ix, ci, g.cin)] : from_float<T>(0.0f);
  }
  __device__ T b(int k, int n, const Pix&) const { return w1f[static_cast<long long>(k) * g.f + n]; }
  __device__ uint4 av(int, int k, const Pix& pm, const Pix&) const {
    const int tap = k / g.cin, ci = k - tap * g.cin;
    const int dy = tap / g.kw, dx = tap - dy * g.kw;
    const int iy = pm.y + dy - g.ph, ix = pm.x + dx - g.pw;
    return inside(iy, ix, g) ? load16(ya + at(g, pm.b, iy, ix, ci, g.cin)) : splat<T>(0.0f);
  }
  __device__ uint4 bv(int k, int n, const Pix&) const {
    return load16(w1f + static_cast<long long>(k) * g.f + n);
  }
  __device__ void epilogue(float* cs, int m0, int n0, int M, int N) const {
    for (int v = threadIdx.x; v < kBM * kBN; v += kThreads) {
      const int r = v / kBN, c = v - (v / kBN) * kBN;
      if (m0 + r < M && n0 + c < N)
        h1[static_cast<long long>(m0 + r) * N + n0 + c] =
            from_float<T>(fmaxf(cs[r * kCS + c] + b1[n0 + c], 0.0f));
    }
  }
};

// h2 = cd(relu(h1 @ W2 + b2)): M pixels, N = K = f
template <typename T>
struct Conv2Op {
  static constexpr int kPix = kPixNone;
  static constexpr bool kAMajorM = false;
  Geo g;
  const T* h1;
  const T* w2;
  const float* b2;
  T* h2;
  bool vec_a = false, vec_b = false;
  __device__ Pix pix(int) const { return Pix{0, 0, 0}; }
  __device__ T a(int m, int k, const Pix&, const Pix&) const {
    return h1[static_cast<long long>(m) * g.f + k];
  }
  __device__ T b(int k, int n, const Pix&) const { return w2[static_cast<long long>(k) * g.f + n]; }
  __device__ uint4 av(int m, int k, const Pix&, const Pix&) const {
    return load16(h1 + static_cast<long long>(m) * g.f + k);
  }
  __device__ uint4 bv(int k, int n, const Pix&) const {
    return load16(w2 + static_cast<long long>(k) * g.f + n);
  }
  __device__ void epilogue(float* cs, int m0, int n0, int M, int N) const {
    for (int v = threadIdx.x; v < kBM * kBN; v += kThreads) {
      const int r = v / kBN, c = v - (v / kBN) * kBN;
      if (m0 + r < M && n0 + c < N)
        h2[static_cast<long long>(m0 + r) * N + n0 + c] =
            from_float<T>(fmaxf(cs[r * kCS + c] + b2[n0 + c], 0.0f));
    }
  }
};

// partial convz (without bz) = conv(h2 padded with 1, Wz): M pixels, N =
// cout, K = kh*kw*f (tap, k); the reduction is split (N is 6..48, K 4608),
// and the finishing sum adds bz and, in the forward, x exp(3 scale)
template <typename T>
struct ZeroConvOp {
  static constexpr int kPix = kPixM;
  static constexpr bool kAMajorM = false;
  Geo g;
  const T* h2;
  const T* wz;
  float* part;
  bool vec_a = false, vec_b = false;
  __device__ Pix pix(int i) const { return pixel(i, g.h, g.w); }
  __device__ T a(int, int k, const Pix& pm, const Pix&) const {
    const int tap = k / g.f, kk = k - tap * g.f;
    const int dy = tap / g.kw, dx = tap - dy * g.kw;
    const int iy = pm.y + dy - g.ph, ix = pm.x + dx - g.pw;
    return inside(iy, ix, g) ? h2[at(g, pm.b, iy, ix, kk, g.f)] : from_float<T>(1.0f);
  }
  __device__ T b(int k, int n, const Pix&) const { return wz[static_cast<long long>(k) * g.cout + n]; }
  __device__ uint4 av(int, int k, const Pix& pm, const Pix&) const {
    const int tap = k / g.f, kk = k - tap * g.f;
    const int dy = tap / g.kw, dx = tap - dy * g.kw;
    const int iy = pm.y + dy - g.ph, ix = pm.x + dx - g.pw;
    return inside(iy, ix, g) ? load16(h2 + at(g, pm.b, iy, ix, kk, g.f)) : splat<T>(1.0f);
  }
  __device__ uint4 bv(int k, int n, const Pix&) const {
    return load16(wz + static_cast<long long>(k) * g.cout + n);
  }
  __device__ void epilogue(float* cs, int m0, int n0, int M, int N) const {
    store_tile(cs, part + static_cast<long long>(blockIdx.z) * M * N, m0, n0, M, N);
  }
};

// dWz partials over the padded grid q: M = f, N = kh*kw*cout (tap, c),
// K = b * (h + 2ph) * (w + 2pw); A(k, q) = h2 padded with 1, B(q, (tap, c))
// = gs at q - tap (zero outside the image)
template <typename T>
struct DwzOp {
  static constexpr int kPix = kPixK;
  static constexpr bool kAMajorM = true;
  Geo g;
  const T* h2;
  const T* gs;
  float* part;
  bool vec_a = false, vec_b = false;
  __device__ Pix pix(int i) const { return pixel(i, g.h + 2 * g.ph, g.w + 2 * g.pw); }
  __device__ T a(int m, int, const Pix&, const Pix& pk) const {
    const int iy = pk.y - g.ph, ix = pk.x - g.pw;
    return inside(iy, ix, g) ? h2[at(g, pk.b, iy, ix, m, g.f)] : from_float<T>(1.0f);
  }
  __device__ T b(int, int n, const Pix& pk) const {
    const int tap = n / g.cout, c = n - tap * g.cout;
    const int dy = tap / g.kw, dx = tap - dy * g.kw;
    const int gy = pk.y - dy, gx = pk.x - dx;
    return inside(gy, gx, g) ? gs[at(g, pk.b, gy, gx, c, g.cout)] : from_float<T>(0.0f);
  }
  __device__ uint4 av(int m, int, const Pix&, const Pix& pk) const {
    const int iy = pk.y - g.ph, ix = pk.x - g.pw;
    return inside(iy, ix, g) ? load16(h2 + at(g, pk.b, iy, ix, m, g.f)) : splat<T>(1.0f);
  }
  __device__ uint4 bv(int, int n, const Pix& pk) const {
    const int tap = n / g.cout, c = n - tap * g.cout;
    const int dy = tap / g.kw, dx = tap - dy * g.kw;
    const int gy = pk.y - dy, gx = pk.x - dx;
    return inside(gy, gx, g) ? load16(gs + at(g, pk.b, gy, gx, c, g.cout)) : splat<T>(0.0f);
  }
  __device__ void epilogue(float* cs, int m0, int n0, int M, int N) const {
    store_tile(cs, part + static_cast<long long>(blockIdx.z) * M * N, m0, n0, M, N);
  }
};

// dh2 = mask(h2 > 0) corr(gs, Wz) on the interior, db2 column partials:
// M pixels, N = f, K = kh*kw*cout (tap, c); B = wzf[(tap, c), k]
template <typename T>
struct Dh2Op {
  static constexpr int kPix = kPixM;
  static constexpr bool kAMajorM = false;
  Geo g;
  const T* gs;
  const T* wzf;
  const T* h2;
  T* dh2;
  float* colpart;
  bool vec_a = false, vec_b = false;
  __device__ Pix pix(int i) const { return pixel(i, g.h, g.w); }
  __device__ T a(int, int k, const Pix& pm, const Pix&) const {
    const int tap = k / g.cout, c = k - tap * g.cout;
    const int dy = tap / g.kw, dx = tap - dy * g.kw;
    const int gy = pm.y - dy + g.ph, gx = pm.x - dx + g.pw;
    return inside(gy, gx, g) ? gs[at(g, pm.b, gy, gx, c, g.cout)] : from_float<T>(0.0f);
  }
  __device__ T b(int k, int n, const Pix&) const { return wzf[static_cast<long long>(k) * g.f + n]; }
  __device__ uint4 av(int, int k, const Pix& pm, const Pix&) const {
    const int tap = k / g.cout, c = k - tap * g.cout;
    const int dy = tap / g.kw, dx = tap - dy * g.kw;
    const int gy = pm.y - dy + g.ph, gx = pm.x - dx + g.pw;
    return inside(gy, gx, g) ? load16(gs + at(g, pm.b, gy, gx, c, g.cout)) : splat<T>(0.0f);
  }
  __device__ uint4 bv(int k, int n, const Pix&) const {
    return load16(wzf + static_cast<long long>(k) * g.f + n);
  }
  __device__ void epilogue(float* cs, int m0, int n0, int M, int N) const {
    masked_grad_epilogue<T>(cs, h2, dh2, colpart, m0, n0, M, N);
  }
};

// dW2 partials: M = N = f, K = pixels; A(k1, p) = h1[p, k1], B = dh2
template <typename T>
struct Dw2Op {
  static constexpr int kPix = kPixNone;
  static constexpr bool kAMajorM = true;
  Geo g;
  const T* h1;
  const T* dh2;
  float* part;
  bool vec_a = false, vec_b = false;
  __device__ Pix pix(int) const { return Pix{0, 0, 0}; }
  __device__ T a(int m, int k, const Pix&, const Pix&) const {
    return h1[static_cast<long long>(k) * g.f + m];
  }
  __device__ T b(int k, int n, const Pix&) const { return dh2[static_cast<long long>(k) * g.f + n]; }
  __device__ uint4 av(int m, int k, const Pix&, const Pix&) const {
    return load16(h1 + static_cast<long long>(k) * g.f + m);
  }
  __device__ uint4 bv(int k, int n, const Pix&) const {
    return load16(dh2 + static_cast<long long>(k) * g.f + n);
  }
  __device__ void epilogue(float* cs, int m0, int n0, int M, int N) const {
    store_tile(cs, part + static_cast<long long>(blockIdx.z) * M * N, m0, n0, M, N);
  }
};

// dh1 = mask(h1 > 0) dh2 @ W2^T, db1 column partials: M pixels, N = K = f
template <typename T>
struct Dh1Op {
  static constexpr int kPix = kPixNone;
  static constexpr bool kAMajorM = false;
  Geo g;
  const T* dh2;
  const T* w2t;
  const T* h1;
  T* dh1;
  float* colpart;
  bool vec_a = false, vec_b = false;
  __device__ Pix pix(int) const { return Pix{0, 0, 0}; }
  __device__ T a(int m, int k, const Pix&, const Pix&) const {
    return dh2[static_cast<long long>(m) * g.f + k];
  }
  __device__ T b(int k, int n, const Pix&) const { return w2t[static_cast<long long>(k) * g.f + n]; }
  __device__ uint4 av(int m, int k, const Pix&, const Pix&) const {
    return load16(dh2 + static_cast<long long>(m) * g.f + k);
  }
  __device__ uint4 bv(int k, int n, const Pix&) const {
    return load16(w2t + static_cast<long long>(k) * g.f + n);
  }
  __device__ void epilogue(float* cs, int m0, int n0, int M, int N) const {
    masked_grad_epilogue<T>(cs, h1, dh1, colpart, m0, n0, M, N);
  }
};

// dW1 partials: M = kh*kw*cin (tap, ci), N = f, K = pixels; A = im2col(ya)^T
template <typename T>
struct Dw1Op {
  static constexpr int kPix = kPixK;
  static constexpr bool kAMajorM = true;
  Geo g;
  const T* ya;
  const T* dh1;
  float* part;
  bool vec_a = false, vec_b = false;
  __device__ Pix pix(int i) const { return pixel(i, g.h, g.w); }
  __device__ T a(int m, int, const Pix&, const Pix& pk) const {
    const int tap = m / g.cin, ci = m - tap * g.cin;
    const int dy = tap / g.kw, dx = tap - dy * g.kw;
    const int iy = pk.y + dy - g.ph, ix = pk.x + dx - g.pw;
    return inside(iy, ix, g) ? ya[at(g, pk.b, iy, ix, ci, g.cin)] : from_float<T>(0.0f);
  }
  __device__ T b(int k, int n, const Pix&) const { return dh1[static_cast<long long>(k) * g.f + n]; }
  __device__ uint4 av(int m, int, const Pix&, const Pix& pk) const {
    const int tap = m / g.cin, ci = m - tap * g.cin;
    const int dy = tap / g.kw, dx = tap - dy * g.kw;
    const int iy = pk.y + dy - g.ph, ix = pk.x + dx - g.pw;
    return inside(iy, ix, g) ? load16(ya + at(g, pk.b, iy, ix, ci, g.cin)) : splat<T>(0.0f);
  }
  __device__ uint4 bv(int k, int n, const Pix&) const {
    return load16(dh1 + static_cast<long long>(k) * g.f + n);
  }
  __device__ void epilogue(float* cs, int m0, int n0, int M, int N) const {
    store_tile(cs, part + static_cast<long long>(blockIdx.z) * M * N, m0, n0, M, N);
  }
};

// dya partials = corr(dh1, W1): M pixels, N = cin, K = kh*kw*f (tap, k);
// B = w1t; the reduction is split as the ZeroConv's
template <typename T>
struct DyaOp {
  static constexpr int kPix = kPixM;
  static constexpr bool kAMajorM = false;
  Geo g;
  const T* dh1;
  const T* w1t;
  float* part;
  bool vec_a = false, vec_b = false;
  __device__ Pix pix(int i) const { return pixel(i, g.h, g.w); }
  __device__ T a(int, int k, const Pix& pm, const Pix&) const {
    const int tap = k / g.f, kk = k - tap * g.f;
    const int dy = tap / g.kw, dx = tap - dy * g.kw;
    const int gy = pm.y - dy + g.ph, gx = pm.x - dx + g.pw;
    return inside(gy, gx, g) ? dh1[at(g, pm.b, gy, gx, kk, g.f)] : from_float<T>(0.0f);
  }
  __device__ T b(int k, int n, const Pix&) const { return w1t[static_cast<long long>(k) * g.cin + n]; }
  __device__ uint4 av(int, int k, const Pix& pm, const Pix&) const {
    const int tap = k / g.f, kk = k - tap * g.f;
    const int dy = tap / g.kw, dx = tap - dy * g.kw;
    const int gy = pm.y - dy + g.ph, gx = pm.x - dx + g.pw;
    return inside(gy, gx, g) ? load16(dh1 + at(g, pm.b, gy, gx, kk, g.f)) : splat<T>(0.0f);
  }
  __device__ uint4 bv(int k, int n, const Pix&) const {
    return load16(w1t + static_cast<long long>(k) * g.cin + n);
  }
  __device__ void epilogue(float* cs, int m0, int n0, int M, int N) const {
    store_tile(cs, part + static_cast<long long>(blockIdx.z) * M * N, m0, n0, M, N);
  }
};

template <typename T, class Op>
__global__ void __launch_bounds__(kThreads)
glow_gemm_kernel(const Op op, int M, int N, int K, int k_split) {
  constexpr int AS = a_stride<T>();
  constexpr int BS = b_stride<T>();
  __shared__ __align__(128) T as[kBM * AS];
  __shared__ __align__(128) T bs[kBK * BS];
  __shared__ __align__(128) float cs[kBM * kCS];
  __shared__ Pix pm[kBM];
  __shared__ Pix pk[kBK];

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int kbeg = blockIdx.z * k_split;
  const int kend = min(K, kbeg + k_split);
  if constexpr (Op::kPix == kPixM) {
    if (tid < kBM) pm[tid] = op.pix(min(m0 + tid, M - 1));
  }
  const T zero = from_float<T>(0.0f);

  // a chunk is gathered into registers first (all of a thread's loads in
  // flight at once), then written to shared memory; 16-byte loads where the
  // host allowed them
  constexpr int kAPer = kBM * kBK / kThreads;
  constexpr int kBPer = kBK * kBN / kThreads;
  constexpr int V = vec_len<T>();
  auto stage = [&](int k0) {
    if constexpr (Op::kPix == kPixK) {
      if (tid < kBK) pk[tid] = op.pix(min(k0 + tid, kend - 1));
      __syncthreads();
    }
    if (op.vec_a) {
      // A's contiguous axis in vectors: m for kAMajorM, else k
      constexpr int kPer = kBM * kBK / V / kThreads;
      constexpr int kRowVecs = (Op::kAMajorM ? kBM : kBK) / V;
      uint4 ra[kPer];
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int v = tid + i * kThreads;
        const int r = Op::kAMajorM ? (v % kRowVecs) * V : v / kRowVecs;
        const int kk = Op::kAMajorM ? v / kRowVecs : (v % kRowVecs) * V;
        const int m = m0 + r, k = k0 + kk;
        ra[i] = (m < M && k < kend) ? op.av(m, k, pm[r], pk[kk]) : splat<T>(0.0f);
      }
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int v = tid + i * kThreads;
        const int r = Op::kAMajorM ? (v % kRowVecs) * V : v / kRowVecs;
        const int kk = Op::kAMajorM ? v / kRowVecs : (v % kRowVecs) * V;
        const T* e = reinterpret_cast<const T*>(&ra[i]);
        if constexpr (Op::kAMajorM) {
#pragma unroll
          for (int j = 0; j < V; ++j) as[(r + j) * AS + kk] = e[j];
        } else if constexpr (tensor_cores<T>()) {
          *reinterpret_cast<uint4*>(as + r * AS + kk) = ra[i];
        } else {
#pragma unroll
          for (int j = 0; j < V; ++j) as[r * AS + kk + j] = e[j];
        }
      }
    } else {
      T ra[kAPer];
#pragma unroll
      for (int i = 0; i < kAPer; ++i) {
        const int v = tid + i * kThreads;
        const int r = Op::kAMajorM ? v % kBM : v / kBK;
        const int kk = Op::kAMajorM ? v / kBM : v % kBK;
        const int m = m0 + r, k = k0 + kk;
        ra[i] = (m < M && k < kend) ? op.a(m, k, pm[r], pk[kk]) : zero;
      }
#pragma unroll
      for (int i = 0; i < kAPer; ++i) {
        const int v = tid + i * kThreads;
        const int r = Op::kAMajorM ? v % kBM : v / kBK;
        const int kk = Op::kAMajorM ? v / kBM : v % kBK;
        as[r * AS + kk] = ra[i];
      }
    }
    if (op.vec_b) {
      constexpr int kPer = kBK * kBN / V / kThreads;
      uint4 rb[kPer];
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int v = tid + i * kThreads;
        const int kr = v / (kBN / V), nn = (v % (kBN / V)) * V;
        const int k = k0 + kr, n = n0 + nn;
        rb[i] = (k < kend && n < N) ? op.bv(k, n, pk[kr]) : splat<T>(0.0f);
      }
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int v = tid + i * kThreads;
        *reinterpret_cast<uint4*>(bs + (v / (kBN / V)) * BS + (v % (kBN / V)) * V) = rb[i];
      }
    } else {
      T rb[kBPer];
#pragma unroll
      for (int i = 0; i < kBPer; ++i) {
        const int v = tid + i * kThreads;
        const int kr = v / kBN, nn = v % kBN;
        const int k = k0 + kr, n = n0 + nn;
        rb[i] = (k < kend && n < N) ? op.b(k, n, pk[kr]) : zero;
      }
#pragma unroll
      for (int i = 0; i < kBPer; ++i) {
        const int v = tid + i * kThreads;
        bs[(v / kBN) * BS + v % kBN] = rb[i];
      }
    }
  };

  const int warp = tid >> 5;
  if constexpr (tensor_cores<T>()) {
    using namespace nvcuda;
    const int wm = warp >> 1, wn = warp & 1;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);
    for (int k0 = kbeg; k0 < kend; k0 += kBK) {
      __syncthreads();                     // pixel info ready / last chunk consumed
      stage(k0);
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
    __syncthreads();
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
    for (int k0 = kbeg; k0 < kend; k0 += kBK) {
      __syncthreads();
      stage(k0);
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < kBK; ++kk) {
        float a[4], b[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = to_float(as[(ty * 4 + i) * AS + kk]);
#pragma unroll
        for (int j = 0; j < 8; ++j) b[j] = to_float(bs[kk * BS + tx + 8 * j]);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) cs[(ty * 4 + i) * kCS + tx + 8 * j] = acc[i][j];
  }
  __syncthreads();
  op.epilogue(cs, m0, n0, M, N);
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

struct Split {
  int splits, k_split;
};

// no split for the forward-style GEMMs; the weight gradients split their
// reduction into whole chunks so that about kTargetBlocks blocks run
Split split_k(int M, int N, int K, bool split) {
  const int chunks = (K + kBK - 1) / kBK;
  int s = 1;
  if (split) {
    const int tiles = ((M + kBM - 1) / kBM) * ((N + kBN - 1) / kBN);
    s = (kTargetBlocks + tiles - 1) / tiles;
    s = s < 1 ? 1 : (s > chunks ? chunks : s);
  }
  const int per = (chunks + s - 1) / s;
  return Split{(chunks + per - 1) / per, per * kBK};
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

// `op` with 16-byte loads of A / B switched on where `a` / `b` hold (the
// contiguous extent, a channel count, is a multiple of the vector)
template <class Op>
Op vec(Op op, bool a, bool b) {
  op.vec_a = a;
  op.vec_b = b;
  return op;
}

template <typename T>
bool div_vec(int n) {
  return n % vec_len<T>() == 0;
}

bool valid(const Geo& g) {
  const long long p = static_cast<long long>(g.b) * g.h * g.w;
  const long long q = static_cast<long long>(g.b) * (g.h + 2 * g.ph) * (g.w + 2 * g.pw);
  // odd kernels with "same" padding: the output has the input's size
  return g.b > 0 && g.h > 0 && g.w > 0 && g.cin > 0 && g.f > 0 && g.cout > 0 &&
         g.ph >= 0 && g.pw >= 0 && g.kh == 2 * g.ph + 1 && g.kw == 2 * g.pw + 1 &&
         q * g.f < (1LL << 31) && p * g.f < (1LL << 31) &&
         static_cast<long long>(g.kh) * g.kw * g.f < (1LL << 31) &&
         (static_cast<long long>(g.kh) * g.kw * g.cout + kBN - 1) / kBN <= 65535;
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
