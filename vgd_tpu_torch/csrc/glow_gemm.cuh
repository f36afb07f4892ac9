// The tiled implicit GEMM of the Glow coupling network, shared by K5
// (glow_coupling.cu: one launch per stage) and K6 (glow_flow_stack.cu: every
// stage of every flow inside one persistent kernel).
//
// gemm_tile<T, Op> computes one 64 x 64 output tile of C = sum_k A(m, k)
// B(k, n) over one split of the reduction, staging 32-deep chunks in shared
// memory: bf16 on the tensor cores (4 warps, 2 x 2 WMMA 16x16x16 fragments
// each, f32 accumulators), f32 on the CUDA cores. The Ops say how A and B
// are gathered (conv taps with zero or value-1 padding, transposed reads for
// weight gradients) and own the epilogue. The caller names the tile (Tile)
// and hands in the shared memory (Smem), so a persistent kernel can walk
// many tiles of many Ops with one set of buffers. See glow_coupling.cu for
// the math each Op serves.
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

// one output tile: its first row and column, its split of the reduction, and
// its row-tile index among mtiles (the per-tile column sums are indexed so)
struct Tile {
  int m0, n0, z, mi, mtiles;
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
                                                     float* colpart, int m0, int n0, int M, int N,
                                                     int mi, int mtiles) {
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
    colpart[static_cast<long long>(n0 + tid) * mtiles + mi] = s;
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
  __device__ void epilogue(float* cs, const Tile& t, int M, int N) const {
    const int m0 = t.m0, n0 = t.n0;
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
  __device__ void epilogue(float* cs, const Tile& t, int M, int N) const {
    const int m0 = t.m0, n0 = t.n0;
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
  __device__ void epilogue(float* cs, const Tile& t, int M, int N) const {
    const int m0 = t.m0, n0 = t.n0;
    store_tile(cs, part + static_cast<long long>(t.z) * M * N, m0, n0, M, N);
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
  __device__ void epilogue(float* cs, const Tile& t, int M, int N) const {
    const int m0 = t.m0, n0 = t.n0;
    store_tile(cs, part + static_cast<long long>(t.z) * M * N, m0, n0, M, N);
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
  __device__ void epilogue(float* cs, const Tile& t, int M, int N) const {
    const int m0 = t.m0, n0 = t.n0;
    masked_grad_epilogue<T>(cs, h2, dh2, colpart, m0, n0, M, N, t.mi, t.mtiles);
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
  __device__ void epilogue(float* cs, const Tile& t, int M, int N) const {
    const int m0 = t.m0, n0 = t.n0;
    store_tile(cs, part + static_cast<long long>(t.z) * M * N, m0, n0, M, N);
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
  __device__ void epilogue(float* cs, const Tile& t, int M, int N) const {
    const int m0 = t.m0, n0 = t.n0;
    masked_grad_epilogue<T>(cs, h1, dh1, colpart, m0, n0, M, N, t.mi, t.mtiles);
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
  __device__ void epilogue(float* cs, const Tile& t, int M, int N) const {
    const int m0 = t.m0, n0 = t.n0;
    store_tile(cs, part + static_cast<long long>(t.z) * M * N, m0, n0, M, N);
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
  __device__ void epilogue(float* cs, const Tile& t, int M, int N) const {
    const int m0 = t.m0, n0 = t.n0;
    store_tile(cs, part + static_cast<long long>(t.z) * M * N, m0, n0, M, N);
  }
};

// The shared memory of one tile: the staged A and B chunks, the f32 C tile
// (also the scratch of K6's per-pixel stages) and the pixel decompositions.
template <typename T>
struct Smem {
  T as[kBM * a_stride<T>()];
  T bs[kBK * b_stride<T>()];
  float cs[kBM * kCS];
  Pix pm[kBM];
  Pix pk[kBK];
};

// One output tile of Op's GEMM over the reduction split t.z (k_split deep);
// all threads of the block call it. It leaves the C tile in sm.cs for the
// epilogue and runs the epilogue.
template <typename T, class Op>
__device__ __forceinline__ void gemm_tile(const Op& op, int M, int N, int K, int k_split,
                                          const Tile& t, Smem<T>& sm) {
  constexpr int AS = a_stride<T>();
  constexpr int BS = b_stride<T>();
  T* as = sm.as;
  T* bs = sm.bs;
  float* cs = sm.cs;
  Pix* pm = sm.pm;
  Pix* pk = sm.pk;

  const int tid = threadIdx.x;
  const int m0 = t.m0;
  const int n0 = t.n0;
  const int kbeg = t.z * k_split;
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
  op.epilogue(cs, t, M, N);
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

// `op` with 16-byte loads of A / B switched on where `a` / `b` hold (the
// contiguous extent, a channel count, is a multiple of the vector)
template <class Op>
__host__ __device__ Op vec(Op op, bool a, bool b) {
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

}  // namespace
