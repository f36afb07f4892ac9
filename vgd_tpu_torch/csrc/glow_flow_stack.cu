// A chunk of G Glow flows of one block (ActNorm -> invertible 1x1 conv ->
// additive coupling), forward with and without saving each flow's input, and
// the backward, each as ONE persistent cooperative kernel, for Hopper
// (sm_90a).
//
// Replaces the TPU kernels of vgd_tpu/ops/glow_flow_stack.py: _fwd_kernel
// (the forward that saves each flow's input), _fwd_sample_kernel (the
// forward that saves nothing) and _bwd_kernel (the reverse walk), all called
// through _make_stack's run_fwd / run_bwd. The math is theirs, with their
// rounding points (cd is the compute dtype, bf16 on the main path and f32
// for checks):
//
// * y1 = s (x + b) in f32; y2 = cd(y1) @ cd(wt) with f32 sums (wt is the
//   TRANSPOSED PLU weight, assembled outside); ya, yb = split(y2);
// * NN(ya) is K5's coupling network on cd(ya) (glow_coupling.cu): h1 and h2
//   rounded to cd, the ZeroConv's weights in cd, value-1 padding, x exp(3
//   scale); the flow's output is [ya, yb + NN(ya)] in f32;
// * the backward walks the flows in reverse from the saved inputs,
//   recomputes each flow, takes the coupling's gradients as K5's two
//   backward passes do, forms dy2 = cd([ga + dya_nn, gb]), dwt = cd(y1)^T
//   dy2, dy1 = dy2 cd(wt)^T (f32 sums), d an_s = sum dy1 (x + b), dx = dy1
//   s, d an_b = sum dx.
//
// What bounds it on the H100. At the reference Glow (64x64, batch 16, K=32,
// L=4, width 512) one train step sends about 0.47 TFLOP through the forward
// and 1.4 TFLOP through the backward (the recompute included): about 0.48
// and 1.45 ms at the bf16 tensor-core rate of 989 TFLOP/s, while the c-wide
// activations (c = 12..96) and the per-flow weights move a few hundred MB;
// so the work is bound by operations. The TPU kernel keeps the activation,
// the weights and the 512-wide internals of a batch tile in VMEM for the
// whole chain. Here one image's h1 at block 0 is 1 MB in bf16, so the
// internals go through device memory (the 50 MB L2 holds blocks 1-3 whole),
// and what the TPU design buys carries over as one launch per chunk and
// direction. At the small blocks a flow's work is a few microseconds of
// tensor-core time, so there the time is set by each stage's serial chain
// (a tile's walk over its reduction) and by the grid syncs between stages.
//
// bf16, the main path (namespace tc):
// * one block size (256 threads, two warpgroups) and one dynamic shared
//   memory size (99 KB: the 128 x 128 tile's 3-stage ring plus 1024 bytes
//   of alignment) for every stage; the launch sets that size, queries the
//   occupancy with it and launches every resident block (one an SM: with
//   two, ptxas capped the kernels at 128 registers a thread and spilled
//   0.5-1.6 KB in the backward, and the forward ran slower); a grid larger
//   than the resident blocks is refused, never shrunk;
// * every product runs on glow_mma.cuh's tensor-core tiles, chosen per
//   product and shape by kernels.flow_stack_plan (in Python; the entry
//   points check it): wgmma_ring_tile (a 3-stage cp.async ring of 64-deep
//   stages in wgmma's 128-byte swizzle feeding m64n128k16 / m64n64k16
//   descriptors; K-major operands as mma_tile stages them, M- or N-major
//   ones in 64-column blocks read through transposed descriptors) at 128 x
//   128 (128 x 64 for the N-packs and dWz); only the forward's conv1,
//   conv2 and ZeroConv take mma_tile at 64 x 64 (ldmatrix and mma.sync
//   m16n8k16) where the 128-row tiles would fill less than half the SMs
//   (blocks 2 and 3), and the backward runs those on wgmma too (with
//   mma_tile inlined beside the wgmma tiles ptxas spilled at 255
//   registers). The gathers take 16-byte runs, the 4-byte runs of the 6,
//   12 and 22 flow channels, or the element path for odd channel counts;
// * the ZeroConv and dya use the TPU kernel's shared-LHS N-pack, as K5's
//   bf16 path does: r = [h2; 1] @ Wzr over the interior pixels plus one row
//   of ones (the value-1 border's row), then a fixed-order shift-sum over
//   the taps; dya = the zero-bordered shift-sum of r2 = cd(dh1) @ W1r; Wzr
//   and W1r are read K-major from the packed wzf and w1f;
// * the plan splits the reduction of the N-packs and of the weight
//   gradients (dWz, dW2, dW1) into whole 64-deep stages where the output
//   tiles leave more than half the SMs idle; each split writes its partial,
//   and the stage that reads the result sums the splits in split order
//   (the shift-sums read every split of r and r2; dWz, dW2, dW1 are summed
//   by a finishing job of the next stage); conv1, conv2, dh2 and dh1 are
//   read by the next product through cp.async, so they are not split;
// * the stages (each a loop of the blocks over its units; a grid sync
//   between stages): forward 4 per flow plus 1 (flow k - 1's ZeroConv
//   finish shares a per-pixel stage with flow k's ActNorm and 1x1 conv;
//   conv1; conv2; the N-pack), backward 4 per flow plus 6 (flow k's
//   gradient stages run beside flow k - 1's recompute, with ya and h1
//   double-buffered; flow k + 1's tail and flow k's ZeroConv gradient share
//   a per-pixel stage; every finishing sum rides in a later stage): 129 and
//   134 syncs at G = 32; a sync costs about 1.1 us on the 132-block grid
//   (chip_smoke.py's probe);
// * the per-pixel stages work on units of tp pixels (the plan's, about a
//   unit an SM): the ActNorm and the c x c product on the CUDA cores, the
//   backward's tail (dx and the unit's partials of dwt, d an_s, d an_b) and
//   the ZeroConv gradient (gs, and the unit's partials of dscale and dbz),
//   finished by warp-per-column sums in a later stage;
// * with a stamps buffer, block 0 records the device clock after each
//   grid sync (the stage times chip_smoke.py prints).
//
// f32, the checks only (namespace f32, chosen by dtype, never as a
// fallback): the first design on glow_gemm.cuh's 64 x 64 tile on the CUDA
// cores, 128 threads, 5 grid syncs per flow forward and 10 backward.
//
// Deterministic: no atomics; split partials, per-tile column sums and the
// per-unit partials are added in a fixed order by a later stage, and each
// flow's weight gradients are written once; the result does not depend on
// which block computed which unit, so two runs are bit-equal.
//
// Not yet done (later work): keeping h1 / h2 on chip (the TPU kernel keeps
// them in VMEM; here they go through L2 and device memory), overlapping a
// tile's epilogue with the next tile's loads (one block an SM leaves the
// tensor cores idle between the many short tiles of the block-0 stages),
// splitting conv1 / conv2 / dh2 / dh1 at the small blocks (their consumers
// would have to sum the partials inside their cp.async gathers).
//
// Plain C interface for ctypes. Every entry point launches on the given
// stream, does not synchronise and allocates nothing; it returns the CUDA
// error of its launch (cudaErrorInvalidValue for a shape or plan it does
// not take).

#include <cooperative_groups.h>

#include "glow_mma.cuh"

namespace cg = cooperative_groups;

namespace {

// per-flow stride, in elements, of a packed (G, ...) weight: a multiple of 8
// so that every flow's slice starts 16-byte aligned (matches the wrapper)
__host__ __device__ inline long long flow_stride(long long n) { return (n + 7) / 8 * 8; }

__device__ __forceinline__ bool dispatch(int) { return false; }

template <class F, class... R>
__device__ __forceinline__ bool dispatch(int u, int n, const F& f, const R&... rest) {
  if (u < n) {
    f(u);
    return true;
  }
  return dispatch(u - n, rest...);
}

// One stage: the jobs (unit count, unit function) laid end to end; block b
// takes units b, b + grid, ...; then the whole grid waits.
template <class... J>
__device__ __forceinline__ void stage(const J&... jobs) {
  for (int u = blockIdx.x; dispatch(u, jobs...); u += gridDim.x) __syncthreads();
  cg::this_grid().sync();
}

// ---------------------------------------------------------------------------
// f32, the checks only: the first design (glow_gemm.cuh's 64 x 64 tile on
// the CUDA cores, 128 threads, 5 grid syncs per flow forward and 10
// backward)
// ---------------------------------------------------------------------------

namespace f32 {

constexpr int kUnit = 1024;          // elements of one elementwise unit
constexpr int kStackFloats = kBM * kCS;   // floats of Smem::cs, the per-pixel scratch
constexpr int kMaxTilePixels = 64;   // pixels of one backward tail unit

__host__ __device__ inline int units(long long n) {
  return static_cast<int>((n + kUnit - 1) / kUnit);
}

template <typename T>
__device__ __forceinline__ float cdr(float v) {
  return to_float(from_float<T>(v));
}

// one GEMM of a stage: its shape, its reduction split and its tile counts
struct Plan {
  int M, N, K, splits, k_split, mt, nt;
  __host__ __device__ int tiles() const { return mt * nt * splits; }
};

Plan plan(int M, int N, int K, bool split) {
  const Split s = split_k(M, N, K, split);
  return Plan{M, N, K, s.splits, s.k_split, (M + kBM - 1) / kBM, (N + kBN - 1) / kBN};
}

// unit u of a GEMM: its tile (rows fastest, then columns, then splits)
template <typename T, class Op>
__device__ __forceinline__ void tile_of(const Op& op, const Plan& p, int u, Smem<T>& sm) {
  const int per = p.mt * p.nt;
  const int z = u / per, r = u - z * per;
  const int mi = r % p.mt, ni = r / p.mt;
  gemm_tile<T>(op, p.M, p.N, p.K, p.k_split, Tile{mi * kBM, ni * kBN, z, mi, p.mt}, sm);
}

// unit u of an elementwise job over n elements
template <class F>
__device__ __forceinline__ void elems(int u, long long n, const F& f) {
  const long long base = static_cast<long long>(u) * kUnit;
  for (int j = threadIdx.x; j < kUnit; j += kThreads) {
    if (base + j < n) f(base + j);
  }
}

// fixed-order tree sum over the block's threads; every thread gets it
__device__ __forceinline__ float block_sum(float v, float* red) {
  const int tid = threadIdx.x;
  red[tid] = v;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (tid < s) red[tid] += red[tid + s];
    __syncthreads();
  }
  const float total = red[0];
  __syncthreads();
  return total;
}

// y2[p, o] = sum_i cd(s_i (x[p, i] + b_i)) cd(wt[i, o]), f32 sums
template <typename T>
__device__ __forceinline__ float invconv_at(const float* xr, const float* anb, const float* ans,
                                            const float* wt, int c, int o) {
  float acc = 0.0f;
  for (int i = 0; i < c; ++i)
    acc = fmaf(cdr<T>(ans[i] * (xr[i] + anb[i])), cdr<T>(wt[i * c + o]), acc);
  return acc;
}

// sum over the splits of part (splits x n), in split order
__device__ __forceinline__ float sum_splits(const float* part, long long n, int splits,
                                            long long i) {
  float s = 0.0f;
  for (int z = 0; z < splits; ++z) s += part[z * n + i];
  return s;
}

// the byte layout of the scratch, shared by the size query and the entry
// points (each piece 256-byte aligned)
struct Layout {
  long long ya, h1, h2, dh2, dh1, gs, convz, pz, pwz, pw2, pw1, pya, cp2, cp1, pdwt, pdans, pdanb,
      tmp, total;
};

struct Shapes {
  Geo g;
  int c, tp, tiles;      // channels, pixels per tail unit, tail units
  long long p;           // pixels
  Plan conv1, conv2, zconv, dwz, dh2, dw2, dh1, dw1, dya;
};

Shapes shapes(const Geo& g) {
  Shapes s;
  s.g = g;
  s.c = 2 * g.cin;
  s.p = static_cast<long long>(g.b) * g.h * g.w;
  const int p = static_cast<int>(s.p);
  const int q = g.b * (g.h + 2 * g.ph) * (g.w + 2 * g.pw);
  const int taps = g.kh * g.kw, ch = g.cin;
  s.tp = kStackFloats / (2 * s.c);
  s.tp = s.tp > kMaxTilePixels ? kMaxTilePixels : s.tp;
  s.tiles = static_cast<int>((s.p + s.tp - 1) / s.tp);
  s.conv1 = plan(p, g.f, taps * ch, false);
  s.conv2 = plan(p, g.f, g.f, false);
  s.zconv = plan(p, ch, taps * g.f, true);
  s.dwz = plan(g.f, taps * ch, q, true);
  s.dh2 = plan(p, g.f, taps * ch, false);
  s.dw2 = plan(g.f, g.f, p, true);
  s.dh1 = plan(p, g.f, g.f, false);
  s.dw1 = plan(taps * ch, g.f, p, true);
  s.dya = plan(p, ch, taps * g.f, true);
  return s;
}

Layout layout(const Shapes& s, int cdb, bool backward) {
  const Geo& g = s.g;
  const long long p = s.p, f = g.f, ch = g.cin, c = s.c, taps = g.kh * g.kw;
  Layout l{};
  long long at = 0;
  auto take = [&](long long bytes) {
    const long long here = at;
    at += (bytes + 255) / 256 * 256;
    return here;
  };
  l.ya = take(p * ch * cdb);
  l.h1 = take(p * f * cdb);
  l.h2 = take(p * f * cdb);
  l.pz = take(4LL * s.zconv.splits * p * ch);
  if (backward) {
    l.dh2 = take(p * f * cdb);
    l.dh1 = take(p * f * cdb);
    l.gs = take(p * ch * cdb);
    l.convz = take(4 * p * ch);
    l.pwz = take(4LL * s.dwz.splits * f * taps * ch);
    l.pw2 = take(4LL * s.dw2.splits * f * f);
    l.pw1 = take(4LL * s.dw1.splits * taps * ch * f);
    l.pya = take(4LL * s.dya.splits * p * ch);
    l.cp2 = take(4LL * f * s.dh2.mt);
    l.cp1 = take(4LL * f * s.dh1.mt);
    l.pdwt = take(4LL * s.tiles * c * c);
    l.pdans = take(4LL * s.tiles * c);
    l.pdanb = take(4LL * s.tiles * c);
  } else {
    l.tmp = take(4 * 2 * p * c);
  }
  l.total = at;
  return l;
}

// the operands and scratch of one call; each packed weight has G slices of
// flow_stride(its size) elements
struct Args {
  Shapes s;
  int flows, save;
  bool va, vf;                            // 16-byte loads along ch / along f
  const float* x;                         // fwd: input; bwd: the saved inputs (G, P, c)
  const float* grad;                      // bwd: gradient of the output
  float* y;                               // fwd: output; bwd: dx
  float* xsave;                           // fwd with save: (G, P, c)
  const float *anb, *ans, *wt;            // (G, c), (G, c), (G, c, c)
  const void *w1f, *w1t, *w2, *w2t, *wz, *wzf;
  const float *b1, *b2, *bz, *scale;      // (G, f), (G, f), (G, ch), (G, ch)
  float *danb, *dans, *dwt, *dw1, *db1, *dw2, *db2, *dwz, *dbz, *dscale;
  char* scratch;
  Layout l;
};

template <typename T>
__global__ void __launch_bounds__(kThreads) flow_stack_fwd(const Args a) {
  __shared__ __align__(128) Smem<T> sm;
  const Shapes& s = a.s;
  const Geo& g = s.g;
  const int c = s.c, ch = g.cin, f = g.f, taps = g.kh * g.kw;
  const long long P = s.p;
  T* ya = reinterpret_cast<T*>(a.scratch + a.l.ya);
  T* h1 = reinterpret_cast<T*>(a.scratch + a.l.h1);
  T* h2 = reinterpret_cast<T*>(a.scratch + a.l.h2);
  float* pz = reinterpret_cast<float*>(a.scratch + a.l.pz);
  float* tmp = reinterpret_cast<float*>(a.scratch + a.l.tmp);
  for (int k = 0; k < a.flows; ++k) {
    // flow k reads the chunk input or the previous flow's output and writes
    // the next flow's input (the saved inputs themselves when saving)
    const float* in = k == 0 ? a.x
                             : (a.save ? a.xsave + k * P * c : tmp + ((k + 1) & 1) * P * c);
    float* out = k == a.flows - 1 ? a.y
                                  : (a.save ? a.xsave + (k + 1) * P * c : tmp + (k & 1) * P * c);
    const float* anb = a.anb + k * c;
    const float* ans = a.ans + k * c;
    const float* wt = a.wt + static_cast<long long>(k) * c * c;
    const T* w1f = static_cast<const T*>(a.w1f) + k * flow_stride(taps * ch * f);
    const T* w2 = static_cast<const T*>(a.w2) + k * flow_stride(static_cast<long long>(f) * f);
    const T* wz = static_cast<const T*>(a.wz) + k * flow_stride(taps * f * ch);
    const float* b1 = a.b1 + k * f;
    const float* b2 = a.b2 + k * f;
    const float* bz = a.bz + k * ch;
    const float* scale = a.scale + k * ch;
    const bool save0 = a.save && k == 0;

    stage(units(P * c), [&](int u) {
      elems(u, P * c, [&](long long e) {
        const long long p = e / c;
        const int o = static_cast<int>(e - p * c);
        const float v = invconv_at<T>(in + p * c, anb, ans, wt, c, o);
        if (save0) a.xsave[e] = in[e];
        out[e] = v;
        if (o < ch) ya[p * ch + o] = from_float<T>(v);
      });
    });
    stage(s.conv1.tiles(), [&](int u) {
      tile_of<T>(vec(Conv1Op<T>{g, ya, w1f, b1, h1}, a.va, a.vf), s.conv1, u, sm);
    });
    stage(s.conv2.tiles(), [&](int u) {
      tile_of<T>(vec(Conv2Op<T>{g, h1, w2, b2, h2}, a.vf, a.vf), s.conv2, u, sm);
    });
    stage(s.zconv.tiles(), [&](int u) {
      tile_of<T>(vec(ZeroConvOp<T>{g, h2, wz, pz}, a.vf, a.va), s.zconv, u, sm);
    });
    // out[:, ch:] = yb + (convz + bz) exp(3 scale)
    stage(units(P * ch), [&](int u) {
      elems(u, P * ch, [&](long long e) {
        const long long p = e / ch;
        const int cc = static_cast<int>(e - p * ch);
        float v = sum_splits(pz, P * ch, s.zconv.splits, e) + bz[cc];
        v *= expf(scale[cc] * 3.0f);
        out[p * c + ch + cc] += v;
      });
    });
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) flow_stack_bwd(const Args a) {
  __shared__ __align__(128) Smem<T> sm;
  const Shapes& s = a.s;
  const Geo& g = s.g;
  const int c = s.c, ch = g.cin, f = g.f, taps = g.kh * g.kw, tp = s.tp;
  const long long P = s.p;
  char* sc = a.scratch;
  T* ya = reinterpret_cast<T*>(sc + a.l.ya);
  T* h1 = reinterpret_cast<T*>(sc + a.l.h1);
  T* h2 = reinterpret_cast<T*>(sc + a.l.h2);
  T* dh2 = reinterpret_cast<T*>(sc + a.l.dh2);
  T* dh1 = reinterpret_cast<T*>(sc + a.l.dh1);
  T* gs = reinterpret_cast<T*>(sc + a.l.gs);
  float* convz = reinterpret_cast<float*>(sc + a.l.convz);
  float* pz = reinterpret_cast<float*>(sc + a.l.pz);
  float* pwz = reinterpret_cast<float*>(sc + a.l.pwz);
  float* pw2 = reinterpret_cast<float*>(sc + a.l.pw2);
  float* pw1 = reinterpret_cast<float*>(sc + a.l.pw1);
  float* pya = reinterpret_cast<float*>(sc + a.l.pya);
  float* cp2 = reinterpret_cast<float*>(sc + a.l.cp2);
  float* cp1 = reinterpret_cast<float*>(sc + a.l.cp1);
  float* pdwt = reinterpret_cast<float*>(sc + a.l.pdwt);
  float* pdans = reinterpret_cast<float*>(sc + a.l.pdans);
  float* pdanb = reinterpret_cast<float*>(sc + a.l.pdanb);
  const long long n_dwz = static_cast<long long>(f) * taps * ch;
  const long long n_dw2 = static_cast<long long>(f) * f;
  const long long n_dw1 = static_cast<long long>(taps) * ch * f;
  const long long n_tail = static_cast<long long>(c) * c + 2 * c;

  // flow kf's dwt, d an_s, d an_b from the tail units' partials, in order
  auto finish = [&](int u, int kf) {
    elems(u, n_tail, [&](long long e) {
      float v = 0.0f;
      if (e < c * c) {
        for (int t = 0; t < s.tiles; ++t) v += pdwt[static_cast<long long>(t) * c * c + e];
        a.dwt[static_cast<long long>(kf) * c * c + e] = v;
      } else if (e < c * c + c) {
        const int i = static_cast<int>(e - c * c);
        for (int t = 0; t < s.tiles; ++t) v += pdans[t * c + i];
        a.dans[kf * c + i] = v;
      } else {
        const int i = static_cast<int>(e - c * c - c);
        for (int t = 0; t < s.tiles; ++t) v += pdanb[t * c + i];
        a.danb[kf * c + i] = v;
      }
    });
  };
  // out[n] = sum over row tiles of colpart[n * mt + t], in order
  auto colsum = [&](int u, const float* cp, int mt, float* out) {
    elems(u, f, [&](long long n) {
      float v = 0.0f;
      for (int t = 0; t < mt; ++t) v += cp[n * mt + t];
      out[n] = v;
    });
  };

  for (int i = 0; i < a.flows; ++i) {
    const int k = a.flows - 1 - i;
    const float* x = a.x + k * P * c;
    const float* gin = i == 0 ? a.grad : a.y;      // the gradient at flow k's output
    const float* anb = a.anb + k * c;
    const float* ans = a.ans + k * c;
    const float* wt = a.wt + static_cast<long long>(k) * c * c;
    const long long s1 = flow_stride(n_dw1), s2 = flow_stride(n_dw2), sz = flow_stride(n_dwz);
    const T* w1f = static_cast<const T*>(a.w1f) + k * s1;
    const T* w1t = static_cast<const T*>(a.w1t) + k * s1;
    const T* w2 = static_cast<const T*>(a.w2) + k * s2;
    const T* w2t = static_cast<const T*>(a.w2t) + k * s2;
    const T* wz = static_cast<const T*>(a.wz) + k * sz;
    const T* wzf = static_cast<const T*>(a.wzf) + k * sz;
    const float* b1 = a.b1 + k * f;
    const float* b2 = a.b2 + k * f;
    const float* bz = a.bz + k * ch;
    const float* scale = a.scale + k * ch;

    // 1. recompute cd(ya); finish the previous flow's tail sums
    auto ya_job = [&](int u) {
      elems(u, P * ch, [&](long long e) {
        const long long p = e / ch;
        const int o = static_cast<int>(e - p * ch);
        ya[e] = from_float<T>(invconv_at<T>(x + p * c, anb, ans, wt, c, o));
      });
    };
    if (i == 0) {
      stage(units(P * ch), ya_job);
    } else {
      stage(units(P * ch), ya_job, units(n_tail), [&](int u) { finish(u, k + 1); });
    }
    // 2-4. h1, h2 and the ZeroConv partials, as the forward
    stage(s.conv1.tiles(), [&](int u) {
      tile_of<T>(vec(Conv1Op<T>{g, ya, w1f, b1, h1}, a.va, a.vf), s.conv1, u, sm);
    });
    stage(s.conv2.tiles(), [&](int u) {
      tile_of<T>(vec(Conv2Op<T>{g, h1, w2, b2, h2}, a.vf, a.vf), s.conv2, u, sm);
    });
    stage(s.zconv.tiles(), [&](int u) {
      tile_of<T>(vec(ZeroConvOp<T>{g, h2, wz, pz}, a.vf, a.va), s.zconv, u, sm);
    });
    // 5. convz = sum of the partials + bz
    stage(units(P * ch), [&](int u) {
      elems(u, P * ch, [&](long long e) {
        convz[e] = sum_splits(pz, P * ch, s.zconv.splits, e) + bz[static_cast<int>(e % ch)];
      });
    });
    // 6. one unit per ZeroConv channel: gs = gb exp(3 scale) in cd,
    //    dscale = 3 sum(gb convz exp(3 scale)), dbz = sum(gs)
    stage(ch, [&](int cc) {
      const float ex = expf(scale[cc] * 3.0f);
      float s1 = 0.0f, s2 = 0.0f;
      for (long long p = threadIdx.x; p < P; p += kThreads) {
        const float gv = gin[p * c + ch + cc];
        const float gsv = gv * ex;
        gs[p * ch + cc] = from_float<T>(gsv);
        s1 += gv * convz[p * ch + cc] * ex;
        s2 += gsv;
      }
      s1 = block_sum(s1, sm.cs);
      s2 = block_sum(s2, sm.cs);
      if (threadIdx.x == 0) {
        a.dscale[k * ch + cc] = 3.0f * s1;
        a.dbz[k * ch + cc] = s2;
      }
    });
    // 7. dWz partials over the padded grid; dh2 and its column sums
    stage(s.dwz.tiles(), [&](int u) {
      tile_of<T>(vec(DwzOp<T>{g, h2, gs, pwz}, a.vf, a.va), s.dwz, u, sm);
    }, s.dh2.tiles(), [&](int u) {
      tile_of<T>(vec(Dh2Op<T>{g, gs, wzf, h2, dh2, cp2}, a.va, a.vf), s.dh2, u, sm);
    });
    // 8. dWz, db2; dW2 partials; dh1 and its column sums
    stage(units(n_dwz), [&](int u) {
      elems(u, n_dwz, [&](long long e) {
        a.dwz[k * n_dwz + e] = sum_splits(pwz, n_dwz, s.dwz.splits, e);
      });
    }, units(f), [&](int u) { colsum(u, cp2, s.dh2.mt, a.db2 + k * f); },
    s.dw2.tiles(), [&](int u) {
      tile_of<T>(vec(Dw2Op<T>{g, h1, dh2, pw2}, a.vf, a.vf), s.dw2, u, sm);
    }, s.dh1.tiles(), [&](int u) {
      tile_of<T>(vec(Dh1Op<T>{g, dh2, w2t, h1, dh1, cp1}, a.vf, a.vf), s.dh1, u, sm);
    });
    // 9. dW2, db1; dW1 and dya partials
    stage(units(n_dw2), [&](int u) {
      elems(u, n_dw2, [&](long long e) {
        a.dw2[k * n_dw2 + e] = sum_splits(pw2, n_dw2, s.dw2.splits, e);
      });
    }, units(f), [&](int u) { colsum(u, cp1, s.dh1.mt, a.db1 + k * f); },
    s.dw1.tiles(), [&](int u) {
      tile_of<T>(vec(Dw1Op<T>{g, ya, dh1, pw1}, a.va, a.vf), s.dw1, u, sm);
    }, s.dya.tiles(), [&](int u) {
      tile_of<T>(vec(DyaOp<T>{g, dh1, w1t, pya}, a.vf, a.va), s.dya, u, sm);
    });
    // 10. dW1; the tail, one unit per tp pixels: dy2 = cd([ga + dya, gb]),
    //     dwt / d an_s / d an_b partials, dx (over the gradient in place:
    //     a unit reads its pixels' gradient before it writes their dx)
    stage(units(n_dw1), [&](int u) {
      elems(u, n_dw1, [&](long long e) {
        a.dw1[k * n_dw1 + e] = sum_splits(pw1, n_dw1, s.dw1.splits, e);
      });
    }, s.tiles, [&](int t) {
      float* y1s = sm.cs;
      float* dys = sm.cs + tp * c;
      const long long p0 = static_cast<long long>(t) * tp;
      for (int j = threadIdx.x; j < tp * c; j += kThreads) {
        const int pl = j / c, ci = j - pl * c;
        const long long p = p0 + pl;
        float yv = 0.0f, dv = 0.0f;
        if (p < P) {
          yv = cdr<T>(ans[ci] * (x[p * c + ci] + anb[ci]));
          float gv = gin[p * c + ci];
          if (ci < ch) gv = gv + sum_splits(pya, P * ch, s.dya.splits, p * ch + ci);
          dv = cdr<T>(gv);
        }
        y1s[j] = yv;
        dys[j] = dv;
      }
      __syncthreads();
      for (int j = threadIdx.x; j < c * c; j += kThreads) {
        const int ci = j / c, o = j - ci * c;
        float acc = 0.0f;
        for (int pl = 0; pl < tp; ++pl) acc = fmaf(y1s[pl * c + ci], dys[pl * c + o], acc);
        pdwt[static_cast<long long>(t) * c * c + j] = acc;
      }
      if (threadIdx.x < c) {
        const int ci = threadIdx.x;
        float sa = 0.0f, sb = 0.0f;
        for (int pl = 0; pl < tp && p0 + pl < P; ++pl) {
          const long long p = p0 + pl;
          float dy1 = 0.0f;
          for (int o = 0; o < c; ++o) dy1 = fmaf(dys[pl * c + o], cdr<T>(wt[ci * c + o]), dy1);
          sa += dy1 * (x[p * c + ci] + anb[ci]);
          const float dxv = dy1 * ans[ci];
          sb += dxv;
          a.y[p * c + ci] = dxv;
        }
        pdans[t * c + ci] = sa;
        pdanb[t * c + ci] = sb;
      }
    });
  }
  stage(units(n_tail), [&](int u) { finish(u, 0); });
}

Args make_args(const Geo& g, int flows, bool backward, void* scratch) {
  Args a{};
  a.s = shapes(g);
  a.flows = flows;
  a.va = g.cin % 4 == 0;
  a.vf = g.f % 4 == 0;
  a.scratch = static_cast<char*>(scratch);
  a.l = layout(a.s, 4, backward);
  return a;
}

}  // namespace f32

// ---------------------------------------------------------------------------
// bf16: the tensor-core path (the main path)
// ---------------------------------------------------------------------------

namespace tc {

using mma::bf16;
constexpr int kRing = 3;                        // stages of the cp.async ring
using Big = mma::Cfg<128, 128, 2, 4, 1, kRing>;   // 128 x 128 (wgmma)
using Sm = mma::Cfg<64, 64, 2, 4, 1, kRing>;      // 64 x 64: mma.sync, 8 warps of 32 x 16
using Narrow = mma::Cfg<128, 64, 2, 4, 1, kRing>; // 128 x 64 (wgmma)
constexpr int kThreads = 256;                   // one block size for every stage
constexpr int kMinBlocks = 1;                   // resident blocks an SM
constexpr int kSmem = 1024 + Big::kSmemBytes;   // + alignment slack for wgmma
constexpr int kPixFloats = 2048;                // floats of one per-pixel array
constexpr int kUnit = 1024;                     // elements of one elementwise unit
static_assert(Sm::kThreads == kThreads && Big::kThreads == kThreads &&
                  Narrow::kThreads == kThreads, "one block size");
static_assert(Sm::kSmemBytes <= Big::kSmemBytes && Narrow::kSmemBytes <= Big::kSmemBytes,
              "one shared-memory size");
static_assert(4 * kPixFloats * 4 <= Big::kSmemBytes, "the per-pixel arrays fit");

// the tile of a product (kernels.flow_stack_plan names them "mma64",
// "wgmma128x64", "wgmma128")
enum Kind { kMma64 = 0, kWg64 = 1, kWg128 = 2 };
constexpr unsigned kM64 = 1u << kMma64, kW64 = 1u << kWg64, kW128 = 1u << kWg128;
// the products of a flow, in the plan's order
enum { kConv1, kConv2, kZconv, kDwz, kDh2, kDw2, kDh1, kDw1, kDya, kProds };
// the tiles each may take and whether its reduction may be split (its
// consumer sums the partials). The 64 x 64 mma.sync tile serves the
// forward's products at the small blocks; the backward runs every product
// on wgmma (the recompute's 64 x 64 choices mapped to wgmma by tc_args:
// with mma_tile inlined beside the wgmma tiles, ptxas spilled at 255
// registers)
constexpr unsigned kAllowed[kProds] = {kM64 | kW128, kM64 | kW128, kM64 | kW64,
                                       kW64,         kW128,        kW128,
                                       kW128,        kW128,        kW64};
constexpr unsigned kBwdKinds = kW64 | kW128;
constexpr bool kSplittable[kProds] = {false, false, true, true, false,
                                      true,  false, true, true};

__host__ __device__ inline int kind_bm(int kind) { return kind == kMma64 ? 64 : 128; }
__host__ __device__ inline int kind_bn(int kind) {
  return kind == kMma64 || kind == kWg64 ? 64 : 128;
}

// one product of a flow: its GEMM shape, tile and reduction split
struct Prod {
  int M, N, K, kind, splits, k_split, mt, nt;
  __host__ __device__ int tiles() const { return mt * nt * splits; }
};

__device__ __forceinline__ float cdr(float v) { return __bfloat162float(__float2bfloat16(v)); }

// unit u of a product: its tile (columns fastest, then rows, then splits:
// the column tiles of one row block run side by side, so its A rows come
// from device memory once) on the tile the plan chose; Kinds: the tiles
// this Op is compiled for
template <unsigned Kinds, class Op>
__device__ __forceinline__ void product(const Op& op, const Prod& p, int u, unsigned char* smem) {
  const int per = p.mt * p.nt;
  const int z = u / per, r = u - z * per;
  const int mi = r / p.nt, ni = r % p.nt;
  const Tile t{mi * kind_bm(p.kind), ni * kind_bn(p.kind), z, mi, p.mt};
  if constexpr ((Kinds & kW128) != 0) {
    if (p.kind == kWg128) {
      mma::wgmma_ring_tile<Big>(op, p.M, p.N, p.K, p.k_split, t, smem);
      return;
    }
  }
  if constexpr ((Kinds & kW64) != 0) {
    if (p.kind == kWg64) {
      mma::wgmma_ring_tile<Narrow>(op, p.M, p.N, p.K, p.k_split, t, smem);
      return;
    }
  }
  if constexpr ((Kinds & kM64) != 0) {
    mma::mma_tile<Sm>(op, p.M, p.N, p.K, p.k_split, t, smem);
  } else {
    __trap();  // a tile this product is not compiled for (tc_args prevents it)
  }
}

// C = A B with A (M x f) and B read K-major from bt (N rows of f): conv2
// (bt = W2^T, packed w2t) and dh1 (bt = W2, packed w2)
struct DenseKK {
  static constexpr bool kAK = true;
  static constexpr int kRunA = 8;
  static constexpr bool kBKMajor = true;
  mma::Geom g;
  const bf16* a;
  const bf16* bt;
  __device__ const void* any() const { return a; }
  __device__ mma::Src a_src(int m, int k) const {
    return mma::Src{a + static_cast<long long>(m) * g.f + k, mma::kCopy};
  }
  __device__ mma::Src b_src(int k, int n) const {
    return mma::Src{bt + static_cast<long long>(n) * g.f + k, mma::kCopy};
  }
};
// h2 = bf16(ReLU(h1 W2 + b2))
struct Conv2K : DenseKK {
  const float* bias;
  bf16* h2;
  template <class C>
  __device__ void epilogue(float* cs, const Tile& t, int M, int N) const {
    mma::bias_relu_store<C>(cs, bias, h2, t, M, N);
  }
};
// dh1 = mask(h1 > 0) dh2 W2^T, db1 column partials
struct Dh1K : DenseKK {
  const bf16* h1;
  bf16* dh1;
  float* colpart;
  template <class C>
  __device__ void epilogue(float* cs, const Tile& t, int M, int N) const {
    mma::masked_grad<C>(cs, h1, dh1, colpart, t, M, N);
  }
};
// K5's N-pack with a split reduction: split z's partial product at r + z M N
struct SplitPack : mma::NPack {
  template <class C>
  __device__ void epilogue(float* cs, const Tile& t, int M, int N) const {
    mma::store_f32<C>(cs, r + static_cast<long long>(t.z) * M * N, t, M, N);
  }
};

// The operands, outputs, plan and scratch of one call. The packed weights
// hold G slices of flow_stride(their size) elements each.
struct Args {
  mma::Geom g;
  mma::FastDiv gcd;
  int c, ch, gc, taps, f, flows, save, wa, tp, units;
  long long P, Q, s1, s2, sz;        // pixels, padded pixels, per-flow strides
  int n_tail;                         // c c + 2 c: dwt, d an_s, d an_b
  long long n_dwz, n_dwzp, n_dw2, n_dw1;  // a flow's dWz (and its padded
                                          // partials), dW2, dW1 elements
  Prod pr[kProds];
  const float* x;                     // fwd: input; bwd: the saved inputs (G, P, c)
  const float* grad;                  // bwd: gradient of the output
  float* y;                           // fwd: output; bwd: dx (and the running gradient)
  float* xsave;                       // fwd with save: (G, P, c)
  const float *anb, *ans, *wt;        // (G, c), (G, c), (G, c, c)
  const bf16 *w1f, *w2, *w2t, *wzf;
  const float *b1, *b2, *bz, *scale;  // (G, f), (G, f), (G, ch), (G, ch)
  float *danb, *dans, *dwt, *dw1, *db1, *dw2, *db2, *dwz, *dbz, *dscale;
  // scratch (the forward uses ya, h1, h2, r, cur; ya and h1 are doubled in
  // the backward, where flow k - 1's recompute runs beside flow k's gradient)
  bf16 *ya, *h1, *h2, *dh2, *dh1, *gs;
  float *r, *r2, *pwz, *cp2, *pw2, *cp1, *pw1, *pz, *ptail, *cur;
  unsigned long long* stamps;         // null, or one time a stage boundary
};

// The tracing of a call: with a.stamps set, block 0's thread 0 writes the
// device clock (ns) at the kernel's start and after each stage's grid sync,
// so stamps[i + 1] - stamps[i] is stage i's time, its sync included.
struct Clock {
  int i = 0;
  __device__ __forceinline__ void tick(unsigned long long* stamps) {
    if (stamps != nullptr && blockIdx.x == 0 && threadIdx.x == 0) {
      unsigned long long t;
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
      stamps[i] = t;
    }
    ++i;
  }
};

template <class F>
__device__ __forceinline__ void elems(int u, long long n, const F& f) {
  const long long base = static_cast<long long>(u) * kUnit;
  for (int j = threadIdx.x; j < kUnit; j += kThreads)
    if (base + j < n) f(base + j);
}

__host__ __device__ inline int elem_units(long long n) {
  return static_cast<int>((n + kUnit - 1) / kUnit);
}

// out(n, v) for the columns n of unit u (a warp a column, 8 a unit): v =
// the sum over rows of part[row * cols + n], lanes strided over the rows,
// then a fixed butterfly
template <class Out>
__device__ __forceinline__ void colsum(int u, const float* part, int rows, int cols,
                                       const Out& out) {
  const int n = u * (kThreads / 32) + threadIdx.x / 32, lane = threadIdx.x & 31;
  if (n >= cols) return;
  float v = 0.0f;
  for (int r = lane; r < rows; r += 32) v += part[static_cast<long long>(r) * cols + n];
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  if (lane == 0) out(n, v);
}

__host__ __device__ inline int col_units(int cols) {
  return (cols + kThreads / 32 - 1) / (kThreads / 32);
}

// out[i] = sum over the splits of part, in split order; with cols > 0 the
// output rows hold cols = taps x ch columns read from part rows of taps x
// ch_in (dWz from gs's padded width)
__device__ __forceinline__ void splitsum(int u, const float* part, long long n, long long stride,
                                         int splits, float* out, int cols = 0, int ch = 1,
                                         int ch_in = 1) {
  elems(u, n, [&](long long i) {
    long long in = i;
    if (cols > 0) {
      const long long row = i / cols;
      const int col = static_cast<int>(i - row * cols), tap = col / ch;
      in = (row * (cols / ch) + tap) * ch_in + (col - tap * ch);
    }
    float v = 0.0f;
    for (int z = 0; z < splits; ++z) v += part[z * stride + in];
    out[i] = v;
  });
}

// the sum over the taps (in order) of r at pixel p's neighbour through the
// tap, each the sum of r's splits (in order): the ZeroConv's (sign +1; a
// neighbour outside the image takes the value-1 border's row P) or dya's
// (sign -1; zero outside). r has taps * ch columns. Up to 9 taps, the
// taps' loads of a split are in flight together (r comes from L2).
__device__ __forceinline__ float shift_sum(const Args& a, const float* r, int splits,
                                           long long zstride, int p, int c, int sign,
                                           bool border) {
  const mma::Geom& g = a.g;
  const Pix px = g.pix(p);
  const int n = a.taps * a.ch;
  auto row_of = [&](int tap) -> long long {  // -1: zero
    const int dy = g.kwd.div(tap), dx = tap - dy * g.kw;
    const int oy = sign * (dy - g.ph), ox = sign * (dx - g.pw);
    if (inside(px.y + oy, px.x + ox, g)) return p + oy * g.w + ox;
    return border ? a.P : -1;
  };
  float s = 0.0f;
  if (a.taps <= 9) {  // split by split, the taps' loads in flight together
    long long row[9];
    float t[9];
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      row[tap] = tap < a.taps ? row_of(tap) : -1;
      t[tap] = 0.0f;
    }
    for (int z = 0; z < splits; ++z) {
      float v[9];
#pragma unroll
      for (int tap = 0; tap < 9; ++tap)
        v[tap] = row[tap] >= 0 ? r[z * zstride + row[tap] * n + tap * a.ch + c] : 0.0f;
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) t[tap] = z == 0 ? v[tap] : t[tap] + v[tap];
    }
#pragma unroll
    for (int tap = 0; tap < 9; ++tap)
      if (row[tap] >= 0) s += t[tap];
    return s;
  }
  for (int tap = 0; tap < a.taps; ++tap) {
    const long long row = row_of(tap);
    if (row < 0) continue;
    const float* q = r + row * n + tap * a.ch + c;
    float t = q[0];
    for (int z = 1; z < splits; ++z) t += q[z * zstride];
    s += t;
  }
  return s;
}

// flow k's NN(ya) at pixel p, channel c: (ZeroConv + bz) x exp(3 scale)
__device__ __forceinline__ float coupling_out(const Args& a, int k, int p, int c) {
  const Prod& z = a.pr[kZconv];
  const float conv =
      shift_sum(a, a.r, z.splits, static_cast<long long>(z.M) * z.N, p, c, 1, true);
  return (conv + a.bz[k * a.ch + c]) * expf(a.scale[k * a.ch + c] * 3.0f);
}

// y2[p, o] = sum_i y1s[i] cd(wt[i, o]) (f32 sums, i in order) for one
// pixel's y1 in shared memory
__device__ __forceinline__ float invconv(const float* y1s, const float* wt, int c, int o) {
  float acc = 0.0f;
#pragma unroll 8
  for (int i = 0; i < c; ++i) acc = fmaf(y1s[i], cdr(wt[i * c + o]), acc);
  return acc;
}

// Forward, one unit of tp pixels: flow k's input x (the chunk input, or flow
// k - 1's [ya, yb] in cur plus its NN(ya)), saved when asked; then flow k's
// y1 = cd(s (x + b)) and y2 = y1 cd(wt) (f32 sums) into cur and cd(ya).
// k == G writes the last flow's output instead.
__device__ void fwd_pixels(const Args& a, int t, int k, unsigned char* smem) {
  float* xs = reinterpret_cast<float*>(smem);
  const int c = a.c, ch = a.ch;
  const int p0 = t * a.tp;
  const int np = min(a.tp, static_cast<int>(a.P) - p0);
  const bool last = k == a.flows;
  for (int j = threadIdx.x; j < np * c; j += kThreads) {
    const int pl = j / c, ci = j - pl * c;
    const int p = p0 + pl;
    const long long e = static_cast<long long>(p) * c + ci;
    float v;
    if (k == 0) {
      v = a.x[e];
    } else {
      v = a.cur[e];
      if (ci >= ch) v += coupling_out(a, k - 1, p, ci - ch);
    }
    if (last) {
      a.y[e] = v;
      continue;
    }
    if (a.save) a.xsave[k * a.P * c + e] = v;
    xs[j] = cdr(a.ans[k * c + ci] * (v + a.anb[k * c + ci]));
  }
  if (last) return;
  __syncthreads();  // every read of cur is done before it is overwritten
  const float* wt = a.wt + static_cast<long long>(k) * c * c;
  for (int j = threadIdx.x; j < np * c; j += kThreads) {
    const int pl = j / c, o = j - pl * c;
    const int p = p0 + pl;
    const float acc = invconv(xs + pl * c, wt, c, o);
    a.cur[static_cast<long long>(p) * c + o] = acc;
    if (o < ch) a.ya[static_cast<long long>(p) * ch + o] = __float2bfloat16(acc);
  }
}

// Backward, one unit of tp pixels: flow k's cd(ya) recomputed from its
// saved input, into ya's buffer k & 1
__device__ void ya_pixels(const Args& a, int t, int k, unsigned char* smem) {
  float* y1s = reinterpret_cast<float*>(smem);
  const int c = a.c, ch = a.ch;
  const int p0 = t * a.tp;
  const int np = min(a.tp, static_cast<int>(a.P) - p0);
  const float* x = a.x + k * a.P * c + static_cast<long long>(p0) * c;
  const float* anb = a.anb + k * c;
  const float* ans = a.ans + k * c;
  for (int j = threadIdx.x; j < np * c; j += kThreads) {
    const int ci = j % c;
    y1s[j] = cdr(ans[ci] * (x[j] + anb[ci]));
  }
  __syncthreads();
  const float* wt = a.wt + static_cast<long long>(k) * c * c;
  bf16* ya = a.ya + (k & 1) * a.P * ch + static_cast<long long>(p0) * ch;
  for (int j = threadIdx.x; j < np * ch; j += kThreads) {
    const int pl = j / ch, o = j - pl * ch;
    ya[j] = __float2bfloat16(invconv(y1s + pl * c, wt, c, o));
  }
}

// Backward, one unit of tp pixels. With kt >= 0, flow kt's tail: dy2 =
// cd([ga + dya, gb]) (dya the zero-bordered shift-sum of r2), the unit's
// partials of dwt = cd(y1)^T dy2, d an_s = sum dy1 (x + b) and d an_b = sum
// dx, and dx = dy1 s with dy1 = dy2 cd(wt)^T, written over the gradient
// (the unit reads its pixels' gradient before it writes their dx). With kz
// >= 0, flow kz's ZeroConv gradient at the same pixels: convz = shift-sum
// of r + bz, gs = cd(gb exp(3 scale)) and the unit's partials of dscale / 3
// = sum gb convz exp(3 scale) and dbz = sum gb exp(3 scale), gb the gradient
// at flow kz's output (flow kt's dx, or the chunk's gradient).
__device__ void bwd_pixels(const Args& a, int t, int kz, int kt, unsigned char* smem) {
  float* gsm = reinterpret_cast<float*>(smem);
  float* y1s = gsm + kPixFloats;
  float* dys = y1s + kPixFloats;
  float* ws = dys + kPixFloats;
  const int c = a.c, ch = a.ch;
  const int p0 = t * a.tp;
  const int np = min(a.tp, static_cast<int>(a.P) - p0);
  if (kt >= 0) {
    const float* x = a.x + kt * a.P * c;
    const float* gin = kt == a.flows - 1 ? a.grad : a.y;
    const float* anb = a.anb + kt * c;
    const float* ans = a.ans + kt * c;
    const float* wt = a.wt + static_cast<long long>(kt) * c * c;
    const Prod& d = a.pr[kDya];
    for (int j = threadIdx.x; j < np * c; j += kThreads) {
      const int pl = j / c, ci = j - pl * c;
      const long long e = static_cast<long long>(p0 + pl) * c + ci;
      y1s[j] = cdr(ans[ci] * (x[e] + anb[ci]));
      float gv = gin[e];
      if (ci < ch)
        gv += shift_sum(a, a.r2, d.splits, static_cast<long long>(d.M) * d.N, p0 + pl, ci, -1,
                        false);
      dys[j] = cdr(gv);
    }
    __syncthreads();
    float* pt = a.ptail + static_cast<long long>(t) * (c * c + 2 * c);
    for (int e = threadIdx.x; e < c * c; e += kThreads) {
      const int ci = e / c, o = e - ci * c;
      float acc = 0.0f;
      for (int pl = 0; pl < np; ++pl) acc = fmaf(y1s[pl * c + ci], dys[pl * c + o], acc);
      pt[e] = acc;
    }
    for (int j = threadIdx.x; j < np * c; j += kThreads) {
      const int pl = j / c, ci = j - pl * c;
      const long long e = static_cast<long long>(p0 + pl) * c + ci;
      float dy1 = 0.0f;
#pragma unroll 8
      for (int o = 0; o < c; ++o) dy1 = fmaf(dys[pl * c + o], cdr(wt[ci * c + o]), dy1);
      ws[j] = dy1 * (x[e] + anb[ci]);
      const float dx = dy1 * ans[ci];
      gsm[j] = dx;
      a.y[e] = dx;
    }
    __syncthreads();
    for (int ci = threadIdx.x; ci < c; ci += kThreads) {
      float sa = 0.0f, sb = 0.0f;
      for (int pl = 0; pl < np; ++pl) {
        sa += ws[pl * c + ci];
        sb += gsm[pl * c + ci];
      }
      pt[c * c + ci] = sa;
      pt[c * c + c + ci] = sb;
    }
  }
  if (kz < 0) return;
  float* v1 = y1s;  // free again: the tail read them before the last sync
  float* v2 = dys;
  const Prod& z = a.pr[kZconv];
  for (int j = threadIdx.x; j < np * ch; j += kThreads) {
    const int pl = j / ch, cc = j - pl * ch;
    const int p = p0 + pl;
    const float gb =
        kt >= 0 ? gsm[pl * c + ch + cc] : a.grad[static_cast<long long>(p) * c + ch + cc];
    const float conv =
        shift_sum(a, a.r, z.splits, static_cast<long long>(z.M) * z.N, p, cc, 1, true) +
        a.bz[kz * ch + cc];
    const float ex = expf(a.scale[kz * ch + cc] * 3.0f);
    a.gs[static_cast<long long>(p) * a.gc + cc] = __float2bfloat16(gb * ex);
    v1[j] = gb * conv * ex;
    v2[j] = gb * ex;
  }
  const int pad = a.gc - ch;
  for (int j = threadIdx.x; j < np * pad; j += kThreads) {
    const int pl = j / pad;
    a.gs[static_cast<long long>(p0 + pl) * a.gc + ch + (j - pl * pad)] = __float2bfloat16(0.0f);
  }
  __syncthreads();
  float* pzt = a.pz + static_cast<long long>(t) * 2 * ch;
  for (int cc = threadIdx.x; cc < ch; cc += kThreads) {
    float s1 = 0.0f, s2 = 0.0f;
    for (int pl = 0; pl < np; ++pl) {
      s1 += v1[pl * ch + cc];
      s2 += v2[pl * ch + cc];
    }
    pzt[cc] = s1;
    pzt[ch + cc] = s2;
  }
}

// the per-flow slices of the packed weights and vectors
struct Flow {
  const bf16 *w1f, *w2, *w2t, *wzf;
  const float *b1, *b2;
};
__device__ __forceinline__ Flow flow(const Args& a, int k) {
  return Flow{a.w1f + k * a.s1, a.w2 + k * a.s2, a.w2t + k * a.s2, a.wzf + k * a.sz,
              a.b1 + k * a.f,   a.b2 + k * a.f};
}

__device__ __forceinline__ bf16* ya_of(const Args& a, int k) { return a.ya + (k & 1) * a.P * a.ch; }
__device__ __forceinline__ bf16* h1_of(const Args& a, int k) { return a.h1 + (k & 1) * a.P * a.f; }

// the products of flow k (recompute: conv1, conv2, zconv, on the tiles
// Kinds: the forward's, or the backward's; gradient: the rest)
template <unsigned Kinds>
__device__ __forceinline__ void conv1(const Args& a, int u, int k, bf16* ya, bf16* h1,
                                      unsigned char* smem) {
  const Flow fl = flow(a, k);
  mma::Conv1Op op{a.g, ya, fl.w1f, fl.b1, h1, a.wa};
  product<Kinds & kAllowed[kConv1]>(op, a.pr[kConv1], u, smem);
}
template <unsigned Kinds>
__device__ __forceinline__ void conv2(const Args& a, int u, int k, const bf16* h1,
                                      unsigned char* smem) {
  const Flow fl = flow(a, k);
  Conv2K op{};
  op.g = a.g;
  op.a = h1;
  op.bt = fl.w2t;
  op.bias = fl.b2;
  op.h2 = a.h2;
  product<Kinds & kAllowed[kConv2]>(op, a.pr[kConv2], u, smem);
}
template <unsigned Kinds>
__device__ __forceinline__ void zconv(const Args& a, int u, int k, unsigned char* smem) {
  SplitPack op{};
  op.g = a.g;
  op.x = a.h2;
  op.wk = flow(a, k).wzf;
  op.r = a.r;
  op.kdim = a.f;
  op.ones = true;
  product<Kinds & kAllowed[kZconv]>(op, a.pr[kZconv], u, smem);
}
__device__ __forceinline__ void dwz(const Args& a, int u, unsigned char* smem) {
  const mma::DwzOp op{a.g, a.h2, a.gs, a.pwz, a.gc, a.gcd};
  product<kAllowed[kDwz]>(op, a.pr[kDwz], u, smem);
}
__device__ __forceinline__ void dh2(const Args& a, int u, int k, unsigned char* smem) {
  const mma::Dh2Op op{a.g, a.gs, flow(a, k).wzf, a.h2, a.dh2, a.cp2, a.gc, a.gcd};
  product<kAllowed[kDh2]>(op, a.pr[kDh2], u, smem);
}
__device__ __forceinline__ void dw2(const Args& a, int u, int k, unsigned char* smem) {
  const mma::Dw2Op op{a.g, h1_of(a, k), a.dh2, a.pw2};
  product<kAllowed[kDw2]>(op, a.pr[kDw2], u, smem);
}
__device__ __forceinline__ void dh1(const Args& a, int u, int k, unsigned char* smem) {
  Dh1K op{};
  op.g = a.g;
  op.a = a.dh2;
  op.bt = flow(a, k).w2;
  op.h1 = h1_of(a, k);
  op.dh1 = a.dh1;
  op.colpart = a.cp1;
  product<kAllowed[kDh1]>(op, a.pr[kDh1], u, smem);
}
__device__ __forceinline__ void dw1(const Args& a, int u, int k, unsigned char* smem) {
  mma::Dw1Op op{a.g, ya_of(a, k), a.dh1, a.pw1, a.wa};
  product<kAllowed[kDw1]>(op, a.pr[kDw1], u, smem);
}
__device__ __forceinline__ void dya(const Args& a, int u, int k, unsigned char* smem) {
  SplitPack op{};
  op.g = a.g;
  op.x = a.dh1;
  op.wk = flow(a, k).w1f;
  op.r = a.r2;
  op.kdim = a.f;
  op.ones = false;
  product<kAllowed[kDya]>(op, a.pr[kDya], u, smem);
}

__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
  return reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(raw) + 1023) &
                                          ~static_cast<uintptr_t>(1023));
}

// Forward: per flow k, 4 stages (4 G + 1 grid syncs a call):
//   A  flow k - 1's ZeroConv finish and flow k's ActNorm + 1x1 conv (per pixel)
//   B  conv1 -> h1;  C  conv2 -> h2;  D  the ZeroConv's N-pack r = [h2; 1] Wzr
// and a last A that writes the output.
__global__ void __launch_bounds__(kThreads, kMinBlocks) flow_stack_fwd(const Args a) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  Clock clk;
  clk.tick(a.stamps);
  for (int k = 0; k <= a.flows; ++k) {
    stage(a.units, [&](int t) { fwd_pixels(a, t, k, smem); });
    clk.tick(a.stamps);
    if (k == a.flows) break;
    stage(a.pr[kConv1].tiles(), [&](int u) { conv1<~0u>(a, u, k, a.ya, a.h1, smem); });
    clk.tick(a.stamps);
    stage(a.pr[kConv2].tiles(), [&](int u) { conv2<~0u>(a, u, k, a.h1, smem); });
    clk.tick(a.stamps);
    stage(a.pr[kZconv].tiles(), [&](int u) { zconv<~0u>(a, u, k, smem); });
    clk.tick(a.stamps);
  }
}

// Backward: a prologue recomputes flow G - 1 to its ZeroConv product (4
// stages); then per flow k, from G - 1 down, 4 stages, each running flow
// k's gradient beside flow k - 1's recompute (ya and h1 doubled) and the
// finishing sums of the stage before:
//   S1  per pixel: flow k + 1's tail (dx) and flow k's ZeroConv gradient
//       (gs, dscale / dbz partials); flow k - 1's ya; dW1(k + 1)
//   S2  dWz, dh2 (db2 per tile) | conv1(k - 1); dscale, dbz; dwt, d an(k + 1)
//   S3  dW2, dh1 (db1 per tile) | conv2(k - 1); dWz, db2
//   S4  dW1, dya's N-pack r2    | zconv(k - 1); dW2, db1
// and two closing stages: flow 0's tail with dW1(0), then its dwt, d an
// (4 G + 6 grid syncs a call).
__global__ void __launch_bounds__(kThreads, kMinBlocks) flow_stack_bwd(const Args a) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  // (every size is read from a, the kernel's parameters, where it is used:
  // values kept in registers across the flow loop made ptxas spill)
  const int G = a.flows;
  auto tail_finish = [&](int u, int k) {
    colsum(u, a.ptail, a.units, a.n_tail, [&](int n, float v) {
      const int c = a.c;
      if (n < c * c) {
        a.dwt[static_cast<long long>(k) * c * c + n] = v;
      } else if (n < c * c + c) {
        a.dans[k * c + n - c * c] = v;
      } else {
        a.danb[k * c + n - c * c - c] = v;
      }
    });
  };
  auto dw1_finish = [&](int u, int k) {
    splitsum(u, a.pw1, a.n_dw1, a.n_dw1, a.pr[kDw1].splits, a.dw1 + k * a.n_dw1);
  };

  Clock clk;
  clk.tick(a.stamps);
  stage(a.units, [&](int t) { ya_pixels(a, t, G - 1, smem); });
  clk.tick(a.stamps);
  stage(a.pr[kConv1].tiles(),
        [&](int u) { conv1<kBwdKinds>(a, u, G - 1, ya_of(a, G - 1), h1_of(a, G - 1), smem); });
  clk.tick(a.stamps);
  stage(a.pr[kConv2].tiles(),
        [&](int u) { conv2<kBwdKinds>(a, u, G - 1, h1_of(a, G - 1), smem); });
  clk.tick(a.stamps);
  stage(a.pr[kZconv].tiles(), [&](int u) { zconv<kBwdKinds>(a, u, G - 1, smem); });
  clk.tick(a.stamps);
  for (int k = G - 1; k >= 0; --k) {
    const bool tail = k + 1 < G, next = k > 0;
    stage(a.units, [&](int t) { bwd_pixels(a, t, k, tail ? k + 1 : -1, smem); },
          next ? a.units : 0, [&](int t) { ya_pixels(a, t, k - 1, smem); },
          tail ? elem_units(a.n_dw1) : 0, [&](int u) { dw1_finish(u, k + 1); });
    clk.tick(a.stamps);
    stage(a.pr[kDwz].tiles(), [&](int u) { dwz(a, u, smem); },
          a.pr[kDh2].tiles(), [&](int u) { dh2(a, u, k, smem); },
          next ? a.pr[kConv1].tiles() : 0,
          [&](int u) {
            conv1<kBwdKinds>(a, u, k - 1, ya_of(a, k - 1), h1_of(a, k - 1), smem);
          },
          col_units(2 * a.ch), [&](int u) {
            colsum(u, a.pz, a.units, 2 * a.ch, [&](int n, float v) {
              if (n < a.ch) {
                a.dscale[k * a.ch + n] = 3.0f * v;
              } else {
                a.dbz[k * a.ch + n - a.ch] = v;
              }
            });
          },
          tail ? col_units(a.n_tail) : 0, [&](int u) { tail_finish(u, k + 1); });
    clk.tick(a.stamps);
    stage(a.pr[kDw2].tiles(), [&](int u) { dw2(a, u, k, smem); },
          a.pr[kDh1].tiles(), [&](int u) { dh1(a, u, k, smem); },
          next ? a.pr[kConv2].tiles() : 0,
          [&](int u) { conv2<kBwdKinds>(a, u, k - 1, h1_of(a, k - 1), smem); },
          elem_units(a.n_dwz), [&](int u) {
            splitsum(u, a.pwz, a.n_dwz, a.n_dwzp, a.pr[kDwz].splits, a.dwz + k * a.n_dwz,
                     a.taps * a.ch, a.ch, a.gc);
          },
          col_units(a.f), [&](int u) {
            colsum(u, a.cp2, a.pr[kDh2].mt, a.f,
                   [&](int n, float v) { a.db2[k * a.f + n] = v; });
          });
    clk.tick(a.stamps);
    stage(a.pr[kDw1].tiles(), [&](int u) { dw1(a, u, k, smem); },
          a.pr[kDya].tiles(), [&](int u) { dya(a, u, k, smem); },
          next ? a.pr[kZconv].tiles() : 0, [&](int u) { zconv<kBwdKinds>(a, u, k - 1, smem); },
          elem_units(a.n_dw2), [&](int u) {
            splitsum(u, a.pw2, a.n_dw2, a.n_dw2, a.pr[kDw2].splits, a.dw2 + k * a.n_dw2);
          },
          col_units(a.f), [&](int u) {
            colsum(u, a.cp1, a.pr[kDh1].mt, a.f,
                   [&](int n, float v) { a.db1[k * a.f + n] = v; });
          });
    clk.tick(a.stamps);
  }
  stage(a.units, [&](int t) { bwd_pixels(a, t, -1, 0, smem); },
        elem_units(a.n_dw1), [&](int u) { dw1_finish(u, 0); });
  clk.tick(a.stamps);
  stage(col_units(a.n_tail), [&](int u) { tail_finish(u, 0); });
  clk.tick(a.stamps);
}

// a cooperative grid of K6's size that only waits at n grid syncs (the
// cost of one sync, measured apart)
__global__ void __launch_bounds__(kThreads, kMinBlocks) sync_probe(int n) {
  for (int i = 0; i < n; ++i) cg::this_grid().sync();
}

// checks the plan (kind, splits, k_split for each product in kProds order,
// then tp) against the shapes and fills the products; false for a plan the
// kernel does not take
bool make_prods(const int* plan, Args& a) {
  const int ch = a.ch, f = a.f, taps = a.taps;
  const int P = static_cast<int>(a.P), Q = static_cast<int>(a.Q);
  const int shape[kProds][3] = {
      {P, f, taps * ch},     {P, f, f},         {P + 1, taps * ch, f},
      {f, taps * a.gc, Q},   {P, f, taps * a.gc}, {f, f, P},
      {P, f, f},             {taps * ch, f, P}, {P, taps * ch, f}};
  for (int i = 0; i < kProds; ++i) {
    const int kind = plan[3 * i], splits = plan[3 * i + 1], k_split = plan[3 * i + 2];
    const int M = shape[i][0], N = shape[i][1], K = shape[i][2];
    if (kind < 0 || kind > kWg128 || !((kAllowed[i] >> kind) & 1) || splits < 1 ||
        k_split < 1 || k_split % mma::kBK != 0 || (!kSplittable[i] && splits != 1) ||
        static_cast<long long>(splits - 1) * k_split >= K ||
        static_cast<long long>(splits) * k_split < K)
      return false;
    a.pr[i] = Prod{M, N, K, kind, splits, k_split, (M + kind_bm(kind) - 1) / kind_bm(kind),
                   (N + kind_bn(kind) - 1) / kind_bn(kind)};
  }
  a.tp = plan[3 * kProds];
  if (a.tp < 1 || a.tp * a.c > kPixFloats) return false;
  a.units = (P + a.tp - 1) / a.tp;
  return true;
}

// the scratch pieces (each 256-byte aligned) in the order of
// kernels.flow_stack_plan; with base null only the size
long long layout(Args& a, char* base, bool backward) {
  long long at = 0;
  auto take = [&](long long bytes) {
    char* here = base == nullptr ? nullptr : base + at;
    at += (bytes + 255) / 256 * 256;
    return here;
  };
  const long long P = a.P, f = a.f, ch = a.ch, taps = a.taps;
  const int dbl = backward ? 2 : 1;
  a.ya = reinterpret_cast<bf16*>(take(dbl * P * ch * 2));
  a.h1 = reinterpret_cast<bf16*>(take(dbl * P * f * 2));
  a.h2 = reinterpret_cast<bf16*>(take(P * f * 2));
  const Prod& z = a.pr[kZconv];
  a.r = reinterpret_cast<float*>(take(4LL * z.splits * z.M * z.N));
  if (!backward) {
    a.cur = reinterpret_cast<float*>(take(4 * P * a.c));
    return at;
  }
  const Prod& y = a.pr[kDya];
  a.dh2 = reinterpret_cast<bf16*>(take(P * f * 2));
  a.dh1 = reinterpret_cast<bf16*>(take(P * f * 2));
  a.gs = reinterpret_cast<bf16*>(take(P * a.gc * 2));
  a.r2 = reinterpret_cast<float*>(take(4LL * y.splits * y.M * y.N));
  a.pwz = reinterpret_cast<float*>(take(4LL * a.pr[kDwz].splits * f * taps * a.gc));
  a.cp2 = reinterpret_cast<float*>(take(4LL * a.pr[kDh2].mt * f));
  a.pw2 = reinterpret_cast<float*>(take(4LL * a.pr[kDw2].splits * f * f));
  a.cp1 = reinterpret_cast<float*>(take(4LL * a.pr[kDh1].mt * f));
  a.pw1 = reinterpret_cast<float*>(take(4LL * a.pr[kDw1].splits * taps * ch * f));
  a.pz = reinterpret_cast<float*>(take(4LL * a.units * 2 * ch));
  a.ptail = reinterpret_cast<float*>(take(4LL * a.units * (a.c * a.c + 2 * a.c)));
  return at;
}

}  // namespace tc

// ---------------------------------------------------------------------------
// host
// ---------------------------------------------------------------------------

Geo geo(int b, int h, int w, int c, int f, int kh, int kw, int ph, int pw) {
  return Geo{b, h, w, c / 2, f, c / 2, kh, kw, ph, pw};
}

bool valid_stack(const Geo& g, int flows) {
  const long long p = static_cast<long long>(g.b) * g.h * g.w;
  return valid(g) && g.cin == g.cout && flows > 0 && 2 * g.cin <= kThreads &&
         p * 2 * g.cin * flows < (1LL << 31);
}

// the kernel of a dtype and direction, its block size and dynamic shared
// memory
struct Kernel {
  const void* fn;
  int threads, smem;
};

Kernel kernel_of(bool bf16, bool backward) {
  if (bf16)
    return Kernel{backward ? reinterpret_cast<const void*>(&tc::flow_stack_bwd)
                           : reinterpret_cast<const void*>(&tc::flow_stack_fwd),
                  tc::kThreads, tc::kSmem};
  return Kernel{backward ? reinterpret_cast<const void*>(&f32::flow_stack_bwd<float>)
                         : reinterpret_cast<const void*>(&f32::flow_stack_fwd<float>),
                kThreads, 0};
}

// the blocks that can be resident at once (the occupancy query, at the
// kernel's block size and dynamic shared memory, times the SM count)
cudaError_t resident(const Kernel& k, int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && k.smem > 0)
    err = cudaFuncSetAttribute(k.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, k.smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k.fn, k.threads, k.smem);
  *blocks = per_sm * sms;
  return err;
}

// one cooperative launch on `grid` blocks (0: every resident block); a grid
// larger than the resident blocks is refused, never shrunk
cudaError_t launch(const Kernel& k, void* args, int grid, cudaStream_t st) {
  int blocks = 0;
  cudaError_t err = resident(k, &blocks);
  if (err != cudaSuccess) return err;
  if (blocks < 1 || grid > blocks) return cudaErrorCooperativeLaunchTooLarge;
  void* params[] = {args};
  err = cudaLaunchCooperativeKernel(k.fn, dim3(grid > 0 ? grid : blocks), dim3(k.threads), params,
                                    k.smem, st);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// the bf16 arguments of a shape and plan, with the scratch pieces laid out
// from `scratch` (null: only their size); false for a plan it does not take
bool tc_args(const Geo& g, int flows, const int* plan, bool backward, void* scratch,
             tc::Args* a, long long* bytes) {
  if (plan == nullptr || g.f % 8 != 0) return false;  // 16-byte runs along f
  tc::Args& t = *a;
  t = tc::Args{};
  t.g = mma::Geom(g);
  t.ch = g.cin;
  t.c = 2 * g.cin;
  t.gc = (g.cin + 7) / 8 * 8;
  t.gcd = mma::FastDiv(t.gc);
  t.taps = g.kh * g.kw;
  t.f = g.f;
  t.flows = flows;
  t.wa = g.cin % 8 == 0 ? 8 : (g.cin % 2 == 0 ? 2 : 1);
  t.P = static_cast<long long>(g.b) * g.h * g.w;
  t.Q = static_cast<long long>(g.b) * (g.h + 2 * g.ph) * (g.w + 2 * g.pw);
  t.s1 = flow_stride(static_cast<long long>(t.taps) * t.ch * t.f);
  t.s2 = flow_stride(static_cast<long long>(t.f) * t.f);
  t.sz = t.s1;
  t.n_tail = t.c * t.c + 2 * t.c;
  t.n_dwz = static_cast<long long>(t.f) * t.taps * t.ch;
  t.n_dwzp = static_cast<long long>(t.f) * t.taps * t.gc;
  t.n_dw2 = static_cast<long long>(t.f) * t.f;
  t.n_dw1 = static_cast<long long>(t.taps) * t.ch * t.f;
  if (!tc::make_prods(plan, t)) return false;
  if (backward) {  // the recompute's 64 x 64 choices run on wgmma
    for (int i : {tc::kConv1, tc::kConv2, tc::kZconv}) {
      tc::Prod& p = t.pr[i];
      if (p.kind != tc::kMma64) continue;
      p.kind = i == tc::kZconv ? tc::kWg64 : tc::kWg128;
      p.mt = (p.M + tc::kind_bm(p.kind) - 1) / tc::kind_bm(p.kind);
      p.nt = (p.N + tc::kind_bn(p.kind) - 1) / tc::kind_bn(p.kind);
    }
  }
  *bytes = tc::layout(t, static_cast<char*>(scratch), backward);
  return true;
}

}  // namespace

// Bytes of the scratch an entry point needs (forward: backward = 0), or -1
// for a shape (or, in bf16, a plan) it does not take. c = 2 ch flow
// channels, f the coupling width; plan: kernels.flow_stack_plan's ints
// (read in bf16 only).
extern "C" long long vgd_glow_flow_stack_scratch_bytes(int b, int h, int w, int c, int f, int kh,
                                                       int kw, int ph, int pw, int bf16,
                                                       int backward, const int* plan) {
  const Geo g = geo(b, h, w, c, f, kh, kw, ph, pw);
  if (c % 2 != 0 || !valid_stack(g, 1)) return -1;
  if (!bf16) return f32::layout(f32::shapes(g), 4, backward != 0).total;
  tc::Args a;
  long long bytes = 0;
  return tc_args(g, 1, plan, backward != 0, nullptr, &a, &bytes) ? bytes : -1;
}

// Blocks of the persistent grid (the occupancy query at the kernel's block
// size and shared memory, times the SM count) on the current device, or
// -(CUDA error).
extern "C" int vgd_glow_flow_stack_grid(int bf16, int backward) {
  int blocks = 0;
  const cudaError_t err = resident(kernel_of(bf16 != 0, backward != 0), &blocks);
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

// n grid syncs and nothing else on the bf16 backward's grid (its block
// size, shared memory and block count): the cost of one sync, measured apart
extern "C" int vgd_glow_flow_stack_sync_probe(int n, void* stream) {
  int blocks = 0;
  cudaError_t err = resident(kernel_of(true, true), &blocks);
  if (err != cudaSuccess) return err;
  const Kernel k{reinterpret_cast<const void*>(&tc::sync_probe), tc::kThreads, tc::kSmem};
  return launch(k, &n, blocks, static_cast<cudaStream_t>(stream));
}

// Forward of G flows. x (B, H, W, c) f32 -> y (same) f32; with save != 0
// also xsave (G, B, H, W, c) f32, each flow's input. an_b, an_s (G, c), wt
// (G, c, c) (wt[k][i][o]: y2 = y1 wt) f32; w1f (G, s(kh*kw*ch*f)) with rows
// (tap, ci), w2 (G, s(f*f)) and w2t (its transpose), wz (G, s(kh*kw*f*ch))
// with rows (tap, k) and wzf (G, s(kh*kw*ch*f), wzf[(tap, c), k] = Wz[tap,
// k, c]), in cd, s(n) = n rounded up to a multiple of 8 (the f32 path reads
// w2 and wz, the bf16 path w2t and wzf); b1, b2 (G, f), bz, scale (G, ch)
// f32; scratch of vgd_glow_flow_stack_scratch_bytes(..., 0, plan) bytes.
// bf16 != 0: cd is bf16, else f32. grid: the blocks to launch (0: every
// resident block; more is refused). stamps: null, or (bf16 only) room for
// one u64 a stage boundary (4 G + 2), which the kernel fills with the
// device clock in ns (the tracing of chip_smoke.py).
extern "C" int vgd_glow_flow_stack_fwd(const float* x, const float* anb, const float* ans,
                                       const float* wt, const void* w1f, const float* b1,
                                       const void* w2, const void* w2t, const float* b2,
                                       const void* wz, const void* wzf, const float* bz,
                                       const float* scale, float* y, float* xsave,
                                       void* scratch, const int* plan, void* stamps, int flows,
                                       int b, int h, int w, int c, int f, int kh, int kw, int ph,
                                       int pw, int bf16, int save, int grid, void* stream) {
  const Geo g = geo(b, h, w, c, f, kh, kw, ph, pw);
  if (c % 2 != 0 || !valid_stack(g, flows) || (save && xsave == nullptr))
    return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    tc::Args a;
    long long bytes = 0;
    if (!tc_args(g, flows, plan, false, scratch, &a, &bytes)) return cudaErrorInvalidValue;
    a.save = save != 0;
    a.stamps = static_cast<unsigned long long*>(stamps);
    a.x = x;
    a.y = y;
    a.xsave = xsave;
    a.anb = anb;
    a.ans = ans;
    a.wt = wt;
    a.w1f = static_cast<const mma::bf16*>(w1f);
    a.w2t = static_cast<const mma::bf16*>(w2t);
    a.wzf = static_cast<const mma::bf16*>(wzf);
    a.b1 = b1;
    a.b2 = b2;
    a.bz = bz;
    a.scale = scale;
    return launch(kernel_of(true, false), &a, grid, st);
  }
  f32::Args a = f32::make_args(g, flows, false, scratch);
  a.save = save != 0;
  a.x = x;
  a.y = y;
  a.xsave = xsave;
  a.anb = anb;
  a.ans = ans;
  a.wt = wt;
  a.w1f = w1f;
  a.w2 = w2;
  a.wz = wz;
  a.b1 = b1;
  a.b2 = b2;
  a.bz = bz;
  a.scale = scale;
  return launch(kernel_of(false, false), &a, grid, st);
}

// Backward of G flows. xsave from the forward, the weights as the forward
// plus w1t (G, s(kh*kw*f*ch)) (w1t[(tap, k), ci] = W1[tap, ci, k]),
// grad (B, H, W, c) f32. Outputs f32: dx (B, H, W, c), danb, dans (G, c),
// dwt (G, c, c), dw1 (G, kh*kw*ch, f), db1 (G, f), dw2 (G, f, f), db2 (G,
// f), dwz (G, f, kh*kw*ch), dbz, dscale (G, ch). Scratch of
// vgd_glow_flow_stack_scratch_bytes(..., 1, plan) bytes; grid as the
// forward; stamps as the forward's, 4 G + 7 of them.
extern "C" int vgd_glow_flow_stack_bwd(
    const float* xsave, const float* anb, const float* ans, const float* wt, const void* w1f,
    const void* w1t, const float* b1, const void* w2, const void* w2t, const float* b2,
    const void* wz, const void* wzf, const float* bz, const float* scale, const float* grad,
    float* dx, float* danb, float* dans, float* dwt, float* dw1, float* db1, float* dw2,
    float* db2, float* dwz, float* dbz, float* dscale, void* scratch, const int* plan,
    void* stamps, int flows, int b, int h, int w, int c, int f, int kh, int kw, int ph, int pw,
    int bf16, int grid, void* stream) {
  const Geo g = geo(b, h, w, c, f, kh, kw, ph, pw);
  if (c % 2 != 0 || !valid_stack(g, flows)) return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    tc::Args a;
    long long bytes = 0;
    if (!tc_args(g, flows, plan, true, scratch, &a, &bytes)) return cudaErrorInvalidValue;
    a.stamps = static_cast<unsigned long long*>(stamps);
    a.x = xsave;
    a.grad = grad;
    a.y = dx;
    a.anb = anb;
    a.ans = ans;
    a.wt = wt;
    a.w1f = static_cast<const mma::bf16*>(w1f);
    a.w2 = static_cast<const mma::bf16*>(w2);
    a.w2t = static_cast<const mma::bf16*>(w2t);
    a.wzf = static_cast<const mma::bf16*>(wzf);
    a.b1 = b1;
    a.b2 = b2;
    a.bz = bz;
    a.scale = scale;
    a.danb = danb;
    a.dans = dans;
    a.dwt = dwt;
    a.dw1 = dw1;
    a.db1 = db1;
    a.dw2 = dw2;
    a.db2 = db2;
    a.dwz = dwz;
    a.dbz = dbz;
    a.dscale = dscale;
    return launch(kernel_of(true, true), &a, grid, st);
  }
  f32::Args a = f32::make_args(g, flows, true, scratch);
  a.x = xsave;
  a.grad = grad;
  a.y = dx;
  a.anb = anb;
  a.ans = ans;
  a.wt = wt;
  a.w1f = w1f;
  a.w1t = w1t;
  a.w2 = w2;
  a.w2t = w2t;
  a.wz = wz;
  a.wzf = wzf;
  a.b1 = b1;
  a.b2 = b2;
  a.bz = bz;
  a.scale = scale;
  a.danb = danb;
  a.dans = dans;
  a.dwt = dwt;
  a.dw1 = dw1;
  a.db1 = db1;
  a.dw2 = dw2;
  a.db2 = db2;
  a.dwz = dwz;
  a.dbz = dbz;
  a.dscale = dscale;
  return launch(kernel_of(false, true), &a, grid, st);
}

extern "C" const char* vgd_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
