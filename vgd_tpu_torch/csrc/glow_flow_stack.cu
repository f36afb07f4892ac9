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
// and 1.45 ms at the bf16 tensor-core rate of 989 TFLOP/s, while the
// c-wide activations (c = 12..96) and the per-flow weights move a few
// hundred MB; so the work is bound by operations. The TPU kernel keeps the
// activation, the weights and the 512-wide internals of a batch tile in
// VMEM for the whole chain. Here one image's h1 at block 0 is 1 MB in bf16,
// so the internals go through device memory (the 50 MB L2 holds blocks 1-3
// whole), and what the TPU design buys carries over as one launch per chunk
// and direction:
//
// * the grid is as many blocks as can be resident at once (the occupancy
//   query times the SM count) and it loops over the chunk's flows; each
//   stage of a flow is a loop of the blocks over its units (the output tiles
//   of K5's implicit GEMMs, gemm_tile in glow_gemm.cuh, or groups of
//   elements), and cooperative_groups' grid sync separates dependent stages:
//   5 per flow forward, 10 per flow backward;
// * the ActNorm and the c x c product are per-pixel stages on the CUDA
//   cores (c <= 128), and so is the backward's tail (dx, and per-pixel-tile
//   partials of dwt, d an_s, d an_b);
// * every weight is read straight from the packed (G, ...) operands, one
//   flow's slice starting 16-byte aligned; nothing is launched per flow;
// * the scratch (h1, h2, dh2, dh1, the split partials) is one set for the
//   block, reused flow after flow; the wrapper allocates it, the kernel
//   allocates nothing.
//
// Deterministic: no atomics; split partials, per-tile column sums and the
// per-pixel-tile partials are added in a fixed order by a later stage, and
// each flow's weight gradients are written once; the result does not depend
// on which block computed which unit, so two runs are bit-equal.
//
// Not yet done (later work): wgmma, TMA, keeping h1/h2 on chip, fewer grid
// syncs (merging independent stages across flows).
//
// Plain C interface for ctypes. Every entry point launches on the given
// stream, does not synchronise and allocates nothing; it returns the CUDA
// error of its launch (cudaErrorInvalidValue for a shape it does not take).

#include <cooperative_groups.h>

#include "glow_gemm.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kUnit = 1024;          // elements of one elementwise unit
constexpr int kStackFloats = kBM * kCS;   // floats of Smem::cs, the per-pixel scratch
constexpr int kMaxTilePixels = 64;   // pixels of one backward tail unit

__host__ __device__ inline int units(long long n) {
  return static_cast<int>((n + kUnit - 1) / kUnit);
}

// per-flow stride, in elements, of a packed (G, ...) weight: a multiple of 8
// so that every flow's slice starts 16-byte aligned (matches the wrapper)
__host__ __device__ inline long long flow_stride(long long n) { return (n + 7) / 8 * 8; }

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

bool valid_stack(const Geo& g, int flows) {
  const long long p = static_cast<long long>(g.b) * g.h * g.w;
  return valid(g) && g.cin == g.cout && flows > 0 && 2 * g.cin <= kThreads &&
         p * 2 * g.cin * flows < (1LL << 31);
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

template <typename T>
cudaError_t launch(const Args& a, bool backward, cudaStream_t st) {
  const void* kern = backward ? reinterpret_cast<const void*>(&flow_stack_bwd<T>)
                              : reinterpret_cast<const void*>(&flow_stack_fwd<T>);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads, 0);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  void* params[] = {const_cast<Args*>(&a)};
  err = cudaLaunchCooperativeKernel(kern, dim3(per_sm * sms), dim3(kThreads), params, 0, st);
  return err != cudaSuccess ? err : cudaGetLastError();
}

Geo geo(int b, int h, int w, int c, int f, int kh, int kw, int ph, int pw) {
  return Geo{b, h, w, c / 2, f, c / 2, kh, kw, ph, pw};
}

Args make_args(const Geo& g, int flows, int bf16, bool backward, void* scratch) {
  Args a{};
  a.s = shapes(g);
  a.flows = flows;
  const int v = bf16 ? 8 : 4;
  a.va = g.cin % v == 0;
  a.vf = g.f % v == 0;
  a.scratch = static_cast<char*>(scratch);
  a.l = layout(a.s, bf16 ? 2 : 4, backward);
  return a;
}

}  // namespace

// Bytes of the scratch an entry point needs (forward: backward = 0), or -1
// for a shape it does not take. c = 2 ch flow channels, f the coupling width.
extern "C" long long vgd_glow_flow_stack_scratch_bytes(int b, int h, int w, int c, int f, int kh,
                                                       int kw, int ph, int pw, int bf16,
                                                       int backward) {
  const Geo g = geo(b, h, w, c, f, kh, kw, ph, pw);
  if (c % 2 != 0 || !valid_stack(g, 1)) return -1;
  return layout(shapes(g), bf16 ? 2 : 4, backward != 0).total;
}

// Blocks of the persistent grid (the occupancy query times the SM count) on
// the current device, or -(CUDA error).
extern "C" int vgd_glow_flow_stack_grid(int bf16, int backward) {
  const void* kern =
      backward ? (bf16 ? reinterpret_cast<const void*>(&flow_stack_bwd<__nv_bfloat16>)
                       : reinterpret_cast<const void*>(&flow_stack_bwd<float>))
               : (bf16 ? reinterpret_cast<const void*>(&flow_stack_fwd<__nv_bfloat16>)
                       : reinterpret_cast<const void*>(&flow_stack_fwd<float>));
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads, 0);
  return err == cudaSuccess ? per_sm * sms : -static_cast<int>(err);
}

// Forward of G flows. x (B, H, W, c) f32 -> y (same) f32; with save != 0
// also xsave (G, B, H, W, c) f32, each flow's input. an_b, an_s (G, c), wt
// (G, c, c) (wt[k][i][o]: y2 = y1 wt) f32; w1f (G, s(kh*kw*ch*f)) with rows
// (tap, ci), w2 (G, s(f*f)), wz (G, s(kh*kw*f*ch)) with rows (tap, k), in
// cd, s(n) = n rounded up to a multiple of 8; b1, b2 (G, f), bz, scale (G,
// ch) f32; scratch of vgd_glow_flow_stack_scratch_bytes(..., 0) bytes.
// bf16 != 0: cd is bf16, else f32.
extern "C" int vgd_glow_flow_stack_fwd(const float* x, const float* anb, const float* ans,
                                       const float* wt, const void* w1f, const float* b1,
                                       const void* w2, const float* b2, const void* wz,
                                       const float* bz, const float* scale, float* y, float* xsave,
                                       void* scratch, int flows, int b, int h, int w, int c,
                                       int f, int kh, int kw, int ph, int pw, int bf16, int save,
                                       void* stream) {
  const Geo g = geo(b, h, w, c, f, kh, kw, ph, pw);
  if (c % 2 != 0 || !valid_stack(g, flows) || (save && xsave == nullptr))
    return cudaErrorInvalidValue;
  Args a = make_args(g, flows, bf16, false, scratch);
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
  auto st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(a, false, st) : launch<float>(a, false, st);
}

// Backward of G flows. xsave from the forward, the weights as the forward
// plus w1t (G, s(kh*kw*f*ch)) (w1t[(tap, k), ci] = W1[tap, ci, k]), w2t (G,
// s(f*f)) = W2^T, wzf (G, s(kh*kw*ch*f)) (wzf[(tap, c), k] = Wz[tap, k, c]),
// grad (B, H, W, c) f32. Outputs f32: dx (B, H, W, c), danb, dans (G, c),
// dwt (G, c, c), dw1 (G, kh*kw*ch, f), db1 (G, f), dw2 (G, f, f), db2 (G,
// f), dwz (G, f, kh*kw*ch), dbz, dscale (G, ch). Scratch of
// vgd_glow_flow_stack_scratch_bytes(..., 1) bytes.
extern "C" int vgd_glow_flow_stack_bwd(
    const float* xsave, const float* anb, const float* ans, const float* wt, const void* w1f,
    const void* w1t, const float* b1, const void* w2, const void* w2t, const float* b2,
    const void* wz, const void* wzf, const float* bz, const float* scale, const float* grad,
    float* dx, float* danb, float* dans, float* dwt, float* dw1, float* db1, float* dw2,
    float* db2, float* dwz, float* dbz, float* dscale, void* scratch, int flows, int b, int h,
    int w, int c, int f, int kh, int kw, int ph, int pw, int bf16, void* stream) {
  const Geo g = geo(b, h, w, c, f, kh, kw, ph, pw);
  if (c % 2 != 0 || !valid_stack(g, flows)) return cudaErrorInvalidValue;
  Args a = make_args(g, flows, bf16, true, scratch);
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
  auto st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(a, true, st) : launch<float>(a, true, st);
}

extern "C" const char* vgd_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
