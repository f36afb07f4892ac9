// K4: GroupNorm + SiLU over NHWC images, with the casts and the residual
// add around it, for sm_90a.
//
// Replaces the TPU kernel vgd_tpu/ops/pallas_kernels.py : groupnorm_silu
// (body _gn_silu_kernel), which holds one image in VMEM, takes its group
// statistics in two passes (mean, then the centred sum of squares) and
// writes silu(x_hat * scale + bias). The port's callers wrap it in the
// casts and the residual add of vgd_tpu/models/unet.py ConvBlock, which
// this kernel takes in:
//
//   y = silu(gn(float(x)) * scale + bias)            (f32, statistics in f32)
//   out = cast<TOut>(y)  or  cast<TOut>(y + float(residual))
//
// and, for gn1 (no residual), the block's time projection added before the
// normalisation: with a shift s (B, C) f32, x is replaced by
//
//   x' = cast<TIn>(float(x) + float(cast<TIn>(s[image, channel])))
//
// which is `h + tp.to(h.dtype)` in PyTorch, bit for bit, so the stock
// broadcast add's read and write of the whole conv output are gone.
//
// In the fused ConvBlock's forms x is a convolution's output without its
// bias, and the bias b (C,) f32 is added first, as cuDNN's convolution is
// followed by PyTorch's `add_` of `b.to(x.dtype)`; the 1x1 residual conv's
// bias rb is added to the residual r, read in r's type, the same way:
//
//   x'  = cast<TIn>(float(x) + float(cast<TIn>(b[channel])))   then the shift
//   r'  = cast<TRes>(float(r) + float(cast<TRes>(rb[channel])))
//
// each rounded as the stock adds round, so the output is theirs bit for bit.
//
// What bounds it on the H100: a few operations an element against 2-12
// bytes, so bytes. The least it can move is one read of x (and of the
// residual) and one write of out; this kernel moves exactly that.
//
// Design. One image is spread over the shared memory of `cpi` CTAs, each
// holding a contiguous run of whole pixels (so every group of its pixels),
// `ipw` images at once (a wave); the grid of ipw * cpi CTAs, one or two an
// SM (at most 128 registers a thread, so two fit), is launched
// cooperatively so that every CTA is resident (a grid above the resident
// blocks is refused, never shrunk). Per wave each CTA
//   1. has its run brought into shared memory by bulk copies (cp.async.bulk
//      completing on an mbarrier);
//   2. takes each group's mean and centred sum of squares M2 of its run in
//      two passes over shared memory (never E[x^2] - E[x]^2), the lanes'
//      sums reduced through shared memory in a fixed order;
//   3. writes them to a global partials buffer (by wave parity, so a slow
//      CTA still reading one wave's partials is never overwritten);
//   4. arrives on its image's barrier word (image_barrier: a 128-byte line
//      of its own, no reset launch, ready for CUDA-graph replays, one wait
//      a wave);
//   5. merges the image's partials (group-major, so a warp's loads are
//      contiguous) in one fixed order (Chan et al.), the same in every CTA
//      of the image, so the statistics agree everywhere and the kernel is
//      bit-deterministic;
//   6. normalises from shared memory, applies scale, bias and SiLU, adds
//      the residual (16-byte loads, issued a few rows ahead) and stores the
//      output dtype (16-byte stores), chunk by chunk; with `refill`, each
//      chunk, once every thread is done with it, is refilled with the next
//      wave's run, so that load overlaps this wave's apply pass and the
//      buffer is single (more images a wave, so fewer waves).
// An image larger than the grid's shared memory runs "streamed": each run
// is cut into tiles that pass through the buffer, their statistics combined
// in order (Chan), and the apply pass reloads every tile but the last one
// still in shared memory (from L2 when the image fits there). The plan
// (vgd_tpu_torch/ops/kernels.py : groupnorm_silu_plan) chooses all of this;
// the entry point checks it.
//
// Every thread owns 8 channels (C % 8 == 0) of every (threads / (C / 8))-th
// pixel of the run, so its channels, groups, scale and bias stay fixed (and
// its 8 conv biases, and its 8 shifts for a wave's image, held in registers
// and added to each value it reads from shared memory, in both statistics
// passes and the apply pass, and its 8 residual biases added to each
// residual value it loads: no extra pass and no extra global write; see
// Reader): for a 2-byte input 8 consecutive ones (one 16-byte access), for f32 the
// channels 4v..4v+3 and C/2 + 4v..+3 (thread v of a row), so that each
// 16-byte access of a warp is contiguous: no bank conflicts in shared
// memory and whole sectors in global memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kVec = 8;             // channels a thread owns
constexpr int kMaxThreads = 256;
constexpr int kMaxGroups = 32;
constexpr int kMaxChannels = 2048;  // C / 8 <= kMaxThreads
constexpr unsigned kChunk = 32768;  // bytes per bulk copy
constexpr int kBatch = 4;           // rows a thread applies a step
constexpr int kMergeLoads = 16;     // runs a lane merges: cpi <= 512
constexpr int kSyncStride = 32;     // words between two images' barrier words (128 B)
// shared memory after the buffer: the cross-thread reduction (8 floats a
// thread), per-group statistics, the mbarrier
constexpr int kAuxBytes = kMaxThreads * kVec * 4 + 4 * kMaxGroups * 4 + 16;

struct Args {
  const void* x;
  const void* res;
  void* y;
  const float* scale;
  const float* bias;
  float* part;      // [2][ipw][groups][cpi] (mean, M2) pairs, by wave parity
  unsigned* sync;   // image i's barrier word at kSyncStride * i
  long long hw;     // pixels per image
  int b, c, groups, cg;
  float eps;
  int cpi, ipw, run_pix, tile_pix, refill;
  int buf_bytes;    // the buffer, a multiple of 128
  unsigned long long* stamps;  // null, or kStamps device times a wave
  const float* shift;  // (b, c): added to x before the statistics (SHIFT)
};
// Args is kept at 128 bytes: the two conv biases are kernel parameters of
// their own, since with them in Args (144 bytes) ptxas spilled in every
// form, those without the biases too, and gn1 ran 6 % slower on an H100

// The tracing of a call: with a.stamps set, block 0's thread 0 writes the
// device clock (ns) at each wave's start, once its run is in shared memory,
// after the statistics, after the barrier, after the merge and after the
// apply pass, so stamps[6 w + i + 1] - stamps[6 w + i] is phase i of wave w.
constexpr int kStamps = 6;
__device__ __forceinline__ void stamp(unsigned long long* stamps, int i) {
  if (stamps != nullptr && blockIdx.x == 0 && threadIdx.x == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    stamps[i] = t;
  }
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
// waits for the phase of `parity` to complete; traps after 2^28 polls
// instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0, polls = 0;
  do {
    if (++polls == (1u << 28)) __trap();
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}
__device__ __forceinline__ void bulk_g2s(void* dst, const void* src, unsigned bytes,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void red_add_release(unsigned* p, unsigned v) {
  asm volatile("red.release.gpu.global.add.u32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}
__device__ __forceinline__ unsigned atom_add_acq_rel(unsigned* p, unsigned v) {
  unsigned old;
  asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], %2;\n"
               : "=r"(old)
               : "l"(p), "r"(v)
               : "memory");
  return old;
}

// the barrier of one image's n CTAs on one word: arrivals in the low 16
// bits, the generation above. The arrival (acq_rel) releases this CTA's
// partials (its threads wrote them before the block barrier); the last
// arrival adds 2^16 - n, which resets the count and bumps the generation
// in one release, and the others spin on the generation with ld.acquire.
// No reset launch is needed and a CUDA-graph replay finds the word ready.
// A wait that never ends (every CTA is resident, so a wait takes
// microseconds) traps after 2^24 polls instead of hanging the card.
__device__ void image_barrier(unsigned* word, unsigned n) {
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned old = atom_add_acq_rel(word, 1u);
    if ((old & 0xffffu) == n - 1) {
      red_add_release(word, 0x10000u - n);
    } else {
      unsigned polls = 0;
      while (((ld_acquire(word) ^ old) >> 16) == 0)
        if (++polls == (1u << 24)) __trap();
    }
  }
  __syncthreads();
}

// 8 consecutive bf16 elements (one 16-byte access) to and from f32
struct Vec8 {
  static __device__ __forceinline__ void unpack(const uint4 a, float v[8]) {
    const unsigned w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // element 2i in the low half
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float v[8]) {
    unpack(*reinterpret_cast<const uint4*>(p), v);
  }
  static __device__ __forceinline__ void load_global(const __nv_bfloat16* p, float v[8]) {
    unpack(__ldg(reinterpret_cast<const uint4*>(p)), v);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float v[8]) {
    unsigned w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
      w[i] = *reinterpret_cast<const unsigned*>(&h);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
};

// 4 consecutive elements to and from f32
template <typename T>
struct Quad;
template <>
struct Quad<float> {
  static __device__ __forceinline__ void load(const float* p, float v[4]) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  }
  static __device__ __forceinline__ void load_global(const float* p, float v[4]) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  }
  static __device__ __forceinline__ void store(float* p, const float v[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};
template <>
struct Quad<__nv_bfloat16> {
  static __device__ __forceinline__ void unpack(const uint2 a, float v[4]) {
    v[0] = __uint_as_float(a.x << 16), v[1] = __uint_as_float(a.x & 0xffff0000u);
    v[2] = __uint_as_float(a.y << 16), v[3] = __uint_as_float(a.y & 0xffff0000u);
  }
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float v[4]) {
    unpack(*reinterpret_cast<const uint2*>(p), v);
  }
  static __device__ __forceinline__ void load_global(const __nv_bfloat16* p, float v[4]) {
    unpack(__ldg(reinterpret_cast<const uint2*>(p)), v);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float v[4]) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
    *reinterpret_cast<uint2*>(p) =
        make_uint2(*reinterpret_cast<const unsigned*>(&lo), *reinterpret_cast<const unsigned*>(&hi));
  }
};

// channel l of thread v's 8 in a row of c (SPLIT: 4v + l and c/2 + 4v + l - 4)
template <bool SPLIT>
__device__ __forceinline__ int channel(int v, int c, int l) {
  return SPLIT ? (l < 4 ? 4 * v + l : (c >> 1) + 4 * v + l - 4) : kVec * v + l;
}
// thread v's 8 channels of the pixel row at `row`: one 16-byte access for
// 8 consecutive bf16, else two of 4 elements (from channels l = 0 and 4)
template <typename T, bool SPLIT>
struct Row {
  static constexpr bool kOne = !SPLIT && sizeof(T) == 2;
  static __device__ __forceinline__ void load(const T* row, int v, int c, float x[8]) {
    if constexpr (kOne) {
      Vec8::load(row + kVec * v, x);
    } else {
      Quad<T>::load(row + channel<SPLIT>(v, c, 0), x);
      Quad<T>::load(row + channel<SPLIT>(v, c, 4), x + 4);
    }
  }
  static __device__ __forceinline__ void load_global(const T* row, int v, int c, float x[8]) {
    if constexpr (kOne) {
      Vec8::load_global(row + kVec * v, x);
    } else {
      Quad<T>::load_global(row + channel<SPLIT>(v, c, 0), x);
      Quad<T>::load_global(row + channel<SPLIT>(v, c, 4), x + 4);
    }
  }
  static __device__ __forceinline__ void store(T* row, int v, int c, const float x[8]) {
    if constexpr (kOne) {
      Vec8::store(row + kVec * v, x);
    } else {
      Quad<T>::store(row + channel<SPLIT>(v, c, 0), x);
      Quad<T>::store(row + channel<SPLIT>(v, c, 4), x + 4);
    }
  }
};

// A thread's 8 values of a row, read as Row reads them, with N addends added
// in turn: each a thread's 8 values of a vector over the channels (a conv
// bias, or an image's shift) cast to T, and each sum rounded to T,
// x' = cast<T>(cast<T>(x + a0) + a1), as `x + a0.to(x.dtype)` and then
// `+ a1.to(x.dtype)` add in PyTorch. f32: 8 floats added after the load.
// A global row is fetched ahead of its use as Raw (for bf16 the packed
// 16 bytes, half the registers of its floats) and unpacked at its use.
template <typename T, bool SPLIT, int N>
struct Reader {
  static_assert(N == 0 || sizeof(T) == 4, "a bf16 addend is added packed (below)");
  float s[N > 0 ? N : 1][kVec];
  __device__ __forceinline__ void set(int i, const float* vec, int v, int c) {
#pragma unroll
    for (int l = 0; l < kVec; ++l) s[i][l] = vec[channel<SPLIT>(v, c, l)];
  }
  __device__ __forceinline__ void add(float x[kVec]) const {
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int l = 0; l < kVec; ++l) x[l] += s[i][l];
  }
  __device__ __forceinline__ void load(const T* row, int v, int c, float x[kVec]) const {
    Row<T, SPLIT>::load(row, v, c, x);
    add(x);
  }
  struct Raw {
    float v[kVec];
  };
  __device__ __forceinline__ Raw fetch(const T* row, int v, int c) const {
    Raw r;
    Row<T, SPLIT>::load_global(row, v, c, r.v);
    return r;
  }
  __device__ __forceinline__ void unpack(const Raw& r, float x[kVec]) const {
#pragma unroll
    for (int l = 0; l < kVec; ++l) x[l] = r.v[l];
    add(x);
  }
};
// bf16: each addend 4 words of 2 (channel 2i in the low half, as a 16-byte
// access holds them) added to the packed row before it is unpacked, by
// add.rn.bf16x2, the correctly rounded sum: what rounding the f32 sum gives
// (f32 has more than twice bf16's bits, so the double rounding is innocuous)
template <int N>
struct Reader<__nv_bfloat16, false, N> {
  unsigned s[N > 0 ? N : 1][kVec / 2];
  __device__ __forceinline__ void set(int i, const float* vec, int v, int) {
#pragma unroll
    for (int k = 0; k < kVec / 2; ++k) {
      const __nv_bfloat162 h =
          __floats2bfloat162_rn(vec[kVec * v + 2 * k], vec[kVec * v + 2 * k + 1]);
      s[i][k] = *reinterpret_cast<const unsigned*>(&h);
    }
  }
  static __device__ __forceinline__ unsigned add2(unsigned a, unsigned b) {
    unsigned d;
    asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
    return d;
  }
  __device__ __forceinline__ uint4 add(uint4 a) const {
#pragma unroll
    for (int i = 0; i < N; ++i)
      a = make_uint4(add2(a.x, s[i][0]), add2(a.y, s[i][1]), add2(a.z, s[i][2]),
                     add2(a.w, s[i][3]));
    return a;
  }
  __device__ __forceinline__ void load(const __nv_bfloat16* row, int v, int, float x[kVec]) const {
    Vec8::unpack(add(*reinterpret_cast<const uint4*>(row + kVec * v)), x);
  }
  using Raw = uint4;
  __device__ __forceinline__ Raw fetch(const __nv_bfloat16* row, int v, int) const {
    return __ldg(reinterpret_cast<const uint4*>(row + kVec * v));
  }
  __device__ __forceinline__ void unpack(const Raw r, float x[kVec]) const {
    Vec8::unpack(add(r), x);
  }
};

// RES: 0 no residual, 1 f32, 2 bf16
template <int RES>
struct ResT {
  using T = float;
};
template <>
struct ResT<2> {
  using T = __nv_bfloat16;
};

// SHIFT: add a.shift's row of the image to x (gn1; never with RES). BIAS:
// add conv_bias (c,) to x first. RBIAS: add res_bias (c,) to the residual.
template <typename TIn, int RES, typename TOut, bool SHIFT, bool BIAS, bool RBIAS>
__global__ void __launch_bounds__(kMaxThreads, 2)
    groupnorm_silu_kernel(const Args a, const float* conv_bias, const float* res_bias) {
  static_assert(!(SHIFT && RES != 0), "the shift is gn1's, which has no residual");
  static_assert(!RBIAS || RES != 0, "a residual bias needs a residual");
  extern __shared__ __align__(128) unsigned char smem[];
  const int T = blockDim.x, tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int warps = T >> 5;  // whole warps (T may end in a partial one)
  const int u = a.c / kVec, rows = T / u, row0 = tid / u, cv = tid % u;
  const int G = a.groups;
  constexpr bool kSplit = sizeof(TIn) == 4;  // see the header
  using Res = typename ResT<RES>::T;
  // x as read from shared memory: the conv bias, then the image's shift
  Reader<TIn, kSplit, BIAS + SHIFT> in;
  if constexpr (BIAS) in.set(0, conv_bias, cv, a.c);
  const TIn* xs = reinterpret_cast<const TIn*>(smem);
  float* red = reinterpret_cast<float*>(smem + a.buf_bytes);
  float* gsum = red + kMaxThreads * kVec;  // per group: a tile's sums
  float* gmean = gsum + kMaxGroups;        // the image's mean and 1 / std
  float* grstd = gmean + kMaxGroups;
  uint64_t* bar = reinterpret_cast<uint64_t*>(gsum + 4 * kMaxGroups);

  const int slot = blockIdx.x / a.cpi, j = blockIdx.x % a.cpi;
  const long long p0 = static_cast<long long>(j) * a.run_pix;
  const int np = static_cast<int>(min(static_cast<long long>(a.run_pix), a.hw - p0));
  const int ntiles = (np + a.tile_pix - 1) / a.tile_pix;
  // pixels of a refill chunk: about kChunk bytes
  const int chunk_pix = max(1, static_cast<int>(kChunk / (a.c * sizeof(TIn))));
  float sc[kVec], bi[kVec];
  int grp[kVec];
#pragma unroll
  for (int l = 0; l < kVec; ++l) {
    const int ch = channel<kSplit>(cv, a.c, l);
    sc[l] = a.scale[ch];
    bi[l] = a.bias[ch];
    grp[l] = ch / a.cg;
  }
  if (tid == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  unsigned phase = 0;

  // thread 0: pixels [q0, q1) of tile t of image img into the buffer; the
  // first piece of a load sets the barrier's byte count for the whole tile
  auto issue = [&](long long img, int t, int q0, int q1, bool first) {
    if (tid != 0) return;
    const int n = min(a.tile_pix, np - t * a.tile_pix);
    const unsigned char* src = static_cast<const unsigned char*>(a.x) +
        ((img * a.hw + p0 + static_cast<long long>(t) * a.tile_pix) * a.c) * sizeof(TIn);
    const unsigned pix = a.c * sizeof(TIn);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    if (first) mbar_expect_tx(bar, static_cast<unsigned>(n) * pix);
    for (unsigned off = q0 * pix, end = q1 * pix; off < end; off += kChunk)
      bulk_g2s(smem + off, src + off, min(kChunk, end - off), bar);
  };
  auto wait = [&]() {
    mbar_wait(bar, phase);
    phase ^= 1u;
  };
  // per-group sums of s (8 lanes a thread) into gsum, in a fixed order:
  // red holds a [rows][C] matrix; whole warp w sums groups w, w + warps, ...
  // (lane l the elements l, l + 32, ... of the group's columns), then the
  // lanes reduce in a fixed butterfly
  auto group_sums = [&](const float s[kVec]) {
    Row<float, kSplit>::store(red + row0 * a.c, cv, a.c, s);
    __syncthreads();
    const int per = rows * a.cg;
    for (int g = warp; warp < warps && g < G; g += warps) {
      float acc = 0.f;
      for (int e = lane; e < per; e += 32) {
        const int r = e / a.cg;
        acc += red[r * a.c + g * a.cg + (e - r * a.cg)];
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
      if (lane == 0) gsum[g] = acc;
    }
    __syncthreads();
  };

  bool preloaded = false;  // this wave's run is (being) loaded already
  for (int wave = 0;; ++wave) {
    const long long img = slot + static_cast<long long>(wave) * a.ipw;
    if (img >= a.b) break;
    const bool refill = a.refill && img + a.ipw < a.b;
    unsigned long long* st = a.stamps == nullptr ? nullptr : a.stamps + kStamps * wave;
    stamp(st, 0);
    if constexpr (SHIFT) in.set(BIAS, a.shift + img * a.c, cv, a.c);
    // this thread (g < G) carries group g's running (count, mean, M2)
    float rn = 0.f, rmean = 0.f, rm2 = 0.f;
    for (int t = 0; t < ntiles; ++t) {
      if (!(t == 0 && preloaded)) issue(img, t, 0, min(a.tile_pix, np - t * a.tile_pix), true);
      wait();
      if (t == 0) stamp(st, 1);
      const int n = min(a.tile_pix, np - t * a.tile_pix);
      const float cnt = static_cast<float>(n) * a.cg;
      float s[kVec] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
      for (int r = row0; r < n; r += rows) {
        float v[kVec];
        in.load(xs + static_cast<long long>(r) * a.c, cv, a.c, v);
#pragma unroll
        for (int l = 0; l < kVec; ++l) s[l] += v[l];
      }
      group_sums(s);
      float m[kVec];
#pragma unroll
      for (int l = 0; l < kVec; ++l) {
        m[l] = gsum[grp[l]] / cnt;
        s[l] = 0.f;
      }
      const float tmean = tid < G ? gsum[tid] / cnt : 0.f;
#pragma unroll 4
      for (int r = row0; r < n; r += rows) {
        float v[kVec];
        in.load(xs + static_cast<long long>(r) * a.c, cv, a.c, v);
#pragma unroll
        for (int l = 0; l < kVec; ++l) {
          const float d = v[l] - m[l];
          s[l] += d * d;
        }
      }
      group_sums(s);  // its first block barrier: every thread has read gsum
      if (tid < G) {  // Chan's combine of the tiles so far and this one
        const float tm2 = gsum[tid];
        if (t == 0) {
          rn = cnt, rmean = tmean, rm2 = tm2;
        } else {
          const float nn = rn + cnt, d = tmean - rmean;
          rmean += d * (cnt / nn);
          rm2 += tm2 + d * d * (rn * cnt / nn);
          rn = nn;
        }
      }
      if (t + 1 < ntiles) __syncthreads();  // the buffer is refilled next
    }
    stamp(st, 2);
    // publish this run's statistics, wait for the image's other runs
    float* part = a.part + (static_cast<long long>(wave & 1) * a.ipw + slot) * a.cpi * G * 2;
    if (tid < G) {
      __stcg(reinterpret_cast<float2*>(part) + static_cast<long long>(tid) * a.cpi + j,
             make_float2(rmean, rm2));
    }
    image_barrier(a.sync + kSyncStride * slot, a.cpi);
    stamp(st, 3);
    // merge the image's runs: whole warp w takes groups w, w + warps, ...;
    // lane l loads runs l, l + 32, ... (all at once) and sums them in that
    // order, then the lanes reduce in a fixed butterfly
    {
      const float last = static_cast<float>(a.hw - static_cast<long long>(a.cpi - 1) * a.run_pix);
      const float ntot = static_cast<float>(a.hw) * a.cg;
      for (int g = warp; warp < warps && g < G; g += warps) {
        float2 pj[kMergeLoads];
        float nj[kMergeLoads];
#pragma unroll
        for (int i = 0; i < kMergeLoads; ++i) {
          const int jj = lane + 32 * i;
          nj[i] = jj < a.cpi ? (jj + 1 < a.cpi ? static_cast<float>(a.run_pix) : last) * a.cg
                             : 0.f;
          pj[i] = jj < a.cpi ? __ldcg(reinterpret_cast<const float2*>(part) +
                                      static_cast<long long>(g) * a.cpi + jj)
                             : make_float2(0.f, 0.f);
        }
        float acc = 0.f;
#pragma unroll
        for (int i = 0; i < kMergeLoads; ++i) acc += nj[i] * pj[i].x;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
        const float mean = acc / ntot;
        float acc2 = 0.f;
#pragma unroll
        for (int i = 0; i < kMergeLoads; ++i) {
          const float d = pj[i].x - mean;
          acc2 += pj[i].y + nj[i] * d * d;
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) acc2 += __shfl_xor_sync(0xffffffffu, acc2, o);
        if (lane == 0) {
          gmean[g] = mean;
          grstd[g] = rsqrtf(acc2 / ntot + a.eps);
        }
      }
    }
    __syncthreads();
    stamp(st, 4);
    float m[kVec], rs[kVec];
#pragma unroll
    for (int l = 0; l < kVec; ++l) {
      m[l] = gmean[grp[l]];
      rs[l] = grstd[grp[l]];
    }
    // the residual as loaded: its conv's bias (held for the apply pass only)
    [[maybe_unused]] Reader<Res, kSplit, RBIAS> rin;
    if constexpr (RBIAS) rin.set(0, res_bias, cv, a.c);
    // apply, the last tile (still in shared memory) first; a resident run
    // goes chunk by chunk, each chunk refilled with the next wave's run as
    // soon as every thread is done with it
    for (int t = ntiles - 1; t >= 0; --t) {
      const int n = min(a.tile_pix, np - t * a.tile_pix);
      if (t != ntiles - 1) {
        __syncthreads();  // every read of the buffer is done before the reload
        issue(img, t, 0, n, true);
        wait();
      }
      const long long base = (img * a.hw + p0 + static_cast<long long>(t) * a.tile_pix) * a.c;
      const int step = refill ? chunk_pix : n;
      for (int q0 = 0; q0 < n; q0 += step) {
        const int q1 = min(n, q0 + step);
        // kBatch rows a step, their residual loads issued before any store
        // (the stores could alias them, so the compiler would not hoist them)
        for (int r0 = q0 + row0; r0 < q1; r0 += kBatch * rows) {
          [[maybe_unused]] typename Reader<Res, kSplit, RBIAS>::Raw rw[kBatch];
          if constexpr (RES != 0) {
#pragma unroll
            for (int i = 0; i < kBatch; ++i) {
              const int r = r0 + i * rows;
              if (r < q1)
                rw[i] = rin.fetch(static_cast<const Res*>(a.res) + base +
                                      static_cast<long long>(r) * a.c,
                                  cv, a.c);
            }
          }
#pragma unroll
          for (int i = 0; i < kBatch; ++i) {
            const int r = r0 + i * rows;
            if (r >= q1) break;
            float v[kVec];
            in.load(xs + static_cast<long long>(r) * a.c, cv, a.c, v);
            [[maybe_unused]] float rv[kVec];
            if constexpr (RES != 0) rin.unpack(rw[i], rv);
#pragma unroll
            for (int l = 0; l < kVec; ++l) {
              float yv = (v[l] - m[l]) * rs[l] * sc[l] + bi[l];
              yv = __fdividef(yv, 1.f + __expf(-yv));
              if constexpr (RES != 0) yv += rv[l];
              v[l] = yv;
            }
            Row<TOut, kSplit>::store(
                static_cast<TOut*>(a.y) + base + static_cast<long long>(r) * a.c, cv, a.c, v);
          }
        }
        if (refill) {
          __syncthreads();  // the chunk is free
          issue(img + a.ipw, 0, q0, q1, q0 == 0);
        }
      }
    }
    __syncthreads();  // the buffer is free for the next wave
    stamp(st, 5);
    preloaded = refill;
  }
}

// the barrier alone, `rounds` times, on ipw images of cpi CTAs: the
// exchange's cost, measured apart
__global__ void __launch_bounds__(kMaxThreads, 1) counter_probe(unsigned* sync, int cpi,
                                                                 int rounds) {
  for (int r = 0; r < rounds; ++r) image_barrier(sync + kSyncStride * (blockIdx.x / cpi), cpi);
}

using KernelFn = void (*)(const Args, const float*, const float*);

template <typename TIn, int RES, typename TOut, bool SHIFT = false, bool BIAS = false,
          bool RBIAS = false>
KernelFn form() {
  return &groupnorm_silu_kernel<TIn, RES, TOut, SHIFT, BIAS, RBIAS>;
}

// without the convolutions' biases: every residual kind, and the shifted
// form without a residual only (gn1)
template <typename TIn, typename TOut>
KernelFn pick_res(int res_kind, bool shift) {
  switch (res_kind) {
    case 0: return shift ? form<TIn, 0, TOut, true>() : form<TIn, 0, TOut>();
    case 1: return shift ? nullptr : form<TIn, 1, TOut>();
    case 2: return shift ? nullptr : form<TIn, 2, TOut>();
  }
  return nullptr;
}

// with them, the fused ConvBlock's forms alone, out in x's type: gn1 (conv1's
// bias and the shift) and gn2 (conv2's bias; a residual of x's type, with or
// without the 1x1 residual conv's bias, or for bf16 x the f32 one that the
// bottleneck takes from the attention before it)
template <typename T>
KernelFn pick_biased(int res_kind, bool shift, bool res_bias) {
  constexpr int kOwn = sizeof(T) == 2 ? 2 : 1;  // the residual kind of x's type
  if (res_kind == 0) return shift && !res_bias ? form<T, 0, T, true, true>() : nullptr;
  if (shift) return nullptr;
  if (res_kind == kOwn)
    return res_bias ? form<T, kOwn, T, false, true, true>() : form<T, kOwn, T, false, true>();
  return res_kind == 1 && !res_bias ? form<T, 1, T, false, true>() : nullptr;
}

KernelFn pick(int in_bf16, int res_kind, int out_bf16, bool shift, bool bias, bool res_bias) {
  if (bias) {
    if (in_bf16 != out_bf16 || res_kind < 0 || res_kind > 2) return nullptr;
    return in_bf16 ? pick_biased<__nv_bfloat16>(res_kind, shift, res_bias)
                   : pick_biased<float>(res_kind, shift, res_bias);
  }
  if (res_bias) return nullptr;
  if (in_bf16)
    return out_bf16 ? pick_res<__nv_bfloat16, __nv_bfloat16>(res_kind, shift)
                    : pick_res<__nv_bfloat16, float>(res_kind, shift);
  return out_bf16 ? pick_res<float, __nv_bfloat16>(res_kind, shift)
                  : pick_res<float, float>(res_kind, shift);
}

// blocks of `fn` that can be resident at once at `threads` and `smem`
cudaError_t resident(const void* fn, int threads, int smem, int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && smem > 0)
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, threads, smem);
  *blocks = per_sm * sms;
  return err;
}

// a cooperative launch of `grid` blocks; refused above the resident blocks
cudaError_t launch(const void* fn, void** params, int grid, int threads, int smem,
                   cudaStream_t st) {
  int blocks = 0;
  cudaError_t err = resident(fn, threads, smem, &blocks);
  if (err != cudaSuccess) return err;
  if (grid < 1 || grid > blocks) return cudaErrorCooperativeLaunchTooLarge;
  err = cudaLaunchCooperativeKernel(fn, dim3(grid), dim3(threads), params, smem, st);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

// the dynamic shared memory a CTA needs besides its buffers
extern "C" int vgd_groupnorm_silu_aux_bytes() { return kAuxBytes; }

// x, res (null: none), y: (b, hw, c) contiguous, 16-byte aligned; scale,
// bias (c,) f32; part: 4 * ipw * cpi * groups floats; sync: sync_words
// words, zero before the first call (image i of a wave uses word
// kSyncStride * i, and every call leaves each count at zero). The plan
// (threads, cpi, ipw, run_pix, tile_pix, refill, buf_bytes, smem) comes from
// kernels.groupnorm_silu_plan and is checked here. stamps: null, or
// kStamps * waves device times (block 0's phases, see stamp()). shift:
// null, or (b, c) f32 contiguous, added to x (cast to x's type) before the
// statistics; only without res. conv_bias, res_bias: null, or (c,) f32,
// added to x before the shift and to res, each cast to its tensor's type;
// only in the forms pick() lists.
extern "C" int vgd_groupnorm_silu(const void* x, const void* res, void* y, const float* scale,
                                  const float* bias, float* part, unsigned* sync, int sync_words,
                                  int b, long long hw, int c, int groups, float eps, int in_bf16,
                                  int res_kind, int out_bf16, int threads, int cpi, int ipw,
                                  int run_pix, int tile_pix, int refill, int buf_bytes, int smem,
                                  unsigned long long* stamps, const float* shift,
                                  const float* conv_bias, const float* res_bias, void* stream) {
  const KernelFn fn = pick(in_bf16, res_kind, out_bf16, shift != nullptr, conv_bias != nullptr,
                           res_bias != nullptr);
  const long long es = in_bf16 ? 2 : 4;
  const bool ok =
      fn != nullptr && b >= 1 && hw >= 1 && c >= kVec && c % kVec == 0 && c <= kMaxChannels &&
      groups >= 1 && groups <= kMaxGroups && c % groups == 0 && threads >= c / kVec &&
      threads <= kMaxThreads && threads % (c / kVec) == 0 && cpi >= 1 &&
      cpi <= 32 * kMergeLoads && ipw >= 1 &&
      ipw * kSyncStride <= sync_words && ipw <= b && run_pix >= 1 &&
      static_cast<long long>(cpi - 1) * run_pix < hw &&
      static_cast<long long>(cpi) * run_pix >= hw && tile_pix >= 1 && tile_pix <= run_pix &&
      (!refill || tile_pix == run_pix) && buf_bytes % 128 == 0 &&
      static_cast<long long>(tile_pix) * c * es <= buf_bytes &&
      static_cast<long long>(buf_bytes) + kAuxBytes <= smem &&
      (res_kind == 0) == (res == nullptr);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  Args a{x, res, y, scale, bias, part, sync, hw, b, c, groups, c / groups, eps,
         cpi, ipw, run_pix, tile_pix, refill, buf_bytes, stamps, shift};
  void* params[] = {&a, &conv_bias, &res_bias};
  return static_cast<int>(launch(reinterpret_cast<const void*>(fn), params, cpi * ipw, threads,
                                 smem, static_cast<cudaStream_t>(stream)));
}

// the exchange alone, `rounds` times, on the per-image barrier words (sync
// as above) of ipw images of cpi CTAs
extern "C" int vgd_groupnorm_silu_sync_probe(int rounds, int cpi, int ipw, unsigned* sync,
                                             int sync_words, void* stream) {
  if (cpi < 1 || ipw < 1 || rounds < 0 || ipw * kSyncStride > sync_words)
    return static_cast<int>(cudaErrorInvalidValue);
  void* params[] = {&sync, &cpi, &rounds};
  return static_cast<int>(launch(reinterpret_cast<const void*>(&counter_probe), params,
                                 cpi * ipw, kMaxThreads, 0, static_cast<cudaStream_t>(stream)));
}

extern "C" const char* vgd_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
