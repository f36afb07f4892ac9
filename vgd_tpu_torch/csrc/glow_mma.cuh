// The bf16 tensor-core GEMM tiles of the Glow coupling network, written for
// Hopper (sm_90a), shared by K5 (glow_coupling.cu), K6 (glow_flow_stack.cu)
// and K1 (conv_bn_stats.cu): mma_tile (below: K5's and K1's mma.sync
// products, K6's 64 x 64 tiles), wgmma_ring_tile (further below: the same
// cp.async ring feeding wgmma, its M- or N-major operands staged in
// 64-column blocks; K1's products with K > 32 and K6's large tiles), and
// wgmma_tile (TMA into an mbarrier ring, K5's f x f products).
//
// mma_tile<Cfg, Op> computes one BM x BN output tile of C = sum_k A(m, k)
// B(k, n) over one split of the reduction:
//
// * operands stream through a ring of Cfg::kStages shared-memory stages,
//   each kBK = 64 deep, filled by cp.async 16-byte copies (8 bf16 along the
//   operand's contiguous axis), or 4-byte copies where the gathered channel
//   count is even but no multiple of 8 (the 6 and 12 flow channels of
//   Glow's first blocks); a copy whose source lies outside the image or past
//   a ragged edge uses the src-size form (0 bytes read, zeros written), and
//   a value-1 border is written by the threads themselves; an odd channel
//   count is gathered element by element into the same ring;
// * every stage row is 128 bytes or a multiple of it, and the 16-byte chunks
//   of a row are XOR-swizzled with the row index, so ldmatrix (.trans for the
//   operands stored with M or N contiguous) reads 8 rows without bank
//   conflicts;
// * each warp owns a TM x TN sub-tile as m16n8k16 bf16 mma.sync products with
//   f32 accumulators; the fragments of rows at or past M, and of columns at or
//   past N, are skipped, so N tiles step by 8 (an N of 54 costs 56 columns);
// * after the last stage the accumulators go to an f32 tile in the same
//   shared memory, and the Op's epilogue (bias, ReLU, rounding, masks,
//   per-tile column sums, partial stores) reads it there.
//
// As in glow_gemm.cuh's gemm_tile, the caller names the tile (Tile) and hands
// in the shared memory (Cfg::kSmemBytes, 128-byte aligned), so a persistent
// kernel (K6) can walk many tiles of many Ops with one ring. The column sums
// of masked_grad take kThreads / BN row parts (two for K5's tiles, four for
// K6's 64 x 64 tile of 256 threads), added in order.
//
// Each Op gives kAK (A is staged K-contiguous, [BM][kBK], else M-contiguous,
// [kBK][BM]), kBKMajor (B is staged K-contiguous, [BN][kBK], else
// N-contiguous, [kBK][BN]), kRunA (8: A is read in 16-byte runs; 0: in runs
// of `wa` elements, 8, 2 or 1, set by the host with run_a), a_src(m, k) /
// b_src(k, n): the source of the run of elements from (m, k) along A's
// contiguous axis or from B(k, n) along B's (B always in 16-byte runs),
// a_elt(m, k): one element of A, for runs of 1; any(): a valid address for
// zero fills; and epilogue<Cfg>(cs, tile, M, N), called by all threads. The
// operands that run along the coupling width f take 16-byte runs, so f is a
// multiple of 8 on this path.
#include <cuda.h>
#include <cudaTypedefs.h>

#include "glow_gemm.cuh"

namespace {
namespace mma {

using bf16 = __nv_bfloat16;

constexpr int kBK = 64;          // reduction depth of one ring stage

template <int BM_, int BN_, int WM_, int WN_, int MIN_BLOCKS, int STAGES>
struct Cfg {
  static constexpr int BM = BM_, BN = BN_;       // output tile
  static constexpr int WM = WM_, WN = WN_;       // warps along M and N
  static constexpr int kThreads = 32 * WM * WN;
  static constexpr int kMinBlocks = MIN_BLOCKS;  // resident blocks per SM
  static constexpr int kStages = STAGES;         // ring stages
  static constexpr int TM = BM / WM, TN = BN / WN;  // a warp's sub-tile
  static constexpr int MF = TM / 16, NF = TN / 8;   // its m16 and n8 fragments
  static constexpr int kA = BM * kBK, kB = kBK * BN;  // elements per stage
  static constexpr int kCS = BN + 8;  // f32 tile row stride: float2 stores
                                      // of a half warp hit distinct banks
  static constexpr int kRingBytes = kStages * (kA + kB) * 2;
  static constexpr int kCBytes = (BM * kCS + kThreads) * 4;  // + column-sum parts
  static constexpr int kSmemBytes = kRingBytes > kCBytes ? kRingBytes : kCBytes;
  static_assert(BM % (16 * WM) == 0 && BN % (16 * WN) == 0, "warp tiling");
  static_assert(kA % (8 * kThreads) == 0 && kB % (8 * kThreads) == 0, "loads");
  static_assert(kThreads % BN == 0 && BM % (kThreads / BN) == 0,
                "column sums: kThreads / BN row parts");
};
// conv1 and dh2 where they give about a tile an SM or more: 8 warps of 64 x
// 32, two blocks an SM (also the output tile of wgmma_tile)
using Wide = Cfg<128, 128, 2, 4, 2, 3>;
// the other mma.sync products (the N-packs, dWz, dW1, and every product of
// the small blocks): 4 warps of 32 x 32, four blocks an SM
using Small = Cfg<64, 64, 2, 2, 4, 3>;

// n / d for 0 <= n < 2^31 by a multiply-high and a shift (d fixed per call,
// its multiplier made on the host): the gathers divide pixel and channel
// indices by the image and channel sizes
struct FastDiv {
  unsigned d = 1, m = 1, l = 0;
  FastDiv() = default;
  explicit FastDiv(unsigned div) : d(div) {
    while ((1u << l) < d) ++l;
    m = static_cast<unsigned>((((1ull << 32) * ((1ull << l) - d)) / d) + 1);
  }
  __device__ __forceinline__ int div(int n) const {
    return static_cast<int>((__umulhi(static_cast<unsigned>(n), m) + static_cast<unsigned>(n)) >>
                            l);
  }
};

// the geometry with its divisors
struct Geom : Geo {
  FastDiv hw, wd, hwp, wp, kwd, cind, coutd;
  Geom() = default;
  explicit Geom(const Geo& g)
      : Geo(g),
        hw(g.h * g.w),
        wd(g.w),
        hwp((g.h + 2 * g.ph) * (g.w + 2 * g.pw)),
        wp(g.w + 2 * g.pw),
        kwd(g.kw),
        cind(g.cin),
        coutd(g.cout) {}
  __device__ __forceinline__ Pix pix(int i) const {
    const int b = hw.div(i), r = i - b * h * w, y = wd.div(r);
    return Pix{b, y, r - y * w};
  }
  __device__ __forceinline__ Pix pix_padded(int i) const {
    const int b = hwp.div(i), r = i - b * hwp.d, y = wp.div(r);
    return Pix{b, y, r - y * static_cast<int>(wp.d)};
  }
};

// element offset of (row, col) in a stage whose rows hold W elements (a
// multiple of 64): the 16-byte chunk index is XORed with the row in its low
// three bits
template <int W>
__device__ __forceinline__ int swz(int row, int col) {
  const int c = col >> 3;
  return row * W + (((c & ~7) | ((c ^ row) & 7)) << 3) + (col & 7);
}

// the offset of (row, col) in a stage of kBK rows, W columns: plain (swz<W>,
// mma_tile's ldmatrix layout) or, with Blocked, in 64-column blocks of kBK
// rows each swizzled as swz<64> (wgmma's 128-byte-swizzled M- or N-major
// layout: one block per 64 rows of M or columns of N)
template <int W, bool Blocked>
__device__ __forceinline__ int stage_at(int row, int col) {
  if constexpr (Blocked && W > 64) {
    return (col >> 6) * (kBK * 64) + swz<64>(row, col & 63);
  } else {
    return swz<W>(row, col);
  }
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes 0 writes 16 zero bytes, reads none
__device__ __forceinline__ void cp16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
// 4 bytes global -> shared (two bf16); src_bytes 0 writes zeros
__device__ __forceinline__ void cp4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma16816(float (&c)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// where a run of 8 (or 2) elements comes from: copied from p, zeros (p is
// then any valid address), or ones (the value-1 border of the ZeroConv's
// input)
enum Fill { kCopy, kZero, kOne };
struct Src {
  const void* p;
  Fill fill;
};

// the copy of one run of W elements (8: 16 bytes, 2: 4 bytes)
template <int W>
__device__ __forceinline__ void put(bf16* dst, const Src& s) {
  if constexpr (W == 8) {
    if (s.fill == kOne) {
      *reinterpret_cast<uint4*>(dst) = splat<bf16>(1.0f);
    } else {
      cp16(dst, s.p, s.fill == kCopy ? 16 : 0);
    }
  } else {
    if (s.fill == kOne) {
      *reinterpret_cast<unsigned*>(dst) = 0x3F803F80u;  // two bf16 ones
    } else {
      cp4(dst, s.p, s.fill == kCopy ? 4 : 0);
    }
  }
}

// A's share of one ring stage (reduction rows [k0, kend)) in runs of W
// elements along its contiguous axis: 8 (cp.async 16 bytes), 2 (cp.async 4
// bytes, for an even channel count) or 1 (element by element)
template <int W, class C, class Op, bool Blocked = false>
__device__ __forceinline__ void load_a(const Op& op, bf16* sa, int m0, int k0, int kend, int M) {
  constexpr int kRow = Op::kAK ? kBK : C::BM;
#pragma unroll 8
  for (int i = 0; i < C::kA / W / C::kThreads; ++i) {
    const int v = threadIdx.x + i * C::kThreads;
    const int r = v / (kRow / W), col = (v % (kRow / W)) * W;
    const int m = m0 + (Op::kAK ? r : col), k = k0 + (Op::kAK ? col : r);
    bf16* dst = sa + stage_at<kRow, Blocked>(r, col);
    const bool in = m < M && k < kend;
    if constexpr (W == 1) {
      *dst = in ? op.a_elt(m, k) : __float2bfloat16(0.0f);
    } else {
      put<W>(dst, in ? op.a_src(m, k) : Src{op.any(), kZero});
    }
  }
}

// B's share in 16-byte runs, staged N-contiguous ([kBK][BN], or with
// Blocked in 64-column blocks), or K-contiguous ([BN][kBK]) for an Op with
// kBKMajor
template <class C, class Op, bool Blocked = false>
__device__ __forceinline__ void load_b(const Op& op, bf16* sb, int n0, int k0, int kend, int N) {
  constexpr int W = 8;
  constexpr int kRow = Op::kBKMajor ? kBK : C::BN;
#pragma unroll 8
  for (int i = 0; i < C::kB / W / C::kThreads; ++i) {
    const int v = threadIdx.x + i * C::kThreads;
    const int r = v / (kRow / W), col = (v % (kRow / W)) * W;
    const int k = k0 + (Op::kBKMajor ? col : r), n = n0 + (Op::kBKMajor ? r : col);
    put<W>(sb + stage_at<kRow, Blocked>(r, col),
           k < kend && n < N ? op.b_src(k, n) : Src{op.any(), kZero});
  }
}

// one ring stage: A's and B's runs of reduction rows [k0, k0 + kBK); A
// takes 16-byte runs where the Op fixes them (kRunA = 8), else the width
// the host set (wa: 8, 2 or 1) is dispatched here; Blocked: the M- or
// N-major operands in wgmma's 64-column blocks
template <class C, class Op, bool Blocked = false>
__device__ __forceinline__ void load_stage(const Op& op, bf16* sa, bf16* sb, int m0, int n0,
                                           int k0, int kend, int M, int N) {
  if constexpr (Op::kRunA == 8) {
    load_a<8, C, Op, Blocked>(op, sa, m0, k0, kend, M);
  } else if (op.wa == 8) {
    load_a<8, C, Op, Blocked>(op, sa, m0, k0, kend, M);
  } else if (op.wa == 2) {
    load_a<2, C, Op, Blocked>(op, sa, m0, k0, kend, M);
  } else {
    load_a<1, C, Op, Blocked>(op, sa, m0, k0, kend, M);
  }
  load_b<C, Op, Blocked>(op, sb, n0, k0, kend, N);
}

// the products of one stage; mlive / nlive: rows and columns of the warp's
// sub-tile that lie inside the output
template <class C, class Op>
__device__ __forceinline__ void mma_stage(const bf16* sa, const bf16* sb,
                                          float (&acc)[C::MF][C::NF][4], int wm, int wn, int lane,
                                          int mlive, int nlive) {
#pragma unroll
  for (int ks = 0; ks < kBK / 16; ++ks) {
    unsigned af[C::MF][4];
    unsigned bfr[C::NF][2];
#pragma unroll
    for (int i = 0; i < C::MF; ++i) {
      // matrices 0-3: (m 0-7, k 0-7), (m 8-15, k 0-7), (m 0-7, k 8-15),
      // (m 8-15, k 8-15); lane l gives row l % 8 of matrix l / 8
      if constexpr (Op::kAK) {
        const int row = wm * C::TM + i * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        ldsm_x4(af[i], sa + swz<kBK>(row, ks * 16 + (lane >> 4) * 8));
      } else {
        const int row = ks * 16 + (lane & 7) + (lane >> 4) * 8;
        ldsm_x4_t(af[i], sa + swz<C::BM>(row, wm * C::TM + i * 16 + ((lane >> 3) & 1) * 8));
      }
    }
#pragma unroll
    for (int j = 0; j < C::NF / 2; ++j) {
      // matrices: (k 0-7, n 0-7), (k 8-15, n 0-7), (k 0-7, n 8-15), (k 8-15,
      // n 8-15): the b0, b1 of two n8 fragments
      // (K-major B: the same four matrices, rows n, read untransposed)
      unsigned r[4];
      if constexpr (Op::kBKMajor) {
        const int row = wn * C::TN + j * 16 + (lane & 7) + (lane >> 4) * 8;
        ldsm_x4(r, sb + swz<kBK>(row, ks * 16 + ((lane >> 3) & 1) * 8));
      } else {
        const int row = ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        ldsm_x4_t(r, sb + swz<C::BN>(row, wn * C::TN + j * 16 + (lane >> 4) * 8));
      }
      bfr[2 * j][0] = r[0];
      bfr[2 * j][1] = r[1];
      bfr[2 * j + 1][0] = r[2];
      bfr[2 * j + 1][1] = r[3];
    }
#pragma unroll
    for (int i = 0; i < C::MF; ++i)
#pragma unroll
      for (int j = 0; j < C::NF; ++j)
        if (i * 16 < mlive && j * 8 < nlive) mma16816(acc[i][j], af[i], bfr[j]);
  }
}

// One output tile of Op's GEMM over the reduction split t.z (k_split deep,
// a multiple of kBK); all threads of the block call it. The f32 tile ends in
// smem (row stride C::kCS) for the epilogue, which it runs.
template <class C, class Op>
__device__ __forceinline__ void mma_tile(const Op& op, int M, int N, int K, int k_split,
                                         const Tile& t, unsigned char* smem) {
  bf16* ring = reinterpret_cast<bf16*>(smem);
  float* cs = reinterpret_cast<float*>(smem);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / C::WN, wn = warp % C::WN;
  const int kbeg = t.z * k_split;
  const int kend = min(K, kbeg + k_split);
  const int nk = (kend - kbeg + kBK - 1) / kBK;
  const int mlive = M - t.m0 - wm * C::TM, nlive = N - t.n0 - wn * C::TN;
  float acc[C::MF][C::NF][4];
#pragma unroll
  for (int i = 0; i < C::MF; ++i)
#pragma unroll
    for (int j = 0; j < C::NF; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

  __syncthreads();  // the shared memory of the caller's previous tile is free
#pragma unroll
  for (int s = 0; s < C::kStages - 1; ++s) {
    if (s < nk) {
      bf16* sa = ring + s * (C::kA + C::kB);
      load_stage<C>(op, sa, sa + C::kA, t.m0, t.n0, kbeg + s * kBK, kend, M, N);
    }
    cp_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_wait<C::kStages - 2>();  // stage kt has landed (this thread's copies)
    __syncthreads();         // ... everyone's, and stage kt - 1 is consumed
    const int nxt = kt + C::kStages - 1;
    if (nxt < nk) {
      bf16* sa = ring + (nxt % C::kStages) * (C::kA + C::kB);
      load_stage<C>(op, sa, sa + C::kA, t.m0, t.n0, kbeg + nxt * kBK, kend, M, N);
    }
    cp_commit();
    const bf16* sa = ring + (kt % C::kStages) * (C::kA + C::kB);
    mma_stage<C, Op>(sa, sa + C::kA, acc, wm, wn, lane, mlive, nlive);
  }
  cp_wait<0>();
  __syncthreads();  // the ring is consumed: the f32 tile takes its place
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int i = 0; i < C::MF; ++i)
#pragma unroll
    for (int j = 0; j < C::NF; ++j) {
      const int r = wm * C::TM + i * 16 + g, c = wn * C::TN + j * 8 + 2 * t4;
      *reinterpret_cast<float2*>(cs + r * C::kCS + c) = make_float2(acc[i][j][0], acc[i][j][1]);
      *reinterpret_cast<float2*>(cs + (r + 8) * C::kCS + c) =
          make_float2(acc[i][j][2], acc[i][j][3]);
    }
  __syncthreads();
  op.template epilogue<C>(cs, t, M, N);
}

// ---------------------------------------------------------------------------
// epilogues
// ---------------------------------------------------------------------------

// out (M x N, bf16) = bf16(ReLU(c + bias[n])), 8 columns a thread (16-byte
// shared and global accesses where N is a multiple of 8)
template <class C>
__device__ __forceinline__ void bias_relu_store(const float* cs, const float* bias, bf16* out,
                                                const Tile& t, int M, int N) {
  for (int v = threadIdx.x; v < C::BM * C::BN / 8; v += C::kThreads) {
    const int r = v / (C::BN / 8), c = (v % (C::BN / 8)) * 8;
    const int m = t.m0 + r, n = t.n0 + c;
    if (m >= M || n >= N) continue;
    const float* src = cs + r * C::kCS + c;
    bf16* dst = out + static_cast<long long>(m) * N + n;
    if (N % 8 == 0) {
      float x[8], b[8];
      *reinterpret_cast<float4*>(x) = *reinterpret_cast<const float4*>(src);
      *reinterpret_cast<float4*>(x + 4) = *reinterpret_cast<const float4*>(src + 4);
      if ((reinterpret_cast<uintptr_t>(bias) & 15) == 0) {
        *reinterpret_cast<float4*>(b) = __ldg(reinterpret_cast<const float4*>(bias + n));
        *reinterpret_cast<float4*>(b + 4) = __ldg(reinterpret_cast<const float4*>(bias + n + 4));
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) b[j] = bias[n + j];
      }
      uint4 pk;
      bf16* e = reinterpret_cast<bf16*>(&pk);
#pragma unroll
      for (int j = 0; j < 8; ++j) e[j] = __float2bfloat16(fmaxf(x[j] + b[j], 0.0f));
      *reinterpret_cast<uint4*>(dst) = pk;
    } else {
      for (int j = 0; j < 8 && n + j < N; ++j)
        dst[j] = __float2bfloat16(fmaxf(src[j] + bias[n + j], 0.0f));
    }
  }
}

// dst (M x N, f32) = the tile (16-byte accesses where N is a multiple of 4)
template <class C>
__device__ __forceinline__ void store_f32(const float* cs, float* dst, const Tile& t, int M,
                                          int N) {
  if (N % 4 == 0) {
    for (int v = threadIdx.x; v < C::BM * C::BN / 4; v += C::kThreads) {
      const int r = v / (C::BN / 4), c = (v % (C::BN / 4)) * 4;
      const int m = t.m0 + r, n = t.n0 + c;
      if (m < M && n < N)
        *reinterpret_cast<float4*>(dst + static_cast<long long>(m) * N + n) =
            *reinterpret_cast<const float4*>(cs + r * C::kCS + c);
    }
    return;
  }
  for (int v = threadIdx.x; v < C::BM * C::BN; v += C::kThreads) {
    const int r = v / C::BN, c = v % C::BN;
    const int m = t.m0 + r, n = t.n0 + c;
    if (m < M && n < N) dst[static_cast<long long>(m) * N + n] = cs[r * C::kCS + c];
  }
}

// A gradient masked by its activation: out = bf16(act > 0 ? c : 0), and the
// tile's column sums of the masked f32 values, rows in a fixed order, into
// colpart[t.mi * N + n]
template <class C>
__device__ __forceinline__ void masked_grad(float* cs, const bf16* act, bf16* out,
                                            float* colpart, const Tile& t, int M, int N) {
  for (int v = threadIdx.x; v < C::BM * C::BN / 8; v += C::kThreads) {
    const int r = v / (C::BN / 8), c = (v % (C::BN / 8)) * 8;
    const int m = t.m0 + r, n = t.n0 + c;
    if (m >= M || n >= N) continue;   // rows past M hold zeros already
    float* src = cs + r * C::kCS + c;
    const long long i = static_cast<long long>(m) * N + n;
    if (N % 8 == 0) {
      const uint4 a = *reinterpret_cast<const uint4*>(act + i);
      const bf16* ae = reinterpret_cast<const bf16*>(&a);
      float x[8];
      *reinterpret_cast<float4*>(x) = *reinterpret_cast<const float4*>(src);
      *reinterpret_cast<float4*>(x + 4) = *reinterpret_cast<const float4*>(src + 4);
      uint4 pk;
      bf16* e = reinterpret_cast<bf16*>(&pk);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        x[j] = __bfloat162float(ae[j]) > 0.0f ? x[j] : 0.0f;
        e[j] = __float2bfloat16(x[j]);
      }
      *reinterpret_cast<float4*>(src) = *reinterpret_cast<const float4*>(x);
      *reinterpret_cast<float4*>(src + 4) = *reinterpret_cast<const float4*>(x + 4);
      *reinterpret_cast<uint4*>(out + i) = pk;
    } else {
      for (int j = 0; j < 8 && n + j < N; ++j) {
        const float val = __bfloat162float(act[i + j]) > 0.0f ? src[j] : 0.0f;
        src[j] = val;
        out[i + j] = __float2bfloat16(val);
      }
    }
  }
  __syncthreads();
  // thread (part, c) sums one of the kThreads / BN row parts of column c
  // (two halves for K5's tiles), then one thread adds the parts in order
  constexpr int kParts = C::kThreads / C::BN, kRows = C::BM / kParts;
  float* red = cs + C::BM * C::kCS;
  const int c = threadIdx.x % C::BN, part = threadIdx.x / C::BN;
  float s = 0.0f;
  for (int r = part * kRows; r < (part + 1) * kRows; ++r) s += cs[r * C::kCS + c];
  red[part * C::BN + c] = s;
  __syncthreads();
  if (part == 0 && t.n0 + c < N) {
    float v = red[c];
#pragma unroll
    for (int j = 1; j < kParts; ++j) v += red[j * C::BN + c];
    colpart[static_cast<long long>(t.mi) * N + t.n0 + c] = v;
  }
}

// ---------------------------------------------------------------------------
// the Ops (bf16); the math each serves is in glow_coupling.cu
// ---------------------------------------------------------------------------

// global offset of channel c of pixel i's neighbour through tap, or -1
// outside the image: sign +1 for a conv's input (y + dy - ph), -1 for a
// correlation's (y - dy + ph)
__device__ __forceinline__ long long tap_at(const Geom& g, int i, int tap, int c, int ch,
                                            int sign) {
  const Pix p = g.pix(i);
  const int dy = g.kwd.div(tap), dx = tap - dy * g.kw;
  const int y = p.y + sign * (dy - g.ph), x = p.x + sign * (dx - g.pw);
  return inside(y, x, g) ? at(g, p.b, y, x, c, ch) : -1;
}

// h1 = bf16(ReLU(conv(ya) + b1)): M pixels, N = f, K = taps * cin (tap, ci)
struct Conv1Op {
  static constexpr bool kAK = true;
  static constexpr int kRunA = 0;  // the host's wa
  static constexpr bool kBKMajor = false;
  Geom g;
  const bf16* ya;
  const bf16* w1f;
  const float* bias;
  bf16* h1;
  int wa = 1;  // run width of A's loads (8, 2 or 1)
  __device__ const void* any() const { return ya; }
  __device__ long long a_at(int m, int k) const {
    const int tap = g.cind.div(k);
    return tap_at(g, m, tap, k - tap * g.cin, g.cin, 1);
  }
  __device__ Src a_src(int m, int k) const {
    const long long o = a_at(m, k);
    return o < 0 ? Src{ya, kZero} : Src{ya + o, kCopy};
  }
  __device__ bf16 a_elt(int m, int k) const {
    const long long o = a_at(m, k);
    return o < 0 ? __float2bfloat16(0.0f) : ya[o];
  }
  __device__ Src b_src(int k, int n) const {
    return Src{w1f + static_cast<long long>(k) * g.f + n, kCopy};
  }
  template <class C>
  __device__ void epilogue(float* cs, const Tile& t, int M, int N) const {
    bias_relu_store<C>(cs, bias, h1, t, M, N);
  }
};

// a product of two row-major operands with N = K = f: A (M x f), B (f x f);
// Conv2Op adds the bias and ReLU, Dh1Op masks by h1 > 0
struct DenseAB {
  static constexpr bool kAK = true;
  static constexpr int kRunA = 8;
  static constexpr bool kBKMajor = false;
  Geom g;
  const bf16* a;
  const bf16* b;
  __device__ const void* any() const { return a; }
  __device__ Src a_src(int m, int k) const {
    return Src{a + static_cast<long long>(m) * g.f + k, kCopy};
  }
  __device__ Src b_src(int k, int n) const {
    return Src{b + static_cast<long long>(k) * g.f + n, kCopy};
  }
};

// h2 = bf16(ReLU(h1 @ W2 + b2))
struct Conv2Op : DenseAB {
  const float* bias;
  bf16* h2;
  template <class C>
  __device__ void epilogue(float* cs, const Tile& t, int M, int N) const {
    bias_relu_store<C>(cs, bias, h2, t, M, N);
  }
};

// dh1 = mask(h1 > 0) dh2 @ W2^T, db1 column partials
struct Dh1Op : DenseAB {
  const bf16* h1;
  bf16* dh1;
  float* colpart;
  template <class C>
  __device__ void epilogue(float* cs, const Tile& t, int M, int N) const {
    masked_grad<C>(cs, h1, dh1, colpart, t, M, N);
  }
};

// The shared-LHS N-pack (the TPU kernel's _zeroconv_fwd and the dya of its
// _bwd2_kernel): r (M x taps * ch, f32) = X (M x K) @ Wr with Wr[k, (tap, c)]
// = wk[(tap, c), k], wk the (taps * ch, K) packing of the conv weight (wzf,
// w1f), read K-contiguous; with `ones`, row M - 1 of X is all ones (r's row
// of the value-1 border: the column sums of Wr)
struct NPack {
  static constexpr bool kAK = true;
  static constexpr int kRunA = 8;
  static constexpr bool kBKMajor = true;
  Geom g;
  const bf16* x;
  const bf16* wk;
  float* r;
  int kdim;
  bool ones;
  __device__ const void* any() const { return x; }
  __device__ bool one_row(int m) const { return ones && m == g.b * g.h * g.w; }
  __device__ Src a_src(int m, int k) const {
    return one_row(m) ? Src{x, kOne} : Src{x + static_cast<long long>(m) * kdim + k, kCopy};
  }
  __device__ Src b_src(int k, int n) const {
    return Src{wk + static_cast<long long>(n) * kdim + k, kCopy};
  }
  template <class C>
  __device__ void epilogue(float* cs, const Tile& t, int M, int N) const {
    store_f32<C>(cs, r, t, M, N);
  }
};
// r = [h2; 1] @ Wzr (N = taps * cout, K = f)
struct ZeroConvROp : NPack {};
// r2 = cd(dh1) @ W1r (N = taps * cin, K = f)
struct DyaROp : NPack {};

// dWz partials over the padded grid q: M = f, N = taps * gc (tap, c), K =
// b (h + 2ph)(w + 2pw); A(k, q) = h2 padded with 1 (stored M-contiguous),
// B(q, (tap, c)) = gs at q - tap (zero outside the image); gs rows hold gc =
// cout rounded up to 8 channels (the pad zero), so both read 16-byte runs
struct DwzOp {
  static constexpr bool kAK = false;
  static constexpr int kRunA = 8;
  static constexpr bool kBKMajor = false;
  Geom g;
  const bf16* h2;
  const bf16* gs;
  float* part;
  int gc;
  FastDiv gcd;
  __device__ const void* any() const { return h2; }
  __device__ long long a_at(int m, int q) const {
    const Pix pk = g.pix_padded(q);
    const int iy = pk.y - g.ph, ix = pk.x - g.pw;
    return inside(iy, ix, g) ? at(g, pk.b, iy, ix, m, g.f) : -1;
  }
  __device__ Src a_src(int m, int q) const {
    const long long o = a_at(m, q);
    return o < 0 ? Src{h2, kOne} : Src{h2 + o, kCopy};
  }
  __device__ long long b_at(int q, int n) const {
    const Pix pk = g.pix_padded(q);
    const int tap = gcd.div(n), c = n - tap * gc;
    const int dy = g.kwd.div(tap), dx = tap - dy * g.kw;
    const int gy = pk.y - dy, gx = pk.x - dx;
    return inside(gy, gx, g) ? at(g, pk.b, gy, gx, c, gc) : -1;
  }
  __device__ Src b_src(int q, int n) const {
    const long long o = b_at(q, n);
    return o < 0 ? Src{gs, kZero} : Src{gs + o, kCopy};
  }
  template <class C>
  __device__ void epilogue(float* cs, const Tile& t, int M, int N) const {
    store_f32<C>(cs, part + static_cast<long long>(t.z) * M * N, t, M, N);
  }
};

// dh2 = mask(h2 > 0) corr(gs, Wz) on the interior, db2 column partials:
// M pixels, N = f, K = taps * gc (tap, c); A = gs (rows of gc channels), B
// = wzf[(tap, c), k], zero for the pad channels c >= cout
struct Dh2Op {
  static constexpr bool kAK = true;
  static constexpr int kRunA = 8;
  static constexpr bool kBKMajor = false;
  Geom g;
  const bf16* gs;
  const bf16* wzf;
  const bf16* h2;
  bf16* dh2;
  float* colpart;
  int gc;
  FastDiv gcd;
  __device__ const void* any() const { return gs; }
  __device__ long long a_at(int m, int k) const {
    const int tap = gcd.div(k);
    return tap_at(g, m, tap, k - tap * gc, gc, -1);
  }
  __device__ Src a_src(int m, int k) const {
    const long long o = a_at(m, k);
    return o < 0 ? Src{gs, kZero} : Src{gs + o, kCopy};
  }
  __device__ long long b_at(int k, int n) const {
    const int tap = gcd.div(k), c = k - tap * gc;
    return c < g.cout ? (static_cast<long long>(tap) * g.cout + c) * g.f + n : -1;
  }
  __device__ Src b_src(int k, int n) const {
    const long long o = b_at(k, n);
    return o < 0 ? Src{wzf, kZero} : Src{wzf + o, kCopy};
  }
  template <class C>
  __device__ void epilogue(float* cs, const Tile& t, int M, int N) const {
    masked_grad<C>(cs, h2, dh2, colpart, t, M, N);
  }
};

// dW2 partials: M = N = f, K = pixels; A(k1, p) = h1[p, k1] (stored
// M-contiguous), B = dh2
struct Dw2Op {
  static constexpr bool kAK = false;
  static constexpr int kRunA = 8;
  static constexpr bool kBKMajor = false;
  Geom g;
  const bf16* h1;
  const bf16* dh2;
  float* part;
  __device__ const void* any() const { return h1; }
  __device__ Src a_src(int m, int k) const {
    return Src{h1 + static_cast<long long>(k) * g.f + m, kCopy};
  }
  __device__ Src b_src(int k, int n) const {
    return Src{dh2 + static_cast<long long>(k) * g.f + n, kCopy};
  }
  template <class C>
  __device__ void epilogue(float* cs, const Tile& t, int M, int N) const {
    store_f32<C>(cs, part + static_cast<long long>(t.z) * M * N, t, M, N);
  }
};

// dW1 partials: M = taps * cin (tap, ci), N = f, K = pixels; A =
// im2col(ya)^T (stored M-contiguous), B = cd(dh1)
struct Dw1Op {
  static constexpr bool kAK = false;
  static constexpr int kRunA = 0;  // the host's wa
  static constexpr bool kBKMajor = false;
  Geom g;
  const bf16* ya;
  const bf16* dh1;
  float* part;
  int wa = 1;  // run width of A's loads (8, 2 or 1)
  __device__ const void* any() const { return ya; }
  __device__ long long a_at(int m, int p) const {
    const int tap = g.cind.div(m);
    return tap_at(g, p, tap, m - tap * g.cin, g.cin, 1);
  }
  __device__ Src a_src(int m, int p) const {
    const long long o = a_at(m, p);
    return o < 0 ? Src{ya, kZero} : Src{ya + o, kCopy};
  }
  __device__ bf16 a_elt(int m, int p) const {
    const long long o = a_at(m, p);
    return o < 0 ? __float2bfloat16(0.0f) : ya[o];
  }
  __device__ Src b_src(int k, int n) const {
    return Src{dh1 + static_cast<long long>(k) * g.f + n, kCopy};
  }
  template <class C>
  __device__ void epilogue(float* cs, const Tile& t, int M, int N) const {
    store_f32<C>(cs, part + static_cast<long long>(t.z) * M * N, t, M, N);
  }
};

// ---------------------------------------------------------------------------
// wgmma: the f x f products (conv2, dh1, dW2), 128 x 128 tiles
// ---------------------------------------------------------------------------
//
// Two warpgroups each own 64 rows of the tile; per 64-deep stage each issues
// four m64n128k16 wgmma products whose operands the TMA unit brought into a
// kWStages-deep ring of shared-memory stages (mbarrier "full" per stage,
// completed by the copies' byte count; "empty" per stage, one arrival per
// warp once that stage's products have retired). Thread 0 keeps the ring
// full: after stage kt - 1's products are done it refills that stage with
// stage kt - 1 + kWStages. The stages are in the TMA's 128-byte swizzle:
// A K-major (128 rows of 64 elements) or M-major (two blocks of 64 k-rows x
// 64 m), B N-major (two blocks of 64 k-rows x 64 n), which the wgmma
// descriptors name (K-major: 1024-byte 8-row groups; M/N-major: 1024-byte
// 8-row groups along K, 8192 bytes between the 64-wide blocks).

constexpr int kWStages = 3;
constexpr int kWStageA = 128 * kBK * 2, kWStageB = kBK * 128 * 2;
constexpr int kWStage = kWStageA + kWStageB;
// ring + barriers, plus 1024 bytes to align the ring for the swizzle
constexpr int kWSmemBytes = kWStages * kWStage + 2 * kWStages * 8 + 1024;
static_assert(kWStages * kWStage >= Wide::kCBytes, "the f32 tile fits in the ring");

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// waits for the phase of `parity` to complete; a wait that never ends (a
// fault in the ring's bookkeeping) traps after about 2^28 polls instead of
// hanging the card
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

// TMA: the box of `map` at (c0 inner, c1 outer) into dst, completing on bar
__device__ __forceinline__ void tma2d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                      int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_u32(bar))
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand
__device__ __forceinline__ uint64_t gmma_desc(const void* p, unsigned lbo, unsigned sbo) {
  const unsigned a = smem_u32(p);
  return static_cast<uint64_t>((a & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// d (64 x 128, f32, the warpgroup's fragment) += A (64 x 16) B (16 x 128);
// TA: A is M-major (transposed); B is N-major
template <int TA>
__device__ __forceinline__ void wgmma_m64n128(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, %66, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "n"(TA));
}

// One 128 x 128 output tile of Op's GEMM over the reduction split t.z
// (k_split deep, a multiple of kBK) on wgmma; 256 threads. ta / tb: tensor
// maps of A (K-major: box 64 x 128 rows; M-major: box 64 m x 64 k-rows) and
// B (box 64 n x 64 k-rows), bf16, 128-byte swizzle. smem: kWSmemBytes. The
// f32 tile ends in smem for Op's epilogue<Wide>, which it runs. It
// initialises its barriers, so it runs once per block.
template <class Op>
__device__ __forceinline__ void wgmma_tile(const CUtensorMap* ta, const CUtensorMap* tb,
                                           const Op& op, int M, int N, int K, int k_split,
                                           const Tile& t, unsigned char* smem_raw) {
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kWStages * kWStage);
  uint64_t* empty = full + kWStages;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, wg = warp >> 2;
  const int kbeg = t.z * k_split;
  const int kend = min(K, kbeg + k_split);
  const int nk = (kend - kbeg + kBK - 1) / kBK;
  if (tid == 0) {
    for (int s = 0; s < kWStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  auto issue = [&](int kt) {  // thread 0: stage kt into its ring slot
    const int s = kt % kWStages;
    unsigned char* a = smem + s * kWStage;
    unsigned char* b = a + kWStageA;
    const int k0 = kbeg + kt * kBK;
    mbar_expect_tx(&full[s], kWStage);
    if constexpr (Op::kAK) {
      tma2d(a, ta, &full[s], k0, t.m0);
    } else {
      tma2d(a, ta, &full[s], t.m0, k0);
      tma2d(a + kWStageA / 2, ta, &full[s], t.m0 + 64, k0);
    }
    tma2d(b, tb, &full[s], t.n0, k0);
    tma2d(b + kWStageB / 2, tb, &full[s], t.n0 + 64, k0);
  };
  if (tid == 0)
    for (int kt = 0; kt < kWStages && kt < nk; ++kt) issue(kt);

  float d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0.0f;
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % kWStages;
    mbar_wait(&full[s], (kt / kWStages) & 1);
    const unsigned char* a = smem + s * kWStage;
    const unsigned char* b = a + kWStageA;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks) {
      const uint64_t da = Op::kAK ? gmma_desc(a + wg * 64 * 128 + ks * 32, 16, 1024)
                                  : gmma_desc(a + wg * (kWStageA / 2) + ks * 2048,
                                              kWStageA / 2, 1024);
      const uint64_t db = gmma_desc(b + ks * 2048, kWStageB / 2, 1024);
      wgmma_m64n128<Op::kAK ? 0 : 1>(d, da, db);
    }
    wgmma_commit();
    wgmma_wait<1>();  // stage kt - 1's products have retired
    if (kt > 0) {
      const int sp = (kt - 1) % kWStages;
      if (lane == 0) mbar_arrive(&empty[sp]);
      if (tid == 0 && kt - 1 + kWStages < nk) {
        mbar_wait(&empty[sp], ((kt - 1) / kWStages) & 1);
        issue(kt - 1 + kWStages);
      }
      __syncwarp();
    }
  }
  wgmma_wait<0>();
  __syncthreads();  // the ring is consumed: the f32 tile takes its place
  float* cs = reinterpret_cast<float*>(smem);
  const int g = lane >> 2, t4 = lane & 3;
  const int r = wg * 64 + (warp & 3) * 16 + g;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int c = i * 8 + 2 * t4;
    *reinterpret_cast<float2*>(cs + r * Wide::kCS + c) = make_float2(d[4 * i], d[4 * i + 1]);
    *reinterpret_cast<float2*>(cs + (r + 8) * Wide::kCS + c) =
        make_float2(d[4 * i + 2], d[4 * i + 3]);
  }
  __syncthreads();
  op.template epilogue<Wide>(cs, t, M, N);
}

// ---------------------------------------------------------------------------
// wgmma on the same cp.async ring (K1's products with K > 32, K6's K-major
// products)
// ---------------------------------------------------------------------------
//
// The ring's stages are [rows][64] bf16 with the 16-byte chunks of row r
// XOR-swizzled by r % 8 (swz<64>): with 1024-byte aligned stages that is the
// 128-byte swizzle wgmma reads, so A and B (both K-major) feed wgmma
// descriptors directly. Each warpgroup owns 64-row blocks of the tile; per
// 16-deep step it issues one m64nBNk16 per block. The copies are made visible
// to wgmma's async proxy (fence.proxy.async) before the stage's barrier, and
// a stage's products retire before the ring refills it.

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// d (64 x N, f32) += A (64 x 16) B (16 x N), 128-byte swizzled; TA / TB:
// A is M-major / B is N-major (transposed), else K-major
template <int N, int TA = 0, int TB = 0>
__device__ __forceinline__ void wgmma_kk(float (&d)[N / 2], uint64_t da, uint64_t db) {
  static_assert(N == 128 || N == 64, "wgmma widths of the ring tile");
  if constexpr (N == 128) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, %66, %67;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "n"(TA), "n"(TB));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, %34, %35;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "n"(TA), "n"(TB));
  }
}

// mma_tile with the products on wgmma: the same ring, loads and epilogue;
// C::BM = 128, C::BN 64 or 128, whole warpgroups; smem 1024-byte aligned.
// A K-major operand is staged as mma_tile stages it ([rows][64], swz<64>:
// wgmma's 128-byte swizzle); an M- or N-major one (Op::kAK or
// Op::kBKMajor false) in 64-column blocks of [64 k-rows][64] (stage_at),
// read through transposed descriptors (8-row groups 1024 bytes apart, the
// blocks 8192 bytes apart), as wgmma_tile reads TMA's boxes.
template <class C, class Op>
__device__ __forceinline__ void wgmma_ring_tile(const Op& op, int M, int N, int K, int k_split,
                                                const Tile& t, unsigned char* smem) {
  constexpr int WG = C::kThreads / 128;      // warpgroups
  constexpr int RB = C::BM / 64 / WG;        // 64-row blocks per warpgroup
  constexpr int NA = C::BN / 2;              // accumulators per block and thread
  constexpr bool kBlocked = !(Op::kAK && Op::kBKMajor);
  constexpr int kBlock = kBK * 64;           // elements of one 64-column block
  static_assert(C::kThreads % 128 == 0 && C::BM % (64 * WG) == 0, "warpgroup tiling");
  bf16* ring = reinterpret_cast<bf16*>(smem);
  float* cs = reinterpret_cast<float*>(smem);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, wg = warp >> 2;
  const int kbeg = t.z * k_split;
  const int kend = min(K, kbeg + k_split);
  const int nk = (kend - kbeg + kBK - 1) / kBK;
  float d[RB][NA];
#pragma unroll
  for (int rb = 0; rb < RB; ++rb)
#pragma unroll
    for (int e = 0; e < NA; ++e) d[rb][e] = 0.0f;

  __syncthreads();  // the caller's shared memory (K1: its pixel table) is ready
#pragma unroll
  for (int s = 0; s < C::kStages - 1; ++s) {
    if (s < nk) {
      bf16* sa = ring + s * (C::kA + C::kB);
      load_stage<C, Op, kBlocked>(op, sa, sa + C::kA, t.m0, t.n0, kbeg + s * kBK, kend, M, N);
    }
    cp_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_wait<C::kStages - 2>();
    fence_proxy_async();
    __syncthreads();  // stage kt has landed; stage kt - 1's products have retired
    const int nxt = kt + C::kStages - 1;
    if (nxt < nk) {
      bf16* sa = ring + (nxt % C::kStages) * (C::kA + C::kB);
      load_stage<C, Op, kBlocked>(op, sa, sa + C::kA, t.m0, t.n0, kbeg + nxt * kBK, kend, M,
                                  N);
    }
    cp_commit();
    const bf16* sa = ring + (kt % C::kStages) * (C::kA + C::kB);
    const bf16* sb = sa + C::kA;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks) {
      const uint64_t db = Op::kBKMajor ? gmma_desc(sb + ks * 16, 16, 1024)
                                       : gmma_desc(sb + ks * 16 * 64, kBlock * 2, 1024);
#pragma unroll
      for (int rb = 0; rb < RB; ++rb) {
        const int blk = wg * RB + rb;
        const uint64_t da = Op::kAK ? gmma_desc(sa + blk * 64 * kBK + ks * 16, 16, 1024)
                                    : gmma_desc(sa + blk * kBlock + ks * 16 * 64, kBlock * 2,
                                                1024);
        wgmma_kk<C::BN, Op::kAK ? 0 : 1, Op::kBKMajor ? 0 : 1>(d[rb], da, db);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
  }
  cp_wait<0>();
  __syncthreads();  // the ring is consumed: the f32 tile takes its place
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int rb = 0; rb < RB; ++rb) {
    const int r = (wg * RB + rb) * 64 + (warp & 3) * 16 + g;
#pragma unroll
    for (int i = 0; i < C::BN / 8; ++i) {
      const int c = i * 8 + 2 * t4;
      *reinterpret_cast<float2*>(cs + r * C::kCS + c) = make_float2(d[rb][4 * i], d[rb][4 * i + 1]);
      *reinterpret_cast<float2*>(cs + (r + 8) * C::kCS + c) =
          make_float2(d[rb][4 * i + 2], d[rb][4 * i + 3]);
    }
  }
  __syncthreads();
  op.template epilogue<C>(cs, t, M, N);
}

// a 2-D bf16 tensor map (rows x cols, row-major) with boxes of box_cols x
// box_rows, 128-byte swizzle, zeros outside; false if the driver refuses it
inline bool tensor_map(CUtensorMap* map, const void* base, int rows, int cols, int box_cols,
                       int box_rows) {
  static PFN_cuTensorMapEncodeTiled encode = nullptr;
  if (encode == nullptr) {
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", reinterpret_cast<void**>(&encode),
                                cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return false;
  }
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t estr[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims, strides,
                box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the reduction split of a weight gradient: whole stages, so that about
// kTargetBlocks blocks run (the split depends on the shapes only)
struct KSplit {
  int splits, k_split;
};

template <class C>
KSplit ksplit(int M, int N, int K, bool split) {
  const int chunks = (K + kBK - 1) / kBK;
  int s = 1;
  if (split) {
    const int tiles = ((M + C::BM - 1) / C::BM) * ((N + C::BN - 1) / C::BN);
    s = (kTargetBlocks + tiles - 1) / tiles;
    s = s < 1 ? 1 : (s > chunks ? chunks : s);
  }
  const int per = (chunks + s - 1) / s;
  return KSplit{(chunks + per - 1) / per, per * kBK};
}

// `op` with the run width of A's loads for a contiguous axis of `ch`
// elements: 16 bytes where ch is a multiple of 8, 4 bytes where it is even,
// else elements
template <class Op>
Op run_a(Op op, int ch) {
  op.wa = ch % 8 == 0 ? 8 : (ch % 2 == 0 ? 2 : 1);
  return op;
}

template <class C>
int mtiles(int M) {
  return (M + C::BM - 1) / C::BM;
}

}  // namespace mma
}  // namespace
