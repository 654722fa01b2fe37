// Shared by the tiled GEMM and the fused 1-D and 2-D im2col convs
// (im2col_gemm.cu, rows 5, 6 and 7), the weight gradients, 1-D and 2-D
// (sliding_conv_bwd.cu, row 10; sliding_conv2d_bwd.cu, row 12) and the
// sliding convs: 1-D, fp and int8 (sliding_conv1d.cu, row 1;
// sliding_conv_quant.cu, row 13) and 2-D, fp and int8 (sliding_conv2d.cu,
// row 4; sliding_conv2d_quant.cu, row 14): a block-tiled product
//
//   C[M, N] = epilogue(sum_k A[m, k] * B[k, n])
//
// whose A comes through a gather functor and whose B is a row-major (K, N)
// matrix. build.py keys every kernel library on this header's text.
//
// Why it exists: rows 1, 4, 5, 6, 7, 10, 12, 13 and 14 are each one
// product whose reduction is the length of one operand (row 5's K, the
// weight gradients' B*oh*ow output positions, the convs' K*Cin or
// kh*kw*Cin filter taps), and their first versions summed on the CUDA
// cores from 64 x 64 tiles staged one chunk at a time, with no overlap of
// loads and math, no tensor cores for bfloat16 or int8, and no split of
// the reduction where the blocks alone leave the card idle.
//
// The design:
//   * Tiles. bfloat16 runs on the tensor cores: 128 x 128 blocks of 8
//     warps, each warp a 64 x 32 tile of mma.sync.m16n8k16 (bf16 -> f32),
//     fragments loaded by ldmatrix (.trans where the staged operand runs
//     along k's partner dimension). The products of bf16 pairs are exact
//     in float32, so the sums differ from a float32 product only in their
//     order. int8 runs on the tensor cores too: the same block and warp
//     tiles of mma.sync.m16n8k32 (s8 x s8 -> s32), 64 reduction elements
//     a chunk, exact int32 sums. float32 stays on the CUDA cores (no
//     TF32): 8 x 8 register tiles a thread, 16-byte shared-memory reads,
//     a 128 x 128 block or, where N <= 32, a 128 x 32 one so that a
//     32-wide N idles no lanes.
//   * Staging. A ring of STAGES shared-memory stages (4 for the tensor
//     cores, 3 for float32) filled by cp.async: the loads of chunk c +
//     STAGES - 1 are in flight while chunk c is multiplied, one
//     __syncthreads a chunk. A is copied in pieces of the width its
//     alignment allows (16, 8 or 4 bytes by cp.async; 2 or 1 by plain
//     loads held in registers across the products of the chunk ahead;
//     one kernel instance a width), neighbouring threads on neighbouring
//     addresses,
//     B in 16-byte slots where it allows them: the wrapper works the
//     widths out from the pointers and strides, so no operand is padded
//     in device memory. int8 weight codes reach a stage through
//     registers, held the same way: widened to the stage's type for the bf16 and float32
//     tiles (w8a16; cp.async cannot convert), and for the int8 tile
//     transposed with __byte_perm into an [n][k] stage, since the s8
//     fragment wants four k values a register and ldmatrix.trans moves
//     16-bit elements only. Rows, columns and reduction elements past M,
//     N and K stage as zeros and store nothing.
//   * A's two layouts. Where A runs along k in memory (Gather::kMajor:
//     row 5's row-major matrix; rows 1, 4, 13 and 14, where an output
//     position's filter row is one run of kw*Cin values of x in NLC or
//     NHWC, the paper's vector slide; rows 6 and 7, the same runs copied
//     a tap at a time) a stage holds A as [m][k]; where it runs along m
//     (rows 10 and 12: a filter row's (tap, channel) run) as [k][m]. A
//     thread keeps the row keys of the values of m it stages in registers
//     for the whole block: always for [k][m] stages, for [m][k] ones where
//     a key costs divisions (Gather::kCacheRows: the convs); row 5's key,
//     m itself, is formed at each copy.
//   * Split-K. Blocks are (M tiles, N tiles, splits); split z walks chunks
//     [z * per, min((z + 1) * per, chunks)) of BK reduction elements.
//     The split count and the tile are the wrapper's choice
//     (gemm_plan.py), sized from the card's SM count.
//   * The epilogue, a functor, runs once an output: in the block's store
//     with one split; with more, each split writes its partials (float32,
//     int32 on the int8 tile) to the caller's workspace and
//     reduce_splits adds them in split order before it: no atomics, so a
//     result is the same from run to run. Store (a cast to C's type) is
//     rows 5, 6, 7, 10 and 12's; BiasAct (bias, activation, the post-bias
//     z) rows 1 and 4's; Dequant (dequant, bias, activation, requant or
//     cast) rows 13 and 14's.
//   * An optional column sum of B (the weight gradients' bias gradient,
//     db[n] = sum_k B[k, n]) is taken by the blocks of the first M tile
//     from the stages they hold anyway.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

#include "conv_epilogue.cuh"
#include "cp_async.cuh"

namespace {
namespace gm {

template <typename TO, typename V>
__device__ __forceinline__ TO cast_to(V v) {
  if constexpr (std::is_same<TO, V>::value)
    return v;
  else
    return from_f32<TO>(v);
}

// two neighbouring outputs (n, n + 1) of a row-major C, one store where
// both exist and the pair is aligned (N even)
template <typename TO, typename V>
__device__ __forceinline__ void store_pair(TO* out, size_t idx, int n, int N,
                                           V v0, V v1) {
  if (n + 1 < N && N % 2 == 0) {
    if constexpr (std::is_same<TO, __nv_bfloat16>::value)
      *reinterpret_cast<__nv_bfloat162*>(out + idx) =
          __floats2bfloat162_rn(v0, v1);
    else if constexpr (std::is_same<TO, float>::value)
      *reinterpret_cast<float2*>(out + idx) = make_float2(v0, v1);
    else
      *reinterpret_cast<int2*>(out + idx) = make_int2(v0, v1);
  } else {
    if (n < N) out[idx] = cast_to<TO>(v0);
    if (n + 1 < N) out[idx + 1] = cast_to<TO>(v1);
  }
}

// The epilogue that only casts: C in TO (rows 5 and 12), and the splits'
// partials. An epilogue takes one output, one(i, n, v), or two
// neighbours, pair(i, n, v0, v1) (v1 is past the edge where n + 1 >= N):
// i is the output's index in the row-major C, n its column.
template <typename TO>
struct Store {
  TO* c;
  int N;
  template <typename V>
  __device__ void one(size_t i, int, V v) const {
    c[i] = cast_to<TO>(v);
  }
  template <typename V>
  __device__ void pair(size_t i, int n, V v0, V v1) const {
    store_pair(c, i, n, N, v0, v1);
  }
};

// The fp sliding convs' epilogue (rows 1 and 4): y = act(sum + bias) and,
// where z is not null, z = sum + bias (the post-bias pre-activation the
// backward pass forms dz = dy * act'(z) from), both in T. bias may be
// null.
template <typename T>
struct BiasAct {
  T* y;
  T* z;
  const float* bias;
  int N, act;
  __device__ void one(size_t i, int n, float v) const {
    if (bias != nullptr) v += bias[n];
    if (z != nullptr) z[i] = from_f32<T>(v);
    y[i] = from_f32<T>(activate(v, act));
  }
  __device__ void pair(size_t i, int n, float v0, float v1) const {
    if (bias != nullptr) {
      if (n < N) v0 += bias[n];
      if (n + 1 < N) v1 += bias[n + 1];
    }
    if (z != nullptr) store_pair(z, i, n, N, v0, v1);
    store_pair(y, i, n, N, activate(v0, act), activate(v1, act));
  }
};

// The int8 convs' epilogue (rows 13 and 14): store_out on each output,
// dequant by s[n], bias, activation, then int8 on the out_scale grid, or
// float32 / bfloat16. The sum is int32 on the int8 tile (w8a8, exact) and
// float32 on the others (w8a16).
__device__ __forceinline__ float sum_f32(int v) { return __int2float_rn(v); }
__device__ __forceinline__ float sum_f32(float v) { return v; }

struct Dequant {
  void* y;
  const float* s;
  const float* bias;
  const float* out_scale;
  int N, act, y_kind;
  template <typename V>
  __device__ void one(size_t i, int n, V v) const {
    store_out(y, i, sum_f32(v), s[n], bias, n, act, out_scale, y_kind);
  }
  template <typename V>
  __device__ void pair(size_t i, int n, V v0, V v1) const {
    if (n < N) one(i, n, v0);
    if (n + 1 < N) one(i + 1, n + 1, v1);
  }
};

// out = epi(the sum over s = 0 .. S-1 of ws[s * n + i], in that order)
template <typename V, class Epi>
__global__ void reduce_splits(const V* __restrict__ ws, Epi epi, size_t n,
                              int N, int S) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    V v = 0;
    for (int s = 0; s < S; ++s) v += ws[(size_t)s * n + i];
    epi.one(i, (int)(i % (size_t)N), v);
  }
}

// n / d for 0 <= n < 2^31 by a multiply and a shift (the round-up
// method): mul = ceil(2^p / d), p = 31 + ceil(log2 d). A gather divides
// every reduction index it stages.
struct FastDiv {
  int d;
  unsigned mul, shr;
  FastDiv() = default;
  explicit FastDiv(int d_) : d(d_), mul(0), shr(0) {
    if (d > 1) {
      int l = 0;
      while ((1LL << l) < d) ++l;
      mul = (unsigned)(((1ULL << (31 + l)) + d - 1) / d);
      shr = (unsigned)(l - 1);
    }
  }
  __device__ __forceinline__ int div(int n) const {
    return d == 1 ? n : (int)(__umulhi((unsigned)n, mul) >> shr);
  }
};

// A[p, k] of the VALID 2-D sliding conv over x (B, H, W, Cin) NHWC (rows
// 4 and 14): p = (b, oy, ox) an output position, k = i * kw*Cin + r the
// flat HWIO filter index (i the filter row, r = j * Cin + c), so that
//   A[p, k] = x[at(row(p)) + col(k)].
// In NHWC a position's kw*Cin values of filter row i are one contiguous
// run of x, so the stage along k is a series of runs. row(p) is the
// position's first input pixel, (b*H + oy*sh)*W + ox*sw (< B*H*W, which
// the entry bounds by INT_MAX). The 1-D convs (rows 1 and 13) are the case
// H = oh = kh = 1, x (B, L, Cin) NLC read as (B, 1, L, Cin): a position's
// whole K*Cin column is one run.
struct ConvPositions {
  static constexpr bool kMajor = true, kCacheRows = true;
  int H, W, Cin, sh, sw;
  FastDiv img, ow, kwc;  // oh*ow positions an image, ow a row; kw*Cin
  __device__ int row(int p) const {
    const int b = img.div(p), rem = p - b * img.d;
    const int oy = ow.div(rem), ox = rem - oy * ow.d;
    return (b * H + oy * sh) * W + ox * sw;
  }
  __device__ long long at(int pix) const { return (long long)pix * Cin; }
  __device__ long long col(int k) const {
    const int i = kwc.div(k);
    return (long long)i * W * Cin + (k - i * kwc.d);
  }
};

// the shape checks of the convs' C entries (rows 1, 4, 6, 7, 13 and 14;
// the 1-D ones at H = oh = kh = 1): a filter within the input, and every
// index the kernel forms within an int
inline bool conv_shape_ok(int B, int H, int W, int Cin, int Cout, int kh,
                          int kw, int sh, int sw, int oh, int ow) {
  return B >= 1 && Cin >= 1 && Cout >= 1 && kh >= 1 && kw >= 1 && sh >= 1 &&
         sw >= 1 && oh >= 1 && ow >= 1 &&
         (long long)(oh - 1) * sh + kh <= H &&
         (long long)(ow - 1) * sw + kw <= W &&
         (long long)B * H * W <= INT_MAX &&
         (long long)B * oh * ow <= INT_MAX - 128 &&
         (long long)kh * kw * Cin <= INT_MAX - 128;
}

inline ConvPositions conv_positions(int H, int W, int Cin, int kw, int sh,
                                    int sw, int oh, int ow) {
  return ConvPositions{H, W, Cin, sh, sw, FastDiv(oh * ow), FastDiv(ow),
                       FastDiv(kw * Cin)};
}

// A[m, p] of the weight gradients' product (rows 10 and 12), dw[m, n] =
// sum_p A[m, p] * dz[p, n]: m = i * kw*Cin + r the flat HWIO filter index
// (i the filter row, r = j * Cin + c), p = (b, oy, ox) an output position,
//   A[m, p] = x[row(m) + col(p)].
// In NHWC filter row i's kw*Cin values at a position are one contiguous
// run of x, so a stage along m is a series of runs. The 1-D gradient (row
// 10) is the case H = oh = kh = 1, x (B, L, Cin) NLC read as (B, 1, L,
// Cin): row(m) = m, col(p) = (b*L + t*stride)*Cin.
struct FilterRuns {
  static constexpr bool kMajor = false;
  int H, W, Cin, sh, sw;
  int kwc;             // kw * Cin: one filter row's run
  FastDiv img, ow;     // oh * ow positions an image, ow a row
  __device__ int row(int m) const {  // < kh * W * Cin <= INT_MAX
    const int i = m / kwc;
    return i * W * Cin + (m - i * kwc);
  }
  __device__ long long col(int p) const {
    const int b = img.div(p), rem = p - b * img.d;
    const int oy = ow.div(rem), ox = rem - oy * ow.d;
    return (((long long)b * H + (long long)oy * sh) * W + (long long)ox * sw) *
           Cin;
  }
};

// the shape checks of the weight gradients' C entries (rows 10 and 12;
// the 1-D one at H = oh = kh = 1): a filter within the input, and every
// index the kernel forms within an int
inline bool dw_shape_ok(int B, int H, int W, int Cin, int Cout, int kh,
                        int kw, int sh, int sw, int oh, int ow) {
  return B >= 1 && Cin >= 1 && Cout >= 1 && kh >= 1 && kw >= 1 && sh >= 1 &&
         sw >= 1 && oh >= 1 && ow >= 1 &&
         (long long)(oh - 1) * sh + kh <= H &&
         (long long)(ow - 1) * sw + kw <= W &&
         (long long)kh * W * Cin <= INT_MAX &&
         (long long)B * oh * ow <= INT_MAX - 128;
}

inline FilterRuns filter_runs(int H, int W, int Cin, int kw, int sh, int sw,
                              int oh, int ow) {
  return FilterRuns{H, W, Cin, sh, sw, kw * Cin, FastDiv(oh * ow),
                    FastDiv(ow)};
}

// ---------------------------------------------------------------------------
// float32 on the CUDA cores: an 8 x 8 register tile a thread
// ---------------------------------------------------------------------------

// BM x BN blocks, a thread an 8 x 8 tile; MIN_BLOCKS of them share an SM
template <int BM_, int BN_, int MIN_BLOCKS_>
struct Simt {
  static constexpr int BM = BM_, BN = BN_, BK = 16, TN = 8;
  static constexpr int THREADS = (BM / 8) * (BN / TN);
  static constexpr int STAGES = 3, MIN_BLOCKS = MIN_BLOCKS_;
  static constexpr int PAD_A = 4, PAD_B = 4;  // floats: 16-byte rows
  static constexpr int NQ = TN / 4;           // float4 groups along n
  static constexpr bool kBnk = false;         // B staged as [k][n]
  using AccT = float;
  struct Acc {
    float v[8][TN];
  };

  // the thread's accumulator row i and column j within the block tile:
  // [m][k] stages are read a row a float4 (rows BM/8 apart, conflict
  // free at the padded pitch); [k][m] ones two float4 along m
  template <bool KM>
  __device__ static int row(int i) {
    const int tm = threadIdx.x / (BN / TN);
    return KM ? tm + i * (BM / 8) : tm * 4 + (i & 3) + (i >> 2) * (BM / 2);
  }
  __device__ static int col(int j) {
    const int tn = threadIdx.x % (BN / TN);
    return (j >> 2) * (BN / NQ) + tn * 4 + (j & 3);
  }

  __device__ static void b_row(float (&bv)[TN], const float* bs) {
    const int tn = threadIdx.x % (BN / TN);
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const float4 b4 =
          *reinterpret_cast<const float4*>(bs + q * (BN / NQ) + tn * 4);
      bv[4 * q] = b4.x;
      bv[4 * q + 1] = b4.y;
      bv[4 * q + 2] = b4.z;
      bv[4 * q + 3] = b4.w;
    }
  }

  template <bool KM, int LDA, int LDB>
  __device__ static void mac(Acc& acc, const float* __restrict__ as,
                             const float* __restrict__ bs) {
    const int tm = threadIdx.x / (BN / TN);
    if constexpr (KM) {
#pragma unroll
      for (int kq = 0; kq < BK; kq += 4) {
        float4 a4[8];
#pragma unroll
        for (int i = 0; i < 8; ++i)
          a4[i] = *reinterpret_cast<const float4*>(
              as + (tm + i * (BM / 8)) * LDA + kq);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          float bv[TN];
          b_row(bv, bs + (kq + kk) * LDB);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const float av = reinterpret_cast<const float*>(&a4[i])[kk];
#pragma unroll
            for (int j = 0; j < TN; ++j)
              acc.v[i][j] = fmaf(av, bv[j], acc.v[i][j]);
          }
        }
      }
    } else {
#pragma unroll
      for (int k = 0; k < BK; ++k) {
        const float4 a0 =
            *reinterpret_cast<const float4*>(as + k * LDA + tm * 4);
        const float4 a1 =
            *reinterpret_cast<const float4*>(as + k * LDA + BM / 2 + tm * 4);
        const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        float bv[TN];
        b_row(bv, bs + k * LDB);
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j)
            acc.v[i][j] = fmaf(av[i], bv[j], acc.v[i][j]);
      }
    }
  }

  template <bool KM, class Out>
  __device__ static void store(const Acc& acc, const Out& out, int M, int N,
                               int m0, int n0) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int m = m0 + row<KM>(i);
      if (m >= M) continue;
#pragma unroll
      for (int j = 0; j < TN; j += 2) {
        const int n = n0 + col(j);
        out.pair((size_t)m * N + n, n, acc.v[i][j], acc.v[i][j + 1]);
      }
    }
  }
};

// ---------------------------------------------------------------------------
// bfloat16 and int8 on the tensor cores: mma.sync m16n8k16, m16n8k32
// ---------------------------------------------------------------------------

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const unsigned (&a)[4],
                                       unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// BM x BN blocks of WARPS_M x WARPS_N warps, each warp a (BM / WARPS_M) x
// (BN / WARPS_N) tile of m16n8 products; V the accumulators' type
template <int BM_, int BN_, int BK_, int WARPS_M_, int WARPS_N_, int STAGES_,
          int MIN_BLOCKS_, typename V>
struct MmaWarps {
  static constexpr int BM = BM_, BN = BN_, BK = BK_;
  static constexpr int WARPS_M = WARPS_M_, WARPS_N = WARPS_N_;
  static constexpr int THREADS = 32 * WARPS_M * WARPS_N;
  static constexpr int STAGES = STAGES_, MIN_BLOCKS = MIN_BLOCKS_;
  static constexpr int WTM = BM / WARPS_M, WTN = BN / WARPS_N;
  static constexpr int MI = WTM / 16, NJ = WTN / 8;
  static_assert(MI >= 1 && NJ % 2 == 0, "warp tile");
  using AccT = V;
  struct Acc {
    V v[MI][NJ][4];  // [m16 block][n8 block][fragment]
  };

  // fragment h * 2 + e of n8 block j holds row (lane / 4) + 8h and column
  // (lane % 4) * 2 + e of its 16 x 8 tile, for both products
  template <bool KM, class Out>
  __device__ static void store(const Acc& acc, const Out& out, int M, int N,
                               int m0, int n0) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int wm = (warp / WARPS_N) * WTM, wn = (warp % WARPS_N) * WTN;
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm + i * 16 + (lane >> 2) + 8 * h;
        if (m >= M) continue;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int n = n0 + wn + j * 8 + (lane & 3) * 2;
          out.pair((size_t)m * N + n, n, acc.v[i][j][2 * h],
                   acc.v[i][j][2 * h + 1]);
        }
      }
  }
};

// bfloat16: m16n8k16, A and B staged as bf16, B as [k][n]
template <int BM, int BN, int BK, int WARPS_M, int WARPS_N, int STAGES,
          int MIN_BLOCKS>
struct Mma
    : MmaWarps<BM, BN, BK, WARPS_M, WARPS_N, STAGES, MIN_BLOCKS, float> {
  using Base = MmaWarps<BM, BN, BK, WARPS_M, WARPS_N, STAGES, MIN_BLOCKS,
                        float>;
  using typename Base::Acc;
  static_assert(BK % 16 == 0, "chunk");
  static constexpr int PAD_A = 8, PAD_B = 8;  // bf16: 16 bytes a row, so
                                              // ldmatrix's 8 rows miss
                                              // each other's banks
  static constexpr bool kBnk = false;

  template <bool KM, int LDA, int LDB>
  __device__ static void mac(Acc& acc, const __nv_bfloat16* __restrict__ as,
                             const __nv_bfloat16* __restrict__ bs) {
    constexpr int MI = Base::MI, NJ = Base::NJ;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int wm = (warp / WARPS_N) * Base::WTM;
    const int wn = (warp % WARPS_N) * Base::WTN;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      unsigned af[MI][4], bf[NJ][2];
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        if constexpr (KM)  // [m][k]: rows m, 8 k values each
          ldsm_x4(af[i], as + (wm + i * 16 + (lane & 15)) * LDA + kk +
                             (lane >> 4) * 8);
        else  // [k][m]: rows k, transposed into the row-major fragment
          ldsm_x4_t(af[i], as + (kk + (lane & 7) + (lane >> 4) * 8) * LDA +
                               wm + i * 16 + ((lane >> 3) & 1) * 8);
      }
#pragma unroll
      for (int j2 = 0; j2 < NJ / 2; ++j2) {
        unsigned r[4];
        ldsm_x4_t(r, bs + (kk + (lane & 15)) * LDB + wn + j2 * 16 +
                         (lane >> 4) * 8);
        bf[2 * j2][0] = r[0];
        bf[2 * j2][1] = r[1];
        bf[2 * j2 + 1][0] = r[2];
        bf[2 * j2 + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j)
          mma_bf16(acc.v[i][j], af[i], bf[j][0], bf[j][1]);
    }
  }
};

// int8: m16n8k32, A staged as [m][k] and B as [n][k], 32 codes of k a
// row piece. Both fragments are then ldmatrix's non-transposed 8 x 8
// matrices of 16-bit pairs: a register holds 4 codes along k, as the s8
// product wants.
template <int BM, int BN, int BK, int WARPS_M, int WARPS_N, int STAGES,
          int MIN_BLOCKS>
struct MmaS8
    : MmaWarps<BM, BN, BK, WARPS_M, WARPS_N, STAGES, MIN_BLOCKS, int> {
  using Base = MmaWarps<BM, BN, BK, WARPS_M, WARPS_N, STAGES, MIN_BLOCKS,
                        int>;
  using typename Base::Acc;
  static_assert(BK % 32 == 0, "chunk");
  static constexpr int PAD_A = 16, PAD_B = 16;  // bytes: as the bf16 tile
  static constexpr bool kBnk = true;            // B staged as [n][k]

  template <bool KM, int LDA, int LDB>
  __device__ static void mac(Acc& acc, const int8_t* __restrict__ as,
                             const int8_t* __restrict__ bs) {
    static_assert(KM, "the int8 tile stages A as [m][k]");
    constexpr int MI = Base::MI, NJ = Base::NJ;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int wm = (warp / WARPS_N) * Base::WTM;
    const int wn = (warp % WARPS_N) * Base::WTN;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      unsigned af[MI][4], bf[NJ][2];
#pragma unroll
      for (int i = 0; i < MI; ++i)  // rows m, k pieces kk and kk + 16
        ldsm_x4(af[i], as + (wm + i * 16 + (lane & 15)) * LDA + kk +
                           (lane >> 4) * 16);
#pragma unroll
      for (int j2 = 0; j2 < NJ / 2; ++j2) {  // rows n, the same k pieces
        unsigned r[4];
        ldsm_x4(r, bs + (wn + j2 * 16 + (lane & 7) + (lane >> 4) * 8) * LDB +
                       kk + ((lane >> 3) & 1) * 16);
        bf[2 * j2][0] = r[0];
        bf[2 * j2][1] = r[1];
        bf[2 * j2 + 1][0] = r[2];
        bf[2 * j2 + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j)
          mma_s8(acc.v[i][j], af[i], bf[j][0], bf[j][1]);
    }
  }
};

// tile ids of the C entries (gemm_plan.py's TILES): the bf16 tensor-core
// tile, float32 128 x 128, float32 128 x 32 (N <= 32), the int8
// tensor-core tile
enum TileId { TILE_MMA = 0, TILE_WIDE = 1, TILE_NARROW = 2, TILE_INT8 = 3 };
using MmaTile = Mma<128, 128, 32, 2, 4, 4, 2>;
using Wide = Simt<128, 128, 2>;
using Narrow = Simt<128, 32, 6>;
using Int8Tile = MmaS8<128, 128, 64, 2, 4, 4, 2>;

template <class Tile, class Gather>
__host__ __device__ constexpr int lda() {
  return Gather::kMajor ? Tile::BK + Tile::PAD_A : Tile::BM + Tile::PAD_A;
}

template <class Tile>
__host__ __device__ constexpr int ldb() {
  return Tile::kBnk ? Tile::BK + Tile::PAD_B : Tile::BN + Tile::PAD_B;
}

template <class Tile, typename T, class Gather>
constexpr size_t smem_bytes() {
  constexpr int a_elems = Gather::kMajor ? Tile::BM * lda<Tile, Gather>()
                                         : Tile::BK * lda<Tile, Gather>();
  constexpr int b_elems =
      Tile::kBnk ? Tile::BN * ldb<Tile>() : Tile::BK * ldb<Tile>();
  return Tile::STAGES * (size_t)(a_elems + b_elems) * sizeof(T);
}

// four int8 codes b[k, n .. n + 3] as one word, zeros past K and N; vb >=
// 4 (N a multiple of 4, b word-aligned) reads the word at once
__device__ __forceinline__ unsigned code_word(const int8_t* __restrict__ b,
                                              int k, int n, int K, int N,
                                              int vb) {
  if (k >= K || n >= N) return 0u;
  const int8_t* p = b + (size_t)k * N + n;
  if (vb >= 4) return *reinterpret_cast<const unsigned*>(p);
  unsigned w = 0u;
#pragma unroll
  for (int t = 0; t < 4; ++t)
    if (n + t < N) w |= (unsigned)(uint8_t)p[t] << (8 * t);
  return w;
}

__device__ __forceinline__ float code(unsigned w, int t) {
  return (float)(int8_t)(uint8_t)(w >> (8 * t));
}

// four codes widened into a [k][n] stage of T (n 4-aligned)
__device__ __forceinline__ void widen4(float* dst, unsigned w) {
  *reinterpret_cast<float4*>(dst) =
      make_float4(code(w, 0), code(w, 1), code(w, 2), code(w, 3));
}
__device__ __forceinline__ void widen4(__nv_bfloat16* dst, unsigned w) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(code(w, 0), code(w, 1));
  __nv_bfloat162 hi = __floats2bfloat162_rn(code(w, 2), code(w, 3));
  uint2 u;
  u.x = *reinterpret_cast<unsigned*>(&lo);
  u.y = *reinterpret_cast<unsigned*>(&hi);
  *reinterpret_cast<uint2*>(dst) = u;
}

template <int BYTES>
using Bits = typename std::conditional<BYTES == 1, uint8_t, uint16_t>::type;

// whether a thread keeps its rows' keys for the block: always for [k][m]
// stages, for [m][k] ones as the gather says
template <class Gather>
__host__ __device__ constexpr bool cache_rows() {
  if constexpr (Gather::kMajor)
    return Gather::kCacheRows;
  else
    return true;
}

// grid (M tiles, N tiles, splits). epi: the epilogue (one split); ws: the
// splits' partials in Tile::AccT, split z's at ws + z * M * N (more than
// one); db (may be null): the column sums of B, split z's at db + z * N.
// VA, vb: the bytes a copy of A and of B moves (the wrapper's choice). B
// is of A's type T, or int8 codes (TB = int8_t).
template <int VA, class Tile, typename T, typename TB, class Gather,
          class Epi>
__global__ void __launch_bounds__(Tile::THREADS, Tile::MIN_BLOCKS)
gemm_kernel(const T* __restrict__ a, const TB* __restrict__ b, Epi epi,
            void* __restrict__ ws, float* __restrict__ db, int M, int N,
            int K, Gather g, int vb, int per) {
  constexpr bool KM = Gather::kMajor;
  constexpr bool B_SAME = std::is_same<TB, T>::value && !Tile::kBnk;
  static_assert(B_SAME || std::is_same<TB, int8_t>::value, "B's type");
  static_assert(KM || !Tile::kBnk, "the int8 tile stages A as [m][k]");
  using AccT = typename Tile::AccT;
  constexpr int BM = Tile::BM, BN = Tile::BN, BK = Tile::BK;
  constexpr int NT = Tile::THREADS, STAGES = Tile::STAGES;
  constexpr int SE = 16 / sizeof(T);  // elements in a 16-byte slot
  constexpr int EA = VA / sizeof(T);  // elements in a copy of A
  constexpr int LDA = lda<Tile, Gather>();
  constexpr int LDB = ldb<Tile>();
  constexpr int A_ELEMS = KM ? BM * LDA : BK * LDA;
  constexpr int B_ELEMS = Tile::kBnk ? BN * LDB : BK * LDB;
  constexpr int A_COPIES = BM * BK / EA / NT;  // copies of A a thread
  constexpr int B_SLOTS = BK * BN / SE / NT;   // B of A's type
  constexpr int B_WORDS = BK * BN / 4 / NT;    // int8 B, 4 codes a word
  // [k][m] stages: P threads side by side copy one k row's run of m, at
  // most 32 bytes (a sector) an instruction
  constexpr int P = 32 / VA < NT / BK ? 32 / VA : NT / BK;
  static_assert(EA >= 1 && A_COPIES >= 1 && B_SLOTS >= 1 && B_WORDS >= 1 &&
                    NT % (BK / EA) == 0 && (KM || (BM / EA) % P == 0),
                "a stage's copies spread evenly over the threads");
  extern __shared__ __align__(16) unsigned char smem[];
  T* As = reinterpret_cast<T*>(smem);
  T* Bs = As + STAGES * A_ELEMS;

  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN, split = blockIdx.z;
  const int tid = threadIdx.x;
  const int nk = (K + BK - 1) / BK;
  const int kc0 = split * per, kc1 = min(nk, kc0 + per);

  // A's copies, VA bytes each, neighbouring threads on neighbouring
  // addresses, and the keys of their rows (fixed for the block), -1 past
  // M. [m][k] stages: copy c of a thread is row (tid + NT*c) / (BK/EA) at
  // k offset (tid % (BK/EA)) * EA, so the gather's col() runs once a
  // chunk. [k][m] stages: a thread's copies share k row (tid / P) % BK,
  // and copy c takes the (tid % P + P * ((tid + NT*c) / (P*BK)))-th run of
  // EA values along m.
  constexpr bool CACHE = cache_rows<Gather>();
  using Key = decltype(g.row(0));
  auto row_of = [&](int c) -> int {  // the m of copy c's first value
    return KM ? m0 + (tid + NT * c) / (BK / EA)
              : m0 + (tid % P + P * ((tid + NT * c) / (P * BK))) * EA;
  };
  Key ro[CACHE ? A_COPIES : 1];
  if constexpr (CACHE) {
#pragma unroll
    for (int c = 0; c < A_COPIES; ++c) {
      const int m = row_of(c);
      ro[c] = m < M ? g.row(m) : (Key)-1;
    }
  }
  // [m][k] stages: copy c's source, and whether it lies within A (kin: its
  // k < K; ck = col(k))
  auto a_src = [&](int c, bool kin, long long ck, bool& ok) -> const T* {
    if constexpr (!KM) {
      ok = false;
      return a;
    } else if constexpr (CACHE) {
      ok = kin && ro[c] >= 0;
      return a + g.at(ro[c]) + ck;
    } else {
      const int m = row_of(c);
      ok = kin && m < M;
      return a + g.at(g.row(m)) + ck;
    }
  };

  // stage_in() starts a chunk's copies: every cp.async, and fetches of the
  // pieces that go by plain loads (A's under cp.async's 4 bytes, one
  // register a piece: packing pieces into words cost more than it saved;
  // int8 B codes) into registers, held there across the products of the
  // chunk ahead, which hide the loads' latency; put_a() and put_b() then
  // store them to their stage.
  constexpr bool A_PLAIN = KM && VA < 4;
  constexpr bool B_REG = !B_SAME;
  // int8 B into an [n][k] stage: pieces of 4 k x 4 n a lane, a warp's 16 k
  // x 32 n at a time
  constexpr int PIECES = BK * BN / (16 * 32) / (NT / 32);
  constexpr int HB = !B_REG ? 1 : Tile::kBnk ? 4 * PIECES : B_WORDS;
  unsigned hb[HB];
  Bits<VA < 4 ? VA : 2> ha[A_PLAIN ? A_COPIES : 1];
  auto put_a = [&](int st) {  // A's plain pieces from ha into stage st
    if constexpr (A_PLAIN) {
      T* as = As + st * A_ELEMS;
      const int kq = (tid % (BK / EA)) * EA;
#pragma unroll
      for (int c = 0; c < A_COPIES; ++c)
        *reinterpret_cast<Bits<VA>*>(as + ((tid + NT * c) / (BK / EA)) * LDA +
                                     kq) = ha[c];
    }
  };

  auto put_b = [&](int st) {  // int8 codes from hb into stage st
    T* bs = Bs + st * B_ELEMS;
    if constexpr (B_REG && Tile::kBnk) {
      // each piece transposed into four words along k. The lane stores
      // them in the order rotated by lane / 8, so each of the four stores
      // lands the warp's 32 words in 32 banks at the stage's 80-byte
      // pitch.
      const int lane = tid & 31, warp = tid >> 5, rot = lane >> 3;
#pragma unroll
      for (int s = 0; s < PIECES; ++s) {
        const int t = warp + (NT / 32) * s;
        const int kr = (t / (BN / 32)) * 16 + (lane & 3) * 4;
        const int nr = (t % (BN / 32)) * 32 + (lane >> 2) * 4;
        const unsigned* w = hb + 4 * s;
        const unsigned lo01 = __byte_perm(w[0], w[1], 0x5140);
        const unsigned hi01 = __byte_perm(w[0], w[1], 0x7362);
        const unsigned lo23 = __byte_perm(w[2], w[3], 0x5140);
        const unsigned hi23 = __byte_perm(w[2], w[3], 0x7362);
        // o[j]: codes k .. k + 3 of column nr + j
        const unsigned o[4] = {__byte_perm(lo01, lo23, 0x5410),
                               __byte_perm(lo01, lo23, 0x7632),
                               __byte_perm(hi01, hi23, 0x5410),
                               __byte_perm(hi01, hi23, 0x7632)};
        unsigned x[4], y[4];  // y[r] = o[(r + rot) % 4]
#pragma unroll
        for (int r = 0; r < 4; ++r) x[r] = (rot & 1) ? o[(r + 1) & 3] : o[r];
#pragma unroll
        for (int r = 0; r < 4; ++r) y[r] = (rot & 2) ? x[(r + 2) & 3] : x[r];
#pragma unroll
        for (int r = 0; r < 4; ++r)
          *reinterpret_cast<unsigned*>(bs + (nr + ((r + rot) & 3)) * LDB +
                                       kr) = y[r];
      }
    } else if constexpr (B_REG) {  // widened into the [k][n] stage of T
#pragma unroll
      for (int s = 0; s < B_WORDS; ++s) {
        const int v = tid + NT * s;
        widen4(bs + (v / (BN / 4)) * LDB + (v % (BN / 4)) * 4, hb[s]);
      }
    }
  };


  auto stage_in = [&](int st, int kc) {
    const int k0 = kc * BK;
    T* as = As + st * A_ELEMS;
    T* bs = Bs + st * B_ELEMS;
    const int kq = (tid % (BK / EA)) * EA;  // [m][k] stages
    if constexpr (KM) {
      const int k = k0 + kq;
      const long long ck = g.col(k);
      if constexpr (VA >= 4) {
#pragma unroll
        for (int c = 0; c < A_COPIES; ++c) {
          const int r = (tid + NT * c) / (BK / EA);
          bool ok;
          const T* src = a_src(c, k < K, ck, ok);
          copy_in<VA>(as + r * LDA + kq, ok ? src : a, ok);
        }
      } else {
#pragma unroll
        for (int c = 0; c < A_COPIES; ++c) {
          bool ok;
          const T* src = a_src(c, k < K, ck, ok);
          ha[c] = ok ? *reinterpret_cast<const Bits<VA>*>(src) : (Bits<VA>)0;
        }
      }
    } else {
      const int kr = (tid / P) % BK, k = k0 + kr;
      const long long base = k < K ? g.col(k) : -1;
      T* row = as + kr * LDA;
#pragma unroll
      for (int c = 0; c < A_COPIES; ++c) {
        const int mq = (tid % P + P * ((tid + NT * c) / (P * BK))) * EA;
        const bool ok = base >= 0 && ro[c] >= 0;
        copy_in<VA>(row + mq, ok ? a + base + ro[c] : a, ok);
      }
    }
    if constexpr (B_SAME) {
      const int eb = vb / (int)sizeof(T);
#pragma unroll
      for (int s = 0; s < B_SLOTS; ++s) {
        const int v = tid + NT * s;
        const int kr = v / (BN / SE), nq = (v % (BN / SE)) * SE;
        const int k = k0 + kr;
        T* dst = bs + kr * LDB + nq;
        for (int u = 0; u < SE; u += eb) {
          const int n = n0 + nq + u;
          const bool ok = k < K && n < N;
          copy_in(dst + u, ok ? b + (size_t)k * N + n : b, vb, ok);
        }
      }
    } else if constexpr (Tile::kBnk) {
      // a lane's piece (lane % 4: k, lane / 4: n): four words along n,
      // read by the warp as whole sectors
      const int lane = tid & 31, warp = tid >> 5;
#pragma unroll
      for (int s = 0; s < PIECES; ++s) {
        const int t = warp + (NT / 32) * s;
        const int kr = (t / (BN / 32)) * 16 + (lane & 3) * 4;
        const int nr = (t % (BN / 32)) * 32 + (lane >> 2) * 4;
#pragma unroll
        for (int q = 0; q < 4; ++q)
          hb[4 * s + q] = code_word(b, k0 + kr + q, n0 + nr, K, N, vb);
      }
    } else {  // a word of four codes along n a piece
#pragma unroll
      for (int s = 0; s < B_WORDS; ++s) {
        const int v = tid + NT * s;
        hb[s] = code_word(b, k0 + v / (BN / 4), n0 + (v % (BN / 4)) * 4, K,
                          N, vb);
      }
    }
  };

  typename Tile::Acc acc;
  {
    AccT* p = reinterpret_cast<AccT*>(&acc);
#pragma unroll
    for (int i = 0; i < (int)(sizeof(acc) / sizeof(AccT)); ++i) p[i] = 0;
  }
  const bool does_db = db != nullptr && blockIdx.x == 0 && tid < BN;
  float dbs = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (kc0 + s < kc1) {
      stage_in(s, kc0 + s);
      put_a(s);
      if constexpr (B_REG) put_b(s);
    }
    cp_commit();
  }
  for (int kc = kc0; kc < kc1; ++kc) {
    cp_wait<STAGES - 2>();  // chunk kc has landed (this thread's copies)
    __syncthreads();        // ... everyone's; the oldest stage is free
    const int i = kc - kc0, next = (i + STAGES - 1) % STAGES;
    const bool more = kc + STAGES - 1 < kc1;
    if (more) stage_in(next, kc + STAGES - 1);
    cp_commit();
    const T* as = As + (i % STAGES) * A_ELEMS;
    const T* bs = Bs + (i % STAGES) * B_ELEMS;
    if constexpr (B_SAME)
      if (does_db)
        for (int r = 0; r < BK; ++r) dbs += to_f32(bs[r * LDB + tid]);
    Tile::template mac<KM, LDA, LDB>(acc, as, bs);
    if (more) {
      put_a(next);
      if constexpr (B_REG) put_b(next);
    }
  }
  cp_wait<0>();

  if (gridDim.z == 1)
    Tile::template store<KM>(acc, epi, M, N, m0, n0);
  else
    Tile::template store<KM>(
        acc, Store<AccT>{static_cast<AccT*>(ws) + (size_t)split * M * N, N},
        M, N, m0, n0);
  if (does_db && n0 + tid < N) db[(size_t)split * N + n0 + tid] = dbs;
}

template <class Tile, int VA, typename T, typename TB, class Gather,
          class Epi>
int launch_tile(const T* a, const TB* b, const Epi& epi, void* ws, float* db,
                int M, int N, int K, const Gather& g, int splits, int per,
                int vb, cudaStream_t s) {
  using AccT = typename Tile::AccT;
  const long long m_tiles = ((long long)M + Tile::BM - 1) / Tile::BM;
  const long long n_tiles = ((long long)N + Tile::BN - 1) / Tile::BN;
  const int nk = (K + Tile::BK - 1) / Tile::BK;
  if (m_tiles > INT_MAX || n_tiles > 65535 || splits > 65535 || per < 1 ||
      (long long)(splits - 1) * per >= nk || (long long)splits * per < nk ||
      (splits > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  constexpr size_t smem = smem_bytes<Tile, T, Gather>();
  auto kernel = gemm_kernel<VA, Tile, T, TB, Gather, Epi>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  float* db_out = splits > 1 && db != nullptr
                      ? static_cast<float*>(ws) + (size_t)splits * M * N
                      : db;
  const dim3 grid((unsigned)m_tiles, (unsigned)n_tiles, (unsigned)splits);
  kernel<<<grid, Tile::THREADS, smem, s>>>(a, b, epi, ws, db_out, M, N, K, g,
                                           vb, per);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const size_t n = (size_t)M * N;
  const unsigned blocks = (unsigned)((n + 255) / 256 < 65535 ? (n + 255) / 256
                                                             : 65535);
  reduce_splits<AccT><<<blocks, 256, 0, s>>>(static_cast<const AccT*>(ws), epi,
                                             n, N, splits);
  if (db != nullptr)
    reduce_splits<float><<<(N + 255) / 256, 256, 0, s>>>(
        db_out, Store<float>{db, N}, (size_t)N, N, splits);
  return (int)cudaGetLastError();
}

// the tile's kernel for A's copy width va (one instance a width)
template <class Tile, typename T, typename TB, class Gather, class Epi>
int launch_va(const T* a, const TB* b, const Epi& epi, void* ws, float* db,
              int M, int N, int K, const Gather& g, int splits, int per,
              int va, int vb, cudaStream_t s) {
  switch (va) {
    case 16:
      return launch_tile<Tile, 16>(a, b, epi, ws, db, M, N, K, g, splits, per,
                                   vb, s);
    case 8:
      return launch_tile<Tile, 8>(a, b, epi, ws, db, M, N, K, g, splits, per,
                                  vb, s);
    case 4:
      return launch_tile<Tile, 4>(a, b, epi, ws, db, M, N, K, g, splits, per,
                                  vb, s);
    case 2:
      if constexpr (sizeof(T) <= 2)
        return launch_tile<Tile, 2>(a, b, epi, ws, db, M, N, K, g, splits,
                                    per, vb, s);
      return (int)cudaErrorInvalidValue;
    default:
      if constexpr (sizeof(T) == 1)
        return launch_tile<Tile, 1>(a, b, epi, ws, db, M, N, K, g, splits,
                                    per, vb, s);
      return (int)cudaErrorInvalidValue;
  }
}

inline bool copy_ok(int bytes, int elem, const void* p) {
  return (bytes == 16 || bytes == 8 || bytes == 4 || bytes == 2 ||
          bytes == 1) &&
         bytes >= elem && reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// C = epi(A @ B) on tile `tile` (TileId) in `splits` splits of `per`
// chunks, with copies of va / vb bytes: float32 operands, bfloat16 ones
// (the tensor-core tile), int8 ones (the int8 tile), or float32 /
// bfloat16 A with int8 codes for B. Returns a cudaError_t code; a tile
// that does not take T, a split that does not cover the chunks exactly or
// a copy width the pointer does not allow are refused with
// cudaErrorInvalidValue (the wrapper derives va and vb from the strides,
// which the kernel takes on trust). ws: splits * M * N partials of the
// tile's accumulator type (float32; int32 for int8) when splits > 1.
template <typename T, typename TB, class Gather, class Epi>
int gemm(const T* a, const TB* b, const Epi& epi, void* ws, float* db, int M,
         int N, int K, const Gather& g, int tile, int splits, int per, int va,
         int vb, void* stream) {
  if (M < 1 || N < 1 || K < 1 || splits < 1 ||
      !copy_ok(va, (int)sizeof(T), a) || !copy_ok(vb, (int)sizeof(TB), b))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if constexpr (sizeof(T) == 1) {
    if (tile != TILE_INT8) return (int)cudaErrorInvalidValue;
    return launch_va<Int8Tile>(a, b, epi, ws, db, M, N, K, g, splits, per, va,
                               vb, s);
  } else if constexpr (sizeof(T) == 2) {
    if (tile != TILE_MMA) return (int)cudaErrorInvalidValue;
    return launch_va<MmaTile>(a, b, epi, ws, db, M, N, K, g, splits, per, va,
                              vb, s);
  } else {
    if (tile == TILE_WIDE)
      return launch_va<Wide>(a, b, epi, ws, db, M, N, K, g, splits, per, va,
                             vb, s);
    if (tile == TILE_NARROW)
      return launch_va<Narrow>(a, b, epi, ws, db, M, N, K, g, splits, per, va,
                               vb, s);
    return (int)cudaErrorInvalidValue;
  }
}

// The fp sliding convs' product (rows 1 and 4): y (and z) = BiasAct(A @
// w), x and w float32, or bfloat16 where is_bf16, A gathered from x by g.
template <class Gather>
int bias_act_gemm(const void* x, const void* w, const void* bias, void* y,
                  void* z, void* ws, int M, int N, int K, int act,
                  int is_bf16, const Gather& g, int tile, int splits, int per,
                  int va, int vb, void* stream) {
  const float* b = static_cast<const float*>(bias);
  if (is_bf16) {
    using T = __nv_bfloat16;
    return gemm(static_cast<const T*>(x), static_cast<const T*>(w),
                BiasAct<T>{static_cast<T*>(y), static_cast<T*>(z), b, N, act},
                ws, nullptr, M, N, K, g, tile, splits, per, va, vb, stream);
  }
  return gemm(static_cast<const float*>(x), static_cast<const float*>(w),
              BiasAct<float>{static_cast<float*>(y), static_cast<float*>(z), b,
                             N, act},
              ws, nullptr, M, N, K, g, tile, splits, per, va, vb, stream);
}


// The weight gradients' product (rows 10 and 12): dw (M, N) float32 = A @
// dz, A gathered from x by g, and db (may be null) the column sums of dz,
// x and dz float32, or bfloat16 where is_bf16.
template <class Gather>
int dw_gemm(const void* x, const void* dz, float* dw, float* db, float* ws,
            int M, int N, int K, int is_bf16, const Gather& g, int tile,
            int splits, int per, int va, int vb, void* stream) {
  const Store<float> out{dw, N};
  if (is_bf16) {
    using T = __nv_bfloat16;
    return gemm(static_cast<const T*>(x), static_cast<const T*>(dz), out, ws,
                db, M, N, K, g, tile, splits, per, va, vb, stream);
  }
  return gemm(static_cast<const float*>(x), static_cast<const float*>(dz),
              out, ws, db, M, N, K, g, tile, splits, per, va, vb, stream);
}

// The int8 convs' product (rows 13 and 14): y = Dequant(A @ w_q), A
// gathered by g from x, w_q (K, epi.N) int8 codes. mode 0 (w8a8): x int8
// (x_kind 2) on the int8 tile; mode 1 (w8a16): x float32 (x_kind 0) or
// bfloat16 (1) on its type's tile, the codes widened as they are staged.
// y_kind 2 (int8) needs out_scale. Anything else is refused with
// cudaErrorInvalidValue.
template <class Gather>
int dequant_gemm(const void* x, const void* w, const Dequant& epi, void* ws,
                 int M, int K, int mode, int x_kind, const Gather& g,
                 int tile, int splits, int per, int va, int vb,
                 void* stream) {
  if (epi.act < 0 || epi.act > 3 || epi.y_kind < 0 || epi.y_kind > 2 ||
      (epi.y_kind == OUT_INT8 && epi.out_scale == nullptr) ||
      (mode == 0 ? x_kind != 2 : (mode != 1 || x_kind < 0 || x_kind > 1)))
    return (int)cudaErrorInvalidValue;
  const int8_t* b = static_cast<const int8_t*>(w);
  if (x_kind == 2)
    return gemm(static_cast<const int8_t*>(x), b, epi, ws, nullptr, M, epi.N,
                K, g, tile, splits, per, va, vb, stream);
  if (x_kind == 1)
    return gemm(static_cast<const __nv_bfloat16*>(x), b, epi, ws, nullptr, M,
                epi.N, K, g, tile, splits, per, va, vb, stream);
  return gemm(static_cast<const float*>(x), b, epi, ws, nullptr, M, epi.N, K,
              g, tile, splits, per, va, vb, stream);
}

}  // namespace gm
}  // namespace
