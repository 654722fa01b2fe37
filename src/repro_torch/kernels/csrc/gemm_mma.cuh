// Shared by the tiled GEMM (im2col_gemm.cu, row 5) and the 2-D weight
// gradient (sliding_conv2d_bwd.cu, row 12): a block-tiled product
//
//   C[M, N] = sum_k A[m, k] * B[k, n]
//
// whose A comes through a gather functor (a[g.row(m) + g.col(k)] is
// element (m, k)) and whose B is a row-major (K, N) matrix. build.py keys
// every kernel library on this header's text.
//
// Why it exists: rows 5 and 12 are both a product whose reduction is the
// length of one whole operand (row 5's K, row 12's B*oh*ow output
// positions), and their first versions summed on the CUDA cores from
// 64 x 64 tiles staged one chunk at a time, with no overlap of loads and
// math, no tensor cores for bfloat16, and no split of the reduction where
// the blocks alone leave the card idle.
//
// The design:
//   * Tiles. bfloat16 runs on the tensor cores: 128 x 128 blocks of 8
//     warps, each warp a 64 x 32 tile of mma.sync.m16n8k16 (bf16 -> f32),
//     fragments loaded by ldmatrix (.trans where the staged operand runs
//     along k's partner dimension). The products of bf16 pairs are exact
//     in float32, so the sums differ from a float32 product only in their
//     order. float32 stays on the CUDA cores (no TF32): 8 x 8 register
//     tiles a thread, 16-byte shared-memory reads, a 128 x 128 block or,
//     where N <= 32, a 128 x 32 one so that a 32-wide N idles no lanes.
//   * Staging. A ring of STAGES shared-memory stages (4 for bfloat16, 3
//     for float32) filled by cp.async: the loads of chunk c + STAGES - 1
//     are in flight while chunk c is multiplied, one __syncthreads a
//     chunk. A is copied in pieces of the width its alignment allows (16,
//     8 or 4 bytes, or 2-byte plain loads for odd bfloat16 runs; one
//     kernel instance a width), neighbouring threads on neighbouring
//     addresses, B in 16-byte slots where it allows them: the wrapper
//     works the widths out from the pointers and strides, so no operand
//     is padded in device memory. Rows, columns and reduction elements
//     past M, N and K stage as zeros (cp.async's zero fill) and store
//     nothing.
//   * A's two layouts. Where A runs along k in memory (Gather::kMajor,
//     row 5's row-major matrix) a stage holds A as [m][k]; where it runs
//     along m (row 12: a filter row's (tap, channel) run is contiguous in
//     NHWC, the paper's vector slide) a stage holds A as [k][m]. Either
//     way a thread keeps the row offsets of the values of m it stages in
//     registers, and a [k][m] stage's thread stages one k row, so the
//     gather computes an output position's offset once a chunk.
//   * Split-K. Blocks are (M tiles, N tiles, splits); split z walks chunks
//     [z * per, min((z + 1) * per, chunks)) of BK reduction elements.
//     With one split the block casts its float32 sums once to C's type;
//     with more it writes float32 partials to the caller's workspace, and
//     reduce_splits_to adds them in split order (as split_reduce.cuh's
//     reduce_splits does) and casts once: no atomics, so a result is the
//     same from run to run. The split count and the tile are the
//     wrapper's choice (gemm_plan.py), sized from the card's SM count.
//   * An optional column sum of B (row 12's bias gradient, db[n] = sum_k
//     B[k, n]) is taken by the blocks of the first M tile from the stages
//     they hold anyway.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stddef.h>
#include <stdint.h>

#include "conv_epilogue.cuh"

namespace {
namespace gm {

// out[i] = the sum over s = 0 .. S-1 of ws[s * n + i], in that order, cast
// once to T
template <typename T>
__global__ void reduce_splits_to(const float* __restrict__ ws,
                                 T* __restrict__ out, size_t n, int S) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    float v = 0.f;
    for (int s = 0; s < S; ++s) v += ws[(size_t)s * n + i];
    out[i] = from_f32<T>(v);
  }
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// BYTES (16, 8, 4 or 2) from global to shared memory, or zeros where
// !valid (cp.async reads src-size 0 bytes then; the .L2::128B hint has
// the L2 fetch whole lines, which a stream of row pieces then reuses). 2
// bytes, under cp.async's least size, is a plain load and store.
template <int BYTES>
__device__ __forceinline__ void copy_in(void* dst, const void* src,
                                        bool valid) {
  const unsigned d = smem_addr(dst);
  const int n = valid ? BYTES : 0;
  if constexpr (BYTES == 16)
    asm volatile(
        "cp.async.cg.shared.global.L2::128B [%0], [%1], 16, %2;\n" ::"r"(d),
        "l"(src), "r"(n));
  else if constexpr (BYTES == 8 || BYTES == 4)
    asm volatile(
        "cp.async.ca.shared.global.L2::128B [%0], [%1], %2, %3;\n" ::"r"(d),
        "l"(src), "n"(BYTES), "r"(n));
  else
    *static_cast<unsigned short*>(dst) =
        valid ? *static_cast<const unsigned short*>(src)
              : static_cast<unsigned short>(0);
}

__device__ __forceinline__ void copy_in(void* dst, const void* src, int bytes,
                                        bool valid) {
  switch (bytes) {
    case 16: copy_in<16>(dst, src, valid); break;
    case 8: copy_in<8>(dst, src, valid); break;
    case 4: copy_in<4>(dst, src, valid); break;
    default: copy_in<2>(dst, src, valid);
  }
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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

// two neighbouring outputs (n, n + 1) of a row-major C, one store where
// both exist and the pair is aligned (N even)
template <typename TO>
__device__ __forceinline__ void store_pair(TO* out, size_t idx, int n, int N,
                                           float v0, float v1) {
  if (n + 1 < N && N % 2 == 0) {
    if constexpr (sizeof(TO) == 2)
      *reinterpret_cast<__nv_bfloat162*>(out + idx) =
          __floats2bfloat162_rn(v0, v1);
    else
      *reinterpret_cast<float2*>(out + idx) = make_float2(v0, v1);
  } else {
    if (n < N) out[idx] = from_f32<TO>(v0);
    if (n + 1 < N) out[idx + 1] = from_f32<TO>(v1);
  }
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

  template <bool KM, typename TO>
  __device__ static void store(const Acc& acc, TO* __restrict__ out, int M,
                               int N, int m0, int n0) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int m = m0 + row<KM>(i);
      if (m >= M) continue;
#pragma unroll
      for (int j = 0; j < TN; j += 2) {
        const int n = n0 + col(j);
        store_pair(out, (size_t)m * N + n, n, N, acc.v[i][j], acc.v[i][j + 1]);
      }
    }
  }
};

// ---------------------------------------------------------------------------
// bfloat16 on the tensor cores: mma.sync m16n8k16
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

// BM x BN blocks of WARPS_M x WARPS_N warps, each warp a (BM / WARPS_M) x
// (BN / WARPS_N) tile of m16n8k16 products
template <int BM_, int BN_, int BK_, int WARPS_M, int WARPS_N, int STAGES_,
          int MIN_BLOCKS_>
struct Mma {
  static constexpr int BM = BM_, BN = BN_, BK = BK_;
  static constexpr int THREADS = 32 * WARPS_M * WARPS_N;
  static constexpr int STAGES = STAGES_, MIN_BLOCKS = MIN_BLOCKS_;
  static constexpr int WTM = BM / WARPS_M, WTN = BN / WARPS_N;
  static constexpr int MI = WTM / 16, NJ = WTN / 8;
  static_assert(MI >= 1 && NJ % 2 == 0 && BK % 16 == 0, "warp tile");
  static constexpr int PAD_A = 8, PAD_B = 8;  // bf16: 16 bytes a row, so
                                              // ldmatrix's 8 rows miss
                                              // each other's banks
  struct Acc {
    float v[MI][NJ][4];  // [m16 block][n8 block][fragment]
  };

  template <bool KM, int LDA, int LDB>
  __device__ static void mac(Acc& acc, const __nv_bfloat16* __restrict__ as,
                             const __nv_bfloat16* __restrict__ bs) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int wm = (warp / WARPS_N) * WTM, wn = (warp % WARPS_N) * WTN;
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

  template <bool KM, typename TO>
  __device__ static void store(const Acc& acc, TO* __restrict__ out, int M,
                               int N, int m0, int n0) {
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
          store_pair(out, (size_t)m * N + n, n, N, acc.v[i][j][2 * h],
                     acc.v[i][j][2 * h + 1]);
        }
      }
  }
};

// tile ids of the C entries (gemm_plan.py's TILES): the bf16 tensor-core
// tile, float32 128 x 128, float32 128 x 32 (N <= 32)
enum TileId { TILE_MMA = 0, TILE_WIDE = 1, TILE_NARROW = 2 };
using MmaTile = Mma<128, 128, 32, 2, 4, 4, 2>;
using Wide = Simt<128, 128, 2>;
using Narrow = Simt<128, 32, 6>;

template <class Tile, typename T, class Gather>
__host__ __device__ constexpr int lda() {
  return Gather::kMajor ? Tile::BK + Tile::PAD_A : Tile::BM + Tile::PAD_A;
}

template <class Tile, typename T, class Gather>
constexpr size_t smem_bytes() {
  constexpr int a_elems = Gather::kMajor ? Tile::BM * lda<Tile, T, Gather>()
                                         : Tile::BK * lda<Tile, T, Gather>();
  constexpr int b_elems = Tile::BK * (Tile::BN + Tile::PAD_B);
  return Tile::STAGES * (size_t)(a_elems + b_elems) * sizeof(T);
}

// grid (M tiles, N tiles, splits). c: C in TO (one split) ; ws: the
// splits' float32 partials, split z's at ws + z * M * N (more than one);
// db (may be null): the column sums of B, split z's at db + z * N. VA, vb:
// the bytes a copy of A and of B moves (the wrapper's choice).
template <int VA, class Tile, typename T, typename TO, class Gather>
__global__ void __launch_bounds__(Tile::THREADS, Tile::MIN_BLOCKS)
gemm_kernel(const T* __restrict__ a, const T* __restrict__ b,
            TO* __restrict__ c, float* __restrict__ ws,
            float* __restrict__ db, int M, int N, int K, Gather g, int vb,
            int per) {
  constexpr bool KM = Gather::kMajor;
  constexpr int BM = Tile::BM, BN = Tile::BN, BK = Tile::BK;
  constexpr int NT = Tile::THREADS, STAGES = Tile::STAGES;
  constexpr int SE = 16 / sizeof(T);  // elements in a 16-byte slot
  constexpr int EA = VA / sizeof(T);  // elements in a copy of A
  constexpr int LDA = lda<Tile, T, Gather>();
  constexpr int LDB = BN + Tile::PAD_B;
  constexpr int A_ELEMS = KM ? BM * LDA : BK * LDA;
  constexpr int B_ELEMS = BK * LDB;
  constexpr int A_COPIES = BM * BK / EA / NT;  // copies of A a thread
  constexpr int B_SLOTS = BK * BN / SE / NT;
  // [k][m] stages: P threads side by side copy one k row's run of m, at
  // most 32 bytes (a sector) an instruction
  constexpr int P = 32 / VA < NT / BK ? 32 / VA : NT / BK;
  static_assert(EA >= 1 && A_COPIES >= 1 && B_SLOTS >= 1 &&
                    NT % (BK / EA) == 0 && (BM / EA) % P == 0,
                "a stage's copies spread evenly over the threads");
  extern __shared__ __align__(16) unsigned char smem[];
  T* As = reinterpret_cast<T*>(smem);
  T* Bs = As + STAGES * A_ELEMS;

  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN, split = blockIdx.z;
  const int tid = threadIdx.x;
  const int nk = (K + BK - 1) / BK;
  const int kc0 = split * per, kc1 = min(nk, kc0 + per);
  const int eb = vb / (int)sizeof(T);

  // A's copies, VA bytes each, neighbouring threads on neighbouring
  // addresses. [m][k] stages: copy c of a thread is row (tid + NT*c) /
  // (BK/EA) at k offset (tid % (BK/EA)) * EA. [k][m] stages: a thread's
  // copies share k row (tid / P) % BK, so the gather's col() runs once a
  // chunk, and copy c takes the (tid % P + P * ((tid + NT*c) / (P*BK)))-th
  // run of EA values along m; their row offsets (fixed for the block) stay
  // in registers, -1 past M.
  using Off = decltype(g.row(0));
  Off ro[KM ? 1 : A_COPIES];
  if constexpr (!KM) {
#pragma unroll
    for (int c = 0; c < A_COPIES; ++c) {
      const int m = m0 + (tid % P + P * ((tid + NT * c) / (P * BK))) * EA;
      ro[c] = m < M ? g.row(m) : (Off)-1;
    }
  }

  auto load = [&](int st, int kc) {
    const int k0 = kc * BK;
    T* as = As + st * A_ELEMS;
    T* bs = Bs + st * B_ELEMS;
    if constexpr (KM) {
      const int kq = (tid % (BK / EA)) * EA, k = k0 + kq;
#pragma unroll
      for (int c = 0; c < A_COPIES; ++c) {
        const int r = (tid + NT * c) / (BK / EA), m = m0 + r;
        const bool ok = m < M && k < K;
        copy_in<VA>(as + r * LDA + kq, ok ? a + g.row(m) + g.col(k) : a, ok);
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
  };

  typename Tile::Acc acc;
  {
    float* p = reinterpret_cast<float*>(&acc);
#pragma unroll
    for (int i = 0; i < (int)(sizeof(acc) / sizeof(float)); ++i) p[i] = 0.f;
  }
  const bool does_db = db != nullptr && blockIdx.x == 0 && tid < BN;
  float dbs = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (kc0 + s < kc1) load(s, kc0 + s);
    cp_commit();
  }
  for (int kc = kc0; kc < kc1; ++kc) {
    cp_wait<STAGES - 2>();  // chunk kc has landed (this thread's copies)
    __syncthreads();        // ... everyone's; the oldest stage is free
    const int i = kc - kc0;
    if (kc + STAGES - 1 < kc1) load((i + STAGES - 1) % STAGES, kc + STAGES - 1);
    cp_commit();
    const T* as = As + (i % STAGES) * A_ELEMS;
    const T* bs = Bs + (i % STAGES) * B_ELEMS;
    if (does_db)
      for (int r = 0; r < BK; ++r) dbs += to_f32(bs[r * LDB + tid]);
    Tile::template mac<KM, LDA, LDB>(acc, as, bs);
  }
  cp_wait<0>();

  if (gridDim.z == 1)
    Tile::template store<KM>(acc, c, M, N, m0, n0);
  else
    Tile::template store<KM>(acc, ws + (size_t)split * M * N, M, N, m0, n0);
  if (does_db && n0 + tid < N) db[(size_t)split * N + n0 + tid] = dbs;
}

template <class Tile, int VA, typename T, typename TO, class Gather>
int launch_tile(const T* a, const T* b, TO* c, float* ws, float* db, int M,
                int N, int K, const Gather& g, int splits, int per, int vb,
                cudaStream_t s) {
  const long long m_tiles = ((long long)M + Tile::BM - 1) / Tile::BM;
  const long long n_tiles = ((long long)N + Tile::BN - 1) / Tile::BN;
  const int nk = (K + Tile::BK - 1) / Tile::BK;
  if (m_tiles > INT_MAX || n_tiles > 65535 || splits > 65535 || per < 1 ||
      (long long)(splits - 1) * per >= nk || (long long)splits * per < nk ||
      (splits > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  constexpr size_t smem = smem_bytes<Tile, T, Gather>();
  auto kernel = gemm_kernel<VA, Tile, T, TO, Gather>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  float* db_out = splits > 1 && db != nullptr ? ws + (size_t)splits * M * N
                                              : db;
  const dim3 grid((unsigned)m_tiles, (unsigned)n_tiles, (unsigned)splits);
  kernel<<<grid, Tile::THREADS, smem, s>>>(a, b, c, ws, db_out, M, N, K, g,
                                           vb, per);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const size_t n = (size_t)M * N;
  const unsigned blocks = (unsigned)((n + 255) / 256 < 65535 ? (n + 255) / 256
                                                             : 65535);
  reduce_splits_to<TO><<<blocks, 256, 0, s>>>(ws, c, n, splits);
  if (db != nullptr)
    reduce_splits_to<float><<<(N + 255) / 256, 256, 0, s>>>(db_out, db,
                                                           (size_t)N, splits);
  return (int)cudaGetLastError();
}

// the tile's kernel for A's copy width va (one instance a width)
template <class Tile, typename T, typename TO, class Gather>
int launch_va(const T* a, const T* b, TO* c, float* ws, float* db, int M,
              int N, int K, const Gather& g, int splits, int per, int va,
              int vb, cudaStream_t s) {
  switch (va) {
    case 16:
      return launch_tile<Tile, 16>(a, b, c, ws, db, M, N, K, g, splits, per,
                                   vb, s);
    case 8:
      return launch_tile<Tile, 8>(a, b, c, ws, db, M, N, K, g, splits, per,
                                  vb, s);
    case 4:
      return launch_tile<Tile, 4>(a, b, c, ws, db, M, N, K, g, splits, per,
                                  vb, s);
    default:
      if constexpr (sizeof(T) == 2)
        return launch_tile<Tile, 2>(a, b, c, ws, db, M, N, K, g, splits, per,
                                    vb, s);
      return (int)cudaErrorInvalidValue;
  }
}

inline bool copy_ok(int bytes, int elem, const void* p) {
  return (bytes == 16 || bytes == 8 || bytes == 4 || bytes == 2) &&
         bytes >= elem && reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// C = A @ B on tile `tile` (TileId) in `splits` splits of `per` chunks,
// with copies of va / vb bytes; float32 operands or bfloat16 ones
// (T = __nv_bfloat16, the tensor-core tile). Returns a cudaError_t code;
// a tile that does not take T, a split that does not cover the chunks
// exactly or a copy width the pointer does not allow are refused with
// cudaErrorInvalidValue (the wrapper derives va and vb from the strides,
// which the kernel takes on trust).
template <typename T, typename TO, class Gather>
int gemm(const T* a, const T* b, TO* c, float* ws, float* db, int M, int N,
         int K, const Gather& g, int tile, int splits, int per, int va,
         int vb, void* stream) {
  if (M < 1 || N < 1 || K < 1 || splits < 1 ||
      !copy_ok(va, (int)sizeof(T), a) || !copy_ok(vb, (int)sizeof(T), b))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if constexpr (sizeof(T) == 2) {
    if (tile != TILE_MMA) return (int)cudaErrorInvalidValue;
    return launch_va<MmaTile>(a, b, c, ws, db, M, N, K, g, splits, per, va,
                              vb, s);
  } else {
    if (tile == TILE_WIDE)
      return launch_va<Wide>(a, b, c, ws, db, M, N, K, g, splits, per, va,
                             vb, s);
    if (tile == TILE_NARROW)
      return launch_va<Narrow>(a, b, c, ws, db, M, N, K, g, splits, per, va,
                               vb, s);
    return (int)cudaErrorInvalidValue;
  }
}

}  // namespace gm
}  // namespace
