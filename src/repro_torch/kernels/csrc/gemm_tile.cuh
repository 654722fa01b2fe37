// Used by the fused 1-D im2col convolution alone (im2col_gemm.cu,
// im2col_conv1d, row 6), whose first design it is: the block tiling and
// the main loop of a register-tiled matrix product C = A @ B whose A
// operand is gathered, chunk by chunk, into shared memory. Rows 4, 5, 7,
// 12 and 14 run on gemm_mma.cuh. build.py keys every kernel library on
// this header's text.
//
// The design: each block owns a GM x GN = 64 x 64 tile of C (64 rows of
// A, 64 columns of B) and keeps a 4x4 register tile of float32 sums a
// thread (256 threads, 16 x 16) across the whole reduction. The
// reduction walks K in chunks of GK = 32: each chunk stages the block's
// 64 x 32 slice of A and the 32 x 64 slice of B in shared memory as
// float32 (bfloat16 widened as it is staged), then every thread adds its
// 16 products of each of the 32 reduction steps with float32 FMAs (no
// TF32, no tensor cores: the sums agree with a float32 product up to
// their order). Rows, columns and reduction elements past M, N and K stage
// as zeros and store nothing, so ragged edges need no padding in device
// memory.
//
// Where A comes from is the Gather argument: a[g.row(m) + g.col(r)] is
// element (m, r) of A. For a plain row-major matrix that is m * K + r; for
// a convolution it is the input element that column r of output position
// m's im2col row reads, so the staged A slice is a chunk of the column
// tile, built on chip from the input. Each thread stages the same 8 rows
// in every chunk (their offsets are computed once) and one reduction
// element a chunk (its offset once a chunk), so the gather costs one add
// an element. A warp stages 32 consecutive reduction elements of one row:
// consecutive addresses wherever the column's run is contiguous in the
// input.
#pragma once

#include <cuda_bf16.h>
#include <stddef.h>

#include "conv_epilogue.cuh"

namespace {

constexpr int GM = 64;          // rows of C per block
constexpr int GN = 64;          // columns of C per block
constexpr int GK = 32;          // reduction elements per staged chunk
constexpr int GTHREADS = 256;   // 16 x 16 threads, a 4x4 patch of C each
constexpr int GRM = GM / 16;
constexpr int GRN = GN / 16;
constexpr int A_PER_THREAD = GM * GK / GTHREADS;  // staged A rows a thread
constexpr int B_PER_THREAD = GK * GN / GTHREADS;  // staged B rows a thread
constexpr int A_LD = GK + 1;  // padded A row: the 2 rows a warp reads per
                              // step fall in different banks

// One block's tile of C = A @ B, A (M, K) through the gather g, B (K, N)
// and C (M, N) row-major. blockIdx.x: the row tile, blockIdx.y: the column
// tile.
template <typename T, typename Gather>
__device__ __forceinline__ void gemm_tile(const T* __restrict__ a,
                                          const T* __restrict__ b,
                                          T* __restrict__ c, int M, int N,
                                          int K, const Gather& g) {
  __shared__ float As[GM * A_LD];              // [GM][A_LD]
  __shared__ __align__(16) float Bs[GK * GN];  // [GK][GN]
  const int m0 = blockIdx.x * GM;
  const int n0 = blockIdx.y * GN;
  const int tid = threadIdx.x;

  // staging: A element (a_row + 8p, a_k) and B element (b_k + 4p, b_n)
  const int a_k = tid % GK;
  const int a_row = tid / GK;
  const int b_n = tid % GN;
  const int b_k = tid / GN;
  long long row_off[A_PER_THREAD];
#pragma unroll
  for (int p = 0; p < A_PER_THREAD; ++p) {
    const int m = m0 + a_row + (GTHREADS / GK) * p;
    row_off[p] = m < M ? g.row(m) : -1;
  }
  const int gn = n0 + b_n;

  // compute: rows ty + 16i, columns tx * GRN + j of the tile
  const int tx = tid % 16;
  const int ty = tid / 16;
  float acc[GRM][GRN];
#pragma unroll
  for (int i = 0; i < GRM; ++i)
#pragma unroll
    for (int j = 0; j < GRN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += GK) {
    __syncthreads();  // every reader of the previous chunk is done
    const int r = k0 + a_k;
    const long long col = r < K ? g.col(r) : 0;
#pragma unroll
    for (int p = 0; p < A_PER_THREAD; ++p)
      As[(a_row + (GTHREADS / GK) * p) * A_LD + a_k] =
          (r < K && row_off[p] >= 0) ? to_f32(a[row_off[p] + col]) : 0.f;
#pragma unroll
    for (int p = 0; p < B_PER_THREAD; ++p) {
      const int kk = b_k + (GTHREADS / GN) * p;
      const int gk = k0 + kk;
      Bs[kk * GN + b_n] =
          (gk < K && gn < N) ? to_f32(b[(size_t)gk * N + gn]) : 0.f;
    }
    __syncthreads();  // the chunk is in place
#pragma unroll 8
    for (int kk = 0; kk < GK; ++kk) {
      float av[GRM];
#pragma unroll
      for (int i = 0; i < GRM; ++i) av[i] = As[(ty + 16 * i) * A_LD + kk];
      const float4 bw = *reinterpret_cast<const float4*>(Bs + kk * GN + tx * GRN);
#pragma unroll
      for (int i = 0; i < GRM; ++i) {
        acc[i][0] = fmaf(av[i], bw.x, acc[i][0]);
        acc[i][1] = fmaf(av[i], bw.y, acc[i][1]);
        acc[i][2] = fmaf(av[i], bw.z, acc[i][2]);
        acc[i][3] = fmaf(av[i], bw.w, acc[i][3]);
      }
    }
  }

  // no epilogue: the cast to C's type and the store
#pragma unroll
  for (int i = 0; i < GRM; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < GRN; ++j) {
      const int n = n0 + tx * GRN + j;
      if (n < N) c[(size_t)m * N + n] = from_f32<T>(acc[i][j]);
    }
  }
}

}  // namespace
