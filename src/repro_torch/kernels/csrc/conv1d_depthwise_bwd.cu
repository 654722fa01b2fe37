// Weight and bias gradient of the VALID depthwise conv1d, for Hopper
// (sm_90a).
//
// Replaces: src/repro/kernels/sliding_conv_bwd.py,
// conv1d_depthwise_bwd_dw_pallas (the _dw_depthwise_kernel body: per tap,
// the shifted input tile times the dz tile summed over its rows, carried
// over the (batch x row tile) reduction grid in a float32 VMEM scratch
// that is flushed on the last visit).
//
// What it computes, for x (B, L, C) the padded forward input and dz
// (B, Lout, C) the gradient after the epilogue's activation:
//   dw[k, c] = sum_b sum_t x[b, t*stride + k, c] * dz[b, t, c]
//   db[c]    = sum_b sum_t dz[b, t, c]           (when asked for)
// dw (K, C) and db (C,) in float32. float32 or bfloat16 operands; each
// product is rounded to float32 and then added (IEEE round-to-nearest, no
// FMA contraction), as the plain version multiplies and then sums; the
// order of the sum over (b, t) is the kernel's own.
//
// What bounds it on this card: K multiply-adds per element of dz for one
// element of dz and about one of x read. At jamba-1.5-large's training
// shape (B=2, x 515 x 16384 and dz 512 x 16384 in bfloat16, K=4) that is
// 0.13 GFLOP against 67.3 MB: it is bound by bytes (about 0.020 ms at
// 3.35 TB/s), as the forward kernel is.
//
// What the design does about it: the forward kernel's layout
// (conv1d_depthwise.cu). Channels are contiguous; each thread owns N
// neighbouring channels (16 bytes of a row: 4 float32 or 8 bfloat16), so
// a warp reads 512 contiguous bytes of a row with one load each. It walks
// the rows of a tile of TL dz rows of one batch row, keeping the K input
// rows of the current window and K x N float32 sums in registers: every
// row of x and dz is read once per tile, plus a (K-1)-row halo of x per
// tile. The Pallas revisit grid over (batch, tile) becomes this loop. The
// channels alone give too few blocks (2,048 vectors of bf16 channels at
// C = 16384 are 16 blocks of 128 threads, a few of the card's SMs), so the
// tiles are split over S blocks per channel block, S chosen by the wrapper
// from the card's SM count (gemm_plan.depthwise_dw_splits), each writing
// its partial sums to a float32 workspace, and a second pass
// (split_reduce.cuh) adds the S partials in a fixed order: no atomics, so
// the result does not change from run to run. The window is unrolled at
// compile time for K in {1, 2, 3, 4} (mamba's K is 4); a larger K is cut
// into groups of KT taps, one block per group, each tap's row read per dz
// row through the L1. db is summed by the first tap group only, from the
// dz rows it loads anyway.
// Channel counts that are not a multiple of N, or unaligned bases, take
// scalar loads and stores masked at C.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stddef.h>
#include <stdint.h>

#include "conv_epilogue.cuh"
#include "depthwise_rows.cuh"
#include "split_reduce.cuh"

namespace {

constexpr int TL = 32;               // dz rows per tile
constexpr int THREADS = 128;         // channel vectors per block
constexpr int KT = 4;                // taps per block when K > 4

// N float32 sums stored from channel c0 on: 16-byte stores when ALIGNED
template <bool ALIGNED, int N>
__device__ __forceinline__ void store_f32(float* __restrict__ row, int c0,
                                          int C, const float (&v)[N]) {
  if (ALIGNED) {
#pragma unroll
    for (int j = 0; j < N; j += 4)
      *reinterpret_cast<float4*>(row + c0 + j) =
          make_float4(v[j], v[j + 1], v[j + 2], v[j + 3]);
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j)
      if (c0 + j < C) row[c0 + j] = v[j];
  }
}

// grid: (channel blocks, tap groups x splits). Split s reduces tiles
// [s * per, (s + 1) * per) of the n_tiles = B * ceil(Lout / TL) tiles and
// writes dw and db (one split) or its slice of the workspace. KW > 0: the
// window of KW = K rows in registers, one tap group; KW == 0: groups of KT
// taps.
template <typename T, int KW, bool ALIGNED>
__global__ void __launch_bounds__(THREADS)
dw_kernel(const T* __restrict__ x, const T* __restrict__ dz,
          float* __restrict__ dw, float* __restrict__ db, int L, int C, int K,
          int stride, int Lout, int n_groups, int per, int n_tiles) {
  constexpr int N = VecOf<T>::N;
  constexpr int KA = KW > 0 ? KW : KT;  // sums kept per thread, per channel
  const int c0 = (blockIdx.x * THREADS + threadIdx.x) * N;
  if (c0 >= C) return;
  const int group = blockIdx.y % n_groups;
  const int split = blockIdx.y / n_groups;
  const int k0 = group * KA;
  const int kt = KW > 0 ? KW : min(KT, K - k0);
  const int tiles_per_b = (Lout + TL - 1) / TL;
  const int first = split * per;
  const int last = min(first + per, n_tiles);
  const bool does_db = db != nullptr && group == 0;

  float acc[KA][N];
  float dbs[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    dbs[j] = 0.f;
#pragma unroll
    for (int k = 0; k < KA; ++k) acc[k][j] = 0.f;
  }

  for (int tile = first; tile < last; ++tile) {
    const int b = tile / tiles_per_b;
    const int r0 = (tile % tiles_per_b) * TL;
    const int r1 = min(r0 + TL, Lout);
    const T* xb = x + (size_t)b * L * C;
    const T* dzb = dz + (size_t)b * Lout * C;
    if constexpr (KW > 0) {
      float win[KW][N];  // input rows r*stride .. r*stride + KW-1
#pragma unroll
      for (int k = 0; k < KW; ++k)
        load_row<T, ALIGNED>(xb + (size_t)(r0 * stride + k) * C, c0, C,
                             win[k]);
      for (int r = r0; r < r1; ++r) {
        if (r > r0) {
          const int row0 = r * stride;
          if (stride >= KW) {  // no row of the last window is reused
#pragma unroll
            for (int k = 0; k < KW; ++k)
              load_row<T, ALIGNED>(xb + (size_t)(row0 + k) * C, c0, C,
                                   win[k]);
          } else {
            for (int s = 0; s < stride; ++s) {
#pragma unroll
              for (int k = 0; k + 1 < KW; ++k)
#pragma unroll
                for (int j = 0; j < N; ++j) win[k][j] = win[k + 1][j];
              load_row<T, ALIGNED>(
                  xb + (size_t)(row0 + KW - stride + s) * C, c0, C,
                  win[KW - 1]);
            }
          }
        }
        float g[N];
        load_row<T, ALIGNED>(dzb + (size_t)r * C, c0, C, g);
#pragma unroll
        for (int k = 0; k < KW; ++k)
#pragma unroll
          for (int j = 0; j < N; ++j)
            acc[k][j] = __fadd_rn(acc[k][j], __fmul_rn(win[k][j], g[j]));
        if (does_db) {
#pragma unroll
          for (int j = 0; j < N; ++j) dbs[j] = __fadd_rn(dbs[j], g[j]);
        }
      }
    } else {
      for (int r = r0; r < r1; ++r) {
        float g[N], xv[N];
        load_row<T, ALIGNED>(dzb + (size_t)r * C, c0, C, g);
#pragma unroll
        for (int kk = 0; kk < KT; ++kk) {
          if (kk >= kt) break;
          load_row<T, ALIGNED>(xb + (size_t)(r * stride + k0 + kk) * C, c0,
                               C, xv);
#pragma unroll
          for (int j = 0; j < N; ++j)
            acc[kk][j] = __fadd_rn(acc[kk][j], __fmul_rn(xv[j], g[j]));
        }
        if (does_db) {
#pragma unroll
          for (int j = 0; j < N; ++j) dbs[j] = __fadd_rn(dbs[j], g[j]);
        }
      }
    }
  }

  // dw (or this split's slice of the workspace): (K, C) row-major
  float* out = dw + (size_t)split * K * C;
#pragma unroll
  for (int kk = 0; kk < KA; ++kk) {
    if (kk >= kt) break;
    store_f32<ALIGNED>(out + (size_t)(k0 + kk) * C, c0, C, acc[kk]);
  }
  if (does_db) store_f32<ALIGNED>(db + (size_t)split * C, c0, C, dbs);
}

int vec_of(int is_bf16) { return is_bf16 ? 8 : 4; }

// reduce_splits' grid: 256-thread blocks over n sums, at most two a SM
int reduce_blocks(size_t n, int sms) {
  const size_t want = (n + 255) / 256;
  return (int)(want < (size_t)(2 * sms) ? want : (size_t)(2 * sms));
}

template <typename T, int KW>
cudaError_t launch_k(bool aligned, dim3 grid, const void* x, const void* dz,
                     float* dw, float* db, int L, int C, int K, int stride,
                     int Lout, int n_groups, int per, int n_tiles,
                     cudaStream_t s) {
  auto kernel = aligned ? dw_kernel<T, KW, true> : dw_kernel<T, KW, false>;
  kernel<<<grid, THREADS, 0, s>>>(static_cast<const T*>(x),
                                  static_cast<const T*>(dz), dw, db, L, C, K,
                                  stride, Lout, n_groups, per, n_tiles);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(bool aligned, dim3 grid, const void* x, const void* dz,
                   float* dw, float* db, int L, int C, int K, int stride,
                   int Lout, int n_groups, int per, int n_tiles,
                   cudaStream_t s) {
  switch (K) {
    case 1:
      return launch_k<T, 1>(aligned, grid, x, dz, dw, db, L, C, K, stride,
                            Lout, n_groups, per, n_tiles, s);
    case 2:
      return launch_k<T, 2>(aligned, grid, x, dz, dw, db, L, C, K, stride,
                            Lout, n_groups, per, n_tiles, s);
    case 3:
      return launch_k<T, 3>(aligned, grid, x, dz, dw, db, L, C, K, stride,
                            Lout, n_groups, per, n_tiles, s);
    case 4:
      return launch_k<T, 4>(aligned, grid, x, dz, dw, db, L, C, K, stride,
                            Lout, n_groups, per, n_tiles, s);
    default:
      return launch_k<T, 0>(aligned, grid, x, dz, dw, db, L, C, K, stride,
                            Lout, n_groups, per, n_tiles, s);
  }
}

}  // namespace

// Returns a cudaError_t code: 0 when the launches were accepted. db may be
// null (no bias). splits is the wrapper's split of the row tiles
// (gemm_plan.depthwise_dw_splits, from the card's SM count sms); ws is a
// float32 workspace of splits * (K * C + C) floats, null when splits is 1.
extern "C" int conv1d_depthwise_bwd_dw(const void* x, const void* dz,
                                       float* dw, float* db, float* ws,
                                       int B, int L, int C, int K, int stride,
                                       int Lout, int is_bf16, int splits,
                                       int sms, void* stream) {
  if (B < 1 || C < 1 || K < 1 || stride < 1 || Lout < 1 || splits < 1 ||
      sms < 1 || (Lout - 1) * stride + K > L)
    return (int)cudaErrorInvalidValue;
  const int S = splits;
  if (S > 1 && ws == nullptr) return (int)cudaErrorInvalidValue;
  const int n_groups = K <= 4 ? 1 : (K + KT - 1) / KT;
  const int n_tiles = B * ((Lout + TL - 1) / TL);
  const int per = (n_tiles + S - 1) / S;
  const int used = (n_tiles + per - 1) / per;  // splits that get a tile
  if ((size_t)n_groups * used > 65535) return (int)cudaErrorInvalidValue;
  const size_t n_dw = (size_t)K * C;
  float* dw_out = used > 1 ? ws : dw;
  float* db_out = db == nullptr ? nullptr : (used > 1 ? ws + used * n_dw : db);
  const int N = vec_of(is_bf16);
  const bool aligned = C % N == 0 && (uintptr_t)x % 16 == 0 &&
                       (uintptr_t)dz % 16 == 0 && (uintptr_t)dw_out % 16 == 0 &&
                       (uintptr_t)db_out % 16 == 0;
  const int vecs = (C + N - 1) / N;
  const dim3 grid((vecs + THREADS - 1) / THREADS, n_groups * used);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      is_bf16 ? launch<__nv_bfloat16>(aligned, grid, x, dz, dw_out, db_out, L,
                                      C, K, stride, Lout, n_groups, per,
                                      n_tiles, s)
              : launch<float>(aligned, grid, x, dz, dw_out, db_out, L, C, K,
                              stride, Lout, n_groups, per, n_tiles, s);
  if (err != cudaSuccess || used == 1) return (int)err;
  reduce_splits<<<reduce_blocks(n_dw, sms), 256, 0, s>>>(ws, dw, n_dw, used);
  if (db != nullptr)
    reduce_splits<<<reduce_blocks(C, sms), 256, 0, s>>>(ws + used * n_dw, db,
                                                        C, used);
  return (int)cudaGetLastError();
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
