// Weight and bias gradient of the VALID sliding conv1d, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/sliding_conv_bwd.py, conv1d_bwd_dw_pallas
// (the _dw1d_kernel body, its (batch x spatial tile) reduction grid with the
// f32 VMEM scratch, and the db output gated to the cin-block-0 visits).
//
// What it computes, for x (B, L, Cin) the padded forward input and dz
// (B, Lout, Cout) the gradient after the epilogue's activation:
//   dw[k, c, n] = sum_b sum_t x[b, t*stride + k, c] * dz[b, t, n]
//   db[n]       = sum_b sum_t dz[b, t, n]
// dw (K, Cin, Cout) and db (Cout,) in float32. float32 or bfloat16 operands,
// the sums always in float32 on the CUDA cores, never in TF32.
//
// What bounds it on this card: at whisper's frontend shapes (B=4, 512 mel
// frames; conv1 80->1024 at stride 1, conv2 1024->1024 at stride 2) the
// work is 1.0 and 6.4 GFLOP against 10 and 25 MB of traffic, so it is bound
// by float32 arithmetic (67 TFLOP/s on an H100 SXM), as the forward is.
//
// What the design does about it: each block owns one (tap group of KT taps,
// TC input channels, TN output channels) tile of dw and keeps a KT x 4 x 4
// register tile of float32 sums per thread. The (B x Lout) reduction, which
// the Pallas kernel walks as revisited grid dimensions with a scratch that
// is flushed on the last visit, is a loop inside the block here: blocks run
// in no order, so nothing can be carried from one block to the next. Each
// step of the loop stages one tile of TL rows of dz and the input halo of
// (TL-1)*stride + KT rows that those rows read in shared memory; every tap
// is an address offset into the same halo (the vector slide), so no im2col
// buffer exists. Where those blocks alone would leave most of the 132 SMs
// idle (conv1 has 2 Cin tiles), the row tiles are split over S blocks that
// each write a partial sum to a float32 workspace, and a second pass adds
// the S partials in a fixed order: no atomics, so the result does not
// change from run to run. db is summed once per Cout tile, by the blocks of
// the first Cin tile and first tap group only, from the dz tile they stage
// anyway. Tensor-core (wgmma) tiles for bf16 are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stddef.h>

#include "split_reduce.cuh"

namespace {

constexpr int TL = 32;        // dz rows per reduction step
constexpr int TC = 64;        // input channels per block
constexpr int TN = 64;        // output channels per block
constexpr int KT = 4;         // taps per block
constexpr int THREADS = 256;  // 16 x 16 threads, a 4x4 (c, n) patch each
constexpr int RC = TC / 16;
constexpr int RN = TN / 16;
constexpr int MIN_BLOCKS = 2 * 132;  // split the rows below this many blocks

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__host__ __device__ inline int halo_rows(int stride) {
  return (TL - 1) * stride + KT;
}

size_t smem_bytes(int stride) {
  return sizeof(float) * ((size_t)halo_rows(stride) * TC + (size_t)TL * TN);
}

// grid: (Cout tiles, Cin tiles, tap groups x splits). Split s reduces row
// tiles [s * per, (s + 1) * per) of the n_tiles = B * ceil(Lout / TL) row
// tiles and writes dw (one split) or its slice of the workspace.
template <typename T>
__global__ void __launch_bounds__(THREADS)
dw_kernel(const T* __restrict__ x, const T* __restrict__ dz,
          float* __restrict__ dw, float* __restrict__ db, int L, int Cin,
          int Cout, int K, int stride, int Lout, int n_groups, int per,
          int n_tiles) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                              // [halo_rows][TC]
  float* dzs = smem + halo_rows(stride) * TC;    // [TL][TN]
  const int n0 = blockIdx.x * TN;
  const int c0 = blockIdx.y * TC;
  const int group = blockIdx.z % n_groups;
  const int split = blockIdx.z / n_groups;
  const int k0 = group * KT;
  const int kt = min(KT, K - k0);
  const int halo = (TL - 1) * stride + kt;
  const int tiles_per_b = (Lout + TL - 1) / TL;
  const int first = split * per;
  const int last = min(first + per, n_tiles);
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const bool does_db = db != nullptr && blockIdx.y == 0 && group == 0;

  float acc[KT][RC][RN];
#pragma unroll
  for (int kk = 0; kk < KT; ++kk)
#pragma unroll
    for (int i = 0; i < RC; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j) acc[kk][i][j] = 0.f;
  float dbs = 0.f;  // column threadIdx.x of db, threads < TN

  for (int tile = first; tile < last; ++tile) {
    const int b = tile / tiles_per_b;
    const int t0 = (tile % tiles_per_b) * TL;
    const T* xb = x + (size_t)b * L * Cin;
    const T* dzb = dz + (size_t)b * Lout * Cout;
    const int row0 = t0 * stride + k0;  // first input row of the halo
    __syncthreads();  // every reader of the previous tile is done
    for (int e = threadIdx.x; e < halo * TC; e += THREADS) {
      const int r = e / TC, c = e % TC;
      const int gr = row0 + r, gc = c0 + c;
      xs[e] = (gr < L && gc < Cin) ? to_f32(xb[(size_t)gr * Cin + gc]) : 0.f;
    }
    for (int e = threadIdx.x; e < TL * TN; e += THREADS) {
      const int r = e / TN, n = e % TN;
      const int gt = t0 + r, gn = n0 + n;
      // rows past Lout are zero, so they add nothing to dw or db
      dzs[e] = (gt < Lout && gn < Cout) ? to_f32(dzb[(size_t)gt * Cout + gn])
                                        : 0.f;
    }
    __syncthreads();  // halo and dz tile are in place
    if (does_db && threadIdx.x < TN)
      for (int r = 0; r < TL; ++r) dbs += dzs[r * TN + threadIdx.x];
    for (int t = 0; t < TL; ++t) {
      const float4 g =
          *reinterpret_cast<const float4*>(dzs + t * TN + tx * RN);
#pragma unroll
      for (int kk = 0; kk < KT; ++kk) {
        if (kk >= kt) break;
        const float4 a = *reinterpret_cast<const float4*>(
            xs + (t * stride + kk) * TC + ty * RC);
        const float av[RC] = {a.x, a.y, a.z, a.w};
#pragma unroll
        for (int i = 0; i < RC; ++i) {
          acc[kk][i][0] = fmaf(av[i], g.x, acc[kk][i][0]);
          acc[kk][i][1] = fmaf(av[i], g.y, acc[kk][i][1]);
          acc[kk][i][2] = fmaf(av[i], g.z, acc[kk][i][2]);
          acc[kk][i][3] = fmaf(av[i], g.w, acc[kk][i][3]);
        }
      }
    }
  }

  // dw (or this split's slice of the workspace): (K, Cin, Cout) row-major
  float* out = dw + (size_t)split * K * Cin * Cout;
#pragma unroll
  for (int kk = 0; kk < KT; ++kk) {
    if (kk >= kt) break;
#pragma unroll
    for (int i = 0; i < RC; ++i) {
      const int c = c0 + ty * RC + i;
      if (c >= Cin) continue;
      float* row = out + ((size_t)(k0 + kk) * Cin + c) * Cout;
#pragma unroll
      for (int j = 0; j < RN; ++j) {
        const int n = n0 + tx * RN + j;
        if (n < Cout) row[n] = acc[kk][i][j];
      }
    }
  }
  if (does_db && threadIdx.x < TN && n0 + threadIdx.x < Cout)
    db[(size_t)split * Cout + n0 + threadIdx.x] = dbs;
}

}  // namespace

// How many splits of the row tiles the kernel uses for this shape (1: no
// workspace). The caller allocates S * (K * Cin * Cout + Cout) floats of
// workspace when S > 1.
extern "C" int conv1d_bwd_dw_splits(int B, int Cin, int Cout, int K,
                                    int Lout) {
  const int blocks = ((Cout + TN - 1) / TN) * ((Cin + TC - 1) / TC) *
                     ((K + KT - 1) / KT);
  const int n_tiles = B * ((Lout + TL - 1) / TL);
  if (blocks >= MIN_BLOCKS / 2) return 1;
  const int want = (MIN_BLOCKS + blocks - 1) / blocks;
  return want < n_tiles ? want : n_tiles;
}

// Returns a cudaError_t code: 0 when the launches were accepted. db may be
// null (no bias). ws is the float32 workspace of conv1d_bwd_dw_splits()
// splits (null when that is 1). Shared memory grows with the halo; a stride
// that needs more than the card offers is refused with
// cudaErrorInvalidValue.
extern "C" int conv1d_bwd_dw(const void* x, const void* dz, float* dw,
                             float* db, float* ws, int B, int L, int Cin,
                             int Cout, int K, int stride, int Lout,
                             int is_bf16, void* stream) {
  if (B < 1 || Cin < 1 || Cout < 1 || K < 1 || stride < 1 || Lout < 1 ||
      (Lout - 1) * stride + K > L)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(stride);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  const int S = conv1d_bwd_dw_splits(B, Cin, Cout, K, Lout);
  if (S > 1 && ws == nullptr) return (int)cudaErrorInvalidValue;
  const int n_groups = (K + KT - 1) / KT;
  const int n_tiles = B * ((Lout + TL - 1) / TL);
  const int per = (n_tiles + S - 1) / S;
  const int used = (n_tiles + per - 1) / per;  // splits that get a tile
  if ((size_t)n_groups * used > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t n_dw = (size_t)K * Cin * Cout;
  float* dw_out = used > 1 ? ws : dw;
  float* db_out = db == nullptr ? nullptr : (used > 1 ? ws + used * n_dw : db);
  const dim3 grid((Cout + TN - 1) / TN, (Cin + TC - 1) / TC, n_groups * used);
  cudaError_t err;
  if (is_bf16) {
    auto kernel = dw_kernel<__nv_bfloat16>;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<grid, THREADS, smem, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(dz), dw_out, db_out, L, Cin, Cout,
        K, stride, Lout, n_groups, per, n_tiles);
  } else {
    auto kernel = dw_kernel<float>;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<grid, THREADS, smem, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(dz), dw_out,
        db_out, L, Cin, Cout, K, stride, Lout, n_groups, per, n_tiles);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess || used == 1) return (int)err;
  reduce_splits<<<264, 256, 0, s>>>(ws, dw, n_dw, used);
  if (db != nullptr)
    reduce_splits<<<8, 256, 0, s>>>(ws + used * n_dw, db, Cout, used);
  return (int)cudaGetLastError();
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
