// Depthwise sliding-window conv1d with a fused bias + activation epilogue,
// for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/sliding_conv1d.py, conv1d_depthwise_pallas
// (body _kernel_depthwise: one shifted elementwise multiply-add per tap,
// then _epilogue).
//
// What it computes: VALID depthwise conv1d on an input the caller has
// already padded,
//   y[b, i, c] = act(bias[c] + sum_k w[k, c] * x[b, i*stride + k, c])
// with x (B, L, C), w (K, C) of x's type, bias (C,) float32 or absent, and
// y (B, Lout, C) in x's type. float32 or bfloat16 operands; the products
// and the sum are float32, taken tap by tap in order k = 0 .. K-1 with
// IEEE round-to-nearest multiplies and adds (no FMA contraction), the
// order and rounding of the plain version. act: none, relu, gelu with the
// tanh approximation, silu.
//
// What bounds it on this card: each output element costs K multiply-adds
// for one input element read and one output element written. At mamba's
// prefill shape in jamba-1.5-large (B=4, L=259, C=16384, K=4, bf16) that
// is 0.13 GFLOP against 67 MB of traffic: it is bound by bytes (about
// 0.020 ms at 3.35 TB/s).
//
// What the design does about it: channels are contiguous, so each thread
// owns VEC neighbouring channels (16 bytes of x: 4 float32 or 8 bfloat16)
// and a warp reads 512 contiguous bytes of a row with one load each. The
// thread walks TL output rows of one batch row keeping the K input rows of
// the current window in registers; moving to the next output row loads
// only the `stride` new rows, so every input row is read once per tile,
// plus a (K-1)-row halo per tile that the L2 serves. Its weights (K x VEC)
// stay in registers for the whole tile, and the epilogue stores each
// output row as one 16-byte vector. The window is unrolled at compile time
// for K in {2, 3, 4} (mamba's K is 4); other K read each tap's row per
// output row, through the L1. Channel counts that are not a multiple of
// VEC, or bases that are not 16-byte aligned, take the same code with
// scalar loads and stores masked at C. The Pallas kernel's c_block tiling
// is a VMEM choice with no counterpart here: channels are independent.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stddef.h>
#include <stdint.h>

#include "conv_epilogue.cuh"

namespace {

constexpr int TL = 16;        // output rows per thread
constexpr int THREADS = 128;  // channel vectors per block

template <typename T> struct VecOf;  // values of T in 16 bytes
template <> struct VecOf<float> { static constexpr int N = 4; };
template <> struct VecOf<__nv_bfloat16> { static constexpr int N = 8; };

// N values of a row from channel c0 on, as floats: one 16-byte load when
// ALIGNED (then c0 + N <= C), else scalar loads, zero past C
template <typename T, bool ALIGNED, int N = VecOf<T>::N>
__device__ __forceinline__ void load_row(const T* __restrict__ row, int c0,
                                         int C, float (&out)[N]) {
  if (ALIGNED) {
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(row + c0));
    const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int j = 0; j < N; ++j) out[j] = to_f32(v[j]);
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j)
      out[j] = c0 + j < C ? to_f32(row[c0 + j]) : 0.f;
  }
}

// bias, activation and the cast of one output row's N channels, stored as
// one 16-byte vector when ALIGNED
template <typename T, bool ALIGNED, int N = VecOf<T>::N>
__device__ __forceinline__ void store_row(T* __restrict__ row, int c0, int C,
                                          const float (&acc)[N],
                                          const float* __restrict__ bias,
                                          int act) {
  alignas(16) T out[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    float v = acc[j];
    if (bias != nullptr && c0 + j < C) v = __fadd_rn(v, bias[c0 + j]);
    out[j] = from_f32<T>(activate(v, act));
  }
  if (ALIGNED) {
    *reinterpret_cast<uint4*>(row + c0) = *reinterpret_cast<const uint4*>(out);
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j)
      if (c0 + j < C) row[c0 + j] = out[j];
  }
}

// KW > 0: the window of KW rows in registers (K == KW); KW == 0: any K,
// each tap's row loaded per output row
template <typename T, int KW, bool ALIGNED>
__global__ void __launch_bounds__(THREADS)
depthwise_kernel(const T* __restrict__ x, const T* __restrict__ w,
                 const float* __restrict__ bias, T* __restrict__ y, int L,
                 int C, int K, int stride, int Lout, int act) {
  constexpr int N = VecOf<T>::N;
  const int c0 = (blockIdx.x * THREADS + threadIdx.x) * N;
  if (c0 >= C) return;
  const int b = blockIdx.z;
  const int r0 = blockIdx.y * TL;
  const int r1 = min(r0 + TL, Lout);
  const T* xb = x + (size_t)b * L * C;
  T* yb = y + (size_t)b * Lout * C;

  if constexpr (KW > 0) {
    float wr[KW][N];
#pragma unroll
    for (int k = 0; k < KW; ++k)
      load_row<T, ALIGNED>(w + (size_t)k * C, c0, C, wr[k]);
    float win[KW][N];  // input rows r*stride .. r*stride + KW-1
#pragma unroll
    for (int k = 0; k < KW; ++k)
      load_row<T, ALIGNED>(xb + (size_t)(r0 * stride + k) * C, c0, C, win[k]);
    for (int r = r0; r < r1; ++r) {
      if (r > r0) {
        const int first = r * stride;
        if (stride >= KW) {  // no row of the last window is reused
#pragma unroll
          for (int k = 0; k < KW; ++k)
            load_row<T, ALIGNED>(xb + (size_t)(first + k) * C, c0, C, win[k]);
        } else {
          for (int s = 0; s < stride; ++s) {
#pragma unroll
            for (int k = 0; k + 1 < KW; ++k)
#pragma unroll
              for (int j = 0; j < N; ++j) win[k][j] = win[k + 1][j];
            load_row<T, ALIGNED>(
                xb + (size_t)(first + KW - stride + s) * C, c0, C,
                win[KW - 1]);
          }
        }
      }
      float acc[N];
#pragma unroll
      for (int j = 0; j < N; ++j) acc[j] = __fmul_rn(win[0][j], wr[0][j]);
#pragma unroll
      for (int k = 1; k < KW; ++k)
#pragma unroll
        for (int j = 0; j < N; ++j)
          acc[j] = __fadd_rn(acc[j], __fmul_rn(win[k][j], wr[k][j]));
      store_row<T, ALIGNED>(yb + (size_t)r * C, c0, C, acc, bias, act);
    }
  } else {
    for (int r = r0; r < r1; ++r) {
      float acc[N], xv[N], wv[N];
      for (int k = 0; k < K; ++k) {
        load_row<T, ALIGNED>(xb + (size_t)(r * stride + k) * C, c0, C, xv);
        load_row<T, ALIGNED>(w + (size_t)k * C, c0, C, wv);
#pragma unroll
        for (int j = 0; j < N; ++j)
          acc[j] = k == 0 ? __fmul_rn(xv[j], wv[j])
                          : __fadd_rn(acc[j], __fmul_rn(xv[j], wv[j]));
      }
      store_row<T, ALIGNED>(yb + (size_t)r * C, c0, C, acc, bias, act);
    }
  }
}

template <typename T, int KW>
cudaError_t launch_k(bool aligned, const void* x, const void* w,
                     const void* bias, void* y, int B, int L, int C, int K,
                     int stride, int Lout, int act, cudaStream_t stream) {
  constexpr int N = VecOf<T>::N;
  const int vecs = (C + N - 1) / N;
  const dim3 grid((vecs + THREADS - 1) / THREADS, (Lout + TL - 1) / TL, B);
  auto kernel = aligned ? depthwise_kernel<T, KW, true>
                        : depthwise_kernel<T, KW, false>;
  kernel<<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const float*>(bias), static_cast<T*>(y), L, C, K, stride,
      Lout, act);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* x, const void* w, const void* bias, void* y,
                   int B, int L, int C, int K, int stride, int Lout, int act,
                   cudaStream_t stream) {
  constexpr int N = VecOf<T>::N;
  const bool aligned = C % N == 0 && (uintptr_t)x % 16 == 0 &&
                       (uintptr_t)w % 16 == 0 && (uintptr_t)y % 16 == 0;
  switch (K) {
    case 2:
      return launch_k<T, 2>(aligned, x, w, bias, y, B, L, C, K, stride, Lout,
                            act, stream);
    case 3:
      return launch_k<T, 3>(aligned, x, w, bias, y, B, L, C, K, stride, Lout,
                            act, stream);
    case 4:
      return launch_k<T, 4>(aligned, x, w, bias, y, B, L, C, K, stride, Lout,
                            act, stream);
    default:
      return launch_k<T, 0>(aligned, x, w, bias, y, B, L, C, K, stride, Lout,
                            act, stream);
  }
}

}  // namespace

// Returns a cudaError_t code: 0 when the launch was accepted. bias may be
// null. A shape the grid cannot hold is refused with cudaErrorInvalidValue.
extern "C" int conv1d_depthwise(const void* x, const void* w,
                                const void* bias, void* y, int B, int L,
                                int C, int K, int stride, int Lout, int act,
                                int is_bf16, void* stream) {
  if (B < 1 || B > 65535 || C < 1 || K < 1 || stride < 1 || Lout < 1 ||
      (Lout + TL - 1) / TL > 65535 || (Lout - 1) * stride + K > L ||
      act < 0 || act > 3)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      is_bf16 ? launch<__nv_bfloat16>(x, w, bias, y, B, L, C, K, stride, Lout,
                                      act, s)
              : launch<float>(x, w, bias, y, B, L, C, K, stride, Lout, act, s);
  return (int)err;
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
