// int8 quantized depthwise sliding-window conv1d with a fused dequant,
// bias, activation and optional requant epilogue, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/sliding_conv_quant.py,
// conv1d_depthwise_quant_pallas (body _qkernel_depthwise: one shifted
// elementwise multiply-add per tap, then _dequant_epilogue).
//
// What it computes: VALID depthwise conv1d on an input the caller has
// already padded,
//   acc[b, i, c] = sum_k w_q[k, c] * x[b, i*stride + k, c]
//   y = act(acc * s[c] + bias[c]), then optionally
//   y = clip(rint(y / out_scale), -127, 127) as int8 (requant),
// with w_q int8 (K, C), s float32 (C,), bias float32 or absent. Two modes:
//   w8a8:  x is int8 codes; the products are int8 x int8, summed exactly in
//          int32; s = w_scale * x_scale, formed by the caller in float32
//          (the reference multiplies the two scales first).
//   w8a16: x is float32 or bfloat16; the weight codes are widened to float
//          in registers and the products and sum are float32, tap by tap in
//          order with IEEE round-to-nearest multiplies and adds (no FMA
//          contraction), as the plain version sums them; s = w_scale.
// The output is int8 (requant), float32 or bfloat16, stored by the shared
// epilogue (conv_epilogue.cuh, store_out), which rounds as the reference's
// float32 epilogue does.
//
// What bounds it on this card: K multiply-adds per output element for one
// input element read and one output element written. At mamba's prefill
// shape in jamba-1.5-large (B=4, L=259, C=16384, K=4), w8a8 reads 17.0 MB
// of codes and writes 33.6 MB of bfloat16: bound by bytes (about 0.015 ms
// at 3.35 TB/s).
//
// What the design does about it: the fp depthwise kernel's
// (conv1d_depthwise.cu). Channels are contiguous; each thread owns N
// neighbouring channels (8 int8 codes, 4 float32 or 8 bfloat16 values: one
// 8- or 16-byte load) and walks TL output rows of one batch row, keeping
// the K input rows of the current window in registers, widened to the
// accumulator's type (int32 or float32), so every input row is read once
// per tile plus a (K-1)-row halo. Its weight codes and dequant scales stay
// in registers for the whole tile. The window is unrolled at compile time
// for K in {2, 3, 4}; other K read each tap's row per output row. Channel
// counts that are not a multiple of N, or unaligned bases, take scalar
// loads masked at C. Channels are independent, so the Pallas kernel's
// c_block tiling has no counterpart here.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stddef.h>
#include <stdint.h>

#include "conv_epilogue.cuh"

namespace {

constexpr int TL = 16;        // output rows per thread
constexpr int THREADS = 128;  // channel groups per block

enum XKind { X_F32 = 0, X_BF16 = 1, X_INT8 = 2 };

template <int BYTES> struct Raw;  // one load of BYTES bytes
template <> struct Raw<4> { using type = unsigned int; };
template <> struct Raw<8> { using type = uint2; };
template <> struct Raw<16> { using type = uint4; };

// channels per thread: 16 bytes of a float input, 8 codes of an int8 one
template <typename TX> struct Lanes { static constexpr int N = 16 / sizeof(TX); };
template <> struct Lanes<int8_t> { static constexpr int N = 8; };

// widening to the accumulator's type: int32 (w8a8) or float32 (w8a16)
template <typename A> __device__ __forceinline__ A widen(int8_t v) {
  return static_cast<A>(v);
}
template <typename A> __device__ __forceinline__ A widen(float v) { return v; }
template <typename A> __device__ __forceinline__ A widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ int mul(int a, int b) { return a * b; }
__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ int add(int a, int b) { return a + b; }
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float as_f32(int a) { return __int2float_rn(a); }
__device__ __forceinline__ float as_f32(float a) { return a; }

// N values of T from channel c0 on, widened to A: one load of N values
// when ALIGNED (then c0 + N <= C), else scalar loads, zero past C
template <typename A, typename T, int N, bool ALIGNED>
__device__ __forceinline__ void load_vals(const T* __restrict__ row, int c0,
                                          int C, A (&out)[N]) {
  if (ALIGNED) {
    using R = typename Raw<static_cast<int>(N * sizeof(T))>::type;
    const R raw = __ldg(reinterpret_cast<const R*>(row + c0));
    const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int j = 0; j < N; ++j) out[j] = widen<A>(v[j]);
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j)
      out[j] = c0 + j < C ? widen<A>(row[c0 + j]) : A(0);
  }
}

// KW > 0: the window of KW rows in registers (K == KW); KW == 0: any K,
// each tap's row loaded per output row. A: int (w8a8) or float (w8a16).
template <typename TX, typename A, int KW, bool ALIGNED>
__global__ void __launch_bounds__(THREADS)
depthwise_quant_kernel(const TX* __restrict__ x, const int8_t* __restrict__ w,
                       const float* __restrict__ scale,
                       const float* __restrict__ bias,
                       const float* __restrict__ out_scale,
                       void* __restrict__ y, int L, int C, int K, int stride,
                       int Lout, int act, int y_kind) {
  constexpr int N = Lanes<TX>::N;
  const int c0 = (blockIdx.x * THREADS + threadIdx.x) * N;
  if (c0 >= C) return;
  const int b = blockIdx.z;
  const int r0 = blockIdx.y * TL;
  const int r1 = min(r0 + TL, Lout);
  const TX* xb = x + (size_t)b * L * C;
  float sc[N];
#pragma unroll
  for (int j = 0; j < N; ++j) sc[j] = c0 + j < C ? scale[c0 + j] : 0.f;

  auto store = [&](int r, const A (&acc)[N]) {
    const size_t row = ((size_t)b * Lout + r) * C;
#pragma unroll
    for (int j = 0; j < N; ++j)
      if (c0 + j < C)
        store_out(y, row + c0 + j, as_f32(acc[j]), sc[j], bias, c0 + j, act,
                  out_scale, y_kind);
  };

  if constexpr (KW > 0) {
    A wr[KW][N];
#pragma unroll
    for (int k = 0; k < KW; ++k)
      load_vals<A, int8_t, N, ALIGNED>(w + (size_t)k * C, c0, C, wr[k]);
    A win[KW][N];  // input rows r*stride .. r*stride + KW-1
#pragma unroll
    for (int k = 0; k < KW; ++k)
      load_vals<A, TX, N, ALIGNED>(xb + (size_t)(r0 * stride + k) * C, c0, C,
                                   win[k]);
    for (int r = r0; r < r1; ++r) {
      if (r > r0) {
        const int first = r * stride;
        if (stride >= KW) {  // no row of the last window is reused
#pragma unroll
          for (int k = 0; k < KW; ++k)
            load_vals<A, TX, N, ALIGNED>(xb + (size_t)(first + k) * C, c0, C,
                                         win[k]);
        } else {
          for (int s = 0; s < stride; ++s) {
#pragma unroll
            for (int k = 0; k + 1 < KW; ++k)
#pragma unroll
              for (int j = 0; j < N; ++j) win[k][j] = win[k + 1][j];
            load_vals<A, TX, N, ALIGNED>(
                xb + (size_t)(first + KW - stride + s) * C, c0, C,
                win[KW - 1]);
          }
        }
      }
      A acc[N];
#pragma unroll
      for (int j = 0; j < N; ++j) acc[j] = mul(win[0][j], wr[0][j]);
#pragma unroll
      for (int k = 1; k < KW; ++k)
#pragma unroll
        for (int j = 0; j < N; ++j)
          acc[j] = add(acc[j], mul(win[k][j], wr[k][j]));
      store(r, acc);
    }
  } else {
    for (int r = r0; r < r1; ++r) {
      A acc[N], xv[N], wv[N];
      for (int k = 0; k < K; ++k) {
        load_vals<A, TX, N, ALIGNED>(xb + (size_t)(r * stride + k) * C, c0, C,
                                     xv);
        load_vals<A, int8_t, N, ALIGNED>(w + (size_t)k * C, c0, C, wv);
#pragma unroll
        for (int j = 0; j < N; ++j)
          acc[j] = k == 0 ? mul(xv[j], wv[j]) : add(acc[j], mul(xv[j], wv[j]));
      }
      store(r, acc);
    }
  }
}

template <typename TX, typename A, int KW>
cudaError_t launch_k(bool aligned, const void* x, const void* w,
                     const void* scale, const void* bias,
                     const void* out_scale, void* y, int B, int L, int C,
                     int K, int stride, int Lout, int act, int y_kind,
                     cudaStream_t stream) {
  constexpr int N = Lanes<TX>::N;
  const int groups = (C + N - 1) / N;
  const dim3 grid((groups + THREADS - 1) / THREADS, (Lout + TL - 1) / TL, B);
  auto kernel = aligned ? depthwise_quant_kernel<TX, A, KW, true>
                        : depthwise_quant_kernel<TX, A, KW, false>;
  kernel<<<grid, THREADS, 0, stream>>>(
      static_cast<const TX*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<const float*>(out_scale), y, L, C, K, stride, Lout, act,
      y_kind);
  return cudaGetLastError();
}

template <typename TX, typename A>
cudaError_t launch(const void* x, const void* w, const void* scale,
                   const void* bias, const void* out_scale, void* y, int B,
                   int L, int C, int K, int stride, int Lout, int act,
                   int y_kind, cudaStream_t stream) {
  constexpr int N = Lanes<TX>::N;
  // a thread's N values of x and its N weight codes, each one aligned load
  const bool aligned = C % N == 0 &&
                       (uintptr_t)x % (N * sizeof(TX)) == 0 &&
                       (uintptr_t)w % N == 0;
#define DW_LAUNCH(KW)                                                        \
  launch_k<TX, A, KW>(aligned, x, w, scale, bias, out_scale, y, B, L, C, K, \
                      stride, Lout, act, y_kind, stream)
  switch (K) {
    case 2:
      return DW_LAUNCH(2);
    case 3:
      return DW_LAUNCH(3);
    case 4:
      return DW_LAUNCH(4);
    default:
      return DW_LAUNCH(0);
  }
#undef DW_LAUNCH
}

}  // namespace

// Returns a cudaError_t code: 0 when the launch was accepted. mode: 0 w8a8
// (x int8), 1 w8a16 (x float32 or bfloat16). x_kind: 0 float32, 1
// bfloat16, 2 int8. y_kind: 0 float32, 1 bfloat16, 2 int8 (requant:
// out_scale, a float32 scalar on the card, must not be null). scale is the
// (C,) dequant row; bias may be null. A shape the grid cannot hold is
// refused with cudaErrorInvalidValue.
extern "C" int conv1d_depthwise_quant(const void* x, const void* w,
                                      const void* scale, const void* bias,
                                      const void* out_scale, void* y, int B,
                                      int L, int C, int K, int stride,
                                      int Lout, int act, int mode, int x_kind,
                                      int y_kind, void* stream) {
  if (B < 1 || B > 65535 || C < 1 || K < 1 || stride < 1 || Lout < 1 ||
      (Lout + TL - 1) / TL > 65535 || (Lout - 1) * stride + K > L ||
      act < 0 || act > 3 || y_kind < 0 || y_kind > 2 ||
      (y_kind == OUT_INT8 && out_scale == nullptr))
    return (int)cudaErrorInvalidValue;
  if (mode == 0 ? x_kind != X_INT8 : (mode != 1 || x_kind == X_INT8 ||
                                      x_kind < 0 || x_kind > 2))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (mode == 0)
    err = launch<int8_t, int>(x, w, scale, bias, out_scale, y, B, L, C, K,
                              stride, Lout, act, y_kind, s);
  else if (x_kind == X_BF16)
    err = launch<__nv_bfloat16, float>(x, w, scale, bias, out_scale, y, B, L,
                                       C, K, stride, Lout, act, y_kind, s);
  else
    err = launch<float, float>(x, w, scale, bias, out_scale, y, B, L, C, K,
                               stride, Lout, act, y_kind, s);
  return (int)err;
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
