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
// The output is int8 (requant), float32 or bfloat16, rounded as the shared
// epilogue's store_out (conv_epilogue.cuh) rounds: the reference's float32
// epilogue.
//
// What bounds it on this card: K multiply-adds per output element for one
// input element read and one output element written. At mamba's prefill
// shape in jamba-1.5-large (B=4, L=259, C=16384, K=4), w8a8 reads 17.0 MB
// of codes and writes 33.6 MB of bfloat16: bound by bytes (about 0.015 ms
// at 3.35 TB/s).
//
// What the design does about it: depthwise_rows.cuh's staged body, shared
// with the float kernel (conv1d_depthwise.cu): a persistent grid planned
// by the wrapper from the card's SM count, work items of R output rows x
// 128 channels streamed through a cp.async ring in pieces as wide as x's
// alignment allows (16 bytes of codes on the main path). This file holds
// the epilogue: the dequant scales and bias of a lane's 4 channels read
// once an item, and each output row's 4 values stored as one vector (8
// bytes of bf16, 16 of f32, 4 of int8 codes).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stddef.h>
#include <stdint.h>

#include "conv_epilogue.cuh"
#include "depthwise_rows.cuh"

namespace {

enum XKind { X_F32 = 0, X_BF16 = 1, X_INT8 = 2 };

__device__ __forceinline__ float as_f32(int a) { return __int2float_rn(a); }
__device__ __forceinline__ float as_f32(float a) { return a; }

struct EpiQuant {
  void* y;
  const float* scale;
  const float* bias;       // may be null
  const float* out_scale;  // the requant grid (y_kind OUT_INT8)
  int C, act, y_kind;
  bool vec;  // y takes vector stores
  float sv[DW_LANE], bv[DW_LANE], os;

  __device__ __forceinline__ void begin(int c0) {
#pragma unroll
    for (int j = 0; j < DW_LANE; ++j) {
      const bool in = c0 + j < C;
      sv[j] = in ? scale[c0 + j] : 0.f;
      bv[j] = bias != nullptr && in ? bias[c0 + j] : 0.f;
    }
    os = y_kind == OUT_INT8 ? *out_scale : 1.f;
  }

  template <typename A>
  __device__ __forceinline__ void store(size_t row, int c0,
                                        const A (&acc)[DW_LANE]) {
    float v[DW_LANE];
#pragma unroll
    for (int j = 0; j < DW_LANE; ++j) {
      v[j] = __fmul_rn(as_f32(acc[j]), sv[j]);
      if (bias != nullptr) v[j] = __fadd_rn(v[j], bv[j]);
    }
    activate_all(v, act);
    if (y_kind == OUT_INT8) {
      alignas(16) int8_t q[DW_LANE];
#pragma unroll
      for (int j = 0; j < DW_LANE; ++j) {
        const float r =
            fminf(fmaxf(rintf(__fdiv_rn(v[j], os)), -127.f), 127.f);
        q[j] = static_cast<int8_t>(__float2int_rn(r));
      }
      store_lane<int8_t>(static_cast<int8_t*>(y) + row, c0, C, q, vec);
    } else if (y_kind == OUT_BF16) {
      alignas(16) __nv_bfloat16 o[DW_LANE];
#pragma unroll
      for (int j = 0; j < DW_LANE; ++j) o[j] = __float2bfloat16(v[j]);
      store_lane<__nv_bfloat16>(static_cast<__nv_bfloat16*>(y) + row, c0, C,
                                o, vec);
    } else {
      alignas(16) float o[DW_LANE];
#pragma unroll
      for (int j = 0; j < DW_LANE; ++j) o[j] = v[j];
      store_lane<float>(static_cast<float*>(y) + row, c0, C, o, vec);
    }
  }
};

template <typename TX, typename A>
cudaError_t launch(const void* x, const void* w, const void* scale,
                   const void* bias, const void* out_scale, void* y,
                   const DwShape& s, int act, int y_kind, int blocks,
                   cudaStream_t stream) {
  const bool vec = y_kind == OUT_INT8   ? store_aligned<int8_t>(y, s.C)
                   : y_kind == OUT_BF16 ? store_aligned<__nv_bfloat16>(y, s.C)
                                        : store_aligned<float>(y, s.C);
  const EpiQuant epi{y, static_cast<const float*>(scale),
                     static_cast<const float*>(bias),
                     static_cast<const float*>(out_scale), s.C, act, y_kind,
                     vec, {}, {}, 0.f};
  return launch_depthwise_k<TX, int8_t, A>(x, w, epi, s, blocks, stream);
}

}  // namespace

// Returns a cudaError_t code: 0 when the launch was accepted. mode: 0 w8a8
// (x int8), 1 w8a16 (x float32 or bfloat16). x_kind: 0 float32, 1
// bfloat16, 2 int8. y_kind: 0 float32, 1 bfloat16, 2 int8 (requant:
// out_scale, a float32 scalar on the card, must not be null). scale is the
// (C,) dequant row; bias may be null. rows, stages and blocks are the
// wrapper's plan (gemm_plan.depthwise_plan), copy_bytes the width x's
// alignment allows its staged pieces (16, 8, 4, 2 or, for int8 codes, 1
// bytes). A shape or plan the kernel does not take is refused with
// cudaErrorInvalidValue.
extern "C" int conv1d_depthwise_quant(const void* x, const void* w,
                                      const void* scale, const void* bias,
                                      const void* out_scale, void* y, int B,
                                      int L, int C, int K, int stride,
                                      int Lout, int act, int mode, int x_kind,
                                      int y_kind, int rows, int stages,
                                      int blocks, int copy_bytes,
                                      void* stream) {
  if (mode == 0 ? x_kind != X_INT8 : (mode != 1 || x_kind == X_INT8 ||
                                      x_kind < 0 || x_kind > 2))
    return (int)cudaErrorInvalidValue;
  DwShape s{L, C, K, stride, Lout, rows, stages, copy_bytes, 0, 0, 0, 0};
  const int elem = x_kind == X_INT8 ? 1 : x_kind == X_BF16 ? 2 : 4;
  if (B < 1 || C < 1 || K < 1 || stride < 1 || Lout < 1 ||
      (long long)(Lout - 1) * stride + K > L || act < 0 || act > 3 ||
      y_kind < 0 || y_kind > 2 ||
      (y_kind == OUT_INT8 && out_scale == nullptr) ||
      !dw_geometry(s, B, elem, blocks) || (uintptr_t)x % copy_bytes != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (mode == 0)
    err = launch<int8_t, int>(x, w, scale, bias, out_scale, y, s, act, y_kind,
                              blocks, st);
  else if (x_kind == X_BF16)
    err = launch<__nv_bfloat16, float>(x, w, scale, bias, out_scale, y, s,
                                       act, y_kind, blocks, st);
  else
    err = launch<float, float>(x, w, scale, bias, out_scale, y, s, act,
                               y_kind, blocks, st);
  return (int)err;
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
