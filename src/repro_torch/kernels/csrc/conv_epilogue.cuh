// Shared by the conv kernels (sliding_conv1d.cu, sliding_conv_quant.cu,
// conv1d_depthwise.cu, conv1d_depthwise_quant.cu): the epilogue's
// activation, the float/bf16 conversions and the int8 kernels' dequant,
// bias, activation and requant store. Every kernel library compiles it
// into its own translation unit; build.py keys each library on this
// header's text too.
#pragma once

#include <cuda_bf16.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

enum Act { ACT_NONE = 0, ACT_RELU = 1, ACT_GELU = 2, ACT_SILU = 3 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(
    float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float activate(float x, int act) {
  switch (act) {
    case ACT_RELU:
      return fmaxf(x, 0.f);
    case ACT_GELU: {  // jax.nn.gelu(approximate=True)
      const float c = 0.7978845608028654f;  // sqrt(2/pi)
      return 0.5f * x * (1.f + tanhf(c * (x + 0.044715f * x * x * x)));
    }
    case ACT_SILU:
      return x / (1.f + expf(-x));
    default:
      return x;
  }
}

enum Out { OUT_F32 = 0, OUT_BF16 = 1, OUT_INT8 = 2 };

// The int8 kernels' epilogue: dequant, bias, activation, then the store:
// int8 on the out_scale grid, or float32 / bfloat16. The multiply, add and
// divide are IEEE round-to-nearest operations that the compiler may not
// contract into an FMA, and rint rounds half to even, so from the same sum
// it rounds as the reference's float32 epilogue does.
__device__ __forceinline__ void store_out(void* y, size_t idx, float acc,
                                          float s, const float* bias, int n,
                                          int act, const float* out_scale,
                                          int y_kind) {
  float v = __fmul_rn(acc, s);
  if (bias != nullptr) v = __fadd_rn(v, bias[n]);
  v = activate(v, act);
  if (y_kind == OUT_INT8) {
    float q = rintf(__fdiv_rn(v, *out_scale));
    q = fminf(fmaxf(q, -127.f), 127.f);
    static_cast<int8_t*>(y)[idx] = static_cast<int8_t>(__float2int_rn(q));
  } else if (y_kind == OUT_BF16) {
    static_cast<__nv_bfloat16*>(y)[idx] = __float2bfloat16(v);
  } else {
    static_cast<float*>(y)[idx] = v;
  }
}

}  // namespace
