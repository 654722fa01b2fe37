// Shared by the sliding conv1d kernels (sliding_conv1d.cu,
// sliding_conv_quant.cu): the epilogue's activation and the float/bf16
// conversions. Every kernel library compiles it into its own translation
// unit; build.py keys each library on this header's text too.
#pragma once

#include <cuda_bf16.h>
#include <math.h>

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

}  // namespace
