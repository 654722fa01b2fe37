// Shared by the float depthwise kernels (conv1d_depthwise.cu and
// conv1d_depthwise_bwd.cu): each thread owns N neighbouring channels, 16
// bytes of a row (4 float32 or 8 bfloat16 values), and moves a row's N
// values as one 16-byte access when the channel count and the bases allow
// it (ALIGNED), else as scalar accesses masked at C.
#pragma once

#include <cuda_bf16.h>
#include <stddef.h>
#include <stdint.h>

#include "conv_epilogue.cuh"

namespace {

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

// N values cast to T stored from channel c0 on: one 16-byte store when
// ALIGNED, else scalar stores masked at C
template <typename T, bool ALIGNED, int N = VecOf<T>::N>
__device__ __forceinline__ void store_vals(T* __restrict__ row, int c0, int C,
                                           const T (&v)[N]) {
  if (ALIGNED) {
    *reinterpret_cast<uint4*>(row + c0) = *reinterpret_cast<const uint4*>(v);
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j)
      if (c0 + j < C) row[c0 + j] = v[j];
  }
}

}  // namespace
