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
// tanh approximation, silu. With a z pointer (training, the Pallas
// kernel's save_preact), the post-bias sum bias[c] + sum_k ... is written
// to z (y's shape and type) by the same epilogue; serving passes null and
// runs an instance compiled without that store.
//
// What bounds it on this card: each output element costs K multiply-adds
// for one input element read and one output element written. At mamba's
// prefill shape in jamba-1.5-large (B=4, L=259, C=16384, K=4, bf16) that
// is 0.13 GFLOP against 67 MB of traffic: it is bound by bytes (about
// 0.020 ms at 3.35 TB/s).
//
// What the design does about it: depthwise_rows.cuh's staged body, shared
// with the int8 kernel (conv1d_depthwise_quant.cu): a persistent grid
// planned by the wrapper from the card's SM count, each block streaming
// work items of R output rows x 128 channels through a cp.async ring of
// shared-memory stages, so that several MB are in flight across the card.
// This file holds the epilogue: bias, activation and the cast of a lane's
// 4 channels, stored as one 8-byte (bf16) or 16-byte (f32) vector, and
// with SAVE_Z the post-bias sum to z the same way; bias is read once an
// item.
// The Pallas kernel's c_block tiling is a VMEM choice with no counterpart
// here: channels are independent.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stddef.h>
#include <stdint.h>

#include "conv_epilogue.cuh"
#include "depthwise_rows.cuh"

namespace {

template <typename T, bool SAVE_Z>
struct EpiFp {
  T* y;
  T* z;
  const float* bias;  // may be null
  int C, act;
  bool vec;  // y and z take vector stores
  float bv[DW_LANE];

  __device__ __forceinline__ void begin(int c0) {
#pragma unroll
    for (int j = 0; j < DW_LANE; ++j)
      bv[j] = bias != nullptr && c0 + j < C ? bias[c0 + j] : 0.f;
  }

  __device__ __forceinline__ void store(size_t row, int c0,
                                        const float (&acc)[DW_LANE]) {
    float v[DW_LANE];
    alignas(16) T out[DW_LANE];
    alignas(16) T pre[DW_LANE];
#pragma unroll
    for (int j = 0; j < DW_LANE; ++j) {
      v[j] = bias != nullptr ? __fadd_rn(acc[j], bv[j]) : acc[j];
      if (SAVE_Z) pre[j] = from_f32<T>(v[j]);
    }
    activate_all(v, act);
#pragma unroll
    for (int j = 0; j < DW_LANE; ++j) out[j] = from_f32<T>(v[j]);
    store_lane<T>(y + row, c0, C, out, vec);
    if (SAVE_Z) store_lane<T>(z + row, c0, C, pre, vec);
  }
};

template <typename T, bool SAVE_Z>
cudaError_t launch_z(const void* x, const void* w, const void* bias, void* y,
                     void* z, const DwShape& s, int act, int blocks,
                     cudaStream_t stream) {
  EpiFp<T, SAVE_Z> epi{static_cast<T*>(y), static_cast<T*>(z),
                       static_cast<const float*>(bias), s.C, act,
                       store_aligned<T>(y, s.C) && store_aligned<T>(z, s.C),
                       {}};
  return launch_depthwise_k<T, T, float>(x, w, epi, s, blocks, stream);
}

template <typename T>
cudaError_t launch(const void* x, const void* w, const void* bias, void* y,
                   void* z, const DwShape& s, int act, int blocks,
                   cudaStream_t stream) {
  return z != nullptr
             ? launch_z<T, true>(x, w, bias, y, z, s, act, blocks, stream)
             : launch_z<T, false>(x, w, bias, y, z, s, act, blocks, stream);
}

}  // namespace

// Returns a cudaError_t code: 0 when the launch was accepted. bias may be
// null; z may be null (serving: no pre-activation is written). rows,
// stages and blocks are the wrapper's plan (gemm_plan.depthwise_plan),
// copy_bytes the width x's alignment allows its staged pieces (16, 8, 4, 2
// bytes). A shape or plan the kernel does not take is refused with
// cudaErrorInvalidValue.
extern "C" int conv1d_depthwise(const void* x, const void* w,
                                const void* bias, void* y, void* z, int B,
                                int L, int C, int K, int stride, int Lout,
                                int act, int is_bf16, int rows, int stages,
                                int blocks, int copy_bytes, void* stream) {
  DwShape s{L, C, K, stride, Lout, rows, stages, copy_bytes, 0, 0, 0, 0};
  const int elem = is_bf16 ? 2 : 4;
  if (B < 1 || C < 1 || K < 1 || stride < 1 || Lout < 1 ||
      (long long)(Lout - 1) * stride + K > L || act < 0 || act > 3 ||
      !dw_geometry(s, B, elem, blocks) || copy_bytes < 2 ||
      (uintptr_t)x % copy_bytes != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      is_bf16 ? launch<__nv_bfloat16>(x, w, bias, y, z, s, act, blocks, st)
              : launch<float>(x, w, bias, y, z, s, act, blocks, st);
  return (int)err;
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
