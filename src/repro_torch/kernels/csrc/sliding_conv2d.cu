// Sliding-window conv2d with a fused bias + activation epilogue, for Hopper
// (sm_90a).
//
// Replaces: src/repro/kernels/sliding_conv2d.py, conv2d_sliding_pallas (the
// custom / generic / compound kernel bodies, their Cin-block f32 revisit
// and the fused epilogue).
//
// What it computes: VALID conv2d, NHWC input and HWIO weights, on an input
// the caller has already padded,
//   y[b, oy, ox, n] = act(bias[n] + sum_{i, j, c} w[i, j, c, n]
//                         * x[b, oy*sh + i, ox*sw + j, c])
// with x (B, H, W, Cin), w (kh, kw, Cin, Cout), bias (Cout,) float32 or
// absent, and y (B, oh, ow, Cout) in x's type. float32 or bfloat16
// operands; the sum is always taken in float32 and never in TF32. act:
// none, relu, gelu with the tanh approximation, silu.
//
// What bounds it on this card: at llava's patch embedding (x (20, 336, 336,
// 3), w (14, 14, 3, 1152), stride 14) the work is 15.6 GFLOP against 40 MB
// of traffic (bf16), so it is bound by arithmetic: 0.016 ms on the bf16
// tensor cores, 0.23 ms on the CUDA cores' float32 rate. This kernel sums
// on the CUDA cores in float32 (both types), so the second is its ceiling;
// tensor-core (wgmma) tiles for bf16 are later work.
//
// What the design does about it: the tiling and main loop of
// conv2d_rows.cuh (shared with the int8 conv2d's w8a16 kernel): 64 output
// pixels x 64 output channels a block, a 4x4 register tile of float32 sums
// a thread, one filter row staged at a time so that the reduction over a
// row runs over its (tap, channel) pairs together, every pixel's operand
// an offset into the same staged input row (the paper's vector slide): no
// im2col buffer in device memory. Staging one filter row at a time (the
// compound regime's ROW_CHUNK taken to 1) keeps shared memory independent
// of kh and wastes no staged rows at strides above 1: at the patch
// embedding (kw*CC = 42, stride = kernel) each staged row is read by
// exactly one output row, with no gaps. The epilogue (bias, activation,
// cast) runs once, after the last chunk; with z it also stores the
// post-bias pre-activation in y's type (the residual the backward pass
// forms dz = dy * act'(z) from). The custom / generic / compound split is
// a TPU tiling choice (how taps group in VMEM); this one kernel covers
// every kh, kw >= 1 and every stride >= 1.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stddef.h>

#include "conv2d_rows.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(THREADS)
sliding_conv2d_kernel(const T* __restrict__ x, const T* __restrict__ w,
                      const float* __restrict__ bias, T* __restrict__ y,
                      T* __restrict__ z, int H, int W, int Cin, int Cout,
                      int kh, int kw, int sh, int sw, int oh, int ow, int tw,
                      int cc, int tiles_w, int act) {
  extern __shared__ __align__(16) float smem[];
  float acc[RM][RN];
  sum_rows<T, T>(x, w, smem, H, W, Cin, Cout, kh, kw, sh, sw, tw, cc,
                 tiles_w, acc);

  // epilogue, once per output element: bias, activation, cast, store
  const int th = TM / tw;
  const int b = blockIdx.z;
  const int oy0 = (blockIdx.x / tiles_w) * th;
  const int ox0 = (blockIdx.x % tiles_w) * tw;
  const int n0 = blockIdx.y * TN;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int m = ty + 16 * i;
    const int oy = oy0 + m / tw, ox = ox0 + m % tw;
    if (oy >= oh || ox >= ow) continue;
    const size_t row = (((size_t)b * oh + oy) * ow + ox) * Cout;
#pragma unroll
    for (int j = 0; j < RN; ++j) {
      const int n = n0 + tx * RN + j;
      if (n >= Cout) continue;
      float v = acc[i][j];
      if (bias != nullptr) v += bias[n];
      if (z != nullptr) z[row + n] = from_f32<T>(v);
      y[row + n] = from_f32<T>(activate(v, act));
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* w, const void* bias, void* y,
                   void* z, int B, int H, int W, int Cin, int Cout, int kh,
                   int kw, int sh, int sw, int oh, int ow, int act,
                   const Tiling& t, cudaStream_t stream) {
  auto kernel = sliding_conv2d_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)t.smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(t.tiles_h * t.tiles_w, (Cout + TN - 1) / TN, B);
  kernel<<<grid, THREADS, t.smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const float*>(bias), static_cast<T*>(y), static_cast<T*>(z),
      H, W, Cin, Cout, kh, kw, sh, sw, oh, ow, t.tw, t.cc, t.tiles_w, act);
  return cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t code: 0 when the launch was accepted. A shape whose
// staged rows exceed the card's shared memory even at one channel a chunk
// (a filter row wider than about 3,000 columns) is refused with
// cudaErrorInvalidValue, as is a grid the card cannot launch. bias and z
// may be null.
extern "C" int sliding_conv2d(const void* x, const void* w, const void* bias,
                              void* y, void* z, int B, int H, int W, int Cin,
                              int Cout, int kh, int kw, int sh, int sw,
                              int oh, int ow, int act, int is_bf16,
                              void* stream) {
  if (B < 1 || B > 65535 || Cin < 1 || Cout < 1 || kh < 1 || kw < 1 ||
      sh < 1 || sw < 1 || oh < 1 || ow < 1 || (oh - 1) * sh + kh > H ||
      (ow - 1) * sw + kw > W || act < 0 || act > 3 ||
      (Cout + TN - 1) / TN > 65535)
    return (int)cudaErrorInvalidValue;
  const Tiling t = choose_tiling(Cin, kw, sw, oh, ow);
  if (t.smem > 227 * 1024 || (long)t.tiles_h * t.tiles_w > 0x7fffffffL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      is_bf16 ? launch<__nv_bfloat16>(x, w, bias, y, z, B, H, W, Cin, Cout, kh,
                                      kw, sh, sw, oh, ow, act, t, s)
              : launch<float>(x, w, bias, y, z, B, H, W, Cin, Cout, kh, kw, sh,
                              sw, oh, ow, act, t, s);
  return (int)err;
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
