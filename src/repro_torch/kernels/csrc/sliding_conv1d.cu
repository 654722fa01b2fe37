// Sliding-window conv1d with a fused bias + activation epilogue, for Hopper
// (sm_90a).
//
// Replaces: src/repro/kernels/sliding_conv1d.py, conv1d_sliding_pallas (the
// custom / generic / compound kernel bodies and their channel-blocked f32
// revisit, _reduce_store and _epilogue).
//
// What it computes: VALID conv1d on an input the caller has already padded,
//   y[b, i, n] = act(bias[n] + sum_k sum_c w[k, c, n] * x[b, i*stride + k, c])
// with x (B, L, Cin), w (K, Cin, Cout), bias (Cout,) float32 or absent, and
// y (B, Lout, Cout) in x's type. float32 or bfloat16 operands; the sum is
// always taken in float32 and never in TF32. act: none, relu, gelu with the
// tanh approximation, silu. When z is not null the same epilogue also
// stores z = bias + sum, the post-bias pre-activation in y's type (the
// reference's save_preact output, kept for the backward pass).
//
// What bounds it on this card: at the shapes that whisper's frontend gives
// it (B=4, L=514, 80->1024 at stride 1 and 1024->1024 at stride 2) the work
// is 1.0 and 6.4 GFLOP against 10 and 25 MB of traffic, so it is bound by
// arithmetic. The f32 operands must not go through TF32 tensor cores, so the
// ceiling is the CUDA cores' float32 rate (67 TFLOP/s on an H100 SXM).
//
// What the design does about it: each block owns TL output rows x TN output
// channels. For each chunk of CC input channels it stages the input halo of
// (TL-1)*stride + K rows in shared memory once, then walks the filter taps in
// slices of KT, staging the matching (KT, CC, TN) weight slice; every tap is
// an address offset into the same halo (the paper's vector slide), so no
// im2col buffer exists in device memory and each input row is read from
// device memory once per (row tile, channel tile). Each thread keeps a 4x4
// register tile of float32 accumulators across all channel chunks and taps:
// the Pallas kernel's revisit grid dimension over Cin blocks with its f32
// scratch becomes this loop inside the block. The epilogue (bias,
// activation, cast) runs once, after the last chunk. The custom / generic /
// compound split is a TPU tiling choice; this one kernel covers every K >= 1
// and every stride >= 1. Tensor-core (wgmma) tiles for bf16 are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stddef.h>

#include "conv_epilogue.cuh"

namespace {

constexpr int TL = 64;         // output rows per block
constexpr int TN = 64;         // output channels per block
constexpr int CC = 32;         // input channels per staged chunk
constexpr int XS_LD = CC + 1;  // halo row pitch, padded against bank conflicts
constexpr int KT = 4;          // filter taps per staged weight slice
constexpr int THREADS = 256;   // 16 x 16 threads, a 4x4 output patch each
constexpr int RM = TL / 16;
constexpr int RN = TN / 16;

// halo rows x XS_LD floats, rounded up so the weight slice after it is
// 16-byte aligned for float4 reads
__host__ __device__ inline int halo_floats(int stride, int K) {
  const int halo = (TL - 1) * stride + K;
  return (halo * XS_LD + 3) & ~3;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
sliding_conv1d_kernel(const T* __restrict__ x, const T* __restrict__ w,
                      const float* __restrict__ bias, T* __restrict__ y,
                      T* __restrict__ z, int L, int Cin, int Cout, int K,
                      int stride, int Lout, int act) {
  extern __shared__ __align__(16) float smem[];
  const int halo = (TL - 1) * stride + K;
  float* xs = smem;                             // [halo][XS_LD]
  float* ws = smem + halo_floats(stride, K);    // [KT][CC][TN]
  const int b = blockIdx.z;
  const int l0 = blockIdx.x * TL;
  const int n0 = blockIdx.y * TN;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const T* xb = x + (size_t)b * L * Cin;
  const int row0 = l0 * stride;  // first input row of this tile's halo

  float acc[RM][RN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) acc[i][j] = 0.f;

  for (int c0 = 0; c0 < Cin; c0 += CC) {
    __syncthreads();  // every reader of the previous chunk is done
    for (int e = threadIdx.x; e < halo * CC; e += THREADS) {
      const int r = e / CC, c = e % CC;
      const int gr = row0 + r, gc = c0 + c;
      xs[r * XS_LD + c] =
          (gr < L && gc < Cin) ? to_f32(xb[(size_t)gr * Cin + gc]) : 0.f;
    }
    for (int k0 = 0; k0 < K; k0 += KT) {
      const int kt = min(KT, K - k0);
      if (k0 > 0) __syncthreads();  // every reader of the last slice is done
      for (int e = threadIdx.x; e < kt * CC * TN; e += THREADS) {
        const int n = e % TN, c = (e / TN) % CC, kk = e / (TN * CC);
        const int gc = c0 + c, gn = n0 + n;
        ws[e] = (gc < Cin && gn < Cout)
                    ? to_f32(w[((size_t)(k0 + kk) * Cin + gc) * Cout + gn])
                    : 0.f;
      }
      __syncthreads();  // halo and weight slice are in place
      for (int kk = 0; kk < kt; ++kk) {
        const float* xk = xs + (ty * stride + k0 + kk) * XS_LD;
        const float* wk = ws + kk * CC * TN + tx * RN;
#pragma unroll 8
        for (int c = 0; c < CC; ++c) {
          float a[RM];
#pragma unroll
          for (int i = 0; i < RM; ++i) a[i] = xk[i * 16 * stride * XS_LD + c];
          const float4 bw = *reinterpret_cast<const float4*>(wk + c * TN);
#pragma unroll
          for (int i = 0; i < RM; ++i) {
            acc[i][0] = fmaf(a[i], bw.x, acc[i][0]);
            acc[i][1] = fmaf(a[i], bw.y, acc[i][1]);
            acc[i][2] = fmaf(a[i], bw.z, acc[i][2]);
            acc[i][3] = fmaf(a[i], bw.w, acc[i][3]);
          }
        }
      }
    }
  }

  // epilogue, once per output element: bias, activation, cast, store
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int r = l0 + ty + 16 * i;
    if (r >= Lout) continue;
    const size_t row = ((size_t)b * Lout + r) * Cout;
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
                   void* z, int B, int L, int Cin, int Cout, int K, int stride,
                   int Lout, int act, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)halo_floats(stride, K) + (size_t)KT * CC * TN);
  auto kernel = sliding_conv1d_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Lout + TL - 1) / TL, (Cout + TN - 1) / TN, B);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const float*>(bias), static_cast<T*>(y), static_cast<T*>(z),
      L, Cin, Cout, K, stride, Lout, act);
  return cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t code: 0 when the launch was accepted. Shared memory
// grows with the halo, (TL-1)*stride + K rows; a shape that needs more than
// the card offers is refused with cudaErrorInvalidValue. z may be null.
extern "C" int sliding_conv1d(const void* x, const void* w, const void* bias,
                              void* y, void* z, int B, int L, int Cin,
                              int Cout, int K, int stride, int Lout, int act,
                              int is_bf16, void* stream) {
  if (B < 1 || B > 65535 || Cin < 1 || Cout < 1 || K < 1 || stride < 1 ||
      Lout < 1 || (Lout - 1) * stride + K > L || act < 0 || act > 3)
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      sizeof(float) * ((size_t)halo_floats(stride, K) + (size_t)KT * CC * TN);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      is_bf16 ? launch<__nv_bfloat16>(x, w, bias, y, z, B, L, Cin, Cout, K,
                                      stride, Lout, act, s)
              : launch<float>(x, w, bias, y, z, B, L, Cin, Cout, K, stride,
                              Lout, act, s);
  return (int)err;
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
