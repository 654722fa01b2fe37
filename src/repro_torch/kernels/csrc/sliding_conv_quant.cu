// int8 quantized sliding-window conv1d with a fused dequant, bias,
// activation and optional requant epilogue, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/sliding_conv_quant.py, conv1d_quant_pallas
// (_qkernel_1d, _reduce_dequant, _dequant_epilogue; the custom, generic and
// compound regimes).
//
// What it computes: VALID conv1d on an input the caller has already padded,
//   acc[b, i, n] = sum_k sum_c w_q[k, c, n] * x[b, i*stride + k, c]
//   y = act(acc * s[n] + bias[n]), then optionally
//   y = clip(rint(y / out_scale), -127, 127) as int8 (requant),
// with w_q int8 (K, Cin, Cout), s float32 (Cout,), bias float32 or absent.
// Two modes:
//   w8a8:  x is int8 codes; the products are int8 x int8, summed exactly in
//          int32; s = w_scale * x_scale, computed by the caller in float32.
//   w8a16: x is float32 or bfloat16; the weight codes are converted to
//          float as they are staged and the sum is float32; s = w_scale.
// The output is int8 (requant), float32 or bfloat16, stored by the shared
// epilogue (conv_epilogue.cuh, store_out), which rounds as the reference's
// float32 epilogue does.
//
// What bounds it on this card: at whisper's frontend shapes (B=4, L=514,
// 80->1024 at stride 1 and 1024->1024 at stride 2, K=3) conv2 is 6.4 G
// int8 operations against about 7 MB of traffic, bound by arithmetic;
// conv1 (1.0 G operations, 2.6 MB) likewise at the tensor cores' rate.
//
// What the design does about it: the block structure of the fp kernel
// (sliding_conv1d.cu). Each block owns TL output rows x TN output channels;
// for each chunk of input channels it stages the input halo of
// (TL-1)*stride + K rows in shared memory once, then walks the taps in
// slices of KT, staging the matching weight slice; every tap is an offset
// into the same halo, so no im2col buffer exists. The Pallas kernel's
// revisit grid dimension over Cin blocks, with its int32 scratch, becomes
// this loop inside the block with int32 register accumulators, and its
// epilogue runs once, after the last chunk. In w8a8 the halo and the
// weights are staged as 32-bit words of four channels each, and each thread
// sums its 4x4 output patch with __dp4a (four int8 products and an int32
// add per instruction) on the CUDA cores: exact, and simple. Tensor-core
// tiles (mma.sync s8, then wgmma) are later work. Cin must be a multiple of
// 4 in w8a8: the wrapper pads the channels with zero codes. One kernel
// covers every K >= 1 and every stride >= 1.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "conv_epilogue.cuh"

namespace {

constexpr int TL = 64;         // output rows per block
constexpr int TN = 64;         // output channels per block
constexpr int THREADS = 256;   // 16 x 16 threads, a 4x4 output patch each
constexpr int RM = TL / 16;
constexpr int RN = TN / 16;
constexpr int KT = 4;          // filter taps per staged weight slice
// w8a8: channels staged as int32 words of 4 codes
constexpr int CC8 = 32;        // input channels per staged chunk
constexpr int CW = CC8 / 4;    // words per halo row
constexpr int XW_LD = CW + 1;  // halo row pitch in words, against bank conflicts
// w8a16: channels staged as floats
constexpr int CC = 32;
constexpr int XS_LD = CC + 1;

// halo rows x pitch, rounded up so that the weight slice after it is
// 16-byte aligned
__host__ __device__ inline int halo_words(int stride, int K, int pitch) {
  const int halo = (TL - 1) * stride + K;
  return (halo * pitch + 3) & ~3;
}

__global__ void __launch_bounds__(THREADS)
conv1d_w8a8_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                   const float* __restrict__ scale,
                   const float* __restrict__ bias,
                   const float* __restrict__ out_scale, void* __restrict__ y,
                   int L, int Cin, int Cout, int K, int stride, int Lout,
                   int act, int y_kind) {
  extern __shared__ __align__(16) int smem_w[];
  const int halo = (TL - 1) * stride + K;
  int* xs = smem_w;                                     // [halo][XW_LD]
  int* ws = smem_w + halo_words(stride, K, XW_LD);      // [KT][CW][TN]
  const int b = blockIdx.z;
  const int l0 = blockIdx.x * TL;
  const int n0 = blockIdx.y * TN;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int8_t* xb = x + (size_t)b * L * Cin;
  const int row0 = l0 * stride;  // first input row of this tile's halo

  int acc[RM][RN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) acc[i][j] = 0;

  for (int c0 = 0; c0 < Cin; c0 += CC8) {
    __syncthreads();  // every reader of the previous chunk is done
    for (int e = threadIdx.x; e < halo * CW; e += THREADS) {
      const int r = e / CW, cw = e % CW;
      const int gr = row0 + r, gc = c0 + 4 * cw;
      // Cin % 4 == 0: the word's four channels are all in range or all out
      xs[r * XW_LD + cw] =
          (gr < L && gc < Cin)
              ? *reinterpret_cast<const int*>(xb + (size_t)gr * Cin + gc)
              : 0;
    }
    for (int k0 = 0; k0 < K; k0 += KT) {
      const int kt = min(KT, K - k0);
      if (k0 > 0) __syncthreads();  // every reader of the last slice is done
      for (int e = threadIdx.x; e < kt * CW * TN; e += THREADS) {
        const int n = e % TN, cw = (e / TN) % CW, kk = e / (TN * CW);
        const int gc = c0 + 4 * cw, gn = n0 + n;
        unsigned packed = 0u;  // channels gc..gc+3 of output channel gn
        if (gc < Cin && gn < Cout) {
          const int8_t* wp = w + ((size_t)(k0 + kk) * Cin + gc) * Cout + gn;
#pragma unroll
          for (int j = 0; j < 4; ++j)
            packed |= (unsigned)(uint8_t)wp[(size_t)j * Cout] << (8 * j);
        }
        ws[e] = (int)packed;
      }
      __syncthreads();  // halo and weight slice are in place
      for (int kk = 0; kk < kt; ++kk) {
        const int* xk = xs + (ty * stride + k0 + kk) * XW_LD;
        const int* wk = ws + kk * CW * TN + tx * RN;
#pragma unroll
        for (int cw = 0; cw < CW; ++cw) {
          int a[RM];
#pragma unroll
          for (int i = 0; i < RM; ++i) a[i] = xk[i * 16 * stride * XW_LD + cw];
          const int4 bw = *reinterpret_cast<const int4*>(wk + cw * TN);
#pragma unroll
          for (int i = 0; i < RM; ++i) {
            acc[i][0] = __dp4a(a[i], bw.x, acc[i][0]);
            acc[i][1] = __dp4a(a[i], bw.y, acc[i][1]);
            acc[i][2] = __dp4a(a[i], bw.z, acc[i][2]);
            acc[i][3] = __dp4a(a[i], bw.w, acc[i][3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int r = l0 + ty + 16 * i;
    if (r >= Lout) continue;
    const size_t row = ((size_t)b * Lout + r) * Cout;
#pragma unroll
    for (int j = 0; j < RN; ++j) {
      const int n = n0 + tx * RN + j;
      if (n >= Cout) continue;
      store_out(y, row + n, __int2float_rn(acc[i][j]), scale[n], bias, n, act,
                out_scale, y_kind);
    }
  }
}

template <typename TX>
__global__ void __launch_bounds__(THREADS)
conv1d_w8a16_kernel(const TX* __restrict__ x, const int8_t* __restrict__ w,
                    const float* __restrict__ scale,
                    const float* __restrict__ bias,
                    const float* __restrict__ out_scale, void* __restrict__ y,
                    int L, int Cin, int Cout, int K, int stride, int Lout,
                    int act, int y_kind) {
  extern __shared__ __align__(16) float smem_f[];
  const int halo = (TL - 1) * stride + K;
  float* xs = smem_f;                                  // [halo][XS_LD]
  float* ws = smem_f + halo_words(stride, K, XS_LD);   // [KT][CC][TN]
  const int b = blockIdx.z;
  const int l0 = blockIdx.x * TL;
  const int n0 = blockIdx.y * TN;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const TX* xb = x + (size_t)b * L * Cin;
  const int row0 = l0 * stride;

  float acc[RM][RN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) acc[i][j] = 0.f;

  for (int c0 = 0; c0 < Cin; c0 += CC) {
    __syncthreads();
    for (int e = threadIdx.x; e < halo * CC; e += THREADS) {
      const int r = e / CC, c = e % CC;
      const int gr = row0 + r, gc = c0 + c;
      xs[r * XS_LD + c] =
          (gr < L && gc < Cin) ? to_f32(xb[(size_t)gr * Cin + gc]) : 0.f;
    }
    for (int k0 = 0; k0 < K; k0 += KT) {
      const int kt = min(KT, K - k0);
      if (k0 > 0) __syncthreads();
      for (int e = threadIdx.x; e < kt * CC * TN; e += THREADS) {
        const int n = e % TN, c = (e / TN) % CC, kk = e / (TN * CC);
        const int gc = c0 + c, gn = n0 + n;
        // the weight code, dequantized to float in the staging (its scale
        // is applied once, in the epilogue)
        ws[e] = (gc < Cin && gn < Cout)
                    ? (float)w[((size_t)(k0 + kk) * Cin + gc) * Cout + gn]
                    : 0.f;
      }
      __syncthreads();
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

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int r = l0 + ty + 16 * i;
    if (r >= Lout) continue;
    const size_t row = ((size_t)b * Lout + r) * Cout;
#pragma unroll
    for (int j = 0; j < RN; ++j) {
      const int n = n0 + tx * RN + j;
      if (n >= Cout) continue;
      store_out(y, row + n, acc[i][j], scale[n], bias, n, act, out_scale,
                y_kind);
    }
  }
}

size_t smem_bytes(int w8a8, int stride, int K) {
  if (w8a8)
    return sizeof(int) *
           ((size_t)halo_words(stride, K, XW_LD) + (size_t)KT * CW * TN);
  return sizeof(float) *
         ((size_t)halo_words(stride, K, XS_LD) + (size_t)KT * CC * TN);
}

template <typename Kernel, typename TX>
cudaError_t launch(Kernel kernel, const void* x, const void* w,
                   const void* scale, const void* bias, const void* out_scale,
                   void* y, int B, int L, int Cin, int Cout, int K, int stride,
                   int Lout, int act, int y_kind, size_t smem,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Lout + TL - 1) / TL, (Cout + TN - 1) / TN, B);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const TX*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<const float*>(out_scale), y, L, Cin, Cout, K, stride, Lout,
      act, y_kind);
  return cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t code: 0 when the launch was accepted. mode: 0 w8a8
// (x int8, Cin a multiple of 4), 1 w8a16. x_kind: 0 float32, 1 bfloat16,
// 2 int8. y_kind: 0 float32, 1 bfloat16, 2 int8 (requant: out_scale, a
// float32 scalar on the card, must not be null). bias may be null. Shared
// memory grows with the halo, (TL-1)*stride + K rows; a shape that needs
// more than the card offers is refused with cudaErrorInvalidValue.
extern "C" int sliding_conv_quant(const void* x, const void* w,
                                  const void* scale, const void* bias,
                                  const void* out_scale, void* y, int B, int L,
                                  int Cin, int Cout, int K, int stride,
                                  int Lout, int act, int mode, int x_kind,
                                  int y_kind, void* stream) {
  if (B < 1 || B > 65535 || Cin < 1 || Cout < 1 || K < 1 || stride < 1 ||
      Lout < 1 || (Lout - 1) * stride + K > L || act < 0 || act > 3 ||
      y_kind < 0 || y_kind > 2 || (y_kind == OUT_INT8 && out_scale == nullptr))
    return (int)cudaErrorInvalidValue;
  const int w8a8 = mode == 0;
  if (w8a8 ? (x_kind != 2 || Cin % 4 != 0) : (mode != 1 || x_kind > 1))
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(w8a8, stride, K);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (w8a8)
    err = launch<decltype(&conv1d_w8a8_kernel), int8_t>(
        conv1d_w8a8_kernel, x, w, scale, bias, out_scale, y, B, L, Cin, Cout,
        K, stride, Lout, act, y_kind, smem, s);
  else if (x_kind == 1)
    err = launch<decltype(&conv1d_w8a16_kernel<__nv_bfloat16>), __nv_bfloat16>(
        conv1d_w8a16_kernel<__nv_bfloat16>, x, w, scale, bias, out_scale, y, B,
        L, Cin, Cout, K, stride, Lout, act, y_kind, smem, s);
  else
    err = launch<decltype(&conv1d_w8a16_kernel<float>), float>(
        conv1d_w8a16_kernel<float>, x, w, scale, bias, out_scale, y, B, L,
        Cin, Cout, K, stride, Lout, act, y_kind, smem, s);
  return (int)err;
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
