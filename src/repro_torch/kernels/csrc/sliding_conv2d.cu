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
// What the design does about it: each block owns TM = 64 output pixels (a
// TH x TW patch of one image, TH * TW = 64) by TN = 64 output channels, and
// keeps a 4x4 register tile of float32 sums per thread across the whole
// reduction. The reduction walks Cin in chunks of CC channels and, inside
// a chunk, the filter one row i at a time: for row i the block stages, for
// each of its TH output rows, the one input row that row i of the filter
// reads (columns ox0*sw .. (TW-1)*sw + kw, CC channels) in shared memory.
// In NHWC that row holds the (tap j, channel c) pairs of every output pixel
// as one contiguous run, so the reduction over a filter row runs over
// (tap, channel) together, r = j*CC + c, and every pixel's operand is an
// address offset into the same staged row (the paper's vector slide): no
// im2col buffer in device memory, and the kw taps share one staging.
// Staging one filter row at a time (the compound regime's ROW_CHUNK taken
// to 1) keeps shared memory independent of kh and wastes no staged rows
// at strides above 1: at the patch embedding (kw*CC = 42, stride = kernel)
// each staged row is read by exactly one output row, with no gaps. The
// weights of a filter row stream through shared memory in slices of KT
// reduction elements. The epilogue (bias, activation, cast) runs once,
// after the last chunk. The custom / generic / compound split is a TPU
// tiling choice (how taps group in VMEM); this one kernel covers every
// kh, kw >= 1 and every stride >= 1.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stddef.h>

#include "conv_epilogue.cuh"

namespace {

constexpr int TM = 64;        // output pixels per block
constexpr int TN = 64;        // output channels per block
constexpr int KT = 64;        // reduction elements per staged weight slice
constexpr int CC_MAX = 32;    // input channels per staged chunk, at most
constexpr int THREADS = 256;  // 16 x 16 threads, a 4x4 output patch each
constexpr int RM = TM / 16;
constexpr int RN = TN / 16;
// shared memory the staged rows may take (the weight slice adds 16 KB),
// leaving room for two blocks on an SM
constexpr size_t HALO_BYTES_MAX = 96 * 1024;

// staged rows' floats, rounded up so the weight slice after them is
// 16-byte aligned for float4 reads
__host__ __device__ inline int halo_floats(int th, int halo_w, int cc) {
  return (th * halo_w * cc + 3) & ~3;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
sliding_conv2d_kernel(const T* __restrict__ x, const T* __restrict__ w,
                      const float* __restrict__ bias, T* __restrict__ y,
                      int H, int W, int Cin, int Cout, int kh, int kw, int sh,
                      int sw, int oh, int ow, int tw, int cc, int tiles_w,
                      int act) {
  extern __shared__ __align__(16) float smem[];
  const int th = TM / tw;
  const int halo_w = (tw - 1) * sw + kw;
  const int row_elems = halo_w * cc;  // one staged input row
  float* xs = smem;                                      // [th][halo_w][cc]
  float* ws = smem + halo_floats(th, halo_w, cc);        // [KT][TN]
  const int b = blockIdx.z;
  const int oy0 = (blockIdx.x / tiles_w) * th;
  const int ox0 = (blockIdx.x % tiles_w) * tw;
  const int n0 = blockIdx.y * TN;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const T* xb = x + (size_t)b * H * W * Cin;

  // where pixel ty + 16*i's operands start in the staged rows: its output
  // row's staged row, then ox*sw columns in
  int base[RM];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int m = ty + 16 * i;
    base[i] = (m / tw) * row_elems + (m % tw) * sw * cc;
  }

  float acc[RM][RN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) acc[i][j] = 0.f;

  const int red = kw * cc;  // reduction length of one filter row in a chunk
  for (int c0 = 0; c0 < Cin; c0 += cc) {
    for (int fi = 0; fi < kh; ++fi) {
      __syncthreads();  // every reader of the previous rows and slice is done
      for (int e = threadIdx.x; e < th * row_elems; e += THREADS) {
        const int r = e / row_elems;
        const int rem = e - r * row_elems;
        const int col = rem / cc;
        const int c = rem - col * cc;
        const int gr = (oy0 + r) * sh + fi, gc = ox0 * sw + col, gch = c0 + c;
        xs[e] = (gr < H && gc < W && gch < Cin)
                    ? to_f32(xb[((size_t)gr * W + gc) * Cin + gch])
                    : 0.f;
      }
      for (int k0 = 0; k0 < red; k0 += KT) {
        const int kt = min(KT, red - k0);
        if (k0 > 0) __syncthreads();  // every reader of the last slice is done
        for (int e = threadIdx.x; e < kt * TN; e += THREADS) {
          const int n = e % TN;
          const int r = k0 + e / TN;
          const int fj = r / cc;
          const int gch = c0 + (r - fj * cc), gn = n0 + n;
          ws[e] = (gch < Cin && gn < Cout)
                      ? to_f32(w[(((size_t)fi * kw + fj) * Cin + gch) * Cout +
                                 gn])
                      : 0.f;
        }
        __syncthreads();  // rows and weight slice are in place
        const float* xk = xs + k0;
        const float* wk = ws + tx * RN;
#pragma unroll 4
        for (int rr = 0; rr < kt; ++rr) {
          float a[RM];
#pragma unroll
          for (int i = 0; i < RM; ++i) a[i] = xk[base[i] + rr];
          const float4 bw = *reinterpret_cast<const float4*>(wk + rr * TN);
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
      y[row + n] = from_f32<T>(activate(v, act));
    }
  }
}

struct Tiling {
  int tw, cc, tiles_w, tiles_h;
  size_t smem;
};

// The pixel tile's width TW (TH = 64 / TW) that pads the output grid
// least, the wider on a tie (fewer staged halo columns per pixel); then
// the channel chunk, halved until the staged rows fit.
Tiling choose_tiling(int Cin, int kw, int sw, int oh, int ow) {
  Tiling t{1, 1, 0, 0, 0};
  long best = -1;
  for (int tw = TM; tw >= 1; tw /= 2) {
    const int th = TM / tw;
    const long area = (long)((ow + tw - 1) / tw) * tw *
                      (long)((oh + th - 1) / th) * th;
    if (best < 0 || area < best) {
      best = area;
      t.tw = tw;
    }
  }
  const int th = TM / t.tw;
  const int halo_w = (t.tw - 1) * sw + kw;
  t.cc = Cin < CC_MAX ? Cin : CC_MAX;
  while (t.cc > 1 && sizeof(float) * (size_t)th * halo_w * t.cc > HALO_BYTES_MAX)
    t.cc = (t.cc + 1) / 2;
  t.tiles_w = (ow + t.tw - 1) / t.tw;
  t.tiles_h = (oh + th - 1) / th;
  t.smem = sizeof(float) *
           ((size_t)halo_floats(th, halo_w, t.cc) + (size_t)KT * TN);
  return t;
}

template <typename T>
cudaError_t launch(const void* x, const void* w, const void* bias, void* y,
                   int B, int H, int W, int Cin, int Cout, int kh, int kw,
                   int sh, int sw, int oh, int ow, int act, const Tiling& t,
                   cudaStream_t stream) {
  auto kernel = sliding_conv2d_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)t.smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(t.tiles_h * t.tiles_w, (Cout + TN - 1) / TN, B);
  kernel<<<grid, THREADS, t.smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const float*>(bias), static_cast<T*>(y), H, W, Cin, Cout,
      kh, kw, sh, sw, oh, ow, t.tw, t.cc, t.tiles_w, act);
  return cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t code: 0 when the launch was accepted. A shape whose
// staged rows exceed the card's shared memory even at one channel a chunk
// (a filter row wider than about 3,000 columns) is refused with
// cudaErrorInvalidValue, as is a grid the card cannot launch.
extern "C" int sliding_conv2d(const void* x, const void* w, const void* bias,
                              void* y, int B, int H, int W, int Cin, int Cout,
                              int kh, int kw, int sh, int sw, int oh, int ow,
                              int act, int is_bf16, void* stream) {
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
      is_bf16 ? launch<__nv_bfloat16>(x, w, bias, y, B, H, W, Cin, Cout, kh,
                                      kw, sh, sw, oh, ow, act, t, s)
              : launch<float>(x, w, bias, y, B, H, W, Cin, Cout, kh, kw, sh,
                              sw, oh, ow, act, t, s);
  return (int)err;
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
