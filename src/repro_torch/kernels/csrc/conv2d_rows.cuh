// Shared by the float-sum 2-D sliding conv kernels (sliding_conv2d.cu, and
// the w8a16 kernel of sliding_conv2d_quant.cu): the block tiling and the
// main loop that sums one block's output tile in float32 registers. Each
// kernel adds its own epilogue. Every kernel library compiles it into its
// own translation unit; build.py keys each library on this header's text.
//
// The design (row 4's, PERF.md): each block owns TM = 64 output pixels (a
// TH x TW patch of one image, TH * TW = 64) by TN = 64 output channels, and
// keeps a 4x4 register tile of float32 sums per thread across the whole
// reduction. The reduction walks Cin in chunks of CC channels and, inside
// a chunk, the filter one row i at a time: for row i the block stages, for
// each of its TH output rows, the one input row that row i of the filter
// reads (columns ox0*sw .. (TW-1)*sw + kw, CC channels) in shared memory as
// float32. In NHWC that row holds the (tap j, channel c) pairs of every
// output pixel as one contiguous run, so the reduction over a filter row
// runs over (tap, channel) together, r = j*CC + c, and every pixel's
// operand is an address offset into the same staged row (the paper's
// vector slide): no im2col buffer in device memory, and the kw taps share
// one staging. Shared memory does not grow with kh. The weights of a
// filter row stream through shared memory in slices of KT reduction
// elements, converted to float32 as they are staged (int8 codes too).
#pragma once

#include <cuda_bf16.h>
#include <stddef.h>
#include <stdint.h>

#include "conv_epilogue.cuh"

namespace {

constexpr int TM = 64;        // output pixels per block
constexpr int TN = 64;        // output channels per block
constexpr int THREADS = 256;  // 16 x 16 threads, a 4x4 output patch each
constexpr int RM = TM / 16;
constexpr int RN = TN / 16;
constexpr int KT = 64;        // reduction elements per staged weight slice
constexpr int CC_MAX = 32;    // input channels per staged chunk, at most
// shared memory the staged rows may take (the weight slice adds 16 KB),
// leaving room for two blocks on an SM
constexpr size_t HALO_BYTES_MAX = 96 * 1024;

__device__ __forceinline__ float to_f32(int8_t v) { return (float)v; }

// staged rows' floats, rounded up so the weight slice after them is
// 16-byte aligned for float4 reads
__host__ __device__ inline int halo_floats(int th, int halo_w, int cc) {
  return (th * halo_w * cc + 3) & ~3;
}

// The pixel tile's width TW (TH = 64 / TW) that pads the output grid
// least, the wider on a tie (fewer staged halo columns per pixel).
inline int pixel_tile_w(int oh, int ow) {
  int best_tw = 1;
  long best = -1;
  for (int tw = TM; tw >= 1; tw /= 2) {
    const int th = TM / tw;
    const long area = (long)((ow + tw - 1) / tw) * tw *
                      (long)((oh + th - 1) / th) * th;
    if (best < 0 || area < best) {
      best = area;
      best_tw = tw;
    }
  }
  return best_tw;
}

struct Tiling {
  int tw, cc, tiles_w, tiles_h;
  size_t smem;
};

// The pixel tile, then the channel chunk, halved until the staged rows
// fit.
inline Tiling choose_tiling(int Cin, int kw, int sw, int oh, int ow) {
  Tiling t{pixel_tile_w(oh, ow), 1, 0, 0, 0};
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

// The block's float32 sums: acc[i][j] is output pixel ty + 16*i of the
// tile, channel n0 + tx*RN + j (blockIdx: x the pixel tile, y the channel
// block, z the image; threadIdx.x = ty * 16 + tx). smem holds
// Tiling::smem bytes.
template <typename TX, typename TW>
__device__ __forceinline__ void sum_rows(
    const TX* __restrict__ x, const TW* __restrict__ w, float* smem, int H,
    int W, int Cin, int Cout, int kh, int kw, int sh, int sw, int tw, int cc,
    int tiles_w, float (&acc)[RM][RN]) {
  const int th = TM / tw;
  const int halo_w = (tw - 1) * sw + kw;
  const int row_elems = halo_w * cc;  // one staged input row
  float* xs = smem;                                      // [th][halo_w][cc]
  float* ws = smem + halo_floats(th, halo_w, cc);        // [KT][TN]
  const int oy0 = (blockIdx.x / tiles_w) * th;
  const int ox0 = (blockIdx.x % tiles_w) * tw;
  const int n0 = blockIdx.y * TN;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const TX* xb = x + (size_t)blockIdx.z * H * W * Cin;

  // where pixel ty + 16*i's operands start in the staged rows: its output
  // row's staged row, then ox*sw columns in
  int base[RM];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int m = ty + 16 * i;
    base[i] = (m / tw) * row_elems + (m % tw) * sw * cc;
  }
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
}

}  // namespace
