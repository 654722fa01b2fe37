// int8 quantized sliding-window conv2d with a fused dequant, bias,
// activation and optional requant epilogue, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/sliding_conv_quant.py, conv2d_quant_pallas
// (_qkernel_2d and its custom, generic and compound regimes, the Cin-block
// revisit with its int32 / f32 scratch, and the dequant epilogue).
//
// What it computes: VALID conv2d, NHWC input and HWIO int8 weights, on an
// input the caller has already padded,
//   acc[b, oy, ox, n] = sum_{i, j, c} w_q[i, j, c, n]
//                                     * x[b, oy*sh + i, ox*sw + j, c]
//   y = act(acc * s[n] + bias[n]), then optionally
//   y = clip(rint(y / out_scale), -127, 127) as int8 (requant),
// with w_q int8 (kh, kw, Cin, Cout), s float32 (Cout,), bias float32 or
// absent. Two modes:
//   w8a8:  x is int8 codes; the products are int8 x int8, summed exactly in
//          int32 (the caller asserts kh*kw*Cin*127^2 < 2^31);
//          s = w_scale * x_scale, computed by the caller in float32.
//   w8a16: x is float32 or bfloat16; the weight codes are converted to
//          float as they are staged and the sum is float32; s = w_scale.
// The output is int8 (requant), float32 or bfloat16, stored by the shared
// epilogue (conv_epilogue.cuh, store_out), which rounds as the reference's
// float32 epilogue does.
//
// What bounds it on this card: at llava's patch embedding (x (20, 336, 336,
// 3) int8, w (14, 14, 3, 1152), stride 14) the work is 15.6 G int8
// operations, 0.0079 ms at the tensor cores' 1,979 TOP/s, against 20.7 MB
// of traffic with an int8 output (0.0062 ms at 3.35 TB/s): bound by
// arithmetic. This kernel sums with __dp4a on the CUDA cores (four int8
// products a lane an instruction); int8 tensor-core tiles (mma.sync s8,
// then wgmma) are later work.
//
// What the design does about it: the block tiling of the fp kernel
// (conv2d_rows.cuh): 64 output pixels x 64 output channels a block, a 4x4
// register tile of sums a thread, and the reduction walked one filter row
// at a time over the row's (tap, channel) pairs together, which NHWC keeps
// contiguous: kw*Cin values for each pixel. The w8a16 kernel is that main
// loop with the codes widened as they are staged. The w8a8 kernel stages,
// for each filter row, each pixel's kw*CC run of int8 codes as its own
// segment of whole 32-bit words, zero-padded, so that every __dp4a reads an
// aligned word: at the patch embedding a pixel's run is 14 * 3 = 42 bytes
// and starts at byte 42*ox of its image row, 2 bytes off a word for odd
// ox, so a slide over the staged row itself would need unaligned word
// loads; padded to 44 bytes (zero weights past 42) every load is a word
// load. The weights of the filter row are staged in slices of KW8 words as
// 32-bit words of four reduction elements, one output channel each. The
// Pallas kernel's revisit grid dimension over Cin blocks becomes the
// loop over channel chunks inside the block with int32 register sums, and
// its epilogue runs once, after the last chunk. The regime argument (a TPU
// tiling choice) does not reach this kernel: one kernel covers every kh,
// kw >= 1 and every stride >= 1.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stddef.h>
#include <stdint.h>

#include "conv2d_rows.cuh"

namespace {

constexpr int KW8 = 16;      // words (4 reduction elements each) per slice
constexpr int CC8_MAX = 64;  // input channels per staged chunk, at most
// shared memory the staged segments may take (the weight slice adds 4 KB)
constexpr size_t SEG_BYTES_MAX = 96 * 1024;

struct Tiling8 {
  int tw, cc, seg, pitch, tiles_w, tiles_h;
  size_t smem;
};

// words of one pixel's segment, and the pitch between segments: odd, so
// the two pixels a warp reads at once fall in different banks
__host__ __device__ inline int seg_words(int kw, int cc) {
  return (kw * cc + 3) / 4;
}

// segments' words, rounded up so the weight slice after them is 16-byte
// aligned for int4 reads
__host__ __device__ inline int seg_area(int pitch) {
  return (TM * pitch + 3) & ~3;
}

Tiling8 choose_tiling8(int Cin, int kw, int oh, int ow) {
  Tiling8 t{pixel_tile_w(oh, ow), Cin < CC8_MAX ? Cin : CC8_MAX, 0, 0, 0, 0,
            0};
  while (t.cc > 1 &&
         sizeof(int) * (size_t)TM * (seg_words(kw, t.cc) | 1) > SEG_BYTES_MAX)
    t.cc = (t.cc + 1) / 2;
  t.seg = seg_words(kw, t.cc);
  t.pitch = t.seg | 1;
  t.tiles_w = (ow + t.tw - 1) / t.tw;
  t.tiles_h = (oh + TM / t.tw - 1) / (TM / t.tw);
  t.smem = sizeof(int) * ((size_t)seg_area(t.pitch) + (size_t)KW8 * TN);
  return t;
}

__global__ void __launch_bounds__(THREADS)
conv2d_w8a8_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                   const float* __restrict__ scale,
                   const float* __restrict__ bias,
                   const float* __restrict__ out_scale, void* __restrict__ y,
                   int H, int W, int Cin, int Cout, int kh, int kw, int sh,
                   int sw, int oh, int ow, int tw, int cc, int seg, int pitch,
                   int tiles_w, int act, int y_kind) {
  extern __shared__ __align__(16) int smem_i[];
  int* xs = smem_i;                    // [TM][pitch] words, seg of them used
  int* ws = smem_i + seg_area(pitch);  // [KW8][TN]
  const int th = TM / tw;
  const int b = blockIdx.z;
  const int oy0 = (blockIdx.x / tiles_w) * th;
  const int ox0 = (blockIdx.x % tiles_w) * tw;
  const int n0 = blockIdx.y * TN;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int8_t* xb = x + (size_t)b * H * W * Cin;
  const int red = kw * cc;  // bytes of a segment in use

  int acc[RM][RN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) acc[i][j] = 0;

  for (int c0 = 0; c0 < Cin; c0 += cc) {
    const int cn = min(cc, Cin - c0);  // channels of this chunk
    for (int fi = 0; fi < kh; ++fi) {
      __syncthreads();  // every reader of the previous segments is done
      // every word of every pixel's run of filter row fi, the block's
      // threads on consecutive words
      for (int e = threadIdx.x; e < TM * seg; e += THREADS) {
        const int m = e / seg, q = e - m * seg;
        const int oy = oy0 + m / tw, ox = ox0 + m % tw;
        unsigned packed = 0u;
        if (oy < oh && ox < ow) {
          const int8_t* src =
              xb + ((size_t)(oy * sh + fi) * W + (size_t)ox * sw) * Cin + c0;
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int r = 4 * q + k;
            if (r >= red) break;
            int off = r;  // one chunk (cc == Cin): the run is contiguous
            if (cc != Cin) {
              const int j = r / cc, c = r - j * cc;
              if (c >= cn) continue;
              off = j * Cin + c;
            }
            packed |= (unsigned)(uint8_t)src[off] << (8 * k);
          }
        }
        xs[m * pitch + q] = (int)packed;
      }
      for (int q0 = 0; q0 < seg; q0 += KW8) {
        const int qt = min(KW8, seg - q0);
        if (q0 > 0) __syncthreads();  // every reader of the last slice is done
        for (int e = threadIdx.x; e < qt * TN; e += THREADS) {
          const int n = e % TN, gn = n0 + n;
          const int r0 = 4 * (q0 + e / TN);
          unsigned packed = 0u;
          if (gn < Cout) {
            int j = r0 / cc, c = r0 - j * cc;
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              if (r0 + k < red && c < cn)
                packed |= (unsigned)(uint8_t)
                              w[(((size_t)fi * kw + j) * Cin + c0 + c) * Cout +
                                gn]
                          << (8 * k);
              if (++c == cc) {
                c = 0;
                ++j;
              }
            }
          }
          ws[e] = (int)packed;
        }
        __syncthreads();  // segments and weight slice are in place
        const int* xk = xs + ty * pitch + q0;
        const int* wk = ws + tx * RN;
        for (int q = 0; q < qt; ++q) {
          int a[RM];
#pragma unroll
          for (int i = 0; i < RM; ++i) a[i] = xk[i * 16 * pitch + q];
          const int4 bw = *reinterpret_cast<const int4*>(wk + q * TN);
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
    const int m = ty + 16 * i;
    const int oy = oy0 + m / tw, ox = ox0 + m % tw;
    if (oy >= oh || ox >= ow) continue;
    const size_t row = (((size_t)b * oh + oy) * ow + ox) * Cout;
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
conv2d_w8a16_kernel(const TX* __restrict__ x, const int8_t* __restrict__ w,
                    const float* __restrict__ scale,
                    const float* __restrict__ bias,
                    const float* __restrict__ out_scale, void* __restrict__ y,
                    int H, int W, int Cin, int Cout, int kh, int kw, int sh,
                    int sw, int oh, int ow, int tw, int cc, int tiles_w,
                    int act, int y_kind) {
  extern __shared__ __align__(16) float smem_f[];
  float acc[RM][RN];
  sum_rows<TX, int8_t>(x, w, smem_f, H, W, Cin, Cout, kh, kw, sh, sw, tw, cc,
                       tiles_w, acc);
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
      store_out(y, row + n, acc[i][j], scale[n], bias, n, act, out_scale,
                y_kind);
    }
  }
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace

// Returns a cudaError_t code: 0 when the launch was accepted. mode: 0 w8a8
// (x int8), 1 w8a16. x_kind: 0 float32, 1 bfloat16, 2 int8. y_kind: 0
// float32, 1 bfloat16, 2 int8 (requant: out_scale, a float32 scalar on the
// card, must not be null). bias may be null. A shape whose staged rows or
// segments exceed the card's shared memory even at one channel a chunk, or
// whose grid the card cannot launch, is refused with cudaErrorInvalidValue.
extern "C" int sliding_conv2d_quant(const void* x, const void* w,
                                    const void* scale, const void* bias,
                                    const void* out_scale, void* y, int B,
                                    int H, int W, int Cin, int Cout, int kh,
                                    int kw, int sh, int sw, int oh, int ow,
                                    int act, int mode, int x_kind, int y_kind,
                                    void* stream) {
  if (B < 1 || B > 65535 || Cin < 1 || Cout < 1 || kh < 1 || kw < 1 ||
      sh < 1 || sw < 1 || oh < 1 || ow < 1 || (oh - 1) * sh + kh > H ||
      (ow - 1) * sw + kw > W || act < 0 || act > 3 || y_kind < 0 ||
      y_kind > 2 || (y_kind == OUT_INT8 && out_scale == nullptr) ||
      (Cout + TN - 1) / TN > 65535)
    return (int)cudaErrorInvalidValue;
  const int w8a8 = mode == 0;
  if (w8a8 ? x_kind != 2 : (mode != 1 || x_kind > 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 block(THREADS);
  cudaError_t err;
  if (w8a8) {
    const Tiling8 t = choose_tiling8(Cin, kw, oh, ow);
    if (t.smem > 227 * 1024 || (long)t.tiles_h * t.tiles_w > 0x7fffffffL)
      return (int)cudaErrorInvalidValue;
    err = prepare(conv2d_w8a8_kernel, t.smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid(t.tiles_h * t.tiles_w, (Cout + TN - 1) / TN, B);
    conv2d_w8a8_kernel<<<grid, block, t.smem, s>>>(
        static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
        static_cast<const float*>(scale), static_cast<const float*>(bias),
        static_cast<const float*>(out_scale), y, H, W, Cin, Cout, kh, kw, sh,
        sw, oh, ow, t.tw, t.cc, t.seg, t.pitch, t.tiles_w, act, y_kind);
    return (int)cudaGetLastError();
  }
  const Tiling t = choose_tiling(Cin, kw, sw, oh, ow);
  if (t.smem > 227 * 1024 || (long)t.tiles_h * t.tiles_w > 0x7fffffffL)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(t.tiles_h * t.tiles_w, (Cout + TN - 1) / TN, B);
  const int8_t* wq = static_cast<const int8_t*>(w);
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  const float* os = static_cast<const float*>(out_scale);
  if (x_kind == 1) {
    err = prepare(conv2d_w8a16_kernel<__nv_bfloat16>, t.smem);
    if (err != cudaSuccess) return (int)err;
    conv2d_w8a16_kernel<__nv_bfloat16><<<grid, block, t.smem, s>>>(
        static_cast<const __nv_bfloat16*>(x), wq, sc, bi, os, y, H, W, Cin,
        Cout, kh, kw, sh, sw, oh, ow, t.tw, t.cc, t.tiles_w, act, y_kind);
  } else {
    err = prepare(conv2d_w8a16_kernel<float>, t.smem);
    if (err != cudaSuccess) return (int)err;
    conv2d_w8a16_kernel<float><<<grid, block, t.smem, s>>>(
        static_cast<const float*>(x), wq, sc, bi, os, y, H, W, Cin, Cout, kh,
        kw, sh, sw, oh, ow, t.tw, t.cc, t.tiles_w, act, y_kind);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
