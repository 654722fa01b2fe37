// int8 quantized sliding-window conv2d with a fused dequant, bias,
// activation and optional requant epilogue, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/sliding_conv_quant.py, conv2d_quant_pallas
// (_qkernel_2d and its custom, generic and compound regimes, the Cin-block
// revisit with its int32 / f32 scratch, and _dequant_epilogue).
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
//   w8a16: x is float32 or bfloat16; the weight codes are widened to x's
//          type (|code| <= 127 is exact in bf16, and a bf16 x code product
//          exact in float32) and the sum is float32; s = w_scale.
// The output is int8 (requant), float32 or bfloat16, stored by the shared
// epilogue (conv_epilogue.cuh, store_out), which rounds as the reference's
// float32 epilogue does.
//
// What bounds it on this card: at llava's patch embedding (x (20, 336, 336,
// 3) int8, w (14, 14, 3, 1152), stride 14) the work is 15.6 G int8
// operations, 0.0079 ms at the tensor cores' 1,979 TOP/s, against 33.7 MB
// of traffic with a bf16 output (0.0101 ms at 3.35 TB/s): bound by bytes,
// by a hair. w8a16 in bf16 is bound by the bf16 tensor cores (0.0158 ms).
//
// What the design does about it: the conv is one product on gemm_mma.cuh's
// main loop, as row 4's (sliding_conv2d.cu): output positions by the
// flat HWIO filter index, A gathered from x a filter row's run at a time
// (no im2col buffer in device memory). w8a8 runs on the int8 tensor-core
// tile (mma.sync m16n8k32, int32 sums, 64 codes a chunk); the weight codes
// reach its [n][k] stage through registers, transposed four by four with
// __byte_perm. At the patch embedding a position's run is 42 codes
// starting 42 bytes after its neighbour's, so x is copied 2 bytes at a
// time by plain loads, held in registers (as the codes are) across the
// products of the chunk ahead, which hide their latency. w8a16 runs on row
// 4's tiles for x's type (bf16: mma.sync; float32: CUDA cores), the codes
// widened as they are staged. The epilogue (dequant, bias, activation,
// requant or cast; gm::Dequant, shared with the 1-D int8 conv, row 13)
// runs once an output: in the block's store, or after the splits'
// partials (int32 for w8a8, exact; float32 for w8a16) are added in split
// order. The regime argument (a TPU tiling choice) does
// not reach this kernel: one kernel covers every kh, kw >= 1 and every
// stride >= 1.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stddef.h>
#include <stdint.h>

#include "gemm_mma.cuh"

// Returns a cudaError_t code: 0 when the launches were accepted. mode: 0
// w8a8 (x int8), 1 w8a16. x_kind: 0 float32, 1 bfloat16, 2 int8. y_kind:
// 0 float32, 1 bfloat16, 2 int8 (requant: out_scale, a float32 scalar on
// the card, must not be null). bias may be null. The product runs on tile
// `tile` in `splits` splits of `per` chunks of the kh*kw*Cin filter taps
// (gemm_plan.py's choice), with copies of va bytes of x and vb of w_q; ws
// holds splits * B*oh*ow * Cout partials (int32 for w8a8, float32 for
// w8a16) when splits > 1 (else null). A shape or a grid the card cannot
// take is refused with cudaErrorInvalidValue.
extern "C" int sliding_conv2d_quant(const void* x, const void* w,
                                    const void* scale, const void* bias,
                                    const void* out_scale, void* y, void* ws,
                                    int B, int H, int W, int Cin, int Cout,
                                    int kh, int kw, int sh, int sw, int oh,
                                    int ow, int act, int mode, int x_kind,
                                    int y_kind, int tile, int splits, int per,
                                    int va, int vb, void* stream) {
  if (!gm::conv_shape_ok(B, H, W, Cin, Cout, kh, kw, sh, sw, oh, ow))
    return (int)cudaErrorInvalidValue;
  const gm::Dequant epi{y, static_cast<const float*>(scale),
                        static_cast<const float*>(bias),
                        static_cast<const float*>(out_scale), Cout, act,
                        y_kind};
  const gm::ConvPositions g = gm::conv_positions(H, W, Cin, kw, sh, sw, oh,
                                                 ow);
  return gm::dequant_gemm(x, w, epi, ws, B * oh * ow, kh * kw * Cin, mode,
                          x_kind, g, tile, splits, per, va, vb, stream);
}

// The launch's dynamic shared memory and threads for x of x_kind (0
// float32, 1 bfloat16, 2 int8) on tile `tile`, as sliding_conv2d_quant
// makes it; launches nothing.
extern "C" int sliding_conv2d_quant_query(int x_kind, int tile, int* smem,
                                          int* threads) {
  return gm::query<gm::ConvPositions>(x_kind, tile, smem, threads);
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
