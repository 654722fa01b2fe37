// Sliding-window conv2d with a fused bias + activation epilogue, for Hopper
// (sm_90a).
//
// Replaces: src/repro/kernels/sliding_conv2d.py, conv2d_sliding_pallas (the
// custom / generic / compound kernel bodies, their Cin-block f32 revisit
// and the fused epilogue, _finish).
//
// What it computes: VALID conv2d, NHWC input and HWIO weights, on an input
// the caller has already padded,
//   y[b, oy, ox, n] = act(bias[n] + sum_{i, j, c} w[i, j, c, n]
//                         * x[b, oy*sh + i, ox*sw + j, c])
// with x (B, H, W, Cin), w (kh, kw, Cin, Cout), bias (Cout,) float32 or
// absent, and y (B, oh, ow, Cout) in x's type. float32 or bfloat16
// operands; the sum is always taken in float32 and never in TF32 (bf16
// products are exact in float32). act: none, relu, gelu with the tanh
// approximation, silu. With z it also stores the post-bias pre-activation
// in y's type (the residual the backward pass forms dz = dy * act'(z)
// from).
//
// What bounds it on this card: at llava's patch embedding (x (20, 336, 336,
// 3), w (14, 14, 3, 1152), stride 14) the work is 15.6 GFLOP against 40 MB
// of traffic in bf16: bound by arithmetic, 0.0158 ms on the bf16 tensor
// cores; in float32 0.233 ms at the CUDA cores' rate. The paper's fig1
// k=31 in float32 ((1, 128, 128, 32) x (31, 31, 32, 32)) is 18.9 GFLOP,
// 0.282 ms.
//
// What the design does about it: the conv is one product on gemm_mma.cuh's
// main loop, y[p, n] = epilogue(sum_k A[p, k] * w[k, n]), with p = (b, oy,
// ox) the output positions (B*oh*ow rows), k = (i, j, c) the flat HWIO
// filter index (the weight is already the row-major (kh*kw*Cin, Cout)
// matrix) and A[p, k] = x[base(p) + i*W*Cin + j*Cin + c]. In NHWC a
// position's kw*Cin values of filter row i are one contiguous run of x
// (the paper's vector slide), so A is staged along k run by run, straight
// from x, in copies as wide as the runs' alignment allows: no im2col
// buffer reaches device memory, and no copy crosses from one filter row
// to the next (its width divides kw*Cin). bfloat16 runs on mma.sync tiles
// (128 x 128, 8 warps), float32 on 8 x 8 register tiles (a 32-wide Cout
// tile where Cout <= 32, as at every fig1 and fig2 shape), both behind a
// ring of cp.async stages, the reduction split over blocks where the
// tiles alone would leave the card idle. The epilogue (bias, activation,
// the cast, z) runs once an output: in the block's store, or after the
// splits' float32 partials are added in split order. The custom / generic
// / compound split is a TPU tiling choice (how taps group in VMEM); this
// one kernel covers every kh, kw >= 1 and every stride >= 1.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stddef.h>

#include "gemm_mma.cuh"

// Returns a cudaError_t code: 0 when the launches were accepted. bias and
// z may be null. The product runs on tile `tile` in `splits` splits of
// `per` chunks of the kh*kw*Cin filter taps (gemm_plan.py's choice), with
// copies of va bytes of x and vb of w; ws holds splits * B*oh*ow * Cout
// floats when splits > 1 (else null). A shape or a grid the card cannot
// take (more than INT_MAX input pixels or output positions) is refused
// with cudaErrorInvalidValue.
extern "C" int sliding_conv2d(const void* x, const void* w, const void* bias,
                              void* y, void* z, void* ws, int B, int H, int W,
                              int Cin, int Cout, int kh, int kw, int sh,
                              int sw, int oh, int ow, int act, int is_bf16,
                              int tile, int splits, int per, int va, int vb,
                              void* stream) {
  if (!gm::conv_shape_ok(B, H, W, Cin, Cout, kh, kw, sh, sw, oh, ow) ||
      act < 0 || act > 3)
    return (int)cudaErrorInvalidValue;
  const gm::ConvPositions g = gm::conv_positions(H, W, Cin, kw, sh, sw, oh,
                                                 ow);
  return gm::bias_act_gemm(x, w, bias, y, z, ws, B * oh * ow, Cout,
                           kh * kw * Cin, act, is_bf16, g, tile, splits, per,
                           va, vb, stream);
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
