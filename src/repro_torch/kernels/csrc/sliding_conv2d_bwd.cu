// Weight and bias gradient of the VALID sliding conv2d, for Hopper
// (sm_90a).
//
// Replaces: src/repro/kernels/sliding_conv_bwd.py, conv2d_bwd_dw_pallas
// (the _dw2d_kernel body, its (batch x tile-row x tile-column) reduction
// grid with the f32 VMEM scratch, and the db output gated to the
// cin-block-0 visits).
//
// What it computes, for x (B, H, W, Cin) the padded forward input and dz
// (B, oh, ow, Cout) the gradient after the epilogue's activation:
//   dw[i, j, c, n] = sum_{b, oy, ox} x[b, oy*sh + i, ox*sw + j, c]
//                                    * dz[b, oy, ox, n]
//   db[n]          = sum_{b, oy, ox} dz[b, oy, ox, n]
// dw (kh, kw, Cin, Cout) and db (Cout,) in float32. float32 or bfloat16
// operands; the sums in float32: bfloat16 products on the tensor cores
// (exact in float32), float32 ones on the CUDA cores, never in TF32.
//
// What bounds it on this card: at llava's patch embedding (x (20, 336, 336,
// 3), dz (20, 24, 24, 1152), kh = kw = stride = 14) the work is 15.6 GFLOP
// against 42.7 MB of traffic in bf16: bound by arithmetic, 0.0158 ms on the
// bf16 tensor cores, 0.233 ms on the CUDA cores' float32 rate; fig1 k=31 in
// float32 (x (1, 128, 128, 32), 31 x 31 filter) is 18.9 GFLOP, 0.282 ms.
//
// What the design does about it: dw is one product over the B*oh*ow output
// positions p (gemm_mma.cuh), dw[m, n] = sum_p A[m, p] * dz[p, n], with m
// the flat (i, j, c) index of the filter (kh*kw*Cin rows, no padding of a
// filter row) and A[m, p] = x[base(p) + i*W*Cin + r], r = j*Cin + c. In
// NHWC a position's kw*Cin values of filter row i are one contiguous run
// of x (the paper's vector slide), so the product's A operand is staged
// along m, run by run, straight from x (gm::FilterRuns, shared with the
// 1-D gradient, row 10): no im2col buffer reaches device memory. bfloat16
// runs on mma.sync tiles, float32 on 8 x 8 register tiles (a 32-wide Cout
// tile where Cout <= 32), both behind a ring of cp.async stages. The reduction, which the Pallas kernel walks as
// revisited grid dimensions with a scratch flushed on the last visit, is
// split over blocks where the tiles alone would leave the card idle (the
// wrapper sizes the split from the card's SM count), each split's float32
// partials added in split order by a second pass: no atomics, so the
// result does not change from run to run. db is summed by the blocks of
// the first filter tile from the dz chunks they stage anyway.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "gemm_mma.cuh"

// Returns a cudaError_t code: 0 when the launches were accepted. db may be
// null (no bias). The product runs on tile `tile` in `splits` splits of
// `per` chunks of output positions (gemm_plan.py's choice), with copies of
// va bytes of x and vb of dz; ws holds splits * kh*kw*Cin*Cout floats,
// and splits * Cout more where db is not null, when splits > 1 (else
// null). A shape or a grid the card cannot
// take is refused with cudaErrorInvalidValue.
extern "C" int conv2d_bwd_dw(const void* x, const void* dz, float* dw,
                             float* db, float* ws, int B, int H, int W,
                             int Cin, int Cout, int kh, int kw, int sh, int sw,
                             int oh, int ow, int is_bf16, int tile, int splits,
                             int per, int va, int vb, void* stream) {
  if (!gm::dw_shape_ok(B, H, W, Cin, Cout, kh, kw, sh, sw, oh, ow))
    return (int)cudaErrorInvalidValue;
  const gm::FilterRuns g = gm::filter_runs(H, W, Cin, kw, sh, sw, oh, ow);
  return gm::dw_gemm(x, dz, dw, db, ws, kh * kw * Cin, Cout, B * oh * ow,
                     is_bf16, g, tile, splits, per, va, vb, stream);
}

// The launch's dynamic shared memory and threads for x of x_kind (0
// float32, 1 bfloat16) on tile `tile`, as conv2d_bwd_dw makes it; launches
// nothing.
extern "C" int conv2d_bwd_dw_query(int x_kind, int tile, int* smem,
                                   int* threads) {
  return gm::query<gm::FilterRuns>(x_kind, tile, smem, threads);
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
