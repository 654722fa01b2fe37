// Weight and bias gradient of the VALID sliding conv1d, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/sliding_conv_bwd.py, conv1d_bwd_dw_pallas
// (the _dw1d_kernel body, its (batch x spatial tile) reduction grid with the
// f32 VMEM scratch, and the db output gated to the cin-block-0 visits).
//
// What it computes, for x (B, L, Cin) the padded forward input and dz
// (B, Lout, Cout) the gradient after the epilogue's activation:
//   dw[k, c, n] = sum_b sum_t x[b, t*stride + k, c] * dz[b, t, n]
//   db[n]       = sum_b sum_t dz[b, t, n]
// dw (K, Cin, Cout) and db (Cout,) in float32. float32 or bfloat16
// operands; the sums in float32: bfloat16 products on the tensor cores
// (exact in float32), float32 ones on the CUDA cores, never in TF32.
//
// What bounds it on this card: at whisper's frontend shapes (B=4, L=514,
// K=3; conv1 80->1024 at stride 1, conv2 1024->1024 at stride 2) the work
// is 1.0 and 6.4 GFLOP against 10 and 25 MB of traffic in float32, so it
// is bound by float32 arithmetic: 0.0150 and 0.0962 ms at the CUDA cores'
// 67 TFLOP/s, as the forward is.
//
// What the design does about it: dw is one product over the B*Lout output
// positions p on gemm_mma.cuh's main loop, as row 12's
// (sliding_conv2d_bwd.cu) at kh = 1: dw[m, n] = sum_p A[m, p] * dz[p, n],
// m = k*Cin + c the flat (tap, channel) index of the filter (K*Cin rows)
// and A[m, p] = x[(b*L + t*stride)*Cin + m] (gm::FilterRuns at H = oh =
// kh = 1). A position's K*Cin values are one contiguous run of x (the
// paper's vector slide), so the product's A operand is staged along m, run
// by run, straight from x: no im2col buffer reaches device memory and no
// halo bounds K. bfloat16 runs on mma.sync tiles, float32 on 8 x 8
// register tiles (a 32-wide Cout tile where Cout <= 32), both behind a
// ring of cp.async stages. The reduction, which the Pallas kernel walks as
// revisited grid dimensions with a scratch flushed on the last visit, is
// split over blocks where the tiles alone would leave the card idle
// (whisper's conv1: 16 tiles; the split from gemm_plan.py and the card's
// SM count), each split's float32 partials added in split order by a
// second pass: no atomics, so the result does not change from run to run.
// db is summed by the blocks of the first filter tile from the dz chunks
// they stage anyway.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "gemm_mma.cuh"

// Returns a cudaError_t code: 0 when the launches were accepted. db may be
// null (no bias). The product runs on tile `tile` in `splits` splits of
// `per` chunks of output positions (gemm_plan.py's choice), with copies of
// va bytes of x and vb of dz; ws holds splits * K*Cin*Cout floats, and
// splits * Cout more where db is not null, when splits > 1 (else null). A
// shape or a grid the card cannot take is refused with
// cudaErrorInvalidValue.
extern "C" int conv1d_bwd_dw(const void* x, const void* dz, float* dw,
                             float* db, float* ws, int B, int L, int Cin,
                             int Cout, int K, int stride, int Lout,
                             int is_bf16, int tile, int splits, int per,
                             int va, int vb, void* stream) {
  if (!gm::dw_shape_ok(B, 1, L, Cin, Cout, 1, K, 1, stride, 1, Lout))
    return (int)cudaErrorInvalidValue;
  const gm::FilterRuns g = gm::filter_runs(1, L, Cin, K, 1, stride, 1, Lout);
  return gm::dw_gemm(x, dz, dw, db, ws, K * Cin, Cout, B * Lout, is_bf16, g,
                     tile, splits, per, va, vb, stream);
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
