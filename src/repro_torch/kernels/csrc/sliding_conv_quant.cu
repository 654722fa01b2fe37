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
//   w8a16: x is float32 or bfloat16; the weight codes are widened to x's
//          type (|code| <= 127 is exact in bf16, and a bf16 x code product
//          exact in float32) and the sum is float32; s = w_scale.
// The output is int8 (requant), float32 or bfloat16, stored by the shared
// epilogue (conv_epilogue.cuh, store_out), which rounds as the reference's
// float32 epilogue does.
//
// What bounds it on this card: at whisper's frontend shapes (B=4, L=514,
// K=3; conv1 80->1024 at stride 1, requantized to int8; conv2 1024->1024
// at stride 2, float32 out) in w8a8, conv2 is 6.4 G int8 operations,
// 0.0033 ms at the tensor cores' 1,979 TOP/s, against 9.5 MB of traffic
// (0.0028 ms at 3.35 TB/s): bound by arithmetic. conv1 is 1.0 G operations
// (0.0005 ms) against 2.5 MB, mostly its int8 output (0.00075 ms): bound by
// bytes.
//
// What the design does about it: the conv is one product on gemm_mma.cuh's
// main loop, as row 14's (sliding_conv2d_quant.cu) at H = oh = kh = 1 and
// row 1's (sliding_conv1d.cu) for the fp conv: y[p, n] = epilogue(sum_k
// A[p, k] * w_q[k, n]) over the B*Lout output positions p and the K*Cin
// flat (tap, channel) indices k, A[p, k] = x[(b*L + l*stride)*Cin + k]
// (gm::ConvPositions): a position's whole K*Cin column is one run of x,
// staged straight from x in copies as wide as the runs' alignment allows
// (16 bytes at whisper's shapes; single bytes where Cin is odd), so no
// im2col buffer reaches device memory and no channel is padded. w8a8 runs
// on the int8 tensor-core tile (mma.sync m16n8k32, int32 sums, 64 codes a
// chunk), the weight codes transposed into its [n][k] stage with
// __byte_perm; w8a16 on row 1's tiles for x's type (bf16: mma.sync;
// float32: 8 x 8 register tiles on the CUDA cores, never TF32), the codes
// widened as they are staged. The reduction is split over blocks where the
// tiles alone would leave the card idle (whisper's conv2: 64 tiles, 4
// splits). The epilogue (gm::Dequant, shared with row 14) runs once an
// output: in the block's store, or after the splits' partials (int32 for
// w8a8, so every split order gives the exact sum; float32 for w8a16) are
// added in split order. The Pallas kernel's revisit grid dimension over
// Cin blocks with its int32 scratch becomes the loop over k inside the
// block, and one kernel covers every K >= 1, every stride >= 1 and every
// Cin >= 1.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stddef.h>
#include <stdint.h>

#include "gemm_mma.cuh"

// Returns a cudaError_t code: 0 when the launches were accepted. mode: 0
// w8a8 (x int8), 1 w8a16. x_kind: 0 float32, 1 bfloat16, 2 int8. y_kind:
// 0 float32, 1 bfloat16, 2 int8 (requant: out_scale, a float32 scalar on
// the card, must not be null). bias may be null. The product runs on tile
// `tile` in `splits` splits of `per` chunks of the K*Cin filter taps
// (gemm_plan.py's choice), with copies of va bytes of x and vb of w_q; ws
// holds splits * B*Lout * Cout partials (int32 for w8a8, float32 for
// w8a16) when splits > 1 (else null). A shape or a grid the card cannot
// take is refused with cudaErrorInvalidValue.
extern "C" int sliding_conv_quant(const void* x, const void* w,
                                  const void* scale, const void* bias,
                                  const void* out_scale, void* y, void* ws,
                                  int B, int L, int Cin, int Cout, int K,
                                  int stride, int Lout, int act, int mode,
                                  int x_kind, int y_kind, int tile,
                                  int splits, int per, int va, int vb,
                                  void* stream) {
  if (!gm::conv_shape_ok(B, 1, L, Cin, Cout, 1, K, 1, stride, 1, Lout))
    return (int)cudaErrorInvalidValue;
  const gm::Dequant epi{y, static_cast<const float*>(scale),
                        static_cast<const float*>(bias),
                        static_cast<const float*>(out_scale), Cout, act,
                        y_kind};
  const gm::ConvPositions g =
      gm::conv_positions(1, L, Cin, K, 1, stride, 1, Lout);
  return gm::dequant_gemm(x, w, epi, ws, B * Lout, K * Cin, mode, x_kind, g,
                          tile, splits, per, va, vb, stream);
}

// The launch's dynamic shared memory and threads for x of x_kind (0
// float32, 1 bfloat16, 2 int8) on tile `tile`, as sliding_conv_quant makes
// it; launches nothing.
extern "C" int sliding_conv_quant_query(int x_kind, int tile, int* smem,
                                        int* threads) {
  return gm::query<gm::ConvPositions>(x_kind, tile, smem, threads);
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
