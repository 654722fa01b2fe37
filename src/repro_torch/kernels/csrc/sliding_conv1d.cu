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
// always taken in float32 and never in TF32 (bf16 products are exact in
// float32). act: none, relu, gelu with the tanh approximation, silu. When z
// is not null the same epilogue also stores z = bias + sum, the post-bias
// pre-activation in y's type (the reference's save_preact output, kept for
// the backward pass).
//
// What bounds it on this card: at the shapes that whisper's frontend gives
// it (B=4, L=514, 80->1024 at stride 1 and 1024->1024 at stride 2) the work
// is 1.0 and 6.4 GFLOP against 10 and 25 MB of traffic in float32, so it is
// bound by arithmetic: 0.0150 and 0.0962 ms at the CUDA cores' float32 rate
// (67 TFLOP/s on an H100 SXM; the f32 operands must not go through TF32).
// In bfloat16, which whisper serves in, conv2 takes 0.0065 ms at the
// tensor cores' 989 TFLOP/s and conv1 0.0015 ms at 3.35 TB/s (its 5 MB,
// mostly y, outweigh its 1.0 GFLOP there).
//
// What the design does about it: the conv is one product on gemm_mma.cuh's
// main loop, y[p, n] = epilogue(sum_k A[p, k] * w[k, n]), with p = (b, l)
// the B*Lout output positions, k = t*Cin + c the flat (tap, channel) index
// (w is already the row-major (K*Cin, Cout) matrix) and
//   A[p, k] = x[(b*L + l*stride)*Cin + k].
// In NLC a position's whole K*Cin column is one contiguous run of x (the
// paper's vector slide), so A is gm::ConvPositions at H = oh = kh = 1,
// staged along k straight from x in copies as wide as the runs' alignment
// allows: no im2col buffer reaches device memory. bfloat16 runs on mma.sync
// tiles (128 x 128, 8 warps), float32 on 8 x 8 register tiles (a 32-wide
// Cout tile where Cout <= 32), both behind a ring of cp.async stages, the
// reduction split over blocks where the tiles alone would leave the card
// idle (whisper's conv2: 64 tiles, 4 splits). The epilogue (gm::BiasAct,
// as row 4's: bias, activation, the cast, z) runs once an output: in the
// block's store, or after the splits' float32 partials are added in split
// order. The Pallas kernel's revisit grid dimension over Cin blocks with
// its f32 scratch becomes the loop over k inside the block; its custom /
// generic / compound split is a TPU tiling choice, and this one kernel
// covers every K >= 1, every stride >= 1 and every halo.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "gemm_mma.cuh"

// Returns a cudaError_t code: 0 when the launches were accepted. bias and
// z may be null. The product runs on tile `tile` in `splits` splits of
// `per` chunks of the K*Cin filter taps (gemm_plan.py's choice), with
// copies of va bytes of x and vb of w; ws holds splits * B*Lout * Cout
// floats when splits > 1 (else null). A shape the card cannot take (more
// than INT_MAX input rows or output positions) is refused with
// cudaErrorInvalidValue.
extern "C" int sliding_conv1d(const void* x, const void* w, const void* bias,
                              void* y, void* z, void* ws, int B, int L,
                              int Cin, int Cout, int K, int stride, int Lout,
                              int act, int is_bf16, int tile, int splits,
                              int per, int va, int vb, void* stream) {
  if (!gm::conv_shape_ok(B, 1, L, Cin, Cout, 1, K, 1, stride, 1, Lout) ||
      act < 0 || act > 3)
    return (int)cudaErrorInvalidValue;
  const gm::ConvPositions g =
      gm::conv_positions(1, L, Cin, K, 1, stride, 1, Lout);
  return gm::bias_act_gemm(x, w, bias, y, z, ws, B * Lout, Cout, K * Cin, act,
                           is_bf16, g, tile, splits, per, va, vb, stream);
}

// The launch's dynamic shared memory and threads for x of x_kind (0
// float32, 1 bfloat16) on tile `tile`, as sliding_conv1d makes it; launches
// nothing.
extern "C" int sliding_conv1d_query(int x_kind, int tile, int* smem,
                                    int* threads) {
  return gm::query<gm::ConvPositions>(x_kind, tile, smem, threads);
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
