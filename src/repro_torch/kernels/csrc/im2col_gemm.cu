// The paper's GEMM-convolution baselines, for Hopper (sm_90a): a tiled
// GEMM and the fused 1-D and 2-D im2col convolutions, all three on the
// tensor-core / split-K main loop of gemm_mma.cuh.
//
// Replaces: src/repro/kernels/im2col_gemm.py,
//   matmul_pallas (row 5)             -> im2col_matmul
//   conv1d_im2col_fused_pallas (row 6) -> im2col_conv1d
//   conv2d_im2col_fused_pallas (row 7) -> im2col_conv2d
// The reference's conv{1d,2d}_im2col_hbm build the whole column tensor in
// device memory with array ops and call matmul_pallas; the port does the
// same with torch ops and im2col_matmul.
//
// What they compute, float32 or bfloat16 operands of one type, sums in
// float32 (never TF32), one cast to the input's type at the end, no bias
// and no activation (the callers apply both unfused, as the reference's
// ops.py does):
//   im2col_matmul: C (M, N) = A (M, K) @ B (K, N), all row-major;
//   im2col_conv1d: VALID conv1d, x (B, L, Cin) NLC, w (K, Cin, Cout),
//     y[b, l, n] = sum_{k, c} w[k, c, n] * x[b, l*s + k, c], y (B, Lout, Cout);
//   im2col_conv2d: VALID conv2d, x (B, H, W, Cin) NHWC, w (kh, kw, Cin, Cout)
//     HWIO, y[b, oy, ox, n] = sum_{i, j, c} w[i, j, c, n]
//                             * x[b, oy*sh + i, ox*sw + j, c].
// A convolution is the product of its im2col matrix (one row per output
// position, the position's K*Cin or kh*kw*Cin input elements in (tap,
// channel) order) with the weights read as a (K*Cin, Cout) matrix.
//
// What bounds them on this card: in bfloat16 the tensor cores' rate
// (llava's patch column, 11,520 x 588 @ 588 x 1,152: 15.6 GFLOP, 0.0158
// ms at 989 TFLOP/s); in float32 the CUDA cores' 67 TFLOP/s (fig1 (1, 128,
// 128, 32) x (31, 31, 32, 32): 18.9 GFLOP, 0.282 ms; the 1-D table's (1,
// 16384, 32) x (65, 32, 32): 2.2 GFLOP, 0.0324 ms), or, for the GEMM, the
// column's bytes where the column is long and N narrow (fig1 k=31's hbm
// column, 9,604 x 30,752 float32 = 1.18 GB, 0.354 ms at 3.35 TB/s: the
// memory bloat the paper measures).
//
// What the design does about it (gemm_mma.cuh): bfloat16 on mma.sync
// tiles, float32 on 8 x 8 register tiles with a 32-wide N tile where N <=
// 32, a cp.async ring of stages, and split-K where the blocks alone would
// leave the card idle (a long, narrow column gives few tiles), the splits'
// float32 partials added in split order. The TPU kernels hold a tile's
// whole column in VMEM (for fig1 k=31 at the 16 x 64 tile, 126 MB); a
// Hopper block has 227 KB. So the convs build their column tile chunk by
// chunk along the reduction, as the reference's body does, tap by tap:
// A[p, t*Cin + c] is channel c of tap t of position p, and each copy into
// a stage moves part of one tap's Cin channels of one position
// (TapColumns; the 1-D conv is its case H = oh = kh = 1), never crossing
// into the next tap. The sliding convs on the same loop (rows 1 and 4)
// copy along whole filter-row runs of kw*Cin values instead (the paper's
// vector slide). The column never reaches device memory; a fused baseline
// and its sliding conv differ in the gather alone.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stddef.h>

#include "gemm_mma.cuh"

namespace {

// A row-major (M, K) matrix with leading dimension K: contiguous along k.
struct MatrixRows {
  static constexpr bool kMajor = true, kCacheRows = false;
  int ld;
  __device__ int row(int m) const { return m; }
  __device__ long long at(int m) const { return (long long)m * ld; }
  __device__ long long col(int r) const { return r; }
};

// The im2col matrix of a VALID conv as the reference's body builds it,
// tap by tap: row p = (b, oy, ox) is ConvPositions' output position,
// column k = t*Cin + c is channel c of tap t = i*kw + j, which lies i input
// rows down and j pixels along from the position's first pixel (the 1-D
// conv: H = oh = kh = 1, W = L, t = j). The wrapper's copy width divides
// Cin, so no copy crosses from one tap to the next.
struct TapColumns {
  static constexpr bool kMajor = true, kCacheRows = true;
  gm::ConvPositions pos;
  gm::FastDiv cin, kw;
  int W;
  __device__ int row(int p) const { return pos.row(p); }
  __device__ long long at(int pix) const { return pos.at(pix); }
  __device__ long long col(int k) const {
    const int t = cin.div(k), c = k - t * cin.d;
    const int i = kw.div(t), j = t - i * kw.d;
    return ((long long)i * W + j) * cin.d + c;
  }
};

// C = A @ B cast to A's type (no epilogue), float32 operands or, where
// is_bf16, bfloat16 ones, A gathered by g
template <class Gather>
int store_gemm(const void* a, const void* b, void* c, float* ws, int M, int N,
               int K, const Gather& g, int is_bf16, int tile, int splits,
               int per, int va, int vb, void* stream) {
  if (is_bf16) {
    using T = __nv_bfloat16;
    return gm::gemm(static_cast<const T*>(a), static_cast<const T*>(b),
                    gm::Store<T>{static_cast<T*>(c), N}, ws, nullptr, M, N, K,
                    g, tile, splits, per, va, vb, stream);
  }
  return gm::gemm(static_cast<const float*>(a), static_cast<const float*>(b),
                  gm::Store<float>{static_cast<float*>(c), N}, ws, nullptr, M,
                  N, K, g, tile, splits, per, va, vb, stream);
}

}  // namespace

// Each entry returns a cudaError_t code: 0 when the launch was accepted.
// Empty or out-of-range shapes (a dimension past INT_MAX, more than
// 65535 column tiles, a filter that does not fit the input) are refused
// with cudaErrorInvalidValue.
//
// im2col_matmul runs on tile `tile` in `splits` splits of `per` chunks of
// the reduction (gemm_plan.py's choice), with copies of va bytes of A and
// vb of B; ws holds splits * M * N floats when splits > 1 (else null).
extern "C" int im2col_matmul(const void* a, const void* b, void* c, float* ws,
                             int M, int N, int K, int is_bf16, int tile,
                             int splits, int per, int va, int vb,
                             void* stream) {
  return store_gemm(a, b, c, ws, M, N, K, MatrixRows{K}, is_bf16, tile,
                    splits, per, va, vb, stream);
}

// im2col_conv1d and im2col_conv2d run on tile `tile` in `splits` splits
// of `per` chunks of the K*Cin or kh*kw*Cin taps (gemm_plan.py's choice),
// with copies of va bytes of x (a divisor of Cin's bytes) and vb of w; ws
// holds splits * (positions) * Cout floats when splits > 1 (else null).
extern "C" int im2col_conv1d(const void* x, const void* w, void* y, float* ws,
                             int B, int L, int Cin, int Cout, int K,
                             int stride, int lout, int is_bf16, int tile,
                             int splits, int per, int va, int vb,
                             void* stream) {
  if (!gm::conv_shape_ok(B, 1, L, Cin, Cout, 1, K, 1, stride, 1, lout) ||
      va < 1 || ((long long)Cin * (is_bf16 ? 2 : 4)) % va != 0)
    return (int)cudaErrorInvalidValue;
  const TapColumns g{gm::conv_positions(1, L, Cin, K, 1, stride, 1, lout),
                     gm::FastDiv(Cin), gm::FastDiv(K), L};
  return store_gemm(x, w, y, ws, B * lout, Cout, K * Cin, g, is_bf16, tile,
                    splits, per, va, vb, stream);
}

extern "C" int im2col_conv2d(const void* x, const void* w, void* y, float* ws,
                             int B, int H, int W, int Cin, int Cout, int kh,
                             int kw, int sh, int sw, int oh, int ow,
                             int is_bf16, int tile, int splits, int per,
                             int va, int vb, void* stream) {
  if (!gm::conv_shape_ok(B, H, W, Cin, Cout, kh, kw, sh, sw, oh, ow) ||
      va < 1 || ((long long)Cin * (is_bf16 ? 2 : 4)) % va != 0)
    return (int)cudaErrorInvalidValue;
  const TapColumns g{gm::conv_positions(H, W, Cin, kw, sh, sw, oh, ow),
                     gm::FastDiv(Cin), gm::FastDiv(kw), W};
  return store_gemm(x, w, y, ws, B * oh * ow, Cout, kh * kw * Cin, g,
                    is_bf16, tile, splits, per, va, vb, stream);
}

// Each launch's dynamic shared memory and threads for A of x_kind (0
// float32, 1 bfloat16) on tile `tile`, as the entry above of that name
// makes it; they launch nothing.
extern "C" int im2col_matmul_query(int x_kind, int tile, int* smem,
                                   int* threads) {
  return gm::query<MatrixRows>(x_kind, tile, smem, threads);
}

extern "C" int im2col_conv1d_query(int x_kind, int tile, int* smem,
                                   int* threads) {
  return gm::query<TapColumns>(x_kind, tile, smem, threads);
}

extern "C" int im2col_conv2d_query(int x_kind, int tile, int* smem,
                                   int* threads) {
  return gm::query<TapColumns>(x_kind, tile, smem, threads);
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
