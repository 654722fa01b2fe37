// The paper's GEMM-convolution baselines, for Hopper (sm_90a): a tiled
// GEMM and the two fused im2col convolutions, all on the main loop of
// gemm_tile.cuh.
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
// What bounds them on this card: the float32 rate of the CUDA cores
// (67 TFLOP/s at 700 W), for bfloat16 too, since they sum on the CUDA
// cores. A fused conv does the direct convolution's operations (fig1
// (1, 128, 128, 32) x (31, 31, 32, 32): 18.9 GFLOP, 0.282 ms; llava's patch
// embedding (20, 336, 336, 3) x (14, 14, 3, 1152) stride 14: 15.6 GFLOP,
// 0.233 ms) and reads each input a few times from L2, well under its
// operation bound in bytes. The hbm baseline's GEMM reads the column the
// torch ops wrote: at fig1 k=31 that is 9,604 x 30,752 float32 = 1.18 GB,
// 0.35 ms at 3.35 TB/s to read and again to write, more than its
// operations take: the memory bloat the paper measures.
//
// What the design does about it: the TPU kernels hold a tile's whole
// column in VMEM (for fig1 k=31 at the 16 x 64 tile, 126 MB); a Hopper
// block has 227 KB. So these kernels build the column tile chunk by chunk
// along the reduction: each 32-wide chunk of the 64-position tile's
// column is gathered from the input into shared memory (strides applied,
// rows past the output masked) beside the matching 32 x 64 weight slice,
// and contracted by the 64 x 64 register-tiled main loop before the next
// chunk is gathered. The column never reaches device memory, and the
// explicit on-chip copy, the cost the paper's baseline carries, remains.
// The three kernels differ only in the gather. Output positions run
// flat over (batch, rows, columns), so small images still give many
// blocks. The plain FMA loop from shared memory is the simple, right
// first version: tensor cores (mma.sync, wgmma), cp.async or TMA staging
// and double buffering are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <limits.h>
#include <stddef.h>

#include "gemm_tile.cuh"

namespace {

// A row-major (M, K) matrix with leading dimension K.
struct MatrixRows {
  int ld;
  __device__ long long row(int m) const { return (long long)m * ld; }
  __device__ long long col(int r) const { return r; }
};

// The im2col matrix of a VALID 1-D conv: row m = (b, l) starts at input
// row l*s of image b, and its K*Cin elements are contiguous there.
struct Cols1d {
  int L, Cin, stride, lout;
  __device__ long long row(int m) const {
    const int b = m / lout, l = m - b * lout;
    return ((long long)b * L + (long long)l * stride) * Cin;
  }
  __device__ long long col(int r) const { return r; }
};

// The im2col matrix of a VALID 2-D conv: row m = (b, oy, ox) starts at
// input pixel (oy*sh, ox*sw) of image b; column r = (i*kw + j)*Cin + c
// lies i input rows down and j*Cin + c elements along.
struct Cols2d {
  int H, W, Cin, sh, sw, oh, ow;
  int kwc;  // kw * Cin: one filter row's run
  __device__ long long row(int m) const {
    const int b = m / (oh * ow), p = m - b * (oh * ow);
    const int oy = p / ow, ox = p - oy * ow;
    return (((long long)b * H + (long long)oy * sh) * W + (long long)ox * sw) *
           Cin;
  }
  __device__ long long col(int r) const {
    const int i = r / kwc;
    return (long long)i * W * Cin + (r - i * kwc);
  }
};

template <typename T, typename Gather>
__global__ void __launch_bounds__(GTHREADS)
gemm_kernel(const T* __restrict__ a, const T* __restrict__ b,
            T* __restrict__ c, int M, int N, int K, Gather g) {
  gemm_tile<T>(a, b, c, M, N, K, g);
}

template <typename Gather>
int launch(const void* a, const void* b, void* c, long long M, long long N,
           long long K, int is_bf16, const Gather& g, void* stream) {
  if (M < 1 || N < 1 || K < 1 || M > INT_MAX || N > INT_MAX || K > INT_MAX ||
      (N + GN - 1) / GN > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((M + GM - 1) / GM), (unsigned)((N + GN - 1) / GN));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    gemm_kernel<__nv_bfloat16, Gather><<<grid, GTHREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(a),
        static_cast<const __nv_bfloat16*>(b), static_cast<__nv_bfloat16*>(c),
        (int)M, (int)N, (int)K, g);
  else
    gemm_kernel<float, Gather><<<grid, GTHREADS, 0, s>>>(
        static_cast<const float*>(a), static_cast<const float*>(b),
        static_cast<float*>(c), (int)M, (int)N, (int)K, g);
  return (int)cudaGetLastError();
}

}  // namespace

// Each entry returns a cudaError_t code: 0 when the launch was accepted.
// Empty or out-of-range shapes (a dimension past INT_MAX, more than
// 65535 column tiles, a filter that does not fit the input) are refused
// with cudaErrorInvalidValue.
extern "C" int im2col_matmul(const void* a, const void* b, void* c, int M,
                             int N, int K, int is_bf16, void* stream) {
  return launch(a, b, c, M, N, K, is_bf16, MatrixRows{K}, stream);
}

extern "C" int im2col_conv1d(const void* x, const void* w, void* y, int B,
                             int L, int Cin, int Cout, int K, int stride,
                             int lout, int is_bf16, void* stream) {
  if (B < 1 || Cin < 1 || K < 1 || stride < 1 || lout < 1 ||
      (long long)(lout - 1) * stride + K > L)
    return (int)cudaErrorInvalidValue;
  return launch(x, w, y, (long long)B * lout, Cout, (long long)K * Cin,
                is_bf16, Cols1d{L, Cin, stride, lout}, stream);
}

extern "C" int im2col_conv2d(const void* x, const void* w, void* y, int B,
                             int H, int W, int Cin, int Cout, int kh, int kw,
                             int sh, int sw, int oh, int ow, int is_bf16,
                             void* stream) {
  if (B < 1 || Cin < 1 || kh < 1 || kw < 1 || sh < 1 || sw < 1 || oh < 1 ||
      ow < 1 || (long long)(oh - 1) * sh + kh > H ||
      (long long)(ow - 1) * sw + kw > W || (long long)kw * Cin > INT_MAX ||
      (long long)oh * ow > INT_MAX)
    return (int)cudaErrorInvalidValue;
  return launch(x, w, y, (long long)B * oh * ow, Cout,
                (long long)kh * kw * Cin, is_bf16,
                Cols2d{H, W, Cin, sh, sw, oh, ow, kw * Cin}, stream);
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
