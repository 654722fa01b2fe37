// The selective-SSM scan, forward, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/ssm_scan.py, ssm_scan_pallas (the body
// _kernel, with its state carried in VMEM scratch across L chunks).
//
// What it computes: for each (b, d) the N-wide float32 state
//   h_t = abar_t * h_{t-1} + bx_t          (h_{-1} = h0[b, d])
//   y_t = sum_n h_t[n] * c_t[n]
// over t < L, with abar, bx (B, L, D, N) and c (B, L, N) float32 or
// bfloat16 (one type), h0 (B, D, N) float32; y (B, L, D) in abar's type and
// h_last (B, D, N) float32, the state after the true last position. The
// multiply and the add of the recurrence are separate IEEE operations (no
// FMA contraction), as the reference and the plain version compute them.
//
// What bounds it on this card: every input element is read once and takes
// two operations, so bytes bound it: at one chunk of jamba-1.5-large's
// prefill (B 4, L 256, D 16384, N 16) f32 that is 2.22 GB, 0.66 ms at
// 3.35 TB/s.
//
// What the design does about it: the TPU kernel runs its L chunks in grid
// order and keeps the state in scratch between them; here the L loop is
// inside the thread. One thread owns one (b, d) and keeps its N states in
// registers for the whole sequence, so the state never goes to device
// memory. Each step it loads its N contiguous abar and bx elements with
// vector loads (neighbouring threads own neighbouring d, so a warp reads
// one contiguous span), and c_t, shared by every d of a batch, is staged in
// shared memory a chunk of CH steps at a time. Any L and any D: threads
// past D only help stage c, and no position is padded, so h_last is the
// state at the true L.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stddef.h>

namespace {

constexpr int THREADS = 128;  // d values per block
constexpr int CH = 64;        // time steps of c staged at once
constexpr int NMAX = 64;      // the largest state width taken

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T narrow(float v);
template <> __device__ __forceinline__ float narrow<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(
    float v) {
  return __float2bfloat16(v);
}

// N (= NT, a compile-time width) contiguous elements widened to float32:
// 16-byte loads for float32 when NT % 4 == 0, 4-byte pairs for bfloat16
// when NT % 2 == 0
template <int NT>
__device__ __forceinline__ void load_row(const float* p, float* out) {
  if constexpr (NT % 4 == 0) {
    const float4* p4 = reinterpret_cast<const float4*>(p);
#pragma unroll
    for (int q = 0; q < NT / 4; ++q) {
      const float4 v = p4[q];
      out[4 * q] = v.x;
      out[4 * q + 1] = v.y;
      out[4 * q + 2] = v.z;
      out[4 * q + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int n = 0; n < NT; ++n) out[n] = p[n];
  }
}

template <int NT>
__device__ __forceinline__ void load_row(const __nv_bfloat16* p, float* out) {
  if constexpr (NT % 2 == 0) {
    const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(p);
#pragma unroll
    for (int q = 0; q < NT / 2; ++q) {
      const float2 v = __bfloat1622float2(p2[q]);
      out[2 * q] = v.x;
      out[2 * q + 1] = v.y;
    }
  } else {
#pragma unroll
    for (int n = 0; n < NT; ++n) out[n] = __bfloat162float(p[n]);
  }
}

// NT: the state width N as a compile-time constant
template <typename T, int NT>
__global__ void __launch_bounds__(THREADS)
ssm_scan_kernel(const T* __restrict__ abar, const T* __restrict__ bx,
                const T* __restrict__ c, const float* __restrict__ h0,
                T* __restrict__ y, float* __restrict__ h_last, int L, int D) {
  __shared__ float cs[CH * NT];
  const int b = blockIdx.y;
  const int d = blockIdx.x * THREADS + threadIdx.x;
  const bool active = d < D;
  float h[NT];
#pragma unroll
  for (int n = 0; n < NT; ++n) h[n] = 0.f;
  if (active) {
    const float* hp = h0 + ((size_t)b * D + d) * NT;
#pragma unroll
    for (int n = 0; n < NT; ++n) h[n] = hp[n];
  }
  const T* cb = c + (size_t)b * L * NT;
  for (int t0 = 0; t0 < L; t0 += CH) {
    const int ch = min(CH, L - t0);
    __syncthreads();  // every reader of the last chunk is done
    for (int e = threadIdx.x; e < ch * NT; e += THREADS)
      cs[e] = widen(cb[(size_t)t0 * NT + e]);
    __syncthreads();
    if (!active) continue;
#pragma unroll 2
    for (int tt = 0; tt < ch; ++tt) {
      const size_t row = ((size_t)b * L + t0 + tt) * D + d;
      float a[NT], u[NT];
      load_row<NT>(abar + row * NT, a);
      load_row<NT>(bx + row * NT, u);
      float acc = 0.f;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        h[n] = __fadd_rn(__fmul_rn(a[n], h[n]), u[n]);
        acc = fmaf(h[n], cs[tt * NT + n], acc);
      }
      y[row] = narrow<T>(acc);
    }
  }
  if (active) {
    float* hp = h_last + ((size_t)b * D + d) * NT;
#pragma unroll
    for (int n = 0; n < NT; ++n) hp[n] = h[n];
  }
}

template <typename T, int NT>
cudaError_t launch(const void* abar, const void* bx, const void* c,
                   const float* h0, void* y, float* h_last, int B, int L,
                   int D, cudaStream_t s) {
  const dim3 grid((D + THREADS - 1) / THREADS, B);
  ssm_scan_kernel<T, NT><<<grid, THREADS, 0, s>>>(
      static_cast<const T*>(abar), static_cast<const T*>(bx),
      static_cast<const T*>(c), h0, static_cast<T*>(y), h_last, L, D);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* abar, const void* bx, const void* c,
                     const float* h0, void* y, float* h_last, int B, int L,
                     int D, int N, cudaStream_t s) {
  switch (N) {
#define SSM_CASE(n) \
  case n:           \
    return launch<T, n>(abar, bx, c, h0, y, h_last, B, L, D, s);
    SSM_CASE(1) SSM_CASE(2) SSM_CASE(3) SSM_CASE(4) SSM_CASE(5) SSM_CASE(6)
    SSM_CASE(7) SSM_CASE(8) SSM_CASE(9) SSM_CASE(10) SSM_CASE(11)
    SSM_CASE(12) SSM_CASE(13) SSM_CASE(14) SSM_CASE(15) SSM_CASE(16)
    SSM_CASE(24) SSM_CASE(32) SSM_CASE(48) SSM_CASE(NMAX)
#undef SSM_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Returns a cudaError_t code: 0 when the launch was accepted. The state
// width N must be one of the compiled widths (1-16, 24, 32, 48, 64);
// any other is refused with cudaErrorInvalidValue. Every tensor is
// contiguous; h0 and h_last are float32.
extern "C" int ssm_scan(const void* abar, const void* bx, const void* c,
                        const void* h0, void* y, void* h_last, int B, int L,
                        int D, int N, int is_bf16, void* stream) {
  if (B < 1 || B > 65535 || L < 1 || D < 1 || N < 1 || N > NMAX)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* h0f = static_cast<const float*>(h0);
  float* hl = static_cast<float*>(h_last);
  return (int)(is_bf16 ? dispatch<__nv_bfloat16>(abar, bx, c, h0f, y, hl, B,
                                                 L, D, N, s)
                       : dispatch<float>(abar, bx, c, h0f, y, hl, B, L, D, N,
                                         s));
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
