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
// state at the true L. Any N: the state lives in registers, so its width is
// a template argument, compiled for 1-16, 24, 32, 48 and 64; another N <= 64
// runs at the next compiled width with the lanes past N masked, and N > 64
// walks L once for each group of 64 lanes, adding the groups' float32
// partial y in group order (through a float32 scratch) before the one
// cast.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stddef.h>

namespace {

constexpr int THREADS = 128;  // d values per block
constexpr int CH = 64;        // time steps of c staged at once
constexpr int NMAX = 64;      // the widest group of state lanes

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

// NT: the compiled width of a group of state lanes. The thread walks L once
// for each group of NT lanes (n0 = 0, NT, ...; the last may hold fewer, nv,
// with the lanes past it masked: no loads, h stays 0, nothing added to y).
// Groups before the last add their float32 partial y into yacc (B, L, D),
// in group order; the last adds its own and makes the one cast.
template <typename T, int NT>
__global__ void __launch_bounds__(THREADS)
ssm_scan_kernel(const T* __restrict__ abar, const T* __restrict__ bx,
                const T* __restrict__ c, const float* __restrict__ h0,
                T* __restrict__ y, float* __restrict__ h_last,
                float* __restrict__ yacc, int L, int D, int N) {
  __shared__ float cs[CH * NT];
  const int b = blockIdx.y;
  const int d = blockIdx.x * THREADS + threadIdx.x;
  const bool active = d < D;
  const int groups = (N + NT - 1) / NT;
  const T* cb = c + (size_t)b * L * N;
  for (int gi = 0; gi < groups; ++gi) {
    const int n0 = gi * NT, nv = min(NT, N - n0);
    const bool last = gi == groups - 1;
    // whole groups of aligned rows take the vector loads
    const bool whole = nv == NT && (groups == 1 || N % 4 == 0);
    float h[NT];
#pragma unroll
    for (int n = 0; n < NT; ++n) h[n] = 0.f;
    if (active) {
      const float* hp = h0 + ((size_t)b * D + d) * N + n0;
#pragma unroll
      for (int n = 0; n < NT; ++n)
        if (n < nv) h[n] = hp[n];
    }
    for (int t0 = 0; t0 < L; t0 += CH) {
      const int ch = min(CH, L - t0);
      __syncthreads();  // every reader of the last chunk is done
      for (int e = threadIdx.x; e < ch * NT; e += THREADS) {
        const int tt = e / NT, n = e % NT;
        cs[e] = n < nv ? widen(cb[(size_t)(t0 + tt) * N + n0 + n]) : 0.f;
      }
      __syncthreads();
      if (!active) continue;
#pragma unroll 2
      for (int tt = 0; tt < ch; ++tt) {
        const size_t row = ((size_t)b * L + t0 + tt) * D + d;
        float a[NT], u[NT];
        if (whole) {
          load_row<NT>(abar + row * N + n0, a);
          load_row<NT>(bx + row * N + n0, u);
        } else {
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            a[n] = n < nv ? widen(abar[row * N + n0 + n]) : 0.f;
            u[n] = n < nv ? widen(bx[row * N + n0 + n]) : 0.f;
          }
        }
        float acc = 0.f;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          h[n] = __fadd_rn(__fmul_rn(a[n], h[n]), u[n]);
          acc = fmaf(h[n], cs[tt * NT + n], acc);
        }
        if (groups == 1) {
          y[row] = narrow<T>(acc);
        } else {
          const float part = gi == 0 ? acc : __fadd_rn(yacc[row], acc);
          if (last)
            y[row] = narrow<T>(part);
          else
            yacc[row] = part;
        }
      }
    }
    if (active) {
      float* hp = h_last + ((size_t)b * D + d) * N + n0;
#pragma unroll
      for (int n = 0; n < NT; ++n)
        if (n < nv) hp[n] = h[n];
    }
  }
}

template <typename T, int NT>
cudaError_t launch(const void* abar, const void* bx, const void* c,
                   const float* h0, void* y, float* h_last, float* yacc,
                   int B, int L, int D, int N, cudaStream_t s) {
  const dim3 grid((D + THREADS - 1) / THREADS, B);
  ssm_scan_kernel<T, NT><<<grid, THREADS, 0, s>>>(
      static_cast<const T*>(abar), static_cast<const T*>(bx),
      static_cast<const T*>(c), h0, static_cast<T*>(y), h_last, yacc, L, D,
      N);
  return cudaGetLastError();
}

// The compiled width a state width N runs at: N itself for the widths
// compiled (1-16, 24, 32, 48, 64), else the next one up; above 64, groups
// of 64.
inline int compiled_width(int N) {
  if (N <= 16) return N;
  if (N <= 24) return 24;
  if (N <= 32) return 32;
  if (N <= 48) return 48;
  return NMAX;
}

template <typename T>
cudaError_t dispatch(const void* abar, const void* bx, const void* c,
                     const float* h0, void* y, float* h_last, float* yacc,
                     int B, int L, int D, int N, cudaStream_t s) {
  switch (compiled_width(N)) {
#define SSM_CASE(n) \
  case n:           \
    return launch<T, n>(abar, bx, c, h0, y, h_last, yacc, B, L, D, N, s);
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

// Returns a cudaError_t code: 0 when the launch was accepted. Any state
// width N >= 1; for N > 64, yacc is a float32 scratch of B * L * D
// elements (not read otherwise, may be null). Every tensor is contiguous; h0 and h_last are float32.
extern "C" int ssm_scan(const void* abar, const void* bx, const void* c,
                        const void* h0, void* y, void* h_last, void* yacc,
                        int B, int L, int D, int N, int is_bf16,
                        void* stream) {
  if (B < 1 || B > 65535 || L < 1 || D < 1 || N < 1 ||
      (N > NMAX && yacc == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* h0f = static_cast<const float*>(h0);
  float* hl = static_cast<float*>(h_last);
  float* ya = static_cast<float*>(yacc);
  return (int)(is_bf16 ? dispatch<__nv_bfloat16>(abar, bx, c, h0f, y, hl, ya,
                                                 B, L, D, N, s)
                       : dispatch<float>(abar, bx, c, h0f, y, hl, ya, B, L,
                                         D, N, s));
}

// The kernel's shared memory (static: c staged CH steps of the compiled
// width at a time) and threads for state width N; launches nothing.
extern "C" int ssm_scan_query(int N, int* smem, int* threads) {
  if (N < 1) return (int)cudaErrorInvalidValue;
  *smem = CH * compiled_width(N) * (int)sizeof(float);
  *threads = THREADS;
  return 0;
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
