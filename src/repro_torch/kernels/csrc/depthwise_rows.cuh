// Shared by the depthwise kernels: the staged body of the forward convs,
// float (conv1d_depthwise.cu, row 3) and int8 (conv1d_depthwise_quant.cu,
// row 15), and the per-thread row loads of the weight gradient
// (conv1d_depthwise_bwd.cu, row 11).
//
// The forward body computes a VALID depthwise sliding sum over taps on an
// input the caller has already padded,
//   acc[b, i, c] = sum_k w[k, c] * x[b, i*stride + k, c]   (k = 0 .. K-1)
// and hands each output row's sums to an epilogue functor. Accumulator
// policy: A = float takes IEEE round-to-nearest products and sums tap by
// tap in order k = 0 .. K-1 (no FMA contraction), the plain versions'
// order and rounding; A = int takes exact int32 sums of int8 products.
//
// What bounds it on the H100: K multiply-adds per output element for one
// input element read and one output element written, so bytes; at mamba's
// prefill shape it needs several MB in flight across the card to stream.
//
// The design:
//   * Work items. An item is one batch row's chunk of R output rows over a
//     slab of DW_SLAB = 128 channels (a warp's 32 lanes x 4 channels: 256
//     bytes of a bf16 row, 512 of f32, 128 int8 codes). Items are numbered
//     slab fastest, then chunk, then batch row, so that the blocks running
//     at one time read whole rows and the neighbouring chunk's halo is
//     read near the same time, from the L2.
//   * Persistent grid. The wrapper plans the block count, R and the ring's
//     depth from the card's SM count (gemm_plan.depthwise_plan); block j
//     walks items j, j + grid, j + 2 grid, ...
//   * Staging. For each item a block copies the stride*(R-1)+K input rows
//     of its slab, halo included, into one stage of a ring of 2-4
//     shared-memory stages by cp.async (cp_async.cuh), as wide as the
//     input's alignment allows (16 bytes on the main path, whatever the
//     type): the copies of the next stages-1 items are in flight while
//     this item computes and stores, one __syncthreads an item. Rows past
//     L and channels past C stage as zeros.
//   * Compute. Each of the 4 warps takes a quarter of the chunk's output
//     rows; a lane owns 4 neighbouring channels and reads them from the
//     stage with one 4-, 8- or 16-byte load (conflict-free). The lane's
//     work is small so that 8 blocks (32 warps) fit an SM: the epilogue's
//     activation is a chain of dependent operations a value (silu: an exp
//     and an IEEE division), and the warps hide each other's latency. For
//     K in {2, 3, 4} at stride 1 the window of K rows stays in registers,
//     each output row reading one new row (unrolled K rows a step, so the
//     window's slots stay fixed registers); other strides read the K rows
//     of each output row, other K each tap's row and weights. The weights
//     (and the epilogue's scales and bias) are loaded into registers when
//     a block's item changes slab: once a block on the main path, where
//     the grid is a multiple of the slabs.
//   * Stores. The epilogue applies the activation with its switch taken
//     once a row (activate_all) and stores the lane's 4 outputs as one
//     vector (8 bytes of bf16, 16 of f32, 4 of int8 codes) where C and the
//     output's base allow it, else element by element, masked at C.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "conv_epilogue.cuh"
#include "cp_async.cuh"

namespace {

// ---------------------------------------------------------------------------
// row 11: each thread owns N neighbouring channels, 16 bytes of a row (4
// float32 or 8 bfloat16 values), loaded as one 16-byte access when the
// channel count and the bases allow it (ALIGNED), else as scalar accesses
// masked at C.

template <typename T> struct VecOf;  // values of T in 16 bytes
template <> struct VecOf<float> { static constexpr int N = 4; };
template <> struct VecOf<__nv_bfloat16> { static constexpr int N = 8; };

// N values of a row from channel c0 on, as floats: one 16-byte load when
// ALIGNED (then c0 + N <= C), else scalar loads, zero past C
template <typename T, bool ALIGNED, int N = VecOf<T>::N>
__device__ __forceinline__ void load_row(const T* __restrict__ row, int c0,
                                         int C, float (&out)[N]) {
  if (ALIGNED) {
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(row + c0));
    const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int j = 0; j < N; ++j) out[j] = to_f32(v[j]);
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j)
      out[j] = c0 + j < C ? to_f32(row[c0 + j]) : 0.f;
  }
}

// ---------------------------------------------------------------------------
// rows 3 and 15: the staged body

constexpr int DW_LANE = 4;        // neighbouring channels a lane owns
constexpr int DW_SLAB = 32 * DW_LANE;  // channels of a work item: a warp's
constexpr int DW_THREADS = 128;   // 4 warps, a quarter of R rows each
constexpr int DW_WARPS = DW_THREADS / 32;
constexpr int DW_RESIDENT = 8;    // blocks an SM holds (launch bounds)
constexpr int DW_SMEM_MAX = 232448;  // shared memory a block may use

// a lane's DW_LANE values of TX as one read of the stage
template <int BYTES> struct RawOf;
template <> struct RawOf<4> { using type = unsigned; };
template <> struct RawOf<8> { using type = uint2; };
template <> struct RawOf<16> { using type = uint4; };

// widening to the accumulator's type: int32 (w8a8) or float32
template <typename A> __device__ __forceinline__ A widen(int8_t v) {
  return static_cast<A>(v);
}
template <typename A> __device__ __forceinline__ A widen(float v) { return v; }
template <typename A> __device__ __forceinline__ A widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ int dw_mul(int a, int b) { return a * b; }
__device__ __forceinline__ float dw_mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ int dw_add(int a, int b) { return a + b; }
__device__ __forceinline__ float dw_add(float a, float b) {
  return __fadd_rn(a, b);
}

// conv_epilogue.cuh's activation over a lane's values, the switch taken
// once so that the values' chains interleave (the same arithmetic)
template <int N>
__device__ __forceinline__ void activate_all(float (&v)[N], int act) {
  switch (act) {
    case ACT_RELU:
#pragma unroll
      for (int j = 0; j < N; ++j) v[j] = activate(v[j], ACT_RELU);
      break;
    case ACT_GELU:
#pragma unroll
      for (int j = 0; j < N; ++j) v[j] = activate(v[j], ACT_GELU);
      break;
    case ACT_SILU:
#pragma unroll
      for (int j = 0; j < N; ++j) v[j] = activate(v[j], ACT_SILU);
      break;
    default:
      break;
  }
}

// DW_LANE values of TO from channel c0 on: one vector store when vec (C a
// multiple of DW_LANE and the base aligned to the vector: then the lane's
// channels are all in or all out), else element stores masked at C
template <typename TO>
__device__ __forceinline__ void store_lane(TO* __restrict__ row, int c0,
                                           int C, const TO (&v)[DW_LANE],
                                           bool vec) {
  constexpr int BYTES = DW_LANE * sizeof(TO);
  if (vec) {
    if (c0 < C)
      *reinterpret_cast<typename RawOf<BYTES>::type*>(row + c0) =
          *reinterpret_cast<const typename RawOf<BYTES>::type*>(v);
  } else {
#pragma unroll
    for (int j = 0; j < DW_LANE; ++j)
      if (c0 + j < C) row[c0 + j] = v[j];
  }
}

// whether p (null: no output) and C take a lane's vector stores of TO
template <typename TO>
bool store_aligned(const void* p, int C) {
  return p == nullptr || (C % DW_LANE == 0 &&
                          (uintptr_t)p % (DW_LANE * sizeof(TO)) == 0);
}

// one staged piece of CB bytes (cp_async.cuh's widths, and 1 for int8
// codes, a plain byte copy)
__device__ __forceinline__ void stage_copy(void* dst, const void* src, int cb,
                                           bool valid) {
  if (cb == 1)
    *static_cast<uint8_t*>(dst) = valid ? *static_cast<const uint8_t*>(src)
                                        : static_cast<uint8_t>(0);
  else
    copy_in(dst, src, cb, valid);
}

// wait until at most n (0 .. 2) of this thread's copy groups are pending
__device__ __forceinline__ void cp_wait_pending(int n) {
  switch (n) {
    case 0: cp_wait<0>(); break;
    case 1: cp_wait<1>(); break;
    default: cp_wait<2>();
  }
}

// The launch, worked out and checked by dw_geometry from the wrapper's plan.
struct DwShape {
  int L, C, K, stride, Lout;
  int rows;        // R, output rows of an item (a multiple of DW_WARPS)
  int stages;      // the ring's depth, 2 .. 4
  int cb;          // staged piece width in bytes: 16, 8, 4, 2 or 1
  int stage_rows;  // stride*(R-1)+K
  int slabs, chunks, items;
};

// a stage's bytes and the shape's geometry; false where the plan does not
// fit the kernel (the caller refuses the launch)
inline bool dw_geometry(DwShape& s, int B, int elem, int blocks) {
  if (s.rows < DW_WARPS || s.rows % DW_WARPS != 0 || s.rows > 64 ||
      s.stages < 2 || s.stages > 4 || blocks < 1 ||
      !(s.cb == 16 || s.cb == 8 || s.cb == 4 || s.cb == 2 || s.cb == 1) ||
      s.cb < elem || s.cb > DW_SLAB * elem || (s.C * elem) % s.cb != 0)
    return false;
  s.stage_rows = s.stride * (s.rows - 1) + s.K;
  s.slabs = (s.C + DW_SLAB - 1) / DW_SLAB;
  s.chunks = (s.Lout + s.rows - 1) / s.rows;
  const long long items = (long long)B * s.chunks * s.slabs;
  const long long smem = (long long)s.stages * s.stage_rows * DW_SLAB * elem;
  if (items > INT32_MAX || smem > DW_SMEM_MAX) return false;
  s.items = (int)items;
  return true;
}

// TX the input's type, TW the weights' (TX, or int8 codes), A the
// accumulator (float or int), KW > 0: K = KW, unrolled; KW == 0: any K.
// Epi: begin(c0) once per item, store(row offset, c0, sums) once per
// output row, for the lane's channels c0 .. c0 + DW_LANE - 1.
template <typename TX, typename TW, typename A, int KW, class Epi>
__global__ void __launch_bounds__(DW_THREADS, DW_RESIDENT)
depthwise_rows(const TX* __restrict__ x, const TW* __restrict__ w,
               const Epi epi_arg, DwShape s) {
  constexpr int N = DW_LANE;
  using Raw = typename RawOf<N * sizeof(TX)>::type;
  extern __shared__ __align__(16) unsigned char ring[];
  constexpr int SLAB_BYTES = DW_SLAB * sizeof(TX);
  Epi epi = epi_arg;  // begin() fills its per-item registers
  const int stage_bytes = s.stage_rows * SLAB_BYTES;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rw = s.rows / DW_WARPS;  // output rows a warp computes an item
  const int per_row = SLAB_BYTES / s.cb;  // pieces a staged row takes
  const int shift = __ffs(per_row) - 1;   // a power of two
  const int piece = s.cb / (int)sizeof(TX);  // channels a piece holds

  // the input rows of item `item` into stage `stage`
  auto issue = [&](int item, int stage) {
    if (item >= s.items) return;
    const int slab = item % s.slabs, rest = item / s.slabs;
    const int chunk = rest % s.chunks, b = rest / s.chunks;
    const int r0 = chunk * s.rows * s.stride, c0 = slab * DW_SLAB;
    const TX* xb = x + (size_t)b * s.L * s.C;
    unsigned char* dst = ring + stage * stage_bytes;
    const int n = s.stage_rows * per_row;
    for (int u = threadIdx.x; u < n; u += DW_THREADS) {
      const int r = u >> shift, col = u & (per_row - 1);
      const int row = r0 + r, c = c0 + col * piece;
      const bool valid = row < s.L && c < s.C;
      stage_copy(dst + r * SLAB_BYTES + col * s.cb,
                 valid ? xb + (size_t)row * s.C + c : x, s.cb, valid);
    }
  };

  // the weights and the epilogue's constants of the slab last computed:
  // a block's items keep one slab where the grid is a multiple of the
  // slabs, and then they are loaded once
  int cur_slab = -1;
  A wr[KW > 0 ? KW : 1][N];
  auto compute = [&](int item, const unsigned char* st) {
    const int slab = item % s.slabs, rest = item / s.slabs;
    const int chunk = rest % s.chunks, b = rest / s.chunks;
    const int c0 = slab * DW_SLAB + lane * N;  // the lane's channels
    const int o0 = chunk * s.rows + warp * rw;  // the warp's output rows
    const int o1 = min(o0 + rw, s.Lout);
    const unsigned char* base = st + warp * rw * s.stride * SLAB_BYTES +
                                lane * N * (int)sizeof(TX);
    const size_t out0 = (size_t)b * s.Lout;
    // the lane's values of stage row r (counted from the warp's first)
    auto read = [&](int r, A (&out)[N]) {
      const Raw raw = *reinterpret_cast<const Raw*>(base + r * SLAB_BYTES);
      const TX* v = reinterpret_cast<const TX*>(&raw);
#pragma unroll
      for (int j = 0; j < N; ++j) out[j] = widen<A>(v[j]);
    };
    auto weights = [&](int k, A (&out)[N]) {
#pragma unroll
      for (int j = 0; j < N; ++j)
        out[j] = c0 + j < s.C ? widen<A>(w[(size_t)k * s.C + c0 + j]) : A(0);
    };
    if (slab != cur_slab) {
      cur_slab = slab;
      epi.begin(c0);
      if constexpr (KW > 0) {
#pragma unroll
        for (int k = 0; k < KW; ++k) weights(k, wr[k]);
      }
    }
    if constexpr (KW > 0) {
      if (s.stride == 1) {
        // the window of KW rows in registers, slot (row mod KW): each
        // output row reads one new row; unrolled KW rows a step so that
        // the slots are fixed registers
        A win[KW][N];
#pragma unroll
        for (int k = 0; k + 1 < KW; ++k) read(k, win[k]);
        for (int o = o0; o < o1; o += KW) {
#pragma unroll
          for (int p = 0; p < KW; ++p) {
            if (o + p < o1) {
              const int r = o + p - o0;
              read(r + KW - 1, win[(p + KW - 1) % KW]);
              A acc[N];
#pragma unroll
              for (int j = 0; j < N; ++j)
                acc[j] = dw_mul(win[p % KW][j], wr[0][j]);
#pragma unroll
              for (int k = 1; k < KW; ++k)
#pragma unroll
                for (int j = 0; j < N; ++j)
                  acc[j] = dw_add(acc[j],
                                  dw_mul(win[(p + k) % KW][j], wr[k][j]));
              epi.store((out0 + o + p) * s.C, c0, acc);
            }
          }
        }
      } else {
        for (int o = o0; o < o1; ++o) {
          const int r = (o - o0) * s.stride;
          A acc[N], xv[N];
#pragma unroll
          for (int k = 0; k < KW; ++k) {
            read(r + k, xv);
#pragma unroll
            for (int j = 0; j < N; ++j) {
              const A t = dw_mul(xv[j], wr[k][j]);
              acc[j] = k == 0 ? t : dw_add(acc[j], t);
            }
          }
          epi.store((out0 + o) * s.C, c0, acc);
        }
      }
    } else {
      for (int o = o0; o < o1; ++o) {
        const int r = (o - o0) * s.stride;
        A acc[N], xv[N], wv[N];
        for (int k = 0; k < s.K; ++k) {
          read(r + k, xv);
          weights(k, wv);
#pragma unroll
          for (int j = 0; j < N; ++j) {
            const A t = dw_mul(xv[j], wv[j]);
            acc[j] = k == 0 ? t : dw_add(acc[j], t);
          }
        }
        epi.store((out0 + o) * s.C, c0, acc);
      }
    }
  };

  const int first = blockIdx.x, step = gridDim.x;
  const int mine = first < s.items ? (s.items - first + step - 1) / step : 0;
  for (int i = 0; i + 1 < s.stages; ++i) {
    issue(first + i * step, i);
    cp_commit();
  }
  for (int i = 0; i < mine; ++i) {
    cp_wait_pending(s.stages - 2);  // item i has landed (this thread's part)
    __syncthreads();  // ... everyone's; and item i-1's stage is free again
    const int ahead = i + s.stages - 1;
    issue(first + ahead * step, ahead % s.stages);
    cp_commit();
    compute(first + i * step, ring + (i % s.stages) * stage_bytes);
  }
  cp_wait<0>();
}

// launches depthwise_rows with the dynamic shared memory its ring takes
template <typename TX, typename TW, typename A, int KW, class Epi>
cudaError_t launch_depthwise_rows(const void* x, const void* w, const Epi& epi,
                                  const DwShape& s, int blocks,
                                  cudaStream_t stream) {
  auto kernel = depthwise_rows<TX, TW, A, KW, Epi>;
  const int smem = s.stages * s.stage_rows * DW_SLAB * (int)sizeof(TX);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, DW_THREADS, smem, stream>>>(
      static_cast<const TX*>(x), static_cast<const TW*>(w), epi, s);
  return cudaGetLastError();
}

// the K dispatch: K in {2, 3, 4} unrolled, any other K generic
template <typename TX, typename TW, typename A, class Epi>
cudaError_t launch_depthwise_k(const void* x, const void* w, const Epi& epi,
                               const DwShape& s, int blocks,
                               cudaStream_t stream) {
  switch (s.K) {
    case 2:
      return launch_depthwise_rows<TX, TW, A, 2>(x, w, epi, s, blocks, stream);
    case 3:
      return launch_depthwise_rows<TX, TW, A, 3>(x, w, epi, s, blocks, stream);
    case 4:
      return launch_depthwise_rows<TX, TW, A, 4>(x, w, epi, s, blocks, stream);
    default:
      return launch_depthwise_rows<TX, TW, A, 0>(x, w, epi, s, blocks, stream);
  }
}

}  // namespace
