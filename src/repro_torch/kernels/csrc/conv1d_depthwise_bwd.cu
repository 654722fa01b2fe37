// Weight and bias gradient of the VALID depthwise conv1d, for Hopper
// (sm_90a).
//
// Replaces: src/repro/kernels/sliding_conv_bwd.py,
// conv1d_depthwise_bwd_dw_pallas (the _dw_depthwise_kernel body: per tap,
// the shifted input tile times the dz tile summed over its rows, carried
// over the (batch x row tile) reduction grid in a float32 VMEM scratch
// that is flushed on the last visit).
//
// What it computes, for x (B, L, C) the padded forward input and dz
// (B, Lout, C) the gradient after the epilogue's activation:
//   dw[k, c] = sum_b sum_t x[b, t*stride + k, c] * dz[b, t, c]
//   db[c]    = sum_b sum_t dz[b, t, c]           (when asked for)
// dw (K, C) and db (C,) in float32. float32 or bfloat16 operands; each
// product is rounded to float32 and then added (IEEE round-to-nearest, no
// FMA contraction), as the plain version multiplies and then sums; the
// order of the sum over (b, t) is the kernel's own, fixed: two calls give
// the same bits.
//
// What bounds it on this card: K multiply-adds per element of dz for one
// element of dz and about one of x read. At jamba-1.5-large's training
// shape (B=2, x 515 x 16384 and dz 512 x 16384 in bfloat16, K=4) that is
// 0.13 GFLOP against 67.3 MB: it is bound by bytes (about 0.020 ms at
// 3.35 TB/s), and needs tens of KB in flight on every SM to stream.
//
// What the design does about it: depthwise_rows.cuh's ring, the forward
// kernels' (rows 3 and 15).
//   * Work items. An item is R dz rows of one batch row over a slab of 128
//     channels; a block stages its stride*(R-1)+K rows of x and its R rows
//     of dz into one stage of a cp.async ring, the next item's copies in
//     flight while one computes. The Pallas revisit grid over (batch, row
//     tile) becomes this walk.
//   * A persistent grid of whole slab rounds: slabs x S blocks, S, R and
//     the ring's depth planned by the wrapper from the card's SM count
//     (gemm_plan.depthwise_dw_plan). Block j keeps slab j % slabs for its
//     whole walk (items j, j + grid, ...: the grid is a multiple of the
//     slabs), so its sums never leave registers between items.
//   * Compute. Each of the 4 warps takes a quarter of an item's dz rows; a
//     lane owns 4 neighbouring channels (one conflict-free read of the
//     stage a row) and keeps K x 4 dw sums and 4 db sums in float32
//     registers. For K <= DW_TAPS (4) the taps are unrolled, and at stride
//     1 the window of K x rows stays in fixed registers, each dz row
//     reading one new x row. A larger K takes its taps in groups of
//     DW_TAPS over the same staged rows, each group's sums kept in shared
//     memory between items.
//   * A fixed-order reduction. At the end a block adds its 4 warps' sums in
//     warp order through shared memory and writes its (K+1) x 128 partial:
//     straight into dw and db where S = 1, else into its split's rows of a
//     float32 workspace of S x (K+1) x C, dw's rows then db's, which one
//     reduce_splits pass (split_reduce.cuh) adds in split order. No atomics.
// Channel counts that are not a multiple of 4, or unaligned bases, take
// narrower staged pieces and element stores masked at C.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stddef.h>
#include <stdint.h>

#include "conv_epilogue.cuh"
#include "depthwise_rows.cuh"
#include "split_reduce.cuh"

namespace {

// taps whose sums a lane keeps in registers: K up to this unrolled, a
// larger K in groups of it
constexpr int DW_TAPS = 4;

// shared memory a block takes: the ring, and the warps' (K+1) x DW_SLAB
// float32 sums, in the ring's bytes once it is drained (K unrolled) or
// after it (larger K: the tap groups' sums live there throughout)
long long dw_smem(const DwShape& s) {
  const long long ring = (long long)s.stages * s.stage_bytes;
  const long long red = (long long)DW_WARPS * (s.K + 1) * DW_SLAB * 4;
  return s.K <= DW_TAPS ? (ring > red ? ring : red) : ring + red;
}

// grid: slabs x S blocks; block j sums slab j % slabs over the items of
// split j / slabs and writes its partial to dw and db (S = 1) or to its
// split's rows of the workspace (dw = ws, db = ws + K*C, split_stride =
// (K+1)*C). db may be null (S = 1 without a bias). KW > 0: K = KW,
// unrolled; KW == 0: any K, in tap groups.
template <typename T, int KW>
__global__ void __launch_bounds__(DW_THREADS, DW_RESIDENT)
dw_rows(const T* __restrict__ x, const T* __restrict__ dz,
        float* __restrict__ dw, float* __restrict__ db, size_t split_stride,
        bool vec, DwShape s) {
  constexpr int N = DW_LANE;
  constexpr int SLAB_BYTES = DW_SLAB * sizeof(T);
  using Raw = typename RawOf<N * sizeof(T)>::type;
  extern __shared__ __align__(16) unsigned char ring[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rw = s.rows / DW_WARPS;  // dz rows a warp computes an item
  const int KR = s.K + 1;            // rows of a partial: dw's K, then db
  // the warps' sums, [warp][KR][DW_SLAB]: after the ring for tap groups,
  // else on the ring's bytes once it is drained
  float* red = reinterpret_cast<float*>(
      KW > 0 ? ring : ring + s.stages * s.stage_bytes);
  float* mine = red + warp * KR * DW_SLAB + lane * N;  // the lane's column

  float acc[KW > 0 ? KW : 1][N], dbs[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    dbs[j] = 0.f;
#pragma unroll
    for (int k = 0; k < (KW > 0 ? KW : 1); ++k) acc[k][j] = 0.f;
  }
  if constexpr (KW == 0) {
    for (int k = 0; k < s.K; ++k)
      *reinterpret_cast<float4*>(mine + k * DW_SLAB) =
          make_float4(0.f, 0.f, 0.f, 0.f);
  }

  // an item's x rows, then its dz rows, into a stage
  auto issue = [&](int item, unsigned char* dst) {
    const DwItem it = dw_item(s, item);
    const int c0 = it.slab * DW_SLAB;
    stage_slab(dst, x + (size_t)it.b * s.L * s.C,
               it.chunk * s.rows * s.stride, s.stage_rows, s.L, s.C, c0,
               s.cb);
    stage_slab(dst + s.stage_rows * SLAB_BYTES,
               dz + (size_t)it.b * s.Lout * s.C, it.chunk * s.rows, s.rows,
               s.Lout, s.C, c0, s.cb);
  };

  auto compute = [&](int item, const unsigned char* st) {
    const DwItem it = dw_item(s, item);
    const int r0 = warp * rw;  // the warp's first dz row in the item
    const int n = min(rw, s.Lout - it.chunk * s.rows - r0);  // its rows
    const unsigned char* xs =
        st + r0 * s.stride * SLAB_BYTES + lane * N * (int)sizeof(T);
    const unsigned char* gs =
        st + (s.stage_rows + r0) * SLAB_BYTES + lane * N * (int)sizeof(T);
    // the lane's values of staged row r of base (from the warp's first)
    auto read = [&](const unsigned char* base, int r, float (&out)[N]) {
      const Raw raw = *reinterpret_cast<const Raw*>(base + r * SLAB_BYTES);
      const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < N; ++j) out[j] = widen<float>(v[j]);
    };
    auto add_db = [&](const float (&g)[N]) {
#pragma unroll
      for (int j = 0; j < N; ++j) dbs[j] = dw_add(dbs[j], g[j]);
    };
    if constexpr (KW > 0) {
      if (s.stride == 1) {
        // the window of KW x rows in registers, slot (row mod KW): each
        // dz row reads one new x row; unrolled KW rows a step so that the
        // slots are fixed registers
        float win[KW][N];
#pragma unroll
        for (int k = 0; k + 1 < KW; ++k) read(xs, k, win[k]);
        for (int r = 0; r < n; r += KW) {
#pragma unroll
          for (int p = 0; p < KW; ++p) {
            if (r + p < n) {
              float g[N];
              read(xs, r + p + KW - 1, win[(p + KW - 1) % KW]);
              read(gs, r + p, g);
#pragma unroll
              for (int k = 0; k < KW; ++k)
#pragma unroll
                for (int j = 0; j < N; ++j)
                  acc[k][j] =
                      dw_add(acc[k][j], dw_mul(win[(p + k) % KW][j], g[j]));
              add_db(g);
            }
          }
        }
      } else {
        for (int r = 0; r < n; ++r) {
          float g[N], xv[N];
          read(gs, r, g);
#pragma unroll
          for (int k = 0; k < KW; ++k) {
            read(xs, r * s.stride + k, xv);
#pragma unroll
            for (int j = 0; j < N; ++j)
              acc[k][j] = dw_add(acc[k][j], dw_mul(xv[j], g[j]));
          }
          add_db(g);
        }
      }
    } else {
      // taps k0 .. k0+DW_TAPS-1: their sums from shared memory into
      // registers, over the warp's rows, and back
      for (int k0 = 0; k0 < s.K; k0 += DW_TAPS) {
        const int kt = min(DW_TAPS, s.K - k0);
        float a[DW_TAPS][N];
#pragma unroll
        for (int kk = 0; kk < DW_TAPS; ++kk)
          if (kk < kt) {
            const float4 v =
                *reinterpret_cast<const float4*>(mine + (k0 + kk) * DW_SLAB);
            a[kk][0] = v.x, a[kk][1] = v.y, a[kk][2] = v.z, a[kk][3] = v.w;
          }
        for (int r = 0; r < n; ++r) {
          float g[N], xv[N];
          read(gs, r, g);
#pragma unroll
          for (int kk = 0; kk < DW_TAPS; ++kk)
            if (kk < kt) {
              read(xs, r * s.stride + k0 + kk, xv);
#pragma unroll
              for (int j = 0; j < N; ++j)
                a[kk][j] = dw_add(a[kk][j], dw_mul(xv[j], g[j]));
            }
          if (k0 == 0) add_db(g);
        }
#pragma unroll
        for (int kk = 0; kk < DW_TAPS; ++kk)
          if (kk < kt)
            *reinterpret_cast<float4*>(mine + (k0 + kk) * DW_SLAB) =
                make_float4(a[kk][0], a[kk][1], a[kk][2], a[kk][3]);
      }
    }
  };

  ring_walk(s, ring, issue, compute);
  __syncthreads();  // every warp is done with the ring
  if constexpr (KW > 0) {
#pragma unroll
    for (int k = 0; k < KW; ++k)
      *reinterpret_cast<float4*>(mine + k * DW_SLAB) =
          make_float4(acc[k][0], acc[k][1], acc[k][2], acc[k][3]);
  }
  *reinterpret_cast<float4*>(mine + s.K * DW_SLAB) =
      make_float4(dbs[0], dbs[1], dbs[2], dbs[3]);
  __syncthreads();

  // the block's partial: row k of the 4 warps' sums added in warp order
  const int slab = blockIdx.x % s.slabs, split = blockIdx.x / s.slabs;
  float* dw_out = dw + split * split_stride;
  float* db_out = db == nullptr ? nullptr : db + split * split_stride;
  for (int u = threadIdx.x; u < KR * (DW_SLAB / N); u += DW_THREADS) {
    const int k = u / (DW_SLAB / N), q = (u % (DW_SLAB / N)) * N;
    float* row = k < s.K ? dw_out + (size_t)k * s.C : db_out;
    if (row == nullptr) continue;
    float v[N];
#pragma unroll
    for (int j = 0; j < N; ++j) v[j] = red[k * DW_SLAB + q + j];
#pragma unroll
    for (int w = 1; w < DW_WARPS; ++w)
#pragma unroll
      for (int j = 0; j < N; ++j)
        v[j] = dw_add(v[j], red[(w * KR + k) * DW_SLAB + q + j]);
    store_lane<float>(row, slab * DW_SLAB + q, s.C, v, vec);
  }
}

template <typename T, int KW>
cudaError_t launch_kw(const void* x, const void* dz, float* dw, float* db,
                      size_t split_stride, bool vec, const DwShape& s,
                      int blocks, int smem, cudaStream_t stream) {
  auto kernel = dw_rows<T, KW>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, DW_THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dz), dw, db,
      split_stride, vec, s);
  return cudaGetLastError();
}

// the K dispatch: K in {1, 2, 3, 4} unrolled, any other K in tap groups
template <typename T>
cudaError_t launch(const void* x, const void* dz, float* dw, float* db,
                   size_t split_stride, bool vec, const DwShape& s, int blocks,
                   int smem, cudaStream_t stream) {
  switch (s.K) {
    case 1:
      return launch_kw<T, 1>(x, dz, dw, db, split_stride, vec, s, blocks,
                             smem, stream);
    case 2:
      return launch_kw<T, 2>(x, dz, dw, db, split_stride, vec, s, blocks,
                             smem, stream);
    case 3:
      return launch_kw<T, 3>(x, dz, dw, db, split_stride, vec, s, blocks,
                             smem, stream);
    case 4:
      return launch_kw<T, 4>(x, dz, dw, db, split_stride, vec, s, blocks,
                             smem, stream);
    default:
      return launch_kw<T, 0>(x, dz, dw, db, split_stride, vec, s, blocks,
                             smem, stream);
  }
}

// reduce_splits' grid: 256-thread blocks over n sums, at most two a SM
int reduce_blocks(size_t n, int sms) {
  const size_t want = (n + 255) / 256;
  return (int)(want < (size_t)(2 * sms) ? want : (size_t)(2 * sms));
}

}  // namespace

// Returns a cudaError_t code: 0 when the launches were accepted. db may be
// null (no bias). rows, stages and splits are the wrapper's plan
// (gemm_plan.depthwise_dw_plan, from the card's SM count sms), copy_bytes
// the width x's and dz's alignment allows their staged pieces (16, 8, 4, 2
// bytes); ws is a float32 workspace of splits * (K + 1) * C floats, null
// when splits is 1. A shape or plan the kernel does not take is refused
// with cudaErrorInvalidValue.
extern "C" int conv1d_depthwise_bwd_dw(const void* x, const void* dz,
                                       float* dw, float* db, float* ws,
                                       int B, int L, int C, int K, int stride,
                                       int Lout, int is_bf16, int rows,
                                       int stages, int splits, int copy_bytes,
                                       int sms, void* stream) {
  DwShape s{L, C, K, stride, Lout, rows, stages, copy_bytes, rows};
  const int elem = is_bf16 ? 2 : 4;
  if (B < 1 || C < 1 || K < 1 || stride < 1 || Lout < 1 || splits < 1 ||
      sms < 1 || (long long)(Lout - 1) * stride + K > L ||
      !dw_geometry(s, B, elem, splits) || copy_bytes < 2 ||
      (uintptr_t)x % copy_bytes != 0 || (uintptr_t)dz % copy_bytes != 0 ||
      (long long)splits > (long long)B * s.chunks ||
      (long long)s.slabs * splits > INT32_MAX ||
      (splits > 1 && ws == nullptr) || dw_smem(s) > DW_SMEM_MAX)
    return (int)cudaErrorInvalidValue;
  const size_t n_dw = (size_t)K * C, n = n_dw + C;
  float* dw_out = splits > 1 ? ws : dw;
  float* db_out = splits > 1 ? ws + n_dw : db;
  const bool vec = store_aligned<float>(dw_out, C) &&
                   store_aligned<float>(db_out, C);
  const int blocks = s.slabs * splits;
  const int smem = (int)dw_smem(s);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      is_bf16 ? launch<__nv_bfloat16>(x, dz, dw_out, db_out,
                                      splits > 1 ? n : 0, vec, s, blocks,
                                      smem, st)
              : launch<float>(x, dz, dw_out, db_out, splits > 1 ? n : 0, vec,
                              s, blocks, smem, st);
  if (err != cudaSuccess || splits == 1) return (int)err;
  reduce_splits<<<reduce_blocks(n, sms), 256, 0, st>>>(ws, dw, db, n_dw, n,
                                                        splits);
  return (int)cudaGetLastError();
}

// The launch's dynamic shared memory and threads for the same shape and
// plan as conv1d_depthwise_bwd_dw (x_kind 0 float32, 1 bfloat16); launches
// nothing, and refuses a ring over DW_SMEM_MAX as the launch does.
extern "C" int conv1d_depthwise_bwd_dw_query(int B, int L, int C, int K,
                                             int stride, int Lout, int x_kind,
                                             int rows, int stages, int splits,
                                             int copy_bytes, int* smem,
                                             int* threads) {
  DwShape s{L, C, K, stride, Lout, rows, stages, copy_bytes, rows};
  if (x_kind < 0 || x_kind > 1 || splits < 1 ||
      !dw_geometry(s, B, x_kind ? 2 : 4, splits) || dw_smem(s) > DW_SMEM_MAX)
    return (int)cudaErrorInvalidValue;
  *smem = (int)dw_smem(s);
  *threads = DW_THREADS;
  return 0;
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
