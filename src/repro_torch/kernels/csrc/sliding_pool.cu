// Sliding-window pooling along L and the max-pool gradient, for Hopper
// (sm_90a).
//
// Replaces: src/repro/kernels/sliding_pool.py, sliding_pool_pallas (the
// bodies _sum_pool_kernel, _max_pool_shift_kernel and _max_pool_kernel) and
// max_pool_bwd_pallas (the bodies _max_pool_count_kernel and
// _max_pool_bwd_kernel).
//
// What it computes. Forward (sliding_pool): VALID pooling of x (B, L, C)
// along L into y (B, L-w+1, C) in x's type, float32 or bfloat16.
//   sum: per tile of TL outputs, a float32 prefix S over the tile's halo of
//        TL+w-1 rows that starts at the tile's first row, then
//        y[i] = S[i+w-1] - S[i-1] (S[-1] = 0), cast to x's type;
//   avg: the sum cast to x's type, widened, divided by w in float32 and
//        cast again (the TPU kernel's sum rounds, then its wrapper
//        divides: two roundings in bfloat16);
//   max: the van Herk / Gil-Werman block decomposition (blocks of w rows
//        aligned to the halo's first row; y[i] = max(suffix max at i,
//        prefix max at i+w-1)) or the shift-and-max loop; both exact.
// The input may be read through `lead` zero rows placed before it and zero
// rows after it (L = lead + Lsrc + trailing): the sum-pool gradient pools
// dy padded by w-1 rows on both sides without building the padded copy.
// Gradient of max (two launches): max_pool_count writes, for each window,
// dy / max(cnt, 1) in dy's type, cnt = #{m < w : x[i+m] == y[i]} the ties
// (the split is rounded to dy's type before the scatter, as the TPU kernel's
// wrapper does); max_pool_scatter writes
//   dx[j] = sum_{k<w} dys[j-k] * [x[j] == y[j-k]]
// over the windows j-k that exist, summed in float32 in k order, one cast
// to x's type.
//
// What bounds it on this card: pooling is one pass over the input with a
// few adds or compares per element, far below the card's arithmetic rate,
// so bytes bound it: at the paper's shape (1, 16384, 32) f32 that is 4.2 MB
// (1.3 us at 3.35 TB/s), below what one launch costs; at (8, 16384, 1024)
// 1 GB (0.32 ms). The shift forms and the count and scatter are O(n*w)
// reads, served from L1/L2 since each thread walks its own rows.
//
// What the design does about it: one thread owns one channel of one tile of
// TL rows and walks them in order; neighbouring threads own neighbouring
// channels, so a warp's loads and stores of a row are contiguous. The
// per-tile prefix is carried by two running float32 sums, one at row
// i+w-1 and one at row i-1, each accumulating the same rows in the same
// order, so both read S exactly as a stored prefix would hold it and no
// window size caps shared memory (any w <= L works). The block max needs a
// suffix pass: it goes backwards over the tile's blocks and parks each
// suffix max in y itself (a max of x's values is exact in x's type), then
// a forward pass maxes in the block prefix at i+w-1. TL comes from the
// wrapper, chosen from the shape so that enough threads fill the card.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stddef.h>

#include "conv_epilogue.cuh"

namespace {

constexpr int THREADS = 256;

enum PoolOp { OP_SUM = 0, OP_AVG = 1, OP_MAX_SCAN = 2, OP_MAX_SHIFT = 3 };

// One thread's work item: (batch b, tile t, channel c), channels fastest.
struct Item {
  int b, t, c;
};

__device__ __forceinline__ bool item_of(long long idx, int n_tiles, int C,
                                        int B, Item* it) {
  const long long total = (long long)B * n_tiles * C;
  if (idx >= total) return false;
  it->c = (int)(idx % C);
  const long long rest = idx / C;
  it->t = (int)(rest % n_tiles);
  it->b = (int)(rest / n_tiles);
  return true;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
pool_sum_kernel(const T* __restrict__ x, T* __restrict__ y, int lead,
                int Lsrc, int C, int w, int Lout, int TL, int n_tiles, int B,
                int avg) {
  Item it;
  if (!item_of((long long)blockIdx.x * THREADS + threadIdx.x, n_tiles, C, B,
               &it))
    return;
  const int t0 = it.t * TL;
  const int n_out = min(TL, Lout - t0);
  const T* xb = x + (long long)it.b * Lsrc * C + it.c;
  T* yb = y + ((long long)it.b * Lout + t0) * C + it.c;
  // logical row r of the (zero-padded) input: source row r - lead
  auto row = [&](int r) -> float {
    const int s = r - lead;
    return (s >= 0 && s < Lsrc) ? to_f32(xb[(long long)s * C]) : 0.f;
  };
  float hi = 0.f;  // S at halo row i + w - 1 (after the add below)
  for (int j = 0; j < w - 1; ++j) hi += row(t0 + j);
  float lo = 0.f;  // S at halo row i - 1
  for (int i = 0; i < n_out; ++i) {
    hi += row(t0 + i + w - 1);
    float v = to_f32(from_f32<T>(hi - lo));
    if (avg) v = __fdiv_rn(v, (float)w);
    yb[(long long)i * C] = from_f32<T>(v);
    lo += row(t0 + i);
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
pool_max_scan_kernel(const T* __restrict__ x, T* __restrict__ y, int L,
                     int C, int w, int Lout, int TL, int n_tiles, int B) {
  Item it;
  if (!item_of((long long)blockIdx.x * THREADS + threadIdx.x, n_tiles, C, B,
               &it))
    return;
  const int t0 = it.t * TL;
  const int n_out = min(TL, Lout - t0);
  const T* xb = x + ((long long)it.b * L + t0) * C + it.c;
  T* yb = y + ((long long)it.b * Lout + t0) * C + it.c;
  // halo row r (past L: -inf, the TPU kernel's pad value for max)
  auto row = [&](int r) -> float {
    return (t0 + r < L) ? to_f32(xb[(long long)r * C]) : -INFINITY;
  };
  // phase 1, backwards over the blocks that hold outputs 0..n_out-1: the
  // suffix max within each block of w, parked in y
  const int last_blk = (n_out - 1) / w;
  for (int k = last_blk; k >= 0; --k) {
    float suf = -INFINITY;
    for (int r = w - 1; r >= 0; --r) {
      const int i = k * w + r;
      suf = fmaxf(suf, row(i));
      if (i < n_out) yb[(long long)i * C] = from_f32<T>(suf);
    }
  }
  // phase 2, forwards: the prefix max within each block at halo row
  // i + w - 1, maxed into the parked suffix
  float pre = -INFINITY;
  for (int j = 0; j < n_out + w - 1; ++j) {
    if (j % w == 0) pre = -INFINITY;
    pre = fmaxf(pre, row(j));
    const int i = j - (w - 1);
    if (i >= 0) {
      const float s = to_f32(yb[(long long)i * C]);
      yb[(long long)i * C] = from_f32<T>(fmaxf(s, pre));
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
pool_max_shift_kernel(const T* __restrict__ x, T* __restrict__ y, int L,
                      int C, int w, int Lout, int TL, int n_tiles, int B) {
  Item it;
  if (!item_of((long long)blockIdx.x * THREADS + threadIdx.x, n_tiles, C, B,
               &it))
    return;
  const int t0 = it.t * TL;
  const int n_out = min(TL, Lout - t0);
  const T* xb = x + ((long long)it.b * L + t0) * C + it.c;
  T* yb = y + ((long long)it.b * Lout + t0) * C + it.c;
  for (int i = 0; i < n_out; ++i) {
    const T* xi = xb + (long long)i * C;
    float acc = to_f32(xi[0]);
    for (int m = 1; m < w; ++m) acc = fmaxf(acc, to_f32(xi[(long long)m * C]));
    yb[(long long)i * C] = from_f32<T>(acc);
  }
}

// launch 1 of the max gradient: the tie count of each window and the split
template <typename T>
__global__ void __launch_bounds__(THREADS)
max_count_kernel(const T* __restrict__ x, const T* __restrict__ y,
                 const T* __restrict__ dy, T* __restrict__ dys, int L, int C,
                 int w, int Lout, int TL, int n_tiles, int B) {
  Item it;
  if (!item_of((long long)blockIdx.x * THREADS + threadIdx.x, n_tiles, C, B,
               &it))
    return;
  const int t0 = it.t * TL;
  const int n_out = min(TL, Lout - t0);
  const T* xb = x + ((long long)it.b * L + t0) * C + it.c;
  const long long o = ((long long)it.b * Lout + t0) * C + it.c;
  for (int i = 0; i < n_out; ++i) {
    const float yi = to_f32(y[o + (long long)i * C]);
    const T* xi = xb + (long long)i * C;
    float cnt = 0.f;
    for (int m = 0; m < w; ++m)
      cnt += (to_f32(xi[(long long)m * C]) == yi) ? 1.f : 0.f;
    const float g = to_f32(dy[o + (long long)i * C]);
    dys[o + (long long)i * C] = from_f32<T>(__fdiv_rn(g, fmaxf(cnt, 1.f)));
  }
}

// launch 2: each input row gathers the split gradient of every window
// whose maximum it holds
template <typename T>
__global__ void __launch_bounds__(THREADS)
max_scatter_kernel(const T* __restrict__ x, const T* __restrict__ y,
                   const T* __restrict__ dys, T* __restrict__ dx, int L,
                   int C, int w, int Lout, int TL, int n_tiles, int B) {
  Item it;
  if (!item_of((long long)blockIdx.x * THREADS + threadIdx.x, n_tiles, C, B,
               &it))
    return;
  const int t0 = it.t * TL;
  const int n_in = min(TL, L - t0);
  const long long xo = ((long long)it.b * L) * C + it.c;
  const long long yo = ((long long)it.b * Lout) * C + it.c;
  for (int jj = 0; jj < n_in; ++jj) {
    const int j = t0 + jj;
    const float xj = to_f32(x[xo + (long long)j * C]);
    float acc = 0.f;
    for (int k = 0; k < w; ++k) {
      const int win = j - k;  // the window starting at row j - k
      if (win < 0) break;
      if (win >= Lout) continue;
      const long long p = yo + (long long)win * C;
      if (xj == to_f32(y[p])) acc += to_f32(dys[p]);
    }
    dx[xo + (long long)j * C] = from_f32<T>(acc);
  }
}

inline int n_blocks(int B, int n_tiles, int C) {
  return (int)(((long long)B * n_tiles * C + THREADS - 1) / THREADS);
}

inline bool grid_ok(int B, int n_tiles, int C) {
  return (long long)B * n_tiles * C <= (long long)THREADS * 0x7fffffff;
}

template <typename T>
cudaError_t launch_pool(const void* x, void* y, int B, int L, int lead,
                        int Lsrc, int C, int w, int Lout, int TL, int op,
                        cudaStream_t s) {
  const int n_tiles = (Lout + TL - 1) / TL;
  const int grid = n_blocks(B, n_tiles, C);
  const T* xp = static_cast<const T*>(x);
  T* yp = static_cast<T*>(y);
  if (op == OP_SUM || op == OP_AVG)
    pool_sum_kernel<T><<<grid, THREADS, 0, s>>>(
        xp, yp, lead, Lsrc, C, w, Lout, TL, n_tiles, B, op == OP_AVG);
  else if (op == OP_MAX_SCAN)
    pool_max_scan_kernel<T><<<grid, THREADS, 0, s>>>(xp, yp, L, C, w, Lout,
                                                     TL, n_tiles, B);
  else
    pool_max_shift_kernel<T><<<grid, THREADS, 0, s>>>(xp, yp, L, C, w, Lout,
                                                      TL, n_tiles, B);
  return cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t code: 0 when the launch was accepted. x holds Lsrc
// rows of C channels a batch; the pooled sequence is L = lead + Lsrc + the
// zero rows after it (sum and avg only: max takes lead 0 and L = Lsrc).
// y holds Lout = L - w + 1 rows; TL is the tile of output rows a thread
// walks.
extern "C" int sliding_pool(const void* x, void* y, int B, int L, int lead,
                            int Lsrc, int C, int window, int Lout, int tile,
                            int op, int is_bf16, void* stream) {
  if (B < 1 || C < 1 || window < 1 || tile < 1 || op < OP_SUM ||
      op > OP_MAX_SHIFT || Lout != L - window + 1 || Lout < 1 || lead < 0 ||
      Lsrc < 1 || lead + Lsrc > L ||
      (op >= OP_MAX_SCAN && (lead != 0 || Lsrc != L)) ||
      !grid_ok(B, (Lout + tile - 1) / tile, C))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(is_bf16 ? launch_pool<__nv_bfloat16>(x, y, B, L, lead, Lsrc, C,
                                                    window, Lout, tile, op, s)
                       : launch_pool<float>(x, y, B, L, lead, Lsrc, C, window,
                                            Lout, tile, op, s));
}

// The max-pool gradient's first launch: dys = dy / max(ties, 1) in dy's
// type, one entry per window (Lout of them).
extern "C" int max_pool_count(const void* x, const void* y, const void* dy,
                              void* dys, int B, int L, int C, int window,
                              int Lout, int tile, int is_bf16, void* stream) {
  if (B < 1 || C < 1 || window < 1 || tile < 1 || Lout != L - window + 1 ||
      Lout < 1 || !grid_ok(B, (Lout + tile - 1) / tile, C))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_tiles = (Lout + tile - 1) / tile;
  const int grid = n_blocks(B, n_tiles, C);
  if (is_bf16)
    max_count_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(y),
        static_cast<const __nv_bfloat16*>(dy),
        static_cast<__nv_bfloat16*>(dys), L, C, window, Lout, tile, n_tiles,
        B);
  else
    max_count_kernel<float><<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(y),
        static_cast<const float*>(dy), static_cast<float*>(dys), L, C, window,
        Lout, tile, n_tiles, B);
  return (int)cudaGetLastError();
}

// The max-pool gradient's second launch: dx (B, L, C) in x's type; tile is
// the tile of input rows a thread walks.
extern "C" int max_pool_scatter(const void* x, const void* y, const void* dys,
                                void* dx, int B, int L, int C, int window,
                                int Lout, int tile, int is_bf16,
                                void* stream) {
  if (B < 1 || C < 1 || window < 1 || tile < 1 || Lout != L - window + 1 ||
      Lout < 1 || !grid_ok(B, (L + tile - 1) / tile, C))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_tiles = (L + tile - 1) / tile;
  const int grid = n_blocks(B, n_tiles, C);
  if (is_bf16)
    max_scatter_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(y),
        static_cast<const __nv_bfloat16*>(dys),
        static_cast<__nv_bfloat16*>(dx), L, C, window, Lout, tile, n_tiles,
        B);
  else
    max_scatter_kernel<float><<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(y),
        static_cast<const float*>(dys), static_cast<float*>(dx), L, C, window,
        Lout, tile, n_tiles, B);
  return (int)cudaGetLastError();
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
