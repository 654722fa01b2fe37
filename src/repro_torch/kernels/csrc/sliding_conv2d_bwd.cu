// Weight and bias gradient of the VALID sliding conv2d, for Hopper
// (sm_90a).
//
// Replaces: src/repro/kernels/sliding_conv_bwd.py, conv2d_bwd_dw_pallas
// (the _dw2d_kernel body, its (batch x tile-row x tile-column) reduction
// grid with the f32 VMEM scratch, and the db output gated to the
// cin-block-0 visits).
//
// What it computes, for x (B, H, W, Cin) the padded forward input and dz
// (B, oh, ow, Cout) the gradient after the epilogue's activation:
//   dw[i, j, c, n] = sum_{b, oy, ox} x[b, oy*sh + i, ox*sw + j, c]
//                                    * dz[b, oy, ox, n]
//   db[n]          = sum_{b, oy, ox} dz[b, oy, ox, n]
// dw (kh, kw, Cin, Cout) and db (Cout,) in float32. float32 or bfloat16
// operands, the sums always in float32 on the CUDA cores, never in TF32.
//
// What bounds it on this card: at llava's patch embedding (x (20, 336, 336,
// 3), dz (20, 24, 24, 1152), kh = kw = stride = 14) the work is 15.6 GFLOP
// against 42.7 MB of traffic in bf16: bound by arithmetic, 0.0158 ms on the
// bf16 tensor cores, 0.233 ms on the CUDA cores' float32 rate. This kernel
// sums in float32 on the CUDA cores (both types), so the second is its
// ceiling; tensor-core (wgmma) tiles for bf16 are later work.
//
// What the design does about it: dw is a product over the B*oh*ow output
// positions p, dw[(i, r), n] = sum_p X_i[p, r] * dz[p, n], where r = j*Cin
// + c runs over filter row i's (tap, channel) pairs. In NHWC those kw*Cin
// values of position p are one contiguous run of x's input row oy*sh + i,
// starting at column ox*sw (the paper's vector slide): each block owns one
// filter row i, TR consecutive values r of that run and TN output channels,
// keeps a 4x4 register tile of float32 sums a thread, and walks the
// positions in tiles of TP. Each step stages, for every position of the
// tile, its TR values as one coalesced copy of a contiguous run (its
// offset computed once a position), and the tile's TP x TN slice of dz,
// in shared memory: no im2col buffer in device memory. The reduction,
// which the Pallas kernel walks as revisited grid dimensions with a scratch
// flushed on the last visit, is this loop inside the block: blocks run in
// no order, so nothing can be carried from one block to the next. Where
// the blocks alone would leave the 132 SMs short of work (fig1's k=3 has 6
// blocks), the position tiles are split over S blocks that each write a
// float32 partial to a workspace, and a second pass adds the S partials in
// a fixed order (split_reduce.cuh): no atomics, so the result does not
// change from run to run. db is summed once per Cout tile, by the blocks of
// filter row 0's first run tile, from the dz tile they stage anyway.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stddef.h>

#include "conv_epilogue.cuh"
#include "split_reduce.cuh"

namespace {

constexpr int TP = 64;        // output positions per reduction step
constexpr int TR = 64;        // a filter row's (tap, channel) values per block
constexpr int TN = 64;        // output channels per block
constexpr int THREADS = 256;  // 16 x 16 threads, a 4x4 (r, n) patch each
constexpr int RR = TR / 16;
constexpr int RN = TN / 16;
constexpr int MIN_BLOCKS = 4 * 132;  // split the positions below this many

// grid: (Cout tiles, kh * run tiles, splits). Split s reduces position
// tiles [s * per, (s + 1) * per) of the n_tiles = ceil(B*oh*ow / TP) tiles
// and writes dw (one split) or its slice of the workspace. B*oh*ow < 2^31.
template <typename T>
__global__ void __launch_bounds__(THREADS)
dw2d_kernel(const T* __restrict__ x, const T* __restrict__ dz,
            float* __restrict__ dw, float* __restrict__ db, int B, int H,
            int W, int Cin, int Cout, int kw, int sh, int sw, int oh, int ow,
            int run_tiles, int per, int n_tiles) {
  __shared__ __align__(16) float xs[TP * TR];
  __shared__ __align__(16) float dzs[TP * TN];
  __shared__ long long run[TP];  // x offset of each position's run, or -1
  const int n0 = blockIdx.x * TN;
  const int fi = blockIdx.y / run_tiles;
  const int r0 = (blockIdx.y % run_tiles) * TR;
  const int red = kw * Cin;  // values in one filter row's run
  const int img = oh * ow;
  const int n_pos = B * img;
  const int split = blockIdx.z;
  const int first = split * per;
  const int last = min(first + per, n_tiles);
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const bool does_db = db != nullptr && blockIdx.y == 0;

  float acc[RR][RN];
#pragma unroll
  for (int i = 0; i < RR; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) acc[i][j] = 0.f;
  float dbs = 0.f;  // column threadIdx.x of db, threads < TN

  for (int tile = first; tile < last; ++tile) {
    const int p0 = tile * TP;
    __syncthreads();  // every reader of the previous tile is done
    if (threadIdx.x < TP) {
      const int p = p0 + threadIdx.x;
      long long off = -1;
      if (p < n_pos) {
        const int b = p / img, rem = p - b * img;
        const int oy = rem / ow, ox = rem - oy * ow;
        off = (((long long)b * H + oy * sh + fi) * W + (long long)ox * sw) *
              Cin;
      }
      run[threadIdx.x] = off;
    }
    // dz rows: positions past the end are zero, so they add nothing
    for (int e = threadIdx.x; e < TP * TN; e += THREADS) {
      const int t = e / TN, n = e % TN;
      const int p = p0 + t;
      const int gn = n0 + n;
      dzs[e] = (p < n_pos && gn < Cout)
                   ? to_f32(dz[(size_t)p * Cout + gn])
                   : 0.f;
    }
    __syncthreads();  // run offsets and the dz tile are in place
    for (int e = threadIdx.x; e < TP * TR; e += THREADS) {
      const int t = e / TR, r = e % TR;
      const long long off = run[t];
      xs[e] = (off >= 0 && r0 + r < red) ? to_f32(x[off + r0 + r]) : 0.f;
    }
    if (does_db && threadIdx.x < TN)
      for (int t = 0; t < TP; ++t) dbs += dzs[t * TN + threadIdx.x];
    __syncthreads();  // the runs are in place
#pragma unroll 4
    for (int t = 0; t < TP; ++t) {
      const float4 a =
          *reinterpret_cast<const float4*>(xs + t * TR + ty * RR);
      const float4 g =
          *reinterpret_cast<const float4*>(dzs + t * TN + tx * RN);
      const float av[RR] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int i = 0; i < RR; ++i) {
        acc[i][0] = fmaf(av[i], g.x, acc[i][0]);
        acc[i][1] = fmaf(av[i], g.y, acc[i][1]);
        acc[i][2] = fmaf(av[i], g.z, acc[i][2]);
        acc[i][3] = fmaf(av[i], g.w, acc[i][3]);
      }
    }
  }

  // dw (or this split's slice of the workspace): (kh, kw*Cin, Cout)
  // row-major, row fi's run value r at row fi * red + r
  const int kh = gridDim.y / run_tiles;
  float* out = dw + (size_t)split * kh * red * Cout;
#pragma unroll
  for (int i = 0; i < RR; ++i) {
    const int r = r0 + ty * RR + i;
    if (r >= red) continue;
    float* row = out + ((size_t)fi * red + r) * Cout;
#pragma unroll
    for (int j = 0; j < RN; ++j) {
      const int n = n0 + tx * RN + j;
      if (n < Cout) row[n] = acc[i][j];
    }
  }
  if (does_db && threadIdx.x < TN && n0 + threadIdx.x < Cout)
    db[(size_t)split * Cout + n0 + threadIdx.x] = dbs;
}

// blocks before any split: Cout tiles x filter rows x run tiles
int base_blocks(int Cout, int kh, int kw, int Cin) {
  return ((Cout + TN - 1) / TN) * kh * ((kw * Cin + TR - 1) / TR);
}

}  // namespace

// How many splits of the position tiles the kernel uses for this shape (1:
// no workspace). The caller allocates S * (kh * kw * Cin * Cout + Cout)
// floats of workspace when S > 1.
extern "C" int conv2d_bwd_dw_splits(int B, int Cin, int Cout, int kh, int kw,
                                    int oh, int ow) {
  const int blocks = base_blocks(Cout, kh, kw, Cin);
  const long long n_tiles = ((long long)B * oh * ow + TP - 1) / TP;
  if (blocks >= MIN_BLOCKS) return 1;
  const int want = (MIN_BLOCKS + blocks - 1) / blocks;
  return want < n_tiles ? want : (int)n_tiles;
}

// Returns a cudaError_t code: 0 when the launches were accepted. db may be
// null (no bias). ws is the float32 workspace of conv2d_bwd_dw_splits()
// splits (null when that is 1). A grid the card cannot launch is refused
// with cudaErrorInvalidValue.
extern "C" int conv2d_bwd_dw(const void* x, const void* dz, float* dw,
                             float* db, float* ws, int B, int H, int W,
                             int Cin, int Cout, int kh, int kw, int sh, int sw,
                             int oh, int ow, int is_bf16, void* stream) {
  if (B < 1 || Cin < 1 || Cout < 1 || kh < 1 || kw < 1 || sh < 1 || sw < 1 ||
      oh < 1 || ow < 1 || (oh - 1) * sh + kh > H || (ow - 1) * sw + kw > W)
    return (int)cudaErrorInvalidValue;
  const int run_tiles = (kw * Cin + TR - 1) / TR;
  if ((long long)B * oh * ow + TP > 0x7fffffffLL ||
      (long long)kh * run_tiles > 65535)
    return (int)cudaErrorInvalidValue;
  const int n_tiles = (B * oh * ow + TP - 1) / TP;
  const int S = conv2d_bwd_dw_splits(B, Cin, Cout, kh, kw, oh, ow);
  if (S > 1 && ws == nullptr) return (int)cudaErrorInvalidValue;
  const int per = (n_tiles + S - 1) / S;
  const int used = (n_tiles + per - 1) / per;  // splits that get a tile
  if (used > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t n_dw = (size_t)kh * kw * Cin * Cout;
  float* dw_out = used > 1 ? ws : dw;
  float* db_out = db == nullptr ? nullptr : (used > 1 ? ws + used * n_dw : db);
  const dim3 grid((Cout + TN - 1) / TN, kh * run_tiles, used);
  if (is_bf16)
    dw2d_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(dz), dw_out, db_out, B, H, W, Cin,
        Cout, kw, sh, sw, oh, ow, run_tiles, per, n_tiles);
  else
    dw2d_kernel<float><<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(dz), dw_out,
        db_out, B, H, W, Cin, Cout, kw, sh, sw, oh, ow, run_tiles, per,
        n_tiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || used == 1) return (int)err;
  reduce_splits<<<264, 256, 0, s>>>(ws, dw, n_dw, used);
  if (db != nullptr)
    reduce_splits<<<8, 256, 0, s>>>(ws + used * n_dw, db, Cout, used);
  return (int)cudaGetLastError();
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
