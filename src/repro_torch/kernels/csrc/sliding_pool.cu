// Sliding-window pooling along L and the max-pool gradient, for Hopper
// (sm_90a).
//
// Replaces: src/repro/kernels/sliding_pool.py, sliding_pool_pallas (the
// bodies _sum_pool_kernel, _max_pool_shift_kernel and _max_pool_kernel) and
// max_pool_bwd_pallas (the bodies _max_pool_count_kernel and
// _max_pool_bwd_kernel).
//
// What it computes. Forward (sliding_pool): VALID pooling of x (B, L, C)
// along L into y (B, L-w+1, C) in x's type, float32 or bfloat16. A block
// owns R output rows of one batch row and CB channels; its halo is the
// R+w-1 input rows they read, from the block's first output row on.
//   sum: a float32 prefix S over the halo in one fixed order: the halo is
//        cut into runs of Q rows from its first row, each run summed in
//        sequence (p), the runs' totals carried in run order (c_0 = 0,
//        c_{q+1} = c_q + total of run q) and S = c_q + p; then
//        y[i] = S[i+w-1] - S[i-1] (S[-1] = 0), cast to x's type;
//   avg: the sum cast to x's type, widened, divided by w in float32 and
//        cast again (the TPU kernel's sum rounds, then its wrapper
//        divides: two roundings in bfloat16);
//   max: the van Herk / Gil-Werman block decomposition (blocks of w rows
//        aligned to the halo's first row; y[i] = max(suffix max at i,
//        prefix max at i+w-1)) or the shift-and-max loop; both exact.
// R, CB, Q and the rows a stage holds come from the wrapper
// (sliding_pool.py's pool_layout), whose plain version sums in the same
// order: sum and avg agree with it bit for bit, max exactly.
// The input may be read through `lead` zero rows placed before it and zero
// rows after it (L = lead + Lsrc + trailing): the sum-pool gradient pools
// dy padded by w-1 rows on both sides without building the padded copy.
// Gradient of max (max_pool_bwd, one launch): for each window i the tie
// count cnt = #{m < w : x[i+m] == y[i]} and the split dys = dy / max(cnt,
// 1) in dy's type (rounded before the scatter, as the TPU kernel's wrapper
// does), then dx[j] = sum of dys[i] over the windows i that hold j with
// x[j] == y[i], summed in float32, one cast to x's type: each window's
// gradient is shared evenly by its tied maxima. The contract is that y is
// x's sliding max, as sliding_pool(x, op="max") gives it: the kernel takes
// the maximum from the block decomposition below and does not read y.
//
// What bounds it on this card: pooling is one pass over the input with a
// few adds or compares per element, far below the card's arithmetic rate,
// so bytes bound it: at the paper's shape (1, 16384, 32) f32 that is 4.2 MB
// (1.3 us at 3.35 TB/s), less than a launch and a round trip to device
// memory take, so there the length of the serial chains and the number of
// blocks in flight set the time; at (8, 16384, 1024) 1 GB (0.32 ms), where
// the bytes do.
//
// What the design does about it: a block stages its halo once into shared
// memory with coalesced copies (cp.async, 16 bytes where the alignment
// allows; the `lead` zero rows and the rows past the input are written as
// zeros, not read), and its 256 threads share it: the lanes run along the
// CB channels and the block's 256/CB thread groups split the rows (at C =
// 1, CB = 1: the lanes run along the rows). Each halo row is read from
// device memory once a block; (w-1)/R of them are read by the next block
// too. The sum's runs are summed by one thread each, in parallel, the
// carry folds a few totals (Q is about the root of the halo), and the
// average's divides are one an output, off any chain. The max scan's block
// prefix and suffix maxima are taken in shared memory, one w-row block a
// thread, and y is written once; the shift form's w compares an output
// read shared memory, four neighbouring outputs a thread sharing their
// loads. R is the largest power of two up to 256 that still
// gives two blocks an SM (build.sm_count), halved down to 32 while the
// halo does not fit in the wrapper's budget; where it still does not (a
// wide window), the block streams its halo through a stage of P rows: the
// sum carries its prefix from piece to piece and keeps S[i-1] for the
// outputs of later pieces, the shift form keeps its running maxima, and
// the scan (R <= w there) takes the suffix maxima of rows [0, R) with the
// maximum of rows [R, w) gathered piece by piece, and the next block's
// prefix maxima over rows [w, w+R-1).
//
// The max gradient is O(n) a channel, not O(n*w): the TPU kernel bodies
// count each window's ties over its w rows, then gather w windows a row.
// Here the rows are cut into blocks of w aligned at row 0 (the forward's
// decomposition); window i is block i/w when i % w == 0, else the suffix
// of block i/w and the prefix of the next. A group of K lanes (K from the
// shape, a power of two up to 32: one where B*C*blocks alone fill the card,
// more where there are few blocks) walks TB consecutive blocks of one
// channel (TB = 1 when K > 1), lane k its share of sb = ceil(w/K) rows of
// each block, keeping two float4 slots a row, the block's (S, count, pc,
// x) and the next block's (P, b, pc, x), in shared memory (in global
// scratch when even 32 threads' slots do not fit). For each block m of
// windows (from the block before its own, whose windows reach into its
// first block):
//   A. backward over block m: the suffix max S(i) and the number of rows
//      attaining it, cS(i), each lane over its share with the (max, count)
//      of the shares to its right folded in;
//   B. forward over the windows i of block m, the prefix max P and its
//      count cP over block m+1 carried up to the window's last row e (from
//      the (max, count) of the shares to the left): y = max(S(i), P), cnt
//      = [S == y] cS + [P == y] cP, the split d; the suffix share a = [S ==
//      y] d. S does not increase along the block, so the windows whose
//      suffix part credits row i are the run of equal S ending at i, and
//      only if x(i) == S(i): a running sum of a that restarts when S
//      changes (plus, for a lane's first run, the sum carried in from the
//      shares to its left) gives row i its suffix credit, which with the
//      prefix credit pc from the block before is dx(i). The prefix share
//      b = [P == y] d is parked in block m+1's slot at e;
//   C. backward over block m+1: P does not decrease along a block, so the
//      windows whose prefix part credits row e are the run of equal P
//      starting at e, when x(e) == P(e): a backward running sum of b (plus
//      the sum carried in from the right) gives pc(e), kept for block
//      m+1's pass B.
// The lanes pass these carries by shuffles within the group. Each window
// gives its split to each tied position once, through the part that holds
// it, so the sums are the kernel bodies' but for the float32 order. Each x
// and dy row is read from device memory once (plus one halo block a
// group), each dx row written once; the rows are staged sixteen loads at a
// time.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <limits.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

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

// ---------------------------------------------------------------------------
// forward: a block stages its halo and its threads share it
// ---------------------------------------------------------------------------

// Shared memory is cut into arrays of whole 16-byte lines, so that each
// starts where a 16-byte copy may land.
__host__ __device__ inline long long line16(long long bytes) {
  return (bytes + 15) / 16 * 16;
}

// The forward's geometry: the input (B batch rows of L rows: `lead` zero
// rows, the Lsrc rows of x, zeros; C channels), the window, Lout outputs,
// the layout (R outputs and CB channels a block, runs of Q rows, stages of
// P rows), the blocks along the rows and the channels, and avg.
struct PoolGeom {
  int B, L, lead, Lsrc, C, w, Lout;
  int R, CB, Q, P;
  int n_rb, n_cb, avg;
};

// Shared memory of one forward block (sliding_pool.py's pool_smem_bytes):
// the stage of min(P, H) rows (H = R + w - 1; P < H: the halo streams),
// and for the sum its float32 prefix, the runs' totals and, streamed,
// S[i-1] of the block's outputs; for the scan the suffix maxima or,
// streamed, the two R-row blocks and the groups' maxima; for the shift
// form, streamed, its running maxima.
inline long long pool_smem(int op, int elem, int R, int CB, int P, int w) {
  const long long H = (long long)R + w - 1, PS = P < H ? P : H;
  const bool streamed = P < H;
  const long long G = THREADS / CB, rows = (long long)R * CB;
  if (op == OP_SUM || op == OP_AVG)
    return (elem == 4 ? 0 : line16(PS * CB * elem)) + line16(PS * CB * 4) +
           line16(G * CB * 4) + (streamed ? line16(rows * 4) : 0);
  if (op == OP_MAX_SCAN)
    return streamed ? 2 * line16(rows * elem) + line16(PS * CB * elem) +
                          line16(G * CB * 4)
                    : line16(H * CB * elem) + line16(rows * elem);
  return line16(PS * CB * elem) + (streamed ? line16(rows * 4) : 0);
}

// This block's batch row, first output row and first channel (channel
// blocks fastest, so neighbouring blocks share rows in L2), its outputs,
// and this thread's lane (channel) and group (rows).
struct BlockPos {
  int b, r0, c0, nout, cl, g, G;
};

__device__ __forceinline__ BlockPos block_pos(const PoolGeom& p) {
  long long id = blockIdx.x;
  BlockPos q;
  q.c0 = (int)(id % p.n_cb) * p.CB;
  id /= p.n_cb;
  q.r0 = (int)(id % p.n_rb) * p.R;
  q.b = (int)(id / p.n_rb);
  q.nout = min(p.R, p.Lout - q.r0);
  q.cl = threadIdx.x % p.CB;
  q.g = threadIdx.x / p.CB;
  q.G = THREADS / p.CB;
  return q;
}

// V bytes from global to shared memory, or zeros where !valid: cp.async
// for 16, 8 and 4 (src-size 0 reads nothing), a plain load for 2.
template <int V>
__device__ __forceinline__ void copy_in(void* dst, const void* src,
                                        bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? V : 0;
  if constexpr (V == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(n));
  else if constexpr (V == 8 || V == 4)
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d),
                 "l"(src), "n"(V), "r"(n));
  else
    *static_cast<unsigned short*>(dst) =
        valid ? *static_cast<const unsigned short*>(src)
              : static_cast<unsigned short>(0);
}

__device__ __forceinline__ void copies_landed() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
}

// Halo rows [h0, h0 + n) of the block (input rows r0 + h0 + j) into buf,
// [n][CB] of T, in copies of V bytes, neighbouring threads on neighbouring
// addresses; the rows before `lead` and past the Lsrc rows of x, and the
// channels past C, as zeros. The caller waits with copies_landed().
template <typename T, int V>
__device__ __forceinline__ void stage_rows(T* buf, const T* __restrict__ x,
                                           const PoolGeom& p,
                                           const BlockPos& q, int h0, int n) {
  constexpr int VE = V / (int)sizeof(T);
  const int per_row = p.CB / VE;
  const T* xb = x + (long long)q.b * p.Lsrc * p.C + q.c0;
  for (int u = threadIdx.x; u < n * per_row; u += THREADS) {
    const int j = u / per_row, cc = (u - j * per_row) * VE;
    const int s = q.r0 + h0 + j - p.lead;
    const bool ok = s >= 0 && s < p.Lsrc && q.c0 + cc < p.C;
    copy_in<V>(buf + j * p.CB + cc, ok ? xb + (long long)s * p.C + cc : x,
               ok);
  }
}

// sum and avg. Per stage of np rows: A, each group's run of Q rows summed
// in sequence; B, the carry into each run (the totals before it added in
// run order to the carry from earlier stages); C, the outputs whose last
// row lies in the stage.
template <typename T, int V>
__global__ void __launch_bounds__(THREADS)
pool_sum_kernel(const T* __restrict__ x, T* __restrict__ y, PoolGeom p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const BlockPos q = block_pos(p);
  const int H = p.R + p.w - 1, PS = min(p.P, H), CB = p.CB, cl = q.cl;
  const bool streamed = p.P < H;
  unsigned char* at = smem;
  T* st = reinterpret_cast<T*>(at);  // the stage; float32: S itself
  if (sizeof(T) != 4) at += line16((long long)PS * CB * sizeof(T));
  float* S = reinterpret_cast<float*>(at);
  at += line16((long long)PS * CB * 4);
  float* tot = reinterpret_cast<float*>(at);
  at += line16((long long)q.G * CB * 4);
  float* lo = reinterpret_cast<float*>(at);  // lo[i] = S[i-1], streamed
  const int c = q.c0 + cl;
  T* yb = y + ((long long)q.b * p.Lout + q.r0) * p.C + c;
  float carry = 0.f;
  for (int p0 = 0; p0 < H; p0 += p.P) {
    const int np = min(p.P, H - p0), nrun = (np + p.Q - 1) / p.Q;
    stage_rows<T, V>(st, x, p, q, p0, np);
    copies_landed();
    const int a = min(q.g * p.Q, np), e = min(a + p.Q, np);
    float acc = 0.f;
#pragma unroll 4
    for (int j = a; j < e; ++j) {
      acc += to_f32(st[j * CB + cl]);
      S[j * CB + cl] = acc;
    }
    tot[q.g * CB + cl] = acc;
    __syncthreads();
    float cq = carry;
    for (int r = 0; r < q.g && r < nrun; ++r) cq += tot[r * CB + cl];
    for (int j = a; j < e; ++j) S[j * CB + cl] = cq + S[j * CB + cl];
    for (int r = 0; r < nrun; ++r) carry += tot[r * CB + cl];
    __syncthreads();
    if (streamed)  // S[h], h < R - 1: the lower end of output h + 1
      for (int h = p0 + q.g; h < min(p0 + np, p.R - 1); h += q.G)
        lo[(h + 1) * CB + cl] = S[(h - p0) * CB + cl];
    if (c < p.C)
      for (int i = max(0, p0 - (p.w - 1)) + q.g;
           i < min(q.nout, p0 + np - (p.w - 1)); i += q.G) {
        const int l = i - 1 - p0;  // S[i-1]'s row in this stage
        const float s_lo = i == 0 ? 0.f : l >= 0 ? S[l * CB + cl]
                                                  : lo[i * CB + cl];
        float v = to_f32(from_f32<T>(S[(i + p.w - 1 - p0) * CB + cl] - s_lo));
        if (p.avg) v = __fdiv_rn(v, (float)p.w);
        yb[(long long)i * p.C] = from_f32<T>(v);
      }
    __syncthreads();  // the next stage overwrites this one
  }
}

// The shift form: output i is the maximum of rows [i, i + w). Whole halo:
// a thread takes four neighbouring outputs, whose windows share their
// loads (w + 3 a quad, not 4w: the stage's reads bound this form).
// Streamed: one output at a time, its running maximum kept between stages.
template <typename T, int V>
__global__ void __launch_bounds__(THREADS)
pool_max_shift_kernel(const T* __restrict__ x, T* __restrict__ y,
                      PoolGeom p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const BlockPos q = block_pos(p);
  const int H = p.R + p.w - 1, PS = min(p.P, H), CB = p.CB, cl = q.cl;
  T* st = reinterpret_cast<T*>(smem);
  float* run = reinterpret_cast<float*>(
      smem + line16((long long)PS * CB * sizeof(T)));  // streamed only
  const int c = q.c0 + cl;
  T* yb = y + ((long long)q.b * p.Lout + q.r0) * p.C + c;
  if (p.P >= H) {
    stage_rows<T, V>(st, x, p, q, 0, H);
    copies_landed();
    if (c >= p.C) return;
    auto at = [&](int h) { return to_f32(st[min(h, H - 1) * CB + cl]); };
    for (int i = 4 * q.g; i < q.nout; i += 4 * q.G) {
      float a0 = at(i), a1 = at(i + 1), a2 = at(i + 2);
      float m0 = -INFINITY, m1 = -INFINITY, m2 = -INFINITY, m3 = -INFINITY;
#pragma unroll 4
      for (int k = 0; k < p.w; ++k) {  // m_j takes row i + j + k
        const float a3 = at(i + k + 3);
        m0 = fmaxf(m0, a0);
        m1 = fmaxf(m1, a1);
        m2 = fmaxf(m2, a2);
        m3 = fmaxf(m3, a3);
        a0 = a1;
        a1 = a2;
        a2 = a3;
      }
      T* yi = yb + (long long)i * p.C;
      yi[0] = from_f32<T>(m0);
      if (i + 1 < q.nout) yi[p.C] = from_f32<T>(m1);
      if (i + 2 < q.nout) yi[2LL * p.C] = from_f32<T>(m2);
      if (i + 3 < q.nout) yi[3LL * p.C] = from_f32<T>(m3);
    }
    return;
  }
  for (int p0 = 0; p0 < H; p0 += p.P) {
    const int np = min(p.P, H - p0);
    stage_rows<T, V>(st, x, p, q, p0, np);
    copies_landed();
    if (c < p.C)
      for (int i = max(0, p0 - (p.w - 1)) + q.g; i < min(q.nout, p0 + np);
           i += q.G) {
        const int h0 = max(i, p0), h1 = min(i + p.w, p0 + np);
        float m = h0 == i ? -INFINITY : run[i * CB + cl];
#pragma unroll 4
        for (int h = h0; h < h1; ++h)
          m = fmaxf(m, to_f32(st[(h - p0) * CB + cl]));
        if (h1 == i + p.w)
          yb[(long long)i * p.C] = from_f32<T>(m);
        else
          run[i * CB + cl] = m;
      }
    __syncthreads();
  }
}

// The scan form. Whole halo: one thread group a w-row block, its suffix
// maxima for the rows of the block's outputs (into suf) and its prefix
// maxima from row w - 1 on (in place), then y[i] = max(suf[i], st[i+w-1]).
// Streamed (R <= w): block 0's suffix maxima over rows [0, R), with the
// maximum of its rows [R, w) gathered stage by stage, and block 1's prefix
// maxima over rows [w, w + R - 1).
template <typename T, int V>
__global__ void __launch_bounds__(THREADS)
pool_max_scan_kernel(const T* __restrict__ x, T* __restrict__ y,
                     PoolGeom p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const BlockPos q = block_pos(p);
  const int H = p.R + p.w - 1, CB = p.CB, cl = q.cl, w = p.w;
  const int c = q.c0 + cl;
  T* yb = y + ((long long)q.b * p.Lout + q.r0) * p.C + c;
  if (p.P >= H) {
    T* st = reinterpret_cast<T*>(smem);
    T* suf =
        reinterpret_cast<T*>(smem + line16((long long)H * CB * sizeof(T)));
    stage_rows<T, V>(st, x, p, q, 0, H);
    copies_landed();
    const int last = q.nout + w - 1;  // rows past it feed no output
    for (int k = q.g; k * w < last; k += q.G) {
      const int bs = k * w, be = min(bs + w, last);
      if (bs < q.nout) {
        float m = -INFINITY;
        for (int j = be - 1; j >= bs; --j) {
          m = fmaxf(m, to_f32(st[j * CB + cl]));
          if (j < q.nout) suf[j * CB + cl] = from_f32<T>(m);
        }
      }
      if (be > w - 1) {
        float m = -INFINITY;
        for (int j = bs; j < be; ++j) {
          m = fmaxf(m, to_f32(st[j * CB + cl]));
          if (j >= w - 1) st[j * CB + cl] = from_f32<T>(m);
        }
      }
    }
    __syncthreads();
    if (c < p.C)
      for (int i = q.g; i < q.nout; i += q.G)
        yb[(long long)i * p.C] = from_f32<T>(fmaxf(
            to_f32(suf[i * CB + cl]), to_f32(st[(i + w - 1) * CB + cl])));
    return;
  }
  const int R = p.R;
  const long long rb = line16((long long)R * CB * sizeof(T));
  T* A = reinterpret_cast<T*>(smem);       // rows [0, R)
  T* Bn = reinterpret_cast<T*>(smem + rb);  // rows [w, w + R - 1)
  T* st = reinterpret_cast<T*>(smem + 2 * rb);
  float* red = reinterpret_cast<float*>(
      smem + 2 * rb + line16((long long)p.P * CB * sizeof(T)));
  stage_rows<T, V>(A, x, p, q, 0, R);
  float m = -INFINITY;
  for (int h0 = R; h0 < w; h0 += p.P) {
    const int n = min(p.P, w - h0);
    stage_rows<T, V>(st, x, p, q, h0, n);
    copies_landed();
    for (int j = q.g; j < n; j += q.G) m = fmaxf(m, to_f32(st[j * CB + cl]));
    __syncthreads();
  }
  stage_rows<T, V>(Bn, x, p, q, w, R - 1);
  red[q.g * CB + cl] = m;
  copies_landed();
  if (q.g == 0) {
    float s = -INFINITY;
    for (int r = 0; r < q.G; ++r) s = fmaxf(s, red[r * CB + cl]);
    for (int j = R - 1; j >= 0; --j) {
      s = fmaxf(s, to_f32(A[j * CB + cl]));
      A[j * CB + cl] = from_f32<T>(s);
    }
  } else if (q.g == 1) {
    float s = -INFINITY;
    for (int j = 0; j < R - 1; ++j) {
      s = fmaxf(s, to_f32(Bn[j * CB + cl]));
      Bn[j * CB + cl] = from_f32<T>(s);
    }
  }
  __syncthreads();
  if (c < p.C)
    for (int i = q.g; i < q.nout; i += q.G) {
      float v = to_f32(A[i * CB + cl]);
      if (i > 0) v = fmaxf(v, to_f32(Bn[(i - 1) * CB + cl]));
      yb[(long long)i * p.C] = from_f32<T>(v);
    }
}

// n rows of a channel (src, sstride elements apart) into dst (st floats
// apart), widened: sixteen loads issued before any is stored, four at a
// time for the last few.
template <typename T>
__device__ __forceinline__ void fetch_rows(float* dst, long long st,
                                           const T* __restrict__ src,
                                           long long sstride, int n) {
  int q0 = 0;
  for (; q0 + 16 <= n; q0 += 16) {
    float v[16];
#pragma unroll
    for (int j = 0; j < 16; ++j)
      v[j] = to_f32(src[(long long)(q0 + j) * sstride]);
#pragma unroll
    for (int j = 0; j < 16; ++j) dst[(long long)(q0 + j) * st] = v[j];
  }
  for (; q0 < n; q0 += 4) {
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      v[j] = q0 + j < n ? to_f32(src[(long long)(q0 + j) * sstride]) : 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (q0 + j < n) dst[(long long)(q0 + j) * st] = v[j];
  }
}

// One thread's blocks [m0, m1) of one channel. Per row of a block it keeps
// a float4 slot (S or P, its count or b, pc, x) and two staged floats: xn,
// the next block's x, and dv, the block's dy; rows st apart. See the
// header for the three passes.
template <typename T>
__device__ __forceinline__ void max_bwd_thread(
    const T* __restrict__ xb, const T* __restrict__ dyb, T* __restrict__ dxb,
    float4* sl, float* xn, float* dv, long long st, int L, int C, int w,
    int Lout, int m0, int m1) {
  if (m0 == 0)  // no window of an earlier block credits block 0
    for (int r = 0; r < min(w, L); ++r) sl[r * st].z = 0.f;
  bool first = true;
  for (int mb = max(m0 - 1, 0); mb < m1; ++mb) {
    const int base = mb * w, nb1 = base + w, nrow = min(w, L - base);
    if (first)  // this block's x, into the slots' x
      fetch_rows(&sl->w, 4 * st, xb + (long long)base * C, C, nrow);
    fetch_rows(xn, st, xb + (long long)nb1 * C, C,
               nb1 < L ? min(w, L - nb1) : 0);
    fetch_rows(dv, st, dyb + (long long)base * C, C,
               max(0, min(nrow, Lout - base)));
    first = false;
    // A: backward over block mb, its suffix max and the rows attaining it
    float S = -INFINITY, cS = 0.f;
#pragma unroll 4
    for (int r = nrow - 1; r >= 0; --r) {
      float4* p = sl + r * st;
      const float v = p->w;
      if (v > S) {
        S = v;
        cS = 1.f;
      } else if (v == S) {
        cS += 1.f;
      }
      p->x = S;
      p->y = cS;
    }
    // B: forward over the windows i of block mb, the prefix max of block
    // mb + 1 carried along up to the window's last row e
    const bool own = mb >= m0;
    float P = -INFINITY, cP = 0.f, R = 0.f, Sp = 0.f;
#pragma unroll 4
    for (int r = 0; r < nrow; ++r) {
      const int i = base + r, e = nb1 + r - 1;
      const float4 s = sl[r * st];  // S, cS, pc, x of row i
      float xe = 0.f;
      if (r > 0 && e < L) {
        xe = xn[(r - 1) * st];
        if (xe > P) {
          P = xe;
          cP = 1.f;
        } else if (xe == P) {
          cP += 1.f;
        }
      }
      float a = 0.f, b = 0.f;
      if (i < Lout) {
        const float y = r == 0 ? s.x : fmaxf(s.x, P);
        const float cnt =
            (s.x == y ? s.y : 0.f) + (r > 0 && P == y ? cP : 0.f);
        const float d =
            to_f32(from_f32<T>(__fdiv_rn(dv[r * st], fmaxf(cnt, 1.f))));
        a = s.x == y ? d : 0.f;
        b = r > 0 && P == y ? d : 0.f;
      }
      R = (r > 0 && s.x == Sp) ? __fadd_rn(R, a) : a;
      Sp = s.x;
      if (own)
        dxb[(long long)i * C] =
            from_f32<T>(__fadd_rn(s.z, s.w == s.x ? R : 0.f));
      if (r > 0) sl[(r - 1) * st] = make_float4(P, b, 0.f, xe);
    }
    // C: backward over block mb + 1, the prefix credits of its rows
    if (mb + 1 < m1 && nb1 < L) {
      float Q = 0.f, Pn = 0.f;
      bool fresh = true;
      for (int q = min(w - 1, L - 1 - nb1); q >= 0; --q) {
        float4* p = sl + q * st;
        if (q == w - 1) {  // no window's prefix part ends at a block's end
          p->w = xn[q * st];
          p->z = 0.f;
          continue;
        }
        const float4 v = *p;  // P, b, -, x
        Q = (!fresh && v.x == Pn) ? __fadd_rn(Q, v.y) : v.y;
        fresh = false;
        Pn = v.x;
        p->z = v.w == v.x ? Q : 0.f;
      }
    }
  }
}

// (max, count) of two disjoint ranges into the first.
__device__ __forceinline__ void fold_max(float& m, float& c, float om,
                                         float oc) {
  if (om > m) {
    m = om;
    c = oc;
  } else if (om == m) {
    c += oc;
  }
}

// One group of K lanes (k = 0..K-1, K a power of two) walking blocks
// [m0, m1) of one channel; lane k owns rows [k*sb, (k+1)*sb) of each
// block, sb = ceil(w / K). Per row it keeps two float4 slots, cur for the
// block's rows (S, cS, pc, x) and nxt for the next block's (P, b, pc, x),
// which swap after each block, and dv (the row's dy, then its partial dx);
// rows st apart. The lanes pass the (max, count) of their rows and the
// running sums of runs that cross from one lane's rows into the next by
// shuffles in the group (gmask). See the header for the three passes.
template <typename T>
__device__ __forceinline__ void max_bwd_group(
    const T* __restrict__ xb, const T* __restrict__ dyb, T* __restrict__ dxb,
    float4* cur, float4* nxt, float* dv, long long st, int L, int C, int w,
    int Lout, int m0, int m1, int K, int k, unsigned gmask) {
  const int sb = (w + K - 1) / K;
  const int a0 = k * sb;
  bool first = true;
  for (int mb = max(m0 - 1, 0); mb < m1; ++mb) {
    const int base = mb * w, nb1 = base + w, nrow = min(w, L - base);
    const int nnext = nb1 < L ? min(w, L - nb1) : 0;
    const int na = max(0, min(a0 + sb, nrow) - a0);   // the lane's rows
    const int nn = max(0, min(a0 + sb, nnext) - a0);  // and the next block's
    const bool own = mb >= m0;
    if (first) {  // this block's x; no window before block 0
      fetch_rows(&cur->w, 4 * st, xb + (long long)(base + a0) * C, C, na);
      if (m0 == 0)
        for (int j = 0; j < na; ++j) cur[j * st].z = 0.f;
    }
    fetch_rows(&nxt->w, 4 * st, xb + (long long)(nb1 + a0) * C, C, nn);
    fetch_rows(dv, st, dyb + (long long)(base + a0) * C, C,
               max(0, min(a0 + na, Lout - base) - a0));
    first = false;

    // A: backward over the lane's rows, the suffix max and its count, then
    // the (max, count) of the lanes to the right folded in
    float S = -INFINITY, cS = 0.f;
#pragma unroll 4
    for (int j = na - 1; j >= 0; --j) {
      float4* p = cur + j * st;
      fold_max(S, cS, p->w, 1.f);
      p->x = S;
      p->y = cS;
    }
    float cm = -INFINITY, cc = 0.f;
    for (int j = K - 1; j >= 1; --j) {
      const float om = __shfl_sync(gmask, S, j, K);
      const float oc = __shfl_sync(gmask, cS, j, K);
      if (j > k) fold_max(cm, cc, om, oc);
    }
    if (cc > 0.f)
      for (int j = 0; j < na; ++j) {
        float4* p = cur + j * st;
        const float s2 = fmaxf(p->x, cm);
        p->y = (p->x == s2 ? p->y : 0.f) + (cm == s2 ? cc : 0.f);
        p->x = s2;
      }

    // B: the next block's prefix (max, count) of the lanes to the left,
    // then forward over the lane's windows, the prefix carried up to each
    // window's last row
    float pm = -INFINITY, pcn = 0.f;
    for (int j = 0; j < nn; ++j) fold_max(pm, pcn, nxt[j * st].w, 1.f);
    float P = -INFINITY, cP = 0.f;
    for (int j = 0; j < K - 1; ++j) {
      const float om = __shfl_sync(gmask, pm, j, K);
      const float oc = __shfl_sync(gmask, pcn, j, K);
      if (j < k) fold_max(P, cP, om, oc);
    }
    float R = 0.f, Sp = 0.f, sendP = 0.f, sendB = 0.f;
    int fr = na;  // rows [0, fr) are the lane's first run of equal S
    bool whole = true;
#pragma unroll 4
    for (int j = 0; j < na; ++j) {
      const int r = a0 + j, i = base + r;
      const float4 s = cur[j * st];  // S, cS, pc, x of row i
      if (j > 0 && r - 1 < nnext) fold_max(P, cP, nxt[(j - 1) * st].w, 1.f);
      float a = 0.f, b = 0.f;
      if (i < Lout) {
        const float y = r == 0 ? s.x : fmaxf(s.x, P);
        const float cnt =
            (s.x == y ? s.y : 0.f) + (r > 0 && P == y ? cP : 0.f);
        const float d =
            to_f32(from_f32<T>(__fdiv_rn(dv[j * st], fmaxf(cnt, 1.f))));
        a = s.x == y ? d : 0.f;
        b = r > 0 && P == y ? d : 0.f;
      }
      if (j > 0 && s.x == Sp) {
        R = __fadd_rn(R, a);
      } else {
        if (j > 0 && whole) {
          fr = j;
          whole = false;
        }
        R = a;
      }
      Sp = s.x;
      dv[j * st] = __fadd_rn(s.z, s.w == s.x ? R : 0.f);
      if (r > 0) {
        if (j == 0) {  // window r's last row is lane k-1's
          sendP = P;
          sendB = b;
        } else {
          nxt[(j - 1) * st].x = P;
          nxt[(j - 1) * st].y = b;
        }
      }
    }
    // the running sum that enters the lane's first run from the left
    const float Slast = na > 0 ? cur[(na - 1) * st].x : 0.f;
    const float Sprev = __shfl_up_sync(gmask, Slast, 1, K);
    const int nprev = __shfl_up_sync(gmask, na, 1, K);
    const bool conn = k > 0 && na > 0 && nprev > 0 && cur[0].x == Sprev;
    float run = 0.f, cin = 0.f;
    for (int j = 1; j < K; ++j) {
      const float tp = __shfl_sync(gmask, R, j - 1, K);
      const int wp = __shfl_sync(gmask, (int)whole, j - 1, K);
      const int cj = __shfl_sync(gmask, (int)conn, j, K);
      run = cj ? __fadd_rn(tp, wp ? run : 0.f) : 0.f;
      if (j == k) cin = run;
    }
    if (own)
      for (int j = 0; j < na; ++j) {
        const float4 s = cur[j * st];
        float v = dv[j * st];
        if (j < fr && cin != 0.f && s.w == s.x) v = __fadd_rn(v, cin);
        dxb[(long long)(base + a0 + j) * C] = from_f32<T>(v);
      }

    // C: backward over the next block's rows, the prefix shares summed
    // over runs of equal P, then the sum entering from the right
    if (mb + 1 < m1 && nb1 < L) {
      const int qtop = min(w - 1, L - 1 - nb1);
      const float rP = __shfl_down_sync(gmask, sendP, 1, K);
      const float rB = __shfl_down_sync(gmask, sendB, 1, K);
      const int rn = __shfl_down_sync(gmask, na, 1, K);
      if (k < K - 1 && rn > 0 && sb - 1 < nn) {
        nxt[(sb - 1) * st].x = rP;
        nxt[(sb - 1) * st].y = rB;
      }
      const int hi = max(0, min(nn, qtop + 1 - a0));
      float Q = 0.f, Pn = 0.f;
      bool have = false, whole2 = true;
      int lr = 0;  // rows [lr, hi) are the lane's last run of equal P
      for (int j = hi - 1; j >= 0; --j) {
        float4* p = nxt + j * st;
        if (a0 + j == w - 1) {  // no window's prefix part ends at a block's end
          p->z = 0.f;
          have = false;
          continue;
        }
        const float4 v = *p;  // P, b, -, x
        if (have && v.x == Pn) {
          Q = __fadd_rn(Q, v.y);
        } else {
          if (have && whole2) {
            lr = j + 1;
            whole2 = false;
          }
          Q = v.y;
        }
        have = true;
        Pn = v.x;
        p->z = v.w == v.x ? Q : 0.f;
      }
      const float Pfirst = hi > 0 ? nxt[0].x : 0.f;
      const float Pnext = __shfl_down_sync(gmask, Pfirst, 1, K);
      const int hnext = __shfl_down_sync(gmask, hi, 1, K);
      const bool conn2 = k < K - 1 && hi > 0 && hnext > 0 &&
                         a0 + hi - 1 != w - 1 && a0 + sb != w - 1 &&
                         nxt[(hi - 1) * st].x == Pnext;
      float run2 = 0.f, cin2 = 0.f;
      for (int j = K - 2; j >= 0; --j) {
        const float hn = __shfl_sync(gmask, Q, j + 1, K);
        const int wn = __shfl_sync(gmask, (int)whole2, j + 1, K);
        const int cj = __shfl_sync(gmask, (int)conn2, j, K);
        run2 = cj ? __fadd_rn(hn, wn ? run2 : 0.f) : 0.f;
        if (j == k) cin2 = run2;
      }
      if (cin2 != 0.f)
        for (int j = lr; j < hi; ++j) {
          float4* p = nxt + j * st;
          if (a0 + j != w - 1 && p->w == p->x) p->z = __fadd_rn(p->z, cin2);
        }
    }
    float4* t = cur;
    cur = nxt;
    nxt = t;
  }
}

// Bytes a lane keeps per row of its share of a block: one float4 slot, xn
// and dv alone (K = 1); two float4 slots and dv in a group (K > 1).
__host__ __device__ inline int slot_bytes(int K) {
  return K == 1 ? (int)sizeof(float4) + 2 * (int)sizeof(float)
                : 2 * (int)sizeof(float4) + (int)sizeof(float);
}

// The max-pool gradient, one launch: groups of K lanes, each group one
// (b, tile of TB blocks of w rows, c), lanes fastest; one lane a group
// walks its blocks alone (max_bwd_thread), more share each block
// (max_bwd_group). Slots in shared memory (threadIdx.x fastest), or, for a
// share of a block too wide for it, in the caller's global scratch (thread
// index fastest).
template <typename T, bool GLOBAL_SLOTS>
__global__ void __launch_bounds__(THREADS)
max_pool_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                    T* __restrict__ dx, float* __restrict__ gslots, int L,
                    int C, int w, int Lout, int TB, int n_tiles, int B,
                    int K) {
  extern __shared__ float4 sslots[];
  const long long gid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  Item it;
  if (!item_of(gid / K, n_tiles, C, B, &it)) return;  // whole groups
  const int nb = (L + w - 1) / w;
  const int m0 = it.t * TB, m1 = min(nb, m0 + TB);
  const int sb = (w + K - 1) / K;
  const long long xo = (long long)it.b * L * C + it.c;
  const T* dyb = dy + (long long)it.b * Lout * C + it.c;
  // rows st apart: the float4 slots (sb rows, twice in a group), then the
  // floats (xn and dv alone, dv in a group)
  const long long st = GLOBAL_SLOTS ? (long long)B * n_tiles * C * K
                                    : (long long)blockDim.x;
  float4* s4 = GLOBAL_SLOTS ? reinterpret_cast<float4*>(gslots) : sslots;
  const long long me = GLOBAL_SLOTS ? gid : threadIdx.x;
  if (K == 1) {
    float* f = reinterpret_cast<float*>(s4 + (long long)sb * st);
    max_bwd_thread<T>(x + xo, dyb, dx + xo, s4 + me, f + me,
                      f + (long long)sb * st + me, st, L, C, w, Lout, m0,
                      m1);
  } else {
    const int k = (int)(gid % K);
    const int lane = threadIdx.x & 31;
    const unsigned gmask =
        K == 32 ? 0xffffffffu : ((1u << K) - 1) << (lane & ~(K - 1));
    float* f = reinterpret_cast<float*>(s4 + 2LL * sb * st);
    max_bwd_group<T>(x + xo, dyb, dx + xo, s4 + me,
                     s4 + (long long)sb * st + me, f + me, st, L, C, w, Lout,
                     m0, m1, K, k, gmask);
  }
}

// Shared memory the slots may take in one block.
constexpr int SLOT_SMEM = 200 * 1024;

// Threads a block for the gradient with sb rows a lane of K over `total`
// threads on a card of `sms` SMs: the most (up to 256, a multiple of 32)
// whose slots fit in SLOT_SMEM, fewer while that leaves under two blocks an
// SM; 0 when even 32 threads' slots do not fit (the slots then live in
// global scratch, 256 threads a block).
inline int bwd_block_threads(int sb, int K, long long total, int sms) {
  const long long fit = SLOT_SMEM / ((long long)sb * slot_bytes(K));
  if (fit < 32) return 0;
  int t = THREADS;
  while (t > 32 && (t > fit || (total + t - 1) / t < 2LL * sms)) t /= 2;
  return t;
}

inline bool grid_ok(int B, int n_tiles, int C, int threads = THREADS) {
  return (long long)B * n_tiles * C <= (long long)threads * 0x7fffffff;
}

// the most shared memory a block may have on this card
constexpr long long MAX_BLOCK_SMEM = 227 * 1024;

template <typename T, int V>
cudaError_t launch_pool(const void* x, void* y, const PoolGeom& p, int op,
                        int smem, cudaStream_t s) {
  auto kernel = op == OP_MAX_SCAN    ? pool_max_scan_kernel<T, V>
                : op == OP_MAX_SHIFT ? pool_max_shift_kernel<T, V>
                                     : pool_sum_kernel<T, V>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  const long long grid = (long long)p.B * p.n_rb * p.n_cb;
  kernel<<<(unsigned)grid, THREADS, smem, s>>>(static_cast<const T*>(x),
                                               static_cast<T*>(y), p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_width(const void* x, void* y, const PoolGeom& p, int op,
                         int smem, int copy, cudaStream_t s) {
  switch (copy) {
    case 16: return launch_pool<T, 16>(x, y, p, op, smem, s);
    case 8: return launch_pool<T, 8>(x, y, p, op, smem, s);
    case 4: return launch_pool<T, 4>(x, y, p, op, smem, s);
    default:
      if constexpr (sizeof(T) == 2)
        return launch_pool<T, 2>(x, y, p, op, smem, s);
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Returns a cudaError_t code: 0 when the launch was accepted. x holds Lsrc
// rows of C channels a batch; the pooled sequence is L = lead + Lsrc + the
// zero rows after it (sum and avg only: max takes lead 0 and L = Lsrc).
// y holds Lout = L - w + 1 rows. The layout (sliding_pool.py's
// pool_layout): `rows` outputs and `chans` channels (a power of two up to
// 32) a block, runs of `run` rows, stages of `piece` rows (at least the
// halo of rows + window - 1: one stage); `copy` the bytes a copy of x
// moves (16, 8, 4, or 2 for bfloat16), which x's pointer, C and chans
// allow. A layout the kernel cannot take is refused with
// cudaErrorInvalidValue.
extern "C" int sliding_pool(const void* x, void* y, int B, int L, int lead,
                            int Lsrc, int C, int window, int Lout, int rows,
                            int chans, int run, int piece, int copy, int op,
                            int is_bf16, void* stream) {
  const int elem = is_bf16 ? 2 : 4;
  const long long H = (long long)rows + window - 1;
  const bool streamed = piece < H;
  const int G = chans >= 1 && chans <= 32 ? THREADS / chans : 0;
  const bool sum = op == OP_SUM || op == OP_AVG;
  if (B < 1 || C < 1 || window < 1 || op < OP_SUM || op > OP_MAX_SHIFT ||
      Lout != L - window + 1 || Lout < 1 || lead < 0 || Lsrc < 1 ||
      lead + Lsrc > L || (op >= OP_MAX_SCAN && (lead != 0 || Lsrc != L)) ||
      rows < 1 || G == 0 || (chans & (chans - 1)) != 0 || run < 1 ||
      piece < 1 || H > INT_MAX ||
      (sum && (streamed ? piece % run != 0 || piece / run > G
                        : (H + run - 1) / run > G)) ||
      (op == OP_MAX_SCAN && streamed && rows > window) ||
      (copy != 16 && copy != 8 && copy != 4 && copy != 2) || copy < elem ||
      (chans * elem) % copy != 0 || ((long long)C * elem) % copy != 0 ||
      reinterpret_cast<uintptr_t>(x) % copy != 0)
    return (int)cudaErrorInvalidValue;
  const long long n_rb = (Lout + rows - 1) / rows;
  const long long n_cb = (C + chans - 1) / chans;
  const long long smem = pool_smem(op, elem, rows, chans, piece, window);
  if ((long long)B * n_rb * n_cb > 0x7fffffff || smem > MAX_BLOCK_SMEM)
    return (int)cudaErrorInvalidValue;
  const PoolGeom p{B,    L,     lead,  Lsrc,        C,           window,
                   Lout, rows,  chans, run,         piece,       (int)n_rb,
                   (int)n_cb, op == OP_AVG};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(is_bf16 ? launch_width<__nv_bfloat16>(x, y, p, op, (int)smem,
                                                     copy, s)
                       : launch_width<float>(x, y, p, op, (int)smem, copy, s));
}

// float32 scratch the gradient needs (0 when its slots fit in shared
// memory); tile is the number of w-row blocks a group walks, lanes (K) the
// threads a group, sms the card's streaming multiprocessors.
extern "C" long long max_pool_bwd_scratch(int B, int L, int C, int window,
                                          int tile, int lanes, int sms) {
  if (window < 1 || tile < 1 || L < 1 || lanes < 1 || sms < 1) return 0;
  const long long n_tiles = ((L + window - 1) / window + tile - 1) / tile;
  const long long total = (long long)B * n_tiles * C * lanes;
  const int sb = (window + lanes - 1) / lanes;
  if (bwd_block_threads(sb, lanes, total, sms) > 0) return 0;
  return total * sb * (slot_bytes(lanes) / (long long)sizeof(float));
}

// The max-pool gradient: dx (B, L, C) in x's type from x and dy (B, Lout,
// C) of x's type, y being x's sliding max (not read). tile: the w-row
// blocks a group walks; lanes: the threads of a group (a power of two up
// to 32, at most the window; tile 1 when above 1); sms: the card's
// streaming multiprocessors; scratch: max_pool_bwd_scratch floats (may be
// null when that is 0).
extern "C" int max_pool_bwd(const void* x, const void* dy, void* dx,
                            void* scratch, int B, int L, int C, int window,
                            int Lout, int tile, int lanes, int sms,
                            int is_bf16, void* stream) {
  const int nb = L >= 1 && window >= 1 ? (L + window - 1) / window : 0;
  if (B < 1 || C < 1 || window < 1 || tile < 1 || Lout != L - window + 1 ||
      Lout < 1 || lanes < 1 || lanes > 32 || (lanes & (lanes - 1)) != 0 ||
      sms < 1 ||
      (lanes > 1 && tile != 1) ||
      !grid_ok(B, (nb + tile - 1) / tile, C * lanes, 32))
    return (int)cudaErrorInvalidValue;
  const int n_tiles = (nb + tile - 1) / tile;
  const long long total = (long long)B * n_tiles * C * lanes;
  const int sb = (window + lanes - 1) / lanes;
  const int smem_threads = bwd_block_threads(sb, lanes, total, sms);
  const bool global = smem_threads == 0;
  if (global && scratch == nullptr) return (int)cudaErrorInvalidValue;
  const int threads = global ? THREADS : smem_threads;
  const size_t smem =
      global ? 0 : (size_t)threads * sb * slot_bytes(lanes);
  const int grid = (int)((total + threads - 1) / threads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* gs = static_cast<float*>(scratch);
#define MAX_BWD(T, G)                                                       \
  do {                                                                      \
    if (smem > 48 * 1024) {                                                 \
      const cudaError_t e = cudaFuncSetAttribute(                           \
          max_pool_bwd_kernel<T, G>,                                        \
          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);          \
      if (e != cudaSuccess) return (int)e;                                  \
    }                                                                       \
    max_pool_bwd_kernel<T, G><<<grid, threads, smem, s>>>(                  \
        static_cast<const T*>(x), static_cast<const T*>(dy),                \
        static_cast<T*>(dx), gs, L, C, window, Lout, tile, n_tiles, B,      \
        lanes);                                                             \
  } while (0)
  if (is_bf16) {
    if (global) MAX_BWD(__nv_bfloat16, true);
    else MAX_BWD(__nv_bfloat16, false);
  } else {
    if (global) MAX_BWD(float, true);
    else MAX_BWD(float, false);
  }
#undef MAX_BWD
  return (int)cudaGetLastError();
}

// The forward's dynamic shared memory and threads for op and layout (rows,
// chans, piece) at `window`, as sliding_pool makes it; launches nothing.
extern "C" int sliding_pool_query(int op, int is_bf16, int rows, int chans,
                                  int piece, int window, int* smem,
                                  int* threads) {
  if (op < OP_SUM || op > OP_MAX_SHIFT || rows < 1 || chans < 1 ||
      chans > 32 || piece < 1 || window < 1)
    return (int)cudaErrorInvalidValue;
  *smem = (int)pool_smem(op, is_bf16 ? 2 : 4, rows, chans, piece, window);
  *threads = THREADS;
  return 0;
}

// The gradient's dynamic shared memory and threads, as max_pool_bwd makes
// them for the same arguments (0 bytes: the slots in global scratch);
// launches nothing.
extern "C" int max_pool_bwd_query(int B, int L, int C, int window, int tile,
                                  int lanes, int sms, int* smem,
                                  int* threads) {
  if (B < 1 || C < 1 || L < 1 || window < 1 || tile < 1 || lanes < 1 ||
      sms < 1)
    return (int)cudaErrorInvalidValue;
  const int n_tiles = ((L + window - 1) / window + tile - 1) / tile;
  const long long total = (long long)B * n_tiles * C * lanes;
  const int sb = (window + lanes - 1) / lanes;
  const int t = bwd_block_threads(sb, lanes, total, sms);
  *threads = t == 0 ? THREADS : t;
  *smem = t == 0 ? 0 : t * sb * slot_bytes(lanes);
  return 0;
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
