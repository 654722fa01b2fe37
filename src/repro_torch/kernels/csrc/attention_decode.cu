// Single-query decode attention over a KV cache with a ragged valid prefix,
// for Hopper (sm_90a). Floating-point or int8 cache.
//
// Replaces: src/repro/kernels/attention_decode.py, decode_attention_pallas
// (both variants: _decode_kernel, _softmax_step, _online_update, _finish).
//
// What it computes: for every slot b, kv head h and grouped query g,
//   out[b, h, g] = softmax_s(q[b, h, g] . k[b, s, h] / sqrt(D)) . v[b, s, h]
// over the valid rows s < lengths[b] only, with q (B, KV, G, D), k and v
// (B, S, KV, D), lengths (B,) int32 and out (B, KV, G, D) float32. q and the
// cache may each be float32 or bfloat16; every product is exact in float32
// and every sum is float32 (no TF32). A slot with length 0 gives a zero
// row. G is 1..8 and D 1..256.
// int8 cache: k and v hold int8 codes with float32 scales k_scale and
// v_scale, one per (slot, position, head), laid out (B, S, KV). The K scale
// folds into the score after the dot, (q . k_code) * (k_scale * sm_scale),
// and the V scale into the probability before p . v, p * v_scale, as the
// Pallas kernel folds them (quantized=True), so no float copy of the cache
// exists; the denominator sums the unscaled probabilities. Rows past a
// slot's length are masked by the length, whatever their codes and scales
// (the cross cache is zero-padded past the encoder length).
//
// What bounds it on this card: one call reads each valid K and V row once
// and does 4*G*D operations per row, so it is bound by bytes: at llava's
// decode shape (B=4, S=3168, KV=8, G=7, D=128, bf16 cache) 51.6 MB, or 15.4
// us at 3.35 TB/s; at whisper's (B=4, S=288, KV=16, G=1, D=64) 4.2 MB, 1.3
// us, where latency and the number of blocks set the time. The int8 cache
// moves about half as many bytes.
//
// What the design does about it (split-S, "flash decoding", one launch):
//   * the wrapper picks the rows a split from the shape (attention_decode.py
//     decode_splits: as many blocks as the SMs hold at once, two of 256
//     threads each, 64 to 512 rows a split), so a (slot, head) is cut into
//     few long splits, one block each;
//   * a block walks its split's K rows, then its V rows, in tiles of TR
//     rows (TR from the row's bytes, 16 KB a tile), double-buffered in
//     shared memory by cp.async: tile t+1 is in flight while tile t
//     computes, the first V tile while the softmax runs. This is the Pallas
//     kernel's sequential kv grid dimension inside the block: the split's
//     scores stay in shared memory (at most 512 rows a split), so the
//     online softmax takes one step a split (m_prev = -inf: l is the sum
//     of p) and acc[G][D] needs no correction between tiles;
//   * scores without a shuffle reduction a row. Where q is bfloat16 and the
//     cache bfloat16 or int8 codes (exact in bfloat16), on the tensor cores:
//     mma.sync m16n8k16, the tile's 16-row slices against the queries padded
//     to 8; the products are exact in float32, only the order of the sums
//     changes. Otherwise (a float32 q or cache) on the CUDA cores: a thread
//     a row and a slice of D, q broadcast from shared memory. The slices'
//     partial dots are added in slice order;
//   * the softmax step runs a warp a query (queries w and w + WARPS, the
//     two reduced together) over the split, with _softmax_step's guards (a
//     score that is not finite gets probability 0); rows past the length
//     are never scored;
//   * p.v stays on the CUDA cores in float32 (p is not rounded): threads
//     across D (two columns each, coalesced V rows), rows in groups read
//     four at a time, each group's sums added in group order at the end;
//   * a (slot, head) with one split writes its row directly. Otherwise each
//     split writes (m, l, acc) to the workspace and takes a ticket from a
//     per-(slot, head) counter; the last block to finish merges the splits
//     in index order, acc = sum_i exp(m_i - M) acc_i over l likewise, the
//     acc rows copied into the tile buffers by cp.async, and resets the
//     counter to 0 for the next call. Which block merges does not change
//     the sums, so two calls on the same inputs are bitwise equal. The
//     counters are zero between launches: the caller hands in a zeroed
//     buffer once and the kernel leaves it zeroed.
// No row past lengths[b] is read. A split with no valid row does nothing.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAXG = 8;          // grouped queries per kv head
constexpr int MAXD = 256;        // head_dim
constexpr int MAXTR = 64;        // cache rows a tile
constexpr int TILE_BYTES = 16384;  // bytes of K (or of V) a tile, unpadded
constexpr int BLOCKS_PER_SM = 2;   // registers capped so two blocks fit

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(int8_t v) { return (float)v; }

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// 8 consecutive elements from shared memory, widened (p 8-element aligned)
__device__ __forceinline__ void load8(const float* p, float* o) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* o) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(h[j]);
    o[2 * j] = f.x;
    o[2 * j + 1] = f.y;
  }
}
__device__ __forceinline__ void load8(const int8_t* p, float* o) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const int8_t* c = reinterpret_cast<const int8_t*>(&u);
#pragma unroll
  for (int j = 0; j < 8; ++j) o[j] = (float)c[j];
}

// 2 consecutive elements (p 2-element aligned); the second is not read
// when !two
__device__ __forceinline__ float2 load2(const float* p, bool two) {
  return two ? *reinterpret_cast<const float2*>(p) : make_float2(p[0], 0.f);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p, bool two) {
  return two ? __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p))
             : make_float2(__bfloat162float(p[0]), 0.f);
}
__device__ __forceinline__ float2 load2(const int8_t* p, bool two) {
  return make_float2((float)p[0], two ? (float)p[1] : 0.f);
}

// D(16x8, f32) += A(16x16, bf16, row-major) * B(16x8, bf16, column-major)
__device__ __forceinline__ void mma_bf16(float* c, uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Two consecutive cache elements of a staged row as a bf16 pair (the
// low half the lower column): bf16 as stored, int8 codes exactly
__device__ __forceinline__ uint32_t pair_bf16(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
__device__ __forceinline__ uint32_t pair_bf16(const int8_t* p) {
  const __nv_bfloat162 h = __floats2bfloat162_rn((float)p[0], (float)p[1]);
  return *reinterpret_cast<const uint32_t*>(&h);
}
__device__ __forceinline__ uint32_t pair_bf16(const float*) {
  return 0u;  // never called: a float32 cache scores on the CUDA cores
}

// The score pass runs on the tensor cores where the products are exact in
// float32 whatever the order: q bfloat16 against a bfloat16 cache or int8
// codes (exact in bfloat16), D a multiple of 16.
template <typename TQ, typename TKV>
struct UsesMma {
  static constexpr bool value = std::is_same<TQ, __nv_bfloat16>::value &&
                                !std::is_same<TKV, float>::value;
};

// The launch's geometry, from D, the cache's element size, the rows a
// split and the number of splits.
struct Geometry {
  int TR;       // cache rows a tile (of K or of V)
  int krow;     // bytes between rows of a staged tile
  int qd;       // floats between queries of the staged q
  int rg;       // row groups of the p.v pass
  int rmax;     // rows of the score buffer: the split's rows, whole tiles
  size_t stage_bytes;  // the two tile buffers (reused by the merge)
  size_t off_q, off_qb, off_sp, off_sc, off_misc, off_cw, bytes;
};

__host__ __device__ inline Geometry geometry(int G, int D, int el, int rows,
                                             int nsplit) {
  Geometry g;
  const int row = D * el;
  int tr = MAXTR;
  while (tr > 8 && tr * row > TILE_BYTES) tr /= 2;
  g.TR = tr;
  // 16-byte aligned rows; an odd number of 16-byte units keeps the eight
  // rows a quarter-warp reads in distinct banks
  int k = (row + 15) / 16 * 16;
  if ((k / 16) % 2 == 0) k += 16;
  g.krow = k;
  g.qd = (D + 7) / 8 * 8;
  const int tpr = (D + 1) / 2;  // p.v threads a row (two columns each)
  g.rg = THREADS / tpr;
  g.rmax = (rows + tr - 1) / tr * tr;
  const size_t stages = (size_t)2 * tr * k;  // two tile buffers
  const size_t comb = (size_t)g.rg * G * D * sizeof(float);
  g.stage_bytes = stages;
  size_t off = ((stages > comb ? stages : comb) + 15) / 16 * 16;
  g.off_q = off;
  off += (size_t)G * g.qd * sizeof(float);
  g.off_qb = off;  // q as bf16 [8][qd + 8] for the tensor cores
  off += (size_t)MAXG * (g.qd + 8) * 2;
  g.off_sp = off;  // a tile's partial scores [part][g][row]
  off += (size_t)THREADS * G * sizeof(float);
  g.off_sc = off;  // the split's scores, then p (V scale folded) [row][8]
  off += (size_t)g.rmax * MAXG * sizeof(float);
  g.off_misc = off;  // m[8], l[8], ticket flag
  off += 32 * sizeof(float);
  g.off_cw = off;  // the merge's (m, then weight) and l [g][split]
  off += nsplit > 1 ? (size_t)2 * G * nsplit * sizeof(float) : 0;
  g.bytes = off;
  return g;
}

// Stage rows [r, r + n) of this (slot, head) of one cache leaf into dst.
template <typename TKV>
__device__ __forceinline__ void stage_rows(char* dst, const TKV* src,
                                           size_t row_stride, int n, int D,
                                           int krow, bool vec) {
  if (vec) {
    const int chunks = D * (int)sizeof(TKV) / 16;
    if (THREADS % chunks == 0) {  // a fixed chunk a thread, rows in steps
      const int c = threadIdx.x % chunks, step = THREADS / chunks;
      for (int r = threadIdx.x / chunks; r < n; r += step)
        cp_async16(dst + (size_t)r * krow + c * 16,
                   reinterpret_cast<const char*>(src + r * row_stride) + c * 16);
    } else {
      for (int e = threadIdx.x; e < n * chunks; e += THREADS) {
        const int r = e / chunks, c = e % chunks;
        cp_async16(dst + (size_t)r * krow + c * 16,
                   reinterpret_cast<const char*>(src + r * row_stride) + c * 16);
      }
    }
  } else {
    for (int e = threadIdx.x; e < n * D; e += THREADS) {
      const int r = e / D, d = e % D;
      reinterpret_cast<TKV*>(dst + (size_t)r * krow)[d] = src[r * row_stride + d];
    }
  }
}

// One block per (split, slot * KV + head).
template <typename TQ, typename TKV>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
decode_attention_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
                        const TKV* __restrict__ v,
                        const float* __restrict__ ks,
                        const float* __restrict__ vs,
                        const int* __restrict__ lengths,
                        float* __restrict__ out, float* __restrict__ ws_m,
                        float* __restrict__ ws_l, float* __restrict__ ws_acc,
                        int* __restrict__ tickets, int S, int KV, int G,
                        int D, int rows, float sm_scale) {
  extern __shared__ __align__(16) char smem[];
  const int split = blockIdx.x, nsplit = gridDim.x;
  const int bh = blockIdx.y;
  const int b = bh / KV, h = bh % KV;
  const int len = max(0, min(lengths[b], S));
  const int nvalid = (len + rows - 1) / rows;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  if (split >= nvalid) {  // no valid row; a length-0 slot's row is zero
    if (len == 0 && split == 0)
      for (int e = tid; e < G * D; e += THREADS) out[(size_t)bh * G * D + e] = 0.f;
    return;
  }
  const Geometry geo = geometry(G, D, (int)sizeof(TKV), rows, nsplit);
  const int TR = geo.TR, krow = geo.krow, QD = geo.qd;
  const int trs = __ffs(TR) - 1;  // log2(TR)
  float* qs = reinterpret_cast<float*>(smem + geo.off_q);
  __nv_bfloat16* qb = reinterpret_cast<__nv_bfloat16*>(smem + geo.off_qb);
  float* sp = reinterpret_cast<float*>(smem + geo.off_sp);
  float* sc = reinterpret_cast<float*>(smem + geo.off_sc);
  float* misc = reinterpret_cast<float*>(smem + geo.off_misc);
  float* m_s = misc;       // [8]
  float* l_s = misc + 8;   // [8]
  int* flag = reinterpret_cast<int*>(misc + 16);

  const int r0 = split * rows;
  const int rend = min(len, r0 + rows);
  const int nrows = rend - r0;
  const int ntk = (nrows + TR - 1) / TR;  // tiles of K, then as many of V
  const size_t rs = (size_t)KV * D;  // elements between cache positions
  const TKV* kb = k + ((size_t)b * S) * rs + (size_t)h * D;
  const TKV* vb = v + ((size_t)b * S) * rs + (size_t)h * D;
  const size_t sc0 = (size_t)b * S * KV + h;  // scale of row s: sc0 + s*KV
  const bool vec = (D * (int)sizeof(TKV)) % 16 == 0;
  auto buf = [&](int t) { return smem + (size_t)(t & 1) * TR * krow; };
  auto stage = [&](int t) {  // tile t: K rows for t < ntk, then V rows
    const int tt = t < ntk ? t : t - ntk;
    const int s0 = r0 + tt * TR, n = min(TR, rend - s0);
    stage_rows<TKV>(buf(t), (t < ntk ? kb : vb) + (size_t)s0 * rs, rs, n, D,
                    krow, vec);
  };

  // q, widened; for the tensor cores also as bf16 (exact: q is bf16), with
  // zero rows past G. Every load is issued before any is stored.
  {
    constexpr int QH = MAXD / THREADS;  // columns a thread per query
    float qv[MAXG][QH];
#pragma unroll
    for (int g = 0; g < MAXG; ++g)
#pragma unroll
      for (int c = 0; c < QH; ++c) {
        const int d = tid + c * THREADS;
        qv[g][c] = (g < G && d < D) ? to_f32(q[((size_t)bh * G + g) * D + d])
                                    : 0.f;
      }
#pragma unroll
    for (int g = 0; g < MAXG; ++g)
#pragma unroll
      for (int c = 0; c < QH; ++c) {
        const int d = tid + c * THREADS;
        if (d < QD) {
          if (g < G) qs[g * QD + d] = qv[g][c];
          if (UsesMma<TQ, TKV>::value)
            qb[g * (QD + 8) + d] = __float2bfloat16(qv[g][c]);
        }
      }
  }
  stage(0);
  cp_async_commit();
  const bool mma = UsesMma<TQ, TKV>::value && D % 16 == 0 && TR >= 16;

  // score pass geometry. CUDA cores: thread (row r, slice p of D). Tensor
  // cores: warp (16-row m tile, slice kp of D's 16-wide k steps)
  const int mtiles = TR / 16;
  const int parts = mma ? WARPS / mtiles : THREADS / TR;
  const int sr = tid % TR, spart = tid / TR;
  const int DP = ((D + parts - 1) / parts + 7) / 8 * 8;
  const int d0 = spart * DP, d1 = min(D, d0 + DP);
  // p.v geometry: thread (row group, column pair)
  const int tpr = (D + 1) / 2, RG = geo.rg;
  const int pcol = 2 * (tid % tpr), prg = tid / tpr;
  const bool pv_on = prg < RG;
  const bool two = pcol + 1 < D;
  float acc[MAXG][2];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) acc[g][0] = acc[g][1] = 0.f;

  for (int t = 0; t < 2 * ntk; ++t) {
    if (t + 1 < 2 * ntk) {
      stage(t + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int tt = t < ntk ? t : t - ntk;
    const int s0 = r0 + tt * TR, n = min(TR, rend - s0);
    const char* tile = buf(t);

    if (t < ntk) {
      if (mma) {
        // scores on the tensor cores: rows mt*16.. of the tile against the
        // 8 (zero-padded) queries, k steps [ks0, ks1) of D
        const int mt = warp % mtiles, kp = warp / mtiles;
        const int KS = D / 16, ks0 = kp * KS / parts,
                  ks1 = (kp + 1) * KS / parts;
        const int gid = lane >> 2, tq = lane & 3;
        const char* ka = tile + (size_t)(mt * 16 + gid) * krow;
        const char* kb8 = ka + (size_t)8 * krow;
        const __nv_bfloat16* qrow = qb + gid * (QD + 8);
        float c[4] = {0.f, 0.f, 0.f, 0.f};
        for (int ks = ks0; ks < ks1; ++ks) {
          const int col = ks * 16 + 2 * tq;
          mma_bf16(c, pair_bf16(reinterpret_cast<const TKV*>(ka) + col),
                   pair_bf16(reinterpret_cast<const TKV*>(kb8) + col),
                   pair_bf16(reinterpret_cast<const TKV*>(ka) + col + 8),
                   pair_bf16(reinterpret_cast<const TKV*>(kb8) + col + 8),
                   *reinterpret_cast<const uint32_t*>(qrow + col),
                   *reinterpret_cast<const uint32_t*>(qrow + col + 8));
        }
        const int r = mt * 16 + gid, g = 2 * tq;
        if (g < G) {
          sp[(kp * G + g) * TR + r] = c[0];
          sp[(kp * G + g) * TR + r + 8] = c[2];
        }
        if (g + 1 < G) {
          sp[(kp * G + g + 1) * TR + r] = c[1];
          sp[(kp * G + g + 1) * TR + r + 8] = c[3];
        }
      } else {
        // scores on the CUDA cores: partial dots of row sr over [d0, d1)
        float sacc[MAXG];
#pragma unroll
        for (int g = 0; g < MAXG; ++g) sacc[g] = 0.f;
        if (sr < n) {
          const TKV* kr = reinterpret_cast<const TKV*>(tile + (size_t)sr * krow);
          int d = d0;
          for (; d + 8 <= d1; d += 8) {
            float kv[8];
            load8(kr + d, kv);
#pragma unroll
            for (int g = 0; g < MAXG; ++g) {
              if (g < G) {
                const float4 qa = *reinterpret_cast<const float4*>(qs + g * QD + d);
                const float4 qh = *reinterpret_cast<const float4*>(qs + g * QD + d + 4);
                float a = sacc[g];
                a = fmaf(qa.x, kv[0], a); a = fmaf(qa.y, kv[1], a);
                a = fmaf(qa.z, kv[2], a); a = fmaf(qa.w, kv[3], a);
                a = fmaf(qh.x, kv[4], a); a = fmaf(qh.y, kv[5], a);
                a = fmaf(qh.z, kv[6], a); a = fmaf(qh.w, kv[7], a);
                sacc[g] = a;
              }
            }
          }
          for (; d < d1; ++d) {
            const float kv = to_f32(kr[d]);
#pragma unroll
            for (int g = 0; g < MAXG; ++g)
              if (g < G) sacc[g] = fmaf(qs[g * QD + d], kv, sacc[g]);
          }
        }
#pragma unroll
        for (int g = 0; g < MAXG; ++g)
          if (g < G) sp[(spart * G + g) * TR + sr] = sacc[g];
      }
      __syncthreads();
      // the slices' partial dots added in slice order, scaled (the int8
      // cache's K scale after the dot), into the split's score rows
      for (int e = tid; e < G * TR; e += THREADS) {
        const int g = e >> trs, r = e & (TR - 1);
        if (r < n) {
          float t_ = 0.f;
          for (int p = 0; p < parts; ++p) t_ += sp[(p * G + g) * TR + r];
          sc[(tt * TR + r) * MAXG + g] =
              ks != nullptr ? t_ * (ks[sc0 + (size_t)(s0 + r) * KV] * sm_scale)
                            : t_ * sm_scale;
        }
      }
      if (t == ntk - 1) {
        __syncthreads();
        // _softmax_step over the split's rows (an empty carry: m_prev = -inf,
        // so l is the sum of p), warp w over queries w and w + WARPS;
        // p, with the row's V scale folded in, replaces the score
        float mx[2] = {-INFINITY, -INFINITY};
        for (int r = lane; r < nrows; r += 32)
#pragma unroll
          for (int j = 0; j < 2; ++j)
            if (warp + WARPS * j < G)
              mx[j] = fmaxf(mx[j], sc[r * MAXG + warp + WARPS * j]);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
          mx[0] = fmaxf(mx[0], __shfl_xor_sync(0xffffffffu, mx[0], o));
          mx[1] = fmaxf(mx[1], __shfl_xor_sync(0xffffffffu, mx[1], o));
        }
        float ms[2], psum[2] = {0.f, 0.f};
#pragma unroll
        for (int j = 0; j < 2; ++j) ms[j] = isfinite(mx[j]) ? mx[j] : 0.f;
        for (int r = lane; r < nrows; r += 32) {
          const float vsc = vs != nullptr ? vs[sc0 + (size_t)(r0 + r) * KV] : 1.f;
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int g = warp + WARPS * j;
            if (g < G) {
              const float sv = sc[r * MAXG + g];
              const float p = isfinite(sv) ? expf(sv - ms[j]) : 0.f;
              psum[j] += p;
              sc[r * MAXG + g] = vs != nullptr ? p * vsc : p;
            }
          }
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
          psum[0] += __shfl_xor_sync(0xffffffffu, psum[0], o);
          psum[1] += __shfl_xor_sync(0xffffffffu, psum[1], o);
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int g = warp + WARPS * j;
          if (g < G && lane == 0) {
            m_s[g] = mx[j];
            l_s[g] = psum[j];
          }
        }
      }
    } else if (pv_on) {
      // p.v: thread (row group prg, columns pcol, pcol + 1); rows prg, prg
      // + RG, ... four at a time: the loads of four rows issued before
      // their products, which add in row order
      const float* pt = sc + (size_t)tt * TR * MAXG;
      for (int ra = prg; ra < n; ra += 4 * RG) {
        float2 vv[4];
        float4 pa[4], pb[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int r = ra + u * RG;
          const int rr = r < n ? r : ra;
          vv[u] = load2(reinterpret_cast<const TKV*>(tile + (size_t)rr * krow) + pcol,
                        two);
          pa[u] = *reinterpret_cast<const float4*>(pt + rr * MAXG);
          pb[u] = *reinterpret_cast<const float4*>(pt + rr * MAXG + 4);
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (ra + u * RG < n) {
            const float pr[MAXG] = {pa[u].x, pa[u].y, pa[u].z, pa[u].w,
                                    pb[u].x, pb[u].y, pb[u].z, pb[u].w};
#pragma unroll
            for (int g = 0; g < MAXG; ++g) {
              if (g < G) {
                acc[g][0] = fmaf(pr[g], vv[u].x, acc[g][0]);
                acc[g][1] = fmaf(pr[g], vv[u].y, acc[g][1]);
              }
            }
          }
        }
      }
    }
    __syncthreads();  // the buffer of tile t may be restaged now
  }

  // the row groups' sums, added in group order
  float* comb = reinterpret_cast<float*>(smem);
  if (pv_on) {
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g < G) {
        comb[((size_t)prg * G + g) * D + pcol] = acc[g][0];
        if (two) comb[((size_t)prg * G + g) * D + pcol + 1] = acc[g][1];
      }
    }
  }
  __syncthreads();

  const size_t o = (size_t)bh * G * D;
  if (nvalid == 1) {  // one split: _finish, straight to the output
    for (int e = tid; e < G * D; e += THREADS) {
      const int g = e / D;
      float a = 0.f;
      for (int p = 0; p < RG; ++p) a += comb[(size_t)p * G * D + e];
      const float l = l_s[g];
      out[o + e] = a / (l > 0.f ? l : 1.f);
    }
    return;
  }
  const size_t w0 = (size_t)bh * nsplit + split;
  for (int e = tid; e < G * D; e += THREADS) {
    float a = 0.f;
    for (int p = 0; p < RG; ++p) a += comb[(size_t)p * G * D + e];
    ws_acc[w0 * G * D + e] = a;
  }
  if (tid < G) {
    ws_m[w0 * G + tid] = m_s[tid];
    ws_l[w0 * G + tid] = l_s[tid];
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) *flag = atomicAdd(&tickets[bh], 1) == nvalid - 1;
  __syncthreads();
  if (!*flag) return;
  __threadfence();

  // the last block merges the splits in index order, then _finish: every
  // split's (m, l) at once, then the acc rows, as many splits at a time as
  // the tile buffers hold, copied in by cp.async (L2 only: other blocks
  // wrote them)
  float* cm = reinterpret_cast<float*>(smem + geo.off_cw);  // [g][split]
  float* cl = cm + (size_t)G * nsplit;
  const size_t base = (size_t)bh * nsplit;
  for (int e = tid; e < G * nvalid; e += THREADS) {
    const int g = e / nvalid, i = e % nvalid;
    cm[g * nsplit + i] = __ldcg(ws_m + (base + i) * G + g);
    cl[g * nsplit + i] = __ldcg(ws_l + (base + i) * G + g);
  }
  __syncthreads();
  for (int g = tid; g < G; g += THREADS) {
    float M = -INFINITY;
    for (int i = 0; i < nvalid; ++i) M = fmaxf(M, cm[g * nsplit + i]);
    const float Ms = isfinite(M) ? M : 0.f;
    float L = 0.f;
    for (int i = 0; i < nvalid; ++i) {
      const float mi = cm[g * nsplit + i];
      const float c = isfinite(mi) ? expf(mi - Ms) : 0.f;
      cm[g * nsplit + i] = c;  // the split's weight
      L = fmaf(c, cl[g * nsplit + i], L);
    }
    l_s[g] = L;
  }
  constexpr int EPT = MAXG * MAXD / THREADS;  // output elements a thread
  float a[EPT];
  int eg[EPT];  // the query of each element
#pragma unroll
  for (int j = 0; j < EPT; ++j) {
    a[j] = 0.f;
    eg[j] = (tid + j * THREADS) / D;
  }
  const int rowf = G * D;  // floats of one split's acc
  const bool v16 = rowf % 4 == 0;
  const int per = max(1, (int)(geo.stage_bytes / (rowf * sizeof(float))));
  float* mbuf = reinterpret_cast<float*>(smem);
  for (int i0 = 0; i0 < nvalid; i0 += per) {
    const int cnt = min(per, nvalid - i0);
    const float* src = ws_acc + (base + i0) * rowf;
    if (v16) {
      for (int c = tid; c < cnt * rowf / 4; c += THREADS)
        cp_async16(mbuf + 4 * c, src + 4 * c);
      cp_async_commit();
      cp_async_wait<0>();
    } else {
      for (int c = tid; c < cnt * rowf; c += THREADS) mbuf[c] = __ldcg(src + c);
    }
    __syncthreads();
    for (int u = 0; u < cnt; ++u)
#pragma unroll
      for (int j = 0; j < EPT; ++j) {
        const int e = tid + j * THREADS;
        if (e < rowf)
          a[j] = fmaf(cm[eg[j] * nsplit + i0 + u], mbuf[u * rowf + e], a[j]);
      }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < EPT; ++j) {
    const int e = tid + j * THREADS;
    if (e < rowf) {
      const float l = l_s[eg[j]];
      out[o + e] = a[j] / (l > 0.f ? l : 1.f);
    }
  }
  if (tid == 0) tickets[bh] = 0;  // zero again for the next launch
}

template <typename TQ, typename TKV>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* k_scale, const void* v_scale,
                   const void* lengths, void* out, float* ws, int* tickets,
                   int B, int S, int KV, int G, int D, int rows, int nsplit,
                   float sm_scale, cudaStream_t stream) {
  const Geometry geo = geometry(G, D, (int)sizeof(TKV), rows, nsplit);
  auto kernel = decode_attention_kernel<TQ, TKV>;
  if (geo.bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)geo.bytes);
    if (e != cudaSuccess) return e;
  }
  // acc rows first, so that each split's row is 16-byte aligned when G * D
  // is a multiple of 4
  const size_t n_state = (size_t)B * KV * nsplit * G;
  float* ws_acc = ws;
  float* ws_m = ws == nullptr ? nullptr : ws + n_state * D;
  float* ws_l = ws == nullptr ? nullptr : ws + n_state * (D + 1);
  const dim3 grid(nsplit, B * KV);
  kernel<<<grid, THREADS, geo.bytes, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k),
      static_cast<const TKV*>(v), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<const int*>(lengths),
      static_cast<float*>(out), ws_m, ws_l, ws_acc, tickets, S, KV, G, D,
      rows, sm_scale);
  return cudaGetLastError();
}

template <typename TQ>
cudaError_t launch_kv(int kv_kind, const void* q, const void* k,
                      const void* v, const void* k_scale, const void* v_scale,
                      const void* lengths, void* out, float* ws, int* tickets,
                      int B, int S, int KV, int G, int D, int rows,
                      int nsplit, float sm_scale, cudaStream_t stream) {
  if (kv_kind == 2)
    return launch<TQ, int8_t>(q, k, v, k_scale, v_scale, lengths, out, ws,
                              tickets, B, S, KV, G, D, rows, nsplit, sm_scale,
                              stream);
  if (kv_kind == 1)
    return launch<TQ, __nv_bfloat16>(q, k, v, nullptr, nullptr, lengths, out,
                                     ws, tickets, B, S, KV, G, D, rows,
                                     nsplit, sm_scale, stream);
  return launch<TQ, float>(q, k, v, nullptr, nullptr, lengths, out, ws,
                           tickets, B, S, KV, G, D, rows, nsplit, sm_scale,
                           stream);
}

}  // namespace

// Float32 workspace the caller allocates for nsplit splits a (slot, head):
// acc per (slot, head, split, query, d), then (m, l) per (slot, head,
// split, query); none for one split. It must start 16-byte aligned.
extern "C" long long decode_attention_workspace(int B, int KV, int G, int D,
                                                int nsplit) {
  return nsplit > 1 ? (long long)B * KV * nsplit * G * (2 + (long long)D) : 0;
}

// Returns a cudaError_t code: 0 when the launch was accepted. kv_kind:
// 0 float32, 1 bfloat16, 2 int8 codes with k_scale and v_scale (B, S, KV)
// float32, which must not be null then and are not read otherwise. rows:
// cache rows a split, nsplit = ceil(S / rows) splits; ws: the workspace
// (null for one split); tickets: B * KV int32 counters, zero before the
// launch and zero again after it.
extern "C" int decode_attention(const void* q, const void* k, const void* v,
                                const void* k_scale, const void* v_scale,
                                const void* lengths, void* out, void* ws,
                                void* tickets, int B, int S, int KV, int G,
                                int D, int rows, int nsplit, float sm_scale,
                                int q_bf16, int kv_kind, void* stream) {
  if (B < 1 || S < 1 || KV < 1 || G < 1 || G > MAXG || D < 1 || D > MAXD ||
      rows < 1 || nsplit < 1 || nsplit != (S + rows - 1) / rows ||
      nsplit > 65535 || (long long)B * KV > 65535 || kv_kind < 0 ||
      kv_kind > 2 || tickets == nullptr || (nsplit > 1 && ws == nullptr) ||
      (kv_kind == 2 && (k_scale == nullptr || v_scale == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* w = static_cast<float*>(ws);
  int* tk = static_cast<int*>(tickets);
  cudaError_t err =
      q_bf16 ? launch_kv<__nv_bfloat16>(kv_kind, q, k, v, k_scale, v_scale,
                                        lengths, out, w, tk, B, S, KV, G, D,
                                        rows, nsplit, sm_scale, s)
             : launch_kv<float>(kv_kind, q, k, v, k_scale, v_scale, lengths,
                                out, w, tk, B, S, KV, G, D, rows, nsplit,
                                sm_scale, s);
  return (int)err;
}

// The launch's dynamic shared memory and threads for G queries of D
// values a kv head over a cache of kv_kind (0 float32, 1 bfloat16, 2
// int8), `rows` rows a split in nsplit splits, as decode_attention makes
// it; launches nothing.
extern "C" int decode_attention_query(int G, int D, int kv_kind, int rows,
                                      int nsplit, int* smem, int* threads) {
  if (G < 1 || G > MAXG || D < 1 || D > MAXD || rows < 1 || nsplit < 1 ||
      kv_kind < 0 || kv_kind > 2)
    return (int)cudaErrorInvalidValue;
  const int el = kv_kind == 2 ? 1 : kv_kind == 1 ? 2 : 4;
  *smem = (int)geometry(G, D, el, rows, nsplit).bytes;
  *threads = THREADS;
  return 0;
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
