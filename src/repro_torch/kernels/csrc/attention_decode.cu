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
// cache may each be float32 or bfloat16; all arithmetic is float32. A slot
// with length 0 gives a zero row. G is 1..8 and D at most 128.
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
// and does 4*G*D operations per row, so it is bound by bytes: at whisper's
// serving shape (B=4, S=288, KV=16, G=1, D=64, bf16 cache) about 4.2 MB, or
// 1.3 us at 3.35 TB/s; the int8 cache moves about half as many bytes (one
// a value, and 4 bytes of scale per 64-value row). At that size the real
// limits are latency and parallelism: B*KV is only 64 (slot, head) pairs,
// fewer than the 132 SMs, and a decode step makes 48 such calls.
//
// What the design does about it (split-S, "flash decoding"): the first
// kernel gives every (split of SPLIT cache rows, slot, head) its own block,
// so a 288-row cache at B*KV = 64 runs 576 blocks. Each warp loads all of its
// rows before it reduces any (many loads in flight instead of one row at a
// time), the score pass is a multiply-reduce over D with a shuffle reduction
// (at G = 1 tensor cores gain nothing), and the p.v pass runs threads across
// D so every V row is read coalesced. Each block keeps its split's online-
// softmax state (max m, denominator l, acc[G][D]) in float32, as the Pallas
// kernel keeps it in scratch across its sequential kv grid dimension, and
// writes it out; the second kernel merges the splits of each (slot, head)
// with the same correction, acc = sum_i exp(m_i - M) acc_i over l likewise.
// The guards of _softmax_step hold: rows past lengths[b] get probability 0;
// a split with no valid row is skipped, which leaves the merge untouched,
// exactly as an all-masked block leaves the reference's carry untouched; a
// slot with no valid row (l == 0) writes zeros. No masked row is read.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int SPLIT = 32;                 // cache rows per block
constexpr int ROWS_PER_WARP = SPLIT / WARPS;
constexpr int MAXG = 8;                   // grouped queries per kv head
constexpr int MAXD = 128;                 // head_dim
constexpr int DPL = MAXD / 32;            // head_dim elements per lane

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(int8_t v) { return (float)v; }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// One block per (split, slot * KV + head): the split's scores, softmax and
// p.v, written as (m, l, acc) to the workspace for the merge. ks and vs are
// the int8 cache's scales, null for a float cache.
template <typename TQ, typename TKV>
__global__ void __launch_bounds__(THREADS)
decode_attention_split_kernel(const TQ* __restrict__ q,
                              const TKV* __restrict__ k,
                              const TKV* __restrict__ v,
                              const float* __restrict__ ks,
                              const float* __restrict__ vs,
                              const int* __restrict__ lengths,
                              float* __restrict__ ws_m, float* __restrict__ ws_l,
                              float* __restrict__ ws_acc, int S, int KV, int G,
                              int D, float sm_scale) {
  __shared__ float qs[MAXG * MAXD];
  __shared__ float ps[MAXG * SPLIT];           // scores, then probabilities
  __shared__ float part_acc[THREADS * MAXG];   // per-part sums of p.v

  const int split = blockIdx.x, nsplit = gridDim.x;
  const int bh = blockIdx.y;
  const int b = bh / KV, h = bh % KV;
  const int len = max(0, min(lengths[b], S));
  const int r0 = split * SPLIT;
  if (r0 >= len) return;  // no valid row: the merge never reads this split
  const int n = min(SPLIT, len - r0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const size_t row = (size_t)KV * D;  // elements between cache positions
  const TKV* kb = k + ((size_t)b * S + r0) * row + (size_t)h * D;
  const TKV* vb = v + ((size_t)b * S + r0) * row + (size_t)h * D;
  // scale of row p of this split: sc[p * KV]
  const size_t sc0 = ((size_t)b * S + r0) * KV + h;

  for (int e = tid; e < G * D; e += THREADS)
    qs[e] = to_f32(q[(size_t)bh * G * D + e]);
  __syncthreads();

  // scores: each warp loads all of its rows, then reduces them
  float kr[ROWS_PER_WARP][DPL];
#pragma unroll
  for (int r = 0; r < ROWS_PER_WARP; ++r) {
    const int p = warp * ROWS_PER_WARP + r;
#pragma unroll
    for (int j = 0; j < DPL; ++j) {
      const int d = lane + 32 * j;
      kr[r][j] = (p < n && d < D) ? to_f32(kb[(size_t)p * row + d]) : 0.f;
    }
  }
#pragma unroll
  for (int r = 0; r < ROWS_PER_WARP; ++r) {
    const int p = warp * ROWS_PER_WARP + r;
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g < G) {
        float t = 0.f;
#pragma unroll
        for (int j = 0; j < DPL; ++j) {
          const int d = lane + 32 * j;
          if (d < D) t = fmaf(qs[g * D + d], kr[r][j], t);
        }
        t = warp_sum(t);
        if (lane == 0 && p < n)
          ps[g * SPLIT + p] =
              ks != nullptr ? t * (ks[sc0 + (size_t)p * KV] * sm_scale)
                            : t * sm_scale;
      }
    }
  }
  __syncthreads();

  // _softmax_step over the split, one warp per grouped query (m_prev = -inf)
  for (int g = warp; g < G; g += WARPS) {
    const float sp = lane < n ? ps[g * SPLIT + lane] : -INFINITY;
    const float m = warp_max(sp);
    const float m_safe = isfinite(m) ? m : 0.f;
    const float e = isfinite(sp) ? expf(sp - m_safe) : 0.f;
    // p.v reads the probability with the row's V scale folded in; the
    // denominator sums the unscaled probabilities
    if (lane < n)
      ps[g * SPLIT + lane] =
          vs != nullptr ? e * vs[sc0 + (size_t)lane * KV] : e;
    const float l = warp_sum(e);
    if (lane == 0) {
      ws_m[((size_t)bh * nsplit + split) * G + g] = m;
      ws_l[((size_t)bh * nsplit + split) * G + g] = l;
    }
  }
  __syncthreads();

  // p.v: thread (part, d) sums rows p = part (mod nparts)
  const int nparts = THREADS / D;
  const int d = tid % D, part = tid / D;
  if (part < nparts) {
    float acc[MAXG];
#pragma unroll
    for (int g = 0; g < MAXG; ++g) acc[g] = 0.f;
#pragma unroll 4
    for (int p = part; p < n; p += nparts) {
      const float vv = to_f32(vb[(size_t)p * row + d]);
#pragma unroll
      for (int g = 0; g < MAXG; ++g)
        if (g < G) acc[g] = fmaf(ps[g * SPLIT + p], vv, acc[g]);
    }
#pragma unroll
    for (int g = 0; g < MAXG; ++g)
      if (g < G) part_acc[(part * G + g) * D + d] = acc[g];
  }
  __syncthreads();
  float* out = ws_acc + ((size_t)bh * nsplit + split) * G * D;
  for (int e = tid; e < G * D; e += THREADS) {
    const int g = e / D, dd = e % D;
    float t = 0.f;
    for (int pt = 0; pt < nparts; ++pt) t += part_acc[(pt * G + g) * D + dd];
    out[e] = t;
  }
}

// One block per (slot, head): merge the valid splits, then _finish.
__global__ void __launch_bounds__(THREADS)
decode_attention_combine_kernel(const int* __restrict__ lengths,
                                const float* __restrict__ ws_m,
                                const float* __restrict__ ws_l,
                                const float* __restrict__ ws_acc,
                                float* __restrict__ out, int S, int KV, int G,
                                int D, int nsplit) {
  const int bh = blockIdx.x;
  const int len = max(0, min(lengths[bh / KV], S));
  const int nvalid = (len + SPLIT - 1) / SPLIT;
  for (int e = threadIdx.x; e < G * D; e += THREADS) {
    const int g = e / D;
    float M = -INFINITY;
    for (int i = 0; i < nvalid; ++i)
      M = fmaxf(M, ws_m[((size_t)bh * nsplit + i) * G + g]);
    float L = 0.f, A = 0.f;
    for (int i = 0; i < nvalid; ++i) {
      const size_t si = (size_t)bh * nsplit + i;
      const float c = expf(ws_m[si * G + g] - M);
      L = fmaf(c, ws_l[si * G + g], L);
      A = fmaf(c, ws_acc[si * G * D + e], A);
    }
    out[(size_t)bh * G * D + e] = A / (L > 0.f ? L : 1.f);
  }
}

template <typename TQ, typename TKV>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* k_scale, const void* v_scale,
                   const void* lengths, void* out, float* ws, int B, int S,
                   int KV, int G, int D, float sm_scale,
                   cudaStream_t stream) {
  const int nsplit = (S + SPLIT - 1) / SPLIT;
  const size_t n_state = (size_t)B * KV * nsplit * G;
  float* ws_m = ws;
  float* ws_l = ws + n_state;
  float* ws_acc = ws + 2 * n_state;
  const dim3 grid(nsplit, B * KV);
  decode_attention_split_kernel<TQ, TKV><<<grid, THREADS, 0, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k),
      static_cast<const TKV*>(v), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<const int*>(lengths),
      ws_m, ws_l, ws_acc, S, KV, G, D, sm_scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_attention_combine_kernel<<<B * KV, THREADS, 0, stream>>>(
      static_cast<const int*>(lengths), ws_m, ws_l, ws_acc,
      static_cast<float*>(out), S, KV, G, D, nsplit);
  return cudaGetLastError();
}

template <typename TQ>
cudaError_t launch_kv(int kv_kind, const void* q, const void* k,
                      const void* v, const void* k_scale, const void* v_scale,
                      const void* lengths, void* out, float* ws, int B, int S,
                      int KV, int G, int D, float sm_scale,
                      cudaStream_t stream) {
  if (kv_kind == 2)
    return launch<TQ, int8_t>(q, k, v, k_scale, v_scale, lengths, out, ws, B,
                              S, KV, G, D, sm_scale, stream);
  if (kv_kind == 1)
    return launch<TQ, __nv_bfloat16>(q, k, v, nullptr, nullptr, lengths, out,
                                     ws, B, S, KV, G, D, sm_scale, stream);
  return launch<TQ, float>(q, k, v, nullptr, nullptr, lengths, out, ws, B, S,
                           KV, G, D, sm_scale, stream);
}

}  // namespace

// Float32 workspace the caller allocates: (m, l) per (slot, head, split,
// query) and acc per (slot, head, split, query, d).
extern "C" long long decode_attention_workspace(int B, int S, int KV, int G,
                                                int D) {
  const long long nsplit = (S + SPLIT - 1) / SPLIT;
  return (long long)B * KV * nsplit * G * (2 + (long long)D);
}

// Returns a cudaError_t code: 0 when both launches were accepted. kv_kind:
// 0 float32, 1 bfloat16, 2 int8 codes with k_scale and v_scale (B, S, KV)
// float32, which must not be null then and are not read otherwise.
extern "C" int decode_attention(const void* q, const void* k, const void* v,
                                const void* k_scale, const void* v_scale,
                                const void* lengths, void* out, void* ws,
                                int B, int S, int KV, int G, int D,
                                float sm_scale, int q_bf16, int kv_kind,
                                void* stream) {
  if (B < 1 || S < 1 || KV < 1 || G < 1 || G > MAXG || D < 1 || D > MAXD ||
      (long long)B * KV > 65535 || kv_kind < 0 || kv_kind > 2 ||
      (kv_kind == 2 && (k_scale == nullptr || v_scale == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* w = static_cast<float*>(ws);
  cudaError_t err =
      q_bf16 ? launch_kv<__nv_bfloat16>(kv_kind, q, k, v, k_scale, v_scale,
                                        lengths, out, w, B, S, KV, G, D,
                                        sm_scale, s)
             : launch_kv<float>(kv_kind, q, k, v, k_scale, v_scale, lengths,
                                out, w, B, S, KV, G, D, sm_scale, s);
  return (int)err;
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
