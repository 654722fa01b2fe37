// Used by the depthwise weight-gradient kernel (conv1d_depthwise_bwd.cu):
// where the (batch x row) reduction is split over S blocks that each write
// a float32 partial to a workspace, this second pass adds the partials in
// a fixed order, so the result does not change from run to run (no
// atomics).
#pragma once

#include <stddef.h>

namespace {

// v[i] = sum over s = 0 .. S-1 of ws[s * n + i], in that order, stored to
// head[i] for i < n_head and to tail[i - n_head] after (tail may be null:
// those sums are dropped). One pass for dw's rows and db's together.
__global__ void reduce_splits(const float* __restrict__ ws,
                              float* __restrict__ head,
                              float* __restrict__ tail, size_t n_head,
                              size_t n, int S) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    if (i >= n_head && tail == nullptr) continue;
    float v = 0.f;
    for (int s = 0; s < S; ++s) v += ws[(size_t)s * n + i];
    if (i < n_head)
      head[i] = v;
    else
      tail[i - n_head] = v;
  }
}

}  // namespace
