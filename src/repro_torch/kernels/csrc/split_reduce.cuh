// Used by the depthwise weight-gradient kernel (conv1d_depthwise_bwd.cu):
// where the (batch x row) reduction is split over S blocks that each write
// a float32 partial to a workspace, this second pass adds the partials in
// a fixed order, so the result does not change from run to run (no
// atomics).
#pragma once

#include <stddef.h>

namespace {

// out[i] = sum over s = 0 .. S-1 of ws[s * n + i], in that order
__global__ void reduce_splits(const float* __restrict__ ws,
                              float* __restrict__ out, size_t n, int S) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    float v = 0.f;
    for (int s = 0; s < S; ++s) v += ws[(size_t)s * n + i];
    out[i] = v;
  }
}

}  // namespace
