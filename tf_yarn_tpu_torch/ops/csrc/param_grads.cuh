// dscale and dbias from a backward's per-block partials: the second
// launch of the GroupNorm and LayerNorm backwards (groupnorm.cu,
// layernorm.cu), each of which wraps sum_param_partials in a kernel of
// its own name.
#pragma once

#include "common.cuh"

namespace tyt {
namespace {

constexpr int kSumCols = 32;  // (channel, quantity) columns a block

// dscale[c] = sum_i partials[i, c, 0], dbias[c] = sum_i partials[i, c, 1]
// over the n rows of partials [n, C, 2], for a block of kSumCols x kRows
// threads: each of kRows threads sums every kRows-th row in order, then
// the first adds the kRows sums in order. No float atomics: the same
// partials give the same bits on every call. Either output may be null.
template <int kRows>
__device__ __forceinline__ void sum_param_partials(
    const float* __restrict__ partials, int n, int c,
    float* __restrict__ dscale, float* __restrict__ dbias) {
  __shared__ float rows[kRows][kSumCols];
  const int tx = threadIdx.x % kSumCols, ty = threadIdx.x / kSumCols;
  const int i = blockIdx.x * kSumCols + tx;  // column: channel i / 2
  const size_t width = 2 * static_cast<size_t>(c);
  float s = 0.f;
  if (i < 2 * c) {
    for (int r = ty; r < n; r += kRows) s += partials[r * width + i];
  }
  rows[ty][tx] = s;
  __syncthreads();
  if (ty != 0 || i >= 2 * c) return;
#pragma unroll
  for (int k = 1; k < kRows; ++k) s += rows[k][tx];
  float* out = (i & 1) ? dbias : dscale;
  if (out != nullptr) out[i >> 1] = s;
}

// The grid of a kernel that wraps sum_param_partials over c channels.
inline int param_grads_blocks(int c) {
  return (2 * c + kSumCols - 1) / kSumCols;
}

}  // namespace
}  // namespace tyt
