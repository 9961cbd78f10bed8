// LayerNorm forward, y = (x - mean) * rsqrt(var + eps) * scale + bias with
// the two-pass variance var = mean((x - mean)^2), and its dx,
// dx = r * (gs - mean(gs) - norm * mean(gs * norm)), gs = g * scale,
// norm = (x - mean) * r; f32 math, outputs in x's dtype.
//
// Replaces the TPU kernels tf_yarn_tpu/ops/layernorm.py:_layernorm_kernel
// and :_layernorm_bwd_dx_kernel (launched through
// ops/_rowwise.py:rowwise_call). dscale = sum of g * norm and dbias = sum
// of g over the rows are cross-row reductions and stay outside, as in the
// JAX package.
//
// Bound on the H100: memory. The forward reads x once and writes y once
// (4d bytes a row in bf16) against ~8d f32 operations; dx reads x and g
// and writes dx. Design: one warp per row (BERT-base and ViT-B/16 rows are
// 768 wide: 24 elements a lane), eight rows a block, so each reduction is
// a warp shuffle with no shared memory and no block barrier. The TPU
// kernel holds its row block in VMEM; here the first pass reads the row
// from device memory and the later passes (the centred squares, then the
// output) find it in L1: a block's eight rows are 12 KB in bf16. Loads are
// scalar and coalesced (64 bytes a warp instruction in bf16); vector
// loads are the first step of a faster version.
#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

template <typename T>
__global__ void __launch_bounds__(kThreads)
layernorm_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                 const float* __restrict__ bias, T* __restrict__ y, int rows,
                 int d, float eps) {
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;  // the whole warp leaves together
  const int lane = threadIdx.x & 31;
  const T* xr = x + static_cast<size_t>(row) * d;
  T* yr = y + static_cast<size_t>(row) * d;
  const float inv_d = 1.f / static_cast<float>(d);

  float sum = 0.f;
#pragma unroll 4
  for (int i = lane; i < d; i += 32) sum += tyt::to_float(xr[i]);
  const float mean = tyt::warp_sum(sum) * inv_d;
  float sq = 0.f;
#pragma unroll 4
  for (int i = lane; i < d; i += 32) {
    const float c = tyt::to_float(xr[i]) - mean;
    sq += c * c;
  }
  const float r = rsqrtf(tyt::warp_sum(sq) * inv_d + eps);
#pragma unroll 4
  for (int i = lane; i < d; i += 32) {
    const float norm = (tyt::to_float(xr[i]) - mean) * r;
    yr[i] = tyt::from_float<T>(norm * scale[i] + bias[i]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
layernorm_bwd_dx_kernel(const T* __restrict__ x, const T* __restrict__ g,
                        const float* __restrict__ scale, T* __restrict__ dx,
                        int rows, int d, float eps) {
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  const size_t off = static_cast<size_t>(row) * d;
  const float inv_d = 1.f / static_cast<float>(d);

  float sum = 0.f;
#pragma unroll 4
  for (int i = lane; i < d; i += 32) sum += tyt::to_float(x[off + i]);
  const float mean = tyt::warp_sum(sum) * inv_d;
  // One pass for the three sums that need the mean: the centred squares,
  // gs, and gs times the centred x (mean(gs * norm) = r * mean(gs * c)).
  float sq = 0.f, sum_gs = 0.f, sum_gsc = 0.f;
#pragma unroll 4
  for (int i = lane; i < d; i += 32) {
    const float c = tyt::to_float(x[off + i]) - mean;
    const float gs = tyt::to_float(g[off + i]) * scale[i];
    sq += c * c;
    sum_gs += gs;
    sum_gsc += gs * c;
  }
  const float r = rsqrtf(tyt::warp_sum(sq) * inv_d + eps);
  const float mean_gs = tyt::warp_sum(sum_gs) * inv_d;
  const float mean_gs_norm = tyt::warp_sum(sum_gsc) * inv_d * r;
#pragma unroll 4
  for (int i = lane; i < d; i += 32) {
    const float norm = (tyt::to_float(x[off + i]) - mean) * r;
    const float gs = tyt::to_float(g[off + i]) * scale[i];
    dx[off + i] = tyt::from_float<T>(r * (gs - mean_gs - norm * mean_gs_norm));
  }
}

int blocks_for(int rows) { return (rows + kWarps - 1) / kWarps; }

}  // namespace

extern "C" int tyt_layernorm(const void* x, const float* scale,
                             const float* bias, void* y, int rows, int d,
                             float eps, int dtype, void* stream) {
  if (rows <= 0 || d <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == tyt::kBFloat16) {
    layernorm_kernel<__nv_bfloat16><<<blocks_for(rows), kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), scale, bias,
        static_cast<__nv_bfloat16*>(y), rows, d, eps);
  } else if (dtype == tyt::kFloat32) {
    layernorm_kernel<float><<<blocks_for(rows), kThreads, 0, s>>>(
        static_cast<const float*>(x), scale, bias, static_cast<float*>(y),
        rows, d, eps);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// g (the cotangent of y) has x's dtype; dx is written in it too.
extern "C" int tyt_layernorm_bwd_dx(const void* x, const void* g,
                                    const float* scale, void* dx, int rows,
                                    int d, float eps, int dtype,
                                    void* stream) {
  if (rows <= 0 || d <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == tyt::kBFloat16) {
    layernorm_bwd_dx_kernel<__nv_bfloat16><<<blocks_for(rows), kThreads, 0,
                                              s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(g), scale,
        static_cast<__nv_bfloat16*>(dx), rows, d, eps);
  } else if (dtype == tyt::kFloat32) {
    layernorm_bwd_dx_kernel<float><<<blocks_for(rows), kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(g), scale,
        static_cast<float*>(dx), rows, d, eps);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
