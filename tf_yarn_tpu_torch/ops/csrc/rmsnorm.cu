// RMSNorm forward, y = x * rsqrt(mean(x^2) + eps) * scale, and its dx,
// dx = r*(g*s) - x*r^3*mean(g*s*x) with r = rsqrt(mean(x^2) + eps); f32
// math, outputs in x's dtype.
//
// Replaces the TPU kernels tf_yarn_tpu/ops/rmsnorm.py:_rmsnorm_kernel
// and :_rmsnorm_bwd_dx_kernel (launched through
// ops/_rowwise.py:rowwise_call). dscale = sum over rows of g*x*r is a
// cross-row reduction and stays outside, as in the JAX package.
//
// Bound on the H100: memory. Per row of d elements it reads x once and
// writes y once (2 * 2d bytes in bf16) against ~4d f32 operations, far
// below the card's ~20 flops/byte balance point for f32 CUDA-core math.
// Design: one block of 256 threads per row; each thread accumulates a
// strided slice of x^2 in f32, a warp-shuffle then shared-memory
// reduction gives the row's sum, and a second strided pass (the row, at
// most a few KB, is served from L1/L2) writes y. Loads are scalar and
// coalesced; 16-byte vector loads are the first step of a faster version.
// dx is bound the same way (x and g read once, dx written once); its
// block takes both row reductions (x^2 and g*s*x) in one pass and
// writes dx in a second.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
rmsnorm_kernel(const T* __restrict__ x, const float* __restrict__ scale,
               T* __restrict__ y, int d, float eps) {
  __shared__ float partial[kThreads / 32];
  const T* xr = x + static_cast<size_t>(blockIdx.x) * d;
  T* yr = y + static_cast<size_t>(blockIdx.x) * d;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  float sum = 0.f;
  for (int i = threadIdx.x; i < d; i += kThreads) {
    const float v = tyt::to_float(xr[i]);
    sum += v * v;
  }
  sum = tyt::warp_sum(sum);
  if (lane == 0) partial[warp] = sum;
  __syncthreads();
  if (warp == 0) {
    float total = lane < kThreads / 32 ? partial[lane] : 0.f;
    total = tyt::warp_sum(total);
    if (lane == 0) partial[0] = total;
  }
  __syncthreads();
  const float r = rsqrtf(partial[0] / static_cast<float>(d) + eps);

  for (int i = threadIdx.x; i < d; i += kThreads) {
    const float v = tyt::to_float(xr[i]);
    yr[i] = tyt::from_float<T>(v * r * scale[i]);
  }
}

// Sums two values over the block; every thread gets both totals.
__device__ __forceinline__ float2 block_sum2(float a, float b,
                                             float2* partial) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  a = tyt::warp_sum(a);
  b = tyt::warp_sum(b);
  if (lane == 0) partial[warp] = make_float2(a, b);
  __syncthreads();
  if (warp == 0) {
    float2 v = lane < kThreads / 32 ? partial[lane] : make_float2(0.f, 0.f);
    v.x = tyt::warp_sum(v.x);
    v.y = tyt::warp_sum(v.y);
    if (lane == 0) partial[0] = v;
  }
  __syncthreads();
  return partial[0];
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rmsnorm_bwd_dx_kernel(const T* __restrict__ x, const T* __restrict__ g,
                      const float* __restrict__ scale, T* __restrict__ dx,
                      int d, float eps) {
  __shared__ float2 partial[kThreads / 32];
  const size_t off = static_cast<size_t>(blockIdx.x) * d;
  float sum_xx = 0.f, sum_gsx = 0.f;
  for (int i = threadIdx.x; i < d; i += kThreads) {
    const float xv = tyt::to_float(x[off + i]);
    const float gs = tyt::to_float(g[off + i]) * scale[i];
    sum_xx += xv * xv;
    sum_gsx += gs * xv;
  }
  const float2 sums = block_sum2(sum_xx, sum_gsx, partial);
  const float r = rsqrtf(sums.x / static_cast<float>(d) + eps);
  const float proj = sums.y / static_cast<float>(d);
  for (int i = threadIdx.x; i < d; i += kThreads) {
    const float xv = tyt::to_float(x[off + i]);
    const float gs = tyt::to_float(g[off + i]) * scale[i];
    dx[off + i] = tyt::from_float<T>(r * gs - xv * (r * r * r) * proj);
  }
}

}  // namespace

extern "C" int tyt_rmsnorm(const void* x, const float* scale, void* y,
                           int rows, int d, float eps, int dtype,
                           void* stream) {
  if (rows <= 0 || d <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == tyt::kBFloat16) {
    rmsnorm_kernel<__nv_bfloat16><<<rows, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), scale,
        static_cast<__nv_bfloat16*>(y), d, eps);
  } else if (dtype == tyt::kFloat32) {
    rmsnorm_kernel<float><<<rows, kThreads, 0, s>>>(
        static_cast<const float*>(x), scale, static_cast<float*>(y), d, eps);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// g (the cotangent of y) has x's dtype; dx is written in it too.
extern "C" int tyt_rmsnorm_bwd_dx(const void* x, const void* g,
                                  const float* scale, void* dx, int rows,
                                  int d, float eps, int dtype, void* stream) {
  if (rows <= 0 || d <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == tyt::kBFloat16) {
    rmsnorm_bwd_dx_kernel<__nv_bfloat16><<<rows, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(g), scale,
        static_cast<__nv_bfloat16*>(dx), d, eps);
  } else if (dtype == tyt::kFloat32) {
    rmsnorm_bwd_dx_kernel<float><<<rows, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(g), scale,
        static_cast<float*>(dx), d, eps);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
