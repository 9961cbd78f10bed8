// RMSNorm forward: y = x * rsqrt(mean(x^2) + eps) * scale, f32 math,
// output in x's dtype.
//
// Replaces the TPU kernel tf_yarn_tpu/ops/rmsnorm.py:_rmsnorm_kernel
// (launched through ops/_rowwise.py:rowwise_call).
//
// Bound on the H100: memory. Per row of d elements it reads x once and
// writes y once (2 * 2d bytes in bf16) against ~4d f32 operations, far
// below the card's ~20 flops/byte balance point for f32 CUDA-core math.
// Design: one block of 256 threads per row; each thread accumulates a
// strided slice of x^2 in f32, a warp-shuffle then shared-memory
// reduction gives the row's sum, and a second strided pass (the row, at
// most a few KB, is served from L1/L2) writes y. Loads are scalar and
// coalesced; 16-byte vector loads are the first step of a faster version.
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
