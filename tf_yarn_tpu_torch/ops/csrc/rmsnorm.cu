// RMSNorm forward, y = x * rsqrt(mean(x^2) + eps) * scale, and its dx,
// dx = r*(g*s) - x*r^3*mean(g*s*x) with r = rsqrt(mean(x^2) + eps); f32
// math, outputs in x's dtype.
//
// Replaces the TPU kernels tf_yarn_tpu/ops/rmsnorm.py:_rmsnorm_kernel
// and :_rmsnorm_bwd_dx_kernel (launched through
// ops/_rowwise.py:rowwise_call). dscale = sum over rows of g*x*r is a
// cross-row reduction and stays outside, as in the JAX package.
//
// Bound on the H100: memory. Per row of d elements the forward reads x
// once and writes y once (2 * 2d bytes in bf16) against ~4d f32
// operations, far below the card's ~20 flops/byte balance point for f32
// CUDA-core math; scale (4d bytes) is shared by every row and lives in
// L2/L1.
//
// Forward: the row held in registers, read once in 16-byte loads. Where
// the row is a whole number (1-8) of 16-byte vectors for each of its
// threads and the tensors are 16-byte aligned, rmsnorm_row_kernel has
// each thread issue all its x vectors and its scale float4s (__ldg)
// before any arithmetic, sum x^2 from registers, then scale, pack and
// write y with 16-byte stores. Thread t of a row holds vectors t, t + n,
// ... (n threads a row), so a warp instruction moves 512 contiguous
// bytes. The kernel is templated on the vectors a thread holds, so d is
// a constant and nothing loops at run time. Two layouts, chosen by
// shape and alignment alone:
//   - a warp a row, kRowWarps rows a block, for d up to 2048 in bf16 and
//     1024 in f32: the sum is a warp butterfly, with no barrier;
//   - a block of kBlockThreads threads a row (Llama-3-8B's d 4096): each
//     warp's butterfly sum goes to shared memory, and after a single
//     barrier every thread adds the kBlockThreads / 32 partials in warp
//     order, so all threads hold the same, deterministic total.
//     Of 128, 256 and 512 threads, 512 was fastest at a decode tick's 4
//     rows and level at 2048 (PERF.md §6); blocks that held 2 or 4 rows
//     and read scale once for them were slower with x out of L2.
// Every other width, and unaligned tensors, take rmsnorm_kernel: a block
// of 256 threads a row, scalar loads in a strided loop for the sum, the
// same one-barrier reduction, and a second strided pass that finds the
// row in L1/L2. Two calls give bitwise-equal outputs on every path.
//
// dx is bound the same way (x and g read once, dx written once); its
// block of 256 threads takes both row reductions (x^2 and g*s*x) in one
// strided pass and writes dx in a second.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;       // the looped kernels' block
constexpr int kRowWarps = 4;        // rows a block, a warp a row
constexpr int kBlockThreads = 512;  // threads a row, a block a row

// The sum of v over a block of kWarps warps, in every thread: one
// barrier, then each thread adds the warps' partials in warp order.
template <int kWarps>
__device__ __forceinline__ float block_sum(float v, float* partial) {
  v = tyt::warp_sum(v);
  if ((threadIdx.x & 31) == 0) partial[threadIdx.x >> 5] = v;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) total += partial[w];
  return total;
}

// kRowThreads threads hold one row of kNV 16-byte vectors each: a warp
// (kRowThreads 32, kRowWarps rows a block) or a whole block.
template <typename T, int kNV, int kRowThreads>
__global__ void __launch_bounds__(kRowThreads == 32 ? kRowWarps * 32
                                                    : kRowThreads)
rmsnorm_row_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                   T* __restrict__ y, int rows, float eps) {
  constexpr int kVec = tyt::Vec16<T>::kVec;
  constexpr int kD = kNV * kRowThreads * kVec;
  constexpr int kWarps = kRowThreads / 32;
  const int t = kWarps == 1 ? (threadIdx.x & 31) : threadIdx.x;
  const int row = kWarps == 1 ? blockIdx.x * kRowWarps + (threadIdx.x >> 5)
                              : blockIdx.x;
  if (row >= rows) return;  // a whole warp, or a whole block
  const size_t off = static_cast<size_t>(row) * kD + t * kVec;

  uint4 xv[kNV];
  float4 sv[kNV][kVec / 4];
#pragma unroll
  for (int k = 0; k < kNV; ++k) {
    xv[k] = tyt::load16(x + off + k * kRowThreads * kVec);
  }
#pragma unroll
  for (int k = 0; k < kNV; ++k) {
#pragma unroll
    for (int j = 0; j < kVec / 4; ++j) {
      sv[k][j] = __ldg(reinterpret_cast<const float4*>(
                           scale + (k * kRowThreads + t) * kVec) + j);
    }
  }

  float sum = 0.f;
#pragma unroll
  for (int k = 0; k < kNV; ++k) {
    float v[kVec];
    tyt::unpack(xv[k], v);
#pragma unroll
    for (int j = 0; j < kVec; ++j) sum += v[j] * v[j];
  }
  if constexpr (kWarps == 1) {
    sum = tyt::warp_sum(sum);
  } else {
    __shared__ float partial[kWarps];
    sum = block_sum<kWarps>(sum, partial);
  }
  const float r = rsqrtf(sum / static_cast<float>(kD) + eps);

#pragma unroll
  for (int k = 0; k < kNV; ++k) {
    float v[kVec];
    tyt::unpack(xv[k], v);
#pragma unroll
    for (int j = 0; j < kVec / 4; ++j) {
      v[4 * j] = v[4 * j] * r * sv[k][j].x;
      v[4 * j + 1] = v[4 * j + 1] * r * sv[k][j].y;
      v[4 * j + 2] = v[4 * j + 2] * r * sv[k][j].z;
      v[4 * j + 3] = v[4 * j + 3] * r * sv[k][j].w;
    }
    tyt::store16(y + off + k * kRowThreads * kVec, tyt::pack(v));
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rmsnorm_kernel(const T* __restrict__ x, const float* __restrict__ scale,
               T* __restrict__ y, int d, float eps) {
  __shared__ float partial[kThreads / 32];
  const T* xr = x + static_cast<size_t>(blockIdx.x) * d;
  T* yr = y + static_cast<size_t>(blockIdx.x) * d;

  float sum = 0.f;
  for (int i = threadIdx.x; i < d; i += kThreads) {
    const float v = tyt::to_float(xr[i]);
    sum += v * v;
  }
  sum = block_sum<kThreads / 32>(sum, partial);
  const float r = rsqrtf(sum / static_cast<float>(d) + eps);

  for (int i = threadIdx.x; i < d; i += kThreads) {
    const float v = tyt::to_float(xr[i]);
    yr[i] = tyt::from_float<T>(v * r * scale[i]);
  }
}

template <typename T, int kNV, int kRowThreads>
void launch_rows(const void* x, const float* scale, void* y, int rows,
                 float eps, cudaStream_t s) {
  const int per_block = kRowThreads == 32 ? kRowWarps : 1;
  rmsnorm_row_kernel<T, kNV, kRowThreads>
      <<<(rows + per_block - 1) / per_block, per_block * kRowThreads, 0, s>>>(
          static_cast<const T*>(x), scale, static_cast<T*>(y), rows, eps);
}

// The row kernel with kRowThreads threads a row where d is 1-8 16-byte
// vectors a thread; false where it is not.
template <typename T, int kRowThreads>
bool forward_rows(const void* x, const float* scale, void* y, int rows,
                  int d, float eps, cudaStream_t s) {
  constexpr int kRowElems = kRowThreads * tyt::Vec16<T>::kVec;
  if (d % kRowElems != 0) return false;
  switch (d / kRowElems) {
    case 1: launch_rows<T, 1, kRowThreads>(x, scale, y, rows, eps, s); break;
    case 2: launch_rows<T, 2, kRowThreads>(x, scale, y, rows, eps, s); break;
    case 3: launch_rows<T, 3, kRowThreads>(x, scale, y, rows, eps, s); break;
    case 4: launch_rows<T, 4, kRowThreads>(x, scale, y, rows, eps, s); break;
    case 5: launch_rows<T, 5, kRowThreads>(x, scale, y, rows, eps, s); break;
    case 6: launch_rows<T, 6, kRowThreads>(x, scale, y, rows, eps, s); break;
    case 7: launch_rows<T, 7, kRowThreads>(x, scale, y, rows, eps, s); break;
    case 8: launch_rows<T, 8, kRowThreads>(x, scale, y, rows, eps, s); break;
    default: return false;
  }
  return true;
}

// A warp a row, else a block a row, where the tensors are 16-byte
// aligned and d fits; else the looped kernel.
template <typename T>
int forward(const void* x, const float* scale, void* y, int rows, int d,
            float eps, cudaStream_t s) {
  const bool aligned = tyt::aligned_to(x, 16) && tyt::aligned_to(scale, 16) &&
                       tyt::aligned_to(y, 16);
  if (!aligned || (!forward_rows<T, 32>(x, scale, y, rows, d, eps, s) &&
                   !forward_rows<T, kBlockThreads>(x, scale, y, rows, d, eps,
                                                   s))) {
    rmsnorm_kernel<T><<<rows, kThreads, 0, s>>>(
        static_cast<const T*>(x), scale, static_cast<T*>(y), d, eps);
  }
  return static_cast<int>(cudaGetLastError());
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
    return forward<__nv_bfloat16>(x, scale, y, rows, d, eps, s);
  }
  if (dtype == tyt::kFloat32) {
    return forward<float>(x, scale, y, rows, d, eps, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
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
