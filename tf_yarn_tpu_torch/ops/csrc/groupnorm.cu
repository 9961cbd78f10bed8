// GroupNorm over NHWC slabs, forward and dx. x is [B, HW, C] contiguous
// (channels last); channel c belongs to group c / (C / G); every (image,
// group) is normalised over its HW x C/G elements:
//   forward  y  = (x - mean) * inv * scale + bias,  inv = rsqrt(var + eps),
//            var the biased variance, clamped at 0;
//   dx       dx = inv * (gs - mean(gs) - norm * mean(gs * norm)),
//            gs = g * scale, norm = (x - mean) * inv.
// f32 math, outputs in x's dtype.
//
// Replaces the TPU kernels tf_yarn_tpu/ops/groupnorm.py:_groupnorm_kernel
// and :_groupnorm_bwd_dx_kernel. dscale and dbias are cross-batch sums and
// stay outside, as in the JAX package.
//
// The TPU kernels hold one image's whole [HW, C] slab in VMEM (grid (B,)).
// At ResNet-50 widths a slab reaches 112*112*64 = 802,816 elements (1.6 MB
// in bf16), far above the 227 KB of shared memory a block can have, and
// 128 images would fill barely one wave of the 132 SMs. So each wrapper
// call is two launches over a grid of (row chunk, image) blocks:
//   1. reduce: each block sums two per-element quantities over its chunk
//      of rows for every group and writes the sums as partials
//      [B, chunks, G, 2] (forward: x - shift and its square; dx: gs and
//      gs * norm);
//   2. apply: each block first folds its image's partials into per-group
//      statistics in shared memory, in a fixed order (deterministic: no
//      atomics), then writes its chunk of y (or dx).
// The forward's sums are of x - shift, where shift is the group's first
// element: the variance is E[(x-shift)^2] - E[x-shift]^2, so a large mean
// with a tiny spread loses nothing to cancellation (the TPU kernel's
// unshifted one-pass sums only clamp the negative result). The forward's
// apply blocks of chunk 0 also write each group's (mean, inv) to stats
// [B, G, 2], which the backward reads instead of recomputing them.
//
// Bound on the H100: memory. The forward reads x twice (reduce, apply) and
// writes y once; dx reads x and g twice and writes dx once: 1.5x and
// 1.67x the bytes of the function itself. Threads map to channels (tx)
// and rows (ty), so a thread's channel, group and per-channel constants
// are fixed while it walks down the rows; loads are scalar and coalesced.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

struct Shape {
  int hw, c, groups, rows_per_chunk, chunks;
  __device__ int cg() const { return c / groups; }
  // Threads across channels (tx) and down rows (ty).
  __device__ int tx_count() const { return c < kThreads ? c : kThreads; }
  __device__ int ty_count() const { return kThreads / tx_count(); }
};

// Block (chunk, image) sums q1 and q2 over its rows for every group.
// kBwd = false: q1 = x - shift, q2 = q1^2. kBwd = true: q1 = gs,
// q2 = gs * norm with the forward's (mean, inv) from stats.
template <typename T, bool kBwd>
__global__ void __launch_bounds__(kThreads)
groupnorm_reduce_kernel(const T* __restrict__ x, const T* __restrict__ g,
                        const float* __restrict__ scale,
                        const float* __restrict__ stats,
                        float* __restrict__ partials, Shape s) {
  extern __shared__ float smem[];
  float* group_sums = smem;              // [G, 2]
  float* thread_sums = smem + 2 * s.groups;  // [kThreads, 2]
  const int b = blockIdx.y, chunk = blockIdx.x;
  const int cg = s.cg(), txn = s.tx_count(), tyn = s.ty_count();
  const int tx = threadIdx.x % txn, ty = threadIdx.x / txn;
  const int r0 = chunk * s.rows_per_chunk;
  const int r1 = min(s.hw, r0 + s.rows_per_chunk);
  const size_t base = static_cast<size_t>(b) * s.hw * s.c;
  for (int i = threadIdx.x; i < 2 * s.groups; i += kThreads) {
    group_sums[i] = 0.f;
  }
  for (int c0 = 0; c0 < s.c; c0 += txn) {
    const int c = c0 + tx;
    float q1 = 0.f, q2 = 0.f;
    if (ty < tyn && c < s.c) {
      const int grp = c / cg;
      float shift = 0.f, mean = 0.f, inv = 0.f, sc = 0.f;
      if (kBwd) {
        mean = stats[(b * s.groups + grp) * 2];
        inv = stats[(b * s.groups + grp) * 2 + 1];
        sc = scale[c];
      } else {
        shift = tyt::to_float(x[base + grp * cg]);
      }
#pragma unroll 4
      for (int r = r0 + ty; r < r1; r += tyn) {
        const size_t off = base + static_cast<size_t>(r) * s.c + c;
        if (kBwd) {
          const float gs = tyt::to_float(g[off]) * sc;
          q1 += gs;
          q2 += gs * ((tyt::to_float(x[off]) - mean) * inv);
        } else {
          const float v = tyt::to_float(x[off]) - shift;
          q1 += v;
          q2 += v * v;
        }
      }
    }
    thread_sums[2 * threadIdx.x] = q1;
    thread_sums[2 * threadIdx.x + 1] = q2;
    __syncthreads();
    // Per channel: the column of threads sharing it, summed in order.
    if (ty == 0 && c < s.c) {
      for (int j = 1; j < tyn; ++j) {
        q1 += thread_sums[2 * (j * txn + tx)];
        q2 += thread_sums[2 * (j * txn + tx) + 1];
      }
      thread_sums[2 * tx] = q1;
      thread_sums[2 * tx + 1] = q2;
    }
    __syncthreads();
    // Per group: one thread for each group this channel range touches
    // (at most txn <= kThreads of them), its channels summed in order.
    const int c_end = min(s.c, c0 + txn);
    const int g_first = c0 / cg;
    const int grp = g_first + threadIdx.x;
    if (grp <= (c_end - 1) / cg) {
      float a = 0.f, q = 0.f;
      for (int ch = max(grp * cg, c0); ch < min((grp + 1) * cg, c_end); ++ch) {
        a += thread_sums[2 * (ch - c0)];
        q += thread_sums[2 * (ch - c0) + 1];
      }
      group_sums[2 * grp] += a;
      group_sums[2 * grp + 1] += q;
    }
    __syncthreads();
  }
  float* out = partials + (static_cast<size_t>(b) * s.chunks + chunk) * 2 * s.groups;
  for (int i = threadIdx.x; i < 2 * s.groups; i += kThreads) {
    out[i] = group_sums[i];
  }
}

// Block (chunk, image) folds its image's partials into per-group
// statistics, then writes its rows. kBwd = false: y from (mean, inv),
// and chunk 0 stores them in stats. kBwd = true: dx from the forward's
// stats and the means of gs and gs * norm.
template <typename T, bool kBwd>
__global__ void __launch_bounds__(kThreads)
groupnorm_apply_kernel(const T* __restrict__ x, const T* __restrict__ g,
                       const float* __restrict__ scale,
                       const float* __restrict__ bias,
                       const float* __restrict__ partials,
                       float* __restrict__ stats, T* __restrict__ out,
                       Shape s, float eps) {
  extern __shared__ float smem[];  // [G, 2]
  const int b = blockIdx.y, chunk = blockIdx.x;
  const int cg = s.cg(), txn = s.tx_count(), tyn = s.ty_count();
  const size_t base = static_cast<size_t>(b) * s.hw * s.c;
  const float n = static_cast<float>(s.hw) * static_cast<float>(cg);
  const float* part = partials + static_cast<size_t>(b) * s.chunks * 2 * s.groups;
  for (int grp = threadIdx.x; grp < s.groups; grp += kThreads) {
    float q1 = 0.f, q2 = 0.f;
    for (int k = 0; k < s.chunks; ++k) {
      q1 += part[(k * s.groups + grp) * 2];
      q2 += part[(k * s.groups + grp) * 2 + 1];
    }
    if (kBwd) {
      smem[2 * grp] = q1 / n;  // mean(gs)
      smem[2 * grp + 1] = q2 / n;  // mean(gs * norm)
    } else {
      const float m = q1 / n;  // mean of x - shift
      const float var = fmaxf(q2 / n - m * m, 0.f);
      const float mean = tyt::to_float(x[base + grp * cg]) + m;
      const float inv = rsqrtf(var + eps);
      smem[2 * grp] = mean;
      smem[2 * grp + 1] = inv;
      if (chunk == 0) {
        stats[(b * s.groups + grp) * 2] = mean;
        stats[(b * s.groups + grp) * 2 + 1] = inv;
      }
    }
  }
  __syncthreads();
  const int tx = threadIdx.x % txn, ty = threadIdx.x / txn;
  if (ty >= tyn) return;
  const int r0 = chunk * s.rows_per_chunk;
  const int r1 = min(s.hw, r0 + s.rows_per_chunk);
  for (int c = tx; c < s.c; c += txn) {
    const int grp = c / cg;
    const float sc = scale[c];
    if (kBwd) {
      const float mean = stats[(b * s.groups + grp) * 2];
      const float inv = stats[(b * s.groups + grp) * 2 + 1];
      const float m1 = smem[2 * grp], m2 = smem[2 * grp + 1];
#pragma unroll 4
      for (int r = r0 + ty; r < r1; r += tyn) {
        const size_t off = base + static_cast<size_t>(r) * s.c + c;
        const float gs = tyt::to_float(g[off]) * sc;
        const float norm = (tyt::to_float(x[off]) - mean) * inv;
        out[off] = tyt::from_float<T>(inv * (gs - m1 - norm * m2));
      }
    } else {
      const float mean = smem[2 * grp], inv = smem[2 * grp + 1];
      const float bi = bias[c];
#pragma unroll 4
      for (int r = r0 + ty; r < r1; r += tyn) {
        const size_t off = base + static_cast<size_t>(r) * s.c + c;
        const float norm = (tyt::to_float(x[off]) - mean) * inv;
        out[off] = tyt::from_float<T>(norm * sc + bi);
      }
    }
  }
}

size_t reduce_smem(const Shape& s) {
  return (2 * static_cast<size_t>(s.groups) + 2 * kThreads) * sizeof(float);
}

size_t apply_smem(const Shape& s) {
  return 2 * static_cast<size_t>(s.groups) * sizeof(float);
}

template <typename T>
int forward(const void* x, const float* scale, const float* bias, void* y,
            float* stats, float* partials, int batch, Shape s, float eps,
            cudaStream_t stream) {
  const dim3 grid(s.chunks, batch);
  const T* xt = static_cast<const T*>(x);
  groupnorm_reduce_kernel<T, false><<<grid, kThreads, reduce_smem(s), stream>>>(
      xt, nullptr, nullptr, nullptr, partials, s);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  groupnorm_apply_kernel<T, false><<<grid, kThreads, apply_smem(s), stream>>>(
      xt, nullptr, scale, bias, partials, stats, static_cast<T*>(y), s, eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int backward_dx(const void* x, const void* g, const float* scale,
                const float* stats, void* dx, float* partials, int batch,
                Shape s, cudaStream_t stream) {
  const dim3 grid(s.chunks, batch);
  const T* xt = static_cast<const T*>(x);
  const T* gt = static_cast<const T*>(g);
  groupnorm_reduce_kernel<T, true><<<grid, kThreads, reduce_smem(s), stream>>>(
      xt, gt, scale, stats, partials, s);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  groupnorm_apply_kernel<T, true><<<grid, kThreads, apply_smem(s), stream>>>(
      xt, gt, scale, nullptr, partials, const_cast<float*>(stats),
      static_cast<T*>(dx), s, 0.f);
  return static_cast<int>(cudaGetLastError());
}

bool valid(int batch, const Shape& s) {
  return batch > 0 && batch <= 65535 && s.hw > 0 && s.c > 0 && s.groups > 0 &&
         s.c % s.groups == 0 && s.rows_per_chunk > 0 &&
         s.chunks == (s.hw + s.rows_per_chunk - 1) / s.rows_per_chunk &&
         reduce_smem(s) <= 48 * 1024;
}

}  // namespace

// x, y [B, HW, C] in x's dtype; scale, bias [C] f32; stats [B, G, 2] f32
// (written: mean, inv); partials [B, chunks, G, 2] f32 scratch.
extern "C" int tyt_groupnorm(const void* x, const float* scale,
                             const float* bias, void* y, float* stats,
                             float* partials, int batch, int hw, int c,
                             int groups, int rows_per_chunk, int chunks,
                             float eps, int dtype, void* stream) {
  const Shape s{hw, c, groups, rows_per_chunk, chunks};
  if (!valid(batch, s)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == tyt::kBFloat16) {
    return forward<__nv_bfloat16>(x, scale, bias, y, stats, partials, batch,
                                  s, eps, st);
  }
  if (dtype == tyt::kFloat32) {
    return forward<float>(x, scale, bias, y, stats, partials, batch, s, eps,
                          st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// g (the cotangent of y) and dx have x's dtype; stats are the forward's.
extern "C" int tyt_groupnorm_bwd_dx(const void* x, const void* g,
                                    const float* scale, const float* stats,
                                    void* dx, float* partials, int batch,
                                    int hw, int c, int groups,
                                    int rows_per_chunk, int chunks, int dtype,
                                    void* stream) {
  const Shape s{hw, c, groups, rows_per_chunk, chunks};
  if (!valid(batch, s)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == tyt::kBFloat16) {
    return backward_dx<__nv_bfloat16>(x, g, scale, stats, dx, partials, batch,
                                      s, st);
  }
  if (dtype == tyt::kFloat32) {
    return backward_dx<float>(x, g, scale, stats, dx, partials, batch, s, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
