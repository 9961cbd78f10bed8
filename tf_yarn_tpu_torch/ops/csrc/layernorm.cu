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
// and writes dx (6d bytes) against ~14d.
//
// Forward: one warp per row (BERT-base and ViT-B/16 rows are 768 wide: 24
// elements a lane), eight rows a block, so each reduction is a warp
// shuffle with no shared memory and no block barrier. The TPU kernel
// holds its row block in VMEM; here the first pass reads the row from
// device memory and the later passes (the centred squares, then the
// output) find it in L1. Loads are scalar and coalesced.
//
// dx (layernorm_bwd_dx_row_kernel): each warp holds its row in registers.
// Where a row is a whole number (1-8) of 16-byte vectors for each lane
// (d a multiple of 256 in bf16, of 128 in f32, up to 2048 and 1024; d 768
// in bf16 is 3 vectors a lane for x and 3 for g) and the tensors are
// 16-byte aligned, a lane loads all its x and g vectors before the first
// use, then computes the mean, the centred squares, sum(gs) and
// sum(gs * c) from registers (scale as float4 from L1) and writes dx
// with 16-byte stores: one read of x and g, one write of dx, and two
// rounds of warp shuffles (the mean; the three sums together). The
// kernel is templated on the vectors a lane holds, so d is a constant
// and nothing is looped at run time. Other widths (771 in
// the tests) take layernorm_bwd_dx_kernel, the three passes of the
// forward's design: 16-byte loads where the row is a whole number of
// vectors and aligned, scalar ones otherwise. The entry point picks by
// shape and alignment alone.
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

// Three passes over the row: the sum, then the centred squares and the
// g sums, then dx. kVec16: 16-byte loads (d a multiple of the vector and
// the tensors aligned), else scalar ones.
template <typename T, bool kVec16>
__global__ void __launch_bounds__(kThreads)
layernorm_bwd_dx_kernel(const T* __restrict__ x, const T* __restrict__ g,
                        const float* __restrict__ scale, T* __restrict__ dx,
                        int rows, int d, float eps) {
  constexpr int kVec = kVec16 ? tyt::Vec16<T>::kVec : 1;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  const size_t off = static_cast<size_t>(row) * d;
  const float inv_d = 1.f / static_cast<float>(d);
  const int n = d / kVec;
  // Elements [i * kVec, (i + 1) * kVec) of the row as floats.
  auto load = [&](const T* base, int i, float (&f)[kVec]) {
    if constexpr (kVec16) {
      tyt::unpack(tyt::load16(base + off + i * kVec), f);
    } else {
      f[0] = tyt::to_float(base[off + i]);
    }
  };
  auto load_scale = [&](int i, float (&f)[kVec]) {
    if constexpr (kVec16) {
#pragma unroll
      for (int j = 0; j < kVec; j += 4) {
        const float4 s =
            __ldg(reinterpret_cast<const float4*>(scale + i * kVec + j));
        f[j] = s.x;
        f[j + 1] = s.y;
        f[j + 2] = s.z;
        f[j + 3] = s.w;
      }
    } else {
      f[0] = scale[i];
    }
  };

  float sum = 0.f;
#pragma unroll 4
  for (int i = lane; i < n; i += 32) {
    float v[kVec];
    load(x, i, v);
#pragma unroll
    for (int j = 0; j < kVec; ++j) sum += v[j];
  }
  const float mean = tyt::warp_sum(sum) * inv_d;
  // One pass for the three sums that need the mean: the centred squares,
  // gs, and gs times the centred x (mean(gs * norm) = r * mean(gs * c)).
  float sq = 0.f, sum_gs = 0.f, sum_gsc = 0.f;
#pragma unroll 2
  for (int i = lane; i < n; i += 32) {
    float v[kVec], gv[kVec], sc[kVec];
    load(x, i, v);
    load(g, i, gv);
    load_scale(i, sc);
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const float c = v[j] - mean;
      const float gs = gv[j] * sc[j];
      sq += c * c;
      sum_gs += gs;
      sum_gsc += gs * c;
    }
  }
  const float r = rsqrtf(tyt::warp_sum(sq) * inv_d + eps);
  const float mean_gs = tyt::warp_sum(sum_gs) * inv_d;
  const float mean_gs_norm = tyt::warp_sum(sum_gsc) * inv_d * r;
#pragma unroll 2
  for (int i = lane; i < n; i += 32) {
    float v[kVec], gv[kVec], sc[kVec];
    load(x, i, v);
    load(g, i, gv);
    load_scale(i, sc);
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const float norm = (v[j] - mean) * r;
      v[j] = r * (gv[j] * sc[j] - mean_gs - norm * mean_gs_norm);
    }
    if constexpr (kVec16) {
      tyt::store16(dx + off + i * kVec, tyt::pack(v));
    } else {
      dx[off + i] = tyt::from_float<T>(v[0]);
    }
  }
}

// The row held in registers: lane l holds vectors l, l + 32, ... (kNV of
// them) of x and g, so a warp instruction moves 512 contiguous bytes.
// Only the raw vectors stay live: each pass unpacks them again, four
// elements at a time, and reads its scale vectors from L1 (3 KB, shared
// by every row). One row a warp, two warps a block.
constexpr int kRowWarps = 2;
constexpr int kMaxRowVectors = 8;

// Elements [4q, 4q + 4) of a 16-byte vector of T as floats, and back;
// the row kernel works four elements at a time to keep few registers live.
template <typename T>
__device__ __forceinline__ void get4(const uint4& u, int q, float (&f)[4]);
template <>
__device__ __forceinline__ void get4<float>(const uint4& u, int,
                                           float (&f)[4]) {
  tyt::unpack(u, f);
}
template <>
__device__ __forceinline__ void get4<__nv_bfloat16>(const uint4& u, int q,
                                                    float (&f)[4]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
  const float2 lo = __bfloat1622float2(h[2 * q]);
  const float2 hi = __bfloat1622float2(h[2 * q + 1]);
  f[0] = lo.x;
  f[1] = lo.y;
  f[2] = hi.x;
  f[3] = hi.y;
}

template <typename T>
__device__ __forceinline__ void put4(uint4& u, int q, const float (&f)[4]);
template <>
__device__ __forceinline__ void put4<float>(uint4& u, int,
                                           const float (&f)[4]) {
  u = tyt::pack(f);
}
template <>
__device__ __forceinline__ void put4<__nv_bfloat16>(uint4& u, int q,
                                                    const float (&f)[4]) {
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
  h[2 * q] = __floats2bfloat162_rn(f[0], f[1]);
  h[2 * q + 1] = __floats2bfloat162_rn(f[2], f[3]);
}

__device__ __forceinline__ void get4_scale(const float* scale, int i,
                                           float (&f)[4]) {
  const float4 s = __ldg(reinterpret_cast<const float4*>(scale + i));
  f[0] = s.x;
  f[1] = s.y;
  f[2] = s.z;
  f[3] = s.w;
}

template <typename T, int kNV>
__global__ void __launch_bounds__(kRowWarps * 32)
layernorm_bwd_dx_row_kernel(const T* __restrict__ x, const T* __restrict__ g,
                            const float* __restrict__ scale,
                            T* __restrict__ dx, int rows, float eps) {
  constexpr int kVec = tyt::Vec16<T>::kVec;
  constexpr int kD = kNV * 32 * kVec;
  constexpr float kInvD = 1.f / static_cast<float>(kD);
  const int row = blockIdx.x * kRowWarps + (threadIdx.x >> 5);
  if (row >= rows) return;  // the whole warp leaves together
  const int lane = threadIdx.x & 31;
  const size_t off = static_cast<size_t>(row) * kD + lane * kVec;

  uint4 xv[kNV], gv[kNV];
#pragma unroll
  for (int k = 0; k < kNV; ++k) {
    xv[k] = tyt::load16(x + off + k * 32 * kVec);
    gv[k] = tyt::load16(g + off + k * 32 * kVec);
  }

  float sum = 0.f;
#pragma unroll
  for (int k = 0; k < kNV; ++k) {
#pragma unroll
    for (int q = 0; q < kVec / 4; ++q) {
      float v[4];
      get4<T>(xv[k], q, v);
      sum += (v[0] + v[1]) + (v[2] + v[3]);
    }
  }
  const float mean = tyt::warp_sum(sum) * kInvD;
  // The centred squares, gs and gs times the centred x, as the loop
  // kernel: mean(gs * norm) = r * mean(gs * c).
  float sq = 0.f, sum_gs = 0.f, sum_gsc = 0.f;
#pragma unroll
  for (int k = 0; k < kNV; ++k) {
#pragma unroll
    for (int q = 0; q < kVec / 4; ++q) {
      float v[4], gs[4], sc[4];
      get4<T>(xv[k], q, v);
      get4<T>(gv[k], q, gs);
      get4_scale(scale, (k * 32 + lane) * kVec + 4 * q, sc);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float c = v[j] - mean;
        const float gsj = gs[j] * sc[j];
        sq += c * c;
        sum_gs += gsj;
        sum_gsc += gsj * c;
      }
    }
  }
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
    sq += __shfl_xor_sync(0xffffffffu, sq, offset);
    sum_gs += __shfl_xor_sync(0xffffffffu, sum_gs, offset);
    sum_gsc += __shfl_xor_sync(0xffffffffu, sum_gsc, offset);
  }
  const float r = rsqrtf(sq * kInvD + eps);
  const float mean_gs = sum_gs * kInvD;
  const float mean_gs_norm = sum_gsc * kInvD * r;
#pragma unroll
  for (int k = 0; k < kNV; ++k) {
    uint4 out;
#pragma unroll
    for (int q = 0; q < kVec / 4; ++q) {
      float v[4], gs[4], sc[4];
      get4<T>(xv[k], q, v);
      get4<T>(gv[k], q, gs);
      get4_scale(scale, (k * 32 + lane) * kVec + 4 * q, sc);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float norm = (v[j] - mean) * r;
        v[j] = r * (gs[j] * sc[j] - mean_gs - norm * mean_gs_norm);
      }
      put4<T>(out, q, v);
    }
    tyt::store16(dx + off + k * 32 * kVec, out);
  }
}

template <typename T, int kNV>
int launch_dx_rows(const void* x, const void* g, const float* scale, void* dx,
                   int rows, float eps, cudaStream_t s) {
  layernorm_bwd_dx_row_kernel<T, kNV>
      <<<(rows + kRowWarps - 1) / kRowWarps, kRowWarps * 32, 0, s>>>(
          static_cast<const T*>(x), static_cast<const T*>(g), scale,
          static_cast<T*>(dx), rows, eps);
  return static_cast<int>(cudaGetLastError());
}

int blocks_for(int rows) { return (rows + kWarps - 1) / kWarps; }

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// The row kernel where d is kNV (1-8) 16-byte vectors a lane and the
// tensors are aligned; else the loop kernel, with 16-byte loads where the
// row is whole vectors and aligned.
template <typename T>
int backward_dx(const void* x, const void* g, const float* scale, void* dx,
                int rows, int d, float eps, cudaStream_t s) {
  constexpr int kVec = tyt::Vec16<T>::kVec;
  const bool aligned = aligned16(x) && aligned16(g) && aligned16(scale) &&
                       aligned16(dx);
  const int nv = d / (32 * kVec);
  if (aligned && d % (32 * kVec) == 0 && nv <= kMaxRowVectors) {
    switch (nv) {
      case 1: return launch_dx_rows<T, 1>(x, g, scale, dx, rows, eps, s);
      case 2: return launch_dx_rows<T, 2>(x, g, scale, dx, rows, eps, s);
      case 3: return launch_dx_rows<T, 3>(x, g, scale, dx, rows, eps, s);
      case 4: return launch_dx_rows<T, 4>(x, g, scale, dx, rows, eps, s);
      case 5: return launch_dx_rows<T, 5>(x, g, scale, dx, rows, eps, s);
      case 6: return launch_dx_rows<T, 6>(x, g, scale, dx, rows, eps, s);
      case 7: return launch_dx_rows<T, 7>(x, g, scale, dx, rows, eps, s);
      case 8: return launch_dx_rows<T, 8>(x, g, scale, dx, rows, eps, s);
    }
  }
  const T* xt = static_cast<const T*>(x);
  const T* gt = static_cast<const T*>(g);
  T* out = static_cast<T*>(dx);
  if (aligned && d % kVec == 0) {
    layernorm_bwd_dx_kernel<T, true><<<blocks_for(rows), kThreads, 0, s>>>(
        xt, gt, scale, out, rows, d, eps);
  } else {
    layernorm_bwd_dx_kernel<T, false><<<blocks_for(rows), kThreads, 0, s>>>(
        xt, gt, scale, out, rows, d, eps);
  }
  return static_cast<int>(cudaGetLastError());
}

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
    return backward_dx<__nv_bfloat16>(x, g, scale, dx, rows, d, eps, s);
  }
  if (dtype == tyt::kFloat32) {
    return backward_dx<float>(x, g, scale, dx, rows, d, eps, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
