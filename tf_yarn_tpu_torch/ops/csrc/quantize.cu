// Per-row symmetric int8 quantization of f32 or bf16 input:
//   scale = max(absmax(row), 1e-8) * (1/127)
//   value = clip(round_half_even(x / scale), -127, 127)
//
// Replaces the TPU kernel tf_yarn_tpu/ops/quantize.py:_quantize_kernel
// (deterministic rounding; the TPU-only stochastic mode is not ported).
// Like it, the kernel takes x in its own dtype and converts each element
// to f32 in registers (x_ref[...].astype(jnp.float32)): bf16 -> f32 is
// exact, so a bf16 row gives the codes and scale of its f32 copy, with no
// cast launched before the kernel.
//
// Bound on the H100: memory. Per row of d values it reads d * 4 (f32) or
// d * 2 (bf16) bytes and writes d + 4, with a handful of operations per
// element.
// Design: one warp per row, eight rows a block (four timed the same).
// At d = 128 (head_dim, the serving path), quantize_int8_row_kernel
// holds the row in registers: lane l loads elements [4l, 4l + 4) in one
// 16-byte (f32) or 8-byte (bf16) load, a butterfly max gives absmax, and
// the lane packs its four codes into one 4-byte store (128 bytes a
// warp); lane 0 writes the scale. Other widths
// take quantize_int8_kernel: two strided passes over the row (absmax,
// then the codes; the second finds the row in L1), four elements a load
// and one 4-byte store where d is a multiple of 4 and the tensors are
// aligned, one element at a time otherwise.
//
// Bit parity with the reference needs two things: a true IEEE division
// x / scale (the build uses no --use_fast_math) and rintf, which rounds
// half to even like jnp.round and torch.round (roundf would round half
// away from zero). The scale itself is absmax times the f32 constant
// 1/127: XLA folds the reference's division by the constant 127 into that
// multiply, so the JAX package's scales carry it, and a division here
// would differ from them in the last bit on about one row in twenty.
#include "common.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kRowD = 128;  // the row kernel's width: 4 elements a lane
constexpr float kInv127 = 1.0f / 127.0f;

// Elements [0, 4) from p as floats: one 16-byte load of f32, one 8-byte
// load of bf16.
__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
  const float2 lo = __bfloat1622float2(h[0]);
  const float2 hi = __bfloat1622float2(h[1]);
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

__device__ __forceinline__ float absmax4(const float4& v) {
  return fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)), fmaxf(fabsf(v.z), fabsf(v.w)));
}

__device__ __forceinline__ uint32_t code(float v, float scale) {
  const float q = fminf(fmaxf(rintf(v / scale), -127.f), 127.f);
  return static_cast<uint8_t>(static_cast<int8_t>(q));
}

// Four codes in one little-endian word: element 0 in the low byte.
__device__ __forceinline__ uint32_t codes4(const float4& v, float scale) {
  return code(v.x, scale) | code(v.y, scale) << 8 | code(v.z, scale) << 16 |
         code(v.w, scale) << 24;
}

__device__ __forceinline__ int warp_row(int rows) {
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  return row < rows ? row : -1;
}

template <typename T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
quantize_int8_row_kernel(const T* __restrict__ x, int8_t* __restrict__ values,
                         float* __restrict__ scales, int rows) {
  const int row = warp_row(rows);
  if (row < 0) return;  // the whole warp leaves together
  const int lane = threadIdx.x & 31;
  const size_t off = static_cast<size_t>(row) * kRowD + lane * 4;
  const float4 v = load4(x + off);
  const float scale = fmaxf(tyt::warp_max(absmax4(v)), 1e-8f) * kInv127;
  *reinterpret_cast<uint32_t*>(values + off) = codes4(v, scale);
  if (lane == 0) scales[row] = scale;
}

// kVec4: d a multiple of 4 and the tensors aligned for four elements a
// load and four codes a store.
template <typename T, bool kVec4>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
quantize_int8_kernel(const T* __restrict__ x, int8_t* __restrict__ values,
                     float* __restrict__ scales, int rows, int d) {
  const int row = warp_row(rows);
  if (row < 0) return;
  const int lane = threadIdx.x & 31;
  const T* xr = x + static_cast<size_t>(row) * d;
  int8_t* vr = values + static_cast<size_t>(row) * d;

  float absmax = 0.f;
  if constexpr (kVec4) {
    for (int i = 4 * lane; i < d; i += 128) {
      absmax = fmaxf(absmax, absmax4(load4(xr + i)));
    }
  } else {
    for (int i = lane; i < d; i += 32) {
      absmax = fmaxf(absmax, fabsf(tyt::to_float(xr[i])));
    }
  }
  const float scale = fmaxf(tyt::warp_max(absmax), 1e-8f) * kInv127;

  if constexpr (kVec4) {
    for (int i = 4 * lane; i < d; i += 128) {
      *reinterpret_cast<uint32_t*>(vr + i) = codes4(load4(xr + i), scale);
    }
  } else {
    for (int i = lane; i < d; i += 32) {
      vr[i] = static_cast<int8_t>(code(tyt::to_float(xr[i]), scale));
    }
  }
  if (lane == 0) scales[row] = scale;
}

template <typename T>
int quantize(const void* x, int8_t* values, float* scales, int rows, int d,
             cudaStream_t s) {
  const int blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const int threads = kWarpsPerBlock * 32;
  const T* xt = static_cast<const T*>(x);
  const bool vec4 = d % 4 == 0 && tyt::aligned_to(x, 4 * sizeof(T)) &&
                    tyt::aligned_to(values, 4);
  if (vec4 && d == kRowD) {
    quantize_int8_row_kernel<T><<<blocks, threads, 0, s>>>(xt, values, scales,
                                                           rows);
  } else if (vec4) {
    quantize_int8_kernel<T, true><<<blocks, threads, 0, s>>>(
        xt, values, scales, rows, d);
  } else {
    quantize_int8_kernel<T, false><<<blocks, threads, 0, s>>>(
        xt, values, scales, rows, d);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x [rows, d] in f32 or bf16 (`dtype`, tyt::DType); values [rows, d]
// int8; scales [rows] f32.
extern "C" int tyt_quantize_int8(const void* x, int8_t* values, float* scales,
                                 int rows, int d, int dtype, void* stream) {
  if (rows <= 0 || d <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == tyt::kBFloat16) {
    return quantize<__nv_bfloat16>(x, values, scales, rows, d, s);
  }
  if (dtype == tyt::kFloat32) {
    return quantize<float>(x, values, scales, rows, d, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
