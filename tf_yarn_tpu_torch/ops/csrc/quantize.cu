// Per-row symmetric int8 quantization:
//   scale = max(absmax(row), 1e-8) * (1/127)
//   value = clip(round_half_even(x / scale), -127, 127)
//
// Replaces the TPU kernel tf_yarn_tpu/ops/quantize.py:_quantize_kernel
// (deterministic rounding; the TPU-only stochastic mode is not ported).
//
// Bound on the H100: memory. Per row of d f32 values it reads 4d bytes and
// writes d + 4 bytes, with a handful of operations per element.
// Design: one warp per row (d = head_dim = 128 on the serving path, four
// values per lane), a butterfly max for absmax, then each lane divides
// and rounds its own values. Bit parity with the reference needs two
// things: a true IEEE division x / scale (the build uses no
// --use_fast_math) and rintf, which rounds half to even like jnp.round
// and torch.round (roundf would round half away from zero). The scale
// itself is absmax times the f32 constant 1/127: XLA folds the
// reference's division by the constant 127 into that multiply, so the
// JAX package's scales carry it, and a division here would differ from
// them in the last bit on about one row in twenty.
#include "common.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr float kInv127 = 1.0f / 127.0f;

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
quantize_int8_kernel(const float* __restrict__ x, int8_t* __restrict__ values,
                     float* __restrict__ scales, int rows, int d) {
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const float* xr = x + static_cast<size_t>(row) * d;
  int8_t* vr = values + static_cast<size_t>(row) * d;

  float absmax = 0.f;
  for (int i = lane; i < d; i += 32) absmax = fmaxf(absmax, fabsf(xr[i]));
  absmax = tyt::warp_max(absmax);
  const float scale = fmaxf(absmax, 1e-8f) * kInv127;

  for (int i = lane; i < d; i += 32) {
    const float q = rintf(xr[i] / scale);
    vr[i] = static_cast<int8_t>(fminf(fmaxf(q, -127.f), 127.f));
  }
  if (lane == 0) scales[row] = scale;
}

}  // namespace

extern "C" int tyt_quantize_int8(const float* x, int8_t* values, float* scales,
                                 int rows, int d, void* stream) {
  if (rows <= 0 || d <= 0) return 0;
  const int blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  quantize_int8_kernel<<<blocks, kWarpsPerBlock * 32, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      x, values, scales, rows, d);
  return static_cast<int>(cudaGetLastError());
}
