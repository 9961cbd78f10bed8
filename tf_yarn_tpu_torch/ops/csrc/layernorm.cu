// LayerNorm forward, y = (x - mean) * rsqrt(var + eps) * scale + bias with
// the two-pass variance var = mean((x - mean)^2), and its backward,
// dx = r * (gs - mean(gs) - norm * mean(gs * norm)), gs = g * scale,
// norm = (x - mean) * r, dscale = sum over rows of g * norm and dbias =
// sum of g; f32 math, y and dx in x's dtype, dscale and dbias f32.
//
// Replaces the TPU kernels tf_yarn_tpu/ops/layernorm.py:_layernorm_kernel
// and :_layernorm_bwd_dx_kernel (launched through
// ops/_rowwise.py:rowwise_call), and the XLA sums of dscale and dbias
// beside the latter (layernorm.py:102-111).
//
// Bound on the H100: memory. The forward reads x once and writes y once
// (4d bytes a row in bf16) against ~8d f32 operations; the backward reads
// x and g and writes dx (6d bytes) against ~18d.
//
// Forward: one warp a row, so each reduction is a warp shuffle with no
// shared memory and no block barrier. The TPU kernel holds its row block
// in VMEM; here layernorm_row_kernel holds the row in registers where it
// is a whole number (1-8) of 16-byte vectors for each lane (d a multiple
// of 256 in bf16, of 128 in f32, up to 2048 and 1024; BERT-base's and
// ViT-B/16's d 768 is 3 vectors a lane in bf16, 6 in f32) and x, y,
// scale and bias are 16-byte aligned: a lane issues its x vectors and its
// scale and bias float4s (__ldg) before the first use, takes the mean
// with one warp sum and the centred squares from registers with a second,
// and writes y with 16-byte stores: one read of x, one write of y. Lane l
// holds vectors l, l + 32, ..., so a warp instruction moves 512
// contiguous bytes; the kernel is templated on the vectors a lane holds,
// so d is a constant. The grid is persistent: as many blocks of
// kFwdRowWarps warps as fit on the card at once, each warp taking every
// (kFwdRowWarps * gridDim.x)-th row with scale and bias kept in registers
// across its rows, and loading its next row's x before it reduces the
// current one, so the next row's read overlaps this one's arithmetic and
// write. A block a row group (one row a warp, no loop) ran 6.4-6.5 us at
// BERT-base's [4096, 768] against 5.0 for this, and 30 against 29 at
// ViT-B/16's [25216, 768]; without the prefetch, 5.6 and 29.7; 4 and 8
// warps a block level (PERF.md §6). Every other width (d 64 of
// the tiny configs, 771 in the tests) and unaligned tensors take
// layernorm_kernel, eight rows a block, three strided passes of scalar
// loads: the sum, the centred squares and the output, the later two
// finding the row in L1. The entry point picks by shape and alignment
// alone; either way one launch, and each row's arithmetic does not
// depend on the grid, so two calls give the same bits.
//
// dx alone (layernorm_bwd_dx_row_kernel; the backward of a frozen scale
// and bias): each warp holds its row in registers. Where a row is a whole
// number (1-8) of 16-byte vectors for each lane (d a multiple of 256 in
// bf16, of 128 in f32, up to 2048 and 1024; d 768 in bf16 is 3 vectors a
// lane for x and 3 for g) and the tensors are 16-byte aligned, a lane
// loads all its x and g vectors before the first use, then computes the
// mean, the centred squares, sum(gs) and sum(gs * c) from registers
// (scale as float4 from L1) and writes dx with 16-byte stores: one read
// of x and g, one write of dx, and two rounds of warp shuffles (the mean;
// the three sums together). The kernel is templated on the vectors a
// lane holds, so d is a constant and nothing is looped at run time.
// Other widths (771 in the tests) take layernorm_bwd_dx_kernel, the three
// passes of the forward's design: 16-byte loads where the row is a whole
// number of vectors and aligned, scalar ones otherwise. The entry point
// picks by shape and alignment alone.
//
// The whole backward (layernorm_bwd_row_kernel, layernorm_bwd_loop_kernel,
// then layernorm_param_grads_kernel): dscale and dbias are sums over every
// row, which no block sees. A fixed grid of P blocks of 8 warps (P from
// the shape and the card's SM count alone, ops/layernorm.py:
// layernorm_bwd_blocks: 4 rows a warp or more, at most 2 blocks an SM)
// walks the rows, each warp every (8P)-th row, so the same read of x and
// g that gives dx also gives each column's sum g * norm and sum g:
//   1. the row kernel is the dx kernel's design, persistent: a lane adds
//      g * norm (norm as dx uses it) and g for the columns it owns (those
//      of its vectors) into its warp's slice of shared memory, laid out
//      [quantity][element][lane] so a warp's accesses fall in 32 banks;
//      in registers the 48 sums of d 768 would push the kernel past 128
//      registers and so to one block (8 warps) an SM. Up to 3 vectors a
//      lane, a warp loads its next row before it reduces the current one.
//      Then one barrier, and each thread adds a column's 8 warp sums in
//      warp order;
//   2. the loop kernel (any other width, or unaligned tensors) keeps the
//      dx kernel's three passes a row; each 8-row step the block's
//      threads then take columns, each adding its columns' g * norm and g
//      over the step's rows in order into shared memory, from the rows'
//      (mean, r) and x and g found again in L1;
//   3. each block writes its sums as f32 partials [P, d, 2], and a second
//      launch adds the P rows in order (param_grads.cuh, the GroupNorm
//      backward's sum). No float atomics: dx, dscale and dbias are
//      bitwise equal over two calls. The partials move P * d * 8 bytes
//      twice, small against x and g while P stays near the SM count.
// Without dx (a frozen x) the same kernels skip dx's sums and stores.
#include "common.cuh"
#include "param_grads.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

int blocks_for(int rows) { return (rows + kWarps - 1) / kWarps; }

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

// Three passes over row `row`: the sum, then the centred squares (and
// for dx the g sums), then dx (kDx). kVec16: 16-byte loads (d a multiple
// of the vector and the tensors aligned), else scalar ones. Returns the
// row's (mean, r).
template <typename T, bool kVec16, bool kDx>
__device__ __forceinline__ float2 loop_row(const T* __restrict__ x,
                                           const T* __restrict__ g,
                                           const float* __restrict__ scale,
                                           T* __restrict__ dx, int row, int d,
                                           float eps, int lane) {
  constexpr int kVec = kVec16 ? tyt::Vec16<T>::kVec : 1;
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
  // One pass for the sums that need the mean: the centred squares, and
  // for dx gs and gs times the centred x (mean(gs * norm) = r *
  // mean(gs * c)).
  float sq = 0.f, sum_gs = 0.f, sum_gsc = 0.f;
#pragma unroll 2
  for (int i = lane; i < n; i += 32) {
    float v[kVec], gv[kVec], sc[kVec];
    load(x, i, v);
    if constexpr (kDx) {
      load(g, i, gv);
      load_scale(i, sc);
    }
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const float c = v[j] - mean;
      sq += c * c;
      if constexpr (kDx) {
        const float gs = gv[j] * sc[j];
        sum_gs += gs;
        sum_gsc += gs * c;
      }
    }
  }
  const float r = rsqrtf(tyt::warp_sum(sq) * inv_d + eps);
  if constexpr (kDx) {
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
  return make_float2(mean, r);
}

template <typename T, bool kVec16>
__global__ void __launch_bounds__(kThreads)
layernorm_bwd_dx_kernel(const T* __restrict__ x, const T* __restrict__ g,
                        const float* __restrict__ scale, T* __restrict__ dx,
                        int rows, int d, float eps) {
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  loop_row<T, kVec16, true>(x, g, scale, dx, row, d, eps, threadIdx.x & 31);
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

// The forward with the row in registers (kNV 16-byte vectors a lane),
// a warp a row, kFwdRowWarps warps a block, persistent: a fixed grid of
// at most as many blocks as fit on the card at once, each warp taking
// every (kFwdRowWarps * gridDim.x)-th row, with scale and bias held in
// registers across its rows and the next row's x loaded before the
// current one is reduced.
constexpr int kFwdRowWarps = 8;

template <typename T, int kNV>
__device__ __forceinline__ void load_x(const T* __restrict__ x, size_t off,
                                       uint4 (&xv)[kNV]) {
  constexpr int kVec = tyt::Vec16<T>::kVec;
#pragma unroll
  for (int k = 0; k < kNV; ++k) xv[k] = tyt::load16(x + off + k * 32 * kVec);
}

template <typename T, int kNV>
__global__ void __launch_bounds__(kFwdRowWarps * 32)
layernorm_row_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                     const float* __restrict__ bias, T* __restrict__ y,
                     int rows, float eps) {
  constexpr int kVec = tyt::Vec16<T>::kVec;
  constexpr int kD = kNV * 32 * kVec;
  constexpr float kInvD = 1.f / static_cast<float>(kD);
  int row = blockIdx.x * kFwdRowWarps + (threadIdx.x >> 5);
  if (row >= rows) return;  // the whole warp leaves together
  const int stride = gridDim.x * kFwdRowWarps;
  const int lane = threadIdx.x & 31;

  uint4 xv[kNV];
  load_x<T, kNV>(x, static_cast<size_t>(row) * kD + lane * kVec, xv);
  float4 sv[kNV][kVec / 4], bv[kNV][kVec / 4];
#pragma unroll
  for (int k = 0; k < kNV; ++k) {
#pragma unroll
    for (int j = 0; j < kVec / 4; ++j) {
      const int i = (k * 32 + lane) * kVec + 4 * j;
      sv[k][j] = __ldg(reinterpret_cast<const float4*>(scale + i));
      bv[k][j] = __ldg(reinterpret_cast<const float4*>(bias + i));
    }
  }
  for (; row < rows; row += stride) {
    const size_t off = static_cast<size_t>(row) * kD + lane * kVec;
    uint4 xn[kNV];
    if (row + stride < rows) {
      load_x<T, kNV>(x, off + static_cast<size_t>(stride) * kD, xn);
    }
    float sum = 0.f;
#pragma unroll
    for (int k = 0; k < kNV; ++k) {
      float v[kVec];
      tyt::unpack(xv[k], v);
#pragma unroll
      for (int j = 0; j < kVec; ++j) sum += v[j];
    }
    const float mean = tyt::warp_sum(sum) * kInvD;
    float sq = 0.f;
#pragma unroll
    for (int k = 0; k < kNV; ++k) {
      float v[kVec];
      tyt::unpack(xv[k], v);
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const float c = v[j] - mean;
        sq += c * c;
      }
    }
    const float r = rsqrtf(tyt::warp_sum(sq) * kInvD + eps);
#pragma unroll
    for (int k = 0; k < kNV; ++k) {
      float v[kVec];
      tyt::unpack(xv[k], v);
#pragma unroll
      for (int j = 0; j < kVec / 4; ++j) {
        v[4 * j] = (v[4 * j] - mean) * r * sv[k][j].x + bv[k][j].x;
        v[4 * j + 1] = (v[4 * j + 1] - mean) * r * sv[k][j].y + bv[k][j].y;
        v[4 * j + 2] = (v[4 * j + 2] - mean) * r * sv[k][j].z + bv[k][j].z;
        v[4 * j + 3] = (v[4 * j + 3] - mean) * r * sv[k][j].w + bv[k][j].w;
      }
      tyt::store16(y + off + k * 32 * kVec, tyt::pack(v));
    }
#pragma unroll
    for (int k = 0; k < kNV; ++k) xv[k] = xn[k];
  }
}

template <typename T, int kNV>
void launch_fwd_rows(const void* x, const float* scale, const float* bias,
                     void* y, int rows, float eps, cudaStream_t s) {
  // The blocks that fit on the card at once (kernel and device fixed per
  // process: asked once).
  static int fit = 0;
  if (fit == 0) {
    int device = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, layernorm_row_kernel<T, kNV>, kFwdRowWarps * 32, 0);
    fit = sms * (per_sm > 0 ? per_sm : 1);
  }
  const int need = (rows + kFwdRowWarps - 1) / kFwdRowWarps;
  const int blocks = need < fit ? need : fit;
  layernorm_row_kernel<T, kNV><<<blocks, kFwdRowWarps * 32, 0, s>>>(
      static_cast<const T*>(x), scale, bias, static_cast<T*>(y), rows, eps);
}

// The row kernel where d is kNV (1-8) 16-byte vectors a lane and the
// tensors are aligned; else the three-pass kernel.
template <typename T>
int forward(const void* x, const float* scale, const float* bias, void* y,
            int rows, int d, float eps, cudaStream_t s) {
  constexpr int kVec = tyt::Vec16<T>::kVec;
  using Launch = void (*)(const void*, const float*, const float*, void*, int,
                          float, cudaStream_t);
  constexpr Launch kLaunches[kMaxRowVectors] = {
      launch_fwd_rows<T, 1>, launch_fwd_rows<T, 2>, launch_fwd_rows<T, 3>,
      launch_fwd_rows<T, 4>, launch_fwd_rows<T, 5>, launch_fwd_rows<T, 6>,
      launch_fwd_rows<T, 7>, launch_fwd_rows<T, 8>};
  const bool aligned = tyt::aligned_to(x, 16) && tyt::aligned_to(scale, 16) &&
                       tyt::aligned_to(bias, 16) && tyt::aligned_to(y, 16);
  const int nv = d / (32 * kVec);
  if (aligned && d % (32 * kVec) == 0 && nv <= kMaxRowVectors) {
    kLaunches[nv - 1](x, scale, bias, y, rows, eps, s);
  } else {
    layernorm_kernel<T><<<blocks_for(rows), kThreads, 0, s>>>(
        static_cast<const T*>(x), scale, bias, static_cast<T*>(y), rows, d,
        eps);
  }
  return static_cast<int>(cudaGetLastError());
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

// The row kernel where d is kNV (1-8) 16-byte vectors a lane and the
// tensors are aligned; else the loop kernel, with 16-byte loads where the
// row is whole vectors and aligned.
template <typename T>
int backward_dx(const void* x, const void* g, const float* scale, void* dx,
                int rows, int d, float eps, cudaStream_t s) {
  constexpr int kVec = tyt::Vec16<T>::kVec;
  const bool aligned = tyt::aligned_to(x, 16) && tyt::aligned_to(g, 16) &&
                       tyt::aligned_to(scale, 16) && tyt::aligned_to(dx, 16);
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

// ---------------------------------------------------------------------------
// The whole backward: dx, and the column sums behind dscale and dbias
// ---------------------------------------------------------------------------

constexpr int kBwdWarps = 8;      // warps a block (ops/layernorm.py BWD_WARPS)
constexpr int kLnSumRows = 32;    // the parameter sums' threads down P
constexpr int kMaxSmem = 232448;  // 227 KB: the most a block can have

// Each warp's slice of column sums, [2][d]: sum g * norm (quantity 0)
// and sum g (quantity 1) of the kCols columns each lane owns, laid out
// [quantity][element][lane] so that a warp's accesses fall in 32 banks.
template <typename T, int kNV>
__host__ __device__ constexpr int row_smem_bytes() {
  return kBwdWarps * 2 * kNV * 32 * tyt::Vec16<T>::kVec * 4;
}

// A warp loads its next row's vectors before it reduces the current one
// (so that its loads stay in flight through the reductions) where both
// rows fit beside everything else in 128 registers: up to 3 vectors a
// lane (d 768 in bf16).
template <int kNV>
__host__ __device__ constexpr bool prefetch_rows() {
  return kNV <= 3;
}

template <typename T, int kNV>
__device__ __forceinline__ void load_row(const T* __restrict__ x,
                                         const T* __restrict__ g, size_t off,
                                         uint4 (&xv)[kNV], uint4 (&gv)[kNV]) {
  constexpr int kVec = tyt::Vec16<T>::kVec;
#pragma unroll
  for (int k = 0; k < kNV; ++k) {
    xv[k] = tyt::load16(x + off + k * 32 * kVec);
    gv[k] = tyt::load16(g + off + k * 32 * kVec);
  }
}

// The row-in-registers dx kernel, persistent over rows (warp w of block b
// takes rows b * 8 + w, then every (8 * gridDim.x)-th), adding each row's
// g * norm and g into its lane's column sums; then the block's sums, its
// warps in order, to partials[blockIdx.x, column, quantity]. Where two
// blocks' slices fit an SM's shared memory (d up to 1024 in bf16 and f32),
// at most 128 registers a thread, so that two blocks (16 warps) do.
template <typename T, int kNV, bool kDx>
__global__ void __launch_bounds__(
    kBwdWarps * 32, row_smem_bytes<T, kNV>() <= 64 * 1024 ? 2 : 1)
layernorm_bwd_row_kernel(const T* __restrict__ x, const T* __restrict__ g,
                         const float* __restrict__ scale, T* __restrict__ dx,
                         float* __restrict__ partials, int rows, float eps) {
  constexpr int kVec = tyt::Vec16<T>::kVec;
  constexpr int kD = kNV * 32 * kVec;
  constexpr int kCols = kNV * kVec;
  constexpr float kInvD = 1.f / static_cast<float>(kD);
  constexpr bool kPrefetch = prefetch_rows<kNV>();
  extern __shared__ float smem[];  // [kBwdWarps][2][kCols][32]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int stride = gridDim.x * kBwdWarps;
  float* sums = smem + warp * 2 * kD + lane;  // sums[(q * kCols + e) * 32]
#pragma unroll
  for (int e = 0; e < 2 * kCols; ++e) sums[e * 32] = 0.f;

  uint4 xv[kNV], gv[kNV];
  int row = blockIdx.x * kBwdWarps + warp;
  if (kPrefetch && row < rows) {
    load_row<T, kNV>(x, g, static_cast<size_t>(row) * kD + lane * kVec, xv,
                     gv);
  }
  for (; row < rows; row += stride) {
    const size_t off = static_cast<size_t>(row) * kD + lane * kVec;
    uint4 xn[kNV], gn[kNV];
    if (kPrefetch) {
      if (row + stride < rows) {
        load_row<T, kNV>(x, g, off + static_cast<size_t>(stride) * kD, xn,
                         gn);
      }
    } else {
      load_row<T, kNV>(x, g, off, xv, gv);
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
    float sq = 0.f, sum_gs = 0.f, sum_gsc = 0.f;
#pragma unroll
    for (int k = 0; k < kNV; ++k) {
#pragma unroll
      for (int q = 0; q < kVec / 4; ++q) {
        float v[4], gs[4], sc[4];
        get4<T>(xv[k], q, v);
        if constexpr (kDx) {
          get4<T>(gv[k], q, gs);
          get4_scale(scale, (k * 32 + lane) * kVec + 4 * q, sc);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float c = v[j] - mean;
          sq += c * c;
          if constexpr (kDx) {
            const float gsj = gs[j] * sc[j];
            sum_gs += gsj;
            sum_gsc += gsj * c;
          }
        }
      }
    }
#pragma unroll
    for (int offset = 16; offset > 0; offset >>= 1) {
      sq += __shfl_xor_sync(0xffffffffu, sq, offset);
      if constexpr (kDx) {
        sum_gs += __shfl_xor_sync(0xffffffffu, sum_gs, offset);
        sum_gsc += __shfl_xor_sync(0xffffffffu, sum_gsc, offset);
      }
    }
    const float r = rsqrtf(sq * kInvD + eps);
    const float mean_gs = sum_gs * kInvD;
    const float mean_gs_norm = sum_gsc * kInvD * r;
#pragma unroll
    for (int k = 0; k < kNV; ++k) {
      uint4 out;
#pragma unroll
      for (int q = 0; q < kVec / 4; ++q) {
        float v[4], gq[4], sc[4];
        get4<T>(xv[k], q, v);
        get4<T>(gv[k], q, gq);
        if constexpr (kDx) {
          get4_scale(scale, (k * 32 + lane) * kVec + 4 * q, sc);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float norm = (v[j] - mean) * r;
          const int e = k * kVec + 4 * q + j;
          sums[e * 32] += gq[j] * norm;
          sums[(kCols + e) * 32] += gq[j];
          if constexpr (kDx) {
            v[j] = r * (gq[j] * sc[j] - mean_gs - norm * mean_gs_norm);
          }
        }
        if constexpr (kDx) put4<T>(out, q, v);
      }
      if constexpr (kDx) tyt::store16(dx + off + k * 32 * kVec, out);
    }
    if (kPrefetch) {
#pragma unroll
      for (int k = 0; k < kNV; ++k) {
        xv[k] = xn[k];
        gv[k] = gn[k];
      }
    }
  }

  // Each thread takes slice entries (q, e, lane) in order, adds the
  // warps' in warp order, and writes column c = ((e / kVec) * 32 + lane)
  // * kVec + e % kVec of partials.
  __syncthreads();
  float* out = partials + static_cast<size_t>(blockIdx.x) * 2 * kD;
  for (int i = threadIdx.x; i < 2 * kD; i += kBwdWarps * 32) {
    float total = 0.f;
#pragma unroll
    for (int w = 0; w < kBwdWarps; ++w) total += smem[w * 2 * kD + i];
    const int l = i % 32, e = (i / 32) % kCols, q = i / (32 * kCols);
    const int c = ((e / kVec) * 32 + l) * kVec + e % kVec;
    out[2 * c + q] = total;
  }
}

// Any width: each warp takes a row with the dx kernel's three passes
// (loop_row), 8 rows a step, the block's steps every 8 * gridDim.x rows;
// then the block's threads take columns and add the step's g * norm and
// g, row by row, into the column sums in shared memory ([2][d], then the
// step's (mean, r) a row).
template <typename T, bool kVec16, bool kDx>
__global__ void __launch_bounds__(kBwdWarps * 32)
layernorm_bwd_loop_kernel(const T* __restrict__ x, const T* __restrict__ g,
                          const float* __restrict__ scale, T* __restrict__ dx,
                          float* __restrict__ partials, int rows, int d,
                          float eps) {
  extern __shared__ float smem[];
  float* sums = smem;
  float* stats = smem + 2 * d;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = threadIdx.x; i < 2 * d; i += kBwdWarps * 32) sums[i] = 0.f;
  for (int first = blockIdx.x * kBwdWarps; first < rows;
       first += gridDim.x * kBwdWarps) {
    const int row = first + warp;
    if (row < rows) {
      const float2 stat =
          loop_row<T, kVec16, kDx>(x, g, scale, dx, row, d, eps, lane);
      if (lane == 0) {
        stats[2 * warp] = stat.x;
        stats[2 * warp + 1] = stat.y;
      }
    }
    __syncthreads();
    const int n = min(kBwdWarps, rows - first);
    for (int c = threadIdx.x; c < d; c += kBwdWarps * 32) {
      float s = sums[c], b = sums[d + c];
      for (int w = 0; w < n; ++w) {
        const size_t off = static_cast<size_t>(first + w) * d + c;
        const float gv = tyt::to_float(g[off]);
        s += gv * ((tyt::to_float(x[off]) - stats[2 * w]) * stats[2 * w + 1]);
        b += gv;
      }
      sums[c] = s;
      sums[d + c] = b;
    }
    __syncthreads();
  }
  __syncthreads();
  float* out = partials + static_cast<size_t>(blockIdx.x) * 2 * d;
  for (int i = threadIdx.x; i < 2 * d; i += kBwdWarps * 32) {
    out[i] = sums[(i & 1) * d + (i >> 1)];
  }
}

__global__ void __launch_bounds__(tyt::kSumCols * kLnSumRows)
layernorm_param_grads_kernel(const float* __restrict__ partials, int n,
                             int c, float* __restrict__ dscale,
                             float* __restrict__ dbias) {
  tyt::sum_param_partials<kLnSumRows>(partials, n, c, dscale, dbias);
}

// A kernel launch with `smem` bytes of dynamic shared memory, raising the
// kernel's limit where it is over the default 48 KB.
template <typename Kernel, typename... Args>
int launch_smem(Kernel kernel, int blocks, int smem, cudaStream_t s,
                Args... args) {
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t status = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (status != cudaSuccess) return static_cast<int>(status);
  }
  kernel<<<blocks, kBwdWarps * 32, smem, s>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int kNV>
int launch_bwd_rows(const void* x, const void* g, const float* scale,
                    void* dx, float* partials, int rows, int blocks,
                    float eps, cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  const T* gt = static_cast<const T*>(g);
  T* out = static_cast<T*>(dx);
  constexpr int smem = row_smem_bytes<T, kNV>();
  return dx != nullptr
      ? launch_smem(layernorm_bwd_row_kernel<T, kNV, true>, blocks, smem, s,
                    xt, gt, scale, out, partials, rows, eps)
      : launch_smem(layernorm_bwd_row_kernel<T, kNV, false>, blocks, smem, s,
                    xt, gt, scale, out, partials, rows, eps);
}

template <typename T, bool kVec16>
int launch_bwd_loop(const void* x, const void* g, const float* scale,
                    void* dx, float* partials, int rows, int d, int blocks,
                    float eps, cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  const T* gt = static_cast<const T*>(g);
  T* out = static_cast<T*>(dx);
  const int smem = (2 * d + 2 * kBwdWarps) * 4;
  return dx != nullptr
      ? launch_smem(layernorm_bwd_loop_kernel<T, kVec16, true>, blocks, smem,
                    s, xt, gt, scale, out, partials, rows, d, eps)
      : launch_smem(layernorm_bwd_loop_kernel<T, kVec16, false>, blocks, smem,
                    s, xt, gt, scale, out, partials, rows, d, eps);
}

// The column-sum kernel where d is kNV (1-8) 16-byte vectors a lane and
// the tensors are aligned, else the loop kernel; then the parameter sums
// over its `blocks` rows of partials.
template <typename T>
int backward(const void* x, const void* g, const float* scale, void* dx,
             float* partials, float* dscale, float* dbias, int rows, int d,
             int blocks, float eps, cudaStream_t s) {
  constexpr int kVec = tyt::Vec16<T>::kVec;
  const bool aligned = tyt::aligned_to(x, 16) && tyt::aligned_to(g, 16) &&
                       tyt::aligned_to(scale, 16) &&
                       (dx == nullptr || tyt::aligned_to(dx, 16));
  using RowLaunch = int (*)(const void*, const void*, const float*, void*,
                            float*, int, int, float, cudaStream_t);
  constexpr RowLaunch kRowLaunches[kMaxRowVectors] = {
      launch_bwd_rows<T, 1>, launch_bwd_rows<T, 2>, launch_bwd_rows<T, 3>,
      launch_bwd_rows<T, 4>, launch_bwd_rows<T, 5>, launch_bwd_rows<T, 6>,
      launch_bwd_rows<T, 7>, launch_bwd_rows<T, 8>};
  const int nv = d / (32 * kVec);
  int status;
  if (aligned && d % (32 * kVec) == 0 && nv <= kMaxRowVectors) {
    status = kRowLaunches[nv - 1](x, g, scale, dx, partials, rows, blocks,
                                  eps, s);
  } else if (aligned && d % kVec == 0) {
    status = launch_bwd_loop<T, true>(x, g, scale, dx, partials, rows, d,
                                      blocks, eps, s);
  } else {
    status = launch_bwd_loop<T, false>(x, g, scale, dx, partials, rows, d,
                                       blocks, eps, s);
  }
  if (status != 0) return status;
  layernorm_param_grads_kernel<<<tyt::param_grads_blocks(d),
                                 tyt::kSumCols * kLnSumRows, 0, s>>>(
      partials, blocks, d, dscale, dbias);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int tyt_layernorm(const void* x, const float* scale,
                             const float* bias, void* y, int rows, int d,
                             float eps, int dtype, void* stream) {
  if (rows <= 0 || d <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == tyt::kBFloat16) {
    return forward<__nv_bfloat16>(x, scale, bias, y, rows, d, eps, s);
  }
  if (dtype == tyt::kFloat32) {
    return forward<float>(x, scale, bias, y, rows, d, eps, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
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

// The backward with dscale and dbias: g (the cotangent of y) and dx have
// x's dtype; scale [d] f32; dscale and dbias [d] f32; dx null where x is
// frozen (dx alone is tyt_layernorm_bwd_dx). The column-sum kernel over
// `blocks` blocks into partials [blocks, d, 2] f32 scratch, then the
// parameter sums: 2 launches.
extern "C" int tyt_layernorm_bwd(const void* x, const void* g,
                                 const float* scale, void* dx,
                                 float* partials, float* dscale, float* dbias,
                                 int rows, int d, int blocks, float eps,
                                 int dtype, void* stream) {
  if ((dtype != tyt::kBFloat16 && dtype != tyt::kFloat32) ||
      partials == nullptr || dscale == nullptr || dbias == nullptr ||
      blocks <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rows <= 0 || d <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == tyt::kBFloat16
      ? backward<__nv_bfloat16>(x, g, scale, dx, partials, dscale, dbias,
                                rows, d, blocks, eps, s)
      : backward<float>(x, g, scale, dx, partials, dscale, dbias, rows, d,
                        blocks, eps, s);
}
