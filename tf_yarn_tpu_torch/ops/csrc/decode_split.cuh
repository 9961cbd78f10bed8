// Split-sequence int8 decode attention, shared by the paged kernel
// (paged_decode.cu) and the dense one (dense_decode.cu). The two differ
// only in where position `pos` of a slot's cache lives, which a Layout
// policy says:
//
//   PagedLayout  row = table[pos / block_size] * block_size
//                      + pos % block_size          (through the block table)
//   DenseLayout  row = slot * seq_len + pos         (a [B, S, n_kv, D] cache)
//
// with every row [n_kv, head_dim] int8 plus one f32 scale per kv head:
// the paged pool's scales are per row (scale row = row) or per block
// (one scale row a physical block: scale row = row >> bs_shift, the
// block's id), by a runtime shift of the layout, so both modes share one
// instantiation.
//
// Virtual slot v = slot * width + w attends over the first
//   lengths[slot] + w + length_offset
// positions of its slot, capped at the layout's capacity.
//
// Bound on the H100: memory, on the int8 cache bytes. Each position costs
// 2 * head_dim int8 bytes (+ 8 scale bytes) per kv head against
// 4 * group * head_dim flops, about 8 flops/byte.
//
// Design. The TPU walked one slot's cache in a sequential grid; one SM
// walking a long slot alone is latency-bound on the card, so the sequence
// is split across blocks (flash-decoding), and the last block of each
// (virtual slot, kv head) to finish merges the splits: one launch a call.
//   One block of 128 threads per (virtual slot, kv head, split of
//   kSplitRows positions). Splits at or past the slot's length exit at
//   once, so only live positions are read (the counterpart of the TPU's
//   pl.when(ki * block < length)). The block finds its own rows (the
//   TPU fed the paged table by scalar prefetch). The whole GQA group of G
//   query heads shares each K/V element, which is converted from int8 once
//   and used G times:
//   1. scores: tiles of kTileRows positions come in by cp.async into two
//      shared buffers, the next tile's copies in flight while the current
//      one is used; rows are padded by 16 bytes so that neighbouring
//      threads' 16-byte reads of different rows hit different banks. Each
//      thread scores ITS row against the G query rows (pre-scaled by
//      head_dim^-0.5, broadcast from shared memory) and scales by the
//      row's K scale; dead positions get -inf;
//   2. softmax over the split, in f32: one warp per head takes the max
//      and the sum of exp (two passes over at most kSplitRows logits);
//   3. P.V: the same rows of V come in the same way, each probability is
//      multiplied by its row's V scale (dead rows get exactly 0, so NaN
//      scale garbage cannot leak), and each warp accumulates a quarter of
//      the rows, a lane owning 4 of the 128 columns for all G heads; the
//      four warps' sums meet in shared memory.
//   4. merge: a slot of one live split writes acc / max(l, 1e-30) at once.
//      Otherwise every split writes its unnormalised acc and (max, sum) to
//      f32 scratch, and after a barrier its thread 0 takes a ticket of its
//      (virtual slot, kv head) between two __threadfence()s (the pattern
//      of a cooperative grid sync); the block that takes the last one
//      merges: one warp per query head loads up to kMergeBatch records at
//      once with their (max, sum), and rescales the live splits to their
//      common max in split order, so the output's bits do not depend on
//      which block came last. The merge does the arithmetic of the combine
//      kernel it replaces, in the same order.
//   The ticket is an atomicInc that wraps at the split count: the last
//   block's own increment puts it back to 0, so the buffer is zeroed once
//   (by the caller) and stays zeroed across calls and CUDA-graph replays,
//   with no memset launch. Two launches that share the buffer must not
//   run at the same time (the caller orders them); a launch that faults
//   mid-way leaves tickets behind, but a fault also ends the CUDA context.
// TMA and tensor-core products come later (a one-kernel redesign with
// bulk copies and mma.sync products was slower than this; see PERF.md).
//
// Instantiated only for the configurations the port serves, all at
// head_dim 128: bf16 with a GQA group of 4 (Llama-3-8B widths) and f32
// with a group of 2 (the small f32 model chip_smoke.py serves on the card
// and on the CPU). Any other (dtype, group, head_dim) is refused.
#pragma once

#include <math.h>

#include "common.cuh"

namespace tyt {
namespace decode {

constexpr int kThreads = 128;        // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kTileRows = kThreads;  // positions per tile: one per thread
constexpr int kSplitRows = 256;      // positions per split (whole tiles)
constexpr int kHeadDim = 128;        // one 32-bit word (4 columns) per lane
constexpr int kMinBlocksPerSM = 4;   // caps the kernel at 128 registers
constexpr int kMergeBatch = 8;        // records a merging warp loads at once

// The paged pool: a slot's positions through its row of the block table.
// block_size is a power of two (the kernel indexes with shifts).
struct PagedLayout {
  const int* tables;  // [slots, max_blocks]
  int max_blocks;
  int bs_shift;
  int scale_shift;  // 0: a scale a row; bs_shift: a scale a block

  struct Slot {
    const int* table;
    int bs_shift;
    int scale_shift;
    __device__ __forceinline__ size_t row(int pos) const {
      return (static_cast<size_t>(table[pos >> bs_shift]) << bs_shift) +
             (pos & ((1 << bs_shift) - 1));
    }
    // The row of the scale pool that scales position pos: its own row, or
    // its physical block's one row.
    __device__ __forceinline__ size_t scale_row(int pos) const {
      return row(pos) >> scale_shift;
    }
    // Rows below this may be copied: the live positions' whole blocks
    // (their table entries are valid; the stale tails are masked).
    __device__ __forceinline__ int readable(int n_pos) const {
      return ((n_pos + (1 << bs_shift) - 1) >> bs_shift) << bs_shift;
    }
  };
  __device__ __forceinline__ Slot slot(int s) const {
    return {tables + static_cast<size_t>(s) * max_blocks, bs_shift,
            scale_shift};
  }
  __device__ __forceinline__ int capacity() const {
    return max_blocks << bs_shift;
  }
};

// A dense cache [slots, seq_len, n_kv, head_dim]: row pos of slot s is
// row s * seq_len + pos, so a tile may be any run of positions.
struct DenseLayout {
  int seq_len;

  struct Slot {
    size_t base;
    __device__ __forceinline__ size_t row(int pos) const { return base + pos; }
    __device__ __forceinline__ size_t scale_row(int pos) const {
      return base + pos;
    }
    __device__ __forceinline__ int readable(int n_pos) const { return n_pos; }
  };
  __device__ __forceinline__ Slot slot(int s) const {
    return {static_cast<size_t>(s) * seq_len};
  }
  __device__ __forceinline__ int capacity() const { return seq_len; }
};

// Four signed int8 values of a 32-bit word as exact floats without the
// int-to-float unit (a quarter of the FMA rate on Hopper): each byte,
// offset to unsigned, becomes the low mantissa byte of 2^23 (0x4B0000xx),
// and subtracting 2^23 + 128 leaves the byte's value.
__device__ __forceinline__ float4 int8x4_to_float4(unsigned word) {
  const unsigned u = word ^ 0x80808080u;
  const float bias = 8388736.0f;  // 2^23 + 128
  return make_float4(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440)) - bias,
                     __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7441)) - bias,
                     __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7442)) - bias,
                     __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7443)) - bias);
}

__device__ __forceinline__ int live_positions(const int* lengths, int vslot,
                                              int width, int length_offset,
                                              int capacity) {
  const int slot = vslot / width;
  const int length = lengths[slot] + (vslot - slot * width) + length_offset;
  return max(0, min(length, capacity));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

// Starts the copies of one tile of one kv head's rows, positions
// [base, base + kTileRows), into rows_s (row_bytes apart), as one
// cp.async group. Rows at or past `readable` are skipped (their contents
// stay stale and the caller masks them). Returns the scale of this
// thread's row (read from the scale row of that same position, so a
// per-block scale comes from the position's own block wherever a split
// or a tile starts), 0 for a dead row.
template <typename Slot>
__device__ __forceinline__ float issue_tile(
    const int8_t* __restrict__ cache, const float* __restrict__ scales,
    const Slot& rows, int base, int n_pos, int readable, int n_kv, int h,
    int head_dim, int chunk_shift, int8_t* rows_s, int row_bytes) {
  const int pos = base + threadIdx.x;
  float scale = 0.f;
  if (pos < n_pos) scale = scales[rows.scale_row(pos) * n_kv + h];
  const int tile_chunks = kTileRows << chunk_shift;
  const size_t row_stride = static_cast<size_t>(n_kv) * head_dim;
  for (int idx = threadIdx.x; idx < tile_chunks; idx += kThreads) {
    const int r = idx >> chunk_shift;
    const int p = base + r;
    if (p < readable) {
      const int c = (idx & ((1 << chunk_shift) - 1)) * 16;
      cp_async16(rows_s + r * row_bytes + c,
                 cache + rows.row(p) * row_stride + h * head_dim + c);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
  return scale;
}

// G query heads per kv head.
template <typename T, int G, typename Layout>
__global__ void __launch_bounds__(kThreads, kMinBlocksPerSM)
decode_kernel(const T* __restrict__ q, const int8_t* __restrict__ kcache,
              const float* __restrict__ kscale,
              const int8_t* __restrict__ vcache,
              const float* __restrict__ vscale, Layout layout,
              const int* __restrict__ lengths, T* __restrict__ out,
              float* __restrict__ part_acc, float* __restrict__ part_ml,
              unsigned* __restrict__ tickets, int width, int n_heads,
              int n_kv, int head_dim, int length_offset, int n_splits,
              float softmax_scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int vslot = blockIdx.x;
  const int h = blockIdx.y;
  const int split = blockIdx.z;
  const int n_pos = live_positions(lengths, vslot, width, length_offset,
                                   layout.capacity());
  const int start = split * kSplitRows;
  T* out_h = out + (static_cast<size_t>(vslot) * n_heads + h * G) * head_dim;
  if (n_pos == 0 && split == 0) {
    // No live position: the normaliser's clamp gives zeros.
    for (int i = threadIdx.x; i < G * head_dim; i += kThreads) {
      out_h[i] = tyt::from_float<T>(0.f);
    }
  }
  if (start >= n_pos) return;  // uniform over the block
  const int stop = min(start + kSplitRows, n_pos);

  const int chunks = head_dim / 16;     // 16-byte chunks per row
  const int chunk_shift = __ffs(chunks) - 1;
  const int row_bytes = head_dim + 16;  // padded row (see the design note)
  int8_t* rows_s[2] = {reinterpret_cast<int8_t*>(smem),
                       reinterpret_cast<int8_t*>(smem) + kTileRows * row_bytes};
  float* q_s = reinterpret_cast<float*>(rows_s[1] + kTileRows * row_bytes);
  float* p_s = q_s + G * head_dim;                    // [G][kSplitRows]
  float* ml_s = p_s + G * kSplitRows;                 // [G][2]
  float* red_s = reinterpret_cast<float*>(smem);      // [warps][G][head_dim]

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const auto rows = layout.slot(vslot / width);
  const int readable = rows.readable(n_pos);
  // Tiles 0 .. n_tiles - 1 are K, n_tiles .. 2 n_tiles - 1 the same rows
  // of V; tile i + 1 is in flight while tile i is used.
  const int n_tiles = (stop - start + kTileRows - 1) / kTileRows;
  auto issue = [&](int i) {
    const bool keys = i < n_tiles;
    return issue_tile(keys ? kcache : vcache, keys ? kscale : vscale, rows,
                      start + (keys ? i : i - n_tiles) * kTileRows, n_pos,
                      readable, n_kv, h, head_dim, chunk_shift,
                      rows_s[i & 1], row_bytes);
  };
  float next_scale = issue(0);
  const T* qbase =
      q + (static_cast<size_t>(vslot) * n_heads + h * G) * head_dim;
  for (int i = threadIdx.x; i < G * head_dim; i += kThreads) {
    q_s[i] = tyt::to_float(qbase[i]) * softmax_scale;
  }

  float acc[G][4];
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[g][j] = 0.f;
  }
  for (int i = 0; i < 2 * n_tiles; ++i) {
    const float row_scale = next_scale;
    if (i + 1 < 2 * n_tiles) {
      next_scale = issue(i + 1);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();  // tile i has landed for every thread; q_s is written
    const int8_t* tile = rows_s[i & 1];
    const int offset = ((i < n_tiles) ? i : i - n_tiles) * kTileRows;
    const int base = start + offset;
    const bool live = base + static_cast<int>(threadIdx.x) < n_pos;
    if (i < n_tiles) {
      // 1. Scores: thread r scores position base + r for the G heads.
      const uint4* krow =
          reinterpret_cast<const uint4*>(tile + threadIdx.x * row_bytes);
      float dot[G];
#pragma unroll
      for (int g = 0; g < G; ++g) dot[g] = 0.f;
      for (int c = 0; c < chunks; ++c) {
        const uint4 k16 = krow[c];
        const unsigned kw[4] = {k16.x, k16.y, k16.z, k16.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float4 kv = int8x4_to_float4(kw[e]);
#pragma unroll
          for (int g = 0; g < G; ++g) {
            const float4 qv = *reinterpret_cast<const float4*>(
                q_s + g * head_dim + 16 * c + 4 * e);
            dot[g] += qv.x * kv.x + qv.y * kv.y + qv.z * kv.z + qv.w * kv.w;
          }
        }
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        p_s[g * kSplitRows + offset + threadIdx.x] =
            live ? dot[g] * row_scale : -INFINITY;
      }
      if (i == n_tiles - 1) {
        // 2. Softmax statistics over the split's stop - start >= 1 live
        // logits: one warp per head.
        __syncthreads();
        const int n_live = stop - start;
        for (int g = warp; g < G; g += kWarps) {
          float* logits = p_s + g * kSplitRows;
          float m = -INFINITY;
          for (int k = lane; k < n_live; k += 32) m = fmaxf(m, logits[k]);
          m = tyt::warp_max(m);
          float sum = 0.f;
          for (int k = lane; k < n_live; k += 32) {
            const float prob = expf(logits[k] - m);
            logits[k] = prob;
            sum += prob;
          }
          sum = tyt::warp_sum(sum);
          if (lane == 0) {
            ml_s[2 * g] = m;
            ml_s[2 * g + 1] = sum;
          }
        }
      }
    } else {
      // 3. P.V: each probability times its row's V scale (exactly 0 for
      // a dead row), then warp w takes rows w, w + 4, ... of the tile.
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float* prob = p_s + g * kSplitRows + offset + threadIdx.x;
        *prob = live ? *prob * row_scale : 0.f;
      }
      __syncthreads();
      const int n_rows = min(kTileRows, stop - base);
      for (int r = warp; r < n_rows; r += kWarps) {
        const unsigned* vrow =
            reinterpret_cast<const unsigned*>(tile + r * row_bytes);
        float coef[G];
#pragma unroll
        for (int g = 0; g < G; ++g) coef[g] = p_s[g * kSplitRows + offset + r];
        const float4 v4 = int8x4_to_float4(vrow[lane]);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          acc[g][0] += coef[g] * v4.x;
          acc[g][1] += coef[g] * v4.y;
          acc[g][2] += coef[g] * v4.z;
          acc[g][3] += coef[g] * v4.w;
        }
      }
    }
    __syncthreads();  // tile i is consumed before tile i + 2 lands on it
  }

  // The four warps' sums meet in shared memory (over the tile buffers).
#pragma unroll
  for (int g = 0; g < G; ++g) {
    *reinterpret_cast<float4*>(red_s + (warp * G + g) * head_dim + 4 * lane) =
        make_float4(acc[g][0], acc[g][1], acc[g][2], acc[g][3]);
  }
  __syncthreads();
  const int live = (n_pos + kSplitRows - 1) / kSplitRows;
  if (live == 1) {
    // 4. The only split: normalise and write.
    for (int i = threadIdx.x; i < G * head_dim; i += kThreads) {
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) sum += red_s[w * G * head_dim + i];
      const int g = i / head_dim;
      out_h[i] = tyt::from_float<T>(sum * (1.f / fmaxf(ml_s[2 * g + 1], 1e-30f)));
    }
    return;
  }
  const size_t part0 =
      (static_cast<size_t>(vslot) * n_heads + h * G) * n_splits + split;
  for (int i = threadIdx.x; i < G * head_dim; i += kThreads) {
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += red_s[w * G * head_dim + i];
    const int g = i / head_dim;
    part_acc[(part0 + static_cast<size_t>(g) * n_splits) * head_dim +
             (i - g * head_dim)] = sum;
  }
  if (threadIdx.x < G) {
    const size_t part = part0 + static_cast<size_t>(threadIdx.x) * n_splits;
    part_ml[2 * part] = ml_s[2 * threadIdx.x];
    part_ml[2 * part + 1] = ml_s[2 * threadIdx.x + 1];
  }

  // 4. The ticket: this split's partials are visible to every block
  // before its increment (the barrier, then thread 0's fence), and the
  // block that takes the last one sees every split's before it reads.
  __shared__ int is_last;
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    const unsigned before = atomicInc(
        tickets + static_cast<size_t>(vslot) * n_kv + h, live - 1);
    is_last = before == static_cast<unsigned>(live - 1);
    __threadfence();
  }
  __syncthreads();
  if (!is_last) return;
  // One warp per query head. The first kMergeBatch records' loads and the
  // (max, sum) loads go out together, so a slot of at most kMergeBatch
  // splits merges after one round trip to L2.
  for (int g = warp; g < G; g += kWarps) {
    const size_t pair = static_cast<size_t>(vslot) * n_heads + h * G + g;
    const float* ml = part_ml + pair * n_splits * 2;
    const float* acc_g = part_acc + pair * n_splits * head_dim + 4 * lane;
    float4 a[kMergeBatch];
#pragma unroll
    for (int k = 0; k < kMergeBatch; ++k) {
      if (k < live) a[k] = __ldcg(reinterpret_cast<const float4*>(
          acc_g + static_cast<size_t>(k) * head_dim));
    }
    const float2 own = lane < live
        ? __ldcg(reinterpret_cast<const float2*>(ml) + lane)
        : make_float2(-INFINITY, 0.f);
    float m = own.x;
    for (int i = lane + 32; i < live; i += 32) m = fmaxf(m, __ldcg(ml + 2 * i));
    m = tyt::warp_max(m);

    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
    float l = 0.f;
    for (int i0 = 0; i0 < live; i0 += 32) {
      // Lane k rescales split i0 + k; the warp then walks the splits in
      // order, kMergeBatch records a batch.
      const int mine = i0 + lane;
      const float2 ml_mine = i0 == 0 ? own
          : mine < live ? __ldcg(reinterpret_cast<const float2*>(ml) + mine)
                        : make_float2(-INFINITY, 0.f);
      const float my_corr = mine < live ? expf(ml_mine.x - m) : 0.f;
      if (mine < live) l += ml_mine.y * my_corr;
      const int stop = min(i0 + 32, live);
      for (int j0 = i0; j0 < stop; j0 += kMergeBatch) {
        if (j0 > 0) {
#pragma unroll
          for (int k = 0; k < kMergeBatch; ++k) {
            if (j0 + k < stop) a[k] = __ldcg(reinterpret_cast<const float4*>(
                acc_g + static_cast<size_t>(j0 + k) * head_dim));
          }
        }
#pragma unroll
        for (int k = 0; k < kMergeBatch; ++k) {
          const float corr = __shfl_sync(0xffffffffu, my_corr, j0 - i0 + k);
          if (j0 + k < stop) {
            sum.x += corr * a[k].x;
            sum.y += corr * a[k].y;
            sum.z += corr * a[k].z;
            sum.w += corr * a[k].w;
          }
        }
      }
    }
    l = tyt::warp_sum(l);
    const float inv = 1.f / fmaxf(l, 1e-30f);
    T* orow = out_h + g * head_dim + 4 * lane;
    orow[0] = tyt::from_float<T>(sum.x * inv);
    orow[1] = tyt::from_float<T>(sum.y * inv);
    orow[2] = tyt::from_float<T>(sum.z * inv);
    orow[3] = tyt::from_float<T>(sum.w * inv);
  }
}

template <typename T, int G, typename Layout>
int launch(const void* q, const int8_t* kcache, const float* kscale,
           const int8_t* vcache, const float* vscale, const Layout& layout,
           const int* lengths, void* out, float* part_acc, float* part_ml,
           unsigned* tickets, int slots, int width, int n_heads, int n_kv,
           int head_dim, int length_offset, int n_splits, float softmax_scale,
           cudaStream_t stream) {
  const size_t smem =
      2 * static_cast<size_t>(kTileRows) * (head_dim + 16) +
      sizeof(float) * (G * head_dim + G * kSplitRows + 2 * G);
  auto kernel = decode_kernel<T, G, Layout>;
  if (smem > 48 * 1024) {
    const cudaError_t status = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (status != cudaSuccess) return static_cast<int>(status);
  }
  kernel<<<dim3(slots * width, n_kv, n_splits), kThreads, smem, stream>>>(
      static_cast<const T*>(q), kcache, kscale, vcache, vscale, layout,
      lengths, static_cast<T*>(out), part_acc, part_ml, tickets, width,
      n_heads, n_kv, head_dim, length_offset, n_splits, softmax_scale);
  return static_cast<int>(cudaGetLastError());
}

// The instantiations the port serves (see the file note); any other
// (dtype, group) gets cudaErrorInvalidValue.
template <typename Layout>
int dispatch(int dtype, const void* q, const int8_t* kcache,
             const float* kscale, const int8_t* vcache, const float* vscale,
             const Layout& layout, const int* lengths, void* out,
             float* part_acc, float* part_ml, unsigned* tickets, int slots,
             int width, int n_heads, int n_kv, int head_dim, int capacity,
             int length_offset, int n_splits, float softmax_scale,
             void* stream) {
  if (n_kv <= 0 || n_heads % n_kv != 0 || head_dim != kHeadDim ||
      n_splits <= 0 || n_splits > 65535 ||
      static_cast<long long>(n_splits) * kSplitRows < capacity) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int group = n_heads / n_kv;
  if (dtype == tyt::kBFloat16 && group == 4) {
    return launch<__nv_bfloat16, 4>(q, kcache, kscale, vcache, vscale, layout,
                                    lengths, out, part_acc, part_ml, tickets,
                                    slots, width, n_heads, n_kv, head_dim,
                                    length_offset, n_splits, softmax_scale, s);
  }
  if (dtype == tyt::kFloat32 && group == 2) {
    return launch<float, 2>(q, kcache, kscale, vcache, vscale, layout,
                            lengths, out, part_acc, part_ml, tickets, slots,
                            width, n_heads, n_kv, head_dim, length_offset,
                            n_splits, softmax_scale, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace decode
}  // namespace tyt
