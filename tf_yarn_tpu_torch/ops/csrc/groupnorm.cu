// GroupNorm over NHWC slabs, forward and backward. x is [B, HW, C]
// contiguous (channels last); channel c belongs to group c / (C / G);
// every (image, group) is normalised over its HW x C/G elements:
//   forward  y  = (x - mean) * inv * scale + bias,  inv = rsqrt(var + eps),
//            var the biased variance;
//   backward dx = inv * (gs - mean(gs) - norm * mean(gs * norm)),
//            gs = g * scale, norm = (x - mean) * inv, from the forward's
//            (mean, inv); dscale = sum over images and rows of g * norm,
//            dbias = sum of g.
// f32 math; y and dx in x's dtype, dscale and dbias f32.
//
// Replaces the TPU kernels tf_yarn_tpu/ops/groupnorm.py:_groupnorm_kernel
// and :_groupnorm_bwd_dx_kernel, and the XLA sums of dscale and dbias
// beside the latter (groupnorm.py:220-231).
//
// Bound on the H100: memory (~8 f32 operations an element against 4
// bytes in bf16; the backward ~18 against 6). The forward reads x once
// and writes y once; the backward reads x and g once and writes dx once.
//
// One pass (groupnorm_fwd_kernel, groupnorm_bwd_kernel). The TPU kernels
// hold one image's whole [HW, C] slab in VMEM. Here a thread-block
// cluster of 1-8 blocks stands in for that VMEM: it owns one (image,
// channel span), where a span is whole groups and a multiple of 32 bytes
// wide, and each of its blocks holds its rows' [rows, span] tile (the
// backward: a tile of x and one of g) in shared memory, up to 227 KB a
// block:
//   1. every thread issues all its 16-byte cp.async copies of the tiles
//      before it waits, so an SM has tens of KB in flight; a thread later
//      reads back only the vectors it copied (its column of the span is
//      fixed), so its own wait is all the synchronisation the tiles need;
//   2. per-thread column sums, a warp butterfly, per-channel sums over the
//      block's warps, all in a fixed order; the cluster's blocks then load
//      one another's partials over distributed shared memory, all ranks
//      at once, and add them in rank order, so every block holds the same
//      bits (deterministic, no atomics). The forward sums x, then the centred squares (the exact
//      two-pass variance of groupnorm_stats_reference, with no shift and
//      no clamp), each folded per group. The backward sums, per channel,
//      S2 = sum g * norm and S1 = sum g in one reduction with three uses:
//      the group means mean(gs) = sum_c scale_c S1_c / n and
//      mean(gs * norm) = sum_c scale_c S2_c / n, and this image's share
//      of dscale and dbias, which cluster rank 0 writes to partials
//      [B, C, 2] (S2, S1);
//   3. y (dx) from the tiles with 16-byte stores; the forward's rank 0
//      writes each group's (mean, inv) to stats [B, G, 2], which the
//      backward reads.
// The plan (span, cluster size, rows a block, 128 or 256 threads a block,
// shared memory a block) is ops/groupnorm.py:groupnorm_plan's, a pure
// function of the shape and the direction: spans of 128 bytes where a
// cluster holds them (whole DRAM lines of each row), else the narrowest
// (32 bytes at the stem's backward, whose two tiles are twice the
// forward's one), tiles of ~32 KB so that several blocks share an SM and
// one's copies overlap another's arithmetic (up to ~100 KB where a slab
// needs them), and 256 threads for tiles of 48 KB or more. The entry
// points check the plan and that a cluster of it can be resident
// (cudaOccupancyMaxActiveClusters), and refuse one they cannot run.
//
// dscale and dbias (groupnorm_param_grads_kernel, the backward's second
// launch): each sums its channel's partials over the images in a fixed
// order (rows of 8 threads, then the 8 in order): no float atomics, so
// dx, dscale and dbias are bitwise equal over two calls. A backward that
// needs neither skips it and the partials.
//
// Two launches (groupnorm_reduce_kernel, then groupnorm_apply_kernel):
// for slabs whose span does not fit a cluster (over 8 x 227 KB, as at
// [1, 256^2, 64]) and channel counts no 32-byte span divides. A grid of
// (row chunk, image) blocks:
//   1. reduce: each block sums two per-element quantities over its chunk
//      of rows and writes them as partials (forward: x - shift and its
//      square, per group, [B, chunks, G, 2]; backward: g * norm and g,
//      per channel, [B, chunks, C, 2], which the parameter sums then fold
//      over images and chunks);
//   2. apply: each block first folds its image's partials into per-group
//      statistics in shared memory, in a fixed order (deterministic: no
//      atomics), then writes its chunk of y (or dx).
// The forward's sums there are of x - shift, where shift is the group's
// first element: the variance is E[(x-shift)^2] - E[x-shift]^2, clamped
// at 0, so a large mean with a tiny spread loses nothing to cancellation.
// These read x twice (backward: x and g twice): 1.5x (1.67x) the bytes of
// the function. Threads map to channels (tx) and rows (ty); loads are
// scalar and coalesced.
#include <cooperative_groups.h>

#include <climits>
#include <mutex>
#include <vector>

#include "common.cuh"
#include "param_grads.cuh"

namespace coop = cooperative_groups;

namespace {

constexpr int kThreads = 256;     // the two-launch kernels' blocks
constexpr int kMaxCluster = 8;
constexpr int kMaxSmem = 232448;  // 227 KB: the most a block can have

// ---------------------------------------------------------------------------
// One pass
// ---------------------------------------------------------------------------

struct OnePass {
  int hw, c, groups, span, cluster, rows, threads;
  __host__ __device__ int cg() const { return c / groups; }
  __host__ __device__ int span_groups() const { return span / cg(); }
};

// Slots of per-channel partial sums the block reduction keeps: one a warp
// when a warp spans several rows (nv < 32 vectors a row), else one a row
// of threads. A block is 128 or 256 threads (kBlock, the plan's choice).
__host__ __device__ __forceinline__ int reduce_slots(int nv, int threads) {
  return nv < 32 ? threads / 32 : threads / nv;
}

// Shared memory a block. Forward: the tile [rows, span], the reduction's
// [slots, span] partials, and four [span groups] vectors (sums, squares,
// mean, inv). Backward: the tiles of x and g, [2, slots, span] partials,
// scale times the cluster's [2, span] channel sums, and two [span groups]
// means.
// ops/groupnorm.py:one_pass_smem is the same formula.
size_t one_pass_smem(const OnePass& p, int itemsize, bool backward) {
  const size_t nv = p.span * itemsize / 16;
  const size_t slots = reduce_slots(static_cast<int>(nv), p.threads);
  const size_t tile = static_cast<size_t>(p.rows) * p.span * itemsize;
  const size_t ngs = p.span_groups();
  if (!backward) return tile + (slots * p.span + 4 * ngs) * sizeof(float);
  return 2 * tile + (2 * slots * p.span + 2 * p.span + 2 * ngs) * sizeof(float);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src)
               : "memory");
}

// The two halves of cluster.sync(): a block arrives once it is done
// reading the other blocks' shared memory and waits before it exits, so
// no block's shared memory goes away while another reads it.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The sum over the cluster's ranks of the float at `local` (an address
// in this block's shared memory) in each rank's shared memory: every
// rank's value loaded at once over distributed shared memory, then added
// in rank order (the same bits in every block).
__device__ __forceinline__ float cluster_sum(coop::cluster_group& cluster,
                                             const float* local, int ranks) {
  float v[kMaxCluster];
#pragma unroll
  for (int r = 0; r < kMaxCluster; ++r) {
    v[r] = r < ranks ? *cluster.map_shared_rank(local, r) : 0.f;
  }
  float s = 0.f;
#pragma unroll
  for (int r = 0; r < kMaxCluster; ++r) {
    if (r < ranks) s += v[r];
  }
  return s;
}

// The block's sums of each thread's per-channel partials acc[q] (kQ
// quantities over the kVec channels of its column of the span, nv
// columns) into part[q * slots * span + ch], slot 0 of `part`, which is
// [kQ, slots, span] scratch. A fixed order throughout, so equal inputs
// give equal bits; synchronised on return.
template <int kQ, int kVec, int kBlock>
__device__ __forceinline__ void span_channel_sums(float (&acc)[kQ][kVec],
                                                  int nv, int span,
                                                  float* part) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int slots = reduce_slots(nv, kBlock);
  // Lanes l and l ^ off (off >= nv) share a column: fold them together.
  for (int off = 16; off >= nv; off >>= 1) {
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        acc[q][j] += __shfl_xor_sync(0xffffffffu, acc[q][j], off);
      }
    }
  }
  if (nv >= 32 || lane < nv) {
    const int slot = nv < 32 ? warp : threadIdx.x / nv;
    const int col = threadIdx.x % nv;
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        part[(q * slots + slot) * span + col * kVec + j] = acc[q][j];
      }
    }
  }
  __syncthreads();
  // One thread a (quantity, channel), all at once, each issuing its loads
  // before it adds them in slot order: the block waits on one round of
  // shared-memory latency, not on a chain of them.
  for (int i = threadIdx.x; i < kQ * span; i += kBlock) {
    const int q = kQ == 1 ? 0 : i / span;
    float* column = part + q * (slots - 1) * span + i;
    constexpr int kMaxSlots = kBlock / 32;
    float v[kMaxSlots];
#pragma unroll
    for (int k = 0; k < kMaxSlots; ++k) {
      v[k] = k < slots ? column[k * span] : 0.f;
    }
    float s = v[0];
#pragma unroll
    for (int k = 1; k < kMaxSlots; ++k) {
      if (k < slots) s += v[k];
    }
    column[0] = s;  // slot 0: the channel's block sum
  }
  __syncthreads();
}

// The block's sums of `acc` per channel (span_channel_sums), then each
// group's channels, into group_out[g] for the span's ngs groups. A fixed
// order throughout; group_out is written but not yet synchronised.
template <int kVec, int kBlock>
__device__ __forceinline__ void span_group_sums(float (&acc)[1][kVec], int nv,
                                                int span, int group_width,
                                                int ngs, float* part,
                                                float* group_out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  span_channel_sums<1, kVec, kBlock>(acc, nv, span, part);
  for (int g = warp; g < ngs; g += kBlock / 32) {
    float s = 0.f;
    for (int ch = g * group_width + lane; ch < (g + 1) * group_width;
         ch += 32) {
      s += part[ch];
    }
    s = tyt::warp_sum(s);
    if (lane == 0) group_out[g] = s;
  }
}

// One block of a cluster that owns (image b, channels [c0, c0 + span)):
// rows [rank * rows, min(hw, (rank + 1) * rows)).
template <typename T, int kBlock>
__global__ void __launch_bounds__(kBlock)
groupnorm_fwd_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                     const float* __restrict__ bias, T* __restrict__ y,
                     float* __restrict__ stats, OnePass p, float eps) {
  constexpr int kVec = tyt::Vec16<T>::kVec;
  extern __shared__ __align__(16) unsigned char tile_smem[];
  coop::cluster_group cluster = coop::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int spans = p.c / p.span;
  const int unit = blockIdx.x / p.cluster;
  const int b = unit / spans, c0 = (unit % spans) * p.span;
  const int r0 = rank * p.rows;
  const int nrows = min(p.rows, p.hw - r0);
  const int nv = p.span / kVec;            // 16-byte vectors a row of the span
  const int nv_shift = __ffs(nv) - 1;      // nv is a power of two
  const int col = threadIdx.x & (nv - 1);  // this thread's column, fixed
  const int cgw = p.cg(), ngs = p.span_groups();
  uint4* tile = reinterpret_cast<uint4*>(tile_smem);  // [rows, nv]
  float* part = reinterpret_cast<float*>(tile + p.rows * nv);
  float* sums = part + reduce_slots(nv, kBlock) * p.span;
  float* squares = sums + ngs;
  float* mean = squares + ngs;
  float* inv = mean + ngs;
  const int count = nrows * nv;
  const size_t first = (static_cast<size_t>(b) * p.hw + r0) * p.c + c0 +
                       col * kVec;
  // Vector i of the tile is row i / nv, column col (kBlock % nv == 0).
  const T* xs = x + first;
  for (int i = threadIdx.x; i < count; i += kBlock) {
    cp_async16(&tile[i], xs + static_cast<size_t>(i >> nv_shift) * p.c);
  }
  float a[kVec], bi[kVec];  // scale (then inv * scale) and bias, in flight
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    a[j] = scale[c0 + col * kVec + j];
    bi[j] = bias[c0 + col * kVec + j];
  }
  cp_async_wait_all();

  float acc[1][kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) acc[0][j] = 0.f;
  for (int i = threadIdx.x; i < count; i += kBlock) {
    float v[kVec];
    tyt::unpack(tile[i], v);
#pragma unroll
    for (int j = 0; j < kVec; ++j) acc[0][j] += v[j];
  }
  span_group_sums<kVec, kBlock>(acc, nv, p.span, cgw, ngs, part, sums);
  cluster.sync();
  const float n = static_cast<float>(p.hw) * static_cast<float>(cgw);
  for (int g = threadIdx.x; g < ngs; g += kBlock) {
    mean[g] = cluster_sum(cluster, sums + g, p.cluster) / n;
  }
  __syncthreads();

  float m[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    m[j] = mean[(col * kVec + j) / cgw];
    acc[0][j] = 0.f;
  }
  for (int i = threadIdx.x; i < count; i += kBlock) {
    float v[kVec];
    tyt::unpack(tile[i], v);
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const float d = v[j] - m[j];
      acc[0][j] += d * d;
    }
  }
  span_group_sums<kVec, kBlock>(acc, nv, p.span, cgw, ngs, part, squares);
  cluster.sync();
  const int g0 = c0 / cgw;
  for (int g = threadIdx.x; g < ngs; g += kBlock) {
    const float s = cluster_sum(cluster, squares + g, p.cluster);
    const float iv = rsqrtf(s / n + eps);
    inv[g] = iv;
    if (rank == 0) {
      float* st = stats + (static_cast<size_t>(b) * p.groups + g0 + g) * 2;
      st[0] = mean[g];
      st[1] = iv;
    }
  }
  cluster_arrive();
  __syncthreads();

#pragma unroll
  for (int j = 0; j < kVec; ++j) a[j] *= inv[(col * kVec + j) / cgw];
  T* ys = y + first;
  for (int i = threadIdx.x; i < count; i += kBlock) {
    float v[kVec];
    tyt::unpack(tile[i], v);
#pragma unroll
    for (int j = 0; j < kVec; ++j) v[j] = (v[j] - m[j]) * a[j] + bi[j];
    tyt::store16(ys + static_cast<size_t>(i >> nv_shift) * p.c, tyt::pack(v));
  }
  cluster_wait();
}

// The backward's block of a cluster that owns (image b, channels
// [c0, c0 + span)): rows [rank * rows, min(hw, (rank + 1) * rows)) of x
// and g. dx may be null (x frozen: the sums only), partials may be null
// (scale and bias frozen).
template <typename T, int kBlock>
__global__ void __launch_bounds__(kBlock)
groupnorm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ g,
                     const float* __restrict__ scale,
                     const float* __restrict__ stats, T* __restrict__ dx,
                     float* __restrict__ partials, OnePass p) {
  constexpr int kVec = tyt::Vec16<T>::kVec;
  extern __shared__ __align__(16) unsigned char tile_smem[];
  coop::cluster_group cluster = coop::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int spans = p.c / p.span;
  const int unit = blockIdx.x / p.cluster;
  const int b = unit / spans, c0 = (unit % spans) * p.span;
  const int r0 = rank * p.rows;
  const int nrows = min(p.rows, p.hw - r0);
  const int nv = p.span / kVec;            // 16-byte vectors a row of the span
  const int nv_shift = __ffs(nv) - 1;      // nv is a power of two
  const int col = threadIdx.x & (nv - 1);  // this thread's column, fixed
  const int cgw = p.cg(), ngs = p.span_groups();
  const int slots = reduce_slots(nv, kBlock);
  uint4* xt = reinterpret_cast<uint4*>(tile_smem);  // [rows, nv]
  uint4* gt = xt + p.rows * nv;                     // [rows, nv]
  float* part = reinterpret_cast<float*>(gt + p.rows * nv);  // [2, slots, span]
  float* scaled = part + 2 * slots * p.span;  // [2, span]: scale * (S2, S1)
  float* means = scaled + 2 * p.span;  // [2, ngs]: mean(gs * norm), mean(gs)
  const int count = nrows * nv;
  const size_t first = (static_cast<size_t>(b) * p.hw + r0) * p.c + c0 +
                       col * kVec;
  // Vector i of each tile is row i / nv, column col (kBlock % nv == 0).
  for (int i = threadIdx.x; i < count; i += kBlock) {
    const size_t off = first + static_cast<size_t>(i >> nv_shift) * p.c;
    cp_async16(&xt[i], x + off);
    cp_async16(&gt[i], g + off);
  }
  float sc[kVec], mu[kVec], iv[kVec];  // scale and the forward's statistics
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    const int ch = c0 + col * kVec + j;
    const float* st = stats + (static_cast<size_t>(b) * p.groups + ch / cgw) * 2;
    sc[j] = scale[ch];
    mu[j] = st[0];
    iv[j] = st[1];
  }
  cp_async_wait_all();

  float acc[2][kVec];  // per channel: g * norm (dscale's), g (dbias's)
#pragma unroll
  for (int j = 0; j < kVec; ++j) acc[0][j] = acc[1][j] = 0.f;
  for (int i = threadIdx.x; i < count; i += kBlock) {
    float xv[kVec], gv[kVec];
    tyt::unpack(xt[i], xv);
    tyt::unpack(gt[i], gv);
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      acc[0][j] += gv[j] * ((xv[j] - mu[j]) * iv[j]);
      acc[1][j] += gv[j];
    }
  }
  span_channel_sums<2, kVec, kBlock>(acc, nv, p.span, part);
  cluster.sync();
  // One thread a (quantity, channel): the cluster's sum, this image's
  // share of dscale or dbias, and scale times it for the group means.
  for (int i = threadIdx.x; i < 2 * p.span; i += kBlock) {
    const int q = i / p.span, ch = i - q * p.span;
    const float s = cluster_sum(cluster, part + q * (slots - 1) * p.span + i,
                                p.cluster);
    scaled[i] = scale[c0 + ch] * s;
    if (rank == 0 && partials != nullptr) {
      partials[(static_cast<size_t>(b) * p.c + c0 + ch) * 2 + q] = s;
    }
  }
  cluster_arrive();
  __syncthreads();

  if (dx != nullptr) {
    const float n = static_cast<float>(p.hw) * static_cast<float>(cgw);
    for (int i = threadIdx.x; i < 2 * ngs; i += kBlock) {
      const float* group = scaled + i * cgw;  // q * span + grp * cgw
      float s = 0.f;
      for (int ch = 0; ch < cgw; ++ch) s += group[ch];
      means[i] = s / n;
    }
    __syncthreads();
    float m2[kVec], m1[kVec];  // mean(gs * norm), mean(gs)
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const int grp = (col * kVec + j) / cgw;
      m2[j] = means[grp];
      m1[j] = means[ngs + grp];
    }
    T* dxs = dx + first;
    for (int i = threadIdx.x; i < count; i += kBlock) {
      float xv[kVec], gv[kVec];
      tyt::unpack(xt[i], xv);
      tyt::unpack(gt[i], gv);
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const float norm = (xv[j] - mu[j]) * iv[j];
        xv[j] = iv[j] * (gv[j] * sc[j] - m1[j] - norm * m2[j]);
      }
      tyt::store16(dxs + static_cast<size_t>(i >> nv_shift) * p.c,
                   tyt::pack(xv));
    }
  }
  cluster_wait();
}

bool valid_one_pass(int batch, const OnePass& p, int itemsize, int smem,
                    bool backward) {
  if (batch <= 0 || p.hw <= 0 || p.c <= 0 || p.groups <= 0 ||
      p.c % p.groups != 0) {
    return false;
  }
  if (p.span <= 0 || p.c % p.span != 0 || p.span % p.cg() != 0) return false;
  const int bytes = p.span * itemsize;
  const int nv = bytes / 16;
  if (bytes % 32 != 0 || (p.threads != 128 && p.threads != 256) ||
      nv > p.threads || (nv & (nv - 1)) != 0) {
    return false;
  }
  if (p.cluster < 1 || p.cluster > kMaxCluster || p.rows <= 0) return false;
  if (static_cast<long long>(p.cluster - 1) * p.rows >= p.hw ||
      static_cast<long long>(p.cluster) * p.rows < p.hw) {
    return false;
  }
  if (static_cast<long long>(batch) * (p.c / p.span) * p.cluster > INT_MAX) {
    return false;
  }
  const size_t need = one_pass_smem(p, itemsize, backward);
  return need <= static_cast<size_t>(kMaxSmem) &&
         static_cast<size_t>(smem) == need;
}

// Whether a cluster of this launch can be resident at all
// (cudaOccupancyMaxActiveClusters > 0), memoised by kernel, cluster size
// and shared memory, so that a call inside a graph capture asks nothing.
// Before the first question about a kernel its shared-memory ceiling is
// set once, at the most a block can have: a lower one set later would
// refuse a graph captured earlier at a larger tile.
struct Schedulable {
  const void* kernel;
  unsigned cluster;
  size_t smem;
};

template <typename Kernel>
cudaError_t co_schedulable(Kernel kernel, const cudaLaunchConfig_t& config,
                           bool* ok) {
  static std::mutex lock;
  static std::vector<Schedulable> known;
  static std::vector<const void*> ceilings;
  const Schedulable key{reinterpret_cast<const void*>(kernel),
                        config.attrs[0].val.clusterDim.x,
                        config.dynamicSmemBytes};
  std::lock_guard<std::mutex> guard(lock);
  for (const Schedulable& k : known) {
    if (k.kernel == key.kernel && k.cluster == key.cluster &&
        k.smem == key.smem) {
      *ok = true;
      return cudaSuccess;
    }
  }
  bool ceiling = false;
  for (const void* k : ceilings) ceiling |= k == key.kernel;
  if (!ceiling) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return err;
    ceilings.push_back(key.kernel);
  }
  int clusters = 0;
  const cudaError_t err = cudaOccupancyMaxActiveClusters(&clusters, kernel,
                                                         &config);
  if (err != cudaSuccess) return err;
  *ok = clusters > 0;
  if (*ok) known.push_back(key);
  return cudaSuccess;
}

// One cluster of p.cluster blocks of p.threads threads for each (image,
// span): the one-pass grid of either direction.
template <typename... Params, typename... Args>
int launch_clusters(void (*kernel)(Params...), int batch, const OnePass& p,
                    int smem, cudaStream_t stream, Args... args) {
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = p.cluster;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(batch * (p.c / p.span) * p.cluster);
  config.blockDim = dim3(p.threads);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  config.attrs = &cluster;
  config.numAttrs = 1;
  bool ok = false;
  const cudaError_t err = co_schedulable(kernel, config, &ok);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaLaunchKernelEx(&config, kernel, args...));
}

template <typename T>
int forward_one_pass(const void* x, const float* scale, const float* bias,
                     void* y, float* stats, int batch, const OnePass& p,
                     int smem, float eps, cudaStream_t stream) {
  auto kernel = p.threads == 128 ? groupnorm_fwd_kernel<T, 128>
                                 : groupnorm_fwd_kernel<T, 256>;
  return launch_clusters(kernel, batch, p, smem, stream,
                         static_cast<const T*>(x), scale, bias,
                         static_cast<T*>(y), stats, p, eps);
}

template <typename T>
int backward_one_pass(const void* x, const void* g, const float* scale,
                      const float* stats, void* dx, float* partials,
                      int batch, const OnePass& p, int smem,
                      cudaStream_t stream) {
  auto kernel = p.threads == 128 ? groupnorm_bwd_kernel<T, 128>
                                 : groupnorm_bwd_kernel<T, 256>;
  return launch_clusters(kernel, batch, p, smem, stream,
                         static_cast<const T*>(x), static_cast<const T*>(g),
                         scale, stats, static_cast<T*>(dx), partials, p);
}

// ---------------------------------------------------------------------------
// dscale and dbias from the backward's partials
// ---------------------------------------------------------------------------

constexpr int kSumRows = 8;  // threads down the partials' rows

// The n rows of partials [n, C, 2] (n images, or images x chunks) summed
// into dscale and dbias (param_grads.cuh).
__global__ void __launch_bounds__(tyt::kSumCols * kSumRows)
groupnorm_param_grads_kernel(const float* __restrict__ partials, int n,
                             int c, float* __restrict__ dscale,
                             float* __restrict__ dbias) {
  tyt::sum_param_partials<kSumRows>(partials, n, c, dscale, dbias);
}

// ---------------------------------------------------------------------------
// Forward and backward, two launches
// ---------------------------------------------------------------------------

struct Shape {
  int hw, c, groups, rows_per_chunk, chunks;
  __device__ int cg() const { return c / groups; }
  // Threads across channels (tx) and down rows (ty).
  __device__ int tx_count() const { return c < kThreads ? c : kThreads; }
  __device__ int ty_count() const { return kThreads / tx_count(); }
};

// Block (chunk, image) sums q1 and q2 over its rows. kBwd = false: q1 =
// x - shift, q2 = q1^2, per group into [B, chunks, G, 2]. kBwd = true:
// q1 = g * norm with the forward's (mean, inv) from stats, q2 = g, per
// channel into [B, chunks, C, 2].
template <typename T, bool kBwd>
__global__ void __launch_bounds__(kThreads)
groupnorm_reduce_kernel(const T* __restrict__ x, const T* __restrict__ g,
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
      float shift = 0.f, mean = 0.f, inv = 0.f;
      if (kBwd) {
        mean = stats[(b * s.groups + grp) * 2];
        inv = stats[(b * s.groups + grp) * 2 + 1];
      } else {
        shift = tyt::to_float(x[base + grp * cg]);
      }
#pragma unroll 4
      for (int r = r0 + ty; r < r1; r += tyn) {
        const size_t off = base + static_cast<size_t>(r) * s.c + c;
        if (kBwd) {
          const float gv = tyt::to_float(g[off]);
          q1 += gv * ((tyt::to_float(x[off]) - mean) * inv);
          q2 += gv;
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
      if (kBwd) {
        float* out = partials +
            ((static_cast<size_t>(b) * s.chunks + chunk) * s.c + c) * 2;
        out[0] = q1;
        out[1] = q2;
      } else {
        thread_sums[2 * tx] = q1;
        thread_sums[2 * tx + 1] = q2;
      }
    }
    __syncthreads();
    if (kBwd) continue;
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
  if (kBwd) return;
  float* out = partials + (static_cast<size_t>(b) * s.chunks + chunk) * 2 * s.groups;
  for (int i = threadIdx.x; i < 2 * s.groups; i += kThreads) {
    out[i] = group_sums[i];
  }
}

// Block (chunk, image) folds its image's partials into per-group
// statistics, then writes its rows. kBwd = false: y from (mean, inv),
// and chunk 0 stores them in stats. kBwd = true: dx from the forward's
// stats and the means of gs and gs * norm, each a sum over the group's
// channels of scale times the reduction's per-channel sums.
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
  for (int grp = threadIdx.x; grp < s.groups; grp += kThreads) {
    float q1 = 0.f, q2 = 0.f;
    if (kBwd) {
      const float* part = partials + static_cast<size_t>(b) * s.chunks * s.c * 2;
      for (int k = 0; k < s.chunks; ++k) {
        for (int c = grp * cg; c < (grp + 1) * cg; ++c) {
          const float sc = scale[c];
          q1 += sc * part[(static_cast<size_t>(k) * s.c + c) * 2 + 1];
          q2 += sc * part[(static_cast<size_t>(k) * s.c + c) * 2];
        }
      }
      smem[2 * grp] = q1 / n;  // mean(gs)
      smem[2 * grp + 1] = q2 / n;  // mean(gs * norm)
    } else {
      const float* part = partials + static_cast<size_t>(b) * s.chunks * 2 * s.groups;
      for (int k = 0; k < s.chunks; ++k) {
        q1 += part[(k * s.groups + grp) * 2];
        q2 += part[(k * s.groups + grp) * 2 + 1];
      }
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
      xt, nullptr, nullptr, partials, s);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  groupnorm_apply_kernel<T, false><<<grid, kThreads, apply_smem(s), stream>>>(
      xt, nullptr, scale, bias, partials, stats, static_cast<T*>(y), s, eps);
  return static_cast<int>(cudaGetLastError());
}

// The reduction always (its partials feed the parameter sums too), the
// apply pass only where dx is wanted.
template <typename T>
int backward(const void* x, const void* g, const float* scale,
             const float* stats, void* dx, float* partials, int batch,
             Shape s, cudaStream_t stream) {
  const dim3 grid(s.chunks, batch);
  const T* xt = static_cast<const T*>(x);
  const T* gt = static_cast<const T*>(g);
  groupnorm_reduce_kernel<T, true><<<grid, kThreads, reduce_smem(s), stream>>>(
      xt, gt, stats, partials, s);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || dx == nullptr) return static_cast<int>(err);
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
// (written: mean, inv). The plan is groupnorm_plan's: chunks == 0 is the
// one-pass launch (clusters of `cluster` blocks of `threads` threads
// over `span` channels, `rows` rows and `smem` bytes a block; partials
// unused), else the two launches over `chunks` chunks of `rows` rows with
// partials [B, chunks, G, 2] f32 scratch (span == C, cluster 1, threads
// 256, smem 0).
extern "C" int tyt_groupnorm(const void* x, const float* scale,
                             const float* bias, void* y, float* stats,
                             float* partials, int batch, int hw, int c,
                             int groups, int span, int cluster, int rows,
                             int chunks, int threads, int smem, float eps,
                             int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype != tyt::kBFloat16 && dtype != tyt::kFloat32) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool bf16 = dtype == tyt::kBFloat16;
  if (chunks == 0) {
    const OnePass p{hw, c, groups, span, cluster, rows, threads};
    const int itemsize = bf16 ? 2 : 4;
    if (!valid_one_pass(batch, p, itemsize, smem, false) ||
        !tyt::aligned_to(x, 16) || !tyt::aligned_to(y, 16)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    return bf16 ? forward_one_pass<__nv_bfloat16>(x, scale, bias, y, stats,
                                                  batch, p, smem, eps, st)
                : forward_one_pass<float>(x, scale, bias, y, stats, batch, p,
                                          smem, eps, st);
  }
  const Shape s{hw, c, groups, rows, chunks};
  if (!valid(batch, s) || span != c || cluster != 1 || threads != kThreads ||
      smem != 0 || partials == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return bf16 ? forward<__nv_bfloat16>(x, scale, bias, y, stats, partials,
                                       batch, s, eps, st)
              : forward<float>(x, scale, bias, y, stats, partials, batch, s,
                               eps, st);
}

// The backward: g (the cotangent of y) and dx have x's dtype; scale [C]
// f32; stats [B, G, 2] the forward's; dscale, dbias [C] f32. dx, dscale
// and dbias may each be null (not wanted), not all three. The plan is
// groupnorm_plan(..., backward=True)'s: chunks == 0 is the one-pass
// launch with partials [B, C, 2] f32 scratch (null when neither dscale
// nor dbias is wanted), else the reduce and apply launches with partials
// [B, chunks, C, 2]; then, for dscale or dbias, the parameter sums.
extern "C" int tyt_groupnorm_bwd(const void* x, const void* g,
                                 const float* scale, const float* stats,
                                 void* dx, float* partials, float* dscale,
                                 float* dbias, int batch, int hw, int c,
                                 int groups, int span, int cluster, int rows,
                                 int chunks, int threads, int smem, int dtype,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool params = dscale != nullptr || dbias != nullptr;
  if ((dtype != tyt::kBFloat16 && dtype != tyt::kFloat32) ||
      (dx == nullptr && !params) || (params && partials == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool bf16 = dtype == tyt::kBFloat16;
  int status;
  int rows_of_partials;
  if (chunks == 0) {
    const OnePass p{hw, c, groups, span, cluster, rows, threads};
    if (!valid_one_pass(batch, p, bf16 ? 2 : 4, smem, true) ||
        !tyt::aligned_to(x, 16) || !tyt::aligned_to(g, 16) ||
        !tyt::aligned_to(dx, 16)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    status = bf16 ? backward_one_pass<__nv_bfloat16>(x, g, scale, stats, dx,
                                                     partials, batch, p, smem,
                                                     st)
                  : backward_one_pass<float>(x, g, scale, stats, dx, partials,
                                             batch, p, smem, st);
    rows_of_partials = batch;
  } else {
    const Shape s{hw, c, groups, rows, chunks};
    if (!valid(batch, s) || span != c || cluster != 1 ||
        threads != kThreads || smem != 0 || partials == nullptr) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    status = bf16 ? backward<__nv_bfloat16>(x, g, scale, stats, dx, partials,
                                            batch, s, st)
                  : backward<float>(x, g, scale, stats, dx, partials, batch,
                                    s, st);
    rows_of_partials = batch * chunks;
  }
  if (status != 0 || !params) return status;
  groupnorm_param_grads_kernel<<<tyt::param_grads_blocks(c),
                                 tyt::kSumCols * kSumRows, 0, st>>>(
      partials, rows_of_partials, c, dscale, dbias);
  return static_cast<int>(cudaGetLastError());
}
