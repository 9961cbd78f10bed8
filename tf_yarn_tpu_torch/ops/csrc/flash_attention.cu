// Flash attention, forward and backward (dq, then dk/dv), for Hopper.
//
// Replaces the TPU kernels of tf_yarn_tpu/ops/flash_attention.py:
//   flash_fwd_*  <- _fwd_kernel (:80)   online softmax, o and the LSE;
//   flash_dq_*   <- _dq_kernel  (:240)  dq from the LSE and delta;
//   flash_dkv_*  <- _dkv_kernel (:285)  dk, dv summed over the GQA group.
//
// Layouts are the JAX package's public ones, read with strides, so the
// wrapper transposes nothing: q, o, dO, dq [B, S, H, D]; k, v, dk, dv
// [B, Skv, Hkv, D]; the LSE and delta [B*H, S] f32 (the TPU copy
// replicated them over 128 lanes, which the card does not need). Query
// head h reads kv head h / (H / Hkv): K/V are never repeated.
//
// Semantics kept from the TPU kernels: masked logits are -1e30, not -inf;
// softmax_scale multiplies the f32 logits after the dot and is folded
// into dq and dk only at the end; the normaliser is floored at 1e-30
// before the log; causal masking is top-left (query i sees keys <= i,
// also when Skv != S). The four bf16 rounding points are the TPU
// kernels': p to V's dtype before P.V, ds to K's dtype before ds.K, p to
// dO's dtype for dv, ds to q's dtype for dk.
//
// Bound on the H100 at the training shapes (S = 2048, D = 128): tensor-
// core operations, ~300 flops per byte moved. bf16 design (the ordinary
// FlashAttention-2 shape): one block of 4 warps per (batch*head, 64-row
// q tile) for forward and dq, per (batch*kv head, 64-row kv tile) for
// dk/dv; each warp owns 16 rows and runs mma.sync.m16n8k16 bf16 products
// with f32 accumulators, the probabilities staying in registers between
// the two products of a step. The streamed operand (K/V for forward and
// dq, Q/dO with the LSE and delta for dk/dv) comes through shared memory,
// cp.async double-buffered: the next tile's copies are in flight while
// the current one is computed. Fragments come from shared memory by
// ldmatrix (.trans for the operands read by columns: V, K in ds.K, dO and
// Q in dk/dv), on rows padded by 8 elements so each tile hits 32 banks.
// Logits are kept in log2 units (scale * log2 e folded into one multiply)
// so each exponential is one exp2; only tiles that cross the causal
// diagonal or a tail evaluate the mask; the heaviest causal q tiles are
// launched first. Dead causal tiles are never loaded. dk/dv loop over
// every q head of the group and every live q tile inside the block, so
// the group sum needs no atomics and is deterministic. No TMA or wgmma
// yet: those are the next version's.
//
// f32 (the card-vs-CPU reference type, and never TF32): one warp per row
// on the CUDA cores, the lanes splitting head_dim, one key (or query) at
// a time with an exact online softmax. Simple and slow; the training
// path runs bf16.
#include "common.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr float kNegInf = -1e30f;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 64;  // q rows (forward, dq) or kv rows (dk/dv)
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct FlashArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse_in;
  const float* delta;
  void* out;  // o (forward) or dq
  float* lse_out;
  void* dk;
  void* dv;
  int s_q, s_kv, heads, kv_heads, group;
  float scale;
  int causal;
};

__host__ __device__ __forceinline__ int ceil_div(int a, int b) { return (a + b - 1) / b; }

// ---------------------------------------------------------------------------
// bf16: cp.async tiles and mma.sync fragments
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;  // 0 source bytes: the 16 bytes are zeroed
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Rows [r0, r0 + ROWS) of a strided [rows, D] bf16 source into a shared
// tile of row stride D + 8; rows at or past `limit` are zero-filled.
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* base,
                                          size_t row_stride, int r0,
                                          int limit) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < ROWS * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int c = i % kChunks;
    const bool valid = r0 + r < limit;
    const bf16* src = valid ? base + static_cast<size_t>(r0 + r) * row_stride + c * 8
                            : base;
    cp_async16(dst + r * (D + 8) + c * 8, src, valid);
  }
}

// Round two f32 to bf16 (nearest even) and pack them, lo in the low half.
__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ldmatrix: four 8x8 bf16 tiles per instruction, each lane giving the
// address of one tile row (16 bytes; shared rows of D + 8 elements put
// the 8 rows of a tile on 32 distinct banks). `.trans` transposes each
// tile, which turns a row-major [k][n] operand into B fragments.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// A fragment of rows [row0, row0 + 16), columns [k0, k0 + 16) of a
// row-major shared tile of stride LD.
template <int LD>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* s,
                                       int row0, int k0, int lane) {
  ldsm_x4(a, s + (row0 + (lane & 15)) * LD + k0 + (lane >> 4) * 8);
}

// C[16, NT*8] += A[16, KD] . B^T, A rows [row0, row0+16) of shared sa,
// B the first NT*8 rows of shared sb (both of depth KD, stride LD).
template <int NT, int KD, int LD>
__device__ __forceinline__ void mm_nt(float (&c)[NT][4], const bf16* sa,
                                      int row0, const bf16* sb, int lane) {
  const bf16* b_lane = sb + ((lane & 7) + ((lane >> 4) << 3)) * LD +
                       ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int kc = 0; kc < KD / 16; ++kc) {
    uint32_t a[4];
    load_a<LD>(a, sa, row0, kc * 16, lane);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t b[4];
      ldsm_x4(b, b_lane + np * 16 * LD + kc * 16);
      mma(c[2 * np], a, b[0], b[1]);
      mma(c[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// C[16, NT*8] += P[16, KC*16] . B with P in registers (packed fragments)
// and B[k][n] the shared tile's row k, column n.
template <int NT, int KC, int LD>
__device__ __forceinline__ void mm_rn(float (&c)[NT][4],
                                      const uint32_t (&pa)[KC][4],
                                      const bf16* sb, int lane) {
  const bf16* b_lane = sb + ((lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                       (lane >> 4) * 8;
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) {
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t b[4];
      ldsm_x4_t(b, b_lane + kc * 16 * LD + np * 16);
      mma(c[2 * np], pa[kc], b[0], b[1]);
      mma(c[2 * np + 1], pa[kc], b[2], b[3]);
    }
  }
}

// The accumulator fragments of a [16, 2*KC*8] f32 tile, rounded to bf16,
// as the A fragments of the next product (FlashAttention-2's register
// reuse: the C layout of two n-tiles is the A layout of one k-chunk).
template <int KC>
__device__ __forceinline__ void pack_acc(uint32_t (&pa)[KC][4],
                                         const float (&s)[2 * KC][4]) {
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) {
    pa[kc][0] = pack_f32(s[2 * kc][0], s[2 * kc][1]);
    pa[kc][1] = pack_f32(s[2 * kc][2], s[2 * kc][3]);
    pa[kc][2] = pack_f32(s[2 * kc + 1][0], s[2 * kc + 1][1]);
    pa[kc][3] = pack_f32(s[2 * kc + 1][2], s[2 * kc + 1][3]);
  }
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ bool live(int q, int k, const FlashArgs& p) {
  return q < p.s_q && k < p.s_kv && (!p.causal || q >= k);
}

// kv tiles a q tile ending (exclusive) at q_end attends to.
__device__ __forceinline__ int kv_tiles(int q_end, const FlashArgs& p) {
  int n = ceil_div(p.s_kv, kTile);
  if (p.causal) n = min(n, ceil_div(q_end, kTile));
  return n;
}

// Stores a warp's 16-row accumulator tile, times `mul` per row, as bf16
// rows of a strided [rows, D] destination (rows >= limit skipped).
template <int D>
__device__ __forceinline__ void store_rows(bf16* base, size_t row_stride,
                                           const float (&acc)[D / 8][4],
                                           int r_lo, int limit, float mul_lo,
                                           float mul_hi, int t) {
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) {
    const int col = dn * 8 + 2 * t;
    if (r_lo < limit) {
      *reinterpret_cast<uint32_t*>(base + r_lo * row_stride + col) =
          pack_f32(acc[dn][0] * mul_lo, acc[dn][1] * mul_lo);
    }
    if (r_lo + 8 < limit) {
      *reinterpret_cast<uint32_t*>(base + (r_lo + 8) * row_stride + col) =
          pack_f32(acc[dn][2] * mul_hi, acc[dn][3] * mul_hi);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_bf16(FlashArgs p) {
  constexpr int LD = D + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* s_q = reinterpret_cast<bf16*>(smem);
  bf16* s_k = s_q + kTile * LD;      // two buffers
  bf16* s_v = s_k + 2 * kTile * LD;  // two buffers
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, b = bh / p.heads, h = bh % p.heads;
  const int hk = h / p.group;
  // Causal work grows with the q tile: launch the heaviest tiles first.
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile;
  const size_t q_stride = static_cast<size_t>(p.heads) * D;
  const size_t kv_stride = static_cast<size_t>(p.kv_heads) * D;
  const bf16* qb = static_cast<const bf16*>(p.q) +
                   (static_cast<size_t>(b) * p.s_q * p.heads + h) * D;
  const bf16* kb = static_cast<const bf16*>(p.k) +
                   (static_cast<size_t>(b) * p.s_kv * p.kv_heads + hk) * D;
  const bf16* vb = static_cast<const bf16*>(p.v) +
                   (static_cast<size_t>(b) * p.s_kv * p.kv_heads + hk) * D;
  const int n_tiles = kv_tiles(min(q0 + kTile, p.s_q), p);

  load_tile<D, kTile>(s_q, qb, q_stride, q0, p.s_q);
  load_tile<D, kTile>(s_k, kb, kv_stride, 0, p.s_kv);
  load_tile<D, kTile>(s_v, vb, kv_stride, 0, p.s_kv);
  cp_async_commit();

  const int row0 = warp * 16;
  const int r_lo = q0 + row0 + g, r_hi = r_lo + 8;
  float acc[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;
  float m[2] = {kNegInf, kNegInf};  // running max, log2 units
  float l[2] = {0.f, 0.f};
  uint32_t qa[D / 16][4];
  const float scale_log2 = p.scale * kLog2e;

  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) {
      const int nb = (it + 1) & 1;
      load_tile<D, kTile>(s_k + nb * kTile * LD, kb, kv_stride,
                          (it + 1) * kTile, p.s_kv);
      load_tile<D, kTile>(s_v + nb * kTile * LD, vb, kv_stride,
                          (it + 1) * kTile, p.s_kv);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (it == 0) {
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc) load_a<LD>(qa[kc], s_q, row0, kc * 16, lane);
    }
    const bf16* ck = s_k + (it & 1) * kTile * LD;
    const bf16* cv = s_v + (it & 1) * kTile * LD;

    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
    const bf16* k_lane = ck + ((lane & 7) + ((lane >> 4) << 3)) * LD +
                         ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t kb4[4];
        ldsm_x4(kb4, k_lane + np * 16 * LD + kc * 16);
        mma(s[2 * np], qa[kc], kb4[0], kb4[1]);
        mma(s[2 * np + 1], qa[kc], kb4[2], kb4[3]);
      }
    }
    // Logits in log2 units (scale * log2 e), so each exp is one exp2.
    // Only a tile crossing the diagonal or a tail needs the mask.
    const int k0 = it * kTile;
    const bool edge = k0 + kTile > p.s_kv ||
                      (p.causal && k0 + kTile - 1 > q0 + row0);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float v = s[nt][e] * scale_log2;
        if (edge && !live(e < 2 ? r_lo : r_hi, k0 + nt * 8 + 2 * t + (e & 1), p)) {
          v = kNegInf;
        }
        s[nt][e] = v;
        mx[e >> 1] = fmaxf(mx[e >> 1], v);
      }
    }
    float corr[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float m_new = fmaxf(m[i], quad_max(mx[i]));
      corr[i] = exp2f(m[i] - m_new);
      m[i] = m_new;
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = exp2f(s[nt][e] - m[e >> 1]);
        rs[e >> 1] += s[nt][e];
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * corr[i] + quad_sum(rs[i]);
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      acc[dn][0] *= corr[0];
      acc[dn][1] *= corr[0];
      acc[dn][2] *= corr[1];
      acc[dn][3] *= corr[1];
    }
    uint32_t pa[4][4];
    pack_acc<4>(pa, s);  // p cast to V's dtype before P.V
    mm_rn<D / 8, 4, LD>(acc, pa, cv, lane);
    __syncthreads();
  }

  const float l_lo = fmaxf(l[0], 1e-30f), l_hi = fmaxf(l[1], 1e-30f);
  bf16* ob = static_cast<bf16*>(p.out) +
             (static_cast<size_t>(b) * p.s_q * p.heads + h) * D;
  store_rows<D>(ob, q_stride, acc, r_lo, p.s_q, 1.f / l_lo, 1.f / l_hi, t);
  if (t == 0) {
    float* lse = p.lse_out + static_cast<size_t>(bh) * p.s_q;
    if (r_lo < p.s_q) lse[r_lo] = m[0] * kLn2 + logf(l_lo);
    if (r_hi < p.s_q) lse[r_hi] = m[1] * kLn2 + logf(l_hi);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_dq_bf16(FlashArgs p) {
  constexpr int LD = D + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* s_q = reinterpret_cast<bf16*>(smem);
  bf16* s_do = s_q + kTile * LD;
  bf16* s_k = s_do + kTile * LD;     // two buffers
  bf16* s_v = s_k + 2 * kTile * LD;  // two buffers
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, b = bh / p.heads, h = bh % p.heads;
  const int hk = h / p.group;
  // Causal work grows with the q tile: launch the heaviest tiles first.
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile;
  const size_t q_stride = static_cast<size_t>(p.heads) * D;
  const size_t kv_stride = static_cast<size_t>(p.kv_heads) * D;
  const size_t q_off = (static_cast<size_t>(b) * p.s_q * p.heads + h) * D;
  const size_t kv_off = (static_cast<size_t>(b) * p.s_kv * p.kv_heads + hk) * D;
  const bf16* kb = static_cast<const bf16*>(p.k) + kv_off;
  const bf16* vb = static_cast<const bf16*>(p.v) + kv_off;
  const int n_tiles = kv_tiles(min(q0 + kTile, p.s_q), p);

  load_tile<D, kTile>(s_q, static_cast<const bf16*>(p.q) + q_off, q_stride, q0, p.s_q);
  load_tile<D, kTile>(s_do, static_cast<const bf16*>(p.dout) + q_off, q_stride, q0, p.s_q);
  load_tile<D, kTile>(s_k, kb, kv_stride, 0, p.s_kv);
  load_tile<D, kTile>(s_v, vb, kv_stride, 0, p.s_kv);
  cp_async_commit();

  const int row0 = warp * 16;
  const int r_lo = q0 + row0 + g, r_hi = r_lo + 8;
  const float* lse = p.lse_in + static_cast<size_t>(bh) * p.s_q;
  const float* delta = p.delta + static_cast<size_t>(bh) * p.s_q;
  const float scale_log2 = p.scale * kLog2e;
  const float lse_r[2] = {r_lo < p.s_q ? lse[r_lo] * kLog2e : 0.f,
                          r_hi < p.s_q ? lse[r_hi] * kLog2e : 0.f};
  const float dl_r[2] = {r_lo < p.s_q ? delta[r_lo] : 0.f, r_hi < p.s_q ? delta[r_hi] : 0.f};
  float dq[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) dq[dn][0] = dq[dn][1] = dq[dn][2] = dq[dn][3] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) {
      const int nb = (it + 1) & 1;
      load_tile<D, kTile>(s_k + nb * kTile * LD, kb, kv_stride, (it + 1) * kTile, p.s_kv);
      load_tile<D, kTile>(s_v + nb * kTile * LD, vb, kv_stride, (it + 1) * kTile, p.s_kv);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* ck = s_k + (it & 1) * kTile * LD;
    const bf16* cv = s_v + (it & 1) * kTile * LD;
    float s[8][4], dp[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
    }
    mm_nt<8, D, LD>(s, s_q, row0, ck, lane);
    mm_nt<8, D, LD>(dp, s_do, row0, cv, lane);
    const int k0 = it * kTile;
    const bool edge = k0 + kTile > p.s_kv ||
                      (p.causal && k0 + kTile - 1 > q0 + row0);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float logit = s[nt][e] * scale_log2;
        if (edge && !live(e < 2 ? r_lo : r_hi, k0 + nt * 8 + 2 * t + (e & 1), p)) {
          logit = kNegInf;
        }
        const float prob = exp2f(logit - lse_r[e >> 1]);
        s[nt][e] = prob * (dp[nt][e] - dl_r[e >> 1]);  // ds
      }
    }
    uint32_t pa[4][4];
    pack_acc<4>(pa, s);  // ds cast to K's dtype before ds.K
    mm_rn<D / 8, 4, LD>(dq, pa, ck, lane);
    __syncthreads();
  }
  bf16* dqb = static_cast<bf16*>(p.out) + q_off;
  store_rows<D>(dqb, q_stride, dq, r_lo, p.s_q, p.scale, p.scale, t);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_dkv_bf16(FlashArgs p) {
  constexpr int LD = D + 8;
  constexpr int BQ = D == 128 ? 32 : 64;  // q rows per step (registers)
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* s_k = reinterpret_cast<bf16*>(smem);
  bf16* s_v = s_k + kTile * LD;
  bf16* s_q = s_v + kTile * LD;    // two buffers
  bf16* s_do = s_q + 2 * BQ * LD;  // two buffers
  float* s_lse = reinterpret_cast<float*>(s_do + 2 * BQ * LD);  // two buffers
  float* s_dl = s_lse + 2 * BQ;                                  // two buffers
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bhk = blockIdx.y, b = bhk / p.kv_heads, hk = bhk % p.kv_heads;
  const int kv0 = blockIdx.x * kTile;
  const size_t q_stride = static_cast<size_t>(p.heads) * D;
  const size_t kv_stride = static_cast<size_t>(p.kv_heads) * D;
  const size_t kv_off = (static_cast<size_t>(b) * p.s_kv * p.kv_heads + hk) * D;
  const int n_qt = ceil_div(p.s_q, BQ);
  const int qt_start = p.causal ? kv0 / BQ : 0;
  const int per_head = max(0, n_qt - qt_start);
  const int n_steps = p.group * per_head;

  // Step j: q head hk * group + j / per_head, q tile qt_start + j % per_head.
  auto load_step = [&](int j, int buf) {
    const int h = hk * p.group + j / per_head;
    const int qr0 = (qt_start + j % per_head) * BQ;
    const size_t q_off = (static_cast<size_t>(b) * p.s_q * p.heads + h) * D;
    load_tile<D, BQ>(s_q + buf * BQ * LD, static_cast<const bf16*>(p.q) + q_off,
                     q_stride, qr0, p.s_q);
    load_tile<D, BQ>(s_do + buf * BQ * LD, static_cast<const bf16*>(p.dout) + q_off,
                     q_stride, qr0, p.s_q);
    const size_t stat = static_cast<size_t>(b * p.heads + h) * p.s_q;
    const int i = threadIdx.x;
    if (i < 2 * BQ) {
      const int r = i % BQ;
      const bool valid = qr0 + r < p.s_q;
      const float* src = (i < BQ ? p.lse_in : p.delta) + (valid ? stat + qr0 + r : 0);
      cp_async4((i < BQ ? s_lse : s_dl) + buf * BQ + r, src, valid);
    }
  };

  load_tile<D, kTile>(s_k, static_cast<const bf16*>(p.k) + kv_off, kv_stride, kv0, p.s_kv);
  load_tile<D, kTile>(s_v, static_cast<const bf16*>(p.v) + kv_off, kv_stride, kv0, p.s_kv);
  if (n_steps > 0) load_step(0, 0);
  cp_async_commit();

  const int row0 = warp * 16;
  const int r_lo = kv0 + row0 + g, r_hi = r_lo + 8;
  const float scale_log2 = p.scale * kLog2e;
  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[dn][e] = dv[dn][e] = 0.f;
  }

  for (int j = 0; j < n_steps; ++j) {
    if (j + 1 < n_steps) {
      load_step(j + 1, (j + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int buf = j & 1;
    const bf16* cq = s_q + buf * BQ * LD;
    const bf16* cdo = s_do + buf * BQ * LD;
    const float* clse = s_lse + buf * BQ;
    const float* cdl = s_dl + buf * BQ;
    const int qr0 = (qt_start + j % per_head) * BQ;

    // Transposed scores: rows are this warp's 16 kv rows, columns q.
    float s[BQ / 8][4], dpt[BQ / 8][4];
#pragma unroll
    for (int nt = 0; nt < BQ / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dpt[nt][e] = 0.f;
    }
    mm_nt<BQ / 8, D, LD>(s, s_k, row0, cq, lane);
    const bool edge = qr0 + BQ > p.s_q || kv0 + row0 + 16 > p.s_kv ||
                      (p.causal && qr0 < kv0 + row0 + 15);
#pragma unroll
    for (int nt = 0; nt < BQ / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = nt * 8 + 2 * t + (e & 1);
        float logit = s[nt][e] * scale_log2;
        if (edge && !live(qr0 + c, e < 2 ? r_lo : r_hi, p)) logit = kNegInf;
        s[nt][e] = exp2f(logit - clse[c] * kLog2e);  // p^T
      }
    }
    uint32_t pa[BQ / 16][4];
    pack_acc<BQ / 16>(pa, s);  // p cast to dO's dtype for dv
    mm_rn<D / 8, BQ / 16, LD>(dv, pa, cdo, lane);
    mm_nt<BQ / 8, D, LD>(dpt, s_v, row0, cdo, lane);
#pragma unroll
    for (int nt = 0; nt < BQ / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = nt * 8 + 2 * t + (e & 1);
        s[nt][e] = s[nt][e] * (dpt[nt][e] - cdl[c]);  // ds^T
      }
    }
    pack_acc<BQ / 16>(pa, s);  // ds cast to q's dtype for dk
    mm_rn<D / 8, BQ / 16, LD>(dk, pa, cq, lane);
    __syncthreads();
  }
  bf16* dkb = static_cast<bf16*>(p.dk) + kv_off;
  bf16* dvb = static_cast<bf16*>(p.dv) + kv_off;
  store_rows<D>(dkb, kv_stride, dk, r_lo, p.s_kv, p.scale, p.scale, t);
  store_rows<D>(dvb, kv_stride, dv, r_lo, p.s_kv, 1.f, 1.f, t);
}

// ---------------------------------------------------------------------------
// f32: one warp per row, lanes split head_dim (element lane + 32 * j)
// ---------------------------------------------------------------------------

template <int D>
__device__ __forceinline__ float warp_dot(const float (&a)[D / 32],
                                          const float* row, int lane) {
  float acc = 0.f;
#pragma unroll
  for (int j = 0; j < D / 32; ++j) acc += a[j] * row[lane + 32 * j];
  return tyt::warp_sum(acc);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_f32(FlashArgs p) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int bh = blockIdx.y, b = bh / p.heads, h = bh % p.heads;
  const int hk = h / p.group;
  const int row = blockIdx.x * kWarps + warp;
  if (row >= p.s_q) return;
  const size_t q_off = ((static_cast<size_t>(b) * p.s_q + row) * p.heads + h) * D;
  const float* kb = static_cast<const float*>(p.k) +
                    (static_cast<size_t>(b) * p.s_kv * p.kv_heads + hk) * D;
  const float* vb = static_cast<const float*>(p.v) +
                    (static_cast<size_t>(b) * p.s_kv * p.kv_heads + hk) * D;
  const size_t kv_stride = static_cast<size_t>(p.kv_heads) * D;
  float q[D / 32], acc[D / 32];
#pragma unroll
  for (int j = 0; j < D / 32; ++j) {
    q[j] = static_cast<const float*>(p.q)[q_off + lane + 32 * j];
    acc[j] = 0.f;
  }
  const int n_keys = p.causal ? min(row + 1, p.s_kv) : p.s_kv;
  float m = kNegInf, l = 0.f;
  for (int k = 0; k < n_keys; ++k) {
    const float s = warp_dot<D>(q, kb + k * kv_stride, lane) * p.scale;
    const float m_new = fmaxf(m, s);
    const float corr = expf(m - m_new);
    const float prob = expf(s - m_new);
    l = l * corr + prob;
#pragma unroll
    for (int j = 0; j < D / 32; ++j) {
      acc[j] = acc[j] * corr + prob * vb[k * kv_stride + lane + 32 * j];
    }
    m = m_new;
  }
  l = fmaxf(l, 1e-30f);
#pragma unroll
  for (int j = 0; j < D / 32; ++j) {
    static_cast<float*>(p.out)[q_off + lane + 32 * j] = acc[j] / l;
  }
  if (lane == 0) p.lse_out[static_cast<size_t>(bh) * p.s_q + row] = m + logf(l);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_dq_f32(FlashArgs p) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int bh = blockIdx.y, b = bh / p.heads, h = bh % p.heads;
  const int hk = h / p.group;
  const int row = blockIdx.x * kWarps + warp;
  if (row >= p.s_q) return;
  const size_t q_off = ((static_cast<size_t>(b) * p.s_q + row) * p.heads + h) * D;
  const float* kb = static_cast<const float*>(p.k) +
                    (static_cast<size_t>(b) * p.s_kv * p.kv_heads + hk) * D;
  const float* vb = static_cast<const float*>(p.v) +
                    (static_cast<size_t>(b) * p.s_kv * p.kv_heads + hk) * D;
  const size_t kv_stride = static_cast<size_t>(p.kv_heads) * D;
  float q[D / 32], d_o[D / 32], dq[D / 32];
#pragma unroll
  for (int j = 0; j < D / 32; ++j) {
    q[j] = static_cast<const float*>(p.q)[q_off + lane + 32 * j];
    d_o[j] = static_cast<const float*>(p.dout)[q_off + lane + 32 * j];
    dq[j] = 0.f;
  }
  const float lse = p.lse_in[static_cast<size_t>(bh) * p.s_q + row];
  const float delta = p.delta[static_cast<size_t>(bh) * p.s_q + row];
  const int n_keys = p.causal ? min(row + 1, p.s_kv) : p.s_kv;
  for (int k = 0; k < n_keys; ++k) {
    const float s = warp_dot<D>(q, kb + k * kv_stride, lane) * p.scale;
    const float dp = warp_dot<D>(d_o, vb + k * kv_stride, lane);
    const float ds = expf(s - lse) * (dp - delta);
#pragma unroll
    for (int j = 0; j < D / 32; ++j) dq[j] += ds * kb[k * kv_stride + lane + 32 * j];
  }
#pragma unroll
  for (int j = 0; j < D / 32; ++j) {
    static_cast<float*>(p.out)[q_off + lane + 32 * j] = dq[j] * p.scale;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_dkv_f32(FlashArgs p) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int bhk = blockIdx.y, b = bhk / p.kv_heads, hk = bhk % p.kv_heads;
  const int kv = blockIdx.x * kWarps + warp;
  if (kv >= p.s_kv) return;
  const size_t kv_off = ((static_cast<size_t>(b) * p.s_kv + kv) * p.kv_heads + hk) * D;
  const size_t q_stride = static_cast<size_t>(p.heads) * D;
  float k[D / 32], v[D / 32], dk[D / 32], dv[D / 32];
#pragma unroll
  for (int j = 0; j < D / 32; ++j) {
    k[j] = static_cast<const float*>(p.k)[kv_off + lane + 32 * j];
    v[j] = static_cast<const float*>(p.v)[kv_off + lane + 32 * j];
    dk[j] = dv[j] = 0.f;
  }
  for (int gi = 0; gi < p.group; ++gi) {
    const int h = hk * p.group + gi;
    const float* qb = static_cast<const float*>(p.q) +
                      (static_cast<size_t>(b) * p.s_q * p.heads + h) * D;
    const float* dob = static_cast<const float*>(p.dout) +
                       (static_cast<size_t>(b) * p.s_q * p.heads + h) * D;
    const size_t stat = static_cast<size_t>(b * p.heads + h) * p.s_q;
    for (int qi = p.causal ? kv : 0; qi < p.s_q; ++qi) {
      const float s = warp_dot<D>(k, qb + qi * q_stride, lane) * p.scale;
      const float prob = expf(s - p.lse_in[stat + qi]);
      const float dp = warp_dot<D>(v, dob + qi * q_stride, lane);
      const float ds = prob * (dp - p.delta[stat + qi]);
#pragma unroll
      for (int j = 0; j < D / 32; ++j) {
        dv[j] += prob * dob[qi * q_stride + lane + 32 * j];
        dk[j] += ds * qb[qi * q_stride + lane + 32 * j];
      }
    }
  }
#pragma unroll
  for (int j = 0; j < D / 32; ++j) {
    static_cast<float*>(p.dk)[kv_off + lane + 32 * j] = dk[j] * p.scale;
    static_cast<float*>(p.dv)[kv_off + lane + 32 * j] = dv[j];
  }
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

enum Pass { kForward, kDq, kDkv };

template <int D>
size_t smem_bytes(Pass pass) {
  constexpr size_t row = (D + 8) * sizeof(bf16);
  constexpr int bq = D == 128 ? 32 : 64;
  switch (pass) {
    case kForward: return 5 * kTile * row;                // q + 2 k + 2 v
    case kDq: return 6 * kTile * row;                     // q, dO + 2 k + 2 v
    default: return 2 * kTile * row + 4 * bq * row + 4 * bq * sizeof(float);
  }
}

template <typename Kernel>
int launch(Kernel kernel, dim3 grid, size_t smem, const FlashArgs& args,
           cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t status = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (status != cudaSuccess) return static_cast<int>(status);
  }
  kernel<<<grid, kThreads, smem, stream>>>(args);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int dispatch(Pass pass, int dtype, int batch, const FlashArgs& args,
             cudaStream_t stream) {
  const int rows = pass == kDkv ? args.s_kv : args.s_q;
  const int bh = batch * (pass == kDkv ? args.kv_heads : args.heads);
  if (dtype == tyt::kBFloat16) {
    const dim3 grid(ceil_div(rows, kTile), bh);
    const size_t smem = smem_bytes<D>(pass);
    if (pass == kForward) return launch(flash_fwd_bf16<D>, grid, smem, args, stream);
    if (pass == kDq) return launch(flash_dq_bf16<D>, grid, smem, args, stream);
    return launch(flash_dkv_bf16<D>, grid, smem, args, stream);
  }
  if (dtype == tyt::kFloat32) {
    const dim3 grid(ceil_div(rows, kWarps), bh);
    if (pass == kForward) return launch(flash_fwd_f32<D>, grid, 0, args, stream);
    if (pass == kDq) return launch(flash_dq_f32<D>, grid, 0, args, stream);
    return launch(flash_dkv_f32<D>, grid, 0, args, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

int run(Pass pass, FlashArgs args, int batch, int head_dim, int dtype,
        void* stream) {
  if (batch <= 0 || args.s_q <= 0 || args.s_kv <= 0) return 0;
  if (args.kv_heads <= 0 || args.heads % args.kv_heads != 0 ||
      batch * args.heads > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  args.group = args.heads / args.kv_heads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 64) return dispatch<64>(pass, dtype, batch, args, s);
  if (head_dim == 128) return dispatch<128>(pass, dtype, batch, args, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

FlashArgs make_args(const void* q, const void* k, const void* v, int s_q,
                    int s_kv, int heads, int kv_heads, float scale,
                    int causal) {
  FlashArgs a = {};
  a.q = q;
  a.k = k;
  a.v = v;
  a.s_q = s_q;
  a.s_kv = s_kv;
  a.heads = heads;
  a.kv_heads = kv_heads;
  a.scale = scale;
  a.causal = causal;
  return a;
}

}  // namespace

// o [B, S, H, D] in q's dtype and lse [B*H, S] f32.
extern "C" int tyt_flash_fwd(const void* q, const void* k, const void* v,
                             void* o, float* lse, int batch, int s_q,
                             int s_kv, int heads, int kv_heads, int head_dim,
                             float scale, int causal, int dtype,
                             void* stream) {
  FlashArgs a = make_args(q, k, v, s_q, s_kv, heads, kv_heads, scale, causal);
  a.out = o;
  a.lse_out = lse;
  return run(kForward, a, batch, head_dim, dtype, stream);
}

// dq [B, S, H, D]; lse and delta [B*H, S] f32.
extern "C" int tyt_flash_dq(const void* q, const void* k, const void* v,
                            const void* dout, const float* lse,
                            const float* delta, void* dq, int batch, int s_q,
                            int s_kv, int heads, int kv_heads, int head_dim,
                            float scale, int causal, int dtype,
                            void* stream) {
  FlashArgs a = make_args(q, k, v, s_q, s_kv, heads, kv_heads, scale, causal);
  a.dout = dout;
  a.lse_in = lse;
  a.delta = delta;
  a.out = dq;
  return run(kDq, a, batch, head_dim, dtype, stream);
}

// dk, dv [B, Skv, Hkv, D], each summed over its kv head's group.
extern "C" int tyt_flash_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const float* lse,
                             const float* delta, void* dk, void* dv,
                             int batch, int s_q, int s_kv, int heads,
                             int kv_heads, int head_dim, float scale,
                             int causal, int dtype, void* stream) {
  FlashArgs a = make_args(q, k, v, s_q, s_kv, heads, kv_heads, scale, causal);
  a.dout = dout;
  a.lse_in = lse;
  a.delta = delta;
  a.dk = dk;
  a.dv = dv;
  return run(kDkv, a, batch, head_dim, dtype, stream);
}
