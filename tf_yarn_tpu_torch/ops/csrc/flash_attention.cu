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
// core operations, ~300 flops per byte moved. The causal forward at B 1,
// H 32 is 34.4 GFLOP: 34.76 us at the card's 989 bf16 TFLOP/s; dq's
// three products are 51.6 GFLOP: 52.14 us; dk/dv's four 68.7 GFLOP:
// 69.52 us.
//
// bf16 forward (FlashAttention-3's shape, without its ping-pong): one block
// of three warpgroups per (batch*head, 128-row q tile), one block per SM.
// A producer warp issues every load by TMA from 4-D tensor maps of the
// public layouts (zero-filled past S or Skv, so tails need only logit
// masks): Q once, K and V through a two-stage ring of 128-row tiles
// guarded by full / empty mbarriers, dead causal tiles never loaded. The
// producer warpgroup gives its registers to the two consumer warpgroups
// (setmaxnreg 40 / 232), each owning 64 q rows: S = Q.K^T by wgmma
// m64n128k16 with both operands in shared memory under the 128-byte
// swizzle, the online softmax on the accumulator's registers, then
// O += P.V by wgmma with P packed to bf16 in registers as the A operand
// and V, MN-major, read with the transpose bit. The epilogue stages o
// through shared memory for 16-byte row stores.
//
// bf16 dk/dv (FlashAttention-3's backward shape, with kv rows as M): one
// block of three warpgroups per (batch*kv head, 128-row kv tile, half),
// one block per SM. A producer warp loads K and V once by TMA (128-row
// boxes), then streams each step's Q and dO (64-row boxes) with its 64
// LSE and delta values through a two-stage ring; dead causal q tiles are
// never loaded. A kv tile's steps are every q head of the GQA group times
// every live 64-row q tile; the two blocks of a tile take equal halves of
// that list (a cut between q heads for an even group, between q tiles
// otherwise), so at B 1, S 2048, H 32/8 the 256 blocks carry 64 to 4
// steps, heaviest first, and no SM holds more than ~1/132 of the work
// plus one block. The consumer warpgroups (setmaxnreg 232) each own 64
// kv rows; per step S^T = K.Q^T and dP^T = V.dO^T by wgmma m64n64k16
// from shared memory, P^T = exp2(S^T scale log2 e - lse log2 e) on the
// accumulator while dP^T runs, dS^T = P^T (dP^T - delta), then
// dV += P^T.dO and dK += dS^T.Q by wgmma m64nDk16 with P^T and dS^T
// packed to bf16 in registers as A (the accumulator's layout is the A
// fragment's) and dO and Q MN-major under the transpose bit. Registers
// a consumer thread holds at D 128: dK 64 + dV 64 + S^T 32 + dP^T 32
// f32. The two halves' f32 partials meet in a workspace the wrapper
// allocates: the first block to finish (a ticket from a per-tile
// counter) writes its partial and sets a flag with release semantics;
// the second waits on it with acquire semantics, adds, and writes bf16
// through shared memory. Two addends commute exactly, so dk and dv are
// bitwise the same from call to call; nothing adds into the outputs
// atomically.
//
// bf16 dq (dk/dv's shape with the roles of the two sequences swapped):
// one block of three warpgroups per (batch*head, 128-row q tile), one
// block per SM, heaviest causal tiles first. A producer warp loads Q and
// dO once by TMA (128-row boxes), then streams the kv head's K and V in
// 64-row boxes through a two-stage ring; dead causal kv tiles are never
// loaded. The consumer warpgroups (setmaxnreg 232) each own 64 q rows
// and hold their LSE and delta in registers; per step S = Q.K^T and
// dP = dO.V^T by wgmma m64n64k16 from shared memory, P = exp2(S scale
// log2 e - lse log2 e) on the accumulator while dP runs, dS = P (dP -
// delta) packed to bf16 in registers as A, then dq += dS.K by wgmma
// m64nDk16 with K MN-major under the transpose bit. Registers a consumer
// thread holds at D 128: dq 64 + S 32 + dP 32 f32 + dS 16. A q tile's dq
// sums only over the kv tiles its own block walks, so nothing is split
// and nothing is added atomically: dq is bitwise the same from call to
// call. The epilogue stages dq through shared memory for 16-byte rows.
//
// Every bf16 kernel keeps logits in log2 units (scale * log2 e folded into
// one multiply) so each exponential is one exp2, evaluates the mask only
// on tiles that cross the causal diagonal or a tail, and launches the
// heaviest causal tiles first. Dead causal tiles are never loaded.
//
// f32 (the card-vs-CPU reference type, and never TF32): one warp per row
// on the CUDA cores, the lanes splitting head_dim, one key (or query) at
// a time with an exact online softmax. Simple and slow; the training
// path runs bf16.
#include <cuda.h>

#include "common.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr float kNegInf = -1e30f;
constexpr int kWarps = 4;  // f32 kernels: one row a warp
constexpr int kThreads = kWarps * 32;
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
  float* partial;  // bf16 dk/dv: scratch of the two-partial sum
  int* tickets;
  int s_q, s_kv, heads, kv_heads, group;
  float scale;
  int causal;
};

__host__ __device__ __forceinline__ int ceil_div(int a, int b) { return (a + b - 1) / b; }

// Round two f32 to bf16 (nearest even) and pack them, lo in the low half.
__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// ---------------------------------------------------------------------------
// bf16 forward: TMA loads, wgmma products, one producer warp
// ---------------------------------------------------------------------------

constexpr int kFwdRows = 128;     // q rows of a block; kv rows of a K/V tile
constexpr int kFwdConsumers = 2;  // consumer warpgroups, 64 q rows each
constexpr int kFwdThreads = 128 * (1 + kFwdConsumers);
constexpr int kStages = 2;        // K/V ring depth
constexpr int kSlabCols = 64;     // one 128-byte TMA box / swizzle row of bf16

// What the forward kernel reads: the 4-D tensor maps (D, heads, seq,
// batch) of q, k and v, whose boxes are 64 columns x 1 head x 128 rows x
// 1 batch with the 128-byte swizzle, and the plain pointers it writes.
struct FwdParams {
  CUtensorMap q, k, v;
  bf16* o;
  float* lse;
  int s_q, s_kv, heads, group;
  float scale_log2;
  int causal;
};

// Shared memory, from a 1024-byte aligned base (the 128-byte swizzle
// repeats every 8 rows of 128 bytes): Q, then kStages K tiles, then
// kStages V tiles, then the barriers. A tile is D / 64 slabs of 128 rows
// x 128 bytes, one per TMA box.
template <int D>
struct FwdSmem {
  static constexpr int kSlab = kFwdRows * 128;
  static constexpr int kTile = kSlab * (D / kSlabCols);
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kTile;
  static constexpr int kV = kK + kStages * kTile;
  static constexpr int kBar = kV + kStages * kTile;
  // q_full, k_full[kStages], v_full[kStages], empty[kStages].
  static constexpr int kBytes = kBar + 8 * (1 + 3 * kStages) + 1024;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}

// Arrive once and expect `bytes` more of TMA traffic on the barrier.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Spin until the barrier's phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One box of a 4-D tensor map into shared memory at `dst`, its bytes
// reported to `bar`. Rows past the tensor's extent arrive as zeros.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1, int c2,
                                            int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// A wgmma shared-memory descriptor with the 128-byte swizzle: start
// address, leading and stride byte offsets, each in 16-byte units.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16 |
         static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32 |
         static_cast<uint64_t>(1) << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most N committed wgmma groups are still in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// 2^x by the special-function unit alone, without the fix-up for
// results below 2^-126: those flush to zero, far under what a bf16 p or
// the f32 row sum can show.
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Pins accumulator registers in place around an asynchronous wgmma, so
// the compiler neither reads them early nor moves writes past its launch.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64] (+)= A[64, 16] . B[16, 128] (scale-d = accumulate), A and B
// K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a,
                                            uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d[64] (+)= A[64, 16] . B[16, 128], A in registers (bf16x2 fragments),
// B MN-major in shared memory (the transpose bit set).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(accumulate));
}

// d[32] (+)= A[64, 16] . B[16, 64], A in registers (bf16x2 fragments),
// B MN-major in shared memory (the transpose bit set).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(accumulate));
}


// kv tiles the 128-row q tile at q0 attends to.
__device__ __forceinline__ int fwd_kv_tiles(int q0, const FwdParams& p) {
  int n = ceil_div(p.s_kv, kFwdRows);
  if (p.causal) n = min(n, ceil_div(min(q0 + kFwdRows, p.s_q), kFwdRows));
  return n;
}

// One block per (batch * head, 128-row q tile). Warpgroup 0 is the
// producer: one thread issues every TMA load (Q once, then K and V
// through a kStages ring guarded by full / empty barriers) and the
// warpgroup gives its registers to the consumers. Warpgroups 1 and 2
// each own 64 q rows: S = Q.K^T by wgmma from shared memory, the online
// softmax on the accumulator's registers, O += P.V by wgmma with P from
// registers, then the epilogue.
template <int D>
__global__ void __launch_bounds__(kFwdThreads, 1)
flash_fwd_bf16(const __grid_constant__ FwdParams p) {
  using L = FwdSmem<D>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t q_full = base + L::kBar;
  const auto k_full = [&](int s) { return q_full + 8 * (1 + s); };
  const auto v_full = [&](int s) { return q_full + 8 * (1 + kStages + s); };
  const auto empty = [&](int s) { return q_full + 8 * (1 + 2 * kStages + s); };

  const int bh = blockIdx.x, b = bh / p.heads, h = bh % p.heads;
  const int hk = h / p.group;
  // Causal work grows with the q tile: the grid's slow axis launches the
  // heaviest tiles of every head first.
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kFwdRows;
  const int n_tiles = fwd_kv_tiles(q0, p);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(empty(s), 128 * kFwdConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, L::kTile);
      for (int c = 0; c < D / kSlabCols; ++c) {
        tma_load_4d(base + L::kQ + c * L::kSlab, &p.q, q_full, c * kSlabCols, h,
                    q0, b);
      }
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kStages;
        // The first kStages uses of the ring find it empty.
        mbar_wait(empty(s), ((it / kStages) & 1) ^ 1);
        const uint32_t k_dst = base + L::kK + s * L::kTile;
        const uint32_t v_dst = base + L::kV + s * L::kTile;
        mbar_expect_tx(k_full(s), L::kTile);
        for (int c = 0; c < D / kSlabCols; ++c) {
          tma_load_4d(k_dst + c * L::kSlab, &p.k, k_full(s), c * kSlabCols, hk,
                      it * kFwdRows, b);
        }
        mbar_expect_tx(v_full(s), L::kTile);
        for (int c = 0; c < D / kSlabCols; ++c) {
          tma_load_4d(v_dst + c * L::kSlab, &p.v, v_full(s), c * kSlabCols, hk,
                      it * kFwdRows, b);
        }
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");

  const int cw = wg - 1;  // consumer warpgroup: q rows [64 cw, 64 cw + 64)
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = q0 + 64 * cw + 16 * warp;  // this warp's first row
  const int r_lo = row0 + g, r_hi = r_lo + 8;
  // This warpgroup's 64 rows of every Q slab (8 KB, 1024-byte aligned).
  const uint32_t q_base = base + L::kQ + cw * 64 * 128;

  float o[D / 2];  // m64nD accumulator: element 4j + e is n8 chunk j
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {kNegInf, kNegInf};  // running max of rows r_lo, r_hi (log2)
  float l[2] = {0.f, 0.f};
  const float scale_log2 = p.scale_log2;
  mbar_wait(q_full, 0);

  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % kStages, phase = (it / kStages) & 1;
    const uint32_t k_base = base + L::kK + s * L::kTile;
    const uint32_t v_base = base + L::kV + s * L::kTile;

    // S = Q.K^T: both K-major; stepping 16 columns inside a 128-byte
    // swizzle row adds 32 bytes, a new slab adds kSlab. 8-row groups are
    // 1024 bytes apart.
    float sc[64];
    mbar_wait(k_full(s), phase);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk / 4) * L::kSlab + (kk % 4) * 32;
      wgmma_ss_n128(sc, desc_sw128(q_base + off, 16, 1024),
                    desc_sw128(k_base + off, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);

    // Logits in log2 units (scale * log2 e), so each exp is one exp2.
    // Only a tile crossing the diagonal or the kv tail takes the masked
    // loop (rows past S are never stored, and their zero Q rows keep
    // them finite).
    const int k0 = it * kFwdRows;
    const bool edge = k0 + kFwdRows > p.s_kv ||
                      (p.causal && k0 + kFwdRows - 1 > row0);
    float mx[2] = {kNegInf, kNegInf};
    if (edge) {
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        const int r = (i & 2) ? r_hi : r_lo;
        const int k = k0 + (i / 4) * 8 + 2 * t + (i & 1);
        const bool live = k < p.s_kv && (!p.causal || r >= k);
        sc[i] = live ? sc[i] * scale_log2 : kNegInf;
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
      }
    } else {
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        sc[i] *= scale_log2;
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
      }
    }
    float corr[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float m_new = fmaxf(m[j], quad_max(mx[j]));
      corr[j] = exp2_ftz(m[j] - m_new);
      m[j] = m_new;
    }
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      sc[i] = exp2_ftz(sc[i] - m[(i >> 1) & 1]);
      rs[(i >> 1) & 1] += sc[i];
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) l[j] = l[j] * corr[j] + quad_sum(rs[j]);
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= corr[(i >> 1) & 1];
    // p cast to V's dtype before P.V. The accumulator's n8 chunks 2c and
    // 2c + 1 are the A fragment of k16 chunk c.
    uint32_t pa[8][4];
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      pa[c][0] = pack_f32(sc[8 * c], sc[8 * c + 1]);
      pa[c][1] = pack_f32(sc[8 * c + 2], sc[8 * c + 3]);
      pa[c][2] = pack_f32(sc[8 * c + 4], sc[8 * c + 5]);
      pa[c][3] = pack_f32(sc[8 * c + 6], sc[8 * c + 7]);
    }

    // O += P.V: V's tile is [kv, D] with D contiguous, MN-major for B.
    // 16 kv rows are 2048 bytes; the next 64 columns of D are the next
    // slab (leading offset), the next 8 kv rows 1024 bytes on (stride).
    mbar_wait(v_full(s), phase);
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const uint64_t v_desc = desc_sw128(v_base + c * 2048, L::kSlab, 1024);
      if constexpr (D == 64) {
        wgmma_rs_n64(o, pa[c], v_desc, 1);
      } else {
        wgmma_rs_n128(o, pa[c], v_desc, 1);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    mbar_arrive(empty(s));
  }

  // Epilogue: o / l rounded to bf16 into this warpgroup's (now free) Q
  // rows, with the same swizzle, then 16-byte rows out to [B, S, H, D].
  const float inv[2] = {1.f / fmaxf(l[0], 1e-30f), 1.f / fmaxf(l[1], 1e-30f)};
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + cw) : "memory");
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = 16 * warp + g + 8 * half;  // of this warpgroup's 64
      const int chunk = (j % 8) ^ (row % 8);
      unsigned char* dst = smem + L::kQ + (j / 8) * L::kSlab +
                           (64 * cw + row) * 128 + chunk * 16 + 4 * t;
      *reinterpret_cast<uint32_t*>(dst) =
          pack_f32(o[4 * j + 2 * half] * inv[half], o[4 * j + 2 * half + 1] * inv[half]);
    }
  }
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + cw) : "memory");
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  for (int i = tid; i < 64 * kChunks; i += 128) {
    const int row = i / kChunks, c = i % kChunks;
    const int q = q0 + 64 * cw + row;
    if (q >= p.s_q) break;  // rows only grow with i
    const unsigned char* src = smem + L::kQ + (c / 8) * L::kSlab +
                               (64 * cw + row) * 128 + ((c % 8) ^ (row % 8)) * 16;
    *reinterpret_cast<uint4*>(p.o + ((static_cast<size_t>(b) * p.s_q + q) * p.heads + h) * D +
                              c * 8) = *reinterpret_cast<const uint4*>(src);
  }
  if (t == 0) {
    float* lse = p.lse + static_cast<size_t>(bh) * p.s_q;
    if (r_lo < p.s_q) lse[r_lo] = m[0] * kLn2 + logf(fmaxf(l[0], 1e-30f));
    if (r_hi < p.s_q) lse[r_hi] = m[1] * kLn2 + logf(fmaxf(l[1], 1e-30f));
  }
}

// ---------------------------------------------------------------------------
// bf16 dk/dv: TMA loads, wgmma products, one producer warp, two blocks a
// kv tile
// ---------------------------------------------------------------------------

constexpr int kDkvRows = 128;   // kv rows of a block (64 per consumer)
constexpr int kDkvQRows = 64;   // q rows of a step
constexpr int kDkvStages = 2;   // Q / dO ring depth
constexpr int kDkvSplits = 2;   // blocks sharing one kv tile's steps
static_assert(kDkvSplits == 1 || kDkvSplits == 2,
              "the partial sum is a + b: exactly two addends");

// What the dk/dv kernel reads: the 4-D tensor maps of q and dO (64-row
// boxes) and of k and v (128-row boxes), the LSE and delta, and the
// scratch of the two-partial sum, which the wrapper allocates: `partial`
// holds one f32 dk and dv tile per kv tile, in the consumers' register
// order; `tickets` [tiles, 2] (zeroed) the arrival ticket and the flag
// that says the first block's partial is written.
struct DkvParams {
  CUtensorMap q, k, v, dout;
  const float* lse;
  const float* delta;
  bf16* dk;
  bf16* dv;
  float* partial;
  int* tickets;
  int s_q, s_kv, heads, kv_heads, group;
  float scale, scale_log2;
  int causal;
};

// Shared memory from a 1024-byte aligned base: K and V (D / 64 slabs of
// 128 rows x 128 bytes each), then kDkvStages Q tiles and kDkvStages dO
// tiles (slabs of 64 rows), then each stage's 64 LSE (log2 units) and 64
// delta values, then the barriers and the ticket.
template <int D>
struct DkvSmem {
  static constexpr int kSlabKv = kDkvRows * 128;
  static constexpr int kSlabQ = kDkvQRows * 128;
  static constexpr int kTileKv = kSlabKv * (D / kSlabCols);
  static constexpr int kTileQ = kSlabQ * (D / kSlabCols);
  static constexpr int kK = 0;
  static constexpr int kV = kK + kTileKv;
  static constexpr int kQ = kV + kTileKv;
  static constexpr int kDo = kQ + kDkvStages * kTileQ;
  static constexpr int kStat = kDo + kDkvStages * kTileQ;
  static constexpr int kStatBytes = 2 * kDkvQRows * 4;
  static constexpr int kBar = kStat + kDkvStages * kStatBytes;
  // kv_full, full[kDkvStages], empty[kDkvStages], then the ticket.
  static constexpr int kTicket = kBar + 8 * (1 + 2 * kDkvStages);
  static constexpr int kBytes = kTicket + 16 + 1024;
};

// d[32] (+)= A[64, 16] . B[16, 64], A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a,
                                            uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d[D / 2] += A[64, 16] . B[16, D], A in registers, B MN-major.
template <int D>
__device__ __forceinline__ void wgmma_rs_nd(float (&d)[D / 2], const uint32_t (&a)[4],
                                           uint64_t b) {
  if constexpr (D == 64) {
    wgmma_rs_n64(d, a, b, 1);
  } else {
    wgmma_rs_n128(d, a, b, 1);
  }
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// One block per (batch * kv head, 128-row kv tile, split). The steps of a
// kv tile are every q head of the group times every live 64-row q tile,
// flattened head-major; split s takes the s-th of kDkvSplits runs of
// equal count (a cut between q heads when the group is even, between q
// tiles otherwise). Warpgroup 0 is the producer: K and V once, then Q,
// dO, the LSE and delta of each step through a kDkvStages ring. The two
// consumer warpgroups each own 64 kv rows and keep dK and dV in
// registers: per step S^T = K.Q^T and dP^T = V.dO^T from shared memory,
// P^T and dS^T on the accumulators, then dV += P^T.dO and dK += dS^T.Q
// with P^T and dS^T as register A operands.
template <int D>
__global__ void __launch_bounds__(kFwdThreads, 1)
flash_dkv_bf16(const __grid_constant__ DkvParams p) {
  using L = DkvSmem<D>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t kv_full = base + L::kBar;
  const auto full = [&](int s) { return kv_full + 8 * (1 + s); };
  const auto empty = [&](int s) { return kv_full + 8 * (1 + kDkvStages + s); };

  const int bhk = blockIdx.x / kDkvSplits, split = blockIdx.x % kDkvSplits;
  const int b = bhk / p.kv_heads, hk = bhk % p.kv_heads;
  // Causal work shrinks as kv0 grows: the grid's slow axis launches the
  // heaviest tiles of every head first.
  const int kv0 = blockIdx.y * kDkvRows;
  const int q_first = p.causal ? kv0 / kDkvQRows : 0;
  const int per_head = max(0, ceil_div(p.s_q, kDkvQRows) - q_first);
  const int n_all = p.group * per_head;
  const int j0 = n_all * split / kDkvSplits;
  const int n_steps = n_all * (split + 1) / kDkvSplits - j0;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kDkvStages; ++s) {
      mbar_init(full(s), 32);  // the producer warp's lanes
      mbar_init(empty(s), 128 * 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x < 32 && n_steps > 0) {
      const int lane = threadIdx.x;
      if (lane == 0) {
        mbar_expect_tx(kv_full, 2 * L::kTileKv);
        for (int c = 0; c < D / kSlabCols; ++c) {
          tma_load_4d(base + L::kK + c * L::kSlabKv, &p.k, kv_full, c * kSlabCols, hk,
                      kv0, b);
          tma_load_4d(base + L::kV + c * L::kSlabKv, &p.v, kv_full, c * kSlabCols, hk,
                      kv0, b);
        }
      }
      for (int it = 0; it < n_steps; ++it) {
        const int s = it % kDkvStages, j = j0 + it;
        const int h = hk * p.group + j / per_head;
        const int qr0 = (q_first + j % per_head) * kDkvQRows;
        // Each lane brings two rows' LSE (in log2 units) and delta; rows
        // past S read as zero (their logits are masked).
        const size_t stat = static_cast<size_t>(b * p.heads + h) * p.s_q;
        float lse2[2], dl[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int q = qr0 + lane + 32 * r;
          lse2[r] = q < p.s_q ? p.lse[stat + q] * kLog2e : 0.f;
          dl[r] = q < p.s_q ? p.delta[stat + q] : 0.f;
        }
        // The first kDkvStages uses of the ring find it empty.
        mbar_wait(empty(s), ((it / kDkvStages) & 1) ^ 1);
        float* st = reinterpret_cast<float*>(smem + L::kStat + s * L::kStatBytes);
        st[lane] = lse2[0];
        st[lane + 32] = lse2[1];
        st[kDkvQRows + lane] = dl[0];
        st[kDkvQRows + lane + 32] = dl[1];
        if (lane == 0) {
          // Lane 0's arrival carries the expected TMA bytes.
          mbar_expect_tx(full(s), 2 * L::kTileQ);
          for (int c = 0; c < D / kSlabCols; ++c) {
            tma_load_4d(base + L::kQ + s * L::kTileQ + c * L::kSlabQ, &p.q, full(s),
                        c * kSlabCols, h, qr0, b);
            tma_load_4d(base + L::kDo + s * L::kTileQ + c * L::kSlabQ, &p.dout,
                        full(s), c * kSlabCols, h, qr0, b);
          }
        } else {
          mbar_arrive(full(s));
        }
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");

  const int cw = wg - 1;  // consumer warpgroup: kv rows [kv0 + 64 cw, +64)
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int kvw0 = kv0 + 64 * cw;
  const int r_lo = kvw0 + 16 * warp + g, r_hi = r_lo + 8;
  // This warpgroup's 64 rows of every K and V slab (8 KB, 1024-aligned).
  const uint32_t k_base = base + L::kK + cw * 64 * 128;
  const uint32_t v_base = base + L::kV + cw * 64 * 128;
  const float scale_log2 = p.scale_log2;

  float dk[D / 2], dv[D / 2];  // m64nD accumulators: element 4j + e is n8 chunk j
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
  if (n_steps > 0) mbar_wait(kv_full, 0);

  for (int it = 0; it < n_steps; ++it) {
    const int s = it % kDkvStages, j = j0 + it;
    const int qr0 = (q_first + j % per_head) * kDkvQRows;
    const uint32_t q_base = base + L::kQ + s * L::kTileQ;
    const uint32_t do_base = base + L::kDo + s * L::kTileQ;
    mbar_wait(full(s), (it / kDkvStages) & 1);
    // No live pair: these kv rows lie past Skv, or after every q row of
    // the tile. The stage is still waited for, so the release counts in
    // its own phase.
    if (kvw0 >= p.s_kv || (p.causal && qr0 + kDkvQRows <= kvw0)) {
      mbar_arrive(empty(s));
      continue;
    }

    // S^T = K.Q^T and dP^T = V.dO^T, all K-major (as the forward's Q.K^T;
    // a Q or dO slab is 64 rows, so its 8-row groups are 1024 bytes apart
    // as in a K slab).
    float sc[32], dp[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off_kv = (kk / 4) * L::kSlabKv + (kk % 4) * 32;
      const uint32_t off_q = (kk / 4) * L::kSlabQ + (kk % 4) * 32;
      wgmma_ss_n64(sc, desc_sw128(k_base + off_kv, 16, 1024),
                   desc_sw128(q_base + off_q, 16, 1024), kk > 0);
    }
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off_kv = (kk / 4) * L::kSlabKv + (kk % 4) * 32;
      const uint32_t off_q = (kk / 4) * L::kSlabQ + (kk % 4) * 32;
      wgmma_ss_n64(dp, desc_sw128(v_base + off_kv, 16, 1024),
                   desc_sw128(do_base + off_q, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(sc);

    // P^T = exp2(S^T scale log2 e - lse log2 e) while dP^T runs. Column
    // (q) of element 4j + e: 8j + 2t + (e & 1); row (kv): r_lo, or r_hi
    // when e & 2. Only a tile crossing the diagonal or the q tail takes
    // the masked loop.
    const float* stat = reinterpret_cast<const float*>(smem + L::kStat + s * L::kStatBytes);
    const bool edge = qr0 + kDkvQRows > p.s_q || (p.causal && qr0 < kvw0 + 63);
    if (edge) {
#pragma unroll
      for (int jn = 0; jn < 8; ++jn) {
        const float2 l2 = *reinterpret_cast<const float2*>(stat + 8 * jn + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * jn + e;
          const int q = qr0 + 8 * jn + 2 * t + (e & 1);
          const int r = (e & 2) ? r_hi : r_lo;
          const bool live = q < p.s_q && (!p.causal || q >= r);
          sc[i] = live ? exp2_ftz(sc[i] * scale_log2 - ((e & 1) ? l2.y : l2.x)) : 0.f;
        }
      }
    } else {
#pragma unroll
      for (int jn = 0; jn < 8; ++jn) {
        const float2 l2 = *reinterpret_cast<const float2*>(stat + 8 * jn + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * jn + e;
          sc[i] = exp2_ftz(sc[i] * scale_log2 - ((e & 1) ? l2.y : l2.x));
        }
      }
    }
    wgmma_wait<0>();
    fence_regs(dp);

    // dS^T = P^T (dP^T - delta); p rounded to dO's dtype for dV, ds to
    // q's for dK. The accumulator's n8 chunks 2c and 2c + 1 are the A
    // fragment of k16 chunk c.
    uint32_t pa[4][4], da[4][4];
#pragma unroll
    for (int jn = 0; jn < 8; ++jn) {
      const float2 d2 = *reinterpret_cast<const float2*>(stat + kDkvQRows + 8 * jn + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * jn + e;
        dp[i] = sc[i] * (dp[i] - ((e & 1) ? d2.y : d2.x));
      }
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        pa[c][f] = pack_f32(sc[8 * c + 2 * f], sc[8 * c + 2 * f + 1]);
        da[c][f] = pack_f32(dp[8 * c + 2 * f], dp[8 * c + 2 * f + 1]);
      }
    }

    // dV += P^T.dO and dK += dS^T.Q: dO and Q are [q, D] with D
    // contiguous, MN-major for B. 16 q rows are 2048 bytes; the next 64
    // columns of D are the next slab (leading offset), the next 8 q rows
    // 1024 bytes on (stride).
    fence_regs(dv);
    fence_regs(dk);
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      wgmma_rs_nd<D>(dv, pa[c], desc_sw128(do_base + c * 2048, L::kSlabQ, 1024));
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      wgmma_rs_nd<D>(dk, da[c], desc_sw128(q_base + c * 2048, L::kSlabQ, 1024));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dv);
    fence_regs(dk);
    mbar_arrive(empty(s));
  }

  if constexpr (kDkvSplits == 2) {
    // The two blocks of a kv tile meet. The first to finish takes ticket
    // 0, writes its f32 partial in its registers' order and publishes a
    // flag; the second adds that partial to its own and writes bf16.
    // With two addends a + b == b + a, so the result does not depend on
    // which arrives first. The second block can wait, because the first
    // has already finished its steps.
    const int tile = bhk * gridDim.y + blockIdx.y;
    int* ticket = p.tickets + 2 * tile;
    int* slot = reinterpret_cast<int*>(smem + L::kTicket);
    named_sync(3, 256);
    if (threadIdx.x == 128) *slot = atomicAdd(ticket, 1);
    named_sync(3, 256);
    const int mine = *reinterpret_cast<volatile int*>(slot);
    float4* part = reinterpret_cast<float4*>(p.partial) +
                   (static_cast<size_t>(tile) * 2 + cw) * (D / 4) * 128 + tid;
    if (mine == 0) {
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        __stcg(part + i * 128, make_float4(dk[4 * i], dk[4 * i + 1], dk[4 * i + 2],
                                           dk[4 * i + 3]));
        __stcg(part + (D / 8 + i) * 128, make_float4(dv[4 * i], dv[4 * i + 1],
                                                     dv[4 * i + 2], dv[4 * i + 3]));
      }
      __threadfence();
      named_sync(3, 256);
      if (threadIdx.x == 128) st_release(ticket + 1, 1);
      return;
    }
    if (threadIdx.x == 128) {
      while (ld_acquire(ticket + 1) == 0) {
      }
    }
    named_sync(3, 256);
    (void)ld_acquire(ticket + 1);
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      const float4 a = __ldcg(part + i * 128);
      const float4 c = __ldcg(part + (D / 8 + i) * 128);
      dk[4 * i] += a.x;
      dk[4 * i + 1] += a.y;
      dk[4 * i + 2] += a.z;
      dk[4 * i + 3] += a.w;
      dv[4 * i] += c.x;
      dv[4 * i + 1] += c.y;
      dv[4 * i + 2] += c.z;
      dv[4 * i + 3] += c.w;
    }
  }

  // Epilogue: dk * scale and dv rounded to bf16 into this warpgroup's
  // (now free) K and V rows, with the same swizzle, then 16-byte rows out
  // to [B, Skv, Hkv, D].
  const float scale = p.scale;
  named_sync(1 + cw, 128);
#pragma unroll
  for (int jn = 0; jn < D / 8; ++jn) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = 16 * warp + g + 8 * half;  // of this warpgroup's 64
      const int off = (jn / 8) * L::kSlabKv + (64 * cw + row) * 128 +
                      ((jn % 8) ^ (row % 8)) * 16 + 4 * t;
      const int i = 4 * jn + 2 * half;
      *reinterpret_cast<uint32_t*>(smem + L::kK + off) =
          pack_f32(dk[i] * scale, dk[i + 1] * scale);
      *reinterpret_cast<uint32_t*>(smem + L::kV + off) = pack_f32(dv[i], dv[i + 1]);
    }
  }
  named_sync(1 + cw, 128);
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  for (int i = tid; i < 64 * kChunks; i += 128) {
    const int row = i / kChunks, c = i % kChunks;
    const int kv = kvw0 + row;
    if (kv >= p.s_kv) break;  // rows only grow with i
    const int off = (c / 8) * L::kSlabKv + (64 * cw + row) * 128 + ((c % 8) ^ (row % 8)) * 16;
    const size_t out = ((static_cast<size_t>(b) * p.s_kv + kv) * p.kv_heads + hk) * D + c * 8;
    *reinterpret_cast<uint4*>(p.dk + out) = *reinterpret_cast<const uint4*>(smem + L::kK + off);
    *reinterpret_cast<uint4*>(p.dv + out) = *reinterpret_cast<const uint4*>(smem + L::kV + off);
  }
}

// ---------------------------------------------------------------------------
// bf16 dq: TMA loads, wgmma products, one producer warp
// ---------------------------------------------------------------------------

constexpr int kDqRows = 128;    // q rows of a block (64 per consumer)
constexpr int kDqKvRows = 64;   // kv rows of a step: S and dP are m64n64 products
constexpr int kDqStages = 2;    // K / V ring depth

// What the dq kernel reads: the 4-D tensor maps of q and dO (128-row
// boxes) and of k and v (kDqKvRows-row boxes), the LSE and delta, and
// the plain pointer it writes.
struct DqParams {
  CUtensorMap q, dout, k, v;
  const float* lse;
  const float* delta;
  bf16* dq;
  int s_q, s_kv, heads, group;
  float scale, scale_log2;
  int causal;
};

// Shared memory from a 1024-byte aligned base: Q and dO (D / 64 slabs of
// 128 rows x 128 bytes each), then kDqStages K tiles and kDqStages V
// tiles (slabs of kDqKvRows rows), then the barriers.
template <int D>
struct DqSmem {
  static constexpr int kSlabQ = kDqRows * 128;
  static constexpr int kSlabKv = kDqKvRows * 128;
  static constexpr int kTileQ = kSlabQ * (D / kSlabCols);
  static constexpr int kTileKv = kSlabKv * (D / kSlabCols);
  static constexpr int kQ = 0;
  static constexpr int kDo = kQ + kTileQ;
  static constexpr int kK = kDo + kTileQ;
  static constexpr int kV = kK + kDqStages * kTileKv;
  static constexpr int kBar = kV + kDqStages * kTileKv;
  // q_full, full[kDqStages], empty[kDqStages].
  static constexpr int kBytes = kBar + 8 * (1 + 2 * kDqStages) + 1024;
};

// One block per (batch * head, 128-row q tile), heaviest causal tiles
// first. Warpgroup 0 is the producer: Q and dO once, then K and V of the
// kv head through a kDqStages ring, dead causal kv tiles never loaded.
// The two consumer warpgroups each own 64 q rows and keep dq in
// registers: per step S = Q.K^T and dP = dO.V^T from shared memory, P on
// S's accumulator while dP runs, dS = P (dP - delta), then dq += dS.K
// with dS as the register A operand and K MN-major.
template <int D>
__global__ void __launch_bounds__(kFwdThreads, 1)
flash_dq_bf16(const __grid_constant__ DqParams p) {
  using L = DqSmem<D>;
  constexpr int N = kDqKvRows;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t q_full = base + L::kBar;
  const auto full = [&](int s) { return q_full + 8 * (1 + s); };
  const auto empty = [&](int s) { return q_full + 8 * (1 + kDqStages + s); };

  const int bh = blockIdx.x, b = bh / p.heads, h = bh % p.heads;
  const int hk = h / p.group;
  // Causal work grows with the q tile: the grid's slow axis launches the
  // heaviest tiles of every head first.
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kDqRows;
  const int n_all = ceil_div(p.s_kv, N);
  const int n_tiles = p.causal ? min(n_all, ceil_div(min(q0 + kDqRows, p.s_q), N)) : n_all;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kDqStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 128 * 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, 2 * L::kTileQ);
      for (int c = 0; c < D / kSlabCols; ++c) {
        tma_load_4d(base + L::kQ + c * L::kSlabQ, &p.q, q_full, c * kSlabCols, h, q0, b);
        tma_load_4d(base + L::kDo + c * L::kSlabQ, &p.dout, q_full, c * kSlabCols, h, q0,
                    b);
      }
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kDqStages;
        // The first kDqStages uses of the ring find it empty.
        mbar_wait(empty(s), ((it / kDqStages) & 1) ^ 1);
        mbar_expect_tx(full(s), 2 * L::kTileKv);
        for (int c = 0; c < D / kSlabCols; ++c) {
          tma_load_4d(base + L::kK + s * L::kTileKv + c * L::kSlabKv, &p.k, full(s),
                      c * kSlabCols, hk, it * N, b);
          tma_load_4d(base + L::kV + s * L::kTileKv + c * L::kSlabKv, &p.v, full(s),
                      c * kSlabCols, hk, it * N, b);
        }
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");

  const int cw = wg - 1;  // consumer warpgroup: q rows [q0 + 64 cw, +64)
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int qw0 = q0 + 64 * cw;
  const int row0 = qw0 + 16 * warp;  // this warp's first row
  const int r_lo = row0 + g, r_hi = r_lo + 8;
  // kv tiles with a live pair for these 64 rows: none past S; under the
  // mask, none after the last row.
  const int n_mine = qw0 >= p.s_q ? 0
                     : p.causal   ? min(n_all, ceil_div(min(qw0 + 64, p.s_q), N))
                                  : n_all;
  // This warpgroup's 64 rows of every Q and dO slab (8 KB, 1024-aligned).
  const uint32_t q_base = base + L::kQ + cw * 64 * 128;
  const uint32_t do_base = base + L::kDo + cw * 64 * 128;
  const float scale_log2 = p.scale_log2;
  // Rows past S read as zero: their Q and dO rows are zeros, so their dS
  // is 0 and nothing of them is stored.
  const float* lse = p.lse + static_cast<size_t>(bh) * p.s_q;
  const float* delta = p.delta + static_cast<size_t>(bh) * p.s_q;
  const float lse2[2] = {r_lo < p.s_q ? lse[r_lo] * kLog2e : 0.f,
                         r_hi < p.s_q ? lse[r_hi] * kLog2e : 0.f};
  const float dl[2] = {r_lo < p.s_q ? delta[r_lo] : 0.f, r_hi < p.s_q ? delta[r_hi] : 0.f};

  float dq[D / 2];  // m64nD accumulator: element 4j + e is n8 chunk j
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
  mbar_wait(q_full, 0);

  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % kDqStages;
    mbar_wait(full(s), (it / kDqStages) & 1);
    // No live pair for these rows: the stage is still waited for, so the
    // release counts in its own phase.
    if (it >= n_mine) {
      mbar_arrive(empty(s));
      continue;
    }
    const uint32_t k_base = base + L::kK + s * L::kTileKv;
    const uint32_t v_base = base + L::kV + s * L::kTileKv;

    // S = Q.K^T and dP = dO.V^T, all K-major: stepping 16 columns inside
    // a 128-byte swizzle row adds 32 bytes, a new slab adds its size;
    // 8-row groups are 1024 bytes apart.
    float sc[N / 2], dp[N / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off_q = (kk / 4) * L::kSlabQ + (kk % 4) * 32;
      const uint32_t off_kv = (kk / 4) * L::kSlabKv + (kk % 4) * 32;
      wgmma_ss_n64(sc, desc_sw128(q_base + off_q, 16, 1024),
                   desc_sw128(k_base + off_kv, 16, 1024), kk > 0);
    }
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off_q = (kk / 4) * L::kSlabQ + (kk % 4) * 32;
      const uint32_t off_kv = (kk / 4) * L::kSlabKv + (kk % 4) * 32;
      wgmma_ss_n64(dp, desc_sw128(do_base + off_q, 16, 1024),
                   desc_sw128(v_base + off_kv, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(sc);

    // P = exp2(S scale log2 e - lse log2 e) while dP runs. Column (kv)
    // of element 4j + e: 8j + 2t + (e & 1); row (q): r_lo, or r_hi when
    // e & 2. Only a tile crossing the diagonal or the kv tail takes the
    // masked loop.
    const int k0 = it * N;
    const bool edge = k0 + N > p.s_kv || (p.causal && k0 + N - 1 > row0);
    if (edge) {
#pragma unroll
      for (int i = 0; i < N / 2; ++i) {
        const int k = k0 + (i / 4) * 8 + 2 * t + (i & 1);
        const int r = (i & 2) ? r_hi : r_lo;
        const bool live = k < p.s_kv && (!p.causal || r >= k);
        sc[i] = live ? exp2_ftz(sc[i] * scale_log2 - lse2[(i >> 1) & 1]) : 0.f;
      }
    } else {
#pragma unroll
      for (int i = 0; i < N / 2; ++i) {
        sc[i] = exp2_ftz(sc[i] * scale_log2 - lse2[(i >> 1) & 1]);
      }
    }
    wgmma_wait<0>();
    fence_regs(dp);

    // dS = P (dP - delta), rounded to K's dtype before dS.K. The
    // accumulator's n8 chunks 2c and 2c + 1 are the A fragment of k16
    // chunk c.
    uint32_t da[N / 16][4];
#pragma unroll
    for (int c = 0; c < N / 16; ++c) {
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        const int i = 8 * c + 2 * f;
        da[c][f] = pack_f32(sc[i] * (dp[i] - dl[f & 1]), sc[i + 1] * (dp[i + 1] - dl[f & 1]));
      }
    }

    // dq += dS.K: K's tile is [kv, D] with D contiguous, MN-major for B.
    // 16 kv rows are 2048 bytes; the next 64 columns of D are the next
    // slab (leading offset), the next 8 kv rows 1024 bytes on (stride).
    fence_regs(dq);
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < N / 16; ++c) {
      wgmma_rs_nd<D>(dq, da[c], desc_sw128(k_base + c * 2048, L::kSlabKv, 1024));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dq);
    mbar_arrive(empty(s));
  }
  if (qw0 >= p.s_q) return;

  // Epilogue: dq * scale rounded to bf16 into this warpgroup's (now
  // free) Q rows, with the same swizzle, then 16-byte rows out to
  // [B, S, H, D].
  const float scale = p.scale;
  named_sync(1 + cw, 128);
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = 16 * warp + g + 8 * half;  // of this warpgroup's 64
      const int off = (j / 8) * L::kSlabQ + (64 * cw + row) * 128 +
                      ((j % 8) ^ (row % 8)) * 16 + 4 * t;
      *reinterpret_cast<uint32_t*>(smem + L::kQ + off) =
          pack_f32(dq[4 * j + 2 * half] * scale, dq[4 * j + 2 * half + 1] * scale);
    }
  }
  named_sync(1 + cw, 128);
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  for (int i = tid; i < 64 * kChunks; i += 128) {
    const int row = i / kChunks, c = i % kChunks;
    const int q = qw0 + row;
    if (q >= p.s_q) break;  // rows only grow with i
    const int off = (c / 8) * L::kSlabQ + (64 * cw + row) * 128 + ((c % 8) ^ (row % 8)) * 16;
    *reinterpret_cast<uint4*>(p.dq + ((static_cast<size_t>(b) * p.s_q + q) * p.heads + h) * D +
                              c * 8) = *reinterpret_cast<const uint4*>(smem + L::kQ + off);
  }
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

// cuTensorMapEncodeTiled, reached through the runtime so that the
// library needs no link against libcuda.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t status = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t status = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    return status == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(ptr)
               : nullptr;
  }();
  return fn;
}

// A contiguous bf16 [batch, seq, heads, D] as the 4-D map (D, heads, seq,
// batch) of 64 x 1 x `rows` x 1 boxes with the 128-byte swizzle; boxes
// reaching past seq are filled with zeros.
bool encode_bshd(CUtensorMap* map, const void* ptr, int batch, int seq,
                 int heads, int d, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t row = static_cast<cuuint64_t>(d) * sizeof(bf16);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(seq), static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {row, row * heads, row * heads * seq};
  const cuuint32_t box[4] = {kSlabCols, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
                dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch_fwd_bf16(const FlashArgs& a, int batch, cudaStream_t stream) {
  FwdParams p;
  if (!encode_bshd(&p.q, a.q, batch, a.s_q, a.heads, D, kFwdRows) ||
      !encode_bshd(&p.k, a.k, batch, a.s_kv, a.kv_heads, D, kFwdRows) ||
      !encode_bshd(&p.v, a.v, batch, a.s_kv, a.kv_heads, D, kFwdRows)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  p.o = static_cast<bf16*>(a.out);
  p.lse = a.lse_out;
  p.s_q = a.s_q;
  p.s_kv = a.s_kv;
  p.heads = a.heads;
  p.group = a.group;
  p.scale_log2 = a.scale * kLog2e;
  p.causal = a.causal;
  constexpr int smem = FwdSmem<D>::kBytes;
  const cudaError_t status = cudaFuncSetAttribute(
      flash_fwd_bf16<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (status != cudaSuccess) return static_cast<int>(status);
  const dim3 grid(batch * a.heads, ceil_div(a.s_q, kFwdRows));
  flash_fwd_bf16<D><<<grid, kFwdThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dkv_bf16(const FlashArgs& a, int batch, cudaStream_t stream) {
  if (kDkvSplits > 1 && (a.partial == nullptr || a.tickets == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  DkvParams p;
  if (!encode_bshd(&p.q, a.q, batch, a.s_q, a.heads, D, kDkvQRows) ||
      !encode_bshd(&p.dout, a.dout, batch, a.s_q, a.heads, D, kDkvQRows) ||
      !encode_bshd(&p.k, a.k, batch, a.s_kv, a.kv_heads, D, kDkvRows) ||
      !encode_bshd(&p.v, a.v, batch, a.s_kv, a.kv_heads, D, kDkvRows)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  p.lse = a.lse_in;
  p.delta = a.delta;
  p.dk = static_cast<bf16*>(a.dk);
  p.dv = static_cast<bf16*>(a.dv);
  p.partial = a.partial;
  p.tickets = a.tickets;
  p.s_q = a.s_q;
  p.s_kv = a.s_kv;
  p.heads = a.heads;
  p.kv_heads = a.kv_heads;
  p.group = a.group;
  p.scale = a.scale;
  p.scale_log2 = a.scale * kLog2e;
  p.causal = a.causal;
  constexpr int smem = DkvSmem<D>::kBytes;
  const cudaError_t status = cudaFuncSetAttribute(
      flash_dkv_bf16<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (status != cudaSuccess) return static_cast<int>(status);
  const dim3 grid(batch * a.kv_heads * kDkvSplits, ceil_div(a.s_kv, kDkvRows));
  flash_dkv_bf16<D><<<grid, kFwdThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dq_bf16(const FlashArgs& a, int batch, cudaStream_t stream) {
  DqParams p;
  if (!encode_bshd(&p.q, a.q, batch, a.s_q, a.heads, D, kDqRows) ||
      !encode_bshd(&p.dout, a.dout, batch, a.s_q, a.heads, D, kDqRows) ||
      !encode_bshd(&p.k, a.k, batch, a.s_kv, a.kv_heads, D, kDqKvRows) ||
      !encode_bshd(&p.v, a.v, batch, a.s_kv, a.kv_heads, D, kDqKvRows)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  p.lse = a.lse_in;
  p.delta = a.delta;
  p.dq = static_cast<bf16*>(a.out);
  p.s_q = a.s_q;
  p.s_kv = a.s_kv;
  p.heads = a.heads;
  p.group = a.group;
  p.scale = a.scale;
  p.scale_log2 = a.scale * kLog2e;
  p.causal = a.causal;
  constexpr int smem = DqSmem<D>::kBytes;
  const cudaError_t status = cudaFuncSetAttribute(
      flash_dq_bf16<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (status != cudaSuccess) return static_cast<int>(status);
  const dim3 grid(batch * a.heads, ceil_div(a.s_q, kDqRows));
  flash_dq_bf16<D><<<grid, kFwdThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
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
  if (dtype == tyt::kBFloat16) {
    if (pass == kForward) return launch_fwd_bf16<D>(args, batch, stream);
    if (pass == kDkv) return launch_dkv_bf16<D>(args, batch, stream);
    return launch_dq_bf16<D>(args, batch, stream);
  }
  const int rows = pass == kDkv ? args.s_kv : args.s_q;
  const int bh = batch * (pass == kDkv ? args.kv_heads : args.heads);
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

// dk, dv [B, Skv, Hkv, D], each summed over its kv head's group. bf16
// needs scratch from the caller: `partial`, f32 of B * Hkv * ceil(Skv /
// 128) * 128 * D * 2 elements, and `tickets`, int32 of B * Hkv *
// ceil(Skv / 128) * 2 elements, zeroed (f32 ignores both).
extern "C" int tyt_flash_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const float* lse,
                             const float* delta, void* dk, void* dv,
                             float* partial, int* tickets, int batch,
                             int s_q, int s_kv, int heads, int kv_heads,
                             int head_dim, float scale, int causal,
                             int dtype, void* stream) {
  FlashArgs a = make_args(q, k, v, s_q, s_kv, heads, kv_heads, scale, causal);
  a.dout = dout;
  a.lse_in = lse;
  a.delta = delta;
  a.dk = dk;
  a.dv = dv;
  a.partial = partial;
  a.tickets = tickets;
  return run(kDkv, a, batch, head_dim, dtype, stream);
}
