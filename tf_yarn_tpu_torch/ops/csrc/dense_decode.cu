// Dense int8 decode attention: one query token per batch row attends
// over the first lengths[b] rows of a dense int8 KV cache.
//
// Replaces the TPU kernel tf_yarn_tpu/ops/decode_attention.py:
// _decode_kernel, as launched by int8_decode_attention.
//
// Layout (the JAX package's dense cache):
//   q        [batch, n_heads, head_dim]              bf16 or f32
//   caches   [batch, seq_len, n_kv, head_dim]        int8
//   scales   [batch, seq_len, n_kv, 1]               f32 (one per row)
//   lengths  [batch] int32, out like q
// Dead positions (pos >= lengths[b]) get -inf logits and their V rows
// weigh exactly 0 (their scales may be NaN garbage); the normaliser is
// clamped at 1e-30, so a row of length 0 comes out zero.
//
// Per-row lengths: the TPU kernel takes one scalar length for the batch
// (scalar prefetch); the JAX dense slot grid calls it under vmap, which
// gives every slot its own. Here the lengths are a device vector.
//
// Bound and design: decode_split.cuh, shared with the paged kernel. The
// TPU kernel walked each row's sequence serially in 512-row tiles with
// one program per row; on the card the sequence is split across blocks
// and the last split of each row and kv head merges them, as in the paged
// kernel. The dense layout needs no table: row pos of batch row b is
// b * seq_len + pos (DenseLayout), so a tile is any run of positions.
#include "decode_split.cuh"

// part_acc [batch, n_heads, n_splits, head_dim] and part_ml [batch,
// n_heads, n_splits, 2] are f32 scratch from the caller; n_splits *
// kSplitRows must cover seq_len. tickets [batch * n_kv] are zero on entry
// and left zero (see decode_split.cuh). head_dim must be 128, and (dtype,
// n_heads / n_kv) bf16 with 4 or f32 with 2.
extern "C" int tyt_dense_decode_attention(
    const void* q, const int8_t* kcache, const float* kscale,
    const int8_t* vcache, const float* vscale, const int* lengths,
    void* out, float* part_acc, float* part_ml, unsigned* tickets, int batch,
    int n_heads, int n_kv, int head_dim, int seq_len, int n_splits,
    float softmax_scale, int dtype, void* stream) {
  namespace d = tyt::decode;
  if (batch <= 0) return 0;
  if (seq_len <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const d::DenseLayout layout{seq_len};
  return d::dispatch(dtype, q, kcache, kscale, vcache, vscale, layout,
                     lengths, out, part_acc, part_ml, tickets, batch, 1,
                     n_heads, n_kv, head_dim, seq_len, 0, n_splits,
                     softmax_scale, stream);
}
