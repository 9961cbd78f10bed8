// Paged int8 window attention: decode attention read straight off the
// paged int8 KV block pool.
//
// Replaces the TPU kernel tf_yarn_tpu/ops/decode_attention.py:
// _paged_decode_kernel, as launched by paged_int8_decode_attention and by
// its window wrapper paged_int8_window_attention.
//
// Layout (the JAX package's, unchanged):
//   q        [slots * width, n_heads, head_dim]       bf16 or f32
//   pools    [num_blocks, block_size, n_kv, head_dim] int8
//   scales   [num_blocks, sb, n_kv, 1]                f32, sb = block_size
//            (a scale a row) or 1 (a scale a block, quantize_int8_grouped's
//            per-(block, head) layout)
//   tables   [slots, max_blocks] int32, lengths [slots] int32
//   out      like q
// Virtual slot v = slot * width + w attends over the first
//   lengths[slot] + w + length_offset
// logical positions of its slot (length_offset = 1 for the window form:
// the window's own rows are already in the pool; 0 for the one-token form).
//
// The kernel (one launch: splits, then a merge by the last split), its
// bound and its design are in decode_split.cuh, shared with the dense
// kernel (dense_decode.cu): this file gives it the block table as the row
// address (PagedLayout). The TPU wrapper's virtual slots (a jnp.repeat of
// the tables) are folded into the grid; each block reads its own table
// row (the TPU fed it by scalar prefetch).
#include "decode_split.cuh"

// part_acc [slots * width, n_heads, n_splits, head_dim] and part_ml
// [slots * width, n_heads, n_splits, 2] are f32 scratch from the caller;
// n_splits * kSplitRows must cover max_blocks * block_size. tickets
// [slots * width * n_kv] are zero on entry and left zero (see
// decode_split.cuh). scale_rows is the scale pools' sb: block_size or 1. head_dim must be 128, and (dtype, n_heads / n_kv)
// bf16 with 4 or f32 with 2.
extern "C" int tyt_paged_window_attention(
    const void* q, const int8_t* kpool, const float* kscale,
    const int8_t* vpool, const float* vscale, const int* tables,
    const int* lengths, void* out, float* part_acc, float* part_ml,
    unsigned* tickets, int slots, int width, int n_heads, int n_kv,
    int head_dim, int block_size, int scale_rows, int max_blocks,
    int length_offset, int n_splits, float softmax_scale, int dtype,
    void* stream) {
  namespace d = tyt::decode;
  if (slots <= 0 || width <= 0) return 0;
  // block_size a power of two <= 128: the kernel indexes with shifts.
  if (block_size <= 0 || d::kTileRows % block_size != 0 || max_blocks <= 0 ||
      (scale_rows != block_size && scale_rows != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int bs_shift = 0;
  while ((1 << bs_shift) < block_size) ++bs_shift;
  const d::PagedLayout layout{tables, max_blocks, bs_shift,
                              scale_rows == 1 ? bs_shift : 0};
  return d::dispatch(dtype, q, kpool, kscale, vpool, vscale, layout, lengths,
                     out, part_acc, part_ml, tickets, slots, width, n_heads,
                     n_kv, head_dim, max_blocks * block_size, length_offset,
                     n_splits, softmax_scale, stream);
}
