"""Decode attention over the paged int8 KV pool — counterpart of
tf_yarn_tpu/ops/decode_attention.py (the paged half).

The pool is the JAX package's layout: K/V values ``[NB, bs, Hkv, D]``
int8 plus per-row f32 scales ``[NB, bs, Hkv, 1]``, a block table
``[S, MB]`` int32 mapping each slot's logical blocks to physical ones,
and ``lengths [S]`` int32. Table entries past a slot's length may point
anywhere; those positions are masked.

CUDA tensors go to the hand-written kernel (csrc/paged_decode.cu, which
replaces the TPU kernel `_paged_decode_kernel`); CPU tensors go to
`paged_int8_window_attention_reference`, the plain version the tests
hold against the JAX package. The dense-cache `int8_decode_attention`
and per-block scales are still to port (ROADMAP.md Queue 2).
"""

from __future__ import annotations

from typing import Optional

import torch

from tf_yarn_tpu_torch.ops import _build

# Positions per split of the kernel's sequence (kSplitRows in
# csrc/paged_decode.cu): the kernel refuses a split count that does not
# cover a slot's table.
SPLIT_ROWS = 256
# The kernel's instantiations: head_dim 128 and, per query dtype, the GQA
# group (n_heads / n_kv) of the configuration the port serves in it.
KERNEL_HEAD_DIM = 128
KERNEL_GROUPS = {torch.bfloat16: 4, torch.float32: 2}


def _check_scales(key_pool, key_scale, value_scale) -> None:
    nb, bs, n_kv, _ = key_pool.shape
    for name, scale in (("key_scale", key_scale), ("value_scale", value_scale)):
        if tuple(scale.shape) != (nb, bs, n_kv, 1):
            raise ValueError(
                f"{name} must carry per-row scales {(nb, bs, n_kv, 1)}, got "
                f"{tuple(scale.shape)} (per-block scales are not ported yet)"
            )


def paged_int8_window_attention_reference(
    query, key_pool, key_scale, value_pool, value_scale, block_tables,
    lengths, *, softmax_scale: Optional[float] = None, length_offset: int = 1,
) -> torch.Tensor:
    """Plain torch version: query [S, W, H, D]; window position w of
    slot s attends over the first ``lengths[s] + w + length_offset``
    positions of its slot's blocks. Returns [S, W, H, D] in query's
    dtype. Same semantics as the kernel — dead positions get -inf
    logits, dead V rows are zeroed before P·V, the normaliser is
    clamped to 1e-30 — computed as one softmax over the gathered rows."""
    _check_scales(key_pool, key_scale, value_scale)
    slots, width, n_heads, head_dim = query.shape
    nb, bs, n_kv, _ = key_pool.shape
    max_blocks = block_tables.shape[1]
    group = n_heads // n_kv
    if softmax_scale is None:
        softmax_scale = head_dim ** -0.5
    tables = block_tables.long()
    positions = max_blocks * bs

    def gather(pool, scale):
        rows = pool[tables].float() * scale[tables]  # [S, MB, bs, Hkv, D]
        return rows.reshape(slots, positions, n_kv, head_dim)

    keys = gather(key_pool, key_scale)
    values = gather(value_pool, value_scale)
    eff = (lengths.long()[:, None] + length_offset
           + torch.arange(width, device=query.device)[None, :])  # [S, W]
    live = (torch.arange(positions, device=query.device)[None, None, :]
            < eff[:, :, None])  # [S, W, T]
    q = query.float().reshape(slots, width, n_kv, group, head_dim) * softmax_scale
    logits = torch.einsum("swhgd,sthd->swhgt", q, keys)
    logits = torch.where(live[:, :, None, None, :], logits, float("-inf"))
    peak = torch.amax(logits, dim=-1, keepdim=True)
    peak = torch.where(torch.isfinite(peak), peak, torch.zeros_like(peak))
    probs = torch.exp(logits - peak)
    norm = torch.clamp(probs.sum(dim=-1, keepdim=True), min=1e-30)
    # Dead V rows are zeroed per window position: their scales may be
    # NaN garbage and 0 * NaN would leak into the sum.
    v_live = torch.where(live[:, :, :, None, None], values[:, None], 0.0)
    out = torch.einsum("swhgt,swthd->swhgd", probs, v_live) / norm
    return out.reshape(slots, width, n_heads, head_dim).to(query.dtype)


def _launch(query, key_pool, key_scale, value_pool, value_scale,
            block_tables, lengths, softmax_scale, length_offset):
    slots, width, n_heads, head_dim = query.shape
    nb, bs, n_kv, d = key_pool.shape
    _check_scales(key_pool, key_scale, value_scale)
    if tuple(value_pool.shape) != tuple(key_pool.shape) or d != head_dim:
        raise ValueError(
            f"pools must both be [NB, bs, Hkv, {head_dim}], got "
            f"{tuple(key_pool.shape)} and {tuple(value_pool.shape)}"
        )
    if n_heads % n_kv:
        raise ValueError(f"n_heads={n_heads} must divide by n_kv={n_kv}")
    if block_tables.dim() != 2 or block_tables.shape[0] != slots \
            or tuple(lengths.shape) != (slots,):
        raise ValueError(
            f"block_tables must be [{slots}, MB] and lengths [{slots}], got "
            f"{tuple(block_tables.shape)} and {tuple(lengths.shape)}"
        )
    _build.require_cuda("query", query, _build.DTYPE_CODES)
    for name, tensor in (("key_pool", key_pool), ("value_pool", value_pool)):
        _build.require_cuda(name, tensor, (torch.int8,))
    for name, tensor in (("key_scale", key_scale), ("value_scale", value_scale)):
        _build.require_cuda(name, tensor, (torch.float32,))
    for name, tensor in (("block_tables", block_tables), ("lengths", lengths)):
        _build.require_cuda(name, tensor, (torch.int32,))
    if head_dim != KERNEL_HEAD_DIM \
            or KERNEL_GROUPS.get(query.dtype) != n_heads // n_kv:
        raise ValueError(
            f"the paged kernel is built for head_dim {KERNEL_HEAD_DIM} with "
            f"GQA groups {KERNEL_GROUPS}, got head_dim {head_dim}, group "
            f"{n_heads // n_kv} in {query.dtype}"
        )
    out = torch.empty_like(query)
    max_blocks = block_tables.shape[1]
    if query.numel() == 0 or max_blocks == 0:
        return out.zero_()
    if softmax_scale is None:
        softmax_scale = head_dim ** -0.5
    # Scratch for the split kernel's partial results, one entry per
    # (virtual slot, head, split); the combine kernel reads the live ones.
    n_splits = -(-max_blocks * bs // SPLIT_ROWS)
    part_acc = torch.empty(slots * width, n_heads, n_splits, head_dim,
                           dtype=torch.float32, device=query.device)
    part_ml = torch.empty(slots * width, n_heads, n_splits, 2,
                          dtype=torch.float32, device=query.device)
    lib = _build.load_library()
    status = lib.tyt_paged_window_attention(
        query.data_ptr(), key_pool.data_ptr(), key_scale.data_ptr(),
        value_pool.data_ptr(), value_scale.data_ptr(),
        block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        part_acc.data_ptr(), part_ml.data_ptr(),
        slots, width, n_heads, n_kv, head_dim, bs, max_blocks, length_offset,
        n_splits, float(softmax_scale), _build.DTYPE_CODES[query.dtype],
        _build.stream_handle(query.device),
    )
    _build.check(status, "paged_int8_window_attention")
    return out


def paged_int8_window_attention(
    query, key_pool, key_scale, value_pool, value_scale, block_tables,
    lengths, *, softmax_scale: Optional[float] = None,
) -> torch.Tensor:
    """W-token-window decode attention straight off the paged int8 pool.

    query [S, W, H, D]; lengths [S] = each slot's valid length BEFORE the
    window, whose own K/V rows are already in the pool at logical
    positions ``lengths[s] + w``. Window position w attends causally over
    ``lengths[s] + w + 1`` positions. Returns [S, W, H, D] in query's
    dtype. CUDA tensors launch the kernel (counted in
    `paged_int8_window_attention.launches`), CPU tensors take the plain
    version."""
    if not query.is_cuda:
        return paged_int8_window_attention_reference(
            query, key_pool, key_scale, value_pool, value_scale,
            block_tables, lengths, softmax_scale=softmax_scale,
        )
    out = _launch(query, key_pool, key_scale, value_pool, value_scale,
                  block_tables, lengths, softmax_scale, length_offset=1)
    paged_int8_window_attention.launches += 1
    return out


paged_int8_window_attention.launches = 0


def paged_int8_decode_attention(
    query, key_pool, key_scale, value_pool, value_scale, block_tables,
    lengths, *, softmax_scale: Optional[float] = None,
) -> torch.Tensor:
    """Single-token decode attention: query [S, H, D], lengths [S] =
    valid positions including the token itself. Returns [S, H, D]. The
    same kernel as the window form at W = 1 with no length offset."""
    if not query.is_cuda:
        return paged_int8_window_attention_reference(
            query[:, None], key_pool, key_scale, value_pool, value_scale,
            block_tables, lengths, softmax_scale=softmax_scale,
            length_offset=0,
        )[:, 0]
    out = _launch(query[:, None], key_pool, key_scale, value_pool,
                  value_scale, block_tables, lengths, softmax_scale,
                  length_offset=0)
    paged_int8_decode_attention.launches += 1
    return out[:, 0]


paged_int8_decode_attention.launches = 0
