"""Decode attention over an int8 KV cache — counterpart of
tf_yarn_tpu/ops/decode_attention.py.

Two layouts, the JAX package's:

* the dense cache (`int8_decode_attention`): one query token per batch
  row over K/V ``[B, S, Hkv, D]`` int8 plus per-row f32 scales ``[B, S,
  Hkv, 1]``, with ``lengths [B]`` int32 valid positions — one per row,
  where the TPU kernel took one scalar for the batch (the JAX dense slot
  grid gets per-row lengths through ``vmap``);
* the paged pool (`paged_int8_window_attention`,
  `paged_int8_decode_attention`): K/V values ``[NB, bs, Hkv, D]`` int8
  plus f32 scales ``[NB, sb, Hkv, 1]`` — per-row (``sb = bs``) or
  per-block (``sb = 1``, one scale a (block, kv head), as
  `quantize.quantize_int8_grouped` makes them), the same for K and V —
  a block table ``[S, MB]`` int32 mapping each slot's logical blocks to
  physical ones, and ``lengths [S]`` int32. Table entries past a slot's
  length may point anywhere; those positions are masked.

CUDA tensors go to the hand-written kernels (csrc/dense_decode.cu
replaces the TPU kernel `_decode_kernel`, csrc/paged_decode.cu
`_paged_decode_kernel`; both share csrc/decode_split.cuh), one launch a
call: the sequence is split over blocks and the last split of each
(virtual slot, kv head) merges them, counted by a ticket buffer this
module keeps per device (`_ticket_buffer`); CPU tensors
go to the plain versions (`*_reference`) the tests hold against the JAX
package. A CUDA call the kernels are not built for raises; nothing falls
back.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from tf_yarn_tpu_torch.ops import _build

# Positions per split of the kernels' sequence (kSplitRows in
# csrc/decode_split.cuh): the kernels refuse a split count that does not
# cover a slot's capacity.
SPLIT_ROWS = 256
# The kernels' instantiations: head_dim 128 and, per query dtype, the GQA
# group (n_heads / n_kv) of the configuration the port serves in it.
KERNEL_HEAD_DIM = 128
KERNEL_GROUPS = {torch.bfloat16: 4, torch.float32: 2}

# The kernels' ticket counters, one int32 per (virtual slot, kv head), in
# one buffer per device: zeroed once here, and left zeroed by every launch
# (the last split of each pair resets its ticket, csrc/decode_split.cuh).
_tickets: Dict[int, torch.Tensor] = {}
# Buffers a larger call replaced. A CUDA graph captured earlier may still
# count on one, so none is ever freed.
_retired: List[torch.Tensor] = []
# The stream of each device's last launch outside a graph capture.
_last_stream: Dict[int, torch.cuda.Stream] = {}


def _ticket_buffer(device: torch.device, count: int) -> torch.Tensor:
    """The ticket buffer of `device`, at least `count` long, for a launch
    on the current stream.

    Two launches must not use the buffer at the same time, so a launch on
    another stream than the last one first waits for that stream. Inside
    a CUDA-graph capture the buffer cannot grow or be zeroed (call the
    wrapper once, at the captured size, before capturing), and the graph's
    replays are ordered like any work on the stream they run on."""
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    stream = torch.cuda.current_stream(index)
    capturing = torch.cuda.is_current_stream_capturing()
    buf = _tickets.get(index)
    if buf is None or buf.numel() < count:
        if capturing:
            raise RuntimeError(
                "the decode kernels' ticket buffer must grow outside a "
                "CUDA-graph capture: call the kernel once before capturing")
        if buf is not None:
            _retired.append(buf)
        buf = torch.zeros(max(count, 4096), dtype=torch.int32, device=device)
        _tickets[index] = buf
    if not capturing:
        last = _last_stream.get(index)
        if last is not None and last != stream:
            stream.wait_stream(last)
        _last_stream[index] = stream
    return buf


def _check_scales(key_pool, key_scale, value_scale) -> int:
    """The scale pools' rows a block, ``sb``: the block size (per-row
    scales) or 1 (per-block), the same for K and V; anything else is the
    JAX package's ValueError (decode_attention.py:299-305)."""
    nb, bs, n_kv, _ = key_pool.shape
    sb = key_scale.shape[1] if key_scale.dim() == 4 else None
    if sb not in (bs, 1) or any(
            tuple(scale.shape) != (nb, sb, n_kv, 1)
            for scale in (key_scale, value_scale)):
        raise ValueError(
            f"scale pools must carry per-row ({bs}) or per-block "
            f"(1) scales; got key {tuple(key_scale.shape)}, value "
            f"{tuple(value_scale.shape)}"
        )
    return sb


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
        # [S, MB, bs, Hkv, D]; a per-block scale [S, MB, 1, Hkv, 1]
        # broadcasts over its block's rows.
        rows = pool[tables].float() * scale[tables]
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


def _require_kernel_inputs(kernel: str, query, key, key_scale, value,
                           value_scale, **int32_inputs) -> None:
    """The checks every launch of the two kernels passes: CUDA tensors of
    the kernels' dtypes, contiguous, at an instantiated (head_dim, GQA
    group) for the query's dtype."""
    _build.require_cuda("query", query, _build.DTYPE_CODES)
    for name, tensor in (("key", key), ("value", value)):
        _build.require_cuda(name, tensor, (torch.int8,))
    for name, tensor in (("key_scale", key_scale), ("value_scale", value_scale)):
        _build.require_cuda(name, tensor, (torch.float32,))
    for name, tensor in int32_inputs.items():
        _build.require_cuda(name, tensor, (torch.int32,))
    n_heads, head_dim = query.shape[-2:]
    n_kv = key.shape[-2]
    if head_dim != KERNEL_HEAD_DIM \
            or KERNEL_GROUPS.get(query.dtype) != n_heads // n_kv:
        raise ValueError(
            f"the {kernel} kernel is built for head_dim {KERNEL_HEAD_DIM} "
            f"with GQA groups {KERNEL_GROUPS}, got head_dim {head_dim}, "
            f"group {n_heads // n_kv} in {query.dtype}"
        )


def _launch(query, key_pool, key_scale, value_pool, value_scale,
            block_tables, lengths, softmax_scale, length_offset):
    slots, width, n_heads, head_dim = query.shape
    nb, bs, n_kv, d = key_pool.shape
    sb = _check_scales(key_pool, key_scale, value_scale)
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
    _require_kernel_inputs("paged", query, key_pool, key_scale, value_pool,
                           value_scale, block_tables=block_tables,
                           lengths=lengths)
    out = torch.empty_like(query)
    max_blocks = block_tables.shape[1]
    if query.numel() == 0 or max_blocks == 0:
        return out.zero_()
    if softmax_scale is None:
        softmax_scale = head_dim ** -0.5
    # Scratch for the splits' partial results, one entry per (virtual
    # slot, head, split); the last split of each pair reads the live ones.
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
        _ticket_buffer(query.device, slots * width * n_kv).data_ptr(),
        slots, width, n_heads, n_kv, head_dim, bs, sb, max_blocks,
        length_offset, n_splits, float(softmax_scale),
        _build.DTYPE_CODES[query.dtype],
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


def _check_dense(query, key_q, key_scale, value_q, value_scale,
                 lengths) -> None:
    b, n_heads, head_dim = query.shape
    cache = tuple(key_q.shape)
    if len(cache) != 4 or cache[0] != b or cache[3] != head_dim \
            or tuple(value_q.shape) != cache:
        raise ValueError(
            f"caches must both be [{b}, S, Hkv, {head_dim}], got "
            f"{tuple(key_q.shape)} and {tuple(value_q.shape)}"
        )
    for name, scale in (("key_scale", key_scale), ("value_scale", value_scale)):
        if tuple(scale.shape) != cache[:3] + (1,):
            raise ValueError(
                f"{name} must carry per-row scales {cache[:3] + (1,)}, got "
                f"{tuple(scale.shape)}"
            )
    if n_heads % cache[2]:
        raise ValueError(f"n_heads={n_heads} must divide by n_kv={cache[2]}")
    if tuple(lengths.shape) != (b,):
        raise ValueError(f"lengths must be [{b}], got {tuple(lengths.shape)}")


def int8_decode_attention_reference(
    query, key_q, key_scale, value_q, value_scale, lengths, *,
    softmax_scale: Optional[float] = None,
) -> torch.Tensor:
    """Plain torch version of `int8_decode_attention`: one softmax per
    row over its first ``lengths[b]`` positions, in f32. Dead positions
    get -inf logits and their V rows are zeroed before P·V (their scales
    may be NaN garbage); the normaliser is clamped to 1e-30, so a row of
    length 0 — or an empty cache — gives zeros."""
    _check_dense(query, key_q, key_scale, value_q, value_scale, lengths)
    b, n_heads, head_dim = query.shape
    seq, n_kv = key_q.shape[1], key_q.shape[2]
    if query.numel() == 0 or seq == 0:
        return torch.zeros_like(query)
    if softmax_scale is None:
        softmax_scale = head_dim ** -0.5
    live = (torch.arange(seq, device=query.device)[None, :]
            < lengths.long()[:, None])  # [B, S]
    keys = key_q.float() * key_scale
    values = torch.where(live[:, :, None, None],
                         value_q.float() * value_scale, 0.0)
    q = query.float().reshape(b, n_kv, n_heads // n_kv, head_dim) * softmax_scale
    logits = torch.einsum("bhgd,bshd->bhgs", q, keys)
    logits = torch.where(live[:, None, None, :], logits, float("-inf"))
    peak = torch.amax(logits, dim=-1, keepdim=True)
    peak = torch.where(torch.isfinite(peak), peak, torch.zeros_like(peak))
    probs = torch.exp(logits - peak)
    norm = torch.clamp(probs.sum(dim=-1, keepdim=True), min=1e-30)
    out = torch.einsum("bhgs,bshd->bhgd", probs, values) / norm
    return out.reshape(b, n_heads, head_dim).to(query.dtype)


def int8_decode_attention(
    query, key_q, key_scale, value_q, value_scale, lengths, *,
    softmax_scale: Optional[float] = None,
) -> torch.Tensor:
    """Single-token decode attention over a dense int8 cache.

    query [B, H, D] (one token per batch row); caches [B, S, Hkv, D] int8
    with per-row scales [B, S, Hkv, 1] f32; lengths [B] int32 valid
    positions per row (the token's own row included). Returns [B, H, D]
    in query's dtype. CUDA tensors launch the kernel (counted in
    `int8_decode_attention.launches`), CPU tensors take the plain
    version."""
    if not query.is_cuda:
        return int8_decode_attention_reference(
            query, key_q, key_scale, value_q, value_scale, lengths,
            softmax_scale=softmax_scale)
    _check_dense(query, key_q, key_scale, value_q, value_scale, lengths)
    _require_kernel_inputs("dense", query, key_q, key_scale, value_q,
                           value_scale, lengths=lengths)
    b, n_heads, head_dim = query.shape
    seq, n_kv = key_q.shape[1], key_q.shape[2]
    out = torch.empty_like(query)
    if query.numel() == 0 or seq == 0:
        return out.zero_()
    if softmax_scale is None:
        softmax_scale = head_dim ** -0.5
    n_splits = -(-seq // SPLIT_ROWS)
    part_acc = torch.empty(b, n_heads, n_splits, head_dim,
                           dtype=torch.float32, device=query.device)
    part_ml = torch.empty(b, n_heads, n_splits, 2, dtype=torch.float32,
                          device=query.device)
    lib = _build.load_library()
    status = lib.tyt_dense_decode_attention(
        query.data_ptr(), key_q.data_ptr(), key_scale.data_ptr(),
        value_q.data_ptr(), value_scale.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), part_acc.data_ptr(), part_ml.data_ptr(),
        _ticket_buffer(query.device, b * n_kv).data_ptr(),
        b, n_heads, n_kv, head_dim, seq, n_splits, float(softmax_scale),
        _build.DTYPE_CODES[query.dtype], _build.stream_handle(query.device),
    )
    _build.check(status, "int8_decode_attention")
    int8_decode_attention.launches += 1
    return out


int8_decode_attention.launches = 0
