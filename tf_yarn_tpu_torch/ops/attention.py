"""Attention backends and the dispatch seam — counterpart of
tf_yarn_tpu/ops/attention.py.

`xla_attention` is the JAX package's einsum-and-softmax reference,
computed outside any kernel (XLA einsums there, plain torch matrix
products here): it is the prefill attention of the serving path and the
``attention_impl="xla"`` training path. `attention()` dispatches on the
implementation name (attention.py:79-113): ``"flash"`` goes to
`ops/flash_attention.py` (the hand-written kernels), ``"ring"`` to
`parallel/ring_attention.py` and ``"ulysses"``/``"ulysses_flash"`` to
`parallel/ulysses.py` (the flash kernels inside), each over the
registered mesh's ``sp`` dim for inputs replicated over it, and plain
`xla_attention` without one.

`sequence_sharded_attention` is the seam for a model whose activations
are already the rank's contiguous block of the sequence (the decoder
under ``sp``): ring and Ulysses run their per-shard bodies; ``"xla"``
and ``"flash"`` attend over the whole sequence, gathered, and keep the
rank's block of the output.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

IMPLS = ("xla", "flash", "ring", "ulysses", "ulysses_flash")


def xla_attention(query: torch.Tensor, key: torch.Tensor, value: torch.Tensor,
                  *, causal: bool = True, softmax_scale: Optional[float] = None,
                  segment_offset: Union[int, torch.Tensor] = 0,
                  key_padding_mask: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
    """q [B, S, H, D], k/v [B, Skv, Hkv, D] -> [B, S, H, D].

    Numerics follow the JAX package exactly: QKᵀ in the input dtype, then
    cast to f32; masked logits set to finfo(float32).min; softmax in f32;
    probabilities cast back to the query dtype before P·V. GQA repeats
    each kv head over its group of query heads. `segment_offset` shifts
    the causal mask: query i sits at position i + segment_offset.
    `key_padding_mask` [B, Skv] (nonzero = real token) hides padded keys
    from every query; a row with no real key gets zeros."""
    _, s_q, n_heads, head_dim = query.shape
    s_kv, n_kv = key.shape[1], key.shape[2]
    if n_heads != n_kv:
        key = torch.repeat_interleave(key, n_heads // n_kv, dim=2)
        value = torch.repeat_interleave(value, n_heads // n_kv, dim=2)
    scale = softmax_scale if softmax_scale is not None else head_dim ** -0.5
    logits = (torch.einsum("bqhd,bkhd->bhqk", query, key) * scale).float()
    neg_inf = torch.finfo(torch.float32).min
    if causal:
        offset = segment_offset
        if isinstance(offset, torch.Tensor):
            offset = offset.to(query.device).long()[:, None, None, None]
        q_pos = torch.arange(s_q, device=query.device)[:, None] + offset
        k_pos = torch.arange(s_kv, device=query.device)[None, :]
        logits = torch.where(q_pos >= k_pos, logits, neg_inf)
    keep = None
    if key_padding_mask is not None:
        keep = key_padding_mask.bool()[:, None, None, :]  # [B, 1, 1, Skv]
        logits = torch.where(keep, logits, neg_inf)
    probs = torch.softmax(logits, dim=-1).to(query.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, value)
    if keep is not None:
        # A fully padded row would otherwise get a uniform softmax over
        # finfo.min logits: zero it, as the JAX package does.
        has_any_key = keep.any(dim=-1)[..., None]  # [B, 1, 1, 1]
        out = torch.where(has_any_key, out, torch.zeros((), dtype=out.dtype,
                                                        device=out.device))
    return out


def attention(query, key, value, *, impl: str = "xla", causal: bool = True,
              key_padding_mask=None):
    """Dispatch to the configured backend (attention.py:79-113).
    `key_padding_mask` is an xla-impl feature: a kernel backend given one
    raises rather than silently attending to padding."""
    if key_padding_mask is not None and impl in IMPLS[1:]:
        raise NotImplementedError(
            f"key_padding_mask is not supported by attention impl "
            f"{impl!r}; use impl='xla' for padded-batch encoders (or "
            "strip padding before a kernel impl)"
        )
    if impl == "flash":
        from tf_yarn_tpu_torch.ops.flash_attention import flash_attention

        return flash_attention(query, key, value, causal=causal)
    if impl == "ring":
        from tf_yarn_tpu_torch.parallel.ring_attention import (
            ring_attention_sharded)

        return ring_attention_sharded(query, key, value, causal=causal)
    if impl in ("ulysses", "ulysses_flash"):
        from tf_yarn_tpu_torch.parallel.ulysses import (
            ulysses_attention_sharded)

        return ulysses_attention_sharded(
            query, key, value, causal=causal,
            inner="flash" if impl == "ulysses_flash" else "xla")
    if impl != "xla":
        raise ValueError(
            f"unknown attention impl {impl!r}; use {' | '.join(IMPLS)}"
        )
    return xla_attention(query, key, value, causal=causal,
                         key_padding_mask=key_padding_mask)


def sequence_sharded_attention(query, key, value, *, impl: str, group,
                               causal: bool = True):
    """Attention of the rank's contiguous blocks q [B, S/sp, H, D], k/v
    [B, S/sp, Hkv, D] of a sequence cut over the process group `group`
    -> the rank's block of the output. ``"ring"`` and ``"ulysses"``/
    ``"ulysses_flash"`` run their per-shard bodies; ``"xla"`` and
    ``"flash"`` gather q, k and v whole (each rank's gradient summed
    back to its block), attend and keep the rank's rows."""
    if impl == "ring":
        from tf_yarn_tpu_torch.parallel.ring_attention import ring_attention

        return ring_attention(query, key, value, group=group, causal=causal)
    if impl in ("ulysses", "ulysses_flash"):
        from tf_yarn_tpu_torch.parallel.ulysses import ulysses_attention

        return ulysses_attention(
            query, key, value, group=group, causal=causal,
            inner="flash" if impl == "ulysses_flash" else "xla")
    from tf_yarn_tpu_torch.parallel import collectives

    whole = [collectives.gather_partial(t, group) for t in (query, key, value)]
    out = attention(*whole, impl=impl, causal=causal)
    return collectives.block(out, group)
