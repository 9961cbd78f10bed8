"""Plain attention — the semantics of tf_yarn_tpu/ops/attention.py:
xla_attention.

The JAX package computes this outside any Pallas kernel (XLA einsums),
so the port keeps it as plain torch matrix products: it is the prefill
attention of the serving path. The flash, ring and Ulysses backends and
the key-padding mask are still to port (ROADMAP.md).
"""

from __future__ import annotations

from typing import Optional

import torch


def xla_attention(query: torch.Tensor, key: torch.Tensor, value: torch.Tensor,
                  *, causal: bool = True, softmax_scale: Optional[float] = None,
                  segment_offset: int = 0) -> torch.Tensor:
    """q [B, S, H, D], k/v [B, Skv, Hkv, D] -> [B, S, H, D].

    Numerics follow the JAX package exactly: QKᵀ in the input dtype, then
    cast to f32; masked logits set to finfo(float32).min; softmax in f32;
    probabilities cast back to the query dtype before P·V. GQA repeats
    each kv head over its group of query heads. `segment_offset` shifts
    the causal mask: query i sits at position i + segment_offset."""
    _, s_q, n_heads, head_dim = query.shape
    s_kv, n_kv = key.shape[1], key.shape[2]
    if n_heads != n_kv:
        key = torch.repeat_interleave(key, n_heads // n_kv, dim=2)
        value = torch.repeat_interleave(value, n_heads // n_kv, dim=2)
    scale = softmax_scale if softmax_scale is not None else head_dim ** -0.5
    logits = (torch.einsum("bqhd,bkhd->bhqk", query, key) * scale).float()
    if causal:
        q_pos = torch.arange(s_q, device=query.device)[:, None] + segment_offset
        k_pos = torch.arange(s_kv, device=query.device)[None, :]
        logits = torch.where(q_pos >= k_pos, logits,
                             torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, dim=-1).to(query.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, value)
