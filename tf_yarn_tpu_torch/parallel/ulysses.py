"""Ulysses (all-to-all) sequence parallelism over the ``sp`` mesh dim —
counterpart of tf_yarn_tpu/parallel/ulysses.py.

In the place of the ring's hops, one all-to-all re-cuts q, k and v from
the rank's block of the sequence ``[B, S/sp, H, D]`` to the whole
sequence of its share of the heads ``[B, S, H/sp, D]``; each rank runs
ordinary attention over the whole sequence on its heads, and a second
all-to-all gives back its block of the sequence. Two all-to-alls of the
activations in the place of ``sp`` hops of k and v, and the inner
attention is a one-device call, so the hand-written flash kernels run
unchanged inside it (``inner="flash"``, ``attention_impl=
"ulysses_flash"``): on the card the CUDA kernels at the rank's heads
and the whole sequence, on the CPU their plain versions.

The heads must split over ``sp`` (``n_heads % sp == 0``, the JAX
ValueError); GQA key/value heads that do not are repeated to
``lcm(Hkv, sp)`` first, the fewest that keep each rank's query heads
beside their kv heads, and the inner attention repeats the rest.

`ulysses_attention` is the per-shard body (JAX ``:44-113``): the
decoder under ``sp`` calls it on its blocks. Its q, k and v travel in
one all-to-all (each rank's block of the heads of all three, side by
side), so the ranks' collectives keep one order forward and backward.
`ulysses_attention_sharded` (JAX ``:116-142``) is the ``ops.attention``
seam for inputs replicated over ``sp`` (the encoders): scatter, the
body, gather, as `parallel.ring_attention.ring_attention_sharded`; plain
`xla_attention` without a mesh or at ``sp == 1`` (also for ``inner=
"flash"``, as in JAX).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.distributed as dist

from tf_yarn_tpu_torch.parallel import collectives
from tf_yarn_tpu_torch.parallel.ring_attention import SPAN, sequence_group


def ulysses_attention(query: torch.Tensor, key: torch.Tensor,
                      value: torch.Tensor, *, group, causal: bool = True,
                      softmax_scale: Optional[float] = None,
                      inner: str = "xla") -> torch.Tensor:
    """Per-shard Ulysses attention: the rank's blocks q [B, S_local, H, D]
    and k/v [B, S_local, Hkv, D] of a sequence cut over the process
    group `group` -> its block of the output [B, S_local, H, D]. `inner` is the attention run
    on the whole sequence: ``"xla"`` or ``"flash"``."""
    from tf_yarn_tpu_torch.ops.attention import xla_attention

    sp = dist.get_world_size(group)
    b, s_local, n_heads, head_dim = query.shape
    if n_heads % sp:
        raise ValueError(
            f"ulysses needs n_heads ({n_heads}) divisible by sp ({sp})"
        )
    n_kv = key.shape[2]
    if n_kv % sp:
        # The fewest kv heads that split over sp and keep each chunk's
        # query heads beside theirs: lcm(Hkv, sp), which divides H.
        target = n_kv * sp // math.gcd(n_kv, sp)
        key = torch.repeat_interleave(key, target // n_kv, dim=2)
        value = torch.repeat_interleave(value, target // n_kv, dim=2)
        n_kv = target
    # Each rank's block of q's, k's and v's heads side by side, so one
    # all-to-all moves all three: [B, S/sp, sp, (H + 2 Hkv)/sp, D] ->
    # [B, S, (H + 2 Hkv)/sp, D] (the ranks hold consecutive blocks, so the
    # concatenation is the sequence in order).
    per = lambda t: t.reshape(b, s_local, sp, t.shape[2] // sp, head_dim)
    qkv = torch.cat([per(query), per(key), per(value)], dim=3)
    qkv = collectives.exchange(qkv.flatten(2, 3), group, 2, 1, SPAN)
    h, h_kv = n_heads // sp, n_kv // sp
    q, k, v = qkv.split([h, h_kv, h_kv], dim=2)
    if inner == "flash":
        from tf_yarn_tpu_torch.ops import flash_attention

        out = flash_attention.flash_attention(q, k, v, causal=causal,
                                              softmax_scale=softmax_scale)
    else:
        out = xla_attention(q, k, v, causal=causal,
                            softmax_scale=softmax_scale)
    # [B, S, H/sp, D] -> [B, S/sp, H, D]
    return collectives.exchange(out, group, 1, 2, SPAN).to(query.dtype)


def ulysses_attention_sharded(query: torch.Tensor, key: torch.Tensor,
                              value: torch.Tensor, *, causal: bool = True,
                              softmax_scale: Optional[float] = None,
                              inner: str = "xla") -> torch.Tensor:
    """Ulysses attention of inputs replicated over the registered mesh's
    ``sp`` dim: each rank computes its block and every rank gets the whole
    output; `xla_attention` without a mesh or at ``sp == 1``."""
    group = sequence_group()
    if group is None:
        from tf_yarn_tpu_torch.ops.attention import xla_attention

        return xla_attention(query, key, value, causal=causal,
                             softmax_scale=softmax_scale)
    q, k, v = (collectives.scatter_sequence(t, group)
               for t in (query, key, value))
    out = ulysses_attention(q, k, v, group=group, causal=causal,
                            softmax_scale=softmax_scale, inner=inner)
    return collectives.gather_sequence(out, group)
