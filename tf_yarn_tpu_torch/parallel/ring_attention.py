"""Ring attention over the ``sp`` mesh dim — counterpart of
tf_yarn_tpu/parallel/ring_attention.py.

The sequence is cut over the ranks of the ``sp`` group, each holding a
contiguous block; a rank attends its queries to the key/value block it
holds, then passes that block one hop around the ring (`collectives.
shift`, whose backward passes the gradients back the other way). After
``sp`` steps every query has seen every key, and no rank holds more
than ``S/sp`` positions of the sequence. The blocks merge by the online
softmax (a running max and sum of exponentials), so the result is exact
attention up to the order of the sums.

* `ring_attention(q, k, v, *, group, causal, softmax_scale)` — the
  per-shard body (JAX ``:67-132``): the rank's own blocks in, its block
  of the output out. The decoder under ``sp``, whose activations are
  already the rank's block of the sequence, calls it directly.
* `ring_attention_sharded(q, k, v, *, causal, softmax_scale)` — the
  ``ops.attention`` seam for a computation replicated over ``sp`` (the
  encoders): the rank's block of each input (`collectives.
  scatter_sequence`), the ring, the output's blocks gathered
  (`collectives.gather_sequence`), as JAX's ``shard_map`` over the
  registered mesh does. Plain `xla_attention` without a mesh or at
  ``sp == 1``.

Each block's product is plain torch, as the JAX package's is an einsum
outside any Pallas kernel (the attention backends that run kernels under
``sp`` are Ulysses', `parallel.ulysses`). Under ``causal`` a rank skips
the blocks that came from later ranks, which every query of it would
mask; so that its peers' backward still finds it in every shift, the
last block it skipped is tied to the result (`collectives.tie`). Key and
value travel as one stacked tensor: one shift a step.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from tf_yarn_tpu_torch.parallel import collectives
from tf_yarn_tpu_torch.parallel.mesh import AXIS_SP, current_mesh

NEG_INF = -1e30
SPAN = "train/sp_collective"


def _block_attend(q, k, v, q_offset: int, k_offset: int, causal: bool,
                  scale: float):
    """Unnormalised attention of q [B, Sq, H, D] over one key/value block
    [B, Sk, Hkv, D]: (m, l, acc) for the merge, in f32. GQA heads are
    repeated here, after the hop, so the ring moves Hkv heads; positions
    are global (`q_offset`, `k_offset` place the blocks in the
    sequence)."""
    rep = q.shape[2] // k.shape[2]
    if rep > 1:
        k = torch.repeat_interleave(k, rep, dim=2)
        v = torch.repeat_interleave(v, rep, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    if causal:
        q_pos = q_offset + torch.arange(q.shape[1], device=q.device)[:, None]
        k_pos = k_offset + torch.arange(k.shape[1], device=q.device)[None, :]
        logits = torch.where(q_pos >= k_pos, logits, NEG_INF)
    m = logits.amax(-1, keepdim=True)  # [B, H, Sq, 1]
    # A fully masked row: exp(NEG_INF - NEG_INF) would be 1; clamp m so
    # its probabilities stay 0 and the merge leaves it alone.
    m_safe = m.clamp_min(NEG_INF / 2)
    p = torch.exp(logits - m_safe)
    p = torch.where(m > NEG_INF / 2, p, 0.0)
    l = p.sum(-1, keepdim=True)
    acc = torch.einsum("bhqk,bkhd->bhqd", p.to(v.dtype), v).float()
    return m_safe, l, acc


def ring_attention(query: torch.Tensor, key: torch.Tensor,
                   value: torch.Tensor, *, group, causal: bool = True,
                   softmax_scale: Optional[float] = None) -> torch.Tensor:
    """Per-shard ring attention: the rank's blocks q [B, S_local, H, D]
    and k/v [B, S_local, Hkv, D] of a sequence cut over the process
    group `group` -> its block of the output [B, S_local, H, D]."""
    b, s_local, n_heads, head_dim = query.shape
    scale = softmax_scale if softmax_scale is not None else head_dim ** -0.5
    sp = dist.get_world_size(group)
    me = dist.get_rank(group)
    q_offset = me * s_local

    stats = dict(dtype=torch.float32, device=query.device)
    m = torch.full((b, n_heads, s_local, 1), NEG_INF / 2, **stats)
    l = torch.zeros((b, n_heads, s_local, 1), **stats)
    acc = torch.zeros((b, n_heads, s_local, head_dim), **stats)
    kv = torch.stack([key, value])
    skipped = None
    for step in range(sp):
        # The block held now came from rank (me - step) mod sp.
        src = (me - step) % sp
        if causal and src > me:
            # Every query of this rank precedes the whole block: the
            # merge of an empty block changes nothing.
            skipped = kv
        else:
            skipped = None
            m_blk, l_blk, acc_blk = _block_attend(
                query, kv[0], kv[1], q_offset, src * s_local, causal, scale)
            m_new = torch.maximum(m, m_blk)
            c_old = torch.exp(m - m_new)
            c_blk = torch.exp(m_blk - m_new)
            l = l * c_old + l_blk * c_blk
            acc = acc * c_old + acc_blk * c_blk
            m = m_new
        if step != sp - 1:
            kv = collectives.shift(kv, group, 1, SPAN)
    if skipped is not None and torch.is_grad_enabled():
        acc = collectives.tie(acc, skipped)
    out = acc / l.clamp_min(1e-30)  # [B, H, S, D]
    return out.transpose(1, 2).to(query.dtype)


def sequence_group():
    """The process group of the registered mesh's ``sp`` dim, or None
    when there is no mesh or ``sp`` is 1."""
    from tf_yarn_tpu_torch.parallel import mesh as mesh_lib

    mesh = current_mesh()
    if mesh_lib.mesh_axis_size(mesh, AXIS_SP) <= 1:
        return None
    return mesh[AXIS_SP].get_group()


def ring_attention_sharded(query: torch.Tensor, key: torch.Tensor,
                           value: torch.Tensor, *, causal: bool = True,
                           softmax_scale: Optional[float] = None
                           ) -> torch.Tensor:
    """Ring attention of inputs replicated over the registered mesh's
    ``sp`` dim (JAX ``:135-167``): each rank computes its block of the
    sequence and every rank gets the whole output. Plain `xla_attention`
    without a mesh or at ``sp == 1``: the same numbers, nothing to ring
    over. Heads under ``tp`` are already the rank's own."""
    group = sequence_group()
    if group is None:
        from tf_yarn_tpu_torch.ops.attention import xla_attention

        return xla_attention(query, key, value, causal=causal,
                             softmax_scale=softmax_scale)
    q, k, v = (collectives.scatter_sequence(t, group)
               for t in (query, key, value))
    out = ring_attention(q, k, v, group=group, causal=causal,
                         softmax_scale=softmax_scale)
    return collectives.gather_sequence(out, group)
