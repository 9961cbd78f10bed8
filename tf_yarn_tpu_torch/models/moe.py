"""Mixture-of-Experts MLP — counterpart of tf_yarn_tpu/models/moe.py.

`MoEMlp` is the Switch layer the decoder's `Block` takes in place of the
dense SwiGLU when ``config.moe_experts > 0``: top-1 routing with a
capacity bound, each expert a SwiGLU of the dense block's shape, and the
Switch load-balancing loss. It computes what JAX ``MoEMlp.__call__``
computes (moe.py:33-99):

* ``capacity = max(1, int(moe_capacity_factor * n_tokens / E))`` in
  Python float arithmetic;
* router logits and softmax in f32, the top-1 expert by ``argmax`` (the
  first of equal maxima), its probability the token's gate;
* each token's position in its expert: the count of earlier tokens
  routed there, batch-major. A token at or past the capacity is dropped:
  its output and its gate are 0;
* the experts' SwiGLU in the compute dtype, then the combine, then the
  product with the gate;
* ``aux = E * sum(mean(kept one-hot) * mean(probs))`` over the tokens,
  the kept one-hot taken after the capacity mask.

The JAX package dispatches with dense ``[T, E, C]`` one-hot einsums. Here
the dispatch gathers each slot's token into ``[E, C, D]`` and the
combine gathers each token's slot back (a dropped token reads a zero
row): the one-hot products add exactly one nonzero term per token, so
the values are the same, without their ``2·T·E·C·D`` FLOPs each way.
No gradient flows through the argmax, the one-hots or the positions; it
flows through the gate, through the probabilities in the aux loss and
through the experts. The JAX package's MoE has no Pallas kernel, so the
expert products are ``torch.bmm``.

The aux loss goes where `lm_loss` reads it, as JAX sows it into the
``intermediates`` collection: each forward appends its layer's aux to
the list that `collecting()` opened (the losses of `models.common` open
one around the decoder's forward). A block recomputed under remat runs
its forward again in the backward, after the list has closed, so a
recompute appends nothing (and nothing is appended from inside a
backward at all).

Across ranks (`parallel.expert_parallel`, set by the train loop):

* ``ep`` — the rank keeps ``E / ep`` experts, computes the router, the
  positions and the dispatch for every token of its data shard, runs
  its own experts, and sums the partial combine over the ``ep`` group
  (`tensor_parallel.reduce_out`; the dispatch input enters through
  `tensor_parallel.copy_in`, whose backward sums its gradient). Each
  token has one expert, so the sum adds exact zeros. The gate multiplies
  after the sum, so the replicated router's gradient is whole on every
  rank;
* ``data_shards`` — under ``dp`` x ``fsdp`` > 1 the JAX layer runs on
  the global batch: the capacity counts every data rank's tokens, a
  token's position counts the tokens of the lower data ranks first, and
  the aux loss takes global means. The rank exchanges its per-expert
  counts and probability sums with the other data ranks (one all-reduce
  of a ``[ranks, 2E]`` table a layer), offsets its positions by the
  lower ranks' counts, and writes its aux term as the global token
  fractions (no gradient) times its own mean probabilities, so that the
  ranks' averaged gradients are the global aux loss's; the value it
  reports is the global aux.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Iterator, List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from tf_yarn_tpu_torch.parallel import sharding
from tf_yarn_tpu_torch.parallel import tensor_parallel as tp_lib
from tf_yarn_tpu_torch.parallel.sharding import EMBED, EXPERT, MLP

_SINK = threading.local()


@contextlib.contextmanager
def collecting() -> Iterator[List[torch.Tensor]]:
    """A list that every `MoEMlp` forward inside the block appends its
    layer's aux loss to (the JAX ``mutable=["intermediates"]``)."""
    previous = getattr(_SINK, "losses", None)
    _SINK.losses = losses = []
    try:
        yield losses
    finally:
        _SINK.losses = previous


def _in_backward() -> bool:
    """Whether autograd is running a backward on this thread (a block's
    recompute under remat runs there)."""
    return torch._C._current_graph_task_id() != -1


def capacity(config, n_tokens: int) -> int:
    """Slots an expert has for `n_tokens` tokens (moe.py:40)."""
    return max(1, int(config.moe_capacity_factor * n_tokens
                      / config.moe_experts))


class DataShards:
    """The data ranks of a rank's MoE layers: the groups of the ``dp`` and
    ``fsdp`` mesh dims whose size exceeds 1 (outermost first), this
    rank's data-group index and the count (`parallel.mesh.data_group`)."""

    def __init__(self, groups, index: int, count: int) -> None:
        self.groups = list(groups)
        self.index = index
        self.count = count

    def exchange(self, counts: torch.Tensor, prob_sums: torch.Tensor):
        """Every data rank's per-expert counts and probability sums, as a
        ``[count, 2E]`` f64 table row by data index: an all-reduce of this
        rank's row over each group."""
        table = torch.zeros(self.count, 2 * counts.numel(),
                            dtype=torch.float64, device=counts.device)
        table[self.index] = torch.cat([counts.double(), prob_sums.double()])
        for group in self.groups:
            torch.distributed.all_reduce(table, group=group)
        return table


class MoEMlp(nn.Module):
    """The Switch MLP (module docstring): ``router [d, E]``, ``w_gate``
    and ``w_up [E, d, d_ff]``, ``w_down [E, d_ff, d]`` (under ``ep`` the
    rank's ``E / ep`` experts). `trainable` parameters are f32 masters
    cast at every use; frozen ones (a LoRA fine-tune's: the JAX MoE
    weights are no ``LoraDense``) are stored in the compute dtype."""

    def __init__(self, config, device=None, trainable: bool = False):
        super().__init__()
        cfg = self.config = config
        n_exp, d, f = cfg.moe_experts, cfg.d_model, cfg.d_ff
        dtype = cfg.param_dtype if trainable else cfg.dtype

        def param(*shape):
            return nn.Parameter(torch.empty(*shape, dtype=dtype,
                                            device=device),
                                requires_grad=trainable)

        self.router = param(d, n_exp)
        self.w_gate = param(n_exp, d, f)
        self.w_up = param(n_exp, d, f)
        self.w_down = param(n_exp, f, d)
        sharding.annotate(self, router=(EMBED, None),
                          w_gate=(EXPERT, EMBED, MLP),
                          w_up=(EXPERT, EMBED, MLP),
                          w_down=(EXPERT, MLP, EMBED))
        # Set by `parallel.expert_parallel.parallelize`: the ep group
        # (the rank holds its share of the experts) and the data ranks
        # the capacity and aux loss count over.
        self.ep = None
        self.data_shards: Optional[DataShards] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        b, s, d = x.shape
        n_exp = cfg.moe_experts
        tokens = x.reshape(b * s, d)
        n_local = tokens.shape[0]
        shards = self.data_shards
        n_tokens = n_local * (shards.count if shards is not None else 1)
        cap = capacity(cfg, n_tokens)

        # Router math in f32 (moe.py:49-54).
        probs = torch.softmax(tokens.float() @ self.router.float(), dim=-1)
        expert = probs.argmax(dim=-1)
        gate = probs.gather(1, expert[:, None])[:, 0]
        onehot = F.one_hot(expert, n_exp)
        counts = onehot.sum(0)
        # The token's place among this shard's tokens of its expert.
        local_pos = (onehot.cumsum(0) * onehot).sum(-1) - 1
        prob_sums = probs.sum(0)
        if shards is None:
            position = local_pos
            totals = counts
            global_prob_sums = None
        else:
            table = shards.exchange(counts, prob_sums.detach())
            by_rank = table[:, :n_exp]
            offsets = by_rank[:shards.index].sum(0).long()
            position = local_pos + offsets[expert]
            totals = by_rank.sum(0)
            global_prob_sums = table[:, n_exp:].sum(0).float()
        kept = position < cap
        gate = gate * kept

        out = self._experts(tokens, expert, local_pos, kept, min(cap, n_local))
        out = out * gate[:, None].to(cfg.dtype)

        # The Switch aux loss (moe.py:96-98): kept tokens per expert are
        # min(routed, capacity) over the global token axis.
        frac_tokens = totals.clamp(max=cap).float() / n_tokens
        aux = n_exp * torch.sum(frac_tokens * (prob_sums / n_local))
        if global_prob_sums is not None:
            whole = n_exp * torch.sum(frac_tokens * (global_prob_sums
                                                     / n_tokens))
            aux = aux + (whole - aux).detach()
        sink = getattr(_SINK, "losses", None)
        if sink is not None and not _in_backward():
            sink.append(aux)
        return out.reshape(b, s, d).to(cfg.dtype)

    def _experts(self, tokens, expert, local_pos, kept, slots: int):
        """Each kept token through its expert's SwiGLU (the rank's experts
        under ``ep``, the others' outputs summed over the group), zero for
        a dropped one: ``[T, d]`` in the compute dtype. `slots` is the
        buffer's rows an expert (no more than the capacity or the shard's
        tokens)."""
        cfg = self.config
        n_local, d = tokens.shape
        n_own = self.w_gate.shape[0]
        first = self.ep.rank * n_own if self.ep is not None else 0
        own = expert - first
        mine = kept & (own >= 0) & (own < n_own)
        n_slots = n_own * slots
        # Every token writes one distinct index: its slot, or a spare row
        # past the slots; a slot no token filled reads the zero row.
        index = torch.arange(n_local, device=tokens.device)
        slot = torch.where(mine, own * slots + local_pos, n_slots + index)
        slot_token = torch.full((n_slots + n_local,), n_local,
                                dtype=torch.long, device=tokens.device)
        slot_token.scatter_(0, slot, index)
        source = tokens if self.ep is None else tp_lib.copy_in(
            tokens, self.ep, "ep_dispatch")
        source = torch.cat([source, source.new_zeros(1, d)])
        inputs = source[slot_token[:n_slots]].view(n_own, slots, d)
        dtype = cfg.dtype
        hidden = F.silu(torch.bmm(inputs, self.w_gate.to(dtype))) * \
            torch.bmm(inputs, self.w_up.to(dtype))
        outputs = torch.bmm(hidden, self.w_down.to(dtype))
        rows = torch.cat([outputs.reshape(n_slots, d),
                          outputs.new_zeros(1, d)])
        combined = rows[slot.clamp(max=n_slots)]
        if self.ep is not None:
            combined = tp_lib.reduce_out(combined, self.ep, "ep_combine")
        return combined


def has_moe(model: nn.Module) -> bool:
    """Whether `model` holds an `MoEMlp`."""
    return any(isinstance(module, MoEMlp) for module in model.modules())
