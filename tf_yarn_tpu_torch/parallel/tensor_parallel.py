"""Tensor-parallel layers over the mesh's ``tp`` dim — the port's
counterpart of what GSPMD does with `parallel.sharding`'s placements in
the JAX package, and of `ops/_rowwise.py`'s partition policy.

Megatron's scheme on plain local tensors. `parallelize(model, mesh)`
cuts every parameter whose placement (`sharding.tree_partition_specs`,
from the logical axes its module was annotated with) names ``tp`` to
the rank's contiguous shard, and hands the rank's `TensorParallel` to
every module that has a ``tp`` attribute: the modules that compute on
local shards. A dense layer reads its role from its kernel's logical
axes, so the annotation that places a parameter is the one that says
how it is used:

* column-parallel: an ``(embed, heads)`` or ``(embed, mlp)`` kernel
  keeps its rank's output features; the input is replicated. An
  ``(embed, kv)`` kernel, replicated by the ``"kv": None`` rule, is read
  at the kv heads the rank's query heads use (`kv_span`);
* row-parallel: a ``(heads, embed)`` or ``(mlp, embed)`` kernel keeps
  its rank's input features, and the partial products are summed;
* vocab-parallel embedding: a ``(vocab, embed)`` table keeps its rank's
  rows; an id outside them reads zeros and the ranks' rows are summed;
* vocab-parallel head: an ``(embed, vocab)`` head computes its rank's
  logits, which are gathered whole for the loss (an all-reduce of the
  zero-padded shard, whose backward takes the slice), as JAX's loss sees
  global logits.

The collectives are ``all_reduce`` over the tp group and nothing else,
so they run over gloo on one shared card as over NCCL:

* `copy_in`: identity forward, all-reduce backward — where a replicated
  tensor enters a sharded computation (a block's input, a LoRA factor
  that every rank reads whole but whose gradient each rank has only in
  part);
* `reduce_out`: all-reduce forward, identity backward — where partial
  sums leave it (a row-parallel product, the vocab-parallel lookup, the
  logits gather);
* `slice_replicated`: a replicated parameter read in part (a LoRA
  factor or bias beside a sharded kernel, ``wk``/``wv`` under ``"kv":
  None`` read at the rank's kv heads) — the slice forward, and backward
  the gradient scattered into zeros and all-reduced, so the rule stays
  at the use site.

A parameter every rank uses whole on replicated activations (norm
scales, a row-parallel bias added after the sum, BERT's pooler,
classifier and position embeddings) gets the same whole gradient on
every rank and is not summed. So the ranks' replicated parameters stay
bitwise equal. Each collective's host time, from its call to its
return, is a ``train/tp_allreduce`` span (with ``op`` and ``bytes``) and
goes into the ``train/tp_allreduce_seconds`` histogram; under gloo with
card tensors the call also waits for the kernels that produce its
input.

Partition policy of the kernels (the JAX package's `ops/_rowwise.py`,
which has no file of its own here): the row-wise norms (RMSNorm,
LayerNorm) normalise whole rows, as the residual stream they read is
replicated over ``tp``; flash attention runs on a rank's own heads (its
``n_heads / tp`` query heads and the kv heads they read, the GQA group
unchanged). The JAX policy replicates the heads across the flash call
(flash_attention.py:474-501): the same numbers, and the port does not
repeat the work. GSPMD pads a dim that ``tp`` does not divide; the port
refuses it with a ValueError naming the dim.
"""

from __future__ import annotations

import logging
import time
from typing import Dict, List, Mapping, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from tf_yarn_tpu_torch import telemetry
from tf_yarn_tpu_torch.parallel import collectives
from tf_yarn_tpu_torch.parallel import mesh as mesh_lib
from tf_yarn_tpu_torch.parallel import sharding

_logger = logging.getLogger(__name__)


class TensorParallel(collectives.AxisGroup):
    """A rank's place in its tp group: the group, its size and the
    rank's index in it."""

    def span(self, total: int, what: str) -> Tuple[int, int]:
        """(start, length) of this rank's contiguous share of `total`;
        a ValueError naming `what` when tp does not divide it."""
        if total % self.size:
            raise ValueError(f"{what}={total} does not split over tp="
                             f"{self.size}: the port refuses ragged tp "
                             "shards (GSPMD pads them)")
        length = total // self.size
        return self.rank * length, length


def kv_span(n_heads: int, n_kv_heads: int, tp: TensorParallel
            ) -> Tuple[int, int]:
    """(first, count) of the kv heads a rank's query heads read: with
    ``n_kv_heads % tp == 0`` each rank has its own ``n_kv_heads / tp``;
    with ``tp % n_kv_heads == 0`` its query heads fall in one group and
    read that group's kv head. Anything else is a ValueError."""
    start, local = tp.span(n_heads, "n_heads")
    if n_kv_heads % tp.size == 0:
        return tp.span(n_kv_heads, "n_kv_heads")
    if tp.size % n_kv_heads == 0:
        return start // (n_heads // n_kv_heads), 1
    raise ValueError(f"n_kv_heads={n_kv_heads} neither splits over tp="
                     f"{tp.size} nor divides it")


def _all_reduce(tensor: torch.Tensor, tp: TensorParallel,
                op: str) -> torch.Tensor:
    """Sum `tensor` over the tp group in place, timed."""
    start = time.perf_counter()
    dist.all_reduce(tensor, group=tp.group)
    seconds = time.perf_counter() - start
    telemetry.get_tracer().record(
        "train/tp_allreduce", start, seconds, op=op,
        bytes=tensor.numel() * tensor.element_size())
    telemetry.get_registry().histogram(
        "train/tp_allreduce_seconds").observe(seconds)
    return tensor


class _CopyIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp, op):
        ctx.tp, ctx.op = tp, op
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        return _all_reduce(grad, ctx.tp, ctx.op), None, None


class _ReduceOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp, op):
        return _all_reduce(x.clone(memory_format=torch.contiguous_format),
                           tp, op)

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


class _SliceReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, param, dim, start, length, tp):
        ctx.shape, ctx.dim, ctx.start, ctx.tp = param.shape, dim, start, tp
        return param.narrow(dim, start, length)

    @staticmethod
    def backward(ctx, grad):
        full = grad.new_zeros(ctx.shape)
        full.narrow(ctx.dim, ctx.start, grad.shape[ctx.dim]).copy_(grad)
        return _all_reduce(full, ctx.tp, "grad_slice"), None, None, None, None


def copy_in(x: torch.Tensor, tp: TensorParallel,
            op: str = "copy_in") -> torch.Tensor:
    """Identity forward; the gradient all-reduced over tp."""
    return _CopyIn.apply(x, tp, op)


def reduce_out(x: torch.Tensor, tp: TensorParallel,
               op: str = "reduce_out") -> torch.Tensor:
    """`x` all-reduced over tp; the gradient passed through."""
    return _ReduceOut.apply(x, tp, op)


def slice_replicated(param: torch.Tensor, dim: int, start: int, length: int,
                     tp: TensorParallel) -> torch.Tensor:
    """``param.narrow(dim, start, length)`` of a replicated parameter;
    its gradient scattered into the whole and all-reduced over tp."""
    return _SliceReplicated.apply(param, dim, start, length, tp)


def gather_last(local: torch.Tensor, start: int, total: int,
                tp: TensorParallel) -> torch.Tensor:
    """The whole last dim (`total` wide) from each rank's columns
    ``[start, start + local.shape[-1])``: an all-reduce of the
    zero-padded shard; the backward takes the slice."""
    padded = F.pad(local, (start, total - start - local.shape[-1]))
    return reduce_out(padded, tp, "gather")


def vocab_embed(table: torch.Tensor, ids: torch.Tensor, vocab: int,
                tp: TensorParallel, dtype: torch.dtype) -> torch.Tensor:
    """Rows of a vocab-parallel table for global `ids` (already made
    rows by `models.transformer.vocab_index`): a rank reads the ids in
    its rows and zeros elsewhere, and the ranks' rows are summed — each
    id's row comes from exactly one rank, so the sum is exact."""
    start, length = tp.span(vocab, "vocab_size")
    local = ids - start
    mine = (local >= 0) & (local < length)
    rows = table[local.clamp(0, length - 1)].to(dtype)
    rows = torch.where(mine[..., None], rows, torch.zeros((), dtype=dtype,
                                                          device=rows.device))
    return reduce_out(rows, tp, "embed")


# -- the model and its state ----------------------------------------------


# The config field that counts each logical axis a tp shard splits.
_COUNTS = ((sharding.VOCAB, "vocab_size"), (sharding.HEADS, "n_heads"),
           (sharding.MLP, "d_ff"))


def parallelize(model: torch.nn.Module, mesh) -> Optional[TensorParallel]:
    """Cut `model` to its shards over the tp dim of `mesh` (`shard`).
    Returns the rank's `TensorParallel`, or None — the model left as it
    is — when the mesh has no tp dim or no parameter's placement names
    tp."""
    tp = TensorParallel.of(mesh, mesh_lib.AXIS_TP)
    return tp if tp is not None and shard(model, tp) else None


def shard(model: torch.nn.Module, tp: TensorParallel) -> bool:
    """Slice `model`'s parameters to `tp`'s shards and give its modules
    the group (module docstring); False, the model untouched, when no
    placement names tp (ResNet, mnist's DenseClassifier, the DLRM: they
    train replicated over tp, as GSPMD places them). Raises ValueError,
    naming the config field, where tp does not divide a dim it splits,
    and NotImplementedError where a tp-sliced parameter's module cannot
    compute on its shard (it has no ``tp`` attribute) — both before
    anything is cut."""
    dims = sharding.tp_dims(model)
    if all(dim is None for dim in dims.values()):
        _logger.info("%s has no parameter placed over tp: it trains "
                     "replicated over tp=%d", type(model).__name__, tp.size)
        return False
    axes = {axis for names in sharding.logical_axes(model).values()
            if names for axis in names}
    cfg = model.config
    for axis, field in _COUNTS:
        if axis in axes:
            tp.span(getattr(cfg, field), field)
    if sharding.KV in axes:
        kv_span(cfg.n_heads, getattr(cfg, "n_kv_heads", cfg.n_heads), tp)
    owners = {name: model.get_submodule(name.rpartition(".")[0])
              for name, dim in dims.items() if dim is not None}
    for name, module in owners.items():
        if not hasattr(module, "tp"):
            raise NotImplementedError(
                f"{name} is placed over tp but its {type(module).__name__} "
                "has no tp attribute: it cannot compute on its shard")
    for name, param in list(model.named_parameters()):
        if name in owners:
            local = sharding.local_slice(param.detach(), dims[name], tp.size,
                                         tp.rank).clone()
            setattr(owners[name], name.rpartition(".")[2], torch.nn.Parameter(
                local, requires_grad=param.requires_grad))
    collectives.hand_group(model, "tp", tp)
    model.tp_dims = dims
    return True


def _gather(tensor: torch.Tensor, dim: int, tp: TensorParallel
            ) -> Optional[torch.Tensor]:
    """The whole tensor from each rank's shard along `dim`, on the host of
    the tp group's first rank (None on the others): a gather, through
    host memory under gloo."""
    if dist.get_backend(tp.group) != "nccl":
        tensor = tensor.cpu()
    tensor = tensor.contiguous()
    root = tp.rank == 0
    parts = [torch.empty_like(tensor) for _ in range(tp.size)] if root \
        else None
    dist.gather(tensor, parts, dst=dist.get_global_rank(tp.group, 0),
                group=tp.group)
    return torch.cat(parts, dim).cpu() if root else None


def gather_state(params: Mapping[str, torch.Tensor],
                 optimizer: Mapping, names: List[str],
                 dims: Mapping[str, Optional[int]], tp: TensorParallel
                 ) -> Tuple[Dict[str, torch.Tensor], Dict]:
    """The one-device format of a rank's state: each tp-sliced parameter
    and its optimizer state (keyed by parameter index, `names` giving
    each index's parameter) gathered whole. A collective every rank of
    the tp group calls; only its first rank (the one that writes) gets
    the gathered tensors, the others None in their place."""
    whole = {name: (value if dims.get(name) is None
                    else _gather(value, dims[name], tp))
             for name, value in params.items()}
    if not optimizer:
        return whole, optimizer
    state = {}
    for index, entry in optimizer["state"].items():
        dim = dims.get(names[index])
        state[index] = {
            key: (_gather(value, dim, tp) if dim is not None
                  and isinstance(value, torch.Tensor) and value.dim() > 0
                  else value)
            for key, value in entry.items()}
    return whole, dict(optimizer, state=state)


def shard_optimizer(optimizer: Mapping, names: List[str],
                    dims: Mapping[str, Optional[int]], tp: TensorParallel
                    ) -> Mapping:
    """A rank's slices of a one-device optimizer state (keyed by
    parameter index, `names` giving each index's parameter): each tensor
    of a tp-sliced parameter's state cut as `sharding.shard_like_annotated`
    cuts the parameter."""
    if not optimizer:
        return optimizer
    state = {}
    for index, entry in optimizer["state"].items():
        dim = dims.get(names[index])
        state[index] = {
            key: (sharding.local_slice(value, dim, tp.size, tp.rank)
                  .contiguous()
                  if isinstance(value, torch.Tensor) and value.dim() > 0
                  else value)
            for key, value in entry.items()}
    return dict(optimizer, state=state)
