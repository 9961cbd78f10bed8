"""Pipeline parallelism over the ``pp`` mesh dim (the GPipe schedule) —
counterpart of tf_yarn_tpu/parallel/pipeline.py.

Each rank of the ``pp`` group holds one stage of a stack of layers. The
batch is cut into microbatches that fill the pipe: at tick ``t`` stage 0
takes microbatch ``t``, every stage computes, and the activations move
one hop to the next stage (`collectives.shift`, whose backward carries
the gradients back). After ``n_micro + n_stages - 1`` ticks the last
stage holds every microbatch's output, and those reach every ``pp`` rank
(the JAX package's one-hot ``psum``: an all-reduce in which only the
last stage adds its outputs; backward, the last stage takes the
gradient, which every rank's replicated computation after the pipeline
gives alike). A stage computes only at the ticks that carry one of its
microbatches — microbatch ``t - stage`` — and sends zeros in the
bubble, where the JAX schedule computes on data it then drops: the same
outputs, fewer launches. So that every rank runs the backward of every
shift in the same order, each shift's result is tied to the output
(`collectives.tie`) and made to require a gradient.

* `pipeline_apply(stage_fn, stage_params, x, mesh, num_microbatches,
  batch_axes)` — JAX's surface (``:90-154``): `stage_params` leaves with
  a leading axis of the stage count, of which the rank takes its slice
  (``shard_map``'s ``P(pp)``), and its errors. At ``pp == 1`` the stages
  run in sequence.
* `pipeline_schedule(stage_fn, x, group, num_microbatches,
  data_shards)` — the schedule itself, for a model that holds only its
  stage's layers (`stage_fn(h)` closes over them): the decoder under
  ``pp`` (`models.transformer`).
* `parallelize(model, mesh)` — cut a model's layer stack into the
  rank's stage: the stack the model annotated with the ``"layers"``
  logical axis (`sharding.annotate_stack`), which `LOGICAL_RULES` places
  over ``pp``, keeps its contiguous ``n_layers / pp`` layers and drops
  the others (`Dropped` in their place, so the state dict keeps the
  one-rank names). A model with no such stack trains replicated over
  ``pp``, as GSPMD places it.

`x` on a rank is its data group's share of the batch: the JAX checks of
the global batch (divisible by the microbatches; the microbatch a
multiple of the data sharding) hold exactly when the share divides into
the microbatches. A microbatch of the share holds other rows of the
global batch than JAX's microbatch of the same index, and the stages
compute row by row, so every row's output is the same.
"""

from __future__ import annotations

import logging
import math
from typing import Callable, Optional

import torch
import torch.distributed as dist
from torch import nn
from torch.utils import _pytree as pytree

from tf_yarn_tpu_torch.parallel import collectives
from tf_yarn_tpu_torch.parallel import mesh as mesh_lib
from tf_yarn_tpu_torch.parallel.mesh import AXIS_PP

_logger = logging.getLogger(__name__)

SPAN = "train/pp_send"


class _FromLast(torch.autograd.Function):
    """The last stage's outputs on every rank of the group: forward, an
    all-reduce to which the other stages add zeros; backward, the last
    stage's gradient (every rank computes the same thing after the
    pipeline, so the others' copies are dropped, not summed). The shifts'
    results ride along, each given a zero gradient."""

    @staticmethod
    def forward(ctx, local, group, last, *sent):
        ctx.last = last
        ctx.sent = [(t.shape, t.dtype, t.device) for t in sent]
        out = local.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return (grad if ctx.last else torch.zeros_like(grad), None, None,
                *(torch.zeros(shape, dtype=dtype, device=device)
                  for shape, dtype, device in ctx.sent))


def _data_checks(local_batch: int, n_micro: int, data_shards: int,
                 batch_axes) -> None:
    """JAX's two batch errors (pipeline.py:129-140), on the global batch
    that this rank's share is 1 / `data_shards` of."""
    batch = local_batch * data_shards
    if batch % n_micro:
        raise ValueError(
            f"batch {batch} not divisible by num_microbatches {n_micro}"
        )
    mb = batch // n_micro
    if mb % data_shards:
        raise ValueError(
            f"microbatch size {mb} (= batch {batch} / {n_micro} "
            f"microbatches) must be a multiple of the data sharding "
            f"{data_shards} (product of mesh axes {tuple(batch_axes)}) — use "
            "fewer microbatches or a larger batch"
        )


def pipeline_schedule(stage_fn: Callable[[torch.Tensor], torch.Tensor],
                      x: torch.Tensor, group: collectives.AxisGroup,
                      num_microbatches: int, data_shards: int = 1,
                      batch_axes=mesh_lib.BATCH_AXES) -> torch.Tensor:
    """The GPipe schedule of `stage_fn` (this rank's stage, ``[mb, ...] ->
    [mb, ...]`` of the same shape) over the stages of `group`: `x` is the
    rank's share of the batch (stage 0's input; every rank passes it),
    and every rank returns the last stage's output for it."""
    n_micro, n_stages, stage = num_microbatches, group.size, group.rank
    _data_checks(x.shape[0], n_micro, data_shards, batch_axes)
    micro = x.reshape(n_micro, x.shape[0] // n_micro, *x.shape[1:])
    grad = torch.is_grad_enabled()
    anchor = (torch.zeros((), device=x.device, requires_grad=True)
              if grad else None)
    ticks = n_micro + n_stages - 1
    held = torch.zeros_like(micro[0])
    outputs, sent = [], []
    for t in range(ticks):
        index = t - stage  # the microbatch this stage holds at tick t
        if 0 <= index < n_micro:
            computed = stage_fn(micro[index] if stage == 0 else held)
            if stage == n_stages - 1:
                outputs.append(computed)
        else:
            computed = torch.zeros_like(micro[0])  # the bubble
        if t != ticks - 1:
            held = collectives.shift(computed, group.group, 1, SPAN,
                                     anchor=anchor)
            if grad:
                sent.append(held)
    last = stage == n_stages - 1
    local = torch.cat(outputs) if last else torch.zeros_like(x)
    return _FromLast.apply(local, group.group, last, *sent)


def pipeline_apply(stage_fn: Callable, stage_params, x: torch.Tensor, mesh,
                   num_microbatches: int = 4,
                   batch_axes=mesh_lib.BATCH_AXES) -> torch.Tensor:
    """Run `x` (this rank's share of the batch) through the staged
    computation over `mesh`'s ``pp`` dim: ``stage_fn(params, h)``, with
    `stage_params` a pytree whose leaves have a leading axis of the stage
    count (the rank uses its slice). Raises JAX's ValueErrors on the
    leading dims and the batch."""
    n_stages = mesh_lib.mesh_axis_size(mesh, AXIS_PP)
    leaves = pytree.tree_leaves(stage_params)
    if n_stages == 1:
        for i in range(leaves[0].shape[0]):
            x = stage_fn(pytree.tree_map(lambda p: p[i], stage_params), x)
        return x
    leading = {leaf.shape[0] for leaf in leaves}
    if leading != {n_stages}:
        raise ValueError(
            f"stage_params leading dims {sorted(leading)} must all equal the "
            f"pp mesh axis size {n_stages} (one stage slice per pp shard)"
        )
    group = collectives.AxisGroup.of(mesh, AXIS_PP)
    params = pytree.tree_map(lambda p: p[group.rank], stage_params)
    data_shards = math.prod(mesh_lib.mesh_axis_size(mesh, axis)
                            for axis in batch_axes)
    return pipeline_schedule(lambda h: stage_fn(params, h), x, group,
                             num_microbatches, data_shards, batch_axes)


class Dropped(nn.Module):
    """The place of a layer another pipeline stage holds: no parameters,
    and calling it is an error."""

    def forward(self, *args, **kwargs):
        raise RuntimeError("this layer lives on another pipeline stage")


class PipelineStage(collectives.AxisGroup):
    """A rank's stage: its ``pp`` group, the span of layers it holds
    (``first``, ``count``) and the data groups the global batch is cut
    into (for the batch checks)."""

    def __init__(self, group: collectives.AxisGroup, first: int, count: int,
                 data_shards: int) -> None:
        super().__init__(group.group, group.size, group.rank, group.axis)
        self.first = first
        self.count = count
        self.data_shards = data_shards

    def layers(self) -> range:
        return range(self.first, self.first + self.count)


def parallelize(model: nn.Module, mesh) -> Optional[PipelineStage]:
    """Cut `model`'s ``"layers"`` stack (`sharding.stack_placement`) to
    the rank's contiguous stage over `mesh`'s ``pp`` dim and hand the
    model its `PipelineStage` (its ``pp`` attribute). None — the model
    untouched — when the mesh has no ``pp`` dim or the model no stack
    placed over it. Raises JAX's ValueError when the layers do not divide
    over the stages."""
    from tf_yarn_tpu_torch.parallel import sharding

    group = collectives.AxisGroup.of(mesh, AXIS_PP)
    if group is None:
        return None
    stacks = [name for name, axis in sharding.stack_placement(model).items()
              if axis == AXIS_PP]
    if not stacks or not hasattr(model, "pp"):
        _logger.info("%s has no layer stack placed over pp: it trains "
                     "replicated over pp=%d", type(model).__name__,
                     group.size)
        return None
    data_shards = math.prod(mesh_lib.mesh_axis_size(mesh, axis)
                            for axis in mesh_lib.BATCH_AXES)
    stage = None
    for name in stacks:
        stack = getattr(model, name)
        if len(stack) % group.size:
            raise ValueError(f"n_layers={len(stack)} must divide over "
                             f"pp={group.size} stages")
        count = len(stack) // group.size
        stage = PipelineStage(group, group.rank * count, count, data_shards)
        for i in range(len(stack)):
            if i not in stage.layers():
                stack[i] = Dropped()
    model.pp = stage
    return stage
