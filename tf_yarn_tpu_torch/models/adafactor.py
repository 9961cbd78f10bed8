"""``optax.adafactor(learning_rate)`` for the port — the decoder's
``optimizer="adafactor"`` (JAX transformer.py:711-715).

optax 0.2.6's chain, at its defaults (optax/_src/alias.py, ``adafactor``):

1. ``scale_by_factored_rms``: decay ``1 - (count + 1) ** -0.8``, offset
   0, ``eps=1e-30`` added to the squared gradient. A leaf is factored
   over its two largest dims (numpy's ``argsort`` of its shape: ``d1``
   the second largest, ``d0`` the largest) when the second is at least
   128: it keeps the row means ``v_row`` (``d0`` reduced) and the column
   means ``v_col`` (``d1`` reduced), and the update is ``g ·
   (v_row / mean(v_row over d1)) ** -0.5 · v_col ** -0.5``. Any other
   leaf keeps ``v`` of its own shape and updates by ``g · v ** -0.5``;
2. ``clip_by_block_rms(1.0)``: each leaf's update divided by
   ``max(1, rms(update))``;
3. the learning rate;
4. ``scale_by_param_block_rms()``: times ``max(rms(param), 1e-3)`` (the
   parameter before the step);
5. the sign flip.

It is not `torch.optim.Adafactor`, whose rule and defaults differ.

Both block RMSes are taken over the whole JAX leaf, so the optimizer
groups the port's parameters into the leaves they come from
(`jax_leaves`): under ``scan_layers=True`` (the decoder's default) every
layer's tensor of one name makes one stacked ``[L, ...]`` leaf, as
flax's scan stacks it; under ``False`` each layer's tensor is its own
leaf, as is every parameter outside a layer stack. The factored means
of a stacked leaf keep its layer axis, so they are each layer's own
(only the block RMSes join the layers); a leaf whose layer count is one
of its two largest dims and at least 128 would couple them and raises.

A leaf cut over ranks is summed over the ranks that hold it: FSDP2's
shards over ``fsdp`` (DTensor parameters, dim 0), the expert slices over
``ep`` (the model's ``ep_dims``, `parallel.expert_parallel`), both at
once. The sums of squares of each block RMS, and the row and column sums
of a factored leaf along a cut dim, are all-reduced over those groups:
up to three rounds a step (the row and column sums with the parameters'
squares; the means of ``v_row``; the update's squares), each one
all-reduce a group set. Under FSDP2 the factored statistics
are DTensors placed as their parameter, a cut dim reduced away made
replicated, so `torch.distributed.checkpoint`'s full state gathers them.
Beside ``tp`` or ``pp`` it raises NotImplementedError (ROADMAP.md Queue
1 item 8f). The step writes each update into its parameter's ``grad``
(no update-sized buffer is kept); the train loop drops the gradients
before the next step.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from tf_yarn_tpu_torch import telemetry

MIN_DIM_SIZE_TO_FACTOR = 128
DECAY_RATE = 0.8
EPSILON = 1e-30
CLIPPING_THRESHOLD = 1.0
MIN_SCALE = 1e-3


def factored_dims(shape: Sequence[int],
                  min_dim_size_to_factor: int = MIN_DIM_SIZE_TO_FACTOR
                  ) -> Optional[Tuple[int, int]]:
    """optax's ``_factored_dims``: (d1, d0), the second largest and the
    largest dim of `shape` by numpy's argsort, or None (fewer than 2 dims,
    or the second largest under `min_dim_size_to_factor`)."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < min_dim_size_to_factor:
        return None
    return int(order[-2]), int(order[-1])


def _dtensor_type():
    try:
        from torch.distributed.tensor import DTensor
    except ImportError:  # a build without torch.distributed
        return None
    return DTensor


def _local(tensor: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard (a view), else the tensor."""
    dtensor = _dtensor_type()
    if dtensor is not None and isinstance(tensor, dtensor):
        return tensor.to_local()
    return tensor


class Part:
    """One parameter of a JAX leaf: its global shape and, for each of its
    dims cut over ranks, the process groups that hold the pieces."""

    def __init__(self, param: nn.Parameter, name: str) -> None:
        self.param = param
        self.name = name
        self.shape = list(param.shape)  # a DTensor's global shape
        self.groups: Dict[int, List] = {}
        dtensor = _dtensor_type()
        if dtensor is not None and isinstance(param, dtensor):
            for index, placement in enumerate(param.placements):
                if placement.is_shard():
                    self.groups.setdefault(placement.dim, []).append(
                        param.device_mesh.get_group(index))

    def cut(self, dim: int, group, size: int) -> None:
        """Dim `dim` is this rank's 1/`size` of the leaf's, over `group`."""
        self.shape[dim] *= size
        self.groups.setdefault(dim, []).insert(0, group)

    def all_groups(self) -> Tuple:
        return tuple(g for dim in sorted(self.groups)
                     for g in self.groups[dim])


class Leaf:
    """A JAX leaf: its parts in layer order, its global shape (with the
    leading layer axis when stacked) and its factored dims."""

    def __init__(self, name: str, parts: List[Part], stacked: bool) -> None:
        self.name = name
        self.parts = parts
        self.lead = 1 if stacked else 0
        self.shape = ((len(parts),) if stacked else ()) + tuple(parts[0].shape)
        self.numel = int(np.prod(self.shape))
        self.factored = factored_dims(self.shape)
        if self.factored is not None and stacked and 0 in self.factored:
            raise NotImplementedError(
                f"adafactor: the stacked leaf {name} {self.shape} would be "
                "factored over its layer axis; the port factors each layer's "
                "tensor (use scan_layers=False)")


def jax_leaves(model: nn.Module, params: Sequence[nn.Parameter]
               ) -> List[Leaf]:
    """`params` of `model` grouped into the JAX leaves they come from
    (module docstring), in the order of their first parameter."""
    names = {id(p): n for n, p in model.named_parameters()}
    cfg = getattr(model, "config", None)
    stacks = set(getattr(model, "stack_axes", {})) if getattr(
        cfg, "scan_layers", False) else set()
    ep_dims = getattr(model, "ep_dims", {})
    grouped: Dict[str, List[Part]] = {}
    stacked: Dict[str, bool] = {}
    for param in params:
        name = names[id(param)]
        part = Part(param, name)
        if ep_dims.get(name) is not None:
            ep = model.get_submodule(name.rpartition(".")[0]).ep
            part.cut(ep_dims[name], ep.group, ep.size)
        stack, _, rest = name.partition(".")
        index, _, leaf = rest.partition(".")
        if stack in stacks and index.isdigit():
            key, is_stacked = f"{stack}.*.{leaf}", True
        else:
            key, is_stacked = name, False
        grouped.setdefault(key, []).append(part)
        stacked[key] = is_stacked
    return [Leaf(key, parts, stacked[key]) for key, parts in grouped.items()]


class _Sums:
    """Partial sums all-reduced together, one flat all-reduce for each
    set of groups (a sum over none needs nothing)."""

    def __init__(self) -> None:
        self._items: Dict[Tuple, Tuple[Tuple, List[torch.Tensor]]] = {}

    def add(self, tensor: torch.Tensor, groups: Tuple) -> torch.Tensor:
        if groups:
            key = tuple(id(g) for g in groups)
            self._items.setdefault(key, (groups, []))[1].append(tensor)
        return tensor

    def run(self) -> None:
        for groups, tensors in self._items.values():
            flat = torch.cat([t.reshape(-1) for t in tensors])
            start = time.perf_counter()
            for group in groups:
                dist.all_reduce(flat, group=group)
            seconds = time.perf_counter() - start
            telemetry.get_tracer().record(
                "train/adafactor_allreduce", start, seconds,
                bytes=flat.numel() * flat.element_size())
            offset = 0
            for tensor in tensors:
                tensor.copy_(flat[offset:offset + tensor.numel()]
                             .view_as(tensor))
                offset += tensor.numel()
        self._items = {}


def _stat(part: Part, local: torch.Tensor, reduced: int) -> torch.Tensor:
    """A factored statistic of `part` (`local`: its local values, dim
    `reduced` of the parameter removed) as the state keeps it: a DTensor
    placed as its DTensor parameter (a cut dim reduced away replicated),
    else `local`."""
    param = part.param
    dtensor = _dtensor_type()
    if dtensor is None or not isinstance(param, dtensor):
        return local
    from torch.distributed.tensor import Replicate, Shard

    placements = []
    for placement in param.placements:
        if not placement.is_shard():
            placements.append(placement)
        elif placement.dim == reduced:
            placements.append(Replicate())
        else:
            placements.append(Shard(placement.dim - (placement.dim > reduced)))
    shape = list(param.shape)
    del shape[reduced]
    stride = [int(np.prod(shape[i + 1:])) for i in range(len(shape))]
    return dtensor.from_local(local, param.device_mesh, placements,
                              run_check=False, shape=torch.Size(shape),
                              stride=tuple(stride))


class Adafactor(torch.optim.Optimizer):
    """optax's adafactor over `leaves` (`jax_leaves`), one param group."""

    def __init__(self, leaves: List[Leaf], lr: float) -> None:
        self.leaves = leaves
        super().__init__([part.param for leaf in leaves
                          for part in leaf.parts], dict(lr=lr))

    def _state(self, leaf: Leaf, part: Part) -> dict:
        state = self.state[part.param]
        if state:
            return state
        local = _local(part.param)
        state["step"] = torch.tensor(0.0)
        if leaf.factored is None:
            state["v"] = torch.zeros_like(part.param)
            return state
        d1, d0 = (d - leaf.lead for d in leaf.factored)
        for key, dim in (("v_row", d0), ("v_col", d1)):
            shape = list(local.shape)
            del shape[dim]
            state[key] = _stat(part, local.new_zeros(shape), dim)
        return state

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        lr = self.param_groups[0]["lr"]
        sums = _Sums()
        work = []
        # Round 1: the factored leaves' row and column sums, each leaf's
        # parameter squares; the rest of the second moments.
        for leaf in self.leaves:
            param_sq = None
            for part in leaf.parts:
                state = self._state(leaf, part)
                grad = part.param.grad
                g = (_local(grad) if grad is not None
                     else torch.zeros_like(_local(part.param)))
                p = _local(part.param)
                square = p.float().square().sum()
                param_sq = square if param_sq is None else param_sq + square
                count = int(state["step"])
                state["step"] += 1
                t = torch.tensor(count + 1, dtype=torch.float32)
                decay_t = 1.0 - t ** (-DECAY_RATE)
                decay, keep = float(decay_t), float(1.0 - decay_t)
                sq = g * g + EPSILON
                if leaf.factored is None:
                    v = _local(state["v"])
                    v.mul_(decay).add_(sq, alpha=keep)
                    work.append((leaf, part, g, None, None, decay, keep))
                    continue
                d1, d0 = (d - leaf.lead for d in leaf.factored)
                row = sums.add(sq.sum(d0), tuple(part.groups.get(d0, ())))
                col = sums.add(sq.sum(d1), tuple(part.groups.get(d1, ())))
                del sq
                work.append((leaf, part, g, row, col, decay, keep))
            leaf.param_sq = sums.add(param_sq.reshape(1),
                                     leaf.parts[0].all_groups())
        sums.run()
        # Round 2: the new factored moments, and the means of v_row over d1.
        for item in work:
            leaf, part, g, row, col, decay, keep = item
            if row is None:
                continue
            d1, d0 = (d - leaf.lead for d in leaf.factored)
            state = self.state[part.param]
            v_row, v_col = _local(state["v_row"]), _local(state["v_col"])
            v_row.mul_(decay).add_(row / part.shape[d0], alpha=keep)
            v_col.mul_(decay).add_(col / part.shape[d1], alpha=keep)
            row_dim = d1 - 1 if d1 > d0 else d1
            part.row_mean = sums.add(v_row.sum(row_dim, keepdim=True),
                                     tuple(part.groups.get(d1, ())))
        sums.run()
        # Round 3: each update, written into its grad, and its squares.
        for leaf in self.leaves:
            leaf.update_sq = None
        for leaf, part, g, row, _, _, _ in work:
            state = self.state[part.param]
            if row is None:
                g.mul_(_local(state["v"]).rsqrt())
            else:
                d1, d0 = (d - leaf.lead for d in leaf.factored)
                v_row = _local(state["v_row"])
                row_factor = (v_row / (part.row_mean / part.shape[d1])).rsqrt()
                col_factor = _local(state["v_col"]).rsqrt()
                g.mul_(row_factor.unsqueeze(d0)).mul_(col_factor.unsqueeze(d1))
            part.update = g
            square = g.float().square().sum()
            leaf.update_sq = (square if leaf.update_sq is None
                              else leaf.update_sq + square)
        for leaf in self.leaves:
            sums.add(leaf.update_sq.reshape(1), leaf.parts[0].all_groups())
        sums.run()
        for leaf in self.leaves:
            clip = torch.clamp(torch.sqrt(leaf.update_sq / leaf.numel)
                               / CLIPPING_THRESHOLD, min=1.0)
            rms = torch.sqrt(leaf.param_sq / leaf.numel)
            scale = torch.where(rms <= MIN_SCALE, torch.full_like(
                rms, MIN_SCALE), rms)
            for part in leaf.parts:
                update = part.update.div_(clip).mul_(lr).mul_(scale)
                _local(part.param).sub_(update)
                del part.update
            del leaf.update_sq, leaf.param_sq
        for _, part, _, row, _, _, _ in work:
            if row is not None:
                del part.row_mean
        return loss


def adafactor(learning_rate: float):
    """``optax.adafactor(learning_rate)``: a factory ``model ->
    Adafactor`` over the parameters that require grad, grouped into the
    model's JAX leaves. Raises NotImplementedError for a model cut over
    ``tp`` or into ``pp`` stages (ROADMAP.md Queue 1 item 8f)."""

    def make(model: nn.Module) -> torch.optim.Optimizer:
        cut = [axis for axis in ("tp", "pp")
               if any(getattr(m, axis, None) is not None
                      for m in model.modules())]
        if cut:
            raise NotImplementedError(
                f"optimizer='adafactor' beside {' and '.join(cut)} is not "
                "ported yet (ROADMAP.md Queue 1 item 8f): its block RMS "
                "needs the sums of a leaf cut over those ranks")
        params = [p for p in model.parameters() if p.requires_grad]
        return Adafactor(jax_leaves(model, params), learning_rate)

    return make
