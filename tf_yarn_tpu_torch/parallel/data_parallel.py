"""The train loop's data-parallel wrap over the ``dp`` and ``fsdp`` dims
of a ``("pp", "dp", "fsdp", "sp", "tp", "ep")`` mesh, and the gradient
sums over ``sp`` and ``pp``.

The JAX package shards the train state over the mesh with XLA inserting
the collectives (training.py:574-760 under a multi-device mesh). The
port is eager PyTorch with one process per rank, so the wrap is
explicit, by the mesh's sizes:

* ``dp`` only — `DistributedDataParallel` on the rank's device: the
  parameters replicated, the gradients all-reduced (mean) over ``dp``
  as the backward runs;
* ``fsdp`` > 1 — FSDP2 ``fully_shard`` on each block (the repeated
  layers: members of a ModuleList or Sequential, ``layer_<i>`` or
  ``block_<i>``), then on the root, over the mesh's ``fsdp`` dim: the
  parameters and the optimizer state sharded, the gradients
  reduce-scattered;
* both > 1 — FSDP2's hybrid form over the 2-D mesh: replicated over
  ``dp``, sharded over ``fsdp``;
* both 1 (a mesh of ``tp`` alone) — no wrap.

Under tensor or expert parallelism the model it wraps holds the rank's
``tp`` shards or ``ep`` experts already (`parallel.tensor_parallel.
parallelize`, `parallel.expert_parallel.parallelize`): DDP and FSDP2
treat them as the whole parameters, over the groups of ranks that share
the rank's ``tp`` and ``ep`` indices.

Under sequence parallelism a rank of a sequence-sharded model (the
decoder, ``sp`` handed to it) computes its block of the sequence, so
every parameter's gradient is its block's share: `reduce_partial_grads`
sums them over the ``sp`` group after the backward (one all-reduce of
the flattened gradients), beside DDP's mean over ``dp`` or FSDP2's
reduce-scatter over ``fsdp`` (then of the rank's shards). A model
replicated over ``sp`` (the encoders, whose attention alone is cut)
gets whole gradients and no sum. Under the pipeline a rank holds one
stage of the layers (`parallel.pipeline`): the embedding, read by stage
0 alone, has its gradient summed over ``pp``; the final norm and head,
computed alike on every stage, do not. Each sum is a
``train/grad_allreduce`` span (with ``axis``) and goes into the
``train/grad_allreduce_seconds`` histogram.

`DataParallel` keeps the inner module (``inner``): the loop reads the
dropout ``generator``, the FLOP count and LoRA merges from it, and calls
``module``, the wrapper. Its state dict is the one-device run's format
(`full_state`, gathered in full and onto the host under FSDP2, the
optimizer's state keyed by parameter index as ``optimizer.state_dict()``
keys it, the ``tp`` shards and then the ``ep`` experts gathered whole
through `tensor_parallel.gather_state`, and the other stages' layers and their
optimizer state gathered to the first stage through the host under
``pp``, a batch of leaves a gather (`checkpoint._plan_gather_batches`),
numbered as the one-device optimizer numbers them
(`optimizer_layout`)), so a checkpoint of any world size and mesh
resumes at any other.

Under DDP each gradient bucket's all-reduce is timed from its launch to
its completion, as the host sees it: a ``train/grad_allreduce`` span
(with the step and bucket bytes) and the ``train/grad_allreduce_seconds``
histogram. FSDP2's collectives are its own and are not timed.
"""

from __future__ import annotations

import contextlib
import logging
import re
import time
from typing import Any, Dict, Iterator, List, Optional

import torch
import torch.distributed as dist
from torch import nn

from tf_yarn_tpu_torch import telemetry
from tf_yarn_tpu_torch.parallel import collectives
from tf_yarn_tpu_torch.parallel import mesh as mesh_lib
from tf_yarn_tpu_torch.parallel import sharding
from tf_yarn_tpu_torch.parallel import tensor_parallel as tp_lib

_logger = logging.getLogger(__name__)

_BLOCK_NAME = re.compile(r"(?:layer|block)_\d+")


def blocks(model: nn.Module) -> List[nn.Module]:
    """The outermost repeated blocks of `model` that hold parameters: the
    members of a ModuleList or Sequential, and submodules named
    ``layer_<i>`` or ``block_<i>``."""
    found: List[str] = []
    out: List[nn.Module] = []
    containers = {name for name, module in model.named_modules()
                  if isinstance(module, (nn.ModuleList, nn.Sequential))}
    for name, module in model.named_modules():
        if not name or name in containers:
            continue
        if any(name.startswith(prefix + ".") for prefix in found):
            continue
        parent, _, leaf = name.rpartition(".")
        if (parent in containers or _BLOCK_NAME.fullmatch(leaf)) and any(
                True for _ in module.parameters()):
            found.append(name)
            out.append(module)
    return out


class AllReduceTimer:
    """The state of `timed_allreduce`: the group and the step running."""

    def __init__(self, group) -> None:
        self.group = group
        self.step = 0


def timed_allreduce(timer: AllReduceTimer, bucket):
    """DDP comm hook: the default mean all-reduce of a bucket, timed from
    its launch to its completion."""
    group = timer.group
    tensor = bucket.buffer()
    n_bytes = tensor.numel() * tensor.element_size()
    tensor.div_(dist.get_world_size(group))
    start = time.perf_counter()
    future = dist.all_reduce(tensor, group=group, async_op=True).get_future()
    step = timer.step

    def done(fut):
        seconds = time.perf_counter() - start
        telemetry.get_tracer().record("train/grad_allreduce", start, seconds,
                                      step=step, bytes=n_bytes)
        telemetry.get_registry().histogram(
            "train/grad_allreduce_seconds").observe(seconds)
        return fut.value()[0]

    return future.then(done)


class DataParallel:
    """`model` (on `device`) wrapped over `mesh` for data-parallel
    training, with the optimizer that ``make_optimizer(model)`` builds
    over the wrapped parameters."""

    def __init__(self, model: nn.Module, mesh, device: torch.device,
                 make_optimizer, tp=None, sp=None, pp=None,
                 layout=None, ep=None) -> None:
        self.inner = model
        self.mesh = mesh
        # The tp group of a model `tensor_parallel.parallelize` sliced,
        # and each parameter's tp dim (None: replicated).
        self.tp = tp
        self.tp_dims = getattr(model, "tp_dims", {})
        # The ep group of a model `expert_parallel.parallelize` cut, and
        # each parameter's ep dim.
        self.ep = ep
        self.ep_dims = getattr(model, "ep_dims", {})
        # The sp group of a sequence-sharded model, the pipeline stage of
        # a staged one and the one-device optimizer's layout
        # (`optimizer_layout`) its checkpoints are numbered by.
        self.sp = sp
        self.pp = pp
        self.layout = layout
        # The rank's data group: the dropout seed folds in its index.
        self.data_index = mesh_lib.data_group(mesh)[0]
        dp = mesh_lib.mesh_axis_size(mesh, mesh_lib.AXIS_DP)
        fsdp = mesh_lib.mesh_axis_size(mesh, mesh_lib.AXIS_FSDP)
        self.timer = None
        if fsdp > 1:
            from torch.distributed.fsdp import fully_shard

            shard_mesh = (mesh[(mesh_lib.AXIS_DP, mesh_lib.AXIS_FSDP)]
                          if dp > 1 else mesh[mesh_lib.AXIS_FSDP])
            for block in blocks(model):
                fully_shard(block, mesh=shard_mesh)
            fully_shard(model, mesh=shard_mesh)
            self.kind = "hsdp" if dp > 1 else "fsdp"
            self.module = model
        elif dp > 1:
            from torch.nn.parallel import DistributedDataParallel

            group = mesh[mesh_lib.AXIS_DP].get_group()
            # find_unused_parameters: a parameter no forward reads (BERT's
            # segment_embedding without segments) must not stall the
            # bucket it sits in.
            self.module = DistributedDataParallel(
                model, device_ids=[device.index] if device.type == "cuda"
                else None, process_group=group, find_unused_parameters=True)
            self.timer = AllReduceTimer(group)
            self.module.register_comm_hook(self.timer, timed_allreduce)
            self.kind = "ddp"
        else:
            self.module = model
            self.kind = "tp"
        self.optimizer = make_optimizer(model)
        names = {id(param): name for name, param in model.named_parameters()}
        # Parameter index (as optimizer.state_dict() numbers them) -> name.
        self._names = [names[id(param)]
                       for group in self.optimizer.param_groups
                       for param in group["params"]]

    @contextlib.contextmanager
    def gradient_sync(self, sync: bool) -> Iterator[None]:
        """The forward and backward inside reduce the gradients over the
        mesh only when `sync` (the last microbatch of a step)."""
        if sync or self.kind == "tp":
            yield
        elif self.kind == "ddp":
            with self.module.no_sync():
                yield
        else:
            self.module.set_requires_gradient_sync(False)
            try:
                yield
            finally:
                self.module.set_requires_gradient_sync(True)

    def reduce_partial_grads(self, step: int = 0) -> None:
        """Sum the gradients that are a rank's share over their group: every
        trained parameter's over ``sp`` (a sequence-sharded model), the
        pipeline's inputs' (`pipeline_inputs`: the embedding) over ``pp``.
        A parameter without a gradient adds zeros. Every rank of the
        groups calls it after the step's backward."""
        trained = [(name, param) for name, param
                   in self.inner.named_parameters() if param.requires_grad]
        if self.sp is not None:
            _sum_grads([p for _, p in trained], self.sp, step)
        if self.pp is not None:
            inputs = set(getattr(self.inner, "pipeline_inputs", ()))
            _sum_grads([p for n, p in trained if n in inputs], self.pp, step)

    def full_state(self) -> Dict[str, Any]:
        """``{"params": ..., "optimizer": ...}`` in the one-device format.
        Under FSDP2, tp, ep or pp a collective that every rank calls;
        under FSDP2 alone only rank 0 (the writer) gets the optimizer's
        state, under tp, ep and pp the first rank of the group."""
        state = self._local_state()
        for group, dims in ((self.tp, self.tp_dims), (self.ep, self.ep_dims)):
            if group is not None:
                params, optimizer = tp_lib.gather_state(
                    state["params"], state["optimizer"], self._names, dims,
                    group)
                state = {"params": params, "optimizer": optimizer}
        if self.pp is not None:
            state = self._gather_stages(state)
        return state

    def _stage_leaves(self) -> List[tuple]:
        """(stack, leaf) of each parameter of the first layer the rank's
        stage holds, in its order (the same on every stage)."""
        out = []
        for name, _ in self.inner.named_parameters():
            stack, _, rest = name.partition(".")
            index, _, leaf = rest.partition(".")
            if index.isdigit() and int(index) == self.pp.first:
                out.append((stack, leaf))
        return out

    def _gather_stages(self, state: Dict[str, Any]) -> Dict[str, Any]:
        """The whole model's state on the first stage (gathered layer by
        layer, through the host under gloo), the optimizer's numbered as
        the one-device optimizer numbers it; None in the others'
        tensors' places."""
        stage = self.pp
        root = stage.rank == 0
        params = dict(state["params"])
        by_name = {}
        optimizer = state["optimizer"]
        if optimizer:
            by_name = {self._names[i]: entry
                       for i, entry in optimizer["state"].items()}
        # Every leaf to gather, in one order on every stage: each
        # parameter of the stage's layers, then its optimizer tensors.
        leaves = []  # (stack, leaf, j, optimizer key or None, tensor)
        for stack, leaf in self._stage_leaves():
            for j in range(stage.count):
                mine = f"{stack}.{stage.first + j}.{leaf}"
                leaves.append((stack, leaf, j, None, params[mine]))
                entry = by_name.get(mine, {})
                leaves += [(stack, leaf, j, key, entry[key])
                           for key in sorted(entry)
                           if isinstance(entry[key], torch.Tensor)]
        gathered = _gather_leaves([leaf[-1] for leaf in leaves], stage)
        for (stack, leaf, j, key, _), parts in zip(leaves, gathered):
            entry = by_name.get(f"{stack}.{stage.first + j}.{leaf}", {})
            for s, part in enumerate(parts or []):
                other = f"{stack}.{s * stage.count + j}.{leaf}"
                if key is None:
                    params[other] = part
                else:
                    by_name.setdefault(other, dict(entry))[key] = part
        if not root:
            return {"params": {name: None for name in params},
                    "optimizer": {}}
        if not optimizer:
            return {"params": params, "optimizer": optimizer}
        order = self.layout["names"]
        return {"params": params, "optimizer": {
            "state": {i: by_name[name] for i, name in enumerate(order)
                      if name in by_name},
            "param_groups": self.layout["groups"]}}

    def _stage_state(self, state: Dict[str, Any]) -> Dict[str, Any]:
        """The rank's part of a one-device state: its stage's layers and
        the parameters every stage holds, the optimizer's renumbered to
        the rank's optimizer."""
        own = set(self.inner.state_dict())
        params = {name: value for name, value in state["params"].items()
                  if name in own}
        optim = state["optimizer"]
        if not optim:
            return {"params": params, "optimizer": optim}
        order = self.layout["names"]
        index = {name: i for i, name in enumerate(self._names)}
        groups = []
        for group in optim["param_groups"]:
            mine = [index[order[i]] for i in group["params"]
                    if order[i] in index]
            if mine:
                groups.append(dict(group, params=mine))
        return {"params": params, "optimizer": {
            "state": {index[order[i]]: entry
                      for i, entry in optim["state"].items()
                      if order[i] in index},
            "param_groups": groups}}

    def _local_state(self) -> Dict[str, Any]:
        """The state of the rank's model in the one-device format of its
        tp shard: gathered over fsdp, each tensor as the rank holds it
        over tp."""
        if self.kind in ("ddp", "tp"):
            return {"params": self.inner.state_dict(),
                    "optimizer": self.optimizer.state_dict()}
        from torch.distributed.checkpoint.state_dict import (
            StateDictOptions, get_model_state_dict, get_optimizer_state_dict)

        # With cpu_offload only rank 0 gets the state; under tp or ep
        # every rank's shard is gathered, so every rank keeps its own.
        options = StateDictOptions(
            full_state_dict=True,
            cpu_offload=self.tp is None and self.ep is None)
        optim = get_optimizer_state_dict(self.inner, self.optimizer,
                                         options=options)
        params = get_model_state_dict(self.inner, options=options)
        if "state" not in optim:
            return {"params": params, "optimizer": {}}
        index = {name: i for i, name in enumerate(self._names)}
        return {
            "params": params,
            "optimizer": {
                "state": {index[name]: value
                          for name, value in optim["state"].items()},
                "param_groups": [
                    dict(group, params=[index[name] for name in group["params"]])
                    for group in optim["param_groups"]]},
        }

    def reshard_state(self, state: Dict[str, Any],
                      old_spec=None) -> Dict[str, Any]:
        """The rank's part of a restored one-device train state
        (`full_state`'s format, which a checkpoint of any world size and
        mesh is) on this attempt's mesh — the elastic-resume primitive,
        JAX ``sharding.reshard_state`` (sharding.py:146-187): the rank's
        pipeline stage's leaves, the optimizer's renumbered to the rank's
        optimizer; each ``tp``- or ``ep``-placed parameter and its
        optimizer state cut to the rank's slice
        (`sharding.shard_like_annotated`); the
        rest, and the entries besides the two parts, as they are. Pure
        data movement: every value the rank keeps is the checkpoint's,
        bit for bit. `old_spec` (the declared `MeshSpec` an elastic
        attempt refit) is advisory: logged, so a resize shows in the
        task logs."""
        if old_spec is not None:
            _logger.info("resharding state: %s -> %s", old_spec,
                         dict(zip(self.mesh.mesh_dim_names, self.mesh.shape)))
        part = self._stage_state(state) if self.pp is not None else state
        params, optim = part["params"], part["optimizer"]
        if self.tp is not None or self.ep is not None:
            params = sharding.shard_like_annotated(self.inner, params,
                                                   self.mesh)
        for group, dims in ((self.tp, self.tp_dims), (self.ep, self.ep_dims)):
            if group is not None:
                optim = tp_lib.shard_optimizer(optim, self._names, dims,
                                               group)
        return dict(state, params=params, optimizer=optim)

    def load_rank_state(self, state: Dict[str, Any]) -> None:
        """Load the rank's part of a one-device state (`reshard_state`):
        DDP and tp load it as it is; under FSDP2 every rank loads it whole
        and keeps its shard."""
        params, optim = state["params"], state["optimizer"]
        if self.kind in ("ddp", "tp"):
            self.inner.load_state_dict(params)
            self.optimizer.load_state_dict(optim)
            return
        from torch.distributed.checkpoint.state_dict import (
            StateDictOptions, set_model_state_dict, set_optimizer_state_dict)

        options = StateDictOptions(full_state_dict=True)
        set_model_state_dict(self.inner, params, options=options)
        set_optimizer_state_dict(self.inner, self.optimizer, {
            "state": {self._names[i]: value
                      for i, value in optim["state"].items()},
            "param_groups": [
                dict(group, params=[self._names[i] for i in group["params"]])
                for group in optim["param_groups"]]}, options=options)


def sequence_parallelize(model: nn.Module, mesh):
    """Hand the model the ``sp`` group of `mesh` where it computes a block
    of the sequence (modules with an ``sp`` attribute: the decoder);
    returns the group, or None when the mesh has no ``sp`` dim or the
    model is replicated over it (its attention, if it has any, cuts the
    sequence through the registered mesh)."""
    group = collectives.AxisGroup.of(mesh, mesh_lib.AXIS_SP)
    if group is None:
        return None
    if collectives.hand_group(model, "sp", group):
        return group
    _logger.info("%s computes the whole sequence on every rank of sp=%d "
                 "(its attention cuts it)", type(model).__name__, group.size)
    return None


def optimizer_layout(model: nn.Module, make_optimizer) -> Dict[str, Any]:
    """How the one-device optimizer of `model` (whole, before any cut)
    numbers its parameters: ``names`` (index -> parameter name) and its
    ``param_groups`` as ``optimizer.state_dict()`` gives them. The
    optimizer built for it holds no state and is dropped."""
    optimizer = make_optimizer(model)
    names = {id(param): name for name, param in model.named_parameters()}
    return {"names": [names[id(param)] for group in optimizer.param_groups
                      for param in group["params"]],
            "groups": optimizer.state_dict()["param_groups"]}


def _sum_grads(params: List[torch.Tensor], group, step: int) -> None:
    """Sum `params`' gradients (zeros where there is none) over the
    `collectives.AxisGroup` `group`, one all-reduce for each dtype. Under
    FSDP2 a gradient is the rank's shard, after the reduce-scatter over
    ``fsdp``: the ranks of `group` hold the same shards, and the sum is
    of those."""
    from torch.distributed.tensor import DTensor

    if not params:
        return
    for param in params:
        if param.grad is None:
            param.grad = torch.zeros_like(param)
    by_dtype: Dict[Any, List[torch.Tensor]] = {}
    for param in params:
        grad = param.grad
        if isinstance(grad, DTensor):
            grad = grad.to_local()  # a view: the sum lands in the shard
        by_dtype.setdefault((grad.dtype, grad.device), []).append(grad)
    for grads in by_dtype.values():
        flat = torch.cat([g.reshape(-1) for g in grads])
        start = time.perf_counter()
        dist.all_reduce(flat, group=group.group)
        seconds = time.perf_counter() - start
        telemetry.get_tracer().record(
            "train/grad_allreduce", start, seconds, step=step,
            bytes=flat.numel() * flat.element_size(), axis=group.axis)
        telemetry.get_registry().histogram(
            "train/grad_allreduce_seconds").observe(seconds)
        offset = 0
        for grad in grads:
            grad.copy_(flat[offset:offset + grad.numel()].view_as(grad))
            offset += grad.numel()


def _gather_parts(tensor: torch.Tensor, stage) -> Optional[List[torch.Tensor]]:
    """Every stage's tensor of the same shape on the first stage's host
    (None on the others): a gather, through host memory under gloo."""
    if dist.get_backend(stage.group) != "nccl":
        tensor = tensor.cpu()
    tensor = tensor.contiguous()
    root = stage.rank == 0
    parts = ([torch.empty_like(tensor) for _ in range(stage.size)] if root
             else None)
    dist.gather(tensor, parts, dst=dist.get_global_rank(stage.group, 0),
                group=stage.group)
    return [part.cpu() for part in parts] if root else None


def _gather_leaves(tensors: List[torch.Tensor], stage
                   ) -> List[Optional[List[torch.Tensor]]]:
    """`_gather_parts` of each tensor, in batches of at most
    `checkpoint._GATHER_BATCH_BYTES` planned by `_plan_gather_batches`
    (the JAX package's staged gather): one gather a batch of bytes, not
    one a leaf, and never more than one batch (or one larger leaf) in
    flight. Each tensor's parts on the first stage (on its host), None on
    the others."""
    from tf_yarn_tpu_torch.checkpoint import (_GATHER_BATCH_BYTES,
                                              _plan_gather_batches)

    wire = (torch.device("cuda", torch.cuda.current_device())
            if dist.get_backend(stage.group) == "nccl"
            else torch.device("cpu"))
    sizes = [t.numel() * t.element_size() for t in tensors]
    out: List[Optional[List[torch.Tensor]]] = [None] * len(tensors)
    for batch in _plan_gather_batches(enumerate(sizes), _GATHER_BATCH_BYTES):
        flat = torch.cat([tensors[i].detach().to(wire).contiguous()
                          .reshape(-1).view(torch.uint8) for i in batch])
        parts = _gather_parts(flat, stage)
        if parts is None:
            continue
        offset = 0
        for i in batch:
            t, n = tensors[i], sizes[i]
            out[i] = [part[offset:offset + n].clone().view(t.dtype)
                      .reshape(t.shape) for part in parts]
            offset += n
    return out


def wire_device(device: torch.device) -> torch.device:
    """Where a small host-read collective's tensor lives: the card under
    NCCL, the CPU under gloo."""
    return device if dist.get_backend() == "nccl" else torch.device("cpu")


def mean_metrics(metrics: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """The ranks' scalar metrics averaged over the default group in one
    all-reduce (each rank's share of the global batch is the same size,
    and the ranks of a tp group hold equal values, so this is the mean
    over data groups); ``perplexity`` is re-derived as exp(mean loss),
    the global batch's."""
    if not metrics:
        return {}
    keys = sorted(metrics)
    values = torch.stack([torch.as_tensor(metrics[k]).detach().reshape(())
                          .to(torch.float64) for k in keys])
    values = values.to(wire_device(values.device))
    dist.all_reduce(values)
    out = dict(zip(keys, (values / dist.get_world_size()).tolist()))
    if "perplexity" in out and "loss" in out:
        out["perplexity"] = float(torch.exp(torch.tensor(out["loss"])))
    return out


def weighted_eval_means(batches: List[Dict[str, float]], rows: List[int],
                        device: torch.device) -> Dict[str, float]:
    """The eval metrics of the global batches: each batch's metrics,
    weighted by its rows on each rank, summed over the ranks in one
    all-reduce, then averaged over the batches as one device's
    `training.evaluate` averages them. ``perplexity`` is exp of each
    batch's global loss."""
    if not batches:
        return {}
    keys = sorted(batches[0])
    table = torch.tensor([[b[k] * n for k in keys] + [n]
                          for b, n in zip(batches, rows)],
                         dtype=torch.float64, device=wire_device(device))
    dist.all_reduce(table)
    means = (table[:, :-1] / table[:, -1:]).cpu()
    per_key = dict(zip(keys, means.unbind(1)))
    if "perplexity" in per_key and "loss" in per_key:
        per_key["perplexity"] = torch.exp(per_key["loss"])
    return {k: float(v.mean()) for k, v in per_key.items()}
