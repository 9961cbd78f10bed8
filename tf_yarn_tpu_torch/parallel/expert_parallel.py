"""Expert parallelism over the mesh's ``ep`` dim — what GSPMD does in the
JAX package with the ``("expert", "ep")`` rule (sharding.py:49), which
places the leading axis of every expert leaf over ``ep``; the JAX package
has no file of its own for it.

`parallelize(model, mesh)` cuts each parameter whose placement names
``ep`` (`models.moe.MoEMlp`'s ``w_gate``, ``w_up`` and ``w_down``, whose
logical axes lead with ``"expert"``) to the rank's contiguous ``E / ep``
experts, and hands the `ExpertParallel` group to every module with an
``ep`` attribute. A rank then computes the router, the positions and the
dispatch for every token of its data shard, runs its own experts, and
sums the partial combine over ``ep`` with `tensor_parallel`'s conjugate
pair (`copy_in` on the dispatch input: its gradient summed; `reduce_out`
on the combine; module docstring of `models.moe`). Every other
parameter stays whole on every ``ep`` rank, with the same gradient: the
gate multiplies after the sum. Each collective is a
``train/ep_allreduce`` span (``op``, ``bytes``) and goes into the
``train/ep_allreduce_seconds`` histogram.

It also hands every `MoEMlp` its data ranks (`models.moe.DataShards`)
where ``dp`` x ``fsdp`` > 1: the capacity, the positions and the aux
loss count the global batch, as GSPMD runs the JAX layer on it.

The ranks of an ``ep`` group read the same rows (`mesh.data_group`
leaves ``ep`` out), and DDP and FSDP2 run over the data axes with the
rank's expert slices as the whole parameters. The model's ``ep_dims``
(each parameter's dim cut over ep, or None) serve `DataParallel`'s
checkpoint gather and restore (`tensor_parallel.gather_state` and
`shard_optimizer` over the ep group) and adafactor's sums
(`models.adafactor`).

MoE beside ``tp``, ``sp`` or ``pp`` raises NotImplementedError
(ROADMAP.md Queue 1 item 8d), as ``ep`` beside them does
(`mesh.UNPORTED_PAIRS`).
"""

from __future__ import annotations

import logging
from typing import Optional

from torch import nn

from tf_yarn_tpu_torch.models import moe as moe_lib
from tf_yarn_tpu_torch.parallel import collectives
from tf_yarn_tpu_torch.parallel import mesh as mesh_lib
from tf_yarn_tpu_torch.parallel import sharding

_logger = logging.getLogger(__name__)

class ExpertParallel(collectives.AxisGroup):
    """A rank's place in its ep group; ``trace`` names the span (and,
    with ``_seconds``, the histogram) of its collectives."""

    trace = "train/ep_allreduce"


def data_shards(mesh) -> Optional[moe_lib.DataShards]:
    """The data ranks of this rank (`models.moe.DataShards`), or None
    where there is one."""
    index, count = mesh_lib.data_group(mesh)
    if count <= 1:
        return None
    groups = [mesh[axis].get_group()
              for axis in (mesh_lib.AXIS_DP, mesh_lib.AXIS_FSDP)
              if mesh_lib.mesh_axis_size(mesh, axis) > 1]
    return moe_lib.DataShards(groups, index, count)


def parallelize(model: nn.Module, mesh) -> Optional[ExpertParallel]:
    """Give `model`'s MoE layers their data ranks and cut its experts over
    the ep dim of `mesh` (module docstring). Returns the rank's
    `ExpertParallel`, or None — the model left whole — when the mesh has
    no ep dim or the model no MoE layer (it then trains replicated over
    ep, as GSPMD places it). Raises NotImplementedError for MoE beside
    tp, sp or pp, and ValueError when ep does not divide the experts —
    before anything is cut."""
    has_moe = moe_lib.has_moe(model)
    if has_moe:
        beside = [axis for axis in (mesh_lib.AXIS_TP, mesh_lib.AXIS_SP,
                                    mesh_lib.AXIS_PP)
                  if mesh_lib.mesh_axis_size(mesh, axis) > 1]
        if beside:
            raise NotImplementedError(
                f"an MoE decoder beside {', '.join(beside)} is not ported yet "
                "(ROADMAP.md Queue 1 item 8d); it trains over dp, fsdp and "
                "ep")
        collectives.hand_group(model, "data_shards", data_shards(mesh))
    ep = ExpertParallel.of(mesh, mesh_lib.AXIS_EP)
    if ep is None:
        return None
    if not has_moe:
        _logger.info("%s has no MoE layer: it trains replicated over ep=%d",
                     type(model).__name__, ep.size)
        return None
    n_exp = model.config.moe_experts
    if n_exp % ep.size:
        raise ValueError(f"moe_experts={n_exp} does not split over ep="
                         f"{ep.size}")
    dims = sharding.tp_dims(model, mesh_axis=mesh_lib.AXIS_EP)
    for name, param in list(model.named_parameters()):
        dim = dims[name]
        if dim is None:
            continue
        owner = model.get_submodule(name.rpartition(".")[0])
        local = sharding.local_slice(param.detach(), dim, ep.size,
                                     ep.rank).clone()
        setattr(owner, name.rpartition(".")[2], nn.Parameter(
            local, requires_grad=param.requires_grad))
    collectives.hand_group(model, "ep", ep)
    model.ep_dims = dims
    return ep

