"""The device mesh of a run — counterpart of tf_yarn_tpu/parallel/mesh.py.

`MeshSpec` is the JAX package's layout (mesh.py:50-91): the axes ``pp,
dp, fsdp, sp, tp, ep`` in that order, each of size 1 when off, carried
from the driver to the tasks as JSON. ``auto(n)`` puts every device on
``fsdp``, as in JAX. `resize_mesh_spec` and `order_devices_for_slices`
are the same pure logic; in the port the groups that
`order_devices_for_slices` keeps together are hosts, in the place of
TPU slices.

The port is eager PyTorch with one process per rank and one device per
process, so a mesh is a mesh of ranks: `build_mesh` returns a torch
`DeviceMesh` with the dims ``("pp", "dp", "fsdp", "sp", "tp", "ep")`` —
JAX's axis order (mesh.py:63), so ``ep`` is innermost and an ep group is
adjacent ranks — over the default process group's ranks, and its size
must be the world size. The train loop (`training.train_and_evaluate`)
cuts the decoder's layer stack into ``pp`` stages
(`parallel.pipeline`), slices the model over ``tp``
(`parallel.tensor_parallel`, placements from `parallel.sharding`), hands
the decoder its ``sp`` group (each rank computes its contiguous share of
the sequence; `parallel.ring_attention`, `parallel.ulysses`), cuts an MoE
decoder's experts over ``ep`` (`parallel.expert_parallel`), replicates
it over ``dp`` (`DistributedDataParallel`) and shards it over ``fsdp``
(FSDP2 ``fully_shard``; both at once is FSDP2's hybrid form). The ranks
of one ``dp`` x ``fsdp`` coordinate form a data group (`data_group`):
they read the same share of the global batch, as JAX shards the batch
over ``dp`` and ``fsdp`` only (mesh.py:262-268), so the ranks of one
``tp`` or ``ep`` group read the same rows. That wrap and the DeviceMesh
play the role of the JAX package's `batch_sharding` and
`replicated_sharding`, which have no eager counterpart. The pairs of
axes the port does not combine yet are refused with the ROADMAP.md
Queue 1 items that port them (`UNPORTED_PAIRS`).
"""

from __future__ import annotations

import dataclasses
import json
import math
from typing import Dict, List, Optional, Sequence, Tuple

AXIS_PP = "pp"
AXIS_DP = "dp"
AXIS_FSDP = "fsdp"
AXIS_SP = "sp"
AXIS_TP = "tp"
AXIS_EP = "ep"

# The batch dimension shards over every data-like axis.
BATCH_AXES = (AXIS_DP, AXIS_FSDP)

# The dims of a built mesh, outermost first.
MESH_DIMS = (AXIS_PP, AXIS_DP, AXIS_FSDP, AXIS_SP, AXIS_TP, AXIS_EP)

# The model axes the port does not build yet, each with its ROADMAP.md
# Queue 1 item (none: every axis of a MeshSpec is built).
UNPORTED_AXES: Dict[str, str] = {}

# The pairs of axes the port does not combine yet, each with its
# ROADMAP.md Queue 1 item: the pipeline beside FSDP2, a sequence or a
# tensor group (7d); the experts beside a tensor, sequence or pipeline
# group (8d).
UNPORTED_PAIRS = ((AXIS_FSDP, AXIS_PP, "7d"), (AXIS_SP, AXIS_PP, "7d"),
                  (AXIS_TP, AXIS_PP, "7d"), (AXIS_EP, AXIS_TP, "8d"),
                  (AXIS_EP, AXIS_SP, "8d"), (AXIS_EP, AXIS_PP, "8d"))


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Parallelism layout for a run."""

    dp: int = 1
    fsdp: int = 1
    tp: int = 1
    sp: int = 1
    ep: int = 1
    pp: int = 1

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return (AXIS_PP, AXIS_DP, AXIS_FSDP, AXIS_SP, AXIS_TP, AXIS_EP)

    @property
    def axis_sizes(self) -> Tuple[int, ...]:
        return (self.pp, self.dp, self.fsdp, self.sp, self.tp, self.ep)

    @property
    def total_devices(self) -> int:
        return math.prod(self.axis_sizes)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))

    @classmethod
    def from_json(cls, raw: str) -> "MeshSpec":
        return cls(**json.loads(raw))

    @classmethod
    def auto(cls, n_devices: int) -> "MeshSpec":
        """Every device on the fsdp axis (mesh.py:86-91)."""
        return cls(fsdp=n_devices)


def resize_mesh_spec(spec: MeshSpec, n_devices: int) -> MeshSpec:
    """Refit `spec` onto `n_devices` (mesh.py:94-118): the model axes
    (tp, sp, ep, pp) stay; fsdp keeps as much of its size as still
    divides, and dp takes the rest. Raises ValueError when `n_devices`
    cannot hold the model axes."""
    model = spec.tp * spec.sp * spec.ep * spec.pp
    if n_devices < 1:
        raise ValueError(f"cannot build a mesh over {n_devices} devices")
    if n_devices % model:
        raise ValueError(
            f"elastic resize to {n_devices} devices cannot preserve the "
            f"model axes (tp={spec.tp} sp={spec.sp} ep={spec.ep} "
            f"pp={spec.pp} need multiples of {model}); this capacity loss "
            "is not absorbable by shrinking data parallelism"
        )
    data = n_devices // model
    fsdp = math.gcd(spec.fsdp, data)
    return dataclasses.replace(spec, dp=data // fsdp, fsdp=fsdp)


def order_devices_for_slices(
    spec: MeshSpec, devices: Sequence, slice_ids: Sequence[int]
) -> list:
    """Reorder `devices` (ranks, in the port) so that the boundaries
    between groups — hosts here, TPU slices in the JAX package — fall on
    the outer axes pp and dp (mesh.py:182-211). Pure logic; needs pp*dp
    divisible by the number of groups."""
    if len(slice_ids) != len(devices):
        raise ValueError(
            f"slice_ids ({len(slice_ids)}) must match devices ({len(devices)})"
        )
    n_slices = len(set(slice_ids))
    if n_slices <= 1:
        return list(devices)
    outer = spec.pp * spec.dp
    if outer % n_slices:
        raise ValueError(
            f"multi-slice mesh needs pp*dp ({spec.pp}*{spec.dp}) "
            f"divisible by the slice count {n_slices} so cross-DCN "
            "traffic stays on the outer axes"
        )
    per_slice = len(devices) // n_slices
    grouped: Dict[int, list] = {}
    for device, sid in zip(devices, slice_ids):
        grouped.setdefault(sid, []).append(device)
    if any(len(group) != per_slice for group in grouped.values()):
        raise ValueError("slices contribute unequal device counts")
    return [d for sid in sorted(grouped) for d in grouped[sid]]


def check_mesh_spec(spec, world_size: int) -> None:
    """Refuse an axis the port does not build, or a pair of axes it does
    not combine (NotImplementedError naming the item), then a spec whose
    size is not the world's (the JAX package's ValueError,
    mesh.py:241-245)."""
    for axis, item in UNPORTED_AXES.items():
        if getattr(spec, axis, 1) > 1:
            raise NotImplementedError(
                f"MeshSpec {axis}={getattr(spec, axis)}: the {axis} axis is "
                f"not ported yet (ROADMAP.md Queue 1 item {item}); the port "
                "builds pp, dp, fsdp, sp, tp and ep meshes")
    for first, second, item in UNPORTED_PAIRS:
        if getattr(spec, first, 1) > 1 and getattr(spec, second, 1) > 1:
            raise NotImplementedError(
                f"MeshSpec {first}={getattr(spec, first)} with "
                f"{second}={getattr(spec, second)}: the port does not combine "
                f"{first} and {second} yet (ROADMAP.md Queue 1 item {item})")
    total = getattr(spec, "total_devices", 1)
    if total != world_size:
        sizes = dict(zip(getattr(spec, "axis_names", ()),
                         getattr(spec, "axis_sizes", ())))
        raise ValueError(f"MeshSpec wants {total} devices ({sizes}), got "
                         f"{world_size}")


def build_mesh(spec: MeshSpec, device=None,
               host_ids: Optional[Sequence[int]] = None):
    """The torch `DeviceMesh` of `spec`: dims `MESH_DIMS` over the
    default process group's ranks, row-major (or grouped by `host_ids`,
    one per rank, through `order_devices_for_slices`), on
    `device`'s type (the card's unless `device` is the CPU). None at a
    world of one rank with no process group: the run has one device and
    no collective."""
    import torch
    import torch.distributed as dist

    world = (dist.get_world_size()
             if dist.is_available() and dist.is_initialized() else 1)
    check_mesh_spec(spec, world)
    if world == 1 and not (dist.is_available() and dist.is_initialized()):
        return None
    from torch.distributed.device_mesh import DeviceMesh

    ranks: List[int] = list(range(world))
    if host_ids is not None:
        ranks = order_devices_for_slices(spec, ranks, host_ids)
    device_type = torch.device(device).type if device is not None else "cuda"
    return DeviceMesh(device_type,
                      torch.tensor(ranks).reshape(
                          spec.pp, spec.dp, spec.fsdp, spec.sp, spec.tp,
                          spec.ep),
                      mesh_dim_names=MESH_DIMS)


def mesh_axis_size(mesh, axis: str) -> int:
    """Size of one named axis of a built mesh (1 when the axis is absent
    or there is no mesh)."""
    if mesh is None:
        return 1
    return dict(zip(mesh.mesh_dim_names, mesh.shape)).get(axis, 1)


def mesh_coordinate(mesh, axis: str) -> int:
    """This rank's index along one named axis of a built mesh (0 when
    the axis is absent or there is no mesh)."""
    if mesh is None or axis not in mesh.mesh_dim_names:
        return 0
    return mesh.get_coordinate()[mesh.mesh_dim_names.index(axis)]


def data_group(mesh) -> Tuple[int, int]:
    """(index, count) of this rank's data group: the ``dp`` x ``fsdp``
    coordinate, row-major, which the ranks that differ only in ``pp``,
    ``sp``, ``tp`` and ``ep`` share. They read the same rows of the global batch
    and draw from the same dropout seeds. (0, 1) without a mesh."""
    fsdp = mesh_axis_size(mesh, AXIS_FSDP)
    index = (mesh_coordinate(mesh, AXIS_DP) * fsdp
             + mesh_coordinate(mesh, AXIS_FSDP))
    return index, mesh_axis_size(mesh, AXIS_DP) * fsdp


def local_device_count() -> int:
    """Cards this process sees (1 on a host without one: the CPU)."""
    import torch

    return torch.cuda.device_count() if torch.cuda.is_available() else 1


# The run's mesh, registered by the train loop so code inside the model
# can find it without threading it through every signature.
_CURRENT_MESH = None


def set_current_mesh(mesh) -> None:
    global _CURRENT_MESH
    _CURRENT_MESH = mesh


def current_mesh():
    return _CURRENT_MESH
