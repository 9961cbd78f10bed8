"""Parameter placement: logical axes -> mesh axes — counterpart of
tf_yarn_tpu/parallel/sharding.py.

The JAX models annotate their parameters with *logical* axis names
(flax ``nn.with_partitioning``, e.g. ``("embed", "mlp")``) and
`LOGICAL_RULES` maps those names onto the mesh axes of
`parallel.mesh.MeshSpec`: attention heads, the MLP's hidden width and
the vocabulary over ``tp``, the embedding width over ``fsdp``, ``kv``
(the key and value projections) replicated. A parameter without an
annotation — LoRA factors, biases, norm scales, every leaf of the
unannotated families — is placed by `infer_fsdp_partition`. The rules,
`logical_to_spec`, `_divisible_axis` and `infer_fsdp_partition` are the
same pure logic; a spec is a tuple with one entry per dim: a mesh-axis
name, a tuple of them, or None (``()`` is "replicated", as JAX's
``PartitionSpec()``).

The port's modules carry their annotations as flax's boxes do: a
module's ``logical_axes`` maps each of its parameters (by leaf name) to
the logical axes the JAX model gives the same leaf (`annotate`, called
where the module is built: transformer.py:131, :202-204, :321, :403-405,
:503, :527; bert.py:101-117, :136, :142, :163, :177; vit.py:95, :108;
dlrm.py:78-85). So a subclass keeps them, and the tensor-parallel layers
read their role from the same annotation that places their parameters.
`tree_partition_specs(model, fsdp_size)` gives each parameter its spec
from them, as `tree_partition_specs` of a flax tree does from its boxes.
The decoder's layer stack is a list of blocks here, where the scanned
flax tree stacks each leaf along a leading ``"layers"`` axis: the model
annotates the list itself (`annotate_stack`) and `stack_placement` maps it
through the same rules (``"layers"`` -> ``pp``): `parallel.pipeline.
parallelize` keeps the rank's contiguous stage of a stack placed there.

`shard_like_annotated(model, state, mesh)` is the restore-side twin: a
rank's slices of a one-device state dict. Where a spec names ``tp`` the
rank keeps the contiguous ``1/tp`` of that dim at its ``tp`` index;
``fsdp`` is left to FSDP2, which shards the rank's tensors over its own
group when the train loop wraps the model (`parallel.data_parallel`).
GSPMD pads a dim that ``tp`` does not divide; the port refuses it
(`parallel.tensor_parallel.parallelize` names the dimension).
`reshard_state` (sharding.py:146-187, the elastic-resume primitive) is
`parallel.data_parallel.DataParallel.reshard_state`: a restored
one-device state cut by these rules to what a rank of the attempt's mesh
holds, which is all a re-placement is in the port. Every multi-rank
restore of the train loop goes through it, at the checkpoint's size or
another. `oversized_replicated_leaves` (the placement probe of the
analysis engine, ROADMAP.md Queue 1 item 10) is not ported here.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import torch

from tf_yarn_tpu_torch.parallel.mesh import (
    AXIS_EP,
    AXIS_FSDP,
    AXIS_PP,
    AXIS_SP,
    AXIS_TP,
    BATCH_AXES,
)

# Logical axis names (tf_yarn_tpu/models/transformer.py:27-31).
EMBED = "embed"
HEADS = "heads"
KV = "kv"
MLP = "mlp"
VOCAB = "vocab"
EXPERT = "expert"

# Logical-axis -> mesh-axis rules (first matching entry wins; None =
# replicate): Megatron's placement, sharding.py:41-56.
LOGICAL_RULES: Tuple[Tuple[str, Any], ...] = (
    ("batch", BATCH_AXES),
    ("seq", AXIS_SP),
    (EMBED, AXIS_FSDP),
    (HEADS, AXIS_TP),
    (KV, None),
    (MLP, AXIS_TP),
    (VOCAB, AXIS_TP),
    (EXPERT, AXIS_EP),
    ("conv_out", AXIS_FSDP),
    ("layers", AXIS_PP),
    ("stage", None),
)

# The ranking replica's placement (sharding.py:58-68): the DLRM table's
# ("embed", None) rows over tp, every other rule unchanged
# (`models.rank_engine.RankEngine(mesh=)`).
RANKING_RULES: Tuple[Tuple[str, Any], ...] = (
    (EMBED, AXIS_TP),
) + tuple(rule for rule in LOGICAL_RULES if rule[0] != EMBED)

Spec = Tuple[Any, ...]

def logical_to_spec(logical_axes: Sequence[Optional[str]],
                    rules=LOGICAL_RULES) -> Spec:
    mapping = dict(rules)
    return tuple(mapping.get(name) if name is not None else None
                 for name in logical_axes)


def _divisible_axis(shape: Tuple[int, ...], size: int) -> Optional[int]:
    """Largest axis divisible by `size` (later axes win ties: output
    dims, so a shard does not cross a matmul's reduction dim)."""
    best = None
    best_dim = 0
    for index, dim in enumerate(shape):
        if dim % size == 0 and dim >= best_dim:
            best = index
            best_dim = dim
    return best


def infer_fsdp_partition(shape: Tuple[int, ...], fsdp_size: int) -> Spec:
    """ZeRO-style placement of an unannotated parameter: one axis over
    fsdp if any axis divides, else replicated; scalars and 1-D
    parameters stay replicated."""
    if fsdp_size <= 1 or len(shape) < 2:
        return ()
    axis = _divisible_axis(shape, fsdp_size)
    if axis is None:
        return ()
    spec = [None] * len(shape)
    spec[axis] = AXIS_FSDP
    return tuple(spec)


def annotate(module: torch.nn.Module, **axes: Tuple[Optional[str], ...]
             ) -> None:
    """Give `module`'s own parameters, by leaf name, their logical axes
    (``annotate(dense, kernel=(EMBED, HEADS))``), as flax's
    ``nn.with_partitioning`` boxes a leaf."""
    module.logical_axes = dict(getattr(module, "logical_axes", {}), **axes)


def annotate_stack(module: torch.nn.Module, **stacks: str) -> None:
    """Give `module`'s lists of layers, by attribute name, the logical axis
    of their index (``annotate_stack(model, layers="layers")``), as flax's
    ``nn.scan(metadata_params={nn.PARTITION_NAME: "layers"})`` names the
    stacked axis."""
    module.stack_axes = dict(getattr(module, "stack_axes", {}), **stacks)


def stack_placement(model: torch.nn.Module, rules=LOGICAL_RULES
                    ) -> Dict[str, Any]:
    """``{stack attribute: mesh axis or None}`` of the model's annotated
    lists of layers under `rules`."""
    mapping = dict(rules)
    return {name: mapping.get(axis)
            for name, axis in getattr(model, "stack_axes", {}).items()}


def logical_axes(model: torch.nn.Module) -> Dict[str, Optional[tuple]]:
    """Each parameter's logical axes from its module's annotations (None
    where the JAX model gives the leaf none)."""
    out: Dict[str, Optional[tuple]] = {}
    for prefix, module in model.named_modules():
        table = getattr(module, "logical_axes", {})
        for leaf, _ in module.named_parameters(recurse=False):
            out[f"{prefix}.{leaf}" if prefix else leaf] = table.get(leaf)
    return out


def tree_partition_specs(model: torch.nn.Module, fsdp_size: int,
                         rules=LOGICAL_RULES) -> Dict[str, Spec]:
    """``{parameter name: spec}``: an annotated parameter through
    `rules`, the rest by `infer_fsdp_partition` (sharding.py:114-121) of
    the JAX layout of its shape."""
    axes = logical_axes(model)
    specs = {}
    for name, param in model.named_parameters():
        shape = tuple(param.shape)
        if axes[name] is not None and len(axes[name]) == len(shape):
            specs[name] = logical_to_spec(axes[name], rules)
        elif len(shape) == 4:
            # A conv kernel: torch's [out, in, kh, kw] is placed as JAX
            # places its [kh, kw, in, out].
            spec = infer_fsdp_partition(
                (shape[2], shape[3], shape[1], shape[0]), fsdp_size)
            specs[name] = (spec[3], spec[2], spec[0], spec[1]) if spec else ()
        else:
            specs[name] = infer_fsdp_partition(shape, fsdp_size)
    return specs


def tp_dim(spec: Spec, mesh_axis: str = AXIS_TP) -> Optional[int]:
    """The dim a spec shards over `mesh_axis` (``tp`` by default; None
    when it does not)."""
    for dim, axis in enumerate(spec):
        if axis == mesh_axis or (isinstance(axis, tuple)
                                 and mesh_axis in axis):
            return dim
    return None


def tp_dims(model: torch.nn.Module, rules=LOGICAL_RULES,
            mesh_axis: str = AXIS_TP) -> Dict[str, Optional[int]]:
    """``{parameter name: its tp dim or None}`` under `rules` (with
    `mesh_axis`, its dim over that axis)."""
    return {name: tp_dim(spec, mesh_axis)
            for name, spec in tree_partition_specs(model, 1, rules).items()}


def local_slice(tensor: torch.Tensor, dim: Optional[int], size: int,
                index: int) -> torch.Tensor:
    """Shard `index` of `size` equal shards of `tensor` along `dim` (the
    tensor itself when `dim` is None)."""
    if dim is None or size == 1:
        return tensor
    if tensor.shape[dim] % size:
        raise ValueError(f"dim {dim} of size {tensor.shape[dim]} does not "
                         f"split into {size} shards")
    length = tensor.shape[dim] // size
    return tensor.narrow(dim, index * length, length)


def shard_like_annotated(model: torch.nn.Module,
                         state: Mapping[str, torch.Tensor], mesh,
                         rules=LOGICAL_RULES) -> Dict[str, torch.Tensor]:
    """This rank's slices of a one-device state dict of `model` (whole,
    or already cut to the rank's shards: its annotations place it the
    same): each tensor whose placement under `rules` names ``tp`` or
    ``ep`` cut to the rank's shard along that dim, the others as they
    are. Raises ValueError when the state's names are not the model's."""
    from tf_yarn_tpu_torch.parallel import mesh as mesh_lib

    names = list(model.state_dict())
    if sorted(state) != sorted(names):
        missing = sorted(set(names) - set(state))
        extra = sorted(set(state) - set(names))
        raise ValueError("state does not match the model's parameters "
                         f"(missing {missing}, unexpected {extra})")
    out = dict(state)
    for axis in (AXIS_TP, AXIS_EP):
        dims = tp_dims(model, rules, axis)
        size = mesh_lib.mesh_axis_size(mesh, axis)
        index = mesh_lib.mesh_coordinate(mesh, axis)
        out = {name: local_slice(value, dims.get(name), size, index)
               for name, value in out.items()}
    return {name: value.contiguous() for name, value in out.items()}
