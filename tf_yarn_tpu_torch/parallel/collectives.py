"""Collectives over a mesh dimension — counterpart of
tf_yarn_tpu/parallel/collectives.py.

Each wrapper takes the rank's tensor and an axis — a dim name of a
`DeviceMesh` (the ``mesh`` given, else `mesh.current_mesh()`), a
process group, or None for the default group — and returns a new tensor
with the value that the JAX wrapper of the same name returns inside
``shard_map`` over that axis (collectives.py:40-62): ``all_reduce_mean``
(pmean), ``all_reduce_sum`` (psum), ``reduce_scatter`` (psum_scatter,
tiled), ``all_gather`` (tiled) and ``ring_shift`` (ppermute by
``shift`` hops), and ``all_to_all`` (``jax.lax.all_to_all(...,
tiled=True)``, which the JAX package calls inline in ulysses.py). The
input is left as it was.

``shard_map`` has no counterpart: the port runs a per-shard body on the
rank's own shard, so sequence parallelism (`parallel.ring_attention`,
`parallel.ulysses`) and the pipeline (`parallel.pipeline`) call the
per-shard functions directly, over an `AxisGroup` (the group of a mesh
dim, its size and the rank's index in it). What ``shard_map`` does at
its edges — slice a replicated input to the rank's block, and gather the
blocks of the output — is `scatter_sequence` and `gather_sequence`.

Autograd forms, for the per-shard bodies that run inside a training
forward: `shift` (a ring shift; its backward is the shift by ``-hops``)
and `exchange` (an all-to-all; its backward is the inverse all-to-all).
Each is timed from its call to its return, as the host sees it, forward
and backward: a span named by the caller (``train/sp_collective`` for
sequence parallelism, ``train/pp_send`` for the pipeline) with ``op``,
``bytes`` and ``direction``, and the histogram ``<span>_seconds``. A
rank must call the backward of every collective its peers call, in the
same order: `tie` gives a tensor that the rank's loss does not reach a
zero gradient, so its collectives still run backward.

The transport follows the backend and the tensor's device, never a
caught error: NCCL, and gloo with host tensors, take the tensors as they
are; gloo takes only all-reduce and broadcast of card tensors, so the
other collectives of a card tensor under gloo go through host memory
(``host``). The first use of each (op, transport) is logged at INFO.

`allreduce_bandwidth` (collectives.py:65-124) times all-reduces of one
message a rank over a group. At a world of one rank there is no wire:
the number is an on-chip copy, and ``mode`` says so.
"""

from __future__ import annotations

import logging
import time
from typing import Dict, Optional

import torch
import torch.distributed as dist

_logger = logging.getLogger(__name__)


def _group(axis, mesh=None):
    """The process group of `axis`: a mesh dim name, a group, or None
    (the default group)."""
    if axis is None or not isinstance(axis, str):
        return axis
    from tf_yarn_tpu_torch.parallel import mesh as mesh_lib

    mesh = mesh if mesh is not None else mesh_lib.current_mesh()
    if mesh is None:
        raise ValueError(f"axis {axis!r} names a mesh dim, and there is no "
                         "mesh (pass mesh= or set_current_mesh)")
    return mesh[axis].get_group()


class AxisGroup:
    """A rank's place on one mesh dim: the process group, its size and
    the rank's index in it."""

    def __init__(self, group, size: int, rank: int, axis: str = "") -> None:
        self.group = group
        self.size = size
        self.rank = rank
        self.axis = axis

    @classmethod
    def of(cls, mesh, axis: str) -> Optional["AxisGroup"]:
        """The group of `mesh`'s dim `axis` (None when it has size 1 or
        there is no mesh)."""
        from tf_yarn_tpu_torch.parallel import mesh as mesh_lib

        size = mesh_lib.mesh_axis_size(mesh, axis)
        if size <= 1:
            return None
        return cls(mesh[axis].get_group(), size,
                   mesh_lib.mesh_coordinate(mesh, axis), axis)


def hand_group(model: torch.nn.Module, attr: str, group) -> bool:
    """Set `attr` to `group` on every module of `model` that has the
    attribute (the modules that compute on their shard); whether any
    had it."""
    found = False
    for module in model.modules():
        if hasattr(module, attr):
            setattr(module, attr, group)
            found = True
    return found


_TRANSPORTS_LOGGED = set()


def transport(x: torch.Tensor, group, op: str) -> str:
    """``"host"`` when `op` on `x` over `group` must go through host
    memory (a card tensor under gloo), else ``"direct"``; logged at INFO
    the first time each (op, transport) runs in the process."""
    host = x.is_cuda and dist.get_backend(group) == "gloo"
    way = "host" if host else "direct"
    if (op, way) not in _TRANSPORTS_LOGGED:
        _TRANSPORTS_LOGGED.add((op, way))
        _logger.info("%s over %s: %s", op, dist.get_backend(group),
                     "through host memory" if host else "tensors as they are")
    return way


def all_reduce_sum(x: torch.Tensor, axis=None, mesh=None) -> torch.Tensor:
    out = x.clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=_group(axis, mesh))
    return out


def all_reduce_mean(x: torch.Tensor, axis=None, mesh=None) -> torch.Tensor:
    group = _group(axis, mesh)
    out = all_reduce_sum(x, group)
    return out / dist.get_world_size(group)


def reduce_scatter(x: torch.Tensor, axis=None, scatter_axis: int = 0,
                   mesh=None) -> torch.Tensor:
    """The sum over the axis, of which this rank keeps its contiguous
    1/n along `scatter_axis`."""
    group = _group(axis, mesh)
    n = dist.get_world_size(group)
    if x.shape[scatter_axis] % n:
        raise ValueError(f"dim {scatter_axis} of size "
                         f"{x.shape[scatter_axis]} does not split over {n}")
    moved = x.movedim(scatter_axis, 0).contiguous()
    out = moved.new_empty((moved.shape[0] // n, *moved.shape[1:]))
    dist.reduce_scatter_tensor(out, moved, group=group)
    return out.movedim(0, scatter_axis)


def all_gather(x: torch.Tensor, axis=None, gather_axis: int = 0,
               mesh=None) -> torch.Tensor:
    """Every rank's tensor, concatenated in rank order along
    `gather_axis`."""
    group = _group(axis, mesh)
    n = dist.get_world_size(group)
    moved = x.movedim(gather_axis, 0).contiguous()
    out = moved.new_empty((moved.shape[0] * n, *moved.shape[1:]))
    dist.all_gather_into_tensor(out, moved, group=group)
    return out.movedim(0, gather_axis)


def ring_shift(x: torch.Tensor, axis=None, shift: int = 1,
               mesh=None) -> torch.Tensor:
    """Rank i's tensor moves to rank (i + shift) mod n of the axis; this
    rank returns what rank (i - shift) mod n held."""
    group = _group(axis, mesh)
    n = dist.get_world_size(group)
    me = dist.get_rank(group)
    if shift % n == 0:
        return x.clone(memory_format=torch.contiguous_format)
    host = transport(x, group, "ring_shift") == "host"
    send = (x.cpu() if host else x).contiguous()
    out = torch.empty_like(send)

    def global_rank(r: int) -> int:
        return dist.get_global_rank(group, r) if group is not None else r

    works = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, send, global_rank((me + shift) % n), group=group),
        dist.P2POp(dist.irecv, out, global_rank((me - shift) % n), group=group)])
    for work in works:
        work.wait()
    return out.to(x.device) if host else out


def all_to_all(x: torch.Tensor, axis=None, split_axis: int = 0,
               concat_axis: int = 0, mesh=None) -> torch.Tensor:
    """``jax.lax.all_to_all(x, axis, split_axis, concat_axis,
    tiled=True)``: dim `split_axis` cut into n equal blocks, block j sent
    to rank j of the axis, and the blocks this rank receives concatenated
    along `concat_axis` in rank order."""
    group = _group(axis, mesh)
    n = dist.get_world_size(group)
    if x.shape[split_axis] % n:
        raise ValueError(f"dim {split_axis} of size {x.shape[split_axis]} "
                         f"does not split over {n}")
    host = transport(x, group, "all_to_all") == "host"
    blocks = x.movedim(split_axis, 0)
    blocks = blocks.reshape(n, blocks.shape[0] // n, *blocks.shape[1:])
    send = (blocks.cpu() if host else blocks).contiguous()
    out = torch.empty_like(send)
    dist.all_to_all_single(out, send, group=group)
    if host:
        out = out.to(x.device)
    return torch.cat([block.movedim(0, split_axis) for block in out.unbind(0)],
                     dim=concat_axis)


def _record(span: Optional[str], op: str, x: torch.Tensor, start: float,
            direction: str) -> None:
    if span is None:
        return
    seconds = time.perf_counter() - start
    from tf_yarn_tpu_torch import telemetry

    telemetry.get_tracer().record(span, start, seconds, op=op,
                                  bytes=x.numel() * x.element_size(),
                                  direction=direction)
    telemetry.get_registry().histogram(f"{span}_seconds").observe(seconds)


class _Shift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, anchor, group, hops, span):
        ctx.group, ctx.hops, ctx.span = group, hops, span
        start = time.perf_counter()
        out = ring_shift(x, group, hops)
        _record(span, "ring_shift", x, start, "forward")
        return out

    @staticmethod
    def backward(ctx, grad):
        start = time.perf_counter()
        out = ring_shift(grad, ctx.group, -ctx.hops)
        _record(ctx.span, "ring_shift", grad, start, "backward")
        return out, None, None, None, None


class _Exchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_axis, concat_axis, span):
        ctx.args = group, split_axis, concat_axis, span
        start = time.perf_counter()
        out = all_to_all(x, group, split_axis, concat_axis)
        _record(span, "all_to_all", x, start, "forward")
        return out

    @staticmethod
    def backward(ctx, grad):
        group, split_axis, concat_axis, span = ctx.args
        start = time.perf_counter()
        out = all_to_all(grad, group, concat_axis, split_axis)
        _record(span, "all_to_all", grad, start, "backward")
        return out, None, None, None, None


def shift(x: torch.Tensor, group, hops: int = 1,
          span: Optional[str] = None,
          anchor: Optional[torch.Tensor] = None) -> torch.Tensor:
    """`ring_shift` under autograd: the gradient goes back by ``-hops``.
    `anchor`, a tensor that requires grad, makes the result require grad
    even where `x` does not (a pipeline bubble sends zeros), so every
    rank runs the backward of every shift."""
    if anchor is None:
        anchor = x.new_zeros(())
    return _Shift.apply(x, anchor, group, hops, span)


def exchange(x: torch.Tensor, group, split_axis: int, concat_axis: int,
             span: Optional[str] = None) -> torch.Tensor:
    """`all_to_all` under autograd: the gradient takes the inverse
    all-to-all (`concat_axis` split, `split_axis` concatenated)."""
    return _Exchange.apply(x, group, split_axis, concat_axis, span)


class _Tie(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, *unused):
        ctx.unused = [(t.shape, t.dtype, t.device) for t in unused]
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return (grad, *(torch.zeros(shape, dtype=dtype, device=device)
                        for shape, dtype, device in ctx.unused))


def tie(x: torch.Tensor, *unused: torch.Tensor) -> torch.Tensor:
    """`x`, with each of `unused` given a zero gradient when `x` gets one:
    the collectives that made them then run backward on this rank too."""
    return _Tie.apply(x, *unused) if unused else x


def block(x: torch.Tensor, group, dim: int = 1) -> torch.Tensor:
    """The rank's contiguous block of `x` along `dim` (a view; autograd's
    own narrow, whose gradient is zero outside the block)."""
    size, rank = dist.get_world_size(group), dist.get_rank(group)
    if x.shape[dim] % size:
        raise ValueError(f"dim {dim} of size {x.shape[dim]} does not split "
                         f"over {size} ranks")
    length = x.shape[dim] // size
    return x.narrow(dim, rank * length, length)


def _gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The ranks' blocks concatenated along `dim` (an all-gather, through
    host memory for a card tensor under gloo)."""
    host = transport(x, group, "all_gather") == "host"
    out = all_gather(x.cpu() if host else x, group, dim)
    return out.to(x.device) if host else out


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return block(x, group, dim).contiguous()

    @staticmethod
    def backward(ctx, grad):
        return _gather(grad.contiguous(), ctx.group, ctx.dim), None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _gather(x.contiguous(), group, dim)

    @staticmethod
    def backward(ctx, grad):
        return block(grad, ctx.group, ctx.dim).contiguous(), None, None


class _ReduceValue(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def reduce_value(x: torch.Tensor, group) -> torch.Tensor:
    """`x` summed over `group` forward; backward, the gradient passed to
    the rank's own `x` (each rank's share of a sum whose parameter
    gradients the caller sums)."""
    return _ReduceValue.apply(x, group)


class _GatherPartial(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _gather(x.contiguous(), group, dim)

    @staticmethod
    def backward(ctx, grad):
        total = grad.contiguous().clone()
        dist.all_reduce(total, group=ctx.group)
        return block(total, ctx.group, ctx.dim).contiguous(), None, None


def gather_partial(x: torch.Tensor, group, dim: int = 1) -> torch.Tensor:
    """The ranks' blocks concatenated along `dim`, where each rank goes on
    to use the whole for its own part of the result (not a replicated
    computation): backward, the ranks' gradients of the whole summed,
    and the rank's block of the sum."""
    return _GatherPartial.apply(x, group, dim)


def scatter_sequence(x: torch.Tensor, group, dim: int = 1) -> torch.Tensor:
    """The rank's contiguous block of a tensor replicated over `group`
    (``shard_map``'s input edge); backward, the blocks' gradients gathered
    whole on every rank, as every rank's replicated computation has the
    same gradient outside."""
    return _Scatter.apply(x, group, dim)


def gather_sequence(x: torch.Tensor, group, dim: int = 1) -> torch.Tensor:
    """The ranks' blocks concatenated along `dim` on every rank
    (``shard_map``'s output edge); backward, the rank's block of the
    (replicated) gradient."""
    return _Gather.apply(x, group, dim)


def allreduce_bandwidth(size_mb: float = 64.0, iters: int = 10, group=None,
                        device=None) -> Dict[str, float]:
    """All-reduce algorithmic bandwidth over `group` (the default one):
    each rank contributes one `size_mb` message, and ``gbps`` is
    2(n-1)/n · bytes over the mean seconds of `iters` all-reduces after a
    warm one, the device synchronised around them. Without a process
    group, or in a group of one, the timed op is the mean's on-chip copy
    (``mode`` ``single_chip_hbm_copy``), not an interconnect."""
    device = torch.device(device) if device is not None else torch.device(
        "cuda" if torch.cuda.is_available() else "cpu")
    grouped = dist.is_available() and dist.is_initialized()
    n = dist.get_world_size(group) if grouped else 1
    msg_elems = int(size_mb * 1e6 / 4)
    x = torch.ones(msg_elems, dtype=torch.float32, device=device)

    def sync() -> None:
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def one(s: torch.Tensor) -> torch.Tensor:
        if n > 1:
            dist.all_reduce(s, group=group)
        return s.mul_(1.0 / n) if n > 1 else s * 1.0

    x = one(x)  # warm
    sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        x = one(x)
    sync()
    elapsed = (time.perf_counter() - t0) / iters
    msg_bytes = msg_elems * 4
    algo_factor = 2 * (n - 1) / n if n > 1 else 1.0
    backend = dist.get_backend(group) if grouped else None
    return {
        "gbps": algo_factor * msg_bytes / elapsed / 1e9,
        "elapsed_s": elapsed,
        "size_mb": msg_bytes / 1e6,
        "n_devices": float(n),
        "mode": f"{backend}_allreduce" if n > 1 else "single_chip_hbm_copy",
    }
