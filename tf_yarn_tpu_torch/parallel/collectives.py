"""Collectives over a mesh dimension — counterpart of
tf_yarn_tpu/parallel/collectives.py.

Each wrapper takes the rank's tensor and an axis — a dim name of a
`DeviceMesh` (the ``mesh`` given, else `mesh.current_mesh()`), a
process group, or None for the default group — and returns a new tensor
with the value that the JAX wrapper of the same name returns inside
``shard_map`` over that axis (collectives.py:40-62): ``all_reduce_mean``
(pmean), ``all_reduce_sum`` (psum), ``reduce_scatter`` (psum_scatter,
tiled), ``all_gather`` (tiled) and ``ring_shift`` (ppermute by
``shift`` hops). The input is left as it was.

`allreduce_bandwidth` (collectives.py:65-124) times all-reduces of one
message a rank over a group. At a world of one rank there is no wire:
the number is an on-chip copy, and ``mode`` says so.

``shard_map`` has no counterpart here: it comes with sequence
parallelism and the pipeline (ROADMAP.md Queue 1 items 7c, 7d), which
need it.
"""

from __future__ import annotations

import time
from typing import Dict

import torch
import torch.distributed as dist


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
    send = x.contiguous()
    out = torch.empty_like(send)
    if shift % n == 0:
        out.copy_(send)
        return out

    def global_rank(r: int) -> int:
        return dist.get_global_rank(group, r) if group is not None else r

    works = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, send, global_rank((me + shift) % n), group=group),
        dist.P2POp(dist.irecv, out, global_rank((me - shift) % n), group=group)])
    for work in works:
        work.wait()
    return out


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
