"""A tensor-parallel replica's launch: one leader and N-1 followers over
a tp group of ranks — the port's counterpart of the JAX package's
serving mesh (server.py:434-463, prefill.py:471-491,
decode_engine.py:37-51) and ranking mesh (ranking/server.py:209-225,
rank_engine.py:101-141).

The JAX package serves a tp replica from ONE process over a device mesh,
and GSPMD inserts the collectives. The port runs one process per rank,
so a replica is an SPMD group: rank 0, the leader, runs what a
one-device replica runs (`ServingServer`, `SlotScheduler`, every host
decision) and announces each op of its `DecodeEngine` that touches the
device to the followers, which run it on their heads
(`parallel.tensor_parallel`: the control channel, `Leader`, `follow`).
Blocks that leave the replica are gathered whole, heads in rank order,
onto the leader's host, and blocks that come in are scattered the same
way (`DecodeEngine.extract_blocks`, `inject_blocks`), so the wire stays
the one-device wire.

`start(mesh_spec)` spawns the followers (torch.multiprocessing, spawn
context) and meets them on a local rendezvous as rank 0; each rank
takes its card by `_device.assign_rank_device` (``TPU_YARN_PLATFORM=
cpu``: the CPU and gloo). The group's timeout is `tensor_parallel.
DEFAULT_TIMEOUT_S`, read here. `Replica.load` sends the followers what
to build — a module-level builder, sent by name, and its message: the
config and the checkpoint or a state dict — and every rank builds its
engine with it. `decoder_shard` (the default: a `DecodeEngine`) builds
the model on the ``meta`` device and fills in only its shards from the
memory-mapped state (`inference.shard_restored_params`): no rank holds
the whole decoder on its card. `ranker_shard` (a `RankEngine`) builds
the DLRM whole, draws the seeded init on it when there is no
checkpoint (as a one-device replica draws it), keeps its rows of the
table and reads only those of a checkpoint. A dead follower fails the
leader's next op with `TPGroupError` (LOST_TASK), and `Replica.check`,
which the replica's poll loop calls, raises it too, so `run_serving`
ends with a classified failure instead of a hang. `Replica.close`
collects each rank's report (the engine's `rank_report`: launches or
parameter bytes, peak memory), stops the followers, joins them and ends
the group; `close_all` closes every live replica of the process (the
replica tasks' exit path). A caller that runs its own process group
builds `DecodeEngine(model, mesh=mesh)` or `RankEngine(model,
mesh=mesh)` on every rank and calls `engine.follow()` on the followers.
"""

from __future__ import annotations

import datetime
import logging
import os
import threading
import time
import weakref
from typing import List, Optional

import torch
import torch.distributed as dist

from tf_yarn_tpu_torch import _device
from tf_yarn_tpu_torch.parallel import tensor_parallel as tp_lib
from tf_yarn_tpu_torch.parallel.tensor_parallel import Channel, TPGroupError

_logger = logging.getLogger(__name__)

# How long `Replica.close` waits for a follower to leave before killing
# it, and for a broken NCCL group to shut down.
CLOSE_WAIT_S = 30.0


def _leader_store(size: int, timeout_s: float):
    """The group's rendezvous store, listening before any follower
    starts: a port picked free and bound later could be taken in
    between by any autobound socket of the host."""
    return dist.TCPStore(
        "127.0.0.1", 0, size, True,
        timeout=datetime.timedelta(seconds=timeout_s),
        wait_for_workers=False)


def _init_group(backend: str, store, size: int, rank: int,
                timeout_s: float) -> None:
    dist.init_process_group(
        backend, store=store, world_size=size, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s))


def _state(load: dict):
    """The load message's one-device state dict: its own, or the
    checkpoint's, memory-mapped (None when it names neither)."""
    from tf_yarn_tpu_torch import checkpoint as ckpt_lib

    if load.get("state") is not None or load.get("model_dir") is None:
        return load.get("state")
    return ckpt_lib.restore_checkpoint(
        load["model_dir"], load["step"], map_location="cpu",
        parts=("params",), mmap=True)["params"]


def decoder_shard(load: dict, mesh, device):
    """A rank's `DecodeEngine` from the leader's load message: the
    decoder built on the meta device, cut to the rank's shards, filled
    from the state dict."""
    from tf_yarn_tpu_torch import inference
    from tf_yarn_tpu_torch.models.decode_engine import DecodeEngine
    from tf_yarn_tpu_torch.models.transformer import Transformer

    model = Transformer(load["config"], device="meta")
    model = inference.shard_restored_params(model, _state(load), mesh, device)
    _logger.info("tp rank on %s: %d of %d kv heads", device, model.kv_heads,
                 load["config"].n_kv_heads)
    return DecodeEngine(model, mesh=mesh, **load["engine"])


def ranker_shard(load: dict, mesh, device):
    """A rank's `RankEngine` from the leader's load message: the DLRM
    built whole on `device` (the seeded init drawn on it when the message
    has no state, as `ranking.server.run_ranking` draws it on one
    device), cut to the rank's rows of the table by the engine, then
    filled with the rank's rows of the state dict."""
    import torch

    from tf_yarn_tpu_torch import inference
    from tf_yarn_tpu_torch.models.dlrm import DLRM
    from tf_yarn_tpu_torch.models.rank_engine import RankEngine
    from tf_yarn_tpu_torch.parallel import sharding

    model = DLRM(load["config"], device=device)
    state = _state(load)
    if state is None:
        model.init_weights(torch.Generator(device=device).manual_seed(
            int(load["init_seed"])))
    engine = RankEngine(model, mesh=mesh, **load["engine"])
    if state is not None:
        inference.shard_restored_params(model, state, mesh, device,
                                        sharding.RANKING_RULES)
    _logger.info("tp rank on %s: %d of %d table rows", device,
                 model.embedding.shape[0], load["config"].total_buckets)
    return engine


def _follower_main(rank: int, size: int, port: int, timeout_s: float) -> None:
    """A spawned follower: join the group, take the leader's load
    message, build this rank's engine with its builder and follow until
    ``stop``."""
    logging.basicConfig(
        level=logging.INFO,
        format=f"%(asctime)s %(levelname)s tp rank {rank} %(name)s: "
               "%(message)s")
    from tf_yarn_tpu_torch.parallel import mesh as mesh_lib

    try:
        device, backend = _device.assign_rank_device(rank, size)
        store = dist.TCPStore(
            "127.0.0.1", port, size, False,
            timeout=datetime.timedelta(seconds=timeout_s))
        _init_group(backend, store, size, rank, timeout_s)
        mesh = mesh_lib.build_mesh(mesh_lib.MeshSpec(tp=size), device)
        load, _ = tp_lib.channel_of(mesh, timeout_s).broadcast()
        if not load.get("stop"):
            load["builder"](load, mesh, device).follow()
        dist.destroy_process_group()
    except BaseException:  # noqa: B036 — a follower reports and dies
        _logger.exception("tp follower rank %d failed", rank)
        os._exit(1)
    # Leave without the interpreter's teardown, as the error path does:
    # in it the ended gloo groups' C++ objects abort the process now and
    # then ("terminate called without an active exception", about 1 exit
    # in 20 on a loaded host), though the replica ended cleanly.
    logging.shutdown()
    os._exit(0)


_LIVE: "weakref.WeakSet" = weakref.WeakSet()


class Replica:
    """The leader's handle on a running tp group (`start`)."""

    def __init__(self, mesh, channel: Channel, processes, device):
        self.mesh = mesh
        self.channel = channel
        self.processes = list(processes)
        self.device = device
        self.size = channel.size
        self.engine = None
        self.reports: Optional[List[dict]] = None
        self._closed = False

    def load(self, config, *, builder=decoder_shard,
             model_dir: Optional[str] = None, step: Optional[int] = None,
             state=None, init_seed: Optional[int] = None, **engine_kwargs):
        """Every rank's engine over its shard of the model, built by
        `builder` (a module-level function of the load message, the mesh
        and the device; `decoder_shard` or `ranker_shard`) from
        ckpt-`step` of `model_dir` (verified by the caller), the
        one-device `state` dict, or (the ranker) the seeded init of
        `init_seed`; returns the leader's (`engine_kwargs`: its
        buckets)."""
        load = {"builder": builder, "config": config, "model_dir": model_dir,
                "step": step, "state": state, "init_seed": init_seed,
                "engine": engine_kwargs}
        self.channel.broadcast(load)
        self.engine = builder(load, self.mesh, self.device)
        return self.engine

    def check(self) -> None:
        """Raise `TPGroupError` when a follower has exited or the group
        broke under an op."""
        for process in self.processes:
            if process.exitcode is not None:
                raise TPGroupError(
                    f"tp follower {process.name} exited with code "
                    f"{process.exitcode}")
        leader = getattr(self.engine, "leader", None)
        if leader is not None and leader.error is not None:
            raise TPGroupError(
                f"the tp group is broken: {type(leader.error).__name__}: "
                f"{leader.error}") from leader.error

    def close(self) -> None:
        """Collect the ranks' reports, stop the followers and end the
        group; a follower that does not leave in CLOSE_WAIT_S is
        killed."""
        if self._closed:
            return
        self._closed = True
        broken = False
        try:
            if self.engine is not None:
                leader = self.engine.leader
                if leader.error is None:
                    self.reports = self.engine.rank_report()
                    _logger.info("tp replica ranks: %s", self.reports)
                self.engine.close()
                broken = leader.error is not None
            else:
                self.channel.broadcast({"stop": True})
        except BaseException as exc:  # noqa: B036 — closing regardless
            broken = True
            _logger.warning("tp replica: the followers did not take the "
                            "stop: %s", exc)
        deadline = time.monotonic() + CLOSE_WAIT_S
        for process in self.processes:
            process.join(max(0.0, deadline - time.monotonic()))
            if process.is_alive():
                _logger.warning("tp follower %s did not stop: killing it",
                                process.name)
                process.kill()
                process.join(5.0)
        _end_group(broken)
        _LIVE.discard(self)


def _end_group(broken: bool) -> None:
    """Leave the default process group, so that nothing later in this
    process (a `train_and_evaluate` reads it) finds the replica's. A
    broken NCCL group may block in its shutdown: that one ends on a
    thread given CLOSE_WAIT_S."""
    if not dist.is_initialized():
        return
    if not broken or dist.get_backend() == "gloo":
        dist.destroy_process_group()
        return
    ender = threading.Thread(target=dist.destroy_process_group,
                             name="tp-group-end", daemon=True)
    ender.start()
    ender.join(CLOSE_WAIT_S)
    if ender.is_alive():
        _logger.warning("the broken tp group did not end in %.0f s",
                        CLOSE_WAIT_S)


def start(mesh_spec) -> Replica:
    """Spawn the replica's N-1 followers (N = ``mesh_spec.tp``), join
    them as rank 0 of a new default process group (its timeout
    `tensor_parallel.DEFAULT_TIMEOUT_S`) and build its mesh and control
    channel. Each rank takes its card (`_device.assign_rank_device`). A
    follower that exits before the group forms fails the start."""
    from tf_yarn_tpu_torch.parallel import mesh as mesh_lib

    size = int(mesh_spec.tp)
    if size < 2:
        raise ValueError(f"a tp replica needs tp >= 2, got {size}")
    if dist.is_initialized():
        raise RuntimeError("a tp replica starts its own process group; this "
                           "process is already in one")
    timeout_s = tp_lib.DEFAULT_TIMEOUT_S
    store = _leader_store(size, timeout_s)
    port = store.port
    context = torch.multiprocessing.get_context("spawn")
    processes = []
    try:
        for rank in range(1, size):
            process = context.Process(
                target=_follower_main, args=(rank, size, port, timeout_s),
                name=f"tp-follower-{rank}", daemon=True)
            process.start()
            processes.append(process)
        dev, backend = _device.assign_rank_device(0, size)
        joined: List[BaseException] = []
        done = threading.Event()

        def join() -> None:
            try:
                _init_group(backend, store, size, 0, timeout_s)
            except BaseException as exc:  # noqa: B036 — re-raised below
                joined.append(exc)
            finally:
                done.set()

        threading.Thread(target=join, name="tp-rendezvous", daemon=True).start()
        while not done.wait(0.2):
            for process in processes:
                if process.exitcode is not None:
                    raise TPGroupError(
                        f"tp follower {process.name} exited with code "
                        f"{process.exitcode} before the group formed")
        if joined:
            raise joined[0]
        mesh = mesh_lib.build_mesh(mesh_spec, dev)
        channel = tp_lib.channel_of(mesh, timeout_s)
    except BaseException:
        for process in processes:
            process.kill()
            process.join(5.0)
        _end_group(True)
        raise
    _logger.info("tp replica: %d ranks over %s (the leader on %s)", size,
                 backend, dev)
    replica = Replica(mesh, channel, processes, dev)
    _LIVE.add(replica)
    return replica


def close_all() -> None:
    """Close every live replica this process started."""
    for replica in list(_LIVE):
        replica.close()
