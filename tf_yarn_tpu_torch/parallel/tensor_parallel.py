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
  under `sharding.RANKING_RULES` the DLRM's stacked ``(embed, None)``
  table is cut and read the same way (`shard(..., rules=)`; the ranking
  replica's placement, JAX rank_engine.py:101-141), every other DLRM
  parameter whole;
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
goes into the ``train/tp_allreduce_seconds`` histogram — on a serving
replica's ranks ``serving/tp_allreduce`` (the group's `TensorParallel.
trace`); under gloo with card tensors the call also waits for the
kernels that produce its input.

Serving (`models.decode_engine`, `serving.tp_replica`) runs the same
layers forward only, and needs both head counts to divide tp: each rank
then holds ``n_kv_heads / tp`` kv heads and its caches hold those. A
serving replica is an SPMD group, and this module holds its control
protocol. Rank 0, the leader (`Leader`), makes every host decision;
before each op that touches the device it broadcasts a header over the
group's control channel (`Channel`, a gloo group in host memory): the
op, its host arguments and the handles of the objects it reads (a slot
grid, a block pool, a prefill's rows), of which every rank holds its
own heads. A header also carries the calls the leader deferred for the
followers' copies and the handles it dropped. The followers (`follow`)
run each op on their heads, make no decision of their own, and return
on a ``stop``. Every rank runs the same ops in the same order, so the
model's collectives meet. Liveness: the group has a finite timeout
(DEFAULT_TIMEOUT_S), and an idle leader sends a ``noop`` header every
quarter of it, so a follower's wait ends within the timeout when its
leader is gone; a dead follower fails the leader's next op (gloo
reports a closed connection at once, a silent peer at the timeout),
and the leader raises `TPGroupError` (LOST_TASK) from then on.

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

import collections
import datetime
import functools
import logging
import pickle
import threading
import time
import weakref
from typing import Any, Dict, List, Mapping, NamedTuple, Optional, Tuple

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
    rank's index in it. ``trace`` names the span (and, with
    ``_seconds``, the histogram) each collective is timed into."""

    trace = "train/tp_allreduce"

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
        tp.trace, start, seconds, op=op,
        bytes=tensor.numel() * tensor.element_size())
    telemetry.get_registry().histogram(f"{tp.trace}_seconds").observe(seconds)
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
                tp: TensorParallel, dtype: torch.dtype,
                what: str = "vocab_size") -> torch.Tensor:
    """Rows of a vocab-parallel table of `vocab` rows (`what` names the
    count in an error) for global `ids` (already made rows by
    `models.transformer.vocab_index`, or the DLRM's per-table fold): a
    rank reads the ids in its rows and zeros elsewhere, and the ranks'
    rows are summed — each id's row comes from exactly one rank, so the
    sum is exact."""
    start, length = tp.span(vocab, what)
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


def shard(model: torch.nn.Module, tp: TensorParallel,
          rules=sharding.LOGICAL_RULES) -> bool:
    """Slice `model`'s parameters to `tp`'s shards by their placements
    under `rules` and give its modules the group (module docstring);
    False, the model untouched, when no placement names tp (ResNet,
    mnist's DenseClassifier, and the DLRM under the training rules: they
    train replicated over tp, as GSPMD places them). Raises ValueError,
    naming the config field (or the parameter), where tp does not divide
    a dim it splits, and NotImplementedError where a tp-sliced
    parameter's module cannot compute on its shard (it has no ``tp``
    attribute) — both before anything is cut."""
    dims = sharding.tp_dims(model, rules)
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
    params = dict(model.named_parameters())
    for name in owners:
        tp.span(params[name].shape[dims[name]], f"{name} dim {dims[name]}")
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


# -- a serving replica's control protocol --------------------------------------

# The tp group's timeout: a collective a silent peer never joins fails
# after it (read when a replica starts, `serving.tp_replica.start`).
DEFAULT_TIMEOUT_S = 120.0

# Errors an op raises on every rank alike, from its arguments, before
# any collective: the group stays in step.
LOCAL_ERRORS = (ValueError, TypeError, LookupError, NotImplementedError)


class TPGroupError(RuntimeError):
    """The tp group lost a rank, or fell out of step: the replica cannot
    serve. Classified LOST_TASK (`resilience.taxonomy`)."""

    tpu_yarn_failure_kind = "LOST_TASK"


class _Handle(NamedTuple):
    id: int


class Channel:
    """The tp group's control wire: a gloo group over the same ranks,
    carrying headers and tensors the leader sends or collects through
    host memory."""

    def __init__(self, tp: TensorParallel, timeout_s: float):
        ranks = [dist.get_global_rank(tp.group, i) for i in range(tp.size)]
        self.axis = TensorParallel(
            dist.new_group(ranks, backend="gloo",
                           timeout=datetime.timedelta(seconds=timeout_s)),
            tp.size, tp.rank, tp.axis)
        self.root = ranks[0]
        self.size, self.rank = tp.size, tp.rank
        self.timeout_s = timeout_s

    def broadcast(self, obj: Any = None) -> Tuple[Any, int]:
        """(the leader's `obj` on every rank, its pickled bytes)."""
        size = torch.zeros(1, dtype=torch.int64)
        if self.rank == 0:
            data = torch.frombuffer(bytearray(pickle.dumps(obj)),
                                    dtype=torch.uint8)
            size[0] = data.numel()
        dist.broadcast(size, src=self.root, group=self.axis.group)
        if self.rank != 0:
            data = torch.empty(int(size[0]), dtype=torch.uint8)
        dist.broadcast(data, src=self.root, group=self.axis.group)
        if self.rank != 0:
            obj = pickle.loads(data.numpy().tobytes())
        return obj, int(size[0])

    def gather_objects(self, obj: Any) -> Optional[List[Any]]:
        """Every rank's `obj`, in rank order, on the leader (None on the
        followers)."""
        out = [None] * self.size if self.rank == 0 else None
        dist.gather_object(obj, out, dst=self.root, group=self.axis.group)
        return out

    def gather(self, tensor: torch.Tensor, dim: int
               ) -> Optional[torch.Tensor]:
        """Every rank's `tensor` joined along `dim` in rank order on the
        leader's host; None on the followers."""
        return _gather(tensor, dim, self.axis)

    def scatter(self, whole: Optional[torch.Tensor], shape: Tuple[int, ...],
                dtype: torch.dtype, dim: int) -> torch.Tensor:
        """This rank's share, a host tensor of `shape` and `dtype`, of the
        leader's `whole` cut along `dim` in rank order (the followers pass
        None)."""
        mine = torch.empty(shape, dtype=dtype)
        parts = None
        if self.rank == 0:
            parts = [part.contiguous() for part in
                     whole.to("cpu", dtype).chunk(self.size, dim)]
        dist.scatter(mine, parts, src=self.root, group=self.axis.group)
        return mine


_CHANNELS: Dict[int, tuple] = {}
_CHANNELS_LOCK = threading.Lock()


def channel_of(mesh, timeout_s: Optional[float] = None) -> Channel:
    """The control channel of `mesh`'s tp group (its timeout `timeout_s`,
    by default DEFAULT_TIMEOUT_S), made on first use — a collective every
    rank of the group calls in the same order."""
    with _CHANNELS_LOCK:
        entry = _CHANNELS.get(id(mesh))
        if entry is None or entry[0] is not mesh:
            entry = _CHANNELS[id(mesh)] = (mesh, Channel(
                TensorParallel.of(mesh, mesh_lib.AXIS_TP),
                DEFAULT_TIMEOUT_S if timeout_s is None else timeout_s))
        return entry[1]


class Leader:
    """Rank 0's end of the protocol: each replicated op's header, the
    handles of the objects the followers hold, the deferred calls, and
    the keepalive. Values of the `unsent` types that are not handles stay
    out of the header: the op moves them itself. Each header's send is a
    `trace` span (``op``, ``bytes``)."""

    def __init__(self, channel: Channel, *, unsent: tuple = (),
                 trace: str = "tp_header"):
        self.channel = channel
        self.unsent = unsent
        self.trace = trace
        self._lock = threading.RLock()
        self._ids: Dict[int, int] = {}
        self._next = 0
        self._pending: "collections.deque" = collections.deque()
        self.error: Optional[BaseException] = None
        self._closed = False
        self._last = time.monotonic()
        self._keepalive_s = channel.timeout_s / 4
        self._stop = threading.Event()
        threading.Thread(target=self._keepalive, name="tp-keepalive",
                         daemon=True).start()

    # -- handles -----------------------------------------------------------

    def _bind(self, obj, hid: int) -> None:
        key = id(obj)
        self._ids[key] = hid
        weakref.finalize(obj, self._forget, key, hid)

    def _forget(self, key: int, hid: int) -> None:
        if self._ids.get(key) == hid:
            del self._ids[key]
        self._pending.append(("free", hid))

    def defer(self, obj, method: str, *args) -> None:
        """Have the followers call `method` of their copy of `obj` with
        `args` before the next op."""
        self._pending.append(("call", self._ids[id(obj)], method, args))

    def _encode(self, value):
        if isinstance(value, torch.Generator):
            return None
        hid = self._ids.get(id(value))
        if hid is not None:
            return _Handle(hid)
        if type(value) in (list, tuple):
            return type(value)(self._encode(v) for v in value)
        if isinstance(value, self.unsent):
            return None
        if isinstance(value, torch.Tensor):
            return value.detach().cpu()
        return value

    def _drain_pending(self) -> list:
        out = []
        while self._pending:
            out.append(self._pending.popleft())
        return out

    # -- ops ---------------------------------------------------------------

    def _check(self) -> None:
        if self.error is not None:
            raise TPGroupError(
                f"the tp group is broken: {type(self.error).__name__}: "
                f"{self.error}") from self.error
        if self._closed:
            raise TPGroupError("the tp replica is stopped")

    def _send(self, header: dict) -> None:
        start = time.perf_counter()
        _, size = self.channel.broadcast(header)
        telemetry.get_tracer().record(
            self.trace, start, time.perf_counter() - start,
            op=header["op"], bytes=size)
        self._last = time.monotonic()

    def run(self, op: str, args, kwargs, call, keep=None):
        """Announce `op` with its arguments, then run it here with
        `call()` while the followers run it on their heads. With `keep`,
        the followers hold ``keep(result)`` under a handle."""
        with self._lock:
            self._check()
            hid = None
            if keep is not None:
                hid, self._next = self._next, self._next + 1
            header = {"op": op, "args": self._encode(list(args)),
                      "kwargs": {k: self._encode(v) for k, v in kwargs.items()},
                      "pending": self._drain_pending(), "result": hid}
            try:
                self._send(header)
                result = call()
            except LOCAL_ERRORS:
                raise
            except BaseException as exc:
                self.error = exc
                raise TPGroupError(
                    f"tp op {op} failed: {type(exc).__name__}: {exc}"
                ) from exc
            if hid is not None:
                self._bind(keep(result), hid)
            return result

    def _keepalive(self) -> None:
        while not self._stop.wait(self._keepalive_s / 2):
            if time.monotonic() - self._last < self._keepalive_s:
                continue
            if not self._lock.acquire(blocking=False):
                continue  # an op is running: that is traffic enough
            try:
                if self._closed or self.error is not None:
                    return
                self._send({"op": "noop", "pending": self._drain_pending()})
            except BaseException as exc:  # noqa: B036 — kept for the poll
                self.error = exc
                return
            finally:
                self._lock.release()

    def stop(self) -> None:
        """Send ``stop``: the followers leave `follow`."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._stop.set()
            if self.error is None:
                try:
                    self._send({"op": "stop", "pending": []})
                except BaseException as exc:  # noqa: B036
                    self.error = exc


def _decode(value, objects: Dict[int, Any]):
    if isinstance(value, _Handle):
        return objects[value.id]
    if type(value) in (list, tuple):
        return type(value)(_decode(v, objects) for v in value)
    return value


def replicated(method=None, *, precheck=None, keep=None):
    """Mark an engine method that runs on every rank of a tp replica: on
    the leader it is announced (`Leader.run`) after `precheck(self,
    *args, **kwargs)` passes, then run; on one device, and on a follower
    (`ReplicaEngine.follow`), it just runs. With `keep`, the followers
    hold ``keep(result)`` for the leader's later ops."""
    if method is None:
        return functools.partial(replicated, precheck=precheck, keep=keep)

    @functools.wraps(method)
    def run(self, *args, **kwargs):
        leader = self.leader
        if leader is None:
            return method(self, *args, **kwargs)
        if precheck is not None:
            precheck(self, *args, **kwargs)
        return leader.run(method.__name__, args, kwargs,
                          lambda: method(self, *args, **kwargs), keep)

    run.keep = keep
    return run


class ReplicaEngine:
    """An engine's part in a tp replica (`models.decode_engine`,
    `models.rank_engine`): the group's control channel and, on rank 0,
    the leader's end of the protocol, through which its `replicated`
    methods are announced. Both stay None on one device."""

    channel: Optional[Channel] = None
    leader: Optional[Leader] = None

    def join_replica(self, mesh, rank: int, trace: str,
                     unsent: tuple = ()) -> None:
        """Join `mesh`'s control channel; rank 0 leads, each header a
        `trace` span."""
        self.channel = channel_of(mesh)
        if rank == 0:
            self.leader = Leader(self.channel, unsent=unsent, trace=trace)

    @property
    def follows(self) -> bool:
        """Whether this engine is a tp follower's: it runs the device part
        of each op and leaves the host part to the leader."""
        return self.channel is not None and self.leader is None

    def follow(self) -> None:
        """On a tp follower: run the leader's ops on this rank's shard
        until the leader's ``stop`` (`follow`)."""
        follow(self, self.channel)

    def close(self) -> None:
        """On a tp leader: stop the followers (`follow` returns). Nothing
        to do on one device."""
        if self.leader is not None:
            self.leader.stop()


def follow(target, channel: Channel) -> None:
    """A follower's loop: run each op the leader announces on `target`
    (this rank's heads), until ``stop``. An op that fails on its
    arguments fails on the leader too, which carries on: so does the
    follower. A method whose result the followers hold names how in its
    ``keep`` attribute."""
    objects: Dict[int, Any] = {}
    while True:
        header, _ = channel.broadcast()
        for entry in header.get("pending", ()):
            if entry[0] == "free":
                objects.pop(entry[1], None)
            else:
                _, hid, method, args = entry
                getattr(objects[hid], method)(*args)
        op = header["op"]
        if op == "stop":
            return
        if op == "noop":
            continue
        method = getattr(target, op)
        args = _decode(header["args"], objects)
        kwargs = {k: _decode(v, objects) for k, v in header["kwargs"].items()}
        try:
            result = method(*args, **kwargs)
        except LOCAL_ERRORS as exc:
            _logger.debug("tp op %s refused its arguments here as on the "
                          "leader: %s", op, exc)
            continue
        if header.get("result") is not None:
            objects[header["result"]] = method.keep(result)
