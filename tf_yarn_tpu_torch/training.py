"""The train-and-evaluate loop, on one device or data-parallel over the
ranks of a process group — counterpart of tf_yarn_tpu/training.py.

`build_train_step` (training.py:126-187) runs the loss forward, the
backward (through `torch.utils.checkpoint` where the model recomputes
its blocks) and the optimizer update, with ``grad_accum_steps``
microbatches summed and averaged before the one update and perplexity
re-derived as ``exp(loss)``. The dropout generators — a
``generator`` attribute of the model where it has one, and the global
generator of the model's device, which ``nn.Dropout`` draws from — are
reseeded from ``(seed, step)`` before each step (and ``(seed, step,
microbatch)`` under accumulation), as the JAX step folds the step into
its key: a resumed or drained-and-relaunched run draws the same masks as
an uninterrupted one.

`train_and_evaluate` (training.py:574-1115) drives it: input resume
from the newest verified checkpoint, input prefetch on a background
thread, ``steps_per_loop`` chunks of steps with no host read between
them (a chunk never crosses a log, checkpoint, eval or profile boundary
or the run's end), log, eval and checkpoint cadences through the async
`checkpoint.CheckpointWriter` with ``keep_last_n`` retention, the
preemption drain (a set `preemption.requested()` flag saves the step,
waits for the write and raises `preemption.Preempted`), the
``TPU_YARN_PROFILE`` window over ``torch.profiler``, TensorBoard scalars
under ``<model_dir>/tb``, the steps/sec hook with samples/s, tokens/s
and MFU weighted by the batches really run, and the ``train/*`` spans
and gauges of the port's telemetry. In a launched task (``runtime``
given) the hook broadcasts the rates and ``{task}/last_training_step``
through the run's KV store and flushes the registry to
``{task}/metrics`` (training.py:335-351); ``TPU_YARN_TRACE`` writes the
spans on exit.

PyTorch runs eagerly: a step's kernels are queued on the card as the
host runs, and the host waits only where it reads a value (the log
cadence, ``train/device_wait``), so metrics stay tensors until then. A
chunk of ``steps_per_loop`` steps is that many step calls; CUDA graphs
for it are host work after the port's benchmark (ROADMAP.md Queue 1
item 9a).

In a process group of more than one rank (one process and one device
each; `tasks.worker` makes the group for a launched ``allreduce_topology``)
the loop trains over a `parallel.mesh.MeshSpec` of ``pp``, ``dp``,
``fsdp``, ``sp``, ``tp`` and ``ep`` (``MeshSpec.auto(world)`` when the
experiment gives none, as in JAX). The model is built whole on every
rank, then cut to the rank's pipeline stage by
`parallel.pipeline.parallelize` (the decoder's layers; the one-device
optimizer's numbering kept for the checkpoints), to its ``ep`` experts by
`parallel.expert_parallel.parallelize` (an MoE decoder; its layers also
get their data ranks, so the capacity and the aux loss count the global
batch), to its ``tp`` shards by
`parallel.tensor_parallel.parallelize` (placements from
`parallel.sharding`; a family with no tp placement stays replicated),
given its ``sp`` group (`parallel.data_parallel.sequence_parallelize`:
the decoder then computes the rank's block of the sequence; the encoders
stay replicated and cut only their attention), and wrapped by
`parallel.data_parallel.DataParallel` (DDP over ``dp``, FSDP2 over
``fsdp``, its hybrid form over both, each over the ranks of one ``tp``
and ``ep`` index; after the backward the gradients
that are a rank's share summed over ``sp`` and ``pp``). The ranks of one
``dp`` x
``fsdp`` coordinate form a data group (`mesh.data_group`): an input_fn
that declares ``host_index`` and ``num_hosts`` gets the data group's
index and count and yields its contiguous share of the global batch
(training.py:391-424), so a tp or ep group reads the same rows; microbatches
before a step's last skip the gradient sync; a step's dropout seed folds
in the data group's index, so the data groups draw independent masks and
the ranks of a tp group the same ones; the logged metrics are the ranks'
mean and the eval metrics the global batches' (weighted by rows), equal
on every rank (a tp group's ranks hold equal values, so that is the mean
over data groups); samples, tokens and FLOPs count the global batch once
(× the data groups) and MFU is over world × the card's peak; rank 0
alone writes checkpoints (the one-device format, the tp shards and ep
experts gathered whole, so any mesh resumes any other) and TensorBoard
and broadcasts the
step and rates, and the ranks wait for its manifest before going on;
every rank restores the step rank 0 verified and takes its shards; and
the preemption flag is agreed at the ``drain_poll_every_steps`` cadence
by an all-reduce (MAX), so one rank's flag drains every rank at the same
step (`_preempt_agreed`, training.py:354-388).

An elastic relaunch (training.py:598-616) keeps the experiment's one
declared mesh: when the driver's ``TPU_YARN_ELASTIC_WORKERS`` is set and
the declared `MeshSpec` wants another number of ranks than the group
has, the loop refits it (`parallel.mesh.resize_mesh_spec`: the model
axes kept, the data axes rescaled) and logs "elastic: declared mesh ...
refit onto N ranks -> ..."; without it the mismatch raises. Each data
group then reads its share of the same global batch, and every
multi-rank restore takes its rank's part of the checkpoint through
`parallel.data_parallel.DataParallel.reshard_state`. After each step
(each chunk of ``steps_per_loop``) the loop calls
`resilience.chaos.on_train_step`, the host boundary of the
``TPU_YARN_FAULT`` injections.

Not ported here, each raising or named in ROADMAP.md: the pairs of axes
`parallel.mesh` does not combine (the pipeline beside fsdp, sp or tp,
Queue 1 item 7d; ep, or an MoE decoder, beside tp, sp or pp, item 8d).

The model_dir may be any `fs` URI. A remote one checkpoints staged
(`checkpoint`: every rank holds a writer, which agrees with the others
before rank 0 writes, so a failed upload raises on every rank at the
next save or at the end) and writes TensorBoard events through
`_UploadingTbWriter`: spooled locally, uploaded to ``<model_dir>/tb`` at
each checkpoint and on close. A task launched by a remote backend
refuses a host-local model_dir (`fs.check_model_dir_placement`).
"""

from __future__ import annotations

import contextlib
import hashlib
import inspect
import logging
import os
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from tf_yarn_tpu_torch import checkpoint as ckpt_lib
from tf_yarn_tpu_torch import fs as fs_lib
from tf_yarn_tpu_torch import event, preemption, telemetry
from tf_yarn_tpu_torch._device import resolve_device
from tf_yarn_tpu_torch.data.prefetch import prefetch
from tf_yarn_tpu_torch.experiment import CoreExperiment
from tf_yarn_tpu_torch.parallel import data_parallel, expert_parallel
from tf_yarn_tpu_torch.parallel import mesh as mesh_lib
from tf_yarn_tpu_torch.parallel import pipeline, tensor_parallel
from tf_yarn_tpu_torch.resilience import chaos
from tf_yarn_tpu_torch.utils import flops as flops_lib
from tf_yarn_tpu_torch.utils import mlflow

_logger = logging.getLogger(__name__)

# The elastic launcher's worker counts (tf_yarn_tpu/constants.py:46-47):
# this attempt's and the full reservation's.
ENV_ELASTIC_WORKERS = "TPU_YARN_ELASTIC_WORKERS"
ENV_ELASTIC_MAX_WORKERS = "TPU_YARN_ELASTIC_MAX_WORKERS"


class TrainState:
    """The step, the model (its parameters) and the optimizer (its
    state), mutated in place by the train step. With a `parallel` wrap
    the state dict is its one-device format (a collective under FSDP2:
    every rank calls it), and `load_state_dict` takes the rank's part of
    one (`DataParallel.reshard_state`)."""

    def __init__(self, step: int, model: torch.nn.Module,
                 optimizer: torch.optim.Optimizer,
                 parallel: Optional[data_parallel.DataParallel] = None
                 ) -> None:
        self.step = step
        self.model = model
        self.optimizer = optimizer
        self.parallel = parallel

    def state_dict(self) -> Dict[str, Any]:
        if self.parallel is not None:
            return {"step": self.step, **self.parallel.full_state()}
        return {"step": self.step, "params": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict()}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        if self.parallel is not None:
            self.parallel.load_rank_state(state)
        else:
            self.model.load_state_dict(state["params"])
            self.optimizer.load_state_dict(state["optimizer"])
        self.step = int(state["step"])


def _split(batch: Dict[str, torch.Tensor], parts: int):
    size = next(iter(batch.values())).shape[0]
    if size % parts:
        raise ValueError(f"batch of {size} does not split into "
                         f"grad_accum_steps={parts} microbatches")
    chunks = {key: value.chunk(parts) for key, value in batch.items()}
    return [{key: chunks[key][i] for key in batch} for i in range(parts)]


def step_seed(seed: int, step: int, *micro: int) -> int:
    """The dropout seed of one step (and microbatch, and data group): a
    hash of ``(seed, step[, micro[, group]])`` — the JAX step's
    ``fold_in(base_rng, step)`` (training.py:135-159). The masks are the
    port's own bits."""
    key = ":".join(str(int(value)) for value in (seed, step, *micro))
    return int.from_bytes(
        hashlib.blake2b(key.encode(), digest_size=8).digest(), "little")


def _device_generator(model) -> torch.Generator:
    """The default generator of the device the model's parameters are on."""
    param = next(model.parameters(), None)
    device = param.device if param is not None else torch.device("cpu")
    if device.type == "cuda":
        index = (device.index if device.index is not None
                 else torch.cuda.current_device())
        return torch.cuda.default_generators[index]
    return torch.default_generator


def build_train_step(model, loss_fn, optimizer, grad_accum_steps: int = 1,
                     seed: int = 0,
                     parallel: Optional[data_parallel.DataParallel] = None):
    """``train_step(state, batch) -> (state, metrics)``: metrics are
    detached 0-d tensors on the model's device ("loss" and the loss's
    aux). The model's dropout ``generator``, where it has one, and the
    global generator of the model's device (what ``nn.Dropout`` draws
    from) are reseeded from ``(seed, state.step)`` before the step's
    forward (from ``(seed, state.step, i)`` before microbatch i's); the
    global one is restored after the step, so code outside it sees its
    own stream. With a `parallel` wrap the loss calls its ``module``
    (`model` is the inner one), microbatches before the last skip the
    gradient sync, the gradients that are a rank's share are summed over
    ``sp`` and ``pp`` after the last (`DataParallel.reduce_partial_grads`),
    and the data group's index is folded into every seed
    as ``(seed, step, i, group)``, so the data groups draw independent
    masks and the ranks of a tp group, whose activations are replicated,
    the same ones."""
    generators = [_device_generator(model)]
    if isinstance(getattr(model, "generator", None), torch.Generator):
        generators.append(model.generator)
    call = parallel.module if parallel is not None else model
    timer = parallel.timer if parallel is not None else None
    group = parallel.data_index if parallel is not None else None

    def reseed(step: int, *micro: int) -> None:
        key = (step, *(micro or (0,)), group) if group is not None else (
            step, *micro)
        for generator in generators:
            generator.manual_seed(step_seed(seed, *key))

    def sync(i: int):
        return (parallel.gradient_sync(i == grad_accum_steps - 1)
                if parallel is not None else contextlib.nullcontext())

    def train_step(state: TrainState, batch):
        saved = generators[0].get_state()
        try:
            return _step(state, batch)
        finally:
            generators[0].set_state(saved)

    def _step(state: TrainState, batch):
        optimizer.zero_grad(set_to_none=True)
        if timer is not None:
            timer.step = state.step
        if grad_accum_steps == 1:
            reseed(state.step)
            loss, aux = loss_fn(call, batch, train=True)
            loss.backward()
            loss = loss.detach()
        else:
            loss_sum, aux_sum = 0.0, {}
            for i, micro in enumerate(_split(batch, grad_accum_steps)):
                reseed(state.step, i)
                with sync(i):
                    micro_loss, micro_aux = loss_fn(call, micro, train=True)
                    micro_loss.backward()  # grads sum over the microbatches
                loss_sum = loss_sum + micro_loss.detach()
                for key, value in micro_aux.items():
                    aux_sum[key] = aux_sum.get(key, 0.0) + value.detach()
            scale = 1.0 / grad_accum_steps
            for param in model.parameters():
                if param.grad is not None:
                    param.grad.mul_(scale)
            loss = loss_sum * scale
            aux = {key: value * scale for key, value in aux_sum.items()}
            if "perplexity" in aux:
                # exp(mean), not mean(exp): the accum=1 path's definition.
                aux["perplexity"] = torch.exp(loss)
        if parallel is not None:
            parallel.reduce_partial_grads(state.step)
        for group in optimizer.param_groups:
            for param in group["params"]:
                if param.grad is None:
                    # optax updates every leaf; torch's optimizers skip a
                    # parameter without a grad (BERT's segment_embedding
                    # when no segments are passed), so give it zeros: its
                    # weight decay and momentum still apply.
                    param.grad = torch.zeros_like(param)
        optimizer.step()
        state.step += 1
        return state, {"loss": loss, **{k: v.detach() for k, v in aux.items()}}

    return train_step


def build_eval_step(model, loss_fn):
    def eval_step(state: TrainState, batch):
        with torch.no_grad():
            loss, aux = loss_fn(model, batch, train=False)
        return {"loss": loss, **aux}

    return eval_step


def evaluate(eval_step, state, eval_input_fn, place, max_steps: int,
             hosts: tuple = (0, 1), world: int = 1) -> Dict[str, float]:
    """The mean of the eval batches' metrics. In a world of more than one
    rank each rank evaluates its data group's share (an eval_input_fn
    declaring ``host_index``/``num_hosts`` gets `hosts`, the data group's
    index and count) and the result is the global batches', equal on
    every rank (`data_parallel.weighted_eval_means`)."""
    batches, rows = [], []
    device = None
    for batch in _call_input_fn(eval_input_fn, None, *hosts):
        placed = place(batch)
        batches.append({k: float(v)
                        for k, v in eval_step(state, placed).items()})
        rows.append(flops_lib.batch_counts(placed)[0] or 1)
        device = next(iter(placed.values())).device
        if len(batches) >= max_steps:
            break
    if world > 1:
        return data_parallel.weighted_eval_means(batches, rows, device)
    return {k: sum(b[k] for b in batches) / len(batches)
            for k in (batches[0] if batches else {})}


class _IntervalBreakdown:
    """Host-side step-time attribution over one report interval
    (training.py:200-228): named components plus ``host_other``, summing
    to ``interval_wall``."""

    def __init__(self) -> None:
        self._acc: Dict[str, float] = {}
        self._t_start = time.perf_counter()

    def add(self, component: str, seconds: float) -> None:
        self._acc[component] = self._acc.get(component, 0.0) + seconds

    def report(self) -> Dict[str, float]:
        now = time.perf_counter()
        wall = max(now - self._t_start, 1e-9)
        parts = dict(self._acc)
        parts["host_other"] = max(0.0, wall - sum(parts.values()))
        parts["interval_wall"] = wall
        self._acc = {}
        self._t_start = now
        return parts


class _StepsPerSecondHook:
    """Throughput reporting (training.py:231-351) into the registry's
    ``train/*`` gauges and the log: steps/s, samples/s, tokens/s and MFU
    against the card's peak, weighted by the batches the interval really
    ran (`record_batch`), so a ragged epoch tail is not counted as full
    batches. Each report also goes to MLflow (when active) and, in a
    launched task, to the KV store: ``{task}/<rate>``,
    ``{task}/last_training_step`` and the registry's ``{task}/metrics``."""

    def __init__(self, every: int, resume_step: int = 0,
                 flops_per_step: Optional[float] = None,
                 samples_per_step: Optional[int] = None,
                 tokens_per_step: Optional[int] = None,
                 peak_flops: Optional[float] = None,
                 runtime=None, broadcast: bool = True) -> None:
        self._runtime = runtime
        # Rates and the step go to the KV store from rank 0 only; every
        # rank flushes its registry under its own task.
        self._broadcast = broadcast
        self._n_try = runtime.n_try if runtime is not None else 0
        self._every = max(1, every)
        self._t0 = time.perf_counter()
        self._step0 = resume_step
        self._flops_per_step = flops_per_step
        self._samples_per_step = samples_per_step
        self._tokens_per_step = tokens_per_step
        self._peak_flops = peak_flops
        self._interval_samples = 0

    def record_batch(self, n_samples: Optional[int]) -> None:
        """Count the batch size a step actually ran (training.py:267)."""
        self._interval_samples += (
            n_samples if n_samples is not None else (self._samples_per_step or 0))

    def after_step(self, step: int, metrics: Dict[str, float],
                   force: bool = False,
                   breakdown: Optional[Dict[str, float]] = None) -> None:
        if step % self._every != 0 and not force:
            return
        now = time.perf_counter()
        elapsed = max(now - self._t0, 1e-9)
        n_steps = step - self._step0
        interval_samples = self._interval_samples
        self._t0, self._step0 = now, step
        self._interval_samples = 0
        report: Dict[str, float] = {}
        if n_steps > 0:
            steps_per_sec = n_steps / elapsed
            # The share of full-batch work the interval did: samples,
            # tokens and the batch dimension's FLOPs all scale with it.
            full = (self._samples_per_step or 0) * n_steps
            work_frac = interval_samples / full if full and interval_samples else 1.0
            report["steps_per_sec"] = steps_per_sec
            if self._samples_per_step:
                report["samples_per_sec"] = (
                    steps_per_sec * self._samples_per_step * work_frac)
            if self._tokens_per_step:
                report["tokens_per_sec"] = (
                    steps_per_sec * self._tokens_per_step * work_frac)
            value = flops_lib.mfu(self._flops_per_step,
                                  steps_per_sec * work_frac, self._peak_flops)
            if value is not None:
                report["mfu"] = value
        registry = telemetry.get_registry()
        registry.counter("train/steps_total").inc(n_steps)
        if interval_samples:
            registry.counter("train/samples_total").inc(interval_samples)
        for key, value in report.items():
            registry.gauge(f"train/{key}").set(value)
        for component, seconds in (breakdown or {}).items():
            registry.gauge("train/interval_seconds",
                           component=component).set(seconds)
        _logger.info("step %d: loss=%s %s", step, metrics.get("loss"),
                     " ".join(f"{k}={v:.3f}" for k, v in report.items()))
        for key, value in report.items():
            mlflow.log_metric(f"{key}_{self._n_try}", value, step=step)
        runtime = self._runtime
        if runtime is not None and self._broadcast:
            for key, value in report.items():
                event.broadcast(runtime.kv, f"{runtime.task}/{key}",
                                f"{value:.6g}")
            event.broadcast(runtime.kv, f"{runtime.task}/last_training_step",
                            str(step))
        # Registry snapshot -> log (debug), MLflow and one {task}/metrics
        # KV payload.
        telemetry.flush_metrics(
            registry, step=step,
            kv=runtime.kv if runtime is not None else None,
            task=runtime.task if runtime is not None else None)


def _call_input_fn(input_fn, start_step: Optional[int] = None,
                   host_index: int = 0, num_hosts: int = 1):
    """``input_fn(...)`` with the keywords it declares (training.py:391-424):
    ``start_step`` (the resume step), and ``host_index`` and ``num_hosts``
    (the rank's data group, `parallel.mesh.data_group`, and the count of
    them), for an input_fn that yields its contiguous share of a fixed
    global batch."""
    try:
        params = inspect.signature(input_fn).parameters
    except (TypeError, ValueError):
        params = {}
    kwargs = {}
    if start_step is not None and "start_step" in params:
        kwargs["start_step"] = start_step
    elif start_step:
        _logger.info("input_fn takes no start_step: input restarts from the "
                     "beginning at resume step %d", start_step)
    if "host_index" in params:
        kwargs["host_index"] = host_index
    if "num_hosts" in params:
        kwargs["num_hosts"] = num_hosts
    return input_fn(**kwargs)


def _batch_placer(device: torch.device):
    """numpy (or torch) batch -> dict of tensors on `device`; integer
    arrays become int64 (token ids index the embedding). Each placement
    is a ``train/globalize`` span observed into the
    ``train/globalize_seconds`` histogram, as the reference's
    `make_batch_globalizer` (training.py:85-103); on the prefetch thread
    it overlaps the step, so it is not in the interval breakdown."""

    def place(batch):
        with telemetry.span("train/globalize") as sp:
            out = to_device(batch, device)
        telemetry.get_registry().histogram(
            "train/globalize_seconds").observe(sp.duration)
        return out

    return place


def to_device(batch, device: torch.device) -> Dict[str, torch.Tensor]:
    """numpy (or torch) batch -> dict of tensors on `device`; integer
    arrays become int64."""
    out = {}
    for key, value in batch.items():
        tensor = torch.as_tensor(np.asarray(value))
        if not tensor.is_floating_point():
            tensor = tensor.long()
        out[key] = tensor.to(device, non_blocking=True)
    return out


def _host_metrics(metrics: Dict[str, torch.Tensor], world: int
                  ) -> Dict[str, float]:
    """The step's metrics as floats (a read that waits for the device):
    this rank's, or the ranks' mean in a world of more than one."""
    if world > 1:
        return data_parallel.mean_metrics(metrics)
    return {k: float(v) for k, v in metrics.items()}


def _degraded() -> float:
    """1.0 when an elastic attempt runs below the full worker count
    (training.py:622-633); 0.0 outside an elastic run or on a count
    that does not parse."""
    if not os.environ.get(ENV_ELASTIC_WORKERS):
        return 0.0
    try:
        return float(int(os.environ[ENV_ELASTIC_WORKERS])
                     < int(os.environ.get(ENV_ELASTIC_MAX_WORKERS, 0)))
    except ValueError:
        return 0.0


def _count_train_flops(model, loss_fn, batch, grad_accum_steps: int) -> float:
    """One train step's FLOPs for models without an analytic count: a
    forward and backward of the loss on one microbatch under
    FlopCounterMode, times the microbatches, with no update and the grads
    cleared after (the JAX package reads XLA's cost analysis of the
    compiled step instead). ``train=False`` draws no dropout mask, so the
    training run's random stream is left as it was."""
    micro = (_split(batch, grad_accum_steps)[0] if grad_accum_steps > 1
             else batch)

    def forward_backward():
        loss, _ = loss_fn(model, micro, train=False)
        loss.backward()

    _, flops = flops_lib.count_flops(forward_backward)
    model.zero_grad(set_to_none=True)
    return grad_accum_steps * flops


def _peak_flops(device: torch.device) -> Optional[float]:
    """The card's peak dense bf16 FLOP/s; None off CUDA or for a card
    `flops_lib` does not know."""
    if device.type != "cuda":
        return None
    return flops_lib.peak_flops_per_device(torch.cuda.get_device_name(device))


def _world_size() -> int:
    """Ranks of the default torch process group (1 without one)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def _rank() -> int:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def _preempt_agreed(device: torch.device, world: int) -> bool:
    """Whether every rank drains now (training.py:354-388): one rank's
    preemption flag is every rank's decision, so no rank is left waiting
    in a collective its peers never join. Every rank calls this on the
    same step cadence. The device is synchronised first, so the flag's
    all-reduce (MAX) follows the step's own collectives on every rank. At
    one rank, the local flag."""
    import torch.distributed as dist

    if world == 1:
        return preemption.requested()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    flag = torch.tensor([int(preemption.requested())],
                        device=data_parallel.wire_device(device))
    dist.all_reduce(flag, op=dist.ReduceOp.MAX)
    return bool(flag.item())


def _agreed_verified_step(model_dir: str, rank: int, world: int
                          ) -> Optional[int]:
    """The newest verified checkpoint step, found (and a corrupt newest
    tree quarantined) by rank 0 alone and broadcast to every rank."""
    import torch.distributed as dist

    if world == 1:
        return ckpt_lib.latest_verified_step(model_dir)
    found = [ckpt_lib.latest_verified_step(model_dir) if rank == 0 else None]
    dist.broadcast_object_list(found, src=0)
    return found[0]


ENV_PROFILE = "TPU_YARN_PROFILE"
ENV_PROFILE_STEPS = "TPU_YARN_PROFILE_STEPS"


class _ProfileWindow:
    """``torch.profiler`` capture controlled by env, as the JAX loop's
    jax.profiler window (training.py:427-512):

    * ``TPU_YARN_PROFILE=<dir>`` — capture the whole run into one Chrome
      trace in <dir>;
    * ``TPU_YARN_PROFILE_STEPS="A:B"`` — capture only steps [A, B);
      either bound may be empty ("100:" = from 100 to the end). The
      loop treats the window's edges as host boundaries, so
      steps_per_loop chunks never step over them.

    CPU activity always, CUDA activity on the card. ``on_step(next_step)``
    is called before the loop and after every step advance; start and
    stop happen there and in the loop's cleanup, where `stop`
    synchronizes the card and writes
    ``<dir>/torch_profile_<start>-<stop>_<pid>.json``."""

    def __init__(self, device: torch.device):
        self.device = device
        self.dir = os.environ.get(ENV_PROFILE)
        self.start_step = 0
        self.stop_step = None
        self.active = False
        self._profiler = None
        self._started_at = 0
        window = os.environ.get(ENV_PROFILE_STEPS, "")
        if window:
            start, _, stop = window.partition(":")
            try:
                # Both bounds parse before either is set: a typo in one
                # must not leave a half-applied window.
                parsed_start = int(start) if start else 0
                parsed_stop = int(stop) if stop else None
            except ValueError:
                _logger.warning(
                    "ignoring malformed TPU_YARN_PROFILE_STEPS=%r "
                    "(want 'A:B', e.g. '100:110')", window)
            else:
                if parsed_stop is not None and parsed_stop <= parsed_start:
                    _logger.warning(
                        "ignoring TPU_YARN_PROFILE_STEPS=%r: stop_step "
                        "(%d) <= start_step (%d) selects no steps; "
                        "capturing the whole run instead",
                        window, parsed_stop, parsed_start)
                else:
                    self.start_step = parsed_start
                    self.stop_step = parsed_stop

    def boundaries(self):
        """Absolute steps where capture toggles."""
        if not self.dir:
            return ()
        return tuple(b for b in (self.start_step, self.stop_step)
                     if b is not None and b > 0)

    def on_step(self, next_step: int) -> None:
        if not self.dir:
            return
        in_window = next_step >= self.start_step and (
            self.stop_step is None or next_step < self.stop_step)
        if in_window and not self.active:
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                activities.append(ProfilerActivity.CUDA)
            self._profiler = profile(activities=activities)
            self._profiler.start()
            self.active = True
            self._started_at = next_step
            _logger.info("profiler capture started (step %d) -> %s",
                         next_step, self.dir)
        elif self.active and not in_window:
            self.stop(next_step)

    def stop(self, at_step: Optional[int] = None) -> None:
        if not self.active:
            return
        if self.device.type == "cuda":
            # The queued kernels must land in the trace.
            torch.cuda.synchronize(self.device)
        self._profiler.stop()
        self.active = False
        os.makedirs(self.dir, exist_ok=True)
        path = os.path.join(
            self.dir, f"torch_profile_{self._started_at}-"
            f"{'end' if at_step is None else at_step}_{os.getpid()}.json")
        self._profiler.export_chrome_trace(path)
        self._profiler = None
        _logger.info("profiler trace written to %s", path)


class _UploadingTbWriter:
    """SummaryWriter against a remote model_dir (JAX training.py:515):
    event files go to a local spool, uploaded to the remote dir at
    checkpoint boundaries and finally on close. Everything else
    delegates to the wrapped writer, so user hooks holding the writer
    call add_histogram/add_text/... unchanged."""

    def __init__(self, writer, spool_dir: str, target_uri: str):
        self._writer = writer
        self._spool_dir = spool_dir
        self._target_uri = target_uri
        self._closed = False

    def __getattr__(self, name):
        # Only reached when normal lookup fails: every SummaryWriter
        # method not wrapped here (add_scalar, add_histogram, flush, ...).
        return getattr(self._writer, name)

    def upload(self) -> None:
        """Push the spool to the remote dir now, so a SIGKILL costs at
        most one checkpoint interval of events. Event files only grow, so
        copying the tree again is idempotent."""
        self._writer.flush()
        try:
            fs_lib.upload_dir(self._spool_dir, self._target_uri)
        except Exception:
            _logger.exception("TB log upload to %s failed", self._target_uri)

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._writer.close()
        try:
            fs_lib.upload_dir(self._spool_dir, self._target_uri)
        except Exception:
            _logger.exception("TB log upload to %s failed", self._target_uri)


def _make_tb_writer(model_dir: Optional[str]):
    """A ``SummaryWriter`` at ``<model_dir>/tb`` (training.py:556-571) —
    for a remote model_dir an `_UploadingTbWriter` over a local spool —
    or None without a model_dir or where tensorboard does not import."""
    if not model_dir:
        return None
    try:
        from torch.utils.tensorboard import SummaryWriter

        if fs_lib.is_local(model_dir):
            return SummaryWriter(
                log_dir=os.path.join(fs_lib.local_path(model_dir), "tb"))
        import tempfile

        spool = tempfile.mkdtemp(prefix="tpu-yarn-tb-")
        return _UploadingTbWriter(SummaryWriter(log_dir=spool), spool,
                                  fs_lib.join(model_dir, "tb"))
    except Exception:  # tensorboard is optional, as in the JAX package
        return None


def train_and_evaluate(core: CoreExperiment, device=None,
                       runtime=None) -> Dict[str, float]:
    """Run the train/eval/checkpoint loop on one device (CUDA unless
    ``device="cpu"``), or data-parallel in a process group of more than
    one rank over ``core.mesh_spec`` (``MeshSpec.auto(world)`` when None);
    returns the final metrics. `runtime` is a launched task's
    (`tasks._bootstrap.TaskRuntime`): the loop then reports into the
    run's KV store."""
    world, rank = _world_size(), _rank()
    mesh_spec = core.mesh_spec
    resized_from = None
    if mesh_spec is None and world > 1:
        mesh_spec = mesh_lib.MeshSpec.auto(world)
    elif (mesh_spec is not None and os.environ.get(ENV_ELASTIC_WORKERS)
          and mesh_spec.total_devices != world):
        # An elastic relaunch on resized capacity: the experiment keeps
        # declaring one logical mesh, refit onto the ranks this attempt
        # has. Without the driver's elastic env the mismatch still fails
        # below: a silently smaller mesh would hide a broken reservation.
        resized_from = mesh_spec
        mesh_spec = mesh_lib.resize_mesh_spec(mesh_spec, world)
        _logger.warning("elastic: declared mesh %s refit onto %d ranks -> %s",
                        resized_from, world, mesh_spec)
    if mesh_spec is not None:
        mesh_lib.check_mesh_spec(mesh_spec, world)
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    telemetry_task = (runtime.task if runtime is not None
                      else "train" if rank == 0 else f"train-{rank}")
    telemetry.enable_env_jsonl(telemetry_task)
    try:
        return _train_and_evaluate(core, device, runtime, mesh_spec, world,
                                   rank, resized_from)
    finally:
        telemetry.export_trace(telemetry_task)


def _train_and_evaluate(core: CoreExperiment, device: torch.device,
                        runtime, mesh_spec, world: int, rank: int,
                        resized_from=None) -> Dict[str, float]:
    params_cfg = core.train_params
    place = _batch_placer(device)
    mesh = None
    if world > 1:
        mesh = mesh_lib.build_mesh(mesh_spec, device)
        _logger.info("mesh %s over %d ranks (%s)",
                     dict(zip(mesh.mesh_dim_names, mesh.shape)), world,
                     torch.distributed.get_backend())
    mesh_lib.set_current_mesh(mesh)
    # The data group's share of each global batch (a tp group's ranks
    # read the same rows).
    hosts = mesh_lib.data_group(mesh)
    # Capacity gauges (training.py:622-636): the devices the step
    # computes on (the refit mesh's, on an elastic relaunch), and whether
    # an elastic attempt runs short of workers.
    registry = telemetry.get_registry()
    registry.gauge("train/mesh_devices").set(float(world))
    registry.gauge("train/degraded").set(_degraded())

    input_resume_step = 0
    if core.model_dir:
        fs_lib.check_model_dir_placement(core.model_dir)
        # Quarantines a corrupt newest checkpoint before the input
        # iterator is built, so input and state resume at one step.
        input_resume_step = _agreed_verified_step(core.model_dir, rank,
                                                  world) or 0
    train_iter = iter(_call_input_fn(core.train_input_fn, input_resume_step,
                                     *hosts))
    with telemetry.span("train/first_batch"):
        batch = place(next(train_iter))
    with telemetry.span("train/init"):
        model = (core.init_fn(device, params_cfg.seed) if core.init_fn
                 else core.model.to(device))
        model.train()
    # Counted on the rank's own batch and whole model, before any slice
    # or wrap: no collective runs inside the count.
    samples, tokens = flops_lib.batch_counts(batch)
    flops_per_step = flops_lib.model_train_flops(model, batch)
    if flops_per_step is None and input_resume_step < params_cfg.train_steps:
        with telemetry.span("train/count_flops"):
            flops_per_step = _count_train_flops(
                model, core.loss_fn, batch, params_cfg.grad_accum_steps)
    parallel = None
    if world > 1:
        with telemetry.span("train/parallel_wrap"):
            staged = mesh_lib.mesh_axis_size(mesh, mesh_lib.AXIS_PP) > 1
            layout = (data_parallel.optimizer_layout(model, core.optimizer)
                      if staged else None)
            ep = expert_parallel.parallelize(model, mesh)
            stage = pipeline.parallelize(model, mesh)
            tp = tensor_parallel.parallelize(model, mesh)
            sp = data_parallel.sequence_parallelize(model, mesh)
            parallel = data_parallel.DataParallel(
                model, mesh, device, core.optimizer, tp=tp, sp=sp, pp=stage,
                layout=layout if stage is not None else None, ep=ep)
        state = TrainState(0, model, parallel.optimizer, parallel)
    else:
        state = TrainState(0, model, core.optimizer(model))

    with contextlib.ExitStack() as cleanup:
        resume_step = 0
        ckpt_writer = None
        if core.model_dir:
            with telemetry.span("train/restore_latest"):
                if world == 1:
                    restored, step = ckpt_lib.restore_latest(
                        core.model_dir, map_location=device)
                elif input_resume_step:
                    # Every rank loads the step rank 0 verified; tp and
                    # FSDP2 keep their shards of the whole state.
                    step = input_resume_step
                    restored = ckpt_lib.restore_checkpoint(
                        core.model_dir, step, map_location=(
                            device if parallel.kind == "ddp"
                            and parallel.tp is None and parallel.pp is None
                            and parallel.ep is None else "cpu"))
                else:
                    restored, step = None, None
            if restored is not None:
                if parallel is not None:
                    # Every multi-rank restore, from a checkpoint of this
                    # size or another: the rank's part of the state.
                    restored = parallel.reshard_state(
                        restored, old_spec=resized_from)
                state.load_state_dict(restored)
                resume_step = step
                _logger.info("resumed from checkpoint step %d", resume_step)
            del restored
            # save() returns once the state is in host memory; the write
            # overlaps the next steps. Rank 0 alone writes; for a staged
            # (remote) model_dir every rank holds a writer, which agrees
            # with the others at each save and wait.
            agree = world > 1 and ckpt_lib.is_staged(core.model_dir)
            if rank == 0 or agree:
                ckpt_writer = ckpt_lib.CheckpointWriter(
                    params_cfg.keep_last_n, rank=rank,
                    world=world if agree else 1,
                    device=data_parallel.wire_device(device) if agree
                    else None)
                cleanup.callback(ckpt_writer.close)
        train_step = build_train_step(
            model, core.loss_fn, state.optimizer, params_cfg.grad_accum_steps,
            seed=params_cfg.seed, parallel=parallel)
        eval_step = build_eval_step(model, core.loss_fn)

        # Cadences that surface to the host this run (training.py:748-796).
        # One process polls the preemption flag every step (a local read);
        # ranks agree on it every drain_poll_every steps, the knob or the
        # smallest host cadence, which then bounds the chunks too.
        steps_per_loop = max(1, params_cfg.steps_per_loop)
        host_cadences = [c for c in (
            params_cfg.log_every_steps,
            params_cfg.checkpoint_every_steps if core.model_dir else None,
            params_cfg.eval_every_steps if core.eval_input_fn else None) if c]
        drain_poll_every = (params_cfg.drain_poll_every_steps
                            if params_cfg.drain_poll_every_steps is not None
                            else min(host_cadences, default=1))
        if world > 1:
            if drain_poll_every >= params_cfg.train_steps:
                _logger.warning(
                    "drain_poll_every_steps=%d >= train_steps=%d: preemption "
                    "is never polled mid-run; a SIGTERM will only be honored "
                    "by the grace-window SIGKILL",
                    drain_poll_every, params_cfg.train_steps)
            host_cadences.append(drain_poll_every)
        if steps_per_loop > 1:
            # Chunks never cross host boundaries nor the run's end, so a
            # longer chunk would never run.
            cap = min(host_cadences
                      + [max(1, params_cfg.train_steps - resume_step)])
            if steps_per_loop > cap:
                _logger.warning(
                    "steps_per_loop=%d exceeds the smallest host cadence / "
                    "remaining steps (%d); clamping", steps_per_loop, cap)
                steps_per_loop = cap

        # The global batch's counts (each data group's share once); MFU
        # over world x the card's peak.
        peak = _peak_flops(device)
        groups = hosts[1]
        hook = _StepsPerSecondHook(
            params_cfg.log_every_steps, resume_step,
            flops_per_step * groups if flops_per_step else flops_per_step,
            samples * groups if samples else samples,
            tokens * groups if tokens else tokens,
            peak * world if peak else peak, runtime=runtime,
            broadcast=rank == 0)
        tb_writer = _make_tb_writer(core.model_dir) if rank == 0 else None
        if tb_writer is not None:
            cleanup.callback(tb_writer.close)
        breakdown = _IntervalBreakdown()
        metrics_host: Dict[str, float] = {}
        # Steps already handed to the writer: the final save and a drain skip
        # a step the cadence saved.
        last_saved_step = resume_step if resume_step else None
        step = resume_step
        input_exhausted = False
        profile = _ProfileWindow(device)
        profile.on_step(resume_step)

        def write(at: int) -> None:
            """Hand step `at` to rank 0's writer (the state dict is a
            collective under FSDP2, so every rank makes it)."""
            nonlocal last_saved_step
            snapshot = state.state_dict()
            if ckpt_writer is not None:
                ckpt_writer.save(core.model_dir, at, snapshot)
            last_saved_step = at

        def landed() -> None:
            """Rank 0's writes have landed, and every rank knows it."""
            if ckpt_writer is not None:
                ckpt_writer.wait()
            if world > 1:
                torch.distributed.barrier()

        def save(at: int, **args) -> None:
            with telemetry.span("train/checkpoint_save", step=at,
                                **args) as sp:
                write(at)
            breakdown.add("checkpoint_save", sp.duration)

        def pull_batch():
            """next(batch_iter) timed as input wait; StopIteration
            propagates."""
            with telemetry.span("train/input_wait") as sp:
                pulled = next(batch_iter)
            breakdown.add("input_wait", sp.duration)
            return pulled

        def run_steps(batches):
            """The batches' steps back to back, no host read between them:
            one ``train/step_dispatch`` span (``steps=N`` for a chunk)."""
            nonlocal state
            for b in batches:
                hook.record_batch((flops_lib.batch_counts(b)[0] or 0) * groups)
            args = {"steps": len(batches)} if len(batches) > 1 else {}
            with telemetry.span("train/step_dispatch", **args) as sp:
                for b in batches:
                    state, out = train_step(state, b)
            breakdown.add("step_dispatch", sp.duration)
            return out

        def next_host_boundary(at: int) -> int:
            """First step > `at` where the loop must surface to the host."""
            boundary = params_cfg.train_steps
            for every in host_cadences:
                boundary = min(boundary, (at // every + 1) * every)
            for absolute in profile.boundaries():
                if absolute > at:
                    boundary = min(boundary, absolute)
            return boundary

        # Batches after the first are read and placed on a background thread
        # (training.py:874), `depth` steps ahead of the loop.
        batch_iter = prefetch(train_iter, place_fn=place, depth=2,
                              name="train")
        try:
            while step < params_cfg.train_steps:
                if (steps_per_loop > 1
                        and next_host_boundary(step) - step >= steps_per_loop):
                    chunk = [batch]
                    while len(chunk) < steps_per_loop:
                        try:
                            chunk.append(pull_batch())
                        except StopIteration:
                            input_exhausted = True
                            break
                    # Eager steps need no equal shapes: a short tail (the
                    # input ran out) is a shorter chunk.
                    metrics = run_steps(chunk)
                    step += len(chunk)
                else:
                    metrics = run_steps([batch])
                    step += 1
                profile.on_step(step)
                # TPU_YARN_FAULT's host boundary (training.py:986-991): a
                # cached no-op when unarmed. SIGTERM lands in the
                # preemption flag and drains through the poll below; an
                # injected crash propagates like any runtime abort.
                chaos.on_train_step(step)
                if (not input_exhausted and step < params_cfg.train_steps
                        and (world == 1 or step % drain_poll_every == 0)
                        and _preempt_agreed(device, world)):
                    # First at the host boundary, before eval or log work
                    # that could outlive the SIGTERM grace window. A flag
                    # raised during the final step completes normally.
                    _logger.warning(
                        "preemption drain at step %d: saving checkpoint", step)
                    if core.model_dir:
                        with telemetry.span("train/checkpoint_save", step=step,
                                            drain=True):
                            if step != last_saved_step:
                                write(step)
                            landed()
                    raise preemption.Preempted(
                        f"preempted at step {step}"
                        + (f"; checkpoint saved to {core.model_dir}"
                           if core.model_dir
                           else " (no model_dir: progress lost)"))
                if ((params_cfg.log_every_steps
                     and step % params_cfg.log_every_steps == 0)
                        or step == params_cfg.train_steps):
                    # Reading the metrics waits for the queued device work.
                    with telemetry.span("train/device_wait") as sp:
                        metrics_host = _host_metrics(metrics, world)
                    breakdown.add("device_wait", sp.duration)
                    hook.after_step(step, metrics_host,
                                    force=step == params_cfg.train_steps,
                                    breakdown=breakdown.report())
                    if tb_writer is not None:
                        for key, value in metrics_host.items():
                            tb_writer.add_scalar(f"train/{key}", value, step)
                if (params_cfg.checkpoint_every_steps and core.model_dir
                        and step % params_cfg.checkpoint_every_steps == 0
                        and step != last_saved_step):
                    save(step)
                    if isinstance(tb_writer, _UploadingTbWriter):
                        # TB events survive a SIGKILL up to the last
                        # checkpoint boundary, like the model state does.
                        tb_writer.upload()
                if (params_cfg.eval_every_steps and core.eval_input_fn
                        and step % params_cfg.eval_every_steps == 0):
                    with telemetry.span("train/eval", step=step) as sp:
                        eval_metrics = evaluate(
                            eval_step, state, core.eval_input_fn, place,
                            params_cfg.eval_steps, hosts, world)
                    breakdown.add("eval", sp.duration)
                    _logger.info("eval @ step %d: %s", step, eval_metrics)
                    if tb_writer is not None:
                        for key, value in eval_metrics.items():
                            tb_writer.add_scalar(f"eval/{key}", value, step)
                if step < params_cfg.train_steps:
                    if input_exhausted:
                        _logger.info("input exhausted at step %d", step)
                        break
                    try:
                        batch = pull_batch()
                    except StopIteration:
                        _logger.info("input exhausted at step %d", step)
                        break
        finally:
            batch_iter.close()
            profile.stop()

        if not metrics_host:
            # The loop never ran (restored at train_steps): report the
            # model's current loss instead of {}.
            metrics_host = _host_metrics(eval_step(state, batch), world)
        if core.model_dir:
            with telemetry.span("train/checkpoint_save", step=step,
                                final=True):
                if step != last_saved_step:
                    write(step)
                landed()
        if core.eval_input_fn:
            with telemetry.span("train/eval", final=True):
                final_eval = evaluate(eval_step, state, core.eval_input_fn,
                                      place, params_cfg.eval_steps, hosts,
                                      world)
            metrics_host.update(
                {f"eval_{k}": v for k, v in final_eval.items()})
        return metrics_host
