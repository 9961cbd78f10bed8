"""The train-and-evaluate loop on one device — counterpart of
tf_yarn_tpu/training.py.

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

Not ported here, each raising or named in ROADMAP.md: a multi-device
``mesh_spec`` or a process group of more than one rank, and with them
the multi-host drain agreement (Queue 1 item 7); elastic resize (item
5.1), the chaos hooks (item 5.2), remote model_dirs and their uploading
TensorBoard writer (item 5.4).
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
from tf_yarn_tpu_torch import event, preemption, telemetry
from tf_yarn_tpu_torch._device import resolve_device
from tf_yarn_tpu_torch.data.prefetch import prefetch
from tf_yarn_tpu_torch.experiment import CoreExperiment
from tf_yarn_tpu_torch.utils import flops as flops_lib
from tf_yarn_tpu_torch.utils import mlflow

_logger = logging.getLogger(__name__)

# The elastic launcher's worker counts (tf_yarn_tpu/constants.py:46-47):
# this attempt's and the full reservation's.
ENV_ELASTIC_WORKERS = "TPU_YARN_ELASTIC_WORKERS"
ENV_ELASTIC_MAX_WORKERS = "TPU_YARN_ELASTIC_MAX_WORKERS"


class TrainState:
    """The step, the model (its parameters) and the optimizer (its
    state), mutated in place by the train step."""

    def __init__(self, step: int, model: torch.nn.Module,
                 optimizer: torch.optim.Optimizer) -> None:
        self.step = step
        self.model = model
        self.optimizer = optimizer

    def state_dict(self) -> Dict[str, Any]:
        return {"step": self.step, "params": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict()}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
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
    """The dropout seed of one step (and microbatch): a hash of
    ``(seed, step[, micro])`` — the JAX step's ``fold_in(base_rng,
    step)`` (training.py:135-159). The masks are the port's own bits."""
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
                     seed: int = 0):
    """``train_step(state, batch) -> (state, metrics)``: metrics are
    detached 0-d tensors on the model's device ("loss" and the loss's
    aux). The model's dropout ``generator``, where it has one, and the
    global generator of the model's device (what ``nn.Dropout`` draws
    from) are reseeded from ``(seed, state.step)`` before the step's
    forward (from ``(seed, state.step, i)`` before microbatch i's); the
    global one is restored after the step, so code outside it sees its
    own stream."""
    generators = [_device_generator(model)]
    if isinstance(getattr(model, "generator", None), torch.Generator):
        generators.append(model.generator)

    def reseed(step: int, *micro: int) -> None:
        for generator in generators:
            generator.manual_seed(step_seed(seed, step, *micro))

    def train_step(state: TrainState, batch):
        saved = generators[0].get_state()
        try:
            return _step(state, batch)
        finally:
            generators[0].set_state(saved)

    def _step(state: TrainState, batch):
        optimizer.zero_grad(set_to_none=True)
        if grad_accum_steps == 1:
            reseed(state.step)
            loss, aux = loss_fn(model, batch, train=True)
            loss.backward()
            loss = loss.detach()
        else:
            loss_sum, aux_sum = 0.0, {}
            for i, micro in enumerate(_split(batch, grad_accum_steps)):
                reseed(state.step, i)
                micro_loss, micro_aux = loss_fn(model, micro, train=True)
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


def evaluate(eval_step, state, eval_input_fn, place, max_steps: int
             ) -> Dict[str, float]:
    totals: Dict[str, float] = {}
    count = 0
    for batch in eval_input_fn():
        metrics = eval_step(state, place(batch))
        for key, value in metrics.items():
            totals[key] = totals.get(key, 0.0) + float(value)
        count += 1
        if count >= max_steps:
            break
    return {k: v / max(count, 1) for k, v in totals.items()}


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
                 runtime=None) -> None:
        self._runtime = runtime
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
        if runtime is not None:
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


def _make_input_iter(input_fn, start_step: int):
    """The train iterator; input_fns declaring `start_step` get the
    resume step (training.py:391-424)."""
    try:
        params = inspect.signature(input_fn).parameters
    except (TypeError, ValueError):
        params = {}
    if "start_step" in params:
        return iter(input_fn(start_step=start_step))
    if start_step:
        _logger.info("input_fn takes no start_step: input restarts from the "
                     "beginning at resume step %d", start_step)
    return iter(input_fn())


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


def _make_tb_writer(model_dir: Optional[str]):
    """A ``SummaryWriter`` at ``<model_dir>/tb`` (training.py:556-571,
    local model_dirs only), or None without a model_dir or where
    tensorboard does not import."""
    if not model_dir:
        return None
    try:
        from torch.utils.tensorboard import SummaryWriter

        return SummaryWriter(log_dir=os.path.join(model_dir, "tb"))
    except Exception:  # tensorboard is optional, as in the JAX package
        return None


def train_and_evaluate(core: CoreExperiment, device=None,
                       runtime=None) -> Dict[str, float]:
    """Run the train/eval/checkpoint loop on one device (CUDA unless
    ``device="cpu"``); returns the final metrics. `runtime` is a launched
    task's (`tasks._bootstrap.TaskRuntime`): the loop then reports into
    the run's KV store."""
    if getattr(core.mesh_spec, "total_devices", 1) > 1:
        raise NotImplementedError(
            "a multi-device mesh_spec is not ported yet: the loop runs on one "
            "device (ROADMAP.md Queue 1 item 7, parallelism)")
    if _world_size() > 1:
        # Each rank would train its own replica on its own batches: data
        # parallelism (gradient all-reduce, sharded input) is not ported.
        raise NotImplementedError(
            f"a process group of {_world_size()} ranks: data-parallel "
            "training is not ported yet, the loop trains one device "
            "(ROADMAP.md Queue 1 item 7, parallelism)")
    device = resolve_device(device)
    telemetry_task = runtime.task if runtime is not None else "train"
    telemetry.enable_env_jsonl(telemetry_task)
    try:
        return _train_and_evaluate(core, device, runtime)
    finally:
        telemetry.export_trace(telemetry_task)


def _train_and_evaluate(core: CoreExperiment, device: torch.device,
                        runtime) -> Dict[str, float]:
    params_cfg = core.train_params
    place = _batch_placer(device)
    # Capacity gauges (training.py:622-636): the devices the step
    # computes on, and whether an elastic attempt runs short of workers.
    registry = telemetry.get_registry()
    registry.gauge("train/mesh_devices").set(1.0)
    registry.gauge("train/degraded").set(_degraded())

    input_resume_step = 0
    if core.model_dir:
        # Quarantines a corrupt newest checkpoint before the input
        # iterator is built, so input and state resume at one step.
        input_resume_step = ckpt_lib.latest_verified_step(core.model_dir) or 0
    train_iter = _make_input_iter(core.train_input_fn, input_resume_step)
    with telemetry.span("train/first_batch"):
        batch = place(next(train_iter))
    with telemetry.span("train/init"):
        model = (core.init_fn(device, params_cfg.seed) if core.init_fn
                 else core.model.to(device))
        model.train()
        state = TrainState(0, model, core.optimizer(model))

    with contextlib.ExitStack() as cleanup:
        resume_step = 0
        ckpt_writer = None
        if core.model_dir:
            with telemetry.span("train/restore_latest"):
                restored, step = ckpt_lib.restore_latest(core.model_dir,
                                                         map_location=device)
            if restored is not None:
                state.load_state_dict(restored)
                resume_step = step
                _logger.info("resumed from checkpoint step %d", resume_step)
            del restored
            # save() returns once the state is in host memory; the write
            # overlaps the next steps.
            ckpt_writer = ckpt_lib.CheckpointWriter(params_cfg.keep_last_n)
            cleanup.callback(ckpt_writer.close)
        train_step = build_train_step(model, core.loss_fn, state.optimizer,
                                      params_cfg.grad_accum_steps,
                                      seed=params_cfg.seed)
        eval_step = build_eval_step(model, core.loss_fn)

        # Cadences that surface to the host this run (training.py:748-796).
        # One process polls the preemption flag every step (a local read),
        # so drain_poll_every_steps adds no boundary here.
        steps_per_loop = max(1, params_cfg.steps_per_loop)
        host_cadences = [c for c in (
            params_cfg.log_every_steps,
            params_cfg.checkpoint_every_steps if core.model_dir else None,
            params_cfg.eval_every_steps if core.eval_input_fn else None) if c]
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

        samples, tokens = flops_lib.batch_counts(batch)
        flops_per_step = flops_lib.model_train_flops(model, batch)
        if flops_per_step is None and resume_step < params_cfg.train_steps:
            with telemetry.span("train/count_flops"):
                flops_per_step = _count_train_flops(
                    model, core.loss_fn, batch, params_cfg.grad_accum_steps)
        hook = _StepsPerSecondHook(params_cfg.log_every_steps, resume_step,
                                   flops_per_step, samples, tokens,
                                   _peak_flops(device), runtime=runtime)
        tb_writer = _make_tb_writer(core.model_dir)
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

        def save(at: int, **args) -> None:
            nonlocal last_saved_step
            with telemetry.span("train/checkpoint_save", step=at,
                                **args) as sp:
                ckpt_writer.save(core.model_dir, at, state.state_dict())
                last_saved_step = at
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
                hook.record_batch(flops_lib.batch_counts(b)[0])
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
                if (not input_exhausted and step < params_cfg.train_steps
                        and preemption.requested()):
                    # First at the host boundary, before eval or log work
                    # that could outlive the SIGTERM grace window. A flag
                    # raised during the final step completes normally.
                    _logger.warning(
                        "preemption drain at step %d: saving checkpoint", step)
                    if core.model_dir:
                        with telemetry.span("train/checkpoint_save", step=step,
                                            drain=True):
                            if step != last_saved_step:
                                ckpt_writer.save(core.model_dir, step,
                                                 state.state_dict())
                                last_saved_step = step
                            ckpt_writer.wait()
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
                        metrics_host = {k: float(v)
                                        for k, v in metrics.items()}
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
                if (params_cfg.eval_every_steps and core.eval_input_fn
                        and step % params_cfg.eval_every_steps == 0):
                    with telemetry.span("train/eval", step=step) as sp:
                        eval_metrics = evaluate(
                            eval_step, state, core.eval_input_fn, place,
                            params_cfg.eval_steps)
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
            metrics_host = {k: float(v)
                            for k, v in eval_step(state, batch).items()}
        if core.model_dir:
            with telemetry.span("train/checkpoint_save", step=step,
                                final=True):
                if step != last_saved_step:
                    ckpt_writer.save(core.model_dir, step, state.state_dict())
                    last_saved_step = step
                ckpt_writer.wait()
        if core.eval_input_fn:
            with telemetry.span("train/eval", final=True):
                final_eval = evaluate(eval_step, state, core.eval_input_fn,
                                      place, params_cfg.eval_steps)
            metrics_host.update(
                {f"eval_{k}": v for k, v in final_eval.items()})
        return metrics_host
