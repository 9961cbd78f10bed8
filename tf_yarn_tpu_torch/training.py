"""The train-and-evaluate loop on one device — counterpart of
tf_yarn_tpu/training.py.

`build_train_step` (training.py:126-187) runs the loss forward, the
backward (through `torch.utils.checkpoint` where the model recomputes
its blocks) and the optimizer update, with ``grad_accum_steps``
microbatches summed and averaged before the one update and perplexity
re-derived as ``exp(loss)``. `train_and_evaluate` (training.py:574)
drives it: input resume from the newest verified checkpoint, input
prefetch on a background thread, log, eval and checkpoint cadences with
``keep_last_n`` retention, the steps/sec hook with samples/s, tokens/s
and MFU weighted by the batches really run, and the ``train/*`` spans
and gauges of the port's telemetry. In a launched task (``runtime``
given) the hook broadcasts the rates and ``{task}/last_training_step``
through the run's KV store and flushes the registry to
``{task}/metrics`` (training.py:335-351); ``TPU_YARN_TRACE`` writes the
spans on exit.

PyTorch runs eagerly: a step's kernels are queued on the card as the
host runs, and the host waits only where it reads a value (the log
cadence, ``train/device_wait``), so metrics stay tensors until then.

Not ported here, each raising or named in ROADMAP.md: ``steps_per_loop
> 1`` and the async checkpoint writer (Queue 1 item 4), a multi-device
``mesh_spec`` or a process group of more than one rank (Queue 1 item 7),
elastic resize, preemption drain, the profiler window and the
TensorBoard writer (Queue 1 items 4 and 5).
"""

from __future__ import annotations

import inspect
import logging
import os
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from tf_yarn_tpu_torch import checkpoint as ckpt_lib
from tf_yarn_tpu_torch import event, telemetry
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


def build_train_step(model, loss_fn, optimizer, grad_accum_steps: int = 1):
    """``train_step(state, batch) -> (state, metrics)``: metrics are
    detached 0-d tensors on the model's device ("loss" and the loss's
    aux)."""

    def train_step(state: TrainState, batch):
        optimizer.zero_grad(set_to_none=True)
        if grad_accum_steps == 1:
            loss, aux = loss_fn(model, batch, train=True)
            loss.backward()
            loss = loss.detach()
        else:
            loss_sum, aux_sum = 0.0, {}
            for micro in _split(batch, grad_accum_steps):
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
            out = {}
            for key, value in batch.items():
                tensor = torch.as_tensor(np.asarray(value))
                if not tensor.is_floating_point():
                    tensor = tensor.long()
                out[key] = tensor.to(device, non_blocking=True)
        telemetry.get_registry().histogram(
            "train/globalize_seconds").observe(sp.duration)
        return out

    return place


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


def train_and_evaluate(core: CoreExperiment, device=None,
                       runtime=None) -> Dict[str, float]:
    """Run the train/eval/checkpoint loop on one device (CUDA unless
    ``device="cpu"``); returns the final metrics. `runtime` is a launched
    task's (`tasks._bootstrap.TaskRuntime`): the loop then reports into
    the run's KV store."""
    params_cfg = core.train_params
    if params_cfg.steps_per_loop > 1:
        raise NotImplementedError(
            "steps_per_loop > 1 is not ported yet (ROADMAP.md Queue 1 item 4)")
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

    resume_step = 0
    if core.model_dir:
        with telemetry.span("train/restore_latest"):
            restored, step = ckpt_lib.restore_latest(core.model_dir,
                                                     map_location=device)
        if restored is not None:
            state.load_state_dict(restored)
            resume_step = step
            _logger.info("resumed from checkpoint step %d", resume_step)

    train_step = build_train_step(model, core.loss_fn, state.optimizer,
                                  params_cfg.grad_accum_steps)
    eval_step = build_eval_step(model, core.loss_fn)
    samples, tokens = flops_lib.batch_counts(batch)
    flops_per_step = flops_lib.model_train_flops(model, batch)
    if flops_per_step is None and resume_step < params_cfg.train_steps:
        with telemetry.span("train/count_flops"):
            flops_per_step = _count_train_flops(model, core.loss_fn, batch,
                                                params_cfg.grad_accum_steps)
    hook = _StepsPerSecondHook(params_cfg.log_every_steps, resume_step,
                               flops_per_step, samples, tokens,
                               _peak_flops(device), runtime=runtime)
    breakdown = _IntervalBreakdown()
    metrics_host: Dict[str, float] = {}
    last_saved_step = resume_step if resume_step else None
    step = resume_step

    def save(at: int, **args) -> None:
        with telemetry.span("train/checkpoint_save", step=at, **args) as sp:
            ckpt_lib.prune_checkpoints(core.model_dir, params_cfg.keep_last_n)
            ckpt_lib.save_checkpoint(core.model_dir, at, state.state_dict())
        breakdown.add("checkpoint_save", sp.duration)

    # Batches after the first are read and placed on a background thread
    # (training.py:874), `depth` steps ahead of the loop.
    batch_iter = prefetch(train_iter, place_fn=place, depth=2, name="train")
    try:
        while step < params_cfg.train_steps:
            hook.record_batch(flops_lib.batch_counts(batch)[0])
            with telemetry.span("train/step_dispatch") as sp:
                state, metrics = train_step(state, batch)
            breakdown.add("step_dispatch", sp.duration)
            step += 1
            if ((params_cfg.log_every_steps
                 and step % params_cfg.log_every_steps == 0)
                    or step == params_cfg.train_steps):
                # Reading the metrics waits for the queued device work.
                with telemetry.span("train/device_wait") as sp:
                    metrics_host = {k: float(v) for k, v in metrics.items()}
                breakdown.add("device_wait", sp.duration)
                hook.after_step(step, metrics_host,
                                force=step == params_cfg.train_steps,
                                breakdown=breakdown.report())
            if (params_cfg.checkpoint_every_steps and core.model_dir
                    and step % params_cfg.checkpoint_every_steps == 0
                    and step != last_saved_step):
                save(step)
                last_saved_step = step
            if (params_cfg.eval_every_steps and core.eval_input_fn
                    and step % params_cfg.eval_every_steps == 0):
                with telemetry.span("train/eval", step=step) as sp:
                    eval_metrics = evaluate(eval_step, state, core.eval_input_fn,
                                            place, params_cfg.eval_steps)
                breakdown.add("eval", sp.duration)
                _logger.info("eval @ step %d: %s", step, eval_metrics)
            if step < params_cfg.train_steps:
                try:
                    with telemetry.span("train/input_wait") as sp:
                        batch = next(batch_iter)
                except StopIteration:
                    _logger.info("input exhausted at step %d", step)
                    break
                breakdown.add("input_wait", sp.duration)
    finally:
        batch_iter.close()

    if not metrics_host:
        # The loop never ran (restored at train_steps): report the
        # model's current loss instead of {}.
        metrics_host = {k: float(v) for k, v in eval_step(state, batch).items()}
    if core.model_dir and step != last_saved_step:
        save(step, final=True)
    if core.eval_input_fn:
        with telemetry.span("train/eval", final=True):
            final_eval = evaluate(eval_step, state, core.eval_input_fn, place,
                                  params_cfg.eval_steps)
        metrics_host.update({f"eval_{k}": v for k, v in final_eval.items()})
    return metrics_host
