"""Experiment types — the subset of tf_yarn_tpu/experiment.py that the
port's train loop and batch inference consume.

`TrainParams` is a copy of the JAX package's loop knobs with the same
validation (experiment.py:39-100), less ``drain_poll_every_steps``: the
preemption drain it paces is not ported. `TorchExperiment` is the counterpart
of `JaxExperiment` (experiment.py:103-123) and `as_core_experiment`
normalises it into `CoreExperiment`, the form `training.
train_and_evaluate` reads. The Estimator and Keras shapes are not
ported.

Differences that PyTorch brings: the parameters live in the module, so
``model`` is an ``nn.Module`` (or None, with ``init_fn(device, seed)``
building it on the train loop's device); ``optimizer`` is a factory
``model -> torch.optim.Optimizer``; the loss contract is
``loss_fn(model, batch, train=True) -> (loss, aux)`` with ``batch`` a
dict of tensors. ``mesh_spec`` is carried but a multi-device one raises
in the loop (ROADMAP.md Queue 1 item 7).

`InferenceExperiment` (experiment.py:236-278) describes a batch-inference
job for `inference.run_inference`; its ``model`` is the port's
`Transformer`, whose weights the run restores from ``model_dir``. An
experiment fn that runs in a launched task builds that model on
`_device.task_device()`.

`run_experiment` (experiment.py:765-799) is what the worker task program
calls: training on the task's device, or batch inference. The serving
and ranking experiment types wait for their task programs (ROADMAP.md
Queue 1 items 2c and 8a).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Iterator, Optional

Batch = Dict[str, Any]
InputFn = Callable[[], Iterator[Batch]]


@dataclasses.dataclass
class TrainParams:
    """Loop control knobs, validated at construction."""

    train_steps: int
    eval_every_steps: Optional[int] = None
    eval_steps: int = 10
    checkpoint_every_steps: Optional[int] = None
    # Completed checkpoints beyond the newest N are deleted before each
    # save. None = keep everything.
    keep_last_n: Optional[int] = 5
    log_every_steps: int = 10
    seed: int = 0
    # Split each batch into N sequential microbatches, averaging
    # gradients before the one optimizer update.
    grad_accum_steps: int = 1
    # N steps per host round trip; > 1 is not ported (the loop raises).
    steps_per_loop: int = 1

    def __post_init__(self) -> None:
        if self.train_steps < 1:
            raise ValueError(
                f"train_steps must be >= 1, got {self.train_steps}")
        if self.steps_per_loop < 1:
            raise ValueError(
                f"steps_per_loop must be >= 1, got {self.steps_per_loop}")
        if self.grad_accum_steps < 1:
            raise ValueError(
                f"grad_accum_steps must be >= 1, got {self.grad_accum_steps}")
        for name in ("eval_every_steps", "checkpoint_every_steps",
                     "keep_last_n"):
            value = getattr(self, name)
            if value is not None and value < 1:
                raise ValueError(f"{name} must be >= 1, got {value}")
        if self.log_every_steps < 0:
            raise ValueError(
                f"log_every_steps must be >= 0, got {self.log_every_steps}")
        if self.eval_steps < 1:
            raise ValueError(
                f"eval_steps must be >= 1, got {self.eval_steps}")


@dataclasses.dataclass
class TorchExperiment:
    """Everything the train loop needs: a model (or ``init_fn(device,
    seed) -> nn.Module``), an optimizer factory, a loss and the input."""

    model: Any
    optimizer: Callable[[Any], Any]
    loss_fn: Callable[..., Any]
    train_input_fn: InputFn
    train_params: TrainParams
    model_dir: Optional[str] = None
    eval_input_fn: Optional[InputFn] = None
    init_fn: Optional[Callable[[Any, int], Any]] = None
    mesh_spec: Any = None

    def __post_init__(self) -> None:
        if self.model is None and self.init_fn is None:
            raise ValueError("TorchExperiment needs a model or an init_fn")


@dataclasses.dataclass
class InferenceExperiment:
    """Batch-inference job: restore a checkpoint into ``model``, run
    KV-cache generation over an input stream, write JSON lines.

    ``model`` is a `Transformer` built on the device the job runs on (its
    weights are replaced by the checkpoint's ``params``); ``model_dir``
    holds the ``ckpt-<step>`` trees `training.train_and_evaluate` writes
    (local paths). `input_fn` yields dict batches with "tokens" [B, P]
    and any extra keys to echo into the records; it may declare
    ``(shard, num_shards)`` keywords to split the stream across task
    instances. Results land as JSON lines at `output_path` (suffixed
    ``-<task_id>`` with several instances)."""

    model: Any
    model_dir: str
    input_fn: Callable[..., Iterator[Batch]]
    output_path: str
    max_new_tokens: int = 128
    temperature: float = 0.0
    top_k: Optional[int] = None
    top_p: Optional[float] = None
    eos_token: Optional[int] = None
    step: Optional[int] = None  # checkpoint step; None = latest
    # Multi-instance jobs whose input_fn ignores (shard, num_shards) fail
    # fast unless duplicating the full stream is intended.
    allow_duplicate_stream: bool = False
    # Input batches staged ahead, and decoded batches queued to the
    # background writer before the producer blocks; both >= 1.
    prefetch_depth: int = 2
    writer_depth: int = 8

    def __post_init__(self) -> None:
        for name in ("prefetch_depth", "writer_depth"):
            value = getattr(self, name)
            if value < 1:
                raise ValueError(f"{name} must be >= 1, got {value}")
        if self.max_new_tokens < 0:
            raise ValueError(
                f"max_new_tokens must be >= 0, got {self.max_new_tokens}")


@dataclasses.dataclass
class CoreExperiment:
    """Normalized form consumed by training.train_and_evaluate."""

    model: Any
    optimizer: Callable[[Any], Any]
    loss_fn: Callable[..., Any]
    train_input_fn: InputFn
    train_params: TrainParams
    model_dir: Optional[str]
    eval_input_fn: Optional[InputFn]
    init_fn: Optional[Callable[[Any, int], Any]]
    mesh_spec: Any


def as_core_experiment(experiment: Any) -> CoreExperiment:
    if isinstance(experiment, TorchExperiment):
        return CoreExperiment(
            model=experiment.model,
            optimizer=experiment.optimizer,
            loss_fn=experiment.loss_fn,
            train_input_fn=experiment.train_input_fn,
            train_params=experiment.train_params,
            model_dir=experiment.model_dir,
            eval_input_fn=experiment.eval_input_fn,
            init_fn=experiment.init_fn,
            mesh_spec=experiment.mesh_spec,
        )
    raise TypeError(
        f"unsupported experiment type {type(experiment).__name__}; the port "
        "takes TorchExperiment (the Estimator and Keras shapes are not ported)"
    )


EXPERIMENT_TYPES = (TorchExperiment, CoreExperiment, InferenceExperiment)


def run_experiment(runtime, experiment: Any) -> None:
    """Entry used by tasks/worker.py: an `InferenceExperiment` goes to
    `inference.run_inference`, a `TorchExperiment` or `CoreExperiment` to
    `training.train_and_evaluate` on `_device.task_device()`; anything
    else raises `TypeError`. The body runs under an ``experiment/run``
    span, and the trace is exported on the way out (``TPU_YARN_TRACE``)."""
    from tf_yarn_tpu_torch import telemetry

    task = runtime.task if runtime is not None else "local"
    try:
        with telemetry.span("experiment/run", kind=type(experiment).__name__):
            if isinstance(experiment, InferenceExperiment):
                from tf_yarn_tpu_torch import inference

                inference.run_inference(experiment, runtime=runtime)
                return
            if isinstance(experiment, (TorchExperiment, CoreExperiment)):
                from tf_yarn_tpu_torch import training
                from tf_yarn_tpu_torch._device import task_device

                core = (experiment if isinstance(experiment, CoreExperiment)
                        else as_core_experiment(experiment))
                training.train_and_evaluate(core, device=task_device(),
                                            runtime=runtime)
                return
            raise TypeError(
                f"cannot run an experiment of type {type(experiment)!r}; "
                f"expected one of {EXPERIMENT_TYPES}")
    finally:
        # Re-export so the root span (closed just now, after the runner's
        # own export) is in the file; no-op without TPU_YARN_TRACE.
        telemetry.export_trace(task)
