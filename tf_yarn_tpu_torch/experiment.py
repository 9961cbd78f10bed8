"""Experiment types — the subset of tf_yarn_tpu/experiment.py that the
port's train loop and batch inference consume.

`TrainParams` is a copy of the JAX package's loop knobs with the same
validation (experiment.py:39-100). `TorchExperiment` is the counterpart
of `JaxExperiment` (experiment.py:103-123); the Estimator shape
(`Estimator`, `TrainSpec`, `EvalSpec`, `ExperimentSpec`;
experiment.py:126-214) and `KerasExperiment` (experiment.py:217-233)
are the reference's other two. `as_core_experiment` normalises each into
`CoreExperiment`, the form `training.train_and_evaluate` and the
side-car evaluator (`evaluation.continuous_eval`) read. ``exporters``
(``exporters(params, metrics, step)``, one callable or a sequence) run
in the evaluator after each checkpoint's evaluation; ``params`` is the
checkpoint's state dict.

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

`ServingExperiment` (experiment.py:282-577) describes an online
`/v1/generate` replica — and, with ``prefill_tier``, the prefill tier
beside it — and `RankingExperiment` (experiment.py:580-673) an online
`/v1/rank` replica, with the JAX package's fields, defaults and
validation messages. Their ``model`` is the port's `Transformer` or
`DLRM`, built by the experiment fn on the task's device and holding its
weights. What the port cannot serve yet is refused at construction with
NotImplementedError naming its ROADMAP.md Queue 1 item: any ``mesh_spec``
(item 7). The ``router_*``, ``autoscale``, ``autoscale_launch_eta_s`` and
``autoscale_warm_start`` fields are read only by the ``router`` task of a
fleet (`fleet.router.run_router`), whose model is on the meta device.

`run_experiment` (experiment.py:765-799) is what the worker, serving
and rank task programs call: training on the task's device (every
training shape), batch inference, `serving.server.run_serving` or
`ranking.server.run_ranking`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Iterator, NamedTuple, Optional, Tuple

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
    # Run N train steps back to back between host events (no host read
    # inside the chunk); chunks never cross a log, checkpoint, eval or
    # profile boundary.
    steps_per_loop: int = 1
    # Multi-host preemption agreement polls every N steps; None = the
    # smallest host cadence above. One process polls the flag every step
    # and ignores this.
    drain_poll_every_steps: Optional[int] = None

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
        if (self.drain_poll_every_steps is not None
                and self.drain_poll_every_steps < 1):
            raise ValueError(
                "drain_poll_every_steps must be >= 1, got "
                f"{self.drain_poll_every_steps}")
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
    # exporters(params, metrics, step): run by the side-car evaluator
    # after each checkpoint's evaluation.
    exporters: Optional[Callable] = None

    def __post_init__(self) -> None:
        if self.model is None and self.init_fn is None:
            raise ValueError("TorchExperiment needs a model or an init_fn")


class Estimator:
    """Estimator-style shim (experiment.py:126-178): owns the model (or
    its ``init_fn``), loss, optimizer factory and model_dir."""

    def __init__(self, model: Any, loss_fn: Callable[..., Any],
                 optimizer: Callable[[Any], Any],
                 model_dir: Optional[str] = None,
                 init_fn: Optional[Callable[[Any, int], Any]] = None,
                 mesh_spec: Any = None) -> None:
        self.model = model
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.model_dir = model_dir
        self.init_fn = init_fn
        self.mesh_spec = mesh_spec

    @property
    def config(self) -> Dict[str, Any]:
        return {"model_dir": self.model_dir}

    def train(self, input_fn: InputFn, max_steps: int, device=None,
              **train_params) -> Dict:
        """In-process training on `device` (the card unless "cpu");
        `train_params` override `TrainParams` fields (an unknown key
        raises TypeError)."""
        from tf_yarn_tpu_torch import training

        spec = ExperimentSpec(
            estimator=self,
            train_spec=TrainSpec(input_fn=input_fn, max_steps=max_steps))
        core = as_core_experiment(spec)
        if train_params:
            core.train_params = dataclasses.replace(core.train_params,
                                                    **train_params)
        return training.train_and_evaluate(core, device=device)

    def evaluate(self, input_fn: InputFn, steps: int = 10,
                 device=None) -> Dict:
        """Evaluate the latest checkpoint in model_dir on `input_fn`."""
        from tf_yarn_tpu_torch import checkpoint as ckpt_lib
        from tf_yarn_tpu_torch.evaluation import evaluate_checkpoint

        if not self.model_dir:
            raise ValueError("evaluate() needs a model_dir with checkpoints")
        step = ckpt_lib.latest_checkpoint_step(self.model_dir)
        if step is None:
            raise ValueError(f"no checkpoints in {self.model_dir}")
        return evaluate_checkpoint(
            self.model, self.loss_fn, self.model_dir, step, input_fn, steps,
            init_fn=self.init_fn, device=device)


class TrainSpec(NamedTuple):
    input_fn: InputFn
    max_steps: int


class EvalSpec(NamedTuple):
    input_fn: Optional[InputFn] = None
    steps: int = 10
    throttle_secs: int = 30  # side-car evaluator poll cadence
    start_delay_secs: int = 0
    every_steps: Optional[int] = None  # in-loop eval cadence (None = end only)
    # exporters(params, metrics, step), run by the side-car evaluator
    # after each checkpoint's evaluation.
    exporters: Optional[Callable] = None


class ExperimentSpec(NamedTuple):
    """`Experiment(estimator, train_spec, eval_spec)` (experiment.py:
    198-214)."""

    estimator: Estimator
    train_spec: TrainSpec
    eval_spec: Optional[EvalSpec] = None

    @property
    def config(self) -> Dict[str, Any]:
        return self.estimator.config

    @property
    def model_dir(self) -> Optional[str]:
        return self.estimator.model_dir


@dataclasses.dataclass
class KerasExperiment:
    """Keras-shaped experiment (experiment.py:217-233): model, model_dir,
    train_params, separate feature and target streams, with the optimizer
    factory and loss a compiled Keras model would carry."""

    model: Any
    model_dir: Optional[str]
    train_params: TrainParams
    input_data_fn: InputFn
    optimizer: Callable[[Any], Any]
    loss_fn: Callable[..., Any]
    target_data_fn: Optional[Callable] = None
    validation_data_fn: Optional[InputFn] = None
    init_fn: Optional[Callable[[Any, int], Any]] = None
    mesh_spec: Any = None


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


def _refuse_mesh_spec(spec, what: str) -> None:
    if spec is not None:
        raise NotImplementedError(
            f"mesh_spec: {what} is not ported yet (ROADMAP.md Queue 1 item "
            "7, parallelism); serve on one device (mesh_spec=None)")


@dataclasses.dataclass
class ServingExperiment:
    """Online-serving job: restore a checkpoint into ``model`` and serve
    ``/v1/generate`` with continuous batching until stopped
    (`serving.server.run_serving`). The JAX package's fields, defaults
    and validation (experiment.py:282-577).

    ``model`` is a `Transformer` on the device the replica runs on (its
    weights are replaced by the checkpoint's ``params``); ``model_dir``
    holds the ``ckpt-<step>`` trees. ``temperature``/``top_k``/``top_p``
    configure the slot grid; requests carrying other values are refused
    with a 400. ``serve_seconds=None`` serves until the task is killed
    or a preemption notice arrives. ``kv_layout``, ``block_size``,
    ``num_blocks``, ``prefix_cache_capacity``, ``spec_k``,
    ``spec_draft``, ``decode_attention``, ``prefill_chunk``,
    ``prefill_budget_per_tick``, ``kv_host_blocks`` and ``tier_caps``
    are `SlotScheduler`'s knobs. ``slo`` declares the objectives each
    replica evaluates. ``prefill_tier`` (a `PrefillTierConfig` field
    dict, paged layout) makes ``/v1/generate`` pull long prompts' KV
    blocks from the ``prefill`` task tier before submitting; it is also
    the experiment the ``prefill`` task reads. The ``router_*`` knobs
    (``router_policy`` "round_robin" or "least_loaded", the failover
    budget ``router_retries``, the ``/healthz`` cadence
    ``router_probe_interval_s``) and ``autoscale`` (replica kind ->
    `fleet.autoscaler.AutoscalePolicy` field dict), with
    ``autoscale_launch_eta_s`` (an empty pool's Retry-After) and
    ``autoscale_warm_start`` (prime re-admitted generate replicas over
    ``/v1/blocks``), are the ``router`` task's. ``mesh_spec`` is refused
    (module docstring)."""

    model: Any
    model_dir: str
    host: str = "0.0.0.0"
    port: int = 0  # 0 = ephemeral; the bound port is advertised via KV
    max_slots: int = 8
    queue_capacity: int = 64
    retry_after_s: float = 1.0
    temperature: float = 0.0
    top_k: Optional[int] = None
    top_p: Optional[float] = None
    step: Optional[int] = None  # checkpoint step; None = latest
    serve_seconds: Optional[float] = None
    kv_layout: str = "paged"
    block_size: int = 16
    num_blocks: Optional[int] = None
    prefix_cache_capacity: int = 256
    spec_k: int = 0
    spec_draft: Any = "ngram"
    decode_attention: str = "gather"
    prefill_chunk: Any = 0
    prefill_budget_per_tick: Optional[int] = None
    kv_host_blocks: int = 0
    tier_caps: Optional[Dict[str, int]] = None
    mesh_spec: Any = None
    router_host: str = "0.0.0.0"
    router_port: int = 0
    router_policy: str = "least_loaded"
    router_retries: int = 2
    router_probe_interval_s: float = 1.0
    slo: Optional[Dict[str, float]] = None
    autoscale: Optional[Dict[str, Dict]] = None
    autoscale_launch_eta_s: float = 15.0
    autoscale_warm_start: bool = True
    prefill_tier: Optional[Dict] = None

    def __post_init__(self) -> None:
        if self.max_slots < 1:
            raise ValueError(f"max_slots must be >= 1, got {self.max_slots}")
        if self.queue_capacity < 1:
            raise ValueError(
                f"queue_capacity must be >= 1, got {self.queue_capacity}")
        if self.serve_seconds is not None and self.serve_seconds <= 0:
            raise ValueError(
                f"serve_seconds must be > 0 or None, got {self.serve_seconds}")
        if self.kv_layout not in ("dense", "paged"):
            raise ValueError(
                f"kv_layout must be 'dense' or 'paged', got {self.kv_layout!r}")
        if self.block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {self.block_size}")
        if self.num_blocks is not None and self.num_blocks < 2:
            raise ValueError(
                f"num_blocks must be >= 2 or None, got {self.num_blocks}")
        if self.prefix_cache_capacity < 0:
            raise ValueError(
                f"prefix_cache_capacity must be >= 0, got "
                f"{self.prefix_cache_capacity}")
        if self.spec_k < 0:
            raise ValueError(f"spec_k must be >= 0, got {self.spec_k}")
        if self.spec_draft is not None and not callable(self.spec_draft) \
                and self.spec_draft != "ngram":
            raise ValueError(
                "spec_draft must be 'ngram', a callable "
                f"(context, k) -> tokens, or None; got {self.spec_draft!r}")
        if self.decode_attention not in ("gather", "fused"):
            raise ValueError(
                f"decode_attention must be 'gather' or 'fused', got "
                f"{self.decode_attention!r}")
        if self.decode_attention == "fused" and self.kv_layout != "paged":
            raise ValueError(
                "decode_attention='fused' requires kv_layout='paged'")
        chunked = self.prefill_chunk not in (0, None)
        if chunked and self.prefill_chunk != "auto" and (
                not isinstance(self.prefill_chunk, int)
                or self.prefill_chunk < 1):
            raise ValueError(
                "prefill_chunk must be 0/None (blocking admission "
                "prefill), 'auto', or an int >= 1; got "
                f"{self.prefill_chunk!r}")
        if self.prefill_budget_per_tick is not None:
            if not chunked:
                raise ValueError(
                    "prefill_budget_per_tick needs chunked prefill: set "
                    "prefill_chunk >= 1 or 'auto' (with blocking "
                    "admission there is no per-tick prefill to budget)")
            if self.prefill_budget_per_tick < 1:
                raise ValueError(
                    "prefill_budget_per_tick must be >= 1 or None, got "
                    f"{self.prefill_budget_per_tick}")
        if self.kv_host_blocks < 0:
            raise ValueError(
                f"kv_host_blocks must be >= 0, got {self.kv_host_blocks}")
        if self.kv_host_blocks and self.kv_layout != "paged":
            raise ValueError(
                "kv_host_blocks (the host swap tier) requires "
                "kv_layout='paged'")
        if self.tier_caps is not None:
            from tf_yarn_tpu_torch.serving.request import tier_rank

            for name, cap in self.tier_caps.items():
                tier_rank(name)  # ValueError on an unknown tier name
                if not isinstance(cap, int) or cap < 0:
                    raise ValueError(
                        f"tier_caps[{name!r}] must be an int >= 0, "
                        f"got {cap!r}")
        _refuse_mesh_spec(self.mesh_spec, "tensor-parallel decode")
        if self.router_policy not in ("round_robin", "least_loaded"):
            raise ValueError(
                f"router_policy must be 'round_robin' or 'least_loaded', "
                f"got {self.router_policy!r}")
        if self.router_retries < 0:
            raise ValueError(
                f"router_retries must be >= 0, got {self.router_retries}")
        if self.router_probe_interval_s <= 0:
            raise ValueError(
                f"router_probe_interval_s must be > 0, got "
                f"{self.router_probe_interval_s}")
        if self.slo is not None:
            from tf_yarn_tpu_torch.telemetry.slo import parse_slo

            try:
                parse_slo(self.slo)
            except ValueError as exc:
                raise ValueError(f"slo: {exc}") from exc
        if self.autoscale is not None:
            from tf_yarn_tpu_torch.fleet.autoscaler import parse_autoscale

            try:
                parse_autoscale(self.autoscale)
            except ValueError as exc:
                raise ValueError(f"autoscale: {exc}") from exc
        if not self.autoscale_launch_eta_s > 0:
            raise ValueError(
                f"autoscale_launch_eta_s must be > 0, got "
                f"{self.autoscale_launch_eta_s}")
        if self.prefill_tier is not None:
            from tf_yarn_tpu_torch.serving.prefill import parse_prefill_tier

            try:
                parse_prefill_tier(self.prefill_tier)
            except ValueError as exc:
                raise ValueError(f"prefill_tier: {exc}") from exc


@dataclasses.dataclass
class RankingExperiment:
    """Online-ranking job: restore (or init from ``init_seed``) a
    DLRM-class ``model`` and serve ``/v1/rank`` with fill-or-timeout
    micro-batching until stopped (`ranking.server.run_ranking`). The same
    fields, defaults and validation as the JAX package's
    (experiment.py:580-673).

    ``max_batch``/``max_wait_ms`` are the micro-batch policy: tick when
    the queued rows fill ``max_batch`` or the oldest waiter has waited
    ``max_wait_ms``. ``model_dir=None`` serves the seeded init instead
    of a checkpoint: every replica of the port with the same model and
    seed holds the same weights bit for bit (not the JAX package's: a
    torch generator cannot draw what ``jax.random`` draws). Any
    ``mesh_spec`` is refused (item 7)."""

    model: Any
    model_dir: Optional[str] = None
    host: str = "0.0.0.0"
    port: int = 0  # 0 = ephemeral; the bound port is advertised via KV
    max_batch: int = 32
    max_wait_ms: float = 2.0
    queue_capacity: int = 256
    retry_after_s: float = 0.5
    batch_buckets: Optional[Tuple[int, ...]] = None
    warmup: bool = True
    init_seed: int = 0
    step: Optional[int] = None  # checkpoint step; None = latest
    serve_seconds: Optional[float] = None
    mesh_spec: Any = None

    def __post_init__(self) -> None:
        if self.max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {self.max_batch}")
        if self.max_wait_ms < 0:
            raise ValueError(
                f"max_wait_ms must be >= 0, got {self.max_wait_ms}")
        if self.queue_capacity < 1:
            raise ValueError(
                f"queue_capacity must be >= 1, got {self.queue_capacity}")
        if self.serve_seconds is not None and self.serve_seconds <= 0:
            raise ValueError(
                f"serve_seconds must be > 0 or None, got "
                f"{self.serve_seconds}")
        if self.batch_buckets is not None and (
                not self.batch_buckets or min(self.batch_buckets) < 1):
            raise ValueError(
                f"batch_buckets must be a non-empty tuple of positive "
                f"sizes or None, got {self.batch_buckets!r}")
        config = getattr(self.model, "config", None)
        if config is None or not hasattr(config, "table_sizes"):
            raise ValueError(
                "RankingExperiment.model must be a DLRM-class model "
                "exposing config.table_sizes (the ranking engine reads "
                "it for feature validation and table sharding)")
        _refuse_mesh_spec(self.mesh_spec, "embedding-sharded ranking")


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
    # exporters(params, metrics, step): evaluator post-eval hook.
    exporters: Optional[Callable] = None


def _merge_input_targets(experiment: KerasExperiment) -> InputFn:
    """Zip Keras-style separate feature/target streams into batch dicts
    (experiment.py:693-707)."""

    def input_fn():
        targets = (experiment.target_data_fn() if experiment.target_data_fn
                   else None)
        for features in experiment.input_data_fn():
            batch = (dict(features) if isinstance(features, dict)
                     else {"x": features})
            if targets is not None:
                try:
                    batch["y"] = next(targets)
                except StopIteration:  # targets exhausted: epoch over
                    return
            yield batch

    return input_fn


def as_core_experiment(experiment: Any) -> CoreExperiment:
    if isinstance(experiment, CoreExperiment):
        return experiment
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
            exporters=experiment.exporters,
        )
    if isinstance(experiment, ExperimentSpec):
        estimator = experiment.estimator
        eval_spec = experiment.eval_spec
        params = TrainParams(
            train_steps=experiment.train_spec.max_steps,
            eval_every_steps=eval_spec.every_steps if eval_spec else None,
            eval_steps=eval_spec.steps if eval_spec else 10,
        )
        return CoreExperiment(
            model=estimator.model,
            optimizer=estimator.optimizer,
            loss_fn=estimator.loss_fn,
            train_input_fn=experiment.train_spec.input_fn,
            train_params=params,
            model_dir=estimator.model_dir,
            eval_input_fn=eval_spec.input_fn if eval_spec else None,
            init_fn=estimator.init_fn,
            mesh_spec=estimator.mesh_spec,
            exporters=eval_spec.exporters if eval_spec else None,
        )
    if isinstance(experiment, KerasExperiment):
        return CoreExperiment(
            model=experiment.model,
            optimizer=experiment.optimizer,
            loss_fn=experiment.loss_fn,
            train_input_fn=_merge_input_targets(experiment),
            train_params=experiment.train_params,
            model_dir=experiment.model_dir,
            eval_input_fn=experiment.validation_data_fn,
            init_fn=experiment.init_fn,
            mesh_spec=experiment.mesh_spec,
        )
    raise TypeError(f"cannot normalize experiment of type {type(experiment)!r}")


# The training shapes `run_experiment` sends to `train_and_evaluate`.
TRAINING_TYPES = (TorchExperiment, CoreExperiment, ExperimentSpec,
                  KerasExperiment)
EXPERIMENT_TYPES = TRAINING_TYPES + (InferenceExperiment, ServingExperiment,
                                     RankingExperiment)


def run_experiment(runtime, experiment: Any) -> None:
    """Entry used by tasks/{worker,serving,rank}.py: an
    `InferenceExperiment` goes to `inference.run_inference`, a
    `ServingExperiment` to `serving.server.run_serving`, a
    `RankingExperiment` to `ranking.server.run_ranking`, a training
    shape (`TRAINING_TYPES`) to `training.train_and_evaluate` on
    `_device.task_device()`; anything else raises `TypeError`. The body runs under an ``experiment/run``
    span, and the trace is exported on the way out (``TPU_YARN_TRACE``)."""
    from tf_yarn_tpu_torch import telemetry

    task = runtime.task if runtime is not None else "local"
    try:
        with telemetry.span("experiment/run", kind=type(experiment).__name__):
            if isinstance(experiment, InferenceExperiment):
                from tf_yarn_tpu_torch import inference

                inference.run_inference(experiment, runtime=runtime)
                return
            if isinstance(experiment, ServingExperiment):
                from tf_yarn_tpu_torch.serving.server import run_serving

                run_serving(experiment, runtime=runtime)
                return
            if isinstance(experiment, RankingExperiment):
                from tf_yarn_tpu_torch.ranking.server import run_ranking

                run_ranking(experiment, runtime=runtime)
                return
            if isinstance(experiment, TRAINING_TYPES):
                from tf_yarn_tpu_torch import training
                from tf_yarn_tpu_torch._device import task_device

                training.train_and_evaluate(as_core_experiment(experiment),
                                            device=task_device(),
                                            runtime=runtime)
                return
            raise TypeError(
                f"cannot run an experiment of type {type(experiment)!r}; "
                f"expected one of {EXPERIMENT_TYPES}")
    finally:
        # Re-export so the root span (closed just now, after the runner's
        # own export) is in the file; no-op without TPU_YARN_TRACE.
        telemetry.export_trace(task)
