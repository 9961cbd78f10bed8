"""Continuous (side-car) evaluation over the checkpoint stream — the
counterpart of tf_yarn_tpu/evaluation.py.

Poll the experiment's model_dir, evaluate every manifested checkpoint
exactly once, stop when the final-step checkpoint is done, when every
chief and worker has stopped and no checkpoint is pending, or when
nothing new has appeared for the idle timeout
(``TPU_YARN_EVAL_IDLE_TIMEOUT`` seconds, 20 minutes by default). The
evaluated set persists as ``eval-done/eval-done-<step>.json`` markers
(markers at the model_dir's root, where older runs wrote them, count
too). The model_dir may be any `fs` URI: the polling, the checkpoint
reads and the markers go through `fs`, and a task launched by a remote
backend refuses a host-local one (`fs.check_model_dir_placement`). The
experiment's ``exporters(params, metrics, step)`` run after
each checkpoint's evaluation, ``params`` the checkpoint's state dict.

Health metrics broadcast to the KV store after each checkpoint:
``{task}/awake_time_ratio``, ``eval_step_mean_duration``,
``last_training_step`` and ``nb_eval_steps``, which the driver's
`utils.evaluator_metrics.EvaluatorMetricsLogger` polls and logs.

Placement: the evaluator runs on `_device.task_device()` — the CPU in a
launched evaluator unless the caller's env sets ``TPU_YARN_PLATFORM``
(the driver sets it to ``cpu`` by default, as the JAX driver does). It
builds the experiment's model once (``init_fn(device, seed)`` or
``model``) and loads each checkpoint's parameters into it.
"""

from __future__ import annotations

import json
import logging
import os
import time
from functools import partial
from typing import Optional, Set

import torch

from tf_yarn_tpu_torch import checkpoint as ckpt_lib
from tf_yarn_tpu_torch import event
from tf_yarn_tpu_torch import fs as fs_lib
from tf_yarn_tpu_torch._device import resolve_device, task_device
from tf_yarn_tpu_torch.experiment import as_core_experiment
from tf_yarn_tpu_torch.training import build_eval_step, evaluate, to_device
from tf_yarn_tpu_torch.utils import mlflow

_logger = logging.getLogger(__name__)

DEFAULT_IDLE_TIMEOUT_SECS = 20 * 60
DEFAULT_POLL_SECS = 10.0
ENV_IDLE_TIMEOUT = "TPU_YARN_EVAL_IDLE_TIMEOUT"

EVAL_DONE_DIR = "eval-done"  # bookkeeping lives out of checkpoint listings


def _marker_steps(directory: str) -> Set[int]:
    done: Set[int] = set()
    for entry, _is_dir in fs_lib.listdir(directory):
        if entry.startswith("eval-done-") and entry.endswith(".json"):
            try:
                done.add(int(entry[len("eval-done-"):-len(".json")]))
            except ValueError:
                continue
    return done


def evaluated_steps(model_dir: str) -> Set[int]:
    """Steps with an eval-done marker, in ``eval-done/`` or (older runs)
    at the model_dir's root."""
    return (_marker_steps(fs_lib.join(model_dir, EVAL_DONE_DIR))
            | _marker_steps(model_dir))


def _mark_evaluated(model_dir: str, step: int, metrics: dict) -> None:
    marker = fs_lib.join(model_dir, EVAL_DONE_DIR, f"eval-done-{step}.json")
    fs_lib.write_text(marker, json.dumps(metrics))


def _eval_model(model, init_fn, device: torch.device, seed: int):
    """The model the checkpoints load into, on `device`."""
    return init_fn(device, seed) if init_fn else model.to(device)


def evaluate_checkpoint(model, loss_fn, model_dir: str, step: int,
                        eval_input_fn, eval_steps: int, init_fn=None,
                        device=None, seed: int = 0) -> dict:
    """Load ckpt-<step>'s parameters into the model (or the one
    ``init_fn(device, seed)`` builds) on `device` (the card unless
    "cpu") and evaluate it on `eval_input_fn` — Estimator.evaluate's
    one-shot path."""
    device = resolve_device(device)
    net = _eval_model(model, init_fn, device, seed)
    net.load_state_dict(ckpt_lib.restore_checkpoint_host(model_dir,
                                                         step)["params"])
    return evaluate(build_eval_step(net, loss_fn), None, eval_input_fn,
                    partial(to_device, device=device), eval_steps)


def continuous_eval(runtime, experiment, poll_secs: float = DEFAULT_POLL_SECS,
                    idle_timeout_secs: Optional[float] = None,
                    device=None) -> dict:
    """Evaluate checkpoints as they appear; returns the last metrics.
    `runtime` is the launched evaluator's (`tasks._bootstrap.TaskRuntime`,
    None in process); `device` defaults to `_device.task_device()`."""
    if idle_timeout_secs is None:
        idle_timeout_secs = float(
            os.environ.get(ENV_IDLE_TIMEOUT, DEFAULT_IDLE_TIMEOUT_SECS))
    core = as_core_experiment(experiment)
    if not core.model_dir:
        raise ValueError("continuous evaluation needs an experiment model_dir")
    fs_lib.check_model_dir_placement(core.model_dir)
    device = task_device() if device is None else resolve_device(device)
    eval_input_fn = core.eval_input_fn or core.train_input_fn
    model = _eval_model(core.model, core.init_fn, device,
                        core.train_params.seed)
    eval_step = build_eval_step(model, core.loss_fn)
    place = partial(to_device, device=device)

    # One callable or a sequence of them.
    if core.exporters is None:
        exporter_fns = []
    elif callable(core.exporters):
        exporter_fns = [core.exporters]
    else:
        exporter_fns = list(core.exporters)

    done = evaluated_steps(core.model_dir)
    final_step = core.train_params.train_steps
    last_metrics: dict = {}
    last_new = time.time()
    awake_time = 0.0
    start_time = time.time()
    nb_eval_steps = 0
    n_try = runtime.n_try if runtime is not None else 0

    def broadcast_health(eval_elapsed: float, n_batches: int, step: int) -> None:
        if runtime is None:
            return
        total = max(time.time() - start_time, 1e-9)
        stats = {
            "awake_time_ratio": f"{awake_time / total:.4f}",
            "eval_step_mean_duration": f"{eval_elapsed / max(n_batches, 1):.4f}",
            "last_training_step": str(step),
            "nb_eval_steps": str(nb_eval_steps),
        }
        for key, value in stats.items():
            event.broadcast(runtime.kv, f"{runtime.task}/{key}", value)

    while True:
        pending = [s for s in ckpt_lib.list_checkpoint_steps(core.model_dir)
                   if s not in done]
        for step in pending:
            t0 = time.time()
            try:
                params = ckpt_lib.restore_checkpoint_host(
                    core.model_dir, step)["params"]
            except Exception as exc:  # deleted or torn; retry next poll
                _logger.warning("could not restore ckpt-%d yet: %s", step, exc)
                continue
            model.load_state_dict(params)

            # Count the batches really consumed (the input may be shorter
            # than eval_steps) so the health metrics stay honest.
            consumed = {"n": 0}

            def counted_input():
                for batch in eval_input_fn():
                    consumed["n"] += 1
                    yield batch

            metrics = evaluate(eval_step, None, counted_input, place,
                               core.train_params.eval_steps)
            elapsed = time.time() - t0
            awake_time += elapsed
            nb_eval_steps += consumed["n"]
            for exporter in exporter_fns:
                try:
                    exporter(params, metrics, step)
                except Exception:
                    _logger.exception("exporter failed for ckpt-%d", step)
            last_metrics = metrics
            done.add(step)
            last_new = time.time()
            _mark_evaluated(core.model_dir, step, metrics)
            _logger.info("evaluated ckpt-%d: %s (%.1fs)", step, metrics, elapsed)
            for key, value in metrics.items():
                mlflow.log_metric(f"eval_{key}_{n_try}", value, step=step)
            broadcast_health(elapsed, consumed["n"], step)

        if any(s >= final_step for s in done):
            _logger.info("final checkpoint (step %d) evaluated; stopping",
                         final_step)
            break
        if _training_finished(runtime):
            # Training ended early (input exhausted before train_steps):
            # re-list to catch a final checkpoint written just before the
            # stop event, then finish without the idle wait.
            remaining = [s for s in ckpt_lib.list_checkpoint_steps(
                core.model_dir) if s not in done]
            if not remaining:
                _logger.info("training stopped and no pending ckpts; stopping")
                break
        if time.time() - last_new > idle_timeout_secs:
            _logger.info("no new checkpoint for %.0fs; stopping",
                         idle_timeout_secs)
            break
        time.sleep(poll_secs)
    return last_metrics


def _training_finished(runtime) -> bool:
    """True when every chief/worker has broadcast its stop event."""
    if runtime is None:
        return False
    primaries = [ti for ti in runtime.cluster_tasks
                 if ti.key.type in ("chief", "worker")]
    return bool(primaries) and all(
        runtime.kv.get(f"{ti.to_kv_str()}/{event.STOP}") is not None
        for ti in primaries)
