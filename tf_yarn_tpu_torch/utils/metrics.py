"""Run metrics: fold the lifecycle-event stream into wall-time numbers —
a copy of tf_yarn_tpu/utils/metrics.py.

`handle_events` reads the run's KV state into `Metrics` (container and
train/eval durations) and one `TaskOutcome` a task (with its failure
kind); `collect_task_metrics` reads the tasks' ``{task}/metrics``
snapshots; `task_heartbeats`/`stopped_heartbeats` their liveness.
"""

from __future__ import annotations

import json
import logging
import time
from typing import Dict, List, NamedTuple, Optional, Tuple

from tf_yarn_tpu_torch import event
from tf_yarn_tpu_torch.backends import PRIMARY_TASK_TYPES
from tf_yarn_tpu_torch.coordination.kv import KVStore
from tf_yarn_tpu_torch.resilience.taxonomy import FailureKind, classify_stop_payload
from tf_yarn_tpu_torch.utils import mlflow

_logger = logging.getLogger(__name__)


class Metrics(NamedTuple):
    """Wall-time metrics returned to the `run_on_gpu` caller
    (reference: metrics.py:19-38)."""

    total_training_duration: Optional[float]
    total_eval_duration: Optional[float]
    container_duration: Dict[str, Optional[float]]
    train_eval_time_per_node: Dict[str, Optional[float]]

    def log_mlflow(self, n_try: int = 0) -> None:
        metrics = {
            f"total_training_duration_{n_try}": self.total_training_duration,
            f"total_eval_duration_{n_try}": self.total_eval_duration,
        }
        for task, duration in self.container_duration.items():
            metrics[f"container_duration_{task}_{n_try}"] = duration
        for task, duration in self.train_eval_time_per_node.items():
            metrics[f"train_eval_time_per_node_{task}_{n_try}"] = duration
        for key, value in metrics.items():
            if value is not None:
                mlflow.log_metric(key, value)


class TaskOutcome(NamedTuple):
    """Final state of one task, derived from its event set
    (reference: client.py:660-695). `kind` is the failure classification
    the task serialized through its stop event (resilience.taxonomy) —
    None for non-failures."""

    status: str  # SUCCEEDED | FAILED | KILLED | REQUESTED
    exception: str  # traceback text, "" on success
    kind: Optional["FailureKind"] = None


def _get_float(kv_snapshot: Dict[str, str], key: str) -> Optional[float]:
    raw = kv_snapshot.get(key)
    try:
        return float(raw) if raw is not None else None
    except ValueError:
        return None


def handle_events(
    kv: KVStore, tasks: List[str]
) -> Tuple[Metrics, Dict[str, TaskOutcome]]:
    """Compute Metrics + per-task outcomes from the KV event state.

    Mirrors `_handle_events` (reference: client.py:660-739): container
    durations from start/stop timer events; training duration = min
    train_eval start → max stop over chief+workers; eval duration from the
    evaluator task; tasks with no events at all are REQUESTED, started-but-
    never-stopped tasks are KILLED.
    """
    snapshot: Dict[str, str] = {}
    for key in kv.keys():
        if "/" not in key:  # non-event payloads (pickled experiment, layout)
            continue
        raw = kv.get(key)
        if raw is not None:
            snapshot[key] = raw.decode("utf-8", errors="replace")

    outcomes: Dict[str, TaskOutcome] = {}
    container_duration: Dict[str, Optional[float]] = {}
    train_eval: Dict[str, Optional[float]] = {}
    train_starts: List[float] = []
    train_stops: List[float] = []
    eval_starts: List[float] = []
    eval_stops: List[float] = []

    for task in tasks:
        started = any(
            f"{task}/{stage}" in snapshot
            for stage in (event.START, event.INIT, event.CONTAINER_START_TIME)
        )
        stop_payload = snapshot.get(f"{task}/{event.STOP}")
        if stop_payload is None:
            outcomes[task] = TaskOutcome("KILLED" if started else "REQUESTED", "")
        elif stop_payload == "":
            outcomes[task] = TaskOutcome("SUCCEEDED", "")
        else:
            # The payload leads with a failure-kind marker when the task
            # classified its own death (resilience.taxonomy); strip it so
            # callers see plain traceback text, keep the kind first-class.
            kind, text = classify_stop_payload(stop_payload)
            outcomes[task] = TaskOutcome("FAILED", text, kind)

        c_start = _get_float(snapshot, f"{task}/{event.CONTAINER_START_TIME}")
        c_stop = _get_float(snapshot, f"{task}/{event.CONTAINER_STOP_TIME}")
        container_duration[task] = (
            c_stop - c_start if c_start is not None and c_stop is not None else None
        )

        t_start = _get_float(snapshot, f"{task}/{event.TRAIN_EVAL_START_TIME}")
        t_stop = _get_float(snapshot, f"{task}/{event.TRAIN_EVAL_STOP_TIME}")
        train_eval[task] = (
            t_stop - t_start if t_start is not None and t_stop is not None else None
        )
        task_type = task.split(":", 1)[0]
        if t_start is not None and t_stop is not None:
            if task_type in PRIMARY_TASK_TYPES:
                train_starts.append(t_start)
                train_stops.append(t_stop)
            elif task_type == "evaluator":
                eval_starts.append(t_start)
                eval_stops.append(t_stop)

    metrics = Metrics(
        total_training_duration=(
            max(train_stops) - min(train_starts) if train_starts else None
        ),
        total_eval_duration=(
            max(eval_stops) - min(eval_starts) if eval_starts else None
        ),
        container_duration=container_duration,
        train_eval_time_per_node=train_eval,
    )
    return metrics, outcomes


def collect_task_metrics(
    kv: KVStore, tasks: List[str]
) -> Dict[str, Dict[str, float]]:
    """Latest telemetry-registry snapshot each task published via
    ``event.metrics_event`` ({task}/metrics JSON) — the chief-side
    aggregation seam for per-host step-time breakdowns, decode-engine
    counters, checkpoint durations, etc. Tasks that never published (or
    published garbage) are simply absent."""
    out: Dict[str, Dict[str, float]] = {}
    for task in tasks:
        raw = kv.get_str(f"{task}/{event.METRICS}")
        if not raw:
            continue
        try:
            snap = json.loads(raw)
        except ValueError:
            _logger.warning("unparseable %s/%s payload", task, event.METRICS)
            continue
        if isinstance(snap, dict):
            out[task] = snap
    return out


def task_heartbeats(
    kv: KVStore, tasks: List[str], now: Optional[float] = None
) -> Dict[str, Optional[float]]:
    """Age in seconds of each task's last heartbeat (None = never beat).
    A straggling/wedged worker shows as a growing age from the chief
    long before its container times out.

    Tasks that published a ``heartbeat.stopped`` tombstone (clean
    Heartbeat shutdown) are EXCLUDED: finished is not a liveness concern,
    and before the tombstone a finished task and a dead one both looked
    like a growing age. ``stopped_heartbeats`` lists them."""
    from tf_yarn_tpu_torch.telemetry.heartbeat import heartbeat_age

    now = time.time() if now is None else now
    return {
        task: heartbeat_age(kv.get_str(f"{task}/{event.HEARTBEAT}"), now=now)
        for task in tasks
        if kv.get_str(f"{task}/{event.HEARTBEAT_STOPPED}") is None
    }


def stopped_heartbeats(kv: KVStore, tasks: List[str]) -> List[str]:
    """Tasks that cleanly tombstoned their heartbeat (finished, not dead)."""
    return [
        task for task in tasks
        if kv.get_str(f"{task}/{event.HEARTBEAT_STOPPED}") is not None
    ]


class OneShotMetricsLogger:
    """Log KV-advertised values once each (reference: metrics.py:41-59);
    used for the TensorBoard URL."""

    def __init__(self, kv: KVStore, events: List[Tuple[str, str]], n_try: int = 0):
        self._kv = kv
        self._pending = list(events)
        self._n_try = n_try

    def log(self) -> None:
        remaining = []
        for key, label in self._pending:
            value = self._kv.get_str(key)
            if value is not None:
                _logger.info("%s %s", label, value)
                mlflow.set_tag(f"{label}_{self._n_try}", value)
            else:
                remaining.append((key, label))
        self._pending = remaining
