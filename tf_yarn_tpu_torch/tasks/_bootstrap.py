"""Shared task-program bootstrap and shutdown — a copy of
tf_yarn_tpu/tasks/_bootstrap.py: connect to the coordination service,
publish the start-time and log-location events, and on the way out the
stop event (with the failure's kind and traceback) and the stop time,
exiting nonzero so the backend's process status agrees with the events.
`wait_for_all_stops` is the tensorboard task's barrier on training's
end. `run_replica` is the whole main of the serving, prefill, rank and router
task programs.
"""

from __future__ import annotations

import logging
import sys
from contextlib import contextmanager
from typing import Callable, Iterator, List, NamedTuple, Optional

from tf_yarn_tpu_torch import _task_commons, event
from tf_yarn_tpu_torch.coordination.kv import KVClient
from tf_yarn_tpu_torch.topologies import TaskInstance, TaskKey

_logger = logging.getLogger(__name__)


class TaskRuntime(NamedTuple):
    kv: KVClient
    task_key: TaskKey
    task: str  # "type:id"
    cluster_tasks: List[TaskInstance]
    n_try: int


def init_runtime(need_cluster: bool = True) -> TaskRuntime:
    _task_commons.setup_logging()
    kv = _task_commons.connect_kv()
    task_key = _task_commons.get_task_key()
    task = task_key.to_kv_str()
    _task_commons.setup_task_logs(kv, task)
    cluster_tasks = _task_commons.get_cluster_tasks(kv) if need_cluster else []
    return TaskRuntime(kv, task_key, task, cluster_tasks, _task_commons.n_try())


@contextmanager
def reporting_shutdown(runtime: TaskRuntime) -> Iterator[None]:
    """Publish stop/stop-time events no matter how the body ends; re-exit
    nonzero on failure so ClusterHandle.status() sees FAILED too."""
    failure: Optional[BaseException] = None
    try:
        yield
    except BaseException as exc:  # noqa: B036 — report then re-raise
        failure = exc
    finally:
        event.stop_event(runtime.kv, runtime.task, failure)
        event.stop_time_event(runtime.kv, runtime.task)
    if failure is not None:
        _logger.exception("task %s failed", runtime.task, exc_info=failure)
        sys.exit(1)


def wait_for_all_stops(
    runtime: TaskRuntime, timeout_per_task: float = 3600.0
) -> None:
    """Barrier on every cluster task's `stop` event: keeps a side-car
    (the tensorboard task) alive until training ends."""
    for instance in runtime.cluster_tasks:
        peer = instance.to_kv_str()
        if peer != runtime.task:
            event.wait(runtime.kv, f"{peer}/{event.STOP}", timeout=timeout_per_task)


def run_replica(name: str, body: Callable[[TaskRuntime, object], None]) -> None:
    """Main of a replica's task program (serving, prefill, rank, router;
    JAX tasks/{serving,prefill,rank,router}.py): install the preemption
    handler (SIGTERM sets the drain flag the body polls), bootstrap, pull the
    experiment, publish the start event and run ``body(runtime,
    experiment)`` in a MonitoredThread (so the stop event carries the
    body's stack) under the task's heartbeat."""
    from tf_yarn_tpu_torch import preemption, telemetry
    from tf_yarn_tpu_torch._internal import MonitoredThread

    preemption.install()
    runtime = init_runtime()
    with reporting_shutdown(runtime):
        experiment = _task_commons.get_experiment(runtime.kv)
        event.start_event(runtime.kv, runtime.task)
        thread = MonitoredThread(target=body, args=(runtime, experiment),
                                 name=f"{name}-{runtime.task}")
        with telemetry.Heartbeat(
                runtime.kv, runtime.task,
                every=telemetry.heartbeat.every_from_env(),
                registry=telemetry.get_registry()):
            thread.start()
            thread.join()
        if thread.exception is not None:
            raise thread.exception
