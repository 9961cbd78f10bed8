"""Shared task-program bootstrap and shutdown — a copy of
tf_yarn_tpu/tasks/_bootstrap.py: connect to the coordination service,
publish the start-time and log-location events, and on the way out the
stop event (with the failure's kind and traceback) and the stop time,
exiting nonzero so the backend's process status agrees with the events.
"""

from __future__ import annotations

import logging
import sys
from contextlib import contextmanager
from typing import Iterator, List, NamedTuple, Optional

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

