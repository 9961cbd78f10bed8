"""Task program for the ``tensorboard`` task type — counterpart of
tf_yarn_tpu/tasks/tensorboard.py.

Serve TensorBoard on the run's model_dir (``TB_MODEL_DIR``, else the
experiment's ``model_dir``), advertise the URL, stay up until every
training task has stopped, then linger ``TB_TERMINATION_TIMEOUT_SECONDS``
so users can still browse. Where tensorboard does not import, the task
advertises nothing and still waits, as the JAX task does.
"""

from __future__ import annotations

import logging
import os
import time

from tf_yarn_tpu_torch import _task_commons, event
from tf_yarn_tpu_torch.tasks import _bootstrap
from tf_yarn_tpu_torch.utils import tensorboard_utils

_logger = logging.getLogger(__name__)


def _resolve_model_dir(runtime: _bootstrap.TaskRuntime) -> str:
    """TB_MODEL_DIR wins; otherwise the experiment's model_dir."""
    model_dir = os.environ.get("TB_MODEL_DIR")
    if model_dir:
        return model_dir
    experiment = _task_commons.get_experiment(runtime.kv)
    model_dir = getattr(experiment, "model_dir", None)
    if not model_dir:
        raise ValueError(
            "no model_dir: set TaskSpec.tb_model_dir or use an experiment "
            "type with a model_dir attribute"
        )
    return model_dir


def main() -> None:
    runtime = _bootstrap.init_runtime()
    with _bootstrap.reporting_shutdown(runtime):
        model_dir = _resolve_model_dir(runtime)
        event.start_event(runtime.kv, runtime.task)
        tensorboard_utils.start_tf_board(runtime.kv, runtime.task, model_dir)
        _bootstrap.wait_for_all_stops(runtime)
        timeout = tensorboard_utils.get_termination_timeout()
        _logger.info("training done; lingering %d s", timeout)
        time.sleep(timeout)


if __name__ == "__main__":
    main()
