"""Task program for the ``evaluator`` task type — counterpart of
tf_yarn_tpu/tasks/evaluator.py.

The side-car evaluator: pull the experiment, poll its model_dir and
evaluate every checkpoint once (`evaluation.continuous_eval`),
broadcasting health metrics, until the final checkpoint is evaluated,
training has stopped with nothing pending, or the idle timeout passes.
It runs on `_device.task_device()`: the CPU unless the launch's env
sets ``TPU_YARN_PLATFORM``.
"""

from __future__ import annotations

from tf_yarn_tpu_torch import _task_commons, event
from tf_yarn_tpu_torch.tasks import _bootstrap


def main() -> None:
    runtime = _bootstrap.init_runtime()
    with _bootstrap.reporting_shutdown(runtime):
        experiment = _task_commons.get_experiment(runtime.kv)
        event.start_event(runtime.kv, runtime.task)
        event.train_eval_start_event(runtime.kv, runtime.task)
        try:
            from tf_yarn_tpu_torch.evaluation import continuous_eval

            continuous_eval(runtime, experiment)
        finally:
            event.train_eval_stop_event(runtime.kv, runtime.task)


if __name__ == "__main__":
    main()
