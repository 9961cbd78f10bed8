"""Task program for the ``prefill`` task type — counterpart of
tf_yarn_tpu/tasks/prefill.py.

A replica of the disaggregated prefill tier: it reads the same
`ServingExperiment` as its decode replicas (model, checkpoint, paged
block geometry) and runs `serving.prefill.run_prefill`, which advertises
``{task}/prefill_endpoint``; a decode replica whose ship fails prefills
locally.

`_bootstrap.run_replica` is its main, with the lifecycle events,
heartbeat and failure classification of the worker program: a crashed
replica is classified through its stop event and retried by the
driver's RetryPolicy, and the heartbeat watchdog turns a wedged replica
into a LOST_TASK. SIGTERM (a
preemption notice) sets the drain flag the body polls: ``/healthz``
answers "draining" at once and the task exits cleanly. The replica's
device is the model's, which the experiment fn builds on
`_device.task_device()` (the card, unless ``TPU_YARN_PLATFORM=cpu``).
A tp ``mesh_spec`` makes the task rank 0 of a tensor-parallel prefill
replica, as for the serving task (tasks/serving.py).
"""

from __future__ import annotations

from tf_yarn_tpu_torch.tasks import _bootstrap


def _run(runtime: _bootstrap.TaskRuntime, experiment) -> None:
    from tf_yarn_tpu_torch import experiment as experiment_mod
    from tf_yarn_tpu_torch.serving.prefill import run_prefill

    if not isinstance(experiment, experiment_mod.ServingExperiment):
        raise TypeError(
            f"prefill tasks expect a ServingExperiment, got "
            f"{type(experiment)!r}"
        )
    run_prefill(experiment, runtime=runtime)


def main() -> None:
    _bootstrap.run_replica("prefill", _run)


if __name__ == "__main__":
    main()
