"""Task program for the ``serving`` task type — counterpart of
tf_yarn_tpu/tasks/serving.py.

An online `/v1/generate` replica: `experiment.run_experiment` sends
the `ServingExperiment` to `serving.server.run_serving`, which restores
the checkpoint, serves the slot grid and advertises
``{task}/serving_endpoint``.

`_bootstrap.run_replica` is its main, with the lifecycle events,
heartbeat and failure classification of the worker program: a crashed
replica is classified through its stop event and retried by the
driver's RetryPolicy, and the heartbeat watchdog turns a wedged replica
into a LOST_TASK. SIGTERM (a
preemption notice) sets the drain flag the body polls: ``/healthz``
answers "draining" at once and the task exits cleanly. The replica's
device is the model's, which the experiment fn builds on
`_device.task_device()` (the card, unless ``TPU_YARN_PLATFORM=cpu``).
With ``mesh_spec=MeshSpec(tp=N)`` the task is rank 0 of a tensor-parallel
replica: `run_serving` starts its N-1 followers (`serving.tp_replica`,
one task = one replica, as JAX's ``serving_topology(chips_per_host=N)``)
and stops them on its way out, and `_bootstrap.run_replica` closes any
left on every other exit path.
"""

from __future__ import annotations

from tf_yarn_tpu_torch.tasks import _bootstrap


def _run(runtime: _bootstrap.TaskRuntime, experiment) -> None:
    from tf_yarn_tpu_torch import experiment as experiment_mod

    if not isinstance(experiment, experiment_mod.ServingExperiment):
        raise TypeError(
            f"serving tasks expect a ServingExperiment, got "
            f"{type(experiment)!r}"
        )
    experiment_mod.run_experiment(runtime, experiment)


def main() -> None:
    _bootstrap.run_replica("serve", _run)


if __name__ == "__main__":
    main()
