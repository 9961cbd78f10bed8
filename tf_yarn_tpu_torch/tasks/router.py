"""Task program for the ``router`` task type — counterpart of
tf_yarn_tpu/tasks/router.py.

The fleet frontend beside tasks/serving.py: bootstrap, pull the
`ServingExperiment` from the KV store (the router reads its ``router_*``,
``autoscale*``, ``slo``, ``retry_after_s`` and ``serve_seconds`` knobs
from the experiment the replicas serve) and run
`fleet.router.run_router` under the lifecycle events, heartbeat and
failure classification of the replicas (`_bootstrap.run_replica`): a
crashed router is classified through its stop event and relaunched by
the driver's RetryPolicy, and the heartbeat watchdog turns a wedged
router into a LOST_TASK.

The router never runs the model: in a ``router:*`` task
`_device.task_device()` is the meta device, so the experiment fn builds
the model's shapes only, with no weights and no CUDA context. SIGTERM
(a preemption notice) sets the drain flag the router's loop polls and
its ``/healthz`` answers "draining".
"""

from __future__ import annotations

from tf_yarn_tpu_torch.tasks import _bootstrap


def _run(runtime: _bootstrap.TaskRuntime, experiment) -> None:
    from tf_yarn_tpu_torch import experiment as experiment_mod
    from tf_yarn_tpu_torch.fleet.router import run_router

    if not isinstance(experiment, experiment_mod.ServingExperiment):
        raise TypeError(
            f"router tasks expect a ServingExperiment, got "
            f"{type(experiment)!r}"
        )
    run_router(experiment, runtime=runtime)


def main() -> None:
    _bootstrap.run_replica("route", _run)


if __name__ == "__main__":
    main()
