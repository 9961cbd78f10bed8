"""Task program for the ``rank`` task type — counterpart of
tf_yarn_tpu/tasks/rank.py.

An online `/v1/rank` replica: `experiment.run_experiment` sends the
`RankingExperiment` to `ranking.server.run_ranking`, which restores (or
draws the seeded init), warms up, serves and advertises
``{task}/rank_endpoint``.

`_bootstrap.run_replica` is its main, with the lifecycle events,
heartbeat and failure classification of the worker program: a crashed
replica is classified through its stop event and retried by the
driver's RetryPolicy, and the heartbeat watchdog turns a wedged replica
into a LOST_TASK. SIGTERM (a
preemption notice) sets the drain flag the body polls: ``/healthz``
answers "draining" at once and the task exits cleanly. The replica's
device is the model's, which the experiment fn builds on
`_device.task_device()` (the card, unless ``TPU_YARN_PLATFORM=cpu``).
Under ``mesh_spec=MeshSpec(tp=N)`` (`topologies.ranking_topology(
chips_per_host=N)`) the task is the leader of a tp replica whose N-1
followers it spawns; on one card the ranks share it over gloo
(`_device.assign_rank_device`), and `_bootstrap` closes the group on
the task's way out.
"""

from __future__ import annotations

from tf_yarn_tpu_torch.tasks import _bootstrap


def _run(runtime: _bootstrap.TaskRuntime, experiment) -> None:
    from tf_yarn_tpu_torch import experiment as experiment_mod

    if not isinstance(experiment, experiment_mod.RankingExperiment):
        raise TypeError(
            f"rank tasks expect a RankingExperiment, got "
            f"{type(experiment)!r}"
        )
    experiment_mod.run_experiment(runtime, experiment)


def main() -> None:
    _bootstrap.run_replica("rank", _run)


if __name__ == "__main__":
    main()
