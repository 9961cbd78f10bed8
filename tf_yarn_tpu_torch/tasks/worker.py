"""Default task program for chief and worker tasks — counterpart of
tf_yarn_tpu/tasks/worker.py.

Bootstrap, pull the experiment from the KV store, run it in a
MonitoredThread under a heartbeat, and report the lifecycle events
throughout. Dispatch:

* the port's experiment types (`TorchExperiment`, `CoreExperiment`,
  `InferenceExperiment`) — `experiment.run_experiment`, on the device
  that ``TPU_YARN_PLATFORM`` names (`_device.task_device`: the card
  unless it is ``cpu``), inside a torch process group when the cluster
  has more than one chief or worker — each rank on its own card and the
  group NCCL, or gloo where the ranks share cards
  (`_device.assign_rank_device`) — where `training.train_and_evaluate`
  trains data-parallel;
* a plain callable — invoked with no args.

For a function of rank use
``custom_task_module="tf_yarn_tpu_torch.tasks.distributed"``.
"""

from __future__ import annotations

import logging

from tf_yarn_tpu_torch import _task_commons, event, telemetry
from tf_yarn_tpu_torch._internal import MonitoredThread
from tf_yarn_tpu_torch.tasks import _bootstrap

_logger = logging.getLogger(__name__)


def _maybe_init_torch_distributed(runtime: _bootstrap.TaskRuntime) -> bool:
    """Join the primaries' torch process group (the JAX program's
    `jax.distributed.initialize`, tasks/worker.py:27-82); ranks chief
    first, then workers by id. Each rank takes its card and the group
    its backend by `_device.assign_rank_device` (every primary is on
    this host with `LocalBackend`): NCCL with a card for each rank, gloo
    where they share cards or on the CPU. Only with more than one chief
    or worker, each one process. Returns whether a group was made (the
    caller destroys it)."""
    primaries = sorted(
        (ti for ti in runtime.cluster_tasks if ti.key.type in ("chief", "worker")),
        key=lambda ti: (0 if ti.key.type == "chief" else 1, ti.key.id),
    )
    if len(primaries) <= 1:
        return False
    if any(ti.nb_proc != 1 for ti in primaries):
        raise ValueError(
            "experiments need nb_proc_per_worker=1 (one process drives the "
            "host's GPUs); use tasks.distributed for multi-process-per-host "
            "jobs"
        )
    import torch.distributed as dist

    from tf_yarn_tpu_torch._device import assign_rank_device

    # torch's TCPStore binds without SO_REUSEPORT, so the reservation
    # socket cannot stay open across its bind (the JAX program holds it
    # for jax.distributed's coordinator). The port is free between the
    # reservation and the bind — the reference's documented compromise.
    addr = _task_commons.choose_master(
        runtime.kv, runtime.task_key, runtime.cluster_tasks
    )
    rank = [ti.key for ti in primaries].index(runtime.task_key)
    _, backend = assign_rank_device(rank, len(primaries))
    dist.init_process_group(
        backend=backend, init_method=f"tcp://{addr}", rank=rank,
        world_size=len(primaries),
    )
    _logger.info("torch.distributed up (%s): rank %d/%d, master %s",
                 backend, rank, len(primaries), addr)
    return True


def _run_experiment(runtime: _bootstrap.TaskRuntime, experiment) -> None:
    from tf_yarn_tpu_torch import experiment as experiment_mod

    if isinstance(experiment, experiment_mod.EXPERIMENT_TYPES):
        grouped = _maybe_init_torch_distributed(runtime)
        try:
            experiment_mod.run_experiment(runtime, experiment)
        finally:
            if grouped:
                import torch.distributed as dist

                dist.destroy_process_group()
    elif callable(experiment):
        experiment()
    else:
        raise TypeError(
            f"unsupported experiment type {type(experiment)!r}; expected one "
            f"of {experiment_mod.EXPERIMENT_TYPES} or a callable (for a "
            "function of rank use custom_task_module="
            '"tf_yarn_tpu_torch.tasks.distributed")'
        )


def main() -> None:
    from tf_yarn_tpu_torch import preemption

    # Main thread, before the train thread exists: SIGTERM (a preemption
    # notice) sets the drain flag.
    preemption.install()
    runtime = _bootstrap.init_runtime()
    with _bootstrap.reporting_shutdown(runtime):
        experiment = _task_commons.get_experiment(runtime.kv)
        event.start_event(runtime.kv, runtime.task)
        event.train_eval_start_event(runtime.kv, runtime.task)
        # A MonitoredThread, so the captured exception carries the
        # training stack.
        thread = MonitoredThread(
            target=_run_experiment,
            args=(runtime, experiment),
            name=f"train-{runtime.task}",
        )
        # Liveness + metrics beacon for the whole experiment: the driver's
        # watchdog turns silence past TPU_YARN_DEAD_TASK_SECS into a
        # LOST_TASK failure, and the {task}/metrics snapshot rides along.
        # TPU_YARN_HEARTBEAT_SECS=0 disables; a clean stop publishes a
        # heartbeat.stopped tombstone.
        with telemetry.Heartbeat(
            runtime.kv, runtime.task,
            every=telemetry.heartbeat.every_from_env(),
            registry=telemetry.get_registry(),
        ):
            thread.start()
            thread.join()
        event.train_eval_stop_event(runtime.kv, runtime.task)
        if thread.exception is not None:
            raise thread.exception


if __name__ == "__main__":
    main()
