"""Framework-agnostic task program: run a function per local rank —
counterpart of tf_yarn_tpu/tasks/distributed.py.

The experiment is a factory of a *function of TaskParameters*; this
program computes the ranks, elects a master address through the KV
store, starts `nb_proc_per_worker` local processes (spawn) and runs the
function in each. The function makes its own process group from the
parameters, e.g. ``torch.distributed.init_process_group("nccl",
init_method=f"tcp://{p.master_addr}:{p.master_port}", rank=p.rank,
world_size=p.world_size)``.

Select it with ``custom_task_module="tf_yarn_tpu_torch.tasks.distributed"``.
"""

from __future__ import annotations

import logging
import multiprocessing as mp
import pickle
from typing import List, NamedTuple

from tf_yarn_tpu_torch import _task_commons, event
from tf_yarn_tpu_torch._internal import dumps_fn
from tf_yarn_tpu_torch.tasks import _bootstrap

_logger = logging.getLogger(__name__)


class TaskParameters(NamedTuple):
    """Everything a rank needs to join a collective job (reference:
    distributed/task.py:28-55)."""

    task_type: str
    task_id: int
    rank: int
    local_rank: int
    world_size: int
    master_addr: str
    master_port: int
    n_workers_per_executor: int


def _child_main(fn_bytes: bytes, params: TaskParameters, error_queue) -> None:
    try:
        from tf_yarn_tpu_torch import preemption

        # Fresh interpreter (spawn): the flag/handler don't inherit — user
        # fns polling preemption.requested() need the install here.
        preemption.install()
        fn = pickle.loads(fn_bytes)
        fn(params)
    except BaseException as exc:  # noqa: B036 — ship to parent
        error_queue.put(f"local_rank {params.local_rank}: {exc!r}")
        raise


def parallel_run(fn_bytes: bytes, params_list: List[TaskParameters]) -> None:
    """Start one process per local rank (reference: distributed/task.py:63-78)
    with multiprocessing's spawn."""
    ctx = mp.get_context("spawn")
    error_queue = ctx.SimpleQueue()
    procs = [
        ctx.Process(target=_child_main, args=(fn_bytes, params, error_queue))
        for params in params_list
    ]
    for proc in procs:
        proc.start()
    for proc in procs:
        proc.join()
    failed = [p for p in procs if p.exitcode != 0]
    if failed:
        detail = (
            error_queue.get()
            if not error_queue.empty()
            else "no error captured — see this task's log file for the child traceback"
        )
        raise RuntimeError(
            f"{len(failed)}/{len(procs)} local ranks failed: {detail}"
        )


def main() -> None:
    from tf_yarn_tpu_torch import preemption

    preemption.install()  # SIGTERM -> drain flag for fns that poll it
    runtime = _bootstrap.init_runtime()
    with _bootstrap.reporting_shutdown(runtime):
        master_addr = _task_commons.choose_master(
            runtime.kv, runtime.task_key, runtime.cluster_tasks
        )
        host, _, port = master_addr.rpartition(":")
        world_size = _task_commons.compute_world_size(runtime.cluster_tasks)
        nb_proc = _task_commons.get_nb_proc()
        base_rank = _task_commons.compute_rank(
            runtime.task_key, runtime.cluster_tasks, local_rank=0
        )
        # The experiment crosses as fn_factory() -> fn(TaskParameters).
        fn = _task_commons.get_experiment(runtime.kv)
        params_list = [
            TaskParameters(
                task_type=runtime.task_key.type,
                task_id=runtime.task_key.id,
                rank=base_rank + local_rank,
                local_rank=local_rank,
                world_size=world_size,
                master_addr=host,
                master_port=int(port),
                n_workers_per_executor=nb_proc,
            )
            for local_rank in range(nb_proc)
        ]
        event.start_event(runtime.kv, runtime.task)
        event.train_eval_start_event(runtime.kv, runtime.task)
        # Same liveness beacon as the worker task program: the driver's
        # heartbeat watchdog (TPU_YARN_DEAD_TASK_SECS) covers these fns too.
        from tf_yarn_tpu_torch import telemetry

        try:
            with telemetry.Heartbeat(
                runtime.kv, runtime.task,
                every=telemetry.heartbeat.every_from_env(),
                registry=telemetry.get_registry(),
            ):
                if nb_proc == 1:
                    fn(params_list[0])
                else:
                    parallel_run(dumps_fn(fn), params_list)
        finally:
            event.train_eval_stop_event(runtime.kv, runtime.task)


if __name__ == "__main__":
    main()
