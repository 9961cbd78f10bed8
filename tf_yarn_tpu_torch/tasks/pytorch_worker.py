"""The PyTorch task program: DDP workers — counterpart of
tf_yarn_tpu/tasks/pytorch_worker.py.

The reference's per-container pytorch worker (reference:
pytorch/tasks/worker.py:94-218): the world size from the cluster layout,
the master elected through the KV store, one process per local rank
(``nb_proc_per_worker`` > 1 through `tasks.distributed.parallel_run`),
``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK`` exported,
`init_process_group`, the model moved to the rank's device
(`pytorch.get_device`: its card, or the CPU under
``TPU_YARN_PLATFORM=cpu``) and wrapped in `DistributedDataParallel` when
the world has more than one rank, a `DistributedSampler` loader (or an
IterableDataset's own), then the user's ``main_fn(model, loader, device,
rank, tb_writer)`` with the TensorBoard writer on rank 0, whose event
files it uploads to ``tensorboard_remote_dir`` (a path or any `fs` URI)
after training. The lifecycle events are the JAX program's, with
`preemption.install` first.

Select it with ``custom_task_module="tf_yarn_tpu_torch.tasks.pytorch_worker"``
(`pytorch.run_on_gpu` does).
"""

from __future__ import annotations

import functools
import logging
import os
from typing import Optional

from tf_yarn_tpu_torch import _task_commons, event
from tf_yarn_tpu_torch._internal import dumps_fn
from tf_yarn_tpu_torch.tasks import _bootstrap
from tf_yarn_tpu_torch.tasks.distributed import TaskParameters, parallel_run

_logger = logging.getLogger(__name__)


def _make_tb_writer(log_dir: Optional[str]):
    if not log_dir:
        return None
    try:
        from torch.utils.tensorboard import SummaryWriter

        return SummaryWriter(log_dir=log_dir)
    except Exception:
        return None


def make_loader(experiment, params: TaskParameters):
    """The rank's DataLoader (reference worker.py:50-92): a
    `DistributedSampler` over a map-style dataset; an IterableDataset
    shards itself, and one that shows no sign of it (no ``rank``,
    ``world_size`` or ``shards_by_rank``) is logged at WARNING, since
    every rank then reads all of it."""
    from torch.utils.data import DataLoader, IterableDataset
    from torch.utils.data.distributed import DistributedSampler

    args = experiment.dataloader_args
    dataset = experiment.train_dataset
    if isinstance(dataset, IterableDataset):
        if params.world_size > 1 and not (
            hasattr(dataset, "rank")
            or hasattr(dataset, "world_size")
            or getattr(dataset, "shards_by_rank", False)
        ):
            _logger.warning(
                "IterableDataset %s exposes no rank/world_size "
                "attributes; every rank will iterate the whole "
                "dataset. Shard inside the dataset (e.g. "
                "data.torch_adapter.TorchParquetDataset) for "
                "distributed training.", type(dataset).__name__,
            )
        loader_kwargs = dict(num_workers=args.num_workers,
                             pin_memory=args.pin_memory)
        if getattr(dataset, "yields_batches", False):
            loader_kwargs["batch_size"] = None
        else:
            loader_kwargs["batch_size"] = args.batch_size
            loader_kwargs["drop_last"] = True
    else:
        sampler = DistributedSampler(dataset, num_replicas=params.world_size,
                                     rank=params.rank, shuffle=args.shuffle)
        loader_kwargs = dict(batch_size=args.batch_size, sampler=sampler,
                             num_workers=args.num_workers,
                             pin_memory=args.pin_memory, drop_last=True)
    if args.prefetch_factor is not None and args.num_workers > 0:
        loader_kwargs["prefetch_factor"] = args.prefetch_factor
    return DataLoader(dataset, **loader_kwargs)


def _train_one_rank(experiment, params: TaskParameters) -> None:
    """Body run in each local-rank process (reference _train,
    worker.py:94-122)."""
    import torch
    import torch.distributed as dist

    from tf_yarn_tpu_torch import pytorch as pt

    os.environ.setdefault("MASTER_ADDR", params.master_addr)
    os.environ.setdefault("MASTER_PORT", str(params.master_port))
    os.environ["RANK"] = str(params.rank)
    os.environ["WORLD_SIZE"] = str(params.world_size)
    os.environ["LOCAL_RANK"] = str(params.local_rank)
    device = pt.get_device()
    if device.type == "cuda":
        torch.cuda.set_device(device)
    backend = experiment.backend or pt.collective_backend()
    dist.init_process_group(backend=backend, rank=params.rank,
                            world_size=params.world_size)
    _logger.info("rank %d/%d on %s, process group %s", params.rank,
                 params.world_size, device, dist.get_backend())
    try:
        model = experiment.model.to(device)
        if params.world_size > 1:
            from torch.nn.parallel import DistributedDataParallel

            model = DistributedDataParallel(
                model,
                device_ids=[device.index] if device.type == "cuda" else None,
                find_unused_parameters=experiment.ddp_args.find_unused_parameters,
                gradient_as_bucket_view=experiment.ddp_args.gradient_as_bucket_view,
            )
        loader = make_loader(experiment, params)
        tb_writer = _make_tb_writer(
            experiment.tensorboard_log_dir if params.rank == 0 else None)
        try:
            experiment.main_fn(model, loader, device, params.rank, tb_writer)
        finally:
            if tb_writer is not None:
                tb_writer.close()
            if (params.rank == 0 and experiment.tensorboard_log_dir
                    and experiment.tensorboard_remote_dir):
                _upload_tb_logs(experiment.tensorboard_log_dir,
                                experiment.tensorboard_remote_dir)
    finally:
        dist.destroy_process_group()


def _upload_tb_logs(local_dir: str, remote_dir: str) -> None:
    """Rank 0 uploads its TB event files to `remote_dir` after training
    (reference: pytorch/tasks/worker.py:145-152)."""
    try:
        from tf_yarn_tpu_torch.packaging import upload_dir

        upload_dir(local_dir, remote_dir)
    except Exception:
        _logger.exception("tensorboard log upload to %s failed", remote_dir)


def main() -> None:
    from tf_yarn_tpu_torch import preemption

    # SIGTERM -> drain flag; a main_fn polls preemption.requested().
    # (nb_proc > 1 children get their own install in distributed._child_main.)
    preemption.install()
    runtime = _bootstrap.init_runtime()
    with _bootstrap.reporting_shutdown(runtime):
        experiment = _task_commons.get_experiment(runtime.kv)
        master_addr = _task_commons.choose_master(
            runtime.kv, runtime.task_key, runtime.cluster_tasks
        )
        host, _, port = master_addr.rpartition(":")
        world_size = _task_commons.compute_world_size(runtime.cluster_tasks)
        nb_proc = _task_commons.get_nb_proc()
        base_rank = _task_commons.compute_rank(
            runtime.task_key, runtime.cluster_tasks, local_rank=0
        )
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
        try:
            if nb_proc == 1:
                _train_one_rank(experiment, params_list[0])
            else:
                parallel_run(
                    dumps_fn(functools.partial(_train_one_rank, experiment)),
                    params_list)
        finally:
            event.train_eval_stop_event(runtime.kv, runtime.task)


if __name__ == "__main__":
    main()
