"""The PyTorch experiment surface — counterpart of tf_yarn_tpu/pytorch.py.

`PytorchExperiment` (reference: pytorch/experiment.py:30-56),
`DataLoaderArgs` (:6-20), `DistributedDataParallelArgs` (:23-27) and the
`run_on_gpu` wrapper that defaults the task program to the port's
pytorch worker (`tasks.pytorch_worker`; reference: pytorch/client.py:12-18).
The user's ``main_fn(model, loader, device, rank, tb_writer)`` gets a
model wrapped in `DistributedDataParallel` when the world has more than
one rank, a `DistributedSampler` loader, the rank's device and, on rank
0, a TensorBoard writer.

The collective backend is NCCL when the task's device is the card, and
gloo on the CPU (`collective_backend`); ``experiment.backend`` wins over
it, as in the JAX package — ranks that share one card need ``"gloo"``,
since NCCL refuses two ranks on one device. `get_device` is the rank's
card by `_device.rank_card` (the reference's `_get_device` picks CUDA
round robin, worker.py:162-168), or the CPU under
``TPU_YARN_PLATFORM=cpu``.

``drop_last=False`` is refused with the JAX package's message, so a
`DataLoaderArgs` that one package takes the other takes too.
``tensorboard_remote_dir`` is where rank 0 uploads its event files
after training: a path or any URI `fs` resolves.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable, Dict, Optional

import torch

from tf_yarn_tpu_torch import client as _client
from tf_yarn_tpu_torch.topologies import TaskSpecs

PYTORCH_TASK_MODULE = "tf_yarn_tpu_torch.tasks.pytorch_worker"


@dataclasses.dataclass
class DataLoaderArgs:
    """reference: pytorch/experiment.py:6-20 (drop_last enforced True)."""

    batch_size: int = 32
    num_workers: int = 0
    pin_memory: bool = False
    drop_last: bool = True
    shuffle: bool = True
    prefetch_factor: Optional[int] = None

    def __post_init__(self) -> None:
        if not self.drop_last:
            raise ValueError(
                "drop_last=False is not supported on XLA: uneven final "
                "batches change compile shapes every epoch"
            )


@dataclasses.dataclass
class DistributedDataParallelArgs:
    """reference: pytorch/experiment.py:23-27."""

    find_unused_parameters: bool = False
    gradient_as_bucket_view: bool = False


@dataclasses.dataclass
class PytorchExperiment:
    model: Any
    # main_fn(model, train_loader, device, rank, tb_writer)
    main_fn: Callable
    train_dataset: Any
    dataloader_args: DataLoaderArgs = dataclasses.field(
        default_factory=DataLoaderArgs)
    tensorboard_log_dir: Optional[str] = None
    # Rank 0 uploads its TB event files here after training: a path or
    # any fs URI (reference: pytorch/tasks/worker.py:145-152
    # `tensorboard_hdfs_dir`).
    tensorboard_remote_dir: Optional[str] = None
    ddp_args: DistributedDataParallelArgs = dataclasses.field(
        default_factory=DistributedDataParallelArgs)
    backend: Optional[str] = None  # None = collective_backend()


def get_device() -> torch.device:
    """The rank's device: ``cpu`` under ``TPU_YARN_PLATFORM=cpu``, else
    its card (the reference's round robin over the cards, by the
    ``RANK`` and ``WORLD_SIZE`` the worker exports; `_device.rank_card`),
    raising without one."""
    from tf_yarn_tpu_torch import _device

    device = _device.task_device()
    if device.type != "cuda":
        return device
    card, _ = _device.rank_card(int(os.environ.get("RANK", "0")),
                                int(os.environ.get("WORLD_SIZE", "1")),
                                torch.cuda.device_count())
    return torch.device("cuda", card)


def collective_backend() -> str:
    """``"nccl"`` when the task's device is the card, else ``"gloo"``
    (the reference's choice, worker.py:171-174)."""
    return "nccl" if get_device().type == "cuda" else "gloo"


def run_on_gpu(
    experiment_fn: Callable[[], PytorchExperiment],
    task_specs: Optional[TaskSpecs] = None,
    **kwargs: Dict[str, Any],
):
    """`client.run_on_gpu` with the pytorch task program (reference:
    pytorch/client.py:12-23)."""
    kwargs.setdefault("custom_task_module", PYTORCH_TASK_MODULE)
    return _client.run_on_gpu(experiment_fn, task_specs, **kwargs)
