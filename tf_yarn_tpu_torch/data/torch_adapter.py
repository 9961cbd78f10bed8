"""ParquetDataset -> torch IterableDataset bridge — the port's copy of
tf_yarn_tpu/data/torch_adapter.py.

`TorchParquetDataset` wraps the port's
:class:`~tf_yarn_tpu_torch.data.parquet.ParquetDataset` and re-shards it
by the live process-group rank folded with the DataLoader worker id, so
one dataset object pickled into every DDP process (and every loader
worker) still reads each row once.

It yields pre-batched ``{column: torch.Tensor}`` dicts: give it to a
DataLoader with ``batch_size=None``, as the pytorch worker does when it
sees ``yields_batches``. A string column raises in ``torch.from_numpy``,
as in the JAX package.
"""

from __future__ import annotations

import os
from typing import Dict, Iterator, Tuple

import torch
from torch.utils.data import IterableDataset

from tf_yarn_tpu_torch.data.parquet import ParquetDataset


class TorchParquetDataset(IterableDataset):
    """Sample-level-sharded Parquet batches as torch tensors."""

    # Read by the pytorch worker: build the DataLoader with
    # batch_size=None (the batches come assembled).
    yields_batches = True
    # Read by the worker's duplicate-data check: the sharding happens in
    # __iter__, by the live rank, not through attributes.
    shards_by_rank = True

    def __init__(self, dataset: ParquetDataset) -> None:
        super().__init__()
        self._dataset = dataset

    def _effective_shard(self) -> Tuple[int, int]:
        """(rank, world): the process-group rank times the DataLoader's
        workers plus the worker id, so num_workers > 0 never duplicates
        rows."""
        import torch.distributed as dist
        import torch.utils.data as tud

        if dist.is_available() and dist.is_initialized():
            rank, world = dist.get_rank(), dist.get_world_size()
        else:
            # A spawned DataLoader worker has no process group; the
            # pytorch worker exports RANK and WORLD_SIZE to its processes
            # so the sharding survives the spawn.
            rank = int(os.environ.get("RANK", "0"))
            world = int(os.environ.get("WORLD_SIZE", "1"))
        info = tud.get_worker_info()
        if info is not None:
            rank = rank * info.num_workers + info.id
            world = world * info.num_workers
        return rank, world

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        rank, world = self._effective_shard()
        base = self._dataset
        sharded = ParquetDataset(
            base.paths,
            base.batch_size,
            columns=base.columns,
            rank=rank,
            world_size=world,
            filesystem=base.filesystem,
            repeat=base.repeat,
        )
        for batch in sharded:
            yield {
                name: torch.from_numpy(array) for name, array in batch.items()
            }
