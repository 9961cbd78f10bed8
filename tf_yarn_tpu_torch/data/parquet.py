"""Streaming Parquet input pipeline with sample-level rank sharding —
the port's copy of tf_yarn_tpu/data/parquet.py.

* Sharding is by sample: row i (counted across files and row groups)
  belongs to rank i % world_size, so every row is seen by one rank.
* Only full `batch_size` batches are emitted (static shapes; the tail is
  dropped).
* In single-pass mode every rank emits exactly
  (num_rows // world_size) // batch_size batches, read from the files'
  metadata, so lockstep collectives (DDP's all-reduce) cannot deadlock
  on an uneven tail.

`filesystem` is a pyarrow filesystem object (local, HDFS, GCS through
`pyarrow.fs`), passed to `pyarrow.parquet.ParquetFile` as is; pyarrow is
imported only when the files are read.
"""

from __future__ import annotations

import logging
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

_logger = logging.getLogger(__name__)


class ParquetDataset:
    """Iterable over {column: np.ndarray} batches of exactly `batch_size`
    rows. A string column comes out as an object array, as pyarrow's
    ``to_numpy`` gives it."""

    def __init__(
        self,
        paths: "str | Sequence[str]",
        batch_size: int,
        columns: Optional[List[str]] = None,
        rank: int = 0,
        world_size: int = 1,
        filesystem=None,
        repeat: bool = False,
    ) -> None:
        if isinstance(paths, str):
            paths = [paths]
        self.paths = list(paths)
        self.batch_size = batch_size
        self.columns = columns
        self.rank = rank
        self.world_size = world_size
        self.filesystem = filesystem
        self.repeat = repeat

    def num_samples(self) -> int:
        """Total rows across the files, from their metadata only."""
        import pyarrow.parquet as pq

        total = 0
        for path in self.paths:
            total += pq.ParquetFile(
                path, filesystem=self.filesystem
            ).metadata.num_rows
        return total

    def _iter_rows(self) -> Iterator[Dict[str, np.ndarray]]:
        """This rank's rows, file by file, row group by row group."""
        import pyarrow.parquet as pq

        global_idx = 0
        for path in self.paths:
            pf = pq.ParquetFile(path, filesystem=self.filesystem)
            for rg in range(pf.num_row_groups):
                table = pf.read_row_group(rg, columns=self.columns)
                n = table.num_rows
                # The group's rows are [global_idx, global_idx + n); this
                # rank owns those whose index is rank modulo world_size.
                first = (self.rank - global_idx) % self.world_size
                if first < n:
                    arrays = {
                        name: col.to_numpy(zero_copy_only=False)
                        for name, col in zip(table.column_names, table.columns)
                    }
                    take = slice(first, n, self.world_size)
                    yield {name: arr[take] for name, arr in arrays.items()}
                global_idx += n

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        # Modulo sharding leaves ranks up to world_size - 1 rows apart,
        # which can be a whole batch: in single-pass mode every rank stops
        # at the smallest rank's count, (N // world) // batch.
        max_batches = None
        if self.world_size > 1 and not self.repeat:
            total = self.num_samples()
            max_batches = (total // self.world_size) // self.batch_size
            if max_batches == 0 and total > 0:
                _logger.warning(
                    "ParquetDataset: %d rows over world_size=%d yields "
                    "fewer than batch_size=%d rows per rank — every rank "
                    "emits ZERO batches (training would do no steps). "
                    "Shrink batch_size/world_size or set repeat=True.",
                    total, self.world_size, self.batch_size,
                )
        emitted = 0
        # The buffers persist across epochs under repeat=True, so a rank
        # with fewer rows an epoch than batch_size still makes batches.
        buffers: Dict[str, List[np.ndarray]] = {}
        buffered = 0
        while True:
            rows_this_epoch = 0
            for chunk in self._iter_rows():
                if not buffers:
                    buffers = {k: [] for k in chunk}
                for key, arr in chunk.items():
                    buffers[key].append(arr)
                n = len(next(iter(chunk.values())))
                buffered += n
                rows_this_epoch += n
                while buffered >= self.batch_size:
                    if max_batches is not None and emitted >= max_batches:
                        return
                    merged = {k: np.concatenate(v) for k, v in buffers.items()}
                    batch = {k: v[: self.batch_size] for k, v in merged.items()}
                    buffers = {
                        k: [v[self.batch_size:]] for k, v in merged.items()
                    }
                    buffered -= self.batch_size
                    emitted += 1
                    yield batch
            if not self.repeat:
                return  # the tail (< batch_size) is dropped
            if rows_this_epoch == 0:
                raise ValueError(
                    f"rank {self.rank}/{self.world_size} owns no rows in "
                    f"{self.paths}; cannot repeat forever without data"
                )
