"""RankEngine — micro-batch ranking inference for DLRM-class models;
counterpart of tf_yarn_tpu/models/rank_engine.py.

The stateless sibling of `models.decode_engine`: a ranking request
carries a handful of feature rows, scores in one forward and leaves
nothing behind. What it keeps from the JAX engine:

* **The bucket grid.** An incoming batch ceil-pads with zero rows to the
  next batch bucket (zero ids are valid after the model's per-table
  fold); the padded rows are scored and dropped. Every DLRM operation
  is row-independent, so a real row's score does not depend on the
  rows beside it up to the rounding of the library's kernels, which may
  differ between batch sizes: no bits are promised across buckets.
* **One forward and one host copy a call**, under
  ``torch.inference_mode()`` on the model's device.
* **Admission-time validation** (`feature_arrays`), with the JAX
  engine's messages, so a malformed request dies as the frontend's 400
  and never inside the ticking loop.

PyTorch runs eagerly, so the JAX engine's compile cache has no
counterpart. `stats` keeps ``calls`` and ``unbucketed_shapes`` and, in
place of ``forward_compiles`` and ``forward_cache_hits``, counts
``forward_buckets``: the distinct (bucket, dense or not) forwards that
have run. The ``rank_engine/forward`` span and the
``rank_engine/cache_hits{kind=forward}`` counter (a forward at a bucket
that has run before) keep the JAX names; ``rank_engine/compiles`` and
``rank_engine/compile_seconds`` have nothing to count.

The model holds its weights (the JAX engine takes ``params`` at every
call). Embedding-sharded inference over a tensor-parallel mesh
(``mesh=``) raises: it is ROADMAP.md Queue 1 item 7.
"""

from __future__ import annotations

import logging
import threading
from typing import Optional, Tuple

import numpy as np
import torch

from tf_yarn_tpu_torch import telemetry
from tf_yarn_tpu_torch._device import resolve_device
from tf_yarn_tpu_torch.models.decode_engine import _ceil_bucket

_logger = logging.getLogger(__name__)

# Ranking micro-batches skew small (latency-bound) but a loaded tick can
# fill to max_batch; the grid covers both ends.
DEFAULT_BATCH_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256)


def build_rank_fn(model, has_dense: bool):
    """The ranking forward: ``(cat[, dense]) -> scores [B]``."""
    if has_dense:
        def forward(cat, dense):
            return model(cat, dense).squeeze(-1)
    else:
        def forward(cat):
            return model(cat).squeeze(-1)
    return forward


class RankEngine:
    """Ranking for one model on its device (module docstring). The
    device is the model's, checked by `resolve_device`: CUDA unless the
    model was built with ``device="cpu"``."""

    def __init__(
        self,
        model,
        batch_buckets: Tuple[int, ...] = DEFAULT_BATCH_BUCKETS,
        mesh=None,
    ):
        config = getattr(model, "config", None)
        if config is None or not hasattr(config, "table_sizes"):
            raise ValueError(
                "RankEngine needs a model with config.table_sizes (the "
                "DLRM-style stacked embedding layout) — feature-arity "
                "validation and the table sharding rule both read it"
            )
        self.model = model
        self.n_tables = len(config.table_sizes)
        self.n_dense = int(getattr(config, "n_dense", 0))
        self.batch_buckets = tuple(sorted(set(batch_buckets)))
        if not self.batch_buckets or self.batch_buckets[0] < 1:
            raise ValueError(
                f"batch_buckets must be positive, got {batch_buckets}"
            )
        if mesh is not None:
            raise NotImplementedError(
                "embedding-sharded ranking over a tensor-parallel mesh is "
                "still to port (ROADMAP.md Queue 1 item 7, parallelism)"
            )
        self.tp_degree = 1
        self.device = resolve_device(getattr(model, "device", None))
        self._forwards = set()
        self._lock = threading.Lock()
        self.stats = {
            "calls": 0,
            "forward_buckets": 0,
            "unbucketed_shapes": 0,
        }

    def select_bucket(self, batch: int) -> int:
        """Padded batch size for an incoming batch of `batch` rows:
        ceil to the bucket grid (extra rows are scored and discarded);
        beyond the grid the exact size runs, logged."""
        return _ceil_bucket(batch, self.batch_buckets) or batch

    def params_nbytes_per_device(self) -> int:
        """Resident parameter bytes on the device (one device: all of
        them) — the ``ranking/params_hbm_bytes_per_device`` gauge."""
        return sum(p.numel() * p.element_size()
                   for p in self.model.parameters())

    def feature_arrays(self, cat, dense):
        """Validate + canonicalize one feature batch: int32 ``cat
        [B, n_tables]`` and float32 ``dense [B, n_dense]`` (or None for
        dense-free models). Raises ValueError on arity mismatch — the
        scheduler calls this AT SUBMIT so a malformed request dies as
        the frontend's 400, never inside the ticking loop."""
        cat = np.asarray(cat, np.int32)
        if cat.ndim != 2 or cat.shape[1] != self.n_tables:
            raise ValueError(
                f"cat must be [batch, {self.n_tables}] (one id per "
                f"categorical table), got shape {tuple(cat.shape)}"
            )
        if self.n_dense:
            if dense is None:
                raise ValueError(
                    f"this model takes {self.n_dense} dense features per "
                    "row; the request carried none"
                )
            dense = np.asarray(dense, np.float32)
            if dense.shape != (cat.shape[0], self.n_dense):
                raise ValueError(
                    f"dense must be [batch, {self.n_dense}], got shape "
                    f"{tuple(dense.shape)}"
                )
        elif dense is not None:
            raise ValueError(
                "this model takes no dense features; the request "
                "carried some"
            )
        return cat, dense

    def rank(self, cat, dense=None) -> np.ndarray:
        """Score a ``[B, n_tables]`` id batch (plus ``[B, n_dense]``
        dense features when the model has them): float32 scores ``[B]``.

        B ceil-pads to the bucket grid with zero rows, one forward runs
        on the model's device, and one copy of the scores to the host
        ends the call.
        """
        with self._lock:
            self.stats["calls"] += 1
        cat, dense = self.feature_arrays(cat, dense)
        batch = cat.shape[0]
        if batch < 1:
            raise ValueError("cannot rank an empty batch")
        bucket = self.select_bucket(batch)
        if bucket not in self.batch_buckets:
            with self._lock:
                self.stats["unbucketed_shapes"] += 1
            _logger.warning(
                "rank batch %d beyond the bucket grid %s: exact-shape "
                "forward", batch, self.batch_buckets,
            )
        if bucket != batch:
            cat = np.concatenate(
                [cat, np.zeros((bucket - batch, self.n_tables), np.int32)]
            )
            if dense is not None:
                dense = np.concatenate(
                    [dense,
                     np.zeros((bucket - batch, self.n_dense), np.float32)]
                )
        args = (torch.from_numpy(cat).to(self.device),)
        if dense is not None:
            args = args + (torch.from_numpy(dense).to(self.device),)
        key = (bucket, dense is not None)
        with self._lock:
            seen = key in self._forwards
            self._forwards.add(key)
            self.stats["forward_buckets"] = len(self._forwards)
        if seen:
            telemetry.get_registry().counter(
                "rank_engine/cache_hits", kind="forward").inc()
        fn = build_rank_fn(self.model, has_dense=dense is not None)
        with telemetry.span("rank_engine/forward", batch=batch,
                            bucket=bucket):
            with torch.inference_mode():
                scores = fn(*args).float().cpu().numpy()
        return scores[:batch]

    def warmup(self, max_batch: Optional[int] = None) -> int:
        """Run every bucket ≤ `max_batch` (all of them when None) once
        with zero features, so the first real request on each bucket
        finds the library's kernels loaded and its workspaces sized.
        Returns the number of buckets warmed."""
        warmed = 0
        for bucket in self.batch_buckets:
            if max_batch is not None and bucket > max_batch:
                break
            cat = np.zeros((bucket, self.n_tables), np.int32)
            dense = (
                np.zeros((bucket, self.n_dense), np.float32)
                if self.n_dense else None
            )
            self.rank(cat, dense)
            warmed += 1
        return warmed
