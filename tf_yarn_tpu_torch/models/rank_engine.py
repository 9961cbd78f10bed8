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
call).

**Embedding-sharded inference** (``mesh=``, a mesh of ranks whose only
dim above 1 is ``tp``; JAX rank_engine.py:14-21, 101-141): the stacked
table's rows are cut over tp by `parallel.sharding.RANKING_RULES`
(`parallel.tensor_parallel.shard`), each rank keeping ``sum(table_sizes)
/ tp`` rows and every other parameter whole, and the lookup sums the
ranks' rows (`tensor_parallel.vocab_embed`, op ``embed`` in the
``train/tp_allreduce`` span): each row comes from the one rank that
holds it, so a tp replica's scores are bitwise the one-device port's.
The JAX package serves that from one process over a device mesh; the
port runs one process a rank (`serving.tp_replica`). Rank 0, the
leader, validates and pads each batch, then announces the padded ``cat``
and ``dense`` to the followers (`tensor_parallel.Leader`) before its own
forward; the followers (`follow`) run the same forward on their rows and
keep no scores. A dead follower fails the leader's next call with
`TPGroupError` (LOST_TASK).
"""

from __future__ import annotations

import logging
import math
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from tf_yarn_tpu_torch import telemetry
from tf_yarn_tpu_torch._device import resolve_device
from tf_yarn_tpu_torch.models.decode_engine import _ceil_bucket
from tf_yarn_tpu_torch.parallel.tensor_parallel import (
    ReplicaEngine,
    replicated,
)

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


class RankEngine(ReplicaEngine):
    """Ranking for one model on its device (module docstring). The
    device is the model's, checked by `resolve_device`: CUDA unless the
    model was built with ``device="cpu"``. With ``mesh=`` every rank of
    the tp group builds an engine over its own whole (or already cut)
    model; the followers then call `follow`."""

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
        self.mesh = mesh
        self.tp_degree = 1
        self.tp_rank = 0
        if mesh is not None:
            self._place(model, mesh)
        self.device = resolve_device(getattr(model, "device", None))
        self._forwards = set()
        self._lock = threading.Lock()
        self.stats = {
            "calls": 0,
            "forward_buckets": 0,
            "unbucketed_shapes": 0,
        }

    def _place(self, model, mesh) -> None:
        """The JAX engine's verdicts on the mesh (rank_engine.py:110-129,
        its messages), then the table's rows cut over tp by
        RANKING_RULES (a model already cut keeps its cut) and the group's
        control channel joined."""
        from tf_yarn_tpu_torch.parallel import mesh as mesh_lib
        from tf_yarn_tpu_torch.parallel import sharding
        from tf_yarn_tpu_torch.parallel import tensor_parallel as tp_lib

        sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
        self.tp_degree = int(sizes.get(mesh_lib.AXIS_TP, 1))
        if math.prod(sizes.values()) != self.tp_degree:
            raise ValueError(
                "ranking shards tensor-parallel only: every mesh "
                f"axis but '{mesh_lib.AXIS_TP}' must be 1, got {sizes} "
                "(replica parallelism is the fleet router's job)"
            )
        total = int(sum(model.config.table_sizes))
        if total % self.tp_degree:
            raise ValueError(
                f"tp={self.tp_degree} does not divide the stacked "
                f"embedding table's {total} rows — each device must "
                "hold an equal table shard; pick a tp that divides "
                "sum(table_sizes)"
            )
        if self.tp_degree == 1:
            return
        if model.tp is None:
            tp_lib.shard(model, tp_lib.TensorParallel.of(mesh,
                                                         mesh_lib.AXIS_TP),
                         sharding.RANKING_RULES)
        elif model.tp.size != self.tp_degree:
            raise ValueError(f"the model is cut over tp={model.tp.size}, the "
                             f"mesh has tp={self.tp_degree}")
        self.tp_rank = model.tp.rank
        self.join_replica(mesh, self.tp_rank, "ranking/tp_header")

    def select_bucket(self, batch: int) -> int:
        """Padded batch size for an incoming batch of `batch` rows:
        ceil to the bucket grid (extra rows are scored and discarded);
        beyond the grid the exact size runs, logged."""
        return _ceil_bucket(batch, self.batch_buckets) or batch

    def params_nbytes_per_device(self) -> int:
        """Resident parameter bytes on this rank's device — the
        ``ranking/params_hbm_bytes_per_device`` gauge: all of them on one
        device, the table's ``1/tp`` and the rest whole on a tp rank
        (the total less ``table * (tp - 1) / tp``, JAX
        rank_engine.py:209-214)."""
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
        key = (bucket, dense is not None)
        with self._lock:
            seen = key in self._forwards
            self._forwards.add(key)
            self.stats["forward_buckets"] = len(self._forwards)
        if seen:
            telemetry.get_registry().counter(
                "rank_engine/cache_hits", kind="forward").inc()
        with telemetry.span("rank_engine/forward", batch=batch,
                            bucket=bucket):
            scores = self.score(cat, dense)
        return scores[:batch]

    @replicated
    def score(self, cat: np.ndarray, dense: Optional[np.ndarray] = None
              ) -> Optional[np.ndarray]:
        """One forward of a padded, validated batch on the device and one
        copy of its scores to the host; on a tp leader announced to the
        followers first, which run the forward on their rows and return
        None."""
        args = (torch.from_numpy(cat).to(self.device),)
        if dense is not None:
            args = args + (torch.from_numpy(dense).to(self.device),)
        fn = build_rank_fn(self.model, has_dense=dense is not None)
        with torch.inference_mode():
            scores = fn(*args)
        return None if self.follows else scores.float().cpu().numpy()

    @replicated
    def rank_report(self) -> List[Dict]:
        """Each rank's parameter bytes and peak device memory, in rank
        order ([this rank] on one device; the followers get None)."""
        cuda = self.device.type == "cuda"
        report = {"rank": self.tp_rank, "device": str(self.device),
                  "params_bytes": self.params_nbytes_per_device(),
                  "table_rows": int(self.model.embedding.shape[0]),
                  "peak_memory_bytes": (torch.cuda.max_memory_allocated(
                      self.device) if cuda else None)}
        if self.channel is None:
            return [report]
        return self.channel.gather_objects(report)

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
