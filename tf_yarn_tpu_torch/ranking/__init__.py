"""Stateless micro-batch ranking — counterpart of tf_yarn_tpu/ranking/.

Token decode (`serving/`) is stateful: a request occupies a KV slot for
many ticks. Ranking is the opposite regime: tiny, latency-bound,
stateless requests that score in ONE forward and free their capacity
the same tick. The subsystem shares the serving stack's bones
(`AdmissionQueue` backpressure, deadline semantics, the HTTP
conventions) but none of its KV machinery.

* :mod:`~tf_yarn_tpu_torch.ranking.scheduler` — `MicroBatchScheduler`,
  fill-or-timeout batching over `models.rank_engine.RankEngine`.
* :mod:`~tf_yarn_tpu_torch.ranking.server` — `RankServer`:
  ``/v1/rank``, ``/healthz``, ``/stats``, ``/metrics``.

* `run_ranking` (in the server module) — the ``rank`` task's body.
"""

from tf_yarn_tpu_torch.ranking.scheduler import (  # noqa: F401
    FINISH_COMPLETE,
    MicroBatchScheduler,
    RankRequest,
    RankResponse,
)
from tf_yarn_tpu_torch.ranking.server import (  # noqa: F401
    RankServer,
    run_ranking,
)

__all__ = [
    "FINISH_COMPLETE",
    "MicroBatchScheduler",
    "RankRequest",
    "RankResponse",
    "RankServer",
    "run_ranking",
]
