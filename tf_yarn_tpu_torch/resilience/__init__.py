"""Fault tolerance — counterpart of tf_yarn_tpu/resilience/:

* :mod:`~tf_yarn_tpu_torch.resilience.taxonomy` — why an attempt died
  (TRANSIENT / PREEMPTED / LOST_TASK / FATAL_USER), carried through the
  stop event;
* :mod:`~tf_yarn_tpu_torch.resilience.retry` — per-kind budgets,
  decorrelated-jitter backoff, one global monotonic deadline;
* :mod:`~tf_yarn_tpu_torch.resilience.watchdog` — driver-side dead-task
  detection from heartbeat ages (``TPU_YARN_DEAD_TASK_SECS``).

The three are copies of the JAX package's modules. Elastic resize
(`elastic.py`) and fault injection (`chaos.py`) are not ported yet
(ROADMAP.md Queue 1 item 5).
"""

from tf_yarn_tpu_torch.resilience.retry import (  # noqa: F401
    Deadline,
    RetryDecision,
    RetryPolicy,
)
from tf_yarn_tpu_torch.resilience.taxonomy import (  # noqa: F401
    FailureKind,
    classify_exception,
    classify_stop_payload,
    encode_failure,
    split_kind,
    worst,
)
from tf_yarn_tpu_torch.resilience.watchdog import (  # noqa: F401
    ENV_DEAD_TASK_SECS,
    HeartbeatWatchdog,
    dead_task_secs_from_env,
)

__all__ = [
    "Deadline",
    "ENV_DEAD_TASK_SECS",
    "FailureKind",
    "HeartbeatWatchdog",
    "RetryDecision",
    "RetryPolicy",
    "classify_exception",
    "classify_stop_payload",
    "dead_task_secs_from_env",
    "encode_failure",
    "split_kind",
    "worst",
]
