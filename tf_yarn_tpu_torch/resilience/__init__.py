"""Fault tolerance — counterpart of tf_yarn_tpu/resilience/:

* :mod:`~tf_yarn_tpu_torch.resilience.taxonomy` — why an attempt died
  (TRANSIENT / PREEMPTED / LOST_TASK / FATAL_USER), carried through the
  stop event;
* :mod:`~tf_yarn_tpu_torch.resilience.retry` — per-kind budgets,
  decorrelated-jitter backoff, one global monotonic deadline;
* :mod:`~tf_yarn_tpu_torch.resilience.watchdog` — driver-side dead-task
  detection from heartbeat ages (``TPU_YARN_DEAD_TASK_SECS``);
* :mod:`~tf_yarn_tpu_torch.resilience.elastic` — resize-not-retry: an
  :class:`ElasticPolicy` lets a capacity failure shrink the relaunch to
  the surviving hosts (and grow back later) instead of blocking on full
  capacity;
* :mod:`~tf_yarn_tpu_torch.resilience.chaos` — deterministic, seeded
  fault injection (``TPU_YARN_FAULT``) behind the kill/recover tests.

The five are copies of the JAX package's modules (`chaos` truncates
local checkpoint trees only). Checkpoint integrity (MANIFEST.json,
verified restore, quarantine) lives with the checkpoint code:
:mod:`tf_yarn_tpu_torch.checkpoint`.
"""

from tf_yarn_tpu_torch.resilience import chaos  # noqa: F401
from tf_yarn_tpu_torch.resilience.chaos import (  # noqa: F401
    FaultPlan,
    InjectedFault,
    parse_fault_spec,
)
from tf_yarn_tpu_torch.resilience.elastic import (  # noqa: F401
    CAPACITY_KINDS,
    ElasticPolicy,
    ElasticResize,
)

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
    "CAPACITY_KINDS",
    "Deadline",
    "ENV_DEAD_TASK_SECS",
    "ElasticPolicy",
    "ElasticResize",
    "FailureKind",
    "FaultPlan",
    "HeartbeatWatchdog",
    "InjectedFault",
    "RetryDecision",
    "RetryPolicy",
    "chaos",
    "classify_exception",
    "classify_stop_payload",
    "dead_task_secs_from_env",
    "encode_failure",
    "parse_fault_spec",
    "split_kind",
    "worst",
]
