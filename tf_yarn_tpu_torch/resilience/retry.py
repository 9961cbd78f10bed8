"""Retry policy: per-kind budgets, decorrelated-jitter backoff, one
global monotonic deadline — a copy of tf_yarn_tpu/resilience/retry.py.

* budgets are **per failure kind** — a deterministic user bug
  (FATAL_USER) consumes zero retries, while preemptions don't eat the
  transient budget;
* backoff is exponential with **decorrelated jitter** (min(cap,
  uniform(base, 3·prev))) so a coordination outage isn't hammered by
  synchronized relaunches — except PREEMPTED, which relaunches
  immediately;
* the whole run shares **one monotonic deadline** (`Deadline`,
  perf_counter-based): ``timeout_secs`` bounds the run, not each
  attempt.
"""

from __future__ import annotations

import dataclasses
import logging
import random
import time
from typing import Dict, List, NamedTuple, Optional

from tf_yarn_tpu_torch.resilience.taxonomy import FailureKind

_logger = logging.getLogger(__name__)


class Deadline:
    """One wall-clock budget on a monotonic clock, shared across attempts.

    The reference (and our earlier port) recomputed ``time.time() +
    timeout`` inside each attempt, so ``nb_retries=3`` could run 4x the
    requested timeout — and an NTP step could stretch any single attempt.
    """

    def __init__(self, seconds: float, clock=time.perf_counter) -> None:
        self.seconds = float(seconds)
        self._clock = clock
        self._t0 = clock()

    @classmethod
    def after(
        cls, seconds: Optional[float], clock=time.perf_counter
    ) -> Optional["Deadline"]:
        """A deadline `seconds` from now, or None for no budget."""
        return None if seconds is None else cls(seconds, clock=clock)

    def elapsed(self) -> float:
        return self._clock() - self._t0

    def remaining(self) -> float:
        return self.seconds - self.elapsed()

    def expired(self) -> bool:
        return self.remaining() <= 0


class RetryDecision(NamedTuple):
    """One granted retry: what kind of failure, how long we backed off."""

    kind: FailureKind
    delay: float


@dataclasses.dataclass
class RetryPolicy:
    """Per-kind retry budgets + backoff state. One instance per run; it
    is stateful (spent budgets, jitter chain, decision history).

    ``history`` records every *granted* retry — tests and post-mortems
    read it to see how a run recovered.
    """

    budgets: Dict[FailureKind, int]
    base_backoff_secs: float = 1.0
    max_backoff_secs: float = 30.0
    seed: Optional[int] = None
    history: List[RetryDecision] = dataclasses.field(default_factory=list)

    def __post_init__(self) -> None:
        self._rng = random.Random(self.seed)
        self._spent: Dict[FailureKind, int] = {}
        self._prev_delay: Dict[FailureKind, float] = {}

    @classmethod
    def from_nb_retries(cls, nb_retries: int, **kwargs) -> "RetryPolicy":
        """The ``nb_retries=N`` surface, taxonomy-aware: N retries for
        each retryable kind (independent budgets), zero for FATAL_USER."""
        return cls(
            budgets={
                FailureKind.TRANSIENT: nb_retries,
                FailureKind.PREEMPTED: nb_retries,
                FailureKind.LOST_TASK: nb_retries,
                FailureKind.FATAL_USER: 0,
            },
            **kwargs,
        )

    def spent(self, kind: FailureKind) -> int:
        return self._spent.get(kind, 0)

    def next_delay(self, kind: FailureKind) -> Optional[float]:
        """Grant a retry for a `kind` failure: the backoff delay in
        seconds, or None when that kind's budget is exhausted (the caller
        re-raises). Consumes one unit of the kind's budget."""
        budget = self.budgets.get(kind, 0)
        if self._spent.get(kind, 0) >= budget:
            return None
        self._spent[kind] = self._spent.get(kind, 0) + 1
        if kind is FailureKind.PREEMPTED:
            # Preemption is the expected lifecycle, not an error to damp:
            # the slice is gone either way, relaunch immediately.
            delay = 0.0
        else:
            prev = self._prev_delay.get(kind, self.base_backoff_secs)
            delay = min(
                self.max_backoff_secs,
                self._rng.uniform(self.base_backoff_secs, prev * 3.0),
            )
            self._prev_delay[kind] = delay
        self.history.append(RetryDecision(kind, delay))
        return delay
