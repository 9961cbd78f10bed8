"""Elastic resize policy: shrink instead of blocking on lost capacity —
a copy of tf_yarn_tpu/resilience/elastic.py.

On preemptible hosts the driver's old posture — relaunch the *same*
topology and wait for full capacity — idles training exactly when
capacity is scarce. This module decides, per failed attempt, whether the
next attempt should RESIZE instead: a capacity failure (PREEMPTED /
LOST_TASK) shrinks the worker count to the surviving hosts (never below
``min_workers``); any other retryable failure is the moment to try
growing back to ``max_workers`` (the relaunch re-requests placement
anyway, and the preempted capacity may have returned).

The logical topology stays fixed: the experiment keeps declaring ONE
mesh and ONE global batch, and the runtime refits them onto the ranks
an attempt actually has (`parallel.mesh.resize_mesh_spec` in the train
loop, the data groups' shares of the global batch, and
`parallel.data_parallel.DataParallel.reshard_state` on restore).

The policy is driver-side state (like `RetryPolicy`): `history` records
every granted resize so tests and post-mortems can see how a run's
capacity evolved.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import List, NamedTuple, Optional, Tuple

from tf_yarn_tpu_torch.resilience.taxonomy import FailureKind

_logger = logging.getLogger(__name__)

# The failure kinds that mean "physical capacity went away" — the only
# ones that justify shrinking. Everything else relaunches at (or grows
# back toward) full size.
CAPACITY_KINDS: Tuple[FailureKind, ...] = (
    FailureKind.PREEMPTED,
    FailureKind.LOST_TASK,
)


class ElasticResize(NamedTuple):
    """One granted resize decision."""

    direction: str  # "shrink" | "grow"
    from_workers: int
    to_workers: int
    kind: Optional[FailureKind]


@dataclasses.dataclass
class ElasticPolicy:
    """Resize bounds + decision state for one run.

    ``min_workers``/``max_workers`` bound the worker count the driver may
    relaunch with; the initial topology must start inside the band.
    ``shrink_step`` is the floor on how many workers one capacity failure
    removes when the lost-task count is unknown (the observed number of
    lost tasks wins when larger). ``regrow=False`` pins a shrunken run
    at its degraded size until it finishes (for clusters where the
    replacement host can never come back mid-run).
    """

    min_workers: int
    max_workers: int
    shrink_step: int = 1
    regrow: bool = True
    history: List[ElasticResize] = dataclasses.field(default_factory=list)

    def __post_init__(self) -> None:
        if self.min_workers < 1:
            raise ValueError(
                f"min_workers must be >= 1, got {self.min_workers}")
        if self.max_workers < self.min_workers:
            raise ValueError(
                f"max_workers ({self.max_workers}) must be >= min_workers "
                f"({self.min_workers})")
        if self.shrink_step < 1:
            raise ValueError(
                f"shrink_step must be >= 1, got {self.shrink_step}")

    def plan_resize(
        self,
        kind: FailureKind,
        current_workers: int,
        lost_tasks: int = 0,
    ) -> Optional[int]:
        """Worker count for the NEXT attempt after a `kind` failure, or
        None to relaunch unchanged. Called once per granted retry; a
        granted resize is recorded in `history`.

        Capacity kinds shrink to the surviving hosts:
        ``current - max(lost_tasks, shrink_step)`` clamped to
        ``min_workers`` (already at the floor -> None, the relaunch
        waits for capacity like the non-elastic path). Other kinds grow
        back to ``max_workers`` when currently degraded and `regrow`.
        """
        if kind in CAPACITY_KINDS:
            target = max(
                self.min_workers,
                current_workers - max(lost_tasks, self.shrink_step),
            )
            if target >= current_workers:
                return None
            self.history.append(
                ElasticResize("shrink", current_workers, target, kind))
            return target
        if self.regrow and current_workers < self.max_workers:
            self.history.append(
                ElasticResize("grow", current_workers, self.max_workers, kind))
            return self.max_workers
        return None

    def degraded(self, current_workers: int) -> bool:
        return current_workers < self.max_workers
