"""Balancing policies: which healthy replica gets the next request — a
copy of tf_yarn_tpu/fleet/policy.py.

Pure host-side selection over the registry's healthy set: policies never
probe, never block, and take an ``exclude`` set so the router's retry
loop can fail over without re-picking a replica it just watched fail.
Both are deterministic given the same replica states.
"""

from __future__ import annotations

import threading
from typing import Iterable, Optional, Sequence

from tf_yarn_tpu_torch.fleet.registry import Replica


class RoundRobinPolicy:
    """Cycle the healthy set in task order. Fair regardless of load
    signals — the right default when replicas are homogeneous and the
    /stats poll cadence is slow next to the request rate."""

    name = "round_robin"

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._cursor = 0

    def pick(self, replicas: Sequence[Replica],
             exclude: Iterable[str] = ()) -> Optional[Replica]:
        excluded = set(exclude)
        candidates = sorted(
            (r for r in replicas if r.task not in excluded),
            key=lambda r: r.task,
        )
        if not candidates:
            return None
        with self._lock:
            cursor = self._cursor
            self._cursor += 1
        return candidates[cursor % len(candidates)]


class LeastLoadedPolicy:
    """Pick the replica with the smallest load signal: the cached
    ``/healthz`` occupancy (queue depth + active slots) plus the
    router's own in-flight count for that replica — the correction that
    keeps a burst between polls from dogpiling one replica. Ties break
    by task order (deterministic)."""

    name = "least_loaded"

    def pick(self, replicas: Sequence[Replica],
             exclude: Iterable[str] = ()) -> Optional[Replica]:
        excluded = set(exclude)
        candidates = sorted(
            (r for r in replicas if r.task not in excluded),
            key=lambda r: (r.load, r.task),
        )
        return candidates[0] if candidates else None


POLICIES = {
    RoundRobinPolicy.name: RoundRobinPolicy,
    LeastLoadedPolicy.name: LeastLoadedPolicy,
}


def make_policy(name: str):
    """A fresh policy instance by name (the ServingExperiment
    ``router_policy`` surface)."""
    try:
        return POLICIES[name]()
    except KeyError:
        raise ValueError(
            f"unknown routing policy {name!r}; known: {sorted(POLICIES)}"
        ) from None
