"""Replica registry: the router's live view of the serving fleet — a copy
of tf_yarn_tpu/fleet/registry.py.

Discovery and liveness ride the run's coordination KV, as the replicas
already speak it:

* **discovery** — each replica advertises its HTTP endpoint as
  ``{task}/serving_endpoint`` (generate replicas), ``{task}/rank_endpoint``
  (ranking replicas) or ``{task}/prefill_endpoint`` (the prefill tier).
  The suffix is the replica's capability: the registry records it as
  ``Replica.kind`` and the router routes a request only to replicas of
  the kind its path names (``healthy(kind=...)``).
* **admission** — an advertised endpoint is not routable until its first
  successful ``/healthz`` probe: a replica publishes its endpoint before
  it has served, and routing to it would burn the router's retries.
* **health ejection** — a replica leaves rotation when ``/healthz`` stops
  answering, answers anything but ``"ok"`` (the preemption drain's
  ``"draining"`` ejects before the socket goes), or its KV heartbeat
  goes beat-then-silent past ``dead_heartbeat_s`` (a wedged server can
  still accept TCP). An ejected replica is re-admitted on its first
  healthy probe.
* **finished is not dead** — a ``heartbeat.stopped`` tombstone or a
  ``stop`` event takes the replica out as ``stopped`` without counting an
  ejection, as the watchdog reads them.

A KV read error degrades the view for one refresh (previous states hold);
it never takes the router down with the coordination link.
"""

from __future__ import annotations

import dataclasses
import http.client
import json
import logging
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

from tf_yarn_tpu_torch import telemetry
from tf_yarn_tpu_torch.resilience.taxonomy import classify_exception
from tf_yarn_tpu_torch.telemetry.heartbeat import heartbeat_age

_logger = logging.getLogger(__name__)

# Replica lifecycle states.
PENDING = "pending"    # endpoint advertised, no healthy probe yet
HEALTHY = "healthy"    # in rotation
EJECTED = "ejected"    # out of rotation, re-admitted on recovery
STOPPED = "stopped"    # tombstoned / stop event: finished, not dead

DEFAULT_PROBE_TIMEOUT_S = 2.0
DEFAULT_PROBE_INTERVAL_S = 1.0

# Replica capability kinds, keyed by the KV suffix the replica
# advertised its endpoint under (the suffix IS the declaration — a
# replica that publishes rank_endpoint serves /v1/rank, nothing else).
KIND_GENERATE = "generate"
KIND_RANK = "rank"
KIND_PREFILL = "prefill"


def http_probe(endpoint: str,
               timeout: float = DEFAULT_PROBE_TIMEOUT_S) -> dict:
    """GET ``/healthz`` on a replica; the parsed JSON on HTTP 200,
    raises (ConnectionError family) otherwise. The default probe — tests
    inject fakes through the ``probe=`` seam."""
    host, _, port = endpoint.rpartition(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=timeout)
    try:
        conn.request("GET", "/healthz")
        resp = conn.getresponse()
        payload = resp.read()
        if resp.status != 200:
            raise ConnectionError(
                f"/healthz on {endpoint} answered {resp.status}"
            )
        return json.loads(payload or b"{}")
    finally:
        conn.close()


@dataclasses.dataclass
class Replica:
    """One replica as the registry sees it."""

    task: str
    endpoint: Optional[str] = None
    state: str = PENDING
    # Which request path this replica can serve ("generate" for
    # /v1/generate, "rank" for /v1/rank) — set from the KV suffix it
    # advertised under.
    kind: str = KIND_GENERATE
    # Load signals from the last probe (the /healthz payload carries the
    # scheduler occupancy) plus the router's own in-flight count — the
    # between-polls correction that keeps least-loaded from dogpiling.
    queue_depth: int = 0
    active_slots: int = 0
    inflight: int = 0
    eject_reason: Optional[str] = None
    last_probe_at: Optional[float] = None
    ejections: int = 0
    readmissions: int = 0
    relaunches: int = 0
    ever_beat: bool = False
    # Endpoint the replica was advertising when its stop tombstone was
    # observed. A later advertisement under a DIFFERENT endpoint marks
    # the tombstone as belonging to a previous incarnation — the
    # relaunched task is alive and must be probed back in.
    stopped_endpoint: Optional[str] = None
    # /healthz payload schema version; None = a legacy (pre-versioning)
    # replica that never sent one. Mixed-version fleets keep routing —
    # the version only informs readers like the monitor, never gates
    # health.
    schema_version: Optional[int] = None

    @property
    def load(self) -> int:
        return self.queue_depth + self.active_slots + self.inflight

    def snapshot(self) -> dict:
        return {
            "task": self.task,
            "endpoint": self.endpoint,
            "state": self.state,
            "kind": self.kind,
            "queue_depth": self.queue_depth,
            "active_slots": self.active_slots,
            "inflight": self.inflight,
            "eject_reason": self.eject_reason,
            "ejections": self.ejections,
            "readmissions": self.readmissions,
            "relaunches": self.relaunches,
            "schema_version": self.schema_version,
        }


class ReplicaRegistry:
    """Maintains the live replica set (module docstring).

    ``tasks=None`` discovers replicas by scanning KV keys for
    ``*/serving_endpoint`` and ``*/rank_endpoint``; a launcher passes
    the cluster's serving + rank tasks explicitly (their kind is then
    resolved from whichever endpoint key each task publishes).
    ``dead_heartbeat_s=None`` disables the heartbeat
    check (probes still govern health). ``probe_interval_s`` bounds
    probe traffic per replica; ``refresh(force=True)`` probes
    regardless (used right after an observed failure).
    """

    def __init__(
        self,
        kv,
        tasks: Optional[Sequence[str]] = None,
        *,
        probe: Callable[[str], dict] = http_probe,
        probe_interval_s: float = DEFAULT_PROBE_INTERVAL_S,
        dead_heartbeat_s: Optional[float] = None,
        clock=time.monotonic,
        wall_clock=time.time,
    ) -> None:
        self._kv = kv
        self._tasks = list(tasks) if tasks is not None else None
        self._probe = probe
        self.probe_interval_s = float(probe_interval_s)
        self.dead_heartbeat_s = dead_heartbeat_s
        self._clock = clock
        self._wall_clock = wall_clock
        self._lock = threading.RLock()
        self._replicas: Dict[str, Replica] = {}
        self._registry = telemetry.get_registry()

    # -- refresh (router poll loop; also on-demand from the router) --------

    def refresh(self, force: bool = False) -> List[Replica]:
        """One discovery + health pass; returns the healthy set."""
        with self._lock:
            for task, kind in self._discover_tasks().items():
                replica = self._replicas.setdefault(task, Replica(task))
                if kind is not None:
                    replica.kind = kind
            for replica in self._replicas.values():
                self._refresh_one(replica, force)
            healthy = self._healthy_locked()
            self._registry.gauge("fleet/healthy_replicas").set(len(healthy))
            return healthy

    def _discover_tasks(self) -> Dict[str, Optional[str]]:
        """Task -> kind map of advertised replicas. Kind is ``None``
        (unknown, resolved at refresh from whichever endpoint key the
        task published) for an explicit ``tasks=`` list; the KV scan
        path learns it from the matching suffix directly."""
        from tf_yarn_tpu_torch import event

        if self._tasks is not None:
            return {task: None for task in self._tasks}
        suffixes = {
            f"/{event.SERVING_ENDPOINT}": KIND_GENERATE,
            f"/{event.RANK_ENDPOINT}": KIND_RANK,
            f"/{event.PREFILL_ENDPOINT}": KIND_PREFILL,
        }
        try:
            keys = self._kv.keys("")
        except Exception:
            _logger.warning(
                "registry KV key scan failed; keeping known replicas",
                exc_info=True,
            )
            return {task: None for task in self._replicas}
        found: Dict[str, Optional[str]] = {}
        for key in keys:
            for suffix, kind in suffixes.items():
                if key.endswith(suffix):
                    found[key[: -len(suffix)]] = kind
        return dict(sorted(found.items()))

    def _refresh_one(self, replica: Replica, force: bool) -> None:
        from tf_yarn_tpu_torch import event

        try:
            # Read the endpoint from the replica's own kind's key first;
            # when the kind is not yet known (explicit tasks= list),
            # whichever key the task published resolves it — the suffix
            # IS the capability declaration.
            kind_keys = {
                KIND_GENERATE: event.SERVING_ENDPOINT,
                KIND_RANK: event.RANK_ENDPOINT,
                KIND_PREFILL: event.PREFILL_ENDPOINT,
            }
            ordered = [replica.kind] + [
                kind for kind in kind_keys if kind != replica.kind
            ]
            endpoint = None
            for kind in ordered:
                endpoint = self._kv.get_str(
                    f"{replica.task}/{kind_keys[kind]}"
                )
                if endpoint is not None:
                    replica.kind = kind
                    break
            stopped = (
                self._kv.get_str(
                    f"{replica.task}/{event.HEARTBEAT_STOPPED}"
                ) is not None
                or self._kv.get_str(f"{replica.task}/{event.STOP}")
                is not None
            )
            beat_raw = self._kv.get_str(f"{replica.task}/{event.HEARTBEAT}")
        except Exception:
            # A flaky KV read degrades the view for one refresh (the
            # watchdog's posture) — previous states hold.
            _logger.warning(
                "registry KV read for %s failed; keeping previous state",
                replica.task, exc_info=True,
            )
            return
        if endpoint is None:
            return  # not advertised yet: nothing to probe
        if replica.endpoint is not None and endpoint != replica.endpoint:
            # Relaunched incarnation: the task re-advertised the SAME KV
            # key with a NEW host:port. The cached address is dead weight
            # — replace it NOW and clear the probe clock so THIS refresh
            # probes the new address instead of waiting out the throttle
            # (or worse, keeping a HEALTHY replica routed to the corpse).
            _logger.info(
                "replica %s re-advertised %s (was %s); probing the new "
                "address", replica.task, endpoint, replica.endpoint,
            )
            replica.endpoint = endpoint
            replica.last_probe_at = None
            replica.relaunches += 1
            self._registry.counter("fleet/replica_relaunches_total").inc()
            if replica.state in (HEALTHY, STOPPED):
                # Out of rotation until the new incarnation proves
                # healthy; EJECTED stays ejected so the healthy probe
                # below counts a readmission.
                replica.state = PENDING
                replica.eject_reason = None
        else:
            replica.endpoint = endpoint
        if stopped:
            if (replica.stopped_endpoint is None
                    or replica.stopped_endpoint == endpoint):
                # Finished is not dead: out of rotation, no ejection
                # counted.
                replica.state = STOPPED
                replica.stopped_endpoint = endpoint
                return
            # The tombstone predates the current incarnation (the task
            # re-advertised a NEW endpoint after stopping): stale — fall
            # through and probe the live address.
        if beat_raw is not None:
            replica.ever_beat = True
            age = heartbeat_age(beat_raw, now=self._wall_clock())
            if (
                self.dead_heartbeat_s is not None
                and age is not None
                and age > self.dead_heartbeat_s
            ):
                # Beat-then-silent: the scheduler thread is gone even if
                # the socket still answers — do not probe it back in.
                if replica.state == HEALTHY:
                    self._eject(replica, "heartbeat_silent")
                return
        now = self._clock()
        if (
            not force
            and replica.last_probe_at is not None
            and now - replica.last_probe_at < self.probe_interval_s
        ):
            return
        replica.last_probe_at = now
        try:
            payload = self._probe(replica.endpoint)
        except Exception as exc:
            kind = classify_exception(exc)
            _logger.info(
                "probe of %s (%s) failed (%s: %s)", replica.task,
                replica.endpoint, kind.value, exc,
            )
            if replica.state == HEALTHY:
                self._eject(replica, "unreachable")
            # PENDING stays pending: admission held until first health.
            return
        replica.queue_depth = int(payload.get("queue_depth") or 0)
        replica.active_slots = int(payload.get("active_slots") or 0)
        version = payload.get("schema_version")
        try:
            replica.schema_version = (
                int(version) if version is not None else None
            )
        except (TypeError, ValueError):
            replica.schema_version = None
        status = payload.get("status")
        if status != "ok":
            # "draining" lands here: ejected while the replica is still
            # answering — the router stops sending BEFORE the socket dies.
            if replica.state == HEALTHY:
                self._eject(replica, str(status or "unhealthy"))
            return
        if replica.state == EJECTED:
            replica.readmissions += 1
            self._registry.counter("fleet/replica_readmissions_total").inc()
            _logger.info(
                "replica %s recovered (was ejected: %s); re-admitting",
                replica.task, replica.eject_reason,
            )
        replica.state = HEALTHY
        replica.eject_reason = None

    def _eject(self, replica: Replica, reason: str) -> None:
        replica.state = EJECTED
        replica.eject_reason = reason
        replica.ejections += 1
        self._registry.counter(
            "fleet/replica_ejections_total", reason=reason
        ).inc()
        _logger.warning(
            "ejecting replica %s (%s): %s", replica.task, replica.endpoint,
            reason,
        )

    # -- router-observed failures ------------------------------------------

    def report_failure(self, task: str, exc: BaseException) -> None:
        """A forward to `task` failed at the router: eject it NOW (the
        next request must route elsewhere without waiting a probe
        interval) and clear its probe clock so the next refresh probes
        for recovery immediately."""
        kind = classify_exception(exc)
        with self._lock:
            replica = self._replicas.get(task)
            if replica is None:
                return
            if replica.state == HEALTHY:
                self._eject(replica, f"request_{kind.value.lower()}")
            replica.last_probe_at = None
            self._registry.gauge("fleet/healthy_replicas").set(
                len(self._healthy_locked())
            )

    def note_inflight(self, task: str, delta: int) -> None:
        with self._lock:
            replica = self._replicas.get(task)
            if replica is not None:
                replica.inflight = max(0, replica.inflight + delta)

    # -- views --------------------------------------------------------------

    def _healthy_locked(
        self, kind: Optional[str] = None
    ) -> List[Replica]:
        return sorted(
            (
                r for r in self._replicas.values()
                if r.state == HEALTHY
                and (kind is None or r.kind == kind)
            ),
            key=lambda r: r.task,
        )

    def healthy(self, kind: Optional[str] = None) -> List[Replica]:
        """The routable set, optionally restricted to one capability
        kind — the router passes the kind its request path demands, so
        a /v1/rank request can never land on a generate replica.

        Returns per-call COPIES made under the lock: routing policies
        read load fields lock-free on their own threads, and a live
        Replica could be half-mutated by a concurrent refresh probe."""
        with self._lock:
            return [
                dataclasses.replace(r) for r in self._healthy_locked(kind)
            ]

    def get(self, task: str) -> Optional[Replica]:
        with self._lock:
            return self._replicas.get(task)

    def snapshot(self) -> dict:
        with self._lock:
            replicas = {
                task: replica.snapshot()
                for task, replica in sorted(self._replicas.items())
            }
            return {
                "replicas": replicas,
                "healthy_replicas": len(self._healthy_locked()),
                "ejections_total": sum(
                    r.ejections for r in self._replicas.values()
                ),
                "readmissions_total": sum(
                    r.readmissions for r in self._replicas.values()
                ),
            }
