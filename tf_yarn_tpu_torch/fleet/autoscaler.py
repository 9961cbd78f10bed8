"""Fleet autoscaler: the monitor's signals in, replica counts out — a copy
of tf_yarn_tpu/fleet/autoscaler.py.

A router side-car thread watches the fleet aggregate and the registry
and moves the per-kind replica count (generate, rank and prefill pools
independently: path-aware dispatch makes their load independent) through
a pluggable actuator:

* in-process harnesses (tests) pass an ``actuate=`` callable that starts
  or drains replicas directly;
* the launched router (`router.run_router`) records the desired count in
  the coordination KV (``event.fleet_desired_event``) for an operator to
  act on. Neither driver reads it: the JAX package's `run_on_tpu` does
  not either, whatever its autoscaler's docstring says, and an
  ``elastic_policy={"serving": ...}`` resizes a relaunch from the failure
  that ended the attempt, not from this target.

Decisions are thresholds, a step and a cooldown:

* **scale out** when the kind's fleet is below ``min_replicas``
  (self-healing: ignores the cooldown), when the mean queue depth per
  healthy replica crosses ``scale_out_queue_depth``, when the kind's
  fleet-merged p95 (TTFT for generate, request latency for rank) crosses
  ``scale_out_p95_s``, or when one of the kind's SLO objectives reports
  ``violated``;
* **scale in** when every live replica is healthy, nothing is queued and
  the mean load sits under ``scale_in_load``, never below
  ``min_replicas``;
* ``cooldown_cycles`` cycles follow every decision, so capacity that is
  coming but not healthy yet cannot trigger oscillation.

**Peer warm start**: when a generate replica enters the healthy set at an
endpoint the autoscaler has not seen its task at (a relaunch on a new
port, or a scale-out; a same-endpoint readmission kept its cache), the
autoscaler pulls the hottest prefix-cache blocks from a live peer
(``GET /v1/blocks``) and pushes them to the newcomer (``POST
/v1/blocks``), relaying the wire bytes verbatim.

Threading: one daemon thread (`start()`/`stop()`). `poll_once` gathers
the registry snapshot and the monitor aggregate first (under their own
locks), plans under ``self._lock``, actuates and warm-starts with no lock
held (HTTP never serializes against `stats()`), then records under the
lock again.
"""

from __future__ import annotations

import dataclasses
import http.client
import json
import logging
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from tf_yarn_tpu_torch import telemetry
from tf_yarn_tpu_torch.fleet.monitor import FleetMonitor
from tf_yarn_tpu_torch.fleet.registry import (
    HEALTHY,
    KIND_GENERATE,
    KIND_PREFILL,
    KIND_RANK,
    PENDING,
    ReplicaRegistry,
)

_logger = logging.getLogger(__name__)

KINDS = (KIND_GENERATE, KIND_RANK, KIND_PREFILL)

# Bounds on the launch-ETA hint the router's empty-fleet 503s carry as
# Retry-After: the floor keeps clients from hammering a fleet that is
# seconds from capacity, the ceiling keeps a misconfigured ETA from
# parking clients for an hour on a fleet that heals in one relaunch.
LAUNCH_ETA_FLOOR_S = 1.0
LAUNCH_ETA_CEILING_S = 600.0
DEFAULT_LAUNCH_ETA_S = 15.0

DEFAULT_INTERVAL_S = 1.0

# The fleet-merged latency histogram each kind's p95 trigger reads.
DEFAULT_SIGNALS = {
    KIND_GENERATE: "serving/ttft_seconds",
    KIND_RANK: "ranking/request_seconds",
    # Prefill replicas report their per-request build latency; a
    # saturated tier shows up as a fattening p95 (the tier has no queue
    # of its own — decode replicas fall back locally instead of
    # waiting, so latency IS the pressure signal).
    KIND_PREFILL: "serving/prefill_build_seconds",
}

# SLO objectives are matched to a kind by their metric prefix: a burn
# on serving/* scales the generate pool, ranking/* the rank pool.
# Prefill shares the serving/ namespace but must not double-claim those
# burns — a TTFT burn scales the GENERATE pool (local fallback keeps it
# the bottleneck); the prefill tier scales on its p95 signal alone.
_KIND_METRIC_PREFIXES = {
    KIND_GENERATE: ("serving/",),
    KIND_RANK: ("ranking/",),
    KIND_PREFILL: (),
}


def clamp_launch_eta(eta_s: float) -> float:
    """The bounded launch-ETA the router advertises (floor/ceiling)."""
    return min(LAUNCH_ETA_CEILING_S, max(LAUNCH_ETA_FLOOR_S, float(eta_s)))


@dataclasses.dataclass(frozen=True)
class AutoscalePolicy:
    """Per-kind scaling policy (module docstring for semantics)."""

    min_replicas: int = 1
    max_replicas: int = 1
    scale_out_queue_depth: Optional[float] = 4.0
    scale_out_p95_s: Optional[float] = None
    scale_in_load: Optional[float] = 0.5
    step: int = 1
    cooldown_cycles: int = 2
    signal: Optional[str] = None  # histogram key; kind default if None

    def __post_init__(self):
        if self.min_replicas < 0:
            raise ValueError(
                f"min_replicas must be >= 0, got {self.min_replicas}"
            )
        if self.max_replicas < max(1, self.min_replicas):
            raise ValueError(
                f"max_replicas ({self.max_replicas}) must be >= "
                f"max(1, min_replicas={self.min_replicas})"
            )
        if self.step < 1:
            raise ValueError(f"step must be >= 1, got {self.step}")
        if self.cooldown_cycles < 0:
            raise ValueError(
                f"cooldown_cycles must be >= 0, got {self.cooldown_cycles}"
            )
        for knob in ("scale_out_queue_depth", "scale_out_p95_s",
                     "scale_in_load"):
            value = getattr(self, knob)
            if value is not None and not float(value) > 0:
                raise ValueError(f"{knob} must be > 0 or None, got {value}")


def parse_autoscale(spec: Dict[str, Any]) -> Dict[str, AutoscalePolicy]:
    """Validate an ``autoscale=`` experiment knob: a dict keyed by
    replica kind (``generate`` / ``rank`` / ``prefill``) whose values are
    `AutoscalePolicy` field dicts (or ready policies). Raises ValueError
    naming the offending key, in the experiment-validation style."""
    if not isinstance(spec, dict) or not spec:
        raise ValueError(
            "autoscale must be a non-empty dict keyed by replica kind "
            f"('generate' / 'rank' / 'prefill'), got {spec!r}"
        )
    policies: Dict[str, AutoscalePolicy] = {}
    for kind, policy in spec.items():
        if kind not in KINDS:
            raise ValueError(
                f"autoscale kind {kind!r} unknown; expected one of {KINDS}"
            )
        if isinstance(policy, AutoscalePolicy):
            policies[kind] = policy
            continue
        if not isinstance(policy, dict):
            raise ValueError(
                f"autoscale[{kind!r}] must be a dict of AutoscalePolicy "
                f"fields, got {policy!r}"
            )
        try:
            policies[kind] = AutoscalePolicy(**policy)
        except TypeError as exc:
            raise ValueError(f"autoscale[{kind!r}]: {exc}") from None
    return policies


@dataclasses.dataclass(frozen=True)
class ScaleEvent:
    """One actuated decision, kept in the history `stats()` serves."""

    kind: str
    direction: str  # "out" | "in"
    from_replicas: int
    to_replicas: int
    reason: str
    cycle: int


def http_fetch_blocks(endpoint: str, timeout: float = 10.0) -> bytes:
    """``GET /v1/blocks`` on a donor replica; raw wire bytes on 200,
    raises otherwise. The warm-start pull — injectable seam."""
    host, _, port = endpoint.rpartition(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=timeout)
    try:
        conn.request("GET", "/v1/blocks")
        resp = conn.getresponse()
        payload = resp.read()
        if resp.status != 200:
            raise ConnectionError(
                f"/v1/blocks on {endpoint} answered {resp.status}"
            )
        return payload
    finally:
        conn.close()


def http_push_blocks(endpoint: str, body: bytes,
                     timeout: float = 10.0) -> dict:
    """``POST /v1/blocks`` to a newcomer replica; parsed JSON on 200,
    raises otherwise. The warm-start push — injectable seam."""
    host, _, port = endpoint.rpartition(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=timeout)
    try:
        conn.request("POST", "/v1/blocks", body=body, headers={
            "Content-Type": "application/json",
            "Content-Length": str(len(body)),
        })
        resp = conn.getresponse()
        payload = resp.read()
        if resp.status != 200:
            raise ConnectionError(
                f"/v1/blocks push to {endpoint} answered {resp.status}"
            )
        return json.loads(payload or b"{}")
    finally:
        conn.close()


class FleetAutoscaler:
    """Watch the fleet, move the per-kind replica counts (module
    docstring). ``actuate(kind, current, target, reason) -> bool`` is
    the resize actuator; a falsy/raising actuator records nothing and
    the decision is retried after the cooldown. ``actuate=None`` runs
    decision-only (the history and counters are the output — the KV
    advertisement path run_router wires up)."""

    def __init__(
        self,
        registry: ReplicaRegistry,
        monitor: Optional[FleetMonitor],
        policies: Dict[str, AutoscalePolicy],
        *,
        actuate: Optional[Callable[[str, int, int, str], bool]] = None,
        launch_eta_s: float = DEFAULT_LAUNCH_ETA_S,
        interval_s: float = DEFAULT_INTERVAL_S,
        warm_start: bool = True,
        fetch_blocks: Callable[[str], bytes] = http_fetch_blocks,
        push_blocks: Callable[[str, bytes], dict] = http_push_blocks,
        history_limit: int = 64,
    ) -> None:
        if not float(launch_eta_s) > 0:
            raise ValueError(
                f"launch_eta_s must be > 0, got {launch_eta_s}"
            )
        if not float(interval_s) > 0:
            raise ValueError(f"interval_s must be > 0, got {interval_s}")
        self._fleet = registry
        self._monitor = monitor
        self.policies = dict(parse_autoscale(policies))
        self.launch_eta_s = clamp_launch_eta(launch_eta_s)
        self.interval_s = float(interval_s)
        self.warm_start = bool(warm_start)
        self._actuate = actuate
        self._fetch_blocks = fetch_blocks
        self._push_blocks = push_blocks
        self._history_limit = int(history_limit)
        self._metrics = telemetry.get_registry()
        # Pre-register the decision counters so /stats signals carry
        # explicit zeros before the first event.
        for kind in self.policies:
            for direction in ("out", "in"):
                self._metrics.counter(
                    "fleet/scale_events_total",
                    kind=kind, direction=direction,
                )
        self._metrics.counter("fleet/warm_start_blocks_total")
        self._lock = threading.Lock()
        self._cycles = 0
        self._cooldown: Dict[str, int] = {kind: 0 for kind in self.policies}
        self._history: List[ScaleEvent] = []
        self._warm_starts: List[Dict[str, Any]] = []
        # Warm-start bookkeeping: the endpoint each task was last seen
        # healthy at. A healthy task at a NEW endpoint is a fresh
        # process (relaunch/scale-out) with a cold cache; a readmission
        # at the SAME endpoint kept its cache and needs nothing.
        self._known_endpoints: Dict[str, str] = {}
        self._stop = threading.Event()
        self._lifecycle = threading.Lock()
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle -----------------------------------------------------

    def start(self) -> None:
        with self._lifecycle:
            if self._thread is None:
                self._stop.clear()
                self._thread = threading.Thread(
                    target=self._run, name="fleet-autoscaler", daemon=True,
                )
                self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        with self._lifecycle:
            thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout=10.0)

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                self.poll_once()
            except Exception:
                _logger.warning("autoscaler cycle failed", exc_info=True)
            self._stop.wait(self.interval_s)

    # -- one decision cycle --------------------------------------------

    def poll_once(self) -> Dict[str, Any]:
        """Gather → plan → actuate → record. Returns a cycle report
        (decisions planned, actuated, warm starts performed)."""
        aggregate = (self._monitor.aggregate()
                     if self._monitor is not None else {})
        snapshot = self._fleet.snapshot()
        with self._lock:
            decisions = self._plan_locked(aggregate, snapshot)
            warm_candidates = self._warm_candidates_locked(snapshot)
        actuated: List[ScaleEvent] = []
        for event in decisions:
            ok = True
            if self._actuate is not None:
                try:
                    ok = bool(self._actuate(
                        event.kind, event.from_replicas,
                        event.to_replicas, event.reason,
                    ))
                except Exception:
                    _logger.warning(
                        "autoscaler actuation failed: %s", event,
                        exc_info=True,
                    )
                    ok = False
            if ok:
                self._metrics.counter(
                    "fleet/scale_events_total",
                    kind=event.kind, direction=event.direction,
                ).inc()
                _logger.info("fleet scale %s: %s", event.direction, event)
                actuated.append(event)
        warm_results = [
            self._warm_start_one(task, endpoint, donor)
            for task, endpoint, donor in warm_candidates
        ]
        with self._lock:
            self._cycles += 1
            self._history.extend(actuated)
            del self._history[:-self._history_limit]
            self._warm_starts.extend(warm_results)
            del self._warm_starts[:-self._history_limit]
            cycle = self._cycles
        return {
            "cycle": cycle,
            "decisions": [dataclasses.asdict(e) for e in decisions],
            "actuated": [dataclasses.asdict(e) for e in actuated],
            "warm_starts": warm_results,
        }

    def _plan_locked(self, aggregate: Dict[str, Any],
                     snapshot: Dict[str, Any]) -> List[ScaleEvent]:
        histograms = aggregate.get("histograms") or {}
        slo = aggregate.get("slo") or {}
        decisions: List[ScaleEvent] = []
        replicas = list((snapshot.get("replicas") or {}).values())
        for kind, policy in self.policies.items():
            pool = [r for r in replicas if r.get("kind") == kind]
            live = [r for r in pool if r.get("state") in (PENDING, HEALTHY)]
            healthy = [r for r in pool if r.get("state") == HEALTHY]
            current = len(live)
            # Self-healing floor: ignores cooldown — a fleet below its
            # minimum must not wait out a refractory period.
            if current < policy.min_replicas:
                decisions.append(self._decide_locked(
                    kind, policy, current,
                    min(policy.max_replicas,
                        max(policy.min_replicas, current + policy.step)),
                    "below_min",
                ))
                continue
            if self._cooldown.get(kind, 0) > 0:
                self._cooldown[kind] -= 1
                continue
            reason = self._scale_out_reason_locked(
                kind, policy, healthy, histograms, slo,
            )
            if reason is not None and current < policy.max_replicas:
                decisions.append(self._decide_locked(
                    kind, policy, current,
                    min(policy.max_replicas, current + policy.step),
                    reason,
                ))
                continue
            if (
                policy.scale_in_load is not None
                and current > policy.min_replicas
                and healthy and len(healthy) == current
            ):
                load = sum(
                    (r.get("queue_depth") or 0)
                    + (r.get("active_slots") or 0)
                    + (r.get("inflight") or 0)
                    for r in healthy
                ) / len(healthy)
                if load < policy.scale_in_load:
                    decisions.append(self._decide_locked(
                        kind, policy, current,
                        max(policy.min_replicas, current - policy.step),
                        f"idle_load_{load:.2f}",
                    ))
        return decisions

    def _decide_locked(self, kind: str, policy: AutoscalePolicy,
                       current: int, target: int, reason: str) -> ScaleEvent:
        self._cooldown[kind] = policy.cooldown_cycles
        return ScaleEvent(
            kind=kind,
            direction="out" if target > current else "in",
            from_replicas=current,
            to_replicas=target,
            reason=reason,
            cycle=self._cycles + 1,
        )

    def _scale_out_reason_locked(
        self,
        kind: str,
        policy: AutoscalePolicy,
        healthy: List[Dict[str, Any]],
        histograms: Dict[str, Any],
        slo: Dict[str, Any],
    ) -> Optional[str]:
        if policy.scale_out_queue_depth is not None and healthy:
            depth = sum(
                (r.get("queue_depth") or 0) for r in healthy
            ) / len(healthy)
            if depth >= policy.scale_out_queue_depth:
                return f"queue_depth_{depth:.2f}"
        signal = policy.signal or DEFAULT_SIGNALS.get(kind)
        if policy.scale_out_p95_s is not None and signal:
            summary = histograms.get(signal) or {}
            p95 = summary.get("p95")
            if p95 is not None and p95 > policy.scale_out_p95_s:
                return f"p95_{p95:.3f}s"
        prefixes = _KIND_METRIC_PREFIXES.get(kind, ())
        for name, entry in sorted(slo.items()):
            metric = str(entry.get("metric") or "")
            if entry.get("status") == "violated" and \
                    metric.startswith(prefixes):
                return f"slo_burn_{name}"
        return None

    # -- peer warm start -----------------------------------------------

    def _warm_candidates_locked(
        self, snapshot: Dict[str, Any]
    ) -> List[Tuple[str, str, str]]:
        """(task, endpoint, donor endpoint) for every generate replica
        that just entered the healthy set AT A NEW ENDPOINT with a warm
        peer available. Endpoint change is the cold-cache signal: a
        scale-out newcomer and a relaunched preemption victim both show
        up at an address this autoscaler has never seen the task at,
        while a same-endpoint readmission (transient probe failure, the
        process never died) kept its cache and is skipped. Bookkeeping
        updates here (optimistically — a failed pull is recorded, not
        retried every cycle)."""
        if not self.warm_start:
            return []
        replicas = (snapshot.get("replicas") or {}).values()
        healthy_gen = [
            r for r in replicas
            if r.get("kind") == KIND_GENERATE
            and r.get("state") == HEALTHY and r.get("endpoint")
        ]
        # First sight of a running fleet: everyone present is warm
        # already (or there is nobody to pull from) — record, no pulls.
        first_sight = not self._known_endpoints
        fresh: List[Dict[str, Any]] = []
        veterans: List[Dict[str, Any]] = []
        for replica in healthy_gen:
            task = replica["task"]
            endpoint = replica["endpoint"]
            previous = self._known_endpoints.get(task)
            self._known_endpoints[task] = endpoint
            if first_sight or previous == endpoint:
                veterans.append(replica)
            else:
                fresh.append(replica)
        # Donors come from the veterans only: a fellow fresh replica is
        # exactly as cold as the puller and a pull from it ships air.
        candidates: List[Tuple[str, str, str]] = []
        for replica in fresh:
            donors = [
                v for v in veterans
                if v["endpoint"] != replica["endpoint"]
            ]
            if not donors:
                continue  # nothing warm to pull from: stays cold
            candidates.append(
                (replica["task"], replica["endpoint"],
                 donors[0]["endpoint"])
            )
        return candidates

    def _warm_start_one(self, task: str, endpoint: str,
                        donor: str) -> Dict[str, Any]:
        record: Dict[str, Any] = {"task": task, "donor": donor}
        try:
            wire = self._fetch_blocks(donor)
            result = self._push_blocks(endpoint, wire)
        except Exception as exc:
            _logger.warning(
                "warm start of %s from %s failed: %s", task, donor, exc,
            )
            record["error"] = str(exc)
            return record
        imported = int(result.get("imported_blocks") or 0)
        record["imported_blocks"] = imported
        record["registered_entries"] = int(
            result.get("registered_entries") or 0
        )
        if imported:
            self._metrics.counter(
                "fleet/warm_start_blocks_total").inc(imported)
        _logger.info(
            "warm-started %s from %s: %d blocks, %d entries",
            task, donor, imported, record["registered_entries"],
        )
        return record

    # -- views ---------------------------------------------------------

    def launch_eta_hint(self) -> float:
        """Seconds until scaled-out capacity should be admitting — the
        Retry-After the router's empty-fleet 503s carry. Already
        clamped to [LAUNCH_ETA_FLOOR_S, LAUNCH_ETA_CEILING_S]."""
        return self.launch_eta_s

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "cycles": self._cycles,
                "launch_eta_s": self.launch_eta_s,
                "policies": {
                    kind: dataclasses.asdict(policy)
                    for kind, policy in sorted(self.policies.items())
                },
                "cooldowns": dict(self._cooldown),
                "scale_events": [
                    dataclasses.asdict(e) for e in self._history
                ],
                "warm_starts": [dict(w) for w in self._warm_starts],
            }
