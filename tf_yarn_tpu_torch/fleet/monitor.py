"""FleetMonitor: the router-side scrape-and-merge aggregator — a copy of
tf_yarn_tpu/fleet/monitor.py.

The registry answers "which replicas are routable"; the monitor answers
"how is the fleet doing". Each cycle (by default the registry's probe
interval, floored at ``MIN_DEFAULT_INTERVAL_S``: a ``/stats`` scrape
serializes every replica's sketches) it GETs ``/stats`` from every
HEALTHY replica and merges the windowed histogram sketches of their
``signals`` blocks bucket for bucket: the fleet TTFT p95 is a pooled
quantile over every replica's recent observations, not a max of p95s.

Degradation:

* a failed scrape keeps that replica's last good signals in the merge,
  marked ``stale`` (per replica and as a count on the aggregate);
* a replica without a ``signals`` block stays routable and is reported
  ``legacy``; it contributes no histograms;
* an empty fleet yields ``{"status": "no_data"}``, never zeros (a zero
  p95 would read as "instant" to the autoscaler).

The aggregate is published as `aggregate()` (the router's ``/stats``
``fleet`` block, the autoscaler's input), as ``fleet/<metric>{agg=pNN}``
gauges (the router's ``/metrics``), and, with ``slo=`` objectives, as a
fleet-scoped `SloEvaluator` pass over the merged histograms
(``slo/attainment{scope=fleet}``, ``slo/burn_total{scope=fleet}``).

Threading: one daemon thread, started by `start()` and joined by
`stop()`; the monitor's state is read and written under ``self._lock``,
and `aggregate()` returns deep copies, so handler threads never alias a
cycle in progress.
"""

from __future__ import annotations

import copy
import http.client
import json
import logging
import threading
import time
from typing import Any, Callable, Dict, Optional

from tf_yarn_tpu_torch import telemetry
from tf_yarn_tpu_torch.fleet.registry import (
    DEFAULT_PROBE_TIMEOUT_S,
    ReplicaRegistry,
)
from tf_yarn_tpu_torch.telemetry.registry import Histogram
from tf_yarn_tpu_torch.telemetry.slo import SloEvaluator, parse_slo

_logger = logging.getLogger(__name__)

# Quantiles published per merged histogram, both in the aggregate dict
# and as fleet/<metric>{agg=...} gauges.
_AGGS = (("p50", 0.5), ("p95", 0.95), ("p99", 0.99))

# Floor on the *defaulted* scrape cadence. Health probes are cheap and
# are commonly configured well under a second; a /stats scrape makes
# every replica serialize its full signals block, so piggybacking on a
# sub-second probe interval would turn the monitor into a load
# generator. An explicit ``interval_s=`` is honored verbatim.
MIN_DEFAULT_INTERVAL_S = 1.0


def http_scrape(endpoint: str,
                timeout: float = DEFAULT_PROBE_TIMEOUT_S) -> dict:
    """GET ``/stats`` on a replica; parsed JSON on HTTP 200, raises
    otherwise. The default scrape — tests inject fakes through the
    ``scrape=`` seam exactly like the registry's ``probe=``."""
    host, _, port = endpoint.rpartition(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=timeout)
    try:
        conn.request("GET", "/stats")
        resp = conn.getresponse()
        payload = resp.read()
        if resp.status != 200:
            raise ConnectionError(
                f"/stats on {endpoint} answered {resp.status}"
            )
        return json.loads(payload or b"{}")
    finally:
        conn.close()


class FleetMonitor:
    """Scrape HEALTHY replicas' signals, merge into fleet aggregates."""

    def __init__(
        self,
        registry: ReplicaRegistry,
        *,
        scrape: Callable[[str], dict] = http_scrape,
        interval_s: Optional[float] = None,
        slo: Optional[Dict[str, float]] = None,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        self._fleet = registry
        self._scrape = scrape
        self.interval_s = float(
            interval_s if interval_s is not None
            else max(registry.probe_interval_s, MIN_DEFAULT_INTERVAL_S)
        )
        self._clock = clock
        self._metrics = telemetry.get_registry()
        self._slo_evaluator: Optional[SloEvaluator] = None
        if slo:
            self._slo_evaluator = SloEvaluator(
                parse_slo(slo), self._metrics, scope="fleet",
            )
        self._lock = threading.Lock()
        # task -> last successfully-scraped signals payload (the
        # last-good fallback a failed scrape falls back to).
        self._last_good: Dict[str, Dict[str, Any]] = {}
        self._aggregate: Dict[str, Any] = {"status": "no_data",
                                           "replicas": {}}
        self._cycles = 0
        self._stop = threading.Event()
        self._lifecycle = threading.Lock()
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle -----------------------------------------------------

    def start(self) -> None:
        with self._lifecycle:
            if self._thread is None:
                self._stop.clear()
                self._thread = threading.Thread(
                    target=self._run, name="fleet-monitor", daemon=True,
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
                _logger.warning("fleet monitor cycle failed", exc_info=True)
            self._stop.wait(self.interval_s)

    # -- one scrape-and-merge cycle ------------------------------------

    def poll_once(self) -> Dict[str, Any]:
        """Scrape every healthy replica, rebuild the merged aggregate,
        publish gauges + fleet SLO. Returns the fresh aggregate."""
        replicas = self._fleet.healthy()
        replica_views: Dict[str, Dict[str, Any]] = {}
        merged: Dict[str, Histogram] = {}
        contributing = 0
        stale = 0
        scrape_wall = 0.0
        for replica in replicas:
            if not replica.endpoint:
                continue
            view: Dict[str, Any] = {"kind": replica.kind, "stale": False,
                                    "legacy": False}
            began = self._clock()
            try:
                payload = self._scrape(replica.endpoint)
            except Exception as exc:
                elapsed = self._clock() - began
                scrape_wall += elapsed
                self._metrics.counter(
                    "fleet/monitor_scrapes_total", outcome="error").inc()
                _logger.info("signals scrape of %s (%s) failed: %s",
                             replica.task, replica.endpoint, exc)
                with self._lock:
                    payload = self._last_good.get(replica.task)
                if payload is None:
                    # Never scraped: nothing to fall back to; the
                    # replica stays routable, just unobserved.
                    view["stale"] = True
                    view["signals"] = "never_scraped"
                    replica_views[replica.task] = view
                    stale += 1
                    continue
                view["stale"] = True
                stale += 1
            else:
                elapsed = self._clock() - began
                scrape_wall += elapsed
                self._metrics.counter(
                    "fleet/monitor_scrapes_total", outcome="ok").inc()
                self._metrics.histogram(
                    "fleet/monitor_scrape_seconds").observe(elapsed)
                with self._lock:
                    self._last_good[replica.task] = payload
            view["schema_version"] = payload.get("schema_version")
            signals = payload.get("signals")
            if not isinstance(signals, dict):
                # Pre-observability replica: /stats without a signals
                # block. Keep it routable; it contributes nothing.
                view["legacy"] = True
                replica_views[replica.task] = view
                continue
            contributed = False
            for key, signal in (signals.get("histograms") or {}).items():
                shard = Histogram.from_signal(signal)
                if shard is None:
                    continue  # version/scheme mismatch: skip this one
                contributed = True
                if key in merged:
                    merged[key].merge(shard)
                else:
                    merged[key] = shard
            if contributed or not (signals.get("histograms") or {}):
                contributing += 1
            replica_views[replica.task] = view

        aggregate = self._build_aggregate(
            replica_views, merged, contributing, stale, scrape_wall,
        )
        with self._lock:
            self._cycles += 1
            aggregate["cycle"] = self._cycles
            self._aggregate = aggregate
        self._publish(merged, stale)
        return self.aggregate()

    def _build_aggregate(
        self,
        replica_views: Dict[str, Dict[str, Any]],
        merged: Dict[str, Histogram],
        contributing: int,
        stale: int,
        scrape_wall: float,
    ) -> Dict[str, Any]:
        if not replica_views or not merged:
            # Explicitly NOT zeros: an empty fleet (or one with no
            # signal-bearing replica yet) must not read as "instant".
            return {
                "status": "no_data",
                "replicas": replica_views,
                "stale_replicas": stale,
            }
        histograms: Dict[str, Dict[str, float]] = {}
        for key, hist in sorted(merged.items()):
            summ = hist.summary()
            histograms[key] = summ
        return {
            "status": "ok",
            "replicas": replica_views,
            "contributing_replicas": contributing,
            "stale_replicas": stale,
            "scrape_wall_s": scrape_wall,
            "histograms": histograms,
            "slo": (self._slo_evaluator.evaluate(histograms=merged)
                    if self._slo_evaluator is not None else {}),
        }

    def _publish(self, merged: Dict[str, Histogram], stale: int) -> None:
        self._metrics.gauge("fleet/monitor_stale_replicas").set(stale)
        for key, hist in merged.items():
            if "{" in key:
                # Labeled shards (e.g. per-tier TTFT) stay in the
                # aggregate dict; the gauge namespace publishes the
                # unlabeled headline series.
                continue
            for agg, q in _AGGS:
                est = hist.quantile(q)
                if est is not None:
                    self._metrics.gauge(
                        f"fleet/{key}", agg=agg).set(est)
            self._metrics.gauge(f"fleet/{key}", agg="count").set(hist.count)

    # -- views ---------------------------------------------------------

    def aggregate(self) -> Dict[str, Any]:
        """The latest merged fleet view (deep copy; handler threads may
        call this concurrently with the scrape thread)."""
        with self._lock:
            return copy.deepcopy(self._aggregate)
