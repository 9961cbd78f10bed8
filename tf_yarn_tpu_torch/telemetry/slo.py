"""Declared service-level objectives evaluated over histogram windows.

An SLO is declared on the experiment as a flat dict, e.g.::

    ServingExperiment(..., slo={"interactive_ttft_p95_s": 0.5,
                                "itl_p99_ms": 80.0})

Objective grammar: ``[<tier>_]<metric>_p<NN>_<unit>`` where tier is one
of ``interactive``/``standard``/``batch`` (optional; scopes the
objective to that tier's labeled histogram), metric is ``ttft``
(serving/ttft_seconds, unit s), ``itl``
(serving/inter_token_latency_ms, unit ms), ``queue_wait``
(serving/queue_wait_seconds, unit s) or ``rank``
(ranking/request_seconds, unit s), ``NN`` is the percentile (1-99) and
the unit suffix must match the metric's native unit — the threshold is
compared in that unit with no conversion.

`SloEvaluator` evaluates objectives over the histograms' sliding
window (recent ~60s, not lifetime: an SLO describes "now") and
surfaces each as a ``slo/attainment{objective=,scope=}`` gauge (1
attained, 0 violated) and a ``slo/burn_total{objective=,scope=}``
counter that increments once per evaluation-in-violation — the
burn-rate signal ROADMAP item 4's auto-rollback watches. An objective
with no window data reports ``no_data`` status and touches neither
gauge nor counter (absence of traffic is not a burn).

The same evaluator serves both scopes: a replica evaluates its own
registry (`evaluate()`), the fleet monitor evaluates merged scrape
histograms (`evaluate(histograms=...)`) under ``scope=fleet``.
"""

from __future__ import annotations

import dataclasses
import re
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from tf_yarn_tpu_torch.telemetry.registry import (
    Histogram,
    MetricsRegistry,
    _format_key,
    get_registry,
)

_TIERS = ("interactive", "standard", "batch")

# short metric name -> (histogram name, native unit)
_METRICS: Dict[str, Tuple[str, str]] = {
    "ttft": ("serving/ttft_seconds", "s"),
    "itl": ("serving/inter_token_latency_ms", "ms"),
    "queue_wait": ("serving/queue_wait_seconds", "s"),
    "rank": ("ranking/request_seconds", "s"),
}

_OBJECTIVE_RE = re.compile(
    r"^(?:(interactive|standard|batch)_)?"
    r"(ttft|itl|queue_wait|rank)_p(\d{1,2})_(s|ms)$"
)


@dataclasses.dataclass(frozen=True)
class SloObjective:
    """One parsed objective: `metric` at `quantile` must stay at or
    under `threshold` (in the metric's native unit)."""

    name: str
    metric: str
    labels: Tuple[Tuple[str, str], ...]
    quantile: float
    threshold: float

    @property
    def key(self) -> str:
        """The ``name{label=value}`` snapshot key this objective reads."""
        return _format_key(self.metric, self.labels)


def parse_slo(slo: Dict[str, Any]) -> List[SloObjective]:
    """Parse and validate an `slo=` dict into objectives. Raises
    ValueError naming the offending key, in the experiment knob
    validation style."""
    if not isinstance(slo, dict):
        raise ValueError(f"slo must be a dict of objectives, got {slo!r}")
    objectives: List[SloObjective] = []
    for name, threshold in sorted(slo.items()):
        match = _OBJECTIVE_RE.match(str(name))
        if not match:
            raise ValueError(
                f"slo objective {name!r} does not match "
                "'[interactive_|standard_|batch_]"
                "(ttft|itl|queue_wait|rank)_p<NN>_(s|ms)'"
            )
        tier, short, pct_str, unit = match.groups()
        metric, native_unit = _METRICS[short]
        if unit != native_unit:
            raise ValueError(
                f"slo objective {name!r}: {short} is measured in "
                f"{native_unit!r}, not {unit!r}"
            )
        pct = int(pct_str)
        if not 1 <= pct <= 99:
            raise ValueError(
                f"slo objective {name!r}: percentile must be 1-99, "
                f"got {pct}"
            )
        try:
            threshold = float(threshold)
        except (TypeError, ValueError):
            raise ValueError(
                f"slo objective {name!r}: threshold must be a number, "
                f"got {threshold!r}"
            )
        if not threshold > 0:
            raise ValueError(
                f"slo objective {name!r}: threshold must be > 0, "
                f"got {threshold}"
            )
        labels = (("tier", tier),) if tier else ()
        objectives.append(SloObjective(
            name=str(name), metric=metric, labels=labels,
            quantile=pct / 100.0, threshold=threshold,
        ))
    return objectives


class SloEvaluator:
    """Evaluate parsed objectives against live histograms on a rate
    limit, publishing attainment gauges and burn counters."""

    def __init__(
        self,
        objectives: List[SloObjective],
        registry: Optional[MetricsRegistry] = None,
        *,
        scope: str = "replica",
        min_interval_s: float = 1.0,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        self._objectives = list(objectives)
        self._registry = registry or get_registry()
        self._scope = scope
        self._min_interval_s = float(min_interval_s)
        self._clock = clock
        self._lock = threading.Lock()
        self._last_eval_at: Optional[float] = None
        self._last_report: Dict[str, Dict[str, Any]] = {}
        # Pre-register burn counters so scrapers see an explicit 0
        # before the first violation (rate() needs the zero sample).
        for obj in self._objectives:
            self._registry.counter(
                "slo/burn_total", objective=obj.name, scope=self._scope)

    @property
    def objectives(self) -> List[SloObjective]:
        return list(self._objectives)

    def _lookup(self, objective: SloObjective) -> Optional[Histogram]:
        for labels, hist in self._registry.find_histograms(objective.metric):
            if labels == objective.labels:
                return hist
        return None

    def evaluate(
        self,
        histograms: Optional[Dict[str, Histogram]] = None,
        *,
        window: bool = True,
    ) -> Dict[str, Dict[str, Any]]:
        """Evaluate every objective now. With `histograms` (a
        ``{snapshot_key: Histogram}`` map, e.g. the fleet monitor's
        merged aggregates) objectives read from it; otherwise from the
        evaluator's registry over the sliding window."""
        report: Dict[str, Dict[str, Any]] = {}
        for obj in self._objectives:
            if histograms is not None:
                hist = histograms.get(obj.key)
                est = hist.quantile(obj.quantile) if hist else None
            else:
                hist = self._lookup(obj)
                est = (hist.quantile(obj.quantile, window=window)
                       if hist else None)
            entry: Dict[str, Any] = {
                "objective": obj.name,
                "threshold": obj.threshold,
                "quantile": obj.quantile,
                "metric": obj.key,
            }
            if est is None:
                entry["status"] = "no_data"
            else:
                attained = est <= obj.threshold
                entry["status"] = "ok" if attained else "violated"
                entry["value"] = est
                self._registry.gauge(
                    "slo/attainment", objective=obj.name, scope=self._scope,
                ).set(1.0 if attained else 0.0)
                if not attained:
                    self._registry.counter(
                        "slo/burn_total", objective=obj.name,
                        scope=self._scope,
                    ).inc()
            report[obj.name] = entry
        with self._lock:
            self._last_eval_at = self._clock()
            self._last_report = report
        return report

    def maybe_evaluate(self) -> Optional[Dict[str, Dict[str, Any]]]:
        """Evaluate if at least `min_interval_s` has passed since the
        last evaluation; cheap enough for a poll loop. Returns the
        fresh report, or None when rate-limited."""
        if not self._objectives:
            return None
        now = self._clock()
        with self._lock:
            if (self._last_eval_at is not None
                    and now - self._last_eval_at < self._min_interval_s):
                return None
        return self.evaluate()

    def report(self) -> Dict[str, Dict[str, Any]]:
        """Last evaluation's per-objective report (empty before the
        first evaluation)."""
        with self._lock:
            return {name: dict(entry)
                    for name, entry in self._last_report.items()}
