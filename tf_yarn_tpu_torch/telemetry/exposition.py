"""Wire formats for the metrics registry: Prometheus text exposition
and the versioned machine-readable `signals` block.

Two consumers, two formats. `/metrics` serves `render_prometheus(...)`
— the standard text format (version 0.0.4) any Prometheus-compatible
scraper understands: counters and gauges verbatim, histograms as
summary families (`_count`/`_sum` plus `quantile=...` lines). `/stats`
embeds `signals_block(...)` — the lossless form: windowed bucket
sketches (`Histogram.to_signal`) that a `fleet.FleetMonitor` can merge
into TRUE pooled fleet quantiles, which the flat quantile lines in the
Prometheus form cannot support (you cannot average p95s).

Both payloads are versioned. `STATS_SCHEMA_VERSION` stamps the whole
`/stats` (and `/healthz`) body; `SIGNALS_VERSION` stamps the signals
block independently so the two can evolve apart. Readers
(`fleet/registry.py`, `fleet/monitor.py`) tolerate missing versions —
a legacy replica keeps routing during a mixed-version rollout.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Iterable, Optional, Tuple

from tf_yarn_tpu_torch.telemetry.registry import (
    Counter,
    Histogram,
    MetricsRegistry,
    _format_key,
    get_registry,
)

# Version of the /healthz + /stats payload envelope. Version 1 is the
# implicit pre-versioning format (no `schema_version` key, no
# `signals`); readers treat a missing version as 1.
STATS_SCHEMA_VERSION = 2

# Version of the `signals` block inside /stats.
SIGNALS_VERSION = 1

PROMETHEUS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")
_LABEL_RE = re.compile(r"[^a-zA-Z0-9_]")

_QUANTILES: Tuple[Tuple[str, float], ...] = (
    ("0.5", 0.5), ("0.95", 0.95), ("0.99", 0.99),
)


def _metric_name(name: str) -> str:
    name = _NAME_RE.sub("_", name)
    if name and name[0].isdigit():
        name = "_" + name
    return name


def _label_str(labels: Iterable[Tuple[str, str]]) -> str:
    parts = []
    for key, value in labels:
        value = (str(value).replace("\\", r"\\")
                 .replace('"', r'\"').replace("\n", r"\n"))
        parts.append(f'{_LABEL_RE.sub("_", key)}="{value}"')
    return ",".join(parts)


def _line(name: str, labels: str, value: float) -> str:
    if isinstance(value, float) and value != value:  # NaN guard
        value = 0.0
    body = f"{name}{{{labels}}}" if labels else name
    return f"{body} {value}"


def render_prometheus(registry: Optional[MetricsRegistry] = None) -> str:
    """Render every instrument in `registry` (default: the process
    registry) as Prometheus text exposition. Deterministic order
    (sorted by name, then labels); one `# TYPE` line per family."""
    registry = registry or get_registry()
    lines = []
    last_family = None
    for (name, labels), inst in registry.items():
        family = _metric_name(name)
        label_str = _label_str(labels)
        if isinstance(inst, Histogram):
            if family != last_family:
                lines.append(f"# TYPE {family} summary")
                last_family = family
            summ = inst.summary()
            for qlabel, q in _QUANTILES:
                est = inst.quantile(q)
                if est is None:
                    continue
                qstr = (f'{label_str},quantile="{qlabel}"' if label_str
                        else f'quantile="{qlabel}"')
                lines.append(_line(family, qstr, est))
            lines.append(_line(f"{family}_count", label_str,
                               summ.get("count", 0.0)))
            lines.append(_line(f"{family}_sum", label_str,
                               summ.get("sum", 0.0)))
        else:
            if family != last_family:
                kind = "counter" if isinstance(inst, Counter) else "gauge"
                lines.append(f"# TYPE {family} {kind}")
                last_family = family
            lines.append(_line(family, label_str, inst.value))
    return "\n".join(lines) + "\n"


def signals_block(
    registry: Optional[MetricsRegistry] = None,
    *,
    prefixes: Tuple[str, ...] = (),
) -> Dict[str, Any]:
    """The versioned machine-readable block embedded in `/stats`:
    windowed histogram bucket sketches plus scalar gauges/counters,
    keyed by the same ``name{label=value}`` strings as `snapshot()`.
    `prefixes` restricts to metric names under those namespaces (e.g.
    ``("serving/",)`` for a generate replica) — empty means all."""
    registry = registry or get_registry()
    histograms: Dict[str, Any] = {}
    scalars: Dict[str, float] = {}
    for (name, labels), inst in registry.items():
        if prefixes and not any(name.startswith(p) for p in prefixes):
            continue
        key = _format_key(name, labels)
        if isinstance(inst, Histogram):
            histograms[key] = inst.to_signal(window=True)
        else:
            scalars[key] = inst.value
    return {
        "version": SIGNALS_VERSION,
        "histograms": histograms,
        "scalars": scalars,
    }
