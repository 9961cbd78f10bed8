"""Process-global metrics registry: counters, gauges, histograms.

The numeric half of the telemetry layer (spans are the temporal half):
instruments are named, optionally labeled, and live in one
process-global registry so every subsystem — scheduler, decode engine,
HTTP frontend — reports into the same snapshot. `snapshot()` flattens
everything into a flat ``{"name{label=value}": number}`` dict; the
serving frontend renders it through `/stats` and `/metrics`
(telemetry/exposition.py), and `flush_metrics` ships it to the log,
MLflow and the run's KV store (``{task}/metrics``).

Thread-safe throughout; instruments are cheap enough for per-step use
(a lock + a float update). Everything here is host-side only.
"""

from __future__ import annotations

import collections
import json
import logging
import math
import re
import threading
import time
from typing import Any, Deque, Dict, List, Optional, Tuple

_logger = logging.getLogger(__name__)

LabelKey = Tuple[str, Tuple[Tuple[str, str], ...]]


def _label_key(name: str, labels: Dict[str, Any]) -> LabelKey:
    return name, tuple(sorted((k, str(v)) for k, v in labels.items()))


def _format_key(name: str, labels: Tuple[Tuple[str, str], ...]) -> str:
    if not labels:
        return name
    inner = ",".join(f"{k}={v}" for k, v in labels)
    return f"{name}{{{inner}}}"


class Counter:
    """Monotonic counter; `inc` only."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError(f"counters only go up, got {amount}")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Gauge:
    """Last-write-wins value."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


# Log-spaced bucket scheme shared by every Histogram in the process
# (fixed, so any two histograms — or signals shipped between tasks —
# merge bucket-for-bucket). gamma = (1+alpha)/(1-alpha) guarantees any
# quantile estimate is within `alpha` RELATIVE error of a true sample
# value: bucket i covers (gamma^(i-1), gamma^i], and the midpoint
# estimate 2*gamma^i/(gamma+1) is within alpha of everything inside.
HIST_ALPHA = 0.05
_GAMMA = (1.0 + HIST_ALPHA) / (1.0 - HIST_ALPHA)
_LOG_GAMMA = math.log(_GAMMA)
# Magnitudes below this collapse into a dedicated zero bucket (covers
# exact 0.0 and denormal-ish noise; latencies never get near it).
HIST_MIN_TRACKED = 1e-9
HIST_SIGNAL_VERSION = 1

# Sliding window: quantiles over "the recent past" for SLO evaluation
# and fleet scrape, vs the lifetime distribution. The window is a ring
# of SLICES sub-histograms each covering WINDOW_S/SLICES seconds;
# expiry is whole-slice, so the effective window is WINDOW_S ±
# one slice. Module constants (not ctor args) because the registry
# instantiates instruments with no arguments.
HIST_WINDOW_S = 60.0
HIST_WINDOW_SLICES = 6
_SLICE_S = HIST_WINDOW_S / HIST_WINDOW_SLICES


def _bucket_index(value: float) -> int:
    return int(math.ceil(math.log(value) / _LOG_GAMMA))


def bucket_value(index: int) -> float:
    """Representative value for bucket `index` (midpoint-ish estimate
    with relative error <= HIST_ALPHA for anything in the bucket)."""
    return 2.0 * _GAMMA ** index / (_GAMMA + 1.0)


class _WindowSlice:
    __slots__ = ("epoch", "zero", "buckets", "count", "total")

    def __init__(self, epoch: int) -> None:
        self.epoch = epoch
        self.zero = 0
        self.buckets: Dict[int, int] = {}
        self.count = 0
        self.total = 0.0


class Histogram:
    """Mergeable quantile histogram over fixed log-spaced buckets.

    The summary contract (`count/sum/mean/min/max/last`) is unchanged
    from the old summary-only implementation; on top of it the bucket
    sketch adds `quantile(q)` (relative error <= HIST_ALPHA, asserted
    in tests), `merge(other)` (pooled distributions — a fleet p95 from
    replica shards is a true pooled quantile, not a max-of-p95s), a
    sliding recent-window view, and a wire form (`to_signal` /
    `from_signal`) for cross-task scraping.

    Negative observations are folded into the zero bucket by magnitude
    sign-insensitively is NOT done — values < HIST_MIN_TRACKED
    (including negatives; latencies are non-negative) land in the zero
    bucket, whose representative value is 0.0. Non-finite observations
    are dropped (and counted in `telemetry/dropped_observations_total`)
    rather than poisoning min/max/mean/buckets.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.count = 0
        self.total = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None
        self.last = 0.0
        self._zero = 0
        self._buckets: Dict[int, int] = {}
        self._window: Deque[_WindowSlice] = collections.deque()

    # -- write path ---------------------------------------------------

    def observe(self, value: float) -> None:
        value = float(value)
        if not math.isfinite(value):
            # Count the drop on the global registry (not self: this
            # histogram may track seconds; the drop count is a fleet
            # health signal of its own).
            _GLOBAL_REGISTRY.counter(
                "telemetry/dropped_observations_total"
            ).inc()
            return
        idx: Optional[int] = None
        if value >= HIST_MIN_TRACKED:
            idx = _bucket_index(value)
        now = time.monotonic()
        with self._lock:
            self.count += 1
            self.total += value
            self.last = value
            self.min = value if self.min is None else min(self.min, value)
            self.max = value if self.max is None else max(self.max, value)
            if idx is None:
                self._zero += 1
            else:
                self._buckets[idx] = self._buckets.get(idx, 0) + 1
            cur = self._current_slice_locked(now)
            cur.count += 1
            cur.total += value
            if idx is None:
                cur.zero += 1
            else:
                cur.buckets[idx] = cur.buckets.get(idx, 0) + 1

    def _current_slice_locked(self, now: float) -> _WindowSlice:
        # Caller holds self._lock.
        epoch = int(now / _SLICE_S)
        self._expire_locked(epoch)
        if not self._window or self._window[-1].epoch != epoch:
            self._window.append(_WindowSlice(epoch))
        return self._window[-1]

    def _expire_locked(self, epoch: int) -> None:
        # Caller holds self._lock. Keep slices whose epoch is within
        # the window of `epoch` (inclusive of the current slice).
        horizon = epoch - HIST_WINDOW_SLICES
        while self._window and self._window[0].epoch <= horizon:
            self._window.popleft()

    # -- read path ----------------------------------------------------

    def _pooled_locked(self, window: bool) -> Tuple[int, Dict[int, int], int, float]:
        # Caller holds self._lock. Returns (zero, buckets, count, total).
        if not window:
            return self._zero, self._buckets, self.count, self.total
        self._expire_locked(int(time.monotonic() / _SLICE_S))
        zero = 0
        count = 0
        total = 0.0
        buckets: Dict[int, int] = {}
        for sl in self._window:
            zero += sl.zero
            count += sl.count
            total += sl.total
            for idx, n in sl.buckets.items():
                buckets[idx] = buckets.get(idx, 0) + n
        return zero, buckets, count, total

    @staticmethod
    def _quantile_of(zero: int, buckets: Dict[int, int], count: int,
                     q: float) -> Optional[float]:
        if count <= 0:
            return None
        q = min(1.0, max(0.0, q))
        rank = q * (count - 1)  # 0-based rank, nearest-rank style
        seen = zero
        if rank < seen:
            return 0.0
        for idx in sorted(buckets):
            seen += buckets[idx]
            if rank < seen:
                return bucket_value(idx)
        return bucket_value(max(buckets)) if buckets else 0.0

    def quantile(self, q: float, *, window: bool = False) -> Optional[float]:
        """Estimate the q-quantile (0 <= q <= 1) of the lifetime
        distribution, or of the recent window with `window=True`.
        Relative error <= HIST_ALPHA; None when empty."""
        with self._lock:
            zero, buckets, count, _ = self._pooled_locked(window)
            return self._quantile_of(zero, buckets, count, q)

    def summary(self) -> Dict[str, float]:
        with self._lock:
            if not self.count:
                return {"count": 0.0, "sum": 0.0}
            out = {
                "count": float(self.count),
                "sum": self.total,
                "mean": self.total / self.count,
                "min": float(self.min),
                "max": float(self.max),
                "last": self.last,
            }
            for label, q in (("p50", 0.5), ("p95", 0.95), ("p99", 0.99)):
                est = self._quantile_of(self._zero, self._buckets,
                                        self.count, q)
                if est is not None:
                    out[label] = est
            return out

    # -- merge / wire form --------------------------------------------

    def merge(self, other: "Histogram") -> "Histogram":
        """Fold `other`'s distribution into self (buckets,
        count/sum/min/max and window slices). Commutative and
        associative in the distribution sense; `last` is whichever
        write landed most recently and is explicitly arbitrary after a
        merge. Returns self."""
        if other is self:
            raise ValueError("cannot merge a histogram into itself")
        # Snapshot `other` under its lock, apply under ours: the locks
        # never nest, so concurrent a.merge(b) / b.merge(a) cannot
        # deadlock, and `other` keeps absorbing observations meanwhile.
        with other._lock:
            o_count = other.count
            o_total = other.total
            o_min = other.min
            o_max = other.max
            o_last = other.last
            o_zero = other._zero
            o_buckets = dict(other._buckets)
            o_window = [
                (sl.epoch, sl.zero, sl.count, sl.total, dict(sl.buckets))
                for sl in other._window
            ]
        with self._lock:
            self.count += o_count
            self.total += o_total
            if o_min is not None:
                self.min = (o_min if self.min is None
                            else min(self.min, o_min))
            if o_max is not None:
                self.max = (o_max if self.max is None
                            else max(self.max, o_max))
            if o_count:
                self.last = o_last
            self._zero += o_zero
            for idx, n in o_buckets.items():
                self._buckets[idx] = self._buckets.get(idx, 0) + n
            merged: Dict[int, _WindowSlice] = {
                sl.epoch: sl for sl in self._window
            }
            for epoch, zero, count, total, buckets in o_window:
                sl = merged.get(epoch)
                if sl is None:
                    sl = merged[epoch] = _WindowSlice(epoch)
                sl.zero += zero
                sl.count += count
                sl.total += total
                for idx, n in buckets.items():
                    sl.buckets[idx] = sl.buckets.get(idx, 0) + n
            self._window = collections.deque(
                sorted(merged.values(), key=lambda sl: sl.epoch)
            )
        return self

    def to_signal(self, *, window: bool = True) -> Dict[str, Any]:
        """JSON-ready wire form for /stats `signals` blocks: the bucket
        sketch (windowed by default — the fleet monitor wants "now",
        not history) plus count/sum/min/max. `from_signal` round-trips
        it."""
        with self._lock:
            zero, buckets, count, total = self._pooled_locked(window)
            return {
                "scheme": {"alpha": HIST_ALPHA,
                           "version": HIST_SIGNAL_VERSION},
                "zero": zero,
                "buckets": sorted(
                    [idx, n] for idx, n in buckets.items()
                ),
                "count": count,
                "sum": total,
                "min": self.min,
                "max": self.max,
            }

    @classmethod
    def from_signal(cls, payload: Any) -> Optional["Histogram"]:
        """Rebuild a histogram from `to_signal` output. Returns None
        (never raises) on malformed or scheme-incompatible payloads so
        mixed-version fleets degrade to "this replica contributes
        nothing" instead of crashing the monitor."""
        if not isinstance(payload, dict):
            return None
        scheme = payload.get("scheme")
        if (not isinstance(scheme, dict)
                or scheme.get("version") != HIST_SIGNAL_VERSION
                or scheme.get("alpha") != HIST_ALPHA):
            return None
        try:
            hist = cls()
            hist._zero = int(payload.get("zero", 0))
            count = int(payload.get("count", 0))
            total = float(payload.get("sum", 0.0))
            for idx, n in payload.get("buckets", []):
                hist._buckets[int(idx)] = (
                    hist._buckets.get(int(idx), 0) + int(n))
            hist.count = count
            hist.total = total
            if payload.get("min") is not None:
                hist.min = float(payload["min"])
            if payload.get("max") is not None:
                hist.max = float(payload["max"])
        except (TypeError, ValueError):
            return None
        if hist.count < 0 or hist._zero < 0 or any(
                n < 0 for n in hist._buckets.values()):
            return None
        return hist


class MetricsRegistry:
    """Named, labeled instruments; get-or-create accessors."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._instruments: Dict[LabelKey, Any] = {}

    def _get(self, kind, name: str, labels: Dict[str, Any]):
        key = _label_key(name, labels)
        with self._lock:
            instrument = self._instruments.get(key)
            if instrument is None:
                instrument = self._instruments[key] = kind()
            elif not isinstance(instrument, kind):
                raise TypeError(
                    f"{_format_key(*key)} already registered as "
                    f"{type(instrument).__name__}, not {kind.__name__}"
                )
            return instrument

    def counter(self, name: str, **labels: Any) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels: Any) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str, **labels: Any) -> Histogram:
        return self._get(Histogram, name, labels)

    def items(self) -> List[Tuple[LabelKey, Any]]:
        """Sorted ``((name, labels), instrument)`` pairs — the raw
        instrument view behind `snapshot()`, for renderers (Prometheus
        exposition, signals blocks) that need more than flat floats."""
        with self._lock:
            return sorted(self._instruments.items())

    def find_histograms(
        self, name: str
    ) -> List[Tuple[Tuple[Tuple[str, str], ...], "Histogram"]]:
        """Every Histogram registered under `name` (one per label set),
        as ``(labels, instrument)`` pairs."""
        with self._lock:
            return [
                (labels, inst)
                for (n, labels), inst in sorted(self._instruments.items())
                if n == name and isinstance(inst, Histogram)
            ]

    def snapshot(self) -> Dict[str, float]:
        """Flat dict of every instrument; histograms expand to
        ``name_count/_sum/_mean/_min/_max/_last`` (and, once observed,
        ``_p50/_p95/_p99``) keys (labels kept)."""
        with self._lock:
            items = list(self._instruments.items())
        out: Dict[str, float] = {}
        for (name, labels), instrument in sorted(items):
            if isinstance(instrument, Histogram):
                for agg, value in instrument.summary().items():
                    out[_format_key(f"{name}_{agg}", labels)] = value
            else:
                out[_format_key(name, labels)] = instrument.value
        return out

    def clear(self) -> None:
        with self._lock:
            self._instruments.clear()


_GLOBAL_REGISTRY = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return _GLOBAL_REGISTRY


def _mlflow_key(key: str) -> str:
    # "a/b{c=d}" -> "a/b.c.d"; utils.mlflow.format_key then maps "/" too.
    return re.sub(r"[{},=]+", ".", key).strip(".")


def flush_metrics(
    registry: Optional[MetricsRegistry] = None,
    *,
    step: Optional[int] = None,
    kv=None,
    task: Optional[str] = None,
    to_mlflow: bool = True,
) -> Dict[str, float]:
    """Snapshot `registry` and ship it to every configured backend
    (tf_yarn_tpu/telemetry/registry.py:465):

    * log — one line at DEBUG (the train hook already prints the
      headline numbers at INFO);
    * MLflow — one ``log_metric`` per key, when mlflow is active;
    * KV — a single ``{task}/metrics`` JSON payload via
      ``event.metrics_event`` when both `kv` and `task` are given.

    Returns the snapshot."""
    registry = registry or _GLOBAL_REGISTRY
    snap = registry.snapshot()
    if not snap:
        return snap
    if _logger.isEnabledFor(logging.DEBUG):
        _logger.debug(
            "metrics snapshot: %s",
            " ".join(f"{k}={v:.6g}" for k, v in sorted(snap.items())),
        )
    if to_mlflow:
        from tf_yarn_tpu_torch.utils import mlflow

        for key, value in snap.items():
            mlflow.log_metric(_mlflow_key(key), value, step=step)
    if kv is not None and task:
        from tf_yarn_tpu_torch import event

        event.metrics_event(kv, task, json.dumps(snap, sort_keys=True))
    return snap
