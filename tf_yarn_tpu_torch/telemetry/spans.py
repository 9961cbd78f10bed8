"""Span tracer: nested, thread-aware host-side timing.

Every host-side phase of serving (a scheduler tick, its admissions and
prefills, the engine's step) is wrapped in a `span(...)` context
manager. Spans are `perf_counter`-based (monotonic), nest per thread,
and land in a bounded in-memory ring buffer, so tracing is always on
and can never grow a long run's memory. `Tracer.export_chrome_trace`
writes the buffer in Chrome ``trace_event`` format (open it in
https://ui.perfetto.dev). Spans time the host's view of a phase
(dispatch plus any synchronisation inside it), not device work; the
device half is `torch.profiler`.

Environment-driven sinks, as in the JAX package (spans.py:12-22):
``TPU_YARN_TRACE=<dir>`` makes the run entry points (the train loop,
`run_inference`, `experiment.run_experiment`) write ``trace_<task>.json``
on exit; ``TPU_YARN_TRACE_JSONL=1`` with it also streams every completed
span as one JSON line to ``spans_<task>.jsonl``, which survives a
SIGKILL that the end-of-run export would not.
"""

from __future__ import annotations

import collections
import json
import logging
import os
import re
import threading
import time
from typing import Any, Callable, Dict, List, Optional

_logger = logging.getLogger(__name__)

TRACE_ENV = "TPU_YARN_TRACE"
TRACE_JSONL_ENV = "TPU_YARN_TRACE_JSONL"
DEFAULT_CAPACITY = 100_000

_clock = time.perf_counter  # monotonic; patchable in tests


class Span:
    """One completed (or in-flight) span. Mutable: the context manager
    hands it to the with-block so callers can read ``.duration`` right
    after the block (the train loop's interval breakdown does)."""

    __slots__ = ("name", "category", "args", "start", "duration",
                 "thread_id", "thread_name", "depth", "parent")

    def __init__(self, name: str, category: str, args: Dict[str, Any],
                 depth: int, parent: Optional[str]) -> None:
        self.name = name
        self.category = category
        self.args = args
        self.depth = depth
        self.parent = parent
        thread = threading.current_thread()
        self.thread_id = thread.ident or 0
        self.thread_name = thread.name
        self.duration = 0.0
        self.start = _clock()

    def to_json(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "cat": self.category,
            "start": self.start,
            "dur": self.duration,
            "tid": self.thread_id,
            "thread": self.thread_name,
            "depth": self.depth,
            "parent": self.parent,
            "args": self.args,
        }


class _SpanContext:
    """Class-based context manager (not contextlib) so exceptions —
    including StopIteration from a timed ``next()`` — propagate without
    generator-throw subtleties."""

    __slots__ = ("_tracer", "_name", "_category", "_args", "span")

    def __init__(self, tracer: "Tracer", name: str, category: str,
                 args: Dict[str, Any]) -> None:
        self._tracer = tracer
        self._name = name
        self._category = category
        self._args = args

    def __enter__(self) -> Span:
        self.span = self._tracer._begin(self._name, self._category, self._args)
        return self.span

    def __exit__(self, exc_type, exc, tb) -> bool:
        self._tracer._end(self.span, error=exc_type is not None)
        return False


class Tracer:
    """Ring-buffered span recorder; thread-safe, one per process by
    default (module-level :func:`get_tracer`)."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY) -> None:
        self.capacity = max(1, capacity)
        self._buffer: "collections.deque[Span]" = collections.deque(
            maxlen=self.capacity)
        self._lock = threading.Lock()
        self._local = threading.local()
        self._sinks: List[Callable[[Span], None]] = []

    # -- recording ---------------------------------------------------------

    def span(self, name: str, category: str = "host", **args: Any):
        """Context manager timing its body; yields the :class:`Span`."""
        return _SpanContext(self, name, category, args)

    def _stack(self) -> List[str]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _begin(self, name: str, category: str, args: Dict[str, Any]) -> Span:
        stack = self._stack()
        span = Span(name, category, args, depth=len(stack),
                    parent=stack[-1] if stack else None)
        stack.append(name)
        return span

    def _end(self, span: Span, error: bool = False) -> None:
        span.duration = _clock() - span.start
        if error:
            span.args = dict(span.args, error=True)
        stack = self._stack()
        if stack and stack[-1] == span.name:
            stack.pop()
        self._store(span)

    def record(self, name: str, start: float, duration: float,
               category: str = "host", **args: Any) -> Span:
        """Add a span the caller timed itself (`start` on this module's
        clock), e.g. from a completion callback on another thread."""
        span = Span(name, category, args, depth=0, parent=None)
        span.start, span.duration = start, duration
        self._store(span)
        return span

    def _store(self, span: Span) -> None:
        with self._lock:
            self._buffer.append(span)
            sinks = list(self._sinks)
        for sink in sinks:
            try:
                sink(span)
            except Exception:
                _logger.warning("span sink failed", exc_info=True)

    # -- inspection --------------------------------------------------------

    def records(self) -> List[Span]:
        with self._lock:
            return list(self._buffer)

    def clear(self) -> None:
        with self._lock:
            self._buffer.clear()

    # -- sinks -------------------------------------------------------------

    def add_sink(self, sink: Callable[[Span], None]) -> None:
        with self._lock:
            self._sinks.append(sink)

    def remove_sink(self, sink: Callable[[Span], None]) -> None:
        with self._lock:
            if sink in self._sinks:
                self._sinks.remove(sink)

    def jsonl_sink(self, path: str):
        """Stream completed spans to `path` as JSON lines; returns a
        zero-arg close function that detaches the sink and closes the
        file."""
        fh = open(path, "a", encoding="utf-8")
        write_lock = threading.Lock()

        def sink(span: Span) -> None:
            line = json.dumps(span.to_json(), sort_keys=True)
            with write_lock:
                fh.write(line + "\n")
                fh.flush()

        self.add_sink(sink)

        def close() -> None:
            self.remove_sink(sink)
            with write_lock:
                fh.close()

        return close

    # -- Chrome trace_event export -----------------------------------------

    def chrome_events(self) -> List[Dict[str, Any]]:
        """The ring buffer as Chrome ``trace_event`` dicts ("X" complete
        events + "M" thread-name metadata)."""
        pid = os.getpid()
        events: List[Dict[str, Any]] = []
        thread_names: Dict[int, str] = {}
        for span in self.records():
            thread_names.setdefault(span.thread_id, span.thread_name)
            events.append({
                "name": span.name,
                "cat": span.category,
                "ph": "X",
                "ts": span.start * 1e6,   # microseconds
                "dur": span.duration * 1e6,
                "pid": pid,
                "tid": span.thread_id,
                "args": dict(span.args, depth=span.depth),
            })
        meta = [
            {"name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
             "args": {"name": name}}
            for tid, name in sorted(thread_names.items())
        ]
        return meta + events

    def export_chrome_trace(self, path: str) -> str:
        payload = {
            "traceEvents": self.chrome_events(),
            "displayTimeUnit": "ms",
        }
        with open(path, "w", encoding="utf-8") as fh:
            json.dump(payload, fh)
        return path


# --------------------------------------------------------------------------
# Process-global tracer + env-driven export
# --------------------------------------------------------------------------

_GLOBAL_TRACER = Tracer()
_JSONL_OPEN: Dict[str, Callable[[], None]] = {}
_JSONL_LOCK = threading.Lock()


def get_tracer() -> Tracer:
    return _GLOBAL_TRACER


def span(name: str, category: str = "host", **args: Any):
    """``with telemetry.span("train/input_wait") as sp: ...`` on the
    process-global tracer."""
    return _GLOBAL_TRACER.span(name, category=category, **args)


def trace_dir() -> Optional[str]:
    return os.environ.get(TRACE_ENV) or None


def _safe_task(task: Any) -> str:
    return re.sub(r"[^A-Za-z0-9_.-]+", "-", str(task)) or "task"


def export_trace(task: Any = "local",
                 tracer: Optional[Tracer] = None) -> Optional[str]:
    """Write ``<TPU_YARN_TRACE>/trace_<task>.json`` (Chrome trace_event
    JSON) from the ring buffer; no-op (returns None) when the env var is
    unset. Idempotent — later calls overwrite with the fuller buffer."""
    directory = trace_dir()
    if not directory:
        return None
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"trace_{_safe_task(task)}.json")
    (tracer or _GLOBAL_TRACER).export_chrome_trace(path)
    _logger.info("telemetry trace written to %s", path)
    return path


def enable_env_jsonl(task: Any = "local") -> Optional[str]:
    """Attach a streaming JSONL sink (``spans_<task>.jsonl`` under
    ``TPU_YARN_TRACE``) when ``TPU_YARN_TRACE_JSONL`` is truthy.
    Idempotent per path; returns the path or None when disabled."""
    directory = trace_dir()
    flag = os.environ.get(TRACE_JSONL_ENV, "").lower()
    if not directory or flag in ("", "0", "false", "no"):
        return None
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"spans_{_safe_task(task)}.jsonl")
    with _JSONL_LOCK:
        if path not in _JSONL_OPEN:
            _JSONL_OPEN[path] = _GLOBAL_TRACER.jsonl_sink(path)
    return path


def close_jsonl_sinks() -> None:
    """Detach + close every env-opened JSONL sink (tests)."""
    with _JSONL_LOCK:
        closers = list(_JSONL_OPEN.values())
        _JSONL_OPEN.clear()
    for close in closers:
        close()
