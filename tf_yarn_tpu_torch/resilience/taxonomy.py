"""Failure taxonomy: *why* an attempt died — a copy of
tf_yarn_tpu/resilience/taxonomy.py.

A blind retry loop is wrong both ways: a deterministic user bug burns
every retry reproducing itself, while a preempted host deserves an
immediate relaunch that a generic backoff would delay. So every failure
gets a kind the driver acts on:

* ``TRANSIENT``   — infra flakes (network, coordination timeouts, I/O):
  retry with exponential backoff + jitter.
* ``PREEMPTED``   — the SIGTERM path (:class:`preemption.Preempted`):
  capacity went away on purpose; relaunch immediately.
* ``LOST_TASK``   — a task died without a stop event (SIGKILL, host gone)
  or went heartbeat-silent past ``TPU_YARN_DEAD_TASK_SECS``: retryable,
  with backoff (the replacement host needs time to appear).
* ``FATAL_USER``  — deterministic user-code errors (ValueError, TypeError,
  ImportError, ...): consumes **zero** retries; relaunching reproduces it.

The kind crosses from task to driver *inside the stop event*: the task's
traceback payload is prefixed with a one-line marker
(``[tpu-yarn-failure-kind:KIND]``, the JAX package's, so either driver
reads either package's tasks) — with last-line heuristics for payloads
that lack it.
"""

from __future__ import annotations

import enum
import traceback
from typing import Iterable, Optional, Tuple

from tf_yarn_tpu_torch import preemption


class FailureKind(enum.Enum):
    """Why an attempt died; the retry policy keys budgets off this."""

    TRANSIENT = "TRANSIENT"
    PREEMPTED = "PREEMPTED"
    LOST_TASK = "LOST_TASK"
    FATAL_USER = "FATAL_USER"


# Retry-decision dominance when several tasks fail in one attempt: a
# user bug anywhere means retrying reproduces it; a preemption explains
# collateral lost/transient failures on the same slice.
_SEVERITY = {
    FailureKind.TRANSIENT: 0,
    FailureKind.LOST_TASK: 1,
    FailureKind.PREEMPTED: 2,
    FailureKind.FATAL_USER: 3,
}

# Deterministic user-code error types: same inputs, same crash — a
# relaunch cannot fix these (LookupError covers KeyError/IndexError,
# ArithmeticError covers ZeroDivisionError/Overflow, UnicodeError is a
# ValueError). torch's shape and device errors are RuntimeErrors and
# fall to the TRANSIENT default, as an unknown error does in the JAX
# package.
_FATAL_USER_TYPES = (
    ValueError,
    TypeError,
    LookupError,
    AttributeError,
    NameError,
    ImportError,
    AssertionError,
    ArithmeticError,
    NotImplementedError,
    RecursionError,
)

# Infra-flake types checked BEFORE the fatal set: TimeoutError covers
# coordination.kv.KVTimeoutError (its subclass); OSError covers the
# Connection* family plus remote-fs hiccups.
_TRANSIENT_TYPES = (TimeoutError, ConnectionError, OSError, EOFError, MemoryError)

_KIND_MARKER_PREFIX = "[tpu-yarn-failure-kind:"

# Last-line heuristics for stop payloads without a marker (older task
# programs, hand-written events).
_FATAL_NAMES = frozenset(
    t.__name__ for t in _FATAL_USER_TYPES
) | {"KeyError", "IndexError", "ZeroDivisionError", "ModuleNotFoundError",
     "UnicodeDecodeError", "UnicodeEncodeError", "OverflowError"}
_TRANSIENT_NAMES = frozenset({
    "KVTimeoutError", "TimeoutError", "ConnectionError",
    "ConnectionResetError", "ConnectionRefusedError", "BrokenPipeError",
    "OSError", "IOError", "EOFError", "MemoryError", "InjectedFault",
})


def classify_exception(exc: BaseException) -> FailureKind:
    """Map an exception to its :class:`FailureKind`.

    An exception may pre-classify itself via a ``tpu_yarn_failure_kind``
    attribute holding a kind value (the JAX package's injected faults
    do; cloud-notice pollers can tag their own errors the same way).
    Unknown types default to TRANSIENT: an unrecognized failure is
    retried within budget rather than charged to the user.
    """
    tagged = getattr(exc, "tpu_yarn_failure_kind", None)
    if tagged is not None:
        try:
            return FailureKind(tagged)
        except ValueError:
            pass
    if isinstance(exc, preemption.Preempted):
        return FailureKind.PREEMPTED
    if isinstance(exc, _TRANSIENT_TYPES):
        return FailureKind.TRANSIENT
    if isinstance(exc, _FATAL_USER_TYPES):
        return FailureKind.FATAL_USER
    return FailureKind.TRANSIENT


def encode_failure(exc: BaseException) -> str:
    """Stop-event payload for a failed task: one marker line carrying the
    kind, then the full traceback (the reference ships the bare traceback,
    event.py:82-85 — the marker is what lets the driver act on *why*)."""
    kind = classify_exception(exc)
    text = "".join(
        traceback.format_exception(type(exc), exc, exc.__traceback__)
    )
    return f"{_KIND_MARKER_PREFIX}{kind.value}]\n{text}"


def split_kind(payload: str) -> Tuple[Optional[FailureKind], str]:
    """(kind, traceback-text) from a stop payload; (None, payload) when no
    marker is present (legacy producers)."""
    if payload.startswith(_KIND_MARKER_PREFIX):
        head, _, rest = payload.partition("\n")
        raw = head[len(_KIND_MARKER_PREFIX):].rstrip("]")
        try:
            return FailureKind(raw), rest
        except ValueError:
            return None, rest
    return None, payload


def classify_stop_payload(payload: str) -> Tuple[FailureKind, str]:
    """(kind, display-text) for a failed task's stop payload: the marker
    when present, else last-line exception-name heuristics."""
    kind, text = split_kind(payload)
    if kind is not None:
        return kind, text
    last = ""
    for line in reversed(text.strip().splitlines()):
        if line.strip():
            last = line.strip()
            break
    name = last.split(":", 1)[0].strip().rsplit(".", 1)[-1]
    if name == "Preempted":
        return FailureKind.PREEMPTED, text
    if name in _TRANSIENT_NAMES or name.endswith("TimeoutError"):
        return FailureKind.TRANSIENT, text
    if name in _FATAL_NAMES:
        return FailureKind.FATAL_USER, text
    return FailureKind.TRANSIENT, text


def worst(kinds: Iterable[FailureKind]) -> Optional[FailureKind]:
    """The dominant kind of an attempt that lost several tasks at once
    (None for an empty iterable)."""
    best: Optional[FailureKind] = None
    for kind in kinds:
        if best is None or _SEVERITY[kind] > _SEVERITY[best]:
            best = kind
    return best
