"""Preemption-aware shutdown: SIGTERM sets a drain flag — a copy of
tf_yarn_tpu/preemption.py.

A spot or preemptible host gets a SIGTERM grace window before it
disappears. The task programs install the handler (main thread, before
the train thread starts); the servers' `/healthz` answers "draining" as
soon as the flag is set, so a load balancer stops sending to a replica
about to vanish. :class:`Preempted` ships through the stop event like
any failure and classifies as PREEMPTED, which the driver relaunches at
once. The train loop's drain (poll, save, raise) is not ported yet
(ROADMAP.md Queue 1 item 4).

User functions (`tasks.distributed` fns) can poll :func:`requested`.
"""

from __future__ import annotations

import logging
import signal
import threading
from typing import Iterable, Optional

_logger = logging.getLogger(__name__)

_requested = threading.Event()


class Preempted(RuntimeError):
    """Raised by the train loop after a preemption-triggered save; marks
    the attempt failed-but-resumable (driver retries resume from the
    checkpoint the handler just wrote)."""


def install(signals: Optional[Iterable[int]] = None) -> bool:
    """Install the preemption handler. Main-thread only (CPython restricts
    signal.signal); returns False (and logs) elsewhere so task programs
    can call it unconditionally."""
    if threading.current_thread() is not threading.main_thread():
        _logger.warning("preemption.install skipped: not on the main thread")
        return False
    for sig in signals or (signal.SIGTERM,):
        signal.signal(sig, _handle)
    return True


def _handle(signum, frame) -> None:
    if _requested.is_set():
        # Second signal = the sender escalating (driver kill paths send
        # TERM then KILL after a bound; an impatient operator hits Ctrl-C
        # twice): stop draining, die with the default disposition now —
        # a worker wedged in a collective never reaches the drain poll
        # and must not outlive the kill.
        _logger.warning("signal %d again: abandoning drain, exiting", signum)
        signal.signal(signum, signal.SIG_DFL)
        signal.raise_signal(signum)
        return
    _logger.warning("signal %d received: preemption drain requested", signum)
    _requested.set()


def request() -> None:
    """Set the flag programmatically (tests; cloud notice pollers that
    learn of preemption out-of-band, e.g. a cloud metadata server)."""
    _requested.set()


def requested() -> bool:
    return _requested.is_set()


def reset() -> None:
    """Clear the flag (between run_on_gpu attempts in one process, and in
    tests)."""
    _requested.clear()
