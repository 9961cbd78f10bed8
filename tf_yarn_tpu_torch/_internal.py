"""Low-level process, thread and socket utilities — a copy of
tf_yarn_tpu/_internal.py (exception-capturing threads, port reservation,
task iteration, exclusive environment mutation), plus `dumps_fn`, the
one place the port pickles a function for another process.
"""

from __future__ import annotations

import io
import pickle
import platform
import socket
import threading
import types
from contextlib import contextmanager
from typing import Iterator, Optional, Tuple


class MonitoredThread(threading.Thread):
    """A thread that records the exception its target raised.

    States mirror the reference (reference: _internal.py:22-45): RUNNING
    while alive, FAILED if the target raised, SUCCEEDED otherwise. Task
    programs run user training functions inside one of these and ship the
    captured exception as the `stop`-event payload.
    """

    def __init__(self, *args, **kwargs) -> None:
        super().__init__(*args, **kwargs)
        self._exc: Optional[BaseException] = None

    @property
    def state(self) -> str:
        if self.is_alive():
            return "RUNNING"
        return "FAILED" if self._exc is not None else "SUCCEEDED"

    @property
    def exception(self) -> Optional[BaseException]:
        return self._exc

    def run(self) -> None:
        try:
            super().run()
        except BaseException as exc:  # noqa: B036 — deliberate: report everything
            self._exc = exc


def get_so_reuseport() -> Optional[int]:
    """SO_REUSEPORT if this platform has it (reference: _internal.py:48-57)."""
    if platform.system() in ("Linux", "Darwin"):
        return getattr(socket, "SO_REUSEPORT", None)
    return None


@contextmanager
def reserve_sock_addr() -> Iterator[Tuple[str, int]]:
    """Reserve an address by binding port 0 and *keeping the socket open*.

    The held-open SO_REUSEPORT socket lets the eventual server bind the same
    port while preventing anyone else from grabbing it in between — the
    reference's fix for the TF port race (reference: _internal.py:60-80,
    note at tensorflow/cluster.py:29-34).
    """
    so_reuseport = get_so_reuseport()
    if so_reuseport is None:
        raise RuntimeError("SO_REUSEPORT is not supported on this platform")
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as sock:
        sock.setsockopt(socket.SOL_SOCKET, so_reuseport, 1)
        sock.bind(("", 0))
        _, port = sock.getsockname()
        yield (socket.getfqdn(), port)


class _NoMainPickler(pickle.Pickler):
    """Stdlib pickling that refuses what the task could not import: a
    function or class of the driver's ``__main__`` pickles by reference
    to ``__main__``, which in a task process is the task program."""

    def reducer_override(self, obj):
        if isinstance(obj, (type, types.FunctionType)) \
                and getattr(obj, "__module__", None) == "__main__":
            raise pickle.PicklingError(
                f"{obj!r} lives in __main__, which a task cannot import")
        return NotImplemented


def dumps_fn(fn) -> bytes:
    """Pickle `fn` for a task process: by value with cloudpickle when it
    is installed, else with the stdlib pickle by reference (module-level
    functions and `functools.partial`s of them only). Raises
    `pickle.PicklingError` (or the pickler's `AttributeError`/`TypeError`)
    for what the task could not load."""
    try:
        import cloudpickle
    except ImportError:
        buf = io.BytesIO()
        _NoMainPickler(buf).dump(fn)
        return buf.getvalue()
    return cloudpickle.dumps(fn)
