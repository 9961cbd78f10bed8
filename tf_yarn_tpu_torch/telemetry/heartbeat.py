"""Task heartbeats over the coordination KV store — a copy of
tf_yarn_tpu/telemetry/heartbeat.py.

A daemon thread broadcasts ``{task}/heartbeat`` (a wall-clock timestamp:
heartbeats are compared across hosts) on a fixed cadence and flushes the
process-global metrics registry to ``{task}/metrics`` beside it. The
driver turns the timestamps into ages (`utils.metrics.task_heartbeats`,
the `resilience.HeartbeatWatchdog`): a wedged task shows up as a growing
age long before the run's deadline. A clean stop writes a
``heartbeat.stopped`` tombstone, so finished is never read as dead.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Optional

from tf_yarn_tpu_torch.telemetry.registry import MetricsRegistry, flush_metrics

_logger = logging.getLogger(__name__)

DEFAULT_EVERY_SECS = 10.0

ENV_EVERY_SECS = "TPU_YARN_HEARTBEAT_SECS"


def every_from_env(default: float = DEFAULT_EVERY_SECS) -> float:
    """The heartbeat cadence from ``TPU_YARN_HEARTBEAT_SECS`` (0 disables);
    the one parser every task program shares."""
    try:
        return float(os.environ.get(ENV_EVERY_SECS, "") or default)
    except ValueError:
        return default


class Heartbeat:
    """Periodic ``{task}/heartbeat`` broadcaster; ``every <= 0``
    disables it (construction stays cheap so call sites don't branch).

    KV errors are logged and swallowed — a flaky coordination link must
    degrade liveness reporting, never kill the training thread's
    process."""

    def __init__(
        self,
        kv,
        task: str,
        every: float = DEFAULT_EVERY_SECS,
        registry: Optional[MetricsRegistry] = None,
    ) -> None:
        self._kv = kv
        self._task = task
        self._every = float(every)
        self._registry = registry
        self._stop = threading.Event()
        self._lifecycle = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self.beats = 0

    @property
    def enabled(self) -> bool:
        return self._every > 0

    def _beat(self) -> None:
        from tf_yarn_tpu_torch import event

        try:
            event.heartbeat_event(self._kv, self._task)
            if self._registry is not None:
                flush_metrics(
                    self._registry, kv=self._kv, task=self._task,
                    to_mlflow=False,
                )
            self.beats += 1
        except Exception:
            _logger.warning(
                "heartbeat broadcast for %s failed", self._task, exc_info=True
            )

    def _run(self) -> None:
        self._beat()
        while not self._stop.wait(self._every):
            self._beat()

    def start(self) -> "Heartbeat":
        with self._lifecycle:
            if self.enabled and self._thread is None:
                self._thread = threading.Thread(
                    target=self._run, name=f"heartbeat-{self._task}",
                    daemon=True,
                )
                self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        # Snapshot-under-lock: concurrent stop() calls each either own
        # the beater (join it, write the tombstone once) or see None.
        with self._lifecycle:
            thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout=5.0)
            # Tombstone on clean shutdown (exactly once — only the
            # stop() that won the snapshot): a finished task and a dead
            # one both stop beating — the watchdog must only hunt the
            # latter.
            from tf_yarn_tpu_torch import event

            try:
                event.heartbeat_stopped_event(self._kv, self._task)
            except Exception:
                _logger.warning(
                    "heartbeat tombstone for %s failed", self._task,
                    exc_info=True,
                )

    def __enter__(self) -> "Heartbeat":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


def heartbeat_age(raw: Optional[str], now: Optional[float] = None
                  ) -> Optional[float]:
    """Seconds since a raw heartbeat payload, or None when absent or
    unparseable."""
    if not raw:
        return None
    try:
        return (time.time() if now is None else now) - float(raw)
    except ValueError:
        return None
