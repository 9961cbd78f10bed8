"""Driver-side heartbeat watchdog: heartbeat ages into LOST_TASK — a
copy of tf_yarn_tpu/resilience/watchdog.py.

Every task program beats ``{task}/heartbeat`` (``TPU_YARN_HEARTBEAT_SECS``).
From the driver's poll cadence, a task that has beat at least once and
then goes silent past ``TPU_YARN_DEAD_TASK_SECS`` fails the attempt in
seconds as a
:data:`~tf_yarn_tpu_torch.resilience.taxonomy.FailureKind.LOST_TASK`
(a wedged worker: host gone, partitioned network, livelocked runtime).

Deliberately conservative:

* a task that never beat is NOT flagged (it may still be starting;
  process death is the backend status's job);
* a task with a ``heartbeat.stopped`` tombstone or a ``stop`` event is
  NOT flagged (finished is not dead);
* KV read errors degrade detection for one poll, never kill the run.
"""

from __future__ import annotations

import logging
import os
import time
from typing import List, Optional, Sequence

_logger = logging.getLogger(__name__)

ENV_DEAD_TASK_SECS = "TPU_YARN_DEAD_TASK_SECS"


def dead_task_secs_from_env() -> Optional[float]:
    """The env-configured threshold, or None (watchdog disabled)."""
    raw = os.environ.get(ENV_DEAD_TASK_SECS, "")
    if not raw:
        return None
    try:
        secs = float(raw)
    except ValueError:
        _logger.warning(
            "ignoring malformed %s=%r (want seconds)", ENV_DEAD_TASK_SECS, raw
        )
        return None
    return secs if secs > 0 else None


class HeartbeatWatchdog:
    """Poll-driven dead-task detector over the coordination KV store.

    The driver calls :meth:`poll` from its status loop; heartbeats are
    wall-clock timestamps (they cross hosts — the one place wall clock
    is right), so ages are computed against this process's wall clock.
    """

    def __init__(
        self,
        kv,
        tasks: Sequence[str],
        dead_after_secs: float,
        clock=time.time,
    ) -> None:
        self._kv = kv
        self._tasks = list(tasks)
        self.dead_after_secs = float(dead_after_secs)
        self._clock = clock
        self._reported: set = set()

    def poll(self) -> List[str]:
        """Tasks newly declared dead this poll (each reported once)."""
        from tf_yarn_tpu_torch import event

        dead: List[str] = []
        now = self._clock()
        for task in self._tasks:
            if task in self._reported:
                continue
            try:
                if self._kv.get_str(f"{task}/{event.HEARTBEAT_STOPPED}") is not None:
                    continue  # clean finish: tombstoned, not dead
                if self._kv.get_str(f"{task}/{event.STOP}") is not None:
                    continue  # lifecycle already closed
                raw = self._kv.get_str(f"{task}/{event.HEARTBEAT}")
            except Exception:
                # A flaky KV read must degrade detection for one poll,
                # not fail the run from the observer side.
                _logger.warning(
                    "watchdog KV read failed; skipping this poll",
                    exc_info=True,
                )
                return dead
            if raw is None:
                continue  # never beat: still booting; not our call
            try:
                age = now - float(raw)
            except ValueError:
                continue
            if age > self.dead_after_secs:
                _logger.error(
                    "task %s heartbeat is %.1fs old (> %.1fs): declaring it "
                    "lost", task, age, self.dead_after_secs,
                )
                self._reported.add(task)
                dead.append(task)
        return dead
