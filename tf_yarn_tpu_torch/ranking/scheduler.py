"""Fill-or-timeout micro-batch scheduler over the RankEngine —
counterpart of tf_yarn_tpu/ranking/scheduler.py.

The device-facing half of the ranking subsystem, and the deliberate
opposite of serving/scheduler.py's slot grid: a ranking request holds NO
device state between ticks, so there is nothing to retire incrementally
— every tick admits a coalesced feature batch, runs ONE bucketed
forward, pushes every request's scores, and frees all capacity. The
batching policy is the classic low-latency trade (`max_batch`,
`max_wait_ms`):

* **fill** — enough queued rows to fill `max_batch`: tick immediately;
* **or timeout** — the oldest queued request has waited `max_wait_ms`:
  tick with whatever is queued (latency bound beats device utilization).

`max_wait_ms=0` degenerates to tick-on-arrival (minimum latency, worst
batching).

What IS shared with token serving comes from serving/request.py: the
bounded AdmissionQueue (QueueFull → the frontend's 429 + Retry-After),
the absolute-deadline lifetime (expired requests are evicted at pop,
never scored), and the Response producer/consumer contract — scores
stream through the same `_push`/`_finish` hooks tokens do.

The engine's model holds its weights, so the scheduler takes no
``params`` (the JAX scheduler places them at construction); the rest —
the knobs, their errors, `stats()`'s keys and the ``ranking/*`` metric
names — is the JAX scheduler's. ``tp_degree`` is the engine's (the
ranks of a tp replica, `models.rank_engine`), and the
``ranking/params_hbm_bytes_per_device`` gauge its rank's bytes. A tick
is one call of the engine on any degree; a lost tp follower fails it
with `TPGroupError`, answered as ``error`` like any engine failure,
and the replica's poll (`ranking.server.run_ranking`) ends the task.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from tf_yarn_tpu_torch import telemetry
from tf_yarn_tpu_torch.serving.request import (
    _REQUEST_IDS,
    FINISH_DEADLINE,
    FINISH_ERROR,
    FINISH_SHUTDOWN,
    AdmissionQueue,
    Response,
)

_logger = logging.getLogger(__name__)

# Scores delivered — the ranking twin of serving's FINISH_EOS/LENGTH.
FINISH_COMPLETE = "complete"

# Idle sleep between wake checks; a submit wakes the loop immediately,
# so this only bounds deadline-eviction latency for queued-but-idle
# states (same constant and rationale as serving/scheduler.py).
IDLE_POLL_S = 0.05


@dataclasses.dataclass
class RankRequest:
    """One ranking request: a validated feature batch of `batch` rows.
    Same lifetime semantics as serving's Request — `timeout_s` becomes
    an absolute monotonic deadline covering queue wait AND scoring —
    and the same shared id space, so mixed-fleet logs stay unambiguous.
    """

    cat: np.ndarray
    dense: Optional[np.ndarray] = None
    priority: int = 0
    timeout_s: Optional[float] = None
    id: int = dataclasses.field(default_factory=lambda: next(_REQUEST_IDS))
    submitted_at: float = dataclasses.field(default_factory=time.monotonic)

    def __post_init__(self) -> None:
        if self.timeout_s is not None and self.timeout_s <= 0:
            raise ValueError(
                f"timeout_s must be > 0, got {self.timeout_s}"
            )

    @property
    def batch(self) -> int:
        return int(self.cat.shape[0])

    @property
    def deadline(self) -> Optional[float]:
        if self.timeout_s is None:
            return None
        return self.submitted_at + self.timeout_s

    def expired(self, now: Optional[float] = None) -> bool:
        deadline = self.deadline
        if deadline is None:
            return False
        return (time.monotonic() if now is None else now) >= deadline


class RankResponse(Response):
    """Response whose stream carries float scores, one per feature row
    (the base class coerces pushed items to int — token ids)."""

    def _push(self, score) -> None:
        if self.first_token_at is None:
            self.first_token_at = time.monotonic()
        self._tokens.append(float(score))
        self._stream.put(float(score))

    def scores(self):
        """Alias of `tokens()` under the subsystem's vocabulary."""
        return self.tokens()


class _RankQueue(AdmissionQueue):
    response_cls = RankResponse


class MicroBatchScheduler:
    """Fill-or-timeout micro-batching over one RankEngine (module
    docstring)."""

    def __init__(
        self,
        engine,
        *,
        max_batch: int = 32,
        max_wait_ms: float = 2.0,
        queue_capacity: int = 256,
        retry_after_s: float = 0.5,
    ):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if max_wait_ms < 0:
            raise ValueError(
                f"max_wait_ms must be >= 0, got {max_wait_ms}"
            )
        buckets = tuple(getattr(engine, "batch_buckets", ()) or ())
        if buckets and max_batch > max(buckets):
            raise ValueError(
                f"max_batch={max_batch} exceeds the engine's largest "
                f"batch bucket ({max(buckets)}) — every full tick would "
                "run off the bucket grid; raise batch_buckets or lower "
                "max_batch"
            )
        self.engine = engine
        self.max_batch = int(max_batch)
        self.max_wait_ms = float(max_wait_ms)
        self.tp_degree = int(getattr(engine, "tp_degree", 1) or 1)
        self.queue = _RankQueue(queue_capacity, retry_after_s)
        self._queued_rows = 0
        self._oldest_wait: List[float] = []  # submitted_at, FIFO
        self._meta_lock = threading.Lock()
        self._held: Optional[Tuple[RankRequest, RankResponse]] = None
        self._held_since: Optional[float] = None
        self._ticks = 0
        self._rows_scored = 0
        self._requests_total = 0
        self._draining = False
        self._work = threading.Event()
        self._stop = threading.Event()
        self._lifecycle = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._registry = telemetry.get_registry()
        nbytes = 0
        if hasattr(engine, "params_nbytes_per_device"):
            nbytes = int(engine.params_nbytes_per_device())
        self._params_nbytes_per_device = nbytes
        self._registry.gauge(
            "ranking/params_hbm_bytes_per_device"
        ).set(nbytes)
        self._registry.gauge("ranking/tp_degree").set(self.tp_degree)

    # -- submission (any thread) --------------------------------------------

    def submit(
        self,
        cat,
        dense=None,
        priority: int = 0,
        timeout_s: Optional[float] = None,
    ) -> RankResponse:
        """Admit one feature batch; returns its RankResponse. Raises
        ValueError for batches this engine cannot score (wrong feature
        arity, oversized batch — the frontend's 400) and QueueFull at
        capacity (the 429)."""
        # Feature-arity validation AT ADMISSION: a wrong-arity vector
        # would otherwise first explode mid-tick inside the scheduler
        # thread — the same hardening the serving frontend applies to
        # context overflows.
        cat, dense = self.engine.feature_arrays(cat, dense)
        if cat.shape[0] < 1:
            raise ValueError("cannot rank an empty feature batch")
        if cat.shape[0] > self.max_batch:
            raise ValueError(
                f"request carries {cat.shape[0]} rows but this "
                f"scheduler coalesces at most max_batch={self.max_batch} "
                "per tick — split the request or raise max_batch"
            )
        request = RankRequest(
            cat=cat, dense=dense, priority=priority, timeout_s=timeout_s
        )
        try:
            response = self.queue.submit(request)
        except Exception:
            self._registry.counter("ranking/requests_rejected_total").inc()
            raise
        with self._meta_lock:
            self._queued_rows += request.batch
            self._oldest_wait.append(request.submitted_at)
            self._requests_total += 1
        self._registry.counter("ranking/requests_total").inc()
        self._registry.gauge("ranking/queue_depth").set(self.queue.depth)
        self._work.set()
        return response

    def _note_popped(self, request: RankRequest) -> None:
        with self._meta_lock:
            self._queued_rows -= request.batch
            if self._oldest_wait:
                self._oldest_wait.pop(0)

    # -- the tick (scheduler thread) ----------------------------------------

    def _ready(self, now: float) -> Tuple[bool, float]:
        """(tick now?, seconds until the timeout half would fire).
        Fill: queued rows reach max_batch. Timeout: the oldest waiter
        (held request included) aged past max_wait_ms."""
        with self._meta_lock:
            rows = self._queued_rows
            oldest = self._oldest_wait[0] if self._oldest_wait else None
            held = self._held
            held_at = self._held_since
        if held is not None:
            rows += held[0].batch
            oldest = held_at if oldest is None else min(oldest, held_at)
        if rows <= 0:
            return False, IDLE_POLL_S
        if rows >= self.max_batch:
            return True, 0.0
        wait_s = self.max_wait_ms / 1000.0
        age = now - oldest
        if age >= wait_s:
            return True, 0.0
        return False, wait_s - age

    def tick(self) -> bool:
        """One coalesce-score-deliver round; returns whether any work
        happened. Expired requests are evicted at pop (never scored);
        a request that would overflow the batch is held — FIFO-ordered
        ahead of the queue — for the next tick."""
        now = time.monotonic()
        batch: List[Tuple[RankRequest, RankResponse]] = []
        rows = 0
        with telemetry.span("ranking/tick") as tick_span:
            while True:
                with self._meta_lock:
                    item, self._held = self._held, None
                    self._held_since = None
                if item is None:
                    item = self.queue.pop()
                    if item is not None:
                        self._note_popped(item[0])
                if item is None:
                    break
                request, response = item
                if request.expired(now):
                    self._finish_unadmitted(response, FINISH_DEADLINE)
                    continue
                if rows + request.batch > self.max_batch:
                    with self._meta_lock:
                        self._held = item
                        self._held_since = now
                    break
                batch.append(item)
                rows += request.batch
            if batch:
                try:
                    self._score(batch, rows)
                except Exception:
                    # The popped batch lives only in this frame — if the
                    # forward dies it must be failed HERE or its clients
                    # block forever (queued requests were never at risk
                    # and keep waiting for the next tick).
                    for _request, response in batch:
                        self._finish_unadmitted(response, FINISH_ERROR)
                    raise
        if batch:
            self._ticks += 1
            self._registry.counter("ranking/ticks_total").inc()
            self._registry.histogram("ranking/tick_seconds").observe(
                tick_span.duration
            )
            self._registry.histogram("ranking/batch_rows").observe(rows)
        self._registry.gauge("ranking/queue_depth").set(self.queue.depth)
        return bool(batch)

    def _score(self, batch, rows: int) -> None:
        cat = np.concatenate([request.cat for request, _ in batch])
        dense = None
        if batch[0][0].dense is not None:
            dense = np.concatenate(
                [request.dense for request, _ in batch]
            )
        scores = self.engine.rank(cat, dense)
        offset = 0
        now = time.monotonic()
        for request, response in batch:
            for value in scores[offset:offset + request.batch]:
                response._push(value)
            offset += request.batch
            response._finish(FINISH_COMPLETE)
            self._registry.counter(
                "ranking/requests_completed_total", reason=FINISH_COMPLETE
            ).inc()
            self._registry.histogram("ranking/request_seconds").observe(
                now - request.submitted_at
            )
        self._rows_scored += rows
        self._registry.counter("ranking/rows_scored_total").inc(rows)

    def _finish_unadmitted(self, response: RankResponse,
                           reason: str) -> None:
        response._finish(reason)
        self._registry.counter(
            "ranking/requests_completed_total", reason=reason
        ).inc()

    # -- loop ---------------------------------------------------------------

    def start(self) -> None:
        with self._lifecycle:
            if self._thread is not None:
                raise RuntimeError("scheduler already started")
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, name="ranking-scheduler", daemon=True
            )
            self._thread.start()

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                ready, delay = self._ready(time.monotonic())
                if ready:
                    self.tick()
                    continue
            except Exception:
                # A tick must never kill the ranking loop (the serving
                # scheduler learned this the hard way — see its _run).
                # tick() already failed ITS batch as `error`; everything
                # still queued or held stays admitted and the next tick
                # serves it.
                _logger.exception(
                    "ranking tick failed; its batch answered as error"
                )
                self._registry.counter("ranking/tick_errors_total").inc()
                continue
            self._work.wait(min(IDLE_POLL_S, max(delay, 0.001)))
            self._work.clear()

    def _fail_inflight(self, reason: str) -> None:
        with self._meta_lock:
            held, self._held = self._held, None
            self._held_since = None
        if held is not None:
            self._finish_unadmitted(held[1], reason)
        for request, response in self.queue.drain():
            self._note_popped(request)
            self._finish_unadmitted(response, reason)

    @property
    def draining(self) -> bool:
        return self._draining

    def drain(self) -> None:
        """Mark this replica as draining (preemption notice, planned
        shutdown): surfaced in `stats()` and `/healthz` so the fleet
        router ejects it from rotation before it stops accepting."""
        if not self._draining:
            self._draining = True
            _logger.info("ranking scheduler marked draining")

    def close(self) -> None:
        """Stop the loop; fail queued requests as `shutdown` so no
        client blocks forever on a dead replica."""
        self._draining = True
        self._stop.set()
        self._work.set()
        # Snapshot-under-lock: concurrent close() calls each either own
        # the loop thread (and join it) or see None; join outside the
        # lock so a wedged loop can't deadlock start().
        with self._lifecycle:
            thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout=30.0)
        self._fail_inflight(FINISH_SHUTDOWN)

    # -- introspection -------------------------------------------------------

    def stats(self) -> Dict:
        """Host-side snapshot for /stats and the task's flushed
        metrics."""
        with self._meta_lock:
            queued_rows = self._queued_rows
            requests_total = self._requests_total
            held = self._held
        if held is not None:
            queued_rows += held[0].batch
        snap = {
            "max_batch": self.max_batch,
            "max_wait_ms": self.max_wait_ms,
            "queue_depth": self.queue.depth,
            "queue_capacity": self.queue.capacity,
            "queued_rows": queued_rows,
            "ticks": self._ticks,
            "rows_scored": self._rows_scored,
            "requests_total": requests_total,
            "avg_batch_rows": (
                round(self._rows_scored / self._ticks, 2)
                if self._ticks else None
            ),
            "tp_degree": self.tp_degree,
            "params_hbm_bytes_per_device": self._params_nbytes_per_device,
            "draining": self._draining,
        }
        engine_stats = getattr(self.engine, "stats", None)
        if isinstance(engine_stats, dict):
            snap["rank_engine"] = dict(engine_stats)
        return snap
