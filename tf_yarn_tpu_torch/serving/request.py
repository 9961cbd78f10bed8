"""Request lifecycle for the online serving subsystem.

The user-visible half of continuous batching (docs/Serving.md): a
:class:`Request` describes one generation (prompt ids, sampling params,
optional deadline, priority), a :class:`Response` streams its tokens
back as they are generated, and the :class:`AdmissionQueue` is the
bounded front door — full means *reject now with a retry-after hint*,
not buffer unboundedly until the process OOMs (the backpressure posture
VirtualFlow argues for: the user-visible batch is decoupled from the
hardware-resident batch, and the coupling point must be explicit).

Everything here is host-side plumbing with no device dependency;
the scheduler (serving/scheduler.py) is the only consumer of the
producer-side hooks (`_push`/`_finish`).
"""

from __future__ import annotations

import collections
import dataclasses
import heapq
import itertools
import queue
import threading
import time
from typing import Deque, Iterator, List, Optional, Tuple

# finish_reason values a Response can end with.
FINISH_EOS = "eos"            # the model emitted the request's eos token
FINISH_LENGTH = "length"      # max_new_tokens generated
FINISH_DEADLINE = "deadline"  # per-request deadline hit (queued or active)
FINISH_SHUTDOWN = "shutdown"  # scheduler closed with the request in flight
FINISH_ERROR = "error"        # a scheduler tick failed with it in flight

# SLO tiers, lowest to highest. Admission order and suspend-victim
# selection both key on the rank: `interactive` requests jump the queue
# and are never parked while a lower tier runs; `batch` absorbs the
# pool pressure (suspended to the host tier first, resumed last).
TIERS = ("batch", "standard", "interactive")
DEFAULT_TIER = "standard"
_TIER_RANK = {name: rank for rank, name in enumerate(TIERS)}


def tier_rank(tier: str) -> int:
    """Numeric rank of an SLO tier name (higher = more latency-
    sensitive). Raises ValueError on an unknown tier — the HTTP
    frontend surfaces this as a 400."""
    try:
        return _TIER_RANK[tier]
    except KeyError:
        raise ValueError(
            f"unknown tier {tier!r}; expected one of {TIERS}"
        ) from None


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request generation knobs.

    `temperature`/`top_k`/`top_p` are baked into the compiled slot-step
    program, so the scheduler serves ONE sampling configuration per
    grid and rejects mismatching requests at admission (a 400, not a
    recompile storm); `max_new_tokens`, `seed` and `eos_token` are free
    per request.
    """

    max_new_tokens: int = 128
    temperature: float = 0.0
    top_k: Optional[int] = None
    top_p: Optional[float] = None
    seed: int = 0
    eos_token: Optional[int] = None

    def __post_init__(self) -> None:
        if self.max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {self.max_new_tokens}"
            )


class QueueFull(Exception):
    """Admission rejected: the bounded queue is at capacity. Carries the
    retry-after hint the HTTP frontend surfaces as a 429 Retry-After."""

    def __init__(self, depth: int, retry_after_s: float):
        super().__init__(
            f"admission queue full ({depth} queued); retry in "
            f"~{retry_after_s:.1f}s"
        )
        self.depth = depth
        self.retry_after_s = retry_after_s


_REQUEST_IDS = itertools.count()


@dataclasses.dataclass
class Request:
    """One generation request. `timeout_s` becomes an absolute monotonic
    deadline at construction: it bounds the WHOLE lifetime (queue wait
    included), and the scheduler cancels the request — queued or mid-
    decode — once it passes."""

    prompt: Tuple[int, ...]
    params: SamplingParams = dataclasses.field(default_factory=SamplingParams)
    priority: int = 0
    timeout_s: Optional[float] = None
    tier: str = DEFAULT_TIER
    id: int = dataclasses.field(default_factory=lambda: next(_REQUEST_IDS))
    submitted_at: float = dataclasses.field(default_factory=time.monotonic)
    # Cross-task trace id (the router's X-Request-Id): joins this
    # request's scheduler trace-ring entries and spans to the router's
    # span for the same HTTP request. None for untraced callers.
    trace_id: Optional[str] = None

    def __post_init__(self) -> None:
        self.prompt = tuple(int(t) for t in self.prompt)
        if not self.prompt:
            raise ValueError("prompt must contain at least one token")
        if self.timeout_s is not None and self.timeout_s <= 0:
            raise ValueError(
                f"timeout_s must be > 0, got {self.timeout_s}"
            )
        tier_rank(self.tier)  # validate

    @property
    def tier_rank(self) -> int:
        return _TIER_RANK[self.tier]

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


_DONE = object()


class Response:
    """Consumer handle for one request: a per-token stream plus a final
    result. Single-consumer: either iterate :meth:`tokens` (streaming)
    or call :meth:`result` (blocking) — the token list accumulates
    either way."""

    def __init__(self, request: Request):
        self.request = request
        self._stream: "queue.Queue" = queue.Queue()
        self._done = threading.Event()
        self._tokens: List[int] = []
        self.finish_reason: Optional[str] = None
        self.first_token_at: Optional[float] = None
        # monotonic arrival time of every pushed token — the raw series
        # behind TTFT and inter-token latency (benchmarks/run.py's A/B
        # reads it; tokens landing in one tick share a timestamp).
        self.token_times: List[float] = []

    # -- producer side (the scheduler thread) ------------------------------

    def _push(self, token: int) -> None:
        now = time.monotonic()
        if self.first_token_at is None:
            self.first_token_at = now
        self.token_times.append(now)
        self._tokens.append(int(token))
        self._stream.put(int(token))

    def _finish(self, reason: str) -> None:
        if self._done.is_set():
            return
        self.finish_reason = reason
        self._done.set()
        self._stream.put(_DONE)

    # -- consumer side ------------------------------------------------------

    @property
    def done(self) -> bool:
        return self._done.is_set()

    def tokens(self) -> Iterator[int]:
        """Yield tokens as the scheduler emits them; returns when the
        request finishes (check `finish_reason` afterwards)."""
        while True:
            item = self._stream.get()
            if item is _DONE:
                return
            yield item

    def result(self, timeout: Optional[float] = None) -> List[int]:
        """Block until the request finishes; the generated tokens."""
        if not self._done.wait(timeout):
            raise TimeoutError(
                f"request {self.request.id} not finished after {timeout}s"
            )
        return list(self._tokens)

    @property
    def ttft_s(self) -> Optional[float]:
        """Time-to-first-token, once one exists."""
        if self.first_token_at is None:
            return None
        return self.first_token_at - self.request.submitted_at

    def inter_token_gaps_s(self) -> List[float]:
        """Gaps between consecutive token arrivals (empty with < 2
        tokens) — the per-request series behind inter-token-latency
        percentiles. Tokens accepted in one scheduler tick arrive
        together and contribute ~0 gaps; a decode tick stalled behind a
        blocking admission prefill shows up here as one large gap."""
        times = self.token_times
        return [b - a for a, b in zip(times, times[1:])]


class RetryAfterEstimator:
    """Load-aware Retry-After: `floor_s + depth_ahead / retire_rate`.

    The static `retry_after_s` hint lies under load — a full queue
    drains at the service rate, not in one constant interval. This
    tracker records retirement timestamps in a sliding window and turns
    (queue position, recent throughput) into a wait estimate, clamped
    to the static hint as a floor. Rate is counted across ALL tiers
    (every retirement frees a slot any tier can win); the caller passes
    the per-tier `depth_ahead` — queued requests ordered at-or-above
    the rejected one. No retirements observed yet -> the floor, same
    as the static behavior.
    """

    def __init__(self, floor_s: float = 1.0, window_s: float = 30.0):
        if window_s <= 0:
            raise ValueError(f"window_s must be > 0, got {window_s}")
        self.floor_s = float(floor_s)
        self.window_s = float(window_s)
        self._lock = threading.Lock()
        self._events: Deque[Tuple[float, int]] = collections.deque()

    def _prune(self, now: float) -> None:
        horizon = now - self.window_s
        while self._events and self._events[0][0] < horizon:
            self._events.popleft()

    def record_retire(self, tier: str = DEFAULT_TIER,
                      now: Optional[float] = None) -> None:
        now = time.monotonic() if now is None else now
        with self._lock:
            self._events.append((now, tier_rank(tier)))
            self._prune(now)

    def retire_rate(self, now: Optional[float] = None) -> float:
        """Retirements per second over the sliding window (all tiers)."""
        now = time.monotonic() if now is None else now
        with self._lock:
            self._prune(now)
            return len(self._events) / self.window_s

    def estimate(self, depth_ahead: int,
                 now: Optional[float] = None) -> float:
        rate = self.retire_rate(now)
        if rate <= 0.0 or depth_ahead <= 0:
            return self.floor_s
        return max(self.floor_s, depth_ahead / rate)


class AdmissionQueue:
    """Bounded priority admission queue.

    `submit` raises :class:`QueueFull` at capacity — backpressure is the
    caller's signal to shed or retry, never silent buffering. Ordering
    is (SLO tier desc, priority desc, arrival order) — `tier` settles
    ties only through `priority` within a tier. `retry_after_s` is the
    static floor of the Retry-After hint; with an `estimator` attached
    the hint scales with queue depth over the recent retire rate.
    """

    # The Response built per admission. Subclass hook: the ranking
    # queue (ranking/scheduler.py) swaps in a float-score Response while
    # reusing this class's bound/priority/backpressure behavior intact.
    response_cls = Response

    def __init__(self, capacity: int = 64, retry_after_s: float = 1.0,
                 estimator: Optional[RetryAfterEstimator] = None):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self.retry_after_s = retry_after_s
        self.estimator = estimator
        self._lock = threading.Lock()
        self._heap: List[Tuple[int, int, int, Request, Response]] = []
        self._seq = itertools.count()

    @staticmethod
    def _rank_of(request: Request) -> int:
        # getattr: the ranking subsystem submits its own Request type
        # (no tier field) through the subclassed queue — it rides the
        # default tier.
        return getattr(request, "tier_rank", _TIER_RANK[DEFAULT_TIER])

    def retry_hint(self, request: Request) -> float:
        """The Retry-After to attach to a 429 for `request`: the load-
        aware estimate when an estimator is attached, the static hint
        otherwise."""
        if self.estimator is None:
            return self.retry_after_s
        return self.estimator.estimate(self.depth_ahead(
            self._rank_of(request)))

    def submit(self, request: Request) -> Response:
        response = self.response_cls(request)
        with self._lock:
            if len(self._heap) >= self.capacity:
                depth = len(self._heap)
                hint = self.retry_after_s
                if self.estimator is not None:
                    rank = self._rank_of(request)
                    ahead = sum(1 for entry in self._heap
                                if -entry[0] >= rank)
                    hint = self.estimator.estimate(ahead)
                raise QueueFull(depth, hint)
            heapq.heappush(
                self._heap,
                (-self._rank_of(request), -request.priority,
                 next(self._seq), request, response),
            )
        return response

    def pop(self) -> Optional[Tuple[Request, Response]]:
        with self._lock:
            if not self._heap:
                return None
            _, _, _, request, response = heapq.heappop(self._heap)
            return request, response

    def peek_rank(self) -> Optional[int]:
        """Tier rank of the request `pop` would return next, or None on an
        empty queue: the scheduler's resume-vs-admit arbiter."""
        with self._lock:
            return -self._heap[0][0] if self._heap else None

    def drain(self) -> List[Tuple[Request, Response]]:
        with self._lock:
            items = [(req, resp) for _, _, _, req, resp in self._heap]
            self._heap.clear()
            return items

    @property
    def depth(self) -> int:
        with self._lock:
            return len(self._heap)

    def depth_ahead(self, rank: int) -> int:
        """Queued requests ordered at-or-above tier `rank` — the queue
        position a new request of that tier would take."""
        with self._lock:
            return sum(1 for entry in self._heap if -entry[0] >= rank)
