"""Host→device input prefetch — the port's copy of
tf_yarn_tpu/data/prefetch.py.

Batches are staged a few steps ahead of the consumer on a background
thread (and placed on the device there, when a `place_fn` is given), so
the decode or train step never waits on host I/O.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, Optional


def prefetch(
    iterator: Iterator,
    place_fn: Optional[Callable] = None,
    depth: int = 2,
    name: Optional[str] = None,
) -> Iterator:
    """Yield items from `iterator`, staging up to `depth` ahead.

    `place_fn` maps a host batch to device arrays (e.g. the train loop's
    batch globalizer); placement happens on the background thread so the
    consumer only ever sees device-resident batches.

    `name` labels this pipeline in the telemetry registry: the staged
    queue depth is published as ``prefetch/queue_depth{pipeline=name}``
    on every put/get — a depth pinned at 0 is the "prefetch starved"
    diagnosis behind a tokens/sec drop, pinned at `depth` means the
    consumer (device) is the bottleneck.
    """
    if depth < 1:
        yield from (place_fn(item) if place_fn else item for item in iterator)
        return

    depth_gauge = None
    if name is not None:
        from tf_yarn_tpu_torch.telemetry import get_registry

        depth_gauge = get_registry().gauge(
            "prefetch/queue_depth", pipeline=name
        )

    q: "queue.Queue" = queue.Queue(maxsize=depth)
    _END = object()

    class _Error:
        # Private wrapper: identity-checked below, so iterators that
        # legitimately yield tuples (even array-valued ones, where `==`
        # would return an array) can never collide with the sentinel.
        def __init__(self, exc: BaseException) -> None:
            self.exc = exc

    stopped = threading.Event()

    def _put(item) -> bool:
        while not stopped.is_set():
            try:
                q.put(item, timeout=0.2)
                if depth_gauge is not None:
                    depth_gauge.set(q.qsize())
                return True
            except queue.Full:
                continue
        return False

    def producer() -> None:
        try:
            for item in iterator:
                if not _put(place_fn(item) if place_fn else item):
                    return  # consumer gone: stop holding device batches
        except BaseException as exc:  # surface in consumer
            _put(_Error(exc))
        finally:
            _put(_END)

    thread = threading.Thread(target=producer, name="input-prefetch", daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if depth_gauge is not None:
                depth_gauge.set(q.qsize())
            if item is _END:
                return
            if isinstance(item, _Error):
                raise item.exc
            yield item
    finally:
        # Consumer done (train_steps reached / exception / generator
        # closed): unblock the producer and drop staged device batches so
        # they don't pin device memory.
        stopped.set()
        while True:
            try:
                q.get_nowait()
            except queue.Empty:
                break
