"""Host-side prefetching: overlap decoding and keypoint seeding with device
compute.

Counterpart of ``comet_tpu/data/prefetch.py``. The device step is
asynchronous: while the card evaluates sequence i, a producer thread
prepares sequence i+1/i+2. A bounded queue (depth 2) gives double buffering
without unbounded memory growth. Work that the producer puts on the card
runs on its own stream (``data/device_pipeline.py``).
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, TypeVar

T = TypeVar("T")

_SENTINEL = object()


def prefetch(producer: Callable[[int], T], n: int, depth: int = 2) -> Iterator[T]:
    """Yield producer(0..n-1) with a background thread keeping `depth`
    items ready. Exceptions in the producer propagate to the consumer."""
    if n <= 0:
        return
    q: queue.Queue = queue.Queue(maxsize=depth)

    def work():
        try:
            for i in range(n):
                q.put(producer(i))
        except BaseException as e:  # noqa: BLE001 — re-raised on the consumer side
            q.put(e)
            return
        q.put(_SENTINEL)

    t = threading.Thread(target=work, daemon=True, name="comet-prefetch")
    t.start()
    while True:
        item = q.get()
        if item is _SENTINEL:
            return
        if isinstance(item, BaseException):
            raise item
        yield item
