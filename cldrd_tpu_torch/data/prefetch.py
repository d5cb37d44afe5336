"""Host-side batch prefetching (copy of ``cldrd_tpu/data/prefetch.py``).

``prefetch`` runs the producer iterator (tokenization, collation) in a
background thread with a bounded queue, so batch N+1..N+depth are made
while the device works on batch N. Order is preserved; producer
exceptions re-raise at the consumer; if the consumer abandons the
generator early, a stop event releases the producer thread. The
consumer's wait for its next item is the span ``cldrd.data.wait``.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator, TypeVar

from cldrd_tpu_torch.utils.profiling import annotate

T = TypeVar("T")

_SENTINEL = object()


def prefetch(iterable: Iterable[T], depth: int = 4) -> Iterator[T]:
    """Yield from ``iterable`` with up to ``depth`` items produced ahead."""
    assert depth >= 1
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = threading.Event()
    error = []

    def producer():
        try:
            for item in iterable:
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if stop.is_set():
                    return
        except BaseException as e:  # re-raised on the consumer thread
            error.append(e)
        finally:
            while not stop.is_set():
                try:
                    q.put(_SENTINEL, timeout=0.1)
                    break
                except queue.Full:
                    continue

    thread = threading.Thread(target=producer, daemon=True, name="cldrd-prefetch")
    thread.start()
    try:
        while True:
            with annotate("cldrd.data.wait"):
                item = q.get()
            if item is _SENTINEL:
                if error:
                    raise error[0]
                return
            yield item
    finally:
        stop.set()
