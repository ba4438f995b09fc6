"""Bounded producer/consumer queues and pipelined host threads
(``svc_tpu/runtime/pipeline.py``, the port's own copy).

The reference runs a 3-stage thread pipeline — video reader -> encoder ->
bitstream writer — over bounded circular queues with an end-of-stream
signal (reference: libs/queue.hpp:12-84, apps/encoder.cpp:125-229, queue
caps 10/10; decoder reader cap 100, apps/decoder.cpp:55-88). The apps use
the same structure: a reader thread fills a bounded queue with frames or
payloads, the main thread encodes or decodes, a writer thread drains the
output bytes. ``BoundedQueue`` keeps the reference's queue contract:
blocking push, and a pop that returns None only when the queue is empty
*and* the producer signalled done.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Iterator, List, Optional

_DONE = object()


class CancelledError(RuntimeError):
    """Raised inside a pipeline stage when its token is cancelled."""


class CancelToken:
    """Cooperative cancellation for pipeline stages: stages call
    ``check()`` at loop boundaries and any thread may ``cancel()`` the
    pipeline (clean Ctrl-C teardown). The live counterpart of the
    reference's unused interruptible-thread framework
    (``InterruptFlag``/``IJThread``, libs/thread.hpp:30-152)."""

    def __init__(self):
        self._event = threading.Event()

    def cancel(self) -> None:
        self._event.set()

    @property
    def cancelled(self) -> bool:
        return self._event.is_set()

    def check(self) -> None:
        if self._event.is_set():
            raise CancelledError("pipeline cancelled")

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Interruptible wait (``InterruptibleWait``, libs/thread.hpp:95-104)."""
        return self._event.wait(timeout)


class BoundedQueue:
    """Blocking bounded queue with producer-done signalling (the contract
    of ``CircularQueue``, libs/queue.hpp:23-72)."""

    def __init__(self, capacity: int):
        self._q: "queue.Queue[Any]" = queue.Queue(maxsize=capacity)
        self._done = threading.Event()

    def push(self, item: Any) -> None:
        self._q.put(item)

    def signal_producer_done(self) -> None:
        self._done.set()
        self._q.put(_DONE)  # wakes a blocked pop

    def pop(self) -> Optional[Any]:
        """Blocking pop; returns None iff empty and the producer is done."""
        item = self._q.get()
        if item is _DONE:
            self._q.put(_DONE)  # keep the sentinel for other consumers
            return None
        return item

    def __iter__(self) -> Iterator[Any]:
        while True:
            item = self.pop()
            if item is None:
                return
            yield item


def pipeline_threads(
    producer: Callable[[BoundedQueue], None],
    consumer: Callable[[BoundedQueue], None],
    capacity: int,
    cancel: Optional[CancelToken] = None,
) -> None:
    """Run ``producer`` in a daemon thread feeding ``consumer`` (the
    current thread) through a bounded queue, and join the producer on exit
    (the reference's ``ThreadGuard``, libs/thread.hpp:13-24).

    The producer is expected to call ``cancel.check()`` between pushes;
    when the consumer ends, for any reason, the token is cancelled and the
    queue drained, so a producer blocked on a full queue always unblocks.

    A producer failure (anything but ``CancelledError``) is re-raised here
    after the consumer drains: a crashed reader must never look like a
    clean end of stream, which would "succeed" with a truncated output (a
    bitstream whose header promises more frames than its body holds).
    """
    q = BoundedQueue(capacity)
    producer_error: List[BaseException] = []

    def run_producer():
        try:
            producer(q)
        except CancelledError:
            pass
        except BaseException as e:  # noqa: BLE001 — re-raised below
            producer_error.append(e)
        finally:
            q.signal_producer_done()

    t = threading.Thread(target=run_producer, daemon=True)
    t.start()
    try:
        consumer(q)
    except CancelledError:
        pass
    finally:
        if cancel is not None:
            cancel.cancel()
        # unblock and drain a producer stuck on a full queue so the join
        # below cannot deadlock (a no-op on the normal path)
        while q.pop() is not None:
            pass
        t.join()
    if producer_error:
        raise producer_error[0]
