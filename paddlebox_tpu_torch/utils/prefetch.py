"""Producer-thread prefetch over a bounded channel (copy of
``paddlebox_tpu/utils/prefetch.py``, with the channel reduced to what it
uses): trainers overlap host batch prep with device compute through it."""

from __future__ import annotations

import collections
import threading
from typing import Callable, Deque, Iterable, Iterator, TypeVar

T = TypeVar("T")
U = TypeVar("U")


class ChannelClosed(Exception):
    pass


class _Channel:
    """Bounded FIFO with close (readers drain, then stop) and cancel
    (a blocked writer raises ``ChannelClosed``)."""

    def __init__(self, capacity: int) -> None:
        self._capacity = max(1, capacity)
        self._q: Deque = collections.deque()
        self._cv = threading.Condition()
        self._closed = False
        self._cancelled = False

    def put(self, item) -> None:
        with self._cv:
            while len(self._q) >= self._capacity and not self._cancelled:
                self._cv.wait()
            if self._cancelled or self._closed:
                raise ChannelClosed("put on closed channel")
            self._q.append(item)
            self._cv.notify_all()

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify_all()

    def cancel(self) -> None:
        with self._cv:
            self._closed = self._cancelled = True
            self._q.clear()
            self._cv.notify_all()

    def __iter__(self):
        while True:
            with self._cv:
                while not self._q and not self._closed:
                    self._cv.wait()
                if not self._q:
                    return
                item = self._q.popleft()
                self._cv.notify_all()
            yield item


def prefetch_iter(items: Iterable[T], prepare: Callable[[T], U],
                  capacity: int = 4) -> Iterator[U]:
    """Yield prepare(item) for each item, with preparation running in a
    producer thread up to ``capacity`` items ahead. Producer exceptions
    re-raise at the consumer.

    Abandon-safe: if the consumer walks away early (break / exception /
    GeneratorExit), the ``finally`` cancels the channel so a producer
    blocked on ``put`` unblocks, and ``items`` is closed when it is
    itself a generator — so chained prefetch stages unwind transitively
    instead of leaking blocked threads."""
    ch = _Channel(capacity)
    err: list = []

    def producer() -> None:
        try:
            for it in items:
                ch.put(prepare(it))
        except ChannelClosed:
            pass  # consumer cancelled the channel — normal abandon path
        except BaseException as e:
            err.append(e)
        finally:
            ch.close()
            close = getattr(items, "close", None)
            if close is not None:
                try:  # unwind an upstream generator (chained stages)
                    close()
                except BaseException as e:
                    if not err:
                        err.append(e)

    th = threading.Thread(target=producer, daemon=True)
    th.start()
    try:
        for out in ch:
            yield out
    finally:
        ch.cancel()
        th.join()
    if err:
        raise err[0]
