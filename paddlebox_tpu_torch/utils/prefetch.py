"""Producer-thread prefetch over a bounded channel (copy of
``paddlebox_tpu/utils/prefetch.py``): trainers overlap host batch prep
with device compute through it."""

from __future__ import annotations

import threading
from typing import Callable, Iterable, Iterator, Optional, TypeVar

from paddlebox_tpu_torch.utils.channel import Channel, ChannelClosed

T = TypeVar("T")
U = TypeVar("U")


def prefetch_iter(items: Iterable[T], prepare: Callable[[T], U],
                  capacity: int = 4,
                  name: Optional[str] = None) -> Iterator[U]:
    """Yield prepare(item) for each item, with preparation running in a
    producer thread up to ``capacity`` items ahead. Producer exceptions
    re-raise at the consumer. ``name`` registers the backing channel's
    pipeline gauges (depth, high watermark, blocked time) with the
    telemetry registry (``utils.channel.channel_stats_snapshot``).

    Abandon-safe: if the consumer walks away early (break / exception /
    GeneratorExit), the ``finally`` cancels the channel so a producer
    blocked on ``put`` unblocks, and ``items`` is closed when it is
    itself a generator — so chained prefetch stages unwind transitively
    instead of leaking blocked threads."""
    ch: Channel = Channel(capacity=capacity, name=name)
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
