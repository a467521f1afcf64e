"""Bounded MPMC channel — the backbone of every data-pipeline stage (copy
of ``paddlebox_tpu/utils/channel.py``).

Reference: paddle/fluid/framework/channel.h:39 (``ChannelObject``): bounded
block/batch read-write with close semantics (capacity, block_size batched
reads, ``close()`` drains then raises) on top of a condition-variable
deque; readers get whole batches to amortize locking.

Pipeline gauges: every channel tracks its depth high-watermark and the
wall seconds producers/consumers spent BLOCKED (full on put / empty on
get). The accounting rides the existing lock and only touches the clock
on the blocking slow path. Channels constructed with a ``name``
aggregate into a process-wide registry (``channel_stats_snapshot``):
live ones are snapshotted directly; a finalizer folds each channel's
totals into the per-name aggregate at GC, so short-lived per-pass
pipelines keep their history."""

from __future__ import annotations

import collections
import threading
import time
import weakref
from typing import (Deque, Dict, Generic, Iterable, Iterator, List,
                    Optional, TypeVar)

T = TypeVar("T")

_LIVE: "weakref.WeakSet[Channel]" = weakref.WeakSet()
_CLOSED: Dict[str, Dict[str, float]] = {}
_REG_LOCK = threading.Lock()


def _fold_stats(name: str, m: Dict[str, float]) -> None:
    """Fold one channel's final counters into the per-name aggregate
    (weakref.finalize callback — ``m`` outlives the channel)."""
    with _REG_LOCK:
        agg = _CLOSED.setdefault(name, {
            "channels": 0, "high_watermark": 0, "puts": 0, "gets": 0,
            "blocked_put_sec": 0.0, "blocked_get_sec": 0.0})
        agg["channels"] += 1
        agg["high_watermark"] = max(agg["high_watermark"],
                                    m["high_watermark"])
        for k in ("puts", "gets", "blocked_put_sec", "blocked_get_sec"):
            agg[k] += m[k]


class ChannelClosed(Exception):
    pass


class Channel(Generic[T]):
    def __init__(self, capacity: int = 65536, block_size: int = 1024,
                 name: Optional[str] = None) -> None:
        self._capacity = max(1, capacity)
        self._block_size = max(1, block_size)
        self._q: Deque[T] = collections.deque()
        self._lock = threading.Lock()
        self._not_full = threading.Condition(self._lock)
        self._not_empty = threading.Condition(self._lock)
        self._closed = False
        self.name = name
        # gauge counters in a dict that OUTLIVES the channel (the
        # finalizer folds it into the registry at GC)
        self._m: Dict[str, float] = {
            "high_watermark": 0, "puts": 0, "gets": 0,
            "blocked_put_sec": 0.0, "blocked_get_sec": 0.0}
        if name is not None:
            with _REG_LOCK:
                _LIVE.add(self)
            weakref.finalize(self, _fold_stats, name, self._m)

    # -- write side ---------------------------------------------------------
    def put(self, item: T) -> None:
        m = self._m
        with self._not_full:
            if len(self._q) >= self._capacity and not self._closed:
                t0 = time.perf_counter()
                while len(self._q) >= self._capacity and not self._closed:
                    self._not_full.wait()
                m["blocked_put_sec"] += time.perf_counter() - t0
            if self._closed:
                raise ChannelClosed("put on closed channel")
            self._q.append(item)
            m["puts"] += 1
            n = len(self._q)
            if n > m["high_watermark"]:
                m["high_watermark"] = n
            self._not_empty.notify()

    def put_many(self, items: Iterable[T]) -> None:
        for it in items:
            self.put(it)

    # -- read side ----------------------------------------------------------
    def get(self, timeout: Optional[float] = None) -> T:
        deadline = None if timeout is None else time.monotonic() + timeout
        m = self._m
        with self._not_empty:
            if not self._q and not self._closed:
                t0 = time.perf_counter()
                while not self._q and not self._closed:
                    remaining = None if deadline is None \
                        else deadline - time.monotonic()
                    if remaining is not None and remaining <= 0:
                        break
                    self._not_empty.wait(timeout=remaining)
                m["blocked_get_sec"] += time.perf_counter() - t0
            if self._q:
                item = self._q.popleft()
                m["gets"] += 1
                self._not_full.notify()
                return item
            if self._closed:
                raise ChannelClosed("get on closed empty channel")
            raise TimeoutError("channel get timed out")

    def get_batch(self, max_items: Optional[int] = None) -> List[T]:
        """Blocking batched read; returns [] only when closed and drained."""
        n = self._block_size if max_items is None else max_items
        if n <= 0:
            raise ValueError(f"max_items must be positive, got {n}")
        m = self._m
        with self._not_empty:
            if not self._q and not self._closed:
                t0 = time.perf_counter()
                while not self._q and not self._closed:
                    self._not_empty.wait()
                m["blocked_get_sec"] += time.perf_counter() - t0
            out: List[T] = []
            while self._q and len(out) < n:
                out.append(self._q.popleft())
            if out:
                m["gets"] += len(out)
                self._not_full.notify_all()
            return out

    def close(self) -> None:
        with self._lock:
            self._closed = True
            self._not_empty.notify_all()
            self._not_full.notify_all()

    def cancel(self) -> None:
        """CONSUMER-side close: mark closed and drop whatever is queued,
        so a producer blocked on a full channel unblocks promptly (its
        pending ``put`` raises ChannelClosed) and nothing is retained
        for a consumer that has walked away. ``close()`` keeps drain
        semantics for the normal producer-side end-of-stream."""
        with self._lock:
            self._closed = True
            self._q.clear()
            self._not_empty.notify_all()
            self._not_full.notify_all()

    @property
    def closed(self) -> bool:
        return self._closed

    @property
    def capacity(self) -> int:
        return self._capacity

    def metrics(self) -> Dict[str, float]:
        """Pipeline gauges for this channel (see module docstring)."""
        with self._lock:
            return dict(self._m, depth=len(self._q),
                        capacity=self._capacity)

    def __len__(self) -> int:
        with self._lock:
            return len(self._q)

    def __iter__(self) -> Iterator[T]:
        while True:
            batch = self.get_batch()
            if not batch:
                return
            yield from batch


def channel_stats_snapshot() -> Dict[str, Dict[str, float]]:
    """Per-name aggregate over collected + live named channels. Counters
    (puts/gets/blocked_*_sec) are CUMULATIVE for the process — per-pass
    views diff consecutive snapshots; ``depth`` is the live depth now."""
    with _REG_LOCK:
        out: Dict[str, Dict[str, float]] = {}
        for name, agg in _CLOSED.items():
            out[name] = dict(agg, depth=0, capacity=0)
        live = list(_LIVE)
    for ch in live:
        if ch.name is None:
            continue
        m = ch.metrics()
        st = out.setdefault(ch.name, {
            "channels": 0, "high_watermark": 0, "puts": 0, "gets": 0,
            "blocked_put_sec": 0.0, "blocked_get_sec": 0.0,
            "depth": 0, "capacity": 0})
        st["channels"] += 1
        st["depth"] += m["depth"]
        st["capacity"] = max(st["capacity"], m["capacity"])
        st["high_watermark"] = max(st["high_watermark"],
                                   m["high_watermark"])
        for k in ("puts", "gets", "blocked_put_sec", "blocked_get_sec"):
            st[k] += m[k]
    for st in out.values():
        st["blocked_put_sec"] = round(st["blocked_put_sec"], 6)
        st["blocked_get_sec"] = round(st["blocked_get_sec"], 6)
    return out


def reset_channel_stats() -> None:
    """Drop the per-name aggregates of collected channels (tests)."""
    with _REG_LOCK:
        _CLOSED.clear()
