"""Host key→row index (copy of ``paddlebox_tpu/ps/kv.py``): uint64 keys →
int32 rows with free-list reuse and a hard row capacity (raises when
full). Two routes share the contract that the tables use (assign /
lookup / release / items / len, the fused ``assign_unique`` and
``lookup_unique``, and the slot arena):

- ``NativeKV``, a ctypes wrapper over ``native/kv_index.cpp``, which
  ``make_kv`` returns;
- ``PyKV``, a python dict, for a machine where the library cannot build,
  and as the named comparison that ``chip_smoke.py`` times beside it.

Each route names itself in ``kv_route`` ("native" or "python"), so no
caller takes the slow route unseen. Both yield uniques, and allocate new
rows, in FIRST-OCCURRENCE order, and ``lookup_unique`` puts the one
shared miss entry where the first miss occurs: the two routes give the
same rows, inverses and arena rows for the same calls, bit for bit.
"""

from __future__ import annotations

import ctypes
import logging
from typing import Dict, Optional, Tuple

import numpy as np

from paddlebox_tpu_torch import native

log = logging.getLogger(__name__)


class TableFullError(RuntimeError):
    pass


def _full_error(capacity: int) -> TableFullError:
    return TableFullError(
        f"embedding table full ({capacity} rows); raise the capacity or "
        "shrink the table")


def dedup_first_seen_py(keys: np.ndarray
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Dedup ``keys`` in first-seen order → (uniq, first_idx, inv): the
    three-pass formulation (``_dedup_first_seen_py`` in
    ``paddlebox_tpu/ps/table.py``), the oracle of the native one-pass
    dedup and the python route's dedup."""
    uniq_s, first_s, inv_s = np.unique(keys, return_index=True,
                                       return_inverse=True)
    order = np.argsort(first_s, kind="stable")
    rank = np.empty(len(order), np.int64)
    rank[order] = np.arange(len(order), dtype=np.int64)
    return uniq_s[order], first_s[order], rank[inv_s]


def _buf(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


class _PyArena:
    """Slot-arena allocator state (mirror of the native Arena struct):
    rows are carved from chunk-aligned extents owned by one slot each, so
    (slot, local) addresses any row compactly."""

    def __init__(self, chunk_bits: int, n_slots: int, max_rows: int):
        self.chunk_bits = chunk_bits
        self.n_slots = n_slots  # default (slotless) arena = id n_slots
        self.max_chunks = (max_rows + (1 << chunk_bits) - 1) >> chunk_bits
        self.chunk_slot = np.full(self.max_chunks, -1, np.int32)
        self.chunk_rank = np.full(self.max_chunks, -1, np.int32)
        self.next_chunk = 0
        self.slot_nchunks = [0] * (n_slots + 1)
        self.slot_tail = [-1] * (n_slots + 1)
        self.slot_fill = [0] * (n_slots + 1)
        self.slot_free: list[list[int]] = [[] for _ in range(n_slots + 1)]

    def alloc(self, s: int, max_rows: int) -> int:
        if self.slot_free[s]:
            return self.slot_free[s].pop()
        cs = 1 << self.chunk_bits
        if self.slot_tail[s] < 0 or self.slot_fill[s] == cs:
            if self.next_chunk >= self.max_chunks:
                return -2
            c = self.next_chunk
            self.next_chunk += 1
            self.chunk_slot[c] = s
            self.chunk_rank[c] = self.slot_nchunks[s]
            self.slot_nchunks[s] += 1
            self.slot_tail[s] = c
            self.slot_fill[s] = 0
        row = (self.slot_tail[s] << self.chunk_bits) + self.slot_fill[s]
        self.slot_fill[s] += 1
        return row if row < max_rows else -2

    def local_of(self, row: int, s: int) -> int:
        if not 0 <= s < self.n_slots:  # incl. the default arena id
            return -1
        c = row >> self.chunk_bits
        if self.chunk_slot[c] != s:
            return -1
        return ((int(self.chunk_rank[c]) << self.chunk_bits)
                | (row & ((1 << self.chunk_bits) - 1)))


class PyKV:
    """Dict-backed index: the python route."""

    kv_route = "python"

    def __init__(self, capacity: int) -> None:
        self.capacity = capacity
        self._map: Dict[int, int] = {}
        self._free: list[int] = []
        self._next = 0
        self._arena: Optional[_PyArena] = None

    def __len__(self) -> int:
        return len(self._map)

    def arena_enable(self, chunk_bits: int, n_slots: int) -> None:
        if self._map or self._next:
            raise RuntimeError("arena_enable after rows were assigned")
        self._arena = _PyArena(chunk_bits, n_slots, self.capacity)

    @property
    def arena_enabled(self) -> bool:
        return self._arena is not None

    def _alloc(self, slot: int = -1) -> int:
        if self._arena is not None:
            # out-of-range slots clamp to the default (slotless) arena, as
            # the native clamp_slot does: local = -1 for such rows
            s = (slot if 0 <= slot < self._arena.n_slots
                 else self._arena.n_slots)
            r = self._arena.alloc(s, self.capacity)
            if r == -2:
                raise _full_error(self.capacity)
            return r
        if self._free:
            return self._free.pop()
        if self._next < self.capacity:
            r = self._next
            self._next += 1
            return r
        raise _full_error(self.capacity)

    def assign(self, keys: np.ndarray) -> np.ndarray:
        """Rows for ``keys``; unseen keys get a free row."""
        rows = np.empty(len(keys), dtype=np.int32)
        m = self._map
        for i, k in enumerate(keys.tolist()):
            r = m.get(k)
            if r is None:
                r = self._alloc()
                m[k] = r
            rows[i] = r
        return rows

    def assign_slotted(self, keys: np.ndarray, slots: np.ndarray
                       ) -> Tuple[np.ndarray, np.ndarray]:
        """(global rows, slot-local rows); local = -1 where the key's row
        lives in another slot's arena."""
        assert self._arena is not None
        rows = np.empty(len(keys), dtype=np.int32)
        locs = np.empty(len(keys), dtype=np.int32)
        m = self._map
        for i, (k, s) in enumerate(zip(keys.tolist(), slots.tolist())):
            r = m.get(k)
            if r is None:
                r = self._alloc(s)
                m[k] = r
            rows[i] = r
            locs[i] = self._arena.local_of(r, s)
        return rows, locs

    def assign_unique(self, keys: np.ndarray
                      ) -> Tuple[np.ndarray, np.ndarray]:
        """Dedup + assign → (rows of the uniques, inverse int32): uniques
        and new rows come in first-occurrence order."""
        keys = np.ascontiguousarray(keys, np.uint64)
        uniq, _, inv = dedup_first_seen_py(keys)
        return self.assign(uniq), inv.astype(np.int32)

    def assign_unique_slotted(self, keys: np.ndarray, slots: np.ndarray
                              ) -> Tuple[np.ndarray, np.ndarray]:
        """Slotted ``assign_unique``: first-occurrence order, each new key
        allocated in the arena of the slot of its first occurrence."""
        assert self._arena is not None
        keys = np.ascontiguousarray(keys, np.uint64)
        uniq, first_idx, inv = dedup_first_seen_py(keys)
        rows = np.empty(len(uniq), dtype=np.int32)
        m = self._map
        for j, (k, s) in enumerate(zip(uniq.tolist(),
                                       slots[first_idx].tolist())):
            r = m.get(k)
            if r is None:
                r = self._alloc(s)
                m[k] = r
            rows[j] = r
        return rows, inv.astype(np.int32)

    def arena_export(self) -> Tuple[np.ndarray, np.ndarray]:
        a = self._arena
        assert a is not None
        n = a.next_chunk
        return a.chunk_slot[:n].copy(), a.chunk_rank[:n].copy()

    def lookup(self, keys: np.ndarray) -> np.ndarray:
        """Rows for ``keys``; unknown keys → -1."""
        m = self._map
        return np.array([m.get(k, -1) for k in keys.tolist()],
                        dtype=np.int32)

    def release(self, keys: np.ndarray) -> np.ndarray:
        """Drop ``keys``; returns the freed rows (in key order), which the
        next assignments reuse last-freed first."""
        rows = np.empty(len(keys), dtype=np.int32)
        a = self._arena
        for i, k in enumerate(keys.tolist()):
            r = self._map.pop(k, -1)
            if r >= 0:
                if a is not None:  # back to the OWNING arena
                    a.slot_free[a.chunk_slot[r >> a.chunk_bits]].append(r)
                else:
                    self._free.append(r)
            rows[i] = r
        return rows[rows >= 0]

    def items(self) -> Tuple[np.ndarray, np.ndarray]:
        if not self._map:
            return (np.empty(0, np.uint64), np.empty(0, np.int32))
        ks = np.fromiter(self._map.keys(), dtype=np.uint64,
                         count=len(self._map))
        rs = np.fromiter(self._map.values(), dtype=np.int32,
                         count=len(self._map))
        return ks, rs

    def lookup_unique(self, keys: np.ndarray,
                      sentinel: int) -> Tuple[np.ndarray, np.ndarray]:
        """Read-only dedup → (unique rows, inverse), in first-occurrence
        order. ALL unknown keys collapse into ONE unique entry holding
        the sentinel row, at the position of the first miss (the native
        ``kv_lookup_unique``'s order), which keeps the unique rows
        duplicate-free."""
        keys = np.ascontiguousarray(keys, np.uint64)
        uniq, _, inv = dedup_first_seen_py(keys)
        rows = self.lookup(uniq)
        miss = rows < 0
        if not miss.any():
            return rows, inv.astype(np.int32)
        first_miss = int(np.argmax(miss))
        keep = ~miss
        keep[first_miss] = True
        pos = (np.cumsum(keep) - 1).astype(np.int32)
        pos[miss] = pos[first_miss]
        out_rows = rows[keep]
        out_rows[pos[first_miss]] = sentinel
        return out_rows, pos[inv]


class NativeKV:
    """ctypes wrapper over ``native/kv_index.cpp``: the native route."""

    kv_route = "native"

    def __init__(self, capacity: int, lib) -> None:
        self.capacity = capacity
        self._lib = lib
        self._h = lib.kv_create(min(capacity, 1 << 22), capacity)
        self.arena_enabled = False

    def __del__(self) -> None:
        h = getattr(self, "_h", None)
        if h:
            self._lib.kv_destroy(h)
            self._h = None

    def __len__(self) -> int:
        return int(self._lib.kv_size(self._h))

    def arena_enable(self, chunk_bits: int, n_slots: int) -> None:
        if self._lib.kv_arena_enable(self._h, chunk_bits, n_slots) != 0:
            raise RuntimeError("arena_enable after rows were assigned")
        self.arena_enabled = True

    def assign(self, keys: np.ndarray) -> np.ndarray:
        keys = np.ascontiguousarray(keys, dtype=np.uint64)
        rows = np.empty(len(keys), dtype=np.int32)
        done = self._lib.kv_assign(self._h, _buf(keys), len(keys),
                                   _buf(rows))
        if done != len(keys):
            raise _full_error(self.capacity)
        return rows

    def assign_slotted(self, keys: np.ndarray, slots: np.ndarray
                       ) -> Tuple[np.ndarray, np.ndarray]:
        """(global rows, slot-local rows); local = -1 where the key's row
        lives in another slot's arena."""
        keys = np.ascontiguousarray(keys, dtype=np.uint64)
        slots = np.ascontiguousarray(slots, dtype=np.uint16)
        n = len(keys)
        rows = np.empty(n, dtype=np.int32)
        locs = np.empty(n, dtype=np.int32)
        done = self._lib.kv_assign_slotted(self._h, _buf(keys), _buf(slots),
                                           n, _buf(rows), _buf(locs))
        if done != n:
            raise _full_error(self.capacity)
        return rows, locs

    def assign_unique(self, keys: np.ndarray
                      ) -> Tuple[np.ndarray, np.ndarray]:
        """One-pass hash dedup + row assign (no sort); uniques come in
        first-occurrence order."""
        keys = np.ascontiguousarray(keys, dtype=np.uint64)
        n = len(keys)
        uniq_rows = np.empty(n, dtype=np.int32)
        inv = np.empty(n, dtype=np.int32)
        u = self._lib.kv_assign_unique(self._h, _buf(keys), n,
                                       _buf(uniq_rows), _buf(inv))
        if u < 0:
            raise _full_error(self.capacity)
        return uniq_rows[:u].copy(), inv

    def assign_unique_slotted(self, keys: np.ndarray, slots: np.ndarray
                              ) -> Tuple[np.ndarray, np.ndarray]:
        keys = np.ascontiguousarray(keys, dtype=np.uint64)
        slots = np.ascontiguousarray(slots, dtype=np.uint16)
        n = len(keys)
        uniq_rows = np.empty(n, dtype=np.int32)
        inv = np.empty(n, dtype=np.int32)
        u = self._lib.kv_assign_unique_slotted(
            self._h, _buf(keys), _buf(slots), n, _buf(uniq_rows), _buf(inv))
        if u < 0:
            raise _full_error(self.capacity)
        return uniq_rows[:u].copy(), inv

    def arena_export(self) -> Tuple[np.ndarray, np.ndarray]:
        n = int(self._lib.kv_arena_chunk_count(self._h))
        cs = np.empty(max(n, 1), dtype=np.int32)
        cr = np.empty(max(n, 1), dtype=np.int32)
        if n:
            self._lib.kv_arena_export(self._h, _buf(cs), _buf(cr))
        return cs[:n], cr[:n]

    def lookup(self, keys: np.ndarray) -> np.ndarray:
        keys = np.ascontiguousarray(keys, dtype=np.uint64)
        rows = np.empty(len(keys), dtype=np.int32)
        self._lib.kv_lookup(self._h, _buf(keys), len(keys), _buf(rows))
        return rows

    def release(self, keys: np.ndarray) -> np.ndarray:
        keys = np.ascontiguousarray(keys, dtype=np.uint64)
        rows = np.empty(len(keys), dtype=np.int32)
        self._lib.kv_release(self._h, _buf(keys), len(keys), _buf(rows))
        return rows[rows >= 0]

    def items(self) -> Tuple[np.ndarray, np.ndarray]:
        n = len(self)
        ks = np.empty(n, dtype=np.uint64)
        rs = np.empty(n, dtype=np.int32)
        if n:
            self._lib.kv_items(self._h, _buf(ks), _buf(rs))
        return ks, rs

    def lookup_unique(self, keys: np.ndarray,
                      sentinel: int) -> Tuple[np.ndarray, np.ndarray]:
        keys = np.ascontiguousarray(keys, dtype=np.uint64)
        n = len(keys)
        uniq_rows = np.empty(max(n, 1), dtype=np.int32)
        inv = np.empty(n, dtype=np.int32)
        u = self._lib.kv_lookup_unique(self._h, _buf(keys), n, sentinel,
                                       _buf(uniq_rows), _buf(inv))
        return uniq_rows[:u].copy(), inv


def make_kv(capacity: int):
    """The native index; the python one, with a warning, where the
    library cannot build. The route reads from ``kv_route``."""
    try:
        return NativeKV(capacity, native.load())
    except RuntimeError as e:
        log.warning("%s; the host key index takes the python route", e)
        return PyKV(capacity)


def dedup_first_seen_native(keys: np.ndarray
                            ) -> Optional[Tuple[np.ndarray, np.ndarray,
                                                np.ndarray]]:
    """Native one-pass first-seen dedup (``kv_dedup_first_seen``) →
    (uniq, first_idx, inv) with the oracle's dtypes, or None where the
    library cannot build."""
    try:
        lib = native.load()
    except RuntimeError:
        return None
    keys = np.ascontiguousarray(keys, np.uint64)
    n = len(keys)
    uniq = np.empty(max(n, 1), np.uint64)
    first = np.empty(max(n, 1), np.int64)
    inv = np.empty(max(n, 1), np.int32)
    u = lib.kv_dedup_first_seen(_buf(keys), n, _buf(uniq), _buf(first),
                                _buf(inv))
    return uniq[:u].copy(), first[:u].copy(), inv[:n].astype(np.int64)
