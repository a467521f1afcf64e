"""Host key→row index (copy of the python ``PyKV`` in
``paddlebox_tpu/ps/kv.py``): uint64 keys → int32 rows with a hard row
capacity. Rows are handed out densely from 0 and never released: the
port has no shrink yet, so no free list is carried over.

``assign_unique`` is the training path's per-batch dedup + assign. It
yields uniques, and allocates new rows, in FIRST-OCCURRENCE order, as the
reference's native index does (``NativeKV.assign_unique``), so a batch's
``unique_rows`` match the reference row for row.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


class TableFullError(RuntimeError):
    pass


def dedup_first_seen(keys: np.ndarray
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Dedup ``keys`` in first-seen order → (uniq, first_idx, inv), the
    three-pass formulation of ``_dedup_first_seen_py`` in
    ``paddlebox_tpu/ps/table.py``."""
    uniq_s, first_s, inv_s = np.unique(keys, return_index=True,
                                       return_inverse=True)
    order = np.argsort(first_s, kind="stable")
    rank = np.empty(len(order), np.int64)
    rank[order] = np.arange(len(order), dtype=np.int64)
    return uniq_s[order], first_s[order], rank[inv_s]


class PyKV:
    """Dict-backed key→row index; rows are handed out densely from 0."""

    def __init__(self, capacity: int) -> None:
        self.capacity = capacity
        self._map: Dict[int, int] = {}

    def __len__(self) -> int:
        return len(self._map)

    def assign(self, keys: np.ndarray) -> np.ndarray:
        """Rows for ``keys``; unseen keys get the next free row."""
        rows = np.empty(len(keys), dtype=np.int32)
        m = self._map
        for i, k in enumerate(keys.tolist()):
            r = m.get(k)
            if r is None:
                r = len(m)
                if r >= self.capacity:
                    raise TableFullError(
                        f"embedding table full ({self.capacity} rows)")
                m[k] = r
            rows[i] = r
        return rows

    def assign_unique(self, keys: np.ndarray
                      ) -> Tuple[np.ndarray, np.ndarray]:
        """Dedup + assign → (rows of the uniques, inverse int32): uniques
        and new rows come in first-occurrence order."""
        keys = np.ascontiguousarray(keys, np.uint64)
        uniq, _, inv = dedup_first_seen(keys)
        return self.assign(uniq), inv.astype(np.int32)

    def lookup(self, keys: np.ndarray) -> np.ndarray:
        """Rows for ``keys``; unknown keys → -1."""
        m = self._map
        return np.array([m.get(k, -1) for k in keys.tolist()],
                        dtype=np.int32)

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
        """Read-only dedup → (unique rows, inverse). ALL unknown keys
        collapse into ONE unique entry holding the sentinel row, which
        keeps the unique rows duplicate-free."""
        uniq, inv = np.unique(keys, return_inverse=True)
        rows = self.lookup(uniq)
        miss = rows < 0
        if not miss.any():
            return rows, inv.astype(np.int32, copy=False)
        # known uniques keep their relative order, misses share one slot
        remap = np.empty(len(uniq), np.int32)
        known_idx = np.nonzero(~miss)[0]
        remap[known_idx] = np.arange(len(known_idx), dtype=np.int32)
        remap[np.nonzero(miss)[0]] = len(known_idx)
        out_rows = np.empty(len(known_idx) + 1, np.int32)
        out_rows[:len(known_idx)] = rows[known_idx]
        out_rows[len(known_idx)] = sentinel
        return out_rows, remap[inv].astype(np.int32, copy=False)
