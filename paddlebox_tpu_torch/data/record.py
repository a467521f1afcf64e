"""One training or serving instance and the record pool (copy of
``paddlebox_tpu/data/record.py``): numpy-columnar, so batch building is
array concatenation."""

from __future__ import annotations

import dataclasses
import threading
from typing import List, Optional, Sequence

import numpy as np


@dataclasses.dataclass
class SlotRecord:
    """``keys`` holds all sparse feasigns for all S sparse slots
    concatenated; ``slot_offsets`` (len S+1) delimits each slot's span.
    ``ins_id``, ``search_id``, ``rank``, ``cmatch``, ``uid`` and
    ``timestamp`` are what the PV merge (``data/pv.py``) reads."""

    keys: np.ndarray                 # uint64 [total_keys]
    slot_offsets: np.ndarray         # int32  [S+1]
    dense: np.ndarray                # float32 [dense_dim]
    label: float = 0.0
    show: float = 1.0
    clk: float = 0.0
    ins_id: str = ""
    search_id: int = 0
    rank: int = 0
    cmatch: int = 0
    uid: int = 0                     # user id for the uid merge
    timestamp: int = 0               # cur_timestamp_ (need_time_info path)

    def slot_keys(self, slot_idx: int) -> np.ndarray:
        return self.keys[self.slot_offsets[slot_idx]:
                         self.slot_offsets[slot_idx + 1]]

    @property
    def num_keys(self) -> int:
        return int(self.keys.shape[0])


class SlotRecordPool:
    """Free-list recycler for parsed record batches.

    Reference: ``SlotObjPool``/``SlotRecordPool()`` (data_feed.h:246-433)
    bounds allocator churn when passes load hundreds of millions of
    records; the API (get/put/clear, capacity from
    ``FLAGS.record_pool_max_size``) is kept so the pipeline code reads the
    same."""

    def __init__(self, max_size: Optional[int] = None) -> None:
        from paddlebox_tpu_torch.config import FLAGS
        self._max = (max_size if max_size is not None
                     else FLAGS.record_pool_max_size)
        self._free: List[SlotRecord] = []
        self._lock = threading.Lock()

    def get(self, n: int) -> List[SlotRecord]:
        with self._lock:
            take = min(n, len(self._free))
            out = self._free[len(self._free) - take:]
            del self._free[len(self._free) - take:]
        return out

    def put(self, recs: Sequence[SlotRecord]) -> None:
        with self._lock:
            room = self._max - len(self._free)
            if room > 0:
                self._free.extend(recs[:room])

    def size(self) -> int:
        with self._lock:
            return len(self._free)

    def clear(self) -> None:
        with self._lock:
            self._free.clear()


_GLOBAL_POOL: Optional[SlotRecordPool] = None


def global_record_pool() -> SlotRecordPool:
    global _GLOBAL_POOL
    if _GLOBAL_POOL is None:
        _GLOBAL_POOL = SlotRecordPool()
    return _GLOBAL_POOL
