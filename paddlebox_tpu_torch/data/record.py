"""One training or serving instance (copy of ``SlotRecord`` from
``paddlebox_tpu/data/record.py``): numpy-columnar, so batch building is
array concatenation."""

from __future__ import annotations

import dataclasses

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
