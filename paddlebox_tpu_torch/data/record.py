"""One training or serving instance (copy of ``SlotRecord`` from
``paddlebox_tpu/data/record.py``): numpy-columnar, so batch building is
array concatenation."""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class SlotRecord:
    """``keys`` holds all sparse feasigns for all S sparse slots
    concatenated; ``slot_offsets`` (len S+1) delimits each slot's span."""

    keys: np.ndarray                 # uint64 [total_keys]
    slot_offsets: np.ndarray         # int32  [S+1]
    dense: np.ndarray                # float32 [dense_dim]
    label: float = 0.0
    show: float = 1.0
    clk: float = 0.0
