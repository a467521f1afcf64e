"""Slot schema — the ``DataFeedDesc`` analogue (copy of
``paddlebox_tpu/data/schema.py``, which is numpy-free host code).

The schema fixes the padded key capacity per batch from a geometric bucket
ladder, so the device sees a bounded set of shapes.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional


@dataclasses.dataclass(frozen=True)
class SlotDef:
    """One input slot. ``uint64`` slots carry sparse feature ids (feasigns);
    ``float`` slots carry fixed-dim dense values."""

    name: str
    type: str = "uint64"  # "uint64" | "float"
    dim: int = 1          # float slots: values per record; uint64: unused
    is_used: bool = True

    def __post_init__(self) -> None:
        if self.type not in ("uint64", "float"):
            raise ValueError(f"slot {self.name}: bad type {self.type}")


@dataclasses.dataclass
class DataFeedDesc:
    slots: List[SlotDef] = dataclasses.field(default_factory=list)
    batch_size: int = 512
    parser: str = "slot_text"        # registered parser name
    pipe_command: Optional[str] = None
    label_slot: Optional[str] = None  # which slot is the click label
    show_slot: Optional[str] = None
    clk_slot: Optional[str] = None
    pv_batch_size: int = 0
    rank_offset: Optional[str] = None
    # static padding ladder for flattened sparse keys per batch
    key_bucket_min: int = 1024
    key_bucket_growth: float = 2.0

    @property
    def sparse_slots(self) -> List[SlotDef]:
        return [s for s in self.slots if s.type == "uint64" and s.is_used]

    @property
    def dense_slots(self) -> List[SlotDef]:
        """Float feature slots — excludes the label/show/clk channels."""
        special = {self.label_slot, self.show_slot, self.clk_slot}
        return [s for s in self.slots
                if s.type == "float" and s.is_used and s.name not in special]

    @property
    def dense_dim(self) -> int:
        return sum(s.dim for s in self.dense_slots)

    def sparse_slot_index(self, name: str) -> int:
        for i, s in enumerate(self.sparse_slots):
            if s.name == name:
                return i
        raise KeyError(name)

    def key_capacity(self, num_keys: int) -> int:
        """Padded key capacity bucket for a batch with num_keys keys."""
        cap = self.key_bucket_min
        while cap < num_keys:
            cap = int(cap * self.key_bucket_growth)
        return cap

    @classmethod
    def criteo(cls, batch_size: int = 512) -> "DataFeedDesc":
        """Criteo display-ads schema: 13 dense ints (one float slot of
        dim 13) + 26 categorical sparse slots + click label."""
        slots: List[SlotDef] = [SlotDef("label", "float", 1)]
        slots.append(SlotDef("dense", "float", 13))
        slots += [SlotDef(f"C{i}", "uint64") for i in range(1, 27)]
        return cls(slots=slots, batch_size=batch_size, parser="criteo",
                   label_slot="label")
