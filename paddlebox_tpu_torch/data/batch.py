"""Host batch layout + builder (copy of ``paddlebox_tpu/data/batch.py``
without the ads timestamp).

One flattened key tensor for ALL slots with segment ids ``ins*S + slot``,
padded to a static bucket capacity; padding keys carry segment ``B*S``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from paddlebox_tpu_torch.data.record import SlotRecord
from paddlebox_tpu_torch.data.schema import DataFeedDesc


@dataclasses.dataclass
class SlotBatch:
    """``segments[k] == ins*S + slot`` for valid keys, ``B*S`` for
    padding."""

    keys: np.ndarray        # uint64 [K_pad]
    segments: np.ndarray    # int32  [K_pad]
    num_keys: int           # valid prefix length
    dense: np.ndarray       # float32 [B, dense_dim]
    label: np.ndarray       # float32 [B]
    show: np.ndarray        # float32 [B]
    clk: np.ndarray         # float32 [B]
    batch_size: int
    num_slots: int          # S (sparse slots)
    # True when segments[i] == i for every valid key (one key per slot per
    # record): the device side derives segments from the key position
    segments_trivial: bool = False
    # metric side channels (WuAUC / cmatch_rank variants)
    uid: Optional[np.ndarray] = None     # int64 [B]
    rank: Optional[np.ndarray] = None    # int32 [B]
    cmatch: Optional[np.ndarray] = None  # int32 [B]
    # sample ids for the dump (None when no record carries one)
    ins_ids: Optional[list] = None       # list[str], len == #real records

    @property
    def key_capacity(self) -> int:
        return int(self.keys.shape[0])

    @property
    def pad_segment(self) -> int:
        return self.batch_size * self.num_slots


class BatchBuilder:
    """records → SlotBatch with static-bucket key padding."""

    def __init__(self, desc: DataFeedDesc) -> None:
        self.desc = desc
        self.num_slots = len(desc.sparse_slots)
        self.dense_dim = desc.dense_dim

    def build(self, records: Sequence[SlotRecord]) -> SlotBatch:
        desc = self.desc
        bs = desc.batch_size
        n = len(records)
        if n == 0:
            raise ValueError("empty batch")
        if n > bs:
            raise ValueError(f"{n} records > batch_size {bs}")
        S = self.num_slots

        key_arrays: List[np.ndarray] = []
        seg_arrays: List[np.ndarray] = []
        slot_base = np.arange(S, dtype=np.int64)
        for i, r in enumerate(records):
            key_arrays.append(r.keys)
            counts = np.diff(r.slot_offsets)
            seg_arrays.append(
                np.repeat(i * S + slot_base, counts).astype(np.int32))
        keys = np.concatenate(key_arrays)
        segs = np.concatenate(seg_arrays)
        nk = int(keys.shape[0])

        cap = desc.key_capacity(nk)
        keys_p = np.zeros(cap, dtype=np.uint64)
        segs_p = np.full(cap, bs * S, dtype=np.int32)
        keys_p[:nk] = keys
        segs_p[:nk] = segs

        dense = np.zeros((bs, self.dense_dim), dtype=np.float32)
        dense_rows = [r.dense for r in records]
        if all(d.shape == (self.dense_dim,) for d in dense_rows):
            dense[:n] = dense_rows
        else:           # short or missing dense blocks: pad row by row
            for i, d in enumerate(dense_rows):
                if d.size:
                    dense[i, :d.size] = d

        def column(field: str, dtype) -> np.ndarray:
            out = np.zeros(bs, dtype=dtype)
            out[:n] = np.fromiter((getattr(r, field) for r in records),
                                  dtype=dtype, count=n)
            return out

        label = column("label", np.float32)
        show = column("show", np.float32)
        clk = column("clk", np.float32)
        uid = column("uid", np.int64)
        rank = column("rank", np.int32)
        cmatch = column("cmatch", np.int32)
        ins_ids = ([r.ins_id for r in records]
                   if any(r.ins_id for r in records) else None)
        # short batches: instances [n, bs) have show=0, so they contribute
        # nothing to pooled sums and are masked out of the predictions
        trivial = (nk == n * S
                   and bool(np.array_equal(segs,
                                           np.arange(nk, dtype=np.int32))))
        return SlotBatch(
            keys=keys_p, segments=segs_p, num_keys=nk, dense=dense,
            label=label, show=show, clk=clk, batch_size=bs, num_slots=S,
            segments_trivial=trivial, uid=uid, rank=rank, cmatch=cmatch,
            ins_ids=ins_ids)
