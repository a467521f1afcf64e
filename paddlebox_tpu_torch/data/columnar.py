"""Columnar in-memory record store — copy of
``paddlebox_tpu/data/columnar.py``: a pass's records as flat arrays, so a
batch is two numpy slices and one ``np.repeat`` instead of a walk over
record objects, and the resident pass's columnar front
(``train/device_pass._front_columnar``) slices the whole pass at once.

Layout: all records' keys concatenated (record-major), with per-key slot
ids; record boundaries via offsets; dense/label/show/clk as [R, …] arrays.
The port's ``SlotBatch`` carries no timestamp, so ``batch`` drops that
column.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional, Sequence

import numpy as np

from paddlebox_tpu_torch.data.batch import SlotBatch
from paddlebox_tpu_torch.data.record import SlotRecord
from paddlebox_tpu_torch.data.schema import DataFeedDesc


@dataclasses.dataclass
class ColumnarRecords:
    keys: np.ndarray         # uint64 [total_keys] record-major
    key_slot: np.ndarray     # int32  [total_keys] slot id per key
    offsets: np.ndarray      # int64  [R+1] record key spans
    dense: np.ndarray        # f32 [R, Dd]
    label: np.ndarray        # f32 [R]
    show: np.ndarray         # f32 [R]
    clk: np.ndarray          # f32 [R]
    uid: Optional[np.ndarray] = None     # int64 [R]
    rank: Optional[np.ndarray] = None    # int32 [R]
    cmatch: Optional[np.ndarray] = None  # int32 [R]
    timestamp: Optional[np.ndarray] = None  # int64 [R] (need_time_info)

    @property
    def num_records(self) -> int:
        return int(self.label.shape[0])

    @classmethod
    def from_records(cls, records: Sequence[SlotRecord],
                     dense_dim: int) -> "ColumnarRecords":
        r = len(records)
        counts = np.fromiter((rec.num_keys for rec in records),
                             dtype=np.int64, count=r)
        offsets = np.zeros(r + 1, dtype=np.int64)
        np.cumsum(counts, out=offsets[1:])
        keys = (np.concatenate([rec.keys for rec in records])
                if r else np.empty(0, np.uint64))
        key_slot = np.empty(len(keys), dtype=np.int32)
        pos = 0
        for rec in records:
            sc = np.diff(rec.slot_offsets)
            n = rec.num_keys
            key_slot[pos:pos + n] = np.repeat(
                np.arange(len(sc), dtype=np.int32), sc)
            pos += n
        dense = np.zeros((r, dense_dim), np.float32)
        label = np.empty(r, np.float32)
        show = np.empty(r, np.float32)
        clk = np.empty(r, np.float32)
        uid = np.empty(r, np.int64)
        rank = np.empty(r, np.int32)
        cmatch = np.empty(r, np.int32)
        ts = np.empty(r, np.int64)
        for i, rec in enumerate(records):
            if rec.dense.size:
                dense[i, :rec.dense.size] = rec.dense
            label[i] = rec.label
            show[i] = rec.show
            clk[i] = rec.clk
            uid[i] = rec.uid
            rank[i] = rec.rank
            cmatch[i] = rec.cmatch
            ts[i] = rec.timestamp
        return cls(keys=keys, key_slot=key_slot, offsets=offsets,
                   dense=dense, label=label, show=show, clk=clk, uid=uid,
                   rank=rank, cmatch=cmatch, timestamp=ts)

    def shuffle(self, seed: int = 0) -> "ColumnarRecords":
        """Record-order permutation (one gather per pass, amortized)."""
        perm = np.random.default_rng(seed).permutation(self.num_records)
        counts = np.diff(self.offsets)[perm]
        new_off = np.zeros(self.num_records + 1, dtype=np.int64)
        np.cumsum(counts, out=new_off[1:])
        # gather each permuted record's key span
        src_idx = np.concatenate([
            np.arange(self.offsets[p], self.offsets[p + 1])
            for p in perm]) if len(self.keys) else np.empty(0, np.int64)
        opt = lambda a: None if a is None else a[perm]
        return ColumnarRecords(
            keys=self.keys[src_idx], key_slot=self.key_slot[src_idx],
            offsets=new_off, dense=self.dense[perm], label=self.label[perm],
            show=self.show[perm], clk=self.clk[perm],
            uid=opt(self.uid), rank=opt(self.rank), cmatch=opt(self.cmatch),
            timestamp=opt(self.timestamp))

    def batch(self, start: int, end: int, desc: DataFeedDesc,
              num_slots: int) -> SlotBatch:
        """Records [start, end) → SlotBatch (vectorized)."""
        bs = desc.batch_size
        n = end - start
        ks, ke = self.offsets[start], self.offsets[end]
        nk = int(ke - ks)
        keys = self.keys[ks:ke]
        counts = np.diff(self.offsets[start:end + 1])
        ins = np.repeat(np.arange(n, dtype=np.int64), counts)
        segs = (ins * num_slots + self.key_slot[ks:ke]).astype(np.int32)

        cap = desc.key_capacity(nk)
        pad_seg = bs * num_slots
        keys_p = np.zeros(cap, dtype=np.uint64)
        segs_p = np.full(cap, pad_seg, dtype=np.int32)
        keys_p[:nk] = keys
        segs_p[:nk] = segs

        def padrow(a: np.ndarray, fill: float = 0.0) -> np.ndarray:
            if n == bs:
                return np.ascontiguousarray(a[start:end])
            shape = (bs,) + a.shape[1:]
            out = np.full(shape, fill, a.dtype)
            out[:n] = a[start:end]
            return out

        trivial = (nk == n * num_slots
                   and bool(np.array_equal(segs,
                                           np.arange(nk, dtype=np.int32))))
        opt = lambda a: None if a is None else padrow(a)
        return SlotBatch(
            keys=keys_p, segments=segs_p, num_keys=nk,
            dense=padrow(self.dense), label=padrow(self.label),
            show=padrow(self.show), clk=padrow(self.clk),
            batch_size=bs, num_slots=num_slots, segments_trivial=trivial,
            uid=opt(self.uid), rank=opt(self.rank), cmatch=opt(self.cmatch),
        )

    def batches(self, desc: DataFeedDesc, num_slots: int,
                drop_last: bool = False,
                start_batch: int = 0) -> Iterator[SlotBatch]:
        bs = desc.batch_size
        r = self.num_records
        for i in range(start_batch * bs, r, bs):
            j = min(i + bs, r)
            if j - i < bs and drop_last:
                return
            yield self.batch(i, j, desc, num_slots)
