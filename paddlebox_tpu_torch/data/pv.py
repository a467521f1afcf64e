"""Page-view (PV) merge batching and the ``rank_offset`` matrix (copy of
``paddlebox_tpu/data/pv.py``, host numpy over the port's
``BatchBuilder``).

PreprocessInstance (data_set.cc:2825) sorts records by search_id and
merges consecutive equal-sid records into one PV; GetRankOffset
(data_feed.cc:1855) then builds the int matrix [ins_num, 2*max_rank+1]
that rank_attention consumes:

- col 0: the ad's own 1-based rank, valid only when cmatch ∈ {222, 223}
  and 0 < rank <= max_rank; else -1.
- for every co-shown ad k in the same PV with valid rank r, cols
  (2*(r-1)+1, 2*(r-1)+2) hold (r, global-row-index-of-k). Rows whose own
  rank is invalid keep -1 everywhere past col 0.

The matrix is padded to the static batch size; padding rows are all -1,
which rank_attention treats as "contribute nothing".
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from paddlebox_tpu_torch.data.batch import BatchBuilder, SlotBatch
from paddlebox_tpu_torch.data.record import SlotRecord
from paddlebox_tpu_torch.data.schema import DataFeedDesc

VALID_CMATCH = (222, 223)


def group_by_search_id(records: Sequence[SlotRecord]) -> List[List[SlotRecord]]:
    """Stable sort by search_id, then merge consecutive equal sids into one
    PV (the merge_by_sid path of PreprocessInstance)."""
    order = sorted(range(len(records)), key=lambda i: records[i].search_id)
    pvs: List[List[SlotRecord]] = []
    last_sid = None
    for i in order:
        r = records[i]
        if last_sid is None or r.search_id != last_sid:
            pvs.append([r])
            last_sid = r.search_id
        else:
            pvs[-1].append(r)
    return pvs


def merge_by_insid(records: Sequence[SlotRecord], merge_size: int = 2,
                   num_slots: int = 0) -> Tuple[List[SlotRecord], int]:
    """Merge records sharing an ``ins_id`` into one record
    (MultiSlotDataset::MergeByInsId, data_set.cc:1517): sparse slots
    concatenate across the group's records (slot order preserved); dense/
    label/show/clk come from the first record. When ``merge_size`` > 0,
    groups whose size differs are DROPPED. Returns (merged_records,
    dropped_count)."""
    buckets: Dict[str, List[SlotRecord]] = {}
    for r in records:
        buckets.setdefault(r.ins_id, []).append(r)
    merged: List[SlotRecord] = []
    dropped = 0
    for ins_id in sorted(buckets):
        grp = buckets[ins_id]
        if merge_size > 0 and len(grp) != merge_size:
            dropped += len(grp)
            continue
        if len(grp) == 1:
            merged.append(grp[0])
            continue
        first = grp[0]
        s = (num_slots or len(first.slot_offsets) - 1)
        chunks: List[np.ndarray] = []
        offs = [0]
        for slot in range(s):
            for r in grp:
                chunks.append(r.slot_keys(slot))
            offs.append(offs[-1] + sum(
                len(r.slot_keys(slot)) for r in grp))
        merged.append(SlotRecord(
            keys=(np.concatenate(chunks) if offs[-1]
                  else np.empty(0, np.uint64)),
            slot_offsets=np.array(offs, dtype=np.int32),
            dense=first.dense, label=first.label, show=first.show,
            clk=first.clk, ins_id=ins_id, search_id=first.search_id,
            rank=first.rank, cmatch=first.cmatch, uid=first.uid,
            timestamp=first.timestamp))
    return merged, dropped


def group_by_uid(records: Sequence[SlotRecord],
                 sort_by_time: bool = True) -> List[List[SlotRecord]]:
    """Group records by uid (the merge_by_uid path), each timeline
    time-ordered so the window split sees a temporal sequence."""
    buckets: Dict[int, List[SlotRecord]] = {}
    for r in records:
        buckets.setdefault(r.uid, []).append(r)
    groups = list(buckets.values())
    if sort_by_time:
        for g in groups:
            g.sort(key=lambda r: r.timestamp)
    return groups


def compute_split_num_and_mask(ins_count: int, seq_length: int,
                               train_length: int
                               ) -> Tuple[List[Tuple[int, int]], List[int]]:
    """Sliding test-train windows over a user timeline
    (``compute_split_num_and_mask``, data_set.cc:2783). Returns per-window
    [start, end) offsets and the window's zero-mask prefix length (the
    leading ``seq_length - train_length`` context records that do NOT
    train). Every record trains in exactly one window (asserted)."""
    window_num = (ins_count - seq_length) // train_length + 1
    offsets: List[Tuple[int, int]] = [(0, ins_count - window_num * train_length)]
    zero_mask: List[int] = [0]
    s = offsets[0][1] - (seq_length - train_length)
    e = offsets[0][1] + train_length
    while e <= ins_count:
        offsets.append((s, e))
        zero_mask.append(seq_length - train_length)
        s += train_length
        e += train_length
    train_num = sum((b - a) - z for (a, b), z in zip(offsets, zero_mask))
    assert train_num == ins_count, "window split lost/duplicated train rows"
    return offsets, zero_mask


def split_uid_groups(groups: Sequence[Sequence[SlotRecord]], method: int,
                     split_size: int = 0, train_size: int = 0
                     ) -> List[Tuple[List[SlotRecord], int]]:
    """Split uid-merged timelines into PV chunks with a zero-mask count
    (``merge_by_uid_split_method``, data_feed.h:624):

    - 0: whole timeline as one chunk, mask 0.
    - 1: direct split into ``split_size`` chunks aligned to the END of the
      timeline (a new chunk opens when ``(count - j) % split_size == 0``),
      all records train.
    - 2: sliding test-train windows (``compute_split_num_and_mask``): each
      window's first ``split_size - train_size`` records are frozen
      context (zero mask), the rest train; a record trains exactly once.

    Returns [(records, zero_mask_num)] — feed to ``build_train_mask``.
    """
    if method == 2 and split_size > 0 and train_size > split_size:
        raise ValueError(
            f"train_size ({train_size}) must be <= split_size "
            f"({split_size}) — the window's context prefix would be "
            "negative")
    out: List[Tuple[List[SlotRecord], int]] = []
    for g in groups:
        n = len(g)
        if method == 1 and split_size > 0:
            chunk: List[SlotRecord] = []
            for j, r in enumerate(g):
                if j > 0 and (n - j) % split_size == 0:
                    out.append((chunk, 0))
                    chunk = []
                chunk.append(r)
            out.append((chunk, 0))
        elif method == 2 and 0 < split_size < n and train_size > 0:
            offsets, zmask = compute_split_num_and_mask(
                n, split_size, train_size)
            for (a, b), z in zip(offsets, zmask):
                if b > a:  # the first window can be empty when the
                    out.append((list(g[a:b]), z))  # timeline tiles exactly
        else:
            out.append((list(g), 0))
    return out


def build_train_mask(chunks: Sequence[Tuple[Sequence[SlotRecord], int]],
                     pad_to: int = 0) -> np.ndarray:
    """Flattened per-record ``ads_train_mask`` (data_feed.proto:57): per
    chunk, ``zero_mask_num`` zeros then ones; batch padding rows are 0."""
    ins = sum(len(c) for c, _ in chunks)
    mask = np.zeros(max(ins, pad_to), dtype=np.int64)
    pos = 0
    for recs, z in chunks:
        mask[pos + z:pos + len(recs)] = 1
        pos += len(recs)
    return mask


def timestamp_range_mask(timestamp: np.ndarray, lo: int,
                         hi: int) -> np.ndarray:
    """1.0 where timestamp ∈ [lo, hi) — the test-phase timestamp window
    (SetTestTimestampRange, data_feed.h:2038). Combine multiplicatively
    with ins_w / ads_train_mask."""
    ts = np.asarray(timestamp)
    return ((ts >= lo) & (ts < hi)).astype(np.float32)


def _valid_rank(rank: int, cmatch: int, max_rank: int) -> int:
    if cmatch in VALID_CMATCH and 0 < rank <= max_rank:
        return rank
    return -1


def build_rank_offset(pvs: Sequence[Sequence[SlotRecord]],
                      max_rank: int = 3,
                      pad_to: int = 0) -> np.ndarray:
    """int32 [max(ins_num, pad_to), 2*max_rank+1], padding rows all -1."""
    ins_num = sum(len(pv) for pv in pvs)
    rows = max(ins_num, pad_to)
    cols = 2 * max_rank + 1
    mat = np.full((rows, cols), -1, dtype=np.int32)

    base = 0
    for pv in pvs:
        vr = np.array([_valid_rank(r.rank, r.cmatch, max_rank) for r in pv],
                      dtype=np.int32)
        mat[base:base + len(pv), 0] = vr
        valid_k = np.nonzero(vr > 0)[0]
        for j in range(len(pv)):
            if vr[j] <= 0:
                continue
            for k in valid_k:
                m = vr[k] - 1
                mat[base + j, 2 * m + 1] = vr[k]
                mat[base + j, 2 * m + 2] = base + k
        base += len(pv)
    return mat


class PvBatchBuilder:
    """PV-merged minibatches: ``pv_batch_size`` PVs per batch, flattened ads
    padded to ``desc.batch_size`` rows, plus the rank_offset matrix
    (PaddleBoxDataFeed::PutToFeedVec(pv_vec), data_feed.cc:1915)."""

    def __init__(self, desc: DataFeedDesc, max_rank: int = 3) -> None:
        if desc.pv_batch_size <= 0:
            raise ValueError("desc.pv_batch_size must be > 0 for PV batching")
        self.desc = desc
        self.max_rank = max_rank
        self._builder = BatchBuilder(desc)

    def batches(self, records: Sequence[SlotRecord]
                ) -> List[Tuple[SlotBatch, np.ndarray]]:
        pvs = group_by_search_id(records)
        out: List[Tuple[SlotBatch, np.ndarray]] = []
        pvb = self.desc.pv_batch_size
        for i in range(0, len(pvs), pvb):
            chunk = pvs[i:i + pvb]
            flat = [r for pv in chunk for r in pv]
            if len(flat) > self.desc.batch_size:
                raise ValueError(
                    f"PV chunk flattens to {len(flat)} ads > batch_size "
                    f"{self.desc.batch_size}; lower pv_batch_size")
            batch = self._builder.build(flat)
            ro = build_rank_offset(chunk, self.max_rank,
                                   pad_to=self.desc.batch_size)
            out.append((batch, ro))
        return out
