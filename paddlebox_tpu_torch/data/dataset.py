"""In-memory dataset (the batching half of ``InMemoryDataset`` in
``paddlebox_tpu/data/dataset.py``): a list of ``SlotRecord`` cut into
batches by the feed description, ``columnarize`` into the columnar
store (``data/columnar.py``) that the resident pass's columnar front
slices, and the surface a resume cursor checks
(``filelist_fingerprint``, ``quarantined_files``,
``supports_cursor_resume``). File loading and the shuffles are not
ported yet; callers fill ``records`` themselves, so ``filelist`` stays
empty and nothing is quarantined, as for a records-only reference
dataset.
"""

from __future__ import annotations

import hashlib
from typing import Iterator, List, Optional, Tuple

from paddlebox_tpu_torch.data.batch import BatchBuilder, SlotBatch
from paddlebox_tpu_torch.data.columnar import ColumnarRecords
from paddlebox_tpu_torch.data.record import SlotRecord
from paddlebox_tpu_torch.data.schema import DataFeedDesc


class InMemoryDataset:
    #: the records' order is fixed once set, so a pass can resume from a
    #: batch index
    supports_cursor_resume = True
    #: the loaded order is frozen in memory, so ``batches()`` replays the
    #: same stream (the q8 streaming front walks a pass twice)
    supports_reiteration = True

    def __init__(self, desc: Optional[DataFeedDesc] = None) -> None:
        self.desc = desc or DataFeedDesc()
        self.records: List[SlotRecord] = []
        self.filelist: List[str] = []
        self.quarantined_files: List[Tuple[str, str]] = []
        self.columnar: Optional[ColumnarRecords] = None  # columnarize()

    def filelist_fingerprint(self) -> str:
        """Order-sensitive digest of the file list, the resume cursor's
        identity check (the reference's digest, byte for byte)."""
        h = hashlib.sha256()
        for p in self.filelist:
            h.update(p.encode())
            h.update(b"\0")
        return h.hexdigest()[:16]

    def __len__(self) -> int:
        if self.columnar is not None and not self.records:
            return self.columnar.num_records
        return len(self.records)

    def columnarize(self) -> None:
        """Convert the records to the columnar store, once per pass, and
        release them; the batches and the resident pass's front read the
        store from then on."""
        if self.columnar is not None and not self.records:
            return  # already columnar
        self.columnar = ColumnarRecords.from_records(self.records,
                                                     self.desc.dense_dim)
        self.records = []

    def batches(self, drop_last: bool = False,
                start_batch: int = 0) -> Iterator[SlotBatch]:
        """Batches of ``desc.batch_size`` records in order; the last one
        may be short unless ``drop_last``. ``start_batch=k`` skips the
        first k batches without building them."""
        if self.columnar is not None:
            yield from self.columnar.batches(
                self.desc, len(self.desc.sparse_slots), drop_last,
                start_batch=start_batch)
            return
        builder = BatchBuilder(self.desc)
        bs = self.desc.batch_size
        n = len(self.records)
        for i in range(start_batch * bs, n, bs):
            chunk = self.records[i:i + bs]
            if len(chunk) < bs and drop_last:
                return
            yield builder.build(chunk)
