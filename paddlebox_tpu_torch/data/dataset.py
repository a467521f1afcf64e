"""In-memory dataset (the batching half of ``InMemoryDataset`` in
``paddlebox_tpu/data/dataset.py``): a list of ``SlotRecord`` cut into
batches by the feed description, and the surface a resume cursor checks
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
from paddlebox_tpu_torch.data.record import SlotRecord
from paddlebox_tpu_torch.data.schema import DataFeedDesc


class InMemoryDataset:
    #: the records' order is fixed once set, so a pass can resume from a
    #: batch index
    supports_cursor_resume = True

    def __init__(self, desc: Optional[DataFeedDesc] = None) -> None:
        self.desc = desc or DataFeedDesc()
        self.records: List[SlotRecord] = []
        self.filelist: List[str] = []
        self.quarantined_files: List[Tuple[str, str]] = []

    def filelist_fingerprint(self) -> str:
        """Order-sensitive digest of the file list, the resume cursor's
        identity check (the reference's digest, byte for byte)."""
        h = hashlib.sha256()
        for p in self.filelist:
            h.update(p.encode())
            h.update(b"\0")
        return h.hexdigest()[:16]

    def __len__(self) -> int:
        return len(self.records)

    def batches(self, drop_last: bool = False,
                start_batch: int = 0) -> Iterator[SlotBatch]:
        """Batches of ``desc.batch_size`` records in order; the last one
        may be short unless ``drop_last``. ``start_batch=k`` skips the
        first k batches without building them."""
        builder = BatchBuilder(self.desc)
        bs = self.desc.batch_size
        n = len(self.records)
        for i in range(start_batch * bs, n, bs):
            chunk = self.records[i:i + bs]
            if len(chunk) < bs and drop_last:
                return
            yield builder.build(chunk)
