"""In-memory dataset (the batching half of ``InMemoryDataset`` in
``paddlebox_tpu/data/dataset.py``): a list of ``SlotRecord`` cut into
batches by the feed description. File loading and the shuffles are not
ported yet; callers fill ``records`` themselves.
"""

from __future__ import annotations

from typing import Iterator, List, Optional

from paddlebox_tpu_torch.data.batch import BatchBuilder, SlotBatch
from paddlebox_tpu_torch.data.record import SlotRecord
from paddlebox_tpu_torch.data.schema import DataFeedDesc


class InMemoryDataset:
    def __init__(self, desc: Optional[DataFeedDesc] = None) -> None:
        self.desc = desc or DataFeedDesc()
        self.records: List[SlotRecord] = []

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
