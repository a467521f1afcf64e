from paddlebox_tpu_torch.data.batch import BatchBuilder, SlotBatch
from paddlebox_tpu_torch.data.dataset import InMemoryDataset
from paddlebox_tpu_torch.data.pv import PvBatchBuilder, build_rank_offset
from paddlebox_tpu_torch.data.record import SlotRecord
from paddlebox_tpu_torch.data.schema import DataFeedDesc, SlotDef

__all__ = ["BatchBuilder", "DataFeedDesc", "InMemoryDataset",
           "PvBatchBuilder", "SlotBatch", "SlotDef", "SlotRecord",
           "build_rank_offset"]
