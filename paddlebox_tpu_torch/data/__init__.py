from paddlebox_tpu_torch.data.batch import BatchBuilder, SlotBatch
from paddlebox_tpu_torch.data.record import SlotRecord
from paddlebox_tpu_torch.data.schema import DataFeedDesc, SlotDef

__all__ = ["BatchBuilder", "DataFeedDesc", "SlotBatch", "SlotDef",
           "SlotRecord"]
