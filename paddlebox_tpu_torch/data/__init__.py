from paddlebox_tpu_torch.data.batch import BatchBuilder, SlotBatch
from paddlebox_tpu_torch.data.dataset import (DatasetFactory,
                                              InMemoryDataset,
                                              PaddleBoxDataset, QueueDataset)
from paddlebox_tpu_torch.data.parser import (CriteoParser, SlotTextParser,
                                             get_parser, register_parser)
from paddlebox_tpu_torch.data.pv import (PvBatchBuilder, build_rank_offset,
                                         group_by_search_id, group_by_uid)
from paddlebox_tpu_torch.data.record import SlotRecord, SlotRecordPool
from paddlebox_tpu_torch.data.schema import DataFeedDesc, SlotDef

__all__ = ["BatchBuilder", "CriteoParser", "DataFeedDesc", "DatasetFactory",
           "InMemoryDataset", "PaddleBoxDataset", "PvBatchBuilder",
           "QueueDataset", "SlotBatch", "SlotDef", "SlotRecord",
           "SlotRecordPool", "SlotTextParser", "build_rank_offset",
           "get_parser", "group_by_search_id", "group_by_uid",
           "register_parser"]
