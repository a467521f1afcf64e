from paddlebox_tpu_torch.ps.box_helper import BoxPSHelper
from paddlebox_tpu_torch.ps.host_store import HostStore
from paddlebox_tpu_torch.ps.pass_table import PassScopedTable
from paddlebox_tpu_torch.ps.sgd import SparseAdamConfig, SparseSGDConfig
from paddlebox_tpu_torch.ps.table import EmbeddingTable, TableState
from paddlebox_tpu_torch.ps.tiered import TieredShardedEmbeddingTable

__all__ = ["BoxPSHelper", "EmbeddingTable", "HostStore", "PassScopedTable",
           "SparseAdamConfig", "SparseSGDConfig", "TableState",
           "TieredShardedEmbeddingTable"]
