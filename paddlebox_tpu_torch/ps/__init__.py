from paddlebox_tpu_torch.ps.sgd import SparseAdamConfig, SparseSGDConfig
from paddlebox_tpu_torch.ps.table import EmbeddingTable, TableState

__all__ = ["EmbeddingTable", "SparseAdamConfig", "SparseSGDConfig",
           "TableState"]
