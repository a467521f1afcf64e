from paddlebox_tpu_torch.ps.box_helper import BoxPSHelper
from paddlebox_tpu_torch.ps.extended import ExtendedEmbeddingTable
from paddlebox_tpu_torch.ps.host_store import HostStore
from paddlebox_tpu_torch.ps.multi_mf import MultiMfEmbeddingTable
from paddlebox_tpu_torch.ps.multi_mf_sharded import (
    MultiMfShardedTable, MultiMfTieredShardedTable)
from paddlebox_tpu_torch.ps.pass_table import PassScopedTable
from paddlebox_tpu_torch.ps.replica_cache import InputTable, ReplicaCache
from paddlebox_tpu_torch.ps.sgd import SparseAdamConfig, SparseSGDConfig
from paddlebox_tpu_torch.ps.sharded import ShardedEmbeddingTable
from paddlebox_tpu_torch.ps.table import EmbeddingTable, TableState
from paddlebox_tpu_torch.ps.tiered import TieredShardedEmbeddingTable

__all__ = ["BoxPSHelper", "EmbeddingTable", "ExtendedEmbeddingTable",
           "HostStore", "InputTable", "MultiMfEmbeddingTable",
           "MultiMfShardedTable", "MultiMfTieredShardedTable",
           "PassScopedTable", "ReplicaCache", "ShardedEmbeddingTable",
           "SparseAdamConfig", "SparseSGDConfig", "TableState",
           "TieredShardedEmbeddingTable"]
