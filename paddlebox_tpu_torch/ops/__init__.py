from paddlebox_tpu_torch.ops.batch_fc import batch_fc
from paddlebox_tpu_torch.ops.cross_norm import (cross_norm_hadamard,
                                                cross_norm_update,
                                                init_cross_norm_summary)
from paddlebox_tpu_torch.ops.data_norm import (DataNormSummary, data_norm,
                                               data_norm_update,
                                               init_data_norm_summary)
from paddlebox_tpu_torch.ops.kernels import (CVM_CONV, CVM_FULL, CVM_NONE,
                                             CVM_SHOW, KERNELS, PLAIN,
                                             KernelSet, gather_rows,
                                             gather_rows_plain, pool_cvm,
                                             pool_cvm_plain,
                                             scatter_add_update,
                                             scatter_add_update_plain,
                                             segment_gather,
                                             segment_gather_plain)
from paddlebox_tpu_torch.ops.rank_attention import (rank_attention,
                                                    rank_attention2)
from paddlebox_tpu_torch.ops.seqpool_cvm import fused_seqpool_cvm

__all__ = ["CVM_CONV", "CVM_FULL", "CVM_NONE", "CVM_SHOW", "DataNormSummary",
           "KERNELS", "KernelSet", "PLAIN", "batch_fc", "cross_norm_hadamard",
           "cross_norm_update", "data_norm", "data_norm_update",
           "fused_seqpool_cvm", "gather_rows", "gather_rows_plain",
           "init_cross_norm_summary", "init_data_norm_summary", "pool_cvm",
           "pool_cvm_plain", "rank_attention", "rank_attention2",
           "scatter_add_update", "scatter_add_update_plain",
           "segment_gather", "segment_gather_plain"]
