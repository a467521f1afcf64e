from paddlebox_tpu_torch.ops.kernels import (CVM_CONV, CVM_FULL, CVM_NONE,
                                             CVM_SHOW, KERNELS, PLAIN,
                                             KernelSet, gather_rows,
                                             gather_rows_plain, pool_cvm,
                                             pool_cvm_plain,
                                             scatter_add_update,
                                             scatter_add_update_plain,
                                             segment_gather,
                                             segment_gather_plain)
from paddlebox_tpu_torch.ops.seqpool_cvm import fused_seqpool_cvm

__all__ = ["CVM_CONV", "CVM_FULL", "CVM_NONE", "CVM_SHOW", "KERNELS",
           "KernelSet", "PLAIN", "fused_seqpool_cvm", "gather_rows",
           "gather_rows_plain", "pool_cvm", "pool_cvm_plain",
           "scatter_add_update", "scatter_add_update_plain",
           "segment_gather", "segment_gather_plain"]
