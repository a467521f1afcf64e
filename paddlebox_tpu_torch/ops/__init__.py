from paddlebox_tpu_torch.ops.kernels import (CVM_CONV, CVM_FULL, CVM_NONE,
                                             CVM_SHOW, gather_rows,
                                             gather_rows_plain, pool_cvm,
                                             pool_cvm_plain)
from paddlebox_tpu_torch.ops.seqpool_cvm import fused_seqpool_cvm

__all__ = ["CVM_CONV", "CVM_FULL", "CVM_NONE", "CVM_SHOW",
           "fused_seqpool_cvm", "gather_rows", "gather_rows_plain",
           "pool_cvm", "pool_cvm_plain"]
