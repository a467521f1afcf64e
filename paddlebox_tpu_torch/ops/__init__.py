from paddlebox_tpu_torch.ops.batch_fc import batch_fc
from paddlebox_tpu_torch.ops.cross_norm import (cross_norm_hadamard,
                                                cross_norm_update,
                                                init_cross_norm_summary)
from paddlebox_tpu_torch.ops.cvm import cvm, cvm_grad_passthrough
from paddlebox_tpu_torch.ops.data_norm import (DataNormSummary, data_norm,
                                               data_norm_update,
                                               init_data_norm_summary)
from paddlebox_tpu_torch.ops.kernels import (CVM_CONV, CVM_FULL, CVM_NONE,
                                             CVM_SHOW, KERNELS, PLAIN,
                                             KernelSet, fused_embed_pool_cvm,
                                             gather_rows, gather_rows_dma,
                                             gather_rows_dma_plain,
                                             gather_rows_plain, pool_cvm,
                                             pool_cvm_plain,
                                             scatter_add_update,
                                             scatter_add_update_plain,
                                             scatter_rows, scatter_rows_dma,
                                             scatter_rows_dma_plain,
                                             scatter_rows_plain,
                                             segment_gather,
                                             segment_gather_plain,
                                             segment_sum, segment_sum_plain)
from paddlebox_tpu_torch.ops.partial_ops import partial_concat, partial_sum
from paddlebox_tpu_torch.ops.rank_attention import (rank_attention,
                                                    rank_attention2)
from paddlebox_tpu_torch.ops.scaled_fc import scaled_fc, scaled_int8fc
from paddlebox_tpu_torch.ops.seq_tensor import fused_seq_tensor
from paddlebox_tpu_torch.ops.seqpool_cvm import (
    fused_seqpool_concat, fused_seqpool_cvm, fused_seqpool_cvm_slot_group,
    fused_seqpool_cvm_with_conv, slot_group_bounds)
from paddlebox_tpu_torch.ops.seqpool_variants import (
    fused_seqpool_cvm_tradew, fused_seqpool_cvm_with_credit,
    fused_seqpool_cvm_with_diff_thres, fused_seqpool_cvm_with_pcoc)
from paddlebox_tpu_torch.ops.shuffle_batch import (shuffle_batch,
                                                   unshuffle_batch)

__all__ = ["CVM_CONV", "CVM_FULL", "CVM_NONE", "CVM_SHOW", "DataNormSummary",
           "KERNELS", "KernelSet", "PLAIN", "batch_fc", "cross_norm_hadamard",
           "cross_norm_update", "cvm", "cvm_grad_passthrough", "data_norm",
           "data_norm_update", "fused_embed_pool_cvm", "fused_seq_tensor",
           "fused_seqpool_concat",
           "fused_seqpool_cvm", "fused_seqpool_cvm_slot_group",
           "fused_seqpool_cvm_tradew", "fused_seqpool_cvm_with_conv",
           "fused_seqpool_cvm_with_credit",
           "fused_seqpool_cvm_with_diff_thres",
           "fused_seqpool_cvm_with_pcoc", "gather_rows", "gather_rows_dma",
           "gather_rows_dma_plain", "gather_rows_plain",
           "init_cross_norm_summary", "init_data_norm_summary",
           "partial_concat", "partial_sum", "pool_cvm", "pool_cvm_plain",
           "rank_attention", "rank_attention2", "scaled_fc", "scaled_int8fc",
           "scatter_add_update", "scatter_add_update_plain", "scatter_rows",
           "scatter_rows_dma", "scatter_rows_dma_plain",
           "scatter_rows_plain", "segment_gather", "segment_gather_plain",
           "segment_sum", "segment_sum_plain", "shuffle_batch",
           "slot_group_bounds", "unshuffle_batch"]
