"""fused_seqpool_cvm forward — the core CTR fusion (counterpart of
``paddlebox_tpu/ops/seqpool_cvm.py``).

Every slot of every instance is one segment (``ins*S + slot``) of a
single flattened ``[K, D]`` value tensor. The ragged layout pools and
applies the CVM head in one kernel (``ops.kernels.pool_cvm``); the
trivial layout (``segments is None``: exactly one key per (instance,
slot), slot-ordered) is a reshape.

This slice carries the forward for ``embedx_concate_size == 1``; the
backward and the concat/threshold-filter variants belong to the training
slice and raise ``NotImplementedError`` here.
"""

from __future__ import annotations

from typing import Optional

import torch

from paddlebox_tpu_torch.ops.kernels import (CVM_FULL, CVM_NONE, CVM_SHOW,
                                             _cvm_slice, _cvm_transform_wide,
                                             cvm_out_width, keep_or_ones,
                                             pool_cvm)


def fused_seqpool_cvm(
    values: torch.Tensor,             # [K, D] pulled embeddings (D incl. cvm)
    segments: Optional[torch.Tensor],  # [K] int32 ins*S + slot; pads → B*S
    batch_size: int,
    num_slots: int,
    use_cvm: bool = True,
    cvm_offset: int = 2,
    pad_value: float = 0.0,
    need_filter: bool = False,
    show_coeff: float = 0.2,
    clk_coeff: float = 1.0,
    threshold: float = 0.96,
    quant_ratio: int = 0,
    clk_filter: bool = False,
    embed_threshold_filter: bool = False,
    embed_thres_size: int = 0,
    embedx_concate_size: int = 1,
) -> torch.Tensor:
    """Pooled, CVM-transformed features [B, S, D_out].

    Output width per slot: ``D`` with use_cvm, ``D-1`` with use_cvm and
    clk_filter, ``D - cvm_offset - embed_thres_size`` without cvm. The
    same arguments as the reference forward, minus the batch show/clk
    and key_valid inputs, which only its backward reads."""
    if embed_threshold_filter:
        raise NotImplementedError(
            "embed_threshold_filter is not ported yet (training slice)")
    kk = 1 if (use_cvm and not clk_filter) else embedx_concate_size
    if kk != 1:
        raise NotImplementedError(
            "embedx_concate_size > 1 is not ported yet (training slice)")
    d = values.shape[1]
    v = values
    if quant_ratio > 0:
        # quantize embedx dims only; the cvm dims pass through, so the
        # filter below (which reads only them) is unaffected
        q = torch.floor(v * quant_ratio + 0.5) / quant_ratio
        col = torch.arange(d, device=v.device) >= cvm_offset
        v = torch.where(col[None, :], q, v)
    keep = keep_or_ones(v, need_filter, show_coeff, clk_coeff, threshold)
    mode = CVM_NONE if not use_cvm else (CVM_SHOW if clk_filter
                                         else CVM_FULL)
    ets = 0 if use_cvm else embed_thres_size
    if segments is not None:
        return pool_cvm(v, segments, keep.float(), batch_size, num_slots,
                        cvm_mode=mode, cvm_offset=cvm_offset, ets=ets,
                        pad_value=pad_value)
    # trivial layout: key j is segment j, so the pool is a reshape
    cvm_out_width(d, mode, cvm_offset, ets)
    k, n = v.shape[0], batch_size * num_slots
    v = torch.where(keep[:, None], v, 0.0)
    if k < n:  # key bucket smaller than B*S (partial batches)
        v = torch.cat([v, v.new_zeros((n - k, d))])
    pooled = v[:n].reshape(batch_size, num_slots, d) + pad_value
    return _cvm_slice(_cvm_transform_wide(pooled, mode), mode, cvm_offset,
                      ets)
