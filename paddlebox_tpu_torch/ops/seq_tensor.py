"""fused_seq_tensor — DIN-style ad / user-sequence feature interaction;
counterpart of ``paddlebox_tpu/ops/seq_tensor.py``.

Reference: paddle/fluid/operators/fused/fused_seq_tensor_op.{cc,cu}:
``Input`` (behaviour sequence embeddings, [ins, batch_count·slot_num·
max_length·dim]) and ``ADInput`` ([ins, batch_count·ad_slot_num·dim]) →
DINOut (per sequence position [in, ad, in−ad, in·ad] over the ad slots),
MaskOut (a position is non-empty when its sum over slots and dims is not
0), SideInfoOut (the side-info slots) and ADSlotSessionOut (the ad slots
of the sequence). Reshapes, slices and broadcasts; no kernel.
"""

from __future__ import annotations

from typing import Tuple

import torch


def fused_seq_tensor(inputs: torch.Tensor, ad_input: torch.Tensor,
                     batch_count: int, max_length: int, slot_num: int,
                     fea_emb_dim: int, ad_slot_num: int, ad_slot_offset: int,
                     sideinfo_slot_num: int, sideinfo_slot_offset: int
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                torch.Tensor]:
    """Returns (din_out [bc, ins, L, 4·adS·dim], mask [bc, ins, L],
    side_info [bc, ins, L, sideS·dim], ad_session [bc, ins, L, adS·dim])."""
    ins = inputs.shape[0]
    bc, L, d = batch_count, max_length, fea_emb_dim
    x = inputs.reshape(ins, bc, slot_num, L, d)
    ad = ad_input.reshape(ins, bc, ad_slot_num, d)
    seq = x[:, :, ad_slot_offset:ad_slot_offset + ad_slot_num]
    seq = seq.permute(1, 0, 3, 2, 4)                  # [bc, ins, L, adS, d]
    adb = ad.permute(1, 0, 2, 3)[:, :, None].expand_as(seq)
    din = torch.stack([seq, adb, seq - adb, seq * adb], dim=3)
    din_out = din.reshape(bc, ins, L, 4 * ad_slot_num * d)
    pos_sum = x.sum(dim=(2, 4))                       # [ins, bc, L]
    mask_out = (pos_sum.abs() > 1e-8).to(inputs.dtype).permute(1, 0, 2)
    side = x[:, :, sideinfo_slot_offset:
             sideinfo_slot_offset + sideinfo_slot_num]
    side_out = side.permute(1, 0, 3, 2, 4).reshape(
        bc, ins, L, sideinfo_slot_num * d)
    ad_session_out = seq.reshape(bc, ins, L, ad_slot_num * d)
    return din_out, mask_out, side_out, ad_session_out
