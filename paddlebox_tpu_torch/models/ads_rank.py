"""AdsRank — PV (page-view) ads ranking with rank attention; the same math
as ``paddlebox_tpu/models/ads_rank.py``.

PV-merged batches flatten each search result page's ads into instances
with a ``rank_offset`` matrix (``data/pv.py``); the net mixes per-ad
features with a per-(own-rank, co-rank) attention over co-shown ads
(``ops.rank_attention``). Optional towers:

- ``slot_fc``: a per-slot ``batch_fc`` projection over the pooled
  embeddings ([S, B, D] × [S, D, D] + [S, D], then ReLU);
- ``cross_norm``: a ``cross_norm_hadamard`` block over the (projection,
  attention) pair, one field of width ``d_model``. The caller owns the
  ``DataNormSummary`` (``cross_summary`` at call time; update it outside
  the grad with ``ops.cross_norm.cross_norm_update``).

Flax infers layer widths at init; here they are explicit: ``num_slots``
S, ``slot_width`` (the pooled width per slot) and ``dense_dim``. Layer
names follow the flax tree (``slot_fc_w`` [S, D, D], ``slot_fc_b``,
``ad_proj``, ``rank_param`` [K², dm, dm], ``mlp_{i}``, ``head``), so
``convert.ads_rank_state_dict_from_flax`` maps one onto the other.
``ad_proj`` and the ``mlp_{i}`` layers cast their inputs, weights and
biases to ``compute_dtype`` (bf16 by default), as flax's
``Dense(dtype=...)`` does; everything else runs in float32. ``ops``
selects the CTR kernels (``kernels.PLAIN`` runs the plain versions).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from paddlebox_tpu_torch.ops.batch_fc import batch_fc
from paddlebox_tpu_torch.ops.cross_norm import cross_norm_hadamard
from paddlebox_tpu_torch.ops.data_norm import DataNormSummary
from paddlebox_tpu_torch.ops.kernels import KERNELS, KernelSet
from paddlebox_tpu_torch.ops.rank_attention import rank_attention


class AdsRank(nn.Module):
    """pooled [B, S, D] + dense [B, Dd] + rank_offset [B, 1+2K] → logits
    [B] f32."""

    def __init__(self, num_slots: int, slot_width: int, dense_dim: int,
                 d_model: int = 64, max_rank: int = 3,
                 hidden: Sequence[int] = (128, 64),
                 compute_dtype: torch.dtype = torch.bfloat16,
                 slot_fc: bool = False, cross_norm: bool = False,
                 ops: KernelSet = KERNELS) -> None:
        super().__init__()
        s, d = num_slots, slot_width
        self.d_model = d_model
        self.max_rank = max_rank
        self.compute_dtype = compute_dtype
        self.slot_fc = slot_fc
        self.cross_norm = cross_norm
        self.ops = ops
        if slot_fc:
            self.slot_fc_w = nn.Parameter(torch.randn(s, d, d) * 0.02)
            self.slot_fc_b = nn.Parameter(torch.zeros(s, d))
        self.ad_proj = nn.Linear(s * d + dense_dim, d_model)
        self.rank_param = nn.Parameter(
            torch.randn(max_rank * max_rank, d_model, d_model) * 0.02)
        widths = [2 * d_model + (3 * d_model + 1 if cross_norm else 0),
                  *hidden]
        self.mlp_names = tuple(f"mlp_{i}" for i in range(len(hidden)))
        for name, i, o in zip(self.mlp_names, widths[:-1], widths[1:]):
            setattr(self, name, nn.Linear(i, o))
        self.head = nn.Linear(widths[-1], 1)

    def _dense(self, layer: nn.Linear, h: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype
        return F.linear(h.to(cd), layer.weight.to(cd),
                        layer.bias.to(cd)).float()

    def forward(self, pooled: torch.Tensor, dense: torch.Tensor,
                rank_offset: torch.Tensor,
                cross_summary: Optional[DataNormSummary] = None
                ) -> torch.Tensor:
        b, s, d = pooled.shape
        pooled = pooled.float()
        if self.slot_fc:
            pooled = F.relu(batch_fc(pooled.transpose(0, 1), self.slot_fc_w,
                                     self.slot_fc_b, ops=self.ops)
                            ).transpose(0, 1)
        feats = torch.cat([pooled.reshape(b, s * d), dense.float()], dim=1)
        proj = self._dense(self.ad_proj, feats)
        ra = rank_attention(proj, rank_offset, self.rank_param,
                            max_rank=self.max_rank, enable_input_bp=True,
                            ops=self.ops)
        h = torch.cat([proj, ra], dim=1)
        if self.cross_norm:
            if cross_summary is None:
                raise ValueError(
                    "AdsRank(cross_norm=True) needs a cross_summary "
                    "(ops.cross_norm.init_cross_norm_summary(1, d_model))")
            cx = cross_norm_hadamard(h, cross_summary, 1, self.d_model,
                                     ops=self.ops)
            h = torch.cat([h, cx], dim=1)
        for name in self.mlp_names:
            h = F.relu(self._dense(getattr(self, name), h))
        return self.head(h)[:, 0]
