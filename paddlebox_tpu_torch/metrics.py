"""Training metrics: bucketed AUC and error sums (counterpart of the AUC
half of ``paddlebox_tpu/metrics.py``; ``MetricRegistry`` is not ported
yet).

``BasicAucCalculator`` (metrics.h:46): pos/neg tables of ``nbins``
buckets keyed by ``int(pred * nbins)``. The two tables are the two rows of
one ``[2, nbins]`` tensor on the device, so a batch updates both with ONE
``index_add_``; the final compute pulls them to the host and reduces in
float64.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Union

import numpy as np
import torch

AUC_NUM_BUCKETS = 1_000_000


class AucState(NamedTuple):
    buckets: torch.Tensor  # f32 [2, nbins]: row 0 = pos, row 1 = neg
    sums: torch.Tensor     # f32 [5]: abs_err, sqr_err, pred_sum,
                           #          label_sum, ins_num

    @property
    def pos(self) -> torch.Tensor:
        return self.buckets[0]

    @property
    def neg(self) -> torch.Tensor:
        return self.buckets[1]


def init_auc_state(nbins: int = AUC_NUM_BUCKETS,
                   device: Union[str, torch.device] = "cpu") -> AucState:
    return AucState(torch.zeros((2, nbins), dtype=torch.float32,
                                device=device),
                    torch.zeros(5, dtype=torch.float32, device=device))


def auc_add_batch(state: AucState, pred: torch.Tensor, label: torch.Tensor,
                  weight: torch.Tensor) -> AucState:
    """Accumulate one batch IN PLACE (BasicAucCalculator::add_data,
    metrics.h:68); ``weight`` masks padding instances (0). Returns
    ``state``."""
    n = state.buckets.shape[1]
    b = (pred * n).to(torch.int32).clamp(0, n - 1).long()
    w = weight.float()
    lab = label.float()
    lw = lab * w
    state.buckets.view(-1).index_add_(0, torch.cat([b, b + n]),
                                      torch.cat([lw, w - lw]))
    err = (pred - lab) * w
    state.sums.add_(torch.stack([err.abs().sum(), (err * err).sum(),
                                 (pred * w).sum(), lw.sum(), w.sum()]))
    return state


@dataclasses.dataclass
class AucResult:
    auc: float
    actual_ctr: float
    predicted_ctr: float
    mae: float
    rmse: float
    ins_num: float

    def as_dict(self) -> Dict[str, float]:
        return dataclasses.asdict(self)


def auc_compute(state: AucState) -> AucResult:
    """Final compute (BasicAucCalculator::compute): the bucket scan in
    float64 on the host, area / (pos_total * neg_total)."""
    buckets = state.buckets.cpu().numpy().astype(np.float64)
    abs_err, sqr_err, pred_sum, label_sum, ins = (
        float(x) for x in state.sums.cpu().numpy())
    pos, neg = buckets[0], buckets[1]
    tot_pos, tot_neg = pos.sum(), neg.sum()
    cum_neg_below = np.concatenate([[0.0], np.cumsum(neg)[:-1]])
    # P(pos-bucket > neg-bucket) + 0.5 P(tie), summed per bucket
    area = np.sum(pos * (cum_neg_below + 0.5 * neg))
    auc = (float(area / (tot_pos * tot_neg))
           if tot_pos > 0 and tot_neg > 0 else 0.5)
    ins_safe = max(ins, 1e-12)
    return AucResult(auc=auc, actual_ctr=label_sum / ins_safe,
                     predicted_ctr=pred_sum / ins_safe,
                     mae=abs_err / ins_safe,
                     rmse=float(np.sqrt(sqr_err / ins_safe)), ins_num=ins)
