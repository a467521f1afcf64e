"""Training metrics: bucketed AUC and error sums, and the named metric
registry (counterpart of ``paddlebox_tpu/metrics.py``).

``BasicAucCalculator`` (metrics.h:46): pos/neg tables of ``nbins``
buckets keyed by ``int(pred * nbins)``. The two tables are the two rows of
one ``[2, nbins]`` tensor on the device, so a batch updates both with ONE
``index_add_``; the final compute pulls them to the host and reduces in
float64.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Dict, NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

from paddlebox_tpu_torch.device import resolve_device

log = logging.getLogger(__name__)

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
                   device: Union[str, torch.device] = "cuda") -> AucState:
    """Zeroed AUC tables, on the card unless the caller asks for the
    CPU (raises where no card is present)."""
    dev = resolve_device(device)
    return AucState(torch.zeros((2, nbins), dtype=torch.float32,
                                device=dev),
                    torch.zeros(5, dtype=torch.float32, device=dev))


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


def auc_compute_global(state: AucState, collective) -> AucResult:
    """Cross-worker AUC (BasicAucCalculator's MPI reduce,
    metrics.cc:288-304): this worker's tables go through
    ``collective.allreduce_sum`` (any object whose ``allreduce_sum``
    takes a list of numpy arrays and returns their element-wise sums
    over the workers) and ONE global AUC is computed from the sums, the
    same on every worker."""
    host = [state.buckets.detach().cpu().numpy(),
            state.sums.detach().cpu().numpy()]
    buckets, sums = collective.allreduce_sum(host)
    return auc_compute(AucState(
        torch.from_numpy(np.asarray(buckets, np.float32)),
        torch.from_numpy(np.asarray(sums, np.float32))))


def auc_merge(states: Sequence[AucState]) -> AucState:
    """Cross-worker table reduce (metrics.cc:288-304): the host-side sum
    of per-worker states, on the first state's device."""
    dev = states[0].buckets.device
    return AucState(
        torch.stack([s.buckets.to(dev) for s in states]).sum(0),
        torch.stack([s.sums.to(dev) for s in states]).sum(0))


def as_tensor(x, like: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x`` (a tensor, numpy array or sequence) as a tensor, on
    ``like``'s device when given: the registry takes device predictions
    and host side channels in one call."""
    t = x if torch.is_tensor(x) else torch.as_tensor(np.asarray(x))
    return t if like is None else t.to(like.device)


class Metric:
    """Named bucketed AUC with a phase filter (MetricMsg, metrics.h:198).
    The tables live on the device of the first predictions fed (the
    CPU until then)."""

    def __init__(self, name: str, label: str = "label", pred: str = "pred",
                 phase: int = -1, nbins: Optional[int] = None) -> None:
        self.name = name
        self.label_var = label
        self.pred_var = pred
        self.phase = phase  # -1: all phases (join/update)
        self._nbins = nbins or AUC_NUM_BUCKETS
        self.state: Optional[AucState] = None

    def _state_on(self, like: torch.Tensor) -> AucState:
        if self.state is None:
            self.state = init_auc_state(self._nbins, like.device)
        return self.state

    def selection_weight(self, weight: torch.Tensor,
                         **inputs) -> torch.Tensor:
        """The instance weights this metric counts (the filtered variants
        of ``metrics_ext`` zero the instances outside their filter)."""
        return weight

    def add(self, pred, label, weight=None, **inputs) -> None:
        pred = as_tensor(pred)
        w = (torch.ones_like(pred) if weight is None
             else as_tensor(weight, pred))
        auc_add_batch(self._state_on(pred), pred, as_tensor(label, pred),
                      self.selection_weight(w, **inputs))

    def compute(self) -> AucResult:
        return auc_compute(self.state if self.state is not None
                           else init_auc_state(self._nbins, "cpu"))

    def reset(self) -> None:
        if self.state is not None:
            self.state = init_auc_state(self._nbins,
                                        self.state.buckets.device)


class MetricRegistry:
    """init_metric/get_metric_msg surface (box_helper_py.cc:99-160).
    ``method`` selects the variant (``metrics_ext.METRIC_METHODS``):
    auc | cmatch_rank_auc | mask_auc | cmatch_rank_mask_auc |
    multi_task_auc | continue_value | nan_inf | wuauc."""

    def __init__(self) -> None:
        self._metrics: Dict[str, object] = {}
        self.phase = 1  # 1=join, 0=update (FlipPhase semantics)
        self._warned_missing: set = set()

    def init_metric(self, name: str, method: str = "auc", **kwargs):
        from paddlebox_tpu_torch.metrics_ext import METRIC_METHODS
        try:
            cls = METRIC_METHODS[method]
        except KeyError:
            raise ValueError(
                f"unknown metric method {method!r}; "
                f"one of {sorted(METRIC_METHODS)}") from None
        m = cls(name, **kwargs)
        self._metrics[name] = m
        return m

    def get(self, name: str):
        return self._metrics[name]

    def get_metric_msg(self, name: str) -> Dict[str, float]:
        out = self._metrics[name].compute()
        return out.as_dict() if isinstance(out, AucResult) else out

    def add_batch(self, pred, label, weight=None, **inputs) -> None:
        """Feed every phase-active metric from one batch (the per-batch
        AddAucMonitor hook, boxps_worker.cc:1267). ``inputs`` carries
        the side channels (uid/rank/cmatch/mask); None values drop out,
        and a metric whose REQUIRED side channels are absent is skipped
        with a one-time warning instead of failing the pass."""
        kw = {k: v for k, v in inputs.items() if v is not None}
        for name, m in self.active().items():
            missing = [r for r in getattr(m, "REQUIRED", ()) if r not in kw]
            if missing:
                if name not in self._warned_missing:
                    self._warned_missing.add(name)
                    log.warning("metric %r skipped: feed lacks required "
                                "side channel(s) %s", name, missing)
                continue
            m.add(pred, label=label, weight=weight, **kw)

    def flip_phase(self) -> None:
        self.phase = 1 - self.phase

    def __len__(self) -> int:
        return len(self._metrics)

    def active(self) -> Dict[str, object]:
        return {k: m for k, m in self._metrics.items()
                if m.phase in (-1, self.phase)}

    def reset_all(self) -> None:
        for m in self._metrics.values():
            m.reset()
