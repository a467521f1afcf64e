"""Metric variants beyond plain AUC (counterpart of the single-process
half of ``paddlebox_tpu/metrics_ext.py``; the pod reductions wait for the
multi-process port).

Reference: fleet/metrics.h:198-567 — ``MetricMsg`` (auc),
``MultiTaskMetricMsg`` (per-instance task head by cmatch),
``CmatchRankMetricMsg`` (filter by (cmatch, rank) pairs),
``MaskMetricMsg`` (0/1 mask), ``CmatchRankMaskMetricMsg``,
``WuAucMetricMsg`` (per-user AUC over uid-collected records), the
continue-value MSE/RMSE and the NaN/Inf counters.

Every filtered variant reduces to a selection weight fed to the same
bucketed ``auc_add_batch`` on the predictions' device; only WuAUC
collects (uid, pred, label) on the host, as the reference does.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from paddlebox_tpu_torch.metrics import Metric, as_tensor, auc_add_batch


def parse_cmatch_rank_group(group: str) -> List[Tuple[int, int]]:
    """"401:0,402:0" → [(401,0),(402,0)]; entries without ':' get rank 0
    (MetricMsg parse_cmatch_rank)."""
    out = []
    for part in group.split(","):
        part = part.strip()
        if not part:
            continue
        if ":" in part:
            c, r = part.split(":")
            out.append((int(c), int(r)))
        else:
            out.append((int(part), 0))
    return out


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


class AucMetric(Metric):
    """Plain bucketed AUC (MetricMsg). Base of the filtered variants."""

    method = "auc"

    def compute(self) -> Dict[str, float]:
        return super().compute().as_dict()


class CmatchRankAucMetric(AucMetric):
    """AUC over instances whose (cmatch, rank) is in the group
    (CmatchRankMetricMsg, metrics.h:279; ignore_rank matches cmatch
    only)."""

    method = "cmatch_rank_auc"
    REQUIRED = ("cmatch",)

    def __init__(self, name: str, cmatch_rank_group: str,
                 ignore_rank: bool = False, **kw) -> None:
        super().__init__(name, **kw)
        self.group = parse_cmatch_rank_group(cmatch_rank_group)
        self.ignore_rank = ignore_rank

    def selection_weight(self, weight, *, cmatch, rank=None, **_):
        cmatch = as_tensor(cmatch, weight)
        rank = None if rank is None else as_tensor(rank, weight)
        sel = torch.zeros_like(weight, dtype=torch.bool)
        for c, r in self.group:
            m = cmatch == c
            if not self.ignore_rank and rank is not None:
                m = m & (rank == r)
            sel = sel | m
        return weight * sel.to(weight.dtype)


class MaskAucMetric(AucMetric):
    """AUC over instances with mask == 1 (MaskMetricMsg,
    metrics.h:369)."""

    method = "mask_auc"
    REQUIRED = ("mask",)

    def selection_weight(self, weight, *, mask, **_):
        return weight * (as_tensor(mask, weight) > 0).to(weight.dtype)


class CmatchRankMaskAucMetric(CmatchRankAucMetric):
    """Both filters (CmatchRankMaskMetricMsg, metrics.h:414)."""

    method = "cmatch_rank_mask_auc"
    REQUIRED = ("cmatch", "mask")

    def selection_weight(self, weight, *, cmatch, rank=None, mask=None,
                         **_):
        w = super().selection_weight(weight, cmatch=cmatch, rank=rank)
        if mask is not None:
            w = w * (as_tensor(mask, w) > 0).to(w.dtype)
        return w


class MultiTaskAucMetric(AucMetric):
    """Per-instance task head selected by cmatch (MultiTaskMetricMsg,
    metrics.h:198): pred[i] = preds[i, task_of(cmatch[i])]."""

    method = "multi_task_auc"
    REQUIRED = ("cmatch",)

    def __init__(self, name: str, cmatch_rank_group: str, **kw) -> None:
        super().__init__(name, **kw)
        self.group = parse_cmatch_rank_group(cmatch_rank_group)
        max_c = max(c for c, _ in self.group)
        lut = np.full(max_c + 2, -1, np.int64)
        for c, task in self.group:
            lut[c] = task
        self._lut = torch.from_numpy(lut)

    def add(self, preds, label, weight=None, *, cmatch, **_) -> None:
        """preds: [B, num_tasks]."""
        preds = as_tensor(preds)
        w = (torch.ones(preds.shape[0], dtype=preds.dtype,
                        device=preds.device)
             if weight is None else as_tensor(weight, preds))
        lut = self._lut.to(preds.device)
        c = as_tensor(cmatch, preds).long().clamp(0, lut.shape[0] - 1)
        task = lut[c]
        pred = preds.gather(1, task.clamp_min(0)[:, None])[:, 0]
        auc_add_batch(self._state_on(preds), pred, as_tensor(label, preds),
                      w * (task >= 0).to(w.dtype))


class ContinueValueMetric:
    """Regression metric: mae/mse/rmse only (compute_continue_value)."""

    method = "continue_value"

    def __init__(self, name: str, label: str = "label", pred: str = "pred",
                 phase: int = -1) -> None:
        self.name = name
        self.label_var = label
        self.pred_var = pred
        self.phase = phase
        self.reset()

    def add(self, pred, label, weight=None, **_):
        pred = as_tensor(pred)
        w = (torch.ones_like(pred) if weight is None
             else as_tensor(weight, pred))
        err = (pred - as_tensor(label, pred)) * w
        self._abs += float(err.abs().sum())
        self._sqr += float((err * err).sum())
        self._n += float(w.sum())

    def compute(self) -> Dict[str, float]:
        n = max(self._n, 1e-12)
        return {"mae": self._abs / n, "mse": self._sqr / n,
                "rmse": float(np.sqrt(self._sqr / n)), "ins_num": self._n}

    def reset(self):
        self._abs = 0.0
        self._sqr = 0.0
        self._n = 0.0


class NanInfMetric:
    """NaN/Inf prediction counters (box_wrapper.h:792)."""

    method = "nan_inf"

    def __init__(self, name: str, pred: str = "pred", phase: int = -1):
        self.name = name
        self.pred_var = pred
        self.phase = phase
        self.reset()

    def add(self, pred, **_):
        pred = as_tensor(pred)
        self.nan_cnt += int(torch.isnan(pred).sum())
        self.inf_cnt += int(torch.isinf(pred).sum())
        self.total += int(pred.shape[0])

    def compute(self) -> Dict[str, float]:
        return {"nan": float(self.nan_cnt), "inf": float(self.inf_cnt),
                "ins_num": float(self.total)}

    def reset(self):
        self.nan_cnt = 0
        self.inf_cnt = 0
        self.total = 0


def _tie_averaged_user_auc(uid: np.ndarray, pred: np.ndarray,
                           label: np.ndarray) -> Tuple[float, float, int]:
    """Vectorized per-user Mann-Whitney AUC with tie-averaged ranks.
    Returns (wuauc, uauc, users_counted): wuauc weighs each user's AUC by
    its instance count, uauc is the plain mean (computeWuAuc)."""
    if len(uid) == 0:
        return 0.0, 0.0, 0
    s = np.lexsort((pred, uid))
    u, p, l = uid[s], pred[s], label[s].astype(np.float64)
    n = len(u)
    new_user = np.empty(n, bool)
    new_user[0] = True
    new_user[1:] = u[1:] != u[:-1]
    g = np.cumsum(new_user) - 1                      # user group id
    start = np.flatnonzero(new_user)                 # first idx per user
    pos_in_grp = np.arange(n) - start[g]
    # tie runs: same user AND same pred
    new_tie = new_user.copy()
    new_tie[1:] |= p[1:] != p[:-1]
    tie_id = np.cumsum(new_tie) - 1
    tie_start = np.flatnonzero(new_tie)
    tie_cnt = np.diff(np.append(tie_start, n))
    # average 1-based rank within the user for each tie run
    avg_rank = (pos_in_grp[tie_start][tie_id] + 1
                + (tie_cnt[tie_id] - 1) / 2.0)
    num_users = int(g[-1]) + 1
    n_u = np.bincount(g, minlength=num_users).astype(np.float64)
    n_pos = np.bincount(g, weights=l, minlength=num_users)
    n_neg = n_u - n_pos
    rank_pos = np.bincount(g, weights=avg_rank * l, minlength=num_users)
    ok = (n_pos > 0) & (n_neg > 0)
    auc_u = np.zeros(num_users)
    auc_u[ok] = ((rank_pos[ok] - n_pos[ok] * (n_pos[ok] + 1) / 2.0)
                 / (n_pos[ok] * n_neg[ok]))
    w = n_u * ok
    wuauc = float((auc_u * w).sum() / max(w.sum(), 1e-12))
    uauc = float(auc_u[ok].mean()) if ok.any() else 0.0
    return wuauc, uauc, int(ok.sum())


class WuAucMetric:
    """Per-user (weighted-user) AUC (WuAucMetricMsg, metrics.h:497):
    collects (uid, pred, label) on the host per batch, like the
    reference's record-based WuAucCalculator. Feeding it from a trainer
    reads the predictions back every batch."""

    method = "wuauc"
    REQUIRED = ("uid",)

    def __init__(self, name: str, label: str = "label", pred: str = "pred",
                 uid: str = "uid", phase: int = -1) -> None:
        self.name = name
        self.label_var = label
        self.pred_var = pred
        self.uid_var = uid
        self.phase = phase
        self.reset()

    def add(self, pred, label, weight=None, *, uid, **_) -> None:
        pred = _host(pred)
        mask = (_host(weight) > 0 if weight is not None
                else np.ones(len(pred), bool))
        self._uid.append(_host(uid)[mask])
        self._pred.append(pred[mask])
        self._label.append(_host(label)[mask])

    def compute(self) -> Dict[str, float]:
        uid = (np.concatenate(self._uid) if self._uid
               else np.empty(0, np.int64)).astype(np.int64, copy=False)
        pred = (np.concatenate(self._pred) if self._pred
                else np.empty(0)).astype(np.float64, copy=False)
        label = (np.concatenate(self._label) if self._label
                 else np.empty(0)).astype(np.float64, copy=False)
        wuauc, uauc, users = _tie_averaged_user_auc(uid, pred, label)
        return {"wuauc": wuauc, "uauc": uauc, "user_count": float(users),
                "ins_num": float(len(uid))}

    def reset(self) -> None:
        self._uid: List[np.ndarray] = []
        self._pred: List[np.ndarray] = []
        self._label: List[np.ndarray] = []


METRIC_METHODS = {
    cls.method: cls
    for cls in (AucMetric, CmatchRankAucMetric, MaskAucMetric,
                CmatchRankMaskAucMetric, MultiTaskAucMetric,
                ContinueValueMetric, NanInfMetric, WuAucMetric)
}
