"""Model-quality drift monitor — the observability half of feature
lifecycle scoring (counterpart of ``paddlebox_tpu/obs/quality.py``).

PaddleBox's production loop watches per-pass AUC/calibration and
slot-level feature health and alarms on drift (SURVEY §2.7
``metrics.h``, §5.4 ``delta_score``/``ctr_accessor``); crashes page
someone, quality regressions don't — so this monitor rides THE
per-pass telemetry seam (``obs.hub.emit_pass_event``) and turns each
train/stream pass into windowed drift verdicts:

- **key coverage/churn** — rows used, per-slot key counts, and the
  symmetric-difference churn fraction of the key set between passes;
- **embedding-norm drift** — mean |row| over a deterministic sample of
  used rows vs the trailing-window baseline;
- **CTR calibration** — predicted-vs-observed CTR overall
  (``predicted_ctr``/``actual_ctr`` off the pass AUC result) and per
  coarse prediction bucket (the 1e6-bin AUC tables collapsed into
  ``FLAGS.quality_calibration_buckets``, diffed between passes so each
  window is per-pass, not cumulative);
- **windowed AUC trend** — trailing-half vs leading-half mean over the
  window, with a degradation verdict when the drop exceeds
  ``FLAGS.quality_auc_drop``.

Everything lands as ``pbox_quality_*`` instruments plus one
``quality_window`` event per pass. Default-off
(``FLAGS.quality_window_passes=0``): the hook in ``emit_pass_event``
is one flag read; resident digest gates stay bit-identical.

Difference from the reference: the embedding-norm sample is gathered on
the table's device. The reference copies the whole logical table to the
host every pass (``jax.device_get(state.data)``: 512 MiB at 2^23 rows of
16 floats); the port takes the ``NORM_SAMPLE_ROWS`` sampled rows with
one ``index_select`` where the table lives and copies only those. The
AUC tables come to the host with one ``.cpu()`` per pass. These are the
monitor's only device reads, once per pass event.
"""

from __future__ import annotations

import collections
from typing import Dict, List, Optional

import numpy as np
import torch

from paddlebox_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

#: deterministic embedding-norm sample cap (rows, sorted by feasign)
NORM_SAMPLE_ROWS = 2048
#: key-set churn is exact up to this many used rows, then falls back to
#: the table's staged/evicted delta counts
CHURN_EXACT_ROWS = 1 << 20


class QualityMonitor:
    """Trailing-window quality stats; one ``note_pass`` per pass."""

    def __init__(self, window: int, auc_drop: float = 0.01,
                 calib_buckets: int = 10) -> None:
        self.window = max(int(window), 2)
        self.auc_drop = float(auc_drop)
        self.calib_buckets = max(int(calib_buckets), 2)
        self._auc: collections.deque = collections.deque(
            maxlen=self.window)
        self._norm: collections.deque = collections.deque(
            maxlen=self.window)
        self._prev_keys: Optional[np.ndarray] = None
        self._prev_buckets: Optional[np.ndarray] = None  # [2, nbins]
        self.passes = 0

    # ---- per-pass ingestion --------------------------------------------
    def note_pass(self, ev: Dict, table=None, auc_state=None,
                  hub=None) -> Optional[Dict]:
        """Fold one pass event into the window; returns the
        ``quality_window`` payload (also emitted + mirrored into
        ``pbox_quality_*`` instruments when ``hub`` is active)."""
        if hub is None:
            from paddlebox_tpu_torch.obs.hub import get_hub
            hub = get_hub()
        self.passes += 1
        out: Dict = {"pass_seq": ev.get("pass_seq"),
                     "global_step": ev.get("global_step"),
                     "window": self.window}
        auc = ev.get("auc")
        if auc is not None and not _isnan(auc):
            self._auc.append(float(auc))
        out.update(self._auc_trend())
        out.update(self._calibration(ev, auc_state))
        out.update(self._coverage(table))
        out.update(self._norm_drift(table))
        self._mirror(hub, out)
        if hub.active:
            hub.emit("quality_window", **out)
        return out

    # ---- windowed AUC trend --------------------------------------------
    def _auc_trend(self) -> Dict:
        if not self._auc:
            return {}
        vals = list(self._auc)
        mean = sum(vals) / len(vals)
        out = {"auc": vals[-1], "auc_window_mean": round(mean, 6)}
        if len(vals) >= 2:
            half = len(vals) // 2
            lead = sum(vals[:half]) / half
            trail = sum(vals[half:]) / (len(vals) - half)
            trend = trail - lead
            out["auc_trend"] = round(trend, 6)
            out["degraded"] = bool(trend < -self.auc_drop)
        else:
            out["degraded"] = False
        return out

    # ---- CTR calibration -----------------------------------------------
    def _calibration(self, ev: Dict, auc_state) -> Dict:
        out: Dict = {}
        pred = ev.get("predicted_ctr")
        actual = ev.get("actual_ctr")
        if pred is not None and actual is not None:
            out["predicted_ctr"] = round(float(pred), 6)
            out["actual_ctr"] = round(float(actual), 6)
            out["calibration_ratio"] = round(
                float(pred) / max(float(actual), 1e-9), 6)
        if auc_state is None:
            return out
        try:
            buckets = auc_state.buckets.detach().cpu().numpy()
            pos = np.asarray(buckets[0], np.float64)
            neg = np.asarray(buckets[1], np.float64)
        except Exception:
            log.debug("quality: auc bucket fetch failed", exc_info=True)
            return out
        cur = np.stack([pos, neg])
        prev = self._prev_buckets
        self._prev_buckets = cur
        # diff vs the previous pass: the AUC tables are cumulative
        # until reset_metrics — the window must be per-pass
        delta = cur - prev if (prev is not None
                               and prev.shape == cur.shape) else cur
        delta = np.clip(delta, 0.0, None)   # reset_metrics between passes
        nbins = delta.shape[1]
        k = self.calib_buckets
        edges = np.linspace(0, nbins, k + 1).astype(np.int64)
        centers = (np.arange(nbins, dtype=np.float64) + 0.5) / nbins
        buckets: List[Dict] = []
        for i in range(k):
            sl = slice(edges[i], edges[i + 1])
            clicks = float(delta[0, sl].sum())
            imps = clicks + float(delta[1, sl].sum())
            if imps <= 0:
                continue
            w = delta[0, sl] + delta[1, sl]
            pred_b = float((centers[sl] * w).sum() / imps)
            buckets.append({"bucket": i,
                            "pred_ctr": round(pred_b, 6),
                            "observed_ctr": round(clicks / imps, 6),
                            "examples": imps})
        if buckets:
            out["calibration"] = buckets
        return out

    # ---- key coverage / churn ------------------------------------------
    def _coverage(self, table) -> Dict:
        out: Dict = {}
        stats = {}
        if table is not None and hasattr(table, "obs_stats"):
            try:
                stats = table.obs_stats()
            except Exception:
                log.debug("quality: obs_stats failed", exc_info=True)
        if "used" in stats:
            out["keys_used"] = int(stats["used"])
        index = getattr(table, "index", None)
        if index is None or not hasattr(index, "items"):
            return out
        try:
            keys, rows = index.items()
        except Exception:
            return out
        if len(keys) <= CHURN_EXACT_ROWS:
            cur = np.sort(np.asarray(keys, np.uint64))
            prev = self._prev_keys
            self._prev_keys = cur
            if prev is not None:
                inter = np.intersect1d(cur, prev,
                                       assume_unique=True).size
                churn = (cur.size - inter) + (prev.size - inter)
                out["key_churn_frac"] = round(
                    churn / max(cur.size, prev.size, 1), 6)
        else:
            lp = getattr(table, "last_pass_stats", None) or {}
            moved = float(lp.get("staged", 0)) + float(
                lp.get("evicted", 0))
            out["key_churn_frac"] = round(
                moved / max(float(len(keys)), 1.0), 6)
        slot_host = getattr(table, "slot_host", None)
        if slot_host is not None and len(rows):
            slots = np.asarray(slot_host)[np.asarray(rows)]
            uniq, counts = np.unique(slots, return_counts=True)
            out["slot_keys"] = {int(s): int(c)
                                for s, c in zip(uniq, counts)}
        return out

    # ---- embedding-norm drift ------------------------------------------
    def _norm_drift(self, table) -> Dict:
        index = getattr(table, "index", None)
        state = getattr(table, "state", None)
        if index is None or state is None \
                or not hasattr(index, "items") \
                or not hasattr(state, "data"):
            return {}
        try:
            keys, rows = index.items()
            if not len(rows):
                return {}
            # deterministic sample: the NORM_SAMPLE_ROWS smallest keys
            order = np.argsort(np.asarray(keys, np.uint64),
                               kind="stable")[:NORM_SAMPLE_ROWS]
            sample = norm_sample(state.data, np.asarray(rows)[order])
            norm = float(np.abs(sample).mean())
        except Exception:
            log.debug("quality: norm sample failed", exc_info=True)
            return {}
        baseline = (sum(self._norm) / len(self._norm)
                    if self._norm else None)
        self._norm.append(norm)
        out = {"embed_norm": round(norm, 8)}
        if baseline is not None and baseline > 0:
            out["embed_norm_drift"] = round(
                (norm - baseline) / baseline, 6)
        return out

    # ---- instrument mirror ---------------------------------------------
    @staticmethod
    def _mirror(hub, out: Dict) -> None:
        g = hub.gauge
        if "auc" in out:
            g("pbox_quality_auc", "latest pass AUC").set(out["auc"])
            g("pbox_quality_auc_window_mean",
              "trailing-window mean AUC").set(out["auc_window_mean"])
        if "auc_trend" in out:
            g("pbox_quality_auc_trend",
              "trailing-half minus leading-half window AUC"
              ).set(out["auc_trend"])
        if "degraded" in out:
            g("pbox_quality_degraded",
              "1 while the windowed AUC trend breaches the "
              "degradation threshold").set(1.0 if out["degraded"]
                                           else 0.0)
        if "calibration_ratio" in out:
            g("pbox_quality_calibration_ratio",
              "windowed predicted/observed CTR"
              ).set(out["calibration_ratio"])
        for b in out.get("calibration", ()):
            g("pbox_quality_calibration_ctr",
              "per-bucket predicted vs observed CTR").set(
                  b["observed_ctr"], bucket=b["bucket"], kind="observed")
            g("pbox_quality_calibration_ctr",
              "per-bucket predicted vs observed CTR").set(
                  b["pred_ctr"], bucket=b["bucket"], kind="predicted")
        if "keys_used" in out:
            g("pbox_quality_keys_used",
              "embedding rows used at pass end").set(out["keys_used"])
        if "key_churn_frac" in out:
            g("pbox_quality_key_churn_frac",
              "key-set churn fraction vs previous pass"
              ).set(out["key_churn_frac"])
        for slot, n in (out.get("slot_keys") or {}).items():
            g("pbox_quality_slot_keys",
              "embedding rows per slot").set(n, slot=slot)
        if "embed_norm" in out:
            g("pbox_quality_embed_norm",
              "mean |w| over the deterministic row sample"
              ).set(out["embed_norm"])
        if "embed_norm_drift" in out:
            g("pbox_quality_embed_norm_drift",
              "relative embedding-norm drift vs the trailing baseline"
              ).set(out["embed_norm_drift"])


def norm_sample(data, rows: np.ndarray) -> np.ndarray:
    """The sampled rows of the table ``data`` [C+1, F], gathered with
    one ``index_select`` on the table's device, then copied to the host
    (only the sample crosses the bus)."""
    idx = torch.as_tensor(np.asarray(rows, np.int64), device=data.device)
    return data.index_select(0, idx).cpu().numpy()


def _isnan(x) -> bool:
    try:
        return x != x
    except Exception:
        return False


# ---- module-level hook (emit_pass_event rides this) --------------------
_MONITOR: Optional[QualityMonitor] = None


def get_monitor() -> Optional[QualityMonitor]:
    return _MONITOR


def reset_monitor() -> None:
    global _MONITOR
    _MONITOR = None


def note_pass_event(ev: Dict, table=None, auc_state=None,
                    hub=None) -> None:
    """The pass-event hook: lazily build the monitor from FLAGS and
    fold the pass in. Callers (``emit_pass_event``) gate on
    ``FLAGS.quality_window_passes > 0`` — off costs one flag read."""
    global _MONITOR
    from paddlebox_tpu_torch.config import FLAGS
    if _MONITOR is None or _MONITOR.window != max(
            int(FLAGS.quality_window_passes), 2):
        _MONITOR = QualityMonitor(
            FLAGS.quality_window_passes,
            auc_drop=FLAGS.quality_auc_drop,
            calib_buckets=FLAGS.quality_calibration_buckets)
    try:
        _MONITOR.note_pass(ev, table=table, auc_state=auc_state,
                           hub=hub)
    except Exception:
        # drift monitoring must never take the training loop down
        log.warning("quality monitor pass hook failed", exc_info=True)
