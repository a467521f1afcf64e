"""Declarative SLO alert engine over hub instruments.
(Copy of ``paddlebox_tpu/obs/alerts.py``.)

Rules — threshold / absence / trend — evaluate against the live
``TelemetryHub`` instruments on a cadence thread (or explicitly via
``evaluate_once`` in gates) and drive:

- ``pbox_alerts_active{rule,severity}`` — 1 while firing, 0 after the
  clear (the gauge IS the alarm surface a scraper watches);
- ``alert_fired`` / ``alert_cleared`` events with the observed value
  and threshold;
- the ``/alertz`` route and the ``alerts`` block in ``/healthz``
  (``AlertEngine.status``, registered as the hub's alerts probe);
- the flight recorder: a firing rule is an SLO breach — it fires the
  ``slo_breach`` trigger (per-trigger debounce collapses rule storms
  into one bundle per window).

Rule grammar (docs/OBSERVABILITY.md §Alerts):

- ``threshold`` — sample the metric (counters/gauges: sum of the
  series matching ``labels`` as a subset; histograms: ``quantile`` of
  the exact ``labels`` series) and breach when ``op(sample, value)``;
- ``absence`` — breach when the metric has no samples at all (a
  heartbeat instrument that should exist but doesn't);
- ``trend`` — keep the last ``trend_window`` samples (one per
  evaluation) and breach when ``op(newest - oldest, value)`` — e.g.
  ``>`` 0 fires on ANY increase of a monotone counter between
  evaluations and clears once it goes flat.

``for_count``/``clear_count`` debounce flapping: a rule needs that many
consecutive breaching/clean evaluations to transition. Default rules
(``default_rules``): serving staleness, serving p99, stream lag,
pipeline hang, NaN-rollback rate, AUC degradation.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Deque, Dict, List, Optional

from paddlebox_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

_OPS = {
    ">": lambda a, b: a > b,
    "<": lambda a, b: a < b,
    ">=": lambda a, b: a >= b,
    "<=": lambda a, b: a <= b,
}


@dataclasses.dataclass
class Rule:
    name: str
    metric: str
    kind: str = "threshold"            # threshold | absence | trend
    severity: str = "warn"             # warn | critical
    op: str = ">"
    value: float = 0.0
    labels: Dict[str, str] = dataclasses.field(default_factory=dict)
    quantile: Optional[float] = None   # histograms only
    trend_window: int = 2              # samples kept for kind=trend
    for_count: int = 1                 # consecutive breaches to fire
    clear_count: int = 1               # consecutive oks to clear
    help: str = ""

    def __post_init__(self) -> None:
        if self.kind not in ("threshold", "absence", "trend"):
            raise ValueError(f"rule {self.name}: unknown kind "
                             f"{self.kind!r}")
        if self.op not in _OPS:
            raise ValueError(f"rule {self.name}: unknown op {self.op!r}")


class _RuleState:
    __slots__ = ("active", "breaches", "oks", "history", "last_value",
                 "since")

    def __init__(self) -> None:
        self.active = False
        self.breaches = 0
        self.oks = 0
        self.history: Deque[float] = collections.deque()
        self.last_value: Optional[float] = None
        self.since: Optional[float] = None


class AlertEngine:
    """Evaluate rules over one hub; fire/clear with hysteresis."""

    def __init__(self, hub=None, rules: Optional[List[Rule]] = None,
                 clock=time.time) -> None:
        if hub is None:
            from paddlebox_tpu_torch.obs.hub import get_hub
            hub = get_hub()
        self.hub = hub
        self.clock = clock
        self.rules: List[Rule] = []
        self._state: Dict[str, _RuleState] = {}
        self._lock = threading.Lock()
        self._evals = 0
        self._fired_total = 0
        self._last_eval_ts: Optional[float] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        for r in rules or ():
            self.add_rule(r)

    def add_rule(self, rule: Rule) -> "AlertEngine":
        with self._lock:
            if any(r.name == rule.name for r in self.rules):
                raise ValueError(f"duplicate alert rule {rule.name!r}")
            self.rules.append(rule)
            self._state[rule.name] = _RuleState()
        return self

    # ---- sampling ------------------------------------------------------
    def _sample(self, rule: Rule) -> Optional[float]:
        """Observe one value for ``rule`` (None == no samples)."""
        with self.hub._lock:
            inst = self.hub._instruments.get(rule.metric)
        if inst is None:
            return None
        if inst.kind == "histogram":
            if inst.series():
                q = rule.quantile if rule.quantile is not None else 0.99
                return inst.quantile(q, **rule.labels)
            return None
        # counters/gauges: sum every series whose labels contain the
        # rule's labels as a subset — a rule over a labeled counter
        # (e.g. pbox_pipeline_hangs_total{stage=...}) watches the total
        want = set((k, str(v)) for k, v in rule.labels.items())
        total, seen = 0.0, False
        for key, val in inst.series():
            if want <= set(key):
                total += float(val)
                seen = True
        return total if seen else None

    # ---- evaluation ----------------------------------------------------
    def evaluate_once(self) -> List[Dict]:
        """One evaluation sweep. Returns the transitions
        (``[{rule, severity, to, value, threshold}]``) and updates
        gauges/events; safe to call concurrently with the cadence
        thread (rule state is lock-protected)."""
        transitions: List[Dict] = []
        now = self.clock()
        with self._lock:
            rules = list(self.rules)
        for rule in rules:
            sample = self._sample(rule)
            with self._lock:
                st = self._state[rule.name]
                breach, value = self._judge(rule, st, sample)
                st.last_value = value
                if breach:
                    st.breaches += 1
                    st.oks = 0
                    if (not st.active
                            and st.breaches >= rule.for_count):
                        st.active = True
                        st.since = now
                        self._fired_total += 1
                        transitions.append(self._transition(
                            rule, "fired", value))
                else:
                    st.oks += 1
                    st.breaches = 0
                    if st.active and st.oks >= rule.clear_count:
                        st.active = False
                        st.since = None
                        transitions.append(self._transition(
                            rule, "cleared", value))
        with self._lock:
            self._evals += 1
            self._last_eval_ts = now
        # mirror EVERY rule's state each sweep (not just transitions):
        # dashboards must see an explicit 0 for a healthy rule — an
        # absent series is indistinguishable from an engine that
        # never ran
        gauge = self.hub.gauge(
            "pbox_alerts_active",
            "1 while the alert rule is firing, 0 when clear")
        with self._lock:
            states = [(r, self._state[r.name].active) for r in rules]
        for rule, active in states:
            gauge.set(1.0 if active else 0.0, rule=rule.name,
                      severity=rule.severity)
        for tr in transitions:
            self._publish(tr)
        return transitions

    @staticmethod
    def _judge(rule: Rule, st: _RuleState, sample: Optional[float]):
        """(breach?, observed value) for one rule given its sample."""
        if rule.kind == "absence":
            return sample is None, (0.0 if sample is None else sample)
        if sample is None:
            return False, None
        if rule.kind == "trend":
            st.history.append(sample)
            while len(st.history) > max(rule.trend_window, 2):
                st.history.popleft()
            if len(st.history) < 2:
                return False, 0.0
            delta = st.history[-1] - st.history[0]
            return _OPS[rule.op](delta, rule.value), delta
        return _OPS[rule.op](sample, rule.value), sample

    def _transition(self, rule: Rule, to: str, value) -> Dict:
        return {"rule": rule.name, "severity": rule.severity, "to": to,
                "value": value, "threshold": rule.value,
                "metric": rule.metric}

    #: rules whose fires are world-membership changes, not SLO breaches
    _MEMBERSHIP_RULE_NAMES = ("rank_dead", "world_degraded")

    def _publish(self, tr: Dict) -> None:
        hub = self.hub
        fired = tr["to"] == "fired"
        hub.gauge("pbox_alerts_active",
                  "1 per firing alert rule").set(
                      1.0 if fired else 0.0,
                      rule=tr["rule"], severity=tr["severity"])
        if fired:
            hub.counter("pbox_alerts_fired_total",
                        "alert rule fire transitions").inc(
                            rule=tr["rule"])
            log.error("ALERT fired: %s (%s) %s=%s threshold=%s",
                      tr["rule"], tr["severity"], tr["metric"],
                      tr["value"], tr["threshold"])
        else:
            log.warning("alert cleared: %s (%s=%s)", tr["rule"],
                        tr["metric"], tr["value"])
        if hub.active:
            hub.emit("alert_fired" if fired else "alert_cleared",
                     rule=tr["rule"], severity=tr["severity"],
                     metric=tr["metric"], value=tr["value"],
                     threshold=tr["threshold"])
        if fired:
            # every firing rule IS an SLO breach — flight-recorder
            # debounce collapses storms into one bundle per window.
            # Membership rules route to their own trigger so a world
            # change and a concurrent SLO breach each get a bundle.
            from paddlebox_tpu_torch.obs import flightrec
            trigger = ("membership_change"
                       if tr["rule"] in self._MEMBERSHIP_RULE_NAMES
                       else "slo_breach")
            flightrec.trigger(trigger,
                              reason=f"alert {tr['rule']}",
                              rule=tr["rule"], severity=tr["severity"],
                              metric=tr["metric"], value=tr["value"],
                              threshold=tr["threshold"])

    # ---- surfaces ------------------------------------------------------
    def active(self) -> List[Dict]:
        with self._lock:
            out = []
            for rule in self.rules:
                st = self._state[rule.name]
                if st.active:
                    out.append({"rule": rule.name,
                                "severity": rule.severity,
                                "metric": rule.metric,
                                "value": st.last_value,
                                "threshold": rule.value,
                                "since": st.since})
            return out

    def status(self) -> Dict:
        """The ``alerts`` block for /healthz and the /alertz payload."""
        with self._lock:
            rules = [{"rule": r.name, "kind": r.kind,
                      "severity": r.severity, "metric": r.metric,
                      "threshold": r.value,
                      "active": self._state[r.name].active,
                      "value": self._state[r.name].last_value}
                     for r in self.rules]
            evals, fired = self._evals, self._fired_total
            last = self._last_eval_ts
        act = [r for r in rules if r["active"]]
        return {"firing": len(act), "active": act, "rules": rules,
                "evaluations": evals, "fired_total": fired,
                "last_eval_ts": last}

    # ---- cadence thread ------------------------------------------------
    def start(self, interval_sec: float) -> "AlertEngine":
        if self._thread is not None:
            return self
        self._stop.clear()

        def loop() -> None:
            while not self._stop.wait(interval_sec):
                try:
                    self.evaluate_once()
                except Exception:
                    log.error("alert evaluation failed", exc_info=True)

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="pbox-alerts")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=10)


def default_rules() -> List[Rule]:
    """The shipped rule set (docs/OBSERVABILITY.md §Alerts)."""
    from paddlebox_tpu_torch.config import FLAGS
    return [
        Rule("serving_staleness", "pbox_serving_staleness_sec",
             kind="threshold", severity="critical", op=">",
             value=float(FLAGS.serving_staleness_max_sec),
             help="serving snapshot older than the staleness SLO"),
        Rule("serving_p99", "pbox_serving_latency_seconds",
             kind="threshold", severity="critical", op=">",
             value=float(FLAGS.alerts_serving_p99_ms) / 1e3,
             labels={"op": "predict"}, quantile=0.99,
             help="predict p99 over the latency SLO"),
        Rule("stream_lag", "pbox_stream_lag_files",
             kind="threshold", severity="warn", op=">",
             value=float(FLAGS.alerts_stream_lag_files),
             help="stream backlog growing faster than training"),
        Rule("pipeline_hang", "pbox_pipeline_hangs_total",
             kind="trend", severity="critical", op=">", value=0.0,
             help="a pipeline wait hit the hang deadline since the "
                  "last evaluation"),
        Rule("nan_rollback", "pbox_nan_rollbacks_total",
             kind="trend", severity="critical", op=">", value=0.0,
             help="a NaN rollback happened since the last evaluation"),
        Rule("auc_degradation", "pbox_quality_degraded",
             kind="threshold", severity="critical", op=">", value=0.5,
             help="windowed AUC trend breached the degradation "
                  "threshold (obs/quality)"),
        # online-daemon lifecycle rules (docs/ONLINE.md): each fire is
        # a flight-recorder trigger like every other rule (_publish)
        Rule("shrink_overdue", "pbox_online_windows_since_shrink",
             kind="threshold", severity="warn", op=">",
             value=float(FLAGS.alerts_shrink_overdue_windows
                         or 2 * max(1, FLAGS.shrink_every_windows)),
             help="feature-lifecycle shrink cycles stopped firing — "
                  "the key space is growing unbounded"),
        Rule("backlog_growth", "pbox_stream_lag_files",
             kind="trend", severity="warn", op=">", value=0.0,
             trend_window=3, for_count=3,
             help="stream backlog rose across three consecutive "
                  "evaluations — ingest is outrunning training"),
        # elastic-membership rules (docs/RESILIENCE.md §Elastic
        # membership): routed to the membership_change flight-recorder
        # trigger in _publish
        Rule("rank_dead", "pbox_membership_scale_events_total",
             kind="trend", severity="critical", op=">", value=0.0,
             labels={"direction": "lost"},
             help="a rank left the effective membership since the "
                  "last evaluation (TTL expiry or watchdog eviction)"),
        Rule("world_degraded", "pbox_membership_degraded",
             kind="threshold", severity="warn", op=">", value=0.5,
             help="effective membership below the target np — the job "
                  "is running shrunk until the lost ranks rejoin"),
    ]


# ---- module-level engine (configure_from_flags) ------------------------
_ENGINE: Optional[AlertEngine] = None


def get_engine() -> Optional[AlertEngine]:
    return _ENGINE


def install_engine(engine: Optional[AlertEngine],
                   register_probe: bool = True) -> Optional[AlertEngine]:
    """Install the process alert engine (None uninstalls + stops) and
    register its ``status`` as the hub's alerts probe."""
    global _ENGINE
    if _ENGINE is not None and _ENGINE is not engine:
        _ENGINE.stop()
    _ENGINE = engine
    from paddlebox_tpu_torch.obs.hub import get_hub
    if register_probe:
        get_hub().set_alerts_probe(
            engine.status if engine is not None else None)
    return engine


def configure_from_flags() -> Optional[AlertEngine]:
    """Start the default-rule engine on the flag cadence (idempotent;
    called from ``obs.hub.configure_from_flags``)."""
    from paddlebox_tpu_torch.config import FLAGS
    if FLAGS.alerts_eval_interval_sec <= 0:
        return _ENGINE
    if _ENGINE is not None:
        return _ENGINE
    engine = AlertEngine(rules=default_rules())
    install_engine(engine)
    engine.start(FLAGS.alerts_eval_interval_sec)
    return engine
