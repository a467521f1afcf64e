"""The port's black-box observability layer against the JAX package's:
the cases of ``tests/test_obs_blackbox.py`` (flight-recorder bundle
contract, alert-engine rule semantics, quality-monitor windows, sink
fault isolation, JSONL rotation and the torn-tail reader, the strict
Prometheus round trip) and the port's ``tools/obs_check`` run as
``tests/test_obs_check.py`` runs the reference's. Where a case is a
pure function of its feed (alert transitions, bundle keys, quality
verdicts and calibration buckets, the Prometheus text) the reference
gets the same feed and must give the same answer."""

import dataclasses
import glob
import json
import os
import re

import pytest

import paddlebox_tpu.obs as J
from paddlebox_tpu.obs import flightrec as j_flightrec

from paddlebox_tpu_torch.config import FLAGS, flags_scope
from paddlebox_tpu_torch.obs import (AlertEngine, FlightRecorder,
                                     JsonlSink, MemorySink, Rule,
                                     default_rules, get_hub, reset_hub)
from paddlebox_tpu_torch.obs import flightrec
from paddlebox_tpu_torch.obs.instruments import (SERVING_LATENCY_BUCKETS,
                                                 escape_label_value)


@pytest.fixture()
def fresh_hub():
    J.reset_hub()
    hub = reset_hub()
    yield hub
    reset_hub()
    J.reset_hub()


# ---- flight recorder ---------------------------------------------------
def test_bundle_schema_and_ring(fresh_hub, tmp_path):
    rec = FlightRecorder(str(tmp_path), ring_events=4,
                         debounce_sec=600.0)
    flightrec.install_recorder(rec)
    hub = get_hub()
    for i in range(10):          # ring keeps only the newest 4
        hub.emit("tick", i=i)
    path = flightrec.trigger("manual", reason="unit", extra=7)
    assert path and os.path.isfile(path)
    b = json.load(open(path))
    assert b["schema"] == 1 and b["trigger"] == "manual"
    assert b["reason"] == "unit" and b["ctx"]["extra"] == 7
    ring = [e for e in b["ring"] if e.get("event") == "tick"]
    assert [e["i"] for e in ring] == [6, 7, 8, 9]
    assert b["threads"], "no live thread stacks captured"
    assert "flightrec_ring_events" in b["flags"]
    assert "passes_total" in b["health"]
    # the reference's bundle for the same feed has the same layout
    jrec = J.FlightRecorder(str(tmp_path / "ref"), ring_events=4,
                            debounce_sec=600.0)
    j_flightrec.install_recorder(jrec)
    for i in range(10):
        J.get_hub().emit("tick", i=i)
    jb = json.load(open(j_flightrec.trigger("manual", reason="unit",
                                            extra=7)))
    assert set(b) == set(jb)
    assert set(b["health"]) == set(jb["health"])
    assert [e["i"] for e in b["ring"] if e.get("event") == "tick"] \
        == [e["i"] for e in jb["ring"] if e.get("event") == "tick"]
    # the port's flags are a subset of the reference's, every
    # observability flag among them with the reference's default
    obs_flags = [k for k in jb["flags"] if k.startswith(
        ("telemetry_", "flightrec_", "quality_", "alerts_"))]
    assert obs_flags and set(obs_flags) <= set(b["flags"])
    assert {k: b["flags"][k] for k in obs_flags} \
        == {k: jb["flags"][k] for k in obs_flags}


def test_debounce_and_retention(fresh_hub, tmp_path):
    rec = FlightRecorder(str(tmp_path), debounce_sec=600.0, keep=2)
    flightrec.install_recorder(rec)
    hub = get_hub()
    assert flightrec.trigger("manual", reason="first")
    assert flightrec.trigger("manual", reason="storm") is None
    assert hub.counter("pbox_flightrec_suppressed_total",
                       "").value(trigger="manual") == 1.0
    # distinct triggers debounce independently
    assert flightrec.trigger("pipeline_hang", reason="x")
    assert flightrec.trigger("nan_rollback", reason="y")
    # keep=2: the oldest bundle was swept
    names = [os.path.basename(p) for p in rec.bundles()]
    assert len(names) == 2
    assert names == sorted(names)  # lexical order == age order
    assert "manual" not in "".join(names)


def test_unknown_trigger_rejected(fresh_hub, tmp_path):
    rec = FlightRecorder(str(tmp_path))
    with pytest.raises(ValueError, match="unknown flight-recorder"):
        rec.trigger("not_a_trigger")
    # the MODULE seam never raises — anomaly paths call it bare
    flightrec.install_recorder(rec)
    assert flightrec.trigger("not_a_trigger") is None


def test_trigger_without_recorder_is_noop(fresh_hub):
    assert flightrec.get_recorder() is None
    assert flightrec.trigger("manual", reason="nobody home") is None
    assert not fresh_hub.active


def test_configure_from_flags_installs_once(fresh_hub, tmp_path):
    with flags_scope(flightrec_dir=str(tmp_path)):
        rec = flightrec.configure_from_flags()
        assert rec is not None and flightrec.get_recorder() is rec
        assert flightrec.configure_from_flags() is rec  # idempotent
        assert fresh_hub.active  # recorder sink activates the hub
    reset_hub()
    assert flightrec.get_recorder() is None  # reset detaches


def test_hub_dump_blackbox(fresh_hub, tmp_path):
    rec = FlightRecorder(str(tmp_path))
    flightrec.install_recorder(rec)
    fresh_hub.dump_blackbox("operator said so")
    names = [os.path.basename(p) for p in rec.bundles()]
    assert names == ["blackbox-00001-manual.json"]
    mem = MemorySink()
    fresh_hub.add_sink(mem)
    fresh_hub.dump_blackbox("again")  # debounced: no second bundle
    assert len(rec.bundles()) == 1


# ---- alert engine ------------------------------------------------------
def _threshold_feed(mod, hub):
    """The hysteresis feed on one package: every sweep's transitions."""
    eng = mod.AlertEngine(hub, clock=lambda: 100.0)
    eng.add_rule(mod.Rule(name="lag", metric="lag_files",
                          kind="threshold", op=">", value=10.0,
                          for_count=2, clear_count=2))
    g = hub.gauge("lag_files", "")
    out = []
    for v in (50.0, 50.0, 0.0, 0.0):
        g.set(v)
        out.append([{k: v for k, v in t.items() if k != "ts"}
                    for t in eng.evaluate_once()])
    return out


def test_threshold_rule_transitions_match_reference(fresh_hub):
    got = _threshold_feed(__import__("paddlebox_tpu_torch.obs",
                                     fromlist=["AlertEngine"]), fresh_hub)
    assert got == _threshold_feed(J, J.get_hub())
    assert [[t["to"] for t in sweep] for sweep in got] \
        == [[], ["fired"], [], ["cleared"]]


def test_threshold_rule_hysteresis(fresh_hub):
    clk = [100.0]
    eng = AlertEngine(fresh_hub, clock=lambda: clk[0])
    eng.add_rule(Rule(name="lag", metric="lag_files", kind="threshold",
                      op=">", value=10.0, for_count=2, clear_count=2))
    g = fresh_hub.gauge("lag_files", "")
    mem = MemorySink()
    fresh_hub.add_sink(mem)
    g.set(50.0)
    assert eng.evaluate_once() == []      # for_count=2: not yet
    trs = eng.evaluate_once()             # second breach fires
    assert [(t["rule"], t["to"]) for t in trs] == [("lag", "fired")]
    assert fresh_hub.gauge("pbox_alerts_active", "").value(
        rule="lag", severity="warn") == 1.0
    g.set(0.0)
    assert eng.evaluate_once() == []      # clear_count=2: not yet
    trs = eng.evaluate_once()
    assert [(t["rule"], t["to"]) for t in trs] == [("lag", "cleared")]
    assert fresh_hub.gauge("pbox_alerts_active", "").value(
        rule="lag", severity="warn") == 0.0
    evs = [e["event"] for e in mem.events
           if e["event"].startswith("alert_")]
    assert evs == ["alert_fired", "alert_cleared"]
    assert fresh_hub.counter("pbox_alerts_fired_total",
                             "").value(rule="lag") == 1.0


def test_absence_rule(fresh_hub):
    eng = AlertEngine(fresh_hub)
    eng.add_rule(Rule(name="gone", metric="heartbeat_ts",
                      kind="absence"))
    trs = eng.evaluate_once()             # metric never booked → fires
    assert [(t["rule"], t["to"]) for t in trs] == [("gone", "fired")]
    fresh_hub.gauge("heartbeat_ts", "").set(1.0)
    trs = eng.evaluate_once()
    assert [(t["rule"], t["to"]) for t in trs] == [("gone", "cleared")]


def test_trend_rule_on_counter(fresh_hub):
    eng = AlertEngine(fresh_hub)
    eng.add_rule(Rule(name="hangs", metric="hangs_total", kind="trend",
                      op=">", value=0.0, trend_window=2))
    c = fresh_hub.counter("hangs_total", "")
    c.inc(n=0)
    assert eng.evaluate_once() == []      # flat baseline
    c.inc(stage="endpass")
    trs = eng.evaluate_once()             # delta over window > 0
    assert [(t["rule"], t["to"]) for t in trs] == [("hangs", "fired")]
    trs = eng.evaluate_once()             # flat again → clears
    assert [(t["rule"], t["to"]) for t in trs] == [("hangs", "cleared")]


def test_histogram_quantile_rule(fresh_hub):
    eng = AlertEngine(fresh_hub)
    eng.add_rule(Rule(name="p99", metric="lat_seconds",
                      kind="threshold", op=">", value=0.5,
                      quantile=0.99, labels={"op": "predict"}))
    h = fresh_hub.histogram("lat_seconds", "",
                            buckets=SERVING_LATENCY_BUCKETS)
    for _ in range(10):
        h.observe(0.9, op="predict")
    assert [t["to"] for t in eng.evaluate_once()] == ["fired"]
    for _ in range(5000):
        h.observe(0.0002, op="predict")
    assert [t["to"] for t in eng.evaluate_once()] == ["cleared"]


def test_label_subset_sampling(fresh_hub):
    # a rule with labels {"stage": "x"} sums only matching series
    eng = AlertEngine(fresh_hub)
    eng.add_rule(Rule(name="sx", metric="work_total", kind="threshold",
                      op=">", value=5.0, labels={"stage": "x"}))
    c = fresh_hub.counter("work_total", "")
    c.inc(100, stage="y")                 # non-matching series only
    assert eng.evaluate_once() == []
    c.inc(6, stage="x", shard="0")        # superset labels DO match
    assert [t["rule"] for t in eng.evaluate_once()] == ["sx"]


def test_alert_fire_triggers_blackbox(fresh_hub, tmp_path):
    rec = FlightRecorder(str(tmp_path), debounce_sec=600.0)
    flightrec.install_recorder(rec)
    eng = AlertEngine(fresh_hub)
    eng.add_rule(Rule(name="a", metric="m1", kind="threshold", op=">",
                      value=1.0))
    eng.add_rule(Rule(name="b", metric="m2", kind="threshold", op=">",
                      value=1.0))
    fresh_hub.gauge("m1", "").set(9.0)
    fresh_hub.gauge("m2", "").set(9.0)
    eng.evaluate_once()                   # both fire in one sweep
    names = [os.path.basename(p) for p in rec.bundles()]
    assert names == ["blackbox-00001-slo_breach.json"]  # debounced


def test_duplicate_rule_rejected(fresh_hub):
    eng = AlertEngine(fresh_hub)
    eng.add_rule(Rule(name="r", metric="m", kind="threshold"))
    with pytest.raises(ValueError, match="duplicate"):
        eng.add_rule(Rule(name="r", metric="m", kind="threshold"))
    with pytest.raises(ValueError):
        Rule(name="bad", metric="m", kind="nope")
    with pytest.raises(ValueError):
        Rule(name="bad", metric="m", kind="threshold", op="!=")


def test_default_rules_cover_the_slos():
    names = {r.name for r in default_rules()}
    assert [dataclasses.astuple(r) for r in default_rules()] \
        == [dataclasses.astuple(r) for r in J.default_rules()]
    assert names == {"serving_staleness", "serving_p99", "stream_lag",
                     "pipeline_hang", "nan_rollback",
                     "auc_degradation", "shrink_overdue",
                     "backlog_growth", "rank_dead", "world_degraded"}


def test_alertz_route_and_healthz_block(fresh_hub):
    import urllib.request
    eng = AlertEngine(fresh_hub, rules=default_rules())
    fresh_hub.set_alerts_probe(eng.status)
    fresh_hub.gauge("pbox_serving_staleness_sec", "").set(1e4)
    eng.evaluate_once()
    srv = fresh_hub.start_prom_http(0)
    try:
        port = srv.server_address[1]
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/alertz")
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(req, timeout=5)
        assert ei.value.code == 503       # firing alert → 503
        az = json.loads(ei.value.read())
        assert az["firing"] == 1
        assert az["active"][0]["rule"] == "serving_staleness"
        hz = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{port}/healthz", timeout=5).read())
        assert hz["alerts"]["firing"] == 1
        fresh_hub.gauge("pbox_serving_staleness_sec", "").set(0.0)
        eng.evaluate_once()
        az = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{port}/alertz", timeout=5).read())
        assert az["firing"] == 0 and len(az["rules"]) == 10
    finally:
        srv.shutdown()


# ---- sink fault isolation ----------------------------------------------
class _CrashingSink:
    def __init__(self, after=0):
        self.after = after
        self.calls = 0

    def emit(self, ev):
        self.calls += 1
        if self.calls > self.after:
            raise RuntimeError("sink exploded")


def test_crashing_sink_is_isolated_and_quarantined(fresh_hub):
    good = MemorySink()
    bad = _CrashingSink()
    fresh_hub.add_sink(good)
    fresh_hub.add_sink(bad)
    limit = FLAGS.telemetry_sink_errors_max
    for i in range(limit + 5):
        fresh_hub.emit("tick", i=i)
    # the good sink saw EVERY event despite the crashing neighbour
    assert len([e for e in good.events if e["event"] == "tick"]) \
        == limit + 5
    assert fresh_hub.counter("pbox_sink_errors_total", "").value(
        sink="_CrashingSink") == float(limit)
    assert fresh_hub.counter("pbox_sinks_quarantined_total", "").value(
        sink="_CrashingSink") == 1.0
    assert bad.calls == limit             # removed after N failures


def test_sink_failure_count_resets_on_success(fresh_hub):
    flaky = _CrashingSink(after=0)
    fresh_hub.add_sink(flaky)
    limit = FLAGS.telemetry_sink_errors_max
    for i in range(limit - 1):            # one short of quarantine
        fresh_hub.emit("tick", i=i)
    flaky.after = 10 ** 9                 # heals
    fresh_hub.emit("tick", i=-1)          # success resets the streak
    flaky.after = 0                       # breaks again
    for i in range(limit - 1):
        fresh_hub.emit("tick", i=i)
    assert fresh_hub.counter("pbox_sinks_quarantined_total", "").value(
        sink="_CrashingSink") == 0.0      # never hit N CONSECUTIVE


# ---- JSONL rotation + torn tail ----------------------------------------
def test_jsonl_rotation_keeps_k_and_reads_in_order(fresh_hub, tmp_path):
    from paddlebox_tpu_torch.tools.telemetry_report import expand_rotated, load_events
    path = str(tmp_path / "ev.jsonl")
    sink = JsonlSink(path, max_bytes=1500, keep=2)
    for i in range(120):
        sink.emit({"event": "tick", "i": i, "pad": "x" * 40})
    sink.close()
    files = sorted(os.path.basename(f) for f in glob.glob(path + "*"))
    assert files == ["ev.jsonl", "ev.jsonl.1", "ev.jsonl.2"]
    assert expand_rotated(path) == [path + ".2", path + ".1", path]
    seq = [e["i"] for e in load_events(path)]
    assert seq == sorted(seq)             # oldest-first across segments
    assert seq[-1] == 119                 # newest event survives


def test_rotation_via_flags(tmp_path):
    path = str(tmp_path / "t.jsonl")
    with flags_scope(telemetry_jsonl=path, telemetry_jsonl_max_mb=0.001,
                     telemetry_jsonl_keep=2):
        from paddlebox_tpu_torch.obs import hub as hub_mod
        hub = hub_mod.configure_from_flags()
        for i in range(2000):
            hub.emit("tick", i=i, pad="y" * 50)
    reset_hub()
    assert os.path.exists(path + ".1"), "flag-driven rotation inert"


def test_report_tolerates_torn_final_line(tmp_path, capsys):
    from paddlebox_tpu_torch.tools.telemetry_report import load_events
    path = str(tmp_path / "ev.jsonl")
    with open(path, "w") as fh:
        fh.write('{"event": "a", "ts": 1}\n')
        fh.write('{"event": "b", "ts"')   # writer killed mid-write
    evs = load_events(path)
    assert [e["event"] for e in evs] == ["a"]
    assert "torn" in capsys.readouterr().err.lower()
    # a torn line in the MIDDLE (append landed after it) is also
    # skipped, and the events around it survive
    with open(path, "a") as fh:
        fh.write('\n{"event": "c", "ts": 3}\n')
    evs = load_events(path)
    assert [e["event"] for e in evs] == ["a", "c"]


# ---- strict Prometheus round-trip --------------------------------------
_SAMPLE_RE = re.compile(
    r'^([a-zA-Z_:][a-zA-Z0-9_:]*)'
    r'(?:\{((?:[a-zA-Z_][a-zA-Z0-9_]*="(?:[^"\\\n]|\\["\\n])*",?)*)\})?'
    r' (-?(?:[0-9.]+(?:e[+-]?[0-9]+)?|inf)|nan)$', re.IGNORECASE)
_LABEL_RE = re.compile(
    r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\\n]|\\["\\n])*)"')


def _strict_parse(text):
    """A deliberately strict text-format parser: every sample line must
    match the exposition grammar exactly (escaped label values only),
    every sample must belong to a declared # TYPE family, and no series
    may repeat. Returns {family: {(suffix_name, labelset): value}}."""
    types, samples = {}, {}
    for ln in text.splitlines():
        if not ln:
            continue
        if ln.startswith("# HELP "):
            continue
        if ln.startswith("# TYPE "):
            _, _, name, kind = ln.split(" ", 3)
            assert kind in ("counter", "gauge", "histogram", "untyped")
            assert name not in types, f"family {name} declared twice"
            types[name] = kind
            continue
        assert not ln.startswith("#"), f"junk comment line: {ln!r}"
        m = _SAMPLE_RE.match(ln)
        assert m, f"unparseable sample line: {ln!r}"
        name, labels_raw, val = m.groups()
        labels = tuple(_LABEL_RE.findall(labels_raw or ""))
        fam = name
        for suf in ("_bucket", "_sum", "_count"):
            if name.endswith(suf) and name[:-len(suf)] in types:
                fam = name[:-len(suf)]
        assert fam in types, f"sample {name} has no # TYPE declaration"
        if types[fam] == "histogram":
            assert fam != name, \
                f"bare sample {name} inside histogram family"
        key = (name, labels)
        assert key not in samples.get(fam, {}), f"dup series {key}"
        samples.setdefault(fam, {})[key] = float(val)
    return types, samples


def test_prom_round_trip_all_families(fresh_hub):
    hub = fresh_hub
    hub.counter("rt_total", "a counter").inc(3, shard="0")
    hub.counter("rt_total", "").inc(2, shard="1")
    hub.gauge("rt_depth", "a gauge").set(7.5, queue="q\\weird\"n\nv")
    h = hub.histogram("rt_lat_seconds", "a histogram",
                      buckets=(0.01, 0.1, 1.0))
    for v in (0.005, 0.05, 0.5, 2.0):
        h.observe(v, op="predict")
    # the alert gauge family the dashboards scrape
    eng = AlertEngine(hub)
    eng.add_rule(Rule(name="r1", metric="rt_depth", kind="threshold",
                      op=">", value=1.0))
    eng.evaluate_once()
    from paddlebox_tpu_torch.utils.monitor import STATS
    STATS.add("legacy \"stat\"", 4)       # pbox_stat bridge escaping
    types, samples = _strict_parse(hub.snapshot_prom())

    assert types["rt_total"] == "counter"
    assert types["rt_depth"] == "gauge"
    assert types["rt_lat_seconds"] == "histogram"
    assert types["rt_lat_seconds_quantile"] == "gauge"
    assert types["pbox_alerts_active"] == "gauge"
    # counter series survive with labels intact
    vals = {lbls: v for (n, lbls), v in samples["rt_total"].items()}
    assert vals[(("shard", "0"),)] == 3.0
    assert vals[(("shard", "1"),)] == 2.0
    # the hostile label value round-trips through escaping
    (key, v), = samples["rt_depth"].items()
    assert v == 7.5
    assert dict(key[1])["queue"] == 'q\\\\weird\\"n\\nv'
    # histogram: buckets cumulative, +Inf == count, sum preserved
    hs = samples["rt_lat_seconds"]
    bkt = {dict(lbls)["le"]: v for (n, lbls), v in hs.items()
           if n.endswith("_bucket")}
    assert bkt["0.01"] == 1.0 and bkt["0.1"] == 2.0
    assert bkt["1.0"] == 3.0 and bkt["+Inf"] == 4.0
    (cnt,) = [v for (n, _), v in hs.items() if n.endswith("_count")]
    assert cnt == 4.0
    # _quantile sibling family carries p50/p90/p99 for the labelset
    qs = {dict(lbls)["quantile"]
          for (n, lbls), v in samples["rt_lat_seconds_quantile"].items()}
    assert qs == {"0.5", "0.9", "0.99"}
    # alert gauge exposes rule + severity labels
    (akey, av), = samples["pbox_alerts_active"].items()
    assert dict(akey[1]) == {"rule": "r1", "severity": "warn"}
    assert av == 1.0
    # legacy bridge escaped the hostile stat name
    stat_lbls = [dict(lbls)["name"]
                 for (n, lbls), v in samples["pbox_stat"].items()]
    assert 'legacy \\"stat\\"' in stat_lbls


def test_escape_label_value():
    assert escape_label_value('a"b') == 'a\\"b'
    assert escape_label_value("a\\b") == "a\\\\b"
    assert escape_label_value("a\nb") == "a\\nb"
    assert escape_label_value("plain") == "plain"


# ---- quality monitor ---------------------------------------------------
def test_quality_auc_trend_and_degraded_verdict(fresh_hub):
    from paddlebox_tpu.obs.quality import QualityMonitor as JMon
    from paddlebox_tpu_torch.obs.quality import QualityMonitor
    mon = QualityMonitor(window=4, auc_drop=0.01)
    jmon = JMon(window=4, auc_drop=0.01)
    mem = MemorySink()
    fresh_hub.add_sink(mem)
    out = None
    for p, auc in enumerate((0.80, 0.80, 0.70, 0.70)):
        ev = {"kind": "train_pass", "pass_id": p, "auc": auc}
        out = mon.note_pass(ev, hub=fresh_hub)
        assert out == jmon.note_pass(ev, hub=J.get_hub())
    assert out["degraded"] is True        # trailing half clearly worse
    assert out["auc_trend"] == pytest.approx(-0.10)
    assert fresh_hub.gauge("pbox_quality_degraded", "").value() == 1.0
    for p, auc in enumerate((0.70, 0.70, 0.70, 0.70), start=4):
        out = mon.note_pass({"kind": "train_pass", "pass_id": p,
                             "auc": auc}, hub=fresh_hub)
    assert out["degraded"] is False       # flat window: verdict clears
    assert len([e for e in mem.events
                if e["event"] == "quality_window"]) == 8


def test_quality_calibration_buckets(fresh_hub):
    """The port's AUC tables through the port's monitor give the
    reference's calibration buckets for the same predictions."""
    import jax.numpy as jnp
    import torch
    from paddlebox_tpu.metrics import auc_add_batch as j_add
    from paddlebox_tpu.metrics import init_auc_state as j_init
    from paddlebox_tpu.obs.quality import QualityMonitor as JMon
    from paddlebox_tpu_torch.metrics import auc_add_batch, init_auc_state
    from paddlebox_tpu_torch.obs.quality import QualityMonitor
    preds = [0.1] * 50 + [0.9] * 50
    labels = [0.0] * 50 + [1.0] * 50
    st = auc_add_batch(init_auc_state(device="cpu"),
                       torch.tensor(preds), torch.tensor(labels),
                       torch.ones(100))
    jst = j_add(j_init(), jnp.asarray(preds, dtype=jnp.float32),
                jnp.asarray(labels, dtype=jnp.float32), jnp.ones(100))
    ev = {"kind": "train_pass", "pass_id": 0, "auc": 0.9,
          "actual_ctr": 0.5, "predicted_ctr": 0.5}
    out = QualityMonitor(window=2, calib_buckets=4).note_pass(
        ev, auc_state=st, hub=fresh_hub)
    assert out == JMon(window=2, calib_buckets=4).note_pass(
        ev, auc_state=jst, hub=J.get_hub())
    calib = {c["bucket"]: c for c in out["calibration"]}
    lo = min(calib), max(calib)
    # the low-pred bucket observed ~0 CTR, the high-pred bucket ~1
    assert calib[lo[0]]["observed_ctr"] == pytest.approx(0.0)
    assert calib[lo[1]]["observed_ctr"] == pytest.approx(1.0)
    assert calib[lo[1]]["pred_ctr"] > calib[lo[0]]["pred_ctr"]


def test_quality_pass_seam_inert_when_off(fresh_hub):
    from paddlebox_tpu_torch.obs import quality
    from paddlebox_tpu_torch.obs.hub import emit_pass_event
    mem = MemorySink()
    fresh_hub.add_sink(mem)
    assert FLAGS.quality_window_passes == 0  # the default
    emit_pass_event("train_pass", {"auc": 0.8, "batches": 1,
                                   "examples": 32})
    assert quality.get_monitor() is None
    assert not [e for e in mem.events if e["event"] == "quality_window"]
    with flags_scope(quality_window_passes=2):
        emit_pass_event("train_pass", {"auc": 0.8, "batches": 1,
                                       "examples": 32})
        emit_pass_event("eval_pass", {"auc": 0.8})  # wrong kind: no-op
    assert len([e for e in mem.events
                if e["event"] == "quality_window"]) == 1


# ---- the black-box gate (tools/obs_check) ------------------------------
def test_obs_check_gate_deterministic(tmp_path):
    """The port's gate, run as ``tests/test_obs_check.py`` runs the
    reference's: one bundle per anomaly class, every default rule fires
    and clears, rotation and the torn tail hold, the routes serve, the
    inert layer stays cheap, and two seeded runs agree."""
    from paddlebox_tpu_torch.tools.obs_check import run_obs_check
    outs = []
    for run in (1, 2):
        wd = str(tmp_path / f"run{run}")
        os.makedirs(wd)
        outs.append(run_obs_check(wd, seed=7, device="cpu"))
    out = outs[0]
    assert out["quality_windows"] == 3
    assert out["quality_degraded_flag_seen"]
    assert "pbox_quality_auc_trend" in out["quality_instruments"]
    assert "pbox_quality_key_churn_frac" in out["quality_instruments"]
    assert "pbox_quality_embed_norm" in out["quality_instruments"]
    assert out["nan_retried_and_recovered"]
    assert out["nan_rollbacks_total"] == 1.0
    assert out["corrupt_tip_not_adopted"] and out["corrupt_refused_loud"]
    assert out["hang_raised"]
    assert out["one_bundle_per_trigger"] and out["bundles_schema_ok"]
    assert out["bundle_triggers"] == [
        "nan_rollback", "reload_degrade", "pipeline_hang",
        "slo_breach", "membership_change", "manual"]
    assert out["bundles"] == sorted(out["bundles"])
    assert out["slo_breach_suppressed"] >= 1.0
    assert out["alerts_baseline_clean"]
    assert out["alerts_all_fired_and_cleared"]
    assert out["alerts_none_left_firing"]
    assert all(v >= 1.0 for v in out["alerts_fired_total"].values())
    assert len(out["rotated_set"]) == 3
    assert out["rotation_oldest_first"] and out["torn_tail_skipped"]
    assert out["alertz_ok"] and out["healthz_alerts_block"]
    assert out["metrics_expose_alerts"] and out["metrics_expose_bundles"]
    assert out["inert_hub_inactive"] and out["still_inactive_after"]
    assert out["inert_no_recorder"] and out["overhead_ok"]
    assert outs[0] == outs[1]
    # the alert transitions are the reference gate's
    from scripts.obs_check import _run_alerts_leg
    ref = {}
    J.reset_hub()
    try:
        _run_alerts_leg(ref)
    finally:
        J.reset_hub()
    assert out["alert_transitions"] == ref["alert_transitions"]


def test_bundle_keys_frozen():
    from scripts.obs_check import BUNDLE_KEYS as REF_KEYS
    from paddlebox_tpu_torch.tools.obs_check import BUNDLE_KEYS
    assert BUNDLE_KEYS == REF_KEYS == frozenset((
        "schema", "trigger", "reason", "ctx", "ts", "run", "health",
        "ring", "instruments", "critical_path", "flags", "threads"))
