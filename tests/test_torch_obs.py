"""The port's observability layer (``paddlebox_tpu_torch/obs``) against
the JAX package's (``paddlebox_tpu/obs``): the cases of
``tests/test_obs.py`` (all but ``test_make_straggler_watchdog_single_
process``, which waits for ``train/multihost.py`` and
``torch.distributed``), each holding the port to the reference on the
same feeds, plus the trainer parity, hub-on and dispatch-label cases.

Exact parity, given identical feeds: instrument semantics, histogram
quantiles and the Prometheus text, watchdog reports, the
``telemetry_report`` rows. The trainer case runs the reference test's
``tiny_trainer_run`` configuration (CtrDnn (16,), seeded criteo files)
through both packages: pass event names and field keys, work counters
and stage names equal, and the two reports render the same rows once
the clock columns are removed. Device fields (``hbm``: zeros on the CPU
in both) are compared by key only; the port's resident pass event also
carries ``last_loss``, which its result has and the reference's lacks. Dispatch counts: the reference books
once per compiled program, the port once per launch, so the label sets
are compared and the counts only against the port's ``.launches``."""

import gc
import importlib.util
import json
import os
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

from paddlebox_tpu.obs import reset_hub as j_reset_hub
from paddlebox_tpu.obs import instruments as j_instruments
from paddlebox_tpu.obs import watchdog as j_watchdog

from paddlebox_tpu_torch.obs import (DirHeartbeatStore, JsonlSink,
                                     LocalHeartbeatStore, MemorySink,
                                     StragglerTimeout, StragglerWatchdog,
                                     TelemetryHub, reset_hub)
from paddlebox_tpu_torch.obs import instruments as p_instruments
from paddlebox_tpu_torch.obs.hub import emit_pass_event
from paddlebox_tpu_torch.obs.instruments import Histogram
from paddlebox_tpu_torch.utils.channel import (Channel,
                                               channel_stats_snapshot,
                                               reset_channel_stats)

ROOT = os.path.join(os.path.dirname(__file__), os.pardir)


@pytest.fixture()
def fresh_hub():
    j_reset_hub()
    hub = reset_hub()
    yield hub
    reset_hub()
    j_reset_hub()


def _ref_report():
    spec = importlib.util.spec_from_file_location(
        "telemetry_report_ref",
        os.path.join(ROOT, "scripts", "telemetry_report.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---- instruments -------------------------------------------------------
def _counter_feed(mod):
    c = mod.Counter("req_total")
    c.inc()
    c.inc(2.5)
    c.inc(1, shard=0)
    c.inc(2, shard=0)
    c.inc(5, shard=1)
    return c


def test_counter_semantics():
    c = _counter_feed(p_instruments)
    assert c.value() == 3.5
    assert c.value(shard=0) == 3 and c.value(shard=1) == 5
    with pytest.raises(ValueError):
        c.inc(-1)
    assert c.series() == _counter_feed(j_instruments).series()


def _gauge_feed(mod):
    g = mod.Gauge("depth")
    out = []
    for op, v in (("set", 7), ("set", 3), ("set_max", 1),
                  ("set_max", 10)):
        getattr(g, op)(v)
        out.append(g.value())
    g.inc(2, host=1)
    g.inc(3, host=1)
    out.append(g.value(host=1))
    return out


def test_gauge_semantics():
    out = _gauge_feed(p_instruments)
    assert out == [7, 3, 3, 10, 5]
    assert out == _gauge_feed(j_instruments)


def test_histogram_semantics():
    h = Histogram("lat", buckets=(0.1, 1.0, 10.0))
    jh = j_instruments.Histogram("lat", buckets=(0.1, 1.0, 10.0))
    for v in (0.05, 0.5, 0.5, 5.0, 50.0):
        h.observe(v)
        jh.observe(v)
    s = h.snapshot()
    assert s["count"] == 5
    assert s["sum"] == pytest.approx(56.05)
    assert s["buckets"][0.1] == 1
    assert s["buckets"][1.0] == 3
    assert s["buckets"][10.0] == 4
    assert s == jh.snapshot()


def _quantile_feed(mod):
    h = mod.Histogram("lat", buckets=(0.001, 0.01, 0.1, 1.0))
    for v, n in ((0.0005, 50), (0.005, 40), (0.05, 10)):
        for _ in range(n):
            h.observe(v)
    h.observe(0.5, op="predict")
    h2 = mod.Histogram("of", buckets=(0.1, 1.0))
    for _ in range(10):
        h2.observe(50.0)
    return [h.quantile(q) for q in (0.5, 0.9, 0.99)] + [
        h.quantile(0.5, op="predict"), h.quantile(0.99, op="predict"),
        h.quantile(0.5, op="nope"), h2.quantile(0.99)]


def test_histogram_quantiles():
    q = _quantile_feed(p_instruments)
    assert q[0] == pytest.approx(0.001)
    assert q[1] == pytest.approx(0.01)
    assert q[2] == pytest.approx(0.01 + 0.09 * 0.9)
    assert q[3] == pytest.approx(0.55)
    assert q[4] == pytest.approx(0.991)
    assert q[5] == 0.0
    assert q[6] == pytest.approx(1.0)
    assert q == _quantile_feed(j_instruments)
    h = Histogram("lat")
    with pytest.raises(ValueError):
        h.quantile(0.0)
    with pytest.raises(ValueError):
        h.quantile(1.5)


def _prom_quantile_text(mod):
    h = mod.Histogram("pbox_lat_seconds", "latency",
                      buckets=(0.001, 0.01, 0.1))
    for _ in range(99):
        h.observe(0.005, op="lookup")
    h.observe(0.05, op="lookup")
    return h, "\n".join(mod.iter_prom_lines(h))


def test_histogram_prom_quantile_lines():
    h, text = _prom_quantile_text(p_instruments)
    assert text == _prom_quantile_text(j_instruments)[1]
    assert "# TYPE pbox_lat_seconds histogram" in text
    assert 'pbox_lat_seconds_bucket{op="lookup",le="0.01"} 99' in text
    assert 'pbox_lat_seconds_bucket{op="lookup",le="+Inf"} 100' in text
    assert "# TYPE pbox_lat_seconds_quantile gauge" in text
    q50 = h.quantile(0.5, op="lookup")
    q99 = h.quantile(0.99, op="lookup")
    assert (f'pbox_lat_seconds_quantile{{op="lookup",quantile="0.5"}} '
            f"{q50:g}") in text
    assert (f'pbox_lat_seconds_quantile{{op="lookup",quantile="0.99"}} '
            f"{q99:g}") in text
    assert 'pbox_lat_seconds_count{op="lookup"} 100' in text
    assert text.index("# TYPE pbox_lat_seconds_quantile gauge") \
        > text.index("pbox_lat_seconds_count")


def test_instrument_kind_collision(fresh_hub):
    fresh_hub.counter("x_total")
    with pytest.raises(TypeError):
        fresh_hub.gauge("x_total")
    assert fresh_hub.counter("x_total") is fresh_hub.counter("x_total")


# ---- sinks + events ----------------------------------------------------
def test_jsonl_sink_roundtrip(tmp_path, fresh_hub):
    path = str(tmp_path / "run.jsonl")
    fresh_hub.add_sink(JsonlSink(path))
    assert fresh_hub.active
    for i in range(5):
        fresh_hub.emit("tick", i=i, note="x" * i)
    fresh_hub.close_sinks()
    assert not fresh_hub.active
    lines = open(path).read().splitlines()
    assert len(lines) == 5
    evs = [json.loads(l) for l in lines]  # noqa: E741
    assert [e["i"] for e in evs] == list(range(5))
    ts = [e["ts"] for e in evs]
    seqs = [e["seq"] for e in evs]
    assert ts == sorted(ts)
    assert seqs == sorted(seqs) and len(set(seqs)) == 5
    assert all(e["event"] == "tick" and "run" in e for e in evs)
    # the event's envelope keys are the reference's; proc is 0 without
    # an initialized process group
    assert set(evs[0]) == {"ts", "seq", "event", "run", "proc", "i",
                           "note"}
    assert evs[0]["proc"] == 0


def test_no_sink_fast_path(fresh_hub):
    assert not fresh_hub.active
    emit_pass_event("train_pass", {"batches": 1, "elapsed_sec": 1.0})
    assert fresh_hub.snapshot() == {}


def _prom_feed(hub):
    """The feed's exposition without the legacy ``pbox_stat`` bridge
    (each package's process-wide stat registry holds what earlier tests
    in the process booked)."""
    hub.counter("pbox_req_total", "requests").inc(3, kind="a")
    hub.gauge("pbox_depth").set(2.5)
    h = hub.histogram("pbox_lat_seconds", buckets=(0.5, 1.0))
    for v in (0.2, 0.7, 7.0):
        h.observe(v)
    return "\n".join(ln for ln in hub.snapshot_prom().splitlines()
                     if "pbox_stat" not in ln)


def test_prom_exposition(fresh_hub):
    from paddlebox_tpu.obs.hub import get_hub as j_get_hub
    text = _prom_feed(fresh_hub)
    assert text == _prom_feed(j_get_hub())
    assert "# TYPE pbox_req_total counter" in text
    assert 'pbox_req_total{kind="a"} 3' in text
    assert "# TYPE pbox_depth gauge" in text
    assert "pbox_depth 2.5" in text
    assert 'pbox_lat_seconds_bucket{le="0.5"} 1' in text
    assert 'pbox_lat_seconds_bucket{le="1.0"} 2' in text
    assert 'pbox_lat_seconds_bucket{le="+Inf"} 3' in text
    assert "pbox_lat_seconds_count 3" in text
    from paddlebox_tpu_torch.utils.monitor import STATS
    STATS.set("obs_test_stat", 42)
    try:
        assert 'pbox_stat{name="obs_test_stat"} 42' \
            in fresh_hub.snapshot_prom()
    finally:
        STATS.reset("obs_test_stat")


def test_prom_http_endpoint(fresh_hub):
    fresh_hub.counter("pbox_http_total").inc(7)
    srv = fresh_hub.start_prom_http(0)
    try:
        port = srv.server_address[1]
        body = urllib.request.urlopen(
            f"http://127.0.0.1:{port}/metrics", timeout=5).read().decode()
        assert "pbox_http_total 7" in body
        assert any(t.name == "pbox-prom-http" and t.daemon
                   for t in threading.enumerate())
    finally:
        fresh_hub.stop_prom_http()


def test_healthz_route(fresh_hub):
    srv = fresh_hub.start_prom_http(0)
    try:
        port = srv.server_address[1]
        resp = urllib.request.urlopen(
            f"http://127.0.0.1:{port}/healthz", timeout=5)
        assert resp.headers["Content-Type"] == "application/json"
        h = json.loads(resp.read().decode())
        assert h["status"] == "ok"
        assert h["run_id"] == fresh_hub.run_id
        assert h["uptime_sec"] >= 0
        assert h["passes_total"] == 0
        assert h["last_pass_age_sec"] is None
        emit_pass_event("train_pass", {"batches": 1, "elapsed_sec": 0.1})
        h = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{port}/healthz", timeout=5
            ).read().decode())
        assert h["passes_total"] == 1
        assert 0 <= h["last_pass_age_sec"] < 60
        body = urllib.request.urlopen(
            f"http://127.0.0.1:{port}/metrics", timeout=5
            ).read().decode()
        assert "pbox_passes_total" in body
    finally:
        fresh_hub.stop_prom_http()


def test_readyz_route_and_serving_block(fresh_hub):
    srv = fresh_hub.start_prom_http(0)
    try:
        port = srv.server_address[1]

        def get(route):
            try:
                resp = urllib.request.urlopen(
                    f"http://127.0.0.1:{port}{route}", timeout=5)
                return resp.status, json.loads(resp.read().decode())
            except urllib.error.HTTPError as e:
                return e.code, json.loads(e.read().decode())

        code, body = get("/readyz")
        assert code == 503 and body["ready"] is False
        assert "serving" not in fresh_hub.health()
        state = {"adopted": None, "epoch": None,
                 "last_reload_ts": None, "staleness_sec": 0.0,
                 "stale": False}
        fresh_hub.set_serving_probe(lambda: dict(state))
        code, body = get("/readyz")
        assert code == 503
        assert body["reason"] == "no snapshot adopted yet"
        assert get("/healthz")[1]["serving"]["adopted"] is None
        state.update(adopted="v0000000007", epoch=7,
                     last_reload_ts=123.0, staleness_sec=1.5)
        code, body = get("/readyz")
        assert code == 200 and body["ready"] is True
        assert body["serving"]["adopted"] == "v0000000007"
        assert get("/healthz")[1]["serving"]["staleness_sec"] == 1.5

        def boom():
            raise RuntimeError("probe died")
        fresh_hub.set_serving_probe(boom)
        code, body = get("/readyz")
        assert code == 503
        assert get("/healthz")[0] == 200
    finally:
        fresh_hub.stop_prom_http()


SERVING_EVENTS = [
    {"event": "serving_stats", "adopted": "v0000000001",
     "staleness_sec": 0.0, "lookup_p99_ms": 0.21, "queries": 10},
    {"event": "pass", "kind": "train_pass", "batches": 4,
     "elapsed_sec": 1.0, "examples": 128, "examples_per_sec": 128.0,
     "proc": 0},
    {"event": "serving_reload", "artifact": "v0000000002"},
    {"event": "serving_stats", "adopted": "v0000000002",
     "staleness_sec": 2.1, "predict_p99_ms": 5.99, "queries": 30},
    {"event": "pass", "kind": "train_pass", "batches": 4,
     "elapsed_sec": 1.0, "examples": 128, "examples_per_sec": 128.0,
     "proc": 0},
    {"event": "serving_degraded", "tip": "v0000000003",
     "adopted": "v0000000002", "staleness_sec": 4.0},
]


def test_serving_report_column():
    from paddlebox_tpu_torch.tools import telemetry_report as mod
    ref = _ref_report()
    rows = mod.build_rows(SERVING_EVENTS)
    assert rows == ref.build_rows(SERVING_EVENTS)
    assert rows[0]["serve p99"] == "p99 0.21ms @v0000000001"
    assert rows[1]["serve p99"] \
        == "p99 5.99ms @v0000000002 (+2.1s stale)"
    rep = mod.render_report(SERVING_EVENTS)
    assert rep == ref.render_report(SERVING_EVENTS)
    assert "serving: 1 reloads → v0000000002" in rep
    assert "1 degraded polls" in rep and "max staleness 4.0s" in rep
    rows = mod.build_rows([e for e in SERVING_EVENTS
                           if e["event"] == "pass"])
    assert "serve p99" not in rows[0]


def test_add_sink_dual_capability_registers_both(fresh_hub):
    class Dual:
        def __init__(self):
            self.events, self.spans = [], []

        def emit(self, ev):
            self.events.append(ev)

        def span(self, name, start, dur, attrs):
            self.spans.append(name)

        def close(self):
            pass

    d = Dual()
    fresh_hub.add_sink(d)
    assert d in fresh_hub.event_sinks()
    assert d in fresh_hub.span_sinks()
    fresh_hub.emit("tick")
    with fresh_hub.span("s1"):
        pass
    assert [e["event"] for e in d.events] == ["tick"]
    assert d.spans == ["s1"]
    only_ev = Dual()
    fresh_hub.add_sink(only_ev, kind="event")
    assert only_ev in fresh_hub.event_sinks()
    assert only_ev not in fresh_hub.span_sinks()
    with pytest.raises(ValueError):
        fresh_hub.add_sink(Dual(), kind="bogus")
    with pytest.raises(TypeError):
        fresh_hub.add_sink(object())
    closes = []

    class CountingDual(Dual):
        def close(self):
            closes.append(1)

    fresh_hub.add_sink(CountingDual())
    fresh_hub.close_sinks()
    assert len(closes) == 1


def test_chrome_span_sink(fresh_hub):
    from paddlebox_tpu_torch.obs import ChromeSpanSink
    from paddlebox_tpu_torch.utils.profiler import ChromeTraceWriter
    w = ChromeTraceWriter()
    fresh_hub.add_sink(ChromeSpanSink(w))
    with fresh_hub.span("stage_x", pass_id=3):
        pass
    assert w._events and w._events[0]["name"] == "stage_x"
    assert w._events[0]["args"] == {"pass_id": 3}


def _launch(corr, ts):
    return {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": ts,
            "args": {"correlation": corr}}


def _kernel(corr, ts, name="k"):
    return {"cat": "kernel", "name": name, "ts": ts, "dur": 5,
            "args": {"correlation": corr}}


WINDOW_EVENTS = [
    {"name": "Iteration Start: PyTorch Profiler", "ts": 100.0},
    _launch(1, 200.0), _kernel(1, 150.0),     # stamped 50 us early
    _launch(2, 300.0), _kernel(2, 340.0),
    _launch(3, 400.0),                        # its kernel was dropped
    _kernel(99, 500.0, "library_kernel"),     # no launch event
    {"name": "Record Window End", "ts": 1000.0}]


def test_window_record_links_launches_to_kernels():
    """``profiler.window_record`` links each launch to its kernel by
    correlation id: the clock's error both ways, and every launch whose
    kernel the trace lacks, counted from the window's opening."""
    from paddlebox_tpu_torch.utils.profiler import window_record
    rec = window_record(WINDOW_EVENTS, 0.025)
    assert rec == {"margin_us": 25000.0, "window_us": 900.0,
                   "runtime_launches": 3, "kernels": 3,
                   "kernel_minus_launch_us": [-50.0, 40.0],
                   "lost_launches": 1, "lost_launch_after_open_us": [300.0]}
    clean = window_record([e for e in WINDOW_EVENTS
                           if e.get("ts") != 400.0], 0.0)
    assert clean["lost_launches"] == 0
    assert clean["lost_launch_after_open_us"] == []


def test_record_window_writes_the_trace_and_warns_on_a_lost_launch(
        tmp_path, caplog):
    """A launch without its kernel makes ``trace()``'s record loud: a
    warning with the clock's error, and the record in the trace file."""
    import logging

    from paddlebox_tpu_torch.utils import profiler
    path = str(tmp_path / profiler.TRACE_FILE)
    with open(path, "w") as fh:
        json.dump({"traceEvents": WINDOW_EVENTS}, fh)
    with caplog.at_level(logging.WARNING):
        rec = profiler._record_window(path, 0.025)
    assert rec["lost_launches"] == 1
    assert any("lost 1 of 3 kernel launches" in r.getMessage()
               for r in caplog.records)
    doc = json.load(open(path))
    assert doc[profiler.WINDOW_KEY] == rec
    assert doc["traceEvents"] == WINDOW_EVENTS


def test_trace_records_its_window_on_the_cpu(tmp_path):
    """``trace()`` records its window in the file and on the profiler;
    on a host without a card it holds no margin and sees no launch."""
    from paddlebox_tpu_torch.utils import profiler
    with profiler.trace(str(tmp_path)) as prof:
        torch.ones(8, 8) @ torch.ones(8, 8)
    doc = json.load(open(tmp_path / profiler.TRACE_FILE))
    assert doc[profiler.WINDOW_KEY] == prof.window
    assert prof.window["lost_launches"] == 0
    if not torch.cuda.is_available():
        assert prof.window["margin_us"] == 0.0
        assert prof.window["runtime_launches"] == 0


# ---- channel gauges ----------------------------------------------------
def test_channel_blocked_put_and_watermark():
    reset_channel_stats()
    ch = Channel(capacity=2, name="t.full")
    done = threading.Event()

    def slow_consumer():
        while True:
            try:
                ch.get(timeout=5)
            except Exception:
                break
            time.sleep(0.02)
        done.set()

    th = threading.Thread(target=slow_consumer, daemon=True)
    th.start()
    for i in range(10):
        ch.put(i)
    m = ch.metrics()
    assert m["high_watermark"] == 2
    assert m["blocked_put_sec"] > 0.01
    assert m["puts"] == 10
    ch.close()
    done.wait(5)
    snap = channel_stats_snapshot()
    assert snap["t.full"]["blocked_put_sec"] > 0.01
    assert snap["t.full"]["high_watermark"] == 2


def test_channel_blocked_get_under_starvation():
    reset_channel_stats()
    ch = Channel(capacity=8, name="t.starved")

    def slow_producer():
        for i in range(3):
            time.sleep(0.03)
            ch.put(i)
        ch.close()

    threading.Thread(target=slow_producer, daemon=True).start()
    assert list(ch) == [0, 1, 2]
    snap = channel_stats_snapshot()
    assert snap["t.starved"]["blocked_get_sec"] > 0.02
    assert snap["t.starved"]["gets"] == 3


def test_anonymous_channel_not_registered():
    reset_channel_stats()
    ch = Channel(capacity=4)
    ch.put(1)
    ch.close()
    assert channel_stats_snapshot() == {}


# ---- straggler watchdog ------------------------------------------------
class FakeClock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


def _both_wd(**kw):
    """(port, reference) watchdogs, each a (watchdog, store, clock)
    over its own store and fake clock, to be fed the same beats."""
    from paddlebox_tpu.obs import TelemetryHub as JHub
    kw.setdefault("step_lag", 10)
    kw.setdefault("heartbeat_timeout", 30.0)
    out = []
    for store_cls, wd_cls, hub in (
            (LocalHeartbeatStore, StragglerWatchdog, TelemetryHub()),
            (j_watchdog.LocalHeartbeatStore, j_watchdog.StragglerWatchdog,
             JHub())):
        clock, store = FakeClock(), store_cls()
        out.append((wd_cls(store, process_index=0, num_processes=2,
                           clock=clock, hub=hub, **kw), store, clock))
    return out


def _reports(reps):
    return [tuple(r) for r in reps]


def _run_both(script, **kw):
    """Run ``script(wd, store, clock) -> list`` on both packages'
    watchdogs; the port's result must equal the reference's."""
    (p, j) = _both_wd(**kw)
    got = script(*p)
    assert got == script(*j)
    return got


def test_watchdog_silent_on_healthy():
    def script(wd, store, clock):
        out = []
        for step in range(0, 50, 5):
            store.publish(0, step, clock())
            store.publish(1, step - 3, clock())
            clock.t += 5
            out.append(_reports(wd.check()))
        return out
    assert all(r == [] for r in _run_both(script))


def test_watchdog_fires_on_step_lag():
    def script(wd, store, clock):
        store.publish(0, 100, clock())
        store.publish(1, 50, clock())
        return _reports(wd.check())
    from paddlebox_tpu_torch.obs import StragglerReport
    reps = _run_both(script)
    assert len(reps) == 1
    r = StragglerReport(*reps[0])
    assert r.process == 1 and r.reason == "step_lag" and r.behind == 50


def test_watchdog_fires_on_stale_heartbeat():
    def script(wd, store, clock):
        store.publish(0, 10, clock())
        store.publish(1, 10, clock())
        clock.t += 100
        store.publish(0, 11, clock())
        return wd.check()
    (p, j) = _both_wd()
    reps = script(*p)
    assert _reports(reps) == _reports(script(*j))
    assert [r.process for r in reps] == [1]
    assert reps[0].reason == "stale"
    assert reps[0].age_sec == pytest.approx(100.0)


def test_watchdog_missing_process_after_grace():
    def script(wd, store, clock):
        store.publish(0, 5, clock())
        first = _reports(wd.check())
        clock.t += 60
        store.publish(0, 6, clock())
        return [first, _reports(wd.check())]
    from paddlebox_tpu_torch.obs import StragglerReport
    first, reps = _run_both(script)
    assert first == []  # inside the startup grace window
    reps = [StragglerReport(*r) for r in reps]
    assert [r.reason for r in reps] == ["missing"]
    assert reps[0].process == 1 and reps[0].step == -1


def test_watchdog_ignores_prior_run_leftovers():
    def script(wd, store, clock):
        clock.t = 2000.0
        store.publish(1, 120_000, 100.0)
        store.publish(7, 120_000, 100.0)
        store.publish(0, 3, clock())
        store.publish(1, 2, clock())
        return _reports(wd.check())
    assert _run_both(script) == []


def test_watchdog_abort_arms_and_beat_raises():
    clock = FakeClock()
    store = LocalHeartbeatStore()
    seen = []
    wd = StragglerWatchdog(store, process_index=0, num_processes=2,
                           clock=clock, hub=TelemetryHub(), step_lag=10,
                           heartbeat_timeout=30.0, abort_after=20.0,
                           on_straggler=lambda reps: seen.append(reps))
    store.publish(0, 100, clock())
    store.publish(1, 0, clock())
    wd.poll_once()
    assert seen and not wd._abort_exc
    wd.beat(101)
    clock.t += 25
    wd.poll_once()
    with pytest.raises(StragglerTimeout):
        wd.beat(102)
    # the reference arms at the same point of the same feed
    from paddlebox_tpu.obs import TelemetryHub as JHub
    jclock = FakeClock()
    jstore = j_watchdog.LocalHeartbeatStore()
    jwd = j_watchdog.StragglerWatchdog(jstore, process_index=0,
                                       num_processes=2, clock=jclock,
                                       hub=JHub(), step_lag=10,
                                       heartbeat_timeout=30.0,
                                       abort_after=20.0)
    jstore.publish(0, 100, jclock())
    jstore.publish(1, 0, jclock())
    jwd.poll_once()
    jwd.beat(101)
    jclock.t += 25
    jwd.poll_once()
    with pytest.raises(j_watchdog.StragglerTimeout):
        jwd.beat(102)


def test_watchdog_emits_events():
    clock = FakeClock()
    store = LocalHeartbeatStore()
    hub = TelemetryHub()
    sink = MemorySink()
    hub.add_sink(sink)
    wd = StragglerWatchdog(store, 0, 2, step_lag=10, clock=clock, hub=hub)
    store.publish(0, 100, clock())
    store.publish(1, 0, clock())
    wd.poll_once()
    evs = [e for e in sink.events if e["event"] == "straggler"]
    assert evs and evs[0]["stragglers"][0]["process"] == 1
    assert hub.counter("pbox_straggler_events_total").value() == 1
    # the event's fields are the reference's
    from paddlebox_tpu.obs import MemorySink as JMem
    from paddlebox_tpu.obs import TelemetryHub as JHub
    jclock, jstore, jhub, jsink = (FakeClock(),
                                   j_watchdog.LocalHeartbeatStore(),
                                   JHub(), JMem())
    jhub.add_sink(jsink)
    jwd = j_watchdog.StragglerWatchdog(jstore, 0, 2, step_lag=10,
                                       clock=jclock, hub=jhub)
    jstore.publish(0, 100, jclock())
    jstore.publish(1, 0, jclock())
    jwd.poll_once()
    jev = [e for e in jsink.events if e["event"] == "straggler"][0]
    drop = ("ts", "seq", "run")
    assert {k: v for k, v in evs[0].items() if k not in drop} \
        == {k: v for k, v in jev.items() if k not in drop}


def test_watchdog_background_thread_detects():
    store = LocalHeartbeatStore()
    fired = threading.Event()
    wd = StragglerWatchdog(store, 0, 2, step_lag=5, poll_interval=0.02,
                           hub=TelemetryHub(),
                           on_straggler=lambda reps: fired.set())
    store.publish(0, 100, time.time())
    store.publish(1, 1, time.time())
    wd.start()
    try:
        assert fired.wait(5), "watchdog thread never fired"
        assert wd._thread is not None and wd._thread.daemon
    finally:
        wd.stop()


def test_dir_heartbeat_store_roundtrip(tmp_path):
    store = DirHeartbeatStore(str(tmp_path / "hb"))
    store.publish(0, 12, 100.0)
    store.publish(3, 7, 101.5)
    store.publish(0, 13, 102.0)  # overwrite
    beats = store.read()
    assert beats == {0: (13, 102.0), 3: (7, 101.5)}
    with open(tmp_path / "hb" / "hb_9.json", "w") as fh:
        fh.write("{not json")
    assert store.read() == beats
    # the files are the reference's: its store reads the port's beats
    assert j_watchdog.DirHeartbeatStore(str(tmp_path / "hb")).read() \
        == beats


# ---- scatter warmup -----------------------------------------------------
def test_scatter_warmup_emits_event(fresh_hub, tmp_path):
    """The reference's tables compile their pass-boundary scatter ahead
    of time and book ``scatter_warmup``; the port's kernels build once
    per process on first use and a pass-window table has nothing to
    warm, so the port's begin_pass books no warmup (a deliberate
    difference). The reference's seam is held here as its test holds
    it."""
    from paddlebox_tpu.config import flags_scope as j_flags_scope
    from paddlebox_tpu.obs import MemorySink as JMem
    from paddlebox_tpu.obs.hub import get_hub as j_get_hub
    from paddlebox_tpu.ps.table import (init_table_state,
                                        start_scatter_warmup)
    jsink = JMem()
    j_get_hub().add_sink(jsink)
    st = init_table_state(63, 8)
    with j_flags_scope(scatter_chunk_rows=64, warmup_pass_scatter=True):
        start_scatter_warmup(st, sharded=False)
        deadline = time.time() + 60
        while time.time() < deadline:
            if any(e["event"] == "scatter_warmup" for e in jsink.events):
                break
            time.sleep(0.05)
    evs = [e for e in jsink.events if e["event"] == "scatter_warmup"]
    assert evs and evs[0]["outcome"] == "ok"
    assert j_get_hub().counter("pbox_scatter_warmup_total").value(
        outcome="ok") == 1
    # the port: a pass-window table's begin/end books its window
    # counters, never a warmup
    from paddlebox_tpu_torch.ps import HostStore, PassScopedTable
    from paddlebox_tpu_torch.ps.sgd import SparseSGDConfig
    sink = MemorySink()
    fresh_hub.add_sink(sink)
    t = PassScopedTable(HostStore(mf_dim=4, capacity=1 << 10),
                        pass_capacity=1 << 8, cfg=SparseSGDConfig(),
                        device="cpu")
    t.begin_pass(np.arange(1, 41, dtype=np.uint64))
    t.end_pass()
    assert not [e for e in sink.events if e["event"] == "scatter_warmup"]
    assert "pbox_scatter_warmup_total" not in fresh_hub.snapshot()
    assert fresh_hub.counter("pbox_table_staged_rows_total").value() == 40


# ---- trainer integration (pass events end to end) ----------------------
def _criteo(tmp_path_factory):
    from paddlebox_tpu.data.criteo import generate_criteo_files
    d = tmp_path_factory.mktemp("obs_run")
    return d, generate_criteo_files(str(d), num_files=1,
                                    rows_per_file=400, vocab_per_slot=40,
                                    seed=11)


@pytest.fixture(scope="module")
def tiny_runs(tmp_path_factory):
    """The reference test's tiny_trainer_run (one streaming + one
    resident pass with the JSONL sink attached) through both packages
    on the same files; yields {"port": events, "jax": events}."""
    import optax

    from paddlebox_tpu.config import flags_scope
    from paddlebox_tpu.data import DataFeedDesc as JDesc
    from paddlebox_tpu.data import DatasetFactory as JFactory
    from paddlebox_tpu.models import CtrDnn as JCtrDnn
    from paddlebox_tpu.obs import JsonlSink as JJsonl
    from paddlebox_tpu.ps import EmbeddingTable as JTable
    from paddlebox_tpu.ps import SparseSGDConfig as JCfg
    from paddlebox_tpu.train import Trainer as JTrainer

    from paddlebox_tpu_torch.data import DataFeedDesc, DatasetFactory
    from paddlebox_tpu_torch.models import CtrDnn
    from paddlebox_tpu_torch.ps.sgd import SparseSGDConfig
    from paddlebox_tpu_torch.ps.table import EmbeddingTable
    from paddlebox_tpu_torch.train.trainer import Trainer

    from paddlebox_tpu.utils.channel import \
        reset_channel_stats as j_reset_channel_stats
    d, files = _criteo(tmp_path_factory)
    out = {}
    # the channel registries are process-wide and cumulative: start both
    # runs from empty ones, as a fresh process would (collected channels
    # fold into the aggregates the resets drop)
    gc.collect()
    j_reset_channel_stats()
    reset_channel_stats()
    jpath = str(d / "jax.jsonl")
    hub = j_reset_hub()
    hub.add_sink(JJsonl(jpath))
    try:
        desc = JDesc.criteo(batch_size=128)
        desc.key_bucket_min = 4096
        ds = JFactory().create_dataset("InMemoryDataset", desc)
        ds.set_filelist(files)
        ds.set_thread(2)
        ds.load_into_memory()
        table = JTable(mf_dim=4, capacity=1 << 13,
                       cfg=JCfg(mf_create_thresholds=0.0,
                                mf_initial_range=1e-3),
                       unique_bucket_min=4096)
        with flags_scope(log_period_steps=10000):
            tr = JTrainer(JCtrDnn(hidden=(16,)), table, desc,
                          tx=optax.adam(1e-3))
            tr.train_pass(ds)
            tr.train_pass_resident(ds)
    finally:
        j_reset_hub()
    out["jax"] = [json.loads(l) for l in open(jpath)]  # noqa: E741

    ppath = str(d / "port.jsonl")
    hub = reset_hub()
    hub.add_sink(JsonlSink(ppath))
    try:
        desc = DataFeedDesc.criteo(batch_size=128)
        desc.key_bucket_min = 4096
        ds = DatasetFactory().create_dataset("InMemoryDataset", desc)
        ds.set_filelist(files)
        ds.set_thread(2)
        ds.load_into_memory()
        table = EmbeddingTable(mf_dim=4, capacity=1 << 13,
                               cfg=SparseSGDConfig(mf_create_thresholds=0.0,
                                                   mf_initial_range=1e-3),
                               unique_bucket_min=4096, device="cpu")
        torch.manual_seed(0)
        tr = Trainer(CtrDnn(26, 3 + 4, 13, hidden=(16,)), table, desc,
                     tx=lambda p: torch.optim.Adam(p, lr=1e-3),
                     device="cpu")
        tr.train_pass(ds)
        tr.train_pass_resident(ds)
        out["dispatch"] = hub.snapshot().get(
            "pbox_kernel_dispatch_total", {}).get("series", {})
    finally:
        reset_hub()
    out["port"] = [json.loads(l) for l in open(ppath)]  # noqa: E741
    return out


def test_pass_events_schema(tiny_runs):
    events = tiny_runs["port"]
    passes = [e for e in events if e["event"] == "pass"]
    assert [e["kind"] for e in passes] == ["train_pass",
                                           "train_pass_resident"]
    for e in passes:
        json.dumps(e)
        assert e["batches"] >= 1 and e["elapsed_sec"] > 0
        assert "step" in e["stage_sec"]
        assert e["stage_count"]["step"] >= 1
        assert set(e["hbm"]) == {"bytes_in_use", "peak_bytes_in_use",
                                 "bytes_limit"}
        assert e["table"]["used"] > 0
        assert e["table"]["capacity"] == 1 << 13
        assert "channels" in e
    stream = passes[0]
    assert stream["channels"]["trainer.prepare"]["puts"] >= 1
    assert "blocked_put_sec" in stream["channels"]["trainer.prepare"]
    assert "trainer.h2d" in stream["channels"]
    assert stream["stage_sec"]["prepare"] >= 0
    seqs = [e["ts"] for e in events]
    assert seqs == sorted(seqs)


def test_report_renders(tiny_runs):
    from paddlebox_tpu_torch.tools import telemetry_report as mod
    report = mod.render_report(tiny_runs["port"])
    assert "train_pass_resident" in report
    assert "queue stall" in report
    assert "2 passes" in report


#: report columns read from clocks or the device allocator
CLOCK_COLUMNS = ("ex/s", "wall", "stages", "queue stall", "bottleneck",
                 "hbm peak")


def test_trainer_parity_with_reference(tiny_runs):
    """The same configuration through both trainers: pass event names
    and field keys equal (the device block by key), the work counters
    and the stage names equal, and the two reports render the same rows
    once the clock columns are removed."""
    port, ref = tiny_runs["port"], tiny_runs["jax"]
    assert [e["event"] for e in port] == [e["event"] for e in ref]
    pp = [e for e in port if e["event"] == "pass"]
    jp = [e for e in ref if e["event"] == "pass"]
    for a, b in zip(pp, jp):
        # the port's resident pass reports its last loss (the
        # reference's resident result has none), so its event carries it
        extra = {"last_loss"} if a["kind"] == "train_pass_resident" \
            else set()
        assert set(a) == set(b) | extra, set(a) ^ set(b)
        assert set(a["hbm"]) == set(b["hbm"])
        assert set(a["table"]) == set(b["table"])
        assert set(a["resilience"]) == set(b["resilience"])
        assert set(a["critical_path"]) == set(b["critical_path"])
        for k in ("kind", "batches", "examples", "pass_seq",
                  "global_step"):
            assert a[k] == b[k], k
        assert a["table"]["used"] == b["table"]["used"]
        assert a["table"]["capacity"] == b["table"]["capacity"]
        assert a["resilience"] == b["resilience"]
        assert set(a["stage_sec"]) == set(b["stage_sec"])
        assert a["stage_count"] == b["stage_count"]
        assert set(a["channels"]) == set(b["channels"])
        for name in a["channels"]:
            assert a["channels"][name]["puts"] \
                == b["channels"][name]["puts"]
    from paddlebox_tpu_torch.tools import telemetry_report as mod
    strip = lambda rows: [{k: v for k, v in r.items()  # noqa: E731
                           if k not in CLOCK_COLUMNS} for r in rows]
    assert strip(mod.build_rows(port)) \
        == strip(_ref_report().build_rows(ref))


def test_trainer_dispatch_labels_match_reference(tiny_runs):
    """The port books every kernel the reference books on this path
    (criteo: one key a slot, so the pool is the reshape), plus the
    write-back kernel the reference books no label for; every tick on
    the CPU is a plain dispatch, and the count equals the batches."""
    series = tiny_runs["dispatch"]
    labels = {}
    for key, n in series.items():
        kv = dict(x.split("=") for x in key.split(","))
        labels.setdefault(kv["kernel"], set()).add(kv["impl"])
    assert {"gather_rows", "fused_embed_pool_cvm"} <= set(labels)
    assert set(labels) - {"gather_rows", "fused_embed_pool_cvm"} \
        == {"scatter_add_update"}
    assert labels["gather_rows"] == {"plain"}
    assert labels["fused_embed_pool_cvm"] == {"reshape"}
    nb = sum(e["batches"] for e in tiny_runs["port"]
             if e["event"] == "pass")
    assert series["impl=plain,kernel=gather_rows"] == nb


#: each kernel wrapper's dispatch label (the reference's where it books
#: one, else the Pallas function's name)
WRAPPER_LABELS = {
    "gather_rows": "gather_rows", "pool_cvm": "fused_embed_pool_cvm",
    "segment_gather": "seqpool_grad", "scatter_add_update":
    "scatter_add_update", "index_insert": "index_insert",
    "index_lookup": "index_lookup", "rank_attention": "rank_attention",
    "batch_fc": "batch_fc", "cross_norm": "cross_norm",
    "segment_sum": "segment_sum", "scatter_rows": "scatter_rows",
    "scatter_rows_dma": "scatter_rows_dma",
    "gather_rows_dma": "gather_rows_dma"}


@pytest.mark.parametrize("field", sorted(WRAPPER_LABELS))
def test_kernel_wrapper_books_under_its_label(fresh_hub, field):
    """Every wrapper of ``KERNELS`` carries its dispatch label beside its
    launch count, and ``_build.book`` books under that label."""
    from paddlebox_tpu_torch.ops import _build
    from paddlebox_tpu_torch.ops.kernels import KERNELS, KernelSet
    assert set(KernelSet._fields) == set(WRAPPER_LABELS)
    fn = getattr(KERNELS, field)
    assert fn.label == WRAPPER_LABELS[field]
    assert isinstance(fn.launches, int)
    _build.book(fn, "plain")
    assert fresh_hub.snapshot() == {}
    fresh_hub.add_sink(MemorySink())
    _build.book(fn, "plain")
    series = fresh_hub.snapshot()["pbox_kernel_dispatch_total"]["series"]
    assert series == {f"impl=plain,kernel={fn.label}": 1}


def test_trainer_without_sinks_stays_inert():
    hub = reset_hub()
    assert not hub.active
    emit_pass_event("train_pass", {"batches": 1})
    assert hub.snapshot() == {}
    reset_hub()


def _hub_run(tmp_path, on: bool):
    """Two passes of a small ragged DeepFM run with the hub inert or
    fully on (JSONL + lane trace sinks, quality window, alert engine on
    a short cadence, a flight-recorder dir); returns the trained state."""
    from paddlebox_tpu_torch.config import flags_scope
    from paddlebox_tpu_torch.data import DataFeedDesc, DatasetFactory
    from paddlebox_tpu_torch.data.criteo import generate_criteo_files
    from paddlebox_tpu_torch.models import DeepFM
    from paddlebox_tpu_torch.obs import ChromeLaneTraceSink
    from paddlebox_tpu_torch.ps.sgd import SparseSGDConfig
    from paddlebox_tpu_torch.ps.table import EmbeddingTable
    from paddlebox_tpu_torch.train.trainer import Trainer
    from paddlebox_tpu_torch.utils.profiler import ChromeTraceWriter
    files = generate_criteo_files(str(tmp_path / "d"), num_files=1,
                                  rows_per_file=300, vocab_per_slot=30,
                                  seed=5)
    hub = reset_hub()
    flags = {}
    if on:
        hub.add_sink(JsonlSink(str(tmp_path / "on.jsonl")))
        hub.add_sink(ChromeLaneTraceSink(ChromeTraceWriter()))
        flags = dict(quality_window_passes=2,
                     alerts_eval_interval_sec=0.05,
                     flightrec_dir=str(tmp_path / "bb"))
    try:
        with flags_scope(**flags):
            desc = DataFeedDesc.criteo(batch_size=64)
            ds = DatasetFactory().create_dataset("InMemoryDataset", desc)
            ds.set_filelist(files)
            ds.set_thread(1)
            ds.load_into_memory()
            table = EmbeddingTable(
                mf_dim=4, capacity=1 << 12,
                cfg=SparseSGDConfig(mf_create_thresholds=0.0,
                                    mf_initial_range=0.0),
                device="cpu")
            torch.manual_seed(3)
            tr = Trainer(DeepFM(26, 3 + 4, 13, hidden=(8,)), table, desc,
                         tx=lambda p: torch.optim.Adam(p, lr=1e-2),
                         device="cpu")
            tr.train_pass(ds)
            tr.train_pass_resident(ds)
            assert hub.active == on
            if on:
                kinds = [e.get("kind") for e in
                         map(json.loads, open(tmp_path / "on.jsonl"))
                         if e["event"] == "pass"]
                assert kinds == ["train_pass", "train_pass_resident"]
                from paddlebox_tpu_torch.obs import alerts
                assert alerts.get_engine() is not None
        return (table.state.data.clone(),
                {k: v.clone() for k, v in tr.model.state_dict().items()})
    finally:
        reset_hub()


def test_hub_on_state_equals_inert(tmp_path):
    """The telemetry draws from no generator and reorders no launch: the
    trained table and dense params with every piece of the hub on equal
    the inert run's bit for bit."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        data0, params0 = _hub_run(tmp_path / "off", on=False)
        data1, params1 = _hub_run(tmp_path / "on", on=True)
    finally:
        torch.set_num_threads(threads)
    assert torch.equal(data0, data1)
    assert params0.keys() == params1.keys()
    for k in params0:
        assert torch.equal(params0[k], params1[k]), k


def test_quality_norm_sample_matches_whole_table_copy(fresh_hub):
    """The port gathers the norm sample on the table's device; its mean
    equals the reference's formulation (the whole table on the host,
    sampled there) at rtol 1e-6, and the verdict fields match the
    reference monitor fed the same rows."""
    from paddlebox_tpu.obs.quality import QualityMonitor as JMon
    from paddlebox_tpu_torch.obs.quality import (NORM_SAMPLE_ROWS,
                                                 QualityMonitor,
                                                 norm_sample)
    rng = np.random.default_rng(0)
    cap = 5000
    data = rng.standard_normal((cap + 1, 12)).astype(np.float32)
    keys = rng.choice(1 << 40, size=3000, replace=False).astype(np.uint64)
    rows = rng.permutation(cap)[:3000].astype(np.int64)
    order = np.argsort(keys, kind="stable")[:NORM_SAMPLE_ROWS]
    got = norm_sample(torch.from_numpy(data), rows[order])
    np.testing.assert_array_equal(got, data[rows[order]])

    class Index:
        def items(self):
            return keys, rows

    class State:
        def __init__(self, d):
            self.data = d

    class Table:
        def __init__(self, d):
            self.index = Index()
            self.state = State(d)

    ev = {"kind": "train_pass", "pass_seq": 1, "auc": 0.7}
    p = QualityMonitor(window=2).note_pass(
        ev, table=Table(torch.from_numpy(data)), hub=fresh_hub)
    import jax.numpy as jnp
    from paddlebox_tpu.obs.hub import get_hub as j_get_hub
    j = JMon(window=2).note_pass(ev, table=Table(jnp.asarray(data)),
                                 hub=j_get_hub())
    assert p["embed_norm"] == pytest.approx(j["embed_norm"], rel=1e-6)
    assert {k: v for k, v in p.items() if k != "embed_norm"} \
        == {k: v for k, v in j.items() if k != "embed_norm"}
