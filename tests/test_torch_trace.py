"""The port's causal pass tracing (``paddlebox_tpu_torch/obs/trace``)
against the JAX package's (``paddlebox_tpu/obs/trace``): the cases of
``tests/test_trace.py``. Span nesting, lanes, the Chrome lane sink's tid
rows and flow arrows and the critical-path block run the same feeds
through both packages and must agree exactly (span ids, rendered
events without their clock fields, blocks); the depth-2 tiered case
runs on the port's ``TieredShardedEmbeddingTable`` with 2 shards on the
CPU."""

import json
import threading

import pytest
import torch

from paddlebox_tpu.obs import reset_hub as j_reset_hub
from paddlebox_tpu.obs import trace as j_trace
from paddlebox_tpu.obs.hub import emit_pass_event as j_emit_pass_event
from paddlebox_tpu.utils.profiler import ChromeTraceWriter as JWriter

from paddlebox_tpu_torch.config import flags_scope
from paddlebox_tpu_torch.obs import (ChromeLaneTraceSink, MemorySink,
                                     reset_hub)
from paddlebox_tpu_torch.obs import trace
from paddlebox_tpu_torch.obs.hub import emit_pass_event
from paddlebox_tpu_torch.utils.profiler import ChromeTraceWriter

N = 2


@pytest.fixture()
def fresh_hub():
    j_reset_hub()
    j_trace.reset()
    hub = reset_hub()
    trace.reset()
    yield hub
    reset_hub()
    trace.reset()
    j_reset_hub()
    j_trace.reset()


def _shape(events):
    """Rendered chrome events without their clock fields (ts, dur) and
    the span ids (each package numbers its own spans)."""
    out = []
    for e in events:
        e = {k: v for k, v in e.items() if k not in ("ts", "dur", "id")}
        if "args" in e:
            e["args"] = {k: v for k, v in e["args"].items()
                         if k not in ("span_id", "parent_id")}
        out.append(e)
    return out


def _lane_run(tr, writer_cls, sink_cls, hub):
    """The lane-sink scenario of the reference's tests on one package:
    build on the preload worker, consume on main linked to it, a nested
    pair, an ssd lane scope. Returns the writer's events."""
    w = writer_cls()
    hub.add_sink(sink_cls(w))
    with tr.span("pass.build", lane="preload.worker") as hb:
        with tr.span("pass.stage"):
            pass
    with tr.span("pass.consume", lane="main", link_from=hb.span_id):
        pass
    with tr.lane_scope("ssd.compact"):
        with tr.span("ssd.maintain"):
            pass
    return w._events


# ---- span layer --------------------------------------------------------
def test_span_inert_without_sinks(fresh_hub):
    assert not trace.tracing_active()
    with trace.span("x") as h:
        assert h is trace.NULL_SPAN
        assert h.span_id == 0
    assert fresh_hub.snapshot() == {}  # no instrument was created


def test_span_nesting_and_parent_ids(fresh_hub):
    w = ChromeTraceWriter()
    fresh_hub.add_sink(ChromeLaneTraceSink(w))
    assert trace.tracing_active()
    with trace.span("outer") as ho:
        assert trace.current_span_id() == ho.span_id
        with trace.span("inner") as hi:
            assert hi.span_id != ho.span_id
            assert trace.current_span_id() == hi.span_id
        assert trace.current_span_id() == ho.span_id
    assert trace.current_span_id() == 0
    evs = {e["name"]: e for e in w._events if e["ph"] == "X"}
    assert evs["inner"]["args"]["parent_id"] == ho.span_id
    assert "parent_id" not in evs["outer"]["args"]
    # only the TOP-LEVEL span books lane-busy seconds
    busy = fresh_hub.counter("pbox_lane_busy_seconds_total", "x")
    assert busy.value(lane="main") > 0
    assert set(fresh_hub.snapshot()) == {"pbox_lane_busy_seconds_total"}


def test_lane_scope_and_set_lane(fresh_hub):
    fresh_hub.add_sink(ChromeLaneTraceSink(ChromeTraceWriter()))
    assert trace.current_lane() == trace.LANE_MAIN
    with trace.lane_scope("ssd.compact"):
        assert trace.current_lane() == "ssd.compact"
        with trace.span("inside") as h:
            assert h.lane == "ssd.compact"
    assert trace.current_lane() == trace.LANE_MAIN
    seen = {}

    def worker():
        seen["default"] = trace.current_lane()
        trace.set_lane("preload.worker")
        seen["set"] = trace.current_lane()

    t = threading.Thread(target=worker, name="pbox-t")
    t.start()
    t.join()
    assert seen["default"] == "pbox-t"      # thread name fallback
    assert seen["set"] == "preload.worker"
    # the lane catalog is the reference's
    assert [trace.LANE_MAIN, trace.LANE_PRELOAD, trace.LANE_EPILOGUE,
            trace.LANE_SSD, trace.LANE_READER] == [
        j_trace.LANE_MAIN, j_trace.LANE_PRELOAD, j_trace.LANE_EPILOGUE,
        j_trace.LANE_SSD, j_trace.LANE_READER]


def test_chrome_lane_sink_rows_and_flow(fresh_hub):
    """Per-lane tid rows with thread_name metadata; a link_from span
    draws a flow arrow from source end to destination start. The port
    renders the same events as the reference for the same spans."""
    events = _lane_run(trace, ChromeTraceWriter, ChromeLaneTraceSink,
                       fresh_hub)
    from paddlebox_tpu.obs import ChromeLaneTraceSink as JSink
    from paddlebox_tpu.obs.hub import get_hub as j_get_hub
    j_events = _lane_run(j_trace, JWriter, JSink, j_get_hub())
    assert _shape(events) == _shape(j_events)
    metas = [e for e in events
             if e["ph"] == "M" and e["name"] == "thread_name"]
    names = {e["args"]["name"]: e["tid"] for e in metas}
    assert set(names) == {"preload.worker", "main", "ssd.compact"}
    assert names["preload.worker"] != names["main"]
    flows = [e for e in events if e["ph"] in ("s", "f")]
    assert len(flows) == 2
    start = next(e for e in flows if e["ph"] == "s")
    end = next(e for e in flows if e["ph"] == "f")
    build = next(e for e in events if e.get("name") == "pass.build"
                 and e["ph"] == "X")
    assert start["id"] == end["id"] == build["args"]["span_id"]
    assert start["tid"] == names["preload.worker"]
    assert end["tid"] == names["main"]
    assert end.get("bp") == "e"
    assert start["ts"] <= end["ts"]
    json.dumps(events)


def test_cross_thread_span_links(fresh_hub):
    """The producer stashes its span id; a consumer on another thread
    links — the PassPreloader hand-off shape."""
    w = ChromeTraceWriter()
    fresh_hub.add_sink(ChromeLaneTraceSink(w))
    box = {}

    def producer():
        trace.set_lane("preload.worker")
        with trace.span("pass.build") as h:
            pass
        box["sid"] = h.span_id

    t = threading.Thread(target=producer)
    t.start()
    t.join()
    with trace.span("pass.consume", link_from=box["sid"]):
        pass
    flows = [e for e in w._events if e["ph"] in ("s", "f")]
    assert {e["ph"] for e in flows} == {"s", "f"}
    assert all(e["id"] == box["sid"] for e in flows)


def test_plain_span_sinks_receive_causal_spans(fresh_hub):
    """A sink with only the span(name, start, dur, attrs) surface still
    receives causal spans (lane/pass_seq folded into attrs)."""

    class PlainSink:
        def __init__(self):
            self.spans = []

        def span(self, name, start, dur, attrs):
            self.spans.append((name, attrs))

        def close(self):
            pass

    sink = PlainSink()
    fresh_hub.add_sink(sink)
    with fresh_hub.span("stage_y"):
        pass
    with trace.span("causal_z", pass_seq=3):
        pass
    assert [n for n, _ in sink.spans] == ["stage_y", "causal_z"]
    attrs = sink.spans[1][1]
    assert attrs["lane"] == "main" and attrs["pass_seq"] == 3
    with pytest.raises(TypeError):
        fresh_hub.add_sink(sink.spans, kind="span")  # list: no span()


# ---- critical-path math ------------------------------------------------
CP_FEEDS = [
    (1.0, {"build_wait": 0.2, "stage_wait": 0.1}),
    (0.5, {"build_wait": 0.74, "fence_wait": 0.1}),
    (2.0, {}),
    (1.0, {"stage_wait": 0.0, "end_submit": -1.0}),
    (0.3, {"ssd_promote": 0.5, "custom_stall": 0.2, "evict_scatter": 0.1}),
]


def test_critical_path_block_sums_and_verdicts(fresh_hub):
    # the same feeds give the reference's blocks exactly
    for train, parts in CP_FEEDS:
        assert trace.critical_path_block(train, parts) \
            == j_trace.critical_path_block(train, parts)
    blk = trace.critical_path_block(1.0, {"build_wait": 0.2,
                                          "stage_wait": 0.1})
    assert blk["bottleneck"] == "device"
    assert blk["wall_sec"] == pytest.approx(1.3)
    assert blk["train_sec"] == pytest.approx(1.0)
    assert blk["stall_sec"] == pytest.approx(0.3)
    blk = trace.critical_path_block(0.5, {"build_wait": 0.74,
                                          "fence_wait": 0.1})
    assert blk["bottleneck"] == "build_wait"
    assert blk["stall_sec"] == pytest.approx(0.74)
    assert blk["wall_sec"] == pytest.approx(0.5 + 0.74 + 0.1)
    blk = trace.critical_path_block(2.0, {})
    assert blk["bottleneck"] == "device"
    assert blk["wall_sec"] == pytest.approx(2.0)
    blk = trace.critical_path_block(1.0, {"stage_wait": 0.0,
                                          "end_submit": -1.0})
    assert blk["wall_sec"] == pytest.approx(1.0)
    assert trace.BOUNDARY_STAGES == j_trace.BOUNDARY_STAGES


def test_note_and_consume_pass_parts(fresh_hub):
    fresh_hub.add_sink(MemorySink())
    trace.note_pass_part("build_wait", 0.5)
    trace.note_pass_part("build_wait", 0.25)
    trace.note_pass_part("stage_wait", 0.1)
    trace.note_pass_part("fence_wait", 0.0)   # dropped
    parts = trace.consume_pass_parts()
    assert parts == {"build_wait": 0.75, "stage_wait": 0.1}
    assert trace.consume_pass_parts() == {}   # consumed exactly once


def test_parts_inert_without_sinks(fresh_hub):
    trace.note_pass_part("build_wait", 1.0)
    assert trace.consume_pass_parts() == {}


def test_pass_event_carries_critical_path(fresh_hub):
    from paddlebox_tpu.obs import MemorySink as JMemorySink
    from paddlebox_tpu.obs.hub import get_hub as j_get_hub
    sink, j_sink = MemorySink(), JMemorySink()
    fresh_hub.add_sink(sink)
    j_get_hub().add_sink(j_sink)
    trace.note_pass_part("build_wait", 0.74)
    j_trace.note_pass_part("build_wait", 0.74)
    emit_pass_event("train_pass_resident",
                    {"batches": 4, "elapsed_sec": 0.5})
    j_emit_pass_event("train_pass_resident",
                      {"batches": 4, "elapsed_sec": 0.5})
    ev = next(e for e in sink.events if e["event"] == "pass")
    j_ev = next(e for e in j_sink.events if e["event"] == "pass")
    cp = ev["critical_path"]
    assert cp == j_ev["critical_path"]
    assert cp["bottleneck"] == "build_wait"
    assert cp["wall_sec"] == pytest.approx(1.24)
    assert fresh_hub.counter("pbox_pass_bottleneck_total", "x").value(
        stage="build_wait") == 1


# ---- the real thing: a depth-2 tiered pipeline on the port -------------
def _mk_ds(tmp_path, seed):
    from paddlebox_tpu_torch.data import DataFeedDesc, DatasetFactory
    from paddlebox_tpu_torch.data.criteo import generate_criteo_files
    files = generate_criteo_files(str(tmp_path / f"tr{seed}"),
                                  num_files=1, rows_per_file=600,
                                  vocab_per_slot=50, seed=seed)
    desc = DataFeedDesc.criteo(batch_size=32)
    desc.key_bucket_min = 1024
    ds = DatasetFactory().create_dataset("InMemoryDataset", desc)
    ds.set_filelist(files)
    ds.set_thread(1)
    ds.load_into_memory()
    return ds, desc


def test_depth2_tiered_job_emits_linked_lane_spans(tmp_path):
    """A depth-2 tiered job emits linked build/stage/consume/epilogue
    spans with the right lane labels, and each pass event's
    critical-path block sums (within tolerance) to the measured pass
    wall."""
    import time as _time

    from paddlebox_tpu_torch.models import DeepFM
    from paddlebox_tpu_torch.ps import TieredShardedEmbeddingTable
    from paddlebox_tpu_torch.ps.sgd import SparseSGDConfig
    from paddlebox_tpu_torch.train.sharded import ShardedTrainer
    hub = reset_hub()
    trace.reset()
    writer = ChromeTraceWriter()
    sink = ChromeLaneTraceSink(writer)
    mem = MemorySink()
    hub.add_sink(sink)
    hub.add_sink(mem)
    try:
        built = [_mk_ds(tmp_path, s) for s in range(2)]
        datasets = [built[0][0], built[1][0], built[0][0]]
        desc = built[0][1]
        cfg = SparseSGDConfig(mf_create_thresholds=0.0,
                              mf_initial_range=0.0)
        table = TieredShardedEmbeddingTable(
            N, mf_dim=4, capacity_per_shard=1024, cfg=cfg,
            req_bucket_min=256, serve_bucket_min=256,
            ssd_dir=str(tmp_path / "ssd"), devices="cpu")
        torch.manual_seed(0)
        tr = ShardedTrainer(DeepFM(26, 3 + 4, 13, hidden=(16, 16),
                                   compute_dtype=torch.float32),
                            table, desc,
                            tx=lambda p: torch.optim.Adam(p, lr=2e-3))
        with flags_scope(preload_depth=2):
            pipe = tr.tiered_pass_pipeline(iter(datasets), depth=2)
        pipe.start_next()
        walls = []
        while True:
            t0 = _time.perf_counter()
            rp = pipe.wait()
            if rp is None:
                break
            pipe.begin_pass()
            pipe.start_next()
            tr.train_pass_resident(rp)
            pipe.end_pass()
            walls.append(_time.perf_counter() - t0)
        pipe.drain()
        table.fence()
    finally:
        reset_hub()
        trace.reset()

    spans = [e for e in writer._events if e["ph"] == "X"]
    by_name = {}
    for e in spans:
        by_name.setdefault(e["name"], []).append(e)
    for name in ("pass.build", "pass.stage", "pass.consume",
                 "pass.begin", "pass.end_submit", "endpass.writeback"):
        assert len(by_name.get(name, [])) >= 3, \
            f"missing spans for {name}: {sorted(by_name)}"
    metas = {e["tid"]: e["args"]["name"] for e in writer._events
             if e["ph"] == "M" and e["name"] == "thread_name"}
    lane_of = lambda e: metas[e["tid"]]  # noqa: E731
    assert all(lane_of(e) == "preload.worker"
               for e in by_name["pass.build"])
    assert all(lane_of(e) == "preload.worker"
               for e in by_name["pass.stage"])
    assert all(lane_of(e) == "main" for e in by_name["pass.consume"])
    assert all(lane_of(e) == "epilogue.lane"
               for e in by_name["endpass.writeback"])
    # stage is a CHILD of its build (same worker, nested)
    build_ids = {e["args"]["span_id"] for e in by_name["pass.build"]}
    assert all(e["args"].get("parent_id") in build_ids
               for e in by_name["pass.stage"])
    # the ssd maintenance lane rode the epilogue jobs
    assert any(lane_of(e) == "ssd.compact"
               for e in by_name.get("ssd.maintain", [])), \
        "ssd.maintain spans missing or mislabeled"
    assert {"main", "preload.worker", "epilogue.lane",
            "ssd.compact"} <= set(metas.values())
    # flow links: every consume links back to a build span id, every
    # write-back to its end_submit span
    flows = [e for e in writer._events if e["ph"] in ("s", "f")]
    links = {e["id"] for e in flows}
    assert {e["args"]["span_id"] for e in by_name["pass.build"]} <= links
    submit_ids = {e["args"]["span_id"] for e in by_name["pass.end_submit"]}
    assert submit_ids & links, "no end_submit → writeback arrows"
    cps = [e["critical_path"] for e in mem.events
           if e.get("event") == "pass" and "critical_path" in e]
    assert len(cps) == len(walls) == 3
    block_total = sum(cp["wall_sec"] for cp in cps)
    wall_total = sum(walls)
    assert block_total <= wall_total * 1.05 + 0.05
    assert block_total >= wall_total * 0.5 - 0.05, \
        (block_total, wall_total, cps)
    for cp in cps:
        parts = sum(v for k, v in cp.items()
                    if k.endswith("_sec") and k not in ("wall_sec",
                                                        "train_sec",
                                                        "stall_sec"))
        assert cp["wall_sec"] == pytest.approx(
            cp["train_sec"] + parts, rel=1e-6, abs=1e-6)
        assert cp["bottleneck"] in ("device",) + trace.BOUNDARY_STAGES
    # every pass event carries the tiered table's occupancy and pending
    passes = [e for e in mem.events if e.get("event") == "pass"]
    assert all(e["kind"] == "train_pass_resident_sharded" for e in passes)
    assert all("pending" in e["table"] and e["table"]["used"] > 0
               for e in passes)


def test_jsonl_report_renders_bottleneck_column(fresh_hub):
    """The port's telemetry_report renders the per-pass bottleneck
    column and the whole-run critical-path summary exactly as the
    reference's does."""
    import importlib.util
    import os
    from paddlebox_tpu_torch.tools import telemetry_report as mod
    spec = importlib.util.spec_from_file_location(
        "telemetry_report_ref",
        os.path.join(os.path.dirname(__file__), os.pardir, "scripts",
                     "telemetry_report.py"))
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    events = []
    for i in range(8):
        train = 0.5 if i == 1 else 1.0
        cp = (trace.critical_path_block(train, {"build_wait": 0.74})
              if i == 1 else
              trace.critical_path_block(train, {"build_wait": 0.01}))
        events.append({"event": "pass", "ts": i, "seq": i, "proc": 0,
                       "kind": "train_pass_resident", "pass_seq": i + 1,
                       "batches": 4, "examples": 100,
                       "elapsed_sec": train,
                       "examples_per_sec": 100.0 / train,
                       "critical_path": cp})
    report = mod.render_report(events)
    assert report == ref.render_report(events)
    assert "bottleneck" in report
    assert "7/8 passes device-bound" in report
    assert "pass 2 build_wait-bound: +0.740s" in report
