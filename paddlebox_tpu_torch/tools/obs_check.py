"""Black-box observability gate for the port (its copy of
``scripts/obs_check.py``): every anomaly trigger must yield exactly ONE
well-formed postmortem bundle, every default alert rule must fire AND
clear deterministically, and the flags-off overhead of the whole
black-box layer must stay bounded.

One seeded scenario (``run_obs_check``), eight legs against ONE hub +
ONE flight recorder so bundle sequence numbers are provable:

1. **quality + NaN rollback** — a real ``Trainer.run_pass`` loop over
   seeded criteo files with ``quality_window_passes`` on emits
   ``quality_window`` events + ``pbox_quality_*`` instruments; then a
   poisoned pass (``NanInfError`` with a boundary checkpoint) rolls
   back, books ``pbox_nan_rollbacks_total`` and dumps exactly one
   ``nan_rollback`` bundle.
2. **corrupt reload tip** — ``BoxPSHelper`` publishes base+delta, the
   delta gets a flipped byte, three ``ReloadLoop.poll_once`` refusals
   fire the ``reload_degrade`` trigger thrice — debounce collapses
   them into ONE bundle; serving stays on the prior version.
3. **pipeline hang** — a ``PassEpilogue`` job sleeps past
   ``pipeline_wait_timeout_sec``; the fence raises
   ``PipelineHangError`` and ``note_hang`` dumps one
   ``pipeline_hang`` bundle with live thread stacks.
4. **alerts fire/clear** — every default rule is driven over its
   threshold and back via ``evaluate_once``; the first fire dumps ONE
   ``slo_breach`` bundle (debounce eats the storm); the two membership
   rules route to ONE separate ``membership_change`` bundle.
5. **manual dump** — ``hub.dump_blackbox(reason)`` → one ``manual``
   bundle.
6. **rotation + torn tail** — a size-capped ``JsonlSink`` rotates into
   a keep-K set; ``telemetry_report.load_events`` reads the rotated
   set oldest-first and skips a torn final line with a warning.
7. **/alertz + /healthz** — the debug routes serve the alert status
   and the healthz alerts block.
8. **flags-off overhead** — with defaults off the hub is inert and
   100k emit + 100k trigger no-ops stay under a generous wall bound.

Every bundle is schema-checked (``BUNDLE_SCHEMA`` keys). ``main()``
runs the scenario twice with the same seed and asserts an identical
outcome.

Usage::

    python -m paddlebox_tpu_torch.tools.obs_check [--seed 7]
        [--device cuda|cpu]

The trainer and the server run on the card unless ``--device cpu``.
Exit code 0 == every trigger/rule behaved + deterministic.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
import urllib.request

# the 12 keys every postmortem bundle must carry (flightrec.BUNDLE_SCHEMA)
BUNDLE_KEYS = frozenset((
    "schema", "trigger", "reason", "ctx", "ts", "run", "health", "ring",
    "instruments", "critical_path", "flags", "threads"))

# generous CI bound for 200k flags-off no-ops (the real number is ~ns/op;
# the bound only guards against an accidental O(sinks) or lock on the
# inert path)
OVERHEAD_WALL_SEC = 5.0


def _bundle_names(rec) -> list:
    return [os.path.basename(p) for p in rec.bundles()]


def _check_bundle(path: str) -> dict:
    with open(path) as fh:
        b = json.load(fh)
    missing = BUNDLE_KEYS - set(b)
    assert not missing, f"bundle {path} missing keys: {sorted(missing)}"
    assert b["schema"] == 1
    assert isinstance(b["ring"], list)
    assert isinstance(b["threads"], dict) and b["threads"], \
        "bundle carries no thread stacks"
    assert isinstance(b["instruments"], dict)
    assert isinstance(b["flags"], dict) and "flightrec_dir" in b["flags"]
    return b


# ---- leg 1: quality window + NaN rollback ------------------------------
def _run_quality_nan_leg(workdir: str, seed: int, out: dict,
                         device: str) -> None:
    import numpy as np
    import torch

    from paddlebox_tpu_torch.data import DataFeedDesc, DatasetFactory
    from paddlebox_tpu_torch.data.criteo import generate_criteo_files
    from paddlebox_tpu_torch.models import CtrDnn
    from paddlebox_tpu_torch.obs.hub import get_hub
    from paddlebox_tpu_torch.obs.sinks import MemorySink
    from paddlebox_tpu_torch.ps.sgd import SparseSGDConfig
    from paddlebox_tpu_torch.ps.table import EmbeddingTable
    from paddlebox_tpu_torch.train.checkpoint import CheckpointManager
    from paddlebox_tpu_torch.train.trainer import NanInfError, Trainer

    hub = get_hub()
    files = generate_criteo_files(os.path.join(workdir, "data"),
                                  num_files=2, rows_per_file=160,
                                  vocab_per_slot=30, seed=seed)
    desc = DataFeedDesc.criteo(batch_size=32)
    desc.key_bucket_min = 2048
    cfg = SparseSGDConfig(mf_create_thresholds=0.0, mf_initial_range=0.0)
    table = EmbeddingTable(mf_dim=4, capacity=1 << 12, cfg=cfg,
                           unique_bucket_min=2048, device=device)
    torch.manual_seed(seed)
    tr = Trainer(CtrDnn(26, 3 + 4, 13, hidden=(8,),
                        compute_dtype=torch.float32), table, desc,
                 tx=lambda p: torch.optim.Adam(p, lr=1e-2), seed=0,
                 device=device)
    ds = DatasetFactory().create_dataset("InMemoryDataset", desc)
    ds.set_filelist(files)
    ds.load_into_memory()

    mem = MemorySink()
    hub.add_sink(mem)
    cm = CheckpointManager(os.path.join(workdir, "ckpt"))
    for _ in range(3):          # fill the quality window
        tr.run_pass(ds, checkpoint=cm)
        cm.save(tr)

    qevs = [e for e in mem.events if e["event"] == "quality_window"]
    out["quality_windows"] = len(qevs)
    out["quality_degraded_flag_seen"] = all(
        "degraded" in e for e in qevs)
    snap = hub.snapshot()
    out["quality_instruments"] = sorted(
        n for n in snap if n.startswith("pbox_quality_"))

    # poison ONE pass: NanInfError with a boundary target rolls back,
    # books the counter and dumps exactly one nan_rollback bundle
    real = tr.train_pass
    calls = []

    def poisoned_once(*a, **kw):
        calls.append(1)
        if len(calls) == 1:
            raise NanInfError("nan/inf loss at step 3 (injected)")
        return real(*a, **kw)

    tr.train_pass = poisoned_once
    res = tr.run_pass(ds, checkpoint=cm, max_retries=1)
    out["nan_retried_and_recovered"] = (
        len(calls) == 2 and bool(np.isfinite(res["last_loss"])))
    out["nan_rollbacks_total"] = hub.counter(
        "pbox_nan_rollbacks_total", "").value()
    hub.remove_sink(mem)


# ---- leg 2: corrupt reload tip -----------------------------------------
def _run_corrupt_tip_leg(workdir: str, seed: int, out: dict,
                         device: str) -> None:
    import numpy as np
    import torch

    from paddlebox_tpu_torch.artifacts import ArtifactStore
    from paddlebox_tpu_torch.data.schema import DataFeedDesc
    from paddlebox_tpu_torch.models import CtrDnn
    from paddlebox_tpu_torch.ps.box_helper import BoxPSHelper
    from paddlebox_tpu_torch.ps.sgd import SparseSGDConfig
    from paddlebox_tpu_torch.ps.table import FIELD_COL, EmbeddingTable
    from paddlebox_tpu_torch.serving import ReloadLoop, ServingModel

    desc = DataFeedDesc.criteo(batch_size=16)
    cfg = SparseSGDConfig(mf_create_thresholds=1e9)
    t = EmbeddingTable(mf_dim=4, capacity=1 << 10, cfg=cfg, device=device)
    helper = BoxPSHelper(t)
    store = ArtifactStore(os.path.join(workdir, "registry_chaos"))

    def write(lo, hi, scale):
        keys = np.arange(lo, hi, dtype=np.uint64)
        rows = t.index.assign(keys)
        idx = torch.as_tensor(rows.astype(np.int64),
                              device=t.state.data.device)
        t.state.data[idx, FIELD_COL["embed_w"]] = torch.as_tensor(
            keys.astype(np.float32) * scale, device=t.state.data.device)
        t._touched[rows] = True

    write(1, 101, 2.0)
    v1 = helper.publish_base(store)
    srv = ServingModel(CtrDnn(26, 3 + 4, 13, hidden=(8,)), desc,
                       mf_dim=4, capacity=1 << 10, device=device)
    assert srv.adopt(store) == v1
    loop = ReloadLoop(srv, store, poll_sec=0.02)

    write(50, 151, 5.0)
    v2 = helper.publish_delta(store)
    p = os.path.join(store.version_dir(v2), "sparse_delta.npz")
    with open(p, "rb") as fh:
        blob = fh.read()
    flip = 13 % len(blob)
    with open(p, "wb") as fh:
        fh.write(blob[:flip] + bytes([blob[flip] ^ 0xFF])
                 + blob[flip + 1:])
    for _ in range(3):       # corrupt tip: no poll may swap it in
        assert loop.poll_once() is None
    out["corrupt_tip_not_adopted"] = (srv.adopted_aid == v1)
    # the store refuses the corrupt tip before hot_reload ever sees it;
    # the degrade path (serving BEHIND the tip) is what fires the
    # reload_degrade trigger — three polls, debounced into one bundle
    out["corrupt_refused_loud"] = (loop.degraded >= 3)


# ---- leg 3: pipeline hang ----------------------------------------------
def _run_hang_leg(out: dict) -> None:
    from paddlebox_tpu_torch.config import flags_scope
    from paddlebox_tpu_torch.ps.epilogue import PassEpilogue, PipelineHangError

    ep = PassEpilogue("obs_check")
    ep.submit(lambda: time.sleep(0.6), label="wedge")
    hung = False
    with flags_scope(pipeline_wait_timeout_sec=0.15):
        try:
            ep.fence()
        except PipelineHangError:
            hung = True
    out["hang_raised"] = hung
    ep.fence()               # job finishes; drain cleanly


# ---- leg 4: alerts fire/clear ------------------------------------------
def _run_alerts_leg(out: dict) -> None:
    from paddlebox_tpu_torch.obs.alerts import AlertEngine, default_rules
    from paddlebox_tpu_torch.obs.hub import get_hub
    from paddlebox_tpu_torch.obs.instruments import SERVING_LATENCY_BUCKETS

    hub = get_hub()
    engine = AlertEngine(hub, rules=default_rules())
    hub.set_alerts_probe(engine.status)
    out["alert_rules"] = sorted(r.name for r in engine.rules)

    # pin every watched metric to a quiet baseline so the first eval is
    # transition-free, then drive each rule over its threshold and back
    hub.gauge("pbox_serving_staleness_sec", "").set(0.0)
    hub.gauge("pbox_stream_lag_files", "").set(0.0)
    hub.gauge("pbox_quality_degraded", "").set(0.0)
    hub.gauge("pbox_online_windows_since_shrink", "").set(0.0)
    hub.gauge("pbox_membership_degraded", "").set(0.0)
    hub.counter("pbox_membership_scale_events_total", "").inc(
        n=0, direction="lost")
    hist = hub.histogram("pbox_serving_latency_seconds", "",
                         buckets=SERVING_LATENCY_BUCKETS)
    for _ in range(50):
        hist.observe(0.0002, op="predict")
    # trend baselines: the hang + NaN legs already booked these counters
    hub.counter("pbox_pipeline_hangs_total", "").inc(n=0)
    hub.counter("pbox_nan_rollbacks_total", "").inc(n=0)

    transitions = []

    def ev():
        for tr in engine.evaluate_once():
            transitions.append((tr["rule"], tr["to"]))

    ev()
    baseline_clean = not transitions
    # threshold rules: breach, eval, restore, eval
    hub.gauge("pbox_serving_staleness_sec", "").set(1e4)
    ev()
    hub.gauge("pbox_serving_staleness_sec", "").set(0.0)
    ev()
    hub.gauge("pbox_stream_lag_files", "").set(1e4)
    ev()
    hub.gauge("pbox_stream_lag_files", "").set(0.0)
    ev()
    hub.gauge("pbox_quality_degraded", "").set(1.0)
    ev()
    hub.gauge("pbox_quality_degraded", "").set(0.0)
    ev()
    for _ in range(10):            # p99 over the bound...
        hist.observe(0.9, op="predict")
    ev()
    for _ in range(5000):          # ...diluted back under it
        hist.observe(0.0002, op="predict")
    ev()
    # trend rules: one increment fires, the flat next window clears
    hub.counter("pbox_pipeline_hangs_total", "").inc(stage="endpass")
    ev()
    ev()
    hub.counter("pbox_nan_rollbacks_total", "").inc()
    ev()
    ev()
    # online lifecycle rules (docs/ONLINE.md): shrink_overdue is a
    # plain threshold on windows since the last shrink cycle...
    hub.gauge("pbox_online_windows_since_shrink", "").set(1e4)
    ev()
    hub.gauge("pbox_online_windows_since_shrink", "").set(0.0)
    ev()
    # ...backlog_growth needs the lag RISING across three consecutive
    # evaluations (values stay far under the stream_lag threshold so
    # the sibling rule on the same metric sleeps through this)
    for lag in (1.0, 2.0, 3.0, 4.0):
        hub.gauge("pbox_stream_lag_files", "").set(lag)
        ev()
    hub.gauge("pbox_stream_lag_files", "").set(0.0)
    ev()
    # elastic membership rules (docs/RESILIENCE.md §Elastic
    # membership): rank_dead trends the `lost` series of the scale
    # counter — one lost rank fires, a flat window clears...
    hub.counter("pbox_membership_scale_events_total", "").inc(
        direction="lost")
    ev()
    ev()
    # ...world_degraded is a plain threshold on the degraded gauge
    # (1 while running below target np)
    hub.gauge("pbox_membership_degraded", "").set(1.0)
    ev()
    hub.gauge("pbox_membership_degraded", "").set(0.0)
    ev()

    out["alerts_baseline_clean"] = baseline_clean
    out["alert_transitions"] = transitions
    fired = [r for r, to in transitions if to == "fired"]
    cleared = [r for r, to in transitions if to == "cleared"]
    out["alerts_all_fired_and_cleared"] = (
        sorted(set(fired)) == out["alert_rules"]
        and sorted(set(cleared)) == out["alert_rules"])
    out["alerts_none_left_firing"] = not engine.active()
    out["alerts_fired_total"] = {
        r: hub.counter("pbox_alerts_fired_total", "").value(rule=r)
        for r in out["alert_rules"]}


# ---- leg 6: rotation + torn tail ---------------------------------------
def _run_rotation_leg(workdir: str, out: dict) -> None:
    import glob

    from paddlebox_tpu_torch.obs.sinks import JsonlSink
    from paddlebox_tpu_torch.tools.telemetry_report import load_events

    path = os.path.join(workdir, "rot", "events.jsonl")
    os.makedirs(os.path.dirname(path))
    sink = JsonlSink(path, max_bytes=1500, keep=2)
    for i in range(120):
        sink.emit({"event": "tick", "i": i, "pad": "x" * 40})
    sink.close()
    out["rotated_set"] = sorted(
        os.path.basename(f) for f in glob.glob(path + "*"))
    whole = load_events(path)
    out["rotation_oldest_first"] = (
        [e["i"] for e in whole] == sorted(e["i"] for e in whole))
    # a torn tail (writer killed mid-write) must be skipped, not fatal
    with open(path, "ab") as fh:
        fh.write(b'{"event": "torn')
    torn = load_events(path)
    out["torn_tail_skipped"] = (len(torn) == len(whole))


# ---- leg 7: debug routes -----------------------------------------------
def _run_http_leg(out: dict) -> None:
    from paddlebox_tpu_torch.obs.hub import get_hub

    hub = get_hub()
    srv = hub.start_prom_http(0)
    port = srv.server_address[1]
    try:
        az = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{port}/alertz", timeout=5).read())
        out["alertz_ok"] = (len(az["rules"]) == len(out["alert_rules"])
                            and az["firing"] == 0)
        hz = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{port}/healthz", timeout=5).read())
        out["healthz_alerts_block"] = (
            hz.get("alerts", {}).get("rules") == len(out["alert_rules"])
            and hz.get("alerts", {}).get("firing") == 0)
        metrics = urllib.request.urlopen(
            f"http://127.0.0.1:{port}/metrics", timeout=5).read().decode()
        out["metrics_expose_alerts"] = "pbox_alerts_active" in metrics
        out["metrics_expose_bundles"] = \
            "pbox_flightrec_bundles_total" in metrics
    finally:
        srv.shutdown()


# ---- leg 8: flags-off overhead -----------------------------------------
def _run_overhead_leg(out: dict) -> None:
    from paddlebox_tpu_torch.obs import flightrec
    from paddlebox_tpu_torch.obs.hub import reset_hub

    hub = reset_hub()          # defaults-off: no sinks, no recorder
    out["inert_hub_inactive"] = not hub.active
    out["inert_no_recorder"] = flightrec.get_recorder() is None
    t0 = time.perf_counter()
    for i in range(100_000):
        hub.emit("tick", i=i)
    for i in range(100_000):
        flightrec.trigger("manual", reason="noop")
    wall = time.perf_counter() - t0
    out["overhead_ok"] = wall < OVERHEAD_WALL_SEC
    out["still_inactive_after"] = not hub.active


# ---- scenario ----------------------------------------------------------
def run_obs_check(workdir: str, seed: int = 7,
                  device: str = "cuda") -> dict:
    """The full black-box scenario. Deterministic for a fixed seed:
    the outcome dict holds only structural facts (counts, bools,
    bundle filenames, transition sequences). The trainer and the
    server of legs 1-2 run on ``device``."""
    from paddlebox_tpu_torch.config import flags_scope
    from paddlebox_tpu_torch.obs import flightrec
    from paddlebox_tpu_torch.obs.hub import get_hub, reset_hub

    out = {}
    reset_hub()
    bb_dir = os.path.join(workdir, "blackbox")
    with flags_scope(flightrec_dir=bb_dir, flightrec_ring_events=256,
                     flightrec_debounce_sec=600.0, flightrec_keep=16,
                     quality_window_passes=2, quality_auc_drop=0.01,
                     quality_calibration_buckets=5):
        flightrec.configure_from_flags()
        rec = flightrec.get_recorder()
        assert rec is not None, "flightrec_dir did not install a recorder"
        hub = get_hub()
        assert hub.active, "recorder sink must activate the hub"

        _run_quality_nan_leg(workdir, seed, out, device)
        _run_corrupt_tip_leg(workdir, seed, out, device)
        _run_hang_leg(out)
        _run_alerts_leg(out)
        hub.dump_blackbox("obs_check operator dump")

        # ---- bundle audit: exactly one per trigger, schema-complete,
        # seq-ordered names (the debounce ate the reload + SLO storms)
        names = _bundle_names(rec)
        out["bundles"] = names
        triggers = [n.split("-", 2)[2].rsplit(".", 1)[0] for n in names]
        out["bundle_triggers"] = triggers
        out["one_bundle_per_trigger"] = (
            len(triggers) == len(set(triggers)))
        schema_ok = True
        for pth in rec.bundles():
            _check_bundle(pth)
        out["bundles_schema_ok"] = schema_ok
        # the alerts leg fired every default rule; debounce collapsed
        # the SLO storm into the single slo_breach bundle audited above
        # (the two membership rules route to their own
        # membership_change bundle — a topology fact, not an SLO
        # breach — likewise collapsed to one by the debounce)
        out["slo_breach_suppressed"] = hub.counter(
            "pbox_flightrec_suppressed_total",
            "").value(trigger="slo_breach")

        _run_rotation_leg(workdir, out)
        _run_http_leg(out)

    _run_overhead_leg(out)
    reset_hub()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--device", default="cuda",
                    help="where legs 1-2 train and serve (cuda or cpu)")
    ap.add_argument("--keep", action="store_true",
                    help="keep the scratch workdirs")
    args = ap.parse_args()

    outcomes = []
    for run in (1, 2):
        wd = tempfile.mkdtemp(prefix=f"obs_check_r{run}_")
        try:
            outcomes.append(run_obs_check(wd, seed=args.seed,
                                          device=args.device))
        finally:
            if not args.keep:
                import shutil
                shutil.rmtree(wd, ignore_errors=True)
    print(json.dumps(outcomes[-1], indent=2, sort_keys=True))
    checks = {
        "nan leg": outcomes[-1]["nan_retried_and_recovered"],
        "corrupt tip": (outcomes[-1]["corrupt_tip_not_adopted"]
                        and outcomes[-1]["corrupt_refused_loud"]),
        "hang": outcomes[-1]["hang_raised"],
        "alerts": outcomes[-1]["alerts_all_fired_and_cleared"],
        "bundles": (outcomes[-1]["one_bundle_per_trigger"]
                    and outcomes[-1]["bundles_schema_ok"]),
        "rotation": outcomes[-1]["rotation_oldest_first"]
                    and outcomes[-1]["torn_tail_skipped"],
        "routes": outcomes[-1]["alertz_ok"],
        "overhead": outcomes[-1]["overhead_ok"],
        "deterministic": outcomes[0] == outcomes[1],
    }
    for name, ok in checks.items():
        print(f"{'PASS' if ok else 'FAIL'}  {name}")
    return 0 if all(checks.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
