"""TelemetryHub — the unified observability surface (counterpart of
``paddlebox_tpu/obs/hub.py``).

One hub per process unifies the pre-existing primitives (``StatRegistry``
counters, ``StageTimers`` per-pass reports, ``ChromeTraceWriter`` spans,
``device_mem_used`` HBM probes) behind typed instruments (obs/instruments)
with pluggable sinks:

- **event sinks** (``JsonlSink``...) get one structured record per
  pass/alert — the machine-readable PrintSyncTimer;
- **span sinks** (``ChromeSpanSink``) get completed timed spans;
- **Prometheus**: ``snapshot_prom()`` renders every instrument (plus the
  legacy ``STATS`` registry, bridged as ``pbox_stat`` gauges) in text
  exposition format; ``start_prom_http`` serves it from a background
  thread.

Hot-loop contract: with no sinks attached the hub is INERT — call sites
guard on ``hub.active`` (a plain bool attribute, one dict-free attribute
read) before building any event payload, so default-off telemetry costs
nothing measurable per step.

Enable via flags: ``FLAGS.telemetry_jsonl=/path/run.jsonl`` attaches a
JSONL sink, ``FLAGS.telemetry_prom_port>=0`` starts the HTTP endpoint
(``configure_from_flags`` is called by Trainer init).

Differences from the reference: the pass event's ``hbm`` block reads the
CUDA caching allocator of the pass's device (``utils/monitor.
device_mem_used``: bytes in use, peak, the card's total memory; zeros
for the CPU), a host query that adds no device synchronization; and
``_process_index`` is ``torch.distributed``'s rank when a process group
is initialized, else 0.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Dict, Iterator, List, Optional, Sequence

from paddlebox_tpu_torch.obs.instruments import (Counter, Gauge, Histogram,
                                           Instrument, iter_prom_lines)
from paddlebox_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)


class TelemetryHub:
    def __init__(self, run_id: Optional[str] = None) -> None:
        self.run_id = run_id or f"{int(time.time())}-{os.getpid()}"
        self._lock = threading.Lock()
        self._instruments: Dict[str, Instrument] = {}
        self._event_sinks: List = []
        self._span_sinks: List = []
        self._prom_server = None
        self._proc: Optional[int] = None
        self._seq = 0
        # liveness surface (/healthz on the prom endpoint): run start +
        # the last pass event's wall clock / count
        self.started_at = time.time()
        self._last_pass_ts: Optional[float] = None
        self._pass_count = 0
        # serving surface (serving.ServingModel/ReloadLoop register a
        # probe): /healthz grows a "serving" block and /readyz refuses
        # (503) until the probe reports a first snapshot adoption
        self._serving_probe = None
        # alerts surface (obs/alerts.AlertEngine registers its status):
        # /healthz grows an "alerts" block and /alertz serves it whole
        self._alerts_probe = None
        # online-daemon surface (online.OnlineLearner registers its
        # status): /healthz grows an "online" block — windows, backlog,
        # publish/shrink timestamps, and the daemon's degrade mode
        self._online_probe = None
        # elastic-membership surface (distributed.elastic.ElasticManager
        # registers its status on register()): /healthz grows a
        # "membership" block — alive set, np window, last scale event,
        # re-shard count (docs/RESILIENCE.md §Elastic membership)
        self._membership_probe = None
        # per-sink CONSECUTIVE failure counts (sink fault isolation): a
        # sink that keeps raising gets quarantined — removed from the
        # fan-out — after FLAGS.telemetry_sink_errors_max failures
        self._sink_fails: Dict[int, int] = {}
        # fast-path flag: any sink attached / endpoint running. Hot call
        # sites read this one attribute and skip all payload assembly.
        self.active = False

    # ---- instruments ---------------------------------------------------
    def _get(self, cls, name: str, help: str, **kw) -> Instrument:
        with self._lock:
            inst = self._instruments.get(name)
            if inst is None:
                inst = self._instruments[name] = cls(name, help, **kw)
            elif not isinstance(inst, cls):
                raise TypeError(f"instrument {name!r} already registered "
                                f"as {inst.kind}")
            return inst

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets: Optional[Sequence[float]] = None) -> Histogram:
        return self._get(Histogram, name, help,
                         **({"buckets": buckets} if buckets else {}))

    # ---- sinks ---------------------------------------------------------
    def _refresh_active(self) -> None:
        self.active = bool(self._event_sinks or self._span_sinks
                           or self._prom_server is not None)

    def add_sink(self, sink, kind: Optional[str] = None) -> None:
        """Attach an event sink (has ``emit(dict)``), a span sink (has
        ``span(name, start, dur, attrs)`` or the rich
        ``span_full(rec)``), or BOTH — a dual-capability sink registers
        in both lists (the pre-fix behavior silently filed it as
        span-only, dropping its events). ``kind`` overrides the
        auto-classification: "event", "span", or "both"."""
        if kind not in (None, "event", "span", "both"):
            raise ValueError(f"unknown sink kind: {kind!r}")
        as_span = (hasattr(sink, "span") or hasattr(sink, "span_full")
                   if kind is None else kind in ("span", "both"))
        as_event = (hasattr(sink, "emit") if kind is None
                    else kind in ("event", "both"))
        if kind is not None:
            # an explicit kind must be honorable: registering a sink
            # for a capability it lacks would fail at first emit
            if kind in ("event", "both") and not hasattr(sink, "emit"):
                raise TypeError(f"sink {sink!r} has no emit()")
            if kind in ("span", "both") and not (
                    hasattr(sink, "span") or hasattr(sink, "span_full")):
                raise TypeError(f"sink {sink!r} has no span()/span_full()")
        if not (as_span or as_event):
            raise TypeError(
                f"sink {sink!r} exposes neither emit() nor span()")
        with self._lock:
            if as_span:
                self._span_sinks.append(sink)
            if as_event:
                self._event_sinks.append(sink)
            self._refresh_active()

    def remove_sink(self, sink) -> None:
        with self._lock:
            for ls in (self._event_sinks, self._span_sinks):
                if sink in ls:
                    ls.remove(sink)
            self._refresh_active()

    def close_sinks(self) -> None:
        with self._lock:
            # dual-capability sinks sit in both lists — close once
            sinks = list({id(s): s for s in
                          self._event_sinks + self._span_sinks}.values())
            self._event_sinks = []
            self._span_sinks = []
            self._refresh_active()
        for s in sinks:
            try:
                s.close()
            except Exception:  # a dying sink must not take the run down
                log.warning("telemetry sink close failed", exc_info=True)

    def event_sinks(self) -> List:
        return list(self._event_sinks)

    def span_sinks(self) -> List:
        return list(self._span_sinks)

    # ---- events --------------------------------------------------------
    def _process_index(self) -> int:
        if self._proc is None:
            try:
                import torch.distributed as dist
                self._proc = (dist.get_rank()
                              if dist.is_available()
                              and dist.is_initialized() else 0)
            except Exception:
                self._proc = 0
        return self._proc

    def emit(self, event: str, **fields) -> None:
        """Emit one structured event to every event sink. Timestamps are
        wall-clock and ``seq`` is a per-hub monotone sequence number, so
        JSONL consumers can order events even across clock steps."""
        sinks = self._event_sinks
        if not sinks:
            return
        with self._lock:
            self._seq += 1
            seq = self._seq
        ev = {"ts": time.time(), "seq": seq, "event": event,
              "run": self.run_id, "proc": self._process_index()}
        ev.update(fields)
        for s in sinks:
            try:
                s.emit(ev)
                if self._sink_fails:
                    self._sink_fails.pop(id(s), None)
            except Exception:
                self._sink_error(s, "emit")

    @contextlib.contextmanager
    def span(self, name: str, **attrs) -> Iterator[None]:
        """Run-scoped timed span → span sinks (no-op without any)."""
        sinks = self._span_sinks
        if not sinks:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dur = time.perf_counter() - t0
            for s in sinks:
                try:
                    s.span(name, t0, dur, attrs)
                    if self._sink_fails:
                        self._sink_fails.pop(id(s), None)
                except Exception:
                    self._sink_error(s, "span")

    def _sink_error(self, sink, surface: str) -> None:
        """Sink fault isolation: a raising sink never reaches the
        training hot path — book the failure, and after
        ``FLAGS.telemetry_sink_errors_max`` CONSECUTIVE failures
        quarantine it (remove from the fan-out) so a wedged sink can't
        keep burning the emit path on exceptions."""
        name = type(sink).__name__
        log.warning("telemetry %s sink failed (%s)", surface, name,
                    exc_info=True)
        try:
            self.counter("pbox_sink_errors_total",
                         "telemetry sink emit/span failures").inc(
                             sink=name)
            try:
                from paddlebox_tpu_torch.config import FLAGS
                limit = int(FLAGS.telemetry_sink_errors_max)
            except Exception:
                limit = 8
            fails = self._sink_fails.get(id(sink), 0) + 1
            self._sink_fails[id(sink)] = fails
            if limit > 0 and fails >= limit:
                self._sink_fails.pop(id(sink), None)
                self.remove_sink(sink)
                self.counter("pbox_sinks_quarantined_total",
                             "sinks removed after consecutive "
                             "failures").inc(sink=name)
                log.error("telemetry sink %s QUARANTINED after %d "
                          "consecutive failures", name, fails)
        except Exception:
            log.debug("sink error bookkeeping failed", exc_info=True)

    # ---- snapshots -----------------------------------------------------
    def snapshot(self) -> Dict[str, Dict]:
        """Structured dump: {name: {kind, series: {label_str: value}}}
        (histograms dump {sum, count} per series)."""
        with self._lock:
            insts = list(self._instruments.values())
        out: Dict[str, Dict] = {}
        for inst in insts:
            series: Dict[str, object] = {}
            for k, v in inst.series():
                key = ",".join(f"{n}={val}" for n, val in k)
                series[key] = ({"sum": v.sum, "count": v.count}
                               if inst.kind == "histogram" else v)
            out[inst.name] = {"kind": inst.kind, "series": series}
        return out

    def snapshot_prom(self) -> str:
        """Prometheus text exposition of every instrument + the legacy
        StatRegistry (bridged as ``pbox_stat{name=...}`` gauges)."""
        with self._lock:
            insts = sorted(self._instruments.values(),
                           key=lambda i: i.name)
        lines: List[str] = []
        for inst in insts:
            lines.extend(iter_prom_lines(inst))
        from paddlebox_tpu_torch.obs.instruments import escape_label_value
        from paddlebox_tpu_torch.utils.monitor import STATS
        stats = STATS.snapshot()
        if stats:
            lines.append("# TYPE pbox_stat gauge")
            for name, val in sorted(stats.items()):
                lines.append(
                    f'pbox_stat{{name="{escape_label_value(name)}"}}'
                    f' {val}')
        return "\n".join(lines) + "\n"

    def note_pass(self) -> None:
        """Stamp a completed pass for the /healthz liveness surface
        (emit_pass_event calls this on the active path)."""
        with self._lock:
            self._last_pass_ts = time.time()
            self._pass_count += 1

    # ---- serving surface (docs/SERVING.md) -----------------------------
    def set_serving_probe(self, probe) -> None:
        """Register (or clear, with None) the process's serving status
        provider — a callable returning the ``serving`` block for
        /healthz: ``{adopted, epoch, last_reload_ts, staleness_sec,
        stale}`` (serving.ServingModel.serving_status). One serving
        model per process owns the block; the last registration wins."""
        with self._lock:
            self._serving_probe = probe

    def serving_info(self) -> Optional[Dict]:
        """The registered probe's current block (None: no serving model
        in this process, or the probe failed — a broken probe must not
        take the health endpoint down)."""
        with self._lock:
            probe = self._serving_probe
        if probe is None:
            return None
        try:
            return probe()
        except Exception:
            log.warning("serving health probe failed", exc_info=True)
            return {"adopted": None, "error": "probe failed"}

    # ---- online-daemon surface (docs/ONLINE.md) ------------------------
    def set_online_probe(self, probe) -> None:
        """Register (or clear, with None) the online-learning daemon's
        status provider — a callable returning the ``online`` block for
        /healthz: ``{mode, windows_completed, files_backlog,
        last_publish_ts, last_shrink_ts, shrunk_rows_total, ...}``
        (online.OnlineLearner.online_status). One daemon per process;
        the last registration wins."""
        with self._lock:
            self._online_probe = probe

    def online_info(self) -> Optional[Dict]:
        """The registered daemon probe's current block (None: no online
        daemon in this process; a broken probe must not take the
        health endpoint down)."""
        with self._lock:
            probe = self._online_probe
        if probe is None:
            return None
        try:
            return probe()
        except Exception:
            log.warning("online daemon probe failed", exc_info=True)
            return {"mode": "unknown", "error": "probe failed"}

    # ---- elastic-membership surface (RESILIENCE.md §Elastic) -----------
    def set_membership_probe(self, probe) -> None:
        """Register (or clear, with None) the elastic manager's status
        provider — a callable returning the ``membership`` block for
        /healthz: ``{alive, np, min_np, max_np, last_scale_event_ts,
        reshard_count}`` (``distributed.elastic.ElasticManager.
        membership_status``, which ``register()`` installs). One manager
        per process; the last registration wins."""
        with self._lock:
            self._membership_probe = probe

    def membership_info(self) -> Optional[Dict]:
        """The registered membership probe's current block (None: no
        elastic manager in this process; a broken probe must not take
        the health endpoint down)."""
        with self._lock:
            probe = self._membership_probe
        if probe is None:
            return None
        try:
            return probe()
        except Exception:
            log.warning("membership health probe failed", exc_info=True)
            return {"alive": None, "error": "probe failed"}

    # ---- alerts surface (docs/OBSERVABILITY.md §Alerts) ----------------
    def set_alerts_probe(self, probe) -> None:
        """Register (or clear, with None) the alert engine's status
        provider (obs/alerts.AlertEngine.status) — the ``alerts`` block
        for /healthz and the whole /alertz payload."""
        with self._lock:
            self._alerts_probe = probe

    def alerts_info(self) -> Optional[Dict]:
        with self._lock:
            probe = self._alerts_probe
        if probe is None:
            return None
        try:
            return probe()
        except Exception:
            log.warning("alerts probe failed", exc_info=True)
            return {"error": "probe failed"}

    def dump_blackbox(self, reason: str) -> Optional[str]:
        """Explicitly publish a flight-recorder postmortem bundle (the
        ``manual`` trigger). Returns the bundle path, or None when no
        recorder is installed (``FLAGS.flightrec_dir`` unset) or the
        trigger was debounced."""
        from paddlebox_tpu_torch.obs import flightrec
        return flightrec.trigger("manual", reason=reason)

    def readiness(self) -> Dict:
        """The /readyz payload: ready only after the serving model's
        FIRST snapshot adoption (a serving process must not receive
        traffic while it still answers from an empty table). Processes
        with no serving probe registered are unready by definition —
        /readyz is a serving-role endpoint; training liveness is
        /healthz."""
        info = self.serving_info()
        if info is None:
            return {"ready": False, "reason": "no serving model"}
        if not info.get("adopted"):
            return {"ready": False, "reason": "no snapshot adopted yet",
                    "serving": info}
        return {"ready": True, "serving": info}

    def health(self) -> Dict:
        """The /healthz payload: run identity, uptime, and how stale
        the latest pass is — the liveness probe the serving/streaming
        loops poll (a wedged always-on trainer shows a growing
        ``last_pass_age_sec`` while the process still answers). When a
        serving model registered its probe, a ``serving`` block rides
        along (adopted version, last reload, snapshot staleness)."""
        now = time.time()
        with self._lock:
            last = self._last_pass_ts
            count = self._pass_count
        out = {
            "status": "ok",
            "run_id": self.run_id,
            "uptime_sec": round(now - self.started_at, 3),
            "passes_total": count,
            "last_pass_ts": last,
            "last_pass_age_sec": (None if last is None
                                  else round(now - last, 3)),
        }
        serving = self.serving_info()
        if serving is not None:
            out["serving"] = serving
        online = self.online_info()
        if online is not None:
            # the daemon's train+publish+serve verdict in one block:
            # mode != "full" means a leg degraded (docs/ONLINE.md)
            out["online"] = online
        membership = self.membership_info()
        if membership is not None:
            # the elastic world in one block: alive set vs the
            # [min_np, max_np] window, last scale event, re-shards
            out["membership"] = membership
        alerts = self.alerts_info()
        if alerts is not None:
            # /healthz carries the compact alarm view; /alertz the
            # full per-rule table
            out["alerts"] = {"firing": alerts.get("firing", 0),
                             "active": alerts.get("active", []),
                             "rules": len(alerts.get("rules", []))}
        return out

    # ---- Prometheus HTTP endpoint --------------------------------------
    def start_prom_http(self, port: int = 0):
        """Serve ``snapshot_prom()`` from a daemon thread — plus
        ``/healthz`` (JSON liveness: run_id, uptime, last-pass age);
        returns the server (``server.server_address[1]`` is the bound
        port — pass port=0 for an ephemeral one). Idempotent."""
        if self._prom_server is not None:
            return self._prom_server
        import http.server
        import json as _json

        hub = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 (http.server API)
                route = self.path.split("?", 1)[0]
                status = 200
                if route == "/healthz":
                    body = _json.dumps(hub.health()).encode()
                    ctype = "application/json"
                elif route == "/readyz":
                    # the serving readiness gate: 503 until the first
                    # snapshot adoption (docs/SERVING.md)
                    ready = hub.readiness()
                    status = 200 if ready["ready"] else 503
                    body = _json.dumps(ready).encode()
                    ctype = "application/json"
                elif route == "/alertz":
                    # the alert engine's full rule table (503 with the
                    # firing list non-empty — a dumb prober can alarm
                    # on status alone)
                    alerts = hub.alerts_info()
                    if alerts is None:
                        alerts = {"firing": 0, "active": [],
                                  "rules": [],
                                  "note": "no alert engine installed"}
                    status = 503 if alerts.get("firing") else 200
                    body = _json.dumps(alerts).encode()
                    ctype = "application/json"
                else:
                    body = hub.snapshot_prom().encode()
                    ctype = "text/plain; version=0.0.4"
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):  # quiet
                pass

        srv = http.server.ThreadingHTTPServer(("0.0.0.0", port), Handler)
        threading.Thread(target=srv.serve_forever, daemon=True,
                         name="pbox-prom-http").start()
        with self._lock:
            self._prom_server = srv
            self._refresh_active()
        log.info("prometheus endpoint on :%d", srv.server_address[1])
        return srv

    def stop_prom_http(self) -> None:
        with self._lock:
            srv, self._prom_server = self._prom_server, None
            self._refresh_active()
        if srv is not None:
            srv.shutdown()
            srv.server_close()


_HUB = TelemetryHub()
_configured_jsonl: Optional[str] = None


def get_hub() -> TelemetryHub:
    return _HUB


def active_hub() -> Optional[TelemetryHub]:
    """The hub when a sink is attached, else None (the call sites that
    only mirror into instruments skip all work on the inert path)."""
    return _HUB if _HUB.active else None


def reset_hub() -> TelemetryHub:
    """Fresh global hub (tests). Closes the old hub's sinks/endpoint
    and uninstalls the flag-configured flight recorder / alert engine /
    quality monitor so the next configure_from_flags starts clean."""
    global _HUB, _configured_jsonl
    _HUB.close_sinks()
    _HUB.stop_prom_http()
    try:
        from paddlebox_tpu_torch.obs import alerts, flightrec, quality
        flightrec.install_recorder(None)
        alerts.install_engine(None, register_probe=False)
        quality.reset_monitor()
    except Exception:
        log.debug("obs singleton reset failed", exc_info=True)
    _HUB = TelemetryHub()
    _configured_jsonl = None
    return _HUB


def configure_from_flags() -> TelemetryHub:
    """Attach flag-selected sinks to the global hub (idempotent; called
    by Trainer init so ``FLAGS_telemetry_jsonl=...`` in the environment
    is all a run needs)."""
    global _configured_jsonl
    from paddlebox_tpu_torch.config import FLAGS
    hub = _HUB
    path = FLAGS.telemetry_jsonl
    if path and path != _configured_jsonl:
        from paddlebox_tpu_torch.obs.sinks import JsonlSink
        hub.add_sink(JsonlSink(
            path,
            max_bytes=int(FLAGS.telemetry_jsonl_max_mb * 1024 * 1024),
            keep=FLAGS.telemetry_jsonl_keep))
        _configured_jsonl = path
    if FLAGS.telemetry_prom_port >= 0:
        hub.start_prom_http(FLAGS.telemetry_prom_port)
    # the anomaly flight recorder and the SLO alert engine ride the
    # same flag seam (both default-off; docs/OBSERVABILITY.md)
    from paddlebox_tpu_torch.obs import alerts, flightrec
    flightrec.configure_from_flags()
    alerts.configure_from_flags()
    return hub


def _event_device(table, device):
    """The device whose allocator the pass event reads: the caller's,
    else the table's (a sharded table's first shard), else the CPU."""
    if device is not None:
        return device
    dev = getattr(table, "device", None)
    if dev is None:
        devs = getattr(table, "devices", None)
        dev = devs[0] if devs else None
    return dev if dev is not None else "cpu"


def emit_pass_event(kind: str, metrics: Dict, stage_timers=None,
                    table=None, examples: Optional[int] = None,
                    auc_state=None, device=None) -> None:
    """THE per-pass telemetry record: pass metrics + stage timers +
    channel gauges + table occupancy + device memory watermarks, in one
    event and mirrored into instruments for the Prometheus view.
    Trainers call this at every pass end; it returns immediately when no
    sink is attached (the no-sink fast path). ``device``: whose
    allocator the ``hbm`` block reads (default: the table's)."""
    hub = _HUB
    if not hub.active:
        return
    ev: Dict = {"kind": kind}
    for k in ("batches", "elapsed_sec", "examples_per_sec", "auc",
              "last_loss", "global_step", "pass_seq",
              "exchange_overlap_frac", "actual_ctr", "predicted_ctr"):
        if k in metrics:
            ev[k] = metrics[k]
    if examples is not None:
        ev["examples"] = examples
    if stage_timers is not None:
        ev["stage_sec"] = {k: round(v, 6)
                           for k, v in stage_timers.as_dict().items()}
        ev["stage_count"] = stage_timers.counts()
        h = hub.histogram("pbox_stage_seconds",
                          "per-pass stage wall seconds")
        for k, v in ev["stage_sec"].items():
            h.observe(v, stage=k)
    # channel gauges (cumulative across the process; consumers diff
    # between consecutive pass events — tools/telemetry_report.py)
    from paddlebox_tpu_torch.utils.channel import channel_stats_snapshot
    chans = channel_stats_snapshot()
    if chans:
        ev["channels"] = chans
        depth_g = hub.gauge("pbox_channel_depth",
                            "items queued in named channels")
        hwm_g = hub.gauge("pbox_channel_high_watermark",
                          "peak queued items per named channel")
        bput = hub.counter("pbox_channel_blocked_put_seconds_total",
                           "producer seconds blocked on a full channel")
        bget = hub.counter("pbox_channel_blocked_get_seconds_total",
                           "consumer seconds blocked on an empty channel")
        for name, st in chans.items():
            depth_g.set(st["depth"], channel=name)
            hwm_g.set_max(st["high_watermark"], channel=name)
            # counters are monotone: add only the delta since last mirror
            for ctr, key in ((bput, "blocked_put_sec"),
                             (bget, "blocked_get_sec")):
                prev = ctr.value(channel=name)
                if st[key] > prev:
                    ctr.inc(st[key] - prev, channel=name)
    # table occupancy (+ the tiered tables' per-pass delta stats)
    if table is not None:
        tstats = {}
        if hasattr(table, "obs_stats"):
            tstats.update(table.obs_stats())
        lp = getattr(table, "last_pass_stats", None)
        if lp:
            tstats["last_pass"] = dict(lp)
        # async pass epilogue (ps/epilogue): cumulative write-back /
        # fence-wait / overlap seconds ride every pass event so the
        # JSONL alone shows how much end_pass left the critical path
        # (pbox_endpass_* gauges mirror from the epilogue itself)
        eps = getattr(table, "endpass_stats", None)
        if eps is not None:
            tstats["endpass"] = {k: (round(v, 6)
                                     if isinstance(v, float) else v)
                                 for k, v in eps().items()}
        if tstats:
            ev["table"] = tstats
            if "used" in tstats:
                hub.gauge("pbox_table_rows_used",
                          "occupied embedding rows").set(tstats["used"])
            if "capacity" in tstats:
                hub.gauge("pbox_table_rows_capacity",
                          "embedding row capacity").set(tstats["capacity"])
    # device memory watermarks (zeros on the CPU, which has no allocator
    # stats — the keys still ship so consumers are uniform)
    try:
        from paddlebox_tpu_torch.utils.monitor import device_mem_used
        hbm = device_mem_used(_event_device(table, device))
    except Exception:
        hbm = {"bytes_in_use": 0, "peak_bytes_in_use": 0, "bytes_limit": 0}
    ev["hbm"] = hbm
    # resilience counters (retries/quarantines/faults/pass retries) ride
    # every pass event so chaos runs are diagnosable from the JSONL
    # alone (docs/RESILIENCE.md; zeros ship for consumer uniformity)
    try:
        from paddlebox_tpu_torch.resilience.retry import retry_counters
        ev["resilience"] = retry_counters()
    except Exception:
        pass
    # critical-path attribution (obs/trace; docs/OBSERVABILITY.md
    # §Tracing): the pass loops reported each boundary stall
    # (preload wait, stage wait, emergency eviction, the previous
    # pass's end-submit + fence wait) into the trace accumulator —
    # consume them here so every TRAIN pass event carries the wall
    # attribution + bottleneck verdict telemetry_report renders
    if "elapsed_sec" in ev and kind.startswith(("train_pass",
                                                "stream")):
        from paddlebox_tpu_torch.obs import trace
        cp = trace.critical_path_block(ev["elapsed_sec"],
                                       trace.consume_pass_parts())
        ev["critical_path"] = cp
        hub.counter("pbox_pass_bottleneck_total",
                    "passes by critical-path bottleneck verdict"
                    ).inc(stage=cp["bottleneck"])
    hub.note_pass()
    hub.gauge("pbox_hbm_bytes_in_use",
              "device bytes in use").set(hbm["bytes_in_use"])
    hub.gauge("pbox_hbm_peak_bytes",
              "device peak bytes in use").set_max(hbm["peak_bytes_in_use"])
    hub.counter("pbox_passes_total", "completed passes").inc(kind=kind)
    if examples:
        hub.counter("pbox_examples_total",
                    "examples trained/evaluated").inc(examples)
    if "examples_per_sec" in ev:
        hub.gauge("pbox_last_pass_examples_per_sec",
                  "throughput of the latest pass").set(
                      ev["examples_per_sec"], kind=kind)
    # model-quality drift monitor (obs/quality; docs/OBSERVABILITY.md
    # §Model quality): windowed per-slot coverage/churn, norm drift,
    # calibration buckets and the AUC-trend verdict ride THIS seam —
    # off (the default) costs one flag read
    from paddlebox_tpu_torch.config import FLAGS
    if FLAGS.quality_window_passes > 0 and kind.startswith(
            ("train_pass", "stream")):
        from paddlebox_tpu_torch.obs import quality
        quality.note_pass_event(ev, table=table, auc_state=auc_state,
                                hub=hub)
    hub.emit("pass", **ev)
