"""Causal span tracing over the async pass pipeline (counterpart of
``paddlebox_tpu/obs/trace.py``).

Every pass is a concurrent machine — the preloader worker builds k+2,
the stage queue wires k+1, the main thread trains k, the epilogue lane
drains k-1's write-back plus eviction and SSD demotion — which stage
timers and counters see only from the main thread. This module adds
the CAUSAL view:

**Spans.** ``span(name, ...)`` times a region and emits a record
carrying ``(trace_id=run, pass_seq, span_id, parent_id, lane)`` to the
hub's span sinks. ``lane`` names the EXECUTING context — the catalog:

    main            the training thread
    preload.worker  the depth-N PassPreloader worker (build + stage)
    epilogue.lane   the PassEpilogue single-lane write-back worker
    ssd.compact     SSD watermark demotion + segment compaction (rides
                    the epilogue worker, rendered as its own service row)
    stream.reader   dataset reader threads

Parent ids nest automatically per thread (a ``pass.stage`` span opened
inside a ``pass.build`` span becomes its child). Cross-thread causality
uses explicit LINKS: the producer stashes its span id (e.g. the build
span's id rides the built pass as ``rp._trace_span_id``), and the
consumer opens its span with ``link_from=that_id`` — the Chrome sink
renders the link as a flow arrow from the source span's end to the
linked span's start, across lane rows.

**Inert-when-off.** Every entry point guards on the same contract as
the hub (``hub.active`` + a span sink attached): with no sinks the
span() context manager is two attribute reads and yields a shared null
handle — default-off tracing costs nothing measurable per pass.

**Chrome rendering.** ``ChromeLaneTraceSink`` writes spans into a
``utils.profiler.ChromeTraceWriter`` with one STABLE tid row per lane
(thread-name metadata events name the rows) and flow ("s"/"f") events
for links — chrome://tracing / Perfetto shows the four-deep pipeline as
four labeled lanes with arrows from each pass's preloader build to its
main-thread consume.

**Critical path.** The pass loops report each boundary stall into a
per-pass accumulator (``note_pass_part``); ``emit_pass_event`` consumes
it and attaches a ``critical_path`` block — wall time attributed across
train vs build-wait vs stage-wait vs fence-wait vs ssd-promote vs
evict-emergency — plus a per-pass ``bottleneck`` verdict, mirrored into
``pbox_pass_bottleneck_total{stage}``. Completed top-level spans
accumulate ``pbox_lane_busy_seconds_total{lane}``.
``tools/telemetry_report.py`` renders the per-pass verdicts and the
whole-run summary ("7/8 passes device-bound, pass 2 build-bound").

See docs/OBSERVABILITY.md §Tracing for the span schema and the lane /
flow-link semantics.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import OrderedDict
from typing import Dict, Iterator, Optional

from paddlebox_tpu_torch.obs.hub import get_hub
from paddlebox_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

#: the lane catalog (docs/OBSERVABILITY.md §Tracing). Free-form lane
#: names are legal; these are the rows the shipped pipeline uses.
LANE_MAIN = "main"
LANE_PRELOAD = "preload.worker"
LANE_EPILOGUE = "epilogue.lane"
LANE_SSD = "ssd.compact"
LANE_READER = "stream.reader"
#: device-side exchange/compute attribution: the sharded step's
#: chunked embedding exchanges and their interleaved pooling — spans
#: are ``a2a.pull.<k>`` / ``pool.<k>`` / ``a2a.push`` on this row
LANE_DEVICE = "device.a2a"
#: per-kernel device attribution: the embed-pool-CVM kernel family
#: measured by a kernel microbench — spans are ``kernel.<name>`` on
#: this row, one per timed probe re-run
LANE_KERNELS = "device.kernels"

_TLS = threading.local()   # .lane: str, .stack: List[int] (open span ids)
_ID_LOCK = threading.Lock()
_NEXT_ID = 1


def _new_span_id() -> int:
    global _NEXT_ID
    with _ID_LOCK:
        sid = _NEXT_ID
        _NEXT_ID += 1
    return sid


def tracing_active() -> bool:
    """True iff spans would actually be recorded: the hub is active AND
    at least one span sink is attached (the inert-when-off guard every
    span call site shares)."""
    hub = get_hub()
    return hub.active and bool(hub._span_sinks)


# ---- lanes -------------------------------------------------------------
def current_lane() -> str:
    """The calling thread's lane; defaults to ``main`` on the main
    thread and the thread's name elsewhere (workers that matter set
    their lane explicitly — PassPreloader, PassEpilogue, readers)."""
    lane = getattr(_TLS, "lane", None)
    if lane is not None:
        return lane
    t = threading.current_thread()
    return LANE_MAIN if t is threading.main_thread() else t.name


def set_lane(lane: str) -> None:
    """Pin the calling thread's lane for its lifetime (worker-thread
    entry points call this once at start)."""
    _TLS.lane = lane


@contextlib.contextmanager
def lane_scope(lane: str) -> Iterator[None]:
    """Temporarily relabel the calling thread's lane — e.g. the SSD
    demote/compact slot rides the epilogue worker but renders as the
    ``ssd.compact`` service row."""
    prev = getattr(_TLS, "lane", None)
    _TLS.lane = lane
    try:
        yield
    finally:
        _TLS.lane = prev


# ---- spans -------------------------------------------------------------
class SpanHandle:
    """What ``span()`` yields: enough identity for cross-thread links
    (stash ``span_id`` on the object crossing threads and pass it as the
    consumer span's ``link_from``)."""

    __slots__ = ("span_id", "lane", "name")

    def __init__(self, span_id: int, lane: str, name: str) -> None:
        self.span_id = span_id
        self.lane = lane
        self.name = name


#: shared null handle: the no-sink fast path allocates nothing
NULL_SPAN = SpanHandle(0, "", "")


def current_span_id() -> int:
    """The calling thread's innermost OPEN span id (0 when none) — the
    producer-side id for a cross-thread link created mid-span (e.g.
    end_pass links its submit span to the epilogue job it enqueues)."""
    stack = getattr(_TLS, "stack", None)
    return stack[-1] if stack else 0


@contextlib.contextmanager
def span(name: str, pass_seq: Optional[int] = None,
         lane: Optional[str] = None, link_from: int = 0,
         **attrs) -> Iterator[SpanHandle]:
    """Timed causal span → the hub's span sinks. Inert without sinks
    (yields ``NULL_SPAN``). ``link_from`` names a producer span on
    another thread; rich sinks render it as a flow arrow. Attrs ride the
    record (small, JSON-able values only)."""
    hub = get_hub()
    sinks = hub._span_sinks
    if not (hub.active and sinks):
        yield NULL_SPAN
        return
    ln = lane or current_lane()
    stack = getattr(_TLS, "stack", None)
    if stack is None:
        stack = _TLS.stack = []
    parent = stack[-1] if stack else 0
    sid = _new_span_id()
    handle = SpanHandle(sid, ln, name)
    stack.append(sid)
    t0 = time.perf_counter()
    try:
        yield handle
    finally:
        dur = time.perf_counter() - t0
        stack.pop()
        rec = {"name": name, "span_id": sid, "parent_id": parent,
               "lane": ln, "trace_id": hub.run_id, "t0": t0, "dur": dur,
               "link_from": link_from}
        if pass_seq is not None:
            rec["pass_seq"] = pass_seq
        if attrs:
            rec["attrs"] = attrs
        for s in sinks:
            try:
                full = getattr(s, "span_full", None)
                if full is not None:
                    full(rec)
                else:
                    plain = dict(attrs)
                    plain["lane"] = ln
                    if pass_seq is not None:
                        plain["pass_seq"] = pass_seq
                    s.span(name, t0, dur, plain)
            except Exception:
                log.warning("trace span sink failed", exc_info=True)
        if parent == 0:
            # lane occupancy counts TOP-LEVEL spans only (children are
            # contained in their parent's wall — counting both would
            # double-book the lane)
            hub.counter("pbox_lane_busy_seconds_total",
                        "seconds each pipeline lane spent in top-level "
                        "spans").inc(dur, lane=ln)


# ---- Chrome sink: per-lane rows + flow arrows --------------------------
class ChromeLaneTraceSink:
    """Span sink rendering causal spans as PER-LANE tid rows with flow
    arrows for cross-thread links in a chrome://tracing JSON.

    Unlike ``ChromeSpanSink`` (which keys rows off the raw OS
    thread id), rows here are the LANE catalog: one stable tid per lane
    name, labeled via thread-name metadata, ordered by first
    appearance. A span whose ``link_from`` names an already-rendered
    span gets a flow ("s" at the source span's end, "f" at this span's
    start) so the build→consume hand-off draws as an arrow across
    lanes.

    Pass an explicit ``utils.profiler.ChromeTraceWriter`` (then call
    ``writer.save(path)`` yourself), or None to follow whatever writer
    ``utils.profiler.set_chrome_trace`` installed at span time."""

    _DONE_CAP = 1024   # remembered (end, tid) of recent spans for links

    def __init__(self, writer=None) -> None:
        self._writer = writer
        self._lock = threading.Lock()
        self._lane_tids: Dict[str, int] = {}
        self._done: "OrderedDict[int, tuple]" = OrderedDict()

    def _resolve(self):
        w = self._writer
        if w is None:
            from paddlebox_tpu_torch.utils.profiler import chrome_trace
            w = chrome_trace()
        return w

    def _tid(self, w, lane: str) -> int:
        with self._lock:
            tid = self._lane_tids.get(lane)
            if tid is None:
                tid = self._lane_tids[lane] = len(self._lane_tids) + 1
                w.thread_meta(tid, lane, sort_index=tid)
            return tid

    def span_full(self, rec: Dict) -> None:
        w = self._resolve()
        if w is None:
            return
        tid = self._tid(w, rec["lane"])
        args = dict(rec.get("attrs") or {})
        args["span_id"] = rec["span_id"]
        if rec.get("parent_id"):
            args["parent_id"] = rec["parent_id"]
        if "pass_seq" in rec:
            args["pass_seq"] = rec["pass_seq"]
        args["lane"] = rec["lane"]
        t0, dur = rec["t0"], rec["dur"]
        w.complete(rec["name"], t0, dur, tid=tid, **args)
        link = rec.get("link_from", 0)
        with self._lock:
            self._done[rec["span_id"]] = (t0 + dur, tid)
            while len(self._done) > self._DONE_CAP:
                self._done.popitem(last=False)
            src = self._done.get(link) if link else None
        if src is not None:
            src_end, src_tid = src
            # the arrow leaves the source span's END and binds to this
            # span's START; a source that outlived its consumer's start
            # (a submit span closing after its job began) clamps so the
            # arrow still flows forward
            w.flow(link, "s", min(src_end, t0), src_tid,
                   name=rec["name"])
            w.flow(link, "f", t0, tid, name=rec["name"])

    def span(self, name: str, start_s: float, dur_s: float,
             attrs: Optional[Dict] = None) -> None:
        """Plain hub spans (TelemetryHub.span) land on the emitting
        thread's lane row too — same timeline, no links."""
        self.span_full({"name": name, "span_id": 0, "parent_id": 0,
                        "lane": current_lane(), "t0": start_s,
                        "dur": dur_s, "attrs": attrs or {},
                        "link_from": 0})

    def close(self) -> None:
        pass


# ---- per-pass critical-path attribution --------------------------------
#: boundary stage keys the pass loops report (note_pass_part); "train" is
#: implicit (the pass event's elapsed_sec). Order = report/docs order.
#: ``exchange_wait`` is the sharded step's measured NON-overlapped
#: embedding-exchange seconds per pass (train/a2a_probe): the part of
#: the pull/push all_to_all the schedule could not hide behind compute.
BOUNDARY_STAGES = ("build_wait", "stage_wait", "fence_wait",
                   "ssd_promote", "evict_emergency", "evict_scatter",
                   "exchange_wait", "end_submit")

_PARTS_LOCK = threading.Lock()
_PENDING_PARTS: Dict[str, float] = {}


def note_pass_part(stage: str, sec: float) -> None:
    """Report one boundary stall component for the UPCOMING pass event
    (pass loops call this as each boundary phase completes: preload wait,
    begin-stall pieces, the previous pass's end-submit and fence wait).
    Inert without sinks — the parts exist to ride the pass event."""
    if sec <= 0 or not get_hub().active:
        return
    with _PARTS_LOCK:
        _PENDING_PARTS[stage] = _PENDING_PARTS.get(stage, 0.0) + sec


def consume_pass_parts() -> Dict[str, float]:
    """Pop the accumulated boundary parts (emit_pass_event calls this
    exactly once per pass event)."""
    with _PARTS_LOCK:
        if not _PENDING_PARTS:
            return {}
        parts = dict(_PENDING_PARTS)
        _PENDING_PARTS.clear()
        return parts


def critical_path_block(train_sec: float,
                        parts: Dict[str, float]) -> Dict:
    """Attribute one pass's wall time across lanes: ``wall_sec`` =
    train + every reported boundary part (so the block SUMS to the
    pass's critical-path wall by construction), with a ``bottleneck``
    verdict — ``device`` when training dominates, else the largest
    stall's stage name, with that stall's seconds as ``stall_sec``."""
    parts = {k: round(float(v), 6) for k, v in parts.items() if v > 0}
    wall = float(train_sec) + sum(parts.values())
    block: Dict = {"train_sec": round(float(train_sec), 6)}
    for k in BOUNDARY_STAGES:
        if k in parts:
            block[f"{k}_sec"] = parts[k]
    for k in sorted(parts):   # free-form extra stages still ship
        if k not in BOUNDARY_STAGES:
            block[f"{k}_sec"] = parts[k]
    block["wall_sec"] = round(wall, 6)
    worst = max(parts, key=parts.get) if parts else None
    if worst is None or train_sec >= parts[worst]:
        block["bottleneck"] = "device"
        block["stall_sec"] = round(max(wall - train_sec, 0.0), 6)
    else:
        block["bottleneck"] = worst
        block["stall_sec"] = parts[worst]
    return block


def reset() -> None:
    """Test hook: drop pending parts (span ids keep counting — they
    only need process-uniqueness)."""
    with _PARTS_LOCK:
        _PENDING_PARTS.clear()
