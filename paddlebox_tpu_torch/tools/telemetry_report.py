"""Render a run's telemetry JSONL as a per-pass summary table (the
port's copy of ``tools/telemetry_report.py``).

Usage: python -m paddlebox_tpu_torch.tools.telemetry_report RUN.jsonl
[--events]

Reads the event stream the TelemetryHub's JsonlSink wrote
(``FLAGS_telemetry_jsonl=...``) and prints one row per pass: throughput,
stage breakdown, queue stalls (diffed from the cumulative channel
counters between consecutive pass events of the same process), table
occupancy and the device memory peak (the pass event's ``hbm`` block).
``--events`` appends the non-pass events (stragglers, alerts) at the
end. Stdlib only — runs anywhere the JSONL lands.
"""

from __future__ import annotations

import json
import os
import sys
from typing import Dict, List, Optional


def expand_rotated(path: str) -> List[str]:
    """A rotated JSONL set (obs/sinks.JsonlSink with
    ``FLAGS_telemetry_jsonl_max_mb``) read oldest-first:
    ``path.<K> … path.1`` then the live ``path``. A path with no
    rotated siblings expands to itself."""
    segs = []
    i = 1
    while os.path.exists(f"{path}.{i}"):
        segs.append(f"{path}.{i}")
        i += 1
    segs.reverse()               # .N is oldest, .1 newest rotated
    if os.path.exists(path) or not segs:
        segs.append(path)
    return segs


def load_events(path: str) -> List[dict]:
    """All events for ``path``'s rotated segment set, oldest first. A
    torn line (a process killed mid-write leaves a truncated tail —
    and the next append can land after it) is skipped with a warning,
    never a crash: the report must render what survived."""
    events = []
    for seg in expand_rotated(path):
        with open(seg) as fh:
            lines = fh.readlines()
        for ln, line in enumerate(lines, 1):
            stripped = line.strip()
            if not stripped:
                continue
            try:
                events.append(json.loads(stripped))
            except json.JSONDecodeError:
                torn_tail = (ln == len(lines)
                             and not line.endswith("\n"))
                print(f"warning: {seg}:{ln}: "
                      + ("torn final line skipped (writer killed "
                         "mid-write?)" if torn_tail
                         else "bad JSON line skipped"),
                      file=sys.stderr)
    return events


def _fmt_bytes(n: float) -> str:
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if abs(n) < 1024 or unit == "TB":
            return f"{n:.1f}{unit}" if unit != "B" else f"{int(n)}B"
        n /= 1024
    return f"{n:.1f}TB"


def _stage_cell(stage_sec: Dict[str, float], top: int = 4) -> str:
    items = sorted(stage_sec.items(), key=lambda kv: -kv[1])[:top]
    return " ".join(f"{k}={v:.3f}s" for k, v in items) or "-"


def _chan_blocked(ch: Dict[str, dict]) -> Dict[str, float]:
    return {name: st.get("blocked_put_sec", 0.0)
            + st.get("blocked_get_sec", 0.0)
            for name, st in ch.items()}


#: tiered per-pass begin_stall attribution (ps/tiered.begin_pass →
#: last_pass_stats, riding every pass event as table.last_pass):
#: column label → stats key. Seconds render only when non-zero so
#: resident rows stay compact.
BEGIN_STALL_COLS = (
    ("stage", "stage_wait_sec"),
    ("evS", "evict_scatter_sec"),
    ("evA", "evict_async_sec"),
    ("evE", "evict_emergency_sec"),
    ("ssdW", "ssd_promote_wait_sec"),
)


def _bottleneck_cell(cp: Dict) -> str:
    """Render a pass event's critical_path block (obs/trace): the
    bottleneck verdict plus the stall it names — 'device (+0.012s
    stalls)' or 'build_wait +0.740s'."""
    if not cp or "bottleneck" not in cp:
        return ""
    b = cp["bottleneck"]
    stall = float(cp.get("stall_sec", 0.0) or 0.0)
    if b == "device":
        return f"device (+{stall:.3f}s stalls)"
    return f"{b} +{stall:.3f}s"


def _a2a_cell(ev: Dict) -> str:
    """Per-pass exchange-overlap fraction: how much of the sharded
    step's embedding exchange the chunked schedule hid behind compute
    (``exchange_overlap_frac`` on the pass event, when a probe measured
    it; the critical_path's exchange_wait_sec is the remainder)."""
    v = ev.get("exchange_overlap_frac")
    if v is None:
        cp = ev.get("critical_path") or {}
        w = cp.get("exchange_wait_sec")
        return f"wait {float(w):.3f}s" if w is not None else ""
    return f"{float(v):.0%}"


def _begin_stall_cell(lp: Dict) -> str:
    """Render a pass event's begin_stall breakdown (tiered runs) —
    the per-stage boundary attribution without jq archaeology."""
    if not lp or "stage_wait_sec" not in lp:
        return ""
    bits = [f"{label}={lp[key]:.3f}s" for label, key in BEGIN_STALL_COLS
            if float(lp.get(key, 0.0) or 0.0) > 5e-4]
    rows = int(lp.get("evict_async_rows", 0) or 0)
    if rows:
        bits.append(f"evA_rows={rows}")
    return " ".join(bits) or "~0"


def _serving_cell(st: Optional[Dict]) -> str:
    """Render the latest ``serving_stats`` event (serving.ReloadLoop)
    seen before this pass: the serving-latency column for
    serve-while-training runs — 'p99 5.99ms @v0000000003 (+2.1s
    stale)'. Empty when the run has no serving model."""
    if not st:
        return ""
    p99 = st.get("predict_p99_ms", st.get("lookup_p99_ms"))
    bits = []
    if p99 is not None:
        bits.append(f"p99 {float(p99):.2f}ms")
    if st.get("adopted"):
        bits.append(f"@{st['adopted']}")
    stale = float(st.get("staleness_sec", 0.0) or 0.0)
    if stale > 0:
        bits.append(f"(+{stale:.1f}s stale)")
    return " ".join(bits)


def build_rows(events: List[dict]) -> List[Dict[str, str]]:
    """Pass events → printable row dicts (the unit tests call this)."""
    rows = []
    prev_blocked: Dict[int, Dict[str, float]] = {}  # per process
    last_serving: Optional[Dict] = None
    any_serving = any(e.get("event") == "serving_stats" for e in events)
    # alert timeline column (obs/alerts): the rules firing as of each
    # pass, tracked from the alert_fired/alert_cleared stream
    any_alerts = any(e.get("event") in ("alert_fired", "alert_cleared")
                     for e in events)
    # feature-lifecycle column (docs/ONLINE.md): the shrink cycle (or
    # loud skip) landing between passes, shown on the next pass row
    any_lifecycle = any(e.get("event") in ("online_shrink",
                                           "online_shrink_skipped")
                        for e in events)
    last_shrink = ""
    last_lag: Optional[int] = None
    firing: List[str] = []
    for ev in events:
        if ev.get("event") == "stream_window" and "lag_files" in ev:
            last_lag = int(ev["lag_files"])
        if ev.get("event") == "alert_fired":
            if ev.get("rule") not in firing:
                firing.append(str(ev.get("rule")))
            continue
        if ev.get("event") == "alert_cleared":
            if ev.get("rule") in firing:
                firing.remove(ev.get("rule"))
            continue
        if ev.get("event") == "serving_stats":
            last_serving = ev
            continue
        if ev.get("event") == "online_shrink":
            last_shrink = (f"w{ev.get('window', '?')}:"
                           f"-{ev.get('freed', 0)}"
                           f" ({ev.get('live_rows', '?')} live)")
            continue
        if ev.get("event") == "online_shrink_skipped":
            last_shrink = f"w{ev.get('window', '?')}:SKIPPED"
            continue
        if ev.get("event") != "pass":
            continue
        proc = int(ev.get("proc", 0))
        stall = ""
        if "channels" in ev:
            cur = _chan_blocked(ev["channels"])
            prev = prev_blocked.get(proc, {})
            delta = sum(v - prev.get(k, 0.0) for k, v in cur.items())
            depth = sum(st.get("depth", 0)
                        for st in ev["channels"].values())
            stall = f"{max(delta, 0.0):.3f}s (depth {int(depth)})"
            prev_blocked[proc] = cur
        tbl = ""
        begin_stall = ""
        if "table" in ev:
            t = ev["table"]
            if "used" in t and "capacity" in t:
                tbl = f"{t['used']}/{t['capacity']}"
            lp = t.get("last_pass")
            if lp:
                tbl += (f" (+{lp.get('staged', 0)} staged,"
                        f" -{lp.get('evicted', 0)} evicted)")
                # tiered begin_stall attribution: the
                # boundary's per-stage seconds as their own column
                begin_stall = _begin_stall_cell(lp)
            eps = t.get("endpass")
            if eps and eps.get("jobs_run"):
                # async epilogue (docs/PERFORMANCE.md): cumulative
                # write-back vs the part that never blocked the main
                # thread — ovl ≈ wb means the epilogue is free
                tbl += (f" [wb {eps.get('writeback_sec', 0):.2f}s"
                        f" ovl {eps.get('overlap_sec', 0):.2f}s]")
        hbm = ev.get("hbm", {})
        rows.append({
            "pass": str(ev.get("pass_seq", len(rows) + 1)),
            "proc": str(proc),
            "kind": str(ev.get("kind", "?")),
            "batches": str(ev.get("batches", "?")),
            "examples": str(ev.get("examples", "?")),
            "ex/s": (f"{ev['examples_per_sec']:.0f}"
                     if "examples_per_sec" in ev else "?"),
            "wall": (f"{ev['elapsed_sec']:.3f}s"
                     if "elapsed_sec" in ev else "?"),
            "stages": _stage_cell(ev.get("stage_sec", {})),
            "queue stall": stall or "-",
            "table": tbl or "-",
            "begin stall": begin_stall or "-",
            "bottleneck": _bottleneck_cell(ev.get("critical_path", {}))
            or "-",
            "a2a ovl": _a2a_cell(ev) or "-",
            "hbm peak": _fmt_bytes(hbm.get("peak_bytes_in_use", 0)),
        })
        if any_serving:
            # serving-latency column only when the run served (a
            # training-only JSONL keeps its compact row)
            rows[-1]["serve p99"] = _serving_cell(last_serving) or "-"
        if any_alerts:
            # alert timeline column only when the run alerted: which
            # rules were firing as of this pass
            rows[-1]["alerts"] = ",".join(firing) or "-"
        if any_lifecycle:
            # lifecycle column only when shrink cycles ran: the cycle
            # (rows freed, live rows after) or loud skip since the
            # previous pass row, plus the stream backlog as of the
            # latest window boundary
            cell = last_shrink or "-"
            if last_lag is not None:
                cell += f" lag {last_lag}"
            rows[-1]["lifecycle"] = cell
            last_shrink = ""
    return rows


def render_table(rows: List[Dict[str, str]]) -> str:
    if not rows:
        return "no pass events"
    cols = list(rows[0].keys())
    widths = {c: max(len(c), *(len(r[c]) for r in rows)) for c in cols}
    lines = ["  ".join(c.ljust(widths[c]) for c in cols),
             "  ".join("-" * widths[c] for c in cols)]
    for r in rows:
        lines.append("  ".join(r[c].ljust(widths[c]) for c in cols))
    return "\n".join(lines)


#: preemption / recovery lifecycle events rendered as their own
#: timeline (docs/RESILIENCE.md §Preemption & mid-pass resume)
RECOVERY_EVENTS = ("preempt_requested", "emergency_checkpoint",
                   "inpass_checkpoint", "cursor_resume",
                   "restore_consensus", "pass_retry")


def _fmt_recovery(ev: dict) -> str:
    name = ev.get("event", "?")
    bits = []
    for k in ("reason", "kind", "global_step", "batch_index", "agreed",
              "attempt"):
        if k in ev:
            bits.append(f"{k}={ev[k]}")
    return f"{name}({', '.join(bits)})" if bits else name


def critical_path_summary(events: List[dict]) -> str:
    """Whole-run critical-path verdict from the passes' critical_path
    blocks (obs/trace): the majority verdict plus each minority pass
    called out with its stall — '7/8 passes device-bound, pass 2
    build_wait-bound: +0.740s'. Empty when no pass carried a block."""
    cps = []
    for ev in events:
        if ev.get("event") != "pass":
            continue
        cp = ev.get("critical_path")
        if cp and "bottleneck" in cp:
            cps.append((str(ev.get("pass_seq", len(cps) + 1)), cp))
    if not cps:
        return ""
    counts: Dict[str, int] = {}
    for _, cp in cps:
        counts[cp["bottleneck"]] = counts.get(cp["bottleneck"], 0) + 1
    major = max(counts, key=counts.get)
    bits = [f"{counts[major]}/{len(cps)} passes {major}-bound"]
    for seq, cp in cps:
        if cp["bottleneck"] != major:
            bits.append(f"pass {seq} {cp['bottleneck']}-bound: "
                        f"+{float(cp.get('stall_sec', 0.0)):.3f}s")
    stall_tot = sum(float(cp.get("stall_sec", 0.0) or 0.0)
                    for _, cp in cps if cp["bottleneck"] != "device")
    if stall_tot > 5e-4:
        bits.append(f"non-device stalls total +{stall_tot:.3f}s")
    return "critical path: " + ", ".join(bits)


def serving_summary(events: List[dict]) -> str:
    """Whole-run serving verdict from the serving_* events
    (serving.ReloadLoop; docs/SERVING.md): adoption count, refusals/
    degrades, the final adopted version, peak staleness and the last
    observed p99 — 'serving: 4 reloads → v0000000005, p99 0.21ms, max
    staleness 0.4s'. Empty when the run served nothing."""
    reloads = [e for e in events if e.get("event") == "serving_reload"]
    refused = [e for e in events
               if e.get("event") == "serving_reload_refused"]
    degraded = [e for e in events
                if e.get("event") == "serving_degraded"]
    stats = [e for e in events if e.get("event") == "serving_stats"]
    if not (reloads or refused or degraded or stats):
        return ""
    bits = [f"{len(reloads)} reloads"]
    adopted = (reloads[-1].get("artifact") if reloads
               else stats[-1].get("adopted") if stats else None)
    if adopted:
        bits[-1] += f" → {adopted}"
    if refused:
        bits.append(f"{len(refused)} refused")
    if degraded:
        bits.append(f"{len(degraded)} degraded polls")
    last_p99 = next(
        (e.get("predict_p99_ms", e.get("lookup_p99_ms"))
         for e in reversed(stats)
         if e.get("predict_p99_ms") is not None
         or e.get("lookup_p99_ms") is not None), None)
    if last_p99 is not None:
        bits.append(f"p99 {float(last_p99):.2f}ms")
    stale = max((float(e.get("staleness_sec", 0.0) or 0.0)
                 for e in stats + degraded), default=0.0)
    if stale > 0:
        bits.append(f"max staleness {stale:.1f}s")
    return "serving: " + ", ".join(bits)


def alerts_summary(events: List[dict]) -> str:
    """Whole-run alert timeline (obs/alerts): every fire/clear
    transition in order — 'alerts: stream_lag fired(seq 12) ->
    stream_lag cleared(seq 19); 1 still firing'. Empty when the run
    never alerted."""
    transitions = [e for e in events
                   if e.get("event") in ("alert_fired",
                                         "alert_cleared")]
    if not transitions:
        return ""
    bits = []
    open_rules: List[str] = []
    for e in transitions:
        rule = str(e.get("rule", "?"))
        if e.get("event") == "alert_fired":
            if rule not in open_rules:
                open_rules.append(rule)
            bits.append(f"{rule} fired(seq {e.get('seq', '?')})")
        else:
            if rule in open_rules:
                open_rules.remove(rule)
            bits.append(f"{rule} cleared(seq {e.get('seq', '?')})")
    line = "alerts: " + " -> ".join(bits)
    if open_rules:
        line += f"; still firing: {','.join(open_rules)}"
    return line


def membership_summary(events: List[dict]) -> str:
    """Elastic membership timeline (distributed/elastic +
    train/multihost; docs/RESILIENCE.md §Elastic membership): every
    ``membership_change`` and completed ``reshard`` in order —
    'membership: np=3 (lost h1) -> reshard 4->3 @step 2 -> np=4
    (joined h1)'. Ends with a degraded flag when the run finished below
    its target world size. Empty when the world never changed."""
    rel = [e for e in events
           if e.get("event") in ("membership_change", "reshard")]
    if not rel:
        return ""
    bits = []
    for e in rel:
        if e.get("event") == "membership_change":
            delta = []
            if e.get("lost"):
                delta.append("lost " + ",".join(e["lost"]))
            if e.get("joined"):
                delta.append("joined " + ",".join(e["joined"]))
            bits.append(f"np={e.get('np', '?')}"
                        + (f" ({'; '.join(delta)})" if delta else ""))
        else:
            bits.append(f"reshard {e.get('old_np', '?')}->"
                        f"{e.get('new_np', '?')} @step {e.get('step', '?')}")
    line = "membership: " + " -> ".join(bits)
    changes = [e for e in rel if e.get("event") == "membership_change"]
    if changes:
        last = changes[-1]
        np_, tgt = last.get("np"), last.get("target_np")
        if isinstance(np_, int) and isinstance(tgt, int) and np_ < tgt:
            line += f"; still degraded ({np_}/{tgt})"
    return line


def bundles_summary(events: List[dict]) -> str:
    """Flight-recorder bundle pointers (obs/flightrec): every
    ``blackbox_dump`` the run published, trigger + path — the first
    thing a postmortem reaches for. Empty when nothing triggered."""
    dumps = [e for e in events if e.get("event") == "blackbox_dump"]
    if not dumps:
        return ""
    return "bundles: " + ", ".join(
        f"{e.get('trigger', '?')} -> {e.get('path', '?')}"
        for e in dumps)


def render_report(events: List[dict], show_events: bool = False) -> str:
    rows = build_rows(events)
    out = [render_table(rows)]
    passes = [e for e in events if e.get("event") == "pass"]
    if passes:
        tot_ex = sum(e.get("examples", 0) or 0 for e in passes)
        tot_wall = sum(e.get("elapsed_sec", 0.0) or 0.0 for e in passes)
        out.append("")
        out.append(f"{len(passes)} passes, {tot_ex} examples, "
                   f"{tot_wall:.3f}s inside passes"
                   + (f", {tot_ex / tot_wall:.0f} ex/s overall"
                      if tot_wall > 0 else ""))
    cp_line = critical_path_summary(events)
    if cp_line:
        out.append(cp_line)
    sv_line = serving_summary(events)
    if sv_line:
        out.append(sv_line)
    al_line = alerts_summary(events)
    if al_line:
        out.append(al_line)
    mb_line = membership_summary(events)
    if mb_line:
        out.append(mb_line)
    bx_line = bundles_summary(events)
    if bx_line:
        out.append(bx_line)
    recovery = [e for e in events if e.get("event") in RECOVERY_EVENTS]
    if recovery:
        out.append("recovery: " + " -> ".join(_fmt_recovery(e)
                                              for e in recovery))
    other = [e for e in events if e.get("event") != "pass"]
    if other:
        counts: Dict[str, int] = {}
        for e in other:
            counts[e.get("event", "?")] = counts.get(e.get("event", "?"),
                                                     0) + 1
        out.append("other events: " + ", ".join(
            f"{k}×{v}" for k, v in sorted(counts.items())))
        if show_events:
            out.extend(json.dumps(e) for e in other)
    return "\n".join(out)


def main(argv: Optional[List[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    show_events = "--events" in argv
    paths = [a for a in argv if not a.startswith("--")]
    if not paths:
        print(__doc__, file=sys.stderr)
        return 2
    for path in paths:
        if len(paths) > 1:
            print(f"== {path}")
        print(render_report(load_events(path), show_events))
    return 0


if __name__ == "__main__":
    sys.exit(main())
