"""The profiler's clock error on the card, window by window.

``utils.profiler.trace`` keeps a device event only when the profiler
stamps it inside the window's bounds, which are taken on the host's
clock, and holds the card idle for ``WINDOW_MARGIN_S`` at each edge so
that a kernel stamped earlier or later than it ran still falls inside.
This tool opens ``--turns`` windows of each kind of ``--kinds``
(``trace``: ``trace()`` itself; ``scheduled``: the scheduled session
``trace()`` opened before) at each margin of ``--margins``, each around
``--launches`` one-element kernels after ``--warmups`` warm-up
launches, with ``--load`` spinning host processes and ``--threads`` spinning Python threads of its own beside
it for each count given, and reports per setting the spread of the
clock's error (a kernel's start less its launch's,
``profiler.window_record``) and the windows that lost a kernel of the
body.

    python -m paddlebox_tpu_torch.tools.trace_clock [--turns 100] \
        [--kinds trace,scheduled] [--margins 0.025,0.25] [--load 0,16] \
        [--threads 0] [--launches 200] [--warmups 256] [--out F]

Needs a card. Prints one ``trace_clock:`` JSON line a setting and the
whole record to ``--out`` (default ``chiprun_out/trace_clock.json``).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

from ..utils import profiler

#: how far before (or after) its launch a kernel was stamped, in
#: microseconds: the bins of the report's counts
EARLY_US = (1_000, 10_000, 25_000, 50_000, 100_000, 250_000)


def spin_load(n: int) -> list:
    """``n`` host processes that spin until killed."""
    return [subprocess.Popen([sys.executable, "-c", "while True: pass"])
            for _ in range(n)]


def spin_threads(n: int):
    """``n`` threads of this process that run Python code (and so take
    the GIL in turns with the main thread) until the returned function
    is called."""
    done = threading.Event()

    def spin():
        while not done.is_set():
            sum(range(1000))

    ths = [threading.Thread(target=spin, daemon=True) for _ in range(n)]
    for th in ths:
        th.start()

    def stop():
        done.set()
        for th in ths:
            th.join()
    return stop


def stop(procs: list) -> None:
    for p in procs:
        p.kill()
    for p in procs:
        p.wait()


def body_lost(events: list, n: int) -> int:
    """Of a chrome trace's events: how many of its last ``n`` kernel
    launches (the body's) have no kernel event."""
    launches = sorted((e for e in events if e.get("cat") == "cuda_runtime"
                       and "LaunchKernel" in e.get("name", "")),
                      key=lambda e: e["ts"])[-n:]
    kept = {(e.get("args") or {}).get("correlation") for e in events
            if e.get("cat") == "kernel"}
    return sum((e.get("args") or {}).get("correlation") not in kept
               for e in launches)


def one_window(kind: str, margin_s: float, body, path: str):
    """The chrome trace events of one window around ``body()``, and the
    record ``trace()`` wrote into it (empty for ``scheduled``):
    ``trace`` is ``utils.profiler.trace``; ``scheduled`` is the session
    ``trace()`` opened before it had none: a ``torch.profiler`` schedule
    of one warm-up step, which runs the same warm-up, and one recording
    step, which holds the margin, the body, a sync and the margin."""
    if kind == "trace":
        with profiler.trace(os.path.dirname(path)):
            body()
    else:
        from torch.profiler import ProfilerActivity, profile, schedule
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA],
                       schedule=schedule(wait=0, warmup=1, active=1,
                                         repeat=1))
        prof.__enter__()
        try:
            profiler._warm_device(torch)
            prof.step()
            time.sleep(margin_s)
            body()
        finally:
            torch.cuda.synchronize()
            time.sleep(margin_s)
            prof.__exit__(None, None, None)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        prof.export_chrome_trace(path)
    with open(path) as fh:
        doc = json.load(fh)
    os.remove(path)
    return doc["traceEvents"], doc.get(profiler.WINDOW_KEY) or {}


def windows(kind: str, turns: int, margin_s: float, launches: int,
            root: str) -> list:
    """``turns`` windows of ``kind`` at ``margin_s``, each around
    ``launches`` kernels; their records (``profiler.window_record``
    with ``body_lost``)."""
    x = torch.zeros(1, device="cuda")

    def body():
        for _ in range(launches):
            x.add_(1.0)

    saved = profiler.WINDOW_MARGIN_S
    profiler.WINDOW_MARGIN_S = margin_s
    out = []
    try:
        for i in range(turns):
            evs, rec = one_window(kind, margin_s, body, os.path.join(
                root, f"w{i}", profiler.TRACE_FILE))
            out.append({**profiler.window_record(evs, margin_s),
                        "body_lost": body_lost(evs, launches),
                        "warmup_lost": rec.get("warmup_lost", 0)})
    finally:
        profiler.WINDOW_MARGIN_S = saved
    return out


def summarize(recs: list) -> dict:
    """The spread of the clock's error over windows and the windows that
    lost a launch's kernel."""
    lags = [r["kernel_minus_launch_us"] for r in recs
            if r["kernel_minus_launch_us"] is not None]
    low = np.array([x[0] for x in lags]) if lags else np.zeros(0)
    high = np.array([x[1] for x in lags]) if lags else np.zeros(0)
    pct = (lambda a, q: float(np.percentile(a, q)) if a.size else None)
    return {"windows": len(recs),
            "windows_with_lost": sum(1 for r in recs if r["body_lost"]),
            "lost_launches": sum(r["body_lost"] for r in recs),
            "windows_without_kernels": sum(1 for r in recs
                                           if not r["kernels"]),
            "warmup_lost_max": max((r.get("warmup_lost", 0) for r in recs),
                                   default=0),
            "least_lag_us": float(low.min()) if low.size else None,
            "least_lag_p1_p10_p50_us": [pct(low, 1), pct(low, 10),
                                        pct(low, 50)],
            "greatest_lag_us": float(high.max()) if high.size else None,
            "early_by_more_than_us": {str(b): int((low < -b).sum())
                                      for b in EARLY_US},
            "late_by_more_than_us": {str(b): int((high > b).sum())
                                     for b in EARLY_US}}


def save(path: str, report: list) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as fh:
        json.dump({"card": torch.cuda.get_device_name(0),
                   "settings": report}, fh)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--turns", type=int, default=100)
    ap.add_argument("--margins", default="0.1")
    ap.add_argument("--load", default="0")
    ap.add_argument("--threads", default="0")
    ap.add_argument("--kinds", default="trace,scheduled")
    ap.add_argument("--launches", type=int, default=200)
    ap.add_argument("--warmups", default=str(profiler.WARMUP_LAUNCHES))
    ap.add_argument("--out", default=os.path.join("chiprun_out",
                                                  "trace_clock.json"))
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("trace_clock: no CUDA device", file=sys.stderr)
        return 2
    report = []
    with tempfile.TemporaryDirectory() as root:
        for load in (int(x) for x in a.load.split(",")):
            procs = spin_load(load)
            try:
                for n_th in (int(x) for x in a.threads.split(",")):
                    stop_threads = spin_threads(n_th)
                    try:
                        for kind, margin, warm in (
                                (k, float(m), int(w))
                                for k in a.kinds.split(",")
                                for m in a.margins.split(",")
                                for w in a.warmups.split(",")):
                            profiler.WARMUP_LAUNCHES = warm
                            t0 = time.perf_counter()
                            recs = windows(kind, a.turns, margin,
                                           a.launches, root)
                            row = {"kind": kind, "load": load,
                                   "threads": n_th, "margin_s": margin,
                                   "warmup_launches": warm,
                                   "seconds": time.perf_counter() - t0,
                                   **summarize(recs)}
                            print("trace_clock: " + json.dumps(row),
                                  flush=True)
                            report.append({**row, "records": recs})
                            save(a.out, report)
                    finally:
                        stop_threads()
            finally:
                stop(procs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
