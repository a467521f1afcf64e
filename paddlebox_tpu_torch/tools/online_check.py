"""Long-horizon soak gate for the always-on online-learning daemon (the
port's counterpart of ``scripts/online_check.py``).

Proves the supervised train -> publish -> serve composition
(``paddlebox_tpu_torch.online.OnlineLearner`` and
``python -m paddlebox_tpu_torch.tools.onlinelearn``) holds up over a
horizon 3x the stream gate's (12 windows against stream_check's 3), with
feature lifecycle aging on:

1. **soak**: one in-process daemon (train, publish, serve, shrink
   cycles) over 12 windows, sampled per window: resident key count,
   cursor size, RSS and serving staleness in versions behind the tip
   must PLATEAU (the last third's max under a bound, not still
   increasing): an always-on run must not leak keys, cursor bytes or
   memory. Every lookup served during the run bit-matches its version's
   replay oracle, and the whole leg runs twice with the same seed: the
   outcome must be identical. Staleness in seconds is printed, never
   held (it is the host's clock, and moves with the machine's load).
2. **tiered lifecycle**: the same aging policy through the full
   PassScopedTable -> HostStore -> SsdTier stack (async epilogue on,
   demotion, shrink, compaction): host keys, SSD live rows and disk
   bytes plateau and the SSD live fraction stays above its floor.
3. **kill legs**: real-SIGTERM and real-SIGKILL subprocess round trips
   of ``tools/onlinelearn``: marker consumed, the open window replayed
   at-least-once, the resumed daemon drains to a final boundary whose
   ``state_digest`` bit-matches an unkilled oracle run's; /healthz
   serves the ``online`` block throughout.
4. **corrupt-delta chaos**: a flipped-byte delta in the publish feed: the
   daemon's reload loop refuses it loudly (degrade counter, staleness)
   and keeps serving the prior snapshot; the next shrink cycle's forced
   BASE publish is the recovery path the daemon itself produces, and
   serving adopts it.
5. **shrink chaos**: the ``online.shrink`` fault seam: a transient
   failure retries on the seeded policy and the cycle completes; a hard
   failure SKIPS the cycle loudly (counter, flight-recorder bundle,
   telemetry event) without stalling training.

Usage::

    python -m paddlebox_tpu_torch.tools.online_check [--seed 7]
        [--windows 12] [--skip-subprocess] [--device cuda|cpu]

The trainers and servers run on the card unless ``--device cpu``.
Exit code 0 == every leg passed and the soak was deterministic.
"""

from __future__ import annotations

import argparse
import collections
import glob as _glob
import hashlib
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

#: the checkout's root (the daemon subprocesses import the package
#: from it)
REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

#: soak geometry: WINDOW files per window, ROWS records per file — the
#: default 12-window horizon is 3x stream_check's 3 windows
WINDOW, ROWS, BS = 2, 32, 16
SOAK_WINDOWS = 12

#: plateau bounds (env-overridable): serving staleness in published
#: versions behind the tip, RSS growth as a fraction of the early max
STALENESS_BOUND_VERSIONS = int(
    os.environ.get("ONLINE_CHECK_STALENESS_VERSIONS", "3"))
RSS_GROWTH_FRAC = float(os.environ.get("ONLINE_CHECK_RSS_FRAC", "0.35"))


def _digest(arr) -> str:
    import numpy as np
    return hashlib.sha256(
        np.ascontiguousarray(arr).tobytes()).hexdigest()[:24]


def _rss_mb() -> float:
    with open("/proc/self/status") as fh:
        for line in fh:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) / 1024.0
    return 0.0


def _assert_plateau(name, series, rel=0.05, abs_bound=None) -> None:
    """The soak invariant: the last third of a per-window series stays
    under bound (default: within ``rel`` of the earlier max) and is not
    still strictly increasing — growth must have stopped, not merely
    slowed."""
    assert len(series) >= 3, (name, series)
    third = max(1, len(series) // 3)
    head, tail = series[:-third], series[-third:]
    bound = abs_bound if abs_bound is not None \
        else max(head) * (1.0 + rel)
    assert max(tail) <= bound + 1e-9, (
        f"{name} did not plateau: last-third max {max(tail)} > bound "
        f"{bound} (series {series})")
    if len(tail) >= 2:
        assert any(b <= a for a, b in zip(tail, tail[1:])), (
            f"{name} still strictly increasing across the last third: "
            f"{series}")


def _mk_trainer(desc, seed, device, capacity=1 << 12):
    import torch

    from paddlebox_tpu_torch.models import CtrDnn
    from paddlebox_tpu_torch.ps.sgd import SparseSGDConfig
    from paddlebox_tpu_torch.ps.table import EmbeddingTable
    from paddlebox_tpu_torch.train.trainer import Trainer
    cfg = SparseSGDConfig(mf_create_thresholds=0.0, mf_initial_range=0.0)
    table = EmbeddingTable(mf_dim=4, capacity=capacity, cfg=cfg,
                           unique_bucket_min=2048, device=device)
    torch.manual_seed(seed)
    return Trainer(CtrDnn(26, 3 + 4, 13, hidden=(8,)), table, desc,
                   tx=lambda p: torch.optim.Adam(p, lr=1e-2), seed=seed,
                   device=device)


def _srv(desc, device, capacity=1 << 12):
    from paddlebox_tpu_torch.models import CtrDnn
    from paddlebox_tpu_torch.serving import ServingModel
    return ServingModel(CtrDnn(26, 3 + 4, 13, hidden=(8,)), desc, mf_dim=4,
                        capacity=capacity, device=device)


def _versions_behind(store, aid) -> int:
    """Serving staleness in versions: the adoptable versions published
    after ``aid`` (all of them while nothing is adopted)."""
    vs = [v for v in store.versions()
          if store.read_manifest(v, verify=False).get("adoptable", True)]
    return len(vs) - 1 - vs.index(aid) if aid in vs else len(vs)


def _probe_keys(path: str, desc):
    """Real keys to probe the served snapshots with: the first 200
    distinct keys of ``path`` (trained in every version that saw them,
    so versions answer different digests and the consistency check
    cannot pass on all-miss lookups) and one key no file holds."""
    import numpy as np

    from paddlebox_tpu_torch.data.parser import get_parser
    parser = get_parser(desc)
    keys = []
    with open(path) as fh:
        for line in fh:
            rec = parser.parse(line)
            if rec is not None:
                keys.append(rec.keys)
    uniq = np.unique(np.concatenate(keys))[:200]
    return np.concatenate([uniq, np.array([0xDEAD_BEEF_0001], np.uint64)])


def _lookup_oracles(store, desc, probe, aids, device, capacity=1 << 12):
    """Per-version replay oracles (serve_check idiom): a FRESH consumer
    adopts each version and digests the same probe lookup the live
    queries ran — the bit-consistency reference."""
    out = {}
    for aid in sorted(set(aids)):
        srv = _srv(desc, device, capacity)
        srv.adopt(store, aid)
        out[aid] = _digest(srv.snapshot().lookup(probe))
        srv.release()
    return out


class _QueryWorker(threading.Thread):
    """Sustained serving traffic against the daemon's own ServingModel:
    each query pins ONE snapshot and counts its (version, lookup digest)
    pair — adoption swaps must never tear a read. Only distinct pairs
    are kept, so the log does not grow with the soak's length and adds
    nothing to the RSS series the soak holds flat."""

    def __init__(self, srv, probe) -> None:
        super().__init__(daemon=True, name="online-query")
        self.srv = srv
        self.probe = probe
        self.records = collections.Counter()
        self.max_staleness = 0.0
        self.exc = None
        self._halt = threading.Event()

    def run(self) -> None:
        try:
            while not self._halt.is_set():
                if self.srv.adopted_aid is None:
                    time.sleep(0.01)
                    continue
                snap = self.srv.snapshot()
                self.records[(snap.aid,
                              _digest(snap.lookup(self.probe)))] += 1
                st = self.srv.serving_status()
                self.max_staleness = max(
                    self.max_staleness,
                    float(st.get("staleness_sec") or 0.0))
                time.sleep(0.003)
        except BaseException as e:   # noqa: BLE001 — reported by leg
            self.exc = e

    def stop(self) -> None:
        self._halt.set()
        self.join(timeout=60)
        if self.exc is not None:
            raise AssertionError(
                f"query worker died (queries must survive reload "
                f"swaps): {self.exc!r}") from self.exc


# ---------------------------------------------------------------------------
# leg 1: long-horizon soak (train + publish + serve + shrink, in-process)
# ---------------------------------------------------------------------------

def _run_soak_leg(workdir: str, seed: int,
                  windows: int = SOAK_WINDOWS,
                  device: str = "cuda") -> dict:
    import numpy as np

    from paddlebox_tpu_torch.config import flags_scope
    from paddlebox_tpu_torch.data import DataFeedDesc, DatasetFactory
    from paddlebox_tpu_torch.data.criteo import generate_criteo_files
    from paddlebox_tpu_torch.obs.hub import get_hub, reset_hub
    from paddlebox_tpu_torch.online import MODES, OnlineLearner
    from paddlebox_tpu_torch.resilience import preemption
    from paddlebox_tpu_torch.train.checkpoint import (CheckpointManager,
                                                      state_digest)

    assert windows >= 9, "soak must cover >=3x stream_check's 3 windows"
    reset_hub()
    preemption.clear_stop()
    jsonl = os.path.join(workdir, "telemetry.jsonl")
    files = generate_criteo_files(os.path.join(workdir, "data"),
                                  num_files=windows * WINDOW,
                                  rows_per_file=ROWS,
                                  vocab_per_slot=40, seed=seed)
    with flags_scope(seed=seed, telemetry_jsonl=jsonl,
                     stream_window_files=WINDOW,
                     stream_ckpt_every_windows=1,
                     shrink_every_windows=3,
                     shrink_delete_threshold=0.05,
                     show_click_decay_rate=0.9,
                     read_thread_num=1):
        desc = DataFeedDesc.criteo(batch_size=BS)
        desc.key_bucket_min = 2048
        trainer = _mk_trainer(desc, seed, device)
        cm = CheckpointManager(os.path.join(workdir, "ckpt"),
                               artifacts=os.path.join(workdir, "registry"))
        srv = _srv(desc, device)

        def mkds():
            ds = DatasetFactory().create_dataset("QueueDataset", desc)
            ds.set_filelist(files)
            return ds

        learner = OnlineLearner(trainer, mkds, cm, serving=srv,
                                store=cm.artifacts,
                                filelist_fn=lambda: list(files),
                                max_idle_polls=2,
                                reload_poll_sec=0.05)
        samples = []
        healthz_seen = []
        orig_hook = learner._on_window

        def hook(widx, dataset):
            orig_hook(widx, dataset)
            cur = None
            try:
                cur = cm.load_cursor()
            except Exception:
                pass
            samples.append(dict(
                window=int(widx),
                live_rows=int(learner._live_rows()),
                cursor_bytes=len(json.dumps(cur, sort_keys=True))
                if cur else 0,
                rss_mb=round(_rss_mb(), 1),
                staleness_versions=_versions_behind(cm.artifacts,
                                                    srv.adopted_aid),
                staleness_sec=round(float(
                    srv.serving_status().get("staleness_sec") or 0.0),
                    3)))
            if widx == 2:   # mid-run /healthz aggregation check
                h = get_hub().health()
                assert "online" in h, sorted(h)
                ob = h["online"]
                assert ob["mode"] in MODES and ob["serving"], ob
                healthz_seen.append(ob)

        learner._on_window = hook
        probe = _probe_keys(files[0], desc)
        worker = _QueryWorker(srv, probe)
        worker.start()
        t0 = time.perf_counter()
        totals = learner.run()
        elapsed = time.perf_counter() - t0
        worker.stop()

        # ---- composition held for the whole horizon
        assert totals["windows"] == windows, totals
        assert learner.shrink_cycles == windows // 3, (
            learner.shrink_cycles, windows)
        assert learner.shrink_skipped_total == 0
        assert learner.leg_failures == 0
        assert healthz_seen, "mid-run /healthz check never ran"
        final = learner.online_status()
        assert final["mode"] in ("full", "degraded"), final

        # ---- plateau proofs (the soak invariant)
        live = [s["live_rows"] for s in samples]
        _assert_plateau("live_rows", live, rel=0.05)
        _assert_plateau("cursor_bytes",
                        [s["cursor_bytes"] for s in samples], rel=0.20)
        _assert_plateau("rss_mb", [s["rss_mb"] for s in samples],
                        rel=RSS_GROWTH_FRAC)
        _assert_plateau("staleness_versions",
                        [s["staleness_versions"] for s in samples],
                        abs_bound=STALENESS_BOUND_VERSIONS)

        # ---- every served lookup bit-matches its version's oracle
        assert worker.records, "no queries were served during the soak"
        seen_aids = {aid for aid, _ in worker.records}
        assert len(seen_aids) >= 2, (
            f"hot reload never advanced the served version: {seen_aids}")
        # the oracles of EVERY published version: the outcome must not
        # depend on which versions the query thread happened to see
        oracle = _lookup_oracles(cm.artifacts, desc, probe,
                                 cm.artifacts.versions(), device)
        torn = [(aid, d) for aid, d in worker.records
                if oracle.get(aid) != d]
        assert not torn, f"served lookups tore across swaps: {torn[:3]}"

        # ---- final state is restorable and digest-stable
        versions = cm.artifacts.versions()
        assert len(versions) == windows, (len(versions), windows)
        last = cm.latest_step()
        fresh = _mk_trainer(desc, seed, device)
        assert CheckpointManager(
            os.path.join(workdir, "ckpt")).restore(fresh) == last
        final_digest = state_digest(fresh)

    with open(jsonl) as fh:
        events = [json.loads(line) for line in fh]
    counts = {}
    for e in events:
        counts[e["event"]] = counts.get(e["event"], 0) + 1
    assert counts.get("stream_window", 0) == windows, counts
    assert counts.get("online_shrink", 0) == windows // 3, counts

    return dict(
        ok=True,
        # `sig` is the determinism contract: byte-identical across
        # identically-seeded runs (timing fields live outside it)
        sig=dict(
            windows=int(totals["windows"]),
            examples=int(totals["examples"]),
            shrink_cycles=int(learner.shrink_cycles),
            shrunk_rows_total=int(learner.shrunk_rows_total),
            live_rows=live,
            versions=list(versions),
            final_step=int(last),
            final_digest=final_digest,
            oracle=oracle,
            events=dict(stream_window=counts["stream_window"],
                        online_shrink=counts["online_shrink"]),
        ),
        samples=samples,
        ex_per_sec=round(totals["examples"] / max(elapsed, 1e-9), 1),
        queries=sum(worker.records.values()),
        max_staleness=round(worker.max_staleness, 3),
    )


# ---------------------------------------------------------------------------
# leg 2: tiered/SSD feature lifecycle soak (async epilogue ON)
# ---------------------------------------------------------------------------

def _run_tiered_lifecycle_leg(workdir: str, seed: int,
                              windows: int = SOAK_WINDOWS,
                              device: str = "cuda") -> dict:
    """The aging policy through the full tier stack: BoxPS-style pass
    windows over PassScopedTable → HostStore → SsdTier with the async
    end_pass epilogue on, watermark demotion every window and a fenced
    shrink every 3 — host keys, SSD live rows, disk bytes must all
    plateau and compaction must keep the live fraction above floor."""
    import numpy as np
    import torch

    from paddlebox_tpu_torch.config import flags_scope
    from paddlebox_tpu_torch.ps.host_store import HostStore
    from paddlebox_tpu_torch.ps.pass_table import PassScopedTable
    from paddlebox_tpu_torch.ps.sgd import SparseSGDConfig
    from paddlebox_tpu_torch.ps.table import FIELD_COL

    with flags_scope(seed=seed, async_end_pass=True,
                     host_demote_watermark=0.25,
                     host_demote_target=0.1,
                     ssd_segment_rows=256,
                     ssd_compact_live_frac=0.6):
        hs = HostStore(mf_dim=4, capacity=1024,
                       ssd_dir=os.path.join(workdir, "tier"))
        t = PassScopedTable(hs, pass_capacity=512, cfg=SparseSGDConfig(),
                            device=device)
        hot = np.arange(1, 161, dtype=np.uint64)
        samples, shrunk_total = [], 0
        for w in range(windows):
            churn = np.arange(10_000 + w * 120, 10_120 + w * 120,
                              dtype=np.uint64)
            keys = np.concatenate([hot, churn])
            t.begin_pass(keys)
            rows = t.index.lookup(keys)
            d = t.state.data
            idx = torch.as_tensor(rows.astype(np.int64), device=d.device)
            show = FIELD_COL["show"]
            d[idx[:len(hot)], show] += 3.0  # stays warm
            d[idx[len(hot):], show] += 0.2  # goes cold
            t._touched[rows] = True
            t.end_pass()
            # drain the async epilogue before demotion decisions — the
            # window's write-back must land so every run sees the same
            # tier state (the shrink-vs-draining-epilogue race itself
            # is covered by tests/test_torch_host_store.py)
            t.fence()
            hs.demote_to_watermark()
            if (w + 1) % 3 == 0:
                # fenced against the epilogue; SSD ages + compacts too
                shrunk_total += t.shrink(delete_threshold=0.1,
                                         decay=0.7)
                # production follows a shrink with a BASE save (which
                # seals the active segment via manifest()) and compacts
                # on the demote worker — run the same sequence so the
                # sample sees the steady state, not the transient
                # just-shrunk dead fraction
                hs.ssd.manifest()
                hs.ssd.maybe_compact()
            st = hs.ssd.stats()
            row_bytes = 8 + 1 + hs.ssd.width * 4
            samples.append(dict(
                window=w, host_rows=len(hs), ssd_rows=len(hs.ssd),
                live_rows=len(hs) + len(hs.ssd),
                ssd_bytes=int(st["bytes"]),
                live_frac=round(st["live_rows"] * row_bytes
                                / max(1, st["bytes"]), 4)))
        assert shrunk_total > 0, "shrink cycles never dropped a row"
        # hot keys must survive every cycle (their decayed score stays
        # above threshold); churn keys must not accumulate
        back = hs.fetch(hot)
        assert float(back["show"].min()) > 0.0, "a hot key was aged out"
        _assert_plateau("tiered.live_rows",
                        [s["live_rows"] for s in samples], rel=0.05)
        _assert_plateau("tiered.host_rows",
                        [s["host_rows"] for s in samples], rel=0.05)
        # disk footprint: the mid-cycle peak (vacated copies pending
        # compaction) is bounded loosely; the post-shrink/post-compact
        # footprint — the steady-state claim — is bounded tightly
        _assert_plateau("tiered.ssd_bytes",
                        [s["ssd_bytes"] for s in samples], rel=0.30)
        _assert_plateau("tiered.ssd_bytes_post_shrink",
                        [s["ssd_bytes"] for i, s in enumerate(samples)
                         if (i + 1) % 3 == 0], rel=0.05)
        third = max(1, len(samples) // 3)
        tail_frac = [s["live_frac"] for s in samples[-third:]]
        assert min(tail_frac) >= 0.25, (
            f"SSD live fraction collapsed — compaction is not keeping "
            f"up: {tail_frac}")
    return dict(ok=True, shrunk_total=int(shrunk_total),
                samples=samples)


# ---------------------------------------------------------------------------
# leg 3: subprocess kill round-trips of tools/onlinelearn
# ---------------------------------------------------------------------------

def _daemon_cmd(workdir: str, data_dir: str, seed: int,
                device: str) -> list:
    return [sys.executable, "-m", "paddlebox_tpu_torch.tools.onlinelearn",
            "--workdir", workdir, "--data-dir", data_dir,
            "--device", device,
            "--seed", str(seed), "--window-files", str(WINDOW),
            "--ckpt-every", "1", "--shrink-every", "3",
            "--shrink-threshold", "0.05", "--decay", "0.9",
            "--max-idle-polls", "3", "--serve", "--healthz-port", "0",
            # deep boundary history: the kill legs digest-compare the
            # victim against the oracle at a pre-kill window boundary,
            # so retention must not sweep it during the drain
            "--ckpt-keep", "64"]


def _daemon_env() -> dict:
    """The daemon subprocesses' environment: this checkout first on the
    import path."""
    path = os.environ.get("PYTHONPATH")
    return dict(os.environ, PYTHONPATH=REPO + (os.pathsep + path
                                                if path else ""))


def _read_port(proc, deadline_sec: float = 120.0) -> int:
    deadline = time.time() + deadline_sec
    while time.time() < deadline:
        line = proc.stdout.readline()
        if not line:
            time.sleep(0.05)
            continue
        try:
            obj = json.loads(line)
        except json.JSONDecodeError:
            continue
        if "healthz_port" in obj:
            return int(obj["healthz_port"])
    raise AssertionError("daemon never printed its healthz port")


def _healthz(port: int) -> dict:
    with urllib.request.urlopen(
            f"http://127.0.0.1:{port}/healthz", timeout=5) as r:
        return json.loads(r.read())


def _final_digest(workdir: str, seed: int, device: str, step=None):
    from paddlebox_tpu_torch.config import flags_scope
    from paddlebox_tpu_torch.data import DataFeedDesc
    from paddlebox_tpu_torch.train.checkpoint import (CheckpointManager,
                                                      state_digest)
    with flags_scope(seed=seed):
        desc = DataFeedDesc.criteo(batch_size=BS)
        desc.key_bucket_min = 2048
        cm = CheckpointManager(os.path.join(workdir, "ckpt"))
        if step is None:
            step = cm.latest_step()
        t = _mk_trainer(desc, seed, device)
        assert cm.restore(t, step=step) == step
        return int(step), state_digest(t)


def _count_events(jsonl: str, name: str) -> int:
    if not os.path.exists(jsonl):
        return 0
    n = 0
    with open(jsonl) as fh:
        for line in fh:
            try:
                if json.loads(line).get("event") == name:
                    n += 1
            except json.JSONDecodeError:
                pass   # a torn tail line mid-write
    return n


def _run_kill_leg(workdir: str, seed: int, signame: str,
                  windows: int = 6, device: str = "cuda") -> dict:
    """One real-signal round-trip: launch the daemon as a subprocess,
    land ``signame`` mid-window (gated on the daemon's own telemetry
    event stream), relaunch with the same workdir, and require the
    drained daemon's final boundary digest to bit-match an unkilled
    oracle run's."""
    from paddlebox_tpu_torch.data.criteo import generate_criteo_files
    from paddlebox_tpu_torch.resilience.preemption import (EXIT_RESUME,
                                                     read_resume_marker)
    from paddlebox_tpu_torch.train.checkpoint import CheckpointManager

    data_dir = os.path.join(workdir, "data")
    generate_criteo_files(data_dir, num_files=windows * WINDOW,
                          rows_per_file=256, vocab_per_slot=40,
                          seed=seed)

    # (a) unkilled oracle
    oracle_dir = os.path.join(workdir, "oracle")
    r = subprocess.run(_daemon_cmd(oracle_dir, data_dir, seed, device),
                       capture_output=True, text=True, timeout=600,
                       env=_daemon_env())
    assert r.returncode == 0, r.stderr[-2000:]
    oracle_step, oracle_digest = _final_digest(oracle_dir, seed, device)

    # (b) victim: the signal is sent right after the 2nd stream_window
    # event lands in the victim's telemetry — several windows of work
    # remain, so a SIGTERM lands mid-window (boundary-exact landings
    # are rare; retried for determinism of the leg's claims)
    healthz_ok = False
    victim_dir = rc = cursor = None
    for attempt in range(3):
        victim_dir = os.path.join(workdir, f"victim{attempt}")
        jsonl = os.path.join(victim_dir, "telemetry.jsonl")
        proc = subprocess.Popen(_daemon_cmd(victim_dir, data_dir, seed,
                                            device),
                                stdout=subprocess.PIPE,
                                stderr=subprocess.DEVNULL, text=True,
                                env=_daemon_env())
        try:
            port = _read_port(proc)
            deadline = time.time() + 300
            while time.time() < deadline:
                if _count_events(jsonl, "stream_window") >= 2:
                    break
                if not healthz_ok:
                    try:   # /healthz aggregation answers while training
                        ob = _healthz(port).get("online") or {}
                        healthz_ok = bool(ob.get("serving")) \
                            and "windows_completed" in ob \
                            and "mode" in ob
                    except Exception:
                        pass
                time.sleep(0.01)
            else:
                raise AssertionError("daemon never reached 2 windows")
            # the 2nd window's event just landed — the daemon is in its
            # boundary save; a short beat later the signal lands INSIDE
            # window 3's batches (retried if it still hits a boundary or
            # outruns the stream)
            time.sleep(0.1 + 0.1 * attempt)
            os.kill(proc.pid, getattr(signal, f"SIG{signame}"))
            rc = proc.wait(timeout=120)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)
        cursor = CheckpointManager(
            os.path.join(victim_dir, "ckpt")).load_cursor() or {}
        stream = cursor.get("stream") or {}
        if signame == "TERM":
            if stream.get("window_files"):
                break   # mid-window emergency cursor captured
        elif _count_events(jsonl, "stream_window") < windows:
            break       # SIGKILL landed before the stream drained
    assert healthz_ok, "/healthz online block never answered"
    stream = cursor.get("stream") or {}
    open_window = [os.path.basename(p)
                   for p in stream.get("window_files", [])]

    marker = read_resume_marker(os.path.join(victim_dir, "ckpt"))
    if signame == "TERM":
        # graceful: emergency boundary checkpoint + RESUME.json + 75
        assert rc == EXIT_RESUME, rc
        assert marker is not None and marker["exit_code"] == EXIT_RESUME
        assert open_window, (
            "SIGTERM never landed mid-window — no open window to "
            "replay (3 attempts)")
    else:
        assert rc == -signal.SIGKILL, rc
        assert marker is None, "SIGKILL cannot write a graceful marker"
        # progress past the last boundary is legitimately lost — the
        # relaunch must still have windows left to train
        assert _count_events(jsonl, "stream_window") < windows, \
            "SIGKILL never landed before the stream drained (3 attempts)"
        assert int(stream.get("windows_completed", 0)) < windows, stream

    # (c) relaunch with the same workdir: resume + drain; /healthz
    # answers while it does
    jsonl = os.path.join(victim_dir, "telemetry.jsonl")
    resumes0 = _count_events(jsonl, "cursor_resume")
    proc = subprocess.Popen(_daemon_cmd(victim_dir, data_dir, seed, device),
                            stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            env=_daemon_env())
    saw_online = False
    try:
        port = _read_port(proc)
        deadline = time.time() + 300
        while proc.poll() is None and time.time() < deadline:
            try:
                ob = _healthz(port).get("online") or {}
                # early polls can race the probe wiring — require the
                # block to show up at least once during the drain
                saw_online = saw_online or bool(ob.get("mode"))
            except (urllib.error.URLError, OSError, ValueError):
                pass   # between server teardown and process exit
            time.sleep(0.05)
        out, err = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate(timeout=30)
    assert proc.returncode == 0, err[-2000:]
    assert saw_online, \
        "/healthz online block never answered during the drain"
    assert read_resume_marker(os.path.join(victim_dir, "ckpt")) is None, \
        "resume marker not consumed"
    status = json.loads(out.strip().splitlines()[-1])
    assert status["windows_completed"] == windows, status

    # at-least-once: the resume adopted the cursor and replayed exactly
    # the open window (SIGTERM) / re-entered the lost window (SIGKILL)
    events = []
    with open(jsonl) as fh:
        for line in fh:
            events.append(json.loads(line))
    resumes = [e for e in events if e["event"] == "cursor_resume"]
    assert len(resumes) > resumes0, \
        sorted({e["event"] for e in events})
    replayed = int(resumes[-1].get("replay_files", 0) or 0)
    if signame == "TERM":
        assert replayed == len(open_window), (replayed, open_window)

    # ---- bit-determinism vs the unkilled oracle
    step, digest = _final_digest(victim_dir, seed, device)
    if signame == "KILL":
        # SIGKILL resumes from the last BOUNDARY checkpoint — no
        # mid-window state survives, so the drained daemon's final
        # state must bit-match the oracle's exactly
        assert (step, digest) == (oracle_step, oracle_digest), (
            f"post-resume state diverged from the unkilled oracle:\n"
            f"  oracle step {oracle_step} digest {oracle_digest}\n"
            f"  victim step {step} digest {digest}")
        common_step, common_digest = step, digest
    else:
        # SIGTERM resumed MID-window: the open window's pre-kill
        # batches legitimately train twice (at-least-once), inflating
        # global_step by < one window — the bit-match contract is at
        # the last COMMON window boundary (stream_check's), and the
        # inflation stays bounded to the replayed window
        assert oracle_step <= step < oracle_step + windows * 256 // BS, (
            step, oracle_step)
        from paddlebox_tpu_torch.config import flags_scope
        with flags_scope(seed=seed):
            victim_steps = set(CheckpointManager(
                os.path.join(victim_dir, "ckpt")).steps())
            oracle_steps = set(CheckpointManager(
                os.path.join(oracle_dir, "ckpt")).steps())
        kill_step = int(cursor["global_step"])
        common = sorted(s for s in victim_steps & oracle_steps
                        if s <= kill_step)
        assert common, "no common pre-kill boundary checkpoint"
        common_step = common[-1]
        _, d_oracle = _final_digest(oracle_dir, seed, device,
                                    step=common_step)
        _, common_digest = _final_digest(victim_dir, seed, device,
                                         step=common_step)
        assert common_digest == d_oracle, (
            f"killed run diverged from the oracle at the last common "
            f"window boundary (step {common_step}):\n"
            f"  oracle {d_oracle}\n  victim {common_digest}")
    return dict(ok=True, signal=signame, rc=rc,
                open_window=open_window, replayed_files=replayed,
                final_step=step, common_boundary=int(common_step),
                boundary_digest=common_digest)


# ---------------------------------------------------------------------------
# leg 4: corrupt-delta chaos through the daemon's own reload loop
# ---------------------------------------------------------------------------

def _run_corrupt_delta_leg(workdir: str, seed: int,
                           device: str = "cuda") -> dict:
    import numpy as np

    from paddlebox_tpu_torch.config import flags_scope
    from paddlebox_tpu_torch.data import DataFeedDesc, DatasetFactory
    from paddlebox_tpu_torch.data.criteo import generate_criteo_files
    from paddlebox_tpu_torch.obs.hub import get_hub, reset_hub
    from paddlebox_tpu_torch.online import OnlineLearner
    from paddlebox_tpu_torch.resilience import preemption
    from paddlebox_tpu_torch.train.checkpoint import CheckpointManager

    reset_hub()
    preemption.clear_stop()
    staged = generate_criteo_files(os.path.join(workdir, "staged"),
                                   num_files=3 * WINDOW,
                                   rows_per_file=ROWS,
                                   vocab_per_slot=40, seed=seed)
    data_dir = os.path.join(workdir, "data")
    os.makedirs(data_dir)
    for p in staged[:WINDOW]:               # window 0 only, for now
        shutil.copy(p, data_dir)

    with flags_scope(seed=seed,
                     telemetry_jsonl=os.path.join(workdir,
                                                  "telemetry.jsonl"),
                     stream_window_files=WINDOW,
                     stream_ckpt_every_windows=1,
                     shrink_every_windows=3,
                     shrink_delete_threshold=0.05,
                     show_click_decay_rate=0.9,
                     read_thread_num=1):
        desc = DataFeedDesc.criteo(batch_size=BS)
        desc.key_bucket_min = 2048
        trainer = _mk_trainer(desc, seed, device)
        cm = CheckpointManager(os.path.join(workdir, "ckpt"),
                               artifacts=os.path.join(workdir, "registry"))
        srv = _srv(desc, device)

        def filelist():
            return sorted(_glob.glob(os.path.join(data_dir, "*.txt")))

        def mkds():
            ds = DatasetFactory().create_dataset("QueueDataset", desc)
            ds.set_filelist(filelist())
            return ds

        learner = OnlineLearner(trainer, mkds, cm, serving=srv,
                                store=cm.artifacts,
                                filelist_fn=filelist, max_windows=3,
                                reload_poll_sec=0.05)
        probe = _probe_keys(staged[0], desc)
        worker = _QueryWorker(srv, probe)
        worker.start()
        th = threading.Thread(target=learner.run, daemon=True)
        th.start()
        store = cm.artifacts
        hub = get_hub()

        def wait_for(cond, what, sec=120):
            deadline = time.time() + sec
            while time.time() < deadline:
                if cond():
                    return
                time.sleep(0.02)
            raise AssertionError(f"timed out waiting for {what}")

        # window 0 publishes the base; the daemon's loop adopts it
        wait_for(lambda: len(store.versions()) >= 1, "the base publish")
        v1 = store.versions()[0]
        wait_for(lambda: srv.adopted_aid == v1, "base adoption")
        # pause the daemon's reload loop at a known point so the
        # corruption deterministically lands BEFORE the next adoption
        loop = learner._loop
        loop.stop()

        for p in staged[WINDOW:2 * WINDOW]:   # window 1 -> delta v2
            shutil.copy(p, data_dir)
        wait_for(lambda: len(store.versions()) >= 2, "the delta publish")
        v2 = store.versions()[1]
        payload = os.path.join(store.version_dir(v2),
                               "sparse_delta.npz")
        with open(payload, "rb") as fh:
            blob = fh.read()
        flip = 13 % len(blob)
        with open(payload, "wb") as fh:
            fh.write(blob[:flip] + bytes([blob[flip] ^ 0xFF])
                     + blob[flip + 1:])

        refused0 = hub.counter("pbox_artifact_refused_total").value(
            reason="corrupt")
        degraded0 = loop.degraded
        for _ in range(3):   # the daemon's own poll refuses, loudly
            assert loop.poll_once() is None
        assert srv.adopted_aid == v1, "corrupt delta must not swap in"
        assert loop.degraded > degraded0, "degrade was silent"
        assert hub.counter("pbox_artifact_refused_total").value(
            reason="corrupt") > refused0, "refusal was silent"
        assert srv.serving_status()["staleness_sec"] > 0.0
        assert _versions_behind(store, srv.adopted_aid) == 1
        ob = hub.health().get("online") or {}
        assert ob.get("mode") in ("full", "degraded"), ob

        # recovery path the daemon itself produces: window 2 completes
        # the shrink cadence (wc=3) -> forced BASE publish, adoptable
        # without replaying the corrupt delta
        for p in staged[2 * WINDOW:]:
            shutil.copy(p, data_dir)
        th.join(timeout=300)
        assert not th.is_alive(), "daemon never drained"
        versions = store.versions()
        assert len(versions) == 3, versions
        v3 = versions[2]
        man = store.read_manifest(v3, verify=False)
        assert man.get("kind") == "base", (
            f"the shrink boundary was meant to force a BASE: {man}")
        assert loop.poll_once() == v3
        assert srv.adopted_aid == v3
        assert srv.serving_status()["staleness_sec"] == 0.0
        assert _versions_behind(store, srv.adopted_aid) == 0
        worker.stop()
        assert learner.shrink_cycles == 1
        assert learner.totals["windows"] == 3

        seen = {aid for aid, _ in worker.records}
        assert v2 not in seen, "a corrupt version answered queries"
        oracle = _lookup_oracles(store, desc, probe, seen, device)
        torn = [(a, d) for a, d in worker.records if oracle.get(a) != d]
        assert not torn, f"queries tore during the degrade window: {torn[:3]}"
    return dict(ok=True, refused_version=v2, recovered_version=v3,
                versions=versions, queries=sum(worker.records.values()))


# ---------------------------------------------------------------------------
# leg 5: online.shrink fault seam — transient retry / hard skip
# ---------------------------------------------------------------------------

def _run_shrink_chaos_leg(workdir: str, seed: int,
                          device: str = "cuda") -> dict:
    from paddlebox_tpu_torch.config import flags_scope
    from paddlebox_tpu_torch.data import DataFeedDesc, DatasetFactory
    from paddlebox_tpu_torch.data.criteo import generate_criteo_files
    from paddlebox_tpu_torch.obs import flightrec
    from paddlebox_tpu_torch.obs.hub import get_hub, reset_hub
    from paddlebox_tpu_torch.online import OnlineLearner
    from paddlebox_tpu_torch.resilience import preemption
    from paddlebox_tpu_torch.resilience.faults import FaultPlan, installed
    from paddlebox_tpu_torch.train.checkpoint import CheckpointManager

    out = {}
    for sub, spec in (("transient", "online.shrink:fail:nth=1,times=1"),
                      ("hard", "online.shrink:fail:nth=1,exc=crash")):
        reset_hub()
        preemption.clear_stop()
        wd = os.path.join(workdir, sub)
        jsonl = os.path.join(wd, "telemetry.jsonl")
        files = generate_criteo_files(os.path.join(wd, "data"),
                                      num_files=3 * WINDOW,
                                      rows_per_file=ROWS,
                                      vocab_per_slot=40, seed=seed)
        frec_dir = os.path.join(wd, "flightrec")
        with flags_scope(seed=seed, telemetry_jsonl=jsonl,
                         stream_window_files=WINDOW,
                         stream_ckpt_every_windows=1,
                         shrink_every_windows=1,
                         shrink_delete_threshold=0.05,
                         show_click_decay_rate=0.9,
                         flightrec_dir=frec_dir,
                         read_thread_num=1):
            flightrec.configure_from_flags()
            desc = DataFeedDesc.criteo(batch_size=BS)
            desc.key_bucket_min = 2048
            trainer = _mk_trainer(desc, seed, device)
            cm = CheckpointManager(os.path.join(wd, "ckpt"))

            def mkds(files=files):
                ds = DatasetFactory().create_dataset("QueueDataset",
                                                     desc)
                ds.set_filelist(files)
                return ds

            learner = OnlineLearner(trainer, mkds, cm,
                                    filelist_fn=lambda f=files: list(f),
                                    max_idle_polls=2)
            plan = FaultPlan.parse(spec, seed=seed)
            with installed(plan):
                totals = learner.run()
            flightrec.install_recorder(None)
        assert totals["windows"] == 3, totals
        assert plan.stats()["online.shrink:fail"]["fired"] >= 1, \
            plan.stats()
        hub = get_hub()
        with open(jsonl) as fh:
            names = [json.loads(line)["event"] for line in fh]
        if sub == "transient":
            # the seeded online.shrink policy retried past the injected
            # failure: every cycle completed, none skipped
            assert learner.shrink_cycles == 3, learner.online_status()
            assert learner.shrink_skipped_total == 0
            assert names.count("online_shrink") == 3
        else:
            # hard failure: the first cycle SKIPPED loudly, training
            # continued, the cadence resumed on later windows
            assert learner.shrink_skipped_total == 1, \
                learner.online_status()
            assert learner.shrink_cycles == 2
            assert hub.counter(
                "pbox_online_shrink_skipped_total").value() == 1
            assert "online_shrink_skipped" in names, sorted(set(names))
            bundles = os.listdir(frec_dir) if os.path.isdir(frec_dir) \
                else []
            assert bundles, "shrink_skipped never tripped the recorder"
        out[sub] = dict(ok=True, cycles=int(learner.shrink_cycles),
                        skipped=int(learner.shrink_skipped_total),
                        fault=plan.stats())
    return out


# ---------------------------------------------------------------------------

def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--windows", type=int, default=SOAK_WINDOWS,
                    help="soak horizon (>=9: 3x stream_check's "
                         "3 windows)")
    ap.add_argument("--device", default="cuda",
                    help="where the trainers and servers run (cuda or cpu)")
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--keep", action="store_true")
    ap.add_argument("--skip-subprocess", action="store_true",
                    help="skip the real-signal subprocess legs")
    args = ap.parse_args()
    dev = args.device

    base = args.workdir or tempfile.mkdtemp(prefix="pbox_online_")
    try:
        # ---- soak x2: identical seed, identical outcome required
        soaks = []
        for run in (1, 2):
            wd = os.path.join(base, f"soak{run}")
            os.makedirs(wd, exist_ok=True)
            print(f"--- soak run {run} ({args.windows} windows, "
                  f"seed={args.seed}) ---")
            soaks.append(_run_soak_leg(wd, args.seed, args.windows, dev))
            print(json.dumps({k: v for k, v in soaks[-1].items()
                              if k != "samples"}, sort_keys=True))
            print(json.dumps({key: [s[key] for s in soaks[-1]["samples"]]
                              for key in ("staleness_sec", "rss_mb")}))
        if soaks[0]["sig"] != soaks[1]["sig"]:
            print("FAIL: soak outcome differs across identically-"
                  "seeded runs:")
            print(json.dumps(soaks[0]["sig"], sort_keys=True))
            print(json.dumps(soaks[1]["sig"], sort_keys=True))
            return 1

        # ---- tiered lifecycle x2 (deterministic)
        tiered = []
        for run in (1, 2):
            wd = os.path.join(base, f"tiered{run}")
            os.makedirs(wd, exist_ok=True)
            print(f"--- tiered lifecycle run {run} ---")
            tiered.append(_run_tiered_lifecycle_leg(wd, args.seed,
                                                    args.windows, dev))
        if tiered[0] != tiered[1]:
            print("FAIL: tiered lifecycle outcome not deterministic")
            return 1
        print(json.dumps(dict(shrunk=tiered[0]["shrunk_total"],
                              last=tiered[0]["samples"][-1]),
                         sort_keys=True))

        # ---- chaos legs
        print("--- corrupt-delta chaos ---")
        corrupt = _run_corrupt_delta_leg(
            os.path.join(base, "corrupt"), args.seed, dev)
        print(json.dumps(corrupt, sort_keys=True))
        print("--- shrink chaos (transient retry / hard skip) ---")
        chaos = _run_shrink_chaos_leg(os.path.join(base, "chaos"),
                                      args.seed, dev)
        print(json.dumps(chaos, sort_keys=True))

        if not args.skip_subprocess:
            for signame in ("TERM", "KILL"):
                print(f"--- real-SIG{signame} subprocess round-trip ---")
                out = _run_kill_leg(
                    os.path.join(base, f"kill_{signame.lower()}"),
                    args.seed, signame, device=dev)
                print(json.dumps(out, sort_keys=True))

        print(f"PASS: {args.windows}-window soak plateaued "
              f"(live/cursor/RSS/staleness in versions) deterministically "
              f"x2, tiered lifecycle plateaued with SSD compaction, "
              f"corrupt delta refused + recovered via the forced-base "
              f"publish, shrink chaos retried/skipped loudly"
              + ("" if args.skip_subprocess else
                 ", SIGTERM/SIGKILL round-trips bit-matched the "
                 "unkilled oracle"))
        return 0
    finally:
        if not args.keep and args.workdir is None:
            shutil.rmtree(base, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
