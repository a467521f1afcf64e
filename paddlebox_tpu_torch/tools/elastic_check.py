"""Seeded end-to-end elastic membership churn gate (the port's counterpart
of ``scripts/elastic_check.py``).

Drives a stream job (8 windows, 4 simulated hosts x 2 shards each, every
shard on one device) through the full lose-and-regain ladder of
``train/multihost.ElasticStreamRunner`` + ``distributed/elastic``:

1. host ``h1`` dies after the first window boundary: one missed
   heartbeat poll is ABSORBED (``dead_checks=2`` hysteresis), the
   second confirms the death — the survivors agree the boundary step
   over ``RestoreConsensus``, re-shard the embedding table to the
   6-shard world (``key % num_shards`` re-import) and continue,
2. ``h1`` rejoins two windows later and is re-admitted at the NEXT
   boundary (joins carry no hysteresis) — re-shard back to 8 shards,
3. a FALSE-DEAD heartbeat on ``h2`` (one aged lease, refreshed before
   the next poll) produces ZERO spurious scale events or re-shards,
4. the straggler watchdog's shrink-and-continue rung
   (``obs/watchdog.shrink_and_continue_action``) evicts a wedged ``h3``
   — eviction bypasses the hysteresis and the next boundary re-shards
   down without it,
5. a transient ``elastic.kv`` fault is retried on the seeded
   RetryPolicy with no membership flap, and a transient
   ``elastic.rendezvous`` poll failure is absorbed by the rendezvous
   window,
6. a REAL rank loss: a heartbeat-only peer process is SIGKILLed and the
   manager confirms the death through genuine TTL expiry (the one
   wall-clock leg; every in-scenario lease transition is a
   deterministic ``os.utime`` age-out).

Asserted, per run:

- the world-per-window schedule is exactly ``[4, 4, 3, 3, 4, 4, 4, 3]``
  hosts with re-shards at boundaries B1 (8->6 shards), B3 (6->8) and
  B6 (8->6), and nowhere else,
- at EVERY re-shard ``digest_after == digest`` — the shard-count
  invariant ``elastic_state_digest`` proves the re-import lossless,
- the churned run bit-matches an UNCHURNED oracle at every common
  boundary up to and including the first re-shard,
- a SCHEDULE ORACLE — the same runner driven by a scripted controller
  with the same world-per-window schedule but none of the detection
  machinery — bit-matches the churned run at EVERY boundary,
- no window trains twice past a completed boundary,
- the restart pointer tracks the newest boundary,

and the whole scenario runs twice with the same seed — the
(timing-stripped) outcomes must be identical.

``make_world(np)`` builds a ``ShardedTrainer`` over a device list of
``np x 2`` entries where the reference builds a mesh of as many chips.

Usage::

    python -m paddlebox_tpu_torch.tools.elastic_check [--seed 7]
        [--rows 192] [--device cuda|cpu]

The trainers live on the card unless ``--device cpu``. Prints the perf
rows ``elastic.reshard_stall_ms`` and
``elastic.degraded_throughput_frac`` as JSON lines; exit code 0 ==
churn survived, digests match, deterministic x2.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time
from contextlib import redirect_stdout

#: gate geometry: 4 hosts x 2 shards, 8 stream windows, one file per
#: window. WORLD_SCHEDULE is the hosts-per-window ground truth.
HOSTS = ("h0", "h1", "h2", "h3")
DEV_PER_HOST = 2
NUM_WINDOWS = 8
WORLD_SCHEDULE = [4, 4, 3, 3, 4, 4, 4, 3]
RESHARD_AT = {1: (4, 3), 3: (3, 4), 6: (4, 3)}
JOB = "elastic_gate"
TTL = 3600.0  # in-scenario death is an explicit utime age-out, never a race

#: the checkout's root (the SIGKILL peer imports the package from it)
REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

#: heartbeat-only peer for the SIGKILL leg: registers and sleeps; the
#: parent kills it and waits for genuine TTL expiry
_PEER_SRC = r"""
import sys, time
from paddlebox_tpu_torch.distributed.elastic import ElasticManager, FileKVStore
root, host, ttl = sys.argv[1], sys.argv[2], float(sys.argv[3])
m = ElasticManager(FileKVStore(root), "sigkill_leg", host, 2,
                   ttl=ttl, heartbeat_period=ttl / 5.0)
m.register()
print("registered", flush=True)
time.sleep(600)
"""


def _strip_timing(records: list) -> list:
    """Runner records minus wall-clock fields — the x2-comparable view."""
    out = []
    for r in records:
        c = {k: v for k, v in r.items() if k != "train_sec"}
        if "reshard" in r:
            c["reshard"] = {k: v for k, v in r["reshard"].items()
                            if k != "stall_sec"}
        out.append(c)
    return out


class ScheduledController:
    """Scripted ``ElasticController`` twin: replays a boundary->decision
    schedule with NONE of the detection machinery (no manager, no KV, no
    consensus — ``agree_boundary`` IS the local step). Driving the same
    ``ElasticStreamRunner`` with it yields the schedule oracle."""

    def __init__(self, decisions: dict) -> None:
        self.decisions = dict(decisions)
        self._window = -1

    def publish(self, path: str, pass_id: int) -> None:
        self._window = pass_id

    def poll(self):
        return self.decisions.get(self._window)

    def agree_boundary(self, local_step, survivors=None):
        return local_step

    def note_reshard(self, old_np, new_np, step=-1) -> None:
        pass


def _run_sigkill_leg(workdir: str) -> dict:
    """Leg (6): a real heartbeat-only peer process SIGKILLed mid-job; the
    survivor confirms the death through genuine TTL expiry (with
    ``dead_checks=2`` hysteresis: the first expired poll is absorbed)."""
    from paddlebox_tpu_torch.distributed.elastic import (ElasticManager,
                                                         FileKVStore)
    root = os.path.join(workdir, "elastic_sigkill")
    ttl = 1.0
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.Popen(
        [sys.executable, "-c", _PEER_SRC, root, "px", str(ttl)],
        env=env, stdout=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        if "registered" not in line:
            raise RuntimeError(f"sigkill peer failed to register: {line!r}")
        mgr = ElasticManager(FileKVStore(root), "sigkill_leg", "m0", 2,
                             ttl=ttl, heartbeat_period=0.1, dead_checks=2)
        mgr.register()
        assert mgr.scale_event() is None  # baseline: {m0, px}
        assert mgr.alive_hosts() == ["m0", "px"], mgr.alive_hosts()
        proc.send_signal(signal.SIGKILL)
        proc.wait()
        # the lease outlives the process: no event before TTL expiry
        assert mgr.scale_event() is None, "dead peer detected before TTL"
        deadline = time.time() + 30.0
        polls, event = 0, None
        while event is None and time.time() < deadline:
            time.sleep(ttl / 2.0)
            polls += 1
            event = mgr.scale_event()
        assert event == ["m0"], f"sigkill leg: no scale event ({polls} polls)"
        assert mgr.last_event["lost"] == ["px"], mgr.last_event
        assert polls >= 2, "hysteresis must absorb the first expired poll"
        mgr.deregister()
        return {"sigkill_lost": ["px"], "sigkill_survivors": event,
                "sigkill_hysteresis_held": True}
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def run_scenario(workdir: str, seed: int, rows: int,
                 device: str = "cuda") -> dict:
    """One full churn round-trip; returns the timing-stripped outcome."""
    import torch

    from paddlebox_tpu_torch.config import flags_scope
    from paddlebox_tpu_torch.data import DataFeedDesc, DatasetFactory
    from paddlebox_tpu_torch.data.criteo import generate_criteo_files
    from paddlebox_tpu_torch.distributed.elastic import (ElasticManager,
                                                         FileKVStore)
    from paddlebox_tpu_torch.models import DeepFM
    from paddlebox_tpu_torch.obs.hub import reset_hub
    from paddlebox_tpu_torch.obs.watchdog import (LocalHeartbeatStore,
                                                  StragglerWatchdog,
                                                  shrink_and_continue_action)
    from paddlebox_tpu_torch.ps.sgd import SparseSGDConfig
    from paddlebox_tpu_torch.ps.sharded import ShardedEmbeddingTable
    from paddlebox_tpu_torch.resilience.consensus import RestoreConsensus
    from paddlebox_tpu_torch.resilience.faults import FaultPlan, installed
    from paddlebox_tpu_torch.train.checkpoint import CheckpointManager
    from paddlebox_tpu_torch.train.multihost import (ElasticController,
                                                     ElasticStreamRunner)
    from paddlebox_tpu_torch.train.sharded import ShardedTrainer

    reset_hub()
    files = generate_criteo_files(os.path.join(workdir, "data"),
                                  num_files=NUM_WINDOWS,
                                  rows_per_file=rows,
                                  vocab_per_slot=60, seed=seed)
    cfg = SparseSGDConfig(mf_create_thresholds=0.0, mf_initial_range=0.0,
                          learning_rate=0.1, mf_learning_rate=0.1)
    with flags_scope(seed=seed, read_thread_num=1,
                     retry_base_delay_sec=0.01, retry_max_delay_sec=0.05):
        desc = DataFeedDesc.criteo(batch_size=16)
        desc.key_bucket_min = 1024

        datasets = []
        for path in files:  # loaded ONCE; every run sees identical batches
            ds = DatasetFactory().create_dataset("InMemoryDataset", desc)
            ds.set_filelist([path])
            ds.load_into_memory()
            datasets.append(ds)

        ds_calls: dict = {}

        def dataset_fn(label: str):
            ds_calls[label] = []

            def make_dataset(widx: int):
                ds_calls[label].append(widx)
                return datasets[widx]
            return make_dataset

        def world_fn(ckpt_root: str):
            def make_world(np_hosts: int):
                n_dev = np_hosts * DEV_PER_HOST
                table = ShardedEmbeddingTable(
                    n_dev, mf_dim=4, capacity_per_shard=4096, cfg=cfg,
                    req_bucket_min=256, serve_bucket_min=256,
                    devices=[device] * n_dev)
                # a seeded init: every world starts from the same params
                torch.manual_seed(seed)
                model = DeepFM(26, 3 + 4, 13, hidden=(16, 16))
                tr = ShardedTrainer(
                    model, table, desc, seed=seed,
                    tx=lambda p: torch.optim.Adam(p, lr=2e-3))
                return tr, CheckpointManager(ckpt_root)
            return make_world

        # ---- elastic plane: shared-dir leases for the 4 virtual hosts.
        # h0 is this process (real manager + heartbeat thread); h1-h3
        # are lease files whose life is scripted with utime age-outs —
        # TTL is huge, so every death below is deterministic.
        store = FileKVStore(os.path.join(workdir, "elastic"))

        def lease_path(host: str) -> str:
            return store._path(f"paddlebox/{JOB}/nodes/{host}")

        def put_lease(host: str) -> None:
            store.put(f"paddlebox/{JOB}/nodes/{host}",
                      json.dumps({"host": host}).encode())

        def age_lease(host: str) -> None:
            old = time.time() - 2 * TTL
            os.utime(lease_path(host), (old, old))

        for h in HOSTS[1:]:
            put_lease(h)
        mgr = ElasticManager(store, JOB, "h0", len(HOSTS),
                             min_np=2, max_np=len(HOSTS), ttl=TTL,
                             heartbeat_period=0.05, dead_checks=2)

        # (5a) transient elastic.kv fault retried on the seeded policy
        # (before register(), so the heartbeat thread can't race the
        # nth=1 counter) — membership view intact
        with installed(FaultPlan.parse("elastic.kv:fail:nth=1",
                                       seed=seed)) as kvp:
            alive = mgr.alive_hosts()
        assert kvp.stats()["elastic.kv:fail"]["fired"] == 1, kvp.stats()
        assert alive == sorted(HOSTS[1:]), alive

        mgr.register()
        # (5b) transient rendezvous poll absorbed inside wait_for_np
        with installed(FaultPlan.parse("elastic.rendezvous:fail:nth=1",
                                       seed=seed)) as rvp:
            hosts0 = mgr.wait_for_np(timeout=30.0)
        assert rvp.stats()["elastic.rendezvous:fail"]["fired"] == 1
        assert hosts0 == sorted(HOSTS), hosts0

        consensus = RestoreConsensus(
            os.path.join(workdir, "consensus"), 0, 1, timeout=30.0)
        controller = ElasticController(mgr, consensus)
        assert controller.poll() is None  # steady 4-host baseline

        # ---- watchdog leg state (fires at B6 via on_boundary below)
        wd_evicted: list = []

        def run_watchdog_rung() -> None:
            tvar = [1000.0]
            hb = LocalHeartbeatStore()

            def evict(reports) -> None:
                for r in reports:
                    host = HOSTS[r.process]
                    wd_evicted.append((host, r.reason))
                    controller.evict(host, f"watchdog:{r.reason}")
            wd = StragglerWatchdog(
                hb, 0, len(HOSTS), step_lag=100, heartbeat_timeout=30.0,
                clock=lambda: tvar[0],
                escalations=[(0.0, shrink_and_continue_action(evict))])
            hb.publish(3, 100, 1005.0)  # h3 wedged: last beat long ago
            tvar[0] = 1040.0
            for p in (0, 1, 2):
                hb.publish(p, 100, tvar[0])
            reports = wd.poll_once()
            assert [r.process for r in reports] == [3], reports

        def on_boundary(widx: int, trainer) -> None:
            if widx == 0:
                age_lease("h1")       # h1 dies: miss 1 at B0, dead at B1
            elif widx == 3:
                put_lease("h1")       # h1 rejoins: admitted at B3
            elif widx == 4:
                age_lease("h2")       # false-dead: one missed poll...
            elif widx == 5:
                store.touch(f"paddlebox/{JOB}/nodes/h2")  # ...recovers
            elif widx == 6:
                run_watchdog_rung()   # h3 wedged -> shrink-and-continue

        # ---- (1-4) the churned run
        churn_runner = ElasticStreamRunner(
            world_fn(os.path.join(workdir, "ckpt_churn")),
            dataset_fn("churn"), NUM_WINDOWS, controller=controller,
            on_boundary=on_boundary)
        records = churn_runner.run(len(HOSTS))
        mgr.deregister()

        assert [r["np"] for r in records] == WORLD_SCHEDULE, records
        assert ds_calls["churn"] == list(range(NUM_WINDOWS)), (
            "a window trained twice past a completed boundary: "
            f"{ds_calls['churn']}")
        for w, r in enumerate(records):
            if w in RESHARD_AT:
                old_np, new_np = RESHARD_AT[w]
                rs = r.get("reshard")
                assert rs, f"expected re-shard at boundary B{w}"
                assert (rs["old_np"], rs["new_np"]) == (old_np, new_np), rs
                assert rs["agreed_step"] == r["step"], rs
                assert rs["digest_after"] == r["digest"], (
                    f"B{w} re-shard was NOT a lossless re-import:\n"
                    f"  boundary {r['digest']}\n  after    "
                    f"{rs['digest_after']}")
            else:
                assert "reshard" not in r, (
                    f"spurious re-shard at boundary B{w}: {r}")
        assert records[1]["reshard"]["lost"] == ["h1"]
        assert records[3]["reshard"]["joined"] == ["h1"]
        assert records[6]["reshard"]["lost"] == ["h3"]
        assert wd_evicted == [("h3", "stale")], wd_evicted
        assert mgr.reshard_count == len(RESHARD_AT)
        ptr = mgr.latest_checkpoint()
        assert ptr and ptr["pass_id"] == NUM_WINDOWS - 1, ptr

        # ---- unchurned oracle: 4 hosts forever; the common prefix must
        # bit-match through the first re-shard boundary
        oracle = ElasticStreamRunner(
            world_fn(os.path.join(workdir, "ckpt_oracle")),
            dataset_fn("oracle"), NUM_WINDOWS).run(len(HOSTS))
        prefix = [w for w in range(NUM_WINDOWS) if w <= min(RESHARD_AT)]
        for w in prefix:
            assert oracle[w]["step"] == records[w]["step"]
            assert oracle[w]["digest"] == records[w]["digest"], (
                f"churned run diverged from the unchurned oracle at "
                f"boundary B{w} (before any world change)")

        # ---- schedule oracle: same world schedule, zero detection
        # machinery — EVERY boundary must bit-match the churned run
        decisions = {w: {"np": new_np, "hosts": [], "lost": [],
                         "joined": []}
                     for w, (_, new_np) in RESHARD_AT.items()}
        sched = ElasticStreamRunner(
            world_fn(os.path.join(workdir, "ckpt_sched")),
            dataset_fn("sched"), NUM_WINDOWS,
            controller=ScheduledController(decisions)).run(len(HOSTS))
        for w in range(NUM_WINDOWS):
            assert sched[w]["np"] == records[w]["np"]
            assert sched[w]["step"] == records[w]["step"]
            assert sched[w]["digest"] == records[w]["digest"], (
                f"elastic machinery perturbed training math at B{w}")

    # ---- (6) real SIGKILL'd rank, genuine TTL expiry
    sigkill = _run_sigkill_leg(workdir)

    # ---- perf rows (wall-clock; excluded from the x2 outcome)
    full_eps = [rows / r["train_sec"] for r in records
                if r["np"] == len(HOSTS) and r["train_sec"] > 0]
    deg_eps = [rows / r["train_sec"] for r in records
               if r["np"] < len(HOSTS) and r["train_sec"] > 0]
    stalls = [r["reshard"]["stall_sec"] for r in records if "reshard" in r]
    dip_frac = ((sum(deg_eps) / len(deg_eps))
                / (sum(full_eps) / len(full_eps))
                if full_eps and deg_eps else 0.0)
    stall_ms = 1000.0 * sum(stalls) / max(len(stalls), 1)
    assert dip_frac > 0.05, (
        f"degraded-world throughput collapsed: {dip_frac:.3f} of the "
        "full-world rate (the bound only catches a pathological stall)")
    perf_rows = [
        {"metric": "elastic.reshard_stall_ms",
         "value": round(stall_ms, 3), "unit": "ms"},
        {"metric": "elastic.degraded_throughput_frac",
         "value": round(dip_frac, 4), "unit": "frac"},
    ]
    for row in perf_rows:
        print(json.dumps(row))

    return dict(
        ok=True,
        world_schedule=[r["np"] for r in records],
        windows=_strip_timing(records),
        oracle_prefix_match=prefix,
        schedule_oracle_match=NUM_WINDOWS,
        dataset_order=ds_calls["churn"],
        watchdog_evicted=wd_evicted,
        reshard_count=len(RESHARD_AT),
        kv_fault_fired=1, rendezvous_fault_fired=1,
        restart_pointer_pass=ptr["pass_id"],
        perf_metrics=sorted(r["metric"] for r in perf_rows),
        **sigkill,
    )


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--rows", type=int, default=192,
                    help="examples per window file (the tests run 96)")
    ap.add_argument("--device", default="cuda",
                    help="the trainers' device (default: the card)")
    ap.add_argument("--workdir", default=None,
                    help="scratch dir (default: a fresh temp dir)")
    ap.add_argument("--keep", action="store_true",
                    help="keep the scratch dir for inspection")
    args = ap.parse_args()

    t0 = time.perf_counter()
    base = args.workdir or tempfile.mkdtemp(prefix="pbox_elastic_")
    outcomes = []
    try:
        for run in (1, 2):  # same seed twice: outcome must be identical
            wd = os.path.join(base, f"run{run}")
            os.makedirs(wd, exist_ok=True)
            print(f"--- elastic run {run} (seed={args.seed}, "
                  f"rows={args.rows}, device={args.device}) ---")
            buf = io.StringIO()
            with redirect_stdout(buf):
                outcomes.append(run_scenario(wd, args.seed, args.rows,
                                             args.device))
            sys.stdout.write(buf.getvalue())
            print(json.dumps(outcomes[-1], indent=2, sort_keys=True))
        if outcomes[0] != outcomes[1]:
            print("FAIL: elastic outcome differs across "
                  "identically-seeded runs:")
            print(json.dumps(outcomes[0], sort_keys=True))
            print(json.dumps(outcomes[1], sort_keys=True))
            return 1
        print(f"PASS: lost+regained a host mid-stream with lossless "
              f"consensus re-shards at boundaries "
              f"{sorted(RESHARD_AT)}, zero spurious re-shards on the "
              f"false-dead leg, watchdog shrink-and-continue evicted "
              f"the wedged rank, SIGKILL'd peer confirmed via TTL; "
              f"outcome deterministic across 2 runs (seed={args.seed}) "
              f"in {time.perf_counter() - t0:.1f}s")
        return 0
    finally:
        if not args.keep and args.workdir is None:
            shutil.rmtree(base, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
