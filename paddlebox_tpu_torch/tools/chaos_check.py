"""Seeded end-to-end chaos check (the port's counterpart of
``scripts/chaos_check.py``).

Runs a tiny training scenario under a deterministic ``FaultPlan`` that
injects, in ONE run:

1. a transient CommandBackend failure (first remote ``exists`` call),
2. a corrupt record file (every line of one input file is mangled at
   the ``parser.record`` seam), and
3. a mid-save checkpoint crash (the second ``save`` dies just before
   its atomic publish),
4. a transient ``stream.window`` dispatch failure on a WINDOWED
   streaming job (docs/RESILIENCE.md §Streaming),
5. ``ssd.io`` faults on a THREE-TIER (HBM+mem+SSD) table
   (docs/STORAGE.md): a transient segment write during demotion and a
   transient segment read during promotion (both retried on the seeded
   RetryPolicy), a hard CRASH mid-demotion, and a flipped byte in a
   manifested segment file, and
6. ``artifact.publish`` / ``artifact.read`` faults on the versioned
   publishing layer (artifacts.py; docs/RESILIENCE.md §Publishing): a
   transient publish failure retried on the seeded RetryPolicy, and a
   hard-corrupt read of the newest version refused loudly with a
   graceful fallback to its verifiable parent, and
7. a transient ``artifact.read`` failure during the SERVING hot-reload
   poll (serving.ReloadLoop; docs/SERVING.md): the store's seeded
   RetryPolicy retries it INSIDE the poll — the new version still
   adopts on that same poll, no refusal is booked, and the query path
   never sees a gap (the prior snapshot answers throughout),
8. ``elastic.kv`` / ``elastic.rendezvous`` faults on the ELASTIC
   membership plane (distributed/elastic.py; docs/RESILIENCE.md
   §Elastic membership): a transient KV fault during the membership
   list retried on the seeded RetryPolicy, a delayed-but-alive
   heartbeat absorbed by the ``dead_checks`` hysteresis (no membership
   flap, no spurious re-shard), and a rendezvous that times out on a
   genuinely missing host DIAGNOSABLY — the error names the host,

then asserts full recovery:

- the pass completes and the quarantine list names EXACTLY the corrupt
  file,
- ``restore()`` into a fresh trainer returns the last consistent step,
- the windowed stream retries the broken window from its boundary
  checkpoint and still consumes every file,
- the tiered trainer restores THROUGH spill-manifest verification after
  the mid-demotion crash with no lost rows (bit-identical full-model
  digest), while the corrupt segment makes the same restore refuse
  LOUDLY (``CheckpointCorruptError``) — never silent zeros,
- the telemetry JSONL records nonzero ``retry_attempts`` /
  ``files_quarantined`` counters,

and finally runs the WHOLE scenario a second time with the same seed
and asserts the resilience outcome (quarantine list, fault-plan stats,
restored step, counters) is byte-identical — chaos is reproducible.

Usage::

    python -m paddlebox_tpu_torch.tools.chaos_check [--seed 7]
        [--device cuda|cpu]

The trainers, tables and the serving model run on the card unless
``--device cpu``; the SSD leg's ``SSD_SHARDS`` shards all sit on that
one device.

Exit code 0 == recovered + deterministic.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

#: shards of the SSD leg's tiered table, all on one device: the
#: reference's leg makes one shard a device of its mesh, eight under its
#: test harness's virtual CPU platform
SSD_SHARDS = 8


def _run_ssd_chaos(workdir: str, seed: int, device: str,
                   shards: int) -> dict:
    """Fault (5): the SSD third tier under chaos (ps/ssd.py). Drives a
    tiered sharded trainer (``shards`` shards, all on ``device``) whose
    host stores hold more rows than the demote watermark allows, so
    segments exist and the checkpoint records a spill manifest — then
    injects the ``ssd.io`` seam."""
    import numpy as np
    import torch

    from paddlebox_tpu_torch.data import DataFeedDesc
    from paddlebox_tpu_torch.models import DeepFM
    from paddlebox_tpu_torch.ps.sgd import SparseSGDConfig
    from paddlebox_tpu_torch.ps.table import FIELDS
    from paddlebox_tpu_torch.ps.tiered import TieredShardedEmbeddingTable
    from paddlebox_tpu_torch.resilience.faults import (FaultPlan,
                                                       InjectedCrash,
                                                       installed)
    from paddlebox_tpu_torch.train.checkpoint import (
        CheckpointCorruptError, CheckpointManager)
    from paddlebox_tpu_torch.train.sharded import ShardedTrainer

    desc = DataFeedDesc.criteo(batch_size=32)
    cfg = SparseSGDConfig(mf_create_thresholds=0.0, mf_initial_range=0.0)
    ckpt_root = os.path.join(workdir, "ckpt_ssd")

    def mk(tier: str):
        table = TieredShardedEmbeddingTable(
            shards, mf_dim=4, capacity_per_shard=2048, cfg=cfg,
            host_capacity=512, req_bucket_min=256, serve_bucket_min=256,
            ssd_dir=os.path.join(workdir, tier), devices=[device] * shards)
        torch.manual_seed(seed)
        tr = ShardedTrainer(DeepFM(26, 3 + 4, 13, hidden=(8,)), table,
                            desc, tx=lambda p: torch.optim.Adam(p, lr=1e-2))
        return table, tr

    def mk_fields(ks: np.ndarray):
        base = ks.astype(np.float32)
        return {f: (np.tile(base[:, None], (1, 4)) * 0.01
                    if f == "embedx_w" else base * 0.001)
                for f in FIELDS}

    def digest(table) -> str:
        # the layer's own read-only fingerprint (ps/host_store
        # rows_digest folded per shard) — unlike an export_rows walk
        # it clears no touched flags, so digesting twice is inert
        return table.rows_digest()

    table, tr = mk("tier1")
    keys = np.arange(1, 801, dtype=np.uint64)
    for s, ks in enumerate(table._split_by_owner(keys)):
        # chunked: the store holds 512 rows, the model 800 — inserting
        # past capacity drives the emergency headroom demoter
        for i in range(0, len(ks), 256):
            chunk = ks[i:i + 256]
            table.hosts[s].update(chunk, mk_fields(chunk))

    # (5a) transient segment WRITE during demotion — retried to success
    with installed(FaultPlan.parse("ssd.io:fail:nth=1", seed=seed)) as pw:
        demoted = sum(h.demote_cold(count=200) for h in table.hosts)
    assert demoted > 0, "ssd chaos: nothing demoted"
    assert pw.stats()["ssd.io:fail"]["fired"] == 1, pw.stats()

    # (5b) transient segment READ during promotion (the LoadSSD2Mem
    # path inside fetch) — retried the same way, values intact
    probe = np.sort(table.hosts[0].ssd.keys())[:5]
    with installed(FaultPlan.parse("ssd.io:fail:nth=1", seed=seed)) as pr:
        got = table.hosts[0].fetch(probe)
    assert pr.stats()["ssd.io:fail"]["fired"] == 1, pr.stats()
    assert np.allclose(got["embed_w"], probe.astype(np.float32) * 0.001)

    digest0 = digest(table)
    total0 = sum(h.total_rows() for h in table.hosts)
    cm = CheckpointManager(ckpt_root)
    cm.save(tr)
    step = int(tr.global_step)
    mpath = os.path.join(ckpt_root, f"ckpt-{step:012d}",
                         "spill_manifest.json")
    assert os.path.isfile(mpath), \
        "tiered checkpoint recorded no spill manifest"

    # (5c) hard crash MID-DEMOTION (process dies inside the segment
    # append) — the checkpoint published above must stay restorable
    crashed = False
    with installed(FaultPlan.parse("ssd.io:fail:nth=1,exc=crash",
                                   seed=seed)):
        try:
            for h in table.hosts:
                h.demote_cold(count=100)
        except InjectedCrash:
            crashed = True
    assert crashed, "mid-demotion crash fault never fired"

    # (5d) corrupt ONE manifested segment: the restart must refuse
    # LOUDLY before any promote could read garbage
    with open(mpath) as fh:
        seg0 = json.load(fh)["shards"]["0"]["segments"][0]["path"]
    with open(seg0, "rb") as fh:
        blob = fh.read()
    with open(seg0, "wb") as fh:
        fh.write(blob[:8] + bytes([blob[8] ^ 0xFF]) + blob[9:])
    _, tr_c = mk("tier_corrupt")
    loud = False
    try:
        CheckpointManager(ckpt_root).restore(tr_c)
    except CheckpointCorruptError:
        loud = True
    assert loud, "corrupt segment restored silently"

    # repair the segment: the SAME restart now recovers every row
    # through manifest verification — nothing lost to the crash
    with open(seg0, "wb") as fh:
        fh.write(blob)
    table_r, tr_r = mk("tier_restore")
    restored = CheckpointManager(ckpt_root).restore(tr_r)
    assert restored == step, (restored, step)
    assert sum(h.total_rows() for h in table_r.hosts) == total0
    assert digest(table_r) == digest0, (
        "restore after mid-demotion crash lost or mutated rows")
    return {
        "ssd_demoted": int(demoted),
        "ssd_write_fault_fired": pw.stats()["ssd.io:fail"]["fired"],
        "ssd_read_fault_fired": pr.stats()["ssd.io:fail"]["fired"],
        "ssd_crash_mid_demotion": crashed,
        "ssd_corrupt_segment_loud": loud,
        "ssd_restored_step": int(restored),
        "ssd_rows": int(total0),
        "ssd_digest": digest0,
    }


def _writer(table):
    """``write(lo, hi, scale)``: assign keys [lo, hi) in ``table`` and
    set their embed_w to key * scale in place, marked touched."""
    import numpy as np
    import torch

    from paddlebox_tpu_torch.ps.table import FIELD_COL

    def write(lo: int, hi: int, scale: float) -> None:
        keys = np.arange(lo, hi, dtype=np.uint64)
        rows = table.index.assign(keys)
        data = table.state.data
        idx = torch.as_tensor(rows.astype(np.int64), device=data.device)
        data[idx, FIELD_COL["embed_w"]] = torch.as_tensor(
            keys.astype(np.float32) * scale, device=data.device)
        table._touched[rows] = True
    return write


def _run_artifact_chaos(workdir: str, seed: int, device: str) -> dict:
    """Fault (6): the versioned artifact/publishing layer under chaos
    (artifacts.py). A writer publishes a base+delta chain through
    ``BoxPSHelper``; the transient ``artifact.publish`` failure must be
    retried to success on the seeded RetryPolicy, and a hard-corrupt
    ``artifact.read`` of the tip must refuse LOUDLY while unpinned
    adoption gracefully falls back to the verifiable parent."""
    import numpy as np

    from paddlebox_tpu_torch.artifacts import (ArtifactCorruptError,
                                               ArtifactStore)
    from paddlebox_tpu_torch.ps.box_helper import BoxPSHelper
    from paddlebox_tpu_torch.ps.sgd import SparseSGDConfig
    from paddlebox_tpu_torch.ps.table import EmbeddingTable
    from paddlebox_tpu_torch.resilience.faults import FaultPlan, installed

    cfg = SparseSGDConfig(mf_create_thresholds=1e9)
    table = EmbeddingTable(mf_dim=4, capacity=1 << 10, cfg=cfg,
                           device=device)
    helper = BoxPSHelper(table)
    store = ArtifactStore(os.path.join(workdir, "artifacts"))
    write = _writer(table)

    # (6a) transient publish failure — retried to a successful commit
    write(1, 101, 2.0)
    with installed(FaultPlan.parse("artifact.publish:fail:nth=1",
                                   seed=seed)) as pp:
        base_aid = helper.publish_base(store)
    assert pp.stats()["artifact.publish:fail"]["fired"] == 1, pp.stats()
    write(80, 151, 3.0)
    delta_aid = helper.publish_delta(store)

    # (6b) hard-corrupt read of the tip: every registry read of the
    # delta version mangles — explicit adoption refuses LOUDLY, and
    # unpinned adoption degrades to the verifiable base
    loud = False
    with installed(FaultPlan.parse(
            f"artifact.read:corrupt:times=0,match=*{delta_aid}*",
            seed=seed)) as pr:
        try:
            store.open(delta_aid)
        except ArtifactCorruptError:
            loud = True
        with store.open() as h:
            fallback_aid = h.aid
            reader = EmbeddingTable(mf_dim=4, capacity=1 << 10, cfg=cfg,
                                    device=device)
            reader.load(h.path("sparse.npz"), merge=False)
    assert loud, "corrupt artifact read adopted silently"
    assert fallback_aid == base_aid, (fallback_aid, base_aid)
    probe = reader.host_pull(np.array([1], np.uint64))
    assert np.allclose(probe[0, 2], 2.0), "fallback lost base rows"
    # the repaired (fault-free) tip adopts normally again
    with store.open() as h:
        healthy_aid = h.aid
    assert healthy_aid == delta_aid
    return {
        "artifact_base": base_aid,
        "artifact_delta": delta_aid,
        "artifact_publish_fault_fired":
            pp.stats()["artifact.publish:fail"]["fired"],
        "artifact_read_fault_stats": pr.stats(),
        "artifact_corrupt_loud": loud,
        "artifact_fallback": fallback_aid,
        "artifact_healthy_tip": healthy_aid,
    }


def _run_serving_chaos(workdir: str, seed: int, device: str) -> dict:
    """Fault (7): transient ``artifact.read`` during the background
    hot-reload poll (serving.ReloadLoop.poll_once). The read retries on
    the seeded RetryPolicy inside ``store.open`` — the poll itself
    succeeds (no refusal, no degrade) and serving never gaps: queries
    issued before, during and after the faulted poll all answer a
    published version bit-exactly."""
    import numpy as np

    from paddlebox_tpu_torch.artifacts import ArtifactStore
    from paddlebox_tpu_torch.data.schema import DataFeedDesc
    from paddlebox_tpu_torch.models import CtrDnn
    from paddlebox_tpu_torch.ps.box_helper import BoxPSHelper
    from paddlebox_tpu_torch.ps.sgd import SparseSGDConfig
    from paddlebox_tpu_torch.ps.table import EmbeddingTable
    from paddlebox_tpu_torch.resilience.faults import FaultPlan, installed
    from paddlebox_tpu_torch.serving import ReloadLoop, ServingModel

    cfg = SparseSGDConfig(mf_create_thresholds=1e9)
    table = EmbeddingTable(mf_dim=4, capacity=1 << 10, cfg=cfg,
                           device=device)
    helper = BoxPSHelper(table)
    store = ArtifactStore(os.path.join(workdir, "artifacts_serving"))
    write = _writer(table)

    write(1, 101, 2.0)
    base_aid = helper.publish_base(store)
    desc = DataFeedDesc.criteo(batch_size=16)
    srv = ServingModel(CtrDnn(26, 3 + 4, 13, hidden=(4,)), desc, mf_dim=4,
                       capacity=1 << 10, device=device)
    assert srv.adopt(store) == base_aid
    loop = ReloadLoop(srv, store, poll_sec=0.01)
    probe = np.arange(1, 121, dtype=np.uint64)

    def lookup_scale() -> np.ndarray:
        return srv.embed_lookup(probe)[:, 2]

    before = lookup_scale()
    assert np.allclose(before[:100], probe[:100].astype(np.float32) * 2)
    write(80, 121, 3.0)
    delta_aid = helper.publish_delta(store)
    refused0 = loop.refused
    with installed(FaultPlan.parse("artifact.read:fail:nth=1",
                                   seed=seed)) as plan:
        during = lookup_scale()     # query while the poll will retry
        adopted = loop.poll_once()
    assert plan.stats()["artifact.read:fail"]["fired"] == 1, plan.stats()
    assert adopted == delta_aid, (
        "transient read during the reload poll was not retried to a "
        f"successful adoption (got {adopted})")
    assert loop.refused == refused0, (
        "a retried transient read must not book a reload refusal")
    assert np.array_equal(during, before), (
        "a query during the faulted poll saw a torn state")
    after = lookup_scale()
    assert np.allclose(after[79:120],
                       probe[79:120].astype(np.float32) * 3), (
        "adopted delta rows not served after the retried poll")
    srv.release()
    return {
        "serving_base": base_aid,
        "serving_delta": delta_aid,
        "serving_reload_fault_fired":
            plan.stats()["artifact.read:fail"]["fired"],
        "serving_reload_adopted": adopted,
        "serving_reload_refusals": loop.refused - refused0,
        "serving_no_gap": True,
    }


def _run_elastic_chaos(workdir: str, seed: int) -> dict:
    """Fault (8): the elastic membership plane under chaos. A transient
    ``elastic.kv`` fault during the membership list is retried on the
    seeded RetryPolicy; a delayed-but-alive heartbeat (aged lease that
    recovers) is absorbed by the ``dead_checks`` hysteresis with ZERO
    membership flaps — the false-dead host never leaves, so no spurious
    re-shard can fire; and a rendezvous on a genuinely missing host
    times out naming the host (the on-call diagnosis, not a bare
    timeout)."""
    import time

    from paddlebox_tpu_torch.distributed.elastic import (ElasticManager,
                                                         FileKVStore)
    from paddlebox_tpu_torch.resilience.faults import FaultPlan, installed

    store = FileKVStore(os.path.join(workdir, "elastic_chaos"))
    for h in ("e0", "e1"):
        store.put(f"paddlebox/chaos/nodes/{h}",
                  json.dumps({"host": h}).encode())
    # huge TTL: "death" below is an explicit mtime age-out, never a race
    mgr = ElasticManager(store, "chaos", "e0", 2, ttl=3600.0,
                         heartbeat_period=0.05, dead_checks=2)

    # (8a) transient KV fault while listing members: retried to success
    with installed(FaultPlan.parse("elastic.kv:fail:nth=1",
                                   seed=seed)) as plan:
        alive = mgr.alive_hosts()
    assert plan.stats()["elastic.kv:fail"]["fired"] == 1, plan.stats()
    assert alive == ["e0", "e1"], (
        f"retried membership list lost hosts: {alive}")

    # (8b) delayed-but-alive heartbeat: one aged poll then a recovery —
    # hysteresis must absorb it with no scale event in between
    assert mgr.scale_event() is None            # baseline {e0, e1}
    key1 = "paddlebox/chaos/nodes/e1"
    old = time.time() - 7200.0
    os.utime(store._path(key1), (old, old))
    flap1 = mgr.scale_event()                   # miss 1: inside grace
    store.touch(key1)                           # heartbeat catches up
    flap2 = mgr.scale_event()                   # recovered: count reset
    assert flap1 is None and flap2 is None, (
        f"false-dead heartbeat flapped membership: {flap1} / {flap2}")

    # (8c) e1 really gone: the rendezvous barrier times out NAMING it
    store.delete(key1)
    try:
        mgr.wait_for_np(timeout=0.3)
        raise AssertionError("wait_for_np must time out with e1 gone")
    except TimeoutError as exc:
        assert "e1" in str(exc), (
            f"rendezvous timeout does not name the missing host: {exc}")
    return {
        "elastic_kv_fault_fired": plan.stats()["elastic.kv:fail"]["fired"],
        "elastic_alive_after_fault": alive,
        "elastic_false_dead_flapped": False,
        "elastic_timeout_named": ["e1"],
    }


def run_scenario(workdir: str, seed: int, device: str = "cuda",
                 shards: int = SSD_SHARDS) -> dict:
    """One full chaos run on ``device``; returns the resilience outcome
    summary."""
    import torch

    from paddlebox_tpu_torch.config import flags_scope
    from paddlebox_tpu_torch.data import DataFeedDesc, DatasetFactory
    from paddlebox_tpu_torch.data.criteo import generate_criteo_files
    from paddlebox_tpu_torch.models import CtrDnn
    from paddlebox_tpu_torch.obs.hub import reset_hub
    from paddlebox_tpu_torch.ps.sgd import SparseSGDConfig
    from paddlebox_tpu_torch.ps.table import EmbeddingTable
    from paddlebox_tpu_torch.resilience.faults import (FaultPlan,
                                                       InjectedCrash,
                                                       installed)
    from paddlebox_tpu_torch.train.checkpoint import CheckpointManager
    from paddlebox_tpu_torch.train.trainer import Trainer
    from paddlebox_tpu_torch.utils.file_mgr import FileMgr

    reset_hub()
    jsonl = os.path.join(workdir, "telemetry.jsonl")
    files = generate_criteo_files(os.path.join(workdir, "data"),
                                  num_files=3, rows_per_file=120,
                                  vocab_per_slot=40, seed=seed)
    corrupt_file = files[1]
    plan = FaultPlan.parse(
        "file_mgr.command:fail:nth=1; "
        f"parser.record:corrupt:match=*{os.path.basename(corrupt_file)}*,"
        "times=0; "
        "checkpoint.save_commit:fail:nth=2,exc=crash; "
        "stream.window:fail:nth=2", seed=seed)
    outcome: dict = {}
    with flags_scope(seed=seed, native_parse=False,
                     poison_budget_files=1, poison_budget_records=0,
                     retry_base_delay_sec=0.01, retry_max_delay_sec=0.05,
                     telemetry_jsonl=jsonl, read_thread_num=4), \
            installed(plan):
        desc = DataFeedDesc.criteo(batch_size=32)
        desc.key_bucket_min = 2048
        cfg = SparseSGDConfig(mf_create_thresholds=0.0,
                              mf_initial_range=0.0)

        def mk() -> Trainer:
            table = EmbeddingTable(mf_dim=4, capacity=1 << 12, cfg=cfg,
                                   unique_bucket_min=2048, device=device)
            torch.manual_seed(seed)
            return Trainer(CtrDnn(26, 3 + 4, 13, hidden=(8,)), table, desc,
                           tx=lambda p: torch.optim.Adam(p, lr=1e-2),
                           seed=seed, device=device)

        trainer = mk()  # attaches the JSONL sink via FLAGS

        # (1) transient CommandBackend failure, retried to success
        mgr = FileMgr()
        mgr.init(scheme="chaos", command=["true"])
        assert mgr.exists("chaos://cluster/health"), \
            "retried exists must succeed"

        # (2) corrupt record file → quarantined, survivors drain
        ds = DatasetFactory().create_dataset("InMemoryDataset", desc)
        ds.set_filelist(files)
        ds.load_into_memory()
        quarantined = [p for p, _ in ds.quarantined_files]
        assert quarantined == [corrupt_file], (
            f"quarantine list {quarantined} != [{corrupt_file}]")
        assert len(ds) == 240, f"expected 240 surviving records, {len(ds)}"

        # (3) checkpointed training with a mid-save crash
        ckpt_root = os.path.join(workdir, "ckpt")
        cm = CheckpointManager(ckpt_root)
        trainer.run_pass(ds, checkpoint=cm)
        cm.save(trainer)                       # save #1 commits
        consistent_step = trainer.global_step
        trainer.run_pass(ds, checkpoint=cm)
        crashed = False
        try:
            cm.save(trainer)                   # save #2 dies pre-publish
        except InjectedCrash:
            crashed = True
        assert crashed, "mid-save crash fault never fired"

        # restarted process: fresh manager + trainer restore cleanly
        fresh = mk()
        restored = CheckpointManager(ckpt_root).restore(fresh)
        assert restored == consistent_step, (
            f"restore() returned {restored}, want {consistent_step}")

        # (4) stream.window seam: window 2's dispatch dies once; the
        # stream retries it from the window-1 boundary checkpoint and
        # still drains every (healthy) file
        healthy = [files[0], files[2]]
        with flags_scope(stream_window_files=1, read_thread_num=1,
                         stream_ckpt_every_windows=1,
                         pass_retry_limit=1):
            sds = DatasetFactory().create_dataset("QueueDataset", desc)
            sds.set_filelist(healthy)
            streamer = mk()
            sout = streamer.train_stream(
                sds, CheckpointManager(os.path.join(workdir,
                                                    "ckpt_stream")))
        assert sout["windows"] == 2, sout
        assert sds.files_completed == healthy
        assert plan.stats()["stream.window:fail"]["fired"] == 1

        # (5) ssd.io seam on a three-tier table (sub-plans installed
        # around each injection so the op counting stays trivial)
        ssd_outcome = _run_ssd_chaos(workdir, seed, device, shards)

        # (6) artifact.publish / artifact.read seams on the versioned
        # publishing layer (same sub-plan discipline)
        artifact_outcome = _run_artifact_chaos(workdir, seed, device)

        # (7) transient artifact.read during the serving hot-reload
        # poll: retried inside the poll, no serving gap
        serving_outcome = _run_serving_chaos(workdir, seed, device)

        # (8) elastic.kv / elastic.rendezvous seams on the membership
        # plane: transient list retried, false-dead heartbeat absorbed
        # by hysteresis, missing-host rendezvous diagnosed by name
        elastic_outcome = _run_elastic_chaos(workdir, seed)

    # telemetry JSONL: final pass event carries nonzero counters
    with open(jsonl) as fh:
        events = [json.loads(line) for line in fh]
    passes = [e for e in events if e["event"] == "pass"]
    assert passes, "no pass events in telemetry JSONL"
    res = passes[-1]["resilience"]
    assert res["retry_attempts"] > 0, f"retry_attempts == 0: {res}"
    assert res["files_quarantined"] > 0, f"files_quarantined == 0: {res}"
    assert any(e["event"] == "file_quarantined" for e in events)
    assert any(e["event"] == "fault_injected" for e in events)

    outcome.update(
        quarantined=[os.path.basename(p) for p in quarantined],
        restored_step=restored,
        fault_stats=plan.stats(),
        resilience={k: res[k] for k in ("retry_attempts",
                                        "files_quarantined",
                                        "records_poisoned",
                                        "faults_injected")},
        surviving_records=len(ds),
        stream_windows=int(sout["windows"]),
        **ssd_outcome,
        **artifact_outcome,
        **serving_outcome,
        **elastic_outcome,
    )
    return outcome


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--device", default="cuda",
                    help="where the trainers, tables and the serving "
                         "model run (cuda or cpu)")
    ap.add_argument("--workdir", default=None,
                    help="scratch dir (default: a fresh temp dir)")
    ap.add_argument("--keep", action="store_true",
                    help="keep the scratch dir for inspection")
    args = ap.parse_args()

    base = args.workdir or tempfile.mkdtemp(prefix="pbox_chaos_")
    t0 = time.perf_counter()
    outcomes = []
    try:
        for run in (1, 2):  # same seed twice: outcome must be identical
            wd = os.path.join(base, f"run{run}")
            os.makedirs(wd, exist_ok=True)
            print(f"--- chaos run {run} (seed={args.seed}) ---")
            outcomes.append(run_scenario(wd, args.seed, args.device))
            print(json.dumps(outcomes[-1], indent=2, sort_keys=True))
        if outcomes[0] != outcomes[1]:
            print("FAIL: chaos outcome differs across identically-seeded "
                  "runs:")
            print(json.dumps(outcomes[0], sort_keys=True))
            print(json.dumps(outcomes[1], sort_keys=True))
            return 1
        print(f"PASS: recovered from all injected faults; outcome "
              f"deterministic across 2 runs (seed={args.seed}) on "
              f"{args.device} in {time.perf_counter() - t0:.1f}s")
        return 0
    finally:
        if not args.keep and args.workdir is None:
            shutil.rmtree(base, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
