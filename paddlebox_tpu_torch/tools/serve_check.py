"""Serve-while-training gate (the port's counterpart of
``scripts/serve_check.py``): p99 latency, snapshot staleness and
bit-consistency while a training loop publishes, and through injected
faults.

Four legs, one seeded scenario (``run_serve_check``):

1. **stream-serve** — a ``Trainer.train_stream`` loop (windowed
   QueueDataset, one boundary checkpoint per window) publishes a base
   + ≥3 deltas into an ``ArtifactStore`` while a concurrent serving
   thread (``ServingModel`` + background ``ReloadLoop``) sustains
   lookup/predict queries. Asserted THROUGHOUT the run:

   - every served result is bit-consistent with EXACTLY ONE published
     version (each query pins one snapshot; its lookup digest must
     equal that version's replay oracle — no torn reads across swaps);
   - query p99 latency and snapshot staleness are measured on the
     host's clock and reported beside the outcome (``timings``);
     ``main()`` holds them to ``SERVE_CHECK_P99_MS`` (default 500 ms)
     and ``SERVE_CHECK_STALENESS_SEC`` (default 30 s), the outcome
     itself holds nothing timing-valued;
   - ``/readyz`` refuses before the first adoption and passes after.

2. **tiered publisher** — a three-tier (host RAM + SSD segments)
   table publishes base+deltas with spill-manifest refs; the serving
   snapshots must carry the SSD-spilled rows bit-exactly through two
   hot-reload swaps under concurrent readers.

3. **chaos: flipped-byte delta mid-hot-reload** — the reload poll
   refuses the corrupt tip, serving CONTINUES on the prior snapshot
   (queries stay consistent, ``pbox_serving_reload_degraded_total``
   books, staleness gauge rises), and recovers when the tip is
   repaired.

4. **chaos: trainer SIGKILL mid-publish** — a real subprocess
   publisher is SIGKILLed between staging and the atomic rename;
   serving is unaffected (still answering from the last complete
   version), the carcass sweeps, and the next complete publish is
   adopted.

``main()`` runs the whole scenario twice with the same seed and
asserts a byte-identical outcome — serving robustness is provable, not
hoped-for.

Usage::

    python -m paddlebox_tpu_torch.tools.serve_check [--seed 7]
        [--device cuda|cpu]

The trainer, the tables and the servers run on the card unless
``--device cpu``.

Exit code 0 == all bounds held + deterministic.
"""

from __future__ import annotations

import argparse
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
from typing import Optional

#: the checkout's root (the publisher subprocess imports the package
#: from it)
REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

#: generous SLO bounds on the host's clock (env-overridable), held by
#: ``main()`` only
P99_BOUND_MS = float(os.environ.get("SERVE_CHECK_P99_MS", "500"))
STALENESS_BOUND_SEC = float(
    os.environ.get("SERVE_CHECK_STALENESS_SEC", "30"))


def _digest(arr) -> str:
    import numpy as np
    return hashlib.sha256(
        np.ascontiguousarray(arr).tobytes()).hexdigest()[:24]


class QueryWorker(threading.Thread):
    """Sustained serving traffic: each query pins ONE snapshot (the
    fence), reads off it, and records (version, lookup digest, predict
    digest, latency, staleness). Runs until stopped; any exception is
    captured — a reload must never break the query path."""

    def __init__(self, srv, probe, batch=None) -> None:
        super().__init__(daemon=True, name="serve-query")
        self.srv = srv
        self.probe = probe
        self.batch = batch
        self.records = []          # (aid, lookup_digest)
        self.pred_digests = set()  # predict digests seen
        self.latencies = []
        self.max_staleness = 0.0
        self.exc = None
        self._halt = threading.Event()

    def run(self) -> None:
        try:
            while not self._halt.is_set():
                t0 = time.perf_counter()
                snap = self.srv.snapshot()     # THE fence
                out = snap.lookup(self.probe)
                self.latencies.append(time.perf_counter() - t0)
                self.records.append((snap.aid, _digest(out)))
                if self.batch is not None and snap.model is not None:
                    pred = self.srv._predict_on(snap, self.batch,
                                                return_valid=False)
                    self.pred_digests.add(_digest(pred))
                st = self.srv.serving_status()
                self.max_staleness = max(self.max_staleness,
                                         st["staleness_sec"])
                time.sleep(0.002)
        except BaseException as e:   # noqa: BLE001 — reported by leg
            self.exc = e

    def stop(self) -> None:
        self._halt.set()
        self.join(timeout=60)
        if self.exc is not None:
            raise AssertionError(
                f"query worker died (the query path must survive "
                f"reloads): {self.exc!r}") from self.exc

    def p99_ms(self) -> float:
        lat = sorted(self.latencies)
        if not lat:
            return 0.0
        return lat[int(0.99 * (len(lat) - 1))] * 1e3


def _srv(desc, device, capacity=1 << 13):
    from paddlebox_tpu_torch.models import CtrDnn
    from paddlebox_tpu_torch.serving import ServingModel
    return ServingModel(CtrDnn(26, 3 + 4, 13, hidden=(8,)), desc, mf_dim=4,
                        capacity=capacity, device=device)


def _oracles(store, desc, probe, device, batch=None, capacity=1 << 13):
    """Per-version replay oracles: a FRESH consumer adopts each
    adoptable version and digests the same probe lookup (and predict)
    the query workers ran — the bit-consistency reference."""
    lookups, preds = {}, {}
    for aid in store.versions():
        if not store.read_manifest(aid,
                                   verify=False).get("adoptable", True):
            continue
        srv = _srv(desc, device, capacity)
        srv.adopt(store, aid)
        snap = srv.snapshot()
        lookups[aid] = _digest(snap.lookup(probe))
        if batch is not None and snap.model is not None:
            preds[aid] = _digest(srv._predict_on(snap, batch,
                                                 return_valid=False))
        srv.release()
    return lookups, preds


def _run_stream_leg(workdir: str, seed: int, device: str,
                    timings: dict) -> dict:
    """Leg 1: train_stream publishes boundary versions while serving
    queries run; bit-consistency asserted over the whole overlap window,
    the query p99 and the staleness booked into ``timings``."""
    import numpy as np
    import torch

    from paddlebox_tpu_torch.artifacts import ArtifactStore
    from paddlebox_tpu_torch.config import flags_scope
    from paddlebox_tpu_torch.data import DataFeedDesc, DatasetFactory
    from paddlebox_tpu_torch.data.criteo import generate_criteo_files
    from paddlebox_tpu_torch.models import CtrDnn
    from paddlebox_tpu_torch.obs.hub import get_hub
    from paddlebox_tpu_torch.ps.sgd import SparseSGDConfig
    from paddlebox_tpu_torch.ps.table import EmbeddingTable
    from paddlebox_tpu_torch.serving import ReloadLoop
    from paddlebox_tpu_torch.train.trainer import Trainer
    from paddlebox_tpu_torch.train.checkpoint import CheckpointManager

    hub = get_hub()
    files = generate_criteo_files(os.path.join(workdir, "data"),
                                  num_files=5, rows_per_file=120,
                                  vocab_per_slot=40, seed=seed)
    desc = DataFeedDesc.criteo(batch_size=32)
    desc.key_bucket_min = 2048
    cfg = SparseSGDConfig(mf_create_thresholds=0.0, mf_initial_range=0.0)
    store = ArtifactStore(os.path.join(workdir, "registry"))

    # a fixed probe batch for predict consistency (one real batch off
    # the first file — NOT consumed by the stream's own dataset), and
    # REAL probe keys from it (their rows train every window, so each
    # published version answers a DIFFERENT lookup digest — the
    # consistency check cannot pass vacuously on all-zero misses)
    pds = DatasetFactory().create_dataset("InMemoryDataset", desc)
    pds.set_filelist(files[:1])
    pds.load_into_memory()
    probe_batch = next(pds.batches())
    probe = np.unique(probe_batch.keys[:probe_batch.num_keys])[:256]
    probe = np.concatenate(
        [probe, np.array([0xDEAD_BEEF_0001], np.uint64)])  # one miss

    with flags_scope(seed=seed, stream_window_files=1,
                     stream_ckpt_every_windows=1, read_thread_num=1,
                     retry_base_delay_sec=0.01,
                     retry_max_delay_sec=0.05,
                     serving_reload_poll_sec=0.02):
        table = EmbeddingTable(mf_dim=4, capacity=1 << 13, cfg=cfg,
                               unique_bucket_min=2048, device=device)
        torch.manual_seed(seed)
        trainer = Trainer(CtrDnn(26, 3 + 4, 13, hidden=(8,)), table, desc,
                          tx=lambda p: torch.optim.Adam(p, lr=1e-2),
                          seed=seed, device=device)
        cm = CheckpointManager(os.path.join(workdir, "ckpt"),
                               artifacts=store)
        ds = DatasetFactory().create_dataset("QueueDataset", desc)
        ds.set_filelist(files)

        srv = _srv(desc, device)
        srv.register_health()
        ready_before = hub.readiness()["ready"]

        writer_exc = []

        def train() -> None:
            try:
                trainer.train_stream(ds, cm)
            except BaseException as e:   # noqa: BLE001
                writer_exc.append(e)

        writer = threading.Thread(target=train, daemon=True,
                                  name="serve-writer")
        writer.start()
        # serving comes up as soon as the FIRST boundary publishes
        deadline = time.time() + 120
        while not store.versions() and time.time() < deadline:
            time.sleep(0.01)
        assert store.versions(), "writer never published a version"
        srv.adopt(store)
        ready_after = hub.readiness()["ready"]
        loop = ReloadLoop(srv, store).start()
        worker = QueryWorker(srv, probe, batch=probe_batch)
        worker.start()
        writer.join(timeout=300)
        assert not writer.is_alive(), "train_stream never finished"
        if writer_exc:
            raise writer_exc[0]
        # let the loop catch the final publish, then stop cleanly
        deadline = time.time() + 30
        while srv.adopted_aid != store.latest() \
                and time.time() < deadline:
            time.sleep(0.02)
        worker.stop()
        loop.stop()

    versions = store.versions()
    kinds = [store.read_manifest(a, verify=False)["kind"]
             for a in versions]
    assert kinds.count("base") >= 1 and kinds.count("delta") >= 3, (
        f"stream published {kinds} — want 1 base + >=3 deltas")
    lookup_oracle, pred_oracle = _oracles(store, desc, probe, device,
                                          batch=probe_batch)
    served_versions = sorted({aid for aid, _ in worker.records})
    consistent = all(lookup_oracle.get(aid) == d
                     for aid, d in worker.records)
    assert consistent, (
        "a served lookup did not match its pinned version's oracle — "
        "torn read across a snapshot swap")
    preds_ok = worker.pred_digests <= set(pred_oracle.values())
    assert preds_ok, (
        f"served predictions {worker.pred_digests} outside the "
        f"published versions' oracles")
    timings.update(stream_p99_ms=worker.p99_ms(),
                   stream_max_staleness_sec=worker.max_staleness,
                   stream_queries=len(worker.records))
    assert srv.adopted_aid == versions[-1], (
        srv.adopted_aid, versions[-1])
    assert not ready_before and ready_after, (
        "/readyz must refuse before the first adoption and pass after")
    srv.release()
    return {
        "stream_versions": versions,
        "stream_kinds": kinds,
        "stream_lookup_oracle": lookup_oracle,
        "stream_pred_oracle": sorted(pred_oracle.values()),
        "stream_served_all_consistent": bool(consistent),
        "stream_preds_consistent": bool(preds_ok),
        "stream_served_multiple_versions": len(served_versions) >= 1,
        "stream_final_aid": srv.adopted_aid,
        "readyz_transition": [ready_before, ready_after],
    }


def _run_tiered_leg(workdir: str, seed: int, device: str) -> dict:
    """Leg 2: three-tier (RAM+SSD) publisher → serving snapshots carry
    the spilled rows bit-exactly across hot-reload swaps under
    concurrent readers."""
    import numpy as np

    from paddlebox_tpu_torch.artifacts import ArtifactStore
    from paddlebox_tpu_torch.data.schema import DataFeedDesc
    from paddlebox_tpu_torch.ps.box_helper import BoxPSHelper
    from paddlebox_tpu_torch.ps.sgd import SparseSGDConfig
    from paddlebox_tpu_torch.ps.table import FIELDS
    from paddlebox_tpu_torch.ps.tiered import TieredShardedEmbeddingTable
    from paddlebox_tpu_torch.serving import ReloadLoop

    desc = DataFeedDesc.criteo(batch_size=16)
    cfg = SparseSGDConfig(mf_create_thresholds=1e9)
    tiered = TieredShardedEmbeddingTable(
        1, mf_dim=4, capacity_per_shard=1024, cfg=cfg,
        host_capacity=256, req_bucket_min=128, serve_bucket_min=128,
        ssd_dir=os.path.join(workdir, "tier"), devices=device)

    def fill(lo: int, hi: int, scale: float) -> None:
        ks = np.arange(lo, hi, dtype=np.uint64)
        for i in range(0, len(ks), 128):
            chunk = ks[i:i + 128]
            vals = chunk.astype(np.float32)
            tiered.hosts[0].update(chunk, {
                f: (np.tile(vals[:, None], (1, 4)) * 0.01 * scale
                    if f == "embedx_w" else vals * 0.001 * scale)
                for f in FIELDS})

    fill(1, 401, 1.0)
    assert tiered.hosts[0].demote_cold(count=150) > 0
    store = ArtifactStore(os.path.join(workdir, "registry_tiered"))
    helper = BoxPSHelper(tiered)
    v1 = helper.publish_base(store)
    spill_ref = store.read_manifest(v1)["refs"]["spill_manifest"]
    assert spill_ref["digest"], "no spill-manifest ref on the publish"

    probe = np.array([1, 155, 200, 400, 999999], np.uint64)
    srv = _srv(desc, device, capacity=1 << 11)
    assert srv.adopt(store) == v1
    got = srv.embed_lookup(probe)
    want = np.array([1, 155, 200, 400], np.float32) * 0.001
    assert np.allclose(got[:4, 2], want), (
        "snapshot lost SSD-spilled rows")
    assert not got[4].any(), "unknown key must read zeros"

    loop = ReloadLoop(srv, store, poll_sec=0.02)
    worker = QueryWorker(srv, probe)
    worker.start()
    fill(300, 451, 3.0)
    v2 = helper.publish_delta(store)
    deadline = time.time() + 30
    while srv.adopted_aid != v2 and time.time() < deadline:
        loop.poll_once()
        time.sleep(0.01)
    fill(420, 481, 7.0)
    v3 = helper.publish_delta(store)
    deadline = time.time() + 30
    while srv.adopted_aid != v3 and time.time() < deadline:
        loop.poll_once()
        time.sleep(0.01)
    worker.stop()
    assert srv.adopted_aid == v3
    lookup_oracle, _ = _oracles(store, desc, probe, device,
                                capacity=1 << 11)
    consistent = all(lookup_oracle.get(aid) == d
                     for aid, d in worker.records)
    assert consistent, "tiered serving saw a torn/foreign state"
    served = sorted({aid for aid, _ in worker.records})
    assert len(served) >= 2, (
        f"readers never spanned a swap (saw {served}) — widen the "
        "publish window")
    # writer-side completeness: the adopted chain reproduces the
    # writer's OWN full model (SSD-spilled rows included) bit-for-bit,
    # compared through the same single-table fingerprint (a fresh
    # save_base dump of the tier loaded into a plain table)
    replay = _srv(desc, device, capacity=1 << 11)
    replay.adopt(store)
    dump = os.path.join(workdir, "tier_oracle.npz")
    tiered.save_base(dump, clear_touched=False)
    from paddlebox_tpu_torch.ps.table import EmbeddingTable
    oracle_t = EmbeddingTable(mf_dim=4, capacity=1 << 11, cfg=cfg,
                              device=device)
    oracle_t.load(dump)
    writer_digest = oracle_t.rows_digest()
    replay_digest = replay.table.rows_digest()
    assert writer_digest == replay_digest, (
        "adopted tiered chain diverges from the writer's full model — "
        "spilled rows lost or mutated")
    replay.release()
    srv.release()
    srv.release()   # double-release is a no-op
    return {
        "tiered_chain": [v1, v2, v3],
        "tiered_spill_digest": spill_ref["digest"],
        "tiered_consistent": bool(consistent),
        "tiered_swaps_observed": len(served) >= 2,
        "tiered_writer_digest": writer_digest,
        "tiered_replay_digest": replay_digest,
        "tiered_oracle": lookup_oracle,
    }


def _run_corrupt_tip_leg(workdir: str, seed: int, device: str) -> dict:
    """Leg 3: flipped-byte delta mid-hot-reload — degrade loudly, keep
    serving the prior snapshot under live queries, recover on repair."""
    import numpy as np
    import torch

    from paddlebox_tpu_torch.artifacts import ArtifactStore
    from paddlebox_tpu_torch.data.schema import DataFeedDesc
    from paddlebox_tpu_torch.obs.hub import get_hub
    from paddlebox_tpu_torch.ps.box_helper import BoxPSHelper
    from paddlebox_tpu_torch.ps.sgd import SparseSGDConfig
    from paddlebox_tpu_torch.ps.table import FIELD_COL, EmbeddingTable
    from paddlebox_tpu_torch.serving import ReloadLoop

    desc = DataFeedDesc.criteo(batch_size=16)
    cfg = SparseSGDConfig(mf_create_thresholds=1e9)
    t = EmbeddingTable(mf_dim=4, capacity=1 << 10, cfg=cfg, device=device)
    helper = BoxPSHelper(t)
    store = ArtifactStore(os.path.join(workdir, "registry_chaos"))

    def write(lo, hi, scale) -> None:
        keys = np.arange(lo, hi, dtype=np.uint64)
        rows = t.index.assign(keys)
        data = t.state.data
        idx = torch.as_tensor(rows.astype(np.int64), device=data.device)
        data[idx, FIELD_COL["embed_w"]] = torch.as_tensor(
            keys.astype(np.float32) * scale, device=data.device)
        t._touched[rows] = True

    write(1, 101, 2.0)
    v1 = helper.publish_base(store)
    probe = np.arange(1, 101, dtype=np.uint64)
    srv = _srv(desc, device, capacity=1 << 10)
    assert srv.adopt(store) == v1
    loop = ReloadLoop(srv, store, poll_sec=0.02)
    worker = QueryWorker(srv, probe)
    worker.start()

    hub = get_hub()
    refused0 = hub.counter("pbox_artifact_refused_total").value(
        reason="corrupt")
    write(50, 151, 5.0)
    v2 = helper.publish_delta(store)
    p = os.path.join(store.version_dir(v2), "sparse_delta.npz")
    with open(p, "rb") as fh:
        blob = fh.read()
    flip = 13 % len(blob)
    with open(p, "wb") as fh:
        fh.write(blob[:flip] + bytes([blob[flip] ^ 0xFF])
                 + blob[flip + 1:])
    degraded0 = loop.degraded
    for _ in range(3):     # corrupt tip: every poll degrades loudly
        assert loop.poll_once() is None
        time.sleep(0.01)
    assert srv.adopted_aid == v1, "corrupt tip must not swap in"
    assert loop.degraded > degraded0, "degrade was silent"
    assert hub.counter("pbox_artifact_refused_total").value(
        reason="corrupt") > refused0, "refusal was silent"
    staleness_mid = srv.serving_status()["staleness_sec"]
    assert staleness_mid > 0.0, "staleness gauge stayed zero"
    with open(p, "wb") as fh:     # repair the tip
        fh.write(blob)
    deadline = time.time() + 30
    while srv.adopted_aid != v2 and time.time() < deadline:
        loop.poll_once()
        time.sleep(0.01)
    worker.stop()
    assert srv.adopted_aid == v2, "repaired tip never adopted"
    assert srv.serving_status()["staleness_sec"] == 0.0
    lookup_oracle, _ = _oracles(store, desc, probe, device,
                                capacity=1 << 10)
    consistent = all(lookup_oracle.get(aid) == d
                     for aid, d in worker.records)
    assert consistent, "queries tore during the degrade window"
    # queries DURING the corrupt window all answered v1
    assert any(aid == v1 for aid, _ in worker.records)
    srv.release()
    return {
        "corrupt_chain": [v1, v2],
        "corrupt_degraded_loud": True,
        "corrupt_served_prior": True,
        "corrupt_recovered": srv.adopted_aid == v2,
        "corrupt_consistent": bool(consistent),
        "corrupt_oracle": lookup_oracle,
    }


_PUBLISHER = r"""
import os, sys, time
sys.path.insert(0, {repo!r})
import numpy as np
import torch
from paddlebox_tpu_torch.artifacts import ArtifactStore
from paddlebox_tpu_torch.ps.sgd import SparseSGDConfig
from paddlebox_tpu_torch.ps.table import FIELD_COL, EmbeddingTable

root, device = sys.argv[1], sys.argv[2]
store = ArtifactStore(root)
cfg = SparseSGDConfig(mf_create_thresholds=1e9)
t = EmbeddingTable(mf_dim=4, capacity=1 << 10, cfg=cfg, device=device)
keys = np.arange(1, 201, dtype=np.uint64)
rows = t.index.assign(keys)
idx = torch.as_tensor(rows.astype(np.int64), device=t.state.data.device)
t.state.data[idx, FIELD_COL["embed_w"]] = torch.as_tensor(
    keys.astype(np.float32) * 2.0, device=t.state.data.device)
t.state.data[idx, FIELD_COL["show"]] = 1.0
t._touched[rows] = True
aid = store.publish({{"sparse.npz": lambda p: t.save_base(p)}},
                    kind="base", meta={{"step": 1}})
with open(os.path.join(root, "base_aid.txt"), "w") as fh:
    fh.write(aid)

# second publish: stage the payload, signal the parent, then HANG
# inside the writer — the parent SIGKILLs us mid-publish (the trainer
# dying between staging and the atomic rename)
def hang_writer(p):
    t._touched[rows] = True
    t.save_delta(p)
    with open(os.path.join(root, "STAGED"), "w") as fh:
        fh.write("1")
    time.sleep(600)

store.publish({{"sparse_delta.npz": hang_writer}}, kind="delta",
              parent=aid)
"""


def _run_sigkill_leg(workdir: str, seed: int, device: str) -> dict:
    """Leg 4: REAL SIGKILL mid-publish — serving is unaffected, the
    carcass sweeps, the next complete version adopts."""
    import glob

    import numpy as np

    from paddlebox_tpu_torch.artifacts import ArtifactStore
    from paddlebox_tpu_torch.data.schema import DataFeedDesc
    from paddlebox_tpu_torch.serving import ReloadLoop

    desc = DataFeedDesc.criteo(batch_size=16)
    root = os.path.join(workdir, "registry_kill")
    os.makedirs(root, exist_ok=True)
    proc = subprocess.Popen(
        [sys.executable, "-c", _PUBLISHER.format(repo=REPO), root,
         device])
    deadline = time.time() + 120
    base_aid = None
    while time.time() < deadline:
        p = os.path.join(root, "base_aid.txt")
        if os.path.isfile(p):
            with open(p) as fh:
                base_aid = fh.read().strip()
            break
        time.sleep(0.05)
    assert base_aid, "publisher subprocess never published its base"

    store = ArtifactStore(root)
    probe = np.arange(1, 201, dtype=np.uint64)
    srv = _srv(desc, device, capacity=1 << 10)
    assert srv.adopt(store) == base_aid
    loop = ReloadLoop(srv, store, poll_sec=0.02)
    worker = QueryWorker(srv, probe)
    worker.start()

    deadline = time.time() + 120
    while not os.path.isfile(os.path.join(root, "STAGED")) \
            and time.time() < deadline:
        time.sleep(0.02)
    assert os.path.isfile(os.path.join(root, "STAGED")), \
        "publisher never staged its delta"
    os.kill(proc.pid, signal.SIGKILL)     # the trainer dies mid-publish
    proc.wait()
    for _ in range(5):                    # serving shrugs it off
        loop.poll_once()
        time.sleep(0.01)
    assert srv.adopted_aid == base_aid
    assert store.versions() == [base_aid], (
        "half-publish leaked a version")
    carcass = bool(glob.glob(os.path.join(root, ".stage-*")))
    assert carcass, "SIGKILL left no stage carcass"
    # a fresh store open proves the writer dead and sweeps the carcass
    store2 = ArtifactStore(root)
    assert not glob.glob(os.path.join(root, ".stage-*")), (
        "carcass survived the sweep")
    # the next COMPLETE publish adopts normally
    payload = os.path.join(root, "versions", base_aid, "sparse.npz")
    v2 = store2.publish({"sparse_delta.npz": payload}, kind="delta",
                        parent=base_aid, meta={"step": 2})
    deadline = time.time() + 30
    while srv.adopted_aid != v2 and time.time() < deadline:
        loop.poll_once()
        time.sleep(0.01)
    worker.stop()
    assert srv.adopted_aid == v2, "next complete version never adopted"
    lookup_oracle, _ = _oracles(store2, desc, probe, device,
                                capacity=1 << 10)
    consistent = all(lookup_oracle.get(aid) == d
                     for aid, d in worker.records)
    assert consistent, "queries tore across the SIGKILL window"
    srv.release()
    return {
        "kill_base": base_aid,
        "kill_carcass_swept": True,
        "kill_serving_unaffected": True,
        "kill_next_adopted": v2,
        "kill_consistent": bool(consistent),
        "kill_oracle": lookup_oracle,
    }


def run_serve_check(workdir: str, seed: int = 7, device: str = "cuda",
                    timings: Optional[dict] = None) -> dict:
    """One full scenario on ``device``; returns the outcome summary
    (aids, digests, booleans — nothing timing-valued, so two seeded runs
    compare byte-identical). The host-clock numbers (query p99, the
    largest staleness) go into ``timings`` when given."""
    from paddlebox_tpu_torch.obs.hub import get_hub, reset_hub
    from paddlebox_tpu_torch.obs.sinks import MemorySink

    reset_hub()
    hub = get_hub()
    hub.add_sink(MemorySink())   # hub.active: serving telemetry live
    out: dict = {}
    out.update(_run_stream_leg(workdir, seed, device,
                               {} if timings is None else timings))
    out.update(_run_tiered_leg(workdir, seed, device))
    out.update(_run_corrupt_tip_leg(workdir, seed, device))
    out.update(_run_sigkill_leg(workdir, seed, device))
    # the serving counters booked (values vary with poll timing — the
    # outcome records only their non-zero-ness)
    out["reload_adopted_nonzero"] = hub.counter(
        "pbox_serving_reload_adopted_total").series() != []
    out["reload_degraded_nonzero"] = hub.counter(
        "pbox_serving_reload_degraded_total").value() > 0
    reset_hub()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--device", default="cuda",
                    help="where the trainer, tables and servers run "
                         "(cuda or cpu)")
    ap.add_argument("--workdir", default=None,
                    help="scratch dir (default: a fresh temp dir)")
    ap.add_argument("--keep", action="store_true",
                    help="keep the scratch dir for inspection")
    args = ap.parse_args()

    base = args.workdir or tempfile.mkdtemp(prefix="pbox_serve_")
    outcomes, timings = [], []
    try:
        for run in (1, 2):  # same seed twice: outcome must be identical
            wd = os.path.join(base, f"run{run}")
            os.makedirs(wd, exist_ok=True)
            print(f"--- serve run {run} (seed={args.seed}) ---")
            t = {}
            outcomes.append(run_serve_check(wd, args.seed, args.device, t))
            print(json.dumps(outcomes[-1], indent=2, sort_keys=True))
            print(json.dumps({"timings": t}, sort_keys=True))
            timings.append(t)
        if outcomes[0] != outcomes[1]:
            print("FAIL: serve outcome differs across identically-"
                  "seeded runs")
            return 1
        for t in timings:
            if t["stream_p99_ms"] > P99_BOUND_MS:
                print(f"FAIL: serving p99 {t['stream_p99_ms']:.1f}ms broke "
                      f"the {P99_BOUND_MS}ms bound while training "
                      "published")
                return 1
            if t["stream_max_staleness_sec"] > STALENESS_BOUND_SEC:
                print(f"FAIL: snapshot staleness "
                      f"{t['stream_max_staleness_sec']:.1f}s broke the "
                      f"{STALENESS_BOUND_SEC}s bound")
                return 1
        print("PASS: p99/staleness bounds held while training "
              "published; every served result bit-consistent with "
              "exactly one version; corrupt-tip and SIGKILL chaos legs "
              f"recovered; deterministic across 2 runs "
              f"(seed={args.seed})")
        return 0
    finally:
        if not args.keep and args.workdir is None:
            shutil.rmtree(base, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
