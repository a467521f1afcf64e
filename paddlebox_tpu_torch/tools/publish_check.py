"""Deterministic publish/adopt gate for the artifact layer (the port's
counterpart of ``scripts/publish_check.py``).

A seeded WRITER (an ``EmbeddingTable`` publishing base+delta versions
through ``BoxPSHelper.publish_base/publish_delta`` → ``ArtifactStore``)
and a READER (``serving.ServingModel.adopt``) are driven through the
three failure scenarios the layer exists for:

1. **crash mid-publish** — ``artifact.publish:fail:exc=crash`` kills the
   writer after staging but before the atomic rename: the carcass is
   swept on the next store open and a fresh reader adopts the previous
   COMPLETE version, bit-identical to the oracle;
2. **corrupt delta** — one flipped byte in a published delta payload:
   adoption refuses the tip loudly (``ArtifactCorruptError``,
   ``pbox_artifact_refused_total``) and degrades to the newest
   verifiable version, again bit-identical;
3. **retention sweep vs held lease** — a reader holding a lease on an
   old version keeps it (and its lineage) alive through a
   ``retain(keep=2)`` sweep that would otherwise delete it; after
   release the sweep reclaims it and the reader's stale handle FENCES
   (``ArtifactLeaseLostError``) instead of serving swept files.

A tiered preamble also publishes a THREE-TIER table (host RAM + SSD
segments) and checks the artifact's spill-manifest REFERENCE digest
matches the tier's own manifest digest.

Every scenario ends with the reader on a complete, checksum-verified
version, and ``main()`` runs the whole thing twice with the same seed
asserting a byte-identical outcome — publish robustness is provable,
not hoped-for.

Usage::

    python -m paddlebox_tpu_torch.tools.publish_check [--seed 7]
        [--device cuda|cpu]

The writer tables and the readers live on the card unless
``--device cpu``.

Exit code 0 == all scenarios recovered + deterministic.
"""

from __future__ import annotations

import argparse
import glob
import hashlib
import json
import os
import shutil
import sys
import tempfile


def table_digest(t) -> str:
    """sha256 over an EmbeddingTable's logical rows, sorted by feasign
    (row-assignment order cancels out) — the reader-side bit-identity
    oracle."""
    import numpy as np
    with t.host_lock:
        keys, rows = t.index.items()
    order = np.argsort(keys)
    blob = t._gather_host(rows[order])
    h = hashlib.sha256()
    h.update(np.ascontiguousarray(keys[order]).tobytes())
    for f in sorted(blob):
        h.update(f.encode())
        h.update(np.ascontiguousarray(blob[f]).tobytes())
    return h.hexdigest()


def run_publish_check(workdir: str, seed: int = 7,
                      device: str = "cuda") -> dict:
    """One full writer/reader scenario on ``device``; returns the outcome
    summary (aid strings, digests, counters — no absolute paths, so two
    seeded runs compare byte-identical)."""
    import numpy as np
    import torch

    from paddlebox_tpu_torch.artifacts import (ArtifactCorruptError,
                                         ArtifactLeaseLostError,
                                         ArtifactStore)
    from paddlebox_tpu_torch.models import CtrDnn
    from paddlebox_tpu_torch.obs.hub import get_hub, reset_hub
    from paddlebox_tpu_torch.ps.box_helper import BoxPSHelper
    from paddlebox_tpu_torch.ps.sgd import SparseSGDConfig
    from paddlebox_tpu_torch.ps.table import FIELD_COL, EmbeddingTable
    from paddlebox_tpu_torch.resilience.faults import (FaultPlan, InjectedCrash,
                                                 installed)
    from paddlebox_tpu_torch.serving import ServingModel
    from paddlebox_tpu_torch.data.schema import DataFeedDesc

    reset_hub()
    root = os.path.join(workdir, "registry")
    cfg = SparseSGDConfig(mf_create_thresholds=1e9)
    desc = DataFeedDesc.criteo(batch_size=16)
    writer = EmbeddingTable(mf_dim=4, capacity=1 << 11, cfg=cfg,
                            device=device)
    helper = BoxPSHelper(writer)

    def write(lo: int, hi: int, scale: float) -> None:
        keys = np.arange(lo, hi, dtype=np.uint64)
        rows = writer.index.assign(keys)
        data = writer.state.data
        idx = torch.as_tensor(rows.astype(np.int64), device=data.device)
        data[idx, FIELD_COL["embed_w"]] = torch.as_tensor(
            keys.astype(np.float32) * scale, device=data.device)
        data[idx, FIELD_COL["show"]] = 1.0
        writer._touched[rows] = True

    def oracle_digest(aids, store) -> str:
        """Digest a fresh table would hold after replaying ``aids``'
        payloads in order — computed straight from the published files."""
        t = EmbeddingTable(mf_dim=4, capacity=1 << 11, cfg=cfg,
                           device=device)
        for i, aid in enumerate(aids):
            m = store.read_manifest(aid)
            name = ("sparse.npz" if m["kind"] == "base"
                    else "sparse_delta.npz")
            t.load(os.path.join(store.version_dir(aid), name),
                   merge=i > 0)
        return table_digest(t)

    def reader() -> "ServingModel":
        return ServingModel(CtrDnn(26, 3 + 4, 13, hidden=(4,)), desc,
                            mf_dim=4, capacity=1 << 11, device=device)

    out: dict = {}
    store = ArtifactStore(root)

    # ---- tiered preamble: a three-tier publisher's spill-manifest ref
    from paddlebox_tpu_torch.ps.table import FIELDS
    from paddlebox_tpu_torch.ps.tiered import TieredShardedEmbeddingTable
    tiered = TieredShardedEmbeddingTable(
        1, mf_dim=4, capacity_per_shard=1024, cfg=cfg, host_capacity=256,
        req_bucket_min=128, serve_bucket_min=128,
        ssd_dir=os.path.join(workdir, "tier"), devices=device)
    tkeys = np.arange(1, 401, dtype=np.uint64)
    for i in range(0, len(tkeys), 128):   # chunked past host capacity:
        ks = tkeys[i:i + 128]             # the emergency demoter spills
        vals = ks.astype(np.float32)      # the cold tail to segments
        tiered.hosts[0].update(ks, {
            f: (np.tile(vals[:, None], (1, 4)) * 0.01
                if f == "embedx_w" else vals * 0.001)
            for f in FIELDS})
    assert tiered.hosts[0].demote_cold(count=150) > 0
    tiered_store = ArtifactStore(os.path.join(workdir, "registry_tiered"))
    tiered_helper = BoxPSHelper(tiered)
    tier_digest0 = tiered.rows_digest()   # writer-side oracle
    taid = tiered_helper.publish_base(tiered_store)
    # staged publish must be content-inert on the writer (only the
    # delta bookkeeping clears, and only after the commit)
    assert tiered.rows_digest() == tier_digest0, (
        "publish mutated the writer's tier content")
    tman = tiered_store.read_manifest(taid)
    spill_ref = tman["refs"].get("spill_manifest") or {}
    tier_manifest = tiered.spill_manifest()
    assert spill_ref.get("digest") == tier_manifest["digest"], (
        "artifact spill-manifest reference does not name the tier state")
    tsrv = reader()
    assert tsrv.adopt(tiered_store) == taid
    tvals = tsrv.embed_lookup(np.array([1, 200, 400], np.uint64))
    assert np.allclose(tvals[:, 2],
                       np.array([1, 200, 400], np.float32) * 0.001), (
        "tiered publish lost spilled rows")  # demoted rows merged back
    tsrv.release()
    out["tiered"] = {"aid": taid, "spill_digest": spill_ref["digest"],
                     "rows": int(len(tkeys))}

    # ---- publish a clean base + delta chain
    write(1, 201, 2.0)
    v1 = helper.publish_base(store)
    write(150, 261, 3.0)
    v2 = helper.publish_delta(store)
    d2 = oracle_digest([v1, v2], store)
    srv = reader()
    assert srv.adopt(store) == v2
    assert table_digest(srv.table) == d2, "clean adoption not bit-exact"
    srv.release()

    # ---- scenario 1: crash mid-publish (after staging, pre-rename)
    write(240, 301, 5.0)
    crashed = False
    with installed(FaultPlan.parse(
            "artifact.publish:fail:nth=1,exc=crash", seed=seed)) as p1:
        try:
            helper.publish_delta(store)
        except InjectedCrash:
            crashed = True
    assert crashed, "crash-mid-publish fault never fired"
    assert store.versions() == [v1, v2], "half-publish leaked a version"
    carcasses = glob.glob(os.path.join(root, ".stage-*"))
    assert carcasses, "crash left no stage carcass to sweep"
    # while the writer pid is (apparently) alive, even a zero-TTL open
    # must NOT touch the stage — a slow live publisher is not a carcass
    ArtifactStore(root, lease_ttl_sec=0.0)
    assert glob.glob(os.path.join(root, ".stage-*")), (
        "sweep took a live writer's stage")
    # now make the writer PROVABLY dead (marker naming a dead same-host
    # pid, the in-process stand-in for a publisher killed by SIGKILL):
    # the next open sweeps it
    import socket
    import subprocess
    proc = subprocess.Popen(["true"])
    proc.wait()
    dead_pid = proc.pid
    for c in carcasses:
        with open(os.path.join(c, "stage.json"), "w") as fh:
            json.dump({"pid": dead_pid, "host": socket.gethostname()},
                      fh)
    store = ArtifactStore(root)
    assert not glob.glob(os.path.join(root, ".stage-*")), (
        "carcass survived the sweep")
    srv = reader()
    crash_aid = srv.adopt(store)
    crash_ok = crash_aid == v2 and table_digest(srv.table) == d2
    assert crash_ok, "reader not on the previous complete version"
    srv.release()

    # ---- scenario 2: flipped byte in a published delta
    v3 = helper.publish_delta(store)   # the same rows, for real now
    d3 = oracle_digest([v1, v2, v3], store)
    p = os.path.join(store.version_dir(v3), "sparse_delta.npz")
    with open(p, "rb") as fh:
        blob = fh.read()
    flip = 11 % len(blob)
    with open(p, "wb") as fh:
        fh.write(blob[:flip] + bytes([blob[flip] ^ 0xFF])
                 + blob[flip + 1:])
    loud = False
    try:
        reader().adopt(store, v3)      # explicit version: refuse, never
    except ArtifactCorruptError:       # silently degrade
        loud = True
    assert loud, "corrupt delta adopted silently"
    srv = reader()
    corrupt_fallback = srv.adopt(store)   # unpinned: degrade gracefully
    assert corrupt_fallback == v2
    assert table_digest(srv.table) == d2, (
        "degraded adoption not bit-exact")
    srv.release()
    with open(p, "wb") as fh:          # repair: the chain verifies again
        fh.write(blob)
    srv = reader()
    assert srv.adopt(store) == v3
    repaired_ok = table_digest(srv.table) == d3
    assert repaired_ok
    srv.release()
    # writer-side completeness: the chain replay reproduces the
    # writer's OWN table bit-for-bit — in particular, the CRASHED v3
    # publish attempt (which staged with clear_touched=False) lost no
    # delta rows: the successful v3 still carried every one of them
    assert table_digest(writer) == d3, (
        "published chain diverges from the writer table — a failed "
        "publish dropped delta rows")

    # ---- scenario 3: retention sweep concurrent with a held lease
    holder = reader()
    assert holder.adopt(store, v3) == v3      # lease held on v3
    write(300, 361, 7.0)
    v4 = helper.publish_base(store)
    write(350, 401, 9.0)
    v5 = helper.publish_delta(store)
    removed_while_leased = store.retain(keep=2)
    assert removed_while_leased == [], (
        "retention swept a leased/lineage version")
    for aid in (v1, v2, v3):
        assert os.path.isfile(os.path.join(store.version_dir(aid),
                                           "MANIFEST.json")), aid
    # the leased reader still reads bit-verified payloads mid-sweep
    stale_handle = holder._handle
    stale_handle.read("sparse_delta.npz")
    holder.release()
    removed_after_release = store.retain(keep=2)
    assert removed_after_release == [v1, v2, v3], removed_after_release
    fenced = False
    try:
        stale_handle.path("sparse_delta.npz")    # stale handle FENCES
    except ArtifactLeaseLostError:
        fenced = True
    assert fenced, "stale handle served from swept files"
    srv = reader()
    final_aid = srv.adopt(store)
    assert final_aid == v5
    final_digest = table_digest(srv.table)
    assert final_digest == oracle_digest([v4, v5], store)
    srv.release()

    hub = get_hub()
    out.update({
        "ok": True,
        "chain": [v1, v2, v3, v4, v5],
        "digest_v2": d2, "digest_v3": d3, "digest_final": final_digest,
        "crash_fault": p1.stats(),
        "crash_reader_aid": crash_aid,
        "corrupt_fallback_aid": corrupt_fallback,
        "removed_while_leased": removed_while_leased,
        "removed_after_release": removed_after_release,
        "final_aid": final_aid,
        "counters": {
            "published": hub.counter(
                "pbox_artifact_published_total").value(kind="base")
            + hub.counter(
                "pbox_artifact_published_total").value(kind="delta"),
            "refused_corrupt": hub.counter(
                "pbox_artifact_refused_total").value(reason="corrupt"),
        },
    })
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--device", default="cuda",
                    help="where the tables and readers live (cuda or cpu)")
    ap.add_argument("--workdir", default=None,
                    help="scratch dir (default: a fresh temp dir)")
    ap.add_argument("--keep", action="store_true",
                    help="keep the scratch dir for inspection")
    args = ap.parse_args()

    base = args.workdir or tempfile.mkdtemp(prefix="pbox_publish_")
    outcomes = []
    try:
        for run in (1, 2):  # same seed twice: outcome must be identical
            wd = os.path.join(base, f"run{run}")
            os.makedirs(wd, exist_ok=True)
            print(f"--- publish run {run} (seed={args.seed}) ---")
            outcomes.append(run_publish_check(wd, args.seed, args.device))
            print(json.dumps(outcomes[-1], indent=2, sort_keys=True))
        if outcomes[0] != outcomes[1]:
            print("FAIL: publish outcome differs across identically-"
                  "seeded runs")
            return 1
        print(f"PASS: crash-mid-publish, corrupt delta and "
              f"retention-vs-lease all left the reader on a complete "
              f"bit-verified version; deterministic across 2 runs "
              f"(seed={args.seed})")
        return 0
    finally:
        if not args.keep and args.workdir is None:
            shutil.rmtree(base, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
