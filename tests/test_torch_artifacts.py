"""The port's artifact store (``paddlebox_tpu_torch/artifacts.py``): the
cases of ``tests/test_artifacts.py`` on the port's store — crash-safe
versioned publish, checksum-chain adoption, lease-fenced readers,
provably-stale reaping, lineage-aware retention and a publisher killed
by a real SIGKILL mid-publish — and the store held against the JAX
package's in both directions: a store either package published opens,
verifies and loads under the other."""

import hashlib
import json
import os
import signal
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

from paddlebox_tpu.artifacts import ArtifactStore as JStore
from paddlebox_tpu.ps import EmbeddingTable as JTable
from paddlebox_tpu.ps import SparseSGDConfig as JCfg

from paddlebox_tpu_torch import DeepFM, EmbeddingTable, ServingModel
from paddlebox_tpu_torch.artifacts import (MANIFEST, ArtifactCorruptError,
                                           ArtifactLeaseLostError,
                                           ArtifactLineageError,
                                           ArtifactStore, LeaseRegistry)
from paddlebox_tpu_torch.data import DataFeedDesc, SlotDef
from paddlebox_tpu_torch.ps.sgd import SparseSGDConfig
from paddlebox_tpu_torch.ps.table import FIELD_COL, TableState
from paddlebox_tpu_torch.resilience.faults import (FaultPlan, InjectedCrash,
                                                   installed)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MF, CAP = 4, 1 << 10


def _dead_pid() -> int:
    """A pid that PROVABLY belonged to a dead same-host process."""
    proc = subprocess.Popen(["true"])
    proc.wait()
    return proc.pid


def _writer(payload: bytes):
    def write(p):
        with open(p, "wb") as fh:
            fh.write(payload)
    return write


@pytest.fixture()
def store(tmp_path):
    return ArtifactStore(str(tmp_path / "registry"))


def _table():
    return EmbeddingTable(mf_dim=MF, capacity=CAP,
                          cfg=SparseSGDConfig(mf_create_thresholds=1e9),
                          device="cpu")


def _write_rows(t, lo, hi, scale):
    """Assign keys [lo, hi) and give each row embed_w = key * scale."""
    keys = np.arange(lo, hi, dtype=np.uint64)
    rows = t.index.assign(keys)
    data = t.state.data.numpy().copy()
    data[rows, FIELD_COL["embed_w"]] = keys.astype(np.float32) * scale
    data[rows, FIELD_COL["show"]] = 1.0
    t.state = TableState.from_logical(data, t.opt_ext, t.device)
    t._touched[rows] = True


# ---------------------------------------------------------------------------
# publish / manifest / adoption
# ---------------------------------------------------------------------------

def test_publish_roundtrip_and_manifest_schema(store):
    a1 = store.publish({"rows.bin": _writer(b"base" * 64)}, kind="base",
                       refs={"cursor": {"global_step": 7}},
                       meta={"step": 7})
    m = store.read_manifest(a1)
    assert m["artifact"] == a1 and m["epoch"] == 1
    assert m["kind"] == "base" and m["parent"] is None
    rec = m["files"]["rows.bin"]
    assert rec["bytes"] == 256
    assert rec["sha256"] == hashlib.sha256(b"base" * 64).hexdigest()
    assert m["refs"]["cursor"]["global_step"] == 7
    assert m["meta"]["step"] == 7
    with store.open() as h:
        assert h.aid == a1
        assert h.read("rows.bin") == b"base" * 64


def test_epochs_monotone_and_lineage_chain(store):
    a1 = store.publish({"f": _writer(b"1")}, kind="base")
    a2 = store.publish({"f": _writer(b"2")}, kind="delta", parent=a1)
    a3 = store.publish({"f": _writer(b"3")}, kind="delta", parent=a2)
    assert store.versions() == [a1, a2, a3]
    assert [store.epoch_of(a) for a in (a1, a2, a3)] == [1, 2, 3]
    with store.open() as h:
        assert [m["artifact"] for m in h.chain] == [a1, a2, a3]


def test_delta_requires_published_parent(store):
    with pytest.raises(ArtifactLineageError):
        store.publish({"f": _writer(b"x")}, kind="delta")
    with pytest.raises(ArtifactLineageError):
        store.publish({"f": _writer(b"x")}, kind="delta",
                      parent="v0000000099")


def test_existing_files_hardlinked(store, tmp_path):
    src = tmp_path / "payload.npz"
    src.write_bytes(b"precomputed")
    aid = store.publish({"payload.npz": str(src)}, kind="base")
    with store.open(aid) as h:
        assert h.read("payload.npz") == b"precomputed"


def test_corrupt_payload_refused_and_degrades(store):
    a1 = store.publish({"f": _writer(b"good-one")}, kind="base")
    a2 = store.publish({"f": _writer(b"good-two")}, kind="delta",
                       parent=a1)
    p = os.path.join(store.version_dir(a2), "f")
    with open(p, "wb") as fh:
        fh.write(b"good-tw0")   # flipped byte, same length
    with pytest.raises(ArtifactCorruptError):
        store.open(a2)          # explicit version: loud refusal
    with store.open() as h:     # unpinned: degrade to verifiable parent
        assert h.aid == a1


def test_torn_manifest_refused(store):
    a1 = store.publish({"f": _writer(b"ok")}, kind="base")
    a2 = store.publish({"f": _writer(b"ok2")}, kind="delta", parent=a1)
    mp = os.path.join(store.version_dir(a2), MANIFEST)
    with open(mp, "a") as fh:
        fh.write(" ")           # torn/edited manifest: sidecar mismatch
    with pytest.raises(ArtifactCorruptError):
        store.open(a2)
    with store.open() as h:
        assert h.aid == a1


def test_corrupt_parent_fails_whole_chain(store):
    a1 = store.publish({"f": _writer(b"base")}, kind="base")
    store.publish({"f": _writer(b"delta")}, kind="delta", parent=a1)
    p = os.path.join(store.version_dir(a1), "f")
    with open(p, "wb") as fh:
        fh.write(b"b4se")
    with pytest.raises(ArtifactCorruptError):
        store.open()            # nothing verifiable left at all


def test_injected_read_corruption_refuses(store):
    """The ``artifact.read`` seam: a corrupt read refuses the version
    like a corrupt file does."""
    a1 = store.publish({"f": _writer(b"one")}, kind="base")
    a2 = store.publish({"f": _writer(b"two")}, kind="delta", parent=a1)
    with installed(FaultPlan.parse("artifact.read:corrupt:match=*"
                                   f"{a2}*,times=0")):
        with store.open() as h:
            assert h.aid == a1


# ---------------------------------------------------------------------------
# leases: fencing, reaping, retention
# ---------------------------------------------------------------------------

def test_lease_fences_after_reap_and_reader_reopens(store):
    a1 = store.publish({"f": _writer(b"v1")}, kind="base")
    h = store.open(a1)
    assert h.read("f") == b"v1"
    sweeper = ArtifactStore(store.root, lease_ttl_sec=0.0, sweep=False)
    assert sweeper.lease_registry().reap_stale() == []
    assert h.lease.alive()
    with open(h.lease.path) as fh:
        info = json.load(fh)
    info["pid"] = _dead_pid()
    with open(h.lease.path, "w") as fh:
        json.dump(info, fh)
    assert a1 in sweeper.lease_registry().reap_stale()
    with pytest.raises(ArtifactLeaseLostError):
        h.path("f")
    with pytest.raises(ArtifactLeaseLostError):
        h.read("f")
    with pytest.raises(ArtifactLeaseLostError):
        h.heartbeat()
    with store.open() as h2:
        assert h2.aid == a1 and h2.read("f") == b"v1"


def test_reap_only_provably_stale(tmp_path):
    reg = LeaseRegistry(str(tmp_path / "leases"), ttl_sec=3600.0)
    fresh = reg.acquire("keep-me")
    pid = _dead_pid()
    dead_path = os.path.join(reg.root, f"dead-one.{pid}-cafe.lease")
    with open(dead_path, "w") as fh:
        json.dump({"name": "dead-one", "pid": pid,
                   "host": socket.gethostname(),
                   "created_unix": time.time()}, fh)
    assert reg.reap_stale() == ["dead-one"]
    assert fresh.alive()
    assert reg.held("keep-me") and not reg.held("dead-one")
    foreign = os.path.join(reg.root, "far-away.12345-beef.lease")
    with open(foreign, "w") as fh:
        json.dump({"name": "far-away", "pid": 12345,
                   "host": "some-other-host"}, fh)
    assert reg.reap_stale() == []          # fresh heartbeat: kept
    old = time.time() - 7200
    os.utime(foreign, (old, old))          # idle past the TTL: reaped
    assert reg.reap_stale() == ["far-away"]
    fresh.release()


def test_heartbeat_refreshes_mtime(store):
    a1 = store.publish({"f": _writer(b"v1")}, kind="base")
    h = store.open(a1)
    old = os.stat(h.lease.path).st_mtime
    time.sleep(0.05)
    h.heartbeat()
    assert os.stat(h.lease.path).st_mtime >= old
    h.close()
    assert not h.lease.alive()


def test_retention_keeps_leased_and_lineage(store):
    a1 = store.publish({"f": _writer(b"1")}, kind="base")
    a2 = store.publish({"f": _writer(b"2")}, kind="delta", parent=a1)
    b1 = store.publish({"f": _writer(b"3")}, kind="base")
    b2 = store.publish({"f": _writer(b"4")}, kind="delta", parent=b1)
    h = store.open(a2)
    assert store.retain(keep=2) == []
    assert store.versions() == [a1, a2, b1, b2]
    h.close()
    assert store.retain(keep=2) == [a1, a2]
    assert store.versions() == [b1, b2]
    assert store.retain(keep=1) == []


def test_live_publisher_stage_not_swept(store):
    stage = os.path.join(store.root, f".stage-{os.getpid()}-aa")
    os.makedirs(stage)
    with open(os.path.join(stage, "stage.json"), "w") as fh:
        json.dump({"pid": os.getpid(), "host": socket.gethostname(),
                   "created_unix": time.time()}, fh)
    ArtifactStore(store.root, lease_ttl_sec=0.0)
    assert os.path.isdir(stage)
    os.unlink(os.path.join(stage, "stage.json"))
    ArtifactStore(store.root, lease_ttl_sec=0.0)
    assert os.path.isdir(stage)
    with open(os.path.join(stage, "stage.json"), "w") as fh:
        json.dump({"pid": _dead_pid(), "host": socket.gethostname()}, fh)
    ArtifactStore(store.root)
    assert not os.path.isdir(stage)


# ---------------------------------------------------------------------------
# cross-process: a real SIGKILL mid-publish
# ---------------------------------------------------------------------------

_PUBLISHER = r"""
import os, sys, time
sys.path.insert(0, {repo!r})
import numpy as np
from paddlebox_tpu_torch import EmbeddingTable
from paddlebox_tpu_torch.artifacts import ArtifactStore
from paddlebox_tpu_torch.ps.sgd import SparseSGDConfig
from paddlebox_tpu_torch.ps.table import FIELD_COL, TableState

root = sys.argv[1]
store = ArtifactStore(root)
t = EmbeddingTable(mf_dim={mf}, capacity={cap}, device="cpu",
                   cfg=SparseSGDConfig(mf_create_thresholds=1e9))
keys = np.arange(1, 201, dtype=np.uint64)
rows = t.index.assign(keys)
data = t.state.data.numpy().copy()
data[rows, FIELD_COL["embed_w"]] = keys.astype(np.float32) * 2.0
data[rows, FIELD_COL["show"]] = 1.0
t.state = TableState.from_logical(data, t.opt_ext, t.device)
t._touched[rows] = True
aid = store.publish({{"sparse.npz": lambda p: t.save_base(p)}},
                    kind="base", meta={{"step": 1}})
with open(os.path.join(root, "digest.txt"), "w") as fh:
    fh.write(aid + " " + t.rows_digest())

def hang_writer(p):
    t._touched[rows] = True
    t.save_delta(p)
    with open(os.path.join(root, "STAGED"), "w") as fh:
        fh.write("1")
    time.sleep(600)

store.publish({{"sparse_delta.npz": hang_writer}}, kind="delta",
              parent=aid)
"""


def _serving():
    slots = ([SlotDef("label", "float", 1), SlotDef("d", "float", 2)]
             + [SlotDef(f"S{i}", "uint64") for i in range(2)])
    desc = DataFeedDesc(slots=slots, label_slot="label", batch_size=16)
    return ServingModel(DeepFM(2, 3 + MF, 2, hidden=(4,)), desc,
                        mf_dim=MF, capacity=CAP,
                        cfg=SparseSGDConfig(mf_create_thresholds=1e9),
                        device="cpu")


def test_sigkill_mid_publish_reader_adopts_previous(tmp_path):
    """A publisher killed by SIGKILL mid-publish leaves only a stage
    carcass; a fresh reader sweeps it and adopts the previous COMPLETE
    version with a bit-identical digest."""
    root = str(tmp_path / "registry")
    os.makedirs(root)
    proc = subprocess.Popen(
        [sys.executable, "-c",
         _PUBLISHER.format(repo=REPO, mf=MF, cap=CAP), root])
    try:
        staged = os.path.join(root, "STAGED")
        deadline = time.time() + 120
        while not os.path.isfile(staged):
            assert proc.poll() is None, "publisher died before staging"
            assert time.time() < deadline, "publisher never staged"
            time.sleep(0.05)
        os.kill(proc.pid, signal.SIGKILL)
        proc.wait(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    with open(os.path.join(root, "digest.txt")) as fh:
        v1, want_digest = fh.read().split()
    assert [n for n in os.listdir(root) if n.startswith(".stage-")]
    store = ArtifactStore(root)      # dead-pid carcass swept on open
    assert not [n for n in os.listdir(root) if n.startswith(".stage-")]
    assert store.versions() == [v1]
    srv = _serving()
    assert srv.adopt(store) == v1
    assert srv.table.rows_digest() == want_digest
    srv.release()


def test_failed_publish_loses_no_delta_rows(store):
    """A delta staged with ``clear_touched=False`` and cleared only after
    the commit: a publish that dies before the commit keeps every touched
    flag, so the retry's delta still carries the rows."""
    t = _table()

    def publish(kind, parent=None):
        name = "sparse.npz" if kind == "base" else "sparse_delta.npz"
        save = t.save_base if kind == "base" else t.save_delta
        aid = store.publish({name: lambda p: save(p, clear_touched=False)},
                            kind=kind, parent=parent)
        t.clear_touched_flags()
        return aid

    _write_rows(t, 1, 51, 2.0)
    v1 = publish("base")
    assert not t._touched.any()
    _write_rows(t, 30, 81, 3.0)
    with installed(FaultPlan.parse("artifact.publish:fail:nth=1,"
                                   "exc=crash", seed=3)):
        with pytest.raises(InjectedCrash):
            publish("delta", v1)
    assert t._touched.any()
    v2 = publish("delta", v1)
    reader = _table()
    reader.load(os.path.join(store.version_dir(v1), "sparse.npz"))
    reader.load(os.path.join(store.version_dir(v2), "sparse_delta.npz"),
                merge=True)
    assert reader.rows_digest() == t.rows_digest()


# ---------------------------------------------------------------------------
# the two packages' stores against each other
# ---------------------------------------------------------------------------

def _logical(keys, rows, blob):
    order = np.argsort(keys)
    return keys[order], {f: v[order] for f, v in blob.items()}


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_store_crosses_between_packages(tmp_path, writer):
    """A base + delta chain published by one package's store opens,
    chain-verifies and loads under the other's, row for row; the
    manifests agree on every schema key."""
    root = str(tmp_path / "registry")
    W, R = ((ArtifactStore, JStore) if writer == "port"
            else (JStore, ArtifactStore))
    t = _table()
    _write_rows(t, 1, 61, 2.0)
    w = W(root)
    v1 = w.publish({"sparse.npz": lambda p: t.save_base(p)}, kind="base",
                   meta={"step": 1})
    _write_rows(t, 40, 91, 3.0)
    v2 = w.publish({"sparse_delta.npz": lambda p: t.save_delta(p)},
                   kind="delta", parent=v1, meta={"step": 2})
    r = R(root)
    chain = r.verify_chain(v2)
    assert [m["artifact"] for m in chain] == [v1, v2]
    assert set(chain[1]) == set(w.read_manifest(v2))
    assert chain == w.verify_chain(v2)
    # the reader's own table type replays the chain to the writer's rows
    with r.open() as h:
        assert h.aid == v2
        jt = JTable(mf_dim=MF, capacity=CAP,
                    cfg=JCfg(mf_create_thresholds=1e9))
        tt = _table()
        for i, m in enumerate(h.chain):
            name = "sparse.npz" if m["kind"] == "base" else "sparse_delta.npz"
            jt.load(h.path(name, m["artifact"]), merge=i > 0)
            tt.load(h.path(name, m["artifact"]), merge=i > 0)
    assert tt.rows_digest() == t.rows_digest()
    keys, rows = t.index.items()
    want_k, want = _logical(keys, rows, t._gather_host(rows))
    jk, jr = jt.index.items()
    got_k, got = _logical(jk, jr, jt._gather_host(jr))
    np.testing.assert_array_equal(got_k, want_k)
    for f in sorted(want):
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    assert r.leased_versions() == []
