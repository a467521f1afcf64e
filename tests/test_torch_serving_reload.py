"""The port's serving consumer side (``serving.py``): store adoption,
the delta hot-reload, the dense-only reload, the refusal of a
wrong-parent, unmanaged or corrupt delta (the cases of
``tests/test_serving.py``), and ``ReloadLoop``. Chains are published
from a port table into one store, and the JAX ``ServingModel`` adopts the
same store: adopted logical rows and lookups must match exactly."""

import os
import threading
import time

import numpy as np
import pytest
import torch

from paddlebox_tpu.artifacts import ArtifactStore as JStore
from paddlebox_tpu.data.schema import DataFeedDesc as JDesc
from paddlebox_tpu.models import CtrDnn as JCtrDnn
from paddlebox_tpu.serving import ServingModel as JServing

from paddlebox_tpu_torch import (ArtifactCorruptError, ArtifactLineageError,
                                 ArtifactStore, CheckpointManager, DeepFM,
                                 EmbeddingTable, ReloadLoop, ServingModel,
                                 Trainer)
from paddlebox_tpu_torch.config import flags_scope
from paddlebox_tpu_torch.data import (DataFeedDesc, InMemoryDataset,
                                      SlotDef, SlotRecord)
from paddlebox_tpu_torch.ps.sgd import SparseSGDConfig
from paddlebox_tpu_torch.ps.table import FIELD_COL, TableState
from paddlebox_tpu_torch.resilience.faults import FaultPlan, installed
from paddlebox_tpu_torch.train.step import ctr_forward, make_device_batch

MF, CAP, S, DENSE_DIM = 4, 1 << 10, 3, 2
CFG = SparseSGDConfig()
PROBE = np.arange(1, 121, dtype=np.uint64)


def _desc(bs=16):
    slots = ([SlotDef("label", "float", 1), SlotDef("d", "float", DENSE_DIM)]
             + [SlotDef(f"S{i}", "uint64") for i in range(S)])
    return DataFeedDesc(slots=slots, label_slot="label", batch_size=bs,
                        key_bucket_min=64)


def _model():
    torch.manual_seed(0)
    return DeepFM(S, 3 + MF, DENSE_DIM, hidden=(8,),
                  compute_dtype=torch.float32)


def _srv():
    return ServingModel(_model(), _desc(), mf_dim=MF, capacity=CAP,
                        cfg=CFG, device="cpu")


def _jsrv():
    return JServing(JCtrDnn(hidden=(4,)), JDesc.criteo(batch_size=16),
                    mf_dim=MF, capacity=CAP)


class Publisher:
    """A port table publishing base/delta versions into a store, each
    delta parented on the last (the touched set clears only after the
    commit)."""

    def __init__(self, store):
        self.store = store
        self.t = EmbeddingTable(mf_dim=MF, capacity=CAP, cfg=CFG,
                                device="cpu")
        self.tip = None

    def write(self, lo, hi, scale):
        keys = np.arange(lo, hi, dtype=np.uint64)
        rows = self.t.index.assign(keys)
        data = self.t.state.data.numpy().copy()
        data[rows, FIELD_COL["embed_w"]] = keys.astype(np.float32) * scale
        data[rows, FIELD_COL["show"]] = 1.0
        self.t.state = TableState.from_logical(data, self.t.opt_ext,
                                               self.t.device)
        self.t._touched[rows] = True

    def publish(self, kind):
        name = "sparse.npz" if kind == "base" else "sparse_delta.npz"
        save = self.t.save_base if kind == "base" else self.t.save_delta
        self.tip = self.store.publish(
            {name: lambda p: save(p, clear_touched=False)}, kind=kind,
            parent=None if kind == "base" else self.tip)
        self.t.clear_touched_flags()
        return self.tip


def _published_chain(tmp_path):
    pub = Publisher(ArtifactStore(str(tmp_path / "registry")))
    pub.write(1, 51, 2.0)
    v1 = pub.publish("base")
    pub.write(40, 61, 3.0)
    v2 = pub.publish("delta")
    pub.write(55, 71, 5.0)
    v3 = pub.publish("delta")
    return pub, (v1, v2, v3)


def _logical(table):
    keys, rows = table.index.items()
    order = np.argsort(keys)
    blob = table._gather_host(rows[order])
    return keys[order], blob


def _same_rows(srv, jsrv):
    tk, tb = _logical(srv.snapshot().table)
    jk, jb = _logical(jsrv.snapshot().table)
    np.testing.assert_array_equal(tk, jk)
    for f in sorted(jb):
        np.testing.assert_array_equal(tb[f], jb[f], err_msg=f)
    np.testing.assert_array_equal(srv.embed_lookup(PROBE),
                                  jsrv.embed_lookup(PROBE))


def test_adopt_and_hot_reload_chain_match_reference(tmp_path):
    """Adoption verifies the whole chain and holds the lease; hot_reload
    applies ONLY the new delta; each state equals the JAX
    ServingModel's adoption of the same store, row for row."""
    pub, (v1, v2, v3) = _published_chain(tmp_path)
    store = pub.store
    srv, jsrv = _srv(), _jsrv()
    jstore = JStore(store.root)
    assert srv.adopt(store, v2) == jsrv.adopt(jstore, v2) == v2
    _same_rows(srv, jsrv)
    assert srv.last_load == {"aid": v2, "start": 0, "applied": [v1, v2],
                             "fresh": True}
    assert srv.hot_reload(store) == jsrv.hot_reload(jstore) == v3
    assert srv.last_load["applied"] == [v3] and not srv.last_load["fresh"]
    _same_rows(srv, jsrv)
    assert srv.hot_reload(store) is None       # already current
    assert srv.serving_status()["adopted"] == v3
    pub.write(100, 111, 7.0)
    v4 = pub.publish("delta")
    assert srv.hot_reload(store) == jsrv.hot_reload(jstore) == v4
    assert srv.last_load["applied"] == [v4]
    _same_rows(srv, jsrv)
    jsrv.release()
    assert store.leased_versions() == [v4]     # old lease swapped out
    srv.release()
    srv.release()
    assert store.leased_versions() == []
    # a fresh adoption of the tip equals the hot-reloaded state
    fresh = _srv()
    assert fresh.adopt(store) == v4
    assert fresh.snapshot().digest() == srv.snapshot().digest()
    assert fresh.snapshot().digest() == pub.t.rows_digest()
    fresh.release()


def test_hot_reload_readopts_on_new_base(tmp_path):
    pub, (v1, v2, v3) = _published_chain(tmp_path)
    srv = _srv()
    srv.adopt(pub.store)
    pub.write(200, 230, 1.0)
    b2 = pub.publish("base")                  # a diverged lineage
    assert srv.hot_reload(pub.store) == b2
    assert srv.last_load == {"aid": b2, "start": 0, "applied": [b2],
                             "fresh": True}
    assert srv.snapshot().digest() == pub.t.rows_digest()
    srv.release()


def test_apply_delta_verifies_artifact_lineage(tmp_path):
    """A managed delta is verified (parent id and sha256) before it
    touches the table: out-of-order, unmanaged-after-adoption and
    bit-flipped deltas refuse, with the reference's error types."""
    pub, (v1, v2, v3) = _published_chain(tmp_path)
    store = pub.store
    base = os.path.join(store.version_dir(v1), "sparse.npz")
    d2 = os.path.join(store.version_dir(v2), "sparse_delta.npz")
    d3 = os.path.join(store.version_dir(v3), "sparse_delta.npz")
    for make in (_srv, _jsrv):
        srv = make()
        srv.load_base(base)
        with pytest.raises(RuntimeError) as ei:   # each package's own
            srv.apply_delta(d3)                # skips v2
        assert type(ei.value).__name__ == "ArtifactLineageError"
        srv.apply_delta(d2)
        srv.apply_delta(d3)
        v = srv.embed_lookup(np.array([1, 45, 70], np.uint64))
        np.testing.assert_allclose(v[:, 2], [2.0, 135.0, 350.0])
    raw = str(tmp_path / "raw_delta.npz")
    pub.t._touched[:] = True
    pub.t.save_delta(raw, clear_touched=False)
    with pytest.raises(ArtifactLineageError):
        srv_port = _srv()
        srv_port.load_base(base)
        srv_port.apply_delta(d2)
        srv_port.apply_delta(raw)              # unmanaged after adoption
    srv2 = _srv()
    srv2.load_base(base)
    blob = open(d2, "rb").read()
    with open(d2, "wb") as fh:
        fh.write(blob[:9] + bytes([blob[9] ^ 0xFF]) + blob[10:])
    with pytest.raises(ArtifactCorruptError):
        srv2.apply_delta(d2)
    srv3 = _srv()
    srv3.load_base(raw)                        # a plain file stays legal
    assert srv3.adopted_aid is None
    srv3.apply_delta(raw)


def test_corrupt_tip_degrades_and_reload_loop_refuses(tmp_path):
    """A corrupt newest delta: adoption degrades to the newest verifiable
    version; ReloadLoop keeps the prior snapshot, counts the refusal
    and reports staleness; an injected ``serving.reload`` fault is
    refused the same way; a poll on an up-to-date store returns None."""
    pub, (v1, v2, v3) = _published_chain(tmp_path)
    store = pub.store
    srv = _srv()
    assert srv.adopt(store) == v3
    loop = ReloadLoop(srv, store, poll_sec=0.01)
    assert loop.poll_once() is None and loop.refused == 0
    assert srv.serving_status()["staleness_sec"] == 0.0
    pub.write(80, 90, 9.0)
    v4 = pub.publish("delta")
    p = os.path.join(store.version_dir(v4), "sparse_delta.npz")
    blob = open(p, "rb").read()
    with open(p, "wb") as fh:
        fh.write(blob[:-1] + bytes([blob[-1] ^ 1]))
    before = srv.snapshot()
    assert loop.poll_once() is None            # store degrades to v3
    assert srv.snapshot() is before and loop.degraded == 1
    assert srv.serving_status()["staleness_sec"] > 0.0
    with flags_scope(serving_staleness_max_sec=1e-9):
        assert srv.serving_status()["stale"]
    with installed(FaultPlan.parse("serving.reload:fail:nth=1")):
        assert loop.poll_once() is None
    assert loop.refused == 1 and loop._backoff is not None
    with open(p, "wb") as fh:
        fh.write(blob)                         # repaired in place
    assert loop.poll_once() == v4 and loop.adopted == 1
    assert loop._backoff is None
    srv.release()


def test_reload_loop_thread_follows_the_tip(tmp_path):
    pub, (v1, v2, v3) = _published_chain(tmp_path)
    srv = _srv()
    srv.adopt(pub.store, v1)
    with ReloadLoop(srv, pub.store, poll_sec=0.01) as loop:
        deadline = time.time() + 30
        while srv.adopted_aid != v3 and time.time() < deadline:
            time.sleep(0.01)
        pub.write(300, 310, 1.5)
        v4 = pub.publish("delta")
        while srv.adopted_aid != v4 and time.time() < deadline:
            time.sleep(0.01)
    assert srv.adopted_aid == v4 and loop._thread is None
    assert loop.adopted >= 2
    assert srv.snapshot().digest() == pub.t.rows_digest()
    srv.release()


def test_concurrent_readers_across_snapshot_swaps(tmp_path):
    """Query threads read while the main thread hot-reloads across two
    swaps: every read matches ONE published version's oracle."""
    import hashlib
    pub, (v1, v2, v3) = _published_chain(tmp_path)
    store = pub.store

    def digest(arr):
        return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()

    srv = _srv()
    srv.adopt(store, v1)
    stop = threading.Event()
    results, errors = [], []

    def reader():
        try:
            seen = []
            while not stop.is_set():
                snap = srv.snapshot()
                seen.append((snap.aid, digest(snap.lookup(PROBE))))
            results.append(seen)
        except BaseException as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=reader, daemon=True)
               for _ in range(3)]
    for th in threads:
        th.start()
    time.sleep(0.05)
    assert srv.hot_reload(store) == v3
    time.sleep(0.05)
    pub.write(100, 121, 4.0)
    v4 = pub.publish("delta")
    assert srv.hot_reload(store) == v4
    time.sleep(0.05)
    srv.release()
    stop.set()
    for th in threads:
        th.join(timeout=30)
    assert not errors, errors
    oracle = {}
    for aid in (v1, v3, v4):
        o = _srv()
        o.adopt(store, aid)
        oracle[aid] = digest(o.snapshot().lookup(PROBE))
        o.release()
    flat = [rec for seen in results for rec in seen]
    assert flat and all(oracle[aid] == d for aid, d in flat)
    assert store.leased_versions() == []


def _trained(tmp_path):
    rng = np.random.default_rng(1)
    desc = _desc(bs=32)
    recs = [SlotRecord(keys=rng.integers(0, 60, size=S).astype(np.uint64),
                       slot_offsets=np.arange(S + 1, dtype=np.int32),
                       dense=rng.normal(size=DENSE_DIM).astype(np.float32),
                       label=float(i % 2), show=1.0, clk=float(i % 2))
            for i in range(96)]
    ds = InMemoryDataset(desc)
    ds.records = recs
    t = EmbeddingTable(mf_dim=MF, capacity=CAP, cfg=CFG, device="cpu")
    tr = Trainer(_model(), t, desc,
                 tx=lambda p: torch.optim.Adam(p, lr=1e-2), device="cpu")
    store = ArtifactStore(str(tmp_path / "art"))
    cm = CheckpointManager(str(tmp_path / "ckpt"), artifacts=store)
    cm.save(tr)                                  # step-0 base
    tr.train_pass(ds)
    cm.save(tr, delta=True)                      # boundary delta
    return tr, ds, store


def test_adopt_checkpoint_artifacts_predicts_like_trainer(tmp_path):
    """A trainer's boundary checkpoints published through the store
    (``dense.pt`` beside the sparse files) adopt into serving, and its
    predictions equal ``ctr_forward`` on the trainer's own state."""
    tr, ds, store = _trained(tmp_path)
    v1, v2 = store.versions()
    srv = _srv()
    srv.desc = ds.desc
    assert srv.adopt(store, v1) == v1
    assert srv.hot_reload(store) == v2
    assert srv.last_load["applied"] == [v2]
    batch = next(ds.batches())
    idx = tr.table.prepare_eval(batch)
    with torch.inference_mode():
        want, _ = ctr_forward(tr.state.table, tr.model,
                              make_device_batch(batch, idx, tr.device),
                              batch.batch_size, batch.num_slots)
    np.testing.assert_array_equal(srv.predict(batch), want.numpy())
    fresh = _srv()
    fresh.adopt(store)
    np.testing.assert_array_equal(fresh.predict(batch), srv.predict(batch))
    srv.release()
    fresh.release()


def test_dense_only_reload_reaches_queries(tmp_path):
    """``load_dense`` swaps only the model: same frozen table, new
    params, visible to the next query."""
    tr, ds, store = _trained(tmp_path)
    srv = _srv()
    srv.adopt(store)
    batch = next(ds.batches())
    p1 = srv.predict(batch)
    snap1 = srv.snapshot()
    path = str(tmp_path / "bumped")
    for p in tr.model.parameters():
        p.data.mul_(1.5)
    tr.save(path)
    srv.load_dense(path + ".dense.pt")
    snap2 = srv.snapshot()
    assert snap2 is not snap1 and snap2.table is snap1.table
    assert snap2.aid == snap1.aid
    assert not np.allclose(p1, srv.predict(batch))
    srv.release()
