"""The port's remaining PS helpers (``ps/extended.py``,
``ps/replica_cache.py``, ``auc_runner.py``) against the JAX package's, on
the CPU: the counterparts of the extended-table and replica-cache cases
of ``tests/test_seqpool_variants.py`` and ``tests/test_embedding_table.py``
and of ``tests/test_auc_runner.py``.

Tolerances: row assignment, gather indices, slot metadata, the replica
lookups and the AUC runner's replacements exact; the extended tables'
pulls after a push within rtol 1e-6 (the same float32 Adagrad ops in
another framework; lazy mf draws zeros on both sides).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddlebox_tpu.auc_runner import AucRunner as JAucRunner
from paddlebox_tpu.data.batch import SlotBatch as JSlotBatch
from paddlebox_tpu.data.record import SlotRecord as JRecord
from paddlebox_tpu.ps import ExtendedEmbeddingTable as JExtended
from paddlebox_tpu.ps import InputTable as JInputTable
from paddlebox_tpu.ps import ReplicaCache as JReplicaCache
from paddlebox_tpu.ps import SparseSGDConfig as JCfg

from paddlebox_tpu_torch.auc_runner import AucRunner, RecordCandidateList
from paddlebox_tpu_torch.data import (DataFeedDesc, DatasetFactory, SlotDef,
                                      SlotRecord)
from paddlebox_tpu_torch.data.batch import SlotBatch
from paddlebox_tpu_torch.models import CtrDnn
from paddlebox_tpu_torch.ps import (EmbeddingTable, ExtendedEmbeddingTable,
                                    InputTable, ReplicaCache,
                                    ShardedEmbeddingTable, SparseSGDConfig)
from paddlebox_tpu_torch.train import Trainer
from paddlebox_tpu_torch.train.sharded import ShardedTrainer


def _batch(cls, keys, segments, b=2, s=2, k_pad=None):
    keys = np.asarray(keys, np.uint64)
    k_pad = k_pad or len(keys)
    kp = np.zeros(k_pad, np.uint64)
    kp[:len(keys)] = keys
    sp = np.full(k_pad, b * s, np.int32)
    sp[:len(keys)] = segments
    return cls(keys=kp, segments=sp, num_keys=len(keys),
               dense=np.zeros((b, 1), np.float32),
               label=np.zeros(b, np.float32), show=np.ones(b, np.float32),
               clk=np.zeros(b, np.float32), batch_size=b, num_slots=s)


# ---------------------------------------------------------------------------
# ExtendedEmbeddingTable
# ---------------------------------------------------------------------------

def test_extended_embedding_table():
    t = ExtendedEmbeddingTable(mf_dim=4, extend_mf_dim=8, capacity=128,
                               cfg=SparseSGDConfig(mf_create_thresholds=0.0),
                               unique_bucket_min=64, device="cpu")
    batch = _batch(SlotBatch, [5, 9, 5, 33], np.arange(4))
    idx = t.prepare(batch)
    v, ve = t.pull(idx)
    assert v.shape == (4, 3 + 4) and ve.shape == (4, 3 + 8)
    t.push(idx, torch.ones((4, 7)) * 0.1, torch.ones((4, 11)) * 0.1)
    v2, ve2 = t.pull(idx)
    assert not torch.allclose(v, v2)
    assert not torch.allclose(ve, ve2)
    assert t.feature_count == 3


def test_extended_table_skip_slots():
    t = ExtendedEmbeddingTable(mf_dim=4, extend_mf_dim=4, capacity=128,
                               cfg=SparseSGDConfig(mf_create_thresholds=0.0),
                               unique_bucket_min=64, skip_extend_slots=[1],
                               device="cpu")
    # ins0 slots 0,1; ins1 slots 0,1 → keys 9 and 33 in slot 1
    batch = _batch(SlotBatch, [5, 9, 7, 33], [0, 1, 2, 3])
    idx_b, idx_e = t.prepare(batch)
    _, ve = t.pull((idx_b, idx_e))
    np.testing.assert_array_equal(ve.numpy()[[1, 3]], 0.0)
    # skipped keys point at the sentinel slot (the reference's key_valid 0)
    assert (idx_e.gather_idx[[1, 3]] == idx_e.num_unique).all()
    t.push((idx_b, idx_e), torch.ones((4, 7)) * 0.1,
           torch.ones((4, 7)) * 0.1)
    assert t.extend.feature_count == 2   # only slot-0 keys allocated
    assert t.base.feature_count == 4


@pytest.mark.parametrize("skip", [(), (1,)])
def test_extended_matches_jax(skip):
    """prepare's indices and slots exact, pulls before and after two
    pushes against the JAX pair, key_valid as the sentinel."""
    cfg = dict(mf_create_thresholds=0.0, mf_initial_range=0.0)
    t = ExtendedEmbeddingTable(mf_dim=4, extend_mf_dim=8, capacity=128,
                               cfg=SparseSGDConfig(**cfg),
                               unique_bucket_min=8, skip_extend_slots=skip,
                               device="cpu")
    j = JExtended(mf_dim=4, extend_mf_dim=8, capacity=128, cfg=JCfg(**cfg),
                  unique_bucket_min=8, skip_extend_slots=skip)
    rng = np.random.default_rng(4)
    for step in range(2):
        keys = rng.integers(1, 30, size=10)
        segs = np.sort(rng.integers(0, 8, size=10)).astype(np.int32)
        tb = _batch(SlotBatch, keys, segs, b=4, s=2, k_pad=16)
        jb = _batch(JSlotBatch, keys, segs, b=4, s=2, k_pad=16)
        ti, ji = t.prepare(tb), j.prepare(jb)
        for a, w in zip(ti, ji):
            np.testing.assert_array_equal(a.unique_rows, w.unique_rows)
            assert a.num_unique == w.num_unique
            live = w.key_valid > 0
            np.testing.assert_array_equal(a.gather_idx[live],
                                          w.gather_idx[live])
            assert (a.gather_idx[~live] >= a.num_unique).all()
        tv = [x.numpy() for x in t.pull(ti)]
        jv = [np.asarray(x) for x in j.pull(ji)]
        for a, w in zip(tv, jv):
            np.testing.assert_allclose(a, w, rtol=1e-6, atol=1e-7)
        g = rng.normal(size=(16, 7)).astype(np.float32)
        ge = rng.normal(size=(16, 11)).astype(np.float32)
        sok = (segs % 2).astype(np.float32)
        sok = np.concatenate([sok, np.zeros(6, np.float32)])
        t.push(ti, torch.from_numpy(g), torch.from_numpy(ge),
               slot_of_key=sok)
        j.push(ji, jnp.asarray(g), jnp.asarray(ge),
               slot_of_key=jnp.asarray(sok))
        for a, w in zip(t.pull(ti), j.pull(ji)):
            np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=1e-6,
                                       atol=1e-7)
    for a, w in ((t.base, j.base), (t.extend, j.extend)):
        np.testing.assert_array_equal(a.slot_host, w.slot_host)
        assert a.feature_count == w.feature_count


def test_slot_host_recorded_on_all_paths():
    """The extended pair records slots for BOTH tables (the reference's
    regression case), as the JAX pair does."""
    te = ExtendedEmbeddingTable(mf_dim=2, extend_mf_dim=2, capacity=32,
                                unique_bucket_min=8,
                                skip_extend_slots=(0,), device="cpu")
    je = JExtended(mf_dim=2, extend_mf_dim=2, capacity=32,
                   unique_bucket_min=8, skip_extend_slots=(0,))
    te.prepare(_batch(SlotBatch, [11, 12], [0, 1], k_pad=8))
    je.prepare(_batch(JSlotBatch, [11, 12], [0, 1], k_pad=8))
    rb = te.base.index.lookup(np.array([12], np.uint64))[0]
    assert te.base.slot_host[rb] == 1
    re_ = te.extend.index.lookup(np.array([12], np.uint64))[0]
    assert re_ >= 0 and te.extend.slot_host[re_] == 1
    assert te.extend.index.lookup(np.array([11], np.uint64))[0] < 0
    np.testing.assert_array_equal(te.base.slot_host, je.base.slot_host)
    np.testing.assert_array_equal(te.extend.slot_host, je.extend.slot_host)


# ---------------------------------------------------------------------------
# ReplicaCache / InputTable
# ---------------------------------------------------------------------------

def test_replica_cache_and_input_table():
    rc = ReplicaCache(emb_dim=4, device="cpu")
    first = rc.add_items(np.ones((3, 4)))
    assert first == 0 and rc.size == 3
    rc.add_items(np.full((2, 4), 2.0))
    out = rc.pull(torch.tensor([0, 3, 4])).numpy()
    np.testing.assert_allclose(out[0], 1.0)
    np.testing.assert_allclose(out[1], 2.0)
    with pytest.raises(ValueError):
        ReplicaCache(emb_dim=4, device="cpu").pull(torch.tensor([0]))

    it = InputTable(dim=3, device="cpu")
    it.add_input("adv_1", [1.0, 2.0, 3.0])
    it.add_input("adv_2", [4.0, 5.0, 6.0])
    got = it.lookup(["adv_2", "missing", "adv_1"]).numpy()
    np.testing.assert_allclose(got[0], [4, 5, 6])
    np.testing.assert_allclose(got[1], 0.0)
    np.testing.assert_allclose(got[2], [1, 2, 3])


def test_replica_cache_matches_jax():
    """Seeded rows and ids, out-of-range ids clamped, against the JAX
    cache exactly."""
    rng = np.random.default_rng(7)
    rows = [rng.normal(size=(n, 6)).astype(np.float32) for n in (5, 9, 2)]
    rc, jc = ReplicaCache(6, device="cpu"), JReplicaCache(6)
    for r in rows:
        assert rc.add_items(r) == jc.add_items(r)
    ids = rng.integers(-3, 20, size=(4, 7))
    np.testing.assert_array_equal(rc.pull(torch.from_numpy(ids)).numpy(),
                                  np.asarray(jc.pull(jnp.asarray(ids))))
    np.testing.assert_array_equal(rc.to_hbm().numpy(),
                                  np.asarray(jc.to_hbm()))
    it, jt = InputTable(6, device="cpu"), JInputTable(6)
    for i, r in enumerate(rows[1]):
        assert it.add_input(f"k{i % 6}", r) == jt.add_input(f"k{i % 6}", r)
    keys = [f"k{i}" for i in range(8)]
    np.testing.assert_array_equal(it.lookup(keys).numpy(),
                                  np.asarray(jt.lookup(keys)))


def test_input_index_feed_loads_filelist(tmp_path):
    f1 = tmp_path / "idx1.txt"
    f1.write_text("adv_1\t1 2 3\nadv_2\t4,5,6\nBADLINE\nadv_3\t7 8 9\n")
    f2 = tmp_path / "idx2.txt"
    f2.write_text("adv_4\t-1 -2 -3\n")
    it = InputTable(dim=3, device="cpu")
    n = it.load_index_filelist([str(f1), str(f2)], thread_num=2)
    assert n == 4 and len(it) == 4
    got = it.lookup(["adv_2", "adv_4"]).numpy()
    np.testing.assert_allclose(got[0], [4, 5, 6])
    np.testing.assert_allclose(got[1], [-1, -2, -3])
    # pluggable parser (the ParseIndexData hook)
    f3 = tmp_path / "idx3.txt"
    f3.write_text("k9|9;9;9\n")
    it2 = InputTable(dim=3, device="cpu")
    it2.load_index_filelist(
        [str(f3)],
        parse_index_line=lambda ln: (
            (p := ln.strip().split("|"))[0],
            [float(v) for v in p[1].split(";")]))
    np.testing.assert_allclose(it2.lookup(["k9"]).numpy()[0], 9.0)
    # a wrong-width vector skips the ROW; a missing FILE raises
    f4 = tmp_path / "idx4.txt"
    f4.write_text("short\t1 2\nok\t1 2 3\n")
    it3 = InputTable(dim=3, device="cpu")
    assert it3.load_index_filelist([str(f4)]) == 1
    with pytest.raises(FileNotFoundError):
        it3.load_index_filelist([str(tmp_path / "nope.txt"), str(f4)],
                                thread_num=1)
    # duplicate keys across files: the LAST file in filelist order wins
    fa = tmp_path / "dup_a.txt"
    fa.write_text("k\t1 1 1\n")
    fb = tmp_path / "dup_b.txt"
    fb.write_text("k\t2 2 2\n")
    it4 = InputTable(dim=3, device="cpu")
    assert it4.load_index_filelist([str(fa), str(fb)], thread_num=2) == 2
    assert len(it4) == 1
    np.testing.assert_allclose(it4.lookup(["k"]).numpy()[0], 2.0)


# ---------------------------------------------------------------------------
# AucRunner
# ---------------------------------------------------------------------------

def make_records(n, num_slots=4, seed=0, cls=SlotRecord):
    rng = np.random.default_rng(seed)
    recs = []
    for i in range(n):
        keys = rng.integers(0, 50, size=num_slots).astype(np.uint64)
        keys += np.arange(num_slots, dtype=np.uint64) * 100
        recs.append(cls(
            keys=keys, slot_offsets=np.arange(num_slots + 1, dtype=np.int32),
            dense=np.zeros(2, np.float32), label=float(i % 2)))
    return recs


def test_candidate_reservoir():
    rng = np.random.default_rng(0)
    cl = RecordCandidateList(capacity=10, slots=[0, 2])
    cl.add_all(make_records(100), rng)
    assert cl.size == 10
    v = cl.sample(0, rng)
    assert v.dtype == np.uint64 and 0 <= int(v[0]) < 100


def test_record_replace_and_back():
    recs = make_records(20, seed=1)
    runner = AucRunner(slots_to_replace=[1], pool_size=50, seed=2)
    runner.init_pass(recs)
    replaced = runner.record_replace(recs)
    assert runner.phase == 0
    diff = 0
    for a, b in zip(recs, replaced):
        np.testing.assert_array_equal(a.slot_keys(0), b.slot_keys(0))
        np.testing.assert_array_equal(a.slot_keys(2), b.slot_keys(2))
        np.testing.assert_array_equal(a.slot_keys(3), b.slot_keys(3))
        assert 100 <= int(b.slot_keys(1)[0]) < 200  # still slot-1 vocab
        diff += int(a.slot_keys(1)[0] != b.slot_keys(1)[0])
    assert diff > 5
    back = runner.record_replace_back()
    assert back is not replaced and back[0] is recs[0]
    assert runner.phase == 1
    with pytest.raises(RuntimeError):
        runner.record_replace_back()


def test_replacements_match_jax():
    """The same seed replaces the same feasigns as the reference."""
    recs = make_records(300, num_slots=5, seed=8)
    jrecs = make_records(300, num_slots=5, seed=8, cls=JRecord)
    runner = AucRunner(slots_to_replace=[0, 3], pool_size=40, seed=9)
    jrunner = JAucRunner(slots_to_replace=[0, 3], pool_size=40, seed=9)
    runner.init_pass(recs)
    jrunner.init_pass(jrecs)
    for _ in range(2):
        got, want = runner.record_replace(recs), jrunner.record_replace(jrecs)
        for a, w in zip(got, want):
            np.testing.assert_array_equal(a.keys, w.keys)
            np.testing.assert_array_equal(a.slot_offsets, w.slot_offsets)
        runner.record_replace_back()
        jrunner.record_replace_back()
    assert runner.phase == jrunner.phase == 1


def _informative_setup(batch_size):
    """Slot 0 determines the label; slot 3 is pure noise."""
    rng = np.random.default_rng(5)
    n, num_slots = 4000, 4
    recs = []
    for _ in range(n):
        k0 = int(rng.integers(0, 20))
        keys = np.array(
            [k0,
             100 + int(rng.integers(0, 20)),
             200 + int(rng.integers(0, 20)),
             300 + int(rng.integers(0, 20))], np.uint64)
        recs.append(SlotRecord(
            keys=keys, slot_offsets=np.arange(num_slots + 1, dtype=np.int32),
            dense=np.zeros(1, np.float32), label=float(k0 < 10),
            clk=float(k0 < 10)))
    desc = DataFeedDesc(
        slots=[SlotDef(name=f"s{i}") for i in range(num_slots)]
        + [SlotDef(name="d0", type="float", dim=1)],
        batch_size=batch_size)
    desc.key_bucket_min = 2048
    cfg = SparseSGDConfig(mf_create_thresholds=0.0, mf_initial_range=1e-3,
                          learning_rate=0.1, mf_learning_rate=0.1)
    return recs, desc, cfg


def _assert_slot_importance(tr, recs, desc):
    """Train 3 passes, then slot-replacement importance: destroying the
    label-defining slot collapses the AUC; the noise slot does not."""
    ds = DatasetFactory().create_dataset("InMemoryDataset", desc)
    ds.records = recs
    for _ in range(3):
        tr.train_pass(ds)

    def eval_fn(records):
        ds2 = DatasetFactory().create_dataset("InMemoryDataset", desc)
        ds2.records = records
        return tr.eval_pass(ds2)["auc"]

    runner = AucRunner(slots_to_replace=[0, 3], pool_size=2000, seed=3)
    runner.init_pass(recs)
    imp = runner.slot_importance(eval_fn, recs)
    assert imp[0] > 0.2, imp
    assert abs(imp[3]) < 0.05, imp


def _ctr_dnn():
    torch.manual_seed(0)
    return CtrDnn(4, 3 + 8, 1, hidden=(32, 32), compute_dtype=torch.float32)


def test_slot_importance_detects_informative_slot():
    recs, desc, cfg = _informative_setup(batch_size=256)
    table = EmbeddingTable(mf_dim=8, capacity=1 << 12, cfg=cfg,
                           unique_bucket_min=2048, device="cpu")
    tr = Trainer(_ctr_dnn(), table, desc,
                 tx=lambda p: torch.optim.Adam(p, lr=5e-3), device="cpu")
    _assert_slot_importance(tr, recs, desc)


def test_slot_importance_on_sharded_trainer():
    """AucRunner composes with the sharded trainer unchanged (it works on
    records): slot importance through ``ShardedTrainer.eval_pass`` at
    N = 8 finds the same informative slot."""
    recs, desc, cfg = _informative_setup(batch_size=64)
    table = ShardedEmbeddingTable(8, mf_dim=8, capacity_per_shard=1 << 10,
                                  cfg=cfg, req_bucket_min=128,
                                  serve_bucket_min=128, devices="cpu")
    tr = ShardedTrainer(_ctr_dnn(), table, desc,
                        tx=lambda p: torch.optim.Adam(p, lr=5e-3))
    _assert_slot_importance(tr, recs, desc)
