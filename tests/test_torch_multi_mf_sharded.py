"""The port's multi-mf sharded table, step and trainer and its tiered
table (``ps/multi_mf_sharded.py``, ``train/multi_mf_sharded.py``) on the
CPU: the counterparts of ``tests/test_multi_mf_sharded.py`` at N = 4, and
two global steps against the JAX ``MultiMfShardedTrainer`` on a 4-device
slice of its 8-device CPU mesh.

Tolerances: routing plans (``serve_slot`` holding GLOBAL slot ids among
them), row assignment, show/clk and the slot column exact; training
against the reference in the ragged train-state class, rtol 2e-4 / atol
2e-5, the AUC within 1e-5, with the JAX seqpool on its XLA and its Pallas
(interpret) route; the port's overlapped push order against its
sequential one, and its tiered table against the plain one, bit for bit
(one CPU thread). Lazy mf draws zeros on both sides (``mf_initial_range``
0).
"""

import os

import numpy as np
import optax
import pytest

import jax
import jax.numpy as jnp
import torch

from paddlebox_tpu.config import flags_scope as j_flags_scope
from paddlebox_tpu.data import DataFeedDesc as JDesc
from paddlebox_tpu.data import DatasetFactory as JFactory
from paddlebox_tpu.models import CtrDnn as JCtrDnn
from paddlebox_tpu.parallel import make_mesh
from paddlebox_tpu.ps import SparseSGDConfig as JCfg
from paddlebox_tpu.ps.multi_mf_sharded import \
    MultiMfShardedTable as JMmfSharded
from paddlebox_tpu.train.multi_mf_sharded import \
    MultiMfShardedTrainer as JMmfShardedTrainer

from paddlebox_tpu_torch import convert
from paddlebox_tpu_torch.config import flags_scope
from paddlebox_tpu_torch.data import DataFeedDesc, DatasetFactory
from paddlebox_tpu_torch.data.criteo import generate_criteo_files
from paddlebox_tpu_torch.models import CtrDnn
from paddlebox_tpu_torch.ps import (BoxPSHelper, MultiMfEmbeddingTable,
                                    MultiMfShardedTable,
                                    MultiMfTieredShardedTable,
                                    SparseSGDConfig)
from paddlebox_tpu_torch.train import MultiMfShardedTrainer, MultiMfTrainer

from test_torch_sharded import _assert_plan_equal

N = 4
HIDDEN = (16, 8)
STATE_RTOL, STATE_ATOL = 2e-4, 2e-5
CFG = dict(mf_create_thresholds=0.0, mf_initial_range=0.0,
           learning_rate=0.05, mf_learning_rate=0.05)
SEQPOOL = {"xla": False, "pallas": True}


def _dims():
    return [2] * 10 + [4] * 10 + [8] * 6   # three dim classes


@pytest.fixture(scope="module")
def criteo_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("criteo_tmmfs")
    return generate_criteo_files(str(d), num_files=2, rows_per_file=1500,
                                 vocab_per_slot=40, seed=19)


def _ds(files, bs=32, factory=DatasetFactory, desc_cls=DataFeedDesc):
    desc = desc_cls.criteo(batch_size=bs)
    desc.key_bucket_min = 1024
    ds = factory().create_dataset("InMemoryDataset", desc)
    ds.set_filelist(files)
    ds.load_into_memory()
    return ds, desc


class _Batches:
    def __init__(self, batches):
        self._b = list(batches)

    def batches(self):
        return iter(self._b)


def _cfg():
    return SparseSGDConfig(**CFG)


def _model(state=None):
    """CtrDnn with the reference's init (glorot-uniform kernels, zero
    biases, seeded) unless ``state`` gives the params."""
    width = MultiMfShardedTable(1, _dims(), capacity_per_shard=8,
                                devices="cpu").pooled_width()
    torch.manual_seed(0)
    m = CtrDnn(1, width, 13, hidden=HIDDEN, compute_dtype=torch.float32)
    for layer in [*m.hidden, m.out]:
        torch.nn.init.xavier_uniform_(layer.weight)
        torch.nn.init.zeros_(layer.bias)
    if state is not None:
        m.load_state_dict(state)
    return m


def _adam(p):
    return torch.optim.Adam(p, lr=1e-2, eps=1e-8)


def _sharded(cap=2048, bucket=256, cls=MultiMfShardedTable, **kw):
    return cls(N, _dims(), capacity_per_shard=cap, cfg=_cfg(),
               req_bucket_min=bucket, serve_bucket_min=bucket,
               devices="cpu", **kw)


def _trainer(table, desc, state=None, **kw):
    return MultiMfShardedTrainer(_model(state), table, desc, tx=_adam,
                                 seed=3, **kw)


def _one_thread(fn):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return fn()
    finally:
        torch.set_num_threads(threads)


def _class_logical(t):
    """(keys sorted, rows) of a port sharded class table."""
    keys, rows = [], []
    for s in range(t.n):
        k, r = t.indexes[s].items()
        keys.append(k)
        rows.append(t._rows_host(s, r))
    keys = np.concatenate(keys)
    order = np.argsort(keys)
    return keys[order], np.concatenate(rows)[order]


def _jax_class_logical(t):
    data = np.asarray(jax.device_get(t.state.data))
    keys, rows = [], []
    for s in range(t.n):
        k, r = t.indexes[s].items()
        keys.append(k)
        rows.append(data[s][r])
    keys = np.concatenate(keys)
    order = np.argsort(keys)
    return keys[order], np.concatenate(rows)[order]


# ---------------------------------------------------------------------------
# the reference's tests on the port
# ---------------------------------------------------------------------------

def test_mmf_sharded_routing_and_slot_field(criteo_files):
    """Keys route to their slot's class table and, inside it, to their
    key%N owner shard; serve_slot carries GLOBAL slot ids."""
    ds, desc = _ds(criteo_files)
    table = _sharded(bucket=64)
    group = list(ds.batches())[:N]
    plans = table.prepare_global(group)
    assert len(plans) == 3
    for b in group:
        slots = b.segments[:b.num_keys] % b.num_slots
        for k, sl in zip(b.keys[:b.num_keys], slots):
            c = table.class_of_slot[sl]
            assert table.tables[c].indexes[int(k) % N].lookup(
                np.array([k], np.uint64))[0] >= 0
    for c, p in enumerate(plans):
        valid = p.serve_slot[p.serve_valid > 0].astype(int)
        assert np.isin(valid, table.class_slots[c]).all()


def test_mmf_sharded_e2e_learns_and_matches_single_chip(criteo_files):
    """N = 4 multi-mf training with 3 dim classes learns the planted
    signal as the single-table trainer does on the same data, and the
    pulled values keep per-slot widths."""
    ds, desc = _ds(criteo_files)
    sh_table = _sharded()
    tr_m = _trainer(sh_table, desc)
    sc_table = MultiMfEmbeddingTable(_dims(), capacity=1 << 12, cfg=_cfg(),
                                     device="cpu")
    tr_s = MultiMfTrainer(_model(tr_m.model.state_dict()), sc_table, desc,
                          tx=_adam, seed=3)
    for _ in range(4):
        rs = tr_s.train_pass(ds)
    for _ in range(6):
        rm = tr_m.train_pass(ds)
    assert np.isfinite(rm["last_loss"])
    assert rs["auc"] > 0.60, rs["auc"]
    assert rm["auc"] > 0.60, rm["auc"]
    assert rm["auc"] > rs["auc"] - 0.08, (rm["auc"], rs["auc"])
    assert all(t.feature_count() > 0 for t in sh_table.tables)
    ds.columnarize()
    col = ds.columnar
    keys = col.keys[:100].astype(np.uint64)
    slots = col.key_slot[:100]
    vals = sh_table.pull(keys, slots)
    assert vals.shape == (100, 3 + 8)
    dims = np.asarray(_dims())
    for i in range(100):
        np.testing.assert_allclose(vals[i, 3 + dims[slots[i]]:], 0.0)
    assert (vals[:, 0] > 0).all()


def test_mmf_sharded_save_load_roundtrip(criteo_files, tmp_path):
    """save_base → a fresh sharded table loads it; a single-table
    ``MultiMfEmbeddingTable`` loads the same files; all pull alike."""
    ds, desc = _ds(criteo_files)
    table = _sharded()
    tr = _trainer(table, desc)
    tr.train_pass(_Batches(list(ds.batches())[:16]))
    path = str(tmp_path / "mmf_sharded")
    n = table.save_base(path)
    assert n == table.feature_count() > 0
    t2 = _sharded()
    assert t2.load(path) == n
    single = MultiMfEmbeddingTable(_dims(), capacity=1 << 12, cfg=_cfg(),
                                   device="cpu")
    assert single.load(path) == n
    ds.columnarize()
    col = ds.columnar
    keys = col.keys[:200].astype(np.uint64)
    slots = col.key_slot[:200]
    want = table.pull(keys, slots)
    np.testing.assert_array_equal(t2.pull(keys, slots), want)
    np.testing.assert_array_equal(single.pull(keys, slots), want)


def _offset_pass(tmp_path, pass_id, vocab=40, rows=600):
    """Criteo files with per-pass disjoint value ranges (fresh features
    each pass, the day-k workload of the tiered window)."""
    rng = np.random.default_rng(300 + pass_id)
    d = tmp_path / f"mmfoff{pass_id}"
    os.makedirs(str(d), exist_ok=True)
    path = str(d / "part.txt")
    base = pass_id * vocab
    with open(path, "w") as fh:
        for _ in range(rows):
            dense = rng.integers(0, 100, size=13)
            cats = base + rng.integers(0, vocab, size=26)
            label = int(rng.random() < 0.5)
            fh.write(f"{label}\t" + "\t".join(str(int(v)) for v in dense)
                     + "\t" + "\t".join(format(int(c), "x") for c in cats)
                     + "\n")
    return _ds([path])


def test_mmf_tiered_full_cross_product(tmp_path):
    """Per-slot dims x tiering x sharding: 3 dim classes, 3 disjoint
    day-passes, windows far below the union — the host tiers carry the
    whole model across the windows, and save/load round-trips it."""
    built = [_offset_pass(tmp_path, p) for p in range(3)]
    desc = built[0][1]
    table = _sharded(cap=128, bucket=64, cls=MultiMfTieredShardedTable)
    tr = _trainer(table, desc)
    helper = BoxPSHelper(table, trainer=tr)
    for ds, _ in built:
        helper.begin_pass(ds)
        r = tr.train_pass(ds)
        assert np.isfinite(r["last_loss"])
        helper.end_pass(ds)
    total = table.feature_count()
    assert total > 2000, total
    for t in table.tables:
        for s in range(N):
            assert len(t.indexes[s]) <= t.capacity
    ds0 = built[0][0]
    ds0.columnarize()
    col = ds0.columnar
    keys = col.keys[:60].astype(np.uint64)
    slots = col.key_slot[:60]
    vals = table.pull(keys, slots)
    dims = np.asarray(_dims())
    assert (vals[:, 0] > 0).all()   # pass 0's show counters persisted
    for i in range(60):
        np.testing.assert_allclose(vals[i, 3 + dims[slots[i]]:], 0.0)
    path = str(tmp_path / "mmf_tiered")
    n = table.save_base(path)
    assert n == total
    t2 = _sharded(cap=128, bucket=64, cls=MultiMfTieredShardedTable)
    assert t2.load(path) == n
    np.testing.assert_array_equal(t2.pull(keys, slots),
                                  table.pull(keys, slots))
    stats = table.endpass_stats()
    parts = [t.endpass_stats() for t in table.tables]
    for k, v in stats.items():
        vals_k = [p[k] for p in parts]
        assert v == (max(vals_k) if k == "last_writeback_sec"
                     else sum(vals_k)), k


def test_mmf_tiered_overlap_stage_and_delta(tmp_path):
    """stage_pass during an OPEN pass fans out per dim class, and the
    next begin_pass consumes a pure per-class delta when the working set
    repeats."""
    ds, desc = _ds(generate_criteo_files(
        str(tmp_path / "ovl"), num_files=1, rows_per_file=800,
        vocab_per_slot=40, seed=77))
    table = _sharded(bucket=64, cls=MultiMfTieredShardedTable)
    tr = _trainer(table, desc)
    helper = BoxPSHelper(table, trainer=tr)
    helper.begin_pass(ds)
    assert sum(t.last_pass_stats["staged"] for t in table.tables) > 0
    helper.stage_pass(ds)
    r1 = tr.train_pass(ds)
    helper.end_pass(ds)
    helper.begin_pass(ds)
    for t in table.tables:
        st = t.last_pass_stats
        assert st["staged"] == 0, st
        assert st["resident"] > 0, st
    r2 = tr.train_pass(ds)
    helper.end_pass(ds)
    assert np.isfinite(r1["last_loss"]) and np.isfinite(r2["last_loss"])
    # a stage larger than a class's window raises before any class stages
    small = _sharded(cap=8, bucket=64, cls=MultiMfTieredShardedTable)
    with pytest.raises(ValueError, match="exceeds capacity_per_shard"):
        small.stage(*ds.pass_key_slots())
    assert all(t._stage is None and t._stage_thread is None
               for t in small.tables)


def test_mmf_tiered_matches_untiered(tmp_path):
    """Tiering stays TRANSPARENT under multi-mf: when everything fits,
    the tiered table equals the plain one trained straight through, bit
    for bit."""
    ds, desc = _ds(generate_criteo_files(
        str(tmp_path / "flat"), num_files=1, rows_per_file=800,
        vocab_per_slot=30, seed=23))

    def run():
        plain = _sharded(bucket=128)
        tr_a = _trainer(plain, desc)
        tiered = _sharded(bucket=128, cls=MultiMfTieredShardedTable)
        tr_b = _trainer(tiered, desc, state=tr_a.model.state_dict())
        helper = BoxPSHelper(tiered, trainer=tr_b)
        for _ in range(2):
            ra = tr_a.train_pass(ds)
            helper.begin_pass(ds)
            rb = tr_b.train_pass(ds)
            helper.end_pass(ds)
        return plain, tr_a, ra, tiered, tr_b, rb

    plain, tr_a, ra, tiered, tr_b, rb = _one_thread(run)
    assert rb["auc"] == ra["auc"]
    for k, v in tr_a.model.state_dict().items():
        assert torch.equal(v, tr_b.model.state_dict()[k]), k
    ds.columnarize()
    col = ds.columnar
    keys = col.keys.astype(np.uint64)
    slots = col.key_slot
    np.testing.assert_array_equal(tiered.pull(keys, slots),
                                  plain.pull(keys, slots))


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def both_groups(criteo_files):
    """Two global batches of N local batches as each package builds
    them."""
    jds, jdesc = _ds(criteo_files, factory=JFactory, desc_cls=JDesc)
    tds, tdesc = _ds(criteo_files)
    jb, tb = list(jds.batches())[:2 * N], list(tds.batches())[:2 * N]
    for j, t in zip(jb, tb):
        np.testing.assert_array_equal(t.keys, j.keys)
    return jb, tb, jdesc, tdesc


@pytest.fixture(scope="module")
def jax_runs(both_groups):
    """The reference's trainer over the two global batches per seqpool
    route: its start params, plans, class tables, params and result."""
    jb, _, jdesc, _ = both_groups
    mesh = make_mesh(N)
    out = {}
    for route, flag in SEQPOOL.items():
        with j_flags_scope(use_pallas_seqpool=flag):
            table = JMmfSharded(N, _dims(), capacity_per_shard=2048,
                                cfg=JCfg(**CFG), req_bucket_min=256,
                                serve_bucket_min=256)
            plans = JMmfSharded(N, _dims(), capacity_per_shard=2048,
                                cfg=JCfg(**CFG), req_bucket_min=256,
                                serve_bucket_min=256).prepare_global(jb[:N])
            tr = JMmfShardedTrainer(
                JCtrDnn(hidden=HIDDEN, compute_dtype=jnp.float32), table,
                jdesc, mesh, tx=optax.adam(1e-2), seed=3)
            start = convert.ctr_dnn_state_dict_from_flax(
                jax.device_get(tr.state.params))
            res = tr.train_pass(_Batches(jb))
            out[route] = dict(
                start=start, plans=plans, res=res, table=table,
                tables=[_jax_class_logical(t) for t in table.tables],
                params=convert.ctr_dnn_state_dict_from_flax(
                    jax.device_get(tr.state.params)))
    return out


def test_mmf_sharded_plans_match_jax(jax_runs, both_groups):
    """The first global batch's per-class plans, serve_slot's GLOBAL
    slot ids included, array for array."""
    _, tb, _, _ = both_groups
    got = _sharded().prepare_global(tb[:N])
    for g, w in zip(got, jax_runs["xla"]["plans"]):
        _assert_plan_equal(g, w)


@pytest.mark.parametrize("route", sorted(SEQPOOL))
def test_mmf_sharded_two_steps_match_jax(route, jax_runs, both_groups):
    _, tb, _, tdesc = both_groups
    j = jax_runs[route]
    table = _sharded()
    tr = _trainer(table, tdesc, state=j["start"])
    res = tr.train_pass(_Batches(tb))
    assert res["batches"] == j["res"]["batches"] == 2
    np.testing.assert_allclose(res["auc"], j["res"]["auc"], rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(res["last_loss"], j["res"]["last_loss"],
                               rtol=STATE_RTOL)
    for t, (jk, jr) in zip(table.tables, j["tables"]):
        k, r = _class_logical(t)
        np.testing.assert_array_equal(k, jk)
        # show, clk, slot
        np.testing.assert_array_equal(r[:, [0, 1, 3]], jr[:, [0, 1, 3]])
        np.testing.assert_array_equal(r[:, 7], jr[:, 7])    # mf_size
        np.testing.assert_allclose(r, jr, rtol=STATE_RTOL, atol=STATE_ATOL)
        assert (r[:, 7] > 0).any()                          # lazy mf ran
    sd = tr.model.state_dict()
    for k, w in j["params"].items():
        np.testing.assert_allclose(sd[k].numpy(), w.numpy(),
                                   rtol=STATE_RTOL, atol=STATE_ATOL,
                                   err_msg=k)


def test_overlap_order_equals_sequential(both_groups):
    """``a2a_chunks > 1`` (the overlapped push order) gives the
    sequential order's bits."""
    _, tb, _, tdesc = both_groups

    def run(chunks):
        with flags_scope(a2a_chunks=chunks):
            table = _sharded()
            tr = _trainer(table, tdesc)
        assert tr.step_fn.a2a_overlap == (chunks > 1)
        tr.train_pass(_Batches(tb))
        return tr

    a, b = _one_thread(lambda: (run(1), run(4)))
    for k, v in a.model.state_dict().items():
        assert torch.equal(v, b.model.state_dict()[k]), k
    for ta, tb_ in zip(a.table.tables, b.table.tables):
        for sa, sb in zip(ta.states, tb_.states):
            assert torch.equal(sa.data, sb.data)


def test_convert_carries_jax_sharded_class_tables(jax_runs, both_groups):
    """``convert.multi_mf_blobs_from_packed`` + ``load_multi_mf`` carry
    the reference's trained sharded class tables into the port: every
    shard's keys, rows and values exact, the same pulls."""
    _, tb, _, _ = both_groups
    jt = jax_runs["xla"]["table"]
    blobs = convert.multi_mf_blobs_from_packed(
        [(jax.device_get(t.state.packed),
          [t.indexes[s].items() for s in range(N)], t.capacity, t.mf_dim)
         for t in jt.tables])
    port = _sharded()
    assert convert.load_multi_mf(port, blobs) == jt.feature_count()
    for t, j in zip(port.tables, jt.tables):
        k, r = _class_logical(t)
        jk, jr = _jax_class_logical(j)
        np.testing.assert_array_equal(k, jk)
        np.testing.assert_array_equal(r, jr)
        for s in range(N):
            jk_s, jr_s = j.indexes[s].items()
            np.testing.assert_array_equal(t.indexes[s].lookup(jk_s), jr_s)
    keys = np.concatenate([b.keys[:b.num_keys] for b in tb])
    slots = np.concatenate([(b.segments[:b.num_keys] % b.num_slots)
                            for b in tb]).astype(np.int32)
    np.testing.assert_array_equal(port.pull(keys, slots),
                                  jt.pull(keys, slots))
