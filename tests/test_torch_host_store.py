"""The port's host tier (``ps/host_store.py``), SSD tier (``ps/ssd.py``),
asynchronous epilogue (``ps/epilogue.py``), single-table window
(``ps/pass_table.py``) and ``BoxPSHelper`` against the JAX package's, on
the CPU: the counterparts of ``tests/test_pass_lifecycle.py``,
``tests/test_shrink_fence.py`` and the two epilogue fence cases of
``tests/test_streaming.py``, plus the cross-package segment files.

Host-tier operations are numpy in both packages and compare exactly
(fetched fields, save files array for array, segment files byte for
byte, manifest digests). The two-pass ``BoxPSHelper`` run against the
reference's holds the ragged train-state class (rtol 2e-4 / atol 2e-5)
and the AUC within 1e-5, with lazy mf drawing zeros on both sides.
"""

import os
import threading
import time

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from paddlebox_tpu.config import flags_scope as j_flags_scope
from paddlebox_tpu.data import DataFeedDesc as JDesc
from paddlebox_tpu.data import DatasetFactory as JFactory
from paddlebox_tpu.data.criteo import generate_criteo_files
from paddlebox_tpu.models import CtrDnn as JCtrDnn
from paddlebox_tpu.ps import BoxPSHelper as JHelper
from paddlebox_tpu.ps import HostStore as JHost
from paddlebox_tpu.ps import PassScopedTable as JPassTable
from paddlebox_tpu.ps import SparseSGDConfig as JCfg
from paddlebox_tpu.ps import ssd as jssd
from paddlebox_tpu.train import Trainer as JTrainer

from paddlebox_tpu_torch import convert
from paddlebox_tpu_torch.config import flags_scope
from paddlebox_tpu_torch.data import DataFeedDesc
from paddlebox_tpu_torch.data.dataset import DatasetFactory
from paddlebox_tpu_torch.models import CtrDnn
from paddlebox_tpu_torch.ps import (BoxPSHelper, EmbeddingTable, HostStore,
                                    PassScopedTable, SparseAdamConfig,
                                    SparseSGDConfig)
from paddlebox_tpu_torch.ps import ssd as tssd
from paddlebox_tpu_torch.ps.epilogue import PassEpilogue, PipelineHangError
from paddlebox_tpu_torch.ps.host_store import FIELDS
from paddlebox_tpu_torch.ps.sgd import opt_ext_width
from paddlebox_tpu_torch.ps.table import FIELD_COL
from paddlebox_tpu_torch.train.checkpoint import (CheckpointCorruptError,
                                                  CheckpointManager)
from paddlebox_tpu_torch.train.trainer import Trainer

STATE_RTOL, STATE_ATOL = 2e-4, 2e-5


def _rows(n, v, mf_dim=2):
    return {f: np.full((n, mf_dim) if f == "embedx_w" else (n,), v,
                       np.float32) for f in FIELDS}


def _both(fn):
    """``fn(HostStore, tag)`` on the port's store class and the
    reference's; returns both results."""
    return fn(HostStore, "t"), fn(JHost, "j")


def _assert_fields_equal(a, b):
    assert sorted(a) == sorted(b)
    for f in a:
        np.testing.assert_array_equal(a[f], b[f], err_msg=f)


def _window(table, keys):
    """The window rows of ``keys`` as a host array."""
    return table.state.data.numpy()[table.index.lookup(keys)]


def _pass_table(hs, cap=64, cfg=None, **kw):
    return PassScopedTable(hs, pass_capacity=cap,
                           cfg=cfg or SparseSGDConfig(), device="cpu", **kw)


# ---------------------------------------------------------------------------
# HostStore (tests/test_pass_lifecycle.py)
# ---------------------------------------------------------------------------

def test_host_store_fetch_update_roundtrip():
    def run(cls, _):
        hs = cls(mf_dim=4, capacity=1 << 12, init_rows=8)
        keys = np.array([10, 20, 30], np.uint64)
        got = hs.fetch(keys)
        assert got["embed_w"].shape == (3,)
        assert got["embedx_w"].shape == (3, 4)
        np.testing.assert_allclose(got["embed_w"], 0.0)
        hs.update(keys, {f: np.full_like(v, 2.0) for f, v in got.items()})
        many = np.arange(100, 600, dtype=np.uint64)
        hs.update(many, {f: np.ones((500, 4) if f == "embedx_w" else (500,),
                                    np.float32) for f in got})
        back = hs.fetch(np.concatenate([keys, many]))
        np.testing.assert_allclose(back["embed_w"][:3], 2.0)
        assert len(hs) == 503
        return back

    _assert_fields_equal(*_both(run))


def test_host_store_save_delta_and_shrink(tmp_path):
    def run(cls, tag):
        hs = cls(mf_dim=2, capacity=1 << 10)
        hs.update(np.array([1, 2, 3], np.uint64), _rows(3, 1.0))
        base = str(tmp_path / f"{tag}base.npz")
        assert hs.save_base(base) == 3
        k2 = np.array([4, 5], np.uint64)
        hs.update(k2, _rows(2, 2.0))
        delta = str(tmp_path / f"{tag}delta.npz")
        assert hs.save_delta(delta) == 2
        hs2 = cls(mf_dim=2, capacity=1 << 10)
        assert hs2.load(base) == 3
        assert hs2.load(delta, merge=True) == 2
        np.testing.assert_allclose(hs2.fetch(k2)["embed_w"], 2.0)
        hs2.update(np.array([9], np.uint64), _rows(1, 0.0))
        assert hs2.shrink(delete_threshold=0.05, decay=1.0) == 1
        assert len(hs2) == 5
        return hs2.export_rows()

    (tk, tf), (jk, jf) = _both(run)
    np.testing.assert_array_equal(tk, jk)
    _assert_fields_equal(tf, jf)
    for name in ("base", "delta"):
        a = np.load(str(tmp_path / f"t{name}.npz"))
        b = np.load(str(tmp_path / f"j{name}.npz"))
        _assert_fields_equal(dict(a), dict(b))


def test_host_store_disk_tier(tmp_path):
    """spill_cold → load_from_disk (RAM wins over a stale spilled copy),
    subset promotion; each package's spill file loads into the other's
    store."""
    keys = np.arange(1, 21, dtype=np.uint64)
    data = _rows(20, 0.0)
    data["embedx_w"] = np.random.default_rng(0).normal(
        size=(20, 2)).astype(np.float32)
    data["show"][:10] = 100.0
    data["clk"][:10] = 5.0
    data["embed_w"][:] = np.arange(20, dtype=np.float32) + 1

    def run(cls, tag):
        hs = cls(mf_dim=2, capacity=1 << 12)
        hs.update(keys, data)
        ssd = str(tmp_path / f"{tag}cold.npz")
        assert hs.spill_cold(ssd, threshold=1.0) == 0
        hs.save_base(str(tmp_path / f"{tag}b0.npz"))
        assert hs.spill_cold(ssd, threshold=1.0) == 10 and len(hs) == 10
        full = str(tmp_path / f"{tag}full.npz")
        assert hs.save_base(full) == 20
        assert len(np.unique(np.load(full)["keys"])) == 20
        assert (hs.index.lookup(keys[10:]) == -1).all()
        upd = {f: data[f][:1].copy() for f in data}
        upd["embed_w"][0] = 999.0
        hs.update(keys[:1], upd)
        assert hs.load_from_disk(ssd) == 10 and len(hs) == 20
        vals = hs.fetch(keys)
        np.testing.assert_allclose(vals["embed_w"][0], 999.0)
        np.testing.assert_allclose(vals["embed_w"][10:],
                                   np.arange(10, 20) + 1)
        return vals

    _assert_fields_equal(*_both(run))
    # a fresh store of either package adopts the other's spill file
    for cls, other in ((HostStore, "j"), (JHost, "t")):
        hs2 = cls(mf_dim=2, capacity=1 << 12)
        assert hs2.load_from_disk(str(tmp_path / f"{other}cold.npz"),
                                  keys=keys[10:13]) == 3
        np.testing.assert_array_equal(hs2.fetch(keys[10:13])["embedx_w"],
                                      data["embedx_w"][10:13])


def test_disk_tier_read_through_and_no_resurrection(tmp_path):
    """fetch() promotes spilled keys; shrink ages RAM and spilled rows
    alike, and nothing it dropped resurrects; a duplicate spill path is
    refused; a reset load forgets the old spill registration."""
    keys = np.arange(1, 11, dtype=np.uint64)

    def run(cls, tag):
        hs = cls(mf_dim=2, capacity=1 << 12)
        hs.update(keys, _rows(10, 3.0))
        hs.save_base(str(tmp_path / f"{tag}b.npz"))
        ssd = str(tmp_path / f"{tag}s1.npz")
        assert hs.spill_cold(ssd, threshold=1e9) == 10 and len(hs) == 0
        with pytest.raises(ValueError):
            hs.spill_cold(ssd, threshold=1e9)
        got = hs.fetch(keys[:3])
        np.testing.assert_allclose(got["embed_w"], 3.0)
        assert len(hs) == 3
        hs._arr["show"][hs.index.lookup(keys[:1])] = 0.0
        assert hs.shrink(delete_threshold=0.0, decay=1.0) == 0
        assert hs.shrink(delete_threshold=10.0, decay=1.0) == 10
        full = str(tmp_path / f"{tag}full.npz")
        assert hs.save_base(full) == 0
        assert keys[0] not in np.load(full)["keys"]
        hs.load(str(tmp_path / f"{tag}b.npz"), merge=False)
        assert hs._spill_files == []
        return hs.export_rows()

    (tk, tf), (jk, jf) = _both(run)
    np.testing.assert_array_equal(np.sort(tk), np.sort(jk))


def test_spill_stale_copy_never_shadows_fresh_state(tmp_path):
    def run(cls, tag):
        hs = cls(mf_dim=2, capacity=1 << 12)
        k12 = np.array([1, 2], np.uint64)
        hs.update(k12, _rows(2, 1.0))
        hs.save_base(str(tmp_path / f"{tag}b.npz"))
        assert hs.spill_cold(str(tmp_path / f"{tag}f1.npz"),
                             threshold=1e9) == 2
        hs.fetch(np.array([2], np.uint64))
        hs.update(np.array([2], np.uint64), _rows(1, 7.0))
        hs.save_base(str(tmp_path / f"{tag}b2.npz"))
        assert hs.spill_cold(str(tmp_path / f"{tag}f2.npz"),
                             threshold=1e9) == 1
        got = hs.fetch(k12)
        np.testing.assert_allclose(got["embed_w"], [1.0, 7.0])
        return got

    _assert_fields_equal(*_both(run))


# ---------------------------------------------------------------------------
# PassScopedTable (tests/test_pass_lifecycle.py)
# ---------------------------------------------------------------------------

def test_pass_scoped_table_promote_and_writeback():
    hs = HostStore(mf_dim=4, capacity=1 << 12)
    t = _pass_table(hs)
    keys = np.array([7, 8, 9], np.uint64)
    t.begin_pass(keys)
    assert t.in_pass and t.feature_count == 3
    rows = t.index.lookup(keys)
    t.state.data[torch.from_numpy(rows.astype(np.int64)), 0] = 5.0
    t._touched[rows] = True
    t.end_pass()
    assert not t.in_pass
    np.testing.assert_allclose(hs.fetch(keys)["show"], 5.0)
    t.begin_pass(np.array([8, 9, 11], np.uint64))
    assert _window(t, np.array([8], np.uint64))[0, 0] == 5.0
    t.end_pass()


def test_pass_scoped_delta_staging():
    """The persistent window: an overlapping pass stages only the new
    keys, resident rows keep their values, and every count and window
    row equals the reference's."""
    def run(table, jax_side):
        k1 = np.arange(0, 100, dtype=np.uint64)
        table.begin_pass(k1)
        s1 = dict(table.last_pass_stats)
        rows = table.index.lookup(k1)
        if jax_side:
            d = np.asarray(table.state.data).copy()
            d[rows, FIELD_COL["embed_w"]] = 4.25
            table.state = type(table.state).from_logical(
                d, table.state.capacity)
        else:
            table.state.data[torch.from_numpy(rows.astype(np.int64)),
                             FIELD_COL["embed_w"]] = 4.25
        table._touched[rows] = True
        assert table.end_pass() == 100
        table.begin_pass(np.arange(50, 150, dtype=np.uint64))
        s2 = dict(table.last_pass_stats)
        data = np.asarray(table.state.data)
        k = np.array([60], np.uint64)
        out = (s1, s2, data[table.index.lookup(k)][0],
               table.index.lookup(np.arange(0, 150, dtype=np.uint64)))
        table.end_pass()
        return out + (table.last_pass_stats["written_back"],)

    t = _pass_table(HostStore(mf_dim=2, capacity=1 << 12), cap=256)
    jt = JPassTable(JHost(mf_dim=2, capacity=1 << 12), pass_capacity=256,
                    cfg=JCfg())
    got, want = run(t, False), run(jt, True)
    keys = ("staged", "resident", "evicted", "evicted_writeback")
    for a, b in ((got[0], want[0]), (got[1], want[1])):
        assert {k: a[k] for k in keys} == {k: b[k] for k in keys}
    assert got[1]["staged"] == 50 and got[1]["resident"] == 50
    assert got[2][FIELD_COL["embed_w"]] == 4.25
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(got[3], want[3])
    assert got[4] == want[4] == 0


def test_pass_capacity_guard():
    t = _pass_table(HostStore(mf_dim=2, capacity=1 << 12), cap=4)
    with pytest.raises(ValueError):
        t.begin_pass(np.arange(10, dtype=np.uint64))


def test_stage_guards():
    t = _pass_table(HostStore(mf_dim=2, capacity=1 << 12))
    t.begin_pass(np.array([1, 2], np.uint64))
    t.stage(np.array([3], np.uint64), background=False)
    with pytest.raises(RuntimeError, match="already staging"):
        t.stage(np.array([4], np.uint64))
    t.end_pass()
    with pytest.raises(RuntimeError, match="differ"):
        t.begin_pass(np.array([1, 3], np.uint64))
    t._stage = None
    t.begin_pass(np.array([1, 2], np.uint64))
    with pytest.raises(RuntimeError, match="pass is open"):
        t.drop_window()
    t.end_pass()


def test_slot_survives_pass_roundtrip_without_prepare():
    """Slot metadata survives a window no prepare() visits, and a later
    window over other keys does not inherit stale slot_host entries."""
    def run(cls, tcls, **kw):
        hs = cls(mf_dim=4, capacity=1 << 12)
        keys = np.array([7, 8, 9], np.uint64)
        d = _rows(3, 0.0, mf_dim=4)
        d["slot"] = np.array([3.0, 4.0, 5.0], np.float32)
        hs.update(keys, d)
        t = tcls(hs, pass_capacity=64, **kw)
        t.begin_pass(keys)
        t.end_pass()
        np.testing.assert_allclose(hs.fetch(keys)["slot"], [3.0, 4.0, 5.0])
        k2 = np.array([21, 22], np.uint64)
        t.begin_pass(k2)
        t.end_pass()
        np.testing.assert_allclose(hs.fetch(k2)["slot"], 0.0)
        return hs.export_rows(clear_touched=False)

    (tk, tf) = run(HostStore, PassScopedTable, cfg=SparseSGDConfig(),
                   device="cpu")
    (jk, jf) = run(JHost, JPassTable, cfg=JCfg())
    np.testing.assert_array_equal(tk, jk)
    _assert_fields_equal(tf, jf)


def test_pass_scoped_table_sparse_adam_state_survives():
    """The optimizer extension (moments, beta powers) round-trips
    HostStore → window → HostStore; a store without it is refused."""
    cfg = SparseAdamConfig(mf_create_thresholds=0.0, mf_initial_range=0.0)
    ext = opt_ext_width(cfg, 4)
    hs = HostStore(mf_dim=4, capacity=1 << 12, opt_ext=ext)
    t = _pass_table(hs, cfg=cfg)
    keys = np.array([7, 8, 9], np.uint64)
    t.begin_pass(keys)
    rows = t.index.lookup(keys)
    mf_end = 8 + 4
    t.state.data[torch.from_numpy(rows.astype(np.int64)), mf_end + 1] = 0.81
    t._touched[rows] = True
    t.end_pass()
    held = t.state.data
    t.drop_window()
    assert t.state.data is held and not held.any()
    t.begin_pass(keys)
    np.testing.assert_allclose(_window(t, keys)[:, mf_end + 1], 0.81)
    t.end_pass()
    with pytest.raises(ValueError, match="extension block"):
        _pass_table(HostStore(mf_dim=4, capacity=1 << 12), cfg=cfg)


@pytest.fixture(scope="module")
def criteo_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("criteo_pass")
    return generate_criteo_files(str(d), num_files=4, rows_per_file=2500,
                                 vocab_per_slot=40, seed=11)


def _helper_run(criteo_files, tmp_path, kind, params0=None):
    """Two passes through BoxPSHelper (day 2 preloaded while day 1
    trains, a delta saved at end_pass): ``kind`` "jax" (the reference),
    "port", or "plain" (the port's Trainer on a plain EmbeddingTable,
    no window)."""
    cfg = dict(mf_create_thresholds=0.0, mf_initial_range=0.0,
               learning_rate=0.1, mf_learning_rate=0.1)
    if kind == "jax":
        desc = JDesc.criteo(batch_size=128)
        desc.key_bucket_min = 4096
        hs = JHost(mf_dim=8, capacity=1 << 16)
        table = JPassTable(hs, pass_capacity=1 << 13, cfg=JCfg(**cfg),
                           unique_bucket_min=4096)
        tr = JTrainer(JCtrDnn(hidden=(32, 32), compute_dtype=jnp.float32),
                      table, desc, tx=optax.adam(2e-3))
        helper, factory = JHelper(table, trainer=tr), JFactory()
        params0 = convert.ctr_dnn_state_dict_from_flax(
            jax.device_get(tr.state.params))
    else:
        desc = DataFeedDesc.criteo(batch_size=128)
        desc.key_bucket_min = 4096
        hs = HostStore(mf_dim=8, capacity=1 << 16)
        if kind == "port":
            table = PassScopedTable(hs, pass_capacity=1 << 13,
                                    cfg=SparseSGDConfig(**cfg),
                                    unique_bucket_min=4096, device="cpu")
        else:
            table = EmbeddingTable(mf_dim=8, capacity=1 << 13,
                                   cfg=SparseSGDConfig(**cfg),
                                   unique_bucket_min=4096, device="cpu")
        model = CtrDnn(26, 3 + 8, 13, hidden=(32, 32),
                       compute_dtype=torch.float32)
        model.load_state_dict(params0)
        tr = Trainer(model, table, desc,
                     tx=lambda p: torch.optim.Adam(p, lr=2e-3, eps=1e-8),
                     device="cpu")
        helper, factory = BoxPSHelper(table, trainer=tr), DatasetFactory()

    def params():
        return (convert.ctr_dnn_state_dict_from_flax(
            jax.device_get(tr.state.params)) if kind == "jax"
            else {k: v.clone() for k, v in tr.model.state_dict().items()})

    def rows():
        if kind == "plain":
            keys, r = table.index.items()
            return keys, table._gather_host(r)
        return hs.export_rows(clear_touched=False)

    def new_ds(files):
        ds = factory.create_dataset("PaddleBoxDataset", desc)
        if kind != "plain":
            helper.attach(ds)
        ds.set_filelist(files)
        ds.set_thread(1)
        return ds

    out = dict(params0=params0)
    ds1 = new_ds(criteo_files[:2])
    helper.read_data_to_memory(ds1)
    ds1.begin_pass()
    n1 = table.feature_count
    ds2 = new_ds(criteo_files[2:])
    helper.preload_into_memory(ds2)
    r1 = tr.train_pass(ds1)
    if kind == "plain":
        tr.sync_table()
    else:
        delta = str(tmp_path / f"{kind}p1_delta.npz")
        helper.end_pass(ds1, need_save_delta=True, delta_path=delta)
        assert os.path.exists(delta) and len(hs) >= n1 > 50
        out["delta_keys"] = np.sort(np.load(delta)["keys"])
    out.update(r1=r1, params1=params(), rows1=rows())
    helper.wait_feed_pass_done(ds2)
    ds2.begin_pass()
    tr.reset_metrics()
    r2 = tr.train_pass(ds2)
    ds2.end_pass()
    assert np.isfinite(r1["last_loss"]) and np.isfinite(r2["last_loss"])
    assert r2["auc"] > r1["auc"] > 0.5, (r1["auc"], r2["auc"])
    if kind != "plain":
        base = str(tmp_path / f"{kind}base.npz")
        assert helper.save_base(base) == len(hs)
    out.update(r2=r2, params2=params(), rows2=rows())
    return out


def _sorted_rows(rows):
    keys, fields = rows
    o = np.argsort(keys)
    return keys[o], {f: v[o] for f, v in fields.items()}


def test_boxps_helper_multi_pass_training(criteo_files, tmp_path):
    """Two days through BoxPSHelper over a PassScopedTable: the window is
    transparent (the port's run equals its plain EmbeddingTable run bit
    for bit, one CPU thread), and against the reference's helper run the
    first pass holds the train-state class (host tier, dense params, AUC
    1e-5) and both passes' keys, show, clk and delta keys are exact. The
    second pass's trained values leave the class against the reference
    on this data (a float-order difference amplified from its tenth
    step), so they are held against the plain run instead."""
    want = _helper_run(criteo_files, tmp_path, "jax")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        got = _helper_run(criteo_files, tmp_path, "port", want["params0"])
        plain = _helper_run(criteo_files, tmp_path, "plain",
                            want["params0"])
    finally:
        torch.set_num_threads(threads)
    for p in ("1", "2"):
        gk, gf = _sorted_rows(got["rows" + p])
        pk, pf = _sorted_rows(plain["rows" + p])
        wk, wf = _sorted_rows(want["rows" + p])
        np.testing.assert_array_equal(gk, pk)
        np.testing.assert_array_equal(gk, wk)
        for f in FIELDS:
            np.testing.assert_array_equal(gf[f], pf[f], err_msg=f)
            if f in ("show", "clk", "slot", "mf_size"):
                np.testing.assert_array_equal(gf[f], wf[f], err_msg=f)
            elif p == "1":
                np.testing.assert_allclose(gf[f], wf[f], rtol=STATE_RTOL,
                                           atol=STATE_ATOL, err_msg=f)
        for k in got["params" + p]:
            assert torch.equal(got["params" + p][k], plain["params" + p][k])
        assert got["r" + p]["auc"] == plain["r" + p]["auc"]
    for k, w in want["params1"].items():
        np.testing.assert_allclose(got["params1"][k].numpy(), w.numpy(),
                                   rtol=STATE_RTOL, atol=STATE_ATOL,
                                   err_msg=k)
    np.testing.assert_allclose(got["r1"]["auc"], want["r1"]["auc"], rtol=0,
                               atol=1e-5)
    np.testing.assert_array_equal(got["delta_keys"], want["delta_keys"])


# ---------------------------------------------------------------------------
# shrink against the epilogue and the SSD tier (tests/test_shrink_fence.py)
# ---------------------------------------------------------------------------

def test_shrink_fences_draining_epilogue():
    """PassScopedTable.shrink fences the epilogue first: a row refreshed
    by a draining write-back is never aged on its stale counters."""
    with flags_scope(async_end_pass=True):
        hs = HostStore(mf_dim=2, capacity=1 << 12)
        t = _pass_table(hs)
        key = np.array([7], np.uint64)
        hs.update(key, _rows(1, 0.0))
        gate, landed = threading.Event(), threading.Event()
        orig = hs.update_rows

        def gated_update_rows(*a, **k):
            gate.wait(10)
            orig(*a, **k)
            landed.set()

        hs.update_rows = gated_update_rows
        t.begin_pass(key)
        with pytest.raises(RuntimeError):
            t.shrink(delete_threshold=0.5, decay=1.0)
        rows = t.index.lookup(key)
        t.state.data[torch.from_numpy(rows.astype(np.int64)),
                     FIELD_COL["show"]] = 10.0
        t._touched[rows] = True
        t.end_pass()
        out = {}
        th = threading.Thread(target=lambda: out.setdefault(
            "freed", t.shrink(delete_threshold=0.5, decay=1.0)))
        th.start()
        time.sleep(0.2)
        assert th.is_alive(), "shrink ran past a draining epilogue job"
        gate.set()
        th.join(10)
        assert not th.is_alive() and landed.is_set()
        assert out["freed"] == 0
        np.testing.assert_allclose(hs.fetch(key)["show"], 10.0)


def test_embedding_table_shrink_calls_fence():
    table = EmbeddingTable(mf_dim=2, capacity=256, cfg=SparseSGDConfig(),
                           unique_bucket_min=64, device="cpu")
    calls = []
    table.fence = lambda: calls.append("fence")
    table.shrink(delete_threshold=0.0, decay=1.0)
    assert calls == ["fence"]


def test_ssd_tier_shrink(tmp_path):
    """SsdTier.shrink decays, drops below the threshold, keeps the
    survivors' touched bits; its segments equal the reference's byte for
    byte before and after."""
    keys = np.arange(1, 9, dtype=np.uint64)
    rows = np.zeros((8, 8), np.float32)
    rows[:, 0] = np.arange(8, dtype=np.float32)
    rows[:, 4] = 3.5
    touched = np.zeros(8, bool)
    touched[::2] = True
    segs = []
    for mod, tag, scope in ((tssd, "t", flags_scope),
                            (jssd, "j", j_flags_scope)):
        with scope(ssd_segment_rows=4):
            tier = mod.SsdTier(str(tmp_path / tag), width=8)
            tier.append(keys, rows, touched=touched)
            before = [open(p, "rb").read() for p in tier.segment_paths()]
            assert tier.shrink(delete_threshold=0.2, decay=0.5) == 4
            assert len(tier) == 4
            after = [open(p, "rb").read() for p in tier.segment_paths()]
            fk, sub, tch = tier.take(keys)
        order = np.argsort(fk)
        np.testing.assert_array_equal(fk[order], keys[4:])
        np.testing.assert_allclose(sub[order, 0],
                                   np.arange(4, 8, dtype=np.float32) * 0.5)
        np.testing.assert_allclose(sub[order, 4], 3.5)
        np.testing.assert_array_equal(tch[order], touched[4:])
        segs.append((before, after))
    assert segs[0] == segs[1]


def test_host_store_shrink_reaches_ssd(tmp_path):
    def run(cls, tag):
        hs = cls(mf_dim=2, capacity=1 << 10,
                 ssd_dir=str(tmp_path / tag))
        keys = np.arange(10, 20, dtype=np.uint64)
        data = _rows(10, 0.0)
        data["show"] = np.where(keys >= 15, 10.0, 0.0).astype(np.float32)
        hs.update(keys, data)
        assert hs.demote_cold() == 10 and len(hs) == 0
        assert hs.shrink(delete_threshold=0.5, decay=1.0) == 5
        assert len(hs.ssd) == 5
        got = hs.fetch(np.arange(15, 20, dtype=np.uint64))
        np.testing.assert_allclose(got["show"], 10.0)
        return got

    _assert_fields_equal(*_both(run))


# ---------------------------------------------------------------------------
# the epilogue's fence (tests/test_streaming.py)
# ---------------------------------------------------------------------------

def test_epilogue_fence_hang_deadline():
    ep = PassEpilogue("t")
    release = threading.Event()
    ep.submit(release.wait, label="wedged")
    with flags_scope(pipeline_wait_timeout_sec=0.3):
        with pytest.raises(PipelineHangError, match="endpass.writeback"):
            ep.fence()
    release.set()
    ep.fence()
    assert ep.stats()["pending"] == 0


def test_fence_slow_but_moving_pipeline_does_not_trip():
    ep = PassEpilogue("t")
    for _ in range(4):
        ep.submit(lambda: time.sleep(0.15))
    with flags_scope(pipeline_wait_timeout_sec=0.4):
        ep.fence()
    assert ep.stats()["pending"] == 0


# ---------------------------------------------------------------------------
# segment files and manifests across the packages
# ---------------------------------------------------------------------------

def _appends(tier):
    rng = np.random.default_rng(4)
    for i in range(3):
        keys = np.arange(i * 5, i * 5 + 5, dtype=np.uint64) + 1
        tier.append(keys, rng.normal(size=(5, 10)).astype(np.float32),
                    touched=np.arange(5) % 2 == 0)
    tier.discard(np.array([2, 7], np.uint64))   # two dead rows


def test_segment_files_equal_and_read_across_packages(tmp_path):
    """The same appends give byte-identical segment files in both
    packages, and each package's segment reader returns the other's rows
    exactly."""
    t = tssd.SsdTier(str(tmp_path / "t"), width=10, segment_rows=8)
    j = jssd.SsdTier(str(tmp_path / "j"), width=10, segment_rows=8)
    _appends(t)
    _appends(j)
    tp, jp = t.segment_paths(), j.segment_paths()
    assert [os.path.basename(p) for p in tp] == \
        [os.path.basename(p) for p in jp] and len(tp) == 2
    for a, b in zip(tp, jp):
        assert open(a, "rb").read() == open(b, "rb").read()
        for x, y in zip(tssd.read_segment_file(b, 10),
                        jssd.read_segment_file(a, 10)):
            np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(np.sort(t.keys()), np.sort(j.keys()))


def test_manifest_digest_agrees_across_packages(tmp_path):
    t = tssd.SsdTier(str(tmp_path / "t"), width=10, segment_rows=8)
    j = jssd.SsdTier(str(tmp_path / "j"), width=10, segment_rows=8)
    _appends(t)
    _appends(j)
    mt, mj = t.manifest(), j.manifest()
    assert mt["digest"] == mj["digest"]
    assert tssd.manifest_digest(mj) == jssd.manifest_digest(mt) \
        == mt["digest"]
    assert [s["sha256"] for s in mt["segments"]] == \
        [s["sha256"] for s in mj["segments"]]
    assert tssd.verify_manifest(mj) == [] and jssd.verify_manifest(mt) == []


def test_checkpoint_restore_refuses_a_flipped_segment_byte(tmp_path):
    """A checkpoint records the table's spill manifest; a restore that
    finds a flipped byte in a recorded segment raises
    CheckpointCorruptError before touching any state, and a missing
    segment is fine."""
    from paddlebox_tpu_torch.data import DataFeedDesc as Desc
    hs = HostStore(mf_dim=2, capacity=1 << 10,
                   ssd_dir=str(tmp_path / "tier"))
    keys = np.arange(1, 21, dtype=np.uint64)
    hs.update(keys, _rows(20, 1.5))
    assert hs.demote_cold() == 20
    table = _pass_table(hs)
    desc = Desc.criteo(batch_size=8)
    model = CtrDnn(26, 3 + 2, 13, hidden=(4,), compute_dtype=torch.float32)
    tr = Trainer(model, table, desc, device="cpu")
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(tr, step=1)
    spill = os.path.join(mgr._dir(1), "spill_manifest.json")
    assert os.path.isfile(spill)
    seg = hs.ssd.segment_paths()[0]
    raw = bytearray(open(seg, "rb").read())
    raw[20] ^= 0xFF
    open(seg, "wb").write(bytes(raw))
    with pytest.raises(CheckpointCorruptError, match="spill manifest"):
        mgr.restore(tr, step=1)
    os.unlink(seg)
    assert mgr.restore(tr, step=1) == 1


def test_fetch_promote_never_demotes_its_own_keys(tmp_path):
    """The port's repair of a reference fault: a ``fetch`` whose promote
    from the SSD tier needs headroom in a full host store must not demote
    another key of the same fetch (the reference excludes only the
    promoted keys, demotes the fetch's untouched RAM keys and then reads
    them as zero rows)."""
    keys = np.arange(1, 9, dtype=np.uint64)
    hot = np.arange(9, 13, dtype=np.uint64)
    got = {}
    for cls, tag in ((HostStore, "t"), (JHost, "j")):
        hs = cls(mf_dim=2, capacity=8, ssd_dir=str(tmp_path / tag))
        rows = _rows(8, 1.0)
        rows["embed_w"] = keys.astype(np.float32)
        hs.update(keys, rows)
        hs.export_rows()                        # all clean
        assert hs.demote_cold(count=4) == 4     # keys 1..4 to segments
        hot_rows = _rows(4, 10.0)
        hs.update(hot, hot_rows)                # RAM full: 5..12
        got[tag] = hs.fetch(keys)["embed_w"]
    np.testing.assert_array_equal(got["t"], keys.astype(np.float32))
    # the reference read keys 5..8 as zeros after demoting them
    np.testing.assert_array_equal(got["j"][4:], 0.0)
