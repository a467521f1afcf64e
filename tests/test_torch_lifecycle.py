"""The port's table lifecycle (shrink, merge_model, merge_models, the
post-shrink degrade of the device key index) and its sparse Adam row
optimizers against the JAX package's ``EmbeddingTable`` on the CPU.

Both tables load the same seeded save files and take the same calls.
Both key indexes are native and allocate rows alike, so row ids, slots,
touched flags and the logical table (show/clk decay, zeroed freed rows,
accumulated statistics) must match exactly. ``adam_update`` runs the same
float32 operations in another framework: rtol 1e-6. A seeded 3-batch
ragged ``train_pass`` holds the ragged train-state class, rtol 2e-4 /
atol 2e-5 (ROADMAP ground rules).
"""

import numpy as np
import optax
import pytest

import jax
import jax.numpy as jnp
import torch

from paddlebox_tpu.config import flags_scope as j_flags_scope
from paddlebox_tpu.data import DataFeedDesc as JDesc
from paddlebox_tpu.data import SlotDef as JSlotDef
from paddlebox_tpu.data.dataset import InMemoryDataset as JDataset
from paddlebox_tpu.data.record import SlotRecord as JRecord
from paddlebox_tpu.models import DeepFM as JDeepFM
from paddlebox_tpu.ps import EmbeddingTable as JTable
from paddlebox_tpu.ps import SparseAdamConfig as JAdam
from paddlebox_tpu.ps import SparseSGDConfig as JCfg
from paddlebox_tpu.ps import sgd as jsgd
from paddlebox_tpu.train import Trainer as JTrainer

from paddlebox_tpu_torch import (DeepFM, EmbeddingTable, InMemoryDataset,
                                 Trainer, convert)
from paddlebox_tpu_torch.config import flags_scope
from paddlebox_tpu_torch.data import DataFeedDesc, SlotDef, SlotRecord
from paddlebox_tpu_torch.ops import index as tix
from paddlebox_tpu_torch.ps import sgd as tsgd

MF, CAP = 4, 1 << 12
S, DENSE, BS = 4, 3, 64
STATE_RTOL, STATE_ATOL = 2e-4, 2e-5
JAX_FLAGS = {"xla": {}, "pallas": {"use_pallas_gather": True,
                                   "use_pallas_seqpool": True}}


def _blob(rng, keys, ext=0):
    """A save_base-format mapping of ``keys`` with seeded rows: integer
    show/clk counts (so shrink scores straddle the thresholds), a third
    of the rows without mf, random optimizer extension."""
    n = len(keys)
    rows = np.zeros((n, 8 + MF + ext), np.float32)
    rows[:, 0] = rng.integers(0, 60, size=n)
    rows[:, 1] = np.floor(rows[:, 0] * rng.random(n) * 0.4)
    rows[:, 2] = rng.random(n)
    rows[:, 3] = rng.integers(0, S, size=n)
    rows[:, 4] = rng.normal(size=n)
    rows[:, 5:7] = rng.random((n, 2)) * 3
    rows[:, 7] = rng.random(n) < 0.66
    rows[:, 8:8 + MF] = rng.normal(size=(n, MF)) * rows[:, 7:8]
    rows[:, 8 + MF:] = rng.random((n, ext))
    return convert.table_rows_from_logical(keys, rows, MF)


def _file(tmp_path, name, blob):
    path = str(tmp_path / f"{name}.npz")
    np.savez(path, **blob)
    return path


def _tables(path, jcfg=None, tcfg=None):
    jt = JTable(mf_dim=MF, capacity=CAP, cfg=jcfg or JCfg())
    tt = EmbeddingTable(mf_dim=MF, capacity=CAP, cfg=tcfg or
                        tsgd.SparseSGDConfig(), device="cpu")
    assert jt.load(path) == tt.load(path)
    return jt, tt


def _items(index):
    keys, rows = index.items()
    return dict(zip(keys.tolist(), rows.tolist()))


def _same_tables(jt, tt):
    """Row ids, host metadata and the whole logical table, exactly."""
    assert tt.index.kv_route == "native"
    assert tt.feature_count == jt.feature_count
    assert _items(tt.index) == _items(jt.index)
    np.testing.assert_array_equal(tt.slot_host, jt.slot_host)
    np.testing.assert_array_equal(tt._touched, jt._touched)
    np.testing.assert_array_equal(tt.state.data.numpy(),
                                  np.asarray(jt.state.data))
    assert tt.rows_digest() == jt.rows_digest()


def _same_logical(a, b):
    """The logical rows keyed by feasign, every field, exactly (a reload
    lays the rows out in another order)."""
    ka, ra = a.index.items()
    kb, rb = b.index.items()
    oa, ob = np.argsort(ka), np.argsort(kb)
    np.testing.assert_array_equal(ka[oa], kb[ob])
    ga, gb = a._gather_host(ra[oa]), b._gather_host(rb[ob])
    assert sorted(ga) == sorted(gb)
    for f in ga:
        np.testing.assert_array_equal(ga[f], gb[f], err_msg=f)
    assert a.rows_digest() == b.rows_digest()


def _base(tmp_path, seed=0, n=1500):
    rng = np.random.default_rng(seed)
    keys = rng.choice(2**40, size=n, replace=False).astype(np.uint64)
    return keys, _file(tmp_path, f"base{seed}", _blob(rng, keys))


@pytest.mark.parametrize("thr,decay", [(5.0, 0.98), (0.0, None),
                                       (3.0, 0.5)])
def test_shrink_matches_reference(tmp_path, thr, decay):
    _, path = _base(tmp_path)
    jt, tt = _tables(path)
    freed = jt.shrink(thr, decay)
    assert tt.shrink(thr, decay) == freed
    if thr > 0:
        assert 0 < freed < 1500
    _same_tables(jt, tt)
    # the freed rows come back first, in the same order
    more = np.arange(1, 300, dtype=np.uint64)
    np.testing.assert_array_equal(tt.index.assign(more),
                                  jt.index.assign(more))


def test_shrink_reads_the_flags(tmp_path):
    _, path = _base(tmp_path)
    jt, tt = _tables(path)
    with j_flags_scope(shrink_delete_threshold=8.0,
                       show_click_decay_rate=0.9), \
            flags_scope(shrink_delete_threshold=8.0,
                        show_click_decay_rate=0.9):
        assert jt.shrink() == tt.shrink() > 0
    _same_tables(jt, tt)


def _merge_files(tmp_path, keys):
    """Two files: each holds some live keys, some of the base's keys and
    some new ones, with other values."""
    rng = np.random.default_rng(9)
    new = rng.choice(2**40, size=400, replace=False).astype(np.uint64) \
        + np.uint64(2**41)
    b = np.concatenate([keys[:300], new[:200]])
    c = np.concatenate([keys[200:500], new[100:]])
    return (_file(tmp_path, "b", _blob(rng, rng.permutation(b))),
            _file(tmp_path, "c", _blob(rng, rng.permutation(c))))


def test_merge_model_matches_reference(tmp_path):
    keys, path = _base(tmp_path)
    jt, tt = _tables(path)
    # holes first, so the merged new keys reuse freed rows
    assert jt.shrink(10.0) == tt.shrink(10.0) > 0
    b, _ = _merge_files(tmp_path, keys)
    assert tt.merge_model(b) == jt.merge_model(b) == 500
    _same_tables(jt, tt)


@pytest.mark.parametrize("update_type", ["stats", "overwrite"])
def test_merge_models_matches_reference(tmp_path, update_type):
    keys, path = _base(tmp_path)
    jt, tt = _tables(path)
    assert jt.shrink(10.0) == tt.shrink(10.0) > 0
    files = _merge_files(tmp_path, keys)
    assert (tt.merge_models(files, update_type)
            == jt.merge_models(files, update_type) == 1100)
    _same_tables(jt, tt)
    with pytest.raises(ValueError):
        tt.merge_models(files, "bogus")


def test_shrink_holes_degrade_the_device_index(tmp_path):
    """After a shrink the kv's rows are not dense: the next flag-on bulk
    assignment degrades, loudly, and takes the host route, which gives
    the reference's rows. A merge that refills every hole lets the next
    one seed a new device index again."""
    keys, path = _base(tmp_path)
    jt, tt = _tables(path)
    assert jt.shrink(10.0) == tt.shrink(10.0) > 0
    rng = np.random.default_rng(3)
    raw = np.concatenate([rng.choice(keys, 500),
                          rng.integers(2**50, 2**51, size=300,
                                       dtype=np.uint64)])
    slots = (raw % np.uint64(S)).astype(np.int16)
    ticks0 = dict(tix.DISPATCH)
    with j_flags_scope(use_pallas_index=True), \
            flags_scope(use_pallas_index=True):
        want = jt.bulk_assign_unique(raw, slots)
        got = tt.bulk_assign_unique(raw, slots)
    assert jt._dev_index.degraded and tt._dev_index.degraded
    assert "not dense" in tt._dev_index.degrade_reason
    assert tix.DISPATCH[("index.assign", "host")] \
        == ticks0.get(("index.assign", "host"), 0) + 1
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    _same_tables(jt, tt)
    # merging the base back refills the holes: dense again, so the new
    # device index seeds and serves the next assignment on the device
    # route, with the host route's rows
    twin = EmbeddingTable(mf_dim=MF, capacity=CAP, device="cpu")
    twin.load(path)
    twin.shrink(10.0)
    twin.bulk_assign_unique(raw, slots)
    for t in (tt, twin):
        t.merge_model(path)
    assert tt._dev_index is None
    raw2 = rng.integers(2**52, 2**53, size=200, dtype=np.uint64)
    slots2 = (raw2 % np.uint64(S)).astype(np.int16)
    with flags_scope(use_pallas_index=True):
        got2 = tt.bulk_assign_unique(raw2, slots2)
    assert not tt._dev_index.degraded
    assert tix.DISPATCH[("index.assign", "device")] \
        == ticks0.get(("index.assign", "device"), 0) + 1
    want2 = twin.bulk_assign_unique(raw2, slots2)
    np.testing.assert_array_equal(got2[0], want2[0])
    np.testing.assert_array_equal(got2[1], want2[1])
    assert _items(tt.index) == _items(twin.index)


def _adam_rows(rng, u, ext):
    """A row state with mid-training rows, never-touched rows (show 0,
    beta powers 0) and rows without mf."""
    mf_size = (rng.random(u) < 0.5).astype(np.float32)
    show = rng.integers(0, 6, size=u).astype(np.float32)
    opt = rng.random((u, ext)).astype(np.float32) * 0.2
    opt[:, 1:5] = 0.9 ** rng.integers(1, 5, size=(u, 4))
    opt[:, 2] = 0.999 ** rng.integers(1, 5, size=u)
    opt[:, 4] = 0.999 ** rng.integers(1, 5, size=u)
    fresh = show == 0
    opt[fresh, 1:3] = 0.0
    return dict(show=show, clk=np.floor(show * 0.3).astype(np.float32),
                delta_score=rng.random(u).astype(np.float32),
                embed_w=rng.normal(size=u).astype(np.float32),
                embed_g2sum=rng.random(u).astype(np.float32) * 0.1,
                embedx_w=(rng.normal(size=(u, MF)) * mf_size[:, None]
                          ).astype(np.float32),
                embedx_g2sum=rng.random(u).astype(np.float32),
                mf_size=mf_size, opt_ext=opt)


@pytest.mark.parametrize("shared", [False, True])
def test_adam_update_matches_reference(shared):
    rng = np.random.default_rng(11)
    u = 300
    cfg = dict(shared=shared, mf_create_thresholds=1.0,
               mf_initial_range=0.5, learning_rate=0.01)
    ext = tsgd.opt_ext_width(tsgd.SparseAdamConfig(**cfg), MF)
    assert ext == (7 if shared else 5 + 2 * MF)
    cols = _adam_rows(rng, u, ext)
    g_show = rng.integers(0, 4, size=u).astype(np.float32)
    g_clk = np.minimum(g_show, rng.integers(0, 2, size=u)).astype(
        np.float32)
    g_embed = rng.normal(size=u).astype(np.float32)
    g_embedx = rng.normal(size=(u, MF)).astype(np.float32)
    touched = rng.random(u) < 0.85
    key = jax.random.PRNGKey(4)
    init = np.array(jax.random.uniform(key, (u, MF), jnp.float32))
    ref = jsgd.adam_update(
        jsgd.RowState(**{k: jnp.asarray(v) for k, v in cols.items()}),
        jnp.asarray(g_show), jnp.asarray(g_clk), jnp.asarray(g_embed),
        jnp.asarray(g_embedx), jnp.asarray(touched), JAdam(**cfg), key)
    got = tsgd.sparse_update(
        tsgd.RowState(**{k: torch.from_numpy(v) for k, v in cols.items()}),
        torch.from_numpy(g_show), torch.from_numpy(g_clk),
        torch.from_numpy(g_embed), torch.from_numpy(g_embedx),
        torch.from_numpy(touched), tsgd.SparseAdamConfig(**cfg),
        init=torch.from_numpy(init))
    created = (cols["mf_size"] == 0) & (np.asarray(ref.mf_size) > 0)
    fresh = (cols["show"] == 0) & touched
    assert created.any() and fresh.any()
    for f in jsgd.RowState._fields:
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(ref, f)), rtol=1e-6,
                                   atol=0, err_msg=f)


def _ragged_arrays(n, seed):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        counts = np.minimum(rng.zipf(1.5, size=S), 8)
        offs = np.zeros(S + 1, np.int32)
        np.cumsum(counts, out=offs[1:])
        keys = rng.integers(0, 3000, size=int(offs[-1])).astype(np.uint64)
        out.append((keys, offs, rng.normal(size=DENSE).astype(np.float32),
                    float(i % 2)))
    return out


def _slots(cls):
    return ([cls("label", "float", 1), cls("d", "float", DENSE)]
            + [cls(f"S{i}", "uint64") for i in range(S)])


CFG = dict(mf_create_thresholds=0.0, mf_initial_range=0.0,
           learning_rate=0.05, mf_learning_rate=0.05)


@pytest.mark.parametrize("flags", sorted(JAX_FLAGS))
@pytest.mark.parametrize("shared", [False, True])
def test_adam_train_pass_matches_jax_trainer(shared, flags, tmp_path):
    arrs = _ragged_arrays(3 * BS, seed=5)
    jdesc = JDesc(slots=_slots(JSlotDef), label_slot="label",
                  batch_size=BS, key_bucket_min=512)
    tdesc = DataFeedDesc(slots=_slots(SlotDef), label_slot="label",
                         batch_size=BS, key_bucket_min=512)
    with j_flags_scope(**JAX_FLAGS[flags]):
        jt = JTable(mf_dim=MF, capacity=CAP, cfg=JAdam(shared=shared, **CFG),
                    unique_bucket_min=512)
        jtr = JTrainer(JDeepFM(hidden=(16, 8), compute_dtype=jnp.float32),
                       jt, jdesc, tx=optax.adam(1e-2), seed=3)
        params0 = jax.device_get(jtr.state.params)
        jds = JDataset(jdesc)
        jds.records = [JRecord(k, o, d, l, 1.0, l) for k, o, d, l in arrs]
        jres = jtr.train_pass(jds)
        jtr.sync_table()
        jparams = convert.deepfm_state_dict_from_flax(
            jax.device_get(jtr.state.params))

    model = DeepFM(S, 3 + MF, DENSE, hidden=(16, 8),
                   compute_dtype=torch.float32)
    model.load_state_dict(convert.deepfm_state_dict_from_flax(params0))
    tt = EmbeddingTable(mf_dim=MF, capacity=CAP,
                        cfg=tsgd.SparseAdamConfig(shared=shared, **CFG),
                        unique_bucket_min=512, device="cpu")
    assert tt.state.feat == 8 + MF + (7 if shared else 5 + 2 * MF)
    tr = Trainer(model, tt, tdesc,
                 tx=lambda p: torch.optim.Adam(p, lr=1e-2, eps=1e-8),
                 seed=3, check_nan_inf=True, device="cpu")
    ds = InMemoryDataset(tdesc)
    ds.records = [SlotRecord(k, o, d, l, 1.0, l) for k, o, d, l in arrs]
    tres = tr.train_pass(ds)

    assert tres["batches"] == jres["batches"] == 3
    assert _items(tt.index) == _items(jt.index)
    keys, rows = tt.index.items()
    rows = rows[np.argsort(keys)]
    tblob, jblob = tt._gather_host(rows), jt._gather_host(rows)
    assert sorted(tblob) == sorted(jblob) and "opt_ext" in tblob
    for f in sorted(jblob):
        np.testing.assert_allclose(tblob[f], jblob[f], rtol=STATE_RTOL,
                                   atol=STATE_ATOL, err_msg=f)
    assert (tblob["mf_size"] > 0).any() and (tblob["opt_ext"] != 0).any()
    sd = tr.model.state_dict()
    for name, want in jparams.items():
        np.testing.assert_allclose(sd[name].numpy(), want.numpy(),
                                   rtol=STATE_RTOL, atol=STATE_ATOL,
                                   err_msg=name)
    np.testing.assert_allclose(tres["auc"], jres["auc"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(tres["last_loss"], jres["last_loss"],
                               rtol=STATE_RTOL)


@pytest.mark.parametrize("shared", [False, True])
def test_adam_save_load_across_packages(tmp_path, shared):
    """An Adam table's save_base loads into the other package's table with
    every field, the opt_ext block included, intact, both ways."""
    ext = 7 if shared else 5 + 2 * MF
    rng = np.random.default_rng(12)
    keys = rng.choice(2**40, size=900, replace=False).astype(np.uint64)
    blob = _blob(rng, keys, ext)
    src = _file(tmp_path, "src", blob)
    jcfg, tcfg = JAdam(shared=shared), tsgd.SparseAdamConfig(shared=shared)
    jt, tt = _tables(src, jcfg, tcfg)
    _same_tables(jt, tt)
    # JAX -> port
    jpath, tpath = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    assert jt.save_base(jpath) == 900
    back = EmbeddingTable(mf_dim=MF, capacity=CAP, cfg=tcfg, device="cpu")
    assert back.load(jpath) == 900
    _same_logical(jt, back)
    # port -> JAX
    assert tt.save_base(tpath) == 900
    jback = JTable(mf_dim=MF, capacity=CAP, cfg=jcfg)
    assert jback.load(tpath) == 900
    _same_logical(jback, tt)
    with np.load(tpath) as f:
        np.testing.assert_array_equal(f["opt_ext"][np.argsort(f["keys"])],
                                      blob["opt_ext"][np.argsort(keys)])
