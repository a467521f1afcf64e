"""The port's multi-mf single table, step, trainer, resident pass and
server (``ps/multi_mf.py``, ``train/multi_mf_step.py``,
``serving.MultiMfServingModel``) against the JAX package's, on the CPU:
the counterparts of ``tests/test_multi_mf.py`` and the parity cases.

Both packages read the same criteo files (``tests/test_multi_mf.py``'s
sizes: dims ``[2]*10 + [4]*10 + [8]*6``, ``CtrDnn(hidden=(16, 8))`` with a
float32 tower on both sides). Tolerances: ``split_batch``, the per-class
prepare (rows, gather indices, ``slot_host``), the save files' keys and
slot column, show/clk and the port's resident pass against its streaming
pass exact; training against the reference in the ragged train-state
class, rtol 2e-4 / atol 2e-5, the AUC within 1e-5, with the JAX seqpool
on its XLA and its Pallas (interpret) route. Lazy mf draws zeros on both
sides (``mf_initial_range`` 0).
"""

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
from paddlebox_tpu.ps import MultiMfEmbeddingTable as JMmfTable
from paddlebox_tpu.ps import SparseSGDConfig as JCfg
from paddlebox_tpu.serving import MultiMfServingModel as JMmfServing
from paddlebox_tpu.train import MultiMfTrainer as JMmfTrainer

from paddlebox_tpu_torch import convert
from paddlebox_tpu_torch.data import DataFeedDesc, DatasetFactory
from paddlebox_tpu_torch.data.batch import SlotBatch
from paddlebox_tpu_torch.data.criteo import generate_criteo_files
from paddlebox_tpu_torch.metrics import (auc_add_batch, auc_compute,
                                         init_auc_state)
from paddlebox_tpu_torch.models import CtrDnn
from paddlebox_tpu_torch.ps import MultiMfEmbeddingTable, SparseSGDConfig
from paddlebox_tpu_torch.serving import MultiMfServingModel
from paddlebox_tpu_torch.train import MultiMfTrainer
from paddlebox_tpu_torch.train.multi_mf_step import (canonical_concat,
                                                     class_generators)

STATE_RTOL, STATE_ATOL = 2e-4, 2e-5
HIDDEN = (16, 8)
CAP = 1 << 12
BS = 128
CFG = dict(mf_create_thresholds=0.0, mf_initial_range=0.0,
           learning_rate=0.05, mf_learning_rate=0.05)
SEQPOOL = {"xla": False, "pallas": True}


def _dims():
    # 26 criteo slots: first 10 narrow, next 10 medium, rest wide
    return [2] * 10 + [4] * 10 + [8] * 6


@pytest.fixture(scope="module")
def criteo_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("criteo_tmmf")
    return generate_criteo_files(str(d), num_files=2, rows_per_file=1500,
                                 vocab_per_slot=40, seed=11)


def _ds(files, factory=DatasetFactory, desc_cls=DataFeedDesc, bs=BS):
    desc = desc_cls.criteo(batch_size=bs)
    desc.key_bucket_min = 4096
    ds = factory().create_dataset("InMemoryDataset", desc)
    ds.set_filelist(files)
    ds.set_thread(2)
    ds.load_into_memory()
    return ds, desc


class _Batches:
    """A dataset stand-in over a fixed list of batches."""

    def __init__(self, batches):
        self._b = list(batches)

    def batches(self):
        return iter(self._b)


def _table(**kw):
    return MultiMfEmbeddingTable(_dims(), capacity=CAP,
                                 cfg=SparseSGDConfig(**CFG),
                                 unique_bucket_min=1024, device="cpu", **kw)


def _jax_table():
    return JMmfTable(_dims(), capacity=CAP, cfg=JCfg(**CFG),
                     unique_bucket_min=1024)


def _model(width, state=None, dense=13):
    """CtrDnn with the reference's init (glorot-uniform kernels, zero
    biases, seeded) unless ``state`` gives the params."""
    torch.manual_seed(0)
    m = CtrDnn(1, width, dense, hidden=HIDDEN, compute_dtype=torch.float32)
    for layer in [*m.hidden, m.out]:
        torch.nn.init.xavier_uniform_(layer.weight)
        torch.nn.init.zeros_(layer.bias)
    if state is not None:
        m.load_state_dict(state)
    return m


def _port_trainer(desc, state=None, **kw):
    table = _table()
    return MultiMfTrainer(
        _model(table.pooled_width(), state), table, desc,
        tx=lambda p: torch.optim.Adam(p, lr=1e-2, eps=1e-8), seed=3, **kw)


def _jax_trainer(jdesc):
    return JMmfTrainer(JCtrDnn(hidden=HIDDEN, compute_dtype=jnp.float32),
                       _jax_table(), jdesc, tx=optax.adam(1e-2), seed=3)


def _params(jtr):
    return convert.ctr_dnn_state_dict_from_flax(
        jax.device_get(jtr.state.params))


def _logical(t, jax_side=False):
    """(keys sorted, rows, slot_host) of one class table."""
    keys, rows = t.index.items()
    order = np.argsort(keys)
    keys, rows = keys[order], rows[order]
    data = (np.asarray(jax.device_get(t.state.data)) if jax_side
            else t.state.data.numpy())
    return keys, data[rows], t.slot_host[rows]


def _assert_tables_close(table, jtable):
    for t, jt in zip(table.tables, jtable.tables):
        k, r, s = _logical(t)
        jk, jr, js = _logical(jt, jax_side=True)
        np.testing.assert_array_equal(k, jk)
        np.testing.assert_array_equal(s, js)
        np.testing.assert_array_equal(r[:, :2], jr[:, :2])   # show, clk
        np.testing.assert_array_equal(r[:, 7], jr[:, 7])     # mf_size
        rows = np.concatenate([r[:, :3], r[:, 4:]], axis=1)  # slot: host
        jrows = np.concatenate([jr[:, :3], jr[:, 4:]], axis=1)
        np.testing.assert_allclose(rows, jrows, rtol=STATE_RTOL,
                                   atol=STATE_ATOL)


def _assert_params_close(tr, want):
    sd = tr.model.state_dict()
    for k, w in want.items():
        np.testing.assert_allclose(sd[k].numpy(), w.numpy(),
                                   rtol=STATE_RTOL, atol=STATE_ATOL,
                                   err_msg=k)


# ---------------------------------------------------------------------------
# the reference's tests on the port
# ---------------------------------------------------------------------------

def test_split_batch_routes_and_renumbers():
    dims = [2, 4, 2, 4]
    t = MultiMfEmbeddingTable(dims, capacity=256, device="cpu")
    b, s = 2, 4
    keys = np.arange(1, 9, dtype=np.uint64)          # one key per slot
    segs = np.arange(8, dtype=np.int32)              # trivial layout
    batch = SlotBatch(keys=keys, segments=segs, num_keys=8,
                      dense=np.zeros((b, 1), np.float32),
                      label=np.zeros(b, np.float32),
                      show=np.ones(b, np.float32),
                      clk=np.zeros(b, np.float32),
                      batch_size=b, num_slots=s)
    subs, gslots = t.split_batch(batch)
    assert len(subs) == 2
    # class 0 = dims 2 (slots 0, 2), class 1 = dims 4 (slots 1, 3)
    np.testing.assert_array_equal(subs[0].keys[:4], [1, 3, 5, 7])
    np.testing.assert_array_equal(subs[1].keys[:4], [2, 4, 6, 8])
    # segments renumbered: record r, class-rank q → r*2+q
    np.testing.assert_array_equal(subs[0].segments[:4], [0, 1, 2, 3])
    np.testing.assert_array_equal(subs[1].segments[:4], [0, 1, 2, 3])
    assert subs[0].num_slots == 2 and subs[1].num_slots == 2
    assert subs[0].segments_trivial == batch.segments_trivial
    # global slot ids preserved for the persisted slot field
    np.testing.assert_array_equal(gslots[0], [0, 2, 0, 2])
    np.testing.assert_array_equal(gslots[1], [1, 3, 1, 3])


def _learns(criteo_files, **kw):
    ds, desc = _ds(criteo_files)
    tr = _port_trainer(desc, **kw)
    return tr, ds


def test_multi_mf_e2e_learns(criteo_files):
    tr, ds = _learns(criteo_files)
    first = tr.train_pass(ds)
    tr.reset_metrics()
    for _ in range(3):
        last = tr.train_pass(ds)
    assert np.isfinite(last["auc"])
    assert last["auc"] > max(first["auc"], 0.55)
    assert all(t.feature_count > 0 for t in tr.table.tables)


def test_multi_mf_pull_per_slot_widths(criteo_files):
    tr, ds = _learns(criteo_files)
    tr.train_pass(ds)
    ds.columnarize()
    col = ds.columnar
    keys = col.keys[:100].astype(np.uint64)
    slots = col.key_slot[:100]
    vals = tr.table.pull(keys, slots)
    assert vals.shape == (100, 3 + 8)  # padded to the max class width
    dims = np.asarray(_dims())
    for i in range(100):
        np.testing.assert_allclose(vals[i, 3 + dims[slots[i]]:], 0.0)
    assert (vals[:, 0] > 0).all()


def test_multi_mf_resident_matches_streaming(criteo_files):
    """The resident pass equals the streaming pass bit for bit (one CPU
    thread: the accumulating index_put_ then sums in key order)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        ds, desc = _ds(criteo_files)
        batches = _Batches(list(ds.batches())[:6])
        tr_a = _port_trainer(desc)
        tr_b = _port_trainer(desc, state=tr_a.model.state_dict())
        for _ in range(2):
            ra = tr_a.train_pass(batches)
            rb = tr_b.train_pass_resident(batches)
        assert rb["batches"] == ra["batches"] == 6
        assert rb["auc"] == ra["auc"] and rb["last_loss"] == ra["last_loss"]
        for t_a, t_b in zip(tr_a.table.tables, tr_b.table.tables):
            assert torch.equal(t_a.state.data, t_b.state.data)
            np.testing.assert_array_equal(t_a.slot_host, t_b.slot_host)
        for k, v in tr_a.model.state_dict().items():
            assert torch.equal(v, tr_b.model.state_dict()[k]), k
        tr_b.reset_metrics()
        rb2 = tr_b.train_pass_resident(batches)
        assert rb2["auc"] > rb["auc"] - 0.02
    finally:
        torch.set_num_threads(threads)


def test_multi_mf_serving_consumes_save(criteo_files, tmp_path):
    tr, ds = _learns(criteo_files)
    for _ in range(4):
        tr.train_pass(ds)
    base = str(tmp_path / "srv_base")
    n = tr.table.save_base(base)
    dense = str(tmp_path / "dense.pt")
    torch.save({"model": tr.model.state_dict()}, dense)
    srv = MultiMfServingModel(_model(tr.table.pooled_width()), tr.desc,
                              _dims(), capacity=CAP, device="cpu")
    assert srv.load_base(base) == n
    srv.load_dense(dense)
    ds.columnarize()
    col = ds.columnar
    keys = col.keys[:80].astype(np.uint64)
    slots = col.key_slot[:80]
    vals = srv.embed_lookup(keys, slots)
    np.testing.assert_allclose(vals, tr.table.pull(keys, slots),
                               rtol=1e-6, atol=1e-8)
    dims = np.asarray(_dims())
    for i in range(80):
        np.testing.assert_allclose(vals[i, 3 + dims[slots[i]]:], 0.0)
    assert srv.slot_width(0) == 3 + 2 and srv.slot_width(25) == 3 + 8
    auc = init_auc_state(4096, device="cpu")
    for i, batch in enumerate(ds.batches()):
        preds, valid = srv.predict(batch, return_valid=True)
        assert np.isfinite(preds).all()
        auc_add_batch(auc, torch.from_numpy(preds),
                      torch.from_numpy(batch.label),
                      torch.from_numpy(valid))
        if i >= 5:
            break
    assert auc_compute(auc).auc > 0.55
    # a delta keeps serving in step with further training
    tr.train_pass(ds)
    delta = str(tmp_path / "srv_delta")
    nd = tr.table.save_delta(delta)
    assert nd > 0
    assert srv.apply_delta(delta) == nd
    np.testing.assert_allclose(srv.embed_lookup(keys, slots),
                               tr.table.pull(keys, slots), rtol=1e-6,
                               atol=1e-8)


def test_multi_mf_save_load_roundtrip(criteo_files, tmp_path):
    tr, ds = _learns(criteo_files)
    tr.train_pass(ds)
    path = str(tmp_path / "mmf_base")
    n = tr.table.save_base(path)
    assert n == tr.table.feature_count
    t2 = _table()
    assert t2.load(path) == n
    ds.columnarize()
    col = ds.columnar
    keys = col.keys[:50].astype(np.uint64)
    slots = col.key_slot[:50]
    np.testing.assert_allclose(t2.pull(keys, slots),
                               tr.table.pull(keys, slots), rtol=1e-6)


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def both_batches(criteo_files):
    """The first batches of the criteo files as each package builds
    them (the same arrays)."""
    jds, jdesc = _ds(criteo_files, JFactory, JDesc)
    tds, tdesc = _ds(criteo_files)
    jb, tb = list(jds.batches())[:4], list(tds.batches())[:4]
    for j, t in zip(jb, tb):
        np.testing.assert_array_equal(t.keys, j.keys)
        np.testing.assert_array_equal(t.segments, j.segments)
    return jb, tb, jdesc, tdesc


def test_split_batch_and_prepare_match_jax(both_batches):
    jb, tb, _, _ = both_batches
    jt, tt = _jax_table(), _table()
    for j, t in zip(jb, tb):
        jsubs, jgs = jt.split_batch(j)
        tsubs, tgs = tt.split_batch(t)
        for js, ts, jg, tg in zip(jsubs, tsubs, jgs, tgs):
            for f in ("keys", "segments", "dense", "label", "show", "clk"):
                np.testing.assert_array_equal(getattr(ts, f),
                                              getattr(js, f), err_msg=f)
            assert (ts.num_keys, ts.num_slots, ts.batch_size,
                    ts.segments_trivial) == (js.num_keys, js.num_slots,
                                             js.batch_size,
                                             js.segments_trivial)
            np.testing.assert_array_equal(tg, jg)
        jcb, tcb = jt.prepare(j), tt.prepare(t)
        for jc, tc in zip(jcb, tcb):
            np.testing.assert_array_equal(tc.index.unique_rows,
                                          jc.index.unique_rows)
            np.testing.assert_array_equal(tc.index.gather_idx,
                                          jc.index.gather_idx)
            assert tc.index.num_unique == jc.index.num_unique
    for c, (t, j) in enumerate(zip(tt.tables, jt.tables)):
        np.testing.assert_array_equal(t.slot_host, j.slot_host)
        # global slot ids of the class, not class-local ranks
        _, rows = t.index.items()
        assert np.isin(t.slot_host[rows], tt.class_slots[c]).all()


def test_canonical_concat_routes_grads_to_their_class():
    """Slot s of the concat is (class, rank) ``route[s]``; a grad on slot
    s reaches that block's row and nothing else."""
    tt = _table()
    parts = [torch.randn(3, len(sl), 3 + d, requires_grad=True)
             for sl, d in zip(tt.class_slots, tt.dims)]
    flat = canonical_concat(parts, tt.slot_route())
    widths = [3 + d for d in tt.slot_mf_dims]
    off = np.concatenate([[0], np.cumsum(widths)])
    for s in range(tt.num_slots):
        c, r = tt.slot_route()[s]
        assert torch.equal(flat[:, off[s]:off[s + 1]], parts[c][:, r])
    flat[:, off[13]:off[14]].sum().backward()
    c, r = tt.class_of_slot[13], tt.slot_rank[13]
    for k, p in enumerate(parts):
        nz = p.grad.abs().sum(dim=(0, 2)).nonzero().flatten().tolist()
        assert nz == ([r] if k == c else [])


@pytest.fixture(scope="module")
def jax_runs(both_batches):
    """The reference's trainer after 1 and after 3 steps, per seqpool
    route: its start params, then its class tables, params and AUC."""
    jb, _, jdesc, _ = both_batches
    out = {}
    for route, flag in SEQPOOL.items():
        with j_flags_scope(use_pallas_seqpool=flag):
            for steps in (1, 3):
                tr = _jax_trainer(jdesc)
                start = _params(tr)
                res = tr.train_pass(_Batches(jb[:steps]))
                out[route, steps] = dict(start=start, tr=tr, res=res,
                                         params=_params(tr))
    return out


@pytest.mark.parametrize("route", sorted(SEQPOOL))
@pytest.mark.parametrize("steps", [1, 3])
def test_train_steps_match_jax(route, steps, jax_runs, both_batches):
    _, tb, _, tdesc = both_batches
    j = jax_runs[route, steps]
    tr = _port_trainer(tdesc, state=j["start"])
    res = tr.train_pass(_Batches(tb[:steps]))
    assert res["batches"] == j["res"]["batches"] == steps
    assert res["ins_num"] == j["res"]["ins_num"]
    np.testing.assert_allclose(res["auc"], j["res"]["auc"], rtol=0,
                               atol=1e-5)
    _assert_tables_close(tr.table, j["tr"].table)
    _assert_params_close(tr, j["params"])
    # lazy mf creation ran in every class
    for t in tr.table.tables:
        assert (t.state.data[:, 7] > 0).any()


def test_save_files_load_both_ways(jax_runs, both_batches, tmp_path):
    """The reference's ``.mf{d}.npz`` set loads into the port and the
    port's into the reference: keys, slot column, show/clk exact, every
    pulled value equal."""
    jb, tb, _, _ = both_batches
    jtr = jax_runs["xla", 3]["tr"]
    jpath = str(tmp_path / "jax_base")
    n = jtr.table.save_base(jpath)
    port = _table()
    assert port.load(jpath) == n
    keys = np.concatenate([b.keys[:b.num_keys] for b in tb])
    slots = np.concatenate([(b.segments[:b.num_keys] % b.num_slots)
                            for b in tb]).astype(np.int32)
    np.testing.assert_array_equal(port.pull(keys, slots),
                                  jtr.table.pull(keys, slots))
    tpath = str(tmp_path / "port_base")
    assert port.save_base(tpath) == n
    back = _jax_table()
    assert back.load(tpath) == n
    np.testing.assert_array_equal(back.pull(keys, slots),
                                  jtr.table.pull(keys, slots))
    for d in _dims()[::10] + [8]:
        a, b = np.load(f"{jpath}.mf{d}.npz"), np.load(f"{tpath}.mf{d}.npz")
        oa, ob = np.argsort(a["keys"]), np.argsort(b["keys"])
        np.testing.assert_array_equal(a["keys"][oa], b["keys"][ob])
        for f in ("slot", "show", "clk", "mf_size", "embedx_w"):
            np.testing.assert_array_equal(a[f][oa], b[f][ob], err_msg=f)
        assert a["slot"].max() >= 10 or d == 2


def test_serving_predict_matches_jax(jax_runs, both_batches, tmp_path):
    """``MultiMfServingModel`` over the reference trainer's save and
    converted dense params predicts what the reference's server does."""
    import pickle
    jb, tb, jdesc, tdesc = both_batches
    jtr = jax_runs["xla", 3]["tr"]
    base = str(tmp_path / "base")
    jtr.table.save_base(base)
    dense = str(tmp_path / "dense.pkl")
    with open(dense, "wb") as fh:
        pickle.dump(jax.device_get(jtr.state.params), fh)
    jsrv = JMmfServing(JCtrDnn(hidden=HIDDEN, compute_dtype=jnp.float32),
                       jdesc, _dims(), capacity=CAP)
    jsrv.load_base(base)
    jsrv.load_dense(dense)
    srv = MultiMfServingModel(_model(_table().pooled_width()), tdesc,
                              _dims(), capacity=CAP, device="cpu")
    srv.load_base(base)
    srv.load_params(jax_runs["xla", 3]["params"])
    for j, t in zip(jb, tb):
        jp, jv = jsrv.predict(j, return_valid=True)
        tp, tv = srv.predict(t, return_valid=True)
        np.testing.assert_array_equal(tv, jv)
        np.testing.assert_allclose(tp, jp, rtol=1e-5, atol=1e-6)


def test_class_generators_spread_the_trainer_stream():
    """One class gives the single-table ``Trainer``'s stream; C classes
    take consecutive counters of step t."""
    from paddlebox_tpu_torch.device import seeded_generator
    dev = torch.device("cpu")
    one = class_generators(dev, 3, 5, 1)[0]
    want = seeded_generator(dev, 4, 5)
    assert torch.equal(torch.rand(4, generator=one),
                       torch.rand(4, generator=want))
    three = class_generators(dev, 3, 5, 3)
    for c, g in enumerate(three):
        assert torch.equal(torch.rand(4, generator=g), torch.rand(
            4, generator=seeded_generator(dev, 4, 15 + c)))


def test_example_matches_jax_example(tmp_path):
    """ROADMAP's gate for multi-mf: ``examples/train_multi_mf.py``'s
    configuration (criteo 2 x 4000 rows, vocab 200, batch 256, dims
    ``[4]*10 + [8]*10 + [16]*6``, CtrDnn (64, 32), Adam 1e-3) in both
    packages, with ``mf_initial_range`` 0 and a float32 tower on both
    sides: after the first pass the feature counts, keys, show, clk,
    slot and mf_size exact and the values in the train-state class;
    after three passes the AUC within 2e-3."""
    from paddlebox_tpu_torch.examples import train_multi_mf as ex
    files = generate_criteo_files(str(tmp_path / "data"), num_files=2,
                                  rows_per_file=4000, vocab_per_slot=200,
                                  seed=7)
    jds, jdesc = _ds(files, JFactory, JDesc, bs=256)
    jtable = JMmfTable(ex.SLOT_DIMS, capacity=ex.CAPACITY,
                       cfg=JCfg(mf_create_thresholds=0.0,
                                mf_initial_range=0.0))
    jtr = JMmfTrainer(JCtrDnn(hidden=ex.HIDDEN, compute_dtype=jnp.float32),
                      jtable, jdesc, tx=optax.adam(1e-3))
    start = _params(jtr)
    tds, tdesc = ex.dataset(files, 256)
    tr, res = ex.run(tds, tdesc, passes=1, device="cpu",
                     mf_initial_range=0.0, model_state=start,
                     compute_dtype=torch.float32)
    jres = jtr.train_pass(jds)
    assert tr.table.feature_count == jtable.feature_count > 0
    for t, jt in zip(tr.table.tables, jtable.tables):
        k, r, s = _logical(t)
        jk, jr, js = _logical(jt, jax_side=True)
        np.testing.assert_array_equal(k, jk)
        np.testing.assert_array_equal(s, js)
        np.testing.assert_array_equal(r[:, [0, 1, 7]], jr[:, [0, 1, 7]])
        np.testing.assert_allclose(np.delete(r, 3, axis=1),
                                   np.delete(jr, 3, axis=1),
                                   rtol=STATE_RTOL, atol=STATE_ATOL)
    _assert_params_close(tr, _params(jtr))
    np.testing.assert_allclose(res[0]["auc"], jres["auc"], rtol=0,
                               atol=1e-5)
    for _ in range(2):
        last = tr.train_pass(tds)
        jlast = jtr.train_pass(jds)
    np.testing.assert_allclose(last["auc"], jlast["auc"], rtol=0, atol=2e-3)


def test_convert_carries_jax_class_tables(jax_runs, both_batches):
    """``convert.multi_mf_blobs_from_logical`` + ``load_multi_mf`` carry a
    trained JAX multi-mf table into the port: the same rows for the same
    keys, the slot metadata and every pulled value exact."""
    _, tb, _, _ = both_batches
    jt = jax_runs["xla", 3]["tr"].table
    blobs = convert.multi_mf_blobs_from_logical(
        [(*t.index.items(), np.asarray(jax.device_get(t.state.data)),
          t.mf_dim) for t in jt.tables],
        slots=[t.slot_host for t in jt.tables])
    port = _table()
    assert convert.load_multi_mf(port, blobs) == jt.feature_count
    for t, j in zip(port.tables, jt.tables):
        k, r, s = _logical(t)
        jk, jr, js = _logical(j, jax_side=True)
        np.testing.assert_array_equal(k, jk)
        np.testing.assert_array_equal(s, js)
        np.testing.assert_array_equal(np.delete(r, 3, axis=1),
                                      np.delete(jr, 3, axis=1))
        np.testing.assert_array_equal(t.index.lookup(k), j.index.lookup(k))
    keys = np.concatenate([b.keys[:b.num_keys] for b in tb])
    slots = np.concatenate([(b.segments[:b.num_keys] % b.num_slots)
                            for b in tb]).astype(np.int32)
    np.testing.assert_array_equal(port.pull(keys, slots),
                                  jt.pull(keys, slots))
    with pytest.raises(ValueError, match="dim classes"):
        convert.load_multi_mf(port, blobs[:2])
