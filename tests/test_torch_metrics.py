"""The port's metric registry (``metrics.py``: ``auc_merge``, ``Metric``,
``MetricRegistry``) and the single-process ``metrics_ext`` methods held
against the JAX package on the same seeded predictions, labels, weights
and side channels. Bucket tables must match exactly (the same float32
``pred * nbins`` bucket and 0/1 weights); results within rtol 1e-6 (the
error sums reduce in another order)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddlebox_tpu.metrics import MetricRegistry as JRegistry
from paddlebox_tpu.metrics import auc_merge as j_auc_merge
from paddlebox_tpu.metrics import init_auc_state as j_init
from paddlebox_tpu.metrics import auc_add_batch as j_add
from paddlebox_tpu.metrics_ext import \
    _tie_averaged_user_auc as j_user_auc

from paddlebox_tpu_torch import DeepFM, EmbeddingTable, Trainer
from paddlebox_tpu_torch.data import (DataFeedDesc, InMemoryDataset,
                                      SlotDef, SlotRecord)
from paddlebox_tpu_torch.metrics import (Metric, MetricRegistry,
                                         auc_add_batch, auc_compute,
                                         auc_merge, init_auc_state)
from paddlebox_tpu_torch.metrics_ext import (METRIC_METHODS,
                                             ContinueValueMetric,
                                             NanInfMetric, WuAucMetric,
                                             _tie_averaged_user_auc,
                                             parse_cmatch_rank_group)
from paddlebox_tpu_torch.ps.sgd import SparseSGDConfig

NB = 4096
RTOL = 1e-6

METHODS = {
    "auc": {},
    "cmatch_rank_auc": {"cmatch_rank_group": "401:0,402:1"},
    "cmatch_rank_auc_ignore": {"cmatch_rank_group": "401,403",
                               "ignore_rank": True},
    "mask_auc": {},
    "cmatch_rank_mask_auc": {"cmatch_rank_group": "401:0,403:2"},
    "multi_task_auc": {"cmatch_rank_group": "401:0,402:1,403:2"},
    "continue_value": {},
    "nan_inf": {},
    "wuauc": {},
}


def _batches(seed, n=3, b=512, tasks=3):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        preds = rng.random((b, tasks)).astype(np.float32)
        pred = preds[:, 0].copy()
        pred[:3] = [0.0, 1.0, 0.999999]          # bucket edges
        out.append(dict(
            pred=pred, preds=preds,
            label=(rng.random(b) < pred).astype(np.float32),
            weight=(rng.random(b) < 0.9).astype(np.float32),
            uid=rng.integers(0, 40, size=b).astype(np.int64),
            rank=rng.integers(0, 3, size=b).astype(np.int32),
            cmatch=rng.choice([401, 402, 403, 7], size=b).astype(np.int32),
            mask=rng.integers(0, 2, size=b).astype(np.int32)))
    return out


def _feed(reg, batches, to_pred):
    for bt in batches:
        pred = bt["preds"] if reg.get("m").method == "multi_task_auc" \
            else bt["pred"]
        reg.add_batch(to_pred(pred), bt["label"], bt["weight"],
                      uid=bt["uid"], rank=bt["rank"], cmatch=bt["cmatch"],
                      mask=bt["mask"])


@pytest.mark.parametrize("case", sorted(METHODS))
def test_method_matches_reference(case):
    method = case.removesuffix("_ignore")
    kw = dict(METHODS[case])
    if method not in ("continue_value", "nan_inf", "wuauc"):
        kw["nbins"] = NB
    batches = _batches(len(case))
    jreg, treg = JRegistry(), MetricRegistry()
    jm = jreg.init_metric("m", method, **kw)
    tm = treg.init_metric("m", method, **kw)
    assert type(tm).__name__ == type(jm).__name__
    _feed(jreg, batches, jnp.asarray)
    _feed(treg, batches, torch.from_numpy)
    if hasattr(jm, "state"):
        np.testing.assert_array_equal(tm.state.pos.numpy(),
                                      np.asarray(jm.state.pos))
        np.testing.assert_array_equal(tm.state.neg.numpy(),
                                      np.asarray(jm.state.neg))
    want, got = jreg.get_metric_msg("m"), treg.get_metric_msg("m")
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, err_msg=k)
    treg.reset_all()
    jreg.reset_all()
    assert treg.get_metric_msg("m") == jreg.get_metric_msg("m")


def test_registry_dispatch_and_phase():
    reg = MetricRegistry()
    reg.init_metric("join_auc", method="auc", phase=1, nbins=1000)
    reg.init_metric("upd_auc", method="auc", phase=0, nbins=1000)
    reg.init_metric("wu", method="wuauc")
    assert set(reg.active()) == {"join_auc", "wu"}
    reg.flip_phase()
    assert set(reg.active()) == {"upd_auc", "wu"}
    with pytest.raises(ValueError):
        reg.init_metric("x", method="nope")
    assert reg.get_metric_msg("wu")["ins_num"] == 0.0
    assert reg.get_metric_msg("upd_auc")["auc"] == 0.5   # never fed
    assert sorted(METRIC_METHODS) == sorted(
        m.removesuffix("_ignore") for m in METHODS if "_ignore" not in m)


def test_registry_skips_metric_missing_side_channel():
    reg = MetricRegistry()
    reg.init_metric("m", method="mask_auc")
    reg.init_metric("a", method="auc")
    pred = torch.tensor([0.2, 0.8])
    reg.add_batch(pred, np.array([0.0, 1.0], np.float32),
                  np.ones(2, np.float32))
    assert reg.get_metric_msg("a")["ins_num"] == 2
    assert reg.get_metric_msg("m")["ins_num"] == 0


def test_plain_metric_and_auc_merge_match_reference():
    rng = np.random.default_rng(5)
    jstates, tstates = [], []
    m = Metric("plain", nbins=NB)
    for _ in range(3):
        pred = rng.random(300).astype(np.float32)
        label = (rng.random(300) < pred).astype(np.float32)
        w = np.ones(300, np.float32)
        jstates.append(j_add(j_init(NB), jnp.asarray(pred),
                             jnp.asarray(label), jnp.asarray(w)))
        tstates.append(auc_add_batch(init_auc_state(NB, "cpu"),
                                     torch.from_numpy(pred),
                                     torch.from_numpy(label),
                                     torch.from_numpy(w)))
        m.add(torch.from_numpy(pred), label, w)
    jm, tmg = j_auc_merge(tuple(jstates)), auc_merge(tstates)
    np.testing.assert_array_equal(tmg.pos.numpy(), np.asarray(jm.pos))
    np.testing.assert_array_equal(tmg.neg.numpy(), np.asarray(jm.neg))
    np.testing.assert_array_equal(m.state.buckets.numpy(),
                                  tmg.buckets.numpy())
    assert m.compute().auc == auc_compute(tmg).auc
    m.reset()
    assert m.compute().ins_num == 0.0


def test_default_auc_bitmatches_f64_reference_calculator():
    rng = np.random.default_rng(7)
    st = init_auc_state(NB, "cpu")
    for _ in range(3):
        pred = rng.random(512).astype(np.float32)
        label = (rng.random(512) < pred).astype(np.float32)
        auc_add_batch(st, torch.from_numpy(pred), torch.from_numpy(label),
                      torch.ones(512))
    pos = st.pos.numpy().astype(np.float64)
    neg = st.neg.numpy().astype(np.float64)
    area = cum_neg = 0.0
    for i in range(NB):
        area += pos[i] * (cum_neg + 0.5 * neg[i])
        cum_neg += neg[i]
    assert auc_compute(st).auc == area / (pos.sum() * neg.sum())


def test_parse_continue_value_and_nan_inf():
    assert parse_cmatch_rank_group("401:0,402:1") == [(401, 0), (402, 1)]
    assert parse_cmatch_rank_group("7, 8") == [(7, 0), (8, 0)]
    m = ContinueValueMetric("cv")
    m.add(torch.tensor([1.0, 2.0, 3.0]), np.array([1.5, 2.0, 1.0]))
    got = m.compute()
    np.testing.assert_allclose(got["mae"], (0.5 + 0 + 2.0) / 3)
    np.testing.assert_allclose(got["rmse"], np.sqrt((0.25 + 4.0) / 3))
    n = NanInfMetric("ni")
    n.add(torch.tensor([0.1, np.nan, np.inf, -np.inf, 0.5]))
    got = n.compute()
    assert got["nan"] == 1 and got["inf"] == 2 and got["ins_num"] == 5


def test_wuauc_matches_reference_helper():
    rng = np.random.default_rng(3)
    uid = rng.integers(0, 40, size=3000).astype(np.int64)
    pred = np.round(rng.random(3000), 2)               # force ties
    label = (rng.random(3000) < pred).astype(np.float64)
    assert _tie_averaged_user_auc(uid, pred, label) == j_user_auc(
        uid, pred, label)
    w = WuAucMetric("wu")
    w.add(torch.tensor([0.9, 0.1]), np.array([1.0, 0.0]),
          uid=np.array([1, 1]))
    w.add(np.array([0.2, 0.8]), np.array([1.0, 0.0]), uid=np.array([2, 2]))
    got = w.compute()
    assert got["user_count"] == 2
    np.testing.assert_allclose(got["wuauc"], 0.5)


def test_registry_auto_feed_through_trainer():
    """Registered variants accumulate during ``train_pass`` from the
    batches' side channels (uid/rank/cmatch); the plain AUC variant at
    the trainer's bucket count equals the trainer's own AUC."""
    rng = np.random.default_rng(0)
    S = 3
    recs = []
    for i in range(512):
        keys = (rng.integers(0, 40, S) + np.arange(S) * 40).astype(
            np.uint64)
        lbl = float(rng.random() < 0.3)
        recs.append(SlotRecord(
            keys=keys, slot_offsets=np.arange(S + 1, dtype=np.int32),
            dense=rng.normal(size=2).astype(np.float32), label=lbl,
            show=1.0, clk=lbl, uid=int(i % 17),
            rank=int(rng.integers(1, 4)),
            cmatch=int(rng.choice([222, 223, 0]))))
    slots = [SlotDef("label", "float", 1), SlotDef("dense", "float", 2)]
    slots += [SlotDef(f"C{i}", "uint64") for i in range(S)]
    desc = DataFeedDesc(slots=slots, batch_size=64, label_slot="label")
    ds = InMemoryDataset(desc)
    ds.records = recs
    t = EmbeddingTable(mf_dim=2, capacity=1 << 12,
                       cfg=SparseSGDConfig(mf_create_thresholds=0.0),
                       device="cpu")
    torch.manual_seed(0)
    tr = Trainer(DeepFM(S, 5, 2, hidden=(8,)), t, desc, device="cpu")
    tr.metrics.init_metric("all", method="auc")
    tr.metrics.init_metric("cm222", method="cmatch_rank_auc",
                           cmatch_rank_group="222:1,222:2,222:3")
    tr.metrics.init_metric("wu", method="wuauc")
    out = tr.train_pass(ds)
    msg_all = tr.metrics.get_metric_msg("all")
    assert msg_all["ins_num"] == 512
    assert msg_all["auc"] == out["auc"]
    n222 = sum(1 for r in recs if r.cmatch == 222)
    assert tr.metrics.get_metric_msg("cm222")["ins_num"] == n222 > 0
    wu = tr.metrics.get_metric_msg("wu")
    assert np.isfinite(wu["wuauc"]) and wu["user_count"] == 17
    batch = next(ds.batches())
    np.testing.assert_array_equal(batch.uid[:3], [0, 1, 2])
    assert batch.ins_ids is None


@pytest.mark.parametrize("dense_sizes", ["full", "ragged"])
def test_batch_builder_matches_reference(dense_sizes):
    """The port's ``BatchBuilder`` fills the dense block, the
    label/show/clk columns and the metric side channels (uid, rank,
    cmatch, ins_ids) exactly as the JAX builder does, for records whose
    dense blocks are all full and for short or empty ones (zero padded),
    on a short batch (the tail instances stay zero)."""
    from paddlebox_tpu.data import BatchBuilder as JBuilder
    from paddlebox_tpu.data import DataFeedDesc as JDesc
    from paddlebox_tpu.data import SlotDef as JSlotDef
    from paddlebox_tpu.data import SlotRecord as JRecord
    from paddlebox_tpu_torch.data import BatchBuilder
    rng = np.random.default_rng(11)
    S, D, n = 3, 4, 50
    rows = []
    for i in range(n):
        size = D if dense_sizes == "full" else int(rng.integers(0, D + 1))
        rows.append(dict(
            keys=rng.integers(0, 1000, size=S).astype(np.uint64),
            slot_offsets=np.arange(S + 1, dtype=np.int32),
            dense=rng.normal(size=size).astype(np.float32),
            label=float(i % 2), show=1.0, clk=float(i % 2),
            ins_id=f"ins{i}", uid=int(rng.integers(0, 1 << 40)),
            rank=int(rng.integers(0, 4)), cmatch=int(rng.choice([222, 0]))))

    def desc(Desc, Slot):
        slots = [Slot("label", "float", 1), Slot("dense", "float", D)]
        slots += [Slot(f"C{i}", "uint64") for i in range(S)]
        return Desc(slots=slots, batch_size=64, label_slot="label")

    got = BatchBuilder(desc(DataFeedDesc, SlotDef)).build(
        [SlotRecord(**r) for r in rows])
    want = JBuilder(desc(JDesc, JSlotDef)).build([JRecord(**r) for r in rows])
    for f in ("keys", "segments", "dense", "label", "show", "clk", "uid",
              "rank", "cmatch"):
        g, w = getattr(got, f), getattr(want, f)
        assert g.dtype == w.dtype, f
        np.testing.assert_array_equal(g, w, err_msg=f)
    assert got.ins_ids == want.ins_ids
    assert got.num_keys == want.num_keys
