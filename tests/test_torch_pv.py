"""The port's PV ads-ranking path against the JAX package, on the CPU:
``data/pv.py`` batches, ``AdsRank`` through
``convert.ads_rank_state_dict_from_flax``, the table's eager
``pull``/``push`` with ``merge_push``/``push_stats``, and a seeded
multi-batch run of the PV training loop (``bench.py`` ``measure_pv``:
prepare → pull → fused_seqpool_cvm → AdsRank → ins_w-weighted BCE →
backward and Adam → embed grads scaled by −B → push).

The port runs its plain kernel versions (CPU tensors); the JAX side runs
with its three CTR flags off (XLA) and on (Pallas in interpret mode).

Tolerances: host batches and rank_offset byte-identical; pull values and
merged grads exact; AdsRank logits rtol 1e-4 / atol 1e-5 and param grads
rtol 5e-3 / atol 1e-4 in float32 (tests/test_pallas_ctr.py:296-300);
bf16 logits atol 5e-2 (the two frameworks round the bf16 products and
bias adds at other places); the training run's logical table rows rtol
2e-4 / atol 2e-5 and dense params rtol 2e-3 / atol 2e-4
(tests/test_pallas_train_gate.py:271-273).
"""

import numpy as np
import optax
import pytest

import jax
import jax.numpy as jnp
import torch
import torch.nn.functional as F

from paddlebox_tpu.config import flags_scope
from paddlebox_tpu.data import DataFeedDesc as JDesc
from paddlebox_tpu.data import SlotDef as JSlotDef
from paddlebox_tpu.data import pv as jpv
from paddlebox_tpu.data.record import SlotRecord as JRecord
from paddlebox_tpu.models import AdsRank as JAdsRank
from paddlebox_tpu.ops import fused_seqpool_cvm as j_seqpool
from paddlebox_tpu.ops import init_cross_norm_summary as j_init_summary
from paddlebox_tpu.ps import EmbeddingTable as JTable
from paddlebox_tpu.ps import SparseSGDConfig as JCfg
from paddlebox_tpu.ps import table as jtable

from paddlebox_tpu_torch import AdsRank, EmbeddingTable, convert
from paddlebox_tpu_torch.data import DataFeedDesc, SlotDef, SlotRecord
from paddlebox_tpu_torch.data import pv as tpv
from paddlebox_tpu_torch.ops.cross_norm import init_cross_norm_summary
from paddlebox_tpu_torch.ops.seqpool_cvm import fused_seqpool_cvm
from paddlebox_tpu_torch.ps import table as ttable

JAX_FLAGS = {
    "xla": dict(use_pallas_rank_attention=False, use_pallas_batch_fc=False,
                use_pallas_cross_norm=False),
    "pallas": dict(use_pallas_rank_attention=True, use_pallas_batch_fc=True,
                   use_pallas_cross_norm=True)}
FLAGS = sorted(JAX_FLAGS)
MR = 3
STATE_RTOL, STATE_ATOL = 2e-4, 2e-5
PARAM_RTOL, PARAM_ATOL = 2e-3, 2e-4


def _pv_fields(n_pvs, num_slots, vocab, dense_dim, seed=0, wild=False):
    """bench.py build_pv_records as plain fields: 2-4 ads per PV with
    shuffled 1-based ranks, cmatch 222. ``wild`` also draws ranks past
    max_rank, zero ranks, invalid cmatch, ins_ids, uids and timestamps."""
    rng = np.random.default_rng(seed)
    out = []
    for sid in range(n_pvs):
        n_ads = int(rng.integers(2, 5))
        ranks = rng.permutation(n_ads) + 1
        for a in range(n_ads):
            keys = (rng.integers(0, vocab, num_slots)
                    + np.arange(num_slots) * vocab).astype(np.uint64)
            label = float(rng.random() < 0.25)
            f = dict(keys=keys,
                     slot_offsets=np.arange(num_slots + 1, dtype=np.int32),
                     dense=rng.normal(size=dense_dim).astype(np.float32),
                     label=label, show=1.0, clk=label, search_id=sid,
                     rank=int(ranks[a]), cmatch=222)
            if wild:
                f.update(rank=int(rng.integers(0, MR + 3)),
                         cmatch=int(rng.choice([222, 223, 100])),
                         ins_id=f"i{int(rng.integers(0, n_pvs))}",
                         uid=int(rng.integers(0, 7)),
                         timestamp=int(rng.integers(0, 100)),
                         search_id=int(rng.integers(0, n_pvs)))
            out.append(f)
    return out


def _records(fields):
    return ([JRecord(**f) for f in fields], [SlotRecord(**f) for f in fields])


def _descs(num_slots, dense_dim, bs, pvb, key_bucket_min):
    def slots(cls):
        return ([cls("label", "float", 1), cls("dense", "float", dense_dim)]
                + [cls(f"C{i}", "uint64") for i in range(num_slots)])
    kw = dict(batch_size=bs, label_slot="label", pv_batch_size=pvb,
              key_bucket_min=key_bucket_min)
    return JDesc(slots=slots(JSlotDef), **kw), DataFeedDesc(
        slots=slots(SlotDef), **kw)


# ---------------------------------------------------------------------------
# data/pv.py
# ---------------------------------------------------------------------------

BATCH_FIELDS = ("keys", "segments", "num_keys", "dense", "label", "show",
                "clk", "batch_size", "num_slots", "segments_trivial")


@pytest.mark.parametrize("wild", [False, True])
def test_pv_batches_byte_identical(wild):
    """The bench's PV shape (8 slots, 10 000 ids a slot, 4 dense) at a
    small batch: every batch field and every rank_offset matrix equals
    the reference's byte for byte."""
    jrecs, trecs = _records(_pv_fields(120, 8, 10_000, 4, seed=1,
                                       wild=wild))
    jdesc, tdesc = _descs(8, 4, 128, 32, 1024)
    jb = jpv.PvBatchBuilder(jdesc, max_rank=MR).batches(jrecs)
    tb = tpv.PvBatchBuilder(tdesc, max_rank=MR).batches(trecs)
    assert len(tb) == len(jb) == 4
    for (jbatch, jro), (tbatch, tro) in zip(jb, tb):
        assert tro.dtype == jro.dtype and tro.tobytes() == jro.tobytes()
        for f in BATCH_FIELDS:
            a, b = getattr(tbatch, f), getattr(jbatch, f)
            if isinstance(a, np.ndarray):
                assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f
            else:
                assert a == b, f
    if not wild:
        assert all(b.segments_trivial for b, _ in tb)
        assert (tb[0][1][:, 0] > 0).any()


@pytest.mark.parametrize("max_rank,pad_to", [(3, 0), (2, 40), (4, 64)])
def test_build_rank_offset_matches_reference(max_rank, pad_to):
    fields = _pv_fields(12, 2, 50, 1, seed=2, wild=True)
    jrecs, trecs = _records(fields)
    jpvs, tpvs = jpv.group_by_search_id(jrecs), tpv.group_by_search_id(trecs)
    assert [[r.ins_id for r in p] for p in tpvs] == \
        [[r.ins_id for r in p] for p in jpvs]
    want = jpv.build_rank_offset(jpvs, max_rank, pad_to)
    got = tpv.build_rank_offset(tpvs, max_rank, pad_to)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    assert (got == -1).any() and (got[:, 0] > 0).any()


def _rec_view(r):
    return (r.keys.tobytes(), r.slot_offsets.tobytes(), r.dense.tobytes(),
            r.label, r.show, r.clk, r.ins_id, r.search_id, r.rank, r.cmatch,
            r.uid, r.timestamp)


def test_merge_and_split_helpers_match_reference():
    fields = _pv_fields(30, 3, 40, 2, seed=3, wild=True)
    jrecs, trecs = _records(fields)
    for merge_size in (0, 2):
        jm, jd = jpv.merge_by_insid(jrecs, merge_size, 3)
        tm, td = tpv.merge_by_insid(trecs, merge_size, 3)
        assert td == jd
        assert [_rec_view(r) for r in tm] == [_rec_view(r) for r in jm]
    jg, tg = jpv.group_by_uid(jrecs), tpv.group_by_uid(trecs)
    assert [[_rec_view(r) for r in g] for g in tg] == \
        [[_rec_view(r) for r in g] for g in jg]
    for method, split, train in ((0, 0, 0), (1, 4, 0), (2, 5, 2)):
        js = jpv.split_uid_groups(jg, method, split, train)
        ts = tpv.split_uid_groups(tg, method, split, train)
        assert [(len(c), z) for c, z in ts] == [(len(c), z) for c, z in js]
        np.testing.assert_array_equal(tpv.build_train_mask(ts, pad_to=200),
                                      jpv.build_train_mask(js, pad_to=200))
    assert tpv.compute_split_num_and_mask(11, 5, 2) == \
        jpv.compute_split_num_and_mask(11, 5, 2)
    ts_arr = np.array([r.timestamp for r in trecs])
    np.testing.assert_array_equal(tpv.timestamp_range_mask(ts_arr, 10, 60),
                                  jpv.timestamp_range_mask(ts_arr, 10, 60))
    with pytest.raises(ValueError, match="train_size"):
        tpv.split_uid_groups(tg, 2, 2, 3)


def test_pv_batch_builder_rejects_bad_configs():
    _, tdesc = _descs(2, 1, 4, 0, 64)
    with pytest.raises(ValueError, match="pv_batch_size"):
        tpv.PvBatchBuilder(tdesc)
    _, tdesc = _descs(2, 1, 4, 2, 64)
    _, trecs = _records(_pv_fields(4, 2, 10, 1, seed=4))
    with pytest.raises(ValueError, match="lower pv_batch_size"):
        tpv.PvBatchBuilder(tdesc).batches(trecs)


# ---------------------------------------------------------------------------
# models/ads_rank.py
# ---------------------------------------------------------------------------

def _ads_case(b=16, s=4, d=6, dense=2, seed=8):
    rng = np.random.default_rng(seed)
    pooled = rng.normal(size=(b, s, d)).astype(np.float32)
    dn = rng.normal(size=(b, dense)).astype(np.float32)
    ro = np.full((b, 1 + 2 * MR), -1, np.int32)
    ro[:, 0] = rng.integers(0, MR + 2, size=b)
    for k in range(MR):
        on = rng.random(b) < 0.7
        ro[:, 1 + 2 * k] = np.where(on, k + 1, -1)
        ro[:, 2 + 2 * k] = rng.integers(0, b, size=b)
    return pooled, dn, ro


def _ads_models(towers, dtype, d_model=8, hidden=(8, 4), s=4, d=6,
                dense=2):
    slot_fc, cross = towers
    jm = JAdsRank(d_model=d_model, max_rank=MR, hidden=hidden,
                  compute_dtype=jnp.float32 if dtype == "f32"
                  else jnp.bfloat16, slot_fc=slot_fc, cross_norm=cross)
    tm = AdsRank(s, d, dense, d_model=d_model, max_rank=MR, hidden=hidden,
                 compute_dtype=torch.float32 if dtype == "f32"
                 else torch.bfloat16, slot_fc=slot_fc, cross_norm=cross)
    return jm, tm


@pytest.mark.parametrize("flags", FLAGS)
@pytest.mark.parametrize("towers", [(True, True), (False, False),
                                    (True, False)])
def test_ads_rank_forward_and_grads_match_reference(flags, towers):
    pooled, dn, ro = _ads_case()
    jm, tm = _ads_models(towers, "f32")
    dm = 8
    jsumm = j_init_summary(1, dm) if towers[1] else None
    with flags_scope(**JAX_FLAGS[flags]):
        params = jm.init(jax.random.PRNGKey(0), jnp.asarray(pooled),
                         jnp.asarray(dn), jnp.asarray(ro), jsumm)
        args = (jnp.asarray(pooled), jnp.asarray(dn), jnp.asarray(ro), jsumm)
        jout = np.asarray(jm.apply(params, *args))
        jgrads = jax.grad(lambda p: jnp.sum(jm.apply(p, *args) ** 2))(params)
    tm.load_state_dict(convert.ads_rank_state_dict_from_flax(
        jax.device_get(params)))
    tsumm = (init_cross_norm_summary(1, dm, device="cpu") if towers[1]
             else None)
    out = tm(torch.from_numpy(pooled), torch.from_numpy(dn),
             torch.from_numpy(ro), tsumm)
    np.testing.assert_allclose(out.detach().numpy(), jout, rtol=1e-4,
                               atol=1e-5)
    (out ** 2).sum().backward()
    want = convert.ads_rank_state_dict_from_flax(jax.device_get(jgrads))
    got = dict(tm.named_parameters())
    assert sorted(got) == sorted(want)
    for name, g in want.items():
        grad = got[name].grad.numpy()
        assert np.all(np.isfinite(grad)), name
        np.testing.assert_allclose(grad, g.numpy(), rtol=5e-3, atol=1e-4,
                                   err_msg=name)


def test_ads_rank_bf16_forward_close_to_reference():
    pooled, dn, ro = _ads_case(seed=9)
    jm, tm = _ads_models((True, True), "bf16")
    jsumm = j_init_summary(1, 8)
    params = jm.init(jax.random.PRNGKey(1), jnp.asarray(pooled),
                     jnp.asarray(dn), jnp.asarray(ro), jsumm)
    jout = np.asarray(jm.apply(params, jnp.asarray(pooled), jnp.asarray(dn),
                               jnp.asarray(ro), jsumm))
    tm.load_state_dict(convert.ads_rank_state_dict_from_flax(
        jax.device_get(params)))
    with torch.no_grad():
        out = tm(torch.from_numpy(pooled), torch.from_numpy(dn),
                 torch.from_numpy(ro),
                 init_cross_norm_summary(1, 8, device="cpu"))
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), jout, rtol=0, atol=5e-2)


def test_ads_rank_cross_norm_needs_a_summary():
    pooled, dn, ro = _ads_case()
    _, tm = _ads_models((False, True), "f32")
    with pytest.raises(ValueError, match="cross_summary"):
        tm(torch.from_numpy(pooled), torch.from_numpy(dn),
           torch.from_numpy(ro))
    with pytest.raises(ValueError, match="not an AdsRank"):
        convert.ads_rank_state_dict_from_flax({"params": {"Dense_0": {}}})


# ---------------------------------------------------------------------------
# ps/table.py: merge_push, push_stats, pull, push
# ---------------------------------------------------------------------------

def test_merge_push_and_push_stats_match_reference():
    rng = np.random.default_rng(5)
    k, u, d = 300, 40, 6
    grads = rng.normal(size=(k, d)).astype(np.float32)
    gidx = rng.integers(0, u, size=k).astype(np.int32)
    gidx[-50:] = u - 1                          # padded keys, all one slot
    kv = (np.arange(k) < k - 50).astype(np.float32)
    kv[rng.random(k) < 0.1] = 0.0
    slot = rng.integers(0, 5, size=k).astype(np.float32)
    jg, jt, js = jtable.merge_push(jnp.asarray(grads), jnp.asarray(gidx),
                                   jnp.asarray(kv), jnp.asarray(slot), u)
    tg, tt, ts = ttable.merge_push(*map(torch.from_numpy,
                                        (grads, gidx, kv, slot)), u)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6)


CFG = dict(mf_create_thresholds=0.0, mf_initial_range=0.0,
           learning_rate=0.05, mf_learning_rate=0.05)
S, MF, DENSE, BS, CAP = 4, 4, 2, 32, 1 << 10


def _tables():
    return (JTable(mf_dim=MF, capacity=CAP, cfg=JCfg(**CFG),
                   unique_bucket_min=256),
            EmbeddingTable(mf_dim=MF, capacity=CAP,
                           cfg=ttable.SparseSGDConfig(**CFG),
                           unique_bucket_min=256, device="cpu"))


def _logical(table):
    keys, rows = table.index.items()
    order = np.argsort(keys)
    return keys[order], table._gather_host(rows[order])


def test_table_pull_push_match_reference():
    """One PV batch: pull values exact, the pushed rows (merge + Adagrad)
    within the Adagrad class (rtol 1e-6), the slot metadata exact."""
    jrecs, trecs = _records(_pv_fields(8, S, 30, DENSE, seed=6))
    jdesc, tdesc = _descs(S, DENSE, BS, 8, 256)
    (jb, _), = jpv.PvBatchBuilder(jdesc, MR).batches(jrecs)
    (tb, _), = tpv.PvBatchBuilder(tdesc, MR).batches(trecs)
    jt, tt = _tables()
    for _ in range(2):                  # the second pull reads pushed rows
        ji, ti = jt.prepare(jb), tt.prepare(tb)
        jv, tv = np.asarray(jt.pull(ji)), tt.pull(ti)
        np.testing.assert_array_equal(tv.numpy(), jv)
        g = np.random.default_rng(7).normal(size=jv.shape).astype(
            np.float32)
        g[ti.gather_idx >= ti.num_unique] = 5.0     # pads must not count
        sok = (jb.segments % S).astype(np.float32)
        jt.push(ji, jnp.asarray(g), jnp.asarray(sok))
        tt.push(ti, torch.from_numpy(g), sok)
    jk, jblob = _logical(jt)
    tk, tblob = _logical(tt)
    np.testing.assert_array_equal(tk, jk)
    for f in sorted(jblob):
        np.testing.assert_allclose(tblob[f], jblob[f], rtol=1e-6, atol=1e-7,
                                   err_msg=f)
    np.testing.assert_array_equal(tt.state.data.numpy()[CAP], 0.0)


# ---------------------------------------------------------------------------
# the slice as a whole: the PV training loop
# ---------------------------------------------------------------------------

DM, HIDDEN = 8, (8,)


def _jax_pv_run(flags, jrecs, jdesc):
    with flags_scope(**JAX_FLAGS[flags]):
        table, _ = _tables()
        model = JAdsRank(d_model=DM, max_rank=MR, hidden=HIDDEN,
                         compute_dtype=jnp.float32, slot_fc=True,
                         cross_norm=True)
        summary = j_init_summary(1, DM)
        batches = jpv.PvBatchBuilder(jdesc, max_rank=MR).batches(jrecs)
        d = 3 + MF
        params = model.init(jax.random.PRNGKey(0), jnp.zeros((BS, S, d)),
                            jnp.zeros((BS, DENSE)),
                            jnp.asarray(batches[0][1]), summary)
        params0 = jax.device_get(params)
        tx = optax.adam(5e-3)
        opt = tx.init(params)

        @jax.jit
        def step(params, opt, values_k, segments, show_clk, dense, label,
                 ro, ins_w):
            def loss_fn(params, values_k):
                pooled = j_seqpool(values_k, segments, show_clk, BS, S)
                logits = model.apply(params, pooled, dense, ro, summary)
                ls = optax.sigmoid_binary_cross_entropy(logits, label)
                return jnp.sum(ls * ins_w) / jnp.maximum(ins_w.sum(), 1.0)
            loss, (gp, gk) = jax.value_and_grad(
                loss_fn, argnums=(0, 1))(params, values_k)
            upd, opt = tx.update(gp, opt, params)
            return optax.apply_updates(params, upd), opt, loss, gk

        losses = []
        for batch, ro in batches:
            idx = table.prepare(batch)
            values_k = table.pull(idx)
            show_clk = jnp.stack([jnp.asarray(batch.show),
                                  jnp.asarray(batch.clk)], axis=1)
            ins_w = jnp.asarray((batch.show > 0).astype(np.float32))
            params, opt, loss, gk = step(
                params, opt, values_k, jnp.asarray(batch.segments),
                show_clk, jnp.asarray(batch.dense), jnp.asarray(batch.label),
                jnp.asarray(ro), ins_w)
            gk = jnp.concatenate([gk[:, :2], gk[:, 2:] * (-1.0 * BS)],
                                 axis=1)
            table.push(idx, gk)
            losses.append(float(loss))
        return params0, jax.device_get(params), table, losses


def _port_pv_run(params0, trecs, tdesc):
    _, table = _tables()
    model = AdsRank(S, 3 + MF, DENSE, d_model=DM, max_rank=MR,
                    hidden=HIDDEN, compute_dtype=torch.float32,
                    slot_fc=True, cross_norm=True)
    model.load_state_dict(convert.ads_rank_state_dict_from_flax(params0))
    summary = init_cross_norm_summary(1, DM, device="cpu")
    opt = torch.optim.Adam(model.parameters(), lr=5e-3, eps=1e-8)
    losses = []
    for batch, ro in tpv.PvBatchBuilder(tdesc, max_rank=MR).batches(trecs):
        idx = table.prepare(batch)
        values_k = table.pull(idx).requires_grad_(True)
        show_clk = torch.from_numpy(np.stack([batch.show, batch.clk], 1))
        ins_w = torch.from_numpy((batch.show > 0).astype(np.float32))
        pooled = fused_seqpool_cvm(values_k,
                                   torch.from_numpy(batch.segments),
                                   show_clk, BS, S)
        logits = model(pooled, torch.from_numpy(batch.dense),
                       torch.from_numpy(ro), summary)
        ls = F.binary_cross_entropy_with_logits(
            logits, torch.from_numpy(batch.label), reduction="none")
        loss = (ls * ins_w).sum() / ins_w.sum().clamp_min(1.0)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        gk = values_k.grad
        gk[:, 2:] *= -1.0 * BS
        table.push(idx, gk)
        losses.append(float(loss.detach()))
    return model, table, losses


@pytest.mark.parametrize("flags", FLAGS)
def test_pv_training_matches_jax_loop(flags):
    """Five PV batches of 32 rows (S=4, d_model 8, slot_fc and cross_norm
    on) through the bench's loop in both packages from the same params:
    the logical table rows keyed by feasign and the dense params agree."""
    jrecs, trecs = _records(_pv_fields(40, S, 60, DENSE, seed=0))
    jdesc, tdesc = _descs(S, DENSE, BS, 8, 256)
    params0, jparams, jt, jloss = _jax_pv_run(flags, jrecs, jdesc)
    model, tt, tloss = _port_pv_run(params0, trecs, tdesc)
    assert len(tloss) == len(jloss) == 5
    np.testing.assert_allclose(tloss, jloss, rtol=STATE_RTOL)
    jk, jblob = _logical(jt)
    tk, tblob = _logical(tt)
    np.testing.assert_array_equal(tk, jk)
    for f in sorted(jblob):
        np.testing.assert_allclose(tblob[f], jblob[f], rtol=STATE_RTOL,
                                   atol=STATE_ATOL, err_msg=f)
    assert (tblob["mf_size"] > 0).any()
    want = convert.ads_rank_state_dict_from_flax(jparams)
    start = convert.ads_rank_state_dict_from_flax(params0)
    assert not torch.equal(want["rank_param"], start["rank_param"])
    got = model.state_dict()
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w.numpy(),
                                   rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                   err_msg=name)
    np.testing.assert_array_equal(tt.state.data.numpy()[CAP], 0.0)
