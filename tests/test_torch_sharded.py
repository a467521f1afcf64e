"""The port's sharded table and multi-shard trainer against the JAX
package's, on the CPU (the reference on its 8-device CPU mesh).

Inputs come from numpy seeds and cross as numpy. The reference runs with
``use_pallas_index`` off (its flag-on sharded gates fail on this JAX).
Tolerances: routing plans, row assignment, pulls, the save files and the
chunked-vs-monolithic and flag-on-vs-off digests are exact. Training
runs hold the reference's ragged train-state class, rtol 2e-4 / atol
2e-5, and the AUC 1e-5, as ``tests/test_torch_train.py`` does. Lazy mf
creation draws zeros on both sides (``mf_initial_range`` 0), so the two
packages' random streams never enter a comparison.
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
from paddlebox_tpu.data.batch import BatchBuilder as JBuilder
from paddlebox_tpu.data.batch import SlotBatch as JSlotBatch
from paddlebox_tpu.data.dataset import InMemoryDataset as JDataset
from paddlebox_tpu.data.record import SlotRecord as JRecord
from paddlebox_tpu.models import DeepFM as JDeepFM
from paddlebox_tpu.parallel import make_mesh
from paddlebox_tpu.ps import SparseSGDConfig as JCfg
from paddlebox_tpu.ps import table as jtable
from paddlebox_tpu.ps.sharded import ShardedEmbeddingTable as JSharded
from paddlebox_tpu.train.sharded import ShardedTrainer as JShardedTrainer
from paddlebox_tpu.train.sharded import \
    make_global_arrays as j_make_global_arrays

from paddlebox_tpu_torch import DeepFM, EmbeddingTable, InMemoryDataset
from paddlebox_tpu_torch import convert
from paddlebox_tpu_torch import metrics as tmetrics
from paddlebox_tpu_torch.config import flags_scope
from paddlebox_tpu_torch.data import (BatchBuilder, DataFeedDesc, SlotDef,
                                      SlotRecord)
from paddlebox_tpu_torch.data.batch import SlotBatch
from paddlebox_tpu_torch.device import seeded_generator
from paddlebox_tpu_torch.ops import index as tindex
from paddlebox_tpu_torch.ps import table as ttable
from paddlebox_tpu_torch.ps.sgd import SparseSGDConfig
from paddlebox_tpu_torch.ps.sharded import ShardedEmbeddingTable
from paddlebox_tpu_torch.train import sharded as tsharded
from paddlebox_tpu_torch.train.checkpoint import (elastic_state_digest,
                                                  sharded_state_digest)
from paddlebox_tpu_torch.train.sharded import (ShardedTrainer,
                                               make_global_batch)
from paddlebox_tpu_torch.utils.dump import DumpConfig

STATE_RTOL, STATE_ATOL = 2e-4, 2e-5
S, MF, DENSE, BS, CAP = 4, 4, 3, 32, 2048
VOCAB = 300                      # ids per slot; key = slot * 1000 + id
CFG = dict(mf_create_thresholds=0.0, mf_initial_range=0.0,
           learning_rate=0.05, mf_learning_rate=0.05)
TABLE_KW = dict(req_bucket_min=64, serve_bucket_min=128)
PLAN_FIELDS = ("resp_idx", "serve_rows", "serve_valid", "serve_slot",
               "gather_idx", "key_valid", "req_capacity", "serve_capacity",
               "req_need", "serve_need", "a2a_sections", "key_sections",
               "slot_sections", "key_segments")


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

def _arrays(n, seed, vocab=VOCAB):
    """Ragged records with slot-qualified keys (every key in one slot),
    as numpy: (keys, slot_offsets, dense, label)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        counts = np.minimum(rng.zipf(1.5, size=S), 6)
        offs = np.zeros(S + 1, np.int32)
        np.cumsum(counts, out=offs[1:])
        slot = np.repeat(np.arange(S), counts)
        keys = (slot * 1000 + rng.integers(0, vocab, size=int(offs[-1]))
                ).astype(np.uint64)
        out.append((keys, offs, rng.normal(size=DENSE).astype(np.float32),
                    float(rng.random() < 0.3)))
    return out


def _slots(cls):
    return ([cls("label", "float", 1), cls("d", "float", DENSE)]
            + [cls(f"S{i}", "uint64") for i in range(S)])


def _descs():
    return (JDesc(slots=_slots(JSlotDef), label_slot="label",
                  batch_size=BS, key_bucket_min=128),
            DataFeedDesc(slots=_slots(SlotDef), label_slot="label",
                         batch_size=BS, key_bucket_min=128))


def _datasets(arrs):
    jdesc, tdesc = _descs()
    jds, tds = JDataset(jdesc), InMemoryDataset(tdesc)
    jds.records = [JRecord(k, o, d, l, 1.0, l) for k, o, d, l in arrs]
    tds.records = [SlotRecord(k, o, d, l, 1.0, l) for k, o, d, l in arrs]
    return jds, tds


def _batches(arrs, n_local):
    """(JAX, port) SlotBatch lists of ``n_local`` batches each."""
    jdesc, tdesc = _descs()
    jb, tb = JBuilder(jdesc), BatchBuilder(tdesc)
    jout, tout = [], []
    for i in range(n_local):
        part = arrs[i * BS:(i + 1) * BS]
        jout.append(jb.build([JRecord(k, o, d, l, 1.0, l)
                              for k, o, d, l in part]))
        tout.append(tb.build([SlotRecord(k, o, d, l, 1.0, l)
                              for k, o, d, l in part]))
    return jout, tout


def _empty_batch(cls, like):
    """A local batch with no keys (its records have empty slots)."""
    return cls(keys=np.zeros_like(like.keys),
               segments=np.full_like(like.segments, like.pad_segment),
               num_keys=0, dense=like.dense.copy(), label=like.label.copy(),
               show=like.show.copy(), clk=like.clk.copy(),
               batch_size=like.batch_size, num_slots=like.num_slots)


def _global_groups(n, seed):
    """Three global batches of ``n`` local batches (JAX, port): one with
    an empty local batch, and a tail group padded as the trainers pad
    it (``group_batches``)."""
    jb, tb = _batches(_arrays(BS * (3 * n - 2), seed), 3 * n - 2)
    jb[1] = _empty_batch(JSlotBatch, jb[1])
    tb[1] = _empty_batch(SlotBatch, tb[1])
    return (list(tsharded.group_batches(jb, n)),
            list(tsharded.group_batches(tb, n)))


def _base_blob(seed, n_keys=600, no_mf=0.3):
    """A seeded single-table save mapping of slot-qualified keys; a
    ``no_mf`` share has no mf yet, so lazy mf creation runs."""
    rng = np.random.default_rng(seed)
    ids = rng.choice(S * VOCAB, size=n_keys, replace=False)
    keys = ((ids // VOCAB) * 1000 + ids % VOCAB).astype(np.uint64)
    rows = np.zeros((n_keys, 8 + MF), np.float32)
    rows[:, 0] = rng.integers(1, 50, size=n_keys)
    rows[:, 1] = np.floor(rows[:, 0] * rng.random(n_keys) * 0.3)
    rows[:, 2] = rng.random(n_keys)
    rows[:, 3] = (keys // np.uint64(1000)).astype(np.float32)
    rows[:, 4] = rng.normal(0, 0.05, size=n_keys)
    rows[:, 5:7] = 3.0
    rows[:, 7] = (rng.random(n_keys) >= no_mf).astype(np.float32)
    rows[:, 8:] = rng.normal(0, 0.05, size=(n_keys, MF)) * rows[:, 7:8]
    return convert.table_rows_from_logical(keys, rows, MF)


def _port_table(n, cap=CAP, **kw):
    return ShardedEmbeddingTable(n, mf_dim=MF, capacity_per_shard=cap,
                                 cfg=SparseSGDConfig(**CFG), devices="cpu",
                                 **{**TABLE_KW, **kw})


def _jax_table(n, cap=CAP):
    return JSharded(n, mf_dim=MF, capacity_per_shard=cap, cfg=JCfg(**CFG),
                    **TABLE_KW)


def _assert_plan_equal(got, want):
    for f in PLAN_FIELDS:
        g, w = getattr(got, f), getattr(want, f)
        if isinstance(w, np.ndarray):
            np.testing.assert_array_equal(g, w, err_msg=f)
        elif w is None:
            assert g is None, f
        else:
            assert tuple(g) == w if isinstance(w, tuple) else g == w, f


# ---------------------------------------------------------------------------
# the routing plans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,groups", [(4, 1), (4, 4), (8, 1), (8, 4)])
def test_prepare_global_matches_jax(n, groups):
    jgroups, tgroups = _global_groups(n, seed=n + groups)
    jt, tt = _jax_table(n), _port_table(n)
    for jg, tg in zip(jgroups, tgroups):
        want = jt.prepare_global(jg, groups=groups)
        got = tt.prepare_global(tg, groups=groups)
        if groups > 1:
            assert got.a2a_sections, "the grouped plan fell back"
        _assert_plan_equal(got, want)
        # the eval plan: lookups only, unknown keys serve the sentinel
        _assert_plan_equal(tt.prepare_global_eval(tg),
                           jt.prepare_global_eval(jg))
    for s in range(n):
        jk, jr = jt.indexes[s].items()
        tk, tr = tt.indexes[s].items()
        assert dict(zip(jk.tolist(), jr.tolist())) == dict(
            zip(tk.tolist(), tr.tolist()))
    np.testing.assert_array_equal(tt._touched, jt._touched)
    # the staged stacked arrays are the reference's too
    jg, tg = jgroups[0], tgroups[0]
    want = j_make_global_arrays(jg, jt.prepare_global(jg, groups=groups))
    got = tsharded.make_global_arrays(tg, tt.prepare_global(tg,
                                                            groups=groups))
    for f in want:
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)


def test_grouped_plan_falls_back_on_unqualified_keys():
    """Keys that span slot groups within a batch get the monolithic
    plan, with the same bytes as groups=1, in both packages."""
    jb, tb = _batches(_arrays(BS * 4, seed=9), 4)
    for b in jb + tb:
        b.keys[:b.num_keys] = b.keys[:b.num_keys] % np.uint64(1000)
    t1, t2 = _port_table(4), _port_table(4)
    p1 = t1.prepare_global(tb)
    p2 = t2.prepare_global(tb, groups=2)
    assert p2.a2a_sections == () and p2.key_segments is None
    _assert_plan_equal(p2, p1)
    _assert_plan_equal(p2, _jax_table(4).prepare_global(jb, groups=2))


# ---------------------------------------------------------------------------
# the pull
# ---------------------------------------------------------------------------

def test_sharded_pull_matches_single_table():
    """The pull through the owners' gathers and the exchange equals one
    table's pull of the same keys holding the same rows, exactly."""
    n = 4
    base = _base_blob(seed=1)
    st = _port_table(n)
    st.load(base)
    single = EmbeddingTable(mf_dim=MF, capacity=CAP * n,
                            cfg=SparseSGDConfig(**CFG), device="cpu")
    single.load(base)
    _, tb = _batches(_arrays(BS * n, seed=4), n)
    step = tsharded.ShardedTrainStep(None, st.cfg, st.devices, BS, S)
    for plan in (st.prepare_global_eval(tb), st.prepare_global(tb)):
        gb = make_global_batch(tb, plan, st.devices)
        got = step.pull(st.states, gb)
        for d, b in enumerate(tb):
            idx = single.prepare_eval(b)
            want = single.pull(idx)[:b.num_keys]
            assert got[d].shape == want.shape
            assert torch.equal(got[d], want), f"destination {d}"


# ---------------------------------------------------------------------------
# merge_rows and apply_push's new arguments
# ---------------------------------------------------------------------------

def test_merge_rows_matches_reference_and_repeats():
    rng = np.random.default_rng(5)
    m, d, u = 700, 7, 300
    vals = rng.normal(size=(m, d)).astype(np.float32)
    idx = rng.integers(0, u, size=m).astype(np.int32)
    want = np.asarray(jtable.merge_rows(jnp.asarray(vals), jnp.asarray(idx),
                                        u))
    got = ttable.merge_rows(torch.from_numpy(vals), torch.from_numpy(idx), u)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    with torch.no_grad():
        torch.use_deterministic_algorithms(True)
        try:
            again = ttable.merge_rows(torch.from_numpy(vals),
                                      torch.from_numpy(idx), u)
        finally:
            torch.use_deterministic_algorithms(False)
    assert torch.equal(again, got)
    # at most one term a row in a src-major layout sums in that order
    one = np.arange(u, dtype=np.int32)
    ord2 = ttable.merge_rows(torch.from_numpy(np.concatenate([vals[:u],
                                                              vals[u:2 * u]])),
                             torch.from_numpy(np.concatenate([one, one])), u)
    assert torch.equal(ord2, torch.from_numpy(vals[:u] + vals[u:2 * u]))


@pytest.mark.parametrize("explicit", [False, True])
def test_apply_push_touched_and_slot_match_reference(explicit):
    """``touched``/``slot_val`` left out keep today's result bit for bit
    (the default touched is every row below the sentinel); given, they
    match the reference's arguments."""
    rng = np.random.default_rng(6)
    cap, u, f = 64, 20, 8 + MF
    data = rng.normal(size=(cap + 1, f)).astype(np.float32)
    data[:, 0] = np.abs(data[:, 0]) * 10
    data[cap] = 0.0
    rows = np.concatenate([rng.permutation(cap)[:u - 4],
                           cap + 1 + np.arange(4)]).astype(np.int32)
    grads = rng.normal(size=(u, 3 + MF)).astype(np.float32)
    grads[:, 0] = 1.0
    touched = rng.random(u) < 0.7
    slot_val = rng.integers(0, S, size=u).astype(np.float32)
    cfg = dict(CFG, mf_create_thresholds=1e9)
    kw = (dict(touched=torch.from_numpy(touched),
               slot_val=torch.from_numpy(slot_val)) if explicit else {})
    st = ttable.TableState(torch.from_numpy(data.copy()))
    init = torch.zeros(u, MF)
    ttable.apply_push(st, torch.from_numpy(rows), torch.from_numpy(grads),
                      SparseSGDConfig(**cfg), init=init, **kw)
    jkw = (dict(touched=jnp.asarray(touched),
                slot_val=jnp.asarray(slot_val)) if explicit else {})
    ref = jtable.apply_push(jtable.TableState.from_logical(data, cap),
                            jnp.asarray(rows), jnp.asarray(grads),
                            JCfg(**cfg), jax.random.PRNGKey(0), **jkw)
    np.testing.assert_allclose(st.data.numpy(), np.asarray(ref.data),
                               rtol=1e-6, atol=0)
    if not explicit:
        # the explicit default equals the implicit one bit for bit
        st2 = ttable.TableState(torch.from_numpy(data.copy()))
        r = torch.from_numpy(rows)
        ttable.apply_push(st2, r, torch.from_numpy(grads),
                          SparseSGDConfig(**cfg), init=init, touched=r < cap)
        assert torch.equal(st2.data, st.data)
    else:
        live = rows[touched & (rows < cap)]
        np.testing.assert_array_equal(st.data.numpy()[live, 3],
                                      slot_val[touched & (rows < cap)])


def test_apply_push_draw_rows():
    """``draw_rows``: the lazy-mf draw covers the first ``draw_rows`` rows
    (a generator's ``rand(draw_rows, mf)``) and the padded rest draw
    zeros; without it the draw covers every row."""
    cap, u, n = 32, 12, 7
    data = np.zeros((cap + 1, 8 + MF), np.float32)
    rows = torch.arange(u, dtype=torch.int32)
    grads = torch.zeros(u, 3 + MF)
    grads[:, 0] = 1.0                   # a show: every row creates its mf
    cfg = SparseSGDConfig(**dict(CFG, mf_initial_range=0.5))
    want = torch.rand(n, MF, generator=seeded_generator("cpu", 4, 9)) * 0.5
    st = ttable.TableState(torch.from_numpy(data.copy()))
    ttable.apply_push(st, rows, grads, cfg,
                      generator=seeded_generator("cpu", 4, 9), draw_rows=n)
    assert torch.equal(st.data[:n, 8:], want)
    assert not st.data[n:u, 8:].any()
    assert (st.data[:u, 7] == 1.0).all()
    full = ttable.TableState(torch.from_numpy(data.copy()))
    ttable.apply_push(full, rows, grads, cfg,
                      generator=seeded_generator("cpu", 4, 9))
    assert torch.equal(full.data[:u, 8:], torch.rand(
        u, MF, generator=seeded_generator("cpu", 4, 9)) * 0.5)


# ---------------------------------------------------------------------------
# training against the reference
# ---------------------------------------------------------------------------

CONFIGS = {"mono": dict(chunks=1, zero1=False),
           "chunked": dict(chunks=4, zero1=False),
           "zero1": dict(chunks=1, zero1=True)}
TRAIN_N = 4


def _train_arrays():
    # 11 local batches (the last one short): 3 global steps at N = 4,
    # the tail group padded with a dead copy
    return _arrays(BS * 10 + 7, seed=21)


def _jax_logical(table):
    data = np.asarray(jax.device_get(table.state.data))
    keys, blocks = [], []
    for s in range(table.n):
        k, r = table.indexes[s].items()
        keys.append(k)
        blocks.append(data[s][r])
    keys = np.concatenate(keys)
    order = np.argsort(keys)
    return keys[order], np.concatenate(blocks)[order]


def _port_logical(table):
    keys, blocks = [], []
    for s in range(table.n):
        k, r = table.indexes[s].items()
        keys.append(k)
        blocks.append(table._rows_host(s, r))
    keys = np.concatenate(keys)
    order = np.argsort(keys)
    return keys[order], np.concatenate(blocks)[order]


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """The reference's sharded trainer, per config: its starting state
    (converted for the port), and after two train passes and an eval
    pass its logical rows, dense params and results."""
    jds, _ = _datasets(_train_arrays())
    jdesc, _ = _descs()
    base = str(tmp_path_factory.mktemp("base") / "base.npz")
    np.savez(base, **_base_blob(seed=2))
    mesh = make_mesh(TRAIN_N)
    out = {}
    for name, c in CONFIGS.items():
        table = _jax_table(TRAIN_N)
        table.load(base)
        with j_flags_scope(a2a_chunks=c["chunks"]):
            tr = JShardedTrainer(JDeepFM(hidden=(16, 8),
                                         compute_dtype=jnp.float32),
                                 table, jdesc, mesh, tx=optax.adam(1e-2),
                                 seed=3, zero1=c["zero1"])
            start = dict(
                params=convert.deepfm_state_dict_from_flax(
                    jax.device_get(tr.state.params)),
                table=convert.sharded_table_from_packed(
                    jax.device_get(table.state.packed),
                    [table.indexes[s].items() for s in range(TRAIN_N)],
                    CAP, MF))
            res = [tr.train_pass(jds) for _ in range(2)]
        ev = tr.eval_pass(jds)
        keys, rows = _jax_logical(table)
        out[name] = dict(start=start, res=res, eval=ev, keys=keys, rows=rows,
                         params=convert.deepfm_state_dict_from_flax(
                             jax.device_get(tr.state.params)))
    return out


def _port_trainer(start, chunks=1, zero1=False, n=TRAIN_N, **kw):
    _, tdesc = _descs()
    table = _port_table(n)
    table.load(start["table"])
    model = DeepFM(S, 3 + MF, DENSE, hidden=(16, 8),
                   compute_dtype=torch.float32)
    model.load_state_dict(start["params"])
    with flags_scope(a2a_chunks=chunks):
        return ShardedTrainer(
            model, table, tdesc,
            tx=lambda p: torch.optim.Adam(p, lr=1e-2, eps=1e-8), seed=3,
            zero1=zero1, **kw)


@pytest.fixture(scope="module")
def port_runs(jax_runs):
    _, tds = _datasets(_train_arrays())
    out = {}
    # one thread: the CPU's accumulating index_put_ sums in key order,
    # which the bitwise digest comparisons below rely on
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    for name, c in CONFIGS.items():
        tr = _port_trainer(jax_runs[name]["start"], c["chunks"], c["zero1"])
        res = [tr.train_pass(tds) for _ in range(2)]
        ev = tr.eval_pass(tds)
        keys, rows = _port_logical(tr.table)
        out[name] = dict(tr=tr, res=res, eval=ev, keys=keys, rows=rows,
                         digest=sharded_state_digest(tr))
    yield out
    torch.set_num_threads(threads)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_train_pass_matches_jax(name, jax_runs, port_runs):
    j, t = jax_runs[name], port_runs[name]
    np.testing.assert_array_equal(t["keys"], j["keys"])
    np.testing.assert_allclose(t["rows"], j["rows"], rtol=STATE_RTOL,
                               atol=STATE_ATOL)
    start = j["start"]["table"]
    assert (t["rows"][:, 7] > 0).sum() > sum(
        (start[f"mf_size_{s}"] > 0).sum() for s in range(TRAIN_N))
    # lazy mf creation ran
    sd = t["tr"].model.state_dict()
    for k, want in j["params"].items():
        np.testing.assert_allclose(sd[k].numpy(), want.numpy(),
                                   rtol=STATE_RTOL, atol=STATE_ATOL,
                                   err_msg=k)
    for jr, tr in zip(j["res"], t["res"]):
        assert tr["batches"] == jr["batches"] == 3
        assert tr["ins_num"] == jr["ins_num"]
        np.testing.assert_allclose(tr["auc"], jr["auc"], rtol=0, atol=1e-5)
        np.testing.assert_allclose(tr["last_loss"], jr["last_loss"],
                                   rtol=STATE_RTOL)
    # the eval pass's AUC over the trained state
    assert t["eval"]["batches"] == j["eval"]["batches"]
    np.testing.assert_allclose(t["eval"]["auc"], j["eval"]["auc"], rtol=0,
                               atol=1e-5)
    for tab in t["tr"].table.states:
        assert not tab.data[CAP].any(), "the sentinel row was written"


def test_chunked_and_zero1_against_monolithic(port_runs):
    """The chunked schedule gives the monolithic one's bits; ZeRO-1 the
    replicated update's (Adam is elementwise, each chunk steps the same
    float ops)."""
    assert port_runs["chunked"]["digest"] == port_runs["mono"]["digest"]
    # every global batch ran the chunked schedule, none fell back
    for name, want in (("chunked", 3), ("mono", 0)):
        assert [r["chunked_batches"] for r in port_runs[name]["res"]] == [
            want, want]
    m, z = port_runs["mono"]["tr"], port_runs["zero1"]["tr"]
    for k, v in m.model.state_dict().items():
        np.testing.assert_allclose(z.model.state_dict()[k].numpy(),
                                   v.numpy(), rtol=1e-6, atol=1e-7,
                                   err_msg=k)
    np.testing.assert_allclose(port_runs["zero1"]["rows"],
                               port_runs["mono"]["rows"], rtol=1e-6,
                               atol=1e-7)


@pytest.mark.parametrize("chunks", [2, 4])
def test_chunked_digest_repeats(chunks, jax_runs, port_runs):
    """chunks 2 and 4 (26 % 4 != 0 in the criteo width; here 4 slots in
    groups of 2/2 and 1/1/1/1) equal the monolithic digest, run again."""
    _, tds = _datasets(_train_arrays())
    tr = _port_trainer(jax_runs["mono"]["start"], chunks=chunks)
    for _ in range(2):
        res = tr.train_pass(tds)
        assert res["chunked_batches"] == res["batches"] == 3
    tr.eval_pass(tds)
    assert sharded_state_digest(tr) == port_runs["mono"]["digest"]


def test_zero1_chunked_equals_monolithic(jax_runs, port_runs):
    _, tds = _datasets(_train_arrays())
    tr = _port_trainer(jax_runs["zero1"]["start"], chunks=2, zero1=True)
    for _ in range(2):
        tr.train_pass(tds)
    tr.eval_pass(tds)
    assert sharded_state_digest(tr) == port_runs["zero1"]["digest"]


def test_zero1_needs_an_elementwise_optimizer():
    class GlobalNormSGD(torch.optim.SGD):
        """SGD on grads scaled by their global norm: not elementwise."""

        def step(self, closure=None):
            ps = [p for g in self.param_groups for p in g["params"]]
            norm = torch.sqrt(sum((p.grad ** 2).sum() for p in ps))
            for p in ps:
                p.grad = p.grad / norm
            return super().step(closure)

    with pytest.raises(ValueError, match="ELEMENTWISE"):
        tsharded.ShardedTrainStep(lambda p: GlobalNormSGD(p, lr=0.1),
                                  SparseSGDConfig(), ["cpu"] * 2, BS, S,
                                  zero1=True)
    tsharded.ShardedTrainStep(lambda p: torch.optim.Adam(p, lr=0.1),
                              SparseSGDConfig(), ["cpu"] * 2, BS, S,
                              zero1=True)


def test_push_generators_spread_the_trainer_stream():
    """Owner s at global step t draws from (seed + 1, t * N + s): one
    shard draws the port Trainer's stream, four shards four streams."""
    cpu = torch.device("cpu")
    one = tsharded.push_generators([cpu], 5, 7)[0]
    want = seeded_generator(cpu, 6, 7)
    assert torch.equal(torch.rand(8, generator=one),
                       torch.rand(8, generator=want))
    draws = [torch.rand(8, generator=g)
             for g in tsharded.push_generators([cpu] * 4, 5, 7)]
    assert torch.equal(draws[1], torch.rand(
        8, generator=seeded_generator(cpu, 6, 7 * 4 + 1)))
    assert len({tuple(d.tolist()) for d in draws}) == 4


def test_lr_map_waits_for_dense_modes():
    """``lr_map`` came with ``train/dense_modes``: a frozen layer of the
    sharded trainer stays at its start through a pass."""
    _, tdesc = _descs()
    _, tds = _datasets(_train_arrays())
    tr = ShardedTrainer(DeepFM(S, 3 + MF, DENSE, hidden=(4,)),
                        _port_table(2), tdesc, lr_map={"out": 0.0},
                        lr_map_base=1e-3)
    start = {k: v.clone() for k, v in tr.model.state_dict().items()}
    tr.train_pass(tds)
    after = tr.model.state_dict()
    for k in ("out.weight", "out.bias"):
        assert torch.equal(after[k], start[k]), k
    assert not torch.equal(after["first.weight"], start["first.weight"])


# the same two layers on each side: hidden.0 frozen (scale 0) and the
# output layer boosted (scale 5: the old + s * (new - old) branch)
LR_MAP_JAX = {"Dense_1": 0.0, "Dense_3": 5e-2}
LR_MAP_PORT = {"hidden.0": 0.0, "out": 5e-2}


@pytest.mark.parametrize("zero1", [False, True])
def test_lr_map_matches_jax(zero1, tmp_path):
    """``lr_map`` on the sharded trainer against the reference's, from
    the same converted start, two passes: replicated (the optimizer
    wrapped by ``LrMapOptimizer``) and ZeRO-1 (the scales raveled and
    padded over the flat chunks). Rows and params in the ragged
    train-state class, keys exact, the frozen layer at its start bit for
    bit on both sides."""
    jds, tds = _datasets(_train_arrays())
    jdesc, _ = _descs()
    base = str(tmp_path / "base.npz")
    np.savez(base, **_base_blob(seed=2))
    table = _jax_table(TRAIN_N)
    table.load(base)
    jtr = JShardedTrainer(JDeepFM(hidden=(16, 8), compute_dtype=jnp.float32),
                          table, jdesc, make_mesh(TRAIN_N),
                          tx=optax.adam(1e-2), seed=3, zero1=zero1,
                          lr_map=LR_MAP_JAX, lr_map_base=1e-2)
    start = dict(
        params=convert.deepfm_state_dict_from_flax(
            jax.device_get(jtr.state.params)),
        table=convert.sharded_table_from_packed(
            jax.device_get(table.state.packed),
            [table.indexes[s].items() for s in range(TRAIN_N)], CAP, MF))
    jres = [jtr.train_pass(jds) for _ in range(2)]
    jkeys, jrows = _jax_logical(table)
    jparams = convert.deepfm_state_dict_from_flax(
        jax.device_get(jtr.state.params))

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        tr = _port_trainer(start, zero1=zero1, lr_map=LR_MAP_PORT,
                           lr_map_base=1e-2)
        res = [tr.train_pass(tds) for _ in range(2)]
    finally:
        torch.set_num_threads(threads)
    keys, rows = _port_logical(tr.table)
    sd = tr.model.state_dict()
    for k in ("hidden.0.weight", "hidden.0.bias"):
        assert torch.equal(jparams[k], start["params"][k]), k
        assert torch.equal(sd[k], start["params"][k]), k
    for k in ("out.weight", "out.bias", "first.weight"):
        assert not torch.equal(sd[k], start["params"][k]), k
    for k, want in jparams.items():
        np.testing.assert_allclose(sd[k].numpy(), want.numpy(),
                                   rtol=STATE_RTOL, atol=STATE_ATOL,
                                   err_msg=k)
    np.testing.assert_array_equal(keys, jkeys)
    np.testing.assert_allclose(rows, jrows, rtol=STATE_RTOL,
                               atol=STATE_ATOL)
    for jr, r in zip(jres, res):
        assert r["ins_num"] == jr["ins_num"]
        np.testing.assert_allclose(r["auc"], jr["auc"], rtol=0, atol=1e-5)
        np.testing.assert_allclose(r["last_loss"], jr["last_loss"],
                                   rtol=STATE_RTOL)


# ---------------------------------------------------------------------------
# the device key index route
# ---------------------------------------------------------------------------

def _flag_run(flag, start):
    _, tds = _datasets(_train_arrays())
    with flags_scope(use_pallas_index=flag):
        tr = _port_trainer(start)
        tr.train_pass(tds)
        ev = tr.eval_pass(tds)
    return tr, ev


def _dispatches():
    return {(op, impl): tindex.DISPATCH.get((f"index.{op}", impl), 0)
            for op in ("assign", "lookup") for impl in ("device", "host")}


def test_index_route_digest_matches_flag_off(jax_runs):
    start = jax_runs["mono"]["start"]
    before = _dispatches()
    on, ev_on = _flag_run(True, start)
    ticks = {k: v - before[k] for k, v in _dispatches().items()}
    assert ticks[("assign", "device")] > 0
    assert ticks[("lookup", "device")] > 0
    assert ticks[("assign", "host")] == ticks[("lookup", "host")] == 0
    off, ev_off = _flag_run(False, start)
    assert elastic_state_digest(on) == elastic_state_digest(off)
    assert sharded_state_digest(on) == sharded_state_digest(off)
    assert ev_on["auc"] == ev_off["auc"]
    for s, dev in enumerate(on.table._dev_indexes):
        assert dev is not None and not dev.degraded
        assert dev.next_row == len(on.table.indexes[s])


def test_index_route_holes_degrade_loudly(caplog):
    def run(flag):
        t = _port_table(2)
        jg, tg = _global_groups(2, seed=5)
        with flags_scope(use_pallas_index=flag):
            t.prepare_global(tg[0])
            # free-list holes behind the mirrors' back: release the
            # earliest row of each shard, so its kv is not dense
            for s in range(2):
                keys, rows = t.indexes[s].items()
                t.indexes[s].release(keys[np.argsort(rows)[:1]])
            plan = t.prepare_global(tg[1])
        return t, plan

    t0, p0 = run(False)
    before = _dispatches()[("assign", "host")]
    with caplog.at_level("WARNING"):
        t1, p1 = run(True)
    _assert_plan_equal(p1, p0)
    for s in range(2):
        assert dict(zip(*[a.tolist() for a in t0.indexes[s].items()])) == \
            dict(zip(*[a.tolist() for a in t1.indexes[s].items()]))
    assert all(t1._dev_indexes[s].degraded for s in range(2))
    assert "degraded" in caplog.text
    assert _dispatches()[("assign", "host")] > before


# ---------------------------------------------------------------------------
# metrics, dump, checkpoint hooks
# ---------------------------------------------------------------------------

class _TwoPartCollective:
    """A stand-in for the multi-process collective: the two workers'
    arrays, summed."""

    def __init__(self, other):
        self.other = other

    def allreduce_sum(self, arrays):
        return [a + b for a, b in zip(arrays, self.other)]


def test_auc_compute_global_over_two_parts():
    rng = np.random.default_rng(8)
    parts = [tmetrics.init_auc_state(1000, device="cpu") for _ in range(2)]
    whole = tmetrics.init_auc_state(1000, device="cpu")
    for i in range(4):
        pred = rng.random(200).astype(np.float32)
        label = (rng.random(200) < pred).astype(np.float32)
        w = (rng.random(200) < 0.9).astype(np.float32)
        args = [torch.from_numpy(x) for x in (pred, label, w)]
        tmetrics.auc_add_batch(parts[i % 2], *args)
        tmetrics.auc_add_batch(whole, *args)
    other = [parts[1].buckets.numpy(), parts[1].sums.numpy()]
    got = tmetrics.auc_compute_global(parts[0], _TwoPartCollective(other))
    want = tmetrics.auc_compute(whole)
    assert got.auc == want.auc
    for k, v in want.as_dict().items():
        np.testing.assert_allclose(got.as_dict()[k], v, rtol=1e-6)


def test_registry_feed_and_dump_per_shard(jax_runs, tmp_path):
    _, tds = _datasets(_train_arrays())
    tr = _port_trainer(jax_runs["mono"]["start"])
    tr.metrics.init_metric("auc", "auc")
    tr.set_dump(DumpConfig(str(tmp_path / "dump"), interval=1))
    res = tr.train_pass(tds)
    parts = sorted(tmp_path.glob("dump.part-*"))
    assert len(parts) == TRAIN_N
    lines = sum(len(p.read_text().splitlines()) for p in parts)
    assert lines == res["examples"] == len(tds.records)
    msg = tr.metrics.get_metric_msg("auc")
    np.testing.assert_allclose(msg["auc"], res["auc"], atol=1e-6)


def test_snapshot_restore_roundtrip(jax_runs, port_runs, tmp_path):
    """save_base → load into a fresh table and a fresh trainer restored
    from dense_snapshot gives the same logical digest."""
    src = port_runs["mono"]["tr"]
    path = str(tmp_path / "base.npz")
    assert src.table.save_base(path) == src.table.feature_count()
    tr = _port_trainer(jax_runs["mono"]["start"])
    tr.table.load(path)
    snap = src.dense_snapshot()
    tr.restore_state(snap["model"], snap["opt"], snap["auc"],
                     src.global_step)
    assert elastic_state_digest(tr) == elastic_state_digest(src)


# ---------------------------------------------------------------------------
# save files and the table lifecycle
# ---------------------------------------------------------------------------

def _planted(n, seed, scale=1.0):
    """A port table whose keys got rows through prepare_global, with
    embed_w = key * scale planted on the card-side rows."""
    t = _port_table(n)
    _, tb = _batches(_arrays(BS * n, seed=seed), n)
    t.prepare_global(tb)
    for s in range(n):
        keys, rows = t.indexes[s].items()
        t.states[s].data[torch.from_numpy(rows.astype(np.int64)), 4] = \
            torch.from_numpy(keys.astype(np.float32) * scale)
    return t


def test_save_load_roundtrip_and_reshard(tmp_path):
    t = _planted(4, seed=5, scale=2.0)
    path = str(tmp_path / "s.npz")
    n_saved = t.save_base(path)
    assert n_saved == t.feature_count() > 0
    for n in (4, 8, 3):
        t2 = _port_table(n)
        assert t2.load(path) == n_saved
        for s in range(n):
            keys, rows = t2.indexes[s].items()
            assert ((keys % np.uint64(n)) == s).all()
            np.testing.assert_array_equal(
                t2._rows_host(s, rows)[:, 4], keys.astype(np.float32) * 2)
    # a single-table save re-splits by key % N
    single = EmbeddingTable(mf_dim=MF, capacity=CAP, device="cpu")
    single.load(_base_blob(seed=3))
    single.save_base(str(tmp_path / "single.npz"))
    t3 = _port_table(4)
    assert t3.load(str(tmp_path / "single.npz")) == single.feature_count
    k3, r3 = _port_logical(t3)
    keys, rows = single.index.items()
    order = np.argsort(keys)
    want = single._gather_host(rows[order])
    np.testing.assert_array_equal(k3, keys[order])
    np.testing.assert_array_equal(r3[:, 4], want["embed_w"])
    np.testing.assert_array_equal(r3[:, 3], want["slot"])


def test_save_delta_and_reset_load(tmp_path):
    t = _port_table(4)
    g = list(tsharded.group_batches(
        _batches(_arrays(BS * 8, seed=21), 8)[1], 4))
    t.prepare_global(g[0])
    base = str(tmp_path / "b.npz")
    n1 = t.save_base(base)
    t.prepare_global(g[1])
    nd = t.save_delta(str(tmp_path / "d.npz"))
    assert 0 < nd <= t.feature_count()
    assert t.save_delta(str(tmp_path / "d2.npz")) == 0
    t.states[0].data[:, 4] = 99.0
    assert t.load(base) == n1
    keys0, rows0 = t.indexes[0].items()
    w0 = t.states[0].data[:, 4].numpy()
    mask = np.ones(len(w0), bool)
    mask[rows0] = False
    assert (w0[mask] == 0).all(), "stale rows survived a reset load"


def test_jax_save_loads_into_port_and_back(tmp_path):
    """A reference sharded save loads into the port (also at another N)
    and the port's into the reference, row for row."""
    jt = _jax_table(4)
    jb, tb = _batches(_arrays(BS * 4, seed=31), 4)
    jt.prepare_global(jb)
    data = np.asarray(jax.device_get(jt.state.data)).copy()
    rng = np.random.default_rng(0)
    data[:, :CAP] = rng.normal(size=data[:, :CAP].shape)
    data[:, :, 3] = rng.integers(0, S, size=data.shape[:2])
    jt.state = type(jt.state).from_logical(data, CAP)
    jpath = str(tmp_path / "jax.npz")
    n = jt.save_base(jpath)
    jkeys, jrows = _jax_logical(jt)
    for nn in (4, 8):
        t = _port_table(nn)
        assert t.load(jpath) == n
        k, r = _port_logical(t)
        np.testing.assert_array_equal(k, jkeys)
        np.testing.assert_array_equal(r, jrows)
    ppath = str(tmp_path / "port.npz")
    assert t.save_base(ppath) == n
    back = _jax_table(4)
    assert back.load(ppath) == n
    k, r = _jax_logical(back)
    np.testing.assert_array_equal(k, jkeys)
    np.testing.assert_array_equal(r, jrows)


def test_elastic_digest_same_at_4_and_8(port_runs, jax_runs, tmp_path):
    src = port_runs["mono"]["tr"]
    path = str(tmp_path / "b.npz")
    src.table.save_base(path)
    snap = src.dense_snapshot()
    digests = []
    for n in (4, 8):
        tr = _port_trainer(jax_runs["mono"]["start"], n=n)
        tr.table.load(path)
        tr.restore_state(snap["model"], snap["opt"], snap["auc"],
                         src.global_step)
        digests.append(elastic_state_digest(tr))
    assert digests[0] == digests[1] == elastic_state_digest(src)


def test_shrink_ages_and_drops():
    t = _port_table(4)
    _, tb = _batches(_arrays(BS * 4, seed=31), 4)
    t.prepare_global(tb)
    before = t.feature_count()
    hot = {}
    for s in range(4):
        keys, rows = t.indexes[s].items()
        half = torch.from_numpy(rows[:len(rows) // 2].astype(np.int64))
        t.states[s].data[half, 0] = 10.0
        t.states[s].data[half, 1] = 5.0
        hot[s] = set(keys[:len(rows) // 2].tolist())
    freed = t.shrink(delete_threshold=0.5, decay=0.9)
    assert freed == before - sum(len(v) for v in hot.values())
    for s in range(4):
        keys, rows = t.indexes[s].items()
        assert set(keys.tolist()) == hot[s]
        np.testing.assert_allclose(t._rows_host(s, rows)[:, 0], 9.0)


def test_merge_model_and_merge_models(tmp_path):
    def seeded(keys, w):
        t = _port_table(4)
        owners = (keys % np.uint64(4)).astype(np.int64)
        for s in range(4):
            rows = t.indexes[s].assign(keys[owners == s])
            r = torch.from_numpy(rows.astype(np.int64))
            t.states[s].data[r, 4] = w
            t.states[s].data[r, 0] = 3.0
            t.states[s].data[r, 1] = 1.0
        return t

    def row(t, k, col):
        s = k % 4
        r = t.indexes[s].lookup(np.array([k], np.uint64))[0]
        return float(t.states[s].data[r, col])

    live = seeded(np.arange(1, 33, dtype=np.uint64), 1.0)
    other = seeded(np.arange(17, 49, dtype=np.uint64), -5.0)
    p1 = str(tmp_path / "other.npz")
    other.save_base(p1)
    assert live.merge_model(p1) == 32
    assert live.feature_count() == 48
    assert row(live, 17, 0) == 6.0 and row(live, 17, 4) == 1.0
    assert row(live, 48, 4) == -5.0
    live2 = seeded(np.arange(1, 33, dtype=np.uint64), 1.0)
    assert live2.merge_models([p1], update_type="overwrite") == 32
    assert row(live2, 17, 4) == -5.0
    with pytest.raises(ValueError):
        live2.merge_models([p1], update_type="bogus")
