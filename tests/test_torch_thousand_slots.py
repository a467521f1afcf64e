"""Ladder rung 4 on the port: the 1000+-slot feed-log shape (the four cases
of ``tests/test_thousand_slots.py``) at 1024 slots and 128 records, held
against the JAX package on the CPU.

Cases: the single table through ``train_pass`` and through
``train_pass_resident`` (JAX ``Trainer``); the sharded streaming and
resident passes on 8 shards (JAX ``ShardedTrainer`` on its 8-device CPU
mesh), whose resident wire must widen ``serve_slot`` to ``u16``; the
multi-mf sharded trainer with two dim classes interleaved over the 1024
slots on 4 shards (JAX ``MultiMfShardedTrainer`` on 4 devices).

Tolerances: keys of the logical rows exact by key, show / clk / slot
exact, the rest of the rows and the dense params within the ragged
train-state class (rtol 2e-4 / atol 2e-5), the AUC within 1e-5; the
sharded resident wire byte for byte against the JAX pass's host leaves
and the port's resident pass equal to its streaming pass by
``sharded_state_digest``. The single-table pipeline case holds its last
step's start params and dense grads in the class and lets a final param
leave it only where both packages' last grad is below 1e-6 (Adam's sign
turn; its docstring). Lazy mf creation draws zeros on both sides
(``mf_initial_range`` 0), both towers run in float32, and the JAX side
runs with its flags off.
"""

import numpy as np
import optax
import pytest

import jax
import jax.numpy as jnp
import torch

from paddlebox_tpu.config import flags_scope as j_flags_scope
from paddlebox_tpu.data import DataFeedDesc as JDesc
from paddlebox_tpu.data import InMemoryDataset as JDataset
from paddlebox_tpu.data import SlotDef as JSlotDef
from paddlebox_tpu.data.record import SlotRecord as JRecord
from paddlebox_tpu.models import CtrDnn as JCtrDnn
from paddlebox_tpu.parallel import make_mesh
from paddlebox_tpu.ps import EmbeddingTable as JTable
from paddlebox_tpu.ps import SparseSGDConfig as JCfg
from paddlebox_tpu.ps.multi_mf_sharded import \
    MultiMfShardedTable as JMmfSharded
from paddlebox_tpu.ps.sharded import ShardedEmbeddingTable as JSharded
from paddlebox_tpu.train import Trainer as JTrainer
from paddlebox_tpu.train.multi_mf_sharded import \
    MultiMfShardedTrainer as JMmfShardedTrainer
from paddlebox_tpu.train.sharded import ShardedTrainer as JShardedTrainer

from paddlebox_tpu_torch import EmbeddingTable, InMemoryDataset, Trainer
from paddlebox_tpu_torch import convert
from paddlebox_tpu_torch.data import DataFeedDesc, SlotDef, SlotRecord
from paddlebox_tpu_torch.models import CtrDnn
from paddlebox_tpu_torch.ps import MultiMfShardedTable, SparseSGDConfig
from paddlebox_tpu_torch.ps.sharded import ShardedEmbeddingTable
from paddlebox_tpu_torch.train import MultiMfShardedTrainer
from paddlebox_tpu_torch.train.checkpoint import sharded_state_digest
from paddlebox_tpu_torch.train.sharded import ShardedTrainer

STATE_RTOL, STATE_ATOL = 2e-4, 2e-5
S = 1024
DENSE = 4
N_REC = 128
MF = 4
N = 8
MMF_N = 4
CFG = dict(mf_create_thresholds=0.0, mf_initial_range=0.0,
           learning_rate=0.05, mf_learning_rate=0.05)


def _arrays(seed):
    """The reference's ragged feed-log profile: per slot 0, 1 or 2 keys
    (mostly 1) from 97 ids of that slot."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(N_REC):
        counts = rng.choice([0, 1, 1, 1, 2], size=S).astype(np.int64)
        offs = np.zeros(S + 1, np.int32)
        np.cumsum(counts, out=offs[1:])
        nk = int(offs[-1])
        keys = (rng.integers(0, 97, nk).astype(np.uint64)
                + np.repeat(np.arange(S, dtype=np.uint64) * 97, counts))
        label = float(rng.random() < (0.2 + 0.4 * (keys[0] % 3 == 0)))
        out.append((keys, offs, rng.normal(size=DENSE).astype(np.float32),
                    label))
    return out


def _descs(batch):
    def slots(cls):
        return ([cls("label", "float", 1), cls("dense", "float", DENSE)]
                + [cls(f"S{i}", "uint64") for i in range(S)])
    return (JDesc(slots=slots(JSlotDef), batch_size=batch,
                  label_slot="label", key_bucket_min=1 << 10),
            DataFeedDesc(slots=slots(SlotDef), batch_size=batch,
                         label_slot="label", key_bucket_min=1 << 10))


def _datasets(seed, batch):
    arrs = _arrays(seed)
    jdesc, tdesc = _descs(batch)
    jds, tds = JDataset(jdesc), InMemoryDataset(tdesc)
    jds.records = [JRecord(k, o, d, lab, 1.0, lab) for k, o, d, lab in arrs]
    tds.records = [SlotRecord(k, o, d, lab, 1.0, lab)
                   for k, o, d, lab in arrs]
    jds.columnarize()
    tds.columnarize()
    return jds, tds


def _jax_model(hidden):
    return JCtrDnn(hidden=hidden, compute_dtype=jnp.float32)


def _port_model(params, hidden, width=3 + MF, slots=S):
    m = CtrDnn(slots, width, DENSE, hidden=hidden,
               compute_dtype=torch.float32)
    m.load_state_dict(params)
    return m


def _adam(lr):
    return lambda p: torch.optim.Adam(p, lr=lr, eps=1e-8)


class _RecordingAdam(torch.optim.Adam):
    """Adam that keeps each step's (params, grads) before it updates."""

    def step(self, closure=None):
        self.seen = [(p.detach().clone(), p.grad.detach().clone())
                     for g in self.param_groups for p in g["params"]]
        return super().step(closure)


def _jax_recorder():
    """An optax stage that keeps the last step's (grads, params) in its
    state and passes the grads on unchanged."""
    def init(params):
        zeros = jax.tree_util.tree_map(jnp.zeros_like, params)
        return (zeros, zeros)

    def update(updates, state, params=None):
        return updates, (updates, params)

    return optax.GradientTransformation(init, update)


def _sorted(keys, rows):
    order = np.argsort(keys)
    return keys[order], rows[order]


def _single_logical(table):
    """(keys sorted, the save-format field dict of their rows) of a
    single table, either package."""
    keys, rows = table.index.items()
    order = np.argsort(keys)
    return keys[order], table._gather_host(rows[order])


def _jax_sharded_logical(t):
    data = np.asarray(jax.device_get(t.state.data))
    parts = [t.indexes[s].items() for s in range(t.n)]
    return _sorted(np.concatenate([k for k, _ in parts]),
                   np.concatenate([data[s][r]
                                   for s, (_, r) in enumerate(parts)]))


def _port_sharded_logical(t):
    parts = [t.indexes[s].items() for s in range(t.n)]
    return _sorted(np.concatenate([k for k, _ in parts]),
                   np.concatenate([t._rows_host(s, r)
                                   for s, (_, r) in enumerate(parts)]))


def _assert_rows(got, want):
    (k, r), (jk, jr) = got, want
    np.testing.assert_array_equal(k, jk)
    # show, clk and slot exact; the rest in the train-state class
    np.testing.assert_array_equal(r[:, [0, 1, 3]], jr[:, [0, 1, 3]])
    np.testing.assert_allclose(r, jr, rtol=STATE_RTOL, atol=STATE_ATOL)


def _assert_params(model, want):
    sd = model.state_dict()
    for k, w in want.items():
        np.testing.assert_allclose(sd[k].numpy(), w.numpy(),
                                   rtol=STATE_RTOL, atol=STATE_ATOL,
                                   err_msg=k)


def _assert_result(res, jres):
    assert res["batches"] == jres["batches"]
    assert res["ins_num"] == jres["ins_num"] == N_REC
    np.testing.assert_allclose(res["auc"], jres["auc"], rtol=0, atol=1e-5)


@pytest.fixture(autouse=True)
def _one_thread():
    """One CPU thread: the port's row sums repeat at any count, this keeps
    the file's time flat."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("resident", [False, True])
def test_thousand_slot_single_table(resident):
    """The single table at 1024 slots through ``train_pass`` (the
    reference's pipeline case) and ``train_pass_resident`` (its resident
    case, non-trivial segments), against the JAX ``Trainer``, both with
    the reference's dense Adam 2e-3. The pipeline case's second step
    holds a few of its 64 x 7 172 first-layer grads within float order of
    zero, where Adam's m / (sqrt(v) + eps) turns last-bit differences
    into steps of up to lr; so there the last step's start params and
    its dense grads (before the optimizer) are held in the class, and a
    final param may leave the class only where both packages' last grad
    is below 1e-6 in magnitude, far below the layer's largest grads."""
    jds, tds = _datasets(seed=1 if resident else 0, batch=64)
    hidden = (32,) if resident else (64, 32)
    jtable = JTable(mf_dim=MF, capacity=1 << 18, cfg=JCfg(**CFG),
                    unique_bucket_min=1 << 14)
    with j_flags_scope(log_period_steps=10 ** 6):
        jtr = JTrainer(_jax_model(hidden), jtable, jds.desc,
                       tx=optax.adam(2e-3) if resident
                       else optax.chain(_jax_recorder(), optax.adam(2e-3)))
        params = convert.ctr_dnn_state_dict_from_flax(
            jax.device_get(jtr.state.params))
        jres = (jtr.train_pass_resident(jds) if resident
                else jtr.train_pass(jds))
    jtr.sync_table()
    jrows = _single_logical(jtable)
    table = EmbeddingTable(mf_dim=MF, capacity=1 << 18,
                           cfg=SparseSGDConfig(**CFG),
                           unique_bucket_min=1 << 14, device="cpu")
    opts = {}
    tr = Trainer(_port_model(params, hidden), table, tds.desc,
                 tx=_adam(2e-3) if resident
                 else lambda p: opts.setdefault(
                     "adam", _RecordingAdam(p, lr=2e-3, eps=1e-8)),
                 device="cpu")
    res = tr.train_pass_resident(tds) if resident else tr.train_pass(tds)
    assert res["batches"] == N_REC // 64
    _assert_result(res, jres)
    assert np.isfinite(res["last_loss"] if not resident else res["auc"])
    assert table.feature_count > S      # every slot landed keys
    (k, blob), (jk, jblob) = _single_logical(table), jrows
    np.testing.assert_array_equal(k, jk)
    for f, want in jblob.items():
        if f in ("show", "clk", "slot"):
            np.testing.assert_array_equal(blob[f], want, err_msg=f)
        else:
            np.testing.assert_allclose(blob[f], want, rtol=STATE_RTOL,
                                       atol=STATE_ATOL, err_msg=f)
    want = convert.ctr_dnn_state_dict_from_flax(
        jax.device_get(jtr.state.params))
    if resident:
        _assert_params(tr.model, want)
        return
    jgrads, jstart = (convert.ctr_dnn_state_dict_from_flax(
        jax.device_get(t)) for t in jtr.state.opt_state[0])
    names = [k for k, _ in tr.model.named_parameters()]
    sd = tr.model.state_dict()
    for k, (start, grad) in zip(names, opts["adam"].seen):
        for got, ref, what in ((start, jstart, "start"),
                               (grad, jgrads, "grad")):
            np.testing.assert_allclose(got.numpy(), ref[k].numpy(),
                                       rtol=STATE_RTOL, atol=STATE_ATOL,
                                       err_msg=f"{k} last step's {what}")
        off = ~np.isclose(sd[k].numpy(), want[k].numpy(), rtol=STATE_RTOL,
                          atol=STATE_ATOL)
        tiny = ((np.abs(grad.numpy()) < 1e-6)
                & (np.abs(jgrads[k].numpy()) < 1e-6))
        assert not (off & ~tiny).any(), (
            f"{k}: {int((off & ~tiny).sum())} params out of the class")


def test_thousand_slot_mesh_streaming_and_resident():
    """The rung-4 shape on 8 shards: the streaming pass against the JAX
    ``ShardedTrainer``; the resident wire (its ``serve_slot`` widened to
    ``u16``: 1024 slot ids do not fit a byte) byte for byte against the
    JAX pass's; the resident pass equal to the streaming one."""
    jds, tds = _datasets(seed=2, batch=8)
    cfg = JCfg(**CFG)

    def jtrainer():
        t = JSharded(N, mf_dim=MF, capacity_per_shard=1 << 15, cfg=cfg,
                     req_bucket_min=1 << 12, serve_bucket_min=1 << 12)
        with j_flags_scope(log_period_steps=10 ** 6):
            return JShardedTrainer(_jax_model((32,)), t, jds.desc,
                                   make_mesh(N), tx=optax.adam(1e-3),
                                   seed=3)

    jtr = jtrainer()
    params = convert.ctr_dnn_state_dict_from_flax(
        jax.device_get(jtr.state.params))
    jrp = jtrainer().build_resident_pass(jds)
    jres = jtr.train_pass(jds)

    def trainer():
        t = ShardedEmbeddingTable(N, mf_dim=MF, capacity_per_shard=1 << 15,
                                  cfg=SparseSGDConfig(**CFG), devices="cpu",
                                  req_bucket_min=1 << 12,
                                  serve_bucket_min=1 << 12)
        return ShardedTrainer(_port_model(params, (32,)), t, tds.desc,
                              tx=_adam(1e-3), seed=3)

    tr_s, tr_r = trainer(), trainer()
    rs = tr_s.train_pass(tds)
    _assert_result(rs, jres)
    _assert_rows(_port_sharded_logical(tr_s.table),
                 _jax_sharded_logical(jtr.table))
    _assert_params(tr_s.model, convert.ctr_dnn_state_dict_from_flax(
        jax.device_get(jtr.state.params)))

    rp = tr_r.build_resident_pass(tds)
    assert rp.fmt["serve_slot"] == "u16", rp.fmt
    assert rp.fmt == jrp.fmt
    assert set(rp.wire) == set(jrp.wire)
    for name, arrs in jrp.wire.items():
        assert len(rp.wire[name]) == len(arrs), name
        for got, want in zip(rp.wire[name], arrs):
            assert got.dtype == want.dtype and got.shape == want.shape, name
            assert got.tobytes() == np.asarray(want).tobytes(), name
    rr = tr_r.train_pass_resident(rp)
    assert rr["ins_num"] == rs["ins_num"] == N_REC
    assert abs(rr["auc"] - rs["auc"]) < 2e-3
    assert sharded_state_digest(tr_r) == sharded_state_digest(tr_s)
    # every shard holds rows (1024 slots spray keys across all owners)
    assert all(len(ix) > 0 for ix in tr_r.table.indexes)


def test_thousand_slot_multi_mf_mesh():
    """Two dim classes interleaved over the 1024 slots on 4 shards: each
    class table's rows and the params against the JAX
    ``MultiMfShardedTrainer``; every class has keys on every shard."""
    # one global step on 4 shards: the JAX multi-mf step compiles for
    # each new plan width, ~8 s a compile at 1024 slots on 4 devices and
    # twice that on 8
    jds, tds = _datasets(seed=3, batch=32)
    dims = [4, 8] * (S // 2)
    jtable = JMmfSharded(MMF_N, dims, capacity_per_shard=1 << 15,
                         cfg=JCfg(**CFG), req_bucket_min=1 << 11,
                         serve_bucket_min=1 << 11)
    with j_flags_scope(log_period_steps=10 ** 6):
        jtr = JMmfShardedTrainer(_jax_model((32,)), jtable, jds.desc,
                                 make_mesh(MMF_N), tx=optax.adam(1e-3))
        params = convert.ctr_dnn_state_dict_from_flax(
            jax.device_get(jtr.state.params))
        jres = jtr.train_pass(jds)
    table = MultiMfShardedTable(MMF_N, dims, capacity_per_shard=1 << 15,
                                cfg=SparseSGDConfig(**CFG), devices="cpu",
                                req_bucket_min=1 << 11,
                                serve_bucket_min=1 << 11)
    tr = MultiMfShardedTrainer(
        _port_model(params, (32,), width=table.pooled_width(), slots=1),
        table, tds.desc, tx=_adam(1e-3))
    res = tr.train_pass(tds)
    assert np.isfinite(res["last_loss"])
    _assert_result(res, jres)
    for c, (t, jt) in enumerate(zip(table.tables, jtable.tables)):
        _assert_rows(_port_sharded_logical(t), _jax_sharded_logical(jt))
        assert all(len(ix) > 0 for ix in t.indexes), f"class {c}"
    _assert_params(tr.model, convert.ctr_dnn_state_dict_from_flax(
        jax.device_get(jtr.state.params)))
