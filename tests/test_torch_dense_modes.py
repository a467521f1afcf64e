"""The port's dense modes (``train/dense_modes.py``) and ``lr_map`` on
both trainers, against the JAX package's, on the CPU: the cases of
``tests/test_dense_modes.py`` and ``tests/test_lr_map.py``.

The port names params by ``named_parameters()`` (``hidden.0.weight``),
the reference by flax key paths (``['params']['Dense_0']['kernel']``):
each side's ``lr_map`` uses its own names for the same param. The host
async table runs the same numpy float32 Adam: rtol 1e-6. A frozen param
is unchanged bit for bit; training against the reference holds the
ragged train-state class, rtol 2e-4 / atol 2e-5.
"""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from paddlebox_tpu.data.dataset import InMemoryDataset as JDataset
from paddlebox_tpu.data.record import SlotRecord as JRecord
from paddlebox_tpu.models import CtrDnn as JCtrDnn
from paddlebox_tpu.ps import EmbeddingTable as JTable
from paddlebox_tpu.ps import SparseSGDConfig as JCfg
from paddlebox_tpu.train import Trainer as JTrainer
from paddlebox_tpu.train import dense_modes as jdm

from paddlebox_tpu_torch import EmbeddingTable, InMemoryDataset, Trainer
from paddlebox_tpu_torch import convert
from paddlebox_tpu_torch.data import SlotRecord
from paddlebox_tpu_torch.models import CtrDnn
from paddlebox_tpu_torch.ps import table as ttable
from paddlebox_tpu_torch.train import dense_modes as dm

import test_torch_sharded as tsh
from test_torch_train import (CAP, CFG, DENSE, MF, S, STATE_ATOL, STATE_RTOL,
                              _descs, _ragged_arrays)


# ---------------------------------------------------------------------------
# K-step averaging and the async table
# ---------------------------------------------------------------------------

def test_k_step_sync_stacked_mean():
    w = np.arange(8, dtype=np.float32).reshape(4, 2)
    b = np.array([[1.0], [3.0], [5.0], [7.0]], np.float32)
    jsync, sync = jdm.KStepParamSync(k=3), dm.KStepParamSync(k=3)
    jp = {"w": jnp.asarray(w), "b": jnp.asarray(b)}
    p = {"w": torch.from_numpy(w), "b": torch.from_numpy(b)}
    for want_did in (False, False, True):
        jp, jdid = jsync.maybe_sync(jp)
        p, did = sync.maybe_sync(p)
        assert did == jdid == want_did
    np.testing.assert_allclose(p["b"].numpy(), np.full((4, 1), 4.0))
    for k in ("w", "b"):
        np.testing.assert_allclose(p[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-6)


def test_k_step_sync_every_step_over_replicas():
    """k = 1 averages the N replicas every step (the mesh case of the
    reference: one copy a worker, here a leading axis)."""
    sync = dm.KStepParamSync(k=1)
    reps = [torch.arange(8, dtype=torch.float32).reshape(4, 2)]
    out, did = sync.maybe_sync(reps)
    assert did and isinstance(out, list)
    np.testing.assert_allclose(out[0].numpy(), np.tile(
        np.arange(8, dtype=np.float32).reshape(4, 2).mean(0), (4, 1)))


def test_k_step_rejects_bad_k():
    with pytest.raises(ValueError):
        dm.KStepParamSync(k=0)


def _run_table(cls, params, grads_seq, **kw):
    t = cls(params, **kw)
    t.start()
    try:
        for g in grads_seq:
            t.push(g)
        applied = t.drain()
    finally:
        t.stop()
    return t, applied


def test_async_dense_table_matches_reference():
    """The same grad stream through both packages' tables: the same
    float32 Adam on the host, rtol 1e-6; summary leaves accumulate."""
    rng = np.random.default_rng(0)
    params = {"w": np.full(4, 10.0, np.float32),
              "b": np.full(2, -10.0, np.float32),
              "data_norm_summary": np.zeros(3, np.float32)}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32)
              for k, v in params.items()} for _ in range(20)]
    jt, japplied = _run_table(jdm.AsyncDenseTable, params, grads, lr=0.5)
    t, applied = _run_table(dm.AsyncDenseTable, params, grads, lr=0.5)
    assert applied == japplied == 20
    jout, out = jt.pull(), t.pull()
    for k in params:
        np.testing.assert_allclose(out[k].numpy(), np.asarray(jout[k]),
                                   rtol=1e-6, atol=1e-7, err_msg=k)
    np.testing.assert_allclose(out["data_norm_summary"].numpy(),
                               sum(g["data_norm_summary"] for g in grads),
                               rtol=1e-5)


def test_async_dense_table_adam_converges():
    """Minimising ||p||^2 through the table converges. Each push is
    drained before the next pull, so every grad is taken at the params
    the previous update left and the run does not depend on how far the
    background thread lags (without the drain, a loaded machine lets the
    pulls run ahead on stale params and the trajectory varies)."""
    table = dm.AsyncDenseTable({"w": torch.full((4,), 10.0),
                                "b": torch.full((2,), -10.0)}, lr=0.5)
    table.start()
    try:
        for i in range(200):
            table.push({k: 2.0 * v for k, v in table.pull().items()})
            assert table.drain() == i + 1
    finally:
        table.stop()
    final = table.pull()
    assert final["w"].abs().max() < 1.0 and final["b"].abs().max() < 1.0


# ---------------------------------------------------------------------------
# lr_map
# ---------------------------------------------------------------------------

def test_lr_pattern_segment_boundaries():
    assert dm.lr_pattern_matches("hidden.1", "hidden.1.weight")
    assert not dm.lr_pattern_matches("hidden.1", "hidden.10.weight")
    assert dm.lr_pattern_matches("Dense_1", "['params']['Dense_1']['kernel']")
    assert not dm.lr_pattern_matches("Dense_1",
                                     "['params']['Dense_10']['kernel']")
    for pat, key in (("Dense_1", "['params']['Dense_1']['kernel']"),
                     ("Dense_1", "['params']['Dense_10']['kernel']"),
                     ("w", "w_0"), ("w_0", "w_0.b")):
        assert dm.lr_pattern_matches(pat, key) == jdm.lr_pattern_matches(
            pat, key), (pat, key)
    scales = dm.build_lr_scales({"Dense_1": 0, "Dense_10": 0},
                                {"Dense_1": 0.0}, 1.0)
    assert scales == {"Dense_1": 0.0, "Dense_10": 1.0}
    t, _ = _run_table(dm.AsyncDenseTable,
                      {"Dense_1": np.ones(2, np.float32),
                       "Dense_10": np.ones(2, np.float32)},
                      [{"Dense_1": np.ones(2, np.float32),
                        "Dense_10": np.ones(2, np.float32)}],
                      lr=1e-3, lr_map={"Dense_1": 0.0})
    out = t.pull()
    np.testing.assert_array_equal(out["Dense_1"].numpy(), 1.0)
    assert (out["Dense_10"].numpy() != 1.0).all()


def test_lr_map_transform_scales_updates_exactly():
    params = {"w_0": torch.ones(4), "b_0": torch.ones(2),
              "other": torch.ones(3)}
    base = 0.1
    scales = dm.build_lr_scales(params, {"w_0": 0.0, "b_0": 1.0}, base)
    assert scales == {"w_0": 0.0, "b_0": 10.0, "other": 1.0}
    ps = [torch.nn.Parameter(v.clone()) for v in params.values()]
    opt = dm.lr_map_transform(lambda p: torch.optim.SGD(p, lr=base),
                              list(scales.values()))(ps)
    for p in ps:
        p.grad = torch.ones_like(p)
    opt.step()
    np.testing.assert_array_equal(ps[0].detach().numpy(), 1.0)
    np.testing.assert_allclose(ps[1].detach().numpy(), 0.0, atol=1e-6)
    np.testing.assert_allclose(ps[2].detach().numpy(), 0.9, rtol=1e-6)
    assert opt.state_dict()["param_groups"][0]["lr"] == base


def test_async_dense_table_lr_map():
    """A frozen param holds exactly; a boosted one moves ~10x the default
    (Adam's first step is ~lr)."""
    params = {"w_0": np.ones(4, np.float32), "b_0": np.ones(2, np.float32),
              "fc": np.ones(3, np.float32)}
    g = {k: np.full(v.shape, 0.5, np.float32) for k, v in params.items()}
    t, _ = _run_table(dm.AsyncDenseTable, params, [g], lr=1e-3,
                      lr_map={"w_0": 0.0, "b_0": 1e-2})
    out = t.pull()
    np.testing.assert_array_equal(out["w_0"].numpy(), 1.0)
    d_b, d_fc = 1.0 - float(out["b_0"][0]), 1.0 - float(out["fc"][0])
    assert d_fc > 0
    np.testing.assert_allclose(d_b / d_fc, 10.0, rtol=1e-4)


def test_trainer_lr_map_freezes_param_and_matches_jax():
    """The single-table Trainer: the frozen param stays at its start bit
    for bit through two passes, the rest train (the output layer at 3x
    the base lr: the old + s * (new - old) branch), and the run matches
    the reference's Trainer with the same lr_map."""
    arrs = _ragged_arrays(n=192, seed=9)
    jdesc, tdesc = _descs()
    jtr = JTrainer(JCtrDnn(hidden=(8,), compute_dtype=jnp.float32),
                   JTable(mf_dim=MF, capacity=CAP, cfg=JCfg(**CFG),
                          unique_bucket_min=512), jdesc,
                   tx=optax.adam(1e-2), seed=3,
                   lr_map={"['params']['Dense_0']['kernel']": 0.0,
                           "Dense_1": 3e-2},
                   lr_map_base=1e-2)
    params0 = jax.device_get(jtr.state.params)
    jds = JDataset(jdesc)
    jds.records = [JRecord(k, o, d, l, 1.0, l) for k, o, d, l in arrs]
    for _ in range(2):
        jtr.train_pass(jds)
    jparams = convert.ctr_dnn_state_dict_from_flax(
        jax.device_get(jtr.state.params))

    model = CtrDnn(S, 3 + MF, DENSE, hidden=(8,), compute_dtype=torch.float32)
    start = convert.ctr_dnn_state_dict_from_flax(params0)
    model.load_state_dict(start)
    tr = Trainer(model, EmbeddingTable(mf_dim=MF, capacity=CAP,
                                       cfg=ttable.SparseSGDConfig(**CFG),
                                       unique_bucket_min=512, device="cpu"),
                 tdesc, tx=lambda p: torch.optim.Adam(p, lr=1e-2, eps=1e-8),
                 seed=3, device="cpu",
                 lr_map={"hidden.0.weight": 0.0, "out": 3e-2},
                 lr_map_base=1e-2)
    ds = InMemoryDataset(tdesc)
    ds.records = [SlotRecord(k, o, d, l, 1.0, l) for k, o, d, l in arrs]
    for _ in range(2):
        tr.train_pass(ds)
    sd = tr.model.state_dict()
    assert torch.equal(sd["hidden.0.weight"], start["hidden.0.weight"])
    moved = [k for k in sd if k != "hidden.0.weight"
             and not torch.equal(sd[k], start[k])]
    assert moved
    for k, want in jparams.items():
        np.testing.assert_allclose(sd[k].numpy(), want.numpy(),
                                   rtol=STATE_RTOL, atol=STATE_ATOL,
                                   err_msg=k)


@pytest.mark.parametrize("zero1", [False, True])
def test_sharded_trainer_lr_map(zero1):
    """The sharded trainer, replicated and ZeRO-1 (the flat chunks): the
    frozen param holds at its start bit for bit; a boosted param moves
    farther than under the base lr."""
    _, tds = tsh._datasets(tsh._train_arrays())
    _, tdesc = tsh._descs()

    def mk(lr_map=None):
        torch.manual_seed(0)
        model = CtrDnn(tsh.S, 3 + tsh.MF, tsh.DENSE, hidden=(8,),
                       compute_dtype=torch.float32)
        table = tsh._port_table(4)
        return tsh.ShardedTrainer(
            model, table, tdesc, tx=lambda p: torch.optim.Adam(p, lr=1e-2),
            seed=3, zero1=zero1, lr_map=lr_map, lr_map_base=1e-2)

    names = [k for k, _ in mk().model.named_parameters()]
    frozen, boosted = names[0], names[-1]
    tr, plain = mk({frozen: 0.0, boosted: 5e-2}), mk()
    init = {k: v.clone() for k, v in tr.model.state_dict().items()}
    tr.train_pass(tds)
    plain.train_pass(tds)
    after = tr.model.state_dict()
    after_plain = plain.model.state_dict()
    assert torch.equal(after[frozen], init[frozen])
    assert not torch.equal(after_plain[frozen], init[frozen])
    d_boost = (after[boosted] - init[boosted]).abs().mean()
    d_plain = (after_plain[boosted] - init[boosted]).abs().mean()
    assert d_boost > 2.0 * d_plain, (d_boost, d_plain)
