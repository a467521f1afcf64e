"""The production loop on the port, in one test (the counterpart of
``tests/test_production_loop.py``): the tiered sharded table (persistent
windows, delta staging, an overlapped pre-build through ``BoxPSHelper``)
x resident sharded passes x the metric registry x base-plus-delta
checkpoints x a cold restore, on 8 shards on the CPU: 4 passes of 384
criteo rows (the reference's 640, cut for time), batch 32.

Held: the restored run's final state equals the uninterrupted run's (the
reference's tolerances: AUC atol 1e-6, params rtol 1e-6 / atol 1e-7,
each shard's host-tier keys exact and ``embed_w`` rtol 1e-6 / atol
1e-8); delta staging engaged on every later pass; the registry fed. The
port's uninterrupted run against the JAX run of the same scenario (its
8-device CPU mesh, flags off): each shard's host-tier keys and the
per-pass staged / resident counts exact, show and clk exact, ``embed_w``
within the ragged train-state class (rtol 2e-4 / atol 2e-5). Lazy mf
creation draws zeros on both sides (``mf_initial_range`` 0) and both
towers run in float32.
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
from paddlebox_tpu.data.criteo import generate_criteo_files
from paddlebox_tpu.models import DeepFM as JDeepFM
from paddlebox_tpu.parallel import make_mesh
from paddlebox_tpu.ps import BoxPSHelper as JHelper
from paddlebox_tpu.ps import SparseSGDConfig as JCfg
from paddlebox_tpu.ps import TieredShardedEmbeddingTable as JTiered
from paddlebox_tpu.train.sharded import ShardedTrainer as JShardedTrainer

from paddlebox_tpu_torch import DeepFM, convert
from paddlebox_tpu_torch.data import DataFeedDesc, DatasetFactory
from paddlebox_tpu_torch.ps import BoxPSHelper, TieredShardedEmbeddingTable
from paddlebox_tpu_torch.ps.sgd import SparseSGDConfig
from paddlebox_tpu_torch.train.checkpoint import CheckpointManager
from paddlebox_tpu_torch.train.sharded import ShardedTrainer

STATE_RTOL, STATE_ATOL = 2e-4, 2e-5
N = 8
ROWS, BS = 384, 32
PASSES = 4
HIDDEN = (16, 16)
CFG = dict(mf_create_thresholds=0.0, mf_initial_range=0.0,
           learning_rate=0.1, mf_learning_rate=0.1)


@pytest.fixture(scope="module")
def pass_files(tmp_path_factory):
    """Sliding key ranges (value_base): consecutive passes share ~75% of
    their feature space, so delta staging has real reuse."""
    root = tmp_path_factory.mktemp("production")
    return [generate_criteo_files(str(root / f"pp{p}"), num_files=1,
                                  rows_per_file=ROWS, vocab_per_slot=60,
                                  seed=900 + p, value_base=p * 15)
            for p in range(PASSES)]


def _load(files, factory, desc_cls):
    desc = desc_cls.criteo(batch_size=BS)
    desc.key_bucket_min = 1024
    ds = factory().create_dataset("InMemoryDataset", desc)
    ds.set_filelist(files)
    ds.load_into_memory()
    return ds, desc


def _host_keys(table):
    return [np.sort(table.hosts[s].index.items()[0]) for s in range(N)]


def _host_fields(table, keys):
    return [table.hosts[s].fetch(k) for s, k in enumerate(keys)]


@pytest.fixture(scope="module")
def jax_loop(pass_files):
    """The reference's uninterrupted loop: 4 resident passes through its
    helper with the next pass staged ahead; the start params, per-pass
    stats, results, host tiers and params."""
    built = [_load(f, JFactory, JDesc) for f in pass_files]
    table = JTiered(N, mf_dim=4, capacity_per_shard=2048, cfg=JCfg(**CFG),
                    req_bucket_min=256, serve_bucket_min=256)
    with j_flags_scope(log_period_steps=10000):
        tr = JShardedTrainer(JDeepFM(hidden=HIDDEN,
                                     compute_dtype=jnp.float32),
                             table, built[0][1], make_mesh(N),
                             tx=optax.adam(2e-3), seed=11)
    start = convert.deepfm_state_dict_from_flax(
        jax.device_get(tr.state.params))
    helper = JHelper(table, trainer=tr)
    stats, res = [], []
    for p in range(PASSES):
        ds = built[p][0]
        helper.begin_pass(ds)
        stats.append(dict(table.last_pass_stats))
        if p + 1 < PASSES:
            helper.stage_pass(built[p + 1][0])
        res.append(tr.train_pass_resident(ds))
        helper.end_pass(ds)
    table.fence()
    keys = _host_keys(table)
    return dict(start=start, stats=stats, res=res, keys=keys,
                fields=_host_fields(table, keys))


def _mk_trainer(desc, params):
    table = TieredShardedEmbeddingTable(
        N, mf_dim=4, capacity_per_shard=2048, cfg=SparseSGDConfig(**CFG),
        devices="cpu", req_bucket_min=256, serve_bucket_min=256)
    model = DeepFM(26, 3 + 4, 13, hidden=HIDDEN,
                   compute_dtype=torch.float32)
    model.load_state_dict(params)
    tr = ShardedTrainer(model, table, desc,
                        tx=lambda p: torch.optim.Adam(p, lr=2e-3, eps=1e-8),
                        seed=11)
    tr.metrics.init_metric("auc2", method="auc")
    tr.metrics.init_metric("wu", method="wuauc")
    return table, tr, BoxPSHelper(table, trainer=tr)


def test_production_loop_composes_and_restores(pass_files, jax_loop,
                                               tmp_path):
    built = [_load(f, DatasetFactory, DataFeedDesc) for f in pass_files]
    desc = built[0][1]

    def run(n_passes, cm_root, resume=False):
        table, tr, helper = _mk_trainer(desc, jax_loop["start"])
        cm = CheckpointManager(str(cm_root), keep=10)
        start = 0
        if resume:
            restored = cm.restore(tr)
            assert restored is not None
            # every pass has the same global-batch count, and only the
            # resident passes advance global_step
            nb_per_pass = (-(-ROWS // BS) + N - 1) // N
            start = restored // nb_per_pass
        outs = []
        for p in range(start, n_passes):
            ds = built[p][0]
            helper.begin_pass(ds)
            st = dict(table.last_pass_stats)
            if p + 1 < n_passes:
                helper.stage_pass(built[p + 1][0])   # overlapped pre-build
            res = tr.train_pass_resident(ds)         # sharded RESIDENT pass
            helper.end_pass(ds)
            cm.save(tr, delta=(p > 0))               # base then delta chain
            outs.append((res, st))
        table.fence()
        return table, tr, outs

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        # uninterrupted 4-pass run
        ta, tra, outs_a = run(PASSES, tmp_path / "cma")
        # interrupted: 2 passes, then a COLD restore (fresh table,
        # trainer, registry: the replacement process) runs 2 more
        run(2, tmp_path / "cmb")
        tb, trb, outs_b = run(PASSES, tmp_path / "cmb", resume=True)
    finally:
        torch.set_num_threads(threads)

    # delta staging engaged: later passes stage only NEW keys while the
    # overlap stays resident
    for res, st in outs_a[1:]:
        assert st["staged"] > 0 and st["resident"] > 0, st
    # the resident-pass registry accumulated on the shards
    assert tra.metrics.get_metric_msg("auc2")["ins_num"] > 0
    assert np.isfinite(tra.metrics.get_metric_msg("wu")["wuauc"])

    # the restored run's final state matches the uninterrupted run's
    ra, rb = outs_a[-1][0], outs_b[-1][0]
    assert len(outs_b) == 2
    assert rb["ins_num"] == ra["ins_num"]
    assert np.isclose(rb["auc"], ra["auc"], atol=1e-6), (ra["auc"],
                                                         rb["auc"])
    for k, v in tra.model.state_dict().items():
        np.testing.assert_allclose(trb.model.state_dict()[k].numpy(),
                                   v.numpy(), rtol=1e-6, atol=1e-7,
                                   err_msg=k)
    keys_a, keys_b = _host_keys(ta), _host_keys(tb)
    for s in range(N):
        np.testing.assert_array_equal(keys_a[s], keys_b[s])
        a = ta.hosts[s].fetch(keys_a[s])
        b = tb.hosts[s].fetch(keys_a[s])
        np.testing.assert_allclose(b["embed_w"], a["embed_w"], rtol=1e-6,
                                   atol=1e-8)

    # the uninterrupted run against the reference's
    for (res, st), jst, jres in zip(outs_a, jax_loop["stats"],
                                    jax_loop["res"]):
        assert {k: st[k] for k in ("staged", "resident")} == \
            {k: jst[k] for k in ("staged", "resident")}
        assert res["ins_num"] == jres["ins_num"]
    fields_a = _host_fields(ta, keys_a)
    for s in range(N):
        np.testing.assert_array_equal(keys_a[s], jax_loop["keys"][s])
        got, want = fields_a[s], jax_loop["fields"][s]
        for f in ("show", "clk"):
            np.testing.assert_array_equal(got[f], want[f], err_msg=f)
        np.testing.assert_allclose(got["embed_w"], want["embed_w"],
                                   rtol=STATE_RTOL, atol=STATE_ATOL)
