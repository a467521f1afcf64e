"""The port's tiered sharded table (``ps/tiered.py``), its pass pipeline
(``train/device_pass.PassPipeline`` with a window table,
``ShardedTrainer.tiered_pass_pipeline`` / ``train_passes_tiered``) and
``BoxPSHelper`` against the JAX package's, on the CPU: the counterparts
of ``tests/test_tiered_sharded.py``.

The reference runs on a 4-device slice of its 8-device CPU mesh (N = 4);
the port's shards sit on the CPU. Tolerances: row assignment, the
per-pass ``staged`` / ``resident`` / ``evicted`` / ``evicted_writeback``
counts, show/clk and the host-tier key sets exact; the port against its
own runs (delta vs full staging, async vs sync epilogue, depth 2 vs
depth 0, tiered vs plain, device index on vs off) exact by digest;
training against the reference in the ragged train-state class (rtol
2e-4 / atol 2e-5), the AUC within 1e-5. Lazy mf draws zeros on both
sides (``mf_initial_range`` 0). The guard, rollback and failure cases are
port-only behaviour tests.
"""

import os
import time

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from paddlebox_tpu.config import flags_scope as j_flags_scope
from paddlebox_tpu.models import DeepFM as JDeepFM
from paddlebox_tpu.parallel import make_mesh
from paddlebox_tpu.ps import BoxPSHelper as JHelper
from paddlebox_tpu.ps import SparseSGDConfig as JCfg
from paddlebox_tpu.ps import TieredShardedEmbeddingTable as JTiered
from paddlebox_tpu.train.device_pass import PassPreloader as JPreloader
from paddlebox_tpu.train.sharded import ShardedTrainer as JShardedTrainer

from paddlebox_tpu_torch import DeepFM, convert
from paddlebox_tpu_torch.config import flags_scope
from paddlebox_tpu_torch.ps import BoxPSHelper, TieredShardedEmbeddingTable
from paddlebox_tpu_torch.ps.epilogue import EndPassWritebackError
from paddlebox_tpu_torch.ps.sgd import SparseAdamConfig, SparseSGDConfig
from paddlebox_tpu_torch.ps.sharded import ShardedEmbeddingTable
from paddlebox_tpu_torch.ps.table import FIELD_COL, FIELDS, NUM_FIXED
from paddlebox_tpu_torch.resilience.faults import FaultPlan, installed
from paddlebox_tpu_torch.train.device_pass import (PassPipeline,
                                                   PassPreloader,
                                                   PreloadBuildAborted)
from paddlebox_tpu_torch.train.sharded import ShardedTrainer

from test_torch_sharded import (BS, CFG, DENSE, MF, S, STATE_ATOL,
                                STATE_RTOL, TABLE_KW, _datasets, _descs)

N = 4
HIDDEN = (16, 8)
STAT_KEYS = ("staged", "resident", "evicted", "evicted_writeback")


# ---------------------------------------------------------------------------
# data and builders
# ---------------------------------------------------------------------------

def _pass_arrays(n, seed, base, vocab=60):
    """Ragged records whose slot-qualified ids lie in [base, base+vocab)
    (key = slot * 100000 + id): consecutive passes with overlapping or
    disjoint ranges model day-k data."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        counts = np.minimum(rng.zipf(1.5, size=S), 6)
        offs = np.zeros(S + 1, np.int32)
        np.cumsum(counts, out=offs[1:])
        slot = np.repeat(np.arange(S), counts)
        keys = (slot * 100000 + base
                + rng.integers(0, vocab, size=int(offs[-1]))
                ).astype(np.uint64)
        out.append((keys, offs, rng.normal(size=DENSE).astype(np.float32),
                    float(rng.random() < 0.3)))
    return out


def _passes(bases, seed, records=BS * 8, vocab=60):
    """(JAX datasets, port datasets) of one pass per base."""
    pairs = [_datasets(_pass_arrays(records, seed + i, b, vocab))
             for i, b in enumerate(bases)]
    return [p[0] for p in pairs], [p[1] for p in pairs]


def _cfg(**kw):
    return SparseSGDConfig(**{**CFG, **kw})


def _tiered(n=N, cap=2048, **kw):
    kw.setdefault("cfg", _cfg())
    return TieredShardedEmbeddingTable(n, mf_dim=kw.pop("mf_dim", MF),
                                       capacity_per_shard=cap,
                                       devices="cpu", **{**TABLE_KW, **kw})


def _jax_tiered(cap=2048):
    with j_flags_scope(warmup_pass_scatter=False):
        return JTiered(N, mf_dim=MF, capacity_per_shard=cap,
                       cfg=JCfg(**CFG), **TABLE_KW)


def _jax_trainer(table):
    jdesc, _ = _descs()
    return JShardedTrainer(JDeepFM(hidden=HIDDEN, compute_dtype=jnp.float32),
                           table, jdesc, make_mesh(N), tx=optax.adam(1e-2),
                           seed=3)


def _port_trainer(table, params):
    _, tdesc = _descs()
    model = DeepFM(S, 3 + MF, DENSE, hidden=HIDDEN,
                   compute_dtype=torch.float32)
    model.load_state_dict(params)
    return ShardedTrainer(
        model, table, tdesc,
        tx=lambda p: torch.optim.Adam(p, lr=1e-2, eps=1e-8), seed=3)


def _params(jtr):
    return convert.deepfm_state_dict_from_flax(
        jax.device_get(jtr.state.params))


def _host_rows(table):
    """(keys sorted, {field: values}) of every shard's host tier."""
    keys, fields = [], {}
    for h in table.hosts:
        k, f = h.export_rows(clear_touched=False)
        keys.append(k)
        for name, v in f.items():
            fields.setdefault(name, []).append(v)
    keys = np.concatenate(keys)
    order = np.argsort(keys)
    return keys[order], {f: np.concatenate(v)[order]
                         for f, v in fields.items()}


def _assert_host_close(got, want):
    gk, gf = got
    wk, wf = want
    np.testing.assert_array_equal(gk, wk)
    for f in FIELDS:
        if f in ("show", "clk", "slot"):
            np.testing.assert_array_equal(gf[f], wf[f], err_msg=f)
        else:
            np.testing.assert_allclose(gf[f], wf[f], rtol=STATE_RTOL,
                                       atol=STATE_ATOL, err_msg=f)


def _assert_params_close(tr, want):
    sd = tr.model.state_dict()
    for k, w in want.items():
        np.testing.assert_allclose(sd[k].numpy(), w.numpy(),
                                   rtol=STATE_RTOL, atol=STATE_ATOL,
                                   err_msg=k)


def _plant(table, value, col="embed_w"):
    """``value`` into every resident row's ``col``, the rows marked
    touched (a stand-in for a trained pass)."""
    with table.host_lock:
        for s in range(table.n):
            _, rows = table.indexes[s].items()
            if len(rows):
                table.states[s].data[torch.from_numpy(
                    rows.astype(np.int64)), FIELD_COL[col]] = value
                table._touched[s][rows] = True


def _field_rows(n, v, mf=2):
    return {f: (np.full((n, mf), v, np.float32) if f == "embedx_w"
                else np.full(n, v, np.float32)) for f in FIELDS}


def _stats(table):
    return {k: table.last_pass_stats[k] for k in STAT_KEYS}


def _run_helper(table, trainer, tds, resident=False, overlap=False):
    """Passes through ``BoxPSHelper``: begin, (stage the next), train,
    end. Returns the per-pass stats and results."""
    h = BoxPSHelper(table, trainer=trainer)
    stats, res = [], []
    for i, ds in enumerate(tds):
        h.begin_pass(ds)
        stats.append(_stats(table))
        if overlap and i + 1 < len(tds):
            h.stage_pass(tds[i + 1])
        res.append(trainer.train_pass_resident(ds) if resident
                   else trainer.train_pass(ds))
        h.end_pass(ds)
    table.fence()
    return stats, res


# ---------------------------------------------------------------------------
# the reference's runs
# ---------------------------------------------------------------------------

def _jax_run(jds, cap, resident=False, overlap=False, preload=False):
    table = _jax_tiered(cap)
    tr = _jax_trainer(table)
    start = _params(tr)
    h = JHelper(table, trainer=tr)
    stats, res = [], []
    if preload:
        pre = JPreloader(iter(jds), build_fn=tr.build_resident_pass)
        pre.start_next()
    for i, ds in enumerate(jds):
        rp = pre.wait() if preload else None
        h.begin_pass(ds)
        stats.append({k: table.last_pass_stats[k] for k in STAT_KEYS})
        if preload:
            if pre.start_next() and i + 1 < len(jds):
                h.stage_pass(jds[i + 1])
            res.append(tr.train_pass_resident(rp))
        else:
            if overlap and i + 1 < len(jds):
                h.stage_pass(jds[i + 1])
            res.append(tr.train_pass_resident(ds) if resident
                       else tr.train_pass(ds))
        h.end_pass(ds)
    table.fence()
    return dict(start=start, stats=stats, res=res, host=_host_rows(table),
                params=_params(tr))


OVERLAP_BASES = (0, 20, 40, 60)     # 2/3 of each pass's range re-touched
DISJOINT_BASES = (0, 1000, 2000)    # per-pass disjoint ranges


@pytest.fixture(scope="module")
def jax_runs():
    """The reference's tiered runs: streaming passes over sliding
    ranges (overlapped stage), disjoint passes in a window smaller than
    the model, two resident passes, and a preloaded resident run."""
    out = {}
    jds, _ = _passes(OVERLAP_BASES, seed=50)
    out["delta"] = _jax_run(jds, 2048, overlap=True)
    jds, _ = _passes(DISJOINT_BASES, seed=60)
    out["window"] = _jax_run(jds, 96)
    jds, _ = _passes((0, 0), seed=70)
    jds = [jds[0], jds[0]]
    out["resident"] = _jax_run(jds, 2048, resident=True)
    out["stream2"] = _jax_run(jds, 2048)
    ja, _ = _passes((0, 500), seed=80)
    out["preload"] = _jax_run([ja[0], ja[1], ja[0], ja[1]], 2048,
                              preload=True)
    return out


def _assert_matches_jax(table, tr, stats, res, j):
    assert stats == j["stats"]
    _assert_host_close(_host_rows(table), j["host"])
    _assert_params_close(tr, j["params"])
    for r, jr in zip(res, j["res"]):
        assert r["ins_num"] == jr["ins_num"]
        np.testing.assert_allclose(r["auc"], jr["auc"], rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# training through the windows, against the reference
# ---------------------------------------------------------------------------

def test_tiered_window_smaller_than_model(jax_runs):
    """Three disjoint passes in windows of 96 rows a shard: each pass
    fits, the union does not; the host tier carries the full model and
    every pass's stats (evictions included) are the reference's."""
    j = jax_runs["window"]
    _, tds = _passes(DISJOINT_BASES, seed=60)
    table = _tiered(cap=96)
    tr = _port_trainer(table, j["start"])
    stats, res = _run_helper(table, tr, tds)
    assert table.feature_count() > N * table.capacity
    assert sum(st["evicted"] for st in stats) > 0
    for s in range(N):
        assert len(table.indexes[s]) <= table.capacity
    _assert_matches_jax(table, tr, stats, res, j)


def test_tiered_matches_untired_sharded(jax_runs):
    """Tiering is transparent: two pass windows over one dataset equal a
    plain ShardedEmbeddingTable trained straight through, per key and
    dense, bit for bit; and the reference's tiered run in class."""
    j = jax_runs["stream2"]
    _, tds = _passes((0, 0), seed=70)
    tiered = _tiered()
    tr_b = _port_trainer(tiered, j["start"])
    stats, res = _run_helper(tiered, tr_b, [tds[0], tds[0]])
    plain = ShardedEmbeddingTable(N, mf_dim=MF, capacity_per_shard=2048,
                                  cfg=_cfg(), devices="cpu", **TABLE_KW)
    tr_a = _port_trainer(plain, j["start"])
    ra = [tr_a.train_pass(tds[0]) for _ in range(2)]
    assert [r["auc"] for r in res] == [r["auc"] for r in ra]
    for x, y in zip(tr_a.model.parameters(), tr_b.model.parameters()):
        assert torch.equal(x, y)
    for s in range(N):
        keys, rows = plain.indexes[s].items()
        got = tiered.hosts[s].fetch(keys)
        want = plain._rows_host(s, rows)
        np.testing.assert_array_equal(got["embed_w"],
                                      want[:, FIELD_COL["embed_w"]])
        np.testing.assert_array_equal(got["embedx_w"],
                                      want[:, NUM_FIXED:NUM_FIXED + MF])
    _assert_matches_jax(tiered, tr_b, stats, res, j)


def test_tiered_resident_matches_streaming(jax_runs):
    """Resident passes inside tiered windows equal streaming passes bit
    for bit, and the reference's resident run in class."""
    j = jax_runs["resident"]
    _, tds = _passes((0, 0), seed=70)
    ta, tb = _tiered(), _tiered()
    tr_a = _port_trainer(ta, j["start"])
    tr_b = _port_trainer(tb, j["start"])
    _run_helper(ta, tr_a, [tds[0], tds[0]])
    stats, res = _run_helper(tb, tr_b, [tds[0], tds[0]], resident=True)
    assert ta.rows_digest() == tb.rows_digest()
    for x, y in zip(tr_a.model.parameters(), tr_b.model.parameters()):
        assert torch.equal(x, y)
    _assert_matches_jax(tb, tr_b, stats, res, j)


def test_delta_staging_equals_full_staging(jax_runs):
    """The delta contract (box_wrapper.cc:129-186): with overlapping
    passes, a table reusing its window equals one that re-stages the
    whole working set every pass (drop_window), bit for bit; the staged
    count is the working-set DELTA, and every count is the
    reference's."""
    j = jax_runs["delta"]
    _, tds = _passes(OVERLAP_BASES, seed=50)
    ta, tb = _tiered(), _tiered()
    tr_a = _port_trainer(ta, j["start"])
    tr_b = _port_trainer(tb, j["start"])
    ha, hb = BoxPSHelper(ta, trainer=tr_a), BoxPSHelper(tb, trainer=tr_b)
    resident: set = set()
    for p, ds in enumerate(tds):
        want = set(ds.pass_keys().tolist())
        ha.begin_pass(ds)
        st = ta.last_pass_stats
        assert st["staged"] == len(want - resident), (p, st)
        assert st["resident"] == len(want & resident), (p, st)
        assert st["evicted"] == 0
        assert _stats(ta) == j["stats"][p]
        resident |= want
        ra = tr_a.train_pass(ds)
        ha.end_pass(ds)
        tb.drop_window()
        hb.begin_pass(ds)
        assert tb.last_pass_stats["staged"] == len(want)
        rb = tr_b.train_pass(ds)
        hb.end_pass(ds)
        assert ra["auc"] == rb["auc"]
    assert st["staged"] < 0.5 * (st["staged"] + st["resident"])
    for x, y in zip(tr_a.model.parameters(), tr_b.model.parameters()):
        assert torch.equal(x, y)
    assert ta.rows_digest() == tb.rows_digest()
    ka, fa = _host_rows(ta)
    kb, fb = _host_rows(tb)
    np.testing.assert_array_equal(ka, kb)
    for f in fa:
        np.testing.assert_array_equal(fa[f], fb[f], err_msg=f)


def test_async_epilogue_parity_bit_identical(jax_runs):
    """The asynchronous epilogue with overlapped staging equals the
    synchronous path bit for bit (same staged counts, dense params and
    host rows), runs its jobs in the background, and the async run
    matches the reference's in class."""
    j = jax_runs["delta"]
    _, tds = _passes(OVERLAP_BASES, seed=50)
    runs = {}
    for mode in (False, True):
        with flags_scope(async_end_pass=mode):
            t = _tiered()
            tr = _port_trainer(t, j["start"])
            stats, res = _run_helper(t, tr, tds, overlap=True)
        runs[mode] = (t, tr, stats, res)
    (ta, tr_a, sa, _), (tb, tr_b, sb, rb) = runs[False], runs[True]
    assert sa == sb
    assert tb.endpass_stats()["jobs_run"] >= len(tds)
    assert ta.endpass_stats()["jobs_run"] == 0
    for x, y in zip(tr_a.model.parameters(), tr_b.model.parameters()):
        assert torch.equal(x, y)
    assert ta.rows_digest() == tb.rows_digest()
    assert np.abs(_host_rows(tb)[1]["embed_w"]).sum() > 0
    _assert_matches_jax(tb, tr_b, sb, rb, j)


def test_tiered_preloader_overlapped_plan_build(jax_runs):
    """A preloader builds pass k+1's plan while k trains (plan_scope
    pending rows); begin_pass scatters the staged values into the
    plan-baked rows. Staged counts equal the sequential oracle's and the
    reference's preloaded run's; the model equals the oracle's per key
    (row ids differ) and the reference's in class."""
    j = jax_runs["preload"]
    _, tds = _passes((0, 500), seed=80)
    order = [tds[0], tds[1], tds[0], tds[1]]
    ta = _tiered()
    tr_a = _port_trainer(ta, j["start"])
    staged_a, _ = _run_helper(ta, tr_a, order, resident=True)
    tb = _tiered()
    tr_b = _port_trainer(tb, j["start"])
    hb = BoxPSHelper(tb, trainer=tr_b)
    pre = PassPreloader(iter(order), build_fn=tr_b.build_resident_pass,
                        device="cpu")
    pre.start_next()
    stats, res, pending_seen = [], [], 0
    for i, ds in enumerate(order):
        rp = pre.wait()
        hb.begin_pass(ds)
        stats.append(_stats(tb))
        if pre.start_next() and i + 1 < len(order):
            hb.stage_pass(order[i + 1])
        res.append(tr_b.train_pass_resident(rp))
        pending_seen = max(pending_seen, tb.pending_rows())
        hb.end_pass(ds)
    pre.drain()
    tb.fence()
    assert pending_seen > 0
    assert [s["staged"] for s in stats] == [s["staged"] for s in staged_a]
    assert stats[1]["staged"] > 0
    ka, fa = _host_rows(ta)
    kb, fb = _host_rows(tb)
    np.testing.assert_array_equal(ka, kb)
    for f in fa:
        np.testing.assert_allclose(fa[f], fb[f], rtol=STATE_RTOL,
                                   atol=STATE_ATOL, err_msg=f)
    _assert_matches_jax(tb, tr_b, stats, res, j)


def _model_sd():
    torch.manual_seed(0)
    return DeepFM(S, 3 + MF, DENSE, hidden=HIDDEN,
                  compute_dtype=torch.float32).state_dict()


@pytest.fixture(scope="module")
def sliding_ref():
    """Streaming passes over sliding ranges in a window that holds them
    all: the port's digest every windowed run must reproduce."""
    _, tds = _passes((0, 20, 40, 60), seed=90)
    ref = _tiered()
    _run_helper(ref, _port_trainer(ref, _model_sd()), tds)
    return tds, ref.rows_digest()


@pytest.mark.parametrize("depth", [0, 2])
def test_train_passes_tiered_depths_evict_and_spill(depth, sliding_ref,
                                                    tmp_path):
    """``train_passes_tiered`` at depth 0 and 2, in windows smaller than
    the passes' union (the plan builds evict) over host stores smaller
    than the model (rows demote to SSD segments), equals the streaming
    passes in a window that holds everything, by digest."""
    tds, want = sliding_ref
    t = _tiered(cap=110, host_capacity=100, ssd_dir=str(tmp_path))
    tr = _port_trainer(t, _model_sd())
    res = tr.train_passes_tiered(tds, depth=depth)
    assert len(res) == len(tds)
    assert t.rows_digest() == want
    assert t.ssd_stats()["demoted_rows"] > 0
    assert t._evict_async_rows > 0
    for s in range(N):
        assert len(t.indexes[s]) <= t.capacity


def test_tiered_index_route_digest_matches_flag_off(sliding_ref):
    """Streaming passes in an evicting window with ``use_pallas_index``:
    the shards' device key indexes (reset after every promote and
    evict, then re-seeded from the refilled kv) give the flag-off
    digest."""
    from paddlebox_tpu_torch.ops import index as tindex

    def dispatches():
        return {k: tindex.DISPATCH.get(k, 0)
                for k in (("index.assign", "device"),
                          ("index.assign", "host"))}

    tds, want = sliding_ref
    runs = {}
    for flag in (False, True):
        before = dispatches()
        with flags_scope(use_pallas_index=flag):
            t = _tiered(cap=110)
            stats, _ = _run_helper(t, _port_trainer(t, _model_sd()), tds)
        runs[flag] = (t, stats, {k: v - before[k]
                                 for k, v in dispatches().items()})
    (off, s_off, _), (on, s_on, ticks) = runs[False], runs[True]
    assert s_on == s_off
    assert sum(st["evicted"] for st in s_on) > 0
    assert ticks[("index.assign", "device")] > 0
    assert on.rows_digest() == off.rows_digest() == want


def test_tiered_adam_opt_ext_roundtrips():
    """SparseAdam's per-row state (the opt_ext block) survives the
    window: begin_pass → device update → end_pass → host store → next
    window; held against the reference's planted run."""
    from paddlebox_tpu.ps.sgd import SparseAdamConfig as JAdam
    cfg = SparseAdamConfig(mf_create_thresholds=0.0, mf_initial_range=0.0)
    table = _tiered(cap=32, mf_dim=2, cfg=cfg)
    assert table.opt_ext > 0
    with j_flags_scope(warmup_pass_scatter=False):
        jt = JTiered(N, mf_dim=2, capacity_per_shard=32,
                     cfg=JAdam(mf_create_thresholds=0.0,
                               mf_initial_range=0.0))
    keys = np.arange(1, 25, dtype=np.uint64)
    table.begin_pass(keys)
    jt.begin_pass(keys)
    mf_end = NUM_FIXED + 2
    jdata = np.asarray(jax.device_get(jt.state.data)).copy()
    for s in range(N):
        _, rows = table.indexes[s].items()
        jk, jr = jt.indexes[s].items()
        np.testing.assert_array_equal(rows, jr)
        r = torch.from_numpy(rows.astype(np.int64))
        table.states[s].data[r, NUM_FIXED:mf_end] = 2.0
        table.states[s].data[r, mf_end:] = 0.5
        table._touched[s][rows] = True
        jdata[s][jr, NUM_FIXED:mf_end] = 2.0
        jdata[s][jr, mf_end:] = 0.5
        jt._touched[s][jr] = True
    jt.state = type(jt.state).from_logical(jdata, jt.capacity,
                                           ext=jt.opt_ext)
    table.end_pass()
    jt.end_pass()
    for s in range(N):
        ks, _ = table.hosts[s].index.items()
        got, want = table.hosts[s].fetch(ks), jt.hosts[s].fetch(ks)
        assert got["embedx_w"].shape[1] == 2
        for f in got:
            np.testing.assert_array_equal(got[f], want[f], err_msg=f)
        np.testing.assert_allclose(got["opt_ext"], 0.5)
    table.drop_window()
    table.begin_pass(keys)
    for s in range(N):
        _, rows = table.indexes[s].items()
        d = table.states[s].data.numpy()
        np.testing.assert_allclose(d[rows, NUM_FIXED:mf_end], 2.0)
        np.testing.assert_allclose(d[rows, mf_end:], 0.5)
    table.end_pass()


# ---------------------------------------------------------------------------
# the host-tier lifecycle, against the reference
# ---------------------------------------------------------------------------

def _seed_both(n_keys=40, mf=2, cap=64):
    """A port and a JAX tiered table (no trainer) holding the same host
    rows: show 4, clk 2, embed_w = key."""
    t = _tiered(cap=cap, mf_dim=mf)
    with j_flags_scope(warmup_pass_scatter=False):
        jt = JTiered(N, mf_dim=mf, capacity_per_shard=cap, cfg=JCfg(**CFG))
    keys = np.arange(1, n_keys + 1, dtype=np.uint64)
    for tab in (t, jt):
        for s, ks in enumerate(tab._split_by_owner(keys)):
            f = _field_rows(len(ks), 0.0, mf)
            f["show"][:] = 4.0
            f["clk"][:] = 2.0
            f["embed_w"] = ks.astype(np.float32)
            tab.hosts[s].update(ks, f)
    return t, jt


def _assert_tables_equal(t, jt):
    gk, gf = _host_rows(t)
    wk, wf = _host_rows(jt)
    np.testing.assert_array_equal(gk, wk)
    for f in gf:
        np.testing.assert_array_equal(gf[f], wf[f], err_msg=f)


def test_tiered_save_load_roundtrips_through_tiers(tmp_path):
    """save_base after a spill still exports the COMPLETE model; the
    files equal the reference's array for array, and each package loads
    the other's."""
    t, jt = _seed_both()
    for tab, tag in ((t, "t"), (jt, "j")):
        assert tab.save_delta(str(tmp_path / f"{tag}delta.npz")) == 40
        assert tab.spill_cold(str(tmp_path / f"{tag}spill"),
                              threshold=1e9) > 0
        assert tab.save_base(str(tmp_path / f"{tag}base.npz")) == 40
    for name in ("delta", "base"):
        a = np.load(str(tmp_path / f"t{name}.npz"))
        b = np.load(str(tmp_path / f"j{name}.npz"))
        assert sorted(a.files) == sorted(b.files)
        for f in b.files:
            np.testing.assert_array_equal(a[f], b[f], err_msg=f)
    t2 = _tiered(cap=64, mf_dim=2)
    assert t2.load(str(tmp_path / "jbase.npz")) == 40
    with j_flags_scope(warmup_pass_scatter=False):
        jt2 = JTiered(N, mf_dim=2, capacity_per_shard=64, cfg=JCfg(**CFG))
    assert jt2.load(str(tmp_path / "tbase.npz")) == 40
    _assert_tables_equal(t2, jt2)
    _assert_tables_equal(t2, t)
    # the restored table opens a window over the loaded rows
    keys = np.arange(1, 41, dtype=np.uint64)
    t2.begin_pass(keys)
    for s, ks in enumerate(t2._split_by_owner(keys)):
        rows = t2.indexes[s].lookup(ks)
        w = t2.states[s].data.numpy()[rows, FIELD_COL["embed_w"]]
        np.testing.assert_array_equal(w, ks.astype(np.float32))
    t2.end_pass()


def test_tiered_spilled_rows_promote_on_stage(tmp_path):
    """A key whose row lives only in a spill file comes back with its
    value when a later pass stages it (LoadSSD2Mem,
    box_wrapper.cc:1415), as in the reference."""
    t, jt = _seed_both()
    keys = np.arange(1, 41, dtype=np.uint64)
    for tab, tag in ((t, "t"), (jt, "j")):
        tab.save_base(str(tmp_path / f"{tag}b.npz"))
        assert tab.spill_cold(str(tmp_path / f"{tag}sp"), threshold=1e9) > 0
        assert tab.feature_count() == 0
        tab.drop_window()
        tab.begin_pass(keys)
    jdata = np.asarray(jax.device_get(jt.state.data))
    for s, ks in enumerate(t._split_by_owner(keys)):
        rows = t.indexes[s].lookup(ks)
        np.testing.assert_array_equal(rows, jt.indexes[s].lookup(ks))
        np.testing.assert_array_equal(t.states[s].data.numpy()[rows],
                                      jdata[s][rows])
        np.testing.assert_array_equal(
            t.states[s].data.numpy()[rows, FIELD_COL["embed_w"]],
            ks.astype(np.float32))
    assert t.last_pass_stats["staged"] == jt.last_pass_stats["staged"] == 40
    t.end_pass()
    jt.end_pass()


def test_tiered_lifecycle_shrink_and_merge(tmp_path):
    """merge_model folds a single-table save (split by key % N, stats
    accumulate, new keys insert); shrink ages the host tier: both as the
    reference does, exactly."""
    t, jt = _seed_both()
    mkeys = np.arange(21, 51, dtype=np.uint64)
    blob = _field_rows(30, 0.0)
    blob.update(show=np.full(30, 10.0, np.float32),
                clk=np.full(30, 5.0, np.float32),
                embed_w=np.full(30, -7.0, np.float32))
    path = str(tmp_path / "m.npz")
    np.savez(path, keys=mkeys, **blob)
    for tab in (t, jt):
        assert tab.merge_model(path) == 30
        assert tab.feature_count() == 50
    got = t.hosts[21 % N].fetch(np.array([21], np.uint64))
    assert got["show"][0] == 14.0 and got["embed_w"][0] == 21.0
    got = t.hosts[50 % N].fetch(np.array([50], np.uint64))
    assert got["embed_w"][0] == -7.0
    _assert_tables_equal(t, jt)
    assert t.shrink(delete_threshold=3.0, decay=0.5) == \
        jt.shrink(delete_threshold=3.0, decay=0.5) > 0
    assert t.feature_count() == jt.feature_count() < 50
    _assert_tables_equal(t, jt)


# ---------------------------------------------------------------------------
# port-only behaviour: the epilogue, reconcile, eviction, guards
# ---------------------------------------------------------------------------

def test_async_writeback_failure_surfaces_at_fence(tmp_path):
    """A failing write-back job surfaces at the fence (explicit, the
    read barrier, a save), once, as EndPassWritebackError."""
    def check(surface):
        table = _tiered(cap=64, mf_dim=2)
        table.begin_pass(np.arange(1, 33, dtype=np.uint64))
        _plant(table, 3.0)
        with installed(FaultPlan.parse(
                "endpass.writeback:fail:nth=1,exc=crash")):
            table.end_pass()
            with pytest.raises(EndPassWritebackError):
                surface(table)
        return table

    t1 = check(lambda t: t.fence())
    t1.fence()                               # consumed
    check(lambda t: t.feature_count())
    check(lambda t: t.save_delta(str(tmp_path / "never.npz")))


def test_overlap_stage_reconciles_mid_pass_assign():
    """Key K staged for pass 2 while pass 1 is open, then assigned and
    trained by pass 1: the stale fetched value is dropped and the
    resident row wins."""
    table = _tiered(cap=64, mf_dim=2)
    K = np.uint64(200)
    s = int(K) % N
    f0 = _field_rows(1, 0.0)
    f0["embed_w"] = np.array([-5.0], np.float32)
    table.hosts[s].update(np.array([K]), f0)
    table.begin_pass(np.arange(1, 17, dtype=np.uint64))
    k2 = np.concatenate([np.arange(9, 17, dtype=np.uint64), [K]])
    table.stage(k2, background=False)
    assert np.any(np.concatenate(table._stage.new_keys) == K)
    with table.host_lock:
        row = int(table.indexes[s].assign(np.array([K]))[0])
        table._touched[s][row] = True
    table.states[s].data[row, FIELD_COL["embed_w"]] = 7.0
    table.end_pass()
    assert table.hosts[s].fetch(np.array([K]))["embed_w"][0] == 7.0
    table.begin_pass(k2)
    row2 = int(table.indexes[s].lookup(np.array([K]))[0])
    assert float(table.states[s].data[row2, FIELD_COL["embed_w"]]) == 7.0
    table.end_pass()


def test_eviction_writes_back_touched_rows():
    """Capacity-pressure eviction: clean rows evict silently, a row
    dirtied since the last write-back is written back before release."""
    cap = 16
    table = _tiered(cap=cap, mf_dim=2)
    table.begin_pass(np.arange(0, N * cap, dtype=np.uint64))
    _plant(table, 3.0)
    table.end_pass()
    keys0, rows0 = table.indexes[0].items()
    table.states[0].data[int(rows0[0]), FIELD_COL["embed_w"]] = 9.0
    table._touched[0][rows0[0]] = True
    table.begin_pass(np.arange(N * cap, 2 * N * cap, dtype=np.uint64))
    st = table.last_pass_stats
    assert st["evicted"] > 0 and st["evicted_writeback"] == 1
    assert table.hosts[0].fetch(keys0[:1])["embed_w"][0] == 9.0
    assert table.hosts[0].fetch(keys0[1:2])["embed_w"][0] == 3.0
    table.end_pass()


def test_drop_window_discards_pending_stage():
    """drop_window (run by load/merge_model/shrink) discards a pending
    stage and zeroes the windows IN PLACE: the next pass re-fetches the
    post-shrink values."""
    table = _tiered(cap=32, mf_dim=2)
    k1 = np.arange(1, 17, dtype=np.uint64)
    table.begin_pass(k1)
    _plant(table, 5.0, col="show")
    table.end_pass()
    held = [st.data for st in table.states]
    table.stage(k1, background=False)
    table.shrink(delete_threshold=0.0, decay=0.5)
    assert table._stage is None
    assert all(not st.data.any() for st in table.states)
    assert all(st.data is h for st, h in zip(table.states, held))
    table.begin_pass(k1)
    assert table.last_pass_stats["staged"] == len(k1)
    assert table.last_pass_stats["resident"] == 0
    for s in range(N):
        _, rows = table.indexes[s].items()
        np.testing.assert_allclose(
            table.states[s].data.numpy()[rows, FIELD_COL["show"]], 2.5)
    table.end_pass()


def test_tiered_guards(tmp_path):
    table = _tiered(cap=16, mf_dim=2)
    with pytest.raises(RuntimeError):
        table.end_pass()
    table.begin_pass(np.arange(8, dtype=np.uint64))
    with pytest.raises(RuntimeError):
        table.begin_pass(np.arange(8, dtype=np.uint64))
    with pytest.raises(RuntimeError):
        table.save_base(str(tmp_path / "never.npz"))
    with pytest.raises(RuntimeError):
        table.drop_window()
    table.stage(np.arange(8, 16, dtype=np.uint64), background=False)
    with pytest.raises(RuntimeError):
        table.stage(np.arange(8, dtype=np.uint64))
    table.end_pass()
    table.begin_pass(np.arange(8, 16, dtype=np.uint64))
    table.end_pass()
    with pytest.raises(ValueError):
        table.stage(np.arange(N * 64, dtype=np.uint64), background=False)


# ---------------------------------------------------------------------------
# the SSD tier under the tiered table
# ---------------------------------------------------------------------------

def test_ssd_demote_fences_inflight_endpass(tmp_path):
    """A demote fences first: the in-flight write-back lands (its rows
    touched) before victims are chosen, so they never spill while
    colder rows exist."""
    from paddlebox_tpu_torch.ps.host_store import HostStore
    hs = HostStore(mf_dim=2, capacity=64, ssd_dir=str(tmp_path / "tier"))
    cold = np.arange(1, 41, dtype=np.uint64)
    hs.update(cold, _field_rows(40, 1.0))
    hs.export_rows()
    hot = np.arange(101, 111, dtype=np.uint64)
    calls = []

    def inflight():
        if not calls:
            hs.update(hot, _field_rows(10, 9.0))
        calls.append(1)

    hs.read_barrier = inflight
    with flags_scope(host_demote_watermark=0.5, host_demote_target=0.25):
        n = hs.demote_to_watermark(barrier=True)
    assert calls and n > 0
    assert (hs.index.lookup(hot) >= 0).all()
    assert not hs.ssd.contains(hot).any()
    assert hs.ssd.contains(cold).sum() == n


def _train_mutate(table):
    """embed_w = key * 0.001 + 1 on every resident row, touched."""
    with table.host_lock:
        for s in range(table.n):
            keys, rows = table.indexes[s].items()
            table.states[s].data[torch.from_numpy(rows.astype(np.int64)),
                                 FIELD_COL["embed_w"]] = torch.from_numpy(
                (keys.astype(np.float64) * 0.001 + 1).astype(np.float32))
            table._touched[s][rows] = True


def test_ssd_promote_under_plan_rollback_releases_rows(tmp_path):
    """A promote under a plan_scope that rolls back: the plan's window
    rows and pending pins are released, the promoted host rows keep
    their values, and a real pass stages them."""
    table = _tiered(n=2, cap=256, mf_dim=2, host_capacity=1 << 12,
                    ssd_dir=str(tmp_path / "tier"))
    keys = np.arange(1, 65, dtype=np.uint64)
    table.stage(keys, background=False)
    table.begin_pass(keys)
    _train_mutate(table)
    table.end_pass()
    table.fence()
    table.drop_window()
    for h in table.hosts:
        h.demote_cold()
    assert table.has_spilled_rows()
    assert sum(len(h) for h in table.hosts) == 0
    with pytest.raises(RuntimeError, match="boom"):
        with table.plan_scope():
            for s, ks in enumerate(table._split_by_owner(keys)):
                with table.host_lock:
                    table.indexes[s].assign(ks)
                    table._note_plan_assigned(s, ks)
            assert table.prefetch_promote(keys) == len(keys)
            raise RuntimeError("boom")
    assert table.pending_rows() == 0
    for s, ks in enumerate(table._split_by_owner(keys)):
        assert (table.indexes[s].lookup(ks) == -1).all()
    assert not table.has_spilled_rows()
    for s, ks in enumerate(table._split_by_owner(keys)):
        np.testing.assert_allclose(table.hosts[s].fetch(ks)["embed_w"],
                                   ks.astype(np.float64) * 0.001 + 1,
                                   rtol=1e-6)
    table.stage(keys, background=False)
    assert table.begin_pass(keys) == len(keys)
    table.end_pass()
    table.fence()


def _segment_bytes(tier):
    return [open(p, "rb").read() for p in tier.segment_paths()]


def test_ssd_segment_compaction(tmp_path):
    """Compaction rewrites a sealed segment whose live fraction fell
    below the threshold: live rows re-append bit for bit, the dead file
    unlinks, only compaction books the rewrite; the segments equal the
    reference's byte for byte."""
    from paddlebox_tpu.ps.ssd import SsdTier as JSsd
    from paddlebox_tpu_torch.ps.ssd import SsdTier
    keys = np.arange(1, 9, dtype=np.uint64)
    rows = np.arange(32, dtype=np.float32).reshape(8, 4)
    tiers = []
    for cls, tag in ((SsdTier, "t"), (JSsd, "j")):
        tier = cls(str(tmp_path / tag), width=4, segment_rows=8,
                   compact_live_frac=0.9)
        tier.append(keys, rows)
        path0 = tier.segment_paths()[0]
        assert tier.discard(keys[:6]) == 6
        assert tier.maybe_compact() == 2
        assert not os.path.exists(path0)
        tiers.append(tier)
    t, jt = tiers
    assert _segment_bytes(t) == _segment_bytes(jt)
    st = t.stats()
    assert st["compacted_rows"] == 2
    assert st["demoted_rows"] == 8 and st["promoted_rows"] == 0
    assert st["promote_sec"] == 0.0 and st["promote_wait_sec"] == 0.0
    fk, frows, _ = t.take(keys[6:])
    order = np.argsort(fk)
    np.testing.assert_array_equal(fk[order], keys[6:])
    np.testing.assert_array_equal(frows[order], rows[6:])
    assert len(t) == 0


def test_ssd_tier_sweeps_leftover_segments(tmp_path):
    """A restarted tier on the same directory sweeps the dead process's
    segments (its own or the reference's) instead of appending into
    them."""
    from paddlebox_tpu.ps.ssd import SsdTier as JSsd
    from paddlebox_tpu_torch.ps.ssd import SsdTier
    root = str(tmp_path / "t")
    keys = np.arange(1, 5, dtype=np.uint64)
    for first in (SsdTier, JSsd):
        t1 = first(root, width=4, segment_rows=8)
        t1.append(keys, np.full((4, 4), 7.0, np.float32))
        old = t1.segment_paths()
        assert old and all(os.path.exists(p) for p in old)
        t2 = SsdTier(root, width=4, segment_rows=8)   # "restart"
        assert len(t2) == 0
        assert not any(os.path.exists(p) for p in old)
        t2.append(keys, np.full((4, 4), 42.0, np.float32))
        fk, rows, _ = t2.take(keys)
        assert len(fk) == 4
        np.testing.assert_array_equal(rows, np.full((4, 4), 42.0))


def test_ssd_take_deduplicates_keys(tmp_path):
    """A key duplicated in one take() promotes and leaves the index
    once, as in the reference."""
    from paddlebox_tpu.ps.ssd import SsdTier as JSsd
    from paddlebox_tpu_torch.ps.ssd import SsdTier
    keys = np.arange(1, 4, dtype=np.uint64)
    dup = np.array([2, 2, 1, 2], np.uint64)
    out = []
    for cls, tag in ((SsdTier, "t"), (JSsd, "j")):
        tier = cls(str(tmp_path / tag), width=4)
        tier.append(keys, np.tile(keys.astype(np.float32)[:, None], (1, 4)))
        fk, rows, tch = tier.take(dup)
        assert len(tier) == 1 and tier.stats()["promoted_rows"] == 2
        out.append((fk, rows, tch))
    for a, b in zip(*out):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(np.sort(out[0][0]), [1, 2])


def test_ssd_touched_bit_preserves_delta(tmp_path):
    """A row demoted with an un-exported update keeps its touched bit
    through the tier: export_rows(delta=True) emits it exactly once;
    the exports equal the reference's."""
    from paddlebox_tpu.ps.host_store import HostStore as JHost
    from paddlebox_tpu_torch.ps.host_store import HostStore
    keys = np.arange(1, 11, dtype=np.uint64)
    data = {f: (np.full((10, 2), 5.0, np.float32) if f == "embedx_w"
                else np.arange(10, dtype=np.float32)) for f in FIELDS}
    outs = []
    for cls, tag in ((HostStore, "t"), (JHost, "j")):
        hs = cls(mf_dim=2, capacity=1 << 10, ssd_dir=str(tmp_path / tag))
        hs.update(keys, data)
        assert hs.demote_cold(include_touched=True) == 10
        assert len(hs) == 0 and len(hs.ssd) == 10
        dk, dfields = hs.export_rows(delta=True)
        order = np.argsort(dk)
        np.testing.assert_array_equal(dk[order], keys)
        np.testing.assert_allclose(dfields["embed_w"][order],
                                   data["embed_w"])
        assert len(hs.export_rows(delta=True)[0]) == 0
        assert len(hs.export_rows()[0]) == 10
        outs.append(_segment_bytes(hs.ssd))
    assert outs[0] == outs[1]


# ---------------------------------------------------------------------------
# the pass pipeline: queued stages and asynchronous eviction
# ---------------------------------------------------------------------------

def test_async_evict_orders_behind_writeback():
    """The epilogue job's _evict_ahead runs after the write-back landed:
    every evicted key's host value carries the pass's update, and the
    next begin_pass evicts nothing inline."""
    cap = 16
    table = _tiered(n=2, cap=cap, mf_dim=2)
    k1 = np.arange(0, 2 * cap, dtype=np.uint64)
    table.stage(k1, background=False)
    table.begin_pass(k1)
    _plant(table, 5.0)
    k2 = np.arange(2 * cap, 4 * cap, dtype=np.uint64)
    table.stage(k2, background=False, queue=True)
    table.end_pass()
    table.fence()
    for s, ks in enumerate(table._split_by_owner(k1)):
        np.testing.assert_allclose(table.hosts[s].fetch(ks)["embed_w"], 5.0)
    with table.host_lock:
        assert all(len(table.indexes[s]) == 0 for s in range(2))
    table.begin_pass(k2)
    st = table.last_pass_stats
    assert st["evict_async_rows"] == 2 * cap
    assert st["evicted"] == 0 and st["staged"] == 2 * cap
    table.end_pass()
    table.fence()


def test_async_evict_skips_dirty_rows():
    """A row dirtied after the end_pass snapshot is never evicted by the
    lane; begin_pass's emergency path evicts it with its write-back."""
    cap = 16
    table = _tiered(n=2, cap=cap, mf_dim=2)
    k1 = np.arange(0, 2 * cap, dtype=np.uint64)
    table.stage(k1, background=False)
    table.begin_pass(k1)
    _plant(table, 5.0)
    table.end_pass()
    table.fence()
    k2 = np.arange(2 * cap, 4 * cap, dtype=np.uint64)
    table.stage(k2, background=False, queue=True)
    keys0, rows0 = table.indexes[0].items()
    table.states[0].data[int(rows0[0]), FIELD_COL["embed_w"]] = 9.0
    table._touched[0][rows0[0]] = True
    assert table._evict_ahead() == 2 * cap - 1
    with table.host_lock:
        assert int(table.indexes[0].lookup(keys0[:1])[0]) == rows0[0]
    assert table.hosts[0].fetch(keys0[:1])["embed_w"][0] == 5.0
    table.begin_pass(k2)
    st = table.last_pass_stats
    assert st["evicted"] == 1 and st["evicted_writeback"] == 1, st
    assert st["evict_emergency_sec"] > 0.0
    assert table.hosts[0].fetch(keys0[:1])["embed_w"][0] == 9.0
    table.end_pass()
    table.fence()


def test_async_evict_never_unpins_queued_promote(tmp_path):
    """A row plan-assigned (pending) for a queued pass, its value just
    promoted from the SSD tier, survives eviction pressure and reaches
    the window at its own begin_pass."""
    cap = 12
    table = _tiered(n=2, cap=cap, mf_dim=2, ssd_dir=str(tmp_path / "t"))
    k1 = np.arange(0, 16, dtype=np.uint64)
    table.stage(k1, background=False)
    table.begin_pass(k1)
    _plant(table, 5.0)
    table.end_pass()
    table.fence()
    pend = np.arange(100, 108, dtype=np.uint64)
    k2 = np.concatenate([pend, np.arange(200, 216, dtype=np.uint64)])
    for s, ks in enumerate(table._split_by_owner(pend)):
        table.hosts[s].update(ks, _field_rows(len(ks), 7.0))
    table.fence()
    for h in table.hosts:
        h.demote_cold()
    assert table.has_spilled_rows()
    with table.plan_scope():
        for s, ks in enumerate(table._split_by_owner(pend)):
            with table.host_lock:
                pre = table.indexes[s].lookup(ks)
                table.indexes[s].assign(ks)
                table._note_plan_assigned(s, ks[pre < 0])
        assert table.prefetch_promote(pend) == len(pend)
        table.stage(k2, background=False, queue=True)
    assert table._evict_ahead() == 16
    with table.host_lock:
        for s, ks in enumerate(table._split_by_owner(pend)):
            assert (table.indexes[s].lookup(ks) >= 0).all()
    table.begin_pass(k2)
    assert table.last_pass_stats["evicted"] == 0
    for s, ks in enumerate(table._split_by_owner(pend)):
        rows = table.indexes[s].lookup(ks)
        np.testing.assert_allclose(
            table.states[s].data.numpy()[rows, FIELD_COL["embed_w"]], 7.0)
    table.end_pass()
    table.fence()


class _Tok:
    """A stand-in pass for the pipeline tests."""

    def upload(self, device=None):
        pass

    def nbytes(self):
        return 0


def _plan_build(table, abort_at=None):
    built = []

    def build(ks):
        for s, sub in enumerate(table._split_by_owner(ks)):
            with table.host_lock:
                pre = table.indexes[s].lookup(sub)
                table.indexes[s].assign(sub)
                table._note_plan_assigned(s, sub[pre < 0])
        built.append(ks[0])
        if abort_at is not None and len(built) == abort_at:
            raise PreloadBuildAborted("stop between build stages")
        return _Tok()

    return build


def test_pipeline_plan_rollback_on_abort():
    """A build that dies after plan-assigning its keys rolls them back:
    nothing pinned, no rows, no queued stage; a normal pass follows."""
    table = _tiered(n=2, cap=256, mf_dim=2)
    k1 = np.arange(0, 32, dtype=np.uint64)
    k2 = np.arange(100, 132, dtype=np.uint64)
    pipe = PassPipeline(iter([k1, k2]),
                        build_fn=_plan_build(table, abort_at=2),
                        window_table=table, keys_of=lambda k: k,
                        device="cpu")
    pipe.start_next()
    assert pipe.wait() is not None
    pipe.begin_pass()
    pipe.end_pass()
    assert pipe.wait() is None
    pipe.drain()
    table.fence()
    assert table.pending_rows() == 0
    for s, sub in enumerate(table._split_by_owner(k2)):
        assert (table.indexes[s].lookup(sub) == -1).all()
    assert len(table._stage_q) == 0
    table.stage(k2, background=False)
    assert table.begin_pass(k2) == len(k2)
    table.end_pass()
    table.fence()


def test_pipeline_drain_discards_queued_stages():
    """drain() with built-but-never-begun passes discards their stages
    and releases their plan rows; the open pass's rows stay."""
    table = _tiered(n=2, cap=256, mf_dim=2)
    k1 = np.arange(0, 32, dtype=np.uint64)
    k2 = np.arange(100, 132, dtype=np.uint64)
    k3 = np.arange(116, 148, dtype=np.uint64)
    pipe = PassPipeline(iter([k1, k2, k3]), build_fn=_plan_build(table),
                        window_table=table, depth=3, keys_of=lambda k: k,
                        device="cpu")
    pipe.start_next()
    pipe.wait()
    pipe.begin_pass()
    for _ in range(500):
        with table.host_lock:
            q = len(table._stage_q)
        if q == 2:
            break
        time.sleep(0.01)
    assert q == 2
    pipe.end_pass()
    pipe.drain()
    table.fence()
    assert table.pending_rows() == 0 and len(table._stage_q) == 0
    with table.host_lock:
        gone = np.setdiff1d(np.concatenate([k2, k3]), k1)
        for s, sub in enumerate(table._split_by_owner(gone)):
            assert (table.indexes[s].lookup(sub) == -1).all()
        for s, sub in enumerate(table._split_by_owner(k1)):
            assert (table.indexes[s].lookup(sub) >= 0).all()


def test_async_evict_pins_inflight_stage():
    """_evict_ahead firing during a queued stage's host fetch never
    evicts a key that stage classified as resident."""
    cap = 16
    table = _tiered(n=2, cap=cap, mf_dim=2)
    k1 = np.arange(0, 2 * cap, dtype=np.uint64)
    table.stage(k1, background=False)
    table.begin_pass(k1)
    _plant(table, 5.0)
    table.end_pass()
    table.fence()
    table.stage(np.arange(100, 100 + 2 * cap, dtype=np.uint64),
                background=False, queue=True)
    fired = []
    orig = table._fetch_stage_values

    def hook(s, new_keys):
        if not fired:
            fired.append(table._evict_ahead())
        return orig(s, new_keys)

    table._fetch_stage_values = hook
    try:
        table.stage(k1, background=False, queue=True)
    finally:
        table._fetch_stage_values = orig
    assert fired == [0]
    with table.host_lock:
        for s, ks in enumerate(table._split_by_owner(k1)):
            assert (table.indexes[s].lookup(ks) >= 0).all()
        assert table._staging_keys is None
    table.discard_queued_stages()
    table.fence()


def test_begin_failure_restores_queued_stage():
    """A begin_pass that fails after consuming a queued stage restores it
    to the queue head and drops the open-pass pin."""
    cap = 8
    table = _tiered(n=2, cap=cap, mf_dim=2)
    k1 = np.arange(0, 2 * cap, dtype=np.uint64)
    table.stage(k1, background=False)
    table.begin_pass(k1)
    _plant(table, 5.0)
    table.end_pass()
    table.fence()
    kb = np.arange(100, 100 + 2 * cap, dtype=np.uint64)
    table.stage(kb, background=False, queue=True)
    table.stage(k1, background=False, queue=True)
    with pytest.raises(Exception):
        table.begin_pass(kb)
    assert not table.in_pass
    with table.host_lock:
        assert len(table._stage_q) == 2
        assert np.array_equal(np.concatenate(table._stage_q[0].keys),
                              np.concatenate(table._split_by_owner(kb)))
        assert all(len(a) == 0 for a in table._open_keys)
    assert table.discard_queued_stages() == 2
    table.fence()
    table.stage(kb, background=False)
    assert table.begin_pass(kb) == len(kb)
    table.end_pass()
    table.fence()


def test_pin_working_set_covers_plan_build():
    """The pre-build pin holds from the plan's first row lookup:
    _evict_ahead between plan build and stage evicts nothing it
    baked."""
    cap = 16
    table = _tiered(n=2, cap=cap, mf_dim=2)
    k1 = np.arange(0, 2 * cap, dtype=np.uint64)
    table.stage(k1, background=False)
    table.begin_pass(k1)
    _plant(table, 5.0)
    table.end_pass()
    table.fence()
    table.stage(np.arange(100, 100 + 2 * cap, dtype=np.uint64),
                background=False, queue=True)
    table.pin_working_set(k1)
    baked = [table.indexes[s].lookup(ks)
             for s, ks in enumerate(table._split_by_owner(k1))]
    assert table._evict_ahead() == 0
    table.stage(k1, background=False, queue=True)
    with table.host_lock:
        assert table._staging_keys is None
        for s, ks in enumerate(table._split_by_owner(k1)):
            np.testing.assert_array_equal(table.indexes[s].lookup(ks),
                                          baked[s])
    table.discard_queued_stages()
    table.fence()


def test_discard_rejects_straddling_fetch():
    """A queued fetch that straddles discard_queued_stages raises instead
    of appending a zombie stage."""
    table = _tiered(n=2, cap=64, mf_dim=2)
    k1 = np.arange(0, 32, dtype=np.uint64)
    orig = table._fetch_stage_values
    fired = []

    def hook(s, new_keys):
        if not fired:
            fired.append(table.discard_queued_stages())
        return orig(s, new_keys)

    table._fetch_stage_values = hook
    try:
        with pytest.raises(RuntimeError, match="discarded"):
            table.stage(k1, background=False, queue=True)
    finally:
        table._fetch_stage_values = orig
    with table.host_lock:
        assert len(table._stage_q) == 0 and table._staging_keys is None
    table.stage(k1, background=False, queue=True)
    assert table.begin_pass(k1) == len(k1)
    table.end_pass()
    table.fence()


def test_plan_headroom_evicts_for_a_window_smaller_than_the_union():
    """The port's plan-time eviction: a pinned plan build whose new keys
    do not fit beside the resident rows releases clean, unpinned rows
    (booked as async eviction); without a pin it raises as before."""
    from paddlebox_tpu_torch.ps.kv import TableFullError
    cap = 16
    table = _tiered(n=2, cap=cap, mf_dim=2)
    k1 = np.arange(0, 2 * cap, dtype=np.uint64)
    table.begin_pass(k1)
    _plant(table, 5.0)
    table.end_pass()
    table.fence()
    k2 = np.arange(1000, 1000 + 2 * cap, dtype=np.uint64)

    def build():   # the plan-depth assign of prepare_global
        for s, sub in enumerate(table._split_by_owner(k2)):
            with table.host_lock:
                table._shard_rows(s, sub, assign=True)

    with pytest.raises(TableFullError):
        with table.plan_scope():
            build()
    assert table.pending_rows() == 0
    table.pin_working_set(k2)
    with table.plan_scope():
        build()
        table.stage(k2, background=False, queue=True)
    assert table._evict_async_rows == 2 * cap
    table.begin_pass(k2)
    assert table.last_pass_stats["staged"] == 2 * cap
    assert table.last_pass_stats["evict_async_rows"] == 2 * cap
    table.end_pass()
    table.fence()
    for s, ks in enumerate(table._split_by_owner(k1)):
        np.testing.assert_allclose(table.hosts[s].fetch(ks)["embed_w"], 5.0)
