"""The port's online daemon (``paddlebox_tpu_torch/online.py``) against
the reference's ``paddlebox_tpu/online.py`` on the same criteo files.

The configuration is the reference CLI's (``scripts/onlinelearn.py``):
criteo feed, batch 16, windows of 2 files, ``CtrDnn(hidden=(8,))``,
Adam 1e-2, mf_initial_range 0, with a float32 tower on both sides and the
port's dense params taken from the JAX init. Shrink decisions depend only
on show/clk, which are exact, so every window's keys, show, clk, slot,
mf_size and lifecycle block are held exactly. Row values and dense params
are held in the train-state class after the first window only: the two
packages' float order drifts out of the class after about ten steps of
this model on these files (ROADMAP queue 3, PR 17).
"""

import json
import os

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from paddlebox_tpu import online as jonline
from paddlebox_tpu.config import flags_scope as j_flags_scope
from paddlebox_tpu.data import DataFeedDesc as JDesc
from paddlebox_tpu.data import DatasetFactory as JFactory
from paddlebox_tpu.data.criteo import generate_criteo_files
from paddlebox_tpu.models import CtrDnn as JCtrDnn
from paddlebox_tpu.obs.hub import reset_hub as j_reset_hub
from paddlebox_tpu.ps import EmbeddingTable as JTable
from paddlebox_tpu.ps import SparseSGDConfig as JCfg
from paddlebox_tpu.resilience import faults as jfaults
from paddlebox_tpu.resilience import preemption as jpreemption
from paddlebox_tpu.serving import ServingModel as JServing
from paddlebox_tpu.train import Trainer as JTrainer
from paddlebox_tpu.train.checkpoint import CheckpointManager as JCM

from paddlebox_tpu_torch import convert, online
from paddlebox_tpu_torch.config import flags_scope
from paddlebox_tpu_torch.data import DataFeedDesc, DatasetFactory
from paddlebox_tpu_torch.models import CtrDnn
from paddlebox_tpu_torch.obs.hub import reset_hub
from paddlebox_tpu_torch.ps.sgd import SparseSGDConfig
from paddlebox_tpu_torch.ps.table import FIELDS, EmbeddingTable
from paddlebox_tpu_torch.resilience import faults, preemption
from paddlebox_tpu_torch.serving import ServingModel
from paddlebox_tpu_torch.train.checkpoint import CheckpointManager
from paddlebox_tpu_torch.train.trainer import Trainer

STATE_RTOL, STATE_ATOL = 2e-4, 2e-5
BS, WINDOW, ROWS, MF = 16, 2, 32, 4
EXACT = ("show", "clk", "slot", "mf_size")
FLAGS = dict(seed=7, stream_window_files=WINDOW, stream_ckpt_every_windows=1,
             shrink_delete_threshold=0.3, show_click_decay_rate=0.9,
             read_thread_num=1)
CFG = dict(mf_create_thresholds=0.0, mf_initial_range=0.0)


@pytest.fixture(autouse=True)
def clean_state():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    for m in (preemption, jpreemption):
        m.clear_stop()
    reset_hub()
    j_reset_hub()
    yield
    for m in (preemption, jpreemption):
        m.clear_stop()
        m.uninstall_signal_handlers()
    faults.clear_plan()
    jfaults.clear_plan()
    reset_hub()
    j_reset_hub()
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("online_data")
    return generate_criteo_files(str(d), num_files=9 * WINDOW,
                                 rows_per_file=ROWS, vocab_per_slot=40,
                                 seed=7)


class Pkg:
    """One package's daemon pieces, built the same way on both sides."""

    def __init__(self, kind: str, params0=None) -> None:
        self.kind = kind
        self.jax = kind == "jax"
        self.flags = j_flags_scope if self.jax else flags_scope
        self.desc = (JDesc if self.jax else DataFeedDesc).criteo(
            batch_size=BS)
        self.desc.key_bucket_min = 2048
        self.factory = JFactory if self.jax else DatasetFactory
        self.online = jonline if self.jax else online
        self.faults = jfaults if self.jax else faults
        self.params0 = params0

    def trainer(self):
        if self.jax:
            table = JTable(mf_dim=MF, capacity=1 << 12, cfg=JCfg(**CFG),
                           unique_bucket_min=2048)
            tr = JTrainer(JCtrDnn(hidden=(8,), compute_dtype=jnp.float32),
                          table, self.desc, tx=optax.adam(1e-2), seed=7)
            self.params0 = convert.ctr_dnn_state_dict_from_flax(
                jax.device_get(tr.state.params))
            return tr
        table = EmbeddingTable(mf_dim=MF, capacity=1 << 12,
                               cfg=SparseSGDConfig(**CFG),
                               unique_bucket_min=2048, device="cpu")
        model = CtrDnn(26, 3 + MF, 13, hidden=(8,),
                       compute_dtype=torch.float32)
        model.load_state_dict(self.params0)
        return Trainer(model, table, self.desc,
                       tx=lambda p: torch.optim.Adam(p, lr=1e-2, eps=1e-8),
                       seed=7, device="cpu")

    def cm(self, root, store=None):
        if self.jax:
            return JCM(root, keep=64, artifacts=store)
        return CheckpointManager(root, keep=64, artifacts=store)

    def serving(self):
        if self.jax:
            return JServing(JCtrDnn(hidden=(8,), compute_dtype=jnp.float32),
                            self.desc, mf_dim=MF, capacity=1 << 12)
        return ServingModel(CtrDnn(26, 3 + MF, 13, hidden=(8,),
                                   compute_dtype=torch.float32),
                            self.desc, mf_dim=MF, capacity=1 << 12,
                            device="cpu")

    def mkds(self, files):
        def make():
            ds = self.factory().create_dataset("QueueDataset", self.desc)
            ds.set_filelist(list(files))
            return ds
        return make

    def logical(self, tr):
        tr.sync_table()
        t = tr.table
        keys, rows = t.index.items()
        order = np.argsort(keys)
        return keys[order], t._gather_host(rows[order])

    def params(self, tr):
        if self.jax:
            return convert.ctr_dnn_state_dict_from_flax(
                jax.device_get(tr.state.params))
        return {k: v.detach().clone() for k, v in
                tr.model.state_dict().items()}


def _run(pkg, files, root, shrink_every=3, plan=None):
    """The train-only daemon over ``files`` in ``pkg``; returns the
    learner, the trainer, its checkpoint manager and a per-window record
    (logical rows and dense params after the window's hook, the
    trainer's lifecycle block)."""
    flags = dict(FLAGS, shrink_every_windows=shrink_every)
    with pkg.flags(**flags):
        tr = pkg.trainer()
        cm = pkg.cm(os.path.join(root, "ckpt"))
        learner = pkg.online.OnlineLearner(
            tr, pkg.mkds(files), cm, filelist_fn=lambda: list(files),
            max_idle_polls=1)
        per_window = []
        hook = learner._on_window

        def record(widx, ds):
            hook(widx, ds)
            per_window.append(dict(rows=pkg.logical(tr),
                                   params=pkg.params(tr),
                                   lifecycle=tr.lifecycle))
        learner._on_window = record
        if plan is not None:
            with pkg.faults.installed(pkg.faults.FaultPlan.parse(
                    plan, seed=7)) as p:
                learner.run()
                learner.plan_stats = p.stats()
        else:
            learner.run()
    return learner, tr, cm, per_window


def _assert_rows(got, want, values: bool, what: str):
    gk, gf = got
    wk, wf = want
    np.testing.assert_array_equal(gk, wk, err_msg=what)
    for f in FIELDS:
        if f in EXACT:
            np.testing.assert_array_equal(gf[f], wf[f],
                                          err_msg=f"{what} {f}")
        elif values:
            np.testing.assert_allclose(gf[f], wf[f], rtol=STATE_RTOL,
                                       atol=STATE_ATOL,
                                       err_msg=f"{what} {f}")


def _status(learner):
    """``online_status()`` with each timestamp replaced by whether it is
    set."""
    st = learner.online_status()
    for k in ("last_publish_ts", "last_shrink_ts"):
        st[k] = st[k] is not None
    return st


def _cursors(cm):
    return [cm.load_cursor(s) for s in cm.steps()]


@pytest.fixture(scope="module")
def parity_runs(files, tmp_path_factory):
    """Both daemons over the 9 windows (shrink every 3)."""
    j = Pkg("jax")
    want = _run(j, files, str(tmp_path_factory.mktemp("jax_online")))
    p = Pkg("port", j.params0)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        got = _run(p, files, str(tmp_path_factory.mktemp("port_online")))
    finally:
        torch.set_num_threads(threads)
    return got, want


def test_daemon_matches_jax_online_learner(parity_runs):
    """Nine windows, three shrink cycles: keys, show, clk, slot, mf_size
    and the lifecycle block exact after every window's hook, the row
    values and dense params in the train-state class after window 1, the
    same cycles and freed rows, and ``online_status()`` equal but for its
    timestamps."""
    (lg, tg, cg, pw_g), (lw, tw, cw, pw_w) = parity_runs
    assert len(pw_g) == len(pw_w) == 9
    for w, (g, x) in enumerate(zip(pw_g, pw_w)):
        _assert_rows(g["rows"], x["rows"], values=w == 0,
                     what=f"window {w}")
        assert g["lifecycle"] == x["lifecycle"], w
    for k, v in pw_w[0]["params"].items():
        np.testing.assert_allclose(pw_g[0]["params"][k].numpy(), v.numpy(),
                                   rtol=STATE_RTOL, atol=STATE_ATOL,
                                   err_msg=k)
    assert lg.shrink_cycles == lw.shrink_cycles == 3
    assert lg.shrunk_rows_total == lw.shrunk_rows_total > 0
    assert _status(lg) == _status(lw)
    assert lg.totals["windows"] == lw.totals["windows"] == 9
    assert lg.totals["examples"] == lw.totals["examples"]


def test_every_cursor_carries_the_same_lifecycle(parity_runs):
    """The boundary cursors of both runs: the same steps, and the same
    lifecycle block in each (absent before the first cycle, then the
    reference's keys and values)."""
    (_, _, cg, _), (_, _, cw, _) = parity_runs
    assert cg.steps() == cw.steps()
    got, want = _cursors(cg), _cursors(cw)
    assert [c.get("lifecycle") for c in got] == \
        [c.get("lifecycle") for c in want]
    lcs = [c["lifecycle"] for c in got if c.get("lifecycle")]
    assert lcs and set(lcs[-1]) == {
        "version", "cycles", "last_shrink_window", "shrunk_rows_total",
        "live_rows", "decay", "delete_threshold"}
    assert lcs[-1]["cycles"] == 3 and lcs[-1]["last_shrink_window"] == 9
    # the boundary after each cycle is a base (a delta cannot carry the
    # whole table's decay)
    for cm in (cg, cw):
        kinds = {s: json.load(open(os.path.join(cm._dir(s),
                                                "meta.json")))["kind"]
                 for s in cm.steps()}
        assert [kinds[s] for s in sorted(kinds)] == (
            ["base", "delta", "base"] + ["delta", "delta", "base"] * 2)


@pytest.mark.parametrize("reader", ["port", "jax"])
def test_seed_from_cursor_reads_the_other_package(parity_runs, reader):
    """Each package's ``_seed_from_cursor`` reads the lifecycle block the
    other package's daemon wrote into its newest cursor."""
    (lg, _, cg, _), (lw, _, cw, _) = parity_runs
    writer_cm, writer = (cw, lw) if reader == "port" else (cg, lg)
    mod = online if reader == "port" else jonline
    trainer = type("T", (), {"lifecycle": None})()

    class Cursor:
        def load_cursor(self):
            return writer_cm.load_cursor()

    seeded = mod.OnlineLearner(trainer, lambda: None, Cursor())
    seeded._seed_from_cursor()
    lc = writer_cm.load_cursor()["lifecycle"]
    assert trainer.lifecycle == lc
    assert seeded.shrink_cycles == writer.shrink_cycles == lc["cycles"]
    assert seeded.shrunk_rows_total == writer.shrunk_rows_total
    assert seeded._last_shrink_window == lc["last_shrink_window"]


def test_supervise_transient_retries_to_the_same_state(files, tmp_path):
    """``online.supervise:fail:nth=1,exc=transient`` fails the first train
    leg: the supervisor retries it on the seeded policy, and each package
    ends where its own fault-free run ends; the two packages agree on
    keys, show, clk, slot and mf_size and on the retry count."""
    three = files[:3 * WINDOW]
    out = {}
    for kind in ("jax", "port"):
        pkg = Pkg(kind, out.get("jax", {}).get("params0"))
        plain = _run(pkg, three, str(tmp_path / f"{kind}_plain"))
        pkg2 = Pkg(kind, pkg.params0)
        faulted = _run(pkg2, three, str(tmp_path / f"{kind}_fault"),
                       plan="online.supervise:fail:nth=1,exc=transient")
        out[kind] = dict(params0=pkg.params0, plain=plain, fault=faulted,
                         pkg=pkg)
        lp, tp = plain[0], plain[1]
        lf, tf = faulted[0], faulted[1]
        assert lf.plan_stats["online.supervise:fail"]["fired"] == 1
        assert lf.leg_failures == 1 and lp.leg_failures == 0
        assert lf.totals["windows"] == lp.totals["windows"] == 3
        _assert_rows(pkg.logical(tf), pkg.logical(tp), values=True,
                     what=f"{kind} faulted vs plain")
        for k, v in pkg.params(tp).items():
            np.testing.assert_array_equal(np.asarray(pkg.params(tf)[k]),
                                          np.asarray(v), err_msg=k)
    pj, pp = out["jax"]["pkg"], out["port"]["pkg"]
    _assert_rows(pp.logical(out["port"]["fault"][1]),
                 pj.logical(out["jax"]["fault"][1]), values=False,
                 what="port vs jax, faulted")
    assert _status(out["port"]["fault"][0]) == \
        _status(out["jax"]["fault"][0])


def test_deterministic_train_failure_degrades_to_serve_only(files,
                                                            tmp_path):
    """A published version is served; then a crash on the train leg
    (``online.supervise:fail:nth=2,exc=crash``: the serve leg's seam is
    the first call) degrades the daemon to ``serve_only`` instead of
    killing it. Both packages land in the same status."""
    status = {}
    params0 = None
    for kind in ("jax", "port"):
        pkg = Pkg(kind, params0)
        root = str(tmp_path / kind)
        with pkg.flags(**dict(FLAGS, shrink_every_windows=0)):
            tr = pkg.trainer()
            params0 = pkg.params0
            cm = pkg.cm(os.path.join(root, "ckpt"),
                        os.path.join(root, "registry"))
            first = pkg.online.OnlineLearner(
                tr, pkg.mkds(files[:WINDOW]), cm,
                filelist_fn=lambda: list(files[:WINDOW]), max_idle_polls=1)
            first.run()
            assert len(cm.artifacts.versions()) == 1
            srv = pkg.serving()
            learner = pkg.online.OnlineLearner(
                tr, pkg.mkds(files[:2 * WINDOW]), cm, serving=srv,
                store=cm.artifacts,
                filelist_fn=lambda: list(files[:2 * WINDOW]),
                max_idle_polls=1, reload_poll_sec=0.05)
            plan = pkg.faults.FaultPlan.parse(
                "online.supervise:fail:nth=2,exc=crash", seed=7)
            with pkg.faults.installed(plan):
                learner.run()
        st = _status(learner)
        assert st["mode"] == "serve_only", st
        assert st["leg_failures"] >= 1
        assert srv.adopted_aid == cm.artifacts.versions()[0]
        status[kind] = st
    assert status["port"] == status["jax"]


def test_shrink_fault_skips_the_cycle_in_both(files, tmp_path):
    """``online.shrink:fail:nth=1,exc=crash``: the first cycle is skipped
    loudly, training goes on and the later cycles run, with the same
    skipped counter, cycles and rows in both packages."""
    three = files[:3 * WINDOW]
    got = {}
    params0 = None
    for kind in ("jax", "port"):
        pkg = Pkg(kind, params0)
        learner, tr, _, pw = _run(
            pkg, three, str(tmp_path / kind), shrink_every=1,
            plan="online.shrink:fail:nth=1,exc=crash")
        params0 = pkg.params0
        got[kind] = (pkg, learner, tr, pw)
        assert learner.shrink_skipped_total == 1
        assert learner.shrink_cycles == 2
        assert learner.totals["windows"] == 3
    (pj, lj, tj, pwj), (pp, lp, tp, pwp) = got["jax"], got["port"]
    assert _status(lp) == _status(lj)
    for w, (g, x) in enumerate(zip(pwp, pwj)):
        _assert_rows(g["rows"], x["rows"], values=False, what=f"w{w}")
        assert g["lifecycle"] == x["lifecycle"]


def test_serving_and_store_come_together():
    with pytest.raises(ValueError, match="come together"):
        online.OnlineLearner(None, lambda: None, None, serving=object())
    assert online.MODES == jonline.MODES
