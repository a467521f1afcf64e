"""The port's checkpoint side (``train/checkpoint.py``, the cursor and
recovery surface of ``train/trainer.py``) on the CPU: the cases of
``tests/test_checkpoint.py`` and the trainer cases of
``tests/test_preemption.py`` with the port's ``Trainer`` (a narrow
DeepFM over 320 ragged records, 10 batches a pass), and three parity
checks:

- a port run preempted at batch 5 and resumed from its cursor checkpoint
  equals the uninterrupted port run EXACTLY (``state_digest``). The CPU
  runs with one thread: an accumulating ``index_put_`` sums in key order
  only below its parallel grain;
- the same scenario against the JAX ``Trainer`` (DeepFM, the same params
  through ``convert``), in both JAX flag settings: logical rows and dense
  params within the ragged train-state class, rtol 2e-4 / atol 2e-5;
- a JAX ``CheckpointManager`` checkpoint restores into the port through
  ``convert.dense_from_jax_checkpoint`` and two more batches match the
  JAX continuation within the same tolerance.

The AUC tables bucket predictions 1e-6 wide, finer than the predictions
agree across the two frameworks (rtol 2e-4 class), so a few instances
land one bucket apart: the instance and label totals match exactly and
the AUC within 1e-4 (at 320 instances one pair flip moves it ~4e-5). A
restored table (no new predictions yet) matches exactly.
"""

import json
import os
import pickle
import shutil

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
from paddlebox_tpu.ps import SparseSGDConfig as JCfg
from paddlebox_tpu.resilience import faults as jfaults
from paddlebox_tpu.resilience import preemption as jpreemption
from paddlebox_tpu.train import Trainer as JTrainer
from paddlebox_tpu.train.checkpoint import CheckpointManager as JCM

from paddlebox_tpu_torch import (ArtifactStore, DeepFM, EmbeddingTable,
                                 InMemoryDataset, Trainer, convert)
from paddlebox_tpu_torch.artifacts import ArtifactLeaseLostError
from paddlebox_tpu_torch.config import flags_scope
from paddlebox_tpu_torch.data import DataFeedDesc, SlotDef, SlotRecord
from paddlebox_tpu_torch.ps.sgd import SparseSGDConfig
from paddlebox_tpu_torch.resilience import preemption
from paddlebox_tpu_torch.resilience.faults import FaultPlan, installed
from paddlebox_tpu_torch.resilience.preemption import PreemptedError
from paddlebox_tpu_torch.train import ResidentPass
from paddlebox_tpu_torch.train.checkpoint import (DENSE,
                                                  CheckpointCorruptError,
                                                  CheckpointManager,
                                                  adopt_artifact,
                                                  state_digest)
from paddlebox_tpu_torch.train.trainer import NanInfError

JAX_FLAGS = {"xla": {}, "pallas": {"use_pallas_gather": True,
                                   "use_pallas_seqpool": True}}
STATE_RTOL, STATE_ATOL = 2e-4, 2e-5
S, MF, DENSE_DIM, BS, CAP, N = 4, 4, 3, 32, 1 << 12, 320
CFG = dict(mf_create_thresholds=0.0, mf_initial_range=0.0,
           learning_rate=0.05, mf_learning_rate=0.05)


@pytest.fixture(autouse=True)
def one_thread_and_clean_stop():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    preemption.clear_stop()
    jpreemption.clear_stop()
    yield
    preemption.clear_stop()
    jpreemption.clear_stop()
    torch.set_num_threads(threads)


def _arrays(n=N, seed=0):
    """Zipf-ragged multi-key slots, as numpy."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        counts = np.minimum(rng.zipf(1.5, size=S), 8)
        offs = np.zeros(S + 1, np.int32)
        np.cumsum(counts, out=offs[1:])
        keys = rng.integers(0, 3000, size=int(offs[-1])).astype(np.uint64)
        out.append((keys, offs, rng.normal(size=DENSE_DIM).astype(np.float32),
                    float(i % 2)))
    return out


def _slots(cls):
    return ([cls("label", "float", 1), cls("d", "float", DENSE_DIM)]
            + [cls(f"S{i}", "uint64") for i in range(S)])


DESC = DataFeedDesc(slots=_slots(SlotDef), label_slot="label",
                    batch_size=BS, key_bucket_min=512)
ARRS = _arrays()


def mk(seed=0):
    torch.manual_seed(seed)
    t = EmbeddingTable(mf_dim=MF, capacity=CAP,
                       cfg=SparseSGDConfig(**CFG), unique_bucket_min=512,
                       device="cpu")
    model = DeepFM(S, 3 + MF, DENSE_DIM, hidden=(16, 8),
                   compute_dtype=torch.float32)
    return Trainer(model, t, DESC,
                   tx=lambda p: torch.optim.Adam(p, lr=1e-2, eps=1e-8),
                   seed=3, device="cpu")



def mkds(arrs=ARRS):
    ds = InMemoryDataset(DESC)
    ds.records = [SlotRecord(k, o, d, l, 1.0, l) for k, o, d, l in arrs]
    return ds


def _rows_by_key(tr):
    tr.sync_table()
    keys, rows = tr.table.index.items()
    order = np.argsort(keys)
    return keys[order], tr.table.state.data.numpy()[rows[order]]


def _same_state(a, b):
    ka, ra = _rows_by_key(a)
    kb, rb = _rows_by_key(b)
    np.testing.assert_array_equal(ka, kb)
    np.testing.assert_array_equal(ra, rb)
    for (n, x), (_, y) in zip(a.model.state_dict().items(),
                              b.model.state_dict().items()):
        assert torch.equal(x, y), n


def _preempt(tr, cm, nth, ds=None):
    with installed(FaultPlan.parse(f"preempt.signal:fail:nth={nth}")):
        with pytest.raises(PreemptedError) as ei:
            tr.run_pass(ds or mkds(), checkpoint=cm)
    preemption.clear_stop()
    return ei.value


# ---------------------------------------------------------------------------
# CheckpointManager (tests/test_checkpoint.py)
# ---------------------------------------------------------------------------

def test_base_save_restore_roundtrip(tmp_path):
    tr = mk()
    tr.train_pass(mkds())
    cm = CheckpointManager(str(tmp_path / "ckpt"))
    path = cm.save(tr)
    assert os.path.isfile(os.path.join(path, DENSE))
    step = tr.global_step
    tr2 = mk(seed=1)                       # other init: restore overrides
    assert cm.restore(tr2) == step == tr2.global_step
    _same_state(tr, tr2)
    assert state_digest(tr2) == state_digest(tr)
    r = tr2.train_pass(mkds())
    assert np.isfinite(r["last_loss"])


def test_delta_chain_restore(tmp_path):
    tr = mk()
    cm = CheckpointManager(str(tmp_path / "ckpt"), keep=10)
    tr.train_pass(mkds())
    cm.save(tr)
    tr.train_pass(mkds(ARRS[:128]))
    cm.save(tr, delta=True)
    tr.train_pass(mkds(_arrays(96, seed=5)))
    cm.save(tr, delta=True)
    tr2 = mk(seed=1)
    assert cm.restore(tr2) == tr.global_step
    assert state_digest(tr2) == state_digest(tr)


def test_delta_without_base_raises(tmp_path):
    tr = mk()
    tr.train_pass(mkds(ARRS[:64]))
    with pytest.raises(ValueError):
        CheckpointManager(str(tmp_path / "ckpt")).save(tr, delta=True)


def test_retention_keeps_base_of_live_delta(tmp_path):
    tr = mk()
    cm = CheckpointManager(str(tmp_path / "ckpt"), keep=2)
    tr.train_pass(mkds(ARRS[:64]))
    cm.save(tr)
    base_step = tr.global_step
    for i in range(3):
        tr.train_pass(mkds(_arrays(64, seed=10 + i)))
        cm.save(tr, delta=True)
    assert base_step in cm.steps()
    tr2 = mk()
    assert cm.restore(tr2) == tr.global_step
    assert state_digest(tr2) == state_digest(tr)


def test_restore_empty_returns_none(tmp_path):
    cm = CheckpointManager(str(tmp_path / "ckpt"))
    assert cm.restore(mk()) is None
    assert cm.latest_step() is None


def test_chain_gap_detected(tmp_path):
    tr = mk()
    cm = CheckpointManager(str(tmp_path / "ckpt"), keep=10)
    ds = mkds(ARRS[:64])
    tr.train_pass(ds); cm.save(tr)
    tr.train_pass(ds); cm.save(tr, delta=True)
    mid = tr.global_step
    tr.train_pass(ds); cm.save(tr, delta=True)
    shutil.rmtree(cm._dir(mid))
    with pytest.raises(FileNotFoundError):
        cm.restore(mk())


def test_interrupted_resave_recovers(tmp_path):
    root = str(tmp_path / "ckpt")
    tr = mk()
    cm = CheckpointManager(root)
    tr.train_pass(mkds(ARRS[:64]))
    cm.save(tr)
    step = tr.global_step
    os.replace(cm._dir(step), cm._dir(step) + ".old-999")
    cm2 = CheckpointManager(root)           # init runs recovery
    assert cm2.latest_step() == step
    assert cm2.restore(mk()) == step


def test_delta_resave_same_step_no_loop(tmp_path):
    tr = mk()
    cm = CheckpointManager(str(tmp_path / "ckpt"), keep=10)
    ds = mkds(ARRS[:64])
    tr.train_pass(ds); cm.save(tr)
    tr.train_pass(ds)
    cm.save(tr, delta=True)
    cm.save(tr, delta=True)     # retry at the SAME step
    assert cm._meta(tr.global_step)["prev_step"] != tr.global_step
    assert cm.restore(mk()) == tr.global_step


def test_delta_includes_preloaded_pass_rows(tmp_path):
    """A save between a resident pass's build and its training keeps the
    pass's rows in the next delta."""
    tr = mk()
    cm = CheckpointManager(str(tmp_path / "ckpt"), keep=10)
    ds = mkds(ARRS[:128])
    rp1 = ResidentPass.build(ds, tr.table)
    rp2 = ResidentPass.build(ds, tr.table)
    tr.train_pass_resident(rp1)
    cm.save(tr)
    tr.train_pass_resident(rp2)
    cm.save(tr, delta=True)
    assert cm._meta(tr.global_step)["sparse_rows"] > 0


def test_retention_defers_leased_checkpoint(tmp_path):
    root = str(tmp_path / "ckpt")
    tr = mk()
    cm = CheckpointManager(root, keep=1)
    ds = mkds(ARRS[:64])
    tr.train_pass(ds)
    cm.save(tr)
    d1 = cm._dir(tr.global_step)
    lease = cm.lease(tr.global_step)
    try:
        tr.train_pass(ds)
        cm.save(tr)
        assert os.path.isdir(d1)
    finally:
        lease.release()
    tr.train_pass(ds)
    cm.save(tr)
    assert not os.path.isdir(d1)
    with pytest.raises(ArtifactLeaseLostError):
        lease.check()


def test_boundary_saves_publish_artifacts(tmp_path):
    root = str(tmp_path / "ckpt")
    store = ArtifactStore(str(tmp_path / "art"))
    tr = mk()
    cm = CheckpointManager(root, artifacts=store)
    ds = mkds(ARRS[:64])
    tr.train_pass(ds)
    cm.save(tr)
    assert len(store.versions()) == 1
    tr.train_pass(ds)
    cm.save(tr, delta=True, cursor={"pass_seq": 2, "batch_index": 1,
                                    "global_step": int(tr.global_step)})
    assert len(store.versions()) == 1       # mid-pass: no publish
    tr.train_pass(ds)
    cm.save(tr, delta=True)
    tr.train_pass(ds)
    cm.save(tr, delta=True,                 # stream boundary: publishes
            cursor={"global_step": int(tr.global_step),
                    "stream": {"window_files": [],
                               "files_completed": ["a", "b"],
                               "windows_completed": 2}})
    vs = store.versions()
    assert len(vs) == 3
    m0, m1, m2 = (store.read_manifest(v) for v in vs)
    assert m0["kind"] == "base" and m0["parent"] is None
    assert m1["kind"] == "delta" and m1["parent"] == vs[0]
    assert m2["parent"] == vs[1]
    assert m2["refs"]["cursor"]["files_completed"] == 2
    assert m0["meta"]["producer"] == "checkpoint"
    assert {"sparse.npz", DENSE, "meta.json"} <= set(m0["files"])


def test_artifact_publish_path_byte_identical(tmp_path):
    """Restoring through the checkpoint path, with or without a store
    attached, and adopting from the store alone give one digest."""
    ds = mkds(ARRS[:128])
    tr1 = mk()
    cm1 = CheckpointManager(str(tmp_path / "plain"))
    tr1.train_pass(ds); cm1.save(tr1)
    tr1.train_pass(ds); cm1.save(tr1, delta=True)
    r1 = mk()
    CheckpointManager(str(tmp_path / "plain")).restore(r1)
    d_pre = state_digest(r1)
    assert d_pre == state_digest(tr1)
    store = ArtifactStore(str(tmp_path / "art"))
    tr2 = mk()
    cm2 = CheckpointManager(str(tmp_path / "pub"), artifacts=store)
    tr2.train_pass(ds); cm2.save(tr2)
    tr2.train_pass(ds); cm2.save(tr2, delta=True)
    r2 = mk()
    CheckpointManager(str(tmp_path / "pub")).restore(r2)
    assert state_digest(r2) == d_pre
    r3 = mk()
    assert adopt_artifact(r3, store) == tr2.global_step
    assert state_digest(r3) == d_pre


def test_shared_store_roots_do_not_cross_link(tmp_path):
    store = ArtifactStore(str(tmp_path / "shared"))
    ds = mkds(ARRS[:64])
    tra, trb = mk(), mk()
    cma = CheckpointManager(str(tmp_path / "jobA"), artifacts=store)
    cmb = CheckpointManager(str(tmp_path / "jobB"), artifacts=store)
    tra.train_pass(ds); cma.save(tra)
    trb.train_pass(ds); cmb.save(trb)
    tra.train_pass(ds); cma.save(tra, delta=True)
    trb.train_pass(ds); cmb.save(trb, delta=True)
    roots = {}
    for aid in store.versions():
        m = store.read_manifest(aid)
        roots.setdefault(m["meta"]["root"], []).append(m)
    assert len(roots) == 2
    for chain in roots.values():
        base = [m for m in chain if m["kind"] == "base"]
        delta = [m for m in chain if m["kind"] == "delta"]
        assert len(base) == 1 and len(delta) == 1
        assert delta[0]["parent"] == base[0]["artifact"]


def test_restore_to_unpublished_step_backfills_chain(tmp_path):
    root = str(tmp_path / "ckpt")
    store = ArtifactStore(str(tmp_path / "art"))
    ds = mkds(ARRS[:64])
    tr = mk()
    cm = CheckpointManager(root, artifacts=store)
    tr.train_pass(ds)
    cm.save(tr)
    tr.train_pass(ds)
    mid = int(tr.global_step)
    cm.save(tr, delta=True, cursor={"pass_seq": 2, "batch_index": 1,
                                    "global_step": mid})
    assert len(store.versions()) == 1
    tr2 = mk()
    cm2 = CheckpointManager(root, artifacts=store)
    assert cm2.restore(tr2) == mid
    assert len(store.versions()) == 2
    back = store.read_manifest(store.versions()[-1])
    assert back["meta"]["step"] == mid
    assert back["parent"] == store.versions()[0]
    assert "cursor" in back["refs"] and back["adoptable"] is False
    with store.open() as h:
        assert h.aid == store.versions()[0]
    tr2.train_pass(ds)
    cm2.save(tr2, delta=True)
    vs = store.versions()
    assert len(vs) == 3 and store.read_manifest(vs[-1])["parent"] == vs[-2]
    r = mk()
    assert adopt_artifact(r, store) == tr2.global_step
    assert state_digest(r) == state_digest(tr2)


def test_meta_sidecar_detects_torn_meta(tmp_path):
    tr = mk()
    cm = CheckpointManager(str(tmp_path / "ckpt"))
    tr.train_pass(mkds(ARRS[:64]))
    path = cm.save(tr)
    assert os.path.isfile(os.path.join(path, "meta.sha256"))
    mp = os.path.join(path, "meta.json")
    meta = json.load(open(mp))
    assert DENSE in meta["checksums"]
    meta["sparse_rows"] = 0
    with open(mp, "w") as fh:
        json.dump(meta, fh)
    with pytest.raises(CheckpointCorruptError, match="meta.json"):
        cm.restore(mk())


def test_half_deleted_ckpt_dir_is_skipped(tmp_path):
    root = str(tmp_path / "ckpt")
    ds = mkds(ARRS[:64])
    tr = mk()
    cm = CheckpointManager(root, keep=10)
    tr.train_pass(ds)
    cm.save(tr)
    good = tr.global_step
    tr.train_pass(ds)
    cm.save(tr)
    os.unlink(os.path.join(cm._dir(tr.global_step), "meta.json"))
    cm2 = CheckpointManager(root, keep=10)
    assert cm2.steps() == [good]
    assert cm2.latest_step() == good
    tr2 = mk()
    assert cm2.restore(tr2) == good
    tr2.train_pass(ds)
    cm2.save(tr2)
    assert good in cm2.steps()


def test_latest_verified_step_skips_corrupt_chain(tmp_path):
    ds = mkds(ARRS[:64])
    tr = mk()
    cm = CheckpointManager(str(tmp_path / "ckpt"), keep=10)
    tr.train_pass(ds)
    cm.save(tr)
    good = tr.global_step
    tr.train_pass(ds)
    cm.save(tr)
    for name in ("sparse.npz", DENSE):
        target = os.path.join(cm._dir(tr.global_step), name)
        orig = open(target, "rb").read()
        blob = bytearray(orig)
        blob[len(blob) // 2] ^= 0xFF
        with open(target, "wb") as fh:
            fh.write(bytes(blob))
        assert cm.latest_verified_step() == good, name
        with open(target, "wb") as fh:
            fh.write(orig)
    assert cm.latest_verified_step() == tr.global_step


def test_trainer_save_load_roundtrip(tmp_path):
    tr = mk()
    tr.train_pass(mkds(ARRS[:128]))
    prefix = str(tmp_path / "model")
    tr.save(prefix)
    tr2 = mk(seed=1)
    tr2.load(prefix)
    _same_state(tr, tr2)
    for a, b in zip(tr.state.opt.state.values(),
                    tr2.state.opt.state.values()):
        assert torch.equal(a["exp_avg_sq"], b["exp_avg_sq"])


# ---------------------------------------------------------------------------
# preemption and recovery (tests/test_preemption.py)
# ---------------------------------------------------------------------------

def test_preempt_writes_emergency_ckpt_and_is_not_retried(tmp_path):
    root = str(tmp_path / "ckpt")
    ds = mkds()
    tr = mk()
    cm = CheckpointManager(root)
    calls = []
    real = tr.train_pass
    tr.train_pass = lambda *a, **kw: calls.append(1) or real(*a, **kw)
    with installed(FaultPlan.parse("preempt.signal:fail:nth=4")):
        with pytest.raises(PreemptedError) as ei:
            tr.run_pass(ds, checkpoint=cm, max_retries=5)
    assert len(calls) == 1                   # never retried
    assert ei.value.checkpointed and ei.value.batch_index == 4
    cur = cm.load_cursor()
    assert cur["batch_index"] == 4
    assert cur["global_step"] == tr.global_step == 4
    assert cur["fingerprint"] == ds.filelist_fingerprint()
    marker = preemption.read_resume_marker(root)
    assert marker and marker["exit_code"] == preemption.EXIT_RESUME


@pytest.mark.parametrize("every", [0, 3])
def test_resume_from_cursor_matches_uninterrupted_run(tmp_path, every):
    """Preempt at batch 5 → restart → resume from the cursor replays
    ONLY the remaining batches, and the state equals the uninterrupted
    run's bit for bit."""
    root = str(tmp_path / "ckpt")
    baseline = mk()
    total = int(baseline.train_pass(mkds())["batches"])
    want = state_digest(baseline)
    with flags_scope(ckpt_every_batches=every):
        tr = mk()
        e = _preempt(tr, CheckpointManager(root), 5)
        assert e.checkpointed and e.batch_index == 5
        tr2 = mk(seed=1)                    # a restarted process
        cm2 = CheckpointManager(root)
        assert cm2.restore(tr2) == 5
        out = tr2.run_pass(mkds(), checkpoint=cm2)
    assert int(out["batches"]) == total - 5
    assert tr2.global_step == baseline.global_step
    assert state_digest(tr2) == want
    assert preemption.read_resume_marker(root) is None   # consumed
    assert cm2.load_cursor() is None         # newest is a pass boundary


def test_periodic_inpass_ckpt_bounds_replay_after_crash(tmp_path):
    root = str(tmp_path / "ckpt")
    baseline = mk()
    total = int(baseline.train_pass(mkds())["batches"])
    want = state_digest(baseline)
    with flags_scope(ckpt_every_batches=2):
        tr = mk()
        _preempt(tr, CheckpointManager(root), 7)
        tr2 = mk()
        cm2 = CheckpointManager(root)
        periodic = cm2.steps()[-2]           # the save before the kill
        assert cm2.restore(tr2, step=periodic) == periodic
        cur = cm2.load_cursor(periodic)
        assert cur["batch_index"] == periodic
        out = tr2.train_pass(mkds(), start_cursor=cur)
    assert int(out["batches"]) == total - cur["batch_index"]
    assert state_digest(tr2) == want


def test_run_pass_retry_resumes_from_cursor(tmp_path):
    root = str(tmp_path / "ckpt")
    baseline = mk()
    total = int(baseline.train_pass(mkds())["batches"])
    want = state_digest(baseline)
    with flags_scope(ckpt_every_batches=3):
        _preempt(mk(), CheckpointManager(root), 6)
        tr2 = mk()
        cm2 = CheckpointManager(root)
        assert cm2.restore(tr2) == 6
        with installed(FaultPlan.parse("trainer.pass:fail:nth=1")):
            out = tr2.run_pass(mkds(), checkpoint=cm2, max_retries=1)
    assert int(out["batches"]) == total - 6
    assert state_digest(tr2) == want


def test_cursor_mismatch_rolls_back_to_pass_boundary(tmp_path):
    root = str(tmp_path / "ckpt")
    ds = mkds()
    tr = mk()
    cm = CheckpointManager(root, keep=10)
    tr.run_pass(ds, checkpoint=cm)
    cm.save(tr)
    boundary = tr.global_step
    _preempt(tr, cm, 3)
    tr2 = mk()
    cm2 = CheckpointManager(root, keep=10)
    assert cm2.restore(tr2) == boundary + 3
    other = mkds(ARRS[:160])
    other.filelist = ["part-000"]            # another file list
    out = tr2.run_pass(other, checkpoint=cm2)
    assert int(out["batches"]) == 5
    assert tr2.global_step == boundary + 5


def test_nondeterministic_restart_rolls_back_not_splices(tmp_path):
    root = str(tmp_path / "ckpt")
    tr = mk()
    _preempt(tr, CheckpointManager(root, keep=10), 3)
    tr2 = mk()
    cm2 = CheckpointManager(root, keep=10)
    assert cm2.restore(tr2) == 3
    nd = mkds()
    nd.supports_cursor_resume = False
    with pytest.raises(RuntimeError, match="cannot be resumed"):
        tr2.run_pass(nd, checkpoint=cm2)
    tr3 = mk()
    cm3 = CheckpointManager(root + "_b", keep=10)
    tr3.run_pass(mkds(), checkpoint=cm3)
    cm3.save(tr3)
    _preempt(tr3, cm3, 3)
    tr4 = mk()
    cm4 = CheckpointManager(root + "_b", keep=10)
    assert cm4.restore(tr4) == 13
    out = tr4.run_pass(nd, checkpoint=cm4)
    assert tr4.global_step == 10 + int(out["batches"])


def test_stop_honored_between_passes_and_for_resident(tmp_path):
    root = str(tmp_path / "ckpt")
    ds = mkds()
    tr = mk()
    cm = CheckpointManager(root)
    tr.run_pass(ds, checkpoint=cm)
    step = tr.global_step
    preemption.request_stop("scheduler notice")
    with pytest.raises(PreemptedError) as ei:
        tr.run_pass(ds, checkpoint=cm, resident=True)
    assert ei.value.checkpointed and ei.value.step == step
    assert cm.latest_step() == step
    assert cm.load_cursor() is None
    assert preemption.read_resume_marker(root) is not None


def test_resident_restart_on_cursor_rolls_back_to_boundary(tmp_path):
    root = str(tmp_path / "ckpt")
    ds = mkds()
    tr = mk()
    cm = CheckpointManager(root, keep=10)
    tr.run_pass(ds, checkpoint=cm)
    cm.save(tr)
    boundary = tr.global_step
    _preempt(tr, cm, 3)
    tr2 = mk()
    cm2 = CheckpointManager(root, keep=10)
    assert cm2.restore(tr2) == boundary + 3
    out = tr2.run_pass(ds, checkpoint=cm2, resident=True)
    assert tr2.global_step == boundary + int(out["batches"])
    tr3 = mk()
    _preempt(tr3, CheckpointManager(root + "_nb"), 3)
    tr4 = mk()
    cm4 = CheckpointManager(root + "_nb")
    cm4.restore(tr4)
    with pytest.raises(RuntimeError, match="resident"):
        tr4.run_pass(ds, checkpoint=cm4, resident=True)


def test_preempt_on_periodic_save_boundary_reuses_checkpoint(tmp_path):
    root = str(tmp_path / "ckpt")
    with flags_scope(ckpt_every_batches=4):
        tr = mk()
        cm = CheckpointManager(root)
        e = _preempt(tr, cm, 4)
    assert e.checkpointed and e.batch_index == 4
    assert cm.steps() == [4]
    tr2 = mk()
    cm2 = CheckpointManager(root)
    assert cm2.restore(tr2) == 4
    assert int(tr2.run_pass(mkds(), checkpoint=cm2)["batches"]) == 6


def test_boundary_save_when_cadence_hits_pass_length(tmp_path):
    root = str(tmp_path / "ckpt")
    with flags_scope(ckpt_every_batches=5):
        tr = mk()
        cm = CheckpointManager(root)
        out = tr.run_pass(mkds(), checkpoint=cm)
    assert int(out["batches"]) == 10
    assert cm.load_cursor() is None
    assert cm.restore(mk()) == 10


def test_preempt_at_final_batch_resumes_to_clean_boundary(tmp_path):
    root = str(tmp_path / "ckpt")
    baseline = mk()
    nth = int(baseline.train_pass(mkds())["batches"])
    want = state_digest(baseline)
    e = _preempt(mk(), CheckpointManager(root), nth)
    assert e.batch_index == nth
    tr2 = mk()
    cm2 = CheckpointManager(root)
    cm2.restore(tr2)
    assert int(tr2.run_pass(mkds(), checkpoint=cm2)["batches"]) == 0
    assert state_digest(tr2) == want
    assert cm2.load_cursor() is None
    with installed(FaultPlan.parse("trainer.pass:fail:nth=1")):
        out = tr2.run_pass(mkds(), checkpoint=cm2, max_retries=1)
    assert int(out["batches"]) == nth


def test_nan_rollback_needs_a_boundary(tmp_path):
    root = str(tmp_path / "ckpt")
    ds = mkds(ARRS[:64])

    def poison(tr, times):
        calls, real = [], tr.train_pass

        def run(*a, **kw):
            calls.append(1)
            if len(calls) <= times:
                raise NanInfError("nan/inf loss")
            return real(*a, **kw)
        tr.train_pass = run
        return calls

    tr = mk()
    calls = poison(tr, 10)
    with pytest.raises(NanInfError):
        tr.run_pass(ds, max_retries=3)
    assert len(calls) == 1                  # no rollback target
    tr_e = mk()
    calls = poison(tr_e, 10)
    with pytest.raises(NanInfError):
        tr_e.run_pass(ds, checkpoint=CheckpointManager(root + "_e"),
                      max_retries=3)
    assert len(calls) == 1                  # an empty manager is none
    tr2 = mk()
    cm = CheckpointManager(root)
    tr2.run_pass(ds)
    cm.save(tr2)
    step = tr2.global_step
    calls = poison(tr2, 1)
    out = tr2.run_pass(ds, checkpoint=cm, max_retries=1)
    assert len(calls) == 2 and np.isfinite(out["last_loss"])
    assert tr2.global_step == step + 2


def test_delta_after_rollback_links_to_restored_step(tmp_path):
    root = str(tmp_path / "ckpt")
    tr = mk()
    cm = CheckpointManager(root, keep=10)
    tr.run_pass(mkds(), checkpoint=cm)
    cm.save(tr)                               # boundary base @ 10
    _preempt(tr, cm, 3)                       # cursor delta @ 13
    tr2 = mk()
    cm2 = CheckpointManager(root, keep=10)
    assert cm2.restore(tr2) == 13
    short = mkds(ARRS[:64])
    short.filelist = ["short"]
    out = tr2.run_pass(short, checkpoint=cm2)  # rolls back to 10
    assert tr2.global_step == 12 and int(out["batches"]) == 2
    cm2.save(tr2, delta=True)
    assert cm2._meta(12)["prev_step"] == 10
    assert cm2.restore(mk(), step=12) == 12


def test_metric_registry_rides_the_cursor(tmp_path):
    """A registered metric is fed every batch, snapshotted into the
    mid-pass checkpoint and restored with the cursor, so the resumed
    pass's tables equal the uninterrupted ones."""
    root = str(tmp_path / "ckpt")
    baseline = mk()
    baseline.metrics.init_metric("ctr", "auc", nbins=4096)
    baseline.metrics.init_metric("nan", "nan_inf")
    baseline.train_pass(mkds())
    tr = mk()
    tr.metrics.init_metric("ctr", "auc", nbins=4096)
    tr.metrics.init_metric("nan", "nan_inf")
    _preempt(tr, CheckpointManager(root), 5)
    assert os.path.isfile(os.path.join(root, "ckpt-000000000005",
                                       "metrics.pkl"))
    tr2 = mk()
    cm2 = CheckpointManager(root)
    cm2.restore(tr2)
    tr2.run_pass(mkds(), checkpoint=cm2)
    assert (tr2.metrics.get_metric_msg("ctr")
            == baseline.metrics.get_metric_msg("ctr"))
    assert tr2.metrics.get_metric_msg("nan")["ins_num"] == N


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------

JDESC = JDesc(slots=_slots(JSlotDef), label_slot="label", batch_size=BS,
              key_bucket_min=512)


def _jmk():
    jt = JTable(mf_dim=MF, capacity=CAP, cfg=JCfg(**CFG),
                unique_bucket_min=512)
    return JTrainer(JDeepFM(hidden=(16, 8), compute_dtype=jnp.float32), jt,
                    JDESC, tx=optax.adam(1e-2), seed=3)


def _jds(arrs=ARRS):
    ds = JDataset(JDESC)
    ds.records = [JRecord(k, o, d, l, 1.0, l) for k, o, d, l in arrs]
    return ds


def _port_like(jtr):
    """A port trainer holding ``jtr``'s initial params."""
    tr = mk()
    tr.model.load_state_dict(convert.deepfm_state_dict_from_flax(
        jax.device_get(jtr.state.params)))
    return tr


def _logical(table):
    keys, rows = table.index.items()
    order = np.argsort(keys)
    return keys[order], table._gather_host(rows[order])


def _auc_close(out, jout):
    assert out["ins_num"] == jout["ins_num"]
    np.testing.assert_allclose(out["actual_ctr"], jout["actual_ctr"],
                               rtol=1e-6)
    np.testing.assert_allclose(out["auc"], jout["auc"], rtol=0, atol=1e-4)


def _assert_close_to_jax(tr, jtr):
    jtr.sync_table()
    jk, jblob = _logical(jtr.table)
    tk, tblob = _logical(tr.table)
    np.testing.assert_array_equal(tk, jk)
    for f in sorted(jblob):
        np.testing.assert_allclose(tblob[f], jblob[f], rtol=STATE_RTOL,
                                   atol=STATE_ATOL, err_msg=f)
    want = convert.deepfm_state_dict_from_flax(
        jax.device_get(jtr.state.params))
    sd = tr.model.state_dict()
    for name, w in want.items():
        np.testing.assert_allclose(sd[name].numpy(), w.numpy(),
                                   rtol=STATE_RTOL, atol=STATE_ATOL,
                                   err_msg=name)


@pytest.mark.parametrize("flags", sorted(JAX_FLAGS))
def test_preempt_resume_matches_jax_trainer(tmp_path, flags):
    """Both packages preempted at batch 5 (cursor checkpoints every 3
    batches) and resumed in a fresh trainer: the port's state holds the
    JAX run's."""
    with j_flags_scope(ckpt_every_batches=3, **JAX_FLAGS[flags]):
        jtr = _jmk()
        tr = _port_like(jtr)
        jroot = str(tmp_path / "jax")
        with jfaults.installed(
                jfaults.FaultPlan.parse("preempt.signal:fail:nth=5")):
            with pytest.raises(jpreemption.PreemptedError):
                jtr.run_pass(_jds(), checkpoint=JCM(jroot))
        jpreemption.clear_stop()
        jtr2 = _jmk()
        jcm2 = JCM(jroot)
        assert jcm2.restore(jtr2) == 5
        jout = jtr2.run_pass(_jds(), checkpoint=jcm2)
    with flags_scope(ckpt_every_batches=3):
        troot = str(tmp_path / "port")
        _preempt(tr, CheckpointManager(troot), 5)
        tr2 = mk(seed=1)
        cm2 = CheckpointManager(troot)
        assert cm2.restore(tr2) == 5
        out = tr2.run_pass(mkds(), checkpoint=cm2)
    assert int(out["batches"]) == int(jout["batches"]) == 5
    assert tr2.global_step == jtr2.global_step
    _assert_close_to_jax(tr2, jtr2)
    _auc_close(out, jout)


def test_jax_checkpoint_restores_into_port(tmp_path):
    """A JAX checkpoint (base + delta chain, dense.pkl) restores into the
    port: the sparse files load as they are, the dense part goes through
    ``convert.dense_from_jax_checkpoint``; two more batches then match
    the JAX continuation."""
    jroot = str(tmp_path / "jax")
    jtr = _jmk()
    jcm = JCM(jroot)
    jtr.train_pass(_jds(ARRS[:192]))
    jcm.save(jtr)
    jtr.train_pass(_jds(ARRS[192:]))
    path = jcm.save(jtr, delta=True)
    step = jtr.global_step
    with open(os.path.join(path, "dense.pkl"), "rb") as fh:
        blob = pickle.load(fh)
    # the port's own manager reads the JAX chain once dense.pt is beside
    # each link (the sparse files are shared)
    tr = mk(seed=1)
    dense = convert.dense_from_jax_checkpoint(blob, tr.model, tr.state.opt)
    troot = str(tmp_path / "port")
    shutil.copytree(jroot, troot)
    for s in JCM(troot).steps():
        torch.save(dense, os.path.join(troot, f"ckpt-{s:012d}", DENSE))
        mpath = os.path.join(troot, f"ckpt-{s:012d}", "meta.json")
        meta = json.load(open(mpath))
        meta["checksums"].pop("dense.pkl")
        with open(mpath, "w") as fh:
            json.dump(meta, fh)
        os.unlink(os.path.join(troot, f"ckpt-{s:012d}", "meta.sha256"))
    assert CheckpointManager(troot).restore(tr) == step
    _assert_close_to_jax(tr, jtr)
    jauc = jax.device_get(jtr.state.auc)
    np.testing.assert_array_equal(tr.state.auc.buckets.numpy(),
                                  np.stack([jauc.pos, jauc.neg]))
    for t, j in zip(tr.state.opt.state.values(),
                    convert.dense_from_jax_checkpoint(
                        blob, tr.model, tr.state.opt)["opt"]["state"]
                    .values()):
        assert torch.equal(t["exp_avg"], j["exp_avg"])
    more = ARRS[:2 * BS]
    jout = jtr.train_pass(_jds(more))
    out = tr.train_pass(mkds(more))
    assert tr.global_step == jtr.global_step == step + 2
    _assert_close_to_jax(tr, jtr)
    _auc_close(out, jout)


def test_graceful_shutdown_flag_turns_sigterm_into_a_stop(tmp_path):
    """With ``FLAGS.graceful_shutdown`` the trainer installs the handler;
    a real SIGTERM then stops the pass at the next batch boundary with an
    emergency checkpoint, and ``FLAGS.pass_retry_limit`` does not retry
    it."""
    import signal
    with flags_scope(graceful_shutdown=True, pass_retry_limit=3):
        tr = mk()
        try:
            assert signal.getsignal(signal.SIGTERM) is preemption._handler
            real = tr.step_fn

            def step(state, dev, gen):
                out = real(state, dev, gen)
                if tr.global_step == 2:
                    os.kill(os.getpid(), signal.SIGTERM)
                return out
            tr.step_fn = step
            cm = CheckpointManager(str(tmp_path / "ckpt"))
            with pytest.raises(PreemptedError) as ei:
                tr.run_pass(mkds(), checkpoint=cm)
        finally:
            preemption.uninstall_signal_handlers()
    assert ei.value.batch_index == 2 and ei.value.checkpointed
    assert preemption.stop_reason() == "signal:SIGTERM"
    assert cm.load_cursor()["batch_index"] == 2


def test_pass_retry_limit_flag_bounds_retries(tmp_path):
    tr = mk()
    cm = CheckpointManager(str(tmp_path / "ckpt"))
    plan = FaultPlan.parse("trainer.pass:fail:nth=1,times=2")
    with flags_scope(pass_retry_limit=1), installed(plan):
        with pytest.raises(Exception, match="injected"):
            tr.run_pass(mkds(ARRS[:64]), checkpoint=cm)
    with flags_scope(pass_retry_limit=2), installed(
            FaultPlan.parse("trainer.pass:fail:nth=1,times=2")):
        out = tr.run_pass(mkds(ARRS[:64]), checkpoint=cm)
    assert out["batches"] == 2
