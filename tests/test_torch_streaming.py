"""Streaming ingest on the port (``QueueDataset``'s windowed stream and
``Trainer.train_stream``) on the CPU: the counterparts of the dataset and
trainer cases of ``tests/test_streaming.py`` — window flush, the
refusals, the cursor following consumption, cursor adoption, sticky
quarantine, the per-load poison budget, reader cleanup after an abandoned
stream, a reader error surfacing within one batch, a shared quarantine
preseeding the stream; ``train_stream``'s arrivals, seeded idle backoff
and boundary checkpoints, continuing across calls, history compaction,
folded resume and the loud mismatch, the window fault retried and
replayed, and a real SIGTERM resuming at least once. Dataset cases run
the same scenario through both packages and compare.

Left out: the three fence and hang-deadline cases of
``tests/test_streaming.py`` (``test_epilogue_fence_hang_deadline``,
``test_preloader_wait_hang_deadline``,
``test_fence_slow_but_moving_pipeline_does_not_trip``). They need
``PassEpilogue`` (ROADMAP queue 1 item 10) and the hub fixture
``fresh_hub`` (item 13), which the port does not have yet.

Then the stream scenario at a small size (4 slots, batch 64, 8 files of
one batch, windows of 2, one CPU thread), held three ways:

- the port's ``train_stream`` equals its own ``train_pass`` over the
  same batches bit for bit (``state_digest``);
- the port's state at every window boundary against the JAX
  ``Trainer.train_stream``'s, in both JAX flag settings, within the
  ragged train-state class (rtol 2e-4 / atol 2e-5);
- a stream preempted at batch 5 and resumed by new objects replays
  exactly the open window and equals the oracle at the last common
  boundary; and a cursor the JAX ``train_stream`` wrote (folded history
  and an open window) is adopted by the port, whose resume matches the
  JAX resume.

Last, the Criteo walkthrough (``paddlebox_tpu_torch.examples.
train_criteo``) at ``--rows 2000 --batch-size 128 --device cpu``.
"""

import collections
import json
import os
import pickle
import shutil
import signal
import subprocess
import sys
import textwrap
import threading
import time

import numpy as np
import optax
import pytest

import jax
import jax.numpy as jnp
import torch

from paddlebox_tpu.config import flags_scope as j_flags_scope
from paddlebox_tpu.data import DataFeedDesc as JDesc
from paddlebox_tpu.data import DatasetFactory as JFactory
from paddlebox_tpu.data import SlotDef as JSlotDef
from paddlebox_tpu.data.criteo import generate_criteo_files
from paddlebox_tpu.models import DeepFM as JDeepFM
from paddlebox_tpu.ps import EmbeddingTable as JTable
from paddlebox_tpu.ps import SparseSGDConfig as JCfg
from paddlebox_tpu.resilience import faults as jfaults
from paddlebox_tpu.resilience import preemption as jpreemption
from paddlebox_tpu.resilience.consensus import (DirConsensusStore,
                                                RestoreConsensus,
                                                sync_shared_quarantine)
from paddlebox_tpu.resilience.retry import RetryPolicy as JRetryPolicy
from paddlebox_tpu.train import Trainer as JTrainer
from paddlebox_tpu.train.checkpoint import CheckpointManager as JCM

from paddlebox_tpu_torch import DeepFM, EmbeddingTable, Trainer, convert
from paddlebox_tpu_torch.config import FLAGS, flags_scope
from paddlebox_tpu_torch.data import (DataFeedDesc, DatasetFactory,
                                      InMemoryDataset, SlotDef)
from paddlebox_tpu_torch.data.dataset import chain_digest
from paddlebox_tpu_torch.data.parser import SlotTextParser
from paddlebox_tpu_torch.ps.sgd import SparseSGDConfig
from paddlebox_tpu_torch.resilience import preemption
from paddlebox_tpu_torch.resilience.faults import FaultPlan, installed
from paddlebox_tpu_torch.resilience.preemption import PreemptedError
from paddlebox_tpu_torch.resilience.retry import RetryPolicy
from paddlebox_tpu_torch.train.checkpoint import (DENSE, CheckpointManager,
                                                  state_digest)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_FLAGS = {"xla": {}, "pallas": {"use_pallas_gather": True,
                                   "use_pallas_seqpool": True}}
STATE_RTOL, STATE_ATOL = 2e-4, 2e-5
CFG = dict(mf_create_thresholds=0.0, mf_initial_range=0.0,
           learning_rate=0.05, mf_learning_rate=0.05)
BAD = "garbage\tnot\ta\trecord\n" * 10


@pytest.fixture(autouse=True)
def one_thread_and_clean_stop():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    preemption.clear_stop()
    jpreemption.clear_stop()
    yield
    preemption.clear_stop()
    jpreemption.clear_stop()
    preemption.uninstall_signal_handlers()
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# the two packages side by side
# ---------------------------------------------------------------------------

PORT = {"flags": flags_scope, "factory": DatasetFactory, "desc": DataFeedDesc}
JAX = {"flags": j_flags_scope, "factory": JFactory, "desc": JDesc}


def _files(tmp_path, n=4, rows=48, seed=11):
    return generate_criteo_files(str(tmp_path / "data"), num_files=n,
                                 rows_per_file=rows, vocab_per_slot=40,
                                 seed=seed)


def _qds(files, bs=16, pkg=PORT):
    desc = pkg["desc"].criteo(batch_size=bs)
    desc.key_bucket_min = 2048
    ds = pkg["factory"]().create_dataset("QueueDataset", desc)
    ds.set_filelist(files)
    return ds


def _reader_threads():
    return [t for t in threading.enumerate()
            if t.name.startswith("pbox-reader") and t.is_alive()]


def _consume(ds):
    """Drain a windowed stream the way the trainer does: report each
    batch consumed so windows fold (raw drains fold nothing)."""
    sizes = []
    for b in ds.batches():
        sizes.append(int((b.show > 0).sum()))
        ds.note_batches_consumed(len(sizes))
    ds.note_batches_consumed(len(sizes))  # tail-window fold
    return sizes


def _both(scenario, **flags):
    """Run ``scenario(pkg)`` under ``flags`` in each package; returns
    (port result, JAX result)."""
    out = []
    for pkg in (PORT, JAX):
        with pkg["flags"](**flags):
            out.append(scenario(pkg))
    return out


# ---------------------------------------------------------------------------
# windowed batches, cursors, quarantine (dataset cases)
# ---------------------------------------------------------------------------

def test_windowed_batches_flush_at_window_boundary(tmp_path):
    files = _files(tmp_path, n=3, rows=40)  # 40 rows, bs 16 -> 2.5

    def run(pkg):
        ds = _qds(files, pkg=pkg)
        assert ds.supports_cursor_resume and ds.windowed
        sizes = _consume(ds)
        return (sizes, ds.files_completed, ds.windows_completed,
                ds.pending_files())

    port, jax_ = _both(run, stream_window_files=2, read_thread_num=1)
    # window 1 = 80 records (16x5), window 2 = 40 (16,16,8): the tail
    # batch flushes SHORT at the window boundary — no record crosses it
    assert port == jax_ == ([16, 16, 16, 16, 16, 16, 16, 8], files, 2, [])


def test_unwindowed_refusal_and_windowed_start_batch_refusal(tmp_path):
    files = _files(tmp_path, n=2)
    ds = _qds(files)
    assert not ds.supports_cursor_resume
    with pytest.raises(ValueError, match="deterministic"):
        next(ds.batches(start_batch=1))
    with flags_scope(stream_window_files=2):
        assert ds.supports_cursor_resume
        with pytest.raises(ValueError, match="FILE WINDOW"):
            next(ds.batches(start_batch=1))


def test_stream_cursor_tracks_consumption_not_readahead(tmp_path):
    """A window only counts completed once the CONSUMER reports its
    final batch trained — read-ahead must never complete a half-trained
    window. The cursor blocks equal the reference's, key for key."""
    files = _files(tmp_path, n=4, rows=32)  # 2 batches/file

    def run(pkg):
        ds = _qds(files, pkg=pkg)
        it = ds.batches()
        for _ in range(5):  # pull 5 of 8: one past window 1's last
            next(it)
        s3, s4 = ds.stream_cursor_state(3), ds.stream_cursor_state(4)
        it.close()
        return s3, s4, ds.stream_cursor_state(None)

    port, jax_ = _both(run, stream_window_files=2, read_thread_num=1)
    assert port == jax_
    s3, s4, between = port
    assert s3["files_completed"] == [] and s3["window_files"] == files[:2]
    assert s4["files_completed"] == files[:2]
    assert s4["window_files"] == files[2:4]
    assert s4["windows_completed"] == 1
    # the abandoned pass folded nothing: both windows replay
    assert between["files_completed"] == []
    assert not _reader_threads()


def test_adopt_stream_cursor_skips_completed_replays_window(tmp_path):
    files = _files(tmp_path, n=6, rows=32)

    def run(pkg):
        ds = _qds(files, pkg=pkg)
        ds.adopt_stream_cursor(
            {"windowed": True, "files_completed": files[:2],
             "window_files": files[2:4], "windows_completed": 1},
            quarantined=[files[4]])
        pending = ds.pending_files()
        why = dict(ds.quarantined_files)[files[4]]
        sizes = _consume(ds)
        return pending, why, sizes, ds.files_replayed, ds.files_completed

    port, jax_ = _both(run, stream_window_files=2, read_thread_num=1)
    assert port == jax_
    pending, why, sizes, replayed, completed = port
    # completed skipped, quarantine preseeded (budget-free), open window
    # + the rest pending
    assert pending == files[2:4] + [files[5]]
    assert why.startswith("preseeded")
    # replayed window (2 files x 2 batches) + the last file solo
    assert len(sizes) == 6 and replayed == 2
    assert completed == files[:4] + [files[5]]


def test_windowed_quarantine_is_cross_window_sticky(tmp_path):
    """A file quarantined in window k stays quarantined for the rest of
    the stream, is excluded from files_completed, and the preseeded skip
    set never consumes the poison budget."""
    files = _files(tmp_path, n=4, rows=32)
    bad = files[1]
    with open(bad, "w") as fh:
        fh.write(BAD)

    def run(pkg):
        ds = _qds(files, pkg=pkg)
        ds.preseed_quarantine(["/elsewhere/preseeded.txt"])
        sizes = _consume(ds)
        return sizes, [p for p, _ in ds.quarantined_files], \
            ds.files_completed

    port, jax_ = _both(run, stream_window_files=2, read_thread_num=1,
                       poison_budget_files=1, poison_budget_records=0)
    assert port == jax_
    sizes, quar, completed = port
    assert len(sizes) == 6  # 3 healthy files x 2 batches each
    assert bad in quar and "/elsewhere/preseeded.txt" in quar
    assert completed == [files[0], files[2], files[3]]


def test_windowed_poison_budget_resets_per_load(tmp_path):
    """FLAGS.poison_budget_files is per LOAD: a bad file quarantined in
    an earlier windowed pass does not consume the budget of a later
    pass, while the decisions stay sticky."""
    files = _files(tmp_path, n=3, rows=32)
    with open(files[0], "w") as fh:
        fh.write(BAD)
    late = str(tmp_path / "data" / "late_bad.txt")
    with open(late, "w") as fh:
        fh.write(BAD)

    def run(pkg):
        ds = _qds(files, pkg=pkg)
        _consume(ds)
        first = [p for p, _ in ds.quarantined_files]
        ds.set_filelist(ds.files_completed + first + [late])
        _consume(ds)
        return first, [p for p, _ in ds.quarantined_files]

    port, jax_ = _both(run, stream_window_files=1, read_thread_num=1,
                       poison_budget_files=1, poison_budget_records=0)
    assert port == jax_ == ([files[0]], [files[0], late])


def test_poison_budget_spent_names_the_condition(tmp_path):
    """Two bad files against a budget of one: the second raises
    ``PoisonBudgetExceeded`` naming the budget, in both packages."""
    from paddlebox_tpu_torch.data.dataset import PoisonBudgetExceeded
    files = _files(tmp_path, n=3, rows=32)
    for f in files[:2]:
        with open(f, "w") as fh:
            fh.write(BAD)
    with flags_scope(read_thread_num=1, poison_budget_files=1,
                     poison_budget_records=0):
        with pytest.raises(PoisonBudgetExceeded, match="budget exhausted"):
            list(_qds(files).batches())


# ---------------------------------------------------------------------------
# reader lifecycle
# ---------------------------------------------------------------------------

def test_abandoned_stream_leaves_no_reader_threads(tmp_path):
    files = _files(tmp_path, n=3, rows=200)
    for window in (0, 2):  # unwindowed and windowed paths both clean up
        with flags_scope(stream_window_files=window, read_thread_num=3,
                         channel_capacity=8):
            ds = _qds(files)
            it = ds.batches()
            next(it)
            assert _reader_threads(), "readers should be running"
            it.close()  # consumer abandons the generator
            deadline = time.monotonic() + 5
            while _reader_threads() and time.monotonic() < deadline:
                time.sleep(0.01)
            assert not _reader_threads(), \
                f"reader threads survived abandonment (window={window})"


def test_reader_error_surfaces_within_one_batch(tmp_path):
    """A reader that dies on file 1 raises within a batch of the
    failure — not after the surviving readers drained the list."""
    files = _files(tmp_path, n=4, rows=120)  # ~30 batches total
    plan = FaultPlan.parse(
        f"reader.file:fail:nth=1,match=*{os.path.basename(files[0])}*")
    with flags_scope(read_thread_num=2), installed(plan):
        ds = _qds(files)
        n = 0
        with pytest.raises(Exception, match="injected fault"):
            for _ in ds.batches():
                n += 1
        assert n <= 5, f"error surfaced only after {n} batches"
    assert not _reader_threads()


def test_shared_quarantine_preseeds_windowed_stream(tmp_path):
    """A quarantine list shared across ranks (the JAX package's
    consensus ``sync_shared_quarantine``) preseeds the port's stream:
    the port's future windows drop the same files as the JAX ranks'."""
    files = _files(tmp_path, n=4)
    store = DirConsensusStore(str(tmp_path / "consensus"))
    with j_flags_scope(stream_window_files=2):
        j0, j1 = _qds(files, pkg=JAX), _qds(files, pkg=JAX)
        j0.quarantined_files.append((files[1], "IOError: local"))
        out = [None, None]

        def rank(i, ds):
            out[i] = sync_shared_quarantine(
                ds, RestoreConsensus(store, i, 2, timeout=20))

        ths = [threading.Thread(target=rank, args=(i, d))
               for i, d in enumerate([j0, j1])]
        for t in ths:
            t.start()
        for t in ths:
            t.join()
        want = j1.pending_files()
    assert out[0] == out[1] == [files[1]]
    with flags_scope(stream_window_files=2, read_thread_num=1):
        ds = _qds(files)
        ds.preseed_quarantine(out[0])
        assert ds.pending_files() == want
        assert files[1] not in want
        # preseeded decisions consume no budget and ride the cursor
        assert ds._quarantine_preseeded == 1
        assert len(_consume(ds)) == 9  # 3 healthy files x 3 batches
        assert files[1] not in ds.files_completed


# ---------------------------------------------------------------------------
# train_stream (trainer cases), narrow criteo DeepFM
# ---------------------------------------------------------------------------

def _desc():
    desc = DataFeedDesc.criteo(batch_size=16)
    desc.key_bucket_min = 2048
    return desc


def _mk_trainer(desc=None, seed=0):
    desc = desc or _desc()
    torch.manual_seed(seed)
    table = EmbeddingTable(mf_dim=4, capacity=1 << 12,
                           cfg=SparseSGDConfig(**CFG),
                           unique_bucket_min=2048, device="cpu")
    model = DeepFM(len(desc.sparse_slots), 3 + 4, desc.dense_dim,
                   hidden=(8,), compute_dtype=torch.float32)
    return Trainer(model, table, desc,
                   tx=lambda p: torch.optim.Adam(p, lr=1e-2), seed=seed,
                   device="cpu")


def test_train_stream_arrivals_idle_and_boundary_ckpt(tmp_path,
                                                      monkeypatch):
    files = _files(tmp_path, n=4, rows=32)
    root = str(tmp_path / "ckpt")
    polls = {"n": 0}
    slept = []

    def filelist_fn():
        polls["n"] += 1
        # files arrive two at a time, with an empty poll in between
        return files[:2] if polls["n"] < 3 else files

    monkeypatch.setattr(Trainer, "_stream_sleep",
                        staticmethod(lambda sec: slept.append(sec)))
    flags = dict(stream_window_files=2, read_thread_num=1,
                 stream_ckpt_every_windows=1, retry_base_delay_sec=0.01,
                 retry_max_delay_sec=0.02, seed=7)
    with flags_scope(**flags):
        tr = _mk_trainer()
        ds = _qds(files[:2])
        cm = CheckpointManager(root)
        out = tr.train_stream(ds, cm, filelist_fn=filelist_fn,
                              max_idle_polls=3)
        want = list(RetryPolicy.from_flags(
            site="stream.poll", max_attempts=1 << 20).delays())
    assert out["windows"] == 2 and out["files"] == 4
    # one idle poll between the arrivals, then three before the fourth
    # breaks the loop; the backoff restarts after an arrival
    assert out["idle_polls"] == 5 and len(slept) == 4
    # the idle backoff is the seeded schedule, and the reference's for
    # the same FLAGS.seed
    with j_flags_scope(**flags):
        jwant = list(JRetryPolicy.from_flags(
            site="stream.poll", max_attempts=1 << 20).delays())
    assert slept == want[:1] + want[:3]
    assert want[:3] == jwant[:3]
    assert ds.files_completed == files
    # the newest checkpoint is a STREAM BOUNDARY: completed files
    # recorded (older history compacted to count+fingerprint after each
    # boundary publish), open window empty — a rollback target
    cur = cm.load_cursor()
    assert cur["version"] == 2
    st = cur["stream"]
    assert st["files_completed"] == files[2:]
    assert st["files_folded"] == {"count": 2,
                                  "sha256": chain_digest("", files[:2])}
    assert st["window_files"] == []
    assert cm.latest_boundary_step() == cm.latest_step()


def test_train_stream_needs_a_windowed_dataset(tmp_path):
    files = _files(tmp_path, n=2, rows=32)
    with pytest.raises(ValueError, match="windowed QueueDataset"):
        _mk_trainer().train_stream(_qds(files))


def test_train_stream_continues_across_calls(tmp_path):
    """max_windows bounds one call but must not lose the rest of the
    stream: train_stream restores the full known list on exit so a later
    call picks up where the first stopped."""
    files = _files(tmp_path, n=4, rows=32)
    with flags_scope(stream_window_files=2, read_thread_num=1):
        tr = _mk_trainer()
        ds = _qds(files)
        cm = CheckpointManager(str(tmp_path / "ckpt"))
        out1 = tr.train_stream(ds, cm, max_windows=1)
        assert out1["windows"] == 1
        assert ds.filelist == files  # full stream still visible
        assert ds.pending_files() == files[2:]
        out2 = tr.train_stream(ds, cm)
        assert out2["windows"] == 1
        assert ds.files_completed == files


def test_stream_cursor_history_compaction_bounded(tmp_path):
    """The boundary-checkpoint cadence folds completed-file history into
    a count + chained fingerprint, so cursor.json stays bounded by the
    checkpoint interval while the in-memory view keeps every name."""
    files = _files(tmp_path, n=8, rows=32)
    with flags_scope(stream_window_files=2, read_thread_num=1,
                     stream_ckpt_every_windows=1):
        tr = _mk_trainer()
        ds = _qds(files)
        cm = CheckpointManager(str(tmp_path / "ckpt"))
        out = tr.train_stream(ds, cm)
        assert out["windows"] == 4
        assert ds.files_completed == files
        st = cm.load_cursor()["stream"]
        assert st["files_completed"] == files[6:]
        assert st["files_folded"]["count"] == 6
        assert st["files_folded"]["sha256"] == chain_digest("", files[:6])
        for step in cm.steps():
            cur = cm.load_cursor(step)
            if cur is None or "stream" not in cur:
                continue
            assert len(cur["stream"]["files_completed"]) <= 2, cur


def test_folded_cursor_resume_skips_completed(tmp_path):
    """A restart from a cursor whose history is folded re-derives the
    folded prefix from the filelist (fingerprint-checked), skips it, and
    consumes only the remaining stream."""
    files = _files(tmp_path, n=8, rows=32)
    with flags_scope(stream_window_files=2, read_thread_num=1,
                     stream_ckpt_every_windows=1):
        root = str(tmp_path / "ckpt")
        tr = _mk_trainer()
        out1 = tr.train_stream(_qds(files), CheckpointManager(root),
                               max_windows=2)
        assert out1["windows"] == 2
        st = CheckpointManager(root).load_cursor()["stream"]
        assert st["files_folded"]["count"] == 2   # folded history
        tr2 = _mk_trainer(seed=1)
        cm2 = CheckpointManager(root)
        assert cm2.restore(tr2) == tr.global_step
        ds2 = _qds(files)
        out2 = tr2.train_stream(ds2, cm2)
        assert out2["windows"] == 2          # only the remaining half
        assert out2["files"] == 4
        assert out2["replayed_files"] == 0   # boundary cursor: no window
        assert ds2.files_completed == files


def test_folded_cursor_filelist_mismatch_is_loud(tmp_path):
    """A filelist that no longer reproduces the folded fingerprint
    refuses adoption with a clear error — in the dataset, and in the
    trainer's cursor check, which rolls back to the boundary instead of
    skipping the wrong files."""
    files = _files(tmp_path, n=4, rows=32)
    cursor = {"windowed": True, "files_completed": [],
              "window_files": files[2:4], "windows_completed": 1,
              "files_folded": {"count": 2,
                               "sha256": chain_digest("", files[:2])}}
    with flags_scope(stream_window_files=2, read_thread_num=1):
        ds = _qds([files[1], files[0]] + files[2:])  # reordered prefix
        with pytest.raises(ValueError, match="folded"):
            ds.adopt_stream_cursor(cursor)
        # the trainer: a stream cursor whose filelist no longer matches
        # rolls back to the boundary (none here: it refuses)
        tr = _mk_trainer()
        cm = CheckpointManager(str(tmp_path / "ckpt"))
        cm.save(tr, cursor={"version": 2, "global_step": 0,
                            "batch_index": 0, "stream": cursor,
                            "quarantined_files": []})
        with pytest.raises(RuntimeError, match="fingerprint mismatch"):
            tr._adopt_cursor(cm, ds)


def test_train_stream_window_fault_retries_and_replays(tmp_path):
    """The stream.window chaos seam: a transient fault on window 2's
    dispatch rolls back to the window-1 boundary checkpoint and replays
    window 2 — the stream completes with a pass retry, not a crash, and
    ends where the fault-free stream ends."""
    files = _files(tmp_path, n=4, rows=32)
    plan = FaultPlan.parse("stream.window:fail:nth=2")
    flags = dict(stream_window_files=2, read_thread_num=1,
                 stream_ckpt_every_windows=1, pass_retry_limit=1,
                 retry_base_delay_sec=0.01, retry_max_delay_sec=0.02)
    with flags_scope(**flags), installed(plan):
        tr = _mk_trainer()
        ds = _qds(files)
        out = tr.train_stream(ds, CheckpointManager(str(tmp_path / "a")))
        assert out["windows"] == 2
        assert ds.files_completed == files
    assert plan.stats()["stream.window:fail"]["fired"] == 1
    with flags_scope(**flags):
        clean = _mk_trainer()
        clean.train_stream(_qds(files),
                           CheckpointManager(str(tmp_path / "b")))
    assert tr.global_step == clean.global_step
    assert state_digest(tr) == state_digest(clean)


def test_train_stream_window_hooks(tmp_path):
    """The boundary hooks: ``on_window_complete`` sees every window;
    ``stream_save_now`` forces a boundary save off the cadence and
    ``stream_force_base`` makes it a base; a truthy
    ``stream_membership`` saves the boundary and returns."""
    files = _files(tmp_path, n=6, rows=32)
    with flags_scope(stream_window_files=2, read_thread_num=1,
                     stream_ckpt_every_windows=100):
        tr = _mk_trainer()
        cm = CheckpointManager(str(tmp_path / "ckpt"), keep=10)
        seen = []

        def on_window(widx, ds):
            seen.append((widx, list(ds.files_completed)))
            if widx == 0:
                tr.stream_save_now = True
            if widx == 1:
                tr.stream_save_now = tr.stream_force_base = True
        tr.on_window_complete = on_window
        tr.stream_membership = lambda: "scale" if len(seen) == 3 else None
        out = tr.train_stream(_qds(files), cm)
    assert out["windows"] == 3 and out["membership"] == "scale"
    assert [w for w, _ in seen] == [0, 1, 2]
    assert seen[1][1] == files[:4]
    assert cm.steps() == [4, 8, 12]
    kinds = [cm._meta(s)["kind"] for s in cm.steps()]
    assert kinds == ["base", "base", "delta"]
    assert not tr.stream_save_now and not tr.stream_force_base
    assert cm.load_cursor()["stream"]["window_files"] == []


def test_channel_stats_match_the_reference(tmp_path):
    """A per-line load's named record channel books the same puts and
    gets in both packages' registries."""
    from paddlebox_tpu.utils import channel as jchannel

    from paddlebox_tpu_torch.utils import channel
    files = _files(tmp_path, n=2, rows=40)
    stats = []
    for pkg, mod in ((PORT, channel), (JAX, jchannel)):
        mod.reset_channel_stats()
        with pkg["flags"](native_parse=False, read_thread_num=1):
            ds = pkg["factory"]().create_dataset(
                "InMemoryDataset", pkg["desc"].criteo(batch_size=16))
            ds.set_filelist(files)
            ds.load_into_memory()
        del ds
        st = mod.channel_stats_snapshot()["dataset.load_records"]
        stats.append((st["puts"], st["gets"], st["channels"]))
    assert stats[0] == stats[1] == (80, 80, 1)


_STREAM_WORKER = textwrap.dedent("""
    import os, sys, time
    import torch

    from paddlebox_tpu_torch import DeepFM, EmbeddingTable, Trainer
    from paddlebox_tpu_torch.config import FLAGS
    from paddlebox_tpu_torch.data import DataFeedDesc, DatasetFactory
    from paddlebox_tpu_torch.ps.sgd import SparseSGDConfig
    from paddlebox_tpu_torch.resilience import preemption
    from paddlebox_tpu_torch.resilience.preemption import PreemptedError
    from paddlebox_tpu_torch.train.checkpoint import CheckpointManager

    phase, data_dir, ckpt_root, counts_path, beacon = sys.argv[1:6]
    torch.set_num_threads(1)
    FLAGS.graceful_shutdown = True
    FLAGS.stream_window_files = 2
    FLAGS.stream_ckpt_every_windows = 1
    FLAGS.read_thread_num = 1

    desc = DataFeedDesc.criteo(batch_size=16)
    desc.key_bucket_min = 2048
    cfg = SparseSGDConfig(mf_create_thresholds=0.0, mf_initial_range=0.0)
    table = EmbeddingTable(mf_dim=4, capacity=1 << 13, cfg=cfg,
                           unique_bucket_min=2048, device="cpu")
    torch.manual_seed(0)
    model = DeepFM(26, 7, 13, hidden=(8,), compute_dtype=torch.float32)
    trainer = Trainer(model, table, desc, seed=0, device="cpu")

    files = sorted(os.path.join(data_dir, f)
                   for f in os.listdir(data_dir))
    ds = DatasetFactory().create_dataset("QueueDataset", desc)
    ds.set_filelist(files)
    cm = CheckpointManager(ckpt_root)

    # per-record training counts, APPENDED per batch (crash-safe): one
    # record signature per line
    fh = open(counts_path, "a")
    def on_batch(b):
        n = int((b.show > 0).sum())
        keys = b.keys[:n * b.num_slots].reshape(n, b.num_slots)
        for i in range(n):
            fh.write(keys[i].tobytes().hex() + "\\n")
        fh.flush()
        if phase == "run" and trainer.global_step == 3:
            open(beacon, "w").write("mid-stream")
        if phase == "run":
            time.sleep(0.05)  # let the parent's SIGTERM land mid-window
    trainer.on_batch_trained = on_batch

    if phase == "resume":
        cm.restore(trainer)
    try:
        trainer.train_stream(ds, cm)
    except PreemptedError:
        sys.exit(preemption.EXIT_RESUME)
    sys.exit(0)
""")


def test_real_sigterm_stream_resumes_at_least_once(tmp_path):
    """A real SIGTERM to a real windowed streaming process of the port:
    graceful exit with EXIT_RESUME and a stream-cursor emergency
    checkpoint, and the restarted process trains every input record at
    least once, completed-window records exactly once."""
    from paddlebox_tpu_torch.data.parser import get_parser
    data_dir = str(tmp_path / "data")
    generate_criteo_files(data_dir, num_files=6, rows_per_file=48,
                          vocab_per_slot=40, seed=3)
    files = sorted(os.path.join(data_dir, f) for f in os.listdir(data_dir))
    ckpt_root = str(tmp_path / "ckpt")
    counts = str(tmp_path / "counts.txt")
    beacon = str(tmp_path / "beacon")
    worker = str(tmp_path / "worker.py")
    with open(worker, "w") as fh:
        fh.write(_STREAM_WORKER)
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.Popen(
        [sys.executable, worker, "run", data_dir, ckpt_root, counts,
         beacon], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    deadline = time.monotonic() + 120
    while not os.path.exists(beacon):
        assert proc.poll() is None, \
            f"worker died early:\n{proc.stdout.read()}"
        assert time.monotonic() < deadline, "beacon never appeared"
        time.sleep(0.02)
    proc.send_signal(signal.SIGTERM)
    out, _ = proc.communicate(timeout=120)
    assert proc.returncode == preemption.EXIT_RESUME, \
        f"rc={proc.returncode}\n{out}"
    last = sorted(n for n in os.listdir(ckpt_root)
                  if n.startswith("ckpt-"))[-1]
    cur = json.load(open(os.path.join(ckpt_root, last, "cursor.json")))
    open_window = cur["stream"]["window_files"]
    assert open_window, "SIGTERM was meant to land mid-window"
    rc = subprocess.run(
        [sys.executable, worker, "resume", data_dir, ckpt_root, counts,
         beacon], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, timeout=120)
    assert rc.returncode == 0, rc.stdout
    trained = {}
    with open(counts) as fh:
        for line in fh:
            trained[line.strip()] = trained.get(line.strip(), 0) + 1
    parser = get_parser(DataFeedDesc.criteo(batch_size=16))
    replays = 0
    for path in files:
        with open(path) as f:
            for line in f:
                n = trained.get(parser.parse(line).keys.tobytes().hex(), 0)
                assert n >= 1, f"record of {path} never trained"
                if path in open_window:
                    assert n <= 2, (path, n)
                    replays += n - 1
                else:
                    assert n == 1, (path, n)
    assert replays > 0  # the open window's trained prefix replayed


# ---------------------------------------------------------------------------
# the stream scenario: 4 slots, batch 64, 8 files of one batch, windows of 2
# ---------------------------------------------------------------------------

S, MF, DENSE_DIM, BS, NFILES, CAP = 4, 4, 3, 64, 8, 1 << 12


def _slots(cls):
    return ([cls("label", "float", 1), cls("d", "float", DENSE_DIM)]
            + [cls(f"S{i}", "uint64") for i in range(S)])


def _scenario_files(tmp_path, seed=0):
    """NFILES slot_text files of BS ragged records each, from a numpy
    seed; dense values with 9 significant digits (exact f32)."""
    rng = np.random.default_rng(seed)
    d = tmp_path / "stream"
    d.mkdir()
    files = []
    for fi in range(NFILES):
        lines = []
        for _ in range(BS):
            counts = np.minimum(rng.zipf(1.5, size=S), 6)
            label = int(rng.random() < 0.4)
            dense = rng.normal(size=DENSE_DIM).astype(np.float32)
            toks = ["1", str(label), str(DENSE_DIM)]
            toks += ["%.9g" % v for v in dense]
            for c in counts:
                toks += [str(int(c))] + [str(int(k)) for k in
                                         rng.integers(0, 600, size=c)]
            lines.append(" ".join(toks))
        path = str(d / f"part-{fi:03d}.txt")
        with open(path, "w") as fh:
            fh.write("\n".join(lines) + "\n")
        files.append(path)
    return files


SDESC = DataFeedDesc(slots=_slots(SlotDef), label_slot="label",
                     batch_size=BS, key_bucket_min=512)
JSDESC = JDesc(slots=_slots(JSlotDef), label_slot="label", batch_size=BS,
               key_bucket_min=512)


def mk(seed=0):
    torch.manual_seed(seed)
    t = EmbeddingTable(mf_dim=MF, capacity=CAP,
                       cfg=SparseSGDConfig(**CFG), unique_bucket_min=512,
                       device="cpu")
    model = DeepFM(S, 3 + MF, DENSE_DIM, hidden=(16, 8),
                   compute_dtype=torch.float32)
    return Trainer(model, t, SDESC,
                   tx=lambda p: torch.optim.Adam(p, lr=1e-2, eps=1e-8),
                   seed=3, device="cpu")


def _stream_ds(files):
    ds = DatasetFactory().create_dataset("QueueDataset", SDESC)
    ds.set_filelist(files)
    return ds


def _logical(table):
    keys, rows = table.index.items()
    order = np.argsort(keys)
    return keys[order], table._gather_host(rows[order])


def _params(tr):
    return {k: v.clone() for k, v in tr.model.state_dict().items()}


def _snapshots(tr):
    """on_window_complete hook recording (step, logical rows, params) at
    every window boundary."""
    snaps = []

    def hook(widx, ds):
        tr.sync_table()
        snaps.append((tr.global_step, _logical(tr.table), _params(tr)))
    tr.on_window_complete = hook
    return snaps


STREAM_FLAGS = dict(stream_window_files=2, read_thread_num=1,
                    stream_ckpt_every_windows=1)


def test_stream_equals_its_own_train_pass(tmp_path):
    """The port's windowed stream with boundary checkpoints trains the
    same batches in the same order as one ``train_pass`` over the
    natively loaded files: equal state digests, bit for bit."""
    files = _scenario_files(tmp_path)
    with flags_scope(**STREAM_FLAGS):
        tr = mk()
        out = tr.train_stream(_stream_ds(files),
                              CheckpointManager(str(tmp_path / "ckpt")))
    assert out["windows"] == 4 and out["batches"] == NFILES
    ref = mk()
    ds = InMemoryDataset(SDESC)
    ds.set_filelist(files)
    ds.load_into_memory()
    assert ds.parse_route == "native"
    ref.train_pass(ds)
    assert tr.global_step == ref.global_step == NFILES
    assert state_digest(tr) == state_digest(ref)


def _jmk():
    jt = JTable(mf_dim=MF, capacity=CAP, cfg=JCfg(**CFG),
                unique_bucket_min=512)
    return JTrainer(JDeepFM(hidden=(16, 8), compute_dtype=jnp.float32), jt,
                    JSDESC, tx=optax.adam(1e-2), seed=3)


def _jstream_ds(files):
    ds = JFactory().create_dataset("QueueDataset", JSDESC)
    ds.set_filelist(files)
    return ds


def _port_like(jtr, seed=0):
    tr = mk(seed)
    tr.model.load_state_dict(convert.deepfm_state_dict_from_flax(
        jax.device_get(jtr.state.params)))
    return tr


def _jsnapshots(jtr):
    snaps = []

    def hook(widx, ds):
        jtr.sync_table()
        snaps.append((jtr.global_step, _logical(jtr.table),
                      convert.deepfm_state_dict_from_flax(
                          jax.device_get(jtr.state.params))))
    jtr.on_window_complete = hook
    return snaps


def _assert_close(rows_a, params_a, rows_b, params_b):
    (ka, ba), (kb, bb) = rows_a, rows_b
    np.testing.assert_array_equal(ka, kb)
    for f in sorted(bb):
        np.testing.assert_allclose(ba[f], bb[f], rtol=STATE_RTOL,
                                   atol=STATE_ATOL, err_msg=f)
    for name, w in params_b.items():
        np.testing.assert_allclose(params_a[name].numpy(), w.numpy(),
                                   rtol=STATE_RTOL, atol=STATE_ATOL,
                                   err_msg=name)


@pytest.mark.parametrize("flags", sorted(JAX_FLAGS))
def test_stream_matches_jax_train_stream_at_every_boundary(tmp_path,
                                                           flags):
    files = _scenario_files(tmp_path)
    jtr = _jmk()
    tr = _port_like(jtr)
    with j_flags_scope(**STREAM_FLAGS, **JAX_FLAGS[flags]):
        jsnaps = _jsnapshots(jtr)
        jout = jtr.train_stream(_jstream_ds(files),
                                JCM(str(tmp_path / "jax")))
    with flags_scope(**STREAM_FLAGS):
        snaps = _snapshots(tr)
        out = tr.train_stream(_stream_ds(files),
                              CheckpointManager(str(tmp_path / "port")))
    for k in ("windows", "files", "batches", "examples"):
        assert out[k] == jout[k], k
    assert [s[0] for s in snaps] == [s[0] for s in jsnaps] == [2, 4, 6, 8]
    for (_, rows, params), (_, jrows, jparams) in zip(snaps, jsnaps):
        _assert_close(rows, params, jrows, jparams)
    # the final boundary cursors agree key for key
    assert (CheckpointManager(str(tmp_path / "port")).load_cursor()["stream"]
            == JCM(str(tmp_path / "jax")).load_cursor()["stream"])


def test_preempted_stream_replays_the_open_window(tmp_path):
    """Oracle: an uninterrupted stream. Killed: the same stream under
    ``preempt.signal:fail:nth=5`` raises inside window 3 (after its first
    batch); new objects restore and stream again. The resumed run
    replays exactly window 3's two files, every record trains at least
    once and only window 3's first file twice, the resumed run ends at
    the oracle's step count, and the killed run's checkpoint at the last
    common boundary (step 4) equals the oracle's state there."""
    files = _scenario_files(tmp_path)
    trained = collections.Counter()

    def count(b):
        for row in b.dense[:int((b.show > 0).sum())]:
            trained[row.tobytes()] += 1

    with flags_scope(**STREAM_FLAGS):
        oracle = mk()
        digests = {}
        oracle.on_window_complete = (
            lambda w, ds: digests.setdefault(oracle.global_step,
                                             state_digest(oracle)))
        oracle.train_stream(_stream_ds(files),
                            CheckpointManager(str(tmp_path / "oracle")))
        root = str(tmp_path / "killed")
        killed = mk()
        killed.on_batch_trained = count
        with installed(FaultPlan.parse("preempt.signal:fail:nth=5")):
            with pytest.raises(PreemptedError) as ei:
                killed.train_stream(_stream_ds(files),
                                    CheckpointManager(root))
        preemption.clear_stop()
        assert ei.value.checkpointed and killed.global_step == 5
        st = CheckpointManager(root).load_cursor()["stream"]
        assert st["window_files"] == files[4:6]
        assert st["files_completed"] == []
        assert st["files_folded"] == {"count": 4,
                                      "sha256": chain_digest("", files[:4])}
        resumed = mk(seed=1)
        cm = CheckpointManager(root)
        assert cm.restore(resumed) == 5
        resumed.on_batch_trained = count
        out = resumed.train_stream(_stream_ds(files), cm)
        assert out["replayed_files"] == 2 and out["windows"] == 2
        assert resumed.global_step == oracle.global_step + 1
        at4 = mk(seed=2)
        assert CheckpointManager(root).restore(at4, step=4) == 4
        assert state_digest(at4) == digests[4]
    parser = SlotTextParser(SDESC)
    for fi, path in enumerate(files):
        with open(path) as fh:
            hits = {trained[parser.parse(line).dense.tobytes()]
                    for line in fh}
        assert hits == {2 if fi == 4 else 1}, (fi, hits)


def _jax_root_into_port(jroot, proot, trainer):
    """A copy of a JAX checkpoint root the port's manager restores: each
    link's ``dense.pkl`` converted into the port's ``dense.pt``, its
    checksum and sidecar dropped (the sparse files and the cursor are
    shared as they are)."""
    shutil.copytree(jroot, proot)
    for s in JCM(proot).steps():
        d = os.path.join(proot, f"ckpt-{s:012d}")
        with open(os.path.join(d, "dense.pkl"), "rb") as fh:
            blob = pickle.load(fh)
        torch.save(convert.dense_from_jax_checkpoint(
            blob, trainer.model, trainer.state.opt), os.path.join(d, DENSE))
        meta = json.load(open(os.path.join(d, "meta.json")))
        meta["checksums"].pop("dense.pkl")
        with open(os.path.join(d, "meta.json"), "w") as fh:
            json.dump(meta, fh)
        os.unlink(os.path.join(d, "meta.sha256"))


def test_port_adopts_a_jax_stream_cursor(tmp_path):
    """The JAX ``train_stream`` preempted at batch 5 writes a cursor with
    a folded history and an open window; the port restores that chain
    and resumes: it replays the same window and ends at the JAX resume's
    state within the train-state class."""
    files = _scenario_files(tmp_path)
    jroot = str(tmp_path / "jax")
    with j_flags_scope(**STREAM_FLAGS):
        jtr = _jmk()
        with jfaults.installed(
                jfaults.FaultPlan.parse("preempt.signal:fail:nth=5")):
            with pytest.raises(jpreemption.PreemptedError):
                jtr.train_stream(_jstream_ds(files), JCM(jroot))
        jpreemption.clear_stop()
        jcur = JCM(jroot).load_cursor()
        assert jcur["stream"]["window_files"] == files[4:6]
        assert jcur["stream"]["files_folded"]["count"] == 4
        proot = str(tmp_path / "port")
        tr = mk(seed=1)
        _jax_root_into_port(jroot, proot, tr)
        jtr2 = _jmk()
        jcm = JCM(jroot)
        assert jcm.restore(jtr2) == 5
        jout = jtr2.train_stream(_jstream_ds(files), jcm)
    with flags_scope(**STREAM_FLAGS):
        cm = CheckpointManager(proot)
        assert cm.restore(tr) == 5
        ds = _stream_ds(files)
        out = tr.train_stream(ds, cm)
    assert out["replayed_files"] == jout["replayed_files"] == 2
    assert out["batches"] == jout["batches"] == 4
    assert ds.files_completed == files
    jtr2.sync_table()
    _assert_close(_logical(tr.table), _params(tr), _logical(jtr2.table),
                  convert.deepfm_state_dict_from_flax(
                      jax.device_get(jtr2.state.params)))


# ---------------------------------------------------------------------------
# the Criteo walkthrough
# ---------------------------------------------------------------------------

def test_criteo_walkthrough_runs_on_the_cpu(tmp_path):
    from paddlebox_tpu_torch.examples import train_criteo
    out = train_criteo.main(["--rows", "2000", "--batch-size", "128",
                             "--device", "cpu", "--workdir",
                             str(tmp_path)])
    assert out["parse_route"] == "native"
    assert len(out["passes"]) == 3
    assert all(np.isfinite(p["auc"]) for p in out["passes"])
    assert out["eval"]["ins_num"] > 0 and np.isfinite(out["eval"]["auc"])
    assert out["served"] > 0 and np.isfinite(out["mean_ctr"])
