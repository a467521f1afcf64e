"""The port's restore consensus and shared quarantine
(``paddlebox_tpu_torch/resilience/consensus.py``) on the port's
``Trainer``, ``CheckpointManager``, ``InMemoryDataset`` and
``QueueDataset``: the consensus and quarantine cases of
``tests/test_preemption.py`` and
``tests/test_streaming.py::test_shared_quarantine_preseeds_windowed_stream``,
each agreed step and quarantine list held against the reference's
``RestoreConsensus`` on the same inputs, and a mesh whose rank 0 is the
port's consensus and rank 1 the reference's (the store's files are the
same JSON in both packages)."""

import os
import threading

import numpy as np
import pytest
import torch

from paddlebox_tpu.config import flags_scope as j_flags_scope
from paddlebox_tpu.data import DataFeedDesc as JDesc
from paddlebox_tpu.data import DatasetFactory as JDatasetFactory
from paddlebox_tpu.resilience import consensus as jconsensus

from paddlebox_tpu_torch.config import flags_scope
from paddlebox_tpu_torch.data import DataFeedDesc, DatasetFactory
from paddlebox_tpu_torch.data.criteo import generate_criteo_files
from paddlebox_tpu_torch.obs import MemorySink, reset_hub
from paddlebox_tpu_torch.resilience import preemption
from paddlebox_tpu_torch.resilience.consensus import (ConsensusTimeout,
                                                      DirConsensusStore,
                                                      RestoreConsensus,
                                                      consensus_restore,
                                                      sync_shared_quarantine)
from paddlebox_tpu_torch.resilience.faults import FaultPlan, installed
from paddlebox_tpu_torch.train.checkpoint import CheckpointManager


@pytest.fixture(autouse=True)
def clean_preempt_state():
    preemption.clear_stop()
    yield
    preemption.clear_stop()


@pytest.fixture()
def fresh_hub():
    hub = reset_hub()
    yield hub
    reset_hub()


def _run_ranks(fns, timeout=30.0):
    """Run one callable per rank concurrently (the consensus gathers
    block until the full mesh publishes)."""
    out = {}
    errs = []

    def runner(i, fn):
        try:
            out[i] = fn()
        except BaseException as e:  # surfaced below
            errs.append(e)

    threads = [threading.Thread(target=runner, args=(i, fn), daemon=True)
               for i, fn in enumerate(fns)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout)
    assert not any(t.is_alive() for t in threads), "consensus deadlocked"
    if errs:
        raise errs[0]
    return [out[i] for i in range(len(fns))]


def _reference_restore_set(tmp_path, step_sets):
    """The reference's agreement over the same per-rank verified sets."""
    store = jconsensus.DirConsensusStore(str(tmp_path / "ref_consensus"))
    n = len(step_sets)
    return _run_ranks([
        (lambda i=i: jconsensus.RestoreConsensus(
            store, i, n, timeout=20).agree_restore_set(step_sets[i]))
        for i in range(n)])


def _batches_equal(a, b):
    return (np.array_equal(a.keys, b.keys)
            and np.array_equal(a.label, b.label)
            and np.array_equal(a.dense, b.dense))


@pytest.fixture()
def trainer_setup(tmp_path):
    from paddlebox_tpu_torch.models import CtrDnn
    from paddlebox_tpu_torch.ps.sgd import SparseSGDConfig
    from paddlebox_tpu_torch.ps.table import EmbeddingTable
    from paddlebox_tpu_torch.train.trainer import Trainer

    files = generate_criteo_files(str(tmp_path / "data"), num_files=2,
                                  rows_per_file=160, vocab_per_slot=30,
                                  seed=3)
    desc = DataFeedDesc.criteo(batch_size=32)
    desc.key_bucket_min = 2048
    cfg = SparseSGDConfig(mf_create_thresholds=0.0, mf_initial_range=0.0)

    def mk():
        t = EmbeddingTable(mf_dim=4, capacity=1 << 12, cfg=cfg,
                           unique_bucket_min=2048, device="cpu")
        torch.manual_seed(0)
        return Trainer(CtrDnn(26, 3 + 4, 13, hidden=(8,)), t, desc,
                       tx=lambda p: torch.optim.Adam(p, lr=1e-2), seed=0,
                       device="cpu")

    def mkds(filelist=None):
        ds = DatasetFactory().create_dataset("InMemoryDataset", desc)
        ds.set_filelist(filelist or files)
        ds.load_into_memory()
        return ds

    return files, mk, mkds


# ---- the cases of tests/test_preemption.py ----------------------------

def test_consensus_restore_survives_drifted_retention(trainer_setup,
                                                      tmp_path):
    """Ranks whose newest checkpoints drifted apart (crash timing /
    corruption) agree on the newest step that exists on BOTH — not a
    min() that one rank may no longer hold."""
    files, mk, mkds = trainer_setup
    ds = mkds()
    roots = [str(tmp_path / "r0"), str(tmp_path / "r1")]
    cms = []
    for r in roots:
        t = mk()
        cm = CheckpointManager(r, keep=10)
        t.train_pass(ds)
        cm.save(t)            # step 10 on both
        t.train_pass(ds)
        cm.save(t)            # step 20 on both
        cms.append(cm)
    # rank 1's newest checkpoint is corrupt -> its verified set is {10}
    target = os.path.join(cms[1]._dir(20), "dense.pt")
    blob = bytearray(open(target, "rb").read())
    blob[len(blob) // 2] ^= 0xFF
    with open(target, "wb") as fh:
        fh.write(bytes(blob))
    sets = [cms[0].verified_steps(), cms[1].verified_steps()]
    assert sets == [[10, 20], [10]]

    store = DirConsensusStore(str(tmp_path / "consensus"))
    fresh = [mk(), mk()]
    got = _run_ranks([
        lambda: consensus_restore(cms[0], fresh[0],
                                  RestoreConsensus(store, 0, 2,
                                                   timeout=20)),
        lambda: consensus_restore(cms[1], fresh[1],
                                  RestoreConsensus(store, 1, 2,
                                                   timeout=20)),
    ])
    assert got == [10, 10]
    assert fresh[0].global_step == fresh[1].global_step == 10
    assert _reference_restore_set(tmp_path, sets) == got


def test_shared_quarantine_refuses_streaming_dataset(tmp_path):
    desc = DataFeedDesc.criteo(batch_size=16)
    ds = DatasetFactory().create_dataset("QueueDataset", desc)
    store = DirConsensusStore(str(tmp_path / "c"))
    with pytest.raises(TypeError, match="in-memory"):
        sync_shared_quarantine(ds, RestoreConsensus(store, 0, 1,
                                                    timeout=5))


def test_consensus_restore_agrees_on_min_step(trainer_setup, tmp_path,
                                              fresh_hub):
    """2-process consensus: ranks with different newest checkpoints both
    restore the same agreed (min) step."""
    files, mk, mkds = trainer_setup
    sink = MemorySink()
    fresh_hub.add_sink(sink)
    ds = mkds()
    roots = [str(tmp_path / "ckpt_r0"), str(tmp_path / "ckpt_r1")]
    trainers, cms = [], []
    for r in roots:
        t = mk()
        cm = CheckpointManager(r, keep=10)
        t.train_pass(ds)
        cm.save(t)
        trainers.append(t)
        cms.append(cm)
    common = trainers[0].global_step
    assert trainers[1].global_step == common
    # rank 0 got one more save in before the crash; rank 1 did not
    trainers[0].train_pass(ds)
    cms[0].save(trainers[0])
    sets = [cms[0].verified_steps(), cms[1].verified_steps()]

    store = DirConsensusStore(str(tmp_path / "consensus"))
    fresh = [mk(), mk()]

    def restore_rank(i):
        c = RestoreConsensus(store, i, 2, timeout=20)
        return consensus_restore(cms[i], fresh[i], c)

    got = _run_ranks([lambda: restore_rank(0), lambda: restore_rank(1)])
    assert got == [common, common]
    assert fresh[0].global_step == fresh[1].global_step == common
    evs = [e for e in sink.events if e["event"] == "restore_consensus"]
    assert len(evs) == 2 and all(e["agreed"] == common for e in evs)
    assert _reference_restore_set(tmp_path, sets) == got


def test_consensus_fresh_start_when_any_rank_empty(tmp_path):
    store = DirConsensusStore(str(tmp_path / "c"))

    def rank(i, step):
        return RestoreConsensus(store, i, 2,
                                timeout=20).agree_restore_step(step)

    got = _run_ranks([lambda: rank(0, None), lambda: rank(1, 7)])
    assert got == [None, None]
    jstore = jconsensus.DirConsensusStore(str(tmp_path / "jc"))
    want = _run_ranks([
        (lambda i=i, s=s: jconsensus.RestoreConsensus(
            jstore, i, 2, timeout=20).agree_restore_step(s))
        for i, s in enumerate((None, 7))])
    assert got == want


def test_consensus_timeout_names_missing_rank(tmp_path):
    store = DirConsensusStore(str(tmp_path / "c"))
    c = RestoreConsensus(store, 0, 2, timeout=0.2, poll_interval=0.01)
    with pytest.raises(ConsensusTimeout, match=r"\[1\]"):
        c.agree_restore_step(3)


def test_consensus_timeout_defaults_to_the_flag(tmp_path):
    store = DirConsensusStore(str(tmp_path / "c"))
    with flags_scope(consensus_timeout_sec=0.15):
        c = RestoreConsensus(store, 0, 2, poll_interval=0.01)
    assert c.timeout == 0.15
    with pytest.raises(ConsensusTimeout, match=r"\[1\]"):
        c.agree_restore_step(3)


def _quarantine_files(tmp_path):
    return generate_criteo_files(str(tmp_path / "data"), num_files=3,
                                 rows_per_file=48, vocab_per_slot=30,
                                 seed=9)


def test_shared_quarantine_preserves_batch_identity(tmp_path, fresh_hub):
    """2-process quarantine consensus: a file fault on ONE process's
    load ends with BOTH processes dropping the same file — batch streams
    stay byte-identical (the SPMD contract)."""
    files = _quarantine_files(tmp_path)
    desc = DataFeedDesc.criteo(batch_size=16)

    def mkds():
        ds = DatasetFactory().create_dataset("InMemoryDataset", desc)
        ds.set_filelist(files)
        return ds

    # ONE reader thread: the record-path load order is then a pure
    # function of the filelist, so the non-reloading originator and the
    # reloading peer must produce identical streams
    with flags_scope(native_parse=False, poison_budget_files=1,
                     poison_budget_records=0, read_thread_num=1):
        ds0, ds1 = mkds(), mkds()
        target = os.path.basename(files[1])
        plan = FaultPlan.parse(
            f"parser.record:corrupt:match=*{target}*,times=0", seed=5)
        with installed(plan):
            ds0.load_into_memory()   # only "rank 0" hits the fault
        ds1.load_into_memory()
        assert [p for p, _ in ds0.quarantined_files] == [files[1]]
        assert ds1.quarantined_files == []
        assert len(ds0) != len(ds1)  # contract broken before the sync

        store = DirConsensusStore(str(tmp_path / "consensus"))
        got = _run_ranks([
            lambda: sync_shared_quarantine(
                ds0, RestoreConsensus(store, 0, 2, timeout=20)),
            lambda: sync_shared_quarantine(
                ds1, RestoreConsensus(store, 1, 2, timeout=20)),
        ])
    assert got[0] == got[1] == [files[1]]
    assert [p for p, _ in ds0.quarantined_files] == [files[1]]
    assert [p for p, _ in ds1.quarantined_files] == [files[1]]
    b0, b1 = list(ds0.batches()), list(ds1.batches())
    assert len(b0) == len(b1) > 0
    assert all(_batches_equal(x, y) for x, y in zip(b0, b1))


def test_shared_quarantine_across_packages(tmp_path):
    """Rank 0 is the port (its load hits the fault), rank 1 the
    reference (healthy): the mixed mesh agrees on the same list, and
    the two packages' batch streams after the sync are identical."""
    from paddlebox_tpu.resilience.faults import FaultPlan as JFaultPlan
    from paddlebox_tpu.resilience.faults import installed as jinstalled
    files = _quarantine_files(tmp_path)
    flags = dict(native_parse=False, poison_budget_files=1,
                 poison_budget_records=0, read_thread_num=1)
    target = os.path.basename(files[1])
    spec = f"parser.record:corrupt:match=*{target}*,times=0"
    with flags_scope(**flags), j_flags_scope(**flags):
        ds0 = DatasetFactory().create_dataset(
            "InMemoryDataset", DataFeedDesc.criteo(batch_size=16))
        ds0.set_filelist(files)
        with installed(FaultPlan.parse(spec, seed=5)):
            ds0.load_into_memory()
        ds1 = JDatasetFactory().create_dataset(
            "InMemoryDataset", JDesc.criteo(batch_size=16))
        ds1.set_filelist(files)
        ds1.load_into_memory()
        # the reference on its own: its faulted rank drops the same file
        jds = JDatasetFactory().create_dataset(
            "InMemoryDataset", JDesc.criteo(batch_size=16))
        jds.set_filelist(files)
        with jinstalled(JFaultPlan.parse(spec, seed=5)):
            jds.load_into_memory()
        store = str(tmp_path / "consensus")
        got = _run_ranks([
            lambda: sync_shared_quarantine(
                ds0, RestoreConsensus(store, 0, 2, timeout=20)),
            lambda: jconsensus.sync_shared_quarantine(
                ds1, jconsensus.RestoreConsensus(store, 1, 2, timeout=20)),
        ])
    assert got[0] == got[1] == [p for p, _ in jds.quarantined_files] == \
        [files[1]]
    b0, b1 = list(ds0.batches()), list(ds1.batches())
    assert len(b0) == len(b1) > 0
    assert all(_batches_equal(x, y) for x, y in zip(b0, b1))


def test_shared_quarantine_noop_when_all_healthy(tmp_path):
    files = generate_criteo_files(str(tmp_path / "data"), num_files=2,
                                  rows_per_file=32, vocab_per_slot=30,
                                  seed=9)
    desc = DataFeedDesc.criteo(batch_size=16)

    def load():
        ds = DatasetFactory().create_dataset("InMemoryDataset", desc)
        ds.set_filelist(files)
        ds.load_into_memory()
        return ds

    ds0, ds1 = load(), load()
    n0 = len(ds0)
    store = DirConsensusStore(str(tmp_path / "consensus"))
    got = _run_ranks([
        lambda: sync_shared_quarantine(
            ds0, RestoreConsensus(store, 0, 2, timeout=20)),
        lambda: sync_shared_quarantine(
            ds1, RestoreConsensus(store, 1, 2, timeout=20)),
    ])
    assert got == [[], []]
    assert len(ds0) == n0  # converged in one round, nothing reloaded


# ---- the case of tests/test_streaming.py ------------------------------

def _qds(files, bs=16):
    desc = DataFeedDesc.criteo(batch_size=bs)
    desc.key_bucket_min = 2048
    ds = DatasetFactory().create_dataset("QueueDataset", desc)
    ds.set_filelist(files)
    return ds


def test_shared_quarantine_preseeds_windowed_stream(tmp_path):
    files = generate_criteo_files(str(tmp_path / "data"), num_files=4,
                                  rows_per_file=48, vocab_per_slot=40,
                                  seed=11)
    store = DirConsensusStore(str(tmp_path / "consensus"))
    with flags_scope(stream_window_files=2):
        ds0, ds1 = _qds(files), _qds(files)
        ds0.quarantined_files.append((files[1], "IOError: local"))
        out = _run_ranks([
            lambda: sync_shared_quarantine(
                ds0, RestoreConsensus(store, 0, 2, timeout=20)),
            lambda: sync_shared_quarantine(
                ds1, RestoreConsensus(store, 1, 2, timeout=20)),
        ])
        assert out[0] == out[1] == [files[1]]
        # both ranks' future windows drop the same file
        assert ds0.pending_files() == ds1.pending_files()
        assert files[1] not in ds1.pending_files()

    # legacy unwindowed streams are still refused
    ds2 = _qds(files)
    with pytest.raises(TypeError, match="WINDOWED"):
        sync_shared_quarantine(ds2, RestoreConsensus(store, 0, 1,
                                                     timeout=5))


# ---- one directory, both packages -------------------------------------

def test_consensus_across_packages_over_one_dir(tmp_path):
    """The port's rank 0 and the reference's rank 1 publish into one
    directory and reach the same answers, call after call (the per-call
    topics line up: the lockstep contract holds across packages)."""
    path = str(tmp_path / "mixed")
    port = RestoreConsensus(path, 0, 2, timeout=20, poll_interval=0.01)
    ref = jconsensus.RestoreConsensus(path, 1, 2, timeout=20,
                                      poll_interval=0.01)
    got = _run_ranks([
        lambda: (port.agree_restore_step(12),
                 port.agree_restore_set([4, 8, 12]),
                 port.agree_quarantine(["b", "a"])),
        lambda: (ref.agree_restore_step(8),
                 ref.agree_restore_set([4, 8]),
                 ref.agree_quarantine(["c"])),
    ])
    assert got[0] == got[1] == (8, 8, ["a", "b", "c"])
