"""The port's exchange probe (``train/a2a_probe.py``) against the JAX
package's, on the CPU: the reference's ``test_a2a_probe_reports_and_spans``
on the port's ``ShardedTrainer`` (8 shards on the CPU, a2a_chunks 2)
beside the JAX probe on its 8-device CPU mesh, over the same criteo files
from the same initial params.

Held: the 14 keys of the reference's result, the chunk count and the
exchange sections exactly (the plans are the reference's), every timed
piece positive, 0 <= frac <= 1, the spans and their lane only while a
span sink is attached, the ``exchange_wait`` critical-path part, and the
state after the probe: against the JAX trainer after its probe within
the ragged train-state class (rtol 2e-4 / atol 2e-5; both probes run
real steps, lazy mf draws zeros), against a port twin that ran the same
steps on the same staged batch without the probe bit for bit, and on a
two-rank gloo pod bit for bit against the single controller. The next
resident pass event carries the measured ``exchange_overlap_frac``.
Timings are host-clock and never compared across packages.
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
from paddlebox_tpu.obs import reset_hub as j_reset_hub
from paddlebox_tpu.obs import trace as j_trace
from paddlebox_tpu.parallel import make_mesh
from paddlebox_tpu.ps import SparseSGDConfig as JCfg
from paddlebox_tpu.ps.sharded import ShardedEmbeddingTable as JSharded
from paddlebox_tpu.train.a2a_probe import probe_exchange as j_probe
from paddlebox_tpu.train.sharded import ShardedTrainer as JShardedTrainer

from paddlebox_tpu_torch import DeepFM, InMemoryDataset, convert
from paddlebox_tpu_torch.config import flags_scope
from paddlebox_tpu_torch.data import DataFeedDesc
from paddlebox_tpu_torch.obs import (ChromeLaneTraceSink, MemorySink,
                                     reset_hub, trace)
from paddlebox_tpu_torch.ps.sgd import SparseSGDConfig
from paddlebox_tpu_torch.ps.sharded import (ShardedEmbeddingTable,
                                            plan_sections)
from paddlebox_tpu_torch.train import sharded as tsharded
from paddlebox_tpu_torch.train.a2a_probe import probe_exchange
from paddlebox_tpu_torch.train.checkpoint import sharded_state_digest
from paddlebox_tpu_torch.train.sharded import (ShardedTrainer,
                                               push_generators)
from paddlebox_tpu_torch.utils.profiler import ChromeTraceWriter

from test_torch_sharded import (BS, CAP, CFG, DENSE, MF, S, TABLE_KW,
                                _arrays, _base_blob)
from torch_pod_worker import launch_pod, run_probe

STATE_RTOL, STATE_ATOL = 2e-4, 2e-5
N, CHUNKS = 8, 2
HIDDEN = (16, 16)
SGD = dict(mf_create_thresholds=0.0, mf_initial_range=0.0,
           learning_rate=0.1, mf_learning_rate=0.1)
KEYS = {"a2a_chunks", "a2a_sections", "serve_sec", "a2a_pull_sec",
        "pool_sec", "dense_sec", "push_sec", "dense_sync_sec",
        "step_monolithic_sec", "step_chunked_sec", "exchange_sec_total",
        "exchange_overlap_sec", "exchange_overlap_frac",
        "exchange_wait_sec"}


@pytest.fixture
def fresh_hub():
    j_reset_hub()
    j_trace.reset()
    hub = reset_hub()
    trace.reset()
    yield hub
    reset_hub()
    trace.reset()
    j_reset_hub()
    j_trace.reset()


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The reference test's criteo files (500 rows, 40 ids a slot)."""
    d = tmp_path_factory.mktemp("probe_ds")
    return generate_criteo_files(str(d), num_files=1, rows_per_file=500,
                                 vocab_per_slot=40, seed=29)


def _port_ds(files):
    desc = DataFeedDesc.criteo(batch_size=32)
    desc.key_bucket_min = 1024
    ds = InMemoryDataset(desc)
    ds.set_filelist(files)
    ds.load_into_memory()
    return ds, desc


@pytest.fixture(scope="module")
def jax_run(files):
    """The reference's probe (chunks 2, reps 1) on a fresh trainer: the
    initial params for the port, the probe's result and the logical rows
    and params after it."""
    desc = JDesc.criteo(batch_size=32)
    desc.key_bucket_min = 1024
    ds = JFactory().create_dataset("InMemoryDataset", desc)
    ds.set_filelist(files)
    ds.load_into_memory()
    table = JSharded(N, mf_dim=4, capacity_per_shard=4096, cfg=JCfg(**SGD),
                     req_bucket_min=256, serve_bucket_min=256)
    with j_flags_scope(log_period_steps=10 ** 6, a2a_chunks=CHUNKS):
        tr = JShardedTrainer(JDeepFM(hidden=HIDDEN,
                                     compute_dtype=jnp.float32),
                             table, desc, make_mesh(N),
                             tx=optax.adam(2e-3))
        params = convert.deepfm_state_dict_from_flax(
            jax.device_get(tr.state.params))
        pr = j_probe(tr, dataset=ds, reps=1)
    data = np.asarray(jax.device_get(tr.state.table.data))
    keys, rows = [], []
    for s in range(N):
        k, r = table.indexes[s].items()
        keys.append(k)
        rows.append(data[s][r])
    keys = np.concatenate(keys)
    order = np.argsort(keys)
    return dict(params=params, probe=pr, keys=keys[order],
                rows=np.concatenate(rows)[order],
                after=convert.deepfm_state_dict_from_flax(
                    jax.device_get(tr.state.params)))


def _port_trainer(files, params):
    ds, desc = _port_ds(files)
    table = ShardedEmbeddingTable(N, mf_dim=4, capacity_per_shard=4096,
                                  cfg=SparseSGDConfig(**SGD), devices="cpu",
                                  req_bucket_min=256, serve_bucket_min=256)
    model = DeepFM(26, 3 + 4, 13, hidden=HIDDEN,
                   compute_dtype=torch.float32)
    model.load_state_dict(params)
    with flags_scope(a2a_chunks=CHUNKS):
        tr = ShardedTrainer(
            model, table, desc,
            tx=lambda p: torch.optim.Adam(p, lr=2e-3, eps=1e-8))
    return tr, ds


def _logical(table):
    keys, rows = [], []
    for s in range(table.n):
        k, r = table.indexes[s].items()
        keys.append(k)
        rows.append(table._rows_host(s, r))
    keys = np.concatenate(keys)
    order = np.argsort(keys)
    return keys[order], np.concatenate(rows)[order]


def _check_report(pr, chunks):
    assert set(pr) == KEYS
    assert pr["a2a_chunks"] == chunks
    assert len(pr["a2a_pull_sec"]) == chunks == len(pr["pool_sec"])
    assert len(pr["a2a_sections"]) == chunks
    pieces = (pr["a2a_pull_sec"] + pr["pool_sec"]
              + [pr[k] for k in ("serve_sec", "dense_sec", "push_sec",
                                 "dense_sync_sec", "step_monolithic_sec",
                                 "step_chunked_sec")])
    assert all(t > 0 for t in pieces), pr
    assert 0.0 <= pr["exchange_overlap_frac"] <= 1.0
    assert pr["exchange_wait_sec"] >= 0.0
    assert pr["exchange_overlap_sec"] <= pr["exchange_sec_total"]


def test_probe_reports_and_spans(fresh_hub, files, jax_run):
    """The reference's test on the port (a pass, then the probe), beside
    the JAX probe: the same keys, chunks and sections; the wait part
    rides the next pass event (unless the measured wait was 0);
    a2a.pull.*, pool.* and a2a.push spans on the device.a2a lane."""
    tr, ds = _port_trainer(files, jax_run["params"])
    tr.train_pass(ds)
    w = ChromeTraceWriter()
    sink = ChromeLaneTraceSink(w)
    fresh_hub.add_sink(sink)
    try:
        trace.reset()
        pr = probe_exchange(tr, dataset=ds, reps=1)
    finally:
        fresh_hub.remove_sink(sink)
    _check_report(pr, CHUNKS)
    want = jax_run["probe"]
    assert set(pr) == set(want)
    assert pr["a2a_sections"] == want["a2a_sections"]
    assert tr._last_exchange_probe is pr
    parts = trace.consume_pass_parts()
    assert "exchange_wait" in parts or pr["exchange_wait_sec"] == 0.0
    names = {e.get("name") for e in w._events}
    assert {"a2a.pull.0", "a2a.pull.1", "pool.0", "pool.1",
            "a2a.push"} <= names
    lanes = {e.get("args", {}).get("lane") for e in w._events
             if e.get("name", "").startswith(("a2a.", "pool."))}
    assert lanes == {trace.LANE_DEVICE}
    ctr = fresh_hub.counter("pbox_a2a_chunk_seconds_total")
    assert {"0", "1", "push"} <= {dict(k).get("chunk")
                                  for k in ctr._values}


def test_probe_without_span_sink_emits_no_spans(fresh_hub, files,
                                                jax_run):
    """With the hub on (an event sink) but no span sink, the probe
    records no span and books no lane time; its chunk counter still
    counts."""
    tr, ds = _port_trainer(files, jax_run["params"])
    tr.train_pass(ds)
    fresh_hub.add_sink(MemorySink())
    assert fresh_hub.active and not trace.tracing_active()
    pr = probe_exchange(tr, dataset=ds, reps=1)
    _check_report(pr, CHUNKS)
    assert "pbox_lane_busy_seconds_total" not in fresh_hub.snapshot()
    assert "pbox_a2a_chunk_seconds_total" in fresh_hub.snapshot()


def test_probe_state_matches_jax_and_twin(files, jax_run):
    """The probe's pieces change nothing, and its A/B steps are the
    step's own: from the same fresh start, a twin that runs the same
    steps (twice monolithic, twice chunked, reps 1) on the same staged
    batch with step counter 0's generators ends in the same state bit
    for bit, and the JAX trainer after its probe in class."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        a, ds = _port_trainer(files, jax_run["params"])
        b, _ = _port_trainer(files, jax_run["params"])
        probe_exchange(a, dataset=ds, reps=1)
        group = next(iter(b._group_iter(ds.batches())))
        idx = b.table.prepare_global(group, groups=CHUNKS)
        gb = b._stage_batch(group, idx)
        secs = plan_sections(idx)
        assert secs, "the grouped plan fell back"
        for s in ((), (), secs, secs):
            b.step_fn(b.state, gb, push_generators(b.devices, b.seed, 0), s)
        assert a.global_step == b.global_step == 0
        assert sharded_state_digest(a) == sharded_state_digest(b)
    finally:
        torch.set_num_threads(threads)
    keys, rows = _logical(a.table)
    np.testing.assert_array_equal(keys, jax_run["keys"])
    # show, clk and slot exact; the rest in the train-state class
    np.testing.assert_array_equal(rows[:, [0, 1, 3]],
                                  jax_run["rows"][:, [0, 1, 3]])
    np.testing.assert_allclose(rows, jax_run["rows"], rtol=STATE_RTOL,
                               atol=STATE_ATOL)
    sd = a.model.state_dict()
    for k, v in jax_run["after"].items():
        np.testing.assert_allclose(sd[k].numpy(), v.numpy(),
                                   rtol=STATE_RTOL, atol=STATE_ATOL,
                                   err_msg=k)


@pytest.mark.parametrize("source", ["staged", "resident"])
def test_monolithic_schedule_on_a_grouped_plan(files, jax_run, source):
    """A grouped plan is a valid input to both schedules: the monolithic
    step over it pools its one exchanged block section by section and
    equals the chunked step bit for bit, staged from the plan or decoded
    from a resident pass's wire."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        digests = []
        for mono in (False, True):
            tr, ds = _port_trainer(files, jax_run["params"])
            if source == "staged":
                group = next(iter(tr._group_iter(ds.batches())))
                idx = tr.table.prepare_global(group, groups=CHUNKS)
                gb, secs = tr._stage_batch(group, idx), plan_sections(idx)
            else:
                rp = tr.build_resident_pass(ds)
                rp.upload()
                rp.wait_ready()
                gb, secs = tsharded._decode_wire_step(rp, 0), rp.sections
            assert secs and gb.plan_sections == secs
            tr.step_fn(tr.state, gb, push_generators(tr.devices, 3, 1),
                       () if mono else secs)
            digests.append(sharded_state_digest(tr))
        assert digests[0] == digests[1]
    finally:
        torch.set_num_threads(threads)


def test_next_resident_pass_event_carries_overlap(fresh_hub, files,
                                                  jax_run):
    """After a probe, the next resident pass event reports the measured
    exchange_overlap_frac (and its critical path the wait part)."""
    tr, ds = _port_trainer(files, jax_run["params"])
    tr.train_pass(ds)
    mem = MemorySink()
    fresh_hub.add_sink(mem)
    pr = probe_exchange(tr, dataset=ds, chunks=1, reps=1)
    _check_report(pr, 1)
    # one chunk: nothing to hide, the whole exchange waits
    assert pr["exchange_overlap_frac"] == 0.0
    assert pr["step_chunked_sec"] == pr["step_monolithic_sec"]
    tr.train_pass_resident(ds)
    ev = [e for e in mem.events
          if e.get("kind") == "train_pass_resident_sharded"]
    assert len(ev) == 1
    assert ev[0]["exchange_overlap_frac"] == pr["exchange_overlap_frac"]
    crit = ev[0].get("critical_path", {})
    assert "exchange_wait" in str(crit) or pr["exchange_wait_sec"] == 0.0


def test_probe_on_a_two_rank_pod(tmp_path, monkeypatch):
    """The pod form: two gloo ranks, 2 of 4 shards each, train a pass and
    probe (chunks 2); every rank's report has the keys and the single
    controller's sections, and each owned shard's rows and the params
    after the probe equal the single controller's bit for bit."""
    cfg = dict(shards=4, mf=MF, cap=CAP, sgd=CFG, table_kw=TABLE_KW,
               slots=S, dense=DENSE, batch=BS, hidden=(16, 8), chunks=2,
               zero1=False, table=_base_blob(seed=7),
               arrays=_arrays(BS * 4 + 7, seed=31))
    torch.manual_seed(0)
    cfg["params"] = DeepFM(S, 3 + MF, DENSE, hidden=(16, 8),
                           compute_dtype=torch.float32).state_dict()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        single = run_probe(cfg)
    finally:
        torch.set_num_threads(threads)
    ranks = launch_pod("probe", cfg, tmp_path, monkeypatch)
    _check_report(single["probe"], 2)
    for r, out in enumerate(ranks):
        _check_report(out["probe"], 2)
        assert out["probe"]["a2a_sections"] == \
            single["probe"]["a2a_sections"]
        assert out["owned"] == [2 * r, 2 * r + 1]
        for s in out["owned"]:
            for x, y in zip(out["rows"][s], single["rows"][s]):
                np.testing.assert_array_equal(x, y)
        for k, v in single["params"].items():
            assert torch.equal(out["params"][k], v), k
