"""The port's resident training pass (``Trainer.train_pass_resident``,
``train/device_pass.py``) and its bulk row assignment, on the CPU.

The JAX side runs ``Trainer.train_pass_resident`` from a records-only
``InMemoryDataset`` (its record front) with its default flags (host key
index). The port runs with ``use_pallas_index`` off and on; on the CPU
the device key index runs the plain versions of its kernels.

Tolerances: row assignment, per-batch pull indexes and slots are exact.
Against the reference, the trained rows, dense params and AUC hold the
ragged train-state class, rtol 2e-4 / atol 2e-5 (another framework's
float32 pooling and tower). Port against port — the resident pass
against ``train_pass``, chunked against whole, degraded against flag-off
— runs the same float32 operations in the same order and must agree bit
for bit (tolerance 0): the resident pass only reorders each batch's
unique rows, and each row's grad sums its keys in key order either way.
That holds because these batches (a few hundred keys) stay below the
size where the CPU's accumulating ``index_put_`` (the expand's backward)
splits its work over threads; past it (thousands of keys) the two
layouts can sum a row in other orders and differ by an ulp.
"""

import logging

import numpy as np
import optax
import pytest

import jax
import jax.numpy as jnp
import torch

from paddlebox_tpu.data import DataFeedDesc as JDesc
from paddlebox_tpu.data import SlotDef as JSlotDef
from paddlebox_tpu.data.dataset import InMemoryDataset as JDataset
from paddlebox_tpu.data.record import SlotRecord as JRecord
from paddlebox_tpu.models import DeepFM as JDeepFM
from paddlebox_tpu.ps import EmbeddingTable as JTable
from paddlebox_tpu.ps import SparseSGDConfig as JCfg
from paddlebox_tpu.train import Trainer as JTrainer

from paddlebox_tpu_torch import (DeepFM, EmbeddingTable, InMemoryDataset,
                                 Trainer, convert)
from paddlebox_tpu_torch.config import flags_scope
from paddlebox_tpu_torch.data import DataFeedDesc, SlotDef, SlotRecord
from paddlebox_tpu_torch.ops import index as tix
from paddlebox_tpu_torch.ps.sgd import SparseSGDConfig
from paddlebox_tpu_torch.train.device_pass import (ResidentPass,
                                                   ResidentPassRunner)

STATE_RTOL, STATE_ATOL = 2e-4, 2e-5
S, MF, DENSE, BS, CAP = 4, 4, 3, 64, 1 << 12
N_RECORDS = 5 * BS
CFG = dict(mf_create_thresholds=0.0, mf_initial_range=0.0,
           learning_rate=0.05, mf_learning_rate=0.05)


def _kv_map(kv):
    """A host key index's key → row map."""
    keys, rows = kv.items()
    return dict(zip(keys.tolist(), rows.tolist()))


def _arrays(n=N_RECORDS, seed=0, trivial=False):
    """Zipf-ragged slots (or one key per slot) with slot-qualified ids (a
    feasign belongs to one slot, the reference's contract for pass-level
    slot records)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        counts = (np.ones(S, np.int64) if trivial
                  else np.minimum(rng.zipf(1.5, size=S), 8))
        offs = np.zeros(S + 1, np.int32)
        np.cumsum(counts, out=offs[1:])
        ids = rng.integers(0, 600, size=int(offs[-1])).astype(np.uint64)
        slot = np.repeat(np.arange(S, dtype=np.uint64), counts)
        out.append((slot * np.uint64(10_000) + ids, offs,
                    rng.normal(size=DENSE).astype(np.float32),
                    float(i % 2)))
    return out


def _slots(cls):
    return ([cls("label", "float", 1), cls("d", "float", DENSE)]
            + [cls(f"S{i}", "uint64") for i in range(S)])


def _port_desc():
    return DataFeedDesc(slots=_slots(SlotDef), label_slot="label",
                        batch_size=BS, key_bucket_min=512)


def _port_dataset(arrs):
    ds = InMemoryDataset(_port_desc())
    ds.records = [SlotRecord(k, o, d, l, 1.0, l) for k, o, d, l in arrs]
    return ds


def _port_table():
    return EmbeddingTable(mf_dim=MF, capacity=CAP,
                          cfg=SparseSGDConfig(**CFG), unique_bucket_min=512,
                          device="cpu")


def _port_trainer(params, table=None):
    model = DeepFM(S, 3 + MF, DENSE, hidden=(16, 8),
                   compute_dtype=torch.float32)
    model.load_state_dict(params)
    return Trainer(model, table or _port_table(), _port_desc(),
                   tx=lambda p: torch.optim.Adam(p, lr=1e-2, eps=1e-8),
                   seed=3, check_nan_inf=True, device="cpu")


def _logical(table):
    keys, rows = table.index.items()
    order = np.argsort(keys)
    return keys[order], rows[order], table._gather_host(rows[order])


@pytest.fixture(scope="module")
def jax_run():
    """Two resident passes of the JAX trainer, flag off (its default)."""
    arrs = _arrays()
    jdesc = JDesc(slots=_slots(JSlotDef), label_slot="label",
                  batch_size=BS, key_bucket_min=512)
    jt = JTable(mf_dim=MF, capacity=CAP, cfg=JCfg(**CFG),
                unique_bucket_min=512)
    jtr = JTrainer(JDeepFM(hidden=(16, 8), compute_dtype=jnp.float32), jt,
                   jdesc, tx=optax.adam(1e-2), seed=3)
    params0 = convert.deepfm_state_dict_from_flax(
        jax.device_get(jtr.state.params))
    jds = JDataset(jdesc)
    jds.records = [JRecord(k, o, d, l, 1.0, l) for k, o, d, l in arrs]
    res = [jtr.train_pass_resident(jds) for _ in range(2)]
    jtr.sync_table()
    keys, rows = jt.index.items()
    order = np.argsort(keys)
    return dict(arrs=arrs, params0=params0, res=res,
                keys=keys[order], rows=rows[order],
                blob=jt._gather_host(rows[order]), slot_host=jt.slot_host,
                params=convert.deepfm_state_dict_from_flax(
                    jax.device_get(jtr.state.params)))


@pytest.mark.parametrize("use_index", [False, True],
                         ids=["host_index", "device_index"])
def test_two_resident_passes_match_jax(jax_run, use_index):
    before = dict(tix.DISPATCH)
    with flags_scope(use_pallas_index=use_index):
        tr = _port_trainer(jax_run["params0"])
        ds = _port_dataset(jax_run["arrs"])
        res = [tr.train_pass_resident(ds) for _ in range(2)]
    dev_ticks = (tix.DISPATCH.get(("index.assign", "device"), 0)
                 - before.get(("index.assign", "device"), 0))
    host_ticks = (tix.DISPATCH.get(("index.assign", "host"), 0)
                  - before.get(("index.assign", "host"), 0))
    assert (dev_ticks, host_ticks) == ((2, 0) if use_index else (0, 0))
    assert (tr.table._dev_index is not None) == use_index
    keys, rows, blob = _logical(tr.table)
    np.testing.assert_array_equal(keys, jax_run["keys"])
    np.testing.assert_array_equal(rows, jax_run["rows"])
    np.testing.assert_array_equal(tr.table.slot_host, jax_run["slot_host"])
    for f in sorted(jax_run["blob"]):
        np.testing.assert_allclose(blob[f], jax_run["blob"][f],
                                   rtol=STATE_RTOL, atol=STATE_ATOL,
                                   err_msg=f)
    assert (blob["mf_size"] > 0).any()
    sd = tr.model.state_dict()
    for name, want in jax_run["params"].items():
        np.testing.assert_allclose(sd[name].numpy(), want.numpy(),
                                   rtol=STATE_RTOL, atol=STATE_ATOL,
                                   err_msg=name)
    for j, t in zip(jax_run["res"], res):
        assert t["batches"] == j["batches"] == N_RECORDS // BS
        np.testing.assert_allclose(t["auc"], j["auc"], rtol=STATE_RTOL)
    assert tr.global_step == 2 * (N_RECORDS // BS)
    assert not tr.table.state.data[CAP].any()
    # the pass's rows are marked for the next delta save
    assert tr.table._touched[rows].all()


def _key_capacity(arrs):
    return max(b.key_capacity for b in _port_dataset(arrs).batches())


def _state(tr):
    return (tr.table.state.data.clone(),
            {k: v.clone() for k, v in tr.model.state_dict().items()},
            tr.state.auc.pos.clone(), tr.state.auc.neg.clone())


def _assert_same_state(a, b):
    assert torch.equal(a[0], b[0])
    for name in a[1]:
        assert torch.equal(a[1][name], b[1][name]), name
    assert torch.equal(a[2], b[2]) and torch.equal(a[3], b[3])


def _params0():
    torch.manual_seed(4)
    return DeepFM(S, 3 + MF, DENSE, hidden=(16, 8)).state_dict()


@pytest.mark.parametrize("use_index,trivial",
                         [(False, False), (True, False), (True, True)],
                         ids=["host_index", "device_index",
                              "device_index_trivial"])
def test_resident_equals_train_pass_bitwise(use_index, trivial):
    arrs, params = _arrays(seed=1, trivial=trivial), _params0()
    stream = _port_trainer(params)
    sres = [stream.train_pass(_port_dataset(arrs)) for _ in range(2)]
    with flags_scope(use_pallas_index=use_index):
        resident = _port_trainer(params)
        rres = [resident.train_pass_resident(_port_dataset(arrs))
                for _ in range(2)]
    _assert_same_state(_state(stream), _state(resident))
    assert resident._resident_runners.keys() == {
        (_key_capacity(arrs), trivial, "dedup", None)}
    for a, b in zip(sres, rres):
        assert a["auc"] == b["auc"] and a["last_loss"] == b["last_loss"]
        assert a["examples"] == b["examples"]
    np.testing.assert_array_equal(stream.table._touched,
                                  resident.table._touched)
    assert resident.stage_timers.seconds.keys() == {"build", "step"}


def test_crippled_device_index_degrades_loudly(caplog):
    arrs, params = _arrays(seed=2), _params0()
    ref = _port_trainer(params)
    for _ in range(2):
        ref.train_pass_resident(_port_dataset(arrs))
    before = tix.DISPATCH.get(("index.assign", "host"), 0)
    with flags_scope(use_pallas_index=True), \
            caplog.at_level(logging.WARNING):
        tr = _port_trainer(params)
        # 512 buckets cannot hold the pass's ~2k uniques: the first bulk
        # assignment overflows, the index degrades for good, and both
        # passes take the host path
        dev = tix.DeviceKeyIndex(CAP, n_buckets=512, device="cpu")
        tr.table._dev_index = dev
        for _ in range(2):
            tr.train_pass_resident(_port_dataset(arrs))
    assert tix.DISPATCH[("index.assign", "host")] - before == 2
    assert dev.degraded and "overflow" in dev.degrade_reason
    assert dev.next_row == 0 and (dev.rows == -1).all()
    assert any("degraded" in r.getMessage() for r in caplog.records)
    _assert_same_state(_state(ref), _state(tr))
    assert _kv_map(ref.table.index) == _kv_map(tr.table.index)


def test_chunked_run_equals_whole_pass():
    arrs, params = _arrays(seed=3), _params0()
    out = []
    for chunk in (None, 3):
        tr = _port_trainer(params)
        rp = ResidentPass.build(_port_dataset(arrs), tr.table)
        runner = ResidentPassRunner(tr.step_fn, rp.segs is None)
        losses = runner.run_pass(tr.state, rp, tr.seed, 0, chunk=chunk)
        assert len(losses) == rp.num_batches == 5
        out.append(_state(tr))
    _assert_same_state(*out)


def test_bulk_assign_device_equals_host_and_serial():
    arrs = _arrays(seed=4)
    builds = {}
    for name, flags in (("device", dict(use_pallas_index=True)),
                        ("host", dict(use_pallas_index=False)),
                        ("serial", dict(bulk_pass_assign=False))):
        table = _port_table()
        with flags_scope(**flags):
            rp = ResidentPass.build(_port_dataset(arrs), table)
        builds[name] = (rp, table)
    rp0, t0 = builds["host"]
    assert rp0.segs is not None and rp0.num_batches == 5
    assert set(rp0.build_stats) >= {"front", "dedup", "pack"}
    for name in ("device", "serial"):
        rp, table = builds[name]
        for a in ("uniq", "gidx", "meta", "segs", "floats"):
            np.testing.assert_array_equal(getattr(rp, a), getattr(rp0, a),
                                          err_msg=f"{name}: {a}")
        assert _kv_map(table.index) == _kv_map(t0.index), name
        np.testing.assert_array_equal(table.slot_host, t0.slot_host)
    # each batch's wire decodes every key to the row the index holds
    for i, b in enumerate(_port_dataset(arrs).batches()):
        nk = b.num_keys
        np.testing.assert_array_equal(rp0.uniq[i][rp0.gidx[i][:nk]],
                                      t0.index.lookup(b.keys[:nk]))
    assert builds["device"][1].last_assign_seconds["index_device"] > 0
    # the device route mirrors the kv exactly; a table load drops it
    dev = builds["device"][1]._dev_index
    keys, rows = builds["device"][1].index.items()
    np.testing.assert_array_equal(dev.lookup_rows(keys), rows)
    assert dev.next_row == len(keys)
    table = builds["device"][1]
    table.load({"keys": keys[:3], **{f: v[:3] for f, v in
                                     table._gather_host(rows).items()}})
    assert table._dev_index is None


def test_upload_stages_four_arrays_once():
    """``upload`` stages the reference's packed wire (the unpacked
    four-array staging this test once pinned is gone; the name stays):
    every staged block equals the JAX ``ResidentPass.upload`` leaf byte
    for byte (uint16 blocks ride as their int16 view; the port keeps
    ``meta`` on the host and stages no dummy for the trivial segments or
    the absent qmeta), ``nbytes()`` is the staged blocks' sum and below
    the host int32/f32 bytes, and a second ``upload`` is a no-op."""
    from paddlebox_tpu.train.device_pass import ResidentPass as JPass
    arrs = _arrays(seed=5)
    tr = _port_trainer(_params0())
    rp = ResidentPass.build(_port_dataset(arrs), tr.table)
    host_bytes = rp.nbytes()
    rp.upload(torch.device("cpu"))
    staged = rp.dev
    jdesc = JDesc(slots=_slots(JSlotDef), label_slot="label",
                  batch_size=BS, key_bucket_min=512)
    jds = JDataset(jdesc)
    jds.records = [JRecord(k, o, d, l, 1.0, l) for k, o, d, l in arrs]
    jrp = JPass.build(jds, JTable(mf_dim=MF, capacity=CAP, cfg=JCfg(**CFG),
                                  unique_bucket_min=512))
    jrp.upload()
    juniq, jgidx, jfloats, jmeta, jsegs, _ = jrp.dev
    np.testing.assert_array_equal(rp.meta, np.asarray(jmeta))
    pairs = (list(zip(staged[0], juniq)) + list(zip(staged[1], jgidx))
             + [(staged[2], jfloats)] + list(zip(staged[3], jsegs)))
    assert len(pairs) == len(juniq) + len(jgidx) + 1 + len(jsegs)
    for got, want in pairs:
        want = np.asarray(want)
        got = got.numpy()
        assert got.shape == want.shape
        np.testing.assert_array_equal(got.view(want.dtype), want)
    assert rp.formats == {"uniq": "d8", "gidx": "u18", "segs": "grid",
                          "floats": "f32"}
    assert rp.nbytes() == sum(t.numel() * t.element_size()
                              for grp in (staged[0], staged[1], staged[3])
                              for t in grp) + staged[2].nbytes
    assert rp.nbytes() < host_bytes and "h2d" in rp.build_stats
    rp.upload(torch.device("cpu"))
    assert rp.dev is staged
    assert rp.unique_capacity % 512 == 0 and rp.key_capacity >= 512
