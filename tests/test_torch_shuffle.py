"""The port's TCP global shuffle and host collective
(``paddlebox_tpu_torch/distributed/shuffle.py``, ``collective.py``)
against the reference's: the cases of ``tests/test_shuffle.py`` on the
port, the record wire byte for byte both ways, a mesh whose rank 0 is
the JAX package's ``TcpShuffler`` and rank 1 the port's, and the AUC
allreduce on two ranks. Every listener binds port 0 (the OS picks)."""

import threading
import time

import numpy as np
import pytest
import torch

from paddlebox_tpu.data.record import SlotRecord as JSlotRecord
from paddlebox_tpu.distributed import collective as jcollective
from paddlebox_tpu.distributed import shuffle as jshuffle
from paddlebox_tpu import metrics as jmetrics

from paddlebox_tpu_torch import metrics as tmetrics
from paddlebox_tpu_torch.data import InMemoryDataset
from paddlebox_tpu_torch.data.record import SlotRecord
from paddlebox_tpu_torch.data.schema import DataFeedDesc
from paddlebox_tpu_torch.distributed import shuffle as tshuffle
from paddlebox_tpu_torch.distributed import (TcpCollective, TcpShuffler,
                                             default_route,
                                             deserialize_records,
                                             serialize_records)


def rec(i: int, uid: int = 0, ins: str = "", cls=SlotRecord):
    return cls(
        keys=np.array([i, i + 100], np.uint64),
        slot_offsets=np.array([0, 1, 2], np.int32),
        dense=np.array([i * 0.5, 1.0], np.float32),
        label=float(i % 2), show=1.0, clk=float(i % 2),
        ins_id=ins, uid=uid, search_id=i, timestamp=1000 + i,
        rank=i % 3, cmatch=222)


def _mixed_records(cls=SlotRecord):
    """uid-routed, ins_id-routed and content-routed records, an empty
    one among them."""
    out = [rec(i, uid=i * 7, ins=f"ins{i}", cls=cls) for i in range(5)]
    out += [rec(i, ins=f"only-ins-{i}", cls=cls) for i in range(5, 9)]
    out += [rec(i, cls=cls) for i in range(9, 14)]
    out.append(cls(keys=np.empty(0, np.uint64),
                   slot_offsets=np.array([0], np.int32),
                   dense=np.empty(0, np.float32)))
    return out


def _run_ranks(fns, timeout=60.0):
    out, errs = {}, []

    def runner(i, fn):
        try:
            out[i] = fn()
        except BaseException as e:  # surfaced below
            errs.append(e)

    ts = [threading.Thread(target=runner, args=(i, fn), daemon=True)
          for i, fn in enumerate(fns)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout)
    assert not any(t.is_alive() for t in ts), "mesh round deadlocked"
    if errs:
        raise errs[0]
    return [out[i] for i in range(len(fns))]


def _wire(meshes):
    """Point every mesh at the ports the OS gave the others."""
    eps = [("127.0.0.1", m.bound_port) for m in meshes]
    for m in meshes:
        m.endpoints = eps
    return meshes


def _mk_shufflers(world, classes=None):
    classes = classes or [TcpShuffler] * world
    return _wire([cls(r, world, ["127.0.0.1:0"] * world, seed=3)
                  for r, cls in enumerate(classes)])


# ---- the cases of tests/test_shuffle.py -------------------------------

def test_serialize_roundtrip():
    recs = [rec(i, uid=i * 7, ins=f"ins{i}") for i in range(5)]
    recs.append(SlotRecord(keys=np.empty(0, np.uint64),
                           slot_offsets=np.array([0], np.int32),
                           dense=np.empty(0, np.float32)))
    out = deserialize_records(serialize_records(recs))
    assert len(out) == 6
    for a, b in zip(recs, out):
        assert isinstance(b, SlotRecord)
        np.testing.assert_array_equal(a.keys, b.keys)
        np.testing.assert_array_equal(a.slot_offsets, b.slot_offsets)
        np.testing.assert_allclose(a.dense, b.dense)
        assert (a.label, a.show, a.clk) == (b.label, b.show, b.clk)
        assert (a.ins_id, a.uid, a.search_id) == (b.ins_id, b.uid,
                                                  b.search_id)
        assert (a.timestamp, a.rank, a.cmatch) == (b.timestamp, b.rank,
                                                   b.cmatch)


def test_route_deterministic_and_uid_sticky():
    a, b = rec(1, uid=42), rec(2, uid=42)
    assert default_route(a, 4, 0) == default_route(b, 4, 0)
    c = rec(3, ins="same"), rec(4, ins="same")
    assert default_route(c[0], 4, 7) == default_route(c[1], 4, 7)
    # seed changes placement for at least some records
    recs = [rec(i, uid=i) for i in range(64)]
    r0 = [default_route(r, 4, 0) for r in recs]
    r1 = [default_route(r, 4, 1) for r in recs]
    assert r0 != r1


def test_tcp_exchange_three_ranks():
    world = 3
    shs = _mk_shufflers(world)
    per_rank = [[rec(100 * r + i, uid=100 * r + i) for i in range(40)]
                for r in range(world)]
    try:
        results = _run_ranks([
            (lambda r=r: shs[r].exchange(list(per_rank[r])))
            for r in range(world)])
    finally:
        for s in shs:
            s.close()
    # every record landed exactly once, on the rank its hash names
    seen = {}
    for r in range(world):
        for x in results[r]:
            assert default_route(x, world, 3) == r
            key = int(x.search_id)
            assert key not in seen
            seen[key] = r
    assert len(seen) == world * 40


def test_tcp_exchange_rounds_without_barrier():
    """A fast rank may enter round r+1 while a slow peer still collects
    round r — the early payload must be buffered, not fatal."""
    world = 3
    shs = _mk_shufflers(world)
    totals = [0] * world

    def run(r):
        for rnd in range(3):
            if r == 2 and rnd == 0:
                time.sleep(0.3)  # rank 2 lags; 0/1 finish + advance
            out = shs[r].exchange(
                [rec(10_000 * rnd + 100 * r + i, uid=100 * r + i)
                 for i in range(30)])
            totals[r] += len(out)

    try:
        _run_ranks([(lambda r=r: run(r)) for r in range(world)])
    finally:
        for s in shs:
            s.close()
    assert sum(totals) == 3 * world * 30


def test_tcp_exchange_two_rounds_reuse():
    world = 2
    shs = _mk_shufflers(world)
    try:
        for rnd in range(2):
            results = _run_ranks([
                (lambda r=r: shs[r].exchange(
                    [rec(1000 * rnd + 10 * r + i, uid=i)
                     for i in range(10)]))
                for r in range(world)])
            assert sum(len(x) for x in results) == 20
    finally:
        for s in shs:
            s.close()


# ---- against the reference --------------------------------------------

def test_record_wire_byte_for_byte_both_ways():
    """The port's buffer equals the reference's on the same records, and
    each package reads the other's buffer back to the same records."""
    mine = _mixed_records()
    theirs = _mixed_records(JSlotRecord)
    buf = serialize_records(mine)
    assert buf == jshuffle.serialize_records(theirs)
    assert tshuffle._REC_HDR.format == jshuffle._REC_HDR.format
    back_j = jshuffle.deserialize_records(buf)
    back_t = deserialize_records(jshuffle.serialize_records(theirs))
    assert all(isinstance(r, JSlotRecord) for r in back_j)
    assert all(isinstance(r, SlotRecord) for r in back_t)
    assert jshuffle.serialize_records(back_j) == buf
    assert serialize_records(back_t) == buf


@pytest.mark.parametrize("world,seed", [(2, 0), (3, 3), (4, 11)])
def test_default_route_equals_reference(world, seed):
    for r, j in zip(_mixed_records(), _mixed_records(JSlotRecord)):
        assert default_route(r, world, seed) == \
            jshuffle.default_route(j, world, seed)


def _exchange_all(shs, per_rank):
    try:
        return _run_ranks([(lambda r=r: shs[r].exchange(list(per_rank[r])))
                           for r in range(len(shs))])
    finally:
        for s in shs:
            s.close()


def test_mixed_package_mesh_matches_all_port_mesh():
    """Rank 0 is the JAX package's ``TcpShuffler``, rank 1 the port's:
    each rank ends with the records (in order) that an all-port mesh
    gives it."""
    world = 2
    per_rank = [[rec(100 * r + i, uid=(100 * r + i) * (i % 2),
                     ins=f"r{r}-{i}") for i in range(50)]
                for r in range(world)]
    want = _exchange_all(_mk_shufflers(world), per_rank)
    got = _exchange_all(_mk_shufflers(world, [jshuffle.TcpShuffler,
                                              TcpShuffler]), per_rank)
    assert isinstance(got[1][0], SlotRecord)
    for r in range(world):
        assert serialize_records(got[r]) == serialize_records(want[r])
        assert {default_route(x, world, 3) for x in got[r]} == {r}
    assert sum(len(x) for x in got) == world * 50


def test_global_shuffle_through_the_tcp_shuffler():
    """``InMemoryDataset.global_shuffle(shuffler)`` on two ranks: each
    keeps exactly its routed records, the union is the input."""
    world = 2
    desc = DataFeedDesc.criteo(batch_size=8)
    shs = _mk_shufflers(world)
    dss = []
    for r in range(world):
        ds = InMemoryDataset(desc)
        ds.records = [rec(100 * r + i, uid=100 * r + i) for i in range(30)]
        dss.append(ds)
    everything = sorted(serialize_records([x]) for d in dss
                        for x in d.records)
    try:
        _run_ranks([(lambda r=r: dss[r].global_shuffle(shs[r], seed=1))
                    for r in range(world)])
    finally:
        for s in shs:
            s.close()
    for r in range(world):
        assert all(default_route(x, world, 3) == r for x in dss[r].records)
    assert sorted(serialize_records([x]) for d in dss
                  for x in d.records) == everything


def _auc_parts(seed: int):
    """Two workers' AUC tables from seeded predictions, as host arrays
    (pos, neg, abs_err, sqr_err, pred_sum, label_sum, ins_num)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(2):
        st = tmetrics.init_auc_state(1000, device="cpu")
        pred = rng.random(300).astype(np.float32)
        label = (rng.random(300) < pred).astype(np.float32)
        w = (rng.random(300) < 0.9).astype(np.float32)
        tmetrics.auc_add_batch(st, *(torch.from_numpy(x)
                                     for x in (pred, label, w)))
        b, s = st.buckets.numpy(), st.sums.numpy()
        out.append((b[0], b[1], *s))
    return out


def test_collective_allreduce_and_global_auc_equal_reference():
    """``TcpCollective.allreduce_sum`` on two ranks is the f64 sum in
    rank order, the same on both; ``auc_compute_global`` over it equals
    the reference's over its own collective, bit for bit."""
    parts = _auc_parts(5)

    def port_state(p):
        return tmetrics.AucState(torch.from_numpy(np.stack([p[0], p[1]])),
                                 torch.from_numpy(np.array(p[2:],
                                                           np.float32)))

    def ref_state(p):
        import jax.numpy as jnp
        return jmetrics.AucState(*(jnp.asarray(x) for x in p))

    cols = _wire([TcpCollective(r, 2, ["127.0.0.1:0"] * 2)
                  for r in range(2)])
    try:
        sums = _run_ranks([(lambda r=r: cols[r].allreduce_sum(
            [np.stack([parts[r][0], parts[r][1]]),
             np.array(parts[r][2:], np.float32)])) for r in range(2)])
        got = _run_ranks([(lambda r=r: tmetrics.auc_compute_global(
            port_state(parts[r]), cols[r])) for r in range(2)])
    finally:
        for c in cols:
            c.close()
    for a, b in zip(sums[0], sums[1]):
        assert a.dtype == np.float64 and np.array_equal(a, b)
    f64 = [np.stack([parts[0][0], parts[0][1]]).astype(np.float64)
           + np.stack([parts[1][0], parts[1][1]]),
           np.array(parts[0][2:], np.float64) + np.array(parts[1][2:])]
    assert all(np.array_equal(a, b) for a, b in zip(sums[0], f64))
    assert got[0] == got[1]
    assert got[0] == tmetrics.auc_compute(tmetrics.AucState(
        torch.from_numpy(f64[0]), torch.from_numpy(f64[1])))

    jcols = _wire([jcollective.TcpCollective(r, 2, ["127.0.0.1:0"] * 2)
                   for r in range(2)])
    try:
        want = _run_ranks([(lambda r=r: jmetrics.auc_compute_global(
            ref_state(parts[r]), jcols[r])) for r in range(2)])
    finally:
        for c in jcols:
            c.close()
    assert got[0].as_dict() == want[0].as_dict() == want[1].as_dict()


def test_collective_shape_mismatch_raises():
    cols = _wire([TcpCollective(r, 2, ["127.0.0.1:0"] * 2)
                  for r in range(2)])
    try:
        with pytest.raises(ValueError, match="shape mismatch"):
            _run_ranks([(lambda r=r: cols[r].allreduce_sum(
                [np.zeros(3 + r)])) for r in range(2)])
    finally:
        for c in cols:
            c.close()
