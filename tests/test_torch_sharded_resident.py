"""The port's sharded resident pass (``ShardedResidentPass``,
``ShardedTrainStep.run_resident``, ``ShardedTrainer.train_pass_resident``)
against the JAX package's, on the CPU (the reference on a 4-device slice
of its 8-device CPU mesh, N = 4), and against the port's own streaming
``train_pass``.

Tolerances as in ``tests/test_torch_sharded.py``: the staged wire, the
forced-width plans, row assignment, show/clk and slot exact; the port's
resident pass against its streaming pass (and chunked against monolithic,
depth 2 against depth 0) exact by ``sharded_state_digest``; training
against the reference in the ragged train-state class, rtol 2e-4 / atol
2e-5, the AUC within 1e-5. Lazy mf draws zeros on both sides
(``mf_initial_range`` 0).
"""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from paddlebox_tpu.config import flags_scope as j_flags_scope
from paddlebox_tpu.data.batch import SlotBatch as JSlotBatch
from paddlebox_tpu.models import DeepFM as JDeepFM
from paddlebox_tpu.parallel import make_mesh
from paddlebox_tpu.ps import SparseSGDConfig as JCfg
from paddlebox_tpu.ps.sharded import ShardedEmbeddingTable as JSharded
from paddlebox_tpu.train.sharded import ShardedTrainer as JShardedTrainer

from paddlebox_tpu_torch import convert
from paddlebox_tpu_torch.data.batch import SlotBatch
from paddlebox_tpu_torch.ops import bitpack as bp
from paddlebox_tpu_torch.ps.sgd import SparseSGDConfig
from paddlebox_tpu_torch.ps.sharded import ShardedEmbeddingTable
from paddlebox_tpu_torch.train.checkpoint import sharded_state_digest
from paddlebox_tpu_torch.train.device_pass import PassPreloader
from paddlebox_tpu_torch.train.sharded import ShardedResidentPass

from test_torch_sharded import (BS, CAP, CFG, DENSE, MF, S, STATE_ATOL,
                                STATE_RTOL, TABLE_KW, _arrays, _base_blob,
                                _datasets, _descs, _jax_logical,
                                _port_logical, _port_trainer)

N = 4


def _trivial_arrays(n, seed):
    """Records with one key in every slot (the trivial segment layout)."""
    rng = np.random.default_rng(seed)
    offs = np.arange(S + 1, dtype=np.int32)
    return [((np.arange(S) * 1000 + rng.integers(0, 60, size=S)
              ).astype(np.uint64), offs,
             rng.normal(size=DENSE).astype(np.float32),
             float(rng.random() < 0.3)) for _ in range(n)]


DATA = {"trivial": lambda: _trivial_arrays(BS * 10 + 7, seed=41),
        "ragged": lambda: _arrays(BS * 10 + 7, seed=43)}


def _base(seed=2):
    """A seeded sharded save of slot-qualified keys (a third without mf)."""
    rng = np.random.default_rng(seed)
    keys = np.unique(np.concatenate([
        s * 1000 + rng.choice(300, size=120, replace=False)
        for s in range(S)])).astype(np.uint64)
    rows = np.zeros((len(keys), 8 + MF), np.float32)
    rows[:, 0] = rng.integers(1, 50, size=len(keys))
    rows[:, 1] = np.floor(rows[:, 0] * rng.random(len(keys)) * 0.3)
    rows[:, 3] = (keys // np.uint64(1000)).astype(np.float32)
    rows[:, 4] = rng.normal(0, 0.05, size=len(keys))
    rows[:, 5:7] = 3.0
    rows[:, 7] = (rng.random(len(keys)) >= 0.3).astype(np.float32)
    rows[:, 8:] = rng.normal(0, 0.05, size=(len(keys), MF)) * rows[:, 7:8]
    return convert.table_rows_from_logical(keys, rows, MF)


def _jax_trainer(tmp, chunks=1, wire="f32"):
    table = JSharded(N, mf_dim=MF, capacity_per_shard=CAP, cfg=JCfg(**CFG),
                     **TABLE_KW)
    path = str(tmp / f"base_{chunks}_{wire}.npz")
    np.savez(path, **_base())
    table.load(path)
    with j_flags_scope(a2a_chunks=chunks):
        tr = JShardedTrainer(JDeepFM(hidden=(16, 8), compute_dtype=jnp.float32),
                             table, _descs()[0], make_mesh(N),
                             tx=optax.adam(1e-2), seed=3, float_wire=wire)
    start = dict(
        params=convert.deepfm_state_dict_from_flax(
            jax.device_get(tr.state.params)),
        table=convert.sharded_table_from_packed(
            jax.device_get(table.state.packed),
            [table.indexes[s].items() for s in range(N)], CAP, MF))
    return tr, start


def _snap_jax(tr, res):
    keys, rows = _jax_logical(tr.table)
    return dict(res=res, keys=keys, rows=rows,
                params=convert.deepfm_state_dict_from_flax(
                    jax.device_get(tr.state.params)))


@pytest.fixture(scope="module")
def jax_resident(tmp_path_factory):
    """The reference's resident passes: per case its converted start, and
    after each pass its results, logical rows and dense params."""
    tmp = tmp_path_factory.mktemp("jres")
    out = {}
    cases = {"trivial": ("trivial", 1, "f32", 2),
             "ragged": ("ragged", 1, "f32", 1),
             "chunked": ("ragged", 4, "f32", 1),
             "q8": ("trivial", 1, "q8", 1)}
    for name, (data, chunks, wire, passes) in cases.items():
        jds, _ = _datasets(DATA[data]())
        tr, start = _jax_trainer(tmp, chunks, wire)
        snaps = []
        with j_flags_scope(a2a_chunks=chunks):
            for _ in range(passes):
                snaps.append(_snap_jax(tr, tr.train_pass_resident(jds)))
        out[name] = dict(start=start, snaps=snaps)
    return out


def _assert_matches(tr, res, want):
    keys, rows = _port_logical(tr.table)
    np.testing.assert_array_equal(keys, want["keys"])
    # show, clk and slot exact; the rest in the train-state class
    np.testing.assert_array_equal(rows[:, [0, 1, 3]], want["rows"][:, [0, 1, 3]])
    np.testing.assert_allclose(rows, want["rows"], rtol=STATE_RTOL,
                               atol=STATE_ATOL)
    sd = tr.model.state_dict()
    for k, w in want["params"].items():
        np.testing.assert_allclose(sd[k].numpy(), w.numpy(), rtol=STATE_RTOL,
                                   atol=STATE_ATOL, err_msg=k)
    assert res["batches"] == want["res"]["batches"]
    assert res["ins_num"] == want["res"]["ins_num"]
    np.testing.assert_allclose(res["auc"], want["res"]["auc"], rtol=0,
                               atol=1e-5)


@pytest.fixture(autouse=True)
def _one_thread():
    # the CPU's accumulating index_put_ sums in key order on one thread,
    # which the bitwise digest comparisons rely on
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# the reference's resident tests
# ---------------------------------------------------------------------------

def test_sharded_resident_matches_streaming(jax_resident):
    """Trivial segments (one key a slot): the resident pass equals the
    port's streaming pass bit for bit and the reference's resident pass
    in the train-state class."""
    j = jax_resident["trivial"]
    _, tds = _datasets(DATA["trivial"]())
    res = _port_trainer(j["start"])
    r = res.train_pass_resident(tds)
    _assert_matches(res, r, j["snaps"][0])
    stream = _port_trainer(j["start"])
    rs = stream.train_pass(tds)
    assert sharded_state_digest(res) == sharded_state_digest(stream)
    assert (r["auc"], r["examples"], r["last_loss"]) == (
        rs["auc"], rs["examples"], rs["last_loss"])
    # a second resident pass continues from the first
    res.reset_metrics()
    r2 = res.train_pass_resident(tds)
    assert np.isfinite(r2["last_loss"]) and r2["batches"] == 3


def test_sharded_resident_non_trivial_segments(jax_resident):
    """Multi-key slots: the wire ships a segment stream; resident ==
    streaming exactly, and the reference's resident pass in class."""
    j = jax_resident["ragged"]
    _, tds = _datasets(DATA["ragged"]())
    res = _port_trainer(j["start"])
    rp = res.build_resident_pass(tds)
    assert rp.fmt["segments"] != "trivial"
    r = res.train_pass_resident(rp)
    _assert_matches(res, r, j["snaps"][0])
    stream = _port_trainer(j["start"])
    stream.train_pass(tds)
    assert sharded_state_digest(res) == sharded_state_digest(stream)


@pytest.mark.parametrize("zero1", [False, True])
def test_a2a_chunked_resident_digest_parity(jax_resident, zero1):
    """The chunked resident pass (uniform forced sections) equals the
    monolithic resident pass and the chunked streaming pass bit for bit,
    and the reference's chunked resident pass in class."""
    j = jax_resident["chunked"]
    _, tds = _datasets(DATA["ragged"]())
    digests = []
    for chunks, resident in ((4, True), (1, True), (4, False)):
        tr = _port_trainer(j["start"], chunks=chunks, zero1=zero1)
        if resident:
            rp = tr.build_resident_pass(tds)
            assert bool(rp.sections) == (chunks > 1)
            r = tr.train_pass_resident(rp)
            if chunks > 1:
                assert r["chunked_batches"] == r["batches"] == 3
                if not zero1:
                    _assert_matches(tr, r, j["snaps"][0])
        else:
            tr.train_pass(tds)
        digests.append(sharded_state_digest(tr))
    assert digests[0] == digests[1] == digests[2]


def test_sharded_pass_preloader(jax_resident):
    """Two passes through a depth-2 ``PassPreloader(build_fn=...)`` equal
    depth 0 bit for bit, and the reference's two resident passes in
    class."""
    j = jax_resident["trivial"]
    _, tds = _datasets(DATA["trivial"]())
    digests, results = [], []
    for depth in (2, 0):
        tr = _port_trainer(j["start"])
        pre = PassPreloader(iter([tds, tds]), build_fn=tr.build_resident_pass,
                            depth=depth, device="cpu")
        pre.start_next()
        res = []
        while True:
            rp = pre.wait()
            if rp is None:
                break
            assert isinstance(rp, ShardedResidentPass) and rp.dev is not None
            more = pre.start_next()
            res.append(tr.train_pass_resident(rp))
            if not more:
                break
        pre.drain()
        assert len(res) == 2 and pre.builds == 2
        assert set(pre.build_stage_sec) >= {"plans", "repad", "encode", "h2d"}
        digests.append(sharded_state_digest(tr))
        results.append(res)
    assert digests[0] == digests[1]
    _assert_matches(tr, results[1][1], j["snaps"][1])


def test_sharded_resident_q8_wire_learns(jax_resident):
    """The q8 float wire trains: its AUC stays within 5e-3 of the f32
    wire's over three passes (the reference's gate), and its first pass
    matches the reference's q8 pass in class."""
    j = jax_resident["q8"]
    _, tds = _datasets(DATA["trivial"]())
    q8 = _port_trainer(j["start"], float_wire="q8")
    rp = q8.build_resident_pass(tds)
    assert rp.fmt["dense"] == "q8" and rp.fmt["label"] == "u8"
    r = q8.train_pass_resident(rp)
    _assert_matches(q8, r, j["snaps"][0])
    f32 = _port_trainer(j["start"])
    for _ in range(2):
        rq = q8.train_pass_resident(tds)
    for _ in range(3):
        rf = f32.train_pass_resident(tds)
    assert rq["batches"] == rf["batches"]
    assert abs(rq["auc"] - rf["auc"]) < 5e-3, (rq["auc"], rf["auc"])


def _make_batches(n, bs=8, slots=3, k_pad=32, seed=0):
    """The reference test's local batches: random keys over a shared key
    space (not slot-qualified), in both packages' SlotBatch."""
    rng = np.random.default_rng(seed)
    jout, tout = [], []
    for _ in range(n):
        nk = int(rng.integers(slots, k_pad // 2))
        kp = np.zeros(k_pad, np.uint64)
        kp[:nk] = rng.integers(1, 500, size=nk)
        segs = np.full(k_pad, bs * slots, np.int32)
        segs[:nk] = np.sort(rng.integers(0, bs * slots, size=nk))
        kw = dict(keys=kp, segments=segs, num_keys=nk,
                  dense=rng.normal(size=(bs, 4)).astype(np.float32),
                  label=rng.integers(0, 2, bs).astype(np.float32),
                  show=np.ones(bs, np.float32),
                  clk=rng.integers(0, 2, bs).astype(np.float32),
                  batch_size=bs, num_slots=slots)
        jout.append(JSlotBatch(**{k: np.copy(v) if isinstance(v, np.ndarray)
                                  else v for k, v in kw.items()}))
        tout.append(SlotBatch(**kw))
    return jout, tout


def test_repad_plan_equals_reroute():
    """``_repad_plan`` (array surgery) equals the plan ``prepare_global``
    builds with the same forced widths, shrinking and growing, and the
    reference's forced plan; an exactly full request bucket refuses."""
    n = 8
    fields = ("resp_idx", "serve_rows", "serve_valid", "serve_slot",
              "gather_idx")
    cfg = dict(mf_create_thresholds=1e9)
    for forced_a, forced_a2 in ((24, 40), (96, 104)):
        table = ShardedEmbeddingTable(n, mf_dim=4, capacity_per_shard=256,
                                      cfg=SparseSGDConfig(**cfg),
                                      req_bucket_min=64, serve_bucket_min=64,
                                      devices="cpu")
        jtable = JSharded(n, mf_dim=4, capacity_per_shard=256,
                          cfg=JCfg(**cfg), req_bucket_min=64,
                          serve_bucket_min=64)
        jb, tb = _make_batches(n, seed=51)
        p1 = table.prepare_global(tb)
        jtable.prepare_global(jb)
        forced_a = max(forced_a, p1.req_need)
        forced_a2 = max(forced_a2, p1.serve_need)
        got = ShardedResidentPass._repad_plan(p1, forced_a, forced_a2, n,
                                              table.capacity)
        assert got is not None
        want = table.prepare_global(tb, req_capacity=forced_a,
                                    serve_capacity=forced_a2)
        jwant = jtable.prepare_global(jb, req_capacity=forced_a,
                                      serve_capacity=forced_a2)
        for f in fields:
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                          err_msg=f)
            np.testing.assert_array_equal(getattr(got, f), getattr(jwant, f),
                                          err_msg=f)
        assert got.req_capacity == want.req_capacity == forced_a
        assert got.serve_capacity == want.serve_capacity == forced_a2
    full = p1._replace(req_need=p1.req_capacity)
    assert ShardedResidentPass._repad_plan(
        full, p1.req_capacity + 512, p1.serve_capacity, n,
        table.capacity) is None


# ---------------------------------------------------------------------------
# the staged wire, byte for byte
# ---------------------------------------------------------------------------

WIRE_CASES = {"trivial": ("trivial", 1, "f32"),
              "ragged": ("ragged", 1, "f32"),
              "chunked": ("ragged", 4, "f32"),
              "q8": ("trivial", 1, "q8"),
              "ragged_q8": ("ragged", 1, "q8")}


@pytest.mark.parametrize("case", sorted(WIRE_CASES))
def test_wire_matches_jax_bytes(case, tmp_path):
    """The port's ``fmt`` and every host array of ``wire`` equal the
    reference ``ShardedResidentPass``'s, built over the same batches from
    the same table; then staged, every block's bytes are the wire's."""
    data, chunks, wire = WIRE_CASES[case]
    jds, tds = _datasets(DATA[data]())
    jtr, start = _jax_trainer(tmp_path, chunks, wire)
    with j_flags_scope(a2a_chunks=chunks):
        jrp = jtr.build_resident_pass(jds)
    tr = _port_trainer(start, chunks=chunks, float_wire=wire)
    rp = tr.build_resident_pass(tds)
    assert rp.fmt == jrp.fmt
    assert rp.sections == tuple(jrp.sections)
    assert set(rp.wire) == set(jrp.wire)
    for name, arrs in jrp.wire.items():
        assert len(rp.wire[name]) == len(arrs), name
        for got, want in zip(rp.wire[name], arrs):
            assert got.dtype == want.dtype and got.shape == want.shape, name
            assert got.tobytes() == np.asarray(want).tobytes(), name
    assert rp.num_records == jrp.num_records
    rp.upload()
    for name, blocks in rp.dev.items():
        for s, block in enumerate(blocks):
            for t, host in zip(block, rp.wire[name]):
                want = host if name == "qmeta" else host[:, s]
                assert t.numpy().tobytes() == bp.as_wire(
                    np.ascontiguousarray(want)).tobytes(), (name, s)
    assert rp.nbytes() == sum(t.numel() * t.element_size()
                              for s in range(N) for t in rp._leaves(s))


def test_decode_equals_streaming_batch():
    """Each step's decoded ``GlobalBatch`` equals the streaming path's
    staged batch of the same plan (repadded to the pass's widths)."""
    from paddlebox_tpu_torch.train.sharded import (_decode_wire_step,
                                                   make_global_batch)
    _, tds = _datasets(DATA["ragged"]())
    tr = _port_trainer({"table": _base_blob(seed=2),
                        "params": _port_trainer_params()})
    rp = tr.build_resident_pass(tds)
    rp.upload()
    groups = list(tr._group_iter(tds.batches()))
    for i, g in enumerate(groups):
        gb = _decode_wire_step(rp, i)
        plan = tr.table.prepare_global(
            g, req_capacity=gb.resp_idx[0].shape[1],
            serve_capacity=gb.serve_rows[0].shape[0])
        want = make_global_batch(g, plan, tr.devices)
        assert gb.key_counts == want.key_counts
        assert gb.serve_counts == want.serve_counts
        for f in ("resp_idx", "serve_valid", "serve_slot", "live",
                  "floats"):
            for s in range(N):
                assert torch.equal(getattr(gb, f)[s], getattr(want, f)[s]), f
        for s in range(N):
            # the real rows exact; the pads (regenerated from the count,
            # as the reference's decode does) distinct and out of bounds
            u = gb.serve_counts[s]
            assert torch.equal(gb.serve_rows[s][:u], want.serve_rows[s][:u])
            pads = gb.serve_rows[s][u:]
            assert bool((pads > CAP).all())
            assert len(torch.unique(pads)) == len(pads)
            nk = gb.key_counts[s][0]
            for f in ("gather_idx", "segments"):
                assert torch.equal(getattr(gb, f)[s][:nk],
                                   getattr(want, f)[s][:nk]), f


def _port_trainer_params():
    from paddlebox_tpu_torch import DeepFM
    torch.manual_seed(0)
    return DeepFM(S, 3 + MF, DENSE, hidden=(16, 8),
                  compute_dtype=torch.float32).state_dict()


def test_forced_width_below_need_raises():
    table = ShardedEmbeddingTable(N, mf_dim=MF, capacity_per_shard=CAP,
                                  cfg=SparseSGDConfig(**CFG), devices="cpu",
                                  **TABLE_KW)
    _, tds = _datasets(DATA["ragged"]())
    group = list(tds.batches())[:N]
    p = table.prepare_global(group)
    with pytest.raises(ValueError, match="req_capacity"):
        table.prepare_global(group, req_capacity=p.req_need - 1)
    with pytest.raises(ValueError, match="serve_capacity"):
        table.prepare_global_eval(group, serve_capacity=p.serve_need - 1)
    ok = table.prepare_global(group, req_capacity=p.req_need,
                              serve_capacity=p.serve_need)
    assert (ok.req_capacity, ok.serve_capacity) == (p.req_need, p.serve_need)
    g = table.prepare_global(group, groups=2)
    with pytest.raises(ValueError, match="req_sections"):
        table.prepare_global(group, groups=2,
                             req_sections=(1,) * len(g.a2a_sections))
    with pytest.raises(ValueError, match="key_sections"):
        table.prepare_global(group, groups=2, req_sections=g.a2a_sections,
                             key_sections=(1,) * len(g.key_sections))


def test_tiered_hooks_raise():
    """``build_resident_pass`` brackets the build in a table's
    ``plan_scope`` and then runs its ``prefetch_promote`` over the pass's
    keys when the table has spilled rows (the tiered store's hooks); a
    build that raises inside the scope raises through it, and the
    promote is skipped."""
    import contextlib
    _, tds = _datasets(DATA["trivial"]())
    tr = _port_trainer({"table": _base(), "params": _port_trainer_params()})
    calls = []

    @contextlib.contextmanager
    def scope():
        calls.append("enter")
        try:
            yield
        except BaseException:
            calls.append("rollback")
            raise
        calls.append("exit")

    tr.table.plan_scope = scope
    tr.table.has_spilled_rows = lambda: True
    tr.table.prefetch_promote = lambda keys: calls.append(len(keys))
    tr.build_resident_pass(tds)
    assert calls == ["enter", "exit", len(tds.pass_keys())]
    calls.clear()
    tr.table.prepare_global = lambda *a, **k: 1 / 0
    with pytest.raises(ZeroDivisionError):
        tr.build_resident_pass(tds)
    assert calls == ["enter", "rollback"]


def test_train_multichip_walkthrough(tmp_path):
    """The sharded walkthrough at a small size on the CPU: ZeRO-1
    resident passes over 4 shards, the AUC improving, the base saved."""
    from paddlebox_tpu_torch.examples import train_multichip
    out = train_multichip.main(["--devices", "cpu", "--rows", "2000",
                                "--passes", "2", "--workdir",
                                str(tmp_path)])
    first, last = out["passes"]
    assert first["batches"] == last["batches"] > 0
    assert last["auc"] > first["auc"] and out["saved_rows"] > 0
    assert (tmp_path / "sharded_base.npz").exists()
