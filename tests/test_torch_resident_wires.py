"""The resident pass's wires, fronts and arena table in the port
(``ops/bitpack.py``, ``train/step.py`` quantize/dequantize,
``ops/device_unique.dedup_rows``, ``data/columnar.py``,
``train/device_pass.py``) against the JAX package, on the CPU.

Tolerances: packers, staged wire bytes, decoded views, dedup_rows, the
fronts and quantize_floats are exact (integer or copied numpy code).
dequantize_floats is exact too: one float32 multiply and one add per
value in both packages (XLA on the CPU does not contract them into a
fused multiply-add here; if it did, the two would differ by at most one
ulp and this test would say so). Training against the reference holds
the ragged train-state class, rtol 2e-4 / atol 2e-5, on rows by key and
dense params; port against port (compact wire against dedup wire) is
bit for bit, since the two wires give each batch the same unique rows in
the same order of keys.
"""

import logging

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddlebox_tpu.data.columnar import ColumnarRecords as JCol
from paddlebox_tpu.ops import bitpack as jbp
from paddlebox_tpu.ops.device_unique import dedup_rows as jdedup_rows
from paddlebox_tpu.train.device_pass import ResidentPass as JPass
from paddlebox_tpu.train.device_pass import ResidentPassRunner as JRunner
from paddlebox_tpu.train.step import dequantize_floats as jdequantize
from paddlebox_tpu.train.step import quantize_floats as jquantize

from paddlebox_tpu_torch.config import flags_scope
from paddlebox_tpu_torch.data.columnar import ColumnarRecords
from paddlebox_tpu_torch.ops import bitpack as bp
from paddlebox_tpu_torch.ops.device_unique import dedup_rows
from paddlebox_tpu_torch.train.device_pass import (ResidentPass,
                                                   ResidentPassRunner)
from paddlebox_tpu_torch.train.step import (dequantize_floats,
                                            quantize_floats)

from torch_resident_data import (BS, CAP, DENSE, S, STATE_RTOL,
                                 ArenaMapTable, RowMapTable, arrays,
                                 assert_state_close, jax_dataset, jax_state,
                                 jax_trainer, params0, port_dataset,
                                 port_state, port_table, port_trainer)

CPU = torch.device("cpu")


def _t(a):
    """A wire array as the port stages it."""
    return torch.from_numpy(np.ascontiguousarray(bp.as_wire(a)))


def _same_bytes(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    got = got.view(torch.int16) if got.dtype == torch.bfloat16 else got
    got = got.numpy()
    assert got.shape == want.shape, (got.shape, want.shape)
    assert got.tobytes() == want.tobytes()


# ---- packers and unpackers -------------------------------------------------

def _rng_values(bits, shape, seed=0):
    v = np.random.default_rng(seed).integers(0, 1 << bits, size=shape)
    v.reshape(-1)[:2] = [0, (1 << bits) - 1]      # both ends of the range
    return v.astype(np.int32)


@pytest.mark.parametrize("name,args", [
    ("pack_u24", (24,)), ("pack_u18", (18,)), ("pack_u12", (12,)),
    ("pack_u16m", (17, 1)), ("pack_u16m", (18, 2)), ("pack_u16m", (20, 4)),
    ("pack_u16m", (24, 8))],
    ids=["u24", "u18", "u12", "u16m1", "u16m2", "u16m4", "u16m8"])
def test_packers_and_unpackers_match_reference(name, args):
    bits = args[0]
    vals = _rng_values(bits, (3, 64))
    extra = args[1:]
    got = getattr(bp, name)(vals, *extra)
    want = getattr(jbp, name)(vals, *extra)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    unpack = {"pack_u24": "unpack_u24", "pack_u18": "unpack_u18",
              "pack_u12": "unpack_u12", "pack_u16m": "unpack_u16m"}[name]
    out = getattr(bp, unpack)(*(_t(a) for a in got), *extra)
    ref = getattr(jbp, unpack)(*(jnp.asarray(a) for a in want), *extra)
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(out.numpy(), vals)


def _gappy_rows(n_big, gap, u=200, u_pad=256, seed=1):
    """One ascending row with ``n_big`` gaps of ``gap`` (the rest 1..3),
    padded past its real prefix."""
    rng = np.random.default_rng(seed)
    d = rng.integers(1, 4, size=u)
    d[rng.choice(np.arange(1, u), size=n_big, replace=False)] = gap
    row = np.full(u_pad, -7, np.int64)
    row[:u] = 5 + np.cumsum(d) - d[0]
    return row[None, :].astype(np.int32), np.array([u], np.int32)


@pytest.mark.parametrize("bits,n_big,fits", [
    (8, 64, True), (8, 65, False), (16, 32, True), (16, 33, False)],
    ids=["d8_at_64", "d8_past_64", "d16_at_32", "d16_past_32"])
def test_delta_exception_budgets(bits, n_big, fits):
    rows, nreal = _gappy_rows(n_big, (1 << bits) + 3)
    budget = {8: ResidentPass._EXC8, 16: ResidentPass._EXC}[bits]
    got = bp.pack_delta(rows, nreal, budget, bits=bits)
    want = jbp.pack_delta(rows, nreal, budget, bits=bits)
    assert (got is None) == (want is None) == (not fits)
    assert (bp.pack_delta_auto(rows, nreal, ResidentPass._EXC8,
                               ResidentPass._EXC) is None) == (
        jbp.pack_delta_auto(rows, nreal, JPass._EXC8, JPass._EXC) is None)
    if not fits:
        return
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    out = bp.unpack_delta16(*(_t(a[0]) for a in got), base=int(rows[0, 0]))
    ref = jbp.unpack_delta16(*(jnp.asarray(a[0]) for a in want),
                             base=jnp.int32(rows[0, 0]))
    u = int(nreal[0])
    np.testing.assert_array_equal(out.numpy()[:u], np.asarray(ref)[:u])
    np.testing.assert_array_equal(out.numpy()[:u], rows[0, :u])


def test_delta_refuses_unsorted_rows():
    rows = np.array([[5, 9, 7, 20]], np.int32)
    nreal = np.array([4], np.int32)
    assert bp.pack_delta(rows, nreal, 64) is None
    assert jbp.pack_delta(rows, nreal, 64) is None


@pytest.mark.parametrize("bits,k", [(18, 510), (18, 512), (19, 512)],
                         ids=["k_mod4_ne0", "k_mod4_eq0", "over_18_bits"])
def test_gidx_alignment_fallback(bits, k):
    gidx = _rng_values(bits, (2, k))
    fmt = ResidentPass._choose_gidx_fmt(int(gidx.max()), k)
    got = ResidentPass._encode_gidx_fmt(fmt, gidx)
    want = JPass._encode_gidx(gidx)
    assert len(got) == len(want) == (2 if k % 4 == 0 and bits <= 18 else 1)
    for a, b in zip(got, want):
        assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("bits,k,n_leaves", [
    (12, 511, 1), (12, 512, 1), (16, 64, 1), (17, 64, 2), (17, 62, 2),
    (18, 64, 2), (20, 64, 2), (20, 63, 2), (24, 63, 2), (26, 64, 1)],
    ids=["u12_odd_k", "u12", "u16", "u16m1", "u16m1_k62", "u16m2",
         "u16m4", "u16m4_odd_k", "u16m8", "raw"])
def test_locals_encoding_matches_reference(bits, k, n_leaves):
    """``_encode_locals``, narrowest first, with its alignment fallbacks
    (odd k leaves u12 for u16; k % 8 != 0 leaves m=1 for a wider m), and
    the compact decode of each form equal to the raw locals."""
    locs = _rng_values(bits, (3, k), seed=bits)
    got = ResidentPass._encode_locals(locs, bits)
    want = JPass._encode_locals(locs, bits)
    assert len(got) == len(want) == n_leaves
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    runner = ResidentPassRunner(None, True, wire="compact", num_slots=1,
                                chunk_bits=30)
    cmap = torch.zeros((1, 1), dtype=torch.int32)
    floats = torch.zeros((4, 7))
    for i in range(3):
        view = runner._make_view_compact(
            tuple(_t(a[i]) for a in got), cmap, floats, None, None, k, 0,
            1 << 30)
        np.testing.assert_array_equal(
            view.unique_rows.numpy()[view.gather_idx.numpy()], locs[i])


# ---- the float wires -------------------------------------------------------

def _dense_block(n=64, seed=5):
    rng = np.random.default_rng(seed)
    dense = (rng.normal(size=(n, 5))
             * np.array([1, 10, 0.1, 100, 1])).astype(np.float32)
    label = (rng.random(n) < 0.3).astype(np.float32)
    return dense, label, np.ones(n, np.float32), label.copy()


def _quantize_cases():
    dense, label, show, clk = _dense_block()
    pad = np.full((10, 2), 1000.0, np.float32)   # padding rows excluded
    pad[:, 1] = np.linspace(1000.0, 1010.0, 10)
    pad[8:] = 0.0
    pshow = np.ones(10, np.float32)
    pshow[8:] = 0.0
    z = np.zeros(10, np.float32)
    rng = np.random.default_rng(7)               # a winsorized outlier
    out = rng.uniform(0, 100, size=(4096, 1)).astype(np.float32)
    out[17, 0] = 1e6
    z4 = np.zeros(4096, np.float32)
    const = np.full((8, 2), 3.5, np.float32)     # scale clamps to 1
    return {
        "random": ((dense, label, show, clk), {}),
        "padding": ((pad, z, pshow, z), {"valid": pshow > 0}),
        "outlier": ((out, z4, np.ones(4096, np.float32), z4), {}),
        "constant": ((const, label[:8], show[:8], clk[:8]), {}),
        "nan": ((np.array([[np.nan]], np.float32), label[:1], show[:1],
                 clk[:1]), {}),
        "half_label": ((const[:1], np.array([0.5], np.float32), show[:1],
                        clk[:1]), {}),
    }


@pytest.mark.parametrize("case", list(_quantize_cases()))
def test_quantize_and_dequantize_match_reference(case):
    args, kw = _quantize_cases()[case]
    got = quantize_floats(*args, **kw)
    want = jquantize(*args, **kw)
    assert (got is None) == (want is None)
    if want is None:
        assert case in ("nan", "half_label")
        return
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    d, lb, sh, ck = dequantize_floats(_t(got[0]), _t(got[1]))
    jd = jdequantize(jnp.asarray(want[0]), jnp.asarray(want[1]))
    for a, b in zip((d, lb, sh, ck), jd):
        assert a.numpy().tobytes() == np.asarray(b).tobytes()
    if case == "padding":
        assert got[1][1, 1] == 1000.0 and got[1][0, 1] <= 10.0 / 255 + 1e-6
        assert (got[0][8:, :2] == 0).all()
    if case == "outlier":
        body = np.delete(np.arange(4096), 17)
        assert np.abs(d.numpy()[body, 0] - args[0][body, 0]).max() < 1.0
        assert d.numpy()[17, 0] >= d.numpy()[body, 0].max()


def _q8_records(bad_label=False, n=96, seed=3):
    """The reference's q8 streaming-front data: 4 one-key slots, 5 dense
    columns of unequal scale (dense width 5 is unlike the rest of these
    tests, so the records carry their own desc)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        label = 0.5 if bad_label else float(rng.random() < 0.3)
        out.append(((rng.integers(0, 64, size=4)
                     + np.arange(4) * 64).astype(np.uint64),
                    np.arange(5, dtype=np.int32),
                    (rng.normal(size=5) * np.array([1, 10, 0.1, 100, 1])
                     ).astype(np.float32), label))
    return out


def _q8_datasets(arrs):
    from paddlebox_tpu.data import DataFeedDesc as JD, SlotDef as JS
    from paddlebox_tpu.data.dataset import InMemoryDataset as JDS
    from paddlebox_tpu.data.record import SlotRecord as JR
    from paddlebox_tpu_torch.data import DataFeedDesc, SlotDef, SlotRecord
    from paddlebox_tpu_torch import InMemoryDataset

    def desc(D, Sd):
        return D(slots=[Sd("label", "float", 1), Sd("dense", "float", 5)]
                 + [Sd(f"C{i}", "uint64") for i in range(1, 5)],
                 batch_size=32, label_slot="label", key_bucket_min=128)

    pds, jds = InMemoryDataset(desc(DataFeedDesc, SlotDef)), JDS(desc(JD, JS))
    pds.records = [SlotRecord(k, o, d, lb, 1.0, lb) for k, o, d, lb in arrs]
    jds.records = [JR(k, o, d, lb, 1.0, lb) for k, o, d, lb in arrs]
    return pds, jds


@pytest.mark.parametrize("streaming", [True, False],
                         ids=["streaming", "staged"])
@pytest.mark.parametrize("bad_label", [False, True],
                         ids=["q8", "bf16_fallback"])
def test_q8_fronts_match_reference(streaming, bad_label):
    from paddlebox_tpu.config import flags_scope as jflags
    pds, jds = _q8_datasets(_q8_records(bad_label))
    with flags_scope(q8_streaming_front=streaming), \
            jflags(q8_streaming_front=streaming):
        got = ResidentPass._front(pds, "q8")
        want = JPass._front(jds, "q8")
    assert (got[2] is None) == (want[2] is None) == bad_label
    if bad_label:  # bf16 bits, the reference's ml_dtypes bf16 bytes
        assert got[1].dtype == np.int16 and want[1].dtype == jnp.bfloat16
    assert got[1].tobytes() == np.asarray(want[1]).tobytes()
    if not bad_label:
        assert got[2].tobytes() == want[2].tobytes()
    for a, b in zip(got[0], want[0]):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    assert got[3:5] == want[3:5]


def test_dedup_rows_matches_reference():
    rng = np.random.default_rng(0)
    cap = 500
    for trial in range(5):
        rows = rng.integers(0, cap, size=300).astype(np.int32)
        rows[rng.random(300) < 0.1] = cap  # pads carry the sentinel row
        got = dedup_rows(torch.from_numpy(rows), cap)
        want = jdedup_rows(jnp.asarray(rows), cap)
        for a, b in zip(got, want):
            assert a.dtype == torch.int32
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        np.testing.assert_array_equal(got[0].numpy()[got[1].numpy()], rows)
    sent = np.full(16, 64, np.int32)                     # all sentinel
    got = dedup_rows(torch.from_numpy(sent), 64)
    want = jdedup_rows(jnp.asarray(sent), 64)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert int(got[0][0]) == 64 and (got[1] == 0).all()


# ---- the columnar store and front -----------------------------------------

@pytest.mark.parametrize("trivial", [False, True],
                         ids=["ragged", "trivial"])
def test_columnar_matches_reference_and_record_front(trivial):
    arrs = arrays(n=5 * BS - 7, seed=11, trivial=trivial)
    pds = port_dataset(arrs)
    jds = jax_dataset(arrs)
    col = ColumnarRecords.from_records(pds.records, DENSE)
    jcol = JCol.from_records(jds.records, DENSE)
    for f in ("keys", "key_slot", "offsets", "dense", "label", "show",
              "clk", "uid", "rank", "cmatch", "timestamp"):
        np.testing.assert_array_equal(getattr(col, f), getattr(jcol, f),
                                      err_msg=f)
    rec_front = ResidentPass._front(pds)
    pds.columnarize()
    jds.columnarize()
    assert len(pds) == len(arrs) and pds.records == []
    got = ResidentPass._front(pds)
    want = JPass._front(jds, np.float32)
    assert got[3] is want[3] is rec_front[3] is trivial
    assert got[4] == want[4] == rec_front[4] == len(arrs)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[1], rec_front[1])
    for g, w, r in zip(got[0], want[0], rec_front[0]):
        for i in (0, 1, 3, 4):                # k_max is the fine ladder's
            if g[4] is None and i == 4:
                assert w[4] is None and trivial
                continue
            np.testing.assert_array_equal(g[i], w[i])
            np.testing.assert_array_equal(g[i], r[i])
        assert g[2] == w[2]
    side, jside = got[5], want[5]
    assert side.keys() == jside.keys()
    for k in side:
        np.testing.assert_array_equal(side[k], jside[k], err_msg=k)
    # the columnar batches equal the record batches, field for field
    for a, b in zip(pds.batches(), port_dataset(arrs).batches()):
        for f in ("keys", "segments", "dense", "label", "show", "clk",
                  "uid", "rank", "cmatch"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        assert (a.num_keys, a.segments_trivial) == (b.num_keys,
                                                    b.segments_trivial)


def test_columnar_shuffle_matches_reference():
    arrs = arrays(n=100, seed=12)
    pds, jds = port_dataset(arrs, columnar=True), jax_dataset(arrs,
                                                               columnar=True)
    a, b = pds.columnar.shuffle(5), jds.columnar.shuffle(5)
    for f in ("keys", "key_slot", "offsets", "dense", "label"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


# ---- staged wire bytes: build_streamed and upload against the reference ---

def _staged_pairs(rp, jrp):
    """(port leaf, JAX leaf) of every block both stage; the port keeps
    meta on the host and stages no dummy for trivial segments or an
    absent qmeta."""
    u, g, f, sg, qm = rp.dev
    ju, jg, jf, jmeta, jsg, jqm = jrp.dev
    np.testing.assert_array_equal(rp.meta, np.asarray(jmeta))
    assert len(u) == len(ju) and len(g) == len(jg)
    pairs = list(zip(u, ju)) + list(zip(g, jg)) + [(f, jf)]
    if sg is None:
        assert np.asarray(jsg[0]).shape == (1, 1)
    else:
        assert len(sg) == len(jsg)
        pairs += list(zip(sg, jsg))
    if qm is None:
        assert np.asarray(jqm).shape == (2, 0)
    else:
        pairs.append((qm, jqm))
    return pairs


def _check_views(rp, capacity):
    """Every batch's decoded view equals the raw (int32/f32) pass."""
    runner = ResidentPassRunner(None, rp.segs is None, wire=rp.wire,
                                num_slots=S, chunk_bits=rp.chunk_bits)
    for i in range(rp.num_batches):
        v = runner._make_view(rp, i, capacity)
        nk = int(rp.meta[i, 0])
        if rp.wire == "compact":
            ur, gi = v.unique_rows.numpy(), v.gather_idx.numpy()
            np.testing.assert_array_equal(ur[gi[:nk]], rp.uniq[i, :nk])
            u = len(np.unique(ur[gi]))
            assert (np.diff(ur[:u]) > 0).all() and (ur[u:] > capacity).all()
        else:
            # the delta wire derives its pad ids (distinct, > capacity)
            # from the position, like the reference's view
            u = int(rp.meta[i, 2])
            ur = v.unique_rows.numpy()
            np.testing.assert_array_equal(ur[:u], rp.uniq[i, :u])
            assert (ur[u:] > capacity).all() and len(set(ur)) == len(ur)
            np.testing.assert_array_equal(v.gather_idx.numpy(), rp.gidx[i])
        if rp.segs is None:
            assert v.pool_segments is None
        else:
            np.testing.assert_array_equal(v.pool_segments.numpy(),
                                          rp.segs[i])
        if rp.qmeta is None:
            blk = rp.floats[i]
            f = (torch.from_numpy(blk).view(torch.bfloat16).float().numpy()
                 if blk.dtype == np.int16 else blk)
            np.testing.assert_array_equal(v.dense.numpy(), f[:, :-3])
            np.testing.assert_array_equal(v.label.numpy(), f[:, -3])
            np.testing.assert_array_equal(v.show_clk.numpy(), f[:, -2:])


_UNIQ_MAPS = {  # n-th first-seen key → row, and the capacity
    "d8": (lambda n: n, CAP),
    "d16": (lambda n: n * 300, 1 << 20),
    "u24": (lambda n: (n % 200) * 70_000 + n // 200, 15_000_000),
    "raw": (lambda n: (1 << 24) + n * 70_000, 1 << 27),
}


@pytest.mark.parametrize("floats", ["f32", "bf16", "q8"])
@pytest.mark.parametrize("uniq", list(_UNIQ_MAPS))
def test_build_streamed_stages_reference_wire(uniq, floats):
    """The dedup wire through ``build_streamed`` in 2-batch chunks: each
    uniq wire (forced by the rows a table stand-in hands out) and each
    float wire stage the JAX build's bytes, and ``upload`` of a plain
    build stages the same bytes."""
    rows_of, cap = _UNIQ_MAPS[uniq]
    arrs = arrays(seed=21)
    jwire = {"f32": np.float32, "bf16": jnp.bfloat16, "q8": "q8"}[floats]
    pwire = {"f32": np.float32, "bf16": torch.bfloat16, "q8": "q8"}[floats]
    with flags_scope(preload_pack_chunk_batches=2):
        rp = ResidentPass.build_streamed(port_dataset(arrs),
                                         RowMapTable(cap, rows_of),
                                         floats_dtype=pwire)
    from paddlebox_tpu.config import flags_scope as jflags
    with jflags(preload_pack_chunk_batches=2):
        jrp = JPass.build_streamed(jax_dataset(arrs),
                                   RowMapTable(cap, rows_of),
                                   floats_dtype=jwire)
    assert rp.formats == {"uniq": uniq, "gidx": "u18", "segs": "grid",
                          "floats": floats}
    for got, want in _staged_pairs(rp, jrp):
        _same_bytes(got, want)
    assert set(rp.build_stats) >= {"front", "dedup", "pack", "h2d"}
    plain = ResidentPass.build(port_dataset(arrs), RowMapTable(cap, rows_of),
                               floats_dtype=pwire)
    plain.upload(CPU)
    assert plain.formats == rp.formats
    for a, b in zip(plain._leaves(), rp._leaves()):
        assert a.dtype == b.dtype and torch.equal(a, b)
    _check_views(rp, cap)


def _handbuilt(kind, seed=8):
    """A 3-batch pass (B 16, S 7) whose segments force one wire."""
    rng = np.random.default_rng(seed)
    nb, b, s = 3, 16, 7
    k = 126 if kind == "raw" else 128
    pad = b * s
    segs = np.full((nb, k), pad, np.int32)
    meta = np.zeros((nb, 4), np.int32)
    for i in range(nb):
        counts = rng.integers(0, 4, size=b)
        nk = int(counts.sum())
        rec = np.repeat(np.arange(b), counts)
        slot = rng.integers(0, s, size=nk)
        if kind == "grid":
            slot = np.concatenate([np.sort(slot[rec == r])
                                   for r in range(b)])
        segs[i, :nk] = rec * s + slot
        if kind in ("u18", "raw"):             # not record-grouped
            segs[i, :nk] = segs[i, :nk][::-1]
        meta[i] = (nk, pad, 5, 0)
    uniq = np.tile(np.arange(8, dtype=np.int32), (nb, 1))
    uniq[:, 5:] = CAP + np.arange(1, 4)
    gidx = np.where(np.arange(k) < meta[:, :1], np.arange(k) % 5,
                    5).astype(np.int32)
    floats = np.random.default_rng(seed).normal(size=(nb, b, 6)).astype(
        np.float32)
    return uniq, gidx, floats, meta, segs


@pytest.mark.parametrize("kind", ["grid", "slot", "u18", "raw"])
def test_upload_segment_wires_match_reference(kind):
    """Hand-built ragged passes forcing each segment wire: ``upload``
    stages the JAX upload's bytes and the views decode the segments."""
    arrays_ = _handbuilt(kind)
    rp = ResidentPass(*arrays_, num_records=48)
    jrp = JPass(*arrays_, num_records=48)
    rp.upload(CPU)
    jrp.upload()
    assert rp.formats["segs"] == kind
    if kind == "grid":
        assert rp.dev[3][0].dim() == 3 and rp.dev[3][0].dtype == torch.uint8
    for got, want in _staged_pairs(rp, jrp):
        _same_bytes(got, want)
    runner = ResidentPassRunner(None, False)
    for i in range(3):
        got = runner._decode_segs(tuple(a[i] for a in rp.dev[3]),
                                  int(rp.meta[i, 1]), rp.key_capacity)
        want = JRunner._decode_segs(tuple(jnp.asarray(a[i])
                                          for a in jrp.dev[4]),
                                    jnp.asarray(rp.meta[i]),
                                    k_pad=rp.key_capacity)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(got.numpy(), arrays_[4][i])


@pytest.mark.parametrize("case,fmt", [("ascending", "d8"),
                                      ("unsorted", "u24"),
                                      ("no_base", "u24")])
def test_upload_handbuilt_uniq_fallback(case, fmt):
    """``upload`` applies ``build_streamed``'s uniq chooser; a hand-built
    pass whose real rows do not ascend, or whose base column is not the
    first row, takes the order-agnostic u24 wire, as the JAX upload does,
    byte for byte."""
    uniq, gidx, floats, meta, segs = _handbuilt("slot")
    if case == "unsorted":
        uniq[1, [1, 3]] = uniq[1, [3, 1]]
    elif case == "no_base":
        meta[:, 3] = 1
    rp = ResidentPass(uniq, gidx, floats, meta, segs, num_records=48)
    jrp = JPass(uniq, gidx, floats, meta, segs, num_records=48)
    rp.upload(CPU)
    jrp.upload()
    assert rp.formats["uniq"] == fmt
    for got, want in _staged_pairs(rp, jrp):
        _same_bytes(got, want)


@pytest.mark.parametrize("bits,fmt", [
    (12, "u12"), (16, "u16"), (17, "u16m1"), (18, "u16m2"), (20, "u16m4"),
    (24, "u16m8")])
@pytest.mark.parametrize("trivial", [False, True],
                         ids=["ragged", "trivial"])
def test_compact_wire_stages_reference_bytes(bits, fmt, trivial):
    """The compact wire through ``build_streamed``: locals of each width
    (a slot-arena stand-in hands out locals of exactly ``bits`` bits)
    stage the JAX build's bytes and decode to the global rows. Wider
    locals leave the compact wire (``_compact_tail`` refuses > 24 bits);
    the raw local encoding is held by ``test_locals_encoding_matches_
    reference``."""
    arrs = arrays(seed=22, trivial=trivial)
    rp = ResidentPass.build_streamed(port_dataset(arrs), ArenaMapTable(bits),
                                     floats_dtype="q8")
    jrp = JPass.build_streamed(jax_dataset(arrs), ArenaMapTable(bits),
                               floats_dtype="q8")
    assert rp.wire == jrp.wire == "compact"
    assert rp.formats == {"locals": fmt,
                          "segs": "trivial" if trivial else "grid",
                          "floats": "q8"}
    for got, want in _staged_pairs(rp, jrp):
        _same_bytes(got, want)
    np.testing.assert_array_equal(rp.uniq, jrp.uniq)
    _check_views(rp, ArenaMapTable(bits).capacity)


# ---- the arena table and training on each wire ----------------------------

def test_arena_table_load_reassigns_slotted():
    """``load`` assigns a save file's rows slotted on an arena table (the
    compact wire survives a restore), a shrink-free reload re-enables the
    arena, and the device index degrades for arena tables."""
    arrs = arrays(seed=31)
    tr = port_trainer(params0(), arena=True)
    tr.train_pass_resident(ResidentPass.build_streamed(port_dataset(arrs),
                                                       tr.table))
    keys, rows = tr.table.index.items()
    blob = dict(keys=keys, **tr.table._gather_host(rows))
    fresh = port_table(arena=True)
    fresh.load(blob)
    assert fresh.index.arena_enabled
    # every key sits in its own slot's arena (no new rows, locals >= 0)
    loaded = fresh.index.lookup(keys)
    again, local = fresh.index.assign_slotted(
        keys, blob["slot"].astype(np.uint16))
    np.testing.assert_array_equal(again, loaded)
    assert (local >= 0).all() and len(fresh.index) == len(keys)
    rp = ResidentPass.build_streamed(port_dataset(arrs), fresh)
    assert rp.wire == "compact"
    with flags_scope(use_pallas_index=True):
        dev = fresh._device_index()
    assert dev.degraded and "arena" in dev.degrade_reason


@pytest.mark.parametrize("trivial", [False, True],
                         ids=["ragged", "trivial"])
def test_compact_wire_matches_dedup_wire(trivial):
    """Two passes on an arena table (compact wire) and on a plain one
    (dedup wire) from the same start: rows by key, dense params, AUC and
    losses bit for bit (mf_initial_range 0: no lazy-mf draws)."""
    arrs = arrays(seed=32, trivial=trivial)
    params = params0()
    out = {}
    for arena in (False, True):
        tr = port_trainer(params, arena=arena)
        res = []
        for _ in range(2):
            rp = ResidentPass.build_streamed(port_dataset(arrs), tr.table)
            assert rp.wire == ("compact" if arena else "dedup")
            res.append(tr.train_pass_resident(rp))
        out[arena] = (port_state(tr), res)
    (pa, ra), (pb, rb) = out[False], out[True]
    np.testing.assert_array_equal(pa[0], pb[0])
    for f in pa[1]:
        np.testing.assert_array_equal(pa[1][f], pb[1][f], err_msg=f)
    for name in pa[2]:
        assert torch.equal(pa[2][name], pb[2][name]), name
    for a, b in zip(ra, rb):
        assert a["auc"] == b["auc"] and a["last_loss"] == b["last_loss"]


def test_compact_falls_back_after_slotless_assign(caplog):
    """Keys that entered through a slotless path sit in the default arena:
    a pass touching them falls back to the dedup wire, loudly, and still
    trains."""
    arrs = arrays(seed=33)
    tr = port_trainer(params0(), arena=True)
    tr.table.index.assign(arrs[0][0][:3])          # slotless
    with caplog.at_level(logging.WARNING):
        rp = ResidentPass.build_streamed(port_dataset(arrs), tr.table)
    assert rp.wire == "dedup"
    assert any("compact wire unavailable" in r.getMessage()
               for r in caplog.records)
    res = tr.train_pass_resident(rp)
    assert np.isfinite(res["auc"]) and np.isfinite(res["last_loss"])


def test_compact_sentinel_row_stays_zero():
    """Pad keys map to the sentinel row, which the device dedup emits as
    an in-bounds unique entry: with lazy mf creation and a nonzero
    mf_initial_range it must stay zero, and unknown keys pull zeros."""
    cfg = dict(mf_create_thresholds=0.0, mf_initial_range=0.5,
               learning_rate=0.05, mf_learning_rate=0.05)
    tr = port_trainer(params0(), arena=True, cfg=cfg)
    rp = ResidentPass.build_streamed(port_dataset(arrays(seed=34)), tr.table)
    assert rp.wire == "compact"
    assert (rp.meta[:, 0] < rp.key_capacity).all()   # pad keys present
    tr.train_pass_resident(rp)
    assert not tr.table.state.data[CAP].any()
    assert (tr.table.state.data[:CAP, 7] > 0).any()
    assert not tr.table.host_pull(np.array([0xdeadbeefcafe],
                                           np.uint64)).any()


_WIRES = {  # id → (port floats_dtype, JAX floats_dtype, arena, columnar)
    "dedup_f32": (np.float32, np.float32, False, False),
    "dedup_bf16": (torch.bfloat16, jnp.bfloat16, False, False),
    "dedup_q8_columnar": ("q8", "q8", False, True),
    "compact_q8": ("q8", "q8", True, False),
    "compact_f32_columnar": (np.float32, np.float32, True, True),
}


@pytest.mark.parametrize("wire", list(_WIRES))
def test_resident_training_on_each_wire_matches_jax(wire):
    """Two ``build_streamed`` passes on one wire in both packages, each
    trained by ``train_pass_resident``: rows by key and dense params
    within the train-state class, AUC within its rtol."""
    pdt, jdt, arena, columnar = _WIRES[wire]
    arrs = arrays(seed=35, trivial=False)
    jtr, params = jax_trainer(arena=arena)
    tr = port_trainer(params, arena=arena)
    jres, res = [], []
    for _ in range(2):
        jrp = JPass.build_streamed(jax_dataset(arrs, columnar=columnar),
                                   jtr.table, floats_dtype=jdt)
        rp = ResidentPass.build_streamed(
            port_dataset(arrs, columnar=columnar), tr.table,
            floats_dtype=pdt)
        assert rp.wire == jrp.wire == ("compact" if arena else "dedup")
        jres.append(jtr.train_pass_resident(jrp))
        res.append(tr.train_pass_resident(rp))
    assert_state_close(port_state(tr), jax_state(jtr))
    for a, b in zip(res, jres):
        np.testing.assert_allclose(a["auc"], b["auc"], rtol=STATE_RTOL)
    assert not tr.table.state.data[CAP].any()
    assert tr.global_step == 2 * rp.num_batches

