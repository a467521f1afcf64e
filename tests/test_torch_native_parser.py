"""The port's native bulk parser (``native/slot_parser.cpp`` in the
port's own library, driven by ``data/parser.py``) on the cases of
``tests/test_native_parser.py``: malformed lines, extra tabs and bad hex,
truncated lines, token garbage, hex forms, uint64 overflow and hexfloat,
and the real-Criteo quirk fixture. Each case holds three routes: the
port's native parse, the JAX package's native parse (its own library,
built on first ``load_native``) and the JAX per-line parse. Port against
JAX native is exact in every array; native against per line is exact but
for the dense values, which keep the reference's own tolerance (rtol
1e-6: ``strtof`` of a log1p against numpy's). Last,
``generate_criteo_files`` writes the same bytes in both packages.
"""

import os
import pathlib

import numpy as np
import pytest

from paddlebox_tpu.data import DataFeedDesc as JDesc
from paddlebox_tpu.data import SlotDef as JSlotDef
from paddlebox_tpu.data.columnar import ColumnarRecords as JColumnar
from paddlebox_tpu.data.criteo import generate_criteo_files as j_generate
from paddlebox_tpu.data.parser import CriteoParser as JCriteoParser
from paddlebox_tpu.data.parser import SlotTextParser as JSlotTextParser
from paddlebox_tpu.native import load_native

from paddlebox_tpu_torch.data import DataFeedDesc, DatasetFactory, SlotDef
from paddlebox_tpu_torch.data.criteo import generate_criteo_files
from paddlebox_tpu_torch.data.parser import CriteoParser, SlotTextParser

KEYS = ("keys", "key_slot", "offsets", "dense", "label", "show", "clk",
        "dropped")


def _criteo():
    return (CriteoParser(DataFeedDesc.criteo(batch_size=4)),
            JCriteoParser(JDesc.criteo(batch_size=4)))


def _slot_text(slots, **kw):
    return (SlotTextParser(DataFeedDesc(
                slots=[SlotDef(*s) for s in slots], batch_size=4, **kw)),
            JSlotTextParser(JDesc(
                slots=[JSlotDef(*s) for s in slots], batch_size=4, **kw)))


def _per_line(jparser, path):
    recs = []
    with open(path) as fh:
        for line in fh:
            r = jparser.parse(line)
            if r is not None:
                recs.append(r)
    return JColumnar.from_records(recs, jparser.desc.dense_dim)


def three_routes(parsers, path):
    """Port native == JAX native exactly; both == JAX per line (dense
    rtol 1e-6). Returns the port's result."""
    assert load_native() is not None
    port, jax_ = parsers
    got = port.parse_file_columnar(str(path))
    want = jax_.parse_file_columnar(str(path))
    assert sorted(got) == sorted(want) == sorted(KEYS)
    for k in KEYS:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k
    ref = _per_line(jax_, str(path))
    for k in ("keys", "key_slot", "offsets", "label", "show", "clk"):
        np.testing.assert_array_equal(got[k], getattr(ref, k), err_msg=k)
    np.testing.assert_allclose(got["dense"], ref.dense, rtol=1e-6)
    return got


GOOD = ("1\t" + "\t".join(str(i) for i in range(1, 14)) + "\t"
        + "\t".join(f"{i:x}" for i in range(26)))


def test_criteo_native_matches_python(tmp_path):
    files = generate_criteo_files(str(tmp_path), num_files=1,
                                  rows_per_file=500, vocab_per_slot=100,
                                  seed=3)
    got = three_routes(_criteo(), files[0])
    assert len(got["label"]) == 500 and got["dropped"] == 0


def test_criteo_native_skips_malformed(tmp_path):
    f = tmp_path / "bad.txt"
    f.write_text("\n".join(["garbage line", GOOD, "too\tfew\tfields",
                            GOOD + "\n"]))
    got = three_routes(_criteo(), f)
    assert len(got["label"]) == 2 and (got["label"] == 1.0).all()


def test_slot_text_native_matches_python(tmp_path):
    rng = np.random.default_rng(5)
    slots = [("label", "float", 1), ("dense", "float", 3),
             ("s1", "uint64"), ("s2", "uint64"),
             ("unused", "uint64", 1, False)]
    lines = []
    for _ in range(200):
        n1, n2 = int(rng.integers(0, 4)), int(rng.integers(1, 3))
        parts = ["1", str(int(rng.integers(0, 2)))]
        parts += ["3"] + [f"{rng.normal():.4f}" for _ in range(3)]
        parts += [str(n1)] + [str(int(rng.integers(0, 10**12)))
                              for _ in range(n1)]
        parts += [str(n2)] + [str(int(rng.integers(0, 10**12)))
                              for _ in range(n2)]
        parts += ["2", "99", "98"]  # unused slot: tokens must be skipped
        lines.append(" ".join(parts))
    lines.insert(7, "1 bad 3 x y z 0 1 5 2 9 9")  # malformed → dropped
    f = tmp_path / "slots.txt"
    f.write_text("\n".join(lines) + "\n")
    got = three_routes(_slot_text(slots, label_slot="label"), f)
    assert len(got["label"]) == 200 and got["dropped"] == 1


def test_criteo_extra_tabs_and_bad_hex(tmp_path):
    """Lines with >= 40 tabs are skipped; invalid / overlong hex matches
    the per-line parse exactly."""
    f = tmp_path / "edge.txt"
    f.write_text("\n".join([GOOD, GOOD + "\t" * 5,
                            GOOD.replace("\t0\t", "\tzz\t", 1),
                            GOOD + "ffffffffffffffffff"]) + "\n")
    got = three_routes(_criteo(), f)
    assert len(got["label"]) == 3


def test_slot_text_truncated_line_no_bleed(tmp_path):
    """A line truncated mid-record is dropped without consuming the
    NEXT line's tokens."""
    slots = [("label", "float", 1), ("s1", "uint64"), ("s2", "uint64")]
    f = tmp_path / "trunc.txt"
    f.write_text("\n".join(["1 1 2 10 20 1 30", "1 0 1 40",
                            "1 1 2 50 60 1 70"]) + "\n")
    got = three_routes(_slot_text(slots, label_slot="label"), f)
    assert len(got["label"]) == 2
    np.testing.assert_array_equal(got["keys"], [10, 20, 30, 50, 60, 70])


def test_token_garbage_parity(tmp_path):
    """Trailing-garbage tokens are rejected by every route alike, and an
    empty clk group gives clk 0.0."""
    f = tmp_path / "garb.txt"
    f.write_text("\n".join([GOOD, GOOD.replace("1\t", "1x\t", 1),
                            GOOD.replace("\t3\t", "\t3x\t", 1)]) + "\n")
    three_routes(_criteo(), f)
    slots = [("label", "float", 1), ("clk", "float", 1), ("s1", "uint64")]
    f2 = tmp_path / "slots.txt"
    f2.write_text("\n".join(["1 1 1 0.0 1 5", "1 1 0 1 5", "2.5 1 1 1 1 5",
                             "1 1 1 1 1 5x"]) + "\n")
    got = three_routes(_slot_text(slots, label_slot="label",
                                  clk_slot="clk"), f2)
    assert len(got["label"]) == 2 and got["clk"][1] == 0.0


def test_criteo_hex_form_parity(tmp_path):
    """'0x..' and '+1a' map to the slot-salted sentinel on every route."""
    cats = [f"{i:x}" for i in range(26)]
    cats[0], cats[1] = "0x1a", "+1a"
    f = tmp_path / "hexforms.txt"
    f.write_text("1\t" + "\t".join(str(i) for i in range(1, 14)) + "\t"
                 + "\t".join(cats) + "\n")
    got = three_routes(_criteo(), f)
    sent = (np.uint64(1) << np.uint64(52)) | np.uint64(0xFFFFFFFF)
    assert got["keys"][0] == sent


def test_uint64_overflow_and_hexfloat_parity(tmp_path):
    slots = [("label", "float", 1), ("s1", "uint64")]
    f = tmp_path / "ovf.txt"
    f.write_text("\n".join(["1 1 1 5", "1 1 1 18446744073709551616",
                            "1 0x1p1 1 5"]) + "\n")
    got = three_routes(_slot_text(slots, label_slot="label"), f)
    assert len(got["label"]) == 1


def test_key_arena_doubling_retry(tmp_path):
    """More keys than the first arena guess (max_rec x sparse slots)
    take the doubling retry; every route agrees."""
    slots = [("label", "float", 1), ("s1", "uint64")]
    f = tmp_path / "wide.txt"
    f.write_text("\n".join(
        "1 1 3000 " + " ".join(str(k) for k in range(i, i + 3000))
        for i in range(3)) + "\n")
    got = three_routes(_slot_text(slots, label_slot="label"), f)
    assert len(got["keys"]) == 9000


def _real_criteo_fixture(path, rows=384, seed=7):
    """Real Criteo day-file quirks: 8-hex-digit hashes, empty dense
    fields, negative ints in I2, empty categoricals, a trailing empty
    field, and malformed lines that must drop."""
    rng = np.random.default_rng(seed)
    lines = []
    for _ in range(rows):
        label = str(int(rng.random() < 0.3))
        dense = [str(int(v)) for v in rng.integers(0, 1500, size=13)]
        dense[1] = str(int(rng.integers(-3, 10)))
        for i in rng.choice(13, size=4, replace=False):
            dense[i] = ""
        cats = [format(int(v), "08x")
                for v in rng.integers(0, 1 << 32, size=26)]
        for i in rng.choice(25, size=2, replace=False):
            cats[i] = ""
        cats[25] = ""
        lines.append("\t".join([label] + dense + cats))
    lines.insert(0, "")
    lines.insert(5, "\t".join(["1"] + ["1"] * 12))
    lines.insert(9, "abc\t" + "\t".join(["1"] * 39))
    path.write_text("\n".join(lines) + "\n")
    return rows


def test_real_criteo_fixture(tmp_path):
    f = tmp_path / "day_quirks.txt"
    rows = _real_criteo_fixture(f)
    got = three_routes(_criteo(), f)
    assert got["dropped"] == 3 and len(got["label"]) == rows
    mask = (np.uint64(1) << np.uint64(52)) - np.uint64(1)
    assert ((got["keys"] & mask) == np.uint64(0xFFFFFFFF)).sum() == rows * 3
    # the dataset loads it natively, in filelist order
    ds = DatasetFactory().create_dataset("InMemoryDataset",
                                         DataFeedDesc.criteo(128))
    ds.set_filelist([str(f)])
    ds.load_into_memory()
    assert ds.parse_route == "native" and len(ds) == rows
    np.testing.assert_array_equal(ds.columnar.keys, got["keys"])


@pytest.mark.parametrize("kw", [
    dict(num_files=2, rows_per_file=300, vocab_per_slot=50, seed=9),
    dict(num_files=1, rows_per_file=200, vocab_per_slot=100_000, seed=0,
         value_base=7)])
def test_generate_criteo_files_same_bytes(tmp_path, kw):
    ours = generate_criteo_files(str(tmp_path / "port"), **kw)
    theirs = j_generate(str(tmp_path / "jax"), **kw)
    assert [os.path.basename(p) for p in ours] == \
        [os.path.basename(p) for p in theirs]
    for a, b in zip(ours, theirs):
        assert pathlib.Path(a).read_bytes() == pathlib.Path(b).read_bytes()
