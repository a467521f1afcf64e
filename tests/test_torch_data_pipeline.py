"""The port's data pipeline (``data/parser.py``, ``data/dataset.py``,
``data/record.py``, ``utils/monitor.py``) against the JAX package on the
CPU: every case of ``tests/test_data_pipeline.py`` and
``tests/test_dataset_ext.py`` gives both packages the same lines or files
(written from a numpy seed) and compares the results EXACTLY — parsed
records, columnar arrays, batches, shuffles (both stores, the capped
donor pool, under the same ``FLAGS.seed``), the ins_id merge, the plugin
parsers (a python module and a ``.so`` compiled with g++), the
``pipe_command`` reader. Then ``shard_filelist``, ``pass_keys`` /
``pass_key_slots`` (with the two-slot refusal), the quarantine and the
poison budgets, and the route each load records (``parse_route``).
"""

import os
import subprocess
import textwrap

import numpy as np
import pytest

from paddlebox_tpu.config import flags_scope as j_flags_scope
from paddlebox_tpu.data import BatchBuilder as JBuilder
from paddlebox_tpu.data import CriteoParser as JCriteoParser
from paddlebox_tpu.data import DataFeedDesc as JDesc
from paddlebox_tpu.data import DatasetFactory as JFactory
from paddlebox_tpu.data import SlotDef as JSlotDef
from paddlebox_tpu.data import SlotTextParser as JSlotTextParser
from paddlebox_tpu.data import dataset as jdataset
from paddlebox_tpu.data import parser as jparser
from paddlebox_tpu.data.criteo import generate_criteo_files
from paddlebox_tpu.data.pv import merge_by_insid as j_merge_by_insid
from paddlebox_tpu.data.record import SlotRecord as JRecord

from paddlebox_tpu_torch import native
from paddlebox_tpu_torch.config import FLAGS, flags_scope
from paddlebox_tpu_torch.data import (BatchBuilder, CriteoParser,
                                      DataFeedDesc, DatasetFactory,
                                      InMemoryDataset, QueueDataset,
                                      SlotDef, SlotRecord, SlotRecordPool,
                                      SlotTextParser, get_parser)
from paddlebox_tpu_torch.data import dataset as tdataset
from paddlebox_tpu_torch.data import parser as tparser
from paddlebox_tpu_torch.data.pv import merge_by_insid

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = {"desc": DataFeedDesc, "slot": SlotDef, "factory": DatasetFactory,
        "flags": flags_scope, "parser": tparser, "dataset": tdataset,
        "builder": BatchBuilder, "record": SlotRecord}
JAX = {"desc": JDesc, "slot": JSlotDef, "factory": JFactory,
       "flags": j_flags_scope, "parser": jparser, "dataset": jdataset,
       "builder": JBuilder, "record": JRecord}
REC_FIELDS = ("label", "show", "clk", "ins_id", "search_id", "rank",
              "cmatch", "uid", "timestamp")
COL_FIELDS = ("keys", "key_slot", "offsets", "dense", "label", "show",
              "clk", "uid", "rank", "cmatch")
BATCH_ARRAYS = ("keys", "segments", "dense", "label", "show", "clk", "uid",
                "rank", "cmatch")


def same_record(a, b):
    np.testing.assert_array_equal(a.keys, b.keys)
    assert a.keys.dtype == b.keys.dtype
    np.testing.assert_array_equal(a.slot_offsets, b.slot_offsets)
    np.testing.assert_array_equal(a.dense, b.dense)
    assert a.dense.dtype == b.dense.dtype
    for f in REC_FIELDS:
        assert getattr(a, f) == getattr(b, f), f


def same_records(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        same_record(x, y)


def same_columnar(a, b):
    for f in COL_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        np.testing.assert_array_equal(x, y, err_msg=f)
        assert x.dtype == y.dtype, f


def same_batch(a, b):
    for f in BATCH_ARRAYS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                      err_msg=f)
        assert getattr(a, f).dtype == getattr(b, f).dtype, f
    for f in ("batch_size", "num_slots", "num_keys", "key_capacity",
              "segments_trivial", "pad_segment"):
        assert getattr(a, f) == getattr(b, f), f
    assert (a.ins_ids is None) == (b.ins_ids is None)
    if a.ins_ids is not None:
        np.testing.assert_array_equal(a.ins_ids, b.ins_ids)


def same_batches(a, b):
    a, b = list(a), list(b)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        same_batch(x, y)


def both(scenario, **flags):
    out = []
    for pkg in (PORT, JAX):
        with pkg["flags"](**flags):
            out.append(scenario(pkg))
    return out


def small_desc(pkg, bs=4):
    S = pkg["slot"]
    return pkg["desc"](
        slots=[S("label", "float", 1), S("s1", "uint64"),
               S("s2", "uint64"), S("d1", "float", 2)],
        batch_size=bs, parser="slot_text", label_slot="label",
        key_bucket_min=8)


def ext_desc(pkg, **kw):
    S = pkg["slot"]
    slots = [S("label", "float", 1), S("a", "uint64"), S("b", "uint64"),
             S("d", "float", 2)]
    return pkg["desc"](slots=slots, label_slot="label", batch_size=4, **kw)


def _write_slot_text(path, rows):
    with open(path, "w") as fh:
        for label, a_keys, b_keys, dense in rows:
            toks = ["1", str(label)]
            toks += [str(len(a_keys))] + [str(k) for k in a_keys]
            toks += [str(len(b_keys))] + [str(k) for k in b_keys]
            toks += ["2"] + [str(v) for v in dense]
            fh.write(" ".join(toks) + "\n")


ROWS = [(1.0, [11, 12], [21], [0.5, 1.5]),
        (0.0, [13], [22, 23], [2.5, 3.5]),
        (1.0, [14], [24], [4.5, 5.5]),
        (0.0, [15, 16, 17], [25], [6.5, 7.5])]


def _seeded_rows(n, seed):
    """Ragged slot_text rows from a numpy seed."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        out.append((float(rng.integers(0, 2)),
                    [int(k) for k in rng.integers(1, 50,
                                                  rng.integers(0, 4))],
                    [int(k) for k in rng.integers(100, 150,
                                                  rng.integers(1, 3))],
                    [float(np.float32(v)) for v in rng.normal(size=2)]))
    return out


# ---------------------------------------------------------------------------
# tests/test_data_pipeline.py
# ---------------------------------------------------------------------------

LINES = ["1 1.0 2 11 12 1 21 2 0.5 0.25", "1 1.0 1 13 2 22 23 2 0.1 0.2",
         "garbage", "1 1.0 5 1 2", "1 0.0 0 1 7 2 1e-3 -4.5"]


def test_slot_text_parser_roundtrip():
    p, j = SlotTextParser(small_desc(PORT)), JSlotTextParser(small_desc(JAX))
    for line in LINES:
        got, want = p.parse(line), j.parse(line)
        assert (got is None) == (want is None), line
        if got is not None:
            same_record(got, want)
    rec = p.parse(LINES[0])
    assert rec.label == 1.0
    np.testing.assert_array_equal(rec.slot_keys(0),
                                  np.array([11, 12], np.uint64))
    np.testing.assert_allclose(rec.dense, [0.5, 0.25])
    assert p.parse("garbage") is None and p.parse("1 1.0 5 1 2") is None


def test_criteo_parser_slot_salting():
    p = CriteoParser(DataFeedDesc.criteo(batch_size=2))
    j = JCriteoParser(JDesc.criteo(batch_size=2))
    lines = ["1\t" + "\t".join(str(i) for i in range(13)) + "\t"
             + "\t".join("ab" for _ in range(26)),
             "0\t" + "\t".join("" for _ in range(13)) + "\t"
             + "\t".join("" for _ in range(26)),
             "0\t-5\t" + "\t".join("3" for _ in range(12)) + "\t"
             + "\t".join(["zz", "0x1a", "ffffffffffffffffff"] + ["7"] * 23)]
    for line in lines:
        same_record(p.parse(line), j.parse(line))
    rec = p.parse(lines[0])
    assert rec.num_keys == 26 and len(np.unique(rec.keys)) == 26
    assert np.all(p.parse(lines[1]).dense == 0)


def test_batch_builder_layout():
    def run(pkg):
        desc = small_desc(pkg, bs=3)
        p = pkg["parser"].get_parser(desc)
        return pkg["builder"](desc).build([p.parse(LINES[0]),
                                           p.parse(LINES[1])])
    b, jb = both(run)
    same_batch(b, jb)
    np.testing.assert_array_equal(b.segments[:6], [0, 0, 1, 2, 3, 3])
    assert b.key_capacity == 8 and b.show[2] == 0.0


def test_key_bucket_ladder():
    for n in (1, 9, 16, 100, 5000):
        assert small_desc(PORT).key_capacity(n) == \
            small_desc(JAX).key_capacity(n)


def test_in_memory_dataset_end_to_end(tmp_path):
    files = generate_criteo_files(str(tmp_path), num_files=2,
                                  rows_per_file=200)

    def run(pkg):
        ds = pkg["factory"]().create_dataset(
            "InMemoryDataset", pkg["desc"].criteo(batch_size=64))
        ds.set_filelist(files)
        ds.set_thread(2)
        ds.load_into_memory()
        ds.local_shuffle(seed=1)
        return ds, ds.pass_keys(), list(ds.batches())

    (ds, keys, batches), (jds, jkeys, jbatches) = both(run)
    assert ds.parse_route == "native" and len(ds) == 400
    same_columnar(ds.columnar, jds.columnar)
    np.testing.assert_array_equal(keys, jkeys)
    same_batches(batches, jbatches)
    assert sum(b.show.sum() for b in batches) == 400


def test_queue_dataset_streams(tmp_path):
    files = generate_criteo_files(str(tmp_path), num_files=1,
                                  rows_per_file=100)

    def run(pkg):
        ds = pkg["factory"]().create_dataset(
            "QueueDataset", pkg["desc"].criteo(batch_size=32))
        ds.set_filelist(files)
        return ds, list(ds.batches())

    (ds, batches), (_, jbatches) = both(run, read_thread_num=1)
    same_batches(batches, jbatches)
    assert [int(b.show.sum()) for b in batches] == [32, 32, 32, 4]
    assert ds.parse_route == "python"


def test_paddlebox_dataset_pass_lifecycle(tmp_path):
    files = generate_criteo_files(str(tmp_path), num_files=1,
                                  rows_per_file=50)

    def run(pkg):
        ds = pkg["factory"]().create_dataset(
            "PaddleBoxDataset", pkg["desc"].criteo(16))
        ds.set_filelist(files)
        ds.set_date("20260729")
        events = []
        ds.on_begin_pass = lambda d: events.append(("begin", d.pass_id))
        ds.on_end_pass = lambda d, save: events.append(("end", d.pass_id,
                                                        save))
        ds.preload_into_memory()
        ds.wait_preload_done()
        records = list(ds.records)
        ds.begin_pass()
        ds.end_pass(need_save_delta=True)
        n_after = len(ds)
        ds.set_filelist(["/nonexistent/file.txt"])
        ds.preload_into_memory()
        with pytest.raises(FileNotFoundError):
            ds.wait_preload_done()
        return ds, records, events, n_after

    (ds, recs, events, n), (jds, jrecs, jevents, jn) = both(
        run, read_thread_num=1)
    same_records(recs, jrecs)
    assert len(recs) == 50 and ds.date == jds.date == "20260729"
    assert events == jevents == [("begin", 1), ("end", 1, True)]
    assert n == jn == 0
    assert ds.parse_route == "python"
    assert ds.parse_route_reason == "PaddleBoxDataset reads records"


def test_factory_rejects_unknown_and_aliases():
    with pytest.raises(KeyError):
        DatasetFactory().create_dataset("NoSuchDataset")
    for kind in ("BoxPSDataset", "PadBoxSlotDataset", "PaddleBoxDataset",
                 "InMemoryDataset", "QueueDataset"):
        assert type(DatasetFactory().create_dataset(kind)).__name__ == \
            type(JFactory().create_dataset(kind)).__name__


def test_columnar_batches_match_record_batches(tmp_path):
    files = generate_criteo_files(str(tmp_path), num_files=1,
                                  rows_per_file=150)

    def run(pkg):
        ds = pkg["factory"]().create_dataset(
            "InMemoryDataset", pkg["desc"].criteo(batch_size=64))
        ds.set_filelist(files)
        ds.load_into_memory()
        rec = list(ds.batches())
        records = list(ds.records)
        ds.columnarize()
        col = list(ds.batches())
        ds.local_shuffle(seed=3)
        return records, rec, col, ds.columnar

    (records, rec, col, shuf), (jrecords, jrec, jcol, jshuf) = both(
        run, native_parse=False, read_thread_num=1)
    same_records(records, jrecords)
    same_batches(rec, jrec)
    same_batches(col, jcol)
    same_batches(rec, col)
    same_columnar(shuf, jshuf)


def test_native_and_per_line_loads_agree(tmp_path):
    """The native load and the one-thread per-line load of the same
    criteo files give the same columnar store (dense within the
    reference's own native vs per-line tolerance), and each dataset
    records its route."""
    files = generate_criteo_files(str(tmp_path), num_files=3,
                                  rows_per_file=120, seed=4)
    loads = {}
    for native_parse in (True, False):
        with flags_scope(native_parse=native_parse, read_thread_num=1):
            ds = InMemoryDataset(DataFeedDesc.criteo(batch_size=32))
            ds.set_filelist(files)
            ds.load_into_memory()
            ds.columnarize()
            loads[native_parse] = ds
    a, b = loads[True], loads[False]
    assert (a.parse_route, b.parse_route) == ("native", "python")
    assert b.parse_route_reason == "FLAGS.native_parse is off"
    assert a.supports_cursor_resume and b.supports_cursor_resume
    for f in COL_FIELDS:
        if f == "dense":
            np.testing.assert_allclose(a.columnar.dense, b.columnar.dense,
                                       rtol=1e-6)
        else:
            np.testing.assert_array_equal(getattr(a.columnar, f),
                                          getattr(b.columnar, f))


def test_native_build_failure_raises_instead_of_falling_back(
        tmp_path, monkeypatch):
    """A parser library that cannot be built raises with the compiler's
    output; the load does not turn into the per-line route (nor
    quarantine the file, even with a budget)."""
    _write_slot_text(str(tmp_path / "x.txt"), ROWS)

    def broken():
        raise native.NativeBuildError("g++ failed for slot_parser.cpp")
    monkeypatch.setattr(native, "load", broken)
    with flags_scope(poison_budget_files=3):
        ds = InMemoryDataset(ext_desc(PORT))
        ds.set_filelist([str(tmp_path / "x.txt")])
        with pytest.raises(native.NativeBuildError, match="g\\+\\+"):
            ds.load_into_memory()
        assert ds.quarantined_files == [] and ds.parse_route is None


# ---------------------------------------------------------------------------
# tests/test_dataset_ext.py
# ---------------------------------------------------------------------------

def test_pipe_command_transforms_input(tmp_path):
    raw = tmp_path / "raw.txt"
    _write_slot_text(str(raw), ROWS)
    csv = tmp_path / "data.csv"
    csv.write_text(raw.read_text().replace(" ", ","))

    def run(pkg):
        ds = pkg["dataset"].InMemoryDataset(
            ext_desc(pkg, pipe_command="tr ',' ' '"))
        ds.set_filelist([str(csv)])
        ds.load_into_memory()
        return ds

    ds, jds = both(run, read_thread_num=1)
    same_records(ds.records, jds.records)
    assert len(ds.records) == 4 and ds.parse_route_reason == "pipe_command"
    assert list(ds.records[3].slot_keys(0)) == [15, 16, 17]


def test_pipe_command_failure_raises(tmp_path):
    f = tmp_path / "x.txt"
    _write_slot_text(str(f), ROWS)
    for pkg in (PORT, JAX):
        ds = pkg["dataset"].InMemoryDataset(ext_desc(pkg,
                                                     pipe_command="false"))
        ds.set_filelist([str(f)])
        with pytest.raises(RuntimeError, match="pipe_command"):
            ds.load_into_memory()


def test_pipe_command_queue_dataset(tmp_path):
    f = tmp_path / "x.txt"
    _write_slot_text(str(f), ROWS)

    def run(pkg):
        ds = pkg["dataset"].QueueDataset(ext_desc(pkg, pipe_command="cat"))
        ds.set_filelist([str(f)])
        ds.set_thread(1)
        return list(ds.batches())

    batches, jbatches = both(run)
    same_batches(batches, jbatches)
    assert sum(int((b.show > 0).sum()) for b in batches) == 4


def _make_inmem(pkg, rows, columnar):
    ds = pkg["dataset"].InMemoryDataset(ext_desc(pkg))
    parser = pkg["parser"].get_parser(ds.desc)
    lines = []
    for label, a_keys, b_keys, dense in rows:
        toks = ["1", str(label), str(len(a_keys)), *map(str, a_keys),
                str(len(b_keys)), *map(str, b_keys), "2", *map(str, dense)]
        lines.append(" ".join(toks))
    ds.records = [parser.parse(line) for line in lines]
    if columnar:
        ds.columnarize()
    return ds


def _result(ds):
    return ds.columnar if ds.columnar is not None else ds.records


def _same_store(a, b):
    if isinstance(a, list):
        same_records(a, b)
    else:
        same_columnar(a, b)


@pytest.mark.parametrize("columnar", [False, True])
@pytest.mark.parametrize("seed", [0, 5])
def test_slots_shuffle_both_stores_match_jax(columnar, seed):
    rows = _seeded_rows(40, seed=seed)

    def run(pkg):
        ds = _make_inmem(pkg, rows, columnar)
        with pytest.raises(RuntimeError):
            ds.slots_shuffle(["a"])
        ds.set_fea_eval(100, True)
        ds.slots_shuffle(["a"])
        return _result(ds)

    got, want = both(run, seed=seed)
    _same_store(got, want)
    # shuffled slot: global multiset preserved; untouched slot per record
    orig = _make_inmem(PORT, rows, True).columnar
    col = got if columnar else _make_columnar(got)
    np.testing.assert_array_equal(np.sort(col.keys[col.key_slot == 0]),
                                  np.sort(orig.keys[orig.key_slot == 0]))
    np.testing.assert_array_equal(col.keys[col.key_slot == 1],
                                  orig.keys[orig.key_slot == 1])


def _make_columnar(records):
    from paddlebox_tpu_torch.data.columnar import ColumnarRecords
    return ColumnarRecords.from_records(records, 2)


@pytest.mark.parametrize("columnar", [False, True])
def test_slots_shuffle_capped_candidates(columnar):
    """record_candidate_size < pass size → donors come from a capped
    pool; both packages draw the same pool from FLAGS.seed."""
    def run(pkg):
        ds = _make_inmem(pkg, ROWS * 16, columnar)   # 64 records
        ds.set_fea_eval(record_candidate_size=4)
        ds.slots_shuffle(["a"])
        return _result(ds)

    got, want = both(run, seed=3)
    _same_store(got, want)
    col = got if columnar else _make_columnar(got)
    assert set(col.keys[col.key_slot == 0].tolist()) <= {11, 12, 13, 14,
                                                         15, 16, 17}


def test_slots_shuffle_columnar_matches_batching():
    def run(pkg):
        ds = _make_inmem(pkg, ROWS * 8, True)
        ds.set_fea_eval()
        ds.slots_shuffle([0])
        return list(ds.batches())

    batches, jbatches = both(run)
    same_batches(batches, jbatches)
    assert sum(int((b.show > 0).sum()) for b in batches) == 32


@pytest.mark.parametrize("columnar", [False, True])
def test_local_shuffle_both_stores_match_jax(columnar):
    rows = _seeded_rows(30, seed=2)

    def run(pkg):
        ds = _make_inmem(pkg, rows, columnar)
        ds.local_shuffle()                      # FLAGS.seed
        first = [_result(ds)] if columnar else [list(ds.records)]
        ds.local_shuffle(seed=9)
        return first[0], _result(ds)

    (a1, a2), (b1, b2) = both(run, seed=4)
    _same_store(a1, b1)
    _same_store(a2, b2)


def test_global_shuffle_exchanges_records_before_the_local_shuffle():
    class Reverse:
        def exchange(self, records):
            return list(reversed(records))

    def run(pkg):
        ds = _make_inmem(pkg, _seeded_rows(12, seed=1), False)
        ds.global_shuffle(Reverse(), seed=2)
        out = list(ds.records)
        ds.columnarize()
        with pytest.raises(RuntimeError, match="record objects"):
            ds.global_shuffle(Reverse())
        return out

    got, want = both(run)
    same_records(got, want)


def test_merge_by_insid():
    def recs(cls):
        def rec(ins_id, a_keys, b_keys, label=1.0):
            keys = np.array(a_keys + b_keys, np.uint64)
            offs = np.array([0, len(a_keys), len(a_keys) + len(b_keys)],
                            np.int32)
            return cls(keys=keys, slot_offsets=offs,
                       dense=np.array([label], np.float32), label=label,
                       ins_id=ins_id)
        return [rec("x", [1], [10]), rec("x", [2, 3], [20]),
                rec("y", [4], [40]), rec("z", [5], [50]),
                rec("z", [6], [60])]

    for ms in (2, 0):
        merged, dropped = merge_by_insid(recs(SlotRecord), merge_size=ms,
                                         num_slots=2)
        jmerged, jdropped = j_merge_by_insid(recs(JRecord), merge_size=ms,
                                             num_slots=2)
        assert dropped == jdropped == (1 if ms == 2 else 0)
        same_records(merged, jmerged)


def test_dataset_merge_by_lineid(tmp_path):
    f = tmp_path / "x.txt"
    _write_slot_text(str(f), ROWS)

    def run(pkg):
        ds = pkg["dataset"].InMemoryDataset(ext_desc(pkg))
        ds.set_filelist([str(f)])
        ds.set_merge_by_lineid(0)  # ins_id empty for text loads → 1 group
        ds.load_into_memory()
        return ds

    ds, jds = both(run, read_thread_num=1)
    same_records(ds.records, jds.records)
    assert len(ds.records) == 1 and len(ds.records[0].slot_keys(0)) == 7
    assert (ds.parse_route, ds.parse_route_reason) == ("python",
                                                       "merge_by_lineid")
    with pytest.raises(RuntimeError, match="before columnarize"):
        ds.columnarize()
        ds.merge_records_by_insid()


def test_device_mem_used_on_the_cpu(monkeypatch):
    import torch

    from paddlebox_tpu_torch.utils import STATS
    from paddlebox_tpu_torch.utils.monitor import (device_mem_used,
                                                   log_device_mem)
    m = device_mem_used("cpu")
    assert m == {"bytes_in_use": 0, "peak_bytes_in_use": 0,
                 "bytes_limit": 0}
    # the card by default: without one it raises, never reads the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        device_mem_used()
    out = log_device_mem("test", device="cpu")
    assert set(out) == {"bytes_in_use", "peak_bytes_in_use", "bytes_limit"}
    assert STATS.get("hbm_test_bytes_in_use") == out["bytes_in_use"]


def test_parser_plugin_python_module(tmp_path):
    names = {}
    for pkg, mod in ((PORT, "paddlebox_tpu_torch"), (JAX, "paddlebox_tpu")):
        plug = tmp_path / f"my_parser_{mod}.py"
        plug.write_text(textwrap.dedent(f"""
            from {mod}.data.parser import SlotTextParser

            class UpperParser(SlotTextParser):
                pass

            PARSERS = {{"my_custom_{mod}": UpperParser}}
        """))
        names[mod] = pkg["parser"].load_parser_plugin(str(plug))
        d = ext_desc(pkg)
        d.parser = f"my_custom_{mod}"
        p = pkg["parser"].get_parser(d)
        assert type(p).__name__ == "UpperParser"
        names[mod + "_rec"] = p.parse(" ".join(
            ["1", "1", "2", "5", "6", "1", "7", "2", "0.5", "1.5"]))
    assert names["paddlebox_tpu_torch"] == ["my_custom_paddlebox_tpu_torch"]
    assert names["paddlebox_tpu"] == ["my_custom_paddlebox_tpu"]
    same_record(names["paddlebox_tpu_torch_rec"], names["paddlebox_tpu_rec"])


def test_parser_plugin_so(tmp_path):
    """A ``.so`` plugin compiled with g++ from the port's parser source
    (it exposes the bulk columnar ABI under ``slot_text_parse``), loaded
    by both packages under a ``:symbol`` spec: equal columnar output."""
    so = str(tmp_path / "libplug.so")
    subprocess.run(["g++", "-O2", "-std=c++17", "-fPIC", "-shared",
                    str(native.PARSER_SRC), "-o", so], check=True,
                   capture_output=True, timeout=300)
    f = tmp_path / "x.txt"
    _write_slot_text(str(f), ROWS + _seeded_rows(50, seed=8))
    outs = []
    for pkg, name in ((PORT, "plug_port"), (JAX, "plug_jax")):
        assert pkg["parser"].load_parser_plugin(
            so + ":slot_text_parse", name=name) == [name]
        d = ext_desc(pkg)
        d.parser = name
        outs.append(pkg["parser"].get_parser(d).parse_file_columnar(str(f)))
    got, want = outs
    assert sorted(got) == sorted(want)
    for k in got:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert len(got["label"]) == 54


# ---------------------------------------------------------------------------
# shard_filelist, pass keys, quarantine, the record pool
# ---------------------------------------------------------------------------

def test_shard_filelist(monkeypatch):
    files = [f"f{i}" for i in range(7)]
    for rank, world in ((0, 1), (0, 3), (2, 3), (1, 2)):
        assert tdataset.shard_filelist(files, rank, world) == \
            jdataset.shard_filelist(files, rank, world)
    monkeypatch.setenv("PBOX_RANK", "1")
    monkeypatch.setenv("PBOX_WORLD_SIZE", "3")
    assert tdataset.shard_filelist(files) == ["f1", "f4"] == \
        jdataset.shard_filelist(files)
    ds = InMemoryDataset()
    ds.set_filelist(files, shard_by_rank=True)
    assert ds.filelist == ["f1", "f4"]
    with pytest.raises(ValueError, match="out of range"):
        tdataset.shard_filelist(files, 3, 3)


def test_set_glob_and_fingerprint(tmp_path):
    for i in (2, 0, 1):
        (tmp_path / f"part-{i}.txt").write_text("")
    ds, jds = InMemoryDataset(), jdataset.InMemoryDataset()
    for d in (ds, jds):
        d.set_glob(str(tmp_path / "part-*.txt"))
    assert ds.filelist == jds.filelist
    assert [os.path.basename(p) for p in ds.filelist] == [
        "part-0.txt", "part-1.txt", "part-2.txt"]
    assert ds.filelist_fingerprint() == jds.filelist_fingerprint()


@pytest.mark.parametrize("columnar", [False, True])
def test_pass_keys_and_pass_key_slots(columnar):
    rows = _seeded_rows(30, seed=6)

    def run(pkg):
        ds = _make_inmem(pkg, rows, columnar)
        return ds.pass_keys(), ds.pass_key_slots()

    (keys, (k2, slots)), (jkeys, (jk2, jslots)) = both(run)
    np.testing.assert_array_equal(keys, jkeys)
    np.testing.assert_array_equal(k2, jk2)
    np.testing.assert_array_equal(slots, jslots)
    assert slots.dtype == jslots.dtype == np.int32
    # a key under two slots is refused in both packages
    clash = rows + [(1.0, [120], [120], [0.0, 0.0])]
    for pkg in (PORT, JAX):
        with pytest.raises(ValueError, match="more than one slot"):
            _make_inmem(pkg, clash, columnar).pass_key_slots()
    empty = InMemoryDataset(ext_desc(PORT))
    assert empty.pass_keys().dtype == np.uint64
    assert len(empty.pass_key_slots()[0]) == 0


@pytest.mark.parametrize("native_parse", [True, False])
def test_quarantine_within_budget(tmp_path, native_parse):
    """A file that fails to open is quarantined within the budget and
    the load goes on, the same in both packages and on both routes; a
    second bad file beyond the budget raises ``PoisonBudgetExceeded``."""
    good = [str(tmp_path / f"g{i}.txt") for i in range(3)]
    for i, p in enumerate(good):
        _write_slot_text(p, _seeded_rows(10, seed=i))
    missing = str(tmp_path / "missing.txt")
    files = [good[0], missing, good[1], good[2]]

    def run(pkg):
        ds = pkg["dataset"].InMemoryDataset(ext_desc(pkg))
        ds.set_filelist(files)
        ds.load_into_memory()
        ds.columnarize()
        return ds

    ds, jds = both(run, native_parse=native_parse, read_thread_num=1,
                   poison_budget_files=1, retry_max_attempts=1)
    assert [p for p, _ in ds.quarantined_files] == \
        [p for p, _ in jds.quarantined_files] == [missing]
    same_columnar(ds.columnar, jds.columnar)
    assert len(ds) == 30
    assert ds.parse_route == ("native" if native_parse else "python")
    with flags_scope(native_parse=native_parse, read_thread_num=1,
                     poison_budget_files=1, retry_max_attempts=1):
        ds = InMemoryDataset(ext_desc(PORT))
        ds.set_filelist(files + [str(tmp_path / "missing2.txt")])
        with pytest.raises(tdataset.PoisonBudgetExceeded,
                           match="budget exhausted"):
            ds.load_into_memory()


def test_poisoned_file_record_budget(tmp_path):
    """More unparseable lines than ``poison_budget_records`` poison the
    file: quarantined when the file budget allows, the same files in
    both packages; without a file budget the load fails."""
    good = str(tmp_path / "good.txt")
    _write_slot_text(good, ROWS)
    bad = str(tmp_path / "bad.txt")
    with open(bad, "w") as fh:
        fh.write("garbage\n" * 3 + "1 1 1 5 1 6 2 0.5 0.5\n")

    def run(pkg):
        ds = pkg["dataset"].InMemoryDataset(ext_desc(pkg))
        ds.set_filelist([good, bad])
        ds.load_into_memory()
        return ds

    ds, jds = both(run, native_parse=False, read_thread_num=1,
                   poison_budget_files=1, poison_budget_records=2)
    assert [p for p, _ in ds.quarantined_files] == \
        [p for p, _ in jds.quarantined_files] == [bad]
    assert "PoisonedFileError" in ds.quarantined_files[0][1]
    same_records(ds.records, jds.records)
    with flags_scope(native_parse=False, read_thread_num=1,
                     poison_budget_records=2):
        ds = InMemoryDataset(ext_desc(PORT))
        ds.set_filelist([good, bad])
        with pytest.raises(tdataset.PoisonedFileError, match="poison"):
            ds.load_into_memory()


def test_record_pool():
    from paddlebox_tpu_torch.data.record import global_record_pool
    pool = SlotRecordPool(max_size=3)
    recs = [SlotRecord(np.empty(0, np.uint64), np.zeros(1, np.int32),
                       np.empty(0, np.float32)) for _ in range(5)]
    pool.put(recs)
    assert pool.size() == 3
    got = pool.get(2)
    assert len(got) == 2 and pool.size() == 1
    pool.clear()
    assert pool.size() == 0 and pool.get(4) == []
    assert global_record_pool() is global_record_pool()
    assert global_record_pool()._max == FLAGS.record_pool_max_size


def test_in_memory_dataset_refuses_without_files():
    with pytest.raises(ValueError, match="set_filelist"):
        InMemoryDataset().load_into_memory()
    with pytest.raises(ValueError, match="set_filelist"):
        next(QueueDataset().batches())
    assert get_parser(DataFeedDesc.criteo()).__class__ is CriteoParser
