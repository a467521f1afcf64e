"""The port's host key index against the JAX package's ``NativeKV``, on the
CPU: the port's ``NativeKV`` (its own build of ``native/kv_index.cpp``)
and its python ``PyKV`` run the same calls as the reference's native
index, on seeded numpy keys, and every output must match exactly: rows,
inverses, freed rows, ``items()`` as a dict, lengths and the arena's
chunk map. The cases mirror ``tests/test_native_kv.py``; the last ones
cover the dedup, the loader's build and the route that ``make_kv`` takes.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from paddlebox_tpu.native import load_native as j_load_native
from paddlebox_tpu.ps.kv import NativeKV as JNativeKV
from paddlebox_tpu.ps.kv import TableFullError as JTableFullError
from paddlebox_tpu.ps.table import _dedup_first_seen_py as j_dedup_py
from paddlebox_tpu.ps.table import dedup_first_seen as j_dedup

from paddlebox_tpu_torch import native
from paddlebox_tpu_torch.ps import kv as tkv
from paddlebox_tpu_torch.ps.kv import NativeKV, PyKV, TableFullError

ROOT = Path(__file__).resolve().parents[1]


def _trio(capacity):
    """(reference NativeKV, port NativeKV, port PyKV) of one capacity."""
    jlib = j_load_native()
    assert jlib is not None, "the reference's native index must build here"
    return (JNativeKV(capacity, jlib), NativeKV(capacity, native.load()),
            PyKV(capacity))


def _check(want, got):
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want)
        for w, g in zip(want, got):
            _check(w, g)
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want


def _items(kv):
    keys, rows = kv.items()
    return dict(zip(keys.tolist(), rows.tolist()))


def _same(kvs, op):
    """Run ``op`` on every index; the port's outputs must equal the
    reference's exactly. Returns the reference's."""
    ref, *port = kvs
    want = op(ref)
    for kv in port:
        _check(want, op(kv))
    return want


def _same_state(kvs):
    ref, *port = kvs
    for kv in port:
        assert len(kv) == len(ref)
        assert _items(kv) == _items(ref)


def _keys(a):
    return np.asarray(a, np.uint64)


def test_routes_name_themselves():
    _, nat, py = _trio(8)
    assert (nat.kv_route, py.kv_route) == ("native", "python")
    assert tkv.make_kv(8).kv_route == "native"


def test_randomized_assign_lookup_release():
    rng = np.random.default_rng(0)
    kvs = _trio(5000)
    for _ in range(20):
        keys = rng.integers(0, 3000, size=500).astype(np.uint64)
        _same(kvs, lambda kv: kv.assign(keys))
        probe = rng.integers(0, 6000, size=200).astype(np.uint64)
        _same(kvs, lambda kv: kv.lookup(probe))
        rel = rng.integers(0, 3000, size=50).astype(np.uint64)
        # freed rows in key order, reused last-freed first
        _same(kvs, lambda kv: kv.release(rel))
        _same_state(kvs)


def test_edge_keys_and_reuse():
    kvs = _trio(8)
    edge = _keys([0, 1, 2**64 - 1, 2**64 - 2])
    rows = _same(kvs, lambda kv: kv.assign(edge))
    assert len(set(rows.tolist())) == 4
    _same(kvs, lambda kv: kv.assign(edge))
    _same(kvs, lambda kv: kv.lookup(edge))
    freed = _same(kvs, lambda kv: kv.release(edge[:2]))
    assert len(freed) == 2
    assert _same(kvs, lambda kv: kv.lookup(edge[:1]))[0] == -1
    r_new = _same(kvs, lambda kv: kv.assign(_keys([12345])))
    assert r_new[0] in freed
    _same_state(kvs)


def test_capacity_exhaustion():
    kvs = _trio(4)
    _same(kvs, lambda kv: kv.assign(np.arange(4, dtype=np.uint64)))
    for kv, err in zip(kvs, (JTableFullError, TableFullError,
                             TableFullError)):
        with pytest.raises(err):
            kv.assign(_keys([99]))
    # a failed assign corrupts nothing
    rows = _same(kvs, lambda kv: kv.lookup(np.arange(4, dtype=np.uint64)))
    assert (rows >= 0).all()
    _same_state(kvs)


def test_churn_tombstone_rehash():
    """assign/release churn: many tombstone rehashes of the native table,
    the mappings exact throughout."""
    kvs = _trio(64)
    rng = np.random.default_rng(2)
    for round_ in range(200):
        keys = (rng.integers(0, 2**62, size=50)
                + round_ * 1000).astype(np.uint64)
        _same(kvs, lambda kv: kv.assign(keys))
        _same(kvs, lambda kv: kv.release(keys))
    assert all(len(kv) == 0 for kv in kvs)
    keep = rng.integers(0, 2**62, size=40).astype(np.uint64)
    rows = _same(kvs, lambda kv: kv.assign(keep))
    for _ in range(100):
        junk = rng.integers(2**62, 2**63, size=20).astype(np.uint64)
        _same(kvs, lambda kv: kv.assign(junk))
        _same(kvs, lambda kv: kv.release(junk))
    np.testing.assert_array_equal(_same(kvs, lambda kv: kv.lookup(keep)),
                                  rows)
    _same_state(kvs)


def test_assign_unique_first_seen():
    """Fused dedup + assign: the same unique rows, in first-occurrence
    order, and the same inverse on every index."""
    rng = np.random.default_rng(3)
    kvs = _trio(5000)
    for _ in range(10):
        keys = rng.integers(0, 800, size=600).astype(np.uint64)
        r, inv = _same(kvs, lambda kv: kv.assign_unique(keys))
        assert len(r) == len(np.unique(keys))
        np.testing.assert_array_equal(r[inv], kvs[0].lookup(keys))
    _same_state(kvs)


def test_assign_unique_row_reuse_after_release():
    kvs = _trio(64)
    a = _keys([1, 2, 3])
    r_a, _ = _same(kvs, lambda kv: kv.assign_unique(a))
    _same(kvs, lambda kv: kv.release(a))
    b = _keys([7, 8, 9, 7])
    r_b, inv_b = _same(kvs, lambda kv: kv.assign_unique(b))
    assert sorted(r_b.tolist()) == sorted(r_a.tolist())
    assert len(r_b) == 3 and inv_b[0] == inv_b[3]
    _same_state(kvs)


def test_assign_unique_table_full_midway():
    kvs = _trio(2)
    for kv, err in zip(kvs, (JTableFullError, TableFullError,
                             TableFullError)):
        with pytest.raises(err):
            kv.assign_unique(_keys([1, 1, 2, 3]))
    # keys assigned before the failure still resolve, on every index
    assert _same(kvs, lambda kv: kv.lookup(_keys([1, 2, 3]))).tolist() \
        == [0, 1, -1]
    _same_state(kvs)


@pytest.mark.parametrize("where", ["head", "middle", "tail", "all", "none"])
def test_lookup_unique_miss_collapse(where):
    """Unknown keys share one sentinel entry, placed where the first miss
    occurs; known keys come in first-occurrence order."""
    sent = 9999
    kvs = _trio(64)
    _same(kvs, lambda kv: kv.assign(_keys([10, 20, 30, 40])))
    probe = {"head": [555, 20, 10, 666, 20, 555, 40],
             "middle": [20, 555, 10, 666, 20, 555],
             "tail": [30, 20, 30, 10, 777, 888, 777],
             "all": [777, 888, 777],
             "none": [40, 10, 40, 30]}[where]
    r, inv = _same(kvs, lambda kv: kv.lookup_unique(_keys(probe), sent))
    assert len(set(r.tolist())) == len(r)
    assert (r == sent).sum() == (0 if where == "none" else 1)
    got = r[inv]
    rows = kvs[0].lookup(_keys(probe))
    np.testing.assert_array_equal(got, np.where(rows < 0, sent, rows))
    _same_state(kvs)


def test_lookup_unique_randomized():
    rng = np.random.default_rng(4)
    kvs = _trio(4096)
    keys = rng.integers(0, 2000, size=1500).astype(np.uint64)
    _same(kvs, lambda kv: kv.assign(keys))
    for _ in range(10):
        probe = rng.integers(0, 4000, size=700).astype(np.uint64)
        _same(kvs, lambda kv: kv.lookup_unique(probe, 4096))
    _same(kvs, lambda kv: kv.lookup_unique(np.zeros(0, np.uint64), 4096))


def _arena_trio(capacity, chunk_bits, n_slots):
    kvs = _trio(capacity)
    for kv in kvs:
        kv.arena_enable(chunk_bits, n_slots)
    return kvs


def test_arena_slotted_assign_roundtrip():
    cb = 4
    kvs = _arena_trio(1 << 12, cb, 8)
    rng = np.random.default_rng(3)
    keys = rng.integers(0, 500, size=400).astype(np.uint64)
    slots = (keys % 8).astype(np.uint16)
    rows, locs = _same(kvs, lambda kv: kv.assign_slotted(keys, slots))
    cs_map, cr_map = _same(kvs, lambda kv: kv.arena_export())
    assert (locs >= 0).all()
    chunk_of = rows >> cb
    np.testing.assert_array_equal(cs_map[chunk_of], slots.astype(np.int32))
    np.testing.assert_array_equal(
        (cr_map[chunk_of] << cb) | (rows & ((1 << cb) - 1)), locs)
    again = _same(kvs, lambda kv: kv.assign_slotted(keys, slots))
    _check((rows, locs), again)
    _same_state(kvs)


def test_arena_foreign_row_flags_minus_one():
    kvs = _arena_trio(256, 4, 4)
    k = _keys([7, 8])
    _same(kvs, lambda kv: kv.assign(k))     # slotless → default arena
    _, locs = _same(kvs, lambda kv: kv.assign_slotted(
        k, np.array([1, 2], np.uint16)))
    assert (locs == -1).all()
    _, locs2 = _same(kvs, lambda kv: kv.assign_slotted(
        _keys([9]), np.array([1], np.uint16)))
    assert locs2[0] >= 0
    _same(kvs, lambda kv: kv.arena_export())


def test_arena_release_reuses_within_slot():
    kvs = _arena_trio(256, 3, 4)
    keys = np.arange(20, dtype=np.uint64)
    rows, _ = _same(kvs, lambda kv: kv.assign_slotted(
        keys, np.full(20, 2, np.uint16)))
    _same(kvs, lambda kv: kv.release(keys[:5]))
    nrows, nlocs = _same(kvs, lambda kv: kv.assign_slotted(
        np.arange(100, 105, dtype=np.uint64), np.full(5, 2, np.uint16)))
    assert set(nrows.tolist()) == set(rows[:5].tolist())
    assert (nlocs >= 0).all()
    _same_state(kvs)


def test_arena_assign_unique_slotted():
    """First-seen slotted dedup over several slots: new keys take rows in
    the arena of their first occurrence's slot, in first-occurrence
    order, on every index."""
    kvs = _arena_trio(1 << 10, 4, 4)
    keys = _keys([5, 9, 5, 13, 9, 5])
    slots = np.array([1, 2, 3, 3, 0, 1], np.uint16)
    uniq_rows, inv = _same(kvs, lambda kv: kv.assign_unique_slotted(
        keys, slots))
    assert len(uniq_rows) == 3
    rng = np.random.default_rng(5)
    for _ in range(5):
        keys = rng.integers(0, 300, size=400).astype(np.uint64)
        slots = rng.integers(0, 4, size=400).astype(np.uint16)
        _same(kvs, lambda kv: kv.assign_unique_slotted(keys, slots))
    _same(kvs, lambda kv: kv.arena_export())
    _same_state(kvs)


def test_arena_enable_after_assign_raises():
    for kv in _trio(64):
        kv.assign(_keys([1]))
        with pytest.raises(RuntimeError):
            kv.arena_enable(4, 4)


def test_arena_out_of_range_slot_clamps_to_default():
    kvs = _arena_trio(256, 4, 4)
    rows, locs = _same(kvs, lambda kv: kv.assign_slotted(
        _keys([1, 2]), np.array([100, 4], np.uint16)))
    assert (locs == -1).all() and (rows >= 0).all()
    _, l2 = _same(kvs, lambda kv: kv.assign_slotted(
        _keys([3]), np.array([1], np.uint16)))
    assert l2[0] >= 0
    _same_state(kvs)


@pytest.mark.parametrize("n,pool", [(0, 1), (1, 1), (5000, 700),
                                    (3000, 2**64 - 1)])
def test_dedup_first_seen_native_and_oracle(n, pool):
    rng = np.random.default_rng(n)
    keys = rng.integers(0, pool, size=n, dtype=np.uint64)
    want = j_dedup(keys)
    _check(want, j_dedup_py(keys))
    _check(want, tkv.dedup_first_seen_native(keys))
    _check(want, tkv.dedup_first_seen_py(keys))


def test_make_kv_takes_the_python_route_loudly(monkeypatch, caplog):
    def broken():
        raise RuntimeError("g++ failed for kv_index.cpp")
    monkeypatch.setattr(native, "load", broken)
    with caplog.at_level("WARNING"):
        kv = tkv.make_kv(16)
    assert isinstance(kv, PyKV) and kv.kv_route == "python"
    assert "python route" in caplog.text
    assert tkv.dedup_first_seen_native(_keys([3, 1, 3])) is None


def test_failed_build_raises_with_the_compiler_output(tmp_path,
                                                      monkeypatch):
    src = tmp_path / "kv_index.cpp"
    src.write_text("int broken( {\n")
    monkeypatch.setattr(native, "SRC", src)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "out")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed") as e:
        native.build()
    assert "error" in str(e.value)
    assert not list((tmp_path / "out").glob("*"))


def test_library_builds_under_build_dir():
    native.load()
    so = native.library_path(native._cxx())
    assert so.exists() and so.parent == ROOT / "build" / "native"
    src_dir = ROOT / "paddlebox_tpu_torch" / "native"
    assert sorted(p.name for p in src_dir.iterdir()
                  if p.name != "__pycache__") == ["__init__.py",
                                                   "kv_index.cpp"]


def test_two_processes_build_at_once(tmp_path):
    """Two processes that find no build compile at once into one build
    directory; both load a working library and no temp file is left."""
    code = (
        "import sys; from pathlib import Path\n"
        "import numpy as np\n"
        "from paddlebox_tpu_torch import native\n"
        "from paddlebox_tpu_torch.ps.kv import NativeKV\n"
        "native.BUILD_DIR = Path(sys.argv[1])\n"
        "kv = NativeKV(16, native.load())\n"
        "rows = kv.assign(np.array([7, 9, 7], np.uint64))\n"
        "assert rows.tolist() == [0, 1, 0], rows\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = tmp_path / "build"
    procs = [subprocess.Popen([sys.executable, "-c", code, str(out)],
                              cwd=tmp_path, env=env,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    for p in procs:
        _, err = p.communicate(timeout=240)
        assert p.returncode == 0, err
    assert [p.suffix for p in out.iterdir()] == [".so"]


def test_table_threads_share_the_native_index():
    """The native index is not thread-safe and ctypes drops the GIL
    around its calls: every table path holds ``host_lock`` around them.
    Threads (more than cores) that assign, look up and read one table at
    once must leave a key → row bijection that every lookup agrees
    with."""
    import threading

    from paddlebox_tpu_torch.ps.table import EmbeddingTable
    table = EmbeddingTable(mf_dim=4, capacity=1 << 18, device="cpu")
    assert table.index.kv_route == "native"
    n_threads, rounds = 2 * (os.cpu_count() or 4), 40
    errors = []

    def work(t):
        rng = np.random.default_rng(t)
        try:
            for _ in range(rounds):
                keys = rng.integers(0, 200000, size=2000).astype(np.uint64)
                rows, inv = table.bulk_assign_unique(
                    keys, np.zeros(len(keys), np.int16))
                got = table.host_pull(keys)
                if got.shape != (len(keys), 3 + 4):
                    errors.append("host_pull shape")
                with table.host_lock:
                    now = table.index.lookup(keys)
                if not np.array_equal(now, rows[inv]):
                    errors.append("rows moved")
        except Exception as e:  # noqa: BLE001 -- reported below
            errors.append(repr(e))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(t,))
                   for t in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
    assert not errors, errors[:5]
    keys, rows = table.index.items()
    assert len(set(rows.tolist())) == len(rows) == len(table.index)
    np.testing.assert_array_equal(table.index.lookup(keys), rows)
    assert sorted(rows.tolist()) == list(range(len(rows)))
