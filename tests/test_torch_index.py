"""The port's device key index (``paddlebox_tpu_torch/ops/index.py``,
``ops/device_unique.py``) against the JAX package, on the CPU.

The port runs the plain versions of its insert and lookup kernels (CPU
tensors). The JAX side runs its XLA formulations (``use_pallas=False``):
the reference states that they and its Pallas kernels give identical
rows and new-masks, and its Pallas formulation needs
``jax.experimental.pallas.load``, which the installed JAX may lack; the
Pallas case runs where it has it.

Everything here is exact: the hash, the dedup, rows, new-masks, overflow
flags and lookups. Bucket placement is never compared, only the logical
key→row mapping.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch
from jax.experimental import pallas as pl

from paddlebox_tpu.ops import pallas_index as jpi
from paddlebox_tpu.ops.device_unique import (
    dedup_keys_first_seen as j_dedup)
from paddlebox_tpu.ps.table import dedup_first_seen as j_host_dedup

from paddlebox_tpu_torch.ops import index as tix
from paddlebox_tpu_torch.ops import kernels as tk
from paddlebox_tpu_torch.ops.device_unique import dedup_keys_first_seen
from paddlebox_tpu_torch.ps.kv import PyKV
from paddlebox_tpu_torch.ps.kv import dedup_first_seen_py as dedup_first_seen


def _t(keys: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(keys, np.uint64)
                            .view(np.int64).copy())


def _awkward_keys(rng, n: int, pool: int = 400) -> np.ndarray:
    """uint64 ids with key 0, the all-ones id, ids that differ only in
    the high word, and ids that collide mod 2^32."""
    base = rng.integers(0, 2 ** 63, size=pool, dtype=np.uint64)
    base[:4] = [0, np.uint64(2 ** 64 - 1), 7, np.uint64(7 + (1 << 32))]
    base[4:8] = base[8:12] ^ np.uint64(0xABCD << 40)     # high word only
    keys = base[rng.integers(0, pool, size=n)]
    m = min(n, 12)
    keys[:m] = base[:m]
    return keys


def test_hash32_bitwise():
    rng = np.random.default_rng(0)
    keys = _awkward_keys(rng, 5000)
    hi, lo = jpi.split_keys(keys)
    want = np.asarray(jpi._hash32(jnp.asarray(hi), jnp.asarray(lo)))
    got = tix._hash32(_t(keys)).numpy()
    assert got.min() >= 0 and got.max() < 2 ** 32
    np.testing.assert_array_equal(got.astype(np.uint32), want)


@pytest.mark.parametrize("seed,n,pad", [(1, 3000, 200), (2, 513, 0),
                                        (3, 1, 7), (4, 0, 5)])
def test_dedup_keys_first_seen_bitwise(seed, n, pad):
    rng = np.random.default_rng(seed)
    keys = _awkward_keys(rng, n + pad)
    if n and pad:
        keys[n:] = keys[rng.integers(0, n, size=pad)]  # stale real bits
    uniq, first_pos, inv, u = dedup_keys_first_seen(_t(keys), n)
    k = n + pad
    assert uniq.shape == first_pos.shape == inv.shape == (k,)

    hi, lo = jpi.split_keys(keys)
    juh, jul, jfp, jinv, jnu = j_dedup(jnp.asarray(hi), jnp.asarray(lo),
                                       jnp.int32(n))
    assert u == int(jnu)
    np.testing.assert_array_equal(
        uniq[:u].numpy().view(np.uint64),
        jpi.join_keys(np.asarray(juh)[:u], np.asarray(jul)[:u]))
    np.testing.assert_array_equal(first_pos.numpy(), np.asarray(jfp))
    np.testing.assert_array_equal(inv[:n].numpy(), np.asarray(jinv)[:n])
    assert (inv[n:].numpy() == u).all()

    hu, hfirst, hinv = dedup_first_seen(keys[:n])
    ju, jfirst, jinv_h = j_host_dedup(keys[:n])
    for want_u, want_f, want_i in ((hu, hfirst, hinv), (ju, jfirst, jinv_h)):
        np.testing.assert_array_equal(uniq[:u].numpy().view(np.uint64),
                                      want_u)
        np.testing.assert_array_equal(first_pos[:u].numpy(), want_f)
        np.testing.assert_array_equal(inv[:n].numpy(), want_i)


class _JaxIndex:
    """The reference's bucket arrays driven through its XLA (or Pallas)
    insert/lookup."""

    def __init__(self, n_buckets: int, use_pallas: bool) -> None:
        self.bh = jnp.zeros(n_buckets, jnp.int32)
        self.bl = jnp.zeros(n_buckets, jnp.int32)
        self.br = jnp.full(n_buckets, -1, jnp.int32)
        self.use_pallas = use_pallas

    def insert(self, uniq, next_row):
        n = len(uniq)
        hi, lo = jpi.split_keys(uniq)
        bh, bl, br, rows, new, ovf = jpi.insert(
            self.bh, self.bl, self.br, jnp.asarray(jpi._pad_to_block(hi)),
            jnp.asarray(jpi._pad_to_block(lo)), jnp.int32(n),
            jnp.int32(next_row), use_pallas=self.use_pallas)
        if not bool(ovf):
            self.bh, self.bl, self.br = bh, bl, br
        return (np.asarray(rows)[:n], np.asarray(new)[:n].astype(bool),
                bool(ovf))

    def lookup(self, keys):
        n = len(keys)
        hi, lo = jpi.split_keys(keys)
        rows = jpi.lookup(self.bh, self.bl, self.br,
                          jnp.asarray(jpi._pad_to_block(hi)),
                          jnp.asarray(jpi._pad_to_block(lo)), jnp.int32(n),
                          use_pallas=self.use_pallas)
        return np.asarray(rows)[:n]


def _port_index(n_buckets: int):
    return (torch.zeros(n_buckets, dtype=torch.int64),
            torch.full((n_buckets,), -1, dtype=torch.int32))


@pytest.mark.parametrize("use_pallas", [False, True],
                         ids=["xla", "pallas"])
def test_insert_and_lookup_match_reference(use_pallas):
    if use_pallas and not hasattr(pl, "load"):
        pytest.skip("the reference's Pallas index kernels need "
                    "jax.experimental.pallas.load, which this JAX lacks")
    rng = np.random.default_rng(5)
    nb, cap = 4096, 1500
    ref = _JaxIndex(nb, use_pallas)
    bkeys, brows = _port_index(nb)
    before = tix.insert.launches
    pool = _awkward_keys(rng, 1400, pool=1400)
    next_row, seen = 0, []
    # chained calls, each stream deduped and first-seen ordered, with keys
    # of earlier calls mixed in; next_row moves with every call
    for call in range(5):
        keys, _, _ = dedup_first_seen(pool[rng.integers(0, 1400, size=500)])
        want_rows, want_new, want_ovf = ref.insert(keys, next_row)
        rows, new, failed = tix.insert(bkeys, brows, _t(keys), next_row, cap)
        assert bool(failed) is want_ovf is False
        np.testing.assert_array_equal(rows.numpy(), want_rows)
        np.testing.assert_array_equal(new.numpy().astype(bool), want_new)
        next_row += int(want_new.sum())
        seen.append(keys)
    assert tix.insert.launches == before            # CPU: the plain version
    assert int((brows >= 0).sum()) == next_row
    # every inserted key looks up to the same row in both indexes, and
    # misses miss in both
    allk = np.concatenate(seen)
    miss = rng.integers(2 ** 63, 2 ** 64 - 1, size=300, dtype=np.uint64)
    probe = np.concatenate([allk, miss, allk[:50]])
    got = tix.lookup(bkeys, brows, _t(probe)).numpy()
    np.testing.assert_array_equal(got, ref.lookup(probe))
    np.testing.assert_array_equal(got, tix.lookup_plain(bkeys, brows,
                                                        _t(probe)).numpy())
    assert (got[len(allk):len(allk) + len(miss)] == -1).all()
    assert (got[:len(allk)] >= 0).all()


def _snapshot(bkeys, brows):
    live = brows >= 0
    return brows.clone(), torch.where(live, bkeys, 0)


@pytest.mark.parametrize("kind", ["probe", "capacity"])
def test_overflow_leaves_the_index_unchanged(kind):
    rng = np.random.default_rng(6)
    nb = 512
    ref = _JaxIndex(nb, False)
    bkeys, brows = _port_index(nb)
    first, _, _ = dedup_first_seen(_awkward_keys(rng, 200, pool=300))
    _, want_new, _ = ref.insert(first, 0)
    rows, new, failed = tix.insert(bkeys, brows, _t(first), 0, 10_000)
    assert not bool(failed)
    n0 = int(new.sum())
    assert n0 == int(want_new.sum())
    snap = _snapshot(bkeys, brows)
    before = tix.lookup(bkeys, brows, _t(first))
    if kind == "probe":
        # 600 more distinct keys cannot fit in 512 buckets
        more = rng.integers(1, 2 ** 62, size=600, dtype=np.uint64)
        _, _, want_ovf = ref.insert(more, n0)
        assert want_ovf
        *_, failed = tix.insert(bkeys, brows, _t(more), n0, 10_000)
    else:
        more = rng.integers(1, 2 ** 62, size=50, dtype=np.uint64)
        *_, failed = tix.insert(bkeys, brows, _t(more), n0, n0 + 49)
    assert bool(failed)
    after = _snapshot(bkeys, brows)
    assert torch.equal(after[0], snap[0]) and torch.equal(after[1], snap[1])
    assert torch.equal(tix.lookup(bkeys, brows, _t(first)), before)
    assert (tix.lookup(bkeys, brows, _t(more)) == -1).all()


def test_device_key_index_seed_assign_and_lookup():
    rng = np.random.default_rng(7)
    cap = 3000
    kv = PyKV(cap)
    kv.assign(np.unique(_awkward_keys(rng, 800)))
    dev = tix.DeviceKeyIndex(cap, device="cpu")
    assert dev.n_buckets == 8192
    assert dev.seed_from_kv(kv) and dev.next_row == len(kv)
    keys, rows = kv.items()
    np.testing.assert_array_equal(dev.lookup_rows(keys), rows)
    # the raw-id front door against host dedup + the host kv
    raw = _awkward_keys(rng, 2000, pool=1500)
    uniq, first, inv, rows_u, new = dev.assign_raw(raw)
    hu, hfirst, hinv = dedup_first_seen(raw)
    np.testing.assert_array_equal(uniq, hu)
    np.testing.assert_array_equal(first, hfirst)
    np.testing.assert_array_equal(inv, hinv)
    pre = len(kv)
    np.testing.assert_array_equal(rows_u, kv.assign(hu))
    np.testing.assert_array_equal(new, rows_u >= pre)
    assert dev.next_row == len(kv)
    # a kv whose rows are not dense cannot be mirrored
    holes = type("Holes", (), {"items": lambda self: (
        np.array([5, 9], np.uint64), np.array([0, 2], np.int32))})()
    assert not tix.DeviceKeyIndex(cap, device="cpu").seed_from_kv(holes)


def test_device_key_index_plain_ops_and_overflow_returns_none():
    rng = np.random.default_rng(8)
    dev = tix.DeviceKeyIndex(100, n_buckets=512, device="cpu",
                             ops=tk.PLAIN)
    keys = np.unique(rng.integers(0, 2 ** 60, size=80, dtype=np.uint64))
    rows, new = dev.assign_unique(keys)
    np.testing.assert_array_equal(rows, np.arange(len(keys)))
    assert new.all() and dev.next_row == len(keys)
    more = np.unique(rng.integers(2 ** 60, 2 ** 61, size=60,
                                  dtype=np.uint64))
    assert dev.assign_unique(more) is None            # past capacity 100
    assert dev.next_row == len(keys)
    assert (dev.lookup_rows(more) == -1).all()
    np.testing.assert_array_equal(dev.lookup_rows(keys), rows)



@pytest.mark.parametrize("use_pallas", [False, True],
                         ids=["xla", "pallas"])
def test_plain_on_bucket_views_matches_separate_arrays(use_pallas):
    """The plain insert and lookup on the views of one bucket tensor
    (``new_buckets``, the layout the kernels take) give the rows of
    separate arrays and of the reference, a failed call leaves both
    layouts' live buckets as they were, and the pad word stays 0."""
    if use_pallas and not hasattr(pl, "load"):
        pytest.skip("the reference's Pallas index kernels need "
                    "jax.experimental.pallas.load, which this JAX lacks")
    rng = np.random.default_rng(9)
    nb, cap = 2048, 900
    ref = _JaxIndex(nb, use_pallas)
    buckets = tix.new_buckets(nb, "cpu")
    views = tix.bucket_views(buckets)
    sep = _port_index(nb)
    pool = _awkward_keys(rng, 1000, pool=1000)
    next_row = 0
    for call in range(4):
        keys, _, _ = dedup_first_seen(pool[rng.integers(0, 1000, size=400)])
        want_rows, want_new, _ = ref.insert(keys, next_row)
        for index in (views, sep):
            rows, new, failed = tix.insert(*index, _t(keys), next_row, cap)
            assert not bool(failed)
            np.testing.assert_array_equal(rows.numpy(), want_rows)
            np.testing.assert_array_equal(new.numpy().astype(bool), want_new)
        next_row += int(want_new.sum())
    more = rng.integers(2 ** 63, 2 ** 64 - 1, size=50, dtype=np.uint64)
    for index in (views, sep):
        snap = _snapshot(*index)
        *_, failed = tix.insert(*index, _t(more), next_row, next_row + 49)
        assert bool(failed)
        after = _snapshot(*index)
        assert torch.equal(after[0], snap[0]) and torch.equal(after[1],
                                                              snap[1])
    probe = np.concatenate([pool, more, pool[:30]])
    want = ref.lookup(probe)
    for index in (views, sep):
        np.testing.assert_array_equal(tix.lookup(*index, _t(probe)).numpy(),
                                      want)
    assert int((buckets[:, 2] >= 0).sum()) == next_row
    assert not bool(buckets[:, 3].any())


def test_device_key_index_views_share_one_buffer():
    rng = np.random.default_rng(10)
    dev = tix.DeviceKeyIndex(100, n_buckets=512, device="cpu")
    b = dev.buckets
    assert b.shape == (512, 4) and b.dtype == torch.int32
    assert dev.keys.data_ptr() == b.data_ptr()
    assert dev.rows.data_ptr() == b.data_ptr() + 8
    assert dev.keys.untyped_storage().data_ptr() == \
        dev.rows.untyped_storage().data_ptr() == b.untyped_storage().data_ptr()
    assert tix._bucket_base(dev.keys, dev.rows) == b.data_ptr()
    keys = np.unique(rng.integers(0, 2 ** 64 - 1, size=80, dtype=np.uint64))
    rows, new = dev.assign_unique(keys)
    assert new.all()
    live = b[:, 2] >= 0
    np.testing.assert_array_equal(
        np.sort(b[live].contiguous().view(torch.int64)[:, 0].numpy()
                .view(np.uint64)), keys)
    np.testing.assert_array_equal(np.sort(b[live, 2].numpy()),
                                  np.arange(len(keys)))
    assert not bool(b[:, 3].any())


def _layout(kind: str, nb: int = 64):
    """(bkeys, brows) in one of the layouts ``_bucket_base`` is held to."""
    b = tix.new_buckets(nb, "cpu")
    if kind == "views":
        return tix.bucket_views(b)
    if kind == "separate":
        return _port_index(nb)
    if kind == "two_tensors":
        return (tix.bucket_views(b)[0],
                tix.bucket_views(tix.new_buckets(nb, "cpu"))[1])
    if kind == "int32_keys":
        return b[:, 0], b[:, 2]
    if kind == "int64_rows":
        return tix.bucket_views(b)[0], b.view(torch.int64)[:, 1]
    if kind == "stride_32_bytes":
        wide = torch.zeros((nb, 8), dtype=torch.int32)
        return wide.view(torch.int64)[:, 0], wide[:, 2]
    if kind == "rows_offset":
        return tix.bucket_views(b)[0], b[:, 3]
    if kind == "misaligned":
        flat = torch.zeros(4 * nb + 2, dtype=torch.int32)
        return tix.bucket_views(flat[2:].view(nb, 4))
    if kind == "no_pad":
        flat = torch.zeros(4 * nb - 1, dtype=torch.int32)
        keys = flat[:4 * nb - 2].view(torch.int64).as_strided((nb,), (2,))
        return keys, flat.as_strided((nb,), (4,), 2)
    raise ValueError(kind)


@pytest.mark.parametrize("kind,err", [
    ("views", None), ("separate", ValueError), ("two_tensors", ValueError),
    ("int32_keys", TypeError), ("int64_rows", TypeError),
    ("stride_32_bytes", ValueError), ("rows_offset", ValueError),
    ("misaligned", ValueError), ("no_pad", ValueError)])
def test_bucket_base_accepts_only_one_bucket_tensor(kind, err):
    bkeys, brows = _layout(kind)
    if err is None:
        assert tix._bucket_base(bkeys, brows) == bkeys.data_ptr()
    else:
        with pytest.raises(err):
            tix._bucket_base(bkeys, brows)
