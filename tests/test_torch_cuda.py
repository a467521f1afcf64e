"""The port's CUDA kernels on the card, against their plain versions.

These tests need an NVIDIA GPU and skip without one. They import neither
jax nor the JAX package, so they run on a machine that has only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerances: the gathers, the scatter-add and the key index are exact;
the pool holds the pooling-forward class, rtol 3e-5 / atol 1e-6, and a
training run on the card against the same run on the CPU (other
summation orders in the tower) holds the ragged train-state class, rtol
2e-4 / atol 2e-5.
"""

import numpy as np
import pytest
import torch

from paddlebox_tpu_torch import (DeepFM, EmbeddingTable, InMemoryDataset,
                                 ServingModel, Trainer)
from paddlebox_tpu_torch.convert import table_rows_from_logical
from paddlebox_tpu_torch.data import (BatchBuilder, DataFeedDesc, SlotDef,
                                      SlotRecord)
from paddlebox_tpu_torch.ops import kernels as tk

RTOL, ATOL = 3e-5, 1e-6


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _ragged(rng, b=64, s=7, d=11, drop=0.05):
    n = b * s
    seg = np.repeat(np.arange(n, dtype=np.int32), rng.poisson(3.0, size=n))
    seg[rng.random(len(seg)) < drop] = -1            # drop markers
    segments = np.full(len(seg) + 300, n, np.int32)  # tail pads
    segments[:len(seg)] = seg
    values = rng.normal(size=(len(segments), d)).astype(np.float32)
    values[:, :3] = np.abs(values[:, :3]) * 4     # show/clk/conv counts
    keep = (rng.random(len(segments)) < 0.8).astype(np.float32)
    return values, segments, keep, b, s


@pytest.mark.cuda
@pytest.mark.parametrize("feat", [16, 13])   # vector and scalar paths
def test_gather_rows_exact(cuda, feat):
    rng = np.random.default_rng(feat)
    table = torch.from_numpy(
        rng.normal(size=(5001, feat)).astype(np.float32)).to(cuda)
    rows = torch.from_numpy(
        rng.integers(-2, 5100, size=3000).astype(np.int32)).to(cuda)
    got = tk.gather_rows(table, rows)
    torch.cuda.synchronize()
    assert torch.equal(got, tk.gather_rows_plain(table, rows))


@pytest.mark.cuda
@pytest.mark.parametrize("mode,offset", [(tk.CVM_NONE, 2), (tk.CVM_FULL, 2),
                                         (tk.CVM_FULL, 3), (tk.CVM_SHOW, 2),
                                         (tk.CVM_CONV, 3)])
def test_pool_cvm_matches_plain(cuda, mode, offset):
    rng = np.random.default_rng(mode)
    values, segments, keep, b, s = _ragged(rng)
    v, sg, kp = (torch.from_numpy(x).to(cuda)
                 for x in (values, segments, keep))
    got = tk.pool_cvm(v, sg, kp, b, s, mode, offset, 0, 0.25)
    ref = tk.pool_cvm_plain(v, sg, kp, b, s, mode, offset, 0, 0.25)
    torch.testing.assert_close(got, ref, rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
def test_serving_on_card_matches_cpu(cuda):
    """The whole serving path on the card (both kernels launched once per
    predict) against the same ServingModel on the CPU (plain versions).
    f32 tower: only the pooling order differs."""
    rng = np.random.default_rng(0)
    S, mf, vocab, bs = 5, 4, 50, 32
    keys = np.arange(S * vocab, dtype=np.uint64)
    rows = rng.normal(size=(len(keys), 8 + mf)).astype(np.float32)
    rows[:, 0:2] = np.abs(rows[:, 0:2]) * 10
    rows[:, 7] = 1.0
    blob = table_rows_from_logical(keys, rows, mf)
    slots = [SlotDef("dense", "float", 3)] + [
        SlotDef(f"C{i}", "uint64") for i in range(S)]
    desc = DataFeedDesc(slots=slots, batch_size=bs)
    recs = []
    for _ in range(bs):
        counts = 1 + rng.poisson(2.0, size=S)
        offs = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
        k = (rng.integers(0, vocab + 5, size=offs[-1]).astype(np.uint64)
             + np.repeat(np.arange(S, dtype=np.uint64) * np.uint64(vocab),
                         counts))
        recs.append(SlotRecord(keys=k, slot_offsets=offs,
                               dense=rng.normal(size=3).astype(np.float32)))
    batch = BatchBuilder(desc).build(recs)
    torch.manual_seed(0)
    model = DeepFM(S, 3 + mf, 3, hidden=(16, 8), compute_dtype=torch.float32)
    preds = {}
    for dev in ("cpu", "cuda"):
        srv = ServingModel(model, desc, mf_dim=mf, capacity=1 << 12,
                           device=dev)
        srv.load_base(blob)
        srv.load_params(model.state_dict())
        before = (tk.gather_rows.launches, tk.pool_cvm.launches)
        preds[dev] = srv.predict(batch)
        after = (tk.gather_rows.launches, tk.pool_cvm.launches)
        assert [a - b for a, b in zip(after, before)] == (
            [1, 1] if dev == "cuda" else [0, 0])
    np.testing.assert_allclose(preds["cuda"], preds["cpu"], rtol=1e-5,
                               atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("w", [9, 3])      # widths not divisible by 4
def test_segment_gather_exact(cuda, w):
    rng = np.random.default_rng(w)
    n, k = 700, 5000
    block = torch.from_numpy(
        rng.normal(size=(n, w + 2)).astype(np.float32)).to(cuda)
    ids = torch.from_numpy(
        rng.integers(-3, n + 5, size=k).astype(np.int32)).to(cuda)
    for src in (block[:, :w], block[:, 2:].contiguous()):   # strided too
        got = tk.segment_gather(src, ids)
        torch.cuda.synchronize()
        assert torch.equal(got, tk.segment_gather_plain(src, ids))
    # the fused seqpool-grad epilogue: head, ets zeros, mask
    b, s = 70, 10
    head = torch.from_numpy(
        rng.normal(size=(b, 2)).astype(np.float32)).to(cuda)
    mask = torch.from_numpy(
        (rng.random(k) < 0.7).astype(np.float32)).to(cuda)
    for ets in (0, 1):
        got = tk.segment_gather(block[:, :w], ids, head, mask, b, s, ets)
        want = tk.segment_gather_plain(block[:, :w], ids, head, mask, b, s,
                                       ets)
        torch.cuda.synchronize()
        assert got.shape == (k, 2 + ets + w) and torch.equal(got, want)


@pytest.mark.cuda
def test_segment_gather_empty_and_all_dropped(cuda):
    src = torch.ones((5, 9), device=cuda)
    before = tk.segment_gather.launches
    empty = tk.segment_gather(src, torch.zeros(0, dtype=torch.int32,
                                                device=cuda))
    assert empty.shape == (0, 9) and tk.segment_gather.launches == before
    ids = torch.tensor([-1, 5, 99, -7], dtype=torch.int32, device=cuda)
    got = tk.segment_gather(src, ids)
    no_src = tk.segment_gather(src[:0], ids)
    torch.cuda.synchronize()
    assert torch.equal(got, torch.zeros_like(got))
    assert torch.equal(no_src, torch.zeros_like(no_src))


@pytest.mark.cuda
@pytest.mark.parametrize("feat", [16, 13])   # vector and scalar paths
def test_scatter_add_update_exact(cuda, feat):
    rng = np.random.default_rng(feat)
    c, u = 6000, 4000
    table = torch.from_numpy(
        rng.normal(size=(c, feat)).astype(np.float32)).to(cuda)
    rows = rng.permutation(c + 500)[:u].astype(np.int32) - 200
    rows = torch.from_numpy(rows).to(cuda)        # negatives and OOB drop
    deltas = torch.from_numpy(
        rng.normal(size=(u, feat)).astype(np.float32)).to(cuda)
    got = tk.scatter_add_update(table.clone(), rows, deltas)
    want = tk.scatter_add_update_plain(table.clone(), rows, deltas)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    # empty and all-dropped inputs leave the table as it was
    none = torch.zeros(0, dtype=torch.int32, device=cuda)
    same = tk.scatter_add_update(table.clone(), none,
                                 deltas[:0].contiguous())
    dropped = tk.scatter_add_update(
        table.clone(), torch.full((u,), -1, dtype=torch.int32, device=cuda),
        deltas)
    torch.cuda.synchronize()
    assert torch.equal(same, table) and torch.equal(dropped, table)


@pytest.mark.cuda
def test_training_on_card_matches_cpu(cuda):
    """Two passes of the training slice on the card (all four kernels,
    each launched once per step) against the same run on the CPU (plain
    versions). f32 tower, TF32 off; lazy mf creation draws nothing
    (mf_initial_range 0), so the generators do not matter."""
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(1)
    S, mf, bs = 4, 4, 64
    slots = [SlotDef("label", "float", 1), SlotDef("d", "float", 3)] + [
        SlotDef(f"S{i}", "uint64") for i in range(S)]
    desc = DataFeedDesc(slots=slots, label_slot="label", batch_size=bs,
                        key_bucket_min=512)
    recs = []
    for i in range(4 * bs):
        counts = np.minimum(rng.zipf(1.5, size=S), 8)
        offs = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
        recs.append(SlotRecord(
            keys=rng.integers(0, 3000, size=offs[-1]).astype(np.uint64),
            slot_offsets=offs, dense=rng.normal(size=3).astype(np.float32),
            label=float(i % 2), show=1.0, clk=float(i % 2)))
    from paddlebox_tpu_torch.ps.sgd import SparseSGDConfig
    cfg = SparseSGDConfig(mf_create_thresholds=0.0, mf_initial_range=0.0)
    torch.manual_seed(0)
    model = DeepFM(S, 3 + mf, 3, hidden=(16, 8), compute_dtype=torch.float32)
    out = {}
    for dev in ("cpu", "cuda"):
        table = EmbeddingTable(mf_dim=mf, capacity=1 << 12, cfg=cfg,
                               unique_bucket_min=512, device=dev)
        m = DeepFM(S, 3 + mf, 3, hidden=(16, 8), compute_dtype=torch.float32)
        m.load_state_dict(model.state_dict())
        tr = Trainer(m, table, desc, seed=3, check_nan_inf=True, device=dev)
        ds = InMemoryDataset(desc)
        ds.records = recs
        names = ("gather_rows", "pool_cvm", "segment_gather",
                 "scatter_add_update")
        before = [getattr(tk, n).launches for n in names]
        res = [tr.train_pass(ds) for _ in range(2)]
        after = [getattr(tk, n).launches for n in names]
        steps = 2 * res[0]["batches"]
        assert [a - b for a, b in zip(after, before)] == (
            [steps] * 4 if dev == "cuda" else [0] * 4)
        keys, rows = table.index.items()
        order = np.argsort(keys)
        out[dev] = (keys[order], table.state.data.cpu().numpy()[rows[order]],
                    {k: v.cpu().numpy() for k, v in m.state_dict().items()},
                    res[1]["auc"])
        assert not table.state.data[-1].any()          # sentinel stays 0
    np.testing.assert_array_equal(out["cuda"][0], out["cpu"][0])
    np.testing.assert_allclose(out["cuda"][1], out["cpu"][1], rtol=2e-4,
                               atol=2e-5)
    for name, want in out["cpu"][2].items():
        np.testing.assert_allclose(out["cuda"][2][name], want, rtol=2e-4,
                                   atol=2e-5, err_msg=name)
    assert abs(out["cuda"][3] - out["cpu"][3]) < 1e-5


def _key_pool(rng, n):
    base = rng.integers(0, 2 ** 63, size=n, dtype=np.uint64)
    base[:3] = [0, 7, 7 + (1 << 32)]        # collide mod 2^32
    return base


def _index_keys(rng, n, pool):
    """n keys drawn from ``pool`` (an array, or the size of a new one)."""
    if isinstance(pool, int):
        pool = _key_pool(rng, pool)
    keys = pool[rng.integers(0, len(pool), size=n)]
    return torch.from_numpy(keys.view(np.int64))


def _buckets(nb, device):
    return (torch.zeros(nb, dtype=torch.int64, device=device),
            torch.full((nb,), -1, dtype=torch.int32, device=device))


@pytest.mark.cuda
def test_key_index_insert_and_lookup_match_plain(cuda):
    """Chained inserts through the kernel and through the plain version
    give the same rows and new-masks (exact; the bucket placement may
    differ), and every key looks up to its row in both indexes."""
    from paddlebox_tpu_torch.ops import index as tix
    from paddlebox_tpu_torch.ops.device_unique import dedup_keys_first_seen
    rng = np.random.default_rng(11)
    nb, cap = 1 << 16, 1 << 15
    kern, plain = _buckets(nb, cuda), _buckets(nb, cuda)
    next_row, seen = 0, []
    before = tix.insert.launches
    pool = _key_pool(rng, 30_000)           # calls share keys
    for _ in range(4):
        raw = _index_keys(rng, 20_000, pool).to(cuda)
        uniq, _, _, u = dedup_keys_first_seen(raw)
        uniq = uniq[:u].contiguous()
        r1, n1, f1 = tix.insert(*kern, uniq, next_row, cap)
        r2, n2, f2 = tix.insert_plain(*plain, uniq, next_row, cap)
        torch.cuda.synchronize()
        assert not bool(f1) and not bool(f2)
        assert torch.equal(r1, r2) and torch.equal(n1, n2)
        next_row += int(n1.sum())
        seen.append(uniq)
    assert tix.insert.launches == before + 4
    keys = torch.cat(seen + [_index_keys(rng, 5000, 5000).to(cuda)])
    got = tix.lookup(*kern, keys)
    assert torch.equal(got, tix.lookup_plain(*kern, keys))
    assert torch.equal(got, tix.lookup_plain(*plain, keys))
    n_seen = sum(len(s) for s in seen)
    assert (got[:n_seen] >= 0).all()
    assert int((kern[1] >= 0).sum()) == next_row


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["probe", "capacity"])
def test_key_index_overflow_rolls_back(cuda, kind):
    from paddlebox_tpu_torch.ops import index as tix
    rng = np.random.default_rng(12)
    nb = 512
    bkeys, brows = _buckets(nb, cuda)
    first = torch.unique(_index_keys(rng, 200, 200)).to(cuda)
    _, new, failed = tix.insert(bkeys, brows, first, 0, 10_000)
    assert not bool(failed)
    n0 = int(new.sum())
    rows0, keys0 = brows.clone(), torch.where(brows >= 0, bkeys, 0)
    if kind == "probe":
        more = torch.unique(_index_keys(rng, 700, 10_000)).to(cuda)
        *_, failed = tix.insert(bkeys, brows, more, n0, 10_000)
    else:
        more = torch.unique(_index_keys(rng, 60, 10_000)).to(cuda)
        more = more[(tix.lookup(bkeys, brows, more) < 0)].contiguous()
        *_, failed = tix.insert(bkeys, brows, more, n0, n0 + len(more) - 1)
    torch.cuda.synchronize()
    assert bool(failed)
    assert torch.equal(brows, rows0)
    assert torch.equal(torch.where(brows >= 0, bkeys, 0), keys0)
    assert (tix.lookup(bkeys, brows, first) >= 0).all()


@pytest.mark.cuda
def test_dedup_keys_first_seen_on_card_matches_host(cuda):
    from paddlebox_tpu_torch.ops.device_unique import dedup_keys_first_seen
    from paddlebox_tpu_torch.ps.kv import dedup_first_seen
    keys = _index_keys(np.random.default_rng(13), 100_000, 40_000)
    uniq, first, inv, u = dedup_keys_first_seen(keys.to(cuda))
    hu, hf, hi = dedup_first_seen(keys.numpy().view(np.uint64))
    assert u == len(hu)
    np.testing.assert_array_equal(uniq[:u].cpu().numpy().view(np.uint64), hu)
    np.testing.assert_array_equal(first[:u].cpu().numpy(), hf)
    np.testing.assert_array_equal(inv.cpu().numpy(), hi)


@pytest.mark.cuda
def test_resident_pass_on_card_matches_cpu(cuda):
    """Two resident passes with the device key index on the card (insert
    kernel for the bulk assignment, the four step kernels per step)
    against the same passes on the CPU. f32 tower, TF32 off, no lazy-mf
    draws; rows exact, state within rtol 2e-4 / atol 2e-5."""
    from paddlebox_tpu_torch.config import flags_scope
    from paddlebox_tpu_torch.ops import index as tix
    from paddlebox_tpu_torch.ps.sgd import SparseSGDConfig
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(14)
    S, mf, bs = 4, 4, 64
    slots = [SlotDef("label", "float", 1), SlotDef("d", "float", 3)] + [
        SlotDef(f"S{i}", "uint64") for i in range(S)]
    desc = DataFeedDesc(slots=slots, label_slot="label", batch_size=bs,
                        key_bucket_min=512)
    recs = []
    for i in range(4 * bs):
        counts = np.minimum(rng.zipf(1.5, size=S), 8)
        offs = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
        keys = (np.repeat(np.arange(S, dtype=np.uint64), counts)
                * np.uint64(10_000)
                + rng.integers(0, 600, size=offs[-1]).astype(np.uint64))
        recs.append(SlotRecord(keys=keys, slot_offsets=offs,
                               dense=rng.normal(size=3).astype(np.float32),
                               label=float(i % 2), show=1.0,
                               clk=float(i % 2)))
    cfg = SparseSGDConfig(mf_create_thresholds=0.0, mf_initial_range=0.0)
    torch.manual_seed(0)
    model = DeepFM(S, 3 + mf, 3, hidden=(16, 8), compute_dtype=torch.float32)
    out = {}
    for dev in ("cpu", "cuda"):
        table = EmbeddingTable(mf_dim=mf, capacity=1 << 12, cfg=cfg,
                               unique_bucket_min=512, device=dev)
        m = DeepFM(S, 3 + mf, 3, hidden=(16, 8), compute_dtype=torch.float32)
        m.load_state_dict(model.state_dict())
        tr = Trainer(m, table, desc, seed=3, check_nan_inf=True, device=dev)
        ds = InMemoryDataset(desc)
        ds.records = recs
        before = (tix.insert.launches, tk.pool_cvm.launches)
        with flags_scope(use_pallas_index=True):
            res = [tr.train_pass_resident(ds) for _ in range(2)]
        after = (tix.insert.launches, tk.pool_cvm.launches)
        assert [a - b for a, b in zip(after, before)] == (
            [2, 8] if dev == "cuda" else [0, 0])
        assert not table._dev_index.degraded
        keys, rows = table.index.items()
        order = np.argsort(keys)
        out[dev] = (keys[order], rows[order],
                    table.state.data.cpu().numpy()[rows[order]],
                    {k: v.cpu().numpy() for k, v in m.state_dict().items()},
                    res[1]["auc"])
    np.testing.assert_array_equal(out["cuda"][0], out["cpu"][0])
    np.testing.assert_array_equal(out["cuda"][1], out["cpu"][1])
    np.testing.assert_allclose(out["cuda"][2], out["cpu"][2], rtol=2e-4,
                               atol=2e-5)
    for name, want in out["cpu"][3].items():
        np.testing.assert_allclose(out["cuda"][3][name], want, rtol=2e-4,
                                   atol=2e-5, err_msg=name)
    assert abs(out["cuda"][4] - out["cpu"][4]) < 1e-5
