"""The port's CUDA kernels on the card, against their plain versions.

These tests need an NVIDIA GPU and skip without one. They import neither
jax nor the JAX package, so they run on a machine that has only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerances: the gathers, the scatter-add and the key index are exact;
rank_attention holds rtol 1e-5 / atol 1e-6 and batch_fc rtol 1e-6 /
atol 1e-6 (float32 sums in another order); cross_norm is exact but for
its dot column (rtol 1e-5 / atol 1e-6);
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
# vector and scalar paths; 37 and 23: the Adam and shared-Adam rows (mf 8)
@pytest.mark.parametrize("feat", [16, 13, 37, 23])
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


def _gather_once(*args):
    """segment_gather(*args), asserting one launch."""
    before = tk.segment_gather.launches
    got = tk.segment_gather(*args)
    assert tk.segment_gather.launches == before + 1
    return got


@pytest.mark.cuda
# widths not divisible by 4, w = 1, and 150 (tiles of fewer keys than
# lanes: csrc/segment_gather.cu stages at most 509 floats a warp)
@pytest.mark.parametrize("w", [9, 3, 1, 150])
def test_segment_gather_exact(cuda, w):
    rng = np.random.default_rng(w)
    n, k = 700, 5000
    block = torch.from_numpy(
        rng.normal(size=(n, w + 2)).astype(np.float32)).to(cuda)
    ids = torch.from_numpy(
        rng.integers(-3, n + 5, size=k).astype(np.int32)).to(cuda)
    for src in (block[:, :w], block[:, 2:].contiguous()):   # strided too
        got = _gather_once(src, ids)
        torch.cuda.synchronize()
        assert torch.equal(got, tk.segment_gather_plain(src, ids))
    # the fused seqpool-grad epilogue: head, ets zeros, mask
    b, s = 70, 10
    head = torch.from_numpy(
        rng.normal(size=(b, 2)).astype(np.float32)).to(cuda)
    mask = torch.from_numpy(
        (rng.random(k) < 0.7).astype(np.float32)).to(cuda)
    for ets in (0, 1):
        got = _gather_once(block[:, :w], ids, head, mask, b, s, ets)
        want = tk.segment_gather_plain(block[:, :w], ids, head, mask, b, s,
                                       ets)
        torch.cuda.synchronize()
        assert got.shape == (k, 2 + ets + w) and torch.equal(got, want)


def _gather_into(out, src, ids, head=None, mask=None, b=1, s=1, ets=0):
    """pbx_segment_gather called straight into ``out`` (any 4-byte
    offset: the wrapper's own output is always 16-byte aligned)."""
    from paddlebox_tpu_torch.ops import _build
    fn = _build.function("segment_gather", "pbx_segment_gather",
                         tk._SEG_GATHER_ARGS)
    n, w = src.shape
    _build.check(fn(src.data_ptr(), src.stride(0), ids.data_ptr(),
                    None if head is None else head.data_ptr(),
                    None if mask is None else mask.data_ptr(),
                    out.data_ptr(), ids.shape[0], n, w,
                    0 if head is None else head.shape[1], ets, s, b,
                    _build.stream(ids)), "segment_gather")


@pytest.mark.cuda
@pytest.mark.parametrize("w", [9, 3, 4100])   # 4100: past a tile's staging
def test_segment_gather_layouts(cuda, w):
    """Bit-equal to the plain version where the new tiles can slip: an
    output base at each 4-byte offset mod 16 (K * d not a multiple of 4),
    a src base that is not 16-byte aligned, an odd row stride, K = 1, all
    pads, one segment's run longer than a tile, and ids >= N, -1 and
    below -S with head and mask."""
    rng = np.random.default_rng(w + 7)
    b, s = 9, 5
    n = b * s
    k = 37 if w > 1000 else 3001
    block = torch.from_numpy(
        rng.normal(size=(n, w + 4)).astype(np.float32)).to(cuda)
    head = torch.from_numpy(
        rng.normal(size=(b, 3)).astype(np.float32)).to(cuda)
    wild = np.array([-1, -2, -s, -s - 1, -n, -n - 1, -5 * n, n, 7 * n,
                     -2 ** 31, 2 ** 31 - 1], np.int32)
    ids_np = rng.integers(0, n, size=k).astype(np.int32)
    odd = rng.random(k) < 0.3
    ids_np[odd] = rng.choice(wild, size=int(odd.sum()))
    mask = torch.from_numpy(
        (rng.random(k) < 0.8).astype(np.float32)).to(cuda)
    cases = {"mixed": ids_np, "one key": ids_np[:1],
             "all pads": np.full(k, n, np.int32),
             "one long run": np.full(k, 4, np.int32)}
    for name, ids_c in cases.items():
        ids = torch.from_numpy(ids_c).to(cuda)
        m = mask[:ids.shape[0]]
        for src in (block[:, :w], block[:, 1:1 + w]):   # odd ld; base + 4
            for args in ((src, ids), (src, ids, head, m, b, s, 0),
                         (src, ids, head, None, b, s, 2)):
                want = tk.segment_gather_plain(*args)
                got = _gather_once(*args)
                torch.cuda.synchronize()
                assert torch.equal(got, want), name
                flat = torch.full((want.numel() + 3,), float("nan"),
                                  device=cuda)
                for off in (1, 2, 3):
                    out = flat[off:off + want.numel()].view(want.shape)
                    _gather_into(out, *args)
                    torch.cuda.synchronize()
                    assert torch.equal(out, want), (name, off)


@pytest.mark.cuda
def test_segment_gather_errors(cuda):
    """The wrapper's one combined check raises each error the separate
    checks raise, and launches nothing."""
    src = torch.zeros((8, 5), device=cuda)
    ids = torch.zeros(6, dtype=torch.int32, device=cuda)
    head = torch.zeros((2, 2), device=cuda)
    mask = torch.ones(6, device=cuda)
    bad = [
        ((src.cpu(), ids), ValueError, "tensors on"),
        ((src, ids.long()), TypeError, "int32 ids"),
        ((src.double(), ids), TypeError, "float32"),
        ((src, ids, head, mask.double(), 2, 3), TypeError, "float32"),
        ((src, ids[::2]), ValueError, "non-contiguous"),
        ((src.t(), ids), ValueError, "contiguous columns"),
        ((src[0], ids), ValueError, "contiguous columns"),
        ((src, ids, head, None, 3, 3), ValueError, "head"),
        ((src, ids, head, None, 2, 0), ValueError, "head"),
        ((src, ids, None, None, 0, 0, 1), ValueError, "ets"),
        ((src, ids, None, mask[:5]), ValueError, "mask"),
        ((src, ids, head.t(), None, 2, 3), ValueError, "non-contiguous"),
    ]
    before = tk.segment_gather.launches
    for args, exc, match in bad:
        with pytest.raises(exc, match=match):
            tk.segment_gather(*args)
    assert tk.segment_gather.launches == before


@pytest.mark.cuda
def test_segment_gather_padded_bucket(cuda):
    """The training path's shapes: a ragged batch's segment stream padded
    to its key bucket with segment B*S, the strided src g[:, 2:] of the
    pooled grad (ld 11, w 9) and the batch show/clk head: the pads are
    zero rows, the real keys the grad rows."""
    rng = np.random.default_rng(5)
    _, segments, keep, b, s = _ragged(rng, b=512, s=26)
    pad = 1 << int(np.ceil(np.log2(len(segments))))
    ids = np.full(pad, b * s, np.int32)
    ids[:len(segments)] = segments
    ids = torch.from_numpy(ids).to(cuda)
    g = torch.from_numpy(
        rng.normal(size=(b * s, 11)).astype(np.float32)).to(cuda)
    head = torch.from_numpy(
        np.abs(rng.normal(size=(b, 2))).astype(np.float32)).to(cuda)
    mask = torch.ones(pad, device=cuda)
    mask[:len(keep)] = torch.from_numpy(keep).to(cuda)
    for args in ((g[:, 2:], ids, head, None, b, s),
                 (g[:, 2:], ids, head, mask, b, s), (g[:, 2:], ids)):
        got = _gather_once(*args)
        want = tk.segment_gather_plain(*args)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        assert not got[len(segments):].any()


@pytest.mark.cuda
def test_segment_gather_empty_and_all_dropped(cuda):
    src = torch.ones((5, 9), device=cuda)
    before = tk.segment_gather.launches
    empty = tk.segment_gather(src, torch.zeros(0, dtype=torch.int32,
                                                device=cuda))
    assert empty.shape == (0, 9) and tk.segment_gather.launches == before
    ids = torch.tensor([-1, 5, 99, -7], dtype=torch.int32, device=cuda)
    got = _gather_once(src, ids)
    no_src = _gather_once(src[:0], ids)
    masked = _gather_once(src, ids.abs() % 5, None,
                          torch.zeros(4, device=cuda))
    torch.cuda.synchronize()
    assert torch.equal(got, torch.zeros_like(got))
    assert torch.equal(no_src, torch.zeros_like(no_src))
    assert torch.equal(masked, torch.zeros_like(masked))


@pytest.mark.cuda
# vector and scalar paths; 37 and 23: the Adam and shared-Adam rows (mf 8)
@pytest.mark.parametrize("feat", [16, 13, 37, 23])
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


@pytest.mark.cuda
@pytest.mark.parametrize("shared", [False, True])
def test_lifecycle_on_card_matches_cpu(cuda, shared, tmp_path):
    """A sparse Adam table on the card and on the CPU: the same training
    pass, shrink, merge_model of the pre-shrink save and another pass.
    Row ids, freed rows and feature counts match exactly (show/clk are
    exact counts on both); the rows hold the ragged train-state class."""
    torch.backends.cuda.matmul.allow_tf32 = False
    from paddlebox_tpu_torch.ps.sgd import SparseAdamConfig
    rng = np.random.default_rng(5)
    S, mf, bs = 4, 8, 64
    slots = [SlotDef("label", "float", 1), SlotDef("d", "float", 3)] + [
        SlotDef(f"S{i}", "uint64") for i in range(S)]
    desc = DataFeedDesc(slots=slots, label_slot="label", batch_size=bs,
                        key_bucket_min=512)
    recs = []
    for i in range(3 * bs):
        counts = np.minimum(rng.zipf(1.5, size=S), 8)
        offs = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
        recs.append(SlotRecord(
            keys=rng.integers(0, 2000, size=offs[-1]).astype(np.uint64),
            slot_offsets=offs, dense=rng.normal(size=3).astype(np.float32),
            label=float(i % 2), show=1.0, clk=float(i % 2)))
    cfg = SparseAdamConfig(shared=shared, mf_create_thresholds=0.0,
                           mf_initial_range=0.0)
    torch.manual_seed(0)
    model = DeepFM(S, 3 + mf, 3, hidden=(16, 8), compute_dtype=torch.float32)
    out = {}
    for dev in ("cpu", "cuda"):
        table = EmbeddingTable(mf_dim=mf, capacity=1 << 12, cfg=cfg,
                               unique_bucket_min=512, device=dev)
        assert table.state.feat == (23 if shared else 37)
        m = DeepFM(S, 3 + mf, 3, hidden=(16, 8), compute_dtype=torch.float32)
        m.load_state_dict(model.state_dict())
        tr = Trainer(m, table, desc, seed=3, check_nan_inf=True, device=dev)
        ds = InMemoryDataset(desc)
        ds.records = recs
        tr.train_pass(ds)
        path = str(tmp_path / f"{dev}.npz")
        n_saved = table.save_base(path)
        keys0, rows0 = table.index.items()
        freed = table.shrink(1.5)
        gone = np.sort(rows0[table.index.lookup(keys0) < 0])
        assert 0 < freed == len(gone) < n_saved
        assert not table.state.data[torch.from_numpy(gone).long().to(
            dev)].any()
        assert table.merge_model(path) == n_saved
        tr.train_pass(ds)
        keys, rows = table.index.items()
        order = np.argsort(keys)
        out[dev] = (keys[order], rows[order], gone, table.feature_count,
                    table.state.data.cpu().numpy()[rows[order]])
        assert not table.state.data[-1].any()          # sentinel stays 0
    for i in range(4):
        np.testing.assert_array_equal(out["cuda"][i], out["cpu"][i])
    np.testing.assert_allclose(out["cuda"][4], out["cpu"][4], rtol=2e-4,
                               atol=2e-5)


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


def _index(nb, device):
    """(keys, rows) views of an empty bucket tensor of ``nb`` buckets."""
    from paddlebox_tpu_torch.ops import index as tix
    return tix.bucket_views(tix.new_buckets(nb, device))


def _uniq(raw):
    from paddlebox_tpu_torch.ops.device_unique import dedup_keys_first_seen
    uniq, _, _, u = dedup_keys_first_seen(raw)
    return uniq[:u].contiguous()


@pytest.mark.cuda
def test_key_index_insert_and_lookup_match_plain(cuda):
    """Chained inserts through the kernel and through the plain version
    give the same rows and new-masks (exact; the bucket placement may
    differ), and every key looks up to its row in both indexes."""
    from paddlebox_tpu_torch.ops import index as tix
    from paddlebox_tpu_torch.ops.device_unique import dedup_keys_first_seen
    rng = np.random.default_rng(11)
    nb, cap = 1 << 16, 1 << 15
    kern, plain = _index(nb, cuda), _index(nb, cuda)
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
    bkeys, brows = _index(nb, cuda)
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


def _insert_both(tix, kern, plain, keys, next_row, cap):
    """One insert through the kernel (one launch) and the plain version:
    rows, new-masks and the failure flag identical."""
    before = tix.insert.launches
    r1, n1, f1 = tix.insert(*kern, keys, next_row, cap)
    r2, n2, f2 = tix.insert_plain(*plain, keys, next_row, cap)
    torch.cuda.synchronize()
    assert tix.insert.launches == before + 1
    assert bool(f1) == bool(f2)
    if not bool(f1):
        assert torch.equal(r1, r2) and torch.equal(n1, n2)
    return r1, n1, bool(f1)


@pytest.mark.cuda
@pytest.mark.parametrize("n,nb,old", [
    (1, 1 << 10, 0), (1023, 1 << 12, 0), (1025, 1 << 12, 0),
    (5003, 1 << 14, 2000), (40_000, 1 << 17, 15_000),
    (1 << 20, 1 << 23, 0)],
    ids=["n1", "tile-1", "tile+1", "ragged", "lookback", "seed2e20"])
def test_key_index_insert_cases(cuda, n, nb, old):
    """Streams of n keys (``old`` of them already in the index, spread
    through the stream) through one kernel launch against the plain
    version: n = 1, n around the 1024-key tile, 40 tiles (look-back past
    a 32-tile window), and a seed-shaped all-new insert of 2^20 keys at
    the training path's load factor (rows 0..n-1)."""
    from paddlebox_tpu_torch.ops import index as tix
    rng = np.random.default_rng(n)
    kern, plain = _index(nb, cuda), _index(nb, cuda)
    pool = np.unique(_key_pool(rng, max(2 * n, 8)))
    rng.shuffle(pool)
    if old:
        first = torch.from_numpy(pool[:old].view(np.int64)).to(cuda)
        _, new0, _ = _insert_both(tix, kern, plain, first, 0, nb)
        assert bool(new0.all())
    keys = pool[:n].copy()
    rng.shuffle(keys)
    keys = torch.from_numpy(keys.view(np.int64)).to(cuda)
    rows, new, failed = _insert_both(tix, kern, plain, keys, old, nb)
    assert not failed and int(new.sum()) == n - old
    if not old:
        assert torch.equal(rows, torch.arange(n, dtype=torch.int32,
                                              device=cuda))
    assert int((kern[1] >= 0).sum()) == n
    assert torch.equal(tix.lookup(*kern, keys), rows)


@pytest.mark.cuda
@pytest.mark.parametrize("short", [0, 1], ids=["met", "short-by-one"])
def test_key_index_capacity_edge(cuda, short):
    """next_row + new keys == capacity succeeds; one row fewer fails and
    leaves the index as it was (rows and live keys)."""
    from paddlebox_tpu_torch.ops import index as tix
    rng = np.random.default_rng(20 + short)
    nb = 1 << 14
    kern, plain = _index(nb, cuda), _index(nb, cuda)
    pool = np.unique(_key_pool(rng, 7000))
    first = torch.from_numpy(pool[:2000].view(np.int64)).to(cuda)
    _insert_both(tix, kern, plain, first, 0, 2000)
    rows0 = kern[1].clone()
    keys0 = torch.where(kern[1] >= 0, kern[0], 0)
    keys = torch.from_numpy(pool[1000:5000].view(np.int64)).to(cuda)
    rows, new, failed = _insert_both(tix, kern, plain, keys, 2000,
                                     5000 - short)
    assert failed is bool(short)
    if short:
        assert torch.equal(kern[1], rows0)
        assert torch.equal(torch.where(kern[1] >= 0, kern[0], 0), keys0)
        assert (tix.lookup(*kern, keys[1000:]) == -1).all()
    else:
        assert int(new.sum()) == 3000 and int(rows.max()) == 4999
    assert torch.equal(tix.lookup(*kern, first),
                       torch.arange(2000, dtype=torch.int32, device=cuda))


@pytest.mark.cuda
def test_key_index_race_on_stale_keys(cuda):
    """A failed insert leaves its keys' bytes under EMPTY rows; the next
    insert claims those buckets again in the same launch that other
    threads probe them. Its stream holds the stale keys, keys hashed
    into the same home buckets, and key 0 (every fresh bucket's bytes).
    A prober that trusted key bytes read beside a row landed in this
    launch would match a stale key. 20 rounds, each exact against the
    plain version, then every key looks up to its row."""
    from paddlebox_tpu_torch.ops import index as tix
    rng = np.random.default_rng(21)
    nb = 1 << 17
    mask = nb - 1
    for _ in range(20):
        kern, plain = _index(nb, cuda), _index(nb, cuda)
        stale = np.unique(rng.integers(1, 2 ** 63, size=20_000,
                                       dtype=np.uint64))
        t = torch.from_numpy(stale.view(np.int64)).to(cuda)
        *_, failed = _insert_both(tix, kern, plain, t, 0, len(stale) - 1)
        assert failed
        homes = (tix._hash32(t) & mask).cpu().numpy()
        cand = rng.integers(1, 2 ** 63, size=150_000, dtype=np.uint64)
        ch = (tix._hash32(torch.from_numpy(cand.view(np.int64)))
              & mask).numpy()
        coll = cand[np.isin(ch, homes)][:15_000]
        keys = np.concatenate([stale, coll, np.zeros(1, np.uint64)])
        rng.shuffle(keys)
        keys = _uniq(torch.from_numpy(keys.view(np.int64)).to(cuda))
        rows, new, failed = _insert_both(tix, kern, plain, keys, 0, nb)
        assert not failed and bool(new.all())
        assert torch.equal(tix.lookup(*kern, keys), rows)
        assert torch.equal(tix.lookup_plain(*kern, keys), rows)


@pytest.mark.cuda
def test_key_index_lookup_duplicates_and_misses(cuda):
    """A lookup of keys in any order with duplicates, misses (key 0 in a
    fresh index, whose every bucket holds key bytes 0) and keys whose
    probe chains run through full clusters: exact against the plain
    lookup on both indexes, one launch."""
    from paddlebox_tpu_torch.ops import index as tix
    rng = np.random.default_rng(22)
    nb = 1 << 14
    kern, plain = _index(nb, cuda), _index(nb, cuda)
    pool = np.unique(_key_pool(rng, 9000))[1:]       # without key 0
    t = torch.from_numpy(pool[:6000].view(np.int64)).to(cuda)
    _insert_both(tix, kern, plain, t, 0, nb)
    probe = np.concatenate([pool[rng.integers(0, 6000, size=20_000)],
                            pool[6000:], np.zeros(3, np.uint64)])
    rng.shuffle(probe)
    probe = torch.from_numpy(probe.view(np.int64)).to(cuda)
    before = tix.lookup.launches
    got = tix.lookup(*kern, probe)
    torch.cuda.synchronize()
    assert tix.lookup.launches == before + 1
    assert torch.equal(got, tix.lookup_plain(*kern, probe))
    assert torch.equal(got, tix.lookup_plain(*plain, probe))
    miss = np.isin(probe.cpu().numpy().view(np.uint64), pool[:6000],
                   invert=True)
    assert np.array_equal(got.cpu().numpy() < 0, miss)


@pytest.mark.cuda
def test_key_index_rejects_other_layouts(cuda):
    """The kernels take only the views of one bucket tensor: separate
    arrays, or keys and rows of two bucket tensors, raise before any
    launch."""
    from paddlebox_tpu_torch.ops import index as tix
    nb = 1 << 10
    keys = torch.arange(5, dtype=torch.int64, device=cuda)
    sep = (torch.zeros(nb, dtype=torch.int64, device=cuda),
           torch.full((nb,), -1, dtype=torch.int32, device=cuda))
    mixed = (_index(nb, cuda)[0], _index(nb, cuda)[1])
    before = (tix.insert.launches, tix.lookup.launches)
    for bad in (sep, mixed):
        with pytest.raises(ValueError):
            tix._bucket_base(*bad)
        with pytest.raises(ValueError):
            tix.insert(*bad, keys, 0, nb)
        with pytest.raises(ValueError):
            tix.lookup(*bad, keys)
    assert (tix.insert.launches, tix.lookup.launches) == before


@pytest.mark.cuda
def test_dedup_keys_first_seen_on_card_matches_host(cuda):
    from paddlebox_tpu_torch.ops.device_unique import dedup_keys_first_seen
    from paddlebox_tpu_torch.ps.kv import dedup_first_seen_py
    keys = _index_keys(np.random.default_rng(13), 100_000, 40_000)
    uniq, first, inv, u = dedup_keys_first_seen(keys.to(cuda))
    hu, hf, hi = dedup_first_seen_py(keys.numpy().view(np.uint64))
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


# ---------------------------------------------------------------------------
# the CTR op family (rank_attention, batch_fc, cross_norm)
# ---------------------------------------------------------------------------

def _rank_inputs(rng, n=300, d=40, p=33, mr=3, wild=True):
    """rank_offset with invalid, zero, out-of-range ranks and rows, and a
    padded tail (the last fifth) of all -1 rows."""
    x = rng.normal(size=(n, d)).astype(np.float32)
    param = (rng.normal(size=(mr * mr, d, p)) * 0.1).astype(np.float32)
    ro = np.full((n, 1 + 2 * mr), -1, np.int32)
    live = n - n // 5
    lo, hi = (-2, mr + 3) if wild else (1, mr + 1)
    ro[:live, 0] = rng.integers(lo, hi, size=live)
    for k in range(mr):
        ro[:live, 1 + 2 * k] = rng.integers(lo, hi, size=live)
        ro[:live, 2 + 2 * k] = rng.integers(-3 if wild else 0,
                                            n + 3 if wild else n, size=live)
    return x, ro, param


def _rank_case_inputs(rng, n, d, p, mr, case):
    """_rank_inputs, or a rank_offset built for one edge of the bucketed
    kernel: ``all_pad`` (every row −1), ``own_high`` (every own rank past
    max_rank: all rows clip into the last bucket), ``shared`` (co-ranks
    past max_rank and repeated, so entries of one row share a clipped
    co-rank, some on the same X row), ``ragged`` (bucket sizes 33, 31, 65
    and 1, none a multiple of a tile), ``extra_cols`` (3 columns past
    1 + 2K, garbage), ``exact`` (the wild ranks over integer-valued x and
    quarter-valued param: every partial sum is exact in float32, so any
    summation order gives the same floats; at depth 3000 random floats
    differ by more than the tolerance between two orders of a 9000-term
    chain)."""
    x, ro, param = _rank_inputs(rng, n, d, p, mr, wild=case != "shared")
    if case == "exact":
        x = rng.integers(-3, 4, size=x.shape).astype(np.float32)
        param = (rng.integers(-2, 3, size=param.shape) * 0.25).astype(
            np.float32)
    elif case == "all_pad":
        ro[:] = -1
    elif case == "own_high":
        ro[:, 0] = rng.integers(mr + 1, mr + 6, size=n)
    elif case == "shared":
        ro[:, 0] = rng.integers(1, mr + 1, size=n)
        for k in range(mr):
            ro[:, 1 + 2 * k] = rng.integers(mr - 1, mr + 3, size=n)
        ro[:, 4] = ro[:, 2]                   # the same X row twice
    elif case == "ragged":
        own = np.full(n, -1, np.int32)
        own[:130] = np.repeat([1, 2, 3, 4], [33, 31, 65, 1])[:130]
        ro[:, 0] = rng.permutation(own)
    elif case == "extra_cols":
        ro = np.concatenate([ro, rng.integers(-5, n + 5, size=(n, 3)).astype(
            np.int32)], axis=1)
    return x, ro, param


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [
    (300, 40, 33, 3), (64, 128, 128, 3), (50, 7, 300, 2), (9, 3000, 5, 1),
    (200, 8, 24, 16, "wild"),           # max_rank 16: 256 param blocks
    (40, 3000, 64, 3, "exact"),         # depth 3000 in chunks
    (120, 64, 300, 3, "wild"),          # p 300: a column tail
    (1, 16, 16, 3, "wild"), (1, 16, 16, 3, "own_high"),      # n = 1
    (257, 32, 64, 3, "all_pad"), (257, 32, 64, 3, "own_high"),
    (257, 32, 64, 4, "shared"), (300, 64, 64, 4, "ragged"),
    (300, 40, 33, 3, "extra_cols")])
def test_rank_attention_matches_plain(cuda, shape):
    from paddlebox_tpu_torch.ops import ctr_kernels as tc
    n, d, p, mr = shape[:4]
    case = shape[4] if len(shape) > 4 else "wild"
    x, ro, param = (torch.from_numpy(a).to(cuda) for a in _rank_case_inputs(
        np.random.default_rng(n), n, d, p, mr, case))
    before = tc.rank_attention.launches
    got = tc.rank_attention(x, ro, param, mr)
    want = tc.rank_attention_plain(x, ro, param, mr)
    torch.cuda.synchronize()
    assert tc.rank_attention.launches == before + 1
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    if case in ("wild", "exact"):
        pad = got[n - n // 5:]
        assert torch.equal(pad, torch.zeros_like(pad))
    _, _, valid = tc.decode_rank_offset(ro, mr, n)
    none = got[~valid.any(dim=1)]
    assert torch.equal(none, torch.zeros_like(none))


@pytest.mark.cuda
def test_rank_attention_deterministic(cuda):
    """At the PV shapes two calls are bit-equal, and a call counts one
    launch (its C call enqueues the bucket pass and the tile kernel)."""
    from paddlebox_tpu_torch.ops import ctr_kernels as tc
    x, ro, param = (torch.from_numpy(a).to(cuda) for a in _rank_case_inputs(
        np.random.default_rng(4), 4096, 128, 128, 3, "shared"))
    before = tc.rank_attention.launches
    first = tc.rank_attention(x, ro, param, 3)
    second = tc.rank_attention(x, ro, param, 3)
    torch.cuda.synchronize()
    assert tc.rank_attention.launches == before + 2
    assert torch.equal(first, second)


@pytest.mark.cuda
@pytest.mark.parametrize("n,mr,case", [
    (300, 3, "wild"), (1, 3, "wild"), (257, 3, "all_pad"),
    (257, 3, "own_high"), (300, 4, "ragged"), (5000, 3, "wild"),
    (3000, 16, "wild"), (300, 3, "extra_cols"), (20000, 3, "wild")])
def test_rank_buckets_exact(cuda, n, mr, case):
    """The bucket pass alone gives exactly rank_buckets_plain's
    permutation and bounds (several 1024-row rounds at n 5000; at n 20000
    past its shared-memory copy of the buckets), and the tile kernel over
    it gives the wrapper's result bit for bit."""
    from paddlebox_tpu_torch.ops import _build
    from paddlebox_tpu_torch.ops import ctr_kernels as tc
    x, ro, param = (torch.from_numpy(a).to(cuda) for a in _rank_case_inputs(
        np.random.default_rng(n + mr), n, 24, 40, mr, case))
    scratch = torch.full((n + mr + 2,), -7, dtype=torch.int32, device=cuda)
    fb = _build.function("rank_attention", "pbx_rank_buckets",
                         tc._RANK_BUCKETS_ARGS)
    _build.check(fb(ro.data_ptr(), scratch.data_ptr(), n, mr, ro.shape[1],
                    _build.stream(ro)), "rank_buckets")
    perm, bounds = tc.rank_buckets_plain(ro, mr)
    torch.cuda.synchronize()
    assert torch.equal(scratch[:n], perm)
    assert torch.equal(scratch[n:], bounds)
    want = tc.rank_attention(x, ro, param, mr)
    ft = _build.function("rank_attention", "pbx_rank_attention_tiles",
                         tc._RANK_TILES_ARGS)
    out = torch.full_like(want, float("nan"))
    _build.check(ft(x.data_ptr(), ro.data_ptr(), param.data_ptr(),
                    scratch.data_ptr(), out.data_ptr(), n, 24, 40, mr,
                    ro.shape[1], _build.stream(x)), "rank_attention tiles")
    torch.cuda.synchronize()
    assert torch.equal(out, want)


def _fc_inputs(rng, cuda, mode, case, s=8, n=1000, i_dim=11, o_dim=13):
    """batch_fc inputs: x [S, N, I] (``strided``: the [N, S, I] block's
    swapaxes view; case ``odd_strides``: every other column of a wider
    block, strides odd and 4 bytes off; ``offset4``: x, w and bias views 4
    bytes past a 16-byte boundary), w [S, I, O] or [S, O, I]."""
    if case == "wide":
        s, n, i_dim, o_dim = 3, 257, 200, 300   # past the tile's staging
    elif case == "n1":
        n = 1
    elif case == "ragged":
        n = 1001                                # not a multiple of 128

    def dev(*shape, off=0):
        flat = rng.normal(size=int(np.prod(shape)) + off).astype(np.float32)
        return torch.from_numpy(flat).to(cuda)[off:].view(*shape)
    off = 1 if case == "offset4" else 0
    odd = case == "odd_strides"
    lead = (n, s) if mode == "strided" else (s, n)
    x = dev(*lead, 2 * i_dim + 1 if odd else i_dim, off=off)
    if odd:
        x = x[:, :, 1::2]
    if mode == "strided":
        x = x.transpose(0, 1)
    w = (dev(s, o_dim, i_dim, off=off) if mode == "transpose"
         else dev(s, i_dim, o_dim, off=off))
    return x, w, dev(s, o_dim, off=off), mode == "transpose"


_FC_CASES = ["wide", "n1", "ragged", "odd_strides", "offset4"]


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["default", "strided", "batchcount",
                                  "transpose"] + [
    f"{case}/{m}" for case in _FC_CASES
    for m in ("strided", "batchcount", "transpose")])
def test_batch_fc_matches_plain(cuda, mode):
    from paddlebox_tpu_torch.ops import ctr_kernels as tc
    case, _, mode = mode.rpartition("/")
    x, w, bias, tr = _fc_inputs(np.random.default_rng(3), cuda, mode, case)
    before = tc.batch_fc.launches
    got = tc.batch_fc(x, w, bias, tr)
    want = tc.batch_fc_plain(x, w, bias, tr)
    torch.cuda.synchronize()
    assert tc.batch_fc.launches == before + 1
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["strided", "transpose"])
@pytest.mark.parametrize("case", ["", "ragged", "odd_strides", "offset4"])
def test_batch_fc_paths_agree(cuda, mode, case):
    """The tile kernel and the per-element kernel, each forced, give the
    same floats (one FMA chain in i order, the bias last)."""
    from paddlebox_tpu_torch.ops import _build
    from paddlebox_tpu_torch.ops import ctr_kernels as tc
    x, w, bias, tr = _fc_inputs(np.random.default_rng(9), cuda, mode, case)
    fn = _build.function("batch_fc", "pbx_batch_fc_path",
                         tc._BATCH_FC_PATH_ARGS)
    outs = []
    for path in (1, 2):
        out = torch.full((x.shape[0], x.shape[1], bias.shape[1]),
                         float("nan"), device=cuda)
        _build.check(fn(x.data_ptr(), *x.stride(), w.data_ptr(),
                        bias.data_ptr(), out.data_ptr(), x.shape[0],
                        x.shape[1], x.shape[2], bias.shape[1], int(tr), path,
                        _build.stream(x)), "batch_fc")
        outs.append(out)
    torch.cuda.synchronize()
    assert torch.equal(outs[0], outs[1])
    torch.testing.assert_close(outs[0], tc.batch_fc_plain(x, w, bias, tr),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.cuda
def test_ctr_wrapper_errors(cuda):
    """Shapes the kernels do not take raise before any launch."""
    from paddlebox_tpu_torch.ops import ctr_kernels as tc
    x, ro, param = (torch.from_numpy(a).to(cuda) for a in _rank_inputs(
        np.random.default_rng(2), 40, 8, 8, 3))
    before = tc.rank_attention.launches, tc.batch_fc.launches
    with pytest.raises(ValueError):
        tc.rank_attention(x, ro[:, :6].contiguous(), param, 3)
    with pytest.raises(ValueError):
        tc.rank_attention(x, ro, param[:8].contiguous(), 3)
    with pytest.raises(TypeError):
        tc.rank_attention(x, ro.long(), param, 3)
    big = torch.zeros((17 * 17, 8, 8), device=cuda)
    wide = torch.full((40, 35), -1, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        tc.rank_attention(x, wide, big, 17)
    xb = torch.zeros((2, 5, 3), device=cuda)
    with pytest.raises(ValueError):
        tc.batch_fc(xb, torch.zeros((2, 4, 4), device=cuda),
                    torch.zeros((2, 4), device=cuda), False)
    with pytest.raises(TypeError):
        tc.batch_fc(xb.double(), torch.zeros((2, 3, 4), device=cuda),
                    torch.zeros((2, 4), device=cuda), False)
    assert (tc.rank_attention.launches, tc.batch_fc.launches) == before


def _cross_norm_inputs(b, n, d, device, offset=0, drawn=False):
    """x [b, 2nd] (a contiguous view ``offset`` floats into its buffer),
    mean and scale. ``drawn``: mean and scale at random (seeded by d);
    else derived, as the PV path derives them, from a summary: here one
    of 256 other rows of x's distribution alone (decay 0), so every
    column comes out at about unit scale."""
    from paddlebox_tpu_torch.ops.cross_norm import (cross_norm_update,
                                                    init_cross_norm_summary)
    from paddlebox_tpu_torch.ops.data_norm import data_norm_mean_scale
    rng = np.random.default_rng(d if drawn else (b, n, d, offset))
    w = n * (3 * d + 1)
    if drawn:
        x = torch.from_numpy(rng.normal(size=(b, 2 * n * d)).astype(
            np.float32)).to(device)
        mean = torch.from_numpy(rng.normal(size=w).astype(np.float32))
        scale = torch.from_numpy(rng.random(w).astype(np.float32) + 0.5)
        return x, mean.to(device), scale.to(device)
    buf = torch.from_numpy(rng.normal(size=offset + b * 2 * n * d).astype(
        np.float32)).to(device)
    x = buf[offset:].view(b, 2 * n * d)
    sample = torch.from_numpy(rng.normal(size=(256, 2 * n * d)).astype(
        np.float32)).to(device)
    summ = cross_norm_update(init_cross_norm_summary(n, d, device=device),
                             sample, n, d, decay=0.0)
    mean, scale = data_norm_mean_scale(summ, 1e-4)
    return x, mean.contiguous(), scale.contiguous()


def _cross_norm_forced(x, mean, scale, n, d, path, out_offset=0):
    """``pbx_cross_norm_path`` with the kernel forced (1 the tile kernel, 2
    the rows kernel) into a NaN-filled output ``out_offset`` floats into
    its buffer: (its cudaError_t, the output)."""
    from paddlebox_tpu_torch.ops import _build
    from paddlebox_tpu_torch.ops import ctr_kernels as tc
    fn = _build.function("cross_norm", "pbx_cross_norm_path",
                         tc._CROSS_NORM_PATH_ARGS)
    b, w = x.shape[0], n * (3 * d + 1)
    buf = torch.full((out_offset + b * w,), float("nan"), device=x.device)
    out = buf[out_offset:].view(b, w)
    rc = fn(x.data_ptr(), mean.data_ptr(), scale.data_ptr(), out.data_ptr(),
            b, n, d, path, _build.stream(x))
    torch.cuda.synchronize()
    return rc, out


def _assert_cross_norm(got, want, d):
    """Exact outside the dot column, rtol 1e-5 / atol 1e-6 on it."""
    w = got.shape[1]
    dot = torch.zeros(w, dtype=torch.bool, device=got.device)
    dot[3 * d::3 * d + 1] = True
    assert torch.equal(got[:, ~dot], want[:, ~dot])
    torch.testing.assert_close(got[:, dot], want[:, dot], rtol=1e-5,
                               atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("n,d", [(1, 128), (3, 5), (2, 70)])
@pytest.mark.parametrize("b", [257, 0, 1, 5, 20_000])
def test_cross_norm_matches_plain(cuda, n, d, b):
    """The wrapper against the plain version, each kernel forced through
    ``pbx_cross_norm_path`` bit-equal to the wrapper, and two calls
    bit-equal. b: 257 a
    ragged last tile, 5 and 1 fewer rows than a tile, 0 nothing to
    launch, 20 000 more tiles than the card holds at once; (3, 5): n > 1
    and d odd, so output rows start off 16 bytes. At 257 rows mean and
    scale are drawn at random, as before; the other sizes derive them
    from a summary of rows like x's, as the PV path does (a normalized
    dot column has about unit scale; at a random scale near 1, a
    128-term dot of magnitude ~11 moves by ~1e-6 between two summation
    orders, the atol itself)."""
    from paddlebox_tpu_torch.ops import ctr_kernels as tc
    x, mean, scale = _cross_norm_inputs(b, n, d, cuda, drawn=b == 257)
    before = tc.cross_norm.launches
    got = tc.cross_norm(x, mean, scale, n, d)
    again = tc.cross_norm(x, mean, scale, n, d)
    want = tc.cross_norm_plain(x, mean, scale, n, d)
    torch.cuda.synchronize()
    assert tc.cross_norm.launches == before + 2 * (b > 0)
    _assert_cross_norm(got, want, d)
    assert torch.equal(got, again)
    assert tc.cross_norm_branch(x.data_ptr(), got.data_ptr(), b, n, d) == (
        1 if b else 0)
    for path in (1, 2):
        rc, out = _cross_norm_forced(x, mean, scale, n, d, path)
        assert rc == 0
        assert torch.equal(out, got), path


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,b,x_off,out_off", [
    (1, 128, 257, 1, 0),        # x 4 bytes into its buffer
    (3, 5, 37, 2, 0),
    (1, 128, 33, 0, 3),         # out 12 bytes into its buffer
    (1, 20_000, 6, 0, 0),       # a tile of 8 rows past shared memory
    (2, 3_000, 9, 1, 1)])       # both, and mean/scale past 48 KB
def test_cross_norm_rows_kernel(cuda, n, d, b, x_off, out_off):
    """What the tile kernel cannot take goes to the rows kernel: the
    wrapper's branch is 2 and holds against the plain version; the tile
    kernel forced there refuses to launch; the rows kernel forced equals
    the wrapper, and the default pick (path 0) takes it too."""
    from paddlebox_tpu_torch.ops import ctr_kernels as tc
    x, mean, scale = _cross_norm_inputs(b, n, d, cuda, offset=x_off)
    rc, want_rows = _cross_norm_forced(x, mean, scale, n, d, 2,
                                       out_offset=out_off)
    assert rc == 0
    _assert_cross_norm(want_rows, tc.cross_norm_plain(x, mean, scale, n, d),
                       d)
    rc, out = _cross_norm_forced(x, mean, scale, n, d, 1, out_offset=out_off)
    assert rc != 0 and bool(out.isnan().all())
    rc, out = _cross_norm_forced(x, mean, scale, n, d, 0, out_offset=out_off)
    assert rc == 0 and torch.equal(out, want_rows)
    if out_off == 0:
        got = tc.cross_norm(x, mean, scale, n, d)
        torch.cuda.synchronize()
        assert tc.cross_norm_branch(x.data_ptr(), got.data_ptr(), b, n,
                                    d) == 2
        assert torch.equal(got, want_rows)


@pytest.mark.cuda
def test_cross_norm_wrapper_errors(cuda):
    """Inputs the kernels do not take raise before any launch, and a path
    past 0–2 is refused."""
    from paddlebox_tpu_torch.ops import ctr_kernels as tc
    x, mean, scale = _cross_norm_inputs(8, 1, 16, cuda)
    before = tc.cross_norm.launches
    with pytest.raises(TypeError):
        tc.cross_norm(x.double(), mean, scale, 1, 16)
    with pytest.raises(ValueError):
        tc.cross_norm(torch.cat([x, x], 1)[:, ::2], mean, scale, 1, 16)
    with pytest.raises(ValueError):
        tc.cross_norm(x, mean, scale, 1, 15)
    with pytest.raises(ValueError):
        tc.cross_norm(x, mean[1:], scale, 1, 16)
    assert tc.cross_norm.launches == before
    for path in (-1, 3):
        rc, out = _cross_norm_forced(x, mean, scale, 1, 16, path)
        assert rc != 0 and bool(out.isnan().all())


@pytest.mark.cuda
def test_cross_norm_branch_edge_matches_kernel(cuda):
    """The widest d whose tile ``cross_norm_branch`` sends to the tile
    kernel is one that kernel takes, and the next is one it refuses: the
    helper's CROSS_NORM_ROWS and CROSS_NORM_SMEM match the source's
    kTileRows and kSmemBudget."""
    from paddlebox_tpu_torch.ops import ctr_kernels as tc
    d = next(d for d in range(1, 20_000)
             if tc.cross_norm_branch(0, 0, 9, 1, d) == 2) - 1
    for dd, want in ((d, 1), (d + 1, 2)):
        x, mean, scale = _cross_norm_inputs(9, 1, dd, cuda, drawn=True)
        assert tc.cross_norm_branch(0, 0, 9, 1, dd) == want
        rc, out = _cross_norm_forced(x, mean, scale, 1, dd, 1)
        if want == 1:
            assert rc == 0
            _assert_cross_norm(out, tc.cross_norm_plain(x, mean, scale, 1,
                                                        dd), dd)
        else:
            assert rc != 0 and bool(out.isnan().all())


@pytest.mark.cuda
def test_ads_rank_on_card_matches_plain(cuda):
    """AdsRank with both towers: forward and every param grad through the
    kernels against the same model through the plain versions."""
    from paddlebox_tpu_torch import AdsRank
    from paddlebox_tpu_torch.ops.cross_norm import init_cross_norm_summary
    rng = np.random.default_rng(12)
    b, s, d, dm = 200, 5, 11, 32
    x, ro, _ = _rank_inputs(rng, n=b, d=1, p=1, wild=False)
    pooled = torch.from_numpy(rng.normal(size=(b, s, d)).astype(
        np.float32)).to(cuda)
    dense = torch.from_numpy(rng.normal(size=(b, 4)).astype(
        np.float32)).to(cuda)
    ro = torch.from_numpy(ro).to(cuda)
    summ = init_cross_norm_summary(1, dm)
    torch.manual_seed(0)
    model = AdsRank(s, d, 4, d_model=dm, hidden=(16,), slot_fc=True,
                    cross_norm=True, compute_dtype=torch.float32).to(cuda)
    outs, grads = [], []
    for ops in (tk.KERNELS, tk.PLAIN):
        model.ops = ops
        model.zero_grad()
        out = model(pooled, dense, ro, summ)
        (out ** 2).sum().backward()
        outs.append(out.detach())
        grads.append({k: p.grad.clone() for k, p in model.named_parameters()})
    torch.testing.assert_close(outs[0], outs[1], rtol=1e-4, atol=1e-5)
    for k in grads[0]:
        torch.testing.assert_close(grads[0][k], grads[1][k], rtol=5e-3,
                                   atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [11, 3, 150])   # not a multiple of 4; > 128
def test_segment_sum_matches_plain(cuda, d):
    """Ragged ids with −1 markers, ids past num_segments and a tail of
    pads in the last (discard) bin; K not a multiple of 32. The sum holds
    the pooling class; its grad (segment_gather) is exact."""
    rng = np.random.default_rng(d)
    values, segments, _, b, s = _ragged(rng, d=d)
    n = b * s + 1
    segments[rng.random(len(segments)) < 0.02] = n + 7
    v = torch.from_numpy(values[:-3]).to(cuda).requires_grad_(True)
    sg = torch.from_numpy(segments[:-3]).to(cuda)
    assert sg.shape[0] % 32 != 0
    w = torch.randn((n, d), device=cuda)
    before = tk.segment_sum.launches
    got = tk.segment_sum(v, sg, n)
    (got * w).sum().backward()
    g_kernel = v.grad.clone()
    v.grad = None
    want = tk.segment_sum_plain(v, sg, n)
    (want * w).sum().backward()
    torch.cuda.synchronize()
    assert tk.segment_sum.launches == before + 1
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
    assert torch.equal(g_kernel, v.grad)


@pytest.mark.cuda
def test_segment_sum_edges(cuda):
    """No segments, no keys, a bf16 input (summed in f32), a run of many
    keys in one segment."""
    v = torch.randn((37, 5), device=cuda)
    sg = torch.zeros(37, dtype=torch.int32, device=cuda)
    before = tk.segment_sum.launches
    assert tk.segment_sum(v, sg, 0).shape == (0, 5)
    assert tk.segment_sum.launches == before               # nothing to do
    empty = tk.segment_sum(v[:0], sg[:0], 4)
    torch.cuda.synchronize()
    assert torch.equal(empty, torch.zeros((4, 5), device=cuda))
    vb = v.to(torch.bfloat16)
    got = tk.segment_sum(vb, sg, 3)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got, tk.segment_sum_plain(vb, sg, 3))
    long_run = torch.randn((5000, 7), device=cuda)
    ids = torch.zeros(5000, dtype=torch.int32, device=cuda)
    ids[::7] = -1
    torch.testing.assert_close(tk.segment_sum(long_run, ids, 2),
                               tk.segment_sum_plain(long_run, ids, 2),
                               rtol=RTOL, atol=1e-5)


def _unique_rows(rng, c, k, pads):
    """k distinct in-bounds rows then ``pads`` distinct out-of-bounds
    ids (and a few negatives)."""
    rows = np.concatenate([rng.permutation(c)[:k - pads],
                           c + 1 + rng.permutation(3 * pads)[:pads]])
    rows[rng.choice(k - pads, 3, replace=False)] = -5
    return torch.from_numpy(rows.astype(np.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("feat", [16, 13])   # vector and scalar paths
def test_scatter_rows_exact(cuda, feat):
    rng = np.random.default_rng(feat)
    c, k = 6000, 4001
    table = torch.from_numpy(
        rng.normal(size=(c, feat)).astype(np.float32)).to(cuda)
    rows = _unique_rows(rng, c - 1, k, 300).to(cuda)
    vals = torch.from_numpy(
        rng.normal(size=(k, feat)).astype(np.float32)).to(cuda)
    got = tk.scatter_rows(table.clone(), rows, vals)
    want = tk.scatter_rows_plain(table.clone(), rows, vals)
    torch.cuda.synchronize()
    assert torch.equal(got[:-1], want[:-1])     # the last row is racy
    same = tk.scatter_rows(table.clone(), rows[:0], vals[:0])
    assert torch.equal(same, table)


@pytest.mark.cuda
# d 4-128: 16-byte vectors, 1 to 32 a row; 13 and 150: ordinary loads
@pytest.mark.parametrize("d", [4, 16, 13, 128, 150])
@pytest.mark.parametrize("k", [4096, 37, 2048 * 3])
def test_row_dma_exact(cuda, d, k):
    rng = np.random.default_rng(d + k)
    c = 9000
    table = torch.from_numpy(
        rng.normal(size=(c + 1, d)).astype(np.float32)).to(cuda)
    rows = _unique_rows(rng, c, k, k // 8).to(cuda)
    vals = torch.from_numpy(
        rng.normal(size=(k, d)).astype(np.float32)).to(cuda)
    before = (tk.gather_rows_dma.launches, tk.scatter_rows_dma.launches)
    got = tk.gather_rows_dma(table, rows)
    want = tk.gather_rows_dma_plain(table, rows)
    t_k = tk.scatter_rows_dma(table.clone(), rows, vals)
    t_p = tk.scatter_rows_dma_plain(table.clone(), rows, vals)
    torch.cuda.synchronize()
    assert (tk.gather_rows_dma.launches, tk.scatter_rows_dma.launches) == (
        before[0] + 1, before[1] + 1)
    assert torch.equal(got, want)
    assert torch.equal(t_k[:c], t_p[:c])        # the sentinel row is racy
    # the pads all wrote the sentinel row: each of its floats is one of
    # theirs (the rows may interleave)
    pads = vals[(rows < 0) | (rows > c)]
    assert (pads == t_k[c]).any(dim=0).all()
    with pytest.raises(ValueError, match="multiple of 2048"):
        tk.gather_rows_dma(table, rows.repeat(2049)[:2049 * 2 - 1])
    # a table view at a 4-byte offset takes the ordinary loads
    flat = torch.cat([table.new_zeros(1), table.flatten()])
    view = flat[1:].view(c + 1, d)
    assert torch.equal(tk.gather_rows_dma(view, rows), want)
    t_v = torch.cat([table.new_zeros(1), table.clone().flatten()])[1:]
    tk.scatter_rows_dma(t_v.view(c + 1, d), rows, vals)
    torch.cuda.synchronize()
    assert torch.equal(t_v.view(c + 1, d)[:c], t_p[:c])


@pytest.mark.cuda
@pytest.mark.parametrize("vec", [0, 1])     # ordinary loads; the ring
@pytest.mark.parametrize("d", [4, 16, 128])
def test_row_dma_paths_exact(cuda, vec, d):
    """Both paths of csrc/row_dma.cu on rows of 16-byte vectors, called
    straight (the wrapper takes the ring for them), at K = 37 and K =
    2048 * 3."""
    from paddlebox_tpu_torch.ops import _build
    rng = np.random.default_rng(vec * 1000 + d)
    c = 9000
    table = torch.from_numpy(
        rng.normal(size=(c + 1, d)).astype(np.float32)).to(cuda)
    fg = _build.function("row_dma", "pbx_gather_rows_dma", tk._ROW_ARGS)
    fs = _build.function("row_dma", "pbx_scatter_rows_dma", tk._ROW_ARGS)
    for k in (37, 2048 * 3):
        rows = _unique_rows(rng, c, k, k // 8).to(cuda)
        vals = torch.from_numpy(
            rng.normal(size=(k, d)).astype(np.float32)).to(cuda)
        out = torch.full((k, d), float("nan"), device=cuda)
        t_k = table.clone()
        _build.check(fg(table.data_ptr(), rows.data_ptr(), out.data_ptr(), k,
                        c, d, vec, _build.stream(table)), "gather")
        _build.check(fs(t_k.data_ptr(), rows.data_ptr(), vals.data_ptr(), k,
                        c, d, vec, _build.stream(table)), "scatter")
        t_p = tk.scatter_rows_dma_plain(table.clone(), rows, vals)
        torch.cuda.synchronize()
        assert torch.equal(out, tk.gather_rows_dma_plain(table, rows))
        assert torch.equal(t_k[:c], t_p[:c])


@pytest.mark.cuda
def test_segment_gather_negative_head(cuda):
    """The repaired epilogue: a negative id keeps the head row of
    instance floor(id / S), counted from the end and clamped, with zero
    embedx columns; ids >= N and masked keys are zero rows."""
    b, s, w = 9, 5, 13
    n = b * s
    src = torch.randn((n, w), device=cuda)
    head = torch.randn((b, 3), device=cuda)
    ids = torch.tensor([-1, -2, -s, -s - 1, -n, -n - 1, -5 * n, 0, n - 1, n,
                        7 * n, -3] * 3 + [-2 ** 31, 2 ** 31 - 1],
                       dtype=torch.int32, device=cuda)
    mask = torch.ones(ids.shape[0], device=cuda)
    mask[35] = 0.0
    for ets in (0, 2):
        for m in (mask, None):
            got = _gather_once(src, ids, head, m, b, s, ets)
            want = tk.segment_gather_plain(src, ids, head, m, b, s, ets)
            torch.cuda.synchronize()
            assert torch.equal(got, want)
    assert torch.equal(got[-2, :3], head[0])     # int32 min: clamped to 0
    assert torch.equal(got[0, :3], head[b - 1])
    assert torch.equal(got[6, :3], head[0]) and not got[:7, 3:].any()


# ---------------------------------------------------------------------------
# the pool kernels' tiles (pool_cvm, segment_sum) on adversarial streams
# ---------------------------------------------------------------------------

def _tile_stream(rng, d, n=3000):
    """An id stream shaped against the tile kernels (csrc/segment_tile.cuh:
    a warp's tile holds at most 32 segments, a chunk at most 256 keys):
    two runs of 100 empty segments (whole tiles empty), a segment of 600
    keys (several chunks) and 40 segments of 20-120 keys in a row (spans
    that cross tile and chunk edges), −1 markers and ids past n inside the
    runs and between them, and a tail of pads. Dropped keys carry inf and
    NaN. Returns values [K, d] f32, ids [K] i32, n."""
    counts = rng.poisson(2.0, size=n)
    counts[200:300] = 0
    counts[1500:1600] = 0
    counts[700] = 600
    counts[900:940] = rng.integers(20, 120, size=40)
    ids = np.repeat(np.arange(n, dtype=np.int32), counts)
    ids[rng.random(len(ids)) < 0.1] = -1
    ids[rng.random(len(ids)) < 0.02] = n + 5
    ids = np.concatenate([ids, np.full(37, n, np.int32)])    # tail pads
    values = rng.normal(size=(len(ids), d)).astype(np.float32)
    values[:, :min(d, 3)] = np.abs(values[:, :min(d, 3)]) * 4
    bad = (ids < 0) | (ids >= n)
    values[bad] = np.where(rng.random((int(bad.sum()), d)) < 0.5, np.inf,
                           np.nan)
    return values, ids, n


@pytest.mark.cuda
@pytest.mark.parametrize("lib", ["pool_cvm", "segment_sum"])
def test_segment_bounds_pass_matches_plain(cuda, lib):
    """Each library's bounds pass alone (memsets + key-parallel atomics)
    gives exactly segment_bounds_plain, on the adversarial stream, with
    no keys, and with every key dropped."""
    from paddlebox_tpu_torch.ops import _build
    rng = np.random.default_rng(21)
    fn = _build.function(lib, f"pbx_{lib}_bounds", tk._BOUNDS_ARGS)
    _, ids, n = _tile_stream(rng, 11)
    for sg in (torch.from_numpy(ids), torch.zeros(0, dtype=torch.int32),
               torch.full((50,), -1, dtype=torch.int32)):
        sg = sg.to(cuda)
        got = torch.empty((2, n), dtype=torch.int32, device=cuda)
        _build.check(fn(sg.data_ptr(), sg.shape[0], n, got.data_ptr(),
                        _build.stream(sg)), lib)
        torch.cuda.synchronize()
        assert torch.equal(got, tk.segment_bounds_plain(sg, n))


def _one_segment(rng, d, k=3000):
    """n = 1: one segment holding every kept key (several chunks long),
    −1 markers among them carrying NaN."""
    ids = np.where(rng.random(k) < 0.3, -1, 0).astype(np.int32)
    values = np.abs(rng.normal(size=(k, d))).astype(np.float32)
    values[ids < 0] = np.nan
    return values, ids


@pytest.mark.cuda
@pytest.mark.parametrize("d,mode,offset", [(1, tk.CVM_NONE, 0),
                                           (11, tk.CVM_FULL, 2),
                                           (11, tk.CVM_CONV, 3),
                                           (128, tk.CVM_FULL, 2)])
def test_pool_cvm_tiles_adversarial(cuda, d, mode, offset):
    """pool_cvm against its plain version on the adversarial stream: with
    a keep mask that drops more keys (their values NaN), with keep=None
    (bit-equal to an all-ones keep), on a values view that is not 16-byte
    aligned, and at n = 1. One launch a call; finite results although
    dropped keys hold inf and NaN."""
    rng = np.random.default_rng(d + mode)
    values, ids, n = _tile_stream(rng, d)
    keep = (rng.random(len(ids)) < 0.8).astype(np.float32)
    masked = values.copy()
    masked[keep == 0] = np.nan
    dev = [torch.from_numpy(x).to(cuda) for x in (values, masked, ids, keep)]
    v, vm, sg, kp = dev
    one_v, one_ids = (torch.from_numpy(x).to(cuda)
                      for x in _one_segment(rng, d))
    cases = [(vm, sg, kp, n), (v, sg, None, n),
             (torch.cat([vm[:1], vm])[1:], sg, kp, n),   # unaligned view
             (one_v, one_ids, None, 1)]
    for vals, ids_c, kp_c, n_c in cases:
        before = tk.pool_cvm.launches
        got = tk.pool_cvm(vals, ids_c, kp_c, n_c, 1, mode, offset, 0, 0.25)
        assert tk.pool_cvm.launches == before + 1
        want = tk.pool_cvm_plain(vals, ids_c, kp_c, n_c, 1, mode, offset, 0,
                                 0.25)
        torch.cuda.synchronize()
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
        if kp_c is None:
            ones = torch.ones(ids_c.shape[0], device=cuda)
            assert torch.equal(got, tk.pool_cvm(vals, ids_c, ones, n_c, 1,
                                                mode, offset, 0, 0.25))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 11, 150, 300])   # 300: two column tiles
def test_segment_sum_tiles_adversarial(cuda, d):
    """segment_sum against its plain version on the adversarial stream,
    on a values view that is not 16-byte aligned, and at n = 1: finite
    although dropped keys hold inf and NaN, one launch a call."""
    rng = np.random.default_rng(d)
    values, ids, n = _tile_stream(rng, d)
    v, sg = torch.from_numpy(values).to(cuda), torch.from_numpy(ids).to(cuda)
    one_v, one_ids = (torch.from_numpy(x).to(cuda)
                      for x in _one_segment(rng, d))
    for vals, ids_c, n_c in ((v, sg, n), (torch.cat([v[:1], v])[1:], sg, n),
                             (one_v, one_ids, 1)):
        before = tk.segment_sum.launches
        got = tk.segment_sum(vals, ids_c, n_c)
        assert tk.segment_sum.launches == before + 1
        want = tk.segment_sum_plain(vals, ids_c, n_c)
        torch.cuda.synchronize()
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got, want, rtol=RTOL, atol=1e-5)


# ---------------------------------------------------------------------------
# checkpoint, preemption resume and the serving hot reload on the card
# ---------------------------------------------------------------------------

def _ckpt_setup(cuda, n=384, s=4, mf=4, dense=3, bs=64):
    rng = np.random.default_rng(21)
    slots = ([SlotDef("label", "float", 1), SlotDef("d", "float", dense)]
             + [SlotDef(f"S{i}", "uint64") for i in range(s)])
    desc = DataFeedDesc(slots=slots, label_slot="label", batch_size=bs,
                        key_bucket_min=512)
    recs = []
    for i in range(n):
        counts = np.minimum(rng.zipf(1.5, size=s), 8)
        offs = np.zeros(s + 1, np.int32)
        np.cumsum(counts, out=offs[1:])
        keys = rng.integers(0, 3000, size=int(offs[-1])).astype(np.uint64)
        recs.append(SlotRecord(keys, offs,
                               rng.normal(size=dense).astype(np.float32),
                               float(i % 2), 1.0, float(i % 2),
                               uid=int(rng.integers(0, 40)),
                               rank=int(rng.integers(1, 4)),
                               cmatch=int(rng.choice([222, 223]))))

    def trainer(seed=0):
        torch.manual_seed(seed)
        t = EmbeddingTable(mf_dim=mf, capacity=1 << 12, device=cuda)
        tr = Trainer(DeepFM(s, 3 + mf, dense, hidden=(32, 16)), t, desc,
                     seed=3, device=cuda)
        tr.metrics.init_metric("auc")
        tr.metrics.init_metric("cmatch_rank", "cmatch_rank_auc",
                               cmatch_rank_group="222:1,223:2")
        return tr

    def dataset():
        ds = InMemoryDataset(desc)
        ds.records = recs
        return ds

    def serving():
        return ServingModel(DeepFM(s, 3 + mf, dense, hidden=(32, 16)), desc,
                            mf_dim=mf, capacity=1 << 12, device=cuda)

    return trainer, dataset, serving


@pytest.fixture()
def deterministic():
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


@pytest.mark.cuda
def test_resume_digest_equals_uninterrupted_run(cuda, deterministic,
                                                tmp_path):
    """A pass preempted at batch 3 (cursor checkpoints every 2) and
    resumed by a new trainer from its checkpoint gives the uninterrupted
    run's ``state_digest``, bit for bit, through the kernels; the metric
    registry, fed on the card and carried by the cursor checkpoint, ends
    with the uninterrupted run's messages exactly."""
    from paddlebox_tpu_torch import CheckpointManager, state_digest
    from paddlebox_tpu_torch.config import flags_scope
    from paddlebox_tpu_torch.resilience import preemption
    from paddlebox_tpu_torch.resilience.faults import FaultPlan, installed
    from paddlebox_tpu_torch.resilience.preemption import PreemptedError
    trainer, dataset, _ = _ckpt_setup(cuda)
    base = trainer()
    before = tk.scatter_add_update.launches
    base.train_pass(dataset())
    assert tk.scatter_add_update.launches == before + 6
    want = state_digest(base)
    root = str(tmp_path / "ckpt")
    with flags_scope(ckpt_every_batches=2):
        tr = trainer()
        with installed(FaultPlan.parse("preempt.signal:fail:nth=3")):
            with pytest.raises(PreemptedError) as ei:
                tr.run_pass(dataset(), checkpoint=CheckpointManager(root))
        preemption.clear_stop()
        assert ei.value.checkpointed and ei.value.batch_index == 3
        tr2 = trainer(seed=1)
        cm = CheckpointManager(root)
        assert cm.restore(tr2) == 3
        out = tr2.run_pass(dataset(), checkpoint=cm)
    assert out["batches"] == 3
    assert state_digest(tr2) == want
    for name in ("auc", "cmatch_rank"):
        msg = base.metrics.get_metric_msg(name)
        assert msg["ins_num"] > 0
        assert tr2.metrics.get_metric_msg(name) == msg


@pytest.mark.cuda
def test_hot_reload_predictions_equal_fresh_adoption(cuda, deterministic,
                                                     tmp_path):
    """Boundary checkpoints published into a store: a model that adopted
    the base and hot-reloaded the delta predicts bit for bit what a
    fresh adoption of the tip predicts."""
    from paddlebox_tpu_torch import ArtifactStore, CheckpointManager
    trainer, dataset, serving = _ckpt_setup(cuda)
    tr = trainer()
    store = ArtifactStore(str(tmp_path / "store"))
    cm = CheckpointManager(str(tmp_path / "ckpt"), artifacts=store)
    cm.save(tr)
    tr.train_pass(dataset())
    cm.save(tr, delta=True)
    v_base, v_tip = store.versions()
    batch = next(dataset().batches())
    srv = serving()
    srv.adopt(store, v_base)
    p0 = srv.predict(batch)
    assert srv.hot_reload(store) == v_tip
    assert srv.last_load["applied"] == [v_tip]
    p1 = srv.predict(batch)
    fresh = serving()
    assert fresh.adopt(store) == v_tip
    np.testing.assert_array_equal(fresh.predict(batch), p1)
    assert not np.array_equal(p0, p1)
    srv.release()
    fresh.release()


# ---------------------------------------------------------------------------
# the pipelined resident pass on the card
# ---------------------------------------------------------------------------

def _pipeline_setup(cuda, n_pass=3, s=4, mf=4, dense=3, bs=64):
    """Seeded ragged passes (slot-qualified ids), a trainer factory on
    the card (f32 tower, no lazy-mf draws) and a dataset factory."""
    from paddlebox_tpu_torch.ps.sgd import SparseSGDConfig
    torch.backends.cuda.matmul.allow_tf32 = False
    slots = ([SlotDef("label", "float", 1), SlotDef("d", "float", dense)]
             + [SlotDef(f"S{i}", "uint64") for i in range(s)])
    desc = DataFeedDesc(slots=slots, label_slot="label", batch_size=bs,
                        key_bucket_min=512)
    passes = []
    for p in range(n_pass):
        rng = np.random.default_rng(30 + p)
        recs = []
        for i in range(3 * bs - 5):
            counts = np.minimum(rng.zipf(1.5, size=s), 8)
            offs = np.zeros(s + 1, np.int32)
            np.cumsum(counts, out=offs[1:])
            keys = (np.repeat(np.arange(s, dtype=np.uint64), counts)
                    * np.uint64(10_000)
                    + rng.integers(0, 600, size=offs[-1]).astype(np.uint64))
            recs.append(SlotRecord(keys, offs,
                                   rng.normal(size=dense).astype(np.float32),
                                   float(i % 2), 1.0, float(i % 2)))
        passes.append(recs)
    cfg = SparseSGDConfig(mf_create_thresholds=0.0, mf_initial_range=0.0)

    def trainer(arena=False, dev=cuda):
        torch.manual_seed(0)
        t = EmbeddingTable(mf_dim=mf, capacity=1 << 13, cfg=cfg,
                           unique_bucket_min=512, device=dev,
                           arena_slots=s if arena else None,
                           arena_chunk_bits=6)
        return Trainer(DeepFM(s, 3 + mf, dense, hidden=(16, 8),
                              compute_dtype=torch.float32), t, desc,
                       seed=3, check_nan_inf=True, device=dev)

    def datasets(columnar=False):
        out = []
        for recs in passes:
            ds = InMemoryDataset(desc)
            ds.records = list(recs)
            if columnar:
                ds.columnarize()
            out.append(ds)
        return out

    return trainer, datasets


@pytest.mark.cuda
@pytest.mark.parametrize("arena,floats", [(False, "q8"), (False, "q8_whole"),
                                          (False, "f32"), (True, "q8")],
                         ids=["dedup_q8", "dedup_q8_whole", "dedup_f32",
                              "compact_q8"])
def test_build_streamed_on_card_stages_upload_bytes(cuda, arena, floats):
    """``build_streamed`` on the card (pinned buffers, non-blocking copies
    in 2-batch chunks, stitched on the device, its event waited on) stages
    the same bytes as ``build`` + ``upload`` on the card and as the same
    build on the CPU. The record datasets take the q8 streaming front,
    or with ``q8_whole`` the whole-pass ``quantize_floats``."""
    from paddlebox_tpu_torch.config import flags_scope
    trainer, datasets = _pipeline_setup(cuda)
    fd = {"f32": np.float32, "q8_whole": "q8"}.get(floats, floats)
    with flags_scope(q8_streaming_front=floats != "q8_whole"):
        _check_build_streamed_on_card(cuda, trainer, datasets, arena, fd)


def _check_build_streamed_on_card(cuda, trainer, datasets, arena, fd):
    from paddlebox_tpu_torch.config import flags_scope
    from paddlebox_tpu_torch.train.device_pass import ResidentPass
    with flags_scope(preload_pack_chunk_batches=2):
        rp = ResidentPass.build_streamed(datasets()[0],
                                         trainer(arena).table,
                                         floats_dtype=fd, block=False)
    cpu = ResidentPass.build_streamed(datasets()[0],
                                      trainer(arena, "cpu").table,
                                      floats_dtype=fd)
    assert rp.ready is not None and rp.wire == cpu.wire
    assert rp.wire == ("compact" if arena else "dedup")
    rp.settle()
    assert rp._pinned == []
    leaves = rp._leaves()
    assert all(t.is_cuda for t in leaves)
    for a, b in zip(leaves, cpu._leaves()):
        assert a.dtype == b.dtype and torch.equal(a.cpu(), b)
    if not arena:
        plain = ResidentPass.build(datasets()[0], trainer().table,
                                   floats_dtype=fd)
        plain.upload(cuda)
        torch.cuda.current_stream().wait_event(plain.ready)
        for a, b in zip(plain._leaves(), leaves):
            assert a.dtype == b.dtype and torch.equal(a, b)
    assert rp.formats == cpu.formats


@pytest.mark.cuda
@pytest.mark.parametrize("arena,floats", [(False, "q8"),
                                          (False, torch.bfloat16),
                                          (True, "q8")],
                         ids=["dedup_q8", "dedup_bf16", "compact_q8"])
def test_pipeline_depth2_equals_depth0_on_card(cuda, deterministic, arena,
                                               floats):
    """Three passes through the depth-2 pipeline (builds on the worker's
    stream, each pass ordered by its event) and through depth 0 give the
    same ``state_digest`` under deterministic algorithms; the four step
    kernels launch once a step."""
    from paddlebox_tpu_torch.train.checkpoint import state_digest
    trainer, datasets = _pipeline_setup(cuda)
    names = ("gather_rows", "pool_cvm", "segment_gather",
             "scatter_add_update")
    digests = []
    for depth in (2, 0):
        tr = trainer(arena)
        before = [getattr(tk, n).launches for n in names]
        res = tr.train_passes_resident(datasets(columnar=True), depth=depth,
                                       floats_dtype=floats)
        after = [getattr(tk, n).launches for n in names]
        steps = sum(r["batches"] for r in res)
        assert [a - b for a, b in zip(after, before)] == [steps] * 4
        assert not tr.table.state.data[-1].any()
        digests.append(state_digest(tr))
    assert digests[0] == digests[1]


@pytest.mark.cuda
def test_worker_insert_equals_main_thread_build(cuda, deterministic):
    """After a first pass on the host index, ``use_pallas_index`` on: the
    preloader's worker seeds the device key index from the kv and inserts
    every later pass's keys on its own stream; the index's entries, the
    kv and the trained state equal a main-thread run of the same passes
    (``build`` + ``train_pass_resident``)."""
    from paddlebox_tpu_torch.config import flags_scope
    from paddlebox_tpu_torch.ops import index as tix
    from paddlebox_tpu_torch.train.checkpoint import state_digest
    trainer, datasets = _pipeline_setup(cuda)
    worker, main = trainer(), trainer()
    for tr in (worker, main):          # a first pass on the host index
        tr.train_pass_resident(datasets()[0])
    with flags_scope(use_pallas_index=True):
        before = tix.insert.launches
        worker.train_passes_resident(datasets()[1:], depth=2)
        assert tix.insert.launches - before == 1 + 2   # seed + 2 builds
        for ds in datasets()[1:]:
            main.train_pass_resident(ds)
    dw, dm = worker.table._dev_index, main.table._dev_index
    assert not dw.degraded and not dm.degraded
    # the same (key, row) entries; which probe slot a colliding key won
    # is decided by the insert kernel's race, so the layouts may differ
    entries = []
    for d in (dw, dm):
        keys_b, rows_b = tix.bucket_views(d.buckets)
        live = rows_b >= 0
        k, r = keys_b[live].cpu().numpy(), rows_b[live].cpu().numpy()
        order = np.argsort(k)
        entries.append((k[order], r[order]))
    np.testing.assert_array_equal(entries[0][0], entries[1][0])
    np.testing.assert_array_equal(entries[0][1], entries[1][1])
    assert dw.next_row == dm.next_row
    kw, rw = worker.table.index.items()
    km, rm = main.table.index.items()
    assert dict(zip(kw.tolist(), rw.tolist())) == dict(zip(km.tolist(),
                                                           rm.tolist()))
    np.testing.assert_array_equal(dw.lookup_rows(kw), rw)
    assert state_digest(worker) == state_digest(main)


@pytest.mark.cuda
def test_native_loaded_dataset_trains_like_records(cuda, deterministic,
                                                   tmp_path):
    """The records of the checkpoint setup written to slot_text files
    (dense with 9 significant digits: exact float32) and loaded by the
    native parser give the records' batches, and ``train_pass`` over that
    dataset on the card reaches the records path's ``state_digest`` bit
    for bit under deterministic algorithms; the load's route is
    "native"."""
    from paddlebox_tpu_torch import state_digest
    trainer, dataset, _ = _ckpt_setup(cuda)
    recs = dataset().records
    s = len(recs[0].slot_offsets) - 1
    files = []
    for fi in range(3):
        path = str(tmp_path / f"part-{fi}.txt")
        with open(path, "w") as fh:
            for r in recs[fi::3]:
                toks = ["1", "%.9g" % r.label, str(len(r.dense))]
                toks += ["%.9g" % v for v in r.dense]
                for j in range(s):
                    keys = r.slot_keys(j)
                    toks += [str(len(keys))] + [str(int(k)) for k in keys]
                fh.write(" ".join(toks) + "\n")
        files.append(path)
    ordered = [r for fi in range(3) for r in recs[fi::3]]
    ds = InMemoryDataset(dataset().desc)
    ds.set_filelist(files)
    ds.load_into_memory()
    assert ds.parse_route == "native"
    ref = InMemoryDataset(dataset().desc)
    # the text format carries no ins_id/uid/rank/cmatch: the records
    # path trains the same records without them
    ref.records = [SlotRecord(r.keys, r.slot_offsets, r.dense, r.label,
                              r.show, r.clk) for r in ordered]
    for a, b in zip(ds.batches(), ref.batches()):
        for f in ("keys", "segments", "dense", "label", "show", "clk"):
            assert np.array_equal(getattr(a, f), getattr(b, f)), f
    tr_files, tr_recs = trainer(), trainer()
    before = tk.pool_cvm.launches
    tr_files.train_pass(ds)
    assert tk.pool_cvm.launches > before
    tr_recs.train_pass(ref)
    assert state_digest(tr_files) == state_digest(tr_recs)


# ---------------------------------------------------------------------------
# the sharded path (ps/sharded.py, train/sharded.py)
# ---------------------------------------------------------------------------

def _sharded_setup(dev, n=4, s=5, mf=4, dense=3, bs=64, n_rec=64 * 11,
                   init_range=None):
    """A 4-shard table on ``dev`` (one device or a list of n) loaded from
    a seeded single-table base of slot-qualified keys (a third without mf
    yet), and a dataset of ragged records over those keys and new ones.
    ``init_range`` sets mf_initial_range: runs on different devices draw
    lazy mf from different generators (Philox on the card, the Mersenne
    twister on the CPU), so they compare only with 0.0."""
    from paddlebox_tpu_torch.ps.sgd import SparseSGDConfig
    from paddlebox_tpu_torch.ps.sharded import ShardedEmbeddingTable
    rng = np.random.default_rng(15)
    slots = ([SlotDef("label", "float", 1), SlotDef("d", "float", dense)]
             + [SlotDef(f"S{i}", "uint64") for i in range(s)])
    desc = DataFeedDesc(slots=slots, label_slot="label", batch_size=bs,
                        key_bucket_min=512)
    recs = []
    for i in range(n_rec):
        counts = 1 + rng.poisson(2.0, size=s)
        offs = np.zeros(s + 1, np.int32)
        np.cumsum(counts, out=offs[1:])
        slot = np.repeat(np.arange(s), counts)
        keys = (slot * 10_000 + rng.integers(0, 900, size=int(offs[-1]))
                ).astype(np.uint64)
        recs.append(SlotRecord(keys, offs,
                               rng.normal(size=dense).astype(np.float32),
                               float(i % 3 == 0), 1.0, float(i % 3 == 0)))
    ids = np.arange(600)
    base_keys = np.concatenate([k * 10_000 + ids for k in range(s)]
                               ).astype(np.uint64)
    rows = np.zeros((len(base_keys), 8 + mf), np.float32)
    rows[:, 0] = rng.integers(1, 40, size=len(rows))
    rows[:, 3] = (base_keys // np.uint64(10_000)).astype(np.float32)
    rows[:, 4] = rng.normal(0, 0.05, size=len(rows))
    rows[:, 5:7] = 3.0
    rows[:, 7] = (rng.random(len(rows)) < 0.66).astype(np.float32)
    rows[:, 8:] = rng.normal(0, 0.05, size=(len(rows), mf)) * rows[:, 7:8]
    base = table_rows_from_logical(base_keys, rows, mf)
    cfg = SparseSGDConfig(mf_create_thresholds=0.0,
                          **({} if init_range is None else
                             {"mf_initial_range": init_range}))

    def table():
        t = ShardedEmbeddingTable(n, mf_dim=mf, capacity_per_shard=1 << 12,
                                  cfg=cfg, req_bucket_min=128,
                                  serve_bucket_min=256, devices=dev)
        t.load(base)
        return t

    def dataset():
        ds = InMemoryDataset(desc)
        ds.records = recs
        return ds

    def model():
        torch.manual_seed(4)
        return DeepFM(s, 3 + mf, dense, hidden=(32, 16),
                      compute_dtype=torch.float32)

    return desc, table, dataset, model


@pytest.mark.cuda
def test_sharded_step_kernels_match_plain(cuda):
    """One global step through the kernels against the same step through
    the plain versions, on the card, from the same state: show/clk
    counters, the slot column and the pushed grads exact, rows and dense
    params in the ragged train-state class."""
    import copy

    from paddlebox_tpu_torch.ps.table import TableState
    from paddlebox_tpu_torch.train import sharded as tsh
    from paddlebox_tpu_torch.train.step import default_tx
    desc, table, dataset, model = _sharded_setup(cuda)
    t = table()
    group = next(tsh.group_batches(dataset().batches(), t.n))
    gb = tsh.make_global_batch(group, t.prepare_global(group), t.devices)
    runs = []
    for ops in (tk.KERNELS, tk.PLAIN):
        step = tsh.ShardedTrainStep(default_tx, t.cfg, t.devices,
                                    desc.batch_size, len(desc.sparse_slots),
                                    ops=ops)
        tab = copy.copy(t)
        tab.states = [TableState(st.data.clone(), st.ext)
                      for st in t.states]
        state = step.init_state(tab, model())
        before = tk.gather_rows.launches
        stats = step(state, gb, tsh.push_generators(t.devices, 0, 1))
        torch.cuda.synchronize()
        if ops is tk.KERNELS:
            assert tk.gather_rows.launches == before + t.n
        runs.append((state, stats))
    (sk, k), (sp, p) = runs
    for a, b in zip(k["pushed"], p["pushed"]):
        assert torch.equal(a, b)
    for a, b in zip(sk.tables, sp.tables):
        assert torch.equal(a.data[:, :4], b.data[:, :4])
        np.testing.assert_allclose(a.data.cpu().numpy(),
                                   b.data.cpu().numpy(), rtol=2e-4,
                                   atol=2e-5)
    for (name, a), b in zip(sk.model.state_dict().items(),
                            sp.model.state_dict().values()):
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(),
                                   rtol=2e-4, atol=2e-5, err_msg=name)


@pytest.mark.cuda
def test_sharded_trainer_chunks_and_index_route(cuda, deterministic):
    """train_pass on the card: a2a_chunks 2 and 4 and the device key index
    give the monolithic run's digests bit for bit under deterministic
    algorithms, and the eval AUC with the device index is the host
    index's."""
    from paddlebox_tpu_torch.config import flags_scope
    from paddlebox_tpu_torch.train.checkpoint import (elastic_state_digest,
                                                      sharded_state_digest)
    from paddlebox_tpu_torch.train.sharded import ShardedTrainer

    def run(dev, chunks=1, flag=False):
        desc, table, dataset, model = _sharded_setup(dev)
        with flags_scope(a2a_chunks=chunks, use_pallas_index=flag):
            tr = ShardedTrainer(model(), table(), desc, seed=2)
            res = tr.train_pass(dataset())
            ev = tr.eval_pass(dataset())
        return tr, res, ev

    mono, res, ev = run(cuda)
    assert res["batches"] == 3 and np.isfinite(res["last_loss"])
    want = sharded_state_digest(mono)
    for chunks in (2, 4):
        assert sharded_state_digest(run(cuda, chunks)[0]) == want
    on = run(cuda, flag=True)
    assert elastic_state_digest(on[0]) == elastic_state_digest(mono)
    assert on[2]["auc"] == ev["auc"]


def _sharded_logical(table):
    """Every shard's rows keyed by feasign, sorted: (keys, rows)."""
    keys, blocks = [], []
    for s in range(table.n):
        k, r = table.indexes[s].items()
        keys.append(k)
        blocks.append(table._rows_host(s, r))
    keys = np.concatenate(keys)
    order = np.argsort(keys)
    return keys[order], np.concatenate(blocks)[order]


def _sharded_run(dev, chunks=1, zero1=False):
    """Two train passes and an eval pass of the ``_sharded_setup`` table
    on ``dev``, lazy mf drawing nothing; (trainer, logical rows, params,
    pass results, eval result)."""
    from paddlebox_tpu_torch.config import flags_scope
    from paddlebox_tpu_torch.train.sharded import ShardedTrainer
    desc, table, dataset, model = _sharded_setup(dev, init_range=0.0)
    with flags_scope(a2a_chunks=chunks):
        tr = ShardedTrainer(model(), table(), desc, seed=2, zero1=zero1)
        res = [tr.train_pass(dataset()) for _ in range(2)]
        ev = tr.eval_pass(dataset())
    for st in tr.table.states:
        assert not st.data[-1].any(), "the sentinel row was written"
    return (tr, _sharded_logical(tr.table),
            {k: v.cpu().numpy() for k, v in tr.model.state_dict().items()},
            res, ev)


def _assert_sharded_close(got, want):
    """Two ``_sharded_run`` results in the ragged train-state class: the
    same keys, show/clk/slot columns exact, rows and params within rtol
    2e-4 / atol 2e-5, the AUCs within 1e-5."""
    (gk, gr), (wk, wr) = got[1], want[1]
    np.testing.assert_array_equal(gk, wk)
    np.testing.assert_array_equal(gr[:, [0, 1, 3]], wr[:, [0, 1, 3]])
    np.testing.assert_allclose(gr, wr, rtol=2e-4, atol=2e-5)
    for name, v in want[2].items():
        np.testing.assert_allclose(got[2][name], v, rtol=2e-4, atol=2e-5,
                                   err_msg=name)
    for a, b in zip(got[3], want[3]):
        assert a["batches"] == b["batches"] == 3
        assert abs(a["auc"] - b["auc"]) < 1e-5
    assert abs(got[4]["auc"] - want[4]["auc"]) < 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("chunks,zero1", [(1, False), (2, True)])
def test_sharded_training_on_card_matches_cpu(cuda, chunks, zero1):
    """The 4-shard train_pass and eval_pass on the card (kernels) against
    the same run on the CPU (plain versions, held against the JAX
    package by tests/test_torch_sharded.py). f32 tower, TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    names = ("gather_rows", "pool_cvm", "segment_gather",
             "scatter_add_update")
    before = [getattr(tk, n).launches for n in names]
    card = _sharded_run(cuda, chunks, zero1)
    assert all(getattr(tk, n).launches > b for n, b in zip(names, before))
    assert all(r["chunked_batches"] == (3 if chunks > 1 else 0)
               for r in card[3])
    _assert_sharded_close(card, _sharded_run("cpu", chunks, zero1))


@pytest.mark.cuda
@pytest.mark.parametrize("chunks,zero1", [(1, False), (2, True)])
def test_sharded_mixed_devices_match_one_device(cuda, chunks, zero1):
    """Shards on two devices, the card and the CPU in turns: the
    exchanges copy between them, destinations 1 and 3 run a CPU replica
    of the model, ZeRO-1 steps each chunk on its shard's device and the
    dense grads are summed on the card. Against the same run with every
    shard on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    mixed = _sharded_run([cuda, "cpu", cuda, "cpu"], chunks, zero1)
    tr = mixed[0]
    assert [st.data.device.type for st in tr.table.states] == [
        "cuda", "cpu", "cuda", "cpu"]
    assert [d.type for d in tr.step_fn._replicas] == ["cpu"]
    if zero1:
        assert [c.device.type for c in tr.state.opt.chunks] == [
            "cuda", "cpu", "cuda", "cpu"]
    _assert_sharded_close(mixed, _sharded_run(cuda, chunks, zero1))


class _ReluInputs(torch.overrides.TorchFunctionMode):
    """Records, on the host, the input of every ``F.relu`` call made
    under it: the towers' hidden pre-activations, in call order."""

    def __init__(self):
        super().__init__()
        self.inputs = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func is torch.nn.functional.relu:
            self.inputs.append(args[0].detach().cpu())
        return func(*args, **(kwargs or {}))


def _mixed_two_step_runs(cs, card, steps=2):
    """``chip_smoke.py`` phase 13's data and start (module ``cs``), then
    ``steps`` ZeRO-1 SGD global steps (lazy mf drawing nothing) with the
    shards all on ``card``, on card/CPU/card/CPU and all on the CPU.
    Per run and step: copies of the tables, pushed grads and params (the
    next step updates a CPU shard's in place) and the towers' ReLU
    inputs, on the host."""
    import copy
    import dataclasses

    from paddlebox_tpu_torch import convert
    from paddlebox_tpu_torch.ps.sharded import ShardedEmbeddingTable
    from paddlebox_tpu_torch.ps.table import TableState
    from paddlebox_tpu_torch.train import sharded as SH

    slots = ([SlotDef("label", "float", 1),
              SlotDef("dense", "float", cs.DENSE_DIM)]
             + [SlotDef(f"C{i}", "uint64")
                for i in range(1, cs.NUM_SLOTS + 1)])
    desc = DataFeedDesc(slots=slots, batch_size=cs.BATCH,
                        label_slot="label", key_bucket_min=4096)
    base = cs.make_table_blob(np.random.default_rng(1), convert,
                              vocab=cs.TRAIN_BASE_VOCAB, no_mf=0.25)
    records = cs.make_records(np.random.default_rng(13),
                              cs.BATCH * cs.SHARD_BATCHES, SlotRecord)
    builder = BatchBuilder(desc)
    batches = [builder.build(records[i:i + cs.BATCH])
               for i in range(0, cs.BATCH * cs.SHARD_N * steps, cs.BATCH)]
    groups = list(SH.group_batches(batches, cs.SHARD_N))
    table = ShardedEmbeddingTable(cs.SHARD_N, mf_dim=cs.MF_DIM,
                                  capacity_per_shard=cs.SHARD_CAPACITY,
                                  devices=card)
    table.load(base)
    plans = [table.prepare_global(g) for g in groups]
    start = [st.data.clone() for st in table.states]
    cfg0 = dataclasses.replace(table.cfg, mf_initial_range=0.0)
    n = cs.SHARD_N
    layouts = {"card": [torch.device(card)] * n,
               "mixed": [torch.device(card), torch.device("cpu")] * (n // 2),
               "cpu": [torch.device("cpu")] * n}
    runs = {}
    for name, devs in layouts.items():
        tab = copy.copy(table)
        tab.states = [TableState(x.to(d, copy=True), table.opt_ext)
                      for x, d in zip(start, devs)]
        step = SH.ShardedTrainStep(lambda p: torch.optim.SGD(p, lr=0.05),
                                   cfg0, devs, cs.BATCH, cs.NUM_SLOTS,
                                   zero1=True, ops=tk.KERNELS)
        torch.manual_seed(2)
        st = step.init_state(tab, DeepFM(cs.NUM_SLOTS, 3 + cs.MF_DIM,
                                         cs.DENSE_DIM, hidden=cs.HIDDEN,
                                         compute_dtype=torch.float32))
        runs[name] = []
        for i in range(steps):
            with _ReluInputs() as relu:
                out = step(st, SH.make_global_batch(groups[i], plans[i],
                                                    devs),
                           SH.push_generators(devs, 0, i + 1))
            state = ([x.data for x in st.tables] + out["pushed"]
                     + list(st.model.state_dict().values()))
            runs[name].append(dict(
                state=[x.detach().to("cpu", copy=True) for x in state],
                relu=relu.inputs))
    return runs


@pytest.mark.cuda
def test_sharded_mixed_devices_two_steps_at_full_width(cuda):
    """Phase 13's mixed-device check of ``chip_smoke.py`` at its width,
    continued to a second SGD step. Between any two of the layouts (all
    on the card, card/CPU in turns, all on the CPU) a table, pushed-grad
    or param element leaves the ragged train-state class (rtol 2e-4 /
    atol 2e-5) only from a step at which some tower ReLU input took the
    other sign in the two runs: a pre-activation within float order of
    zero, not a fault of the copies, the CPU replica or the ZeRO-1
    chunks. Why the smoke's check stops at one step."""
    import chip_smoke as cs
    torch.backends.cuda.matmul.allow_tf32 = False
    runs = _mixed_two_step_runs(cs, cuda)
    for a, b in (("mixed", "card"), ("cpu", "card"), ("mixed", "cpu")):
        flips = 0
        for i, (ra, rb) in enumerate(zip(runs[a], runs[b])):
            assert len(ra["relu"]) == len(rb["relu"]) > 0
            near = 0.0
            for xa, xb in zip(ra["relu"], rb["relu"]):
                flip = (xa > 0) != (xb > 0)
                flips += int(flip.sum())
                if flip.any():
                    near = max(near, float(torch.maximum(
                        xa.abs(), xb.abs())[flip].max()))
            n_out, err = 0, 0.0
            for xa, xb in zip(ra["state"], rb["state"]):
                d = (xa.double() - xb.double()).abs()
                n_out += int((d > 2e-5 + 2e-4 * xb.double().abs()).sum())
                err = max(err, float(d.max()) if d.numel() else 0.0)
            print(f"{a} vs {b} step {i + 1}: {n_out} elements out of "
                  f"class, max abs err {err:.3g}; ReLU sign flips so far "
                  f"{flips} (|input| <= {near:.3g} this step)")
            assert n_out == 0 or flips > 0, (a, b, i + 1, n_out, err)


# ---------------------------------------------------------------------------
# the sharded resident pass
# ---------------------------------------------------------------------------

def _resident_run(dev, chunks=1, depth=None):
    """Two resident passes of the ``_sharded_setup`` table on ``dev``
    (lazy mf drawing nothing), through a ``PassPreloader`` of ``depth``
    when given; the same result tuple as ``_sharded_run`` (the eval pass
    after the two)."""
    from paddlebox_tpu_torch.config import flags_scope
    from paddlebox_tpu_torch.train.device_pass import PassPreloader
    from paddlebox_tpu_torch.train.sharded import ShardedTrainer
    desc, table, dataset, model = _sharded_setup(dev, init_range=0.0)
    with flags_scope(a2a_chunks=chunks):
        tr = ShardedTrainer(model(), table(), desc, seed=2)
        if depth is None:
            res = [tr.train_pass_resident(dataset()) for _ in range(2)]
        else:
            pre = PassPreloader(iter([dataset(), dataset()]),
                                build_fn=tr.build_resident_pass,
                                depth=depth, device=dev)
            res = []
            try:
                pre.start_next()
                while (rp := pre.wait()) is not None:
                    more = pre.start_next()
                    res.append(tr.train_pass_resident(rp))
                    if not more:
                        break
            finally:
                pre.drain()
        ev = tr.eval_pass(dataset())
    return (tr, _sharded_logical(tr.table),
            {k: v.cpu().numpy() for k, v in tr.model.state_dict().items()},
            res, ev)


@pytest.mark.cuda
@pytest.mark.parametrize("chunks", [1, 2])
def test_sharded_resident_on_card_matches_cpu(cuda, chunks):
    """Two resident passes on the card (kernels, the wire decoded there)
    against the same passes on the CPU (plain versions, held against the
    JAX package by tests/test_torch_sharded_resident.py), in the ragged
    train-state class; on the card the resident pass equals train_pass
    bit for bit under deterministic algorithms."""
    from paddlebox_tpu_torch.train.checkpoint import sharded_state_digest
    torch.backends.cuda.matmul.allow_tf32 = False
    before = tk.gather_rows.launches
    card = _resident_run(cuda, chunks)
    assert tk.gather_rows.launches > before
    _assert_sharded_close(card, _resident_run("cpu", chunks))
    torch.use_deterministic_algorithms(True)
    try:
        res = _resident_run(cuda, chunks)[0]
        stream = _sharded_run(cuda, chunks)[0]
    finally:
        torch.use_deterministic_algorithms(False)
    assert sharded_state_digest(res) == sharded_state_digest(stream)


@pytest.mark.cuda
def test_sharded_resident_preloader_on_card(cuda, deterministic):
    """Two passes through a depth-2 preloader (built and staged on the
    worker's stream, ordered by each pass's events) equal depth 0 and
    the plain resident loop bit for bit."""
    from paddlebox_tpu_torch.train.checkpoint import sharded_state_digest
    digests = [sharded_state_digest(_resident_run(cuda, depth=d)[0])
               for d in (2, 0, None)]
    assert digests[0] == digests[1] == digests[2]


# ---------------------------------------------------------------------------
# the tiered store: the window's row copies and tiered passes on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("k", [700, 5000])
def test_window_row_copies_on_card_match_cpu(cuda, k):
    """The begin-pass scatter (kernel row 3, padded to the DMA row-count
    contract with the zero sentinel) and the end-pass read (kernel row 4
    into pinned memory, an event after the copy) on the card equal the
    same calls on the CPU exactly; the sentinel stays zero."""
    from paddlebox_tpu_torch.ps.table import (RowsToHost, TableState,
                                              scatter_window_rows)
    rng = np.random.default_rng(k)
    cap, feat = 1 << 14, 16
    data = rng.normal(size=(cap + 1, feat)).astype(np.float32)
    data[cap] = 0.0
    rows = rng.permutation(cap)[:k].astype(np.int32)
    vals = rng.normal(size=(k, feat)).astype(np.float32)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        st = TableState(torch.from_numpy(data.copy()).to(dev))
        s0, g0 = tk.scatter_rows_dma.launches, tk.gather_rows_dma.launches
        scatter_window_rows(st, rows, vals)
        copy = RowsToHost(st, rows[::-1].copy())
        got = copy.wait()
        if dev.type == "cuda":
            assert tk.scatter_rows_dma.launches == s0 + 1
            assert tk.gather_rows_dma.launches == g0 + 1
        out[dev.type] = (st.data.cpu().numpy(), got.copy())
    np.testing.assert_array_equal(out["cuda"][0], out["cpu"][0])
    np.testing.assert_array_equal(out["cuda"][1], out["cpu"][1])
    np.testing.assert_array_equal(out["cuda"][1], vals[::-1])
    assert not out["cuda"][0][cap].any()


def _tiered_run(dev, depth=0, cap=1 << 12):
    """Three resident passes (a third of the records each) of the
    ``_sharded_setup`` data through ``train_passes_tiered`` on a tiered
    table on ``dev`` holding the setup's base in its host tier (lazy mf
    drawing nothing): the host model, the dense params and the
    results, as ``_sharded_run`` gives them."""
    import tempfile
    from paddlebox_tpu_torch.ps.table import rows_from_store_fields
    from paddlebox_tpu_torch.ps.tiered import TieredShardedEmbeddingTable
    from paddlebox_tpu_torch.train.sharded import ShardedTrainer
    desc, table, dataset, model = _sharded_setup("cpu", init_range=0.0)
    base = table()
    recs = dataset().records
    parts = []
    for i in range(3):
        ds = InMemoryDataset(desc)
        ds.records = recs[i * len(recs) // 3:(i + 1) * len(recs) // 3]
        parts.append(ds)
    with tempfile.TemporaryDirectory() as tmp:
        t = TieredShardedEmbeddingTable(
            4, mf_dim=base.mf_dim, capacity_per_shard=cap, cfg=base.cfg,
            req_bucket_min=128, serve_bucket_min=256, host_capacity=900,
            ssd_dir=tmp, devices=dev)
        import os
        path = os.path.join(tmp, "base.npz")
        base.save_base(path)
        t.load(path)
        tr = ShardedTrainer(model(), t, desc, seed=2)
        res = tr.train_passes_tiered(parts, depth=depth)
        t.fence()
        keys, rows = [], []
        for h in t.hosts:
            k, f = h.export_rows(clear_touched=False)
            keys.append(k)
            rows.append(rows_from_store_fields(f, t.mf_dim, t.opt_ext))
        keys = np.concatenate(keys)
        o = np.argsort(keys)
        params = {n: v.detach().cpu().numpy()
                  for n, v in tr.model.state_dict().items()}
        return tr, (keys[o], np.concatenate(rows)[o]), params, res, \
            dict(t.ssd_stats(), evicted=t._evict_async_rows)


@pytest.mark.cuda
def test_tiered_passes_on_card_match_cpu(cuda):
    """Three tiered resident passes on the card (windows that evict,
    host stores that spill to SSD segments, the write-back through
    pinned memory on the epilogue worker) against the same passes on
    the CPU (held against the JAX package by tests/test_torch_tiered.py),
    in the ragged train-state class; on the card, depth 2 equals depth 0
    bit for bit under deterministic algorithms."""
    torch.backends.cuda.matmul.allow_tf32 = False
    s0, g0 = tk.scatter_rows_dma.launches, tk.gather_rows_dma.launches
    card = _tiered_run(cuda, cap=800)
    assert tk.scatter_rows_dma.launches > s0
    assert tk.gather_rows_dma.launches > g0
    assert card[4]["demoted_rows"] > 0 and card[4]["promoted_rows"] > 0
    assert card[4]["evicted"] > 0
    cpu = _tiered_run("cpu", cap=800)
    (gk, gr), (wk, wr) = card[1], cpu[1]
    np.testing.assert_array_equal(gk, wk)
    np.testing.assert_array_equal(gr[:, [0, 1, 3]], wr[:, [0, 1, 3]])
    np.testing.assert_allclose(gr, wr, rtol=2e-4, atol=2e-5)
    for name, v in cpu[2].items():
        np.testing.assert_allclose(card[2][name], v, rtol=2e-4, atol=2e-5,
                                   err_msg=name)
    for a, b in zip(card[3], cpu[3]):
        assert abs(a["auc"] - b["auc"]) < 1e-5
    torch.use_deterministic_algorithms(True)
    try:
        d2 = _tiered_run(cuda, depth=2, cap=1 << 12)
        d0 = _tiered_run(cuda, depth=0, cap=1 << 12)
    finally:
        torch.use_deterministic_algorithms(False)
    np.testing.assert_array_equal(d2[1][0], d0[1][0])
    np.testing.assert_array_equal(d2[1][1], d0[1][1])
    for name, v in d0[2].items():
        np.testing.assert_array_equal(d2[2][name], v, err_msg=name)


def _pass_table_run(dev):
    """Three passes of the ``_sharded_setup`` data (a third of the
    records each) through ``BoxPSHelper`` over a ``PassScopedTable`` of
    3000 rows on ``dev`` (smaller than the passes' union, so begin_pass
    evicts and writes dirty evictees back) and a ``Trainer``: the host
    store's rows and the dense params."""
    from paddlebox_tpu_torch.ps import (BoxPSHelper, HostStore,
                                        PassScopedTable)
    from paddlebox_tpu_torch.ps.sgd import SparseSGDConfig
    from paddlebox_tpu_torch.ps.table import rows_from_store_fields
    desc, table, dataset, model = _sharded_setup("cpu", init_range=0.0)
    recs = dataset().records
    hs = HostStore(mf_dim=4, capacity=1 << 14)
    t = PassScopedTable(hs, pass_capacity=3000,
                        cfg=SparseSGDConfig(mf_create_thresholds=0.0,
                                            mf_initial_range=0.0),
                        device=dev)
    tr = Trainer(model(), t, desc, seed=2, device=dev)
    helper = BoxPSHelper(t, trainer=tr)
    evicted = 0
    for i in range(3):
        ds = InMemoryDataset(desc)
        ds.records = recs[i * len(recs) // 3:(i + 1) * len(recs) // 3]
        helper.begin_pass(ds)
        evicted += t.last_pass_stats["evicted"]
        tr.train_pass(ds)
        helper.end_pass(ds)
    t.fence()
    keys, f = hs.export_rows(clear_touched=False)
    o = np.argsort(keys)
    return (keys[o], rows_from_store_fields(f, 4, 0)[o],
            {n: v.detach().cpu().numpy()
             for n, v in tr.model.state_dict().items()}, evicted)


@pytest.mark.cuda
def test_pass_scoped_table_on_card_matches_cpu(cuda):
    """A single-table pass window on the card that evicts (the delta
    scatter by row 3, the write-back read by row 4 into pinned memory on
    the epilogue worker) against the same passes on the CPU, in the
    ragged train-state class."""
    torch.backends.cuda.matmul.allow_tf32 = False
    card = _pass_table_run(cuda)
    cpu = _pass_table_run(torch.device("cpu"))
    assert card[3] > 0 and card[3] == cpu[3]
    np.testing.assert_array_equal(card[0], cpu[0])
    np.testing.assert_array_equal(card[1][:, [0, 1, 3]], cpu[1][:, [0, 1, 3]])
    np.testing.assert_allclose(card[1], cpu[1], rtol=2e-4, atol=2e-5)
    for name, v in cpu[2].items():
        np.testing.assert_allclose(card[2][name], v, rtol=2e-4, atol=2e-5,
                                   err_msg=name)


# ---------------------------------------------------------------------------
# multi-mf (ps/multi_mf.py, ps/multi_mf_sharded.py, train/multi_mf_*.py)
# ---------------------------------------------------------------------------

MMF_TEST_DIMS = [2] * 10 + [4] * 10 + [8] * 6     # row widths 10, 12, 16
MMF_CHIP_DIMS = [4] * 10 + [8] * 10 + [16] * 6    # 12, 16, 24


def _mmf_setup(n_rec=64 * 8, bs=64, dense=13, vocab=400, seed=21):
    """26 ragged slots (1 + Poisson(2) keys each, slot-qualified ids)
    and the desc of batches of ``bs``."""
    rng = np.random.default_rng(seed)
    s = len(MMF_TEST_DIMS)
    slots = ([SlotDef("label", "float", 1), SlotDef("d", "float", dense)]
             + [SlotDef(f"C{i}", "uint64") for i in range(s)])
    desc = DataFeedDesc(slots=slots, label_slot="label", batch_size=bs,
                        key_bucket_min=1024)
    recs = []
    for i in range(n_rec):
        counts = 1 + rng.poisson(2.0, size=s)
        offs = np.zeros(s + 1, np.int32)
        np.cumsum(counts, out=offs[1:])
        slot = np.repeat(np.arange(s), counts)
        keys = (slot * 100_000 + rng.integers(0, vocab, size=int(offs[-1]))
                ).astype(np.uint64)
        lab = float(rng.random() < 0.3)
        recs.append(SlotRecord(keys, offs,
                               rng.normal(size=dense).astype(np.float32),
                               lab, 1.0, lab))
    return desc, recs


def _mmf_model(width, dense=13):
    from paddlebox_tpu_torch.models import CtrDnn
    torch.manual_seed(6)
    return CtrDnn(1, width, dense, hidden=(32, 16),
                  compute_dtype=torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("dims", [MMF_TEST_DIMS, MMF_CHIP_DIMS],
                         ids=["test_dims", "chip_dims"])
def test_multi_mf_step_kernels_match_plain(cuda, dims):
    """Two multi-mf steps through the kernels against the plain versions
    from one state, per class widths 10/12/16 (row 1's and row 13's
    vec = 1 paths at 10) and 12/16/24: the per-class pulls exact, show/
    clk exact, rows and dense params in the ragged train-state class;
    every kernel of the path launched."""
    from paddlebox_tpu_torch.metrics import init_auc_state
    from paddlebox_tpu_torch.ps import MultiMfEmbeddingTable
    from paddlebox_tpu_torch.ps.sgd import SparseSGDConfig
    from paddlebox_tpu_torch.ps.table import TableState
    from paddlebox_tpu_torch.train.multi_mf_step import (
        MultiMfStepState, MultiMfTrainStep, class_device_batches,
        class_generators)
    from paddlebox_tpu_torch.train.step import default_tx
    torch.backends.cuda.matmul.allow_tf32 = False
    desc, recs = _mmf_setup()
    table = MultiMfEmbeddingTable(
        dims, capacity=1 << 14, device=cuda,
        cfg=SparseSGDConfig(mf_create_thresholds=0.0,
                            mf_initial_range=0.0))
    builder = BatchBuilder(desc)
    batches = [builder.build(recs[i:i + 64]) for i in (0, 64)]
    cbs = [table.prepare(b) for b in batches]
    width = table.pooled_width()
    runs = {}
    for name, ops in (("kernels", tk.KERNELS), ("plain", tk.PLAIN)):
        m = _mmf_model(width).to(cuda)
        st = MultiMfStepState(
            tables=[TableState(t.state.data.clone(), t.state.ext)
                    for t in table.tables],
            model=m, opt=default_tx(m.parameters()),
            auc=init_auc_state(device=cuda))
        step = MultiMfTrainStep(table, 64, ops=ops)
        before = {f: getattr(tk, f).launches for f in
                  ("gather_rows", "pool_cvm", "segment_gather",
                   "scatter_add_update")}
        pulls = []
        for i, cb in enumerate(cbs):
            devs = class_device_batches(cb, cuda)
            pulls.append([ops.gather_rows(s.data, d.unique_rows)
                          for s, d in zip(st.tables, devs)])
            step(st, devs, class_generators(cuda, 0, i + 1, len(dims)),
                 [c.index.num_unique for c in cb])
        torch.cuda.synchronize()
        if ops is tk.KERNELS:
            for f, n0 in before.items():
                assert getattr(tk, f).launches > n0, f
        runs[name] = (st, pulls)
    (sk, pk), (sp, pp) = runs["kernels"], runs["plain"]
    for a, b in zip(pk[0], pp[0]):
        assert torch.equal(a, b)
    for a, b in zip(sk.tables, sp.tables):
        assert a.data.shape[1] in (10, 12, 16, 24)
        assert torch.equal(a.data[:, :2], b.data[:, :2])
        np.testing.assert_allclose(a.data.cpu().numpy(),
                                   b.data.cpu().numpy(), rtol=2e-4,
                                   atol=2e-5)
    for (name, a), b in zip(sk.model.state_dict().items(),
                            sp.model.state_dict().values()):
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(),
                                   rtol=2e-4, atol=2e-5, err_msg=name)


@pytest.mark.cuda
def test_multi_mf_resident_equals_streaming_on_card(cuda, deterministic):
    """The multi-mf resident pass equals train_pass on the card bit for
    bit, lazy mf drawing (each class's draw covers its real rows)."""
    from paddlebox_tpu_torch.ps import MultiMfEmbeddingTable
    from paddlebox_tpu_torch.ps.sgd import SparseSGDConfig
    from paddlebox_tpu_torch.train import MultiMfTrainer
    torch.backends.cuda.matmul.allow_tf32 = False
    desc, recs = _mmf_setup()
    ds = InMemoryDataset(desc)
    ds.records = recs
    out = []
    for resident in (False, True):
        table = MultiMfEmbeddingTable(
            MMF_TEST_DIMS, capacity=1 << 14, device=cuda,
            cfg=SparseSGDConfig(mf_create_thresholds=0.0))
        tr = MultiMfTrainer(_mmf_model(table.pooled_width()), table, desc,
                            seed=1)
        res = (tr.train_pass_resident(ds) if resident
               else tr.train_pass(ds))
        out.append((tr, res))
    (a, ra), (b, rb) = out
    assert ra["auc"] == rb["auc"] and ra["last_loss"] == rb["last_loss"]
    for ta, tb_ in zip(a.table.tables, b.table.tables):
        assert torch.equal(ta.state.data, tb_.state.data)
    for k, v in a.model.state_dict().items():
        assert torch.equal(v, b.model.state_dict()[k]), k


@pytest.mark.cuda
def test_multi_mf_tiered_equals_plain_sharded_on_card(cuda, deterministic,
                                                      tmp_path):
    """Four passes through ``BoxPSHelper`` over a
    ``MultiMfTieredShardedTable`` whose class windows are smaller than
    the model (they evict and write back through rows 3 and 4; SSD
    tiers) against a plain ``MultiMfShardedTable`` trained straight
    through: the models read back through the host tiers equal bit for
    bit, the dense params too."""
    from paddlebox_tpu_torch.ps import (BoxPSHelper, MultiMfShardedTable,
                                        MultiMfTieredShardedTable)
    from paddlebox_tpu_torch.ps.sgd import SparseSGDConfig
    from paddlebox_tpu_torch.train import MultiMfShardedTrainer
    torch.backends.cuda.matmul.allow_tf32 = False
    desc, recs = _mmf_setup(n_rec=64 * 16, vocab=3000)
    passes = []
    for i in range(4):
        ds = InMemoryDataset(desc)
        ds.records = recs[i * 256:(i + 1) * 256]
        passes.append(ds)
    cfg = SparseSGDConfig(mf_create_thresholds=0.0, mf_initial_range=0.0)
    kw = dict(cfg=cfg, req_bucket_min=256, serve_bucket_min=512,
              devices=cuda)
    plain = MultiMfShardedTable(4, MMF_TEST_DIMS,
                                capacity_per_shard=1 << 13, **kw)
    tiered = MultiMfTieredShardedTable(
        4, MMF_TEST_DIMS, capacity_per_shard=1 << 11, host_capacity=4000,
        ssd_dir=str(tmp_path), **kw)
    width = plain.pooled_width()
    tr_p = MultiMfShardedTrainer(_mmf_model(width), plain, desc, seed=1)
    tr_t = MultiMfShardedTrainer(_mmf_model(width), tiered, desc, seed=1)
    helper = BoxPSHelper(tiered, trainer=tr_t)
    s0, g0 = tk.scatter_rows_dma.launches, tk.gather_rows_dma.launches
    evicted = 0
    for ds in passes:
        tr_p.train_pass(ds)
        helper.begin_pass(ds)
        evicted += sum(t.last_pass_stats["evicted"]
                       for t in tiered.tables)
        tr_t.train_pass(ds)
        helper.end_pass(ds)
    tiered.fence()
    torch.cuda.synchronize()
    assert tk.scatter_rows_dma.launches > s0
    assert tk.gather_rows_dma.launches > g0
    assert evicted > 0
    from paddlebox_tpu_torch.ps.table import rows_from_store_fields
    demoted = 0
    for t, p in zip(tiered.tables, plain.tables):
        demoted += t.ssd_stats().get("demoted_rows", 0)
        keys, rows, pk, pr = [], [], [], []
        for s, h in enumerate(t.hosts):
            k, f = h.export_rows(clear_touched=False)
            keys.append(k)
            rows.append(rows_from_store_fields(f, t.mf_dim, t.opt_ext))
            k, r = p.indexes[s].items()
            pk.append(k)
            pr.append(p._rows_host(s, r))
        o, po = np.argsort(np.concatenate(keys)), np.argsort(
            np.concatenate(pk))
        np.testing.assert_array_equal(np.concatenate(keys)[o],
                                      np.concatenate(pk)[po])
        np.testing.assert_array_equal(np.concatenate(rows)[o],
                                      np.concatenate(pr)[po])
    assert demoted > 0
    for k, v in tr_p.model.state_dict().items():
        assert torch.equal(v, tr_t.model.state_dict()[k]), k
