"""Port kernels (paddlebox_tpu_torch.ops) against the JAX package.

On the CPU each wrapper takes its plain PyTorch version; the JAX side runs
both its default XLA composition and the Pallas kernel in interpret mode
(the flags below). Inputs come from numpy seeds and cross as numpy.

Tolerances: the gather is a copy and must be exact. The pooling forward
sums in another order than XLA's scatter-add and the MXU one-hot matmul,
so it is held to the pooling-forward class, rtol 3e-5 (atol 1e-6 for
values near zero, where the CVM head's log differences cancel).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from paddlebox_tpu.config import flags_scope
from paddlebox_tpu.ops import pallas_kernels as jpk
from paddlebox_tpu.ops.seqpool_cvm import fused_seqpool_cvm as j_seqpool
from paddlebox_tpu.ps import table as jtable

from paddlebox_tpu_torch.ops import kernels as tk
from paddlebox_tpu_torch.ops.seqpool_cvm import fused_seqpool_cvm
from paddlebox_tpu_torch.ps import table as ttable

RTOL, ATOL = 3e-5, 1e-6
JAX_FLAGS = {"xla": {}, "pallas": {"use_pallas_gather": True,
                                   "use_pallas_seqpool": True}}


def _table(cap=50, feat=12, seed=0):
    rng = np.random.default_rng(seed)
    data = rng.normal(size=(cap + 1, feat)).astype(np.float32)
    data[cap] = 0.0           # sentinel row
    data[::3, 7] = 0.0        # mf_size == 0 rows gate embedx off
    return data


@pytest.mark.parametrize("flags", sorted(JAX_FLAGS))
def test_gather_full_rows_exact(flags):
    cap, feat = 50, 12
    data = _table(cap, feat)
    rng = np.random.default_rng(1)
    u = 37
    rows = np.empty(40, np.int32)
    rows[:u] = rng.permutation(cap)[:u]
    ttable.fill_oob_pads(rows, u, cap)   # distinct ids > cap
    with flags_scope(**JAX_FLAGS[flags]):
        ref = np.asarray(jtable.gather_full_rows(
            jtable.TableState.from_logical(data, cap), jnp.asarray(rows)))
    st = ttable.TableState(torch.from_numpy(data))
    got = ttable.gather_full_rows(st, torch.from_numpy(rows))
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(got.numpy()[u:], 0.0)
    # the pull-value view and the per-key expand match exactly too
    mf = feat - 8
    vals = ttable.pull_values(got, mf)
    np.testing.assert_array_equal(
        vals.numpy(), np.asarray(jtable.pull_values(jnp.asarray(ref), mf)))
    gi = rng.integers(0, 41, size=64).astype(np.int32)  # 40 clamps
    np.testing.assert_array_equal(
        ttable.expand_pull(vals, torch.from_numpy(gi)).numpy(),
        np.asarray(jtable.expand_pull(jnp.asarray(vals.numpy()),
                                      jnp.asarray(gi))))


def test_gather_rows_plain_clamps_negative_to_sentinel():
    data = _table(10, 8)
    got = tk.gather_rows(torch.from_numpy(data),
                         torch.tensor([-1, 3, 11, 10], dtype=torch.int32))
    np.testing.assert_array_equal(got.numpy(), data[[10, 3, 10, 10]])


def _ragged(b=6, s=5, d=7, seed=0, k_pad=256):
    """Nondecreasing ins*S+slot ids with empty segments, −1 markers in
    the middle of the stream and B*S pads at the tail."""
    rng = np.random.default_rng(seed)
    n = b * s
    counts = rng.poisson(2.0, size=n)
    counts[rng.choice(n, 5, replace=False)] = 0      # empty segments
    seg = np.repeat(np.arange(n, dtype=np.int32), counts)
    k = len(seg)
    seg[rng.choice(k, 4, replace=False)] = -1         # drop markers
    segments = np.full(k_pad, n, np.int32)            # tail pads
    segments[:k] = seg
    values = rng.normal(size=(k_pad, d)).astype(np.float32)
    values[:, :2] = rng.integers(0, 6, size=(k_pad, 2))   # show/clk counts
    values[:, 1] = np.minimum(values[:, 1], values[:, 0])
    keep = (rng.random(k_pad) < 0.8).astype(np.float32)
    return values, segments, keep, b, s


@pytest.mark.parametrize("mode,cvm_offset,ets", [
    (jpk.CVM_NONE, 2, 0), (jpk.CVM_NONE, 2, 1), (jpk.CVM_FULL, 2, 0),
    (jpk.CVM_FULL, 3, 0), (jpk.CVM_SHOW, 2, 0), (jpk.CVM_CONV, 3, 0)])
@pytest.mark.parametrize("pad_value", [0.0, 0.25])
def test_pool_cvm_matches_pallas_kernel(mode, cvm_offset, ets, pad_value):
    values, segments, keep, b, s = _ragged()
    ref = np.asarray(jpk.fused_pool_cvm_forward(
        jnp.asarray(values), jnp.asarray(segments), jnp.asarray(keep), b, s,
        cvm_mode=mode, cvm_offset=cvm_offset, ets=ets, pad_value=pad_value))
    got = tk.pool_cvm(torch.from_numpy(values), torch.from_numpy(segments),
                      torch.from_numpy(keep), b, s, cvm_mode=mode,
                      cvm_offset=cvm_offset, ets=ets, pad_value=pad_value)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=ATOL)


def _bounds_case(name):
    """Segment id streams of the pool kernels' contract: ids inside [0, n)
    nondecreasing, anything else dropped. Returns (ids, n)."""
    rng = np.random.default_rng(len(name))
    n = 30
    if name == "k0":
        return np.zeros(0, np.int32), n
    if name == "one_segment":                 # every key in segment 0
        return np.zeros(500, np.int32), 1
    if name == "all_dropped":
        return rng.choice([-1, n, n + 9], size=40).astype(np.int32), n
    ids = np.sort(rng.integers(0, n, size=200)).astype(np.int32)
    if name == "drop_markers":                # −1 anywhere, leading too
        ids[rng.random(200) < 0.2] = -1
        ids[0] = -1
    elif name == "tail_pads":                 # pads at n and past it
        ids[150:] = n
        ids[-5:] = n + 3
    else:
        assert name == "empty_segments"       # whole runs of ids missing
        ids = ids[(ids % 7 != 3) & ((ids < 10) | (ids > 16))]
    return ids, n


@pytest.mark.parametrize("name", ["drop_markers", "tail_pads",
                                  "empty_segments", "all_dropped", "k0",
                                  "one_segment"])
def test_segment_bounds_plain(name):
    """segment_bounds_plain (what the pool kernels' bounds pass computes):
    start = the first key of each segment, end = its last + 1, both −1
    for a segment with no key."""
    ids, n = _bounds_case(name)
    start = np.full(n, -1, np.int64)
    end = np.full(n, -1, np.int64)
    for j, s in enumerate(ids):
        if 0 <= s < n:
            start[s] = j if start[s] < 0 else start[s]
            end[s] = j + 1
    got = tk.segment_bounds_plain(torch.from_numpy(ids), n)
    assert got.dtype == torch.int32 and got.shape == (2, n)
    np.testing.assert_array_equal(got[0].numpy(), start)
    np.testing.assert_array_equal(got[1].numpy(), end)
    # the keys inside a segment's [start, end) are its own or dropped
    for s in range(n):
        inner = ids[max(start[s], 0):max(end[s], 0)]
        assert ((inner == s) | (inner < 0) | (inner >= n)).all()


@pytest.mark.parametrize("flags", sorted(JAX_FLAGS))
@pytest.mark.parametrize("kw", [
    dict(),
    dict(use_cvm=False),
    dict(use_cvm=False, embed_thres_size=2),
    dict(clk_filter=True),
    dict(need_filter=True, threshold=0.9),
    dict(quant_ratio=64, pad_value=0.5),
    dict(cvm_offset=3),
], ids=["full", "nocvm", "nocvm_ets", "show", "filter", "quant_pad",
        "offset3"])
def test_fused_seqpool_cvm_forward(flags, kw):
    values, segments, _, b, s = _ragged(seed=3)
    args = dict(use_cvm=True, cvm_offset=2, pad_value=0.0,
                need_filter=False, show_coeff=0.2, clk_coeff=1.0,
                threshold=0.96, quant_ratio=0, clk_filter=False)
    args.update(kw)
    ets = args.pop("embed_thres_size", 0)
    show_clk = np.ones((b, 2), np.float32)
    with flags_scope(**JAX_FLAGS[flags]):
        ref = np.asarray(j_seqpool(
            jnp.asarray(values), jnp.asarray(segments),
            jnp.asarray(show_clk), b, s, args["use_cvm"],
            args["cvm_offset"], args["pad_value"], args["need_filter"],
            args["show_coeff"], args["clk_coeff"], args["threshold"],
            args["quant_ratio"], args["clk_filter"],
            embed_thres_size=ets))
    got = fused_seqpool_cvm(torch.from_numpy(values),
                            torch.from_numpy(segments),
                            torch.from_numpy(show_clk), b, s,
                            embed_thres_size=ets, **args)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("kw", [dict(), dict(use_cvm=False),
                                dict(clk_filter=True, pad_value=0.5)])
@pytest.mark.parametrize("k", [30, 24])   # full and short key bucket
def test_fused_seqpool_cvm_trivial_layout(kw, k):
    b, s, d = 6, 5, 7
    rng = np.random.default_rng(5)
    values = rng.normal(size=(k, d)).astype(np.float32)
    values[:, :2] = np.abs(values[:, :2])
    args = dict(use_cvm=True, pad_value=0.0, clk_filter=False)
    args.update(kw)
    ref = np.asarray(j_seqpool(
        jnp.asarray(values), None, jnp.ones((b, 2)), b, s, args["use_cvm"],
        2, args["pad_value"], clk_filter=args["clk_filter"]))
    got = fused_seqpool_cvm(torch.from_numpy(values), None,
                            torch.ones((b, 2)), b, s, **args)
    np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=ATOL)


def test_fused_seqpool_cvm_unported_attrs_raise():
    """The concat form and embed_threshold_filter, once unported, now run
    (their parity: tests/test_torch_seqpool_family.py); the output widths
    follow the reference's InferShape."""
    values, segments, _, b, s = _ragged()
    v, sg = torch.from_numpy(values), torch.from_numpy(segments)
    sc = torch.ones((b, 2))
    d = values.shape[1]
    out = fused_seqpool_cvm(v, sg, sc, b, s, use_cvm=False,
                            embedx_concate_size=2)
    assert out.shape == (b, s, (d - 2) * 2)
    out = fused_seqpool_cvm(v, sg, sc, b, s, clk_filter=True,
                            embedx_concate_size=3)
    assert out.shape == (b, s, (d - 1) * 3)
    out = fused_seqpool_cvm(v, sg, sc, b, s, embed_threshold_filter=True,
                            embed_threshold=0.5)
    assert out.shape == (b, s, d) and np.isfinite(out.numpy()).all()
    # plain CVM ignores the concat size, as the reference does
    assert fused_seqpool_cvm(v, sg, sc, b, s,
                             embedx_concate_size=2).shape == (b, s, d)


# ---------------------------------------------------------------------------
# segment_sum (row 5) and the row copies (rows 2-4)
# ---------------------------------------------------------------------------

def _sum_case(name):
    """The segment_sum_mxu cases of tests/test_pallas_kernels.py: values,
    segments, num_segments."""
    rng = np.random.default_rng(4)
    if name.startswith("sweep"):
        k, n = {"sweep_a": (100, 40), "sweep_b": (700, 200),
                "sweep_c": (7, 3), "sweep_d": (1500, 3000)}[name]
        vals = rng.normal(size=(k, 11)).astype(np.float32)
        return vals, np.sort(rng.integers(0, n, size=k)).astype(np.int32), n
    if name == "gap_blocks":        # keys only in the last segment
        return np.ones((8, 4), np.float32), np.full(8, 999, np.int32), 1000
    if name == "drop_negative":
        return (np.ones((4, 3), np.float32),
                np.array([0, 1, -1, -1], np.int32), 2)
    if name == "leading_interleaved_drops":
        return (np.arange(20, dtype=np.float32).reshape(5, 4),
                np.array([-1, 0, -1, 0, 1], np.int32), 2)
    if name == "discard_bin":       # ids at num_segments - 1 (a pad bin)
        seg = np.sort(rng.integers(0, 12, size=60)).astype(np.int32)
        seg[-15:] = 12
        return rng.normal(size=(60, 5)).astype(np.float32), seg, 13
    if name == "wide":              # D > 128: several column tiles
        seg = np.sort(rng.integers(0, 9, size=50)).astype(np.int32)
        seg[rng.random(50) < 0.2] = -1
        return rng.normal(size=(50, 150)).astype(np.float32), seg, 9
    assert name == "empty"          # K = 0
    return np.zeros((0, 6), np.float32), np.zeros(0, np.int32), 5


@pytest.mark.parametrize("name", [
    "sweep_a", "sweep_b", "sweep_c", "sweep_d", "gap_blocks",
    "drop_negative", "leading_interleaved_drops", "discard_bin", "wide",
    "empty"])
def test_segment_sum_matches_mxu(name):
    values, segments, n = _sum_case(name)
    ref = np.asarray(jpk.segment_sum_mxu(jnp.asarray(values),
                                         jnp.asarray(segments), n))
    for fn in (tk.segment_sum_plain, tk.segment_sum):
        got = fn(torch.from_numpy(values), torch.from_numpy(segments), n)
        assert got.shape == ref.shape == (n, values.shape[1])
        np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=1e-5)


def test_segment_sum_grad_and_dtype():
    """The grad (a gather of the output grad's rows: segment_gather_mxu
    under the flag) is exact; a bf16 input sums in f32 and comes back
    bf16; no segments is an empty result."""
    rng = np.random.default_rng(6)
    vals = rng.normal(size=(50, 5)).astype(np.float32)
    segs = np.sort(rng.integers(0, 12, size=50)).astype(np.int32)
    segs[[3, 20]] = -1
    segs[-4:] = 14                                    # past num_segments
    w = rng.normal(size=(12, 5)).astype(np.float32)
    with flags_scope(use_pallas_seqpool=True):
        ref = np.asarray(jax.grad(lambda v: (jpk.segment_sum_mxu(
            v, jnp.asarray(segs), 12) * jnp.asarray(w)).sum())(
                jnp.asarray(vals)))
    for fn in (tk.segment_sum, tk.segment_sum_plain):
        v = torch.from_numpy(vals).requires_grad_(True)
        (fn(v, torch.from_numpy(segs), 12) * torch.from_numpy(w)).sum(
        ).backward()
        np.testing.assert_array_equal(v.grad.numpy(), ref)
    vb = torch.from_numpy(vals).to(torch.bfloat16)
    got = tk.segment_sum(vb, torch.from_numpy(segs), 12)
    assert got.dtype == torch.bfloat16
    want = tk.segment_sum_plain(vb.float(), torch.from_numpy(segs), 12)
    torch.testing.assert_close(got, want.to(torch.bfloat16))
    assert tk.segment_sum(vb, torch.from_numpy(segs), 0).shape == (0, 5)


def _row_case(c=64, d=16, k=32, seed=0):
    """A zero table [C+1, D], K rows: distinct in-bounds ids, then
    distinct out-of-bounds pads (the unique-row bucket's contract)."""
    rng = np.random.default_rng(seed)
    uq = np.unique(rng.integers(0, c, size=k).astype(np.int32))
    rows = np.concatenate([uq, c + 1 + np.arange(k - len(uq),
                                                 dtype=np.int32)])
    vals = rng.normal(size=(k, d)).astype(np.float32)
    return np.zeros((c + 1, d), np.float32), rows, vals, len(uq)


def test_scatter_rows_matches_pallas():
    table, rows, vals, u = _row_case(seed=2)
    table[:] = np.random.default_rng(3).normal(size=table.shape)
    ref = np.asarray(jpk.scatter_rows(jnp.asarray(table), jnp.asarray(rows),
                                      jnp.asarray(vals)))
    for fn in (tk.scatter_rows, tk.scatter_rows_plain):
        t = torch.from_numpy(table.copy())
        assert fn(t, torch.from_numpy(rows), torch.from_numpy(vals)) is t
        # the last row is the pads' racy sentinel
        np.testing.assert_array_equal(t.numpy()[:-1], ref[:-1])
        np.testing.assert_array_equal(t.numpy()[rows[:u]], vals[:u])


def test_dma_row_copies_match_pallas():
    """scatter_rows_dma / gather_rows_dma as
    tests/test_pallas_kernels.py::test_dma_kernels_interpret_semantics
    runs them (interpret mode): out-of-bounds rows clamp to the sentinel,
    the scatter writes in place."""
    table, rows, vals, u = _row_case()
    c = table.shape[0] - 1
    ref = np.array(jpk.scatter_rows_dma(jnp.asarray(table),
                                        jnp.asarray(rows),
                                        jnp.asarray(vals)))
    ref[c] = 0.0
    ref_g = np.asarray(jpk.gather_rows_dma(jnp.asarray(ref),
                                           jnp.asarray(rows)))
    for scatter, gather in ((tk.scatter_rows_dma, tk.gather_rows_dma),
                            (tk.scatter_rows_dma_plain,
                             tk.gather_rows_dma_plain)):
        t = torch.from_numpy(table.copy())
        assert scatter(t, torch.from_numpy(rows),
                       torch.from_numpy(vals)) is t
        np.testing.assert_array_equal(t.numpy()[:c], ref[:c])
        t[c] = 0.0
        got = gather(t, torch.from_numpy(rows)).numpy()
        np.testing.assert_array_equal(got, ref_g)
        np.testing.assert_array_equal(got[u:], 0.0)
        # the TPU grid's row-count rule: K a multiple of min(2048, K)
        with pytest.raises(ValueError, match="multiple of 2048"):
            gather(t, torch.zeros(2049, dtype=torch.int32))
        with pytest.raises(ValueError, match="multiple of 2048"):
            scatter(t, torch.zeros(2050, dtype=torch.int32),
                    torch.zeros((2050, t.shape[1])))
