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


@pytest.mark.parametrize("k,row", [(1, 4), (37, 8), (64, 8), (3000, 1024)])
def test_suffix_min_segment_stream(k, row):
    """The pool kernel's id stream: a dropped key takes the next valid
    key's id (n past the last), so the stream is nondecreasing and the
    tail pads join no segment."""
    rng = np.random.default_rng(k)
    n = 30
    segments = np.sort(rng.integers(0, n, size=k)).astype(np.int32)
    segments[rng.random(k) < 0.1] = -1                # drop markers
    segments[k - k // 5:] = n                         # tail pads
    seg = torch.from_numpy(segments)
    valid = (seg >= 0) & (seg < n)
    got = tk._suffix_min(torch.where(valid, seg, n), n, row).numpy()
    want = np.minimum.accumulate(
        np.where(valid.numpy(), segments, n)[::-1])[::-1]
    np.testing.assert_array_equal(got, want)
    assert (np.diff(got) >= 0).all()


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
                            torch.from_numpy(segments), b, s,
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
    got = fused_seqpool_cvm(torch.from_numpy(values), None, b, s, **args)
    np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=ATOL)


def test_fused_seqpool_cvm_unported_attrs_raise():
    values, segments, _, b, s = _ragged()
    v, sg = torch.from_numpy(values), torch.from_numpy(segments)
    with pytest.raises(NotImplementedError, match="training slice"):
        fused_seqpool_cvm(v, sg, b, s, use_cvm=False, embedx_concate_size=2)
    with pytest.raises(NotImplementedError, match="training slice"):
        fused_seqpool_cvm(v, sg, b, s, embed_threshold_filter=True)
    # plain CVM ignores the concat size, as the reference does
    fused_seqpool_cvm(v, sg, b, s, embedx_concate_size=2)
