"""The seqpool op family of the port against the JAX package, on the CPU.

Every op of ``paddlebox_tpu_torch.ops.seqpool_cvm`` (the concat form,
embed_threshold_filter, conv, slot groups, seqpool_concat, the shared
pool), ``ops.seqpool_variants`` (diff_thres, tradew, credit, pcoc),
``ops.kernels.fused_embed_pool_cvm`` and ``ops.cvm`` runs forward and
backward here (plain kernel versions, CPU tensors) and in the JAX
package, under both ``FLAGS.use_pallas_seqpool`` settings (the XLA
compositions, and the Pallas kernels in interpret mode). Inputs come
from numpy seeds and cross as numpy.

Tolerances: forwards hold the pooling-forward class, rtol 3e-5 (atol 1e-6
near zero, where the CVM head's log differences cancel). Backwards are
gathers plus copied head values and must match exactly, except tradew's
trade_id column, Σ g·embed over the embed columns, an f32 sum in another
order: atol 1e-6.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from paddlebox_tpu.config import flags_scope
from paddlebox_tpu.ops.cvm import cvm as j_cvm
from paddlebox_tpu.ops.cvm import cvm_grad_passthrough as j_passthrough
from paddlebox_tpu.ops import pallas_kernels as jpk
from paddlebox_tpu.ops import seqpool_cvm as jsc
from paddlebox_tpu.ops import seqpool_variants as jsv

from paddlebox_tpu_torch.ops import kernels as tk
from paddlebox_tpu_torch.ops import seqpool_cvm as tsc
from paddlebox_tpu_torch.ops import seqpool_variants as tsv
from paddlebox_tpu_torch.ops.cvm import cvm as t_cvm
from paddlebox_tpu_torch.ops.cvm import cvm_grad_passthrough as t_passthrough

RTOL, ATOL = 3e-5, 1e-6
FLAGS = {"xla": {}, "pallas": {"use_pallas_seqpool": True}}
B, S = 6, 5


def _stream(rng, b=B, s=S, k_pad=160, lam=2.0, drops=0):
    """BatchBuilder-style ids: nondecreasing ins*S+slot with empty
    segments, ``drops`` −1 markers in the stream and B*S pads at the
    tail."""
    n = b * s
    counts = rng.poisson(lam, size=n)
    counts[rng.choice(n, 3, replace=False)] = 0
    seg = np.repeat(np.arange(n, dtype=np.int32), counts)[:k_pad - 8]
    if drops:
        seg[rng.choice(len(seg), drops, replace=False)] = -1
    segments = np.full(k_pad, n, np.int32)
    segments[:len(seg)] = seg
    return segments


def _values(rng, k, d, cvm_cols=2):
    """Seeded values with non-negative count columns (clk <= show)."""
    v = rng.normal(size=(k, d)).astype(np.float32)
    v[:, :cvm_cols] = rng.integers(0, 6, size=(k, cvm_cols))
    v[:, 1] = np.minimum(v[:, 1], v[:, 0])
    return v


def _vjp(flags, fn, values, rng):
    """JAX forward and the vjp of a seeded cotangent; returns (out, grad,
    cotangent) as numpy."""
    with flags_scope(**FLAGS[flags]):
        out, vjp = jax.vjp(fn, jnp.asarray(values))
        g = rng.normal(size=out.shape).astype(np.float32)
        (grad,) = vjp(jnp.asarray(g))
    return np.asarray(out), np.asarray(grad), g


def _torch_grad(fn, values, g):
    v = torch.from_numpy(values).requires_grad_(True)
    out = fn(v)
    out.backward(torch.from_numpy(g))
    return out.detach().numpy(), v.grad.numpy()


def _check(out, ref, grad, ref_grad):
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(grad, ref_grad)
    assert np.abs(grad).sum() > 0


# ---------------------------------------------------------------------------
# fused_seqpool_cvm: the concat form and embed_threshold_filter
# ---------------------------------------------------------------------------

_CONCAT_CASES = {
    "kk3_show": ("ragged", dict(
        clk_filter=True, embedx_concate_size=3, pad_value=0.25,
        need_filter=True, embedx_concate_filter=True)),
    "kk3_nocvm": ("ragged", dict(
        use_cvm=False, embedx_concate_size=3, pad_value=0.25,
        need_filter=True, embedx_concate_filter=True)),
    "kk2_nocvm_ets": ("ragged", dict(use_cvm=False, embedx_concate_size=2,
                                     embed_thres_size=1)),
    "kk2_trivial": ("trivial", dict(use_cvm=False, embedx_concate_size=2,
                                    pad_value=0.5)),
    "etf": ("ragged", dict(embed_threshold_filter=True, embed_threshold=1.2,
                           embed_thres_size=3)),
    "etf_trivial": ("trivial", dict(clk_filter=True,
                                    embed_threshold_filter=True,
                                    embed_threshold=1.0)),
    "etf_kk2": ("ragged", dict(use_cvm=False, embedx_concate_size=2,
                               embedx_concate_filter=True,
                               embed_threshold_filter=True,
                               embed_threshold=1.0, embed_thres_size=2)),
}


def _cases(names, pallas):
    """Every case under the XLA compositions; those in ``pallas`` under
    the Pallas kernels too (interpret mode costs ~0.4 s a kernel call
    here, so each op runs its widest cases there)."""
    return ([("xla", c) for c in names]
            + [("pallas", c) for c in names if c in pallas])


@pytest.mark.parametrize("flags,case", _cases(
    _CONCAT_CASES, ("kk3_show", "kk3_nocvm", "etf")))
def test_seqpool_cvm_concat_and_threshold(flags, case):
    layout, kw = _CONCAT_CASES[case]
    rng = np.random.default_rng(7)
    d = 7
    if layout == "ragged":
        segments = _stream(rng)
        k = len(segments)
        nk = int((segments < B * S).sum())
    else:
        segments, k, nk = None, B * S + 4, B * S - 3
    values = _values(rng, k, d)
    show_clk = rng.integers(0, 3, size=(B, 2)).astype(np.float32)
    key_valid = (np.arange(k) < nk).astype(np.float32)
    args = dict(use_cvm=True, cvm_offset=2, pad_value=0.0, need_filter=False,
                show_coeff=0.2, clk_coeff=1.0, threshold=0.96, quant_ratio=0,
                clk_filter=False, embed_threshold_filter=False,
                embed_threshold=0.0, embed_thres_size=0,
                embedx_concate_size=1, embedx_concate_filter=False)
    args.update(kw)
    jseg = None if segments is None else jnp.asarray(segments)
    ref, ref_grad, g = _vjp(flags, lambda v: jsc.fused_seqpool_cvm(
        v, jseg, jnp.asarray(show_clk), B, S, *args.values(),
        key_valid=jnp.asarray(key_valid)), values, rng)
    tseg = None if segments is None else torch.from_numpy(segments)
    out, grad = _torch_grad(lambda v: tsc.fused_seqpool_cvm(
        v, tseg, torch.from_numpy(show_clk), B, S,
        key_valid=torch.from_numpy(key_valid), **args), values, g)
    _check(out, ref, grad, ref_grad)


def test_segment_ranks_matches_reference():
    rng = np.random.default_rng(3)
    segments = rng.integers(-1, 9, size=300).astype(np.int32)  # any order
    np.testing.assert_array_equal(
        tsc._segment_ranks(torch.from_numpy(segments)).numpy(),
        np.asarray(jsc._segment_ranks(jnp.asarray(segments))))
    assert tsc._segment_ranks(torch.zeros(0, dtype=torch.int32)).shape == (0,)


_KEEP_CASES = {
    "filter_etf": dict(need_filter=True, embed_threshold_filter=True,
                       embed_threshold=0.8),
    "etf_ets": dict(embed_threshold_filter=True, embed_threshold=1.5,
                    embed_thres_size=2)}


@pytest.mark.parametrize("flags,case", _cases(_KEEP_CASES, ("filter_etf",)))
@pytest.mark.parametrize("layout", ["ragged", "trivial"])
def test_keep_mask_and_pool_core(flags, case, layout):
    """The shared keep mask and the two pool bodies against JAX's."""
    kw = _KEEP_CASES[case]
    rng = np.random.default_rng(9)
    segments = _stream(rng, drops=4) if layout == "ragged" else None
    k = B * S + 2 if segments is None else len(segments)
    values = _values(rng, k, 6)
    args = dict(cvm_offset=2, need_filter=False, show_coeff=0.2,
                clk_coeff=1.0, threshold=0.96, embed_threshold_filter=False,
                embed_threshold=0.0, embed_thres_size=0)
    args.update(kw)
    ref_keep = np.asarray(jsc._keep_mask(jnp.asarray(values), *args.values()))
    keep = tsc._keep_mask(torch.from_numpy(values), *args.values())
    np.testing.assert_array_equal(keep.numpy(), ref_keep)
    jseg = None if segments is None else jnp.asarray(segments)
    tseg = None if segments is None else torch.from_numpy(segments)
    with flags_scope(**FLAGS[flags]):
        ref = np.asarray(jsc._pool_core(jnp.asarray(values), jseg, B, S,
                                        jnp.asarray(ref_keep), 0.25))
        ref_f, ref_fk = jsc._filtered_pool(jnp.asarray(values), jseg, B, S,
                                           0.5, True, 0.2, 1.0, 0.96)
    got = tsc._pool_core(torch.from_numpy(values), tseg, B, S, keep, 0.25)
    np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=ATOL)
    got_f, got_fk = tsc._filtered_pool(torch.from_numpy(values), tseg, B, S,
                                       0.5, True, 0.2, 1.0, 0.96)
    np.testing.assert_allclose(got_f.numpy(), np.asarray(ref_f), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_array_equal(got_fk.numpy(), np.asarray(ref_fk))


# ---------------------------------------------------------------------------
# conv, slot groups, seqpool_concat, fused_embed_pool_cvm
# ---------------------------------------------------------------------------

_CONV_CASES = {"cvm": (True, False, False, 0.0),
               "show_filter": (True, True, True, 0.25),
               "nocvm": (False, False, True, 0.0)}


@pytest.mark.parametrize("flags,case", _cases(_CONV_CASES,
                                              ("show_filter",)))
def test_seqpool_cvm_with_conv(flags, case):
    use_cvm, show_filter, need_filter, pad_value = _CONV_CASES[case]
    rng = np.random.default_rng(13)
    segments = _stream(rng, drops=3)
    values = _values(rng, len(segments), 8, cvm_cols=3)
    head = rng.integers(0, 4, size=(B, 3)).astype(np.float32)
    args = (use_cvm, show_filter, pad_value, need_filter, 0.2, 1.0, 0.96)
    ref, ref_grad, g = _vjp(flags, lambda v: jsc.fused_seqpool_cvm_with_conv(
        v, jnp.asarray(segments), jnp.asarray(head), B, S, *args), values,
        rng)
    out, grad = _torch_grad(lambda v: tsc.fused_seqpool_cvm_with_conv(
        v, torch.from_numpy(segments), torch.from_numpy(head), B, S, *args),
        values, g)
    _check(out, ref, grad, ref_grad)


@pytest.mark.parametrize("flags,groups", _cases((1, 2, 4), (2,)))
def test_seqpool_cvm_slot_group(flags, groups):
    """Each group's block against JAX's, and the blocks in slot order
    against the monolithic op (forward and backward)."""
    rng = np.random.default_rng(17)
    n = B * S
    full = _stream(rng, lam=1.5)
    values = _values(rng, len(full), 7)
    show_clk = rng.integers(0, 3, size=(B, 2)).astype(np.float32)
    assert tsc.slot_group_bounds(S, groups) == jsc.slot_group_bounds(
        S, groups)
    blocks, grads = [], np.zeros_like(values)
    g_full = rng.normal(size=(B, S, 7)).astype(np.float32)
    slot = full % S
    picks = [np.nonzero((full < n) & (slot >= lo) & (slot < hi))[0]
             for lo, hi in tsc.slot_group_bounds(S, groups)]
    width = max(len(p) for p in picks) + 4
    for (lo, hi), pick in zip(tsc.slot_group_bounds(S, groups), picks):
        # every group's stream padded to one length (pads at B*S): JAX
        # compiles each shape once
        seg = np.full(width, n, np.int32)
        seg[:len(pick)] = full[pick]
        val = np.zeros((width, 7), np.float32)
        val[:len(pick)] = values[pick]

        def jf(v):
            return jsc.fused_seqpool_cvm_slot_group(
                v, jnp.asarray(seg), jnp.asarray(show_clk), B, S, lo, hi)

        with flags_scope(**FLAGS[flags]):
            ref, vjp = jax.vjp(jf, jnp.asarray(val))
            (ref_grad,) = vjp(jnp.asarray(g_full[:, lo:hi]))
        v = torch.from_numpy(val).requires_grad_(True)
        out = tsc.fused_seqpool_cvm_slot_group(
            v, torch.from_numpy(seg), torch.from_numpy(show_clk), B, S, lo,
            hi)
        out.backward(torch.from_numpy(np.ascontiguousarray(
            g_full[:, lo:hi])))
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_array_equal(v.grad.numpy(), np.asarray(ref_grad))
        blocks.append(out.detach().numpy())
        grads[pick] = v.grad.numpy()[:len(pick)]
    v = torch.from_numpy(values).requires_grad_(True)
    mono = tsc.fused_seqpool_cvm(v, torch.from_numpy(full),
                                 torch.from_numpy(show_clk), B, S)
    mono.backward(torch.from_numpy(g_full))
    np.testing.assert_array_equal(np.concatenate(blocks, axis=1),
                                  mono.detach().numpy())
    np.testing.assert_array_equal(grads, v.grad.numpy())


@pytest.mark.parametrize("flags,pad_value", _cases((0.0, 0.5), (0.5,)))
def test_seqpool_concat(flags, pad_value):
    rng = np.random.default_rng(19)
    segments = _stream(rng)
    values = _values(rng, len(segments), 9)
    ref, ref_grad, g = _vjp(flags, lambda v: jsc.fused_seqpool_concat(
        v, jnp.asarray(segments), B, S, pad_value), values, rng)
    out, grad = _torch_grad(lambda v: tsc.fused_seqpool_concat(
        v, torch.from_numpy(segments), B, S, pad_value), values, g)
    _check(out, ref, grad, ref_grad)


@pytest.mark.parametrize("use_cvm,need_filter,cvm_offset,pad_value", [
    (True, True, 3, 0.25), (False, True, 2, 0.0)],
    ids=["filter_offset3", "nocvm"])
def test_fused_embed_pool_cvm(use_cvm, need_filter, cvm_offset, pad_value):
    """The standalone fused op (JAX: the Pallas kernel in interpret mode
    and its custom_vjp); a negative id is a pad here."""
    rng = np.random.default_rng(23)
    segments = _stream(rng, drops=4)
    values = _values(rng, len(segments), 8)
    show_clk = rng.integers(0, 3, size=(B, cvm_offset)).astype(np.float32)
    args = (use_cvm, cvm_offset, pad_value, need_filter, 0.2, 1.0, 0.96)
    ref, ref_grad, g = _vjp("xla", lambda v: jpk.fused_embed_pool_cvm(
        v, jnp.asarray(segments), jnp.asarray(show_clk), B, S, *args),
        values, rng)
    out, grad = _torch_grad(lambda v: tk.fused_embed_pool_cvm(
        v, torch.from_numpy(segments), torch.from_numpy(show_clk), B, S,
        *args), values, g)
    _check(out, ref, grad, ref_grad)
    assert not grad[segments < 0].any()


# ---------------------------------------------------------------------------
# the variants
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("flags,use_cvm", _cases((True, False), (True,)))
def test_seqpool_cvm_with_diff_thres(flags, use_cvm):
    rng = np.random.default_rng(29)
    segments = _stream(rng, drops=3)
    values = _values(rng, len(segments), 7)
    show_clk = rng.integers(0, 3, size=(B, 2)).astype(np.float32)
    thr = rng.uniform(0.2, 2.0, size=S).astype(np.float32)   # per slot
    args = (B, S, use_cvm, 2, 0.25, 0.2, 1.0, True)
    ref, ref_grad, g = _vjp(flags, lambda v: (
        jsv.fused_seqpool_cvm_with_diff_thres(
            v, jnp.asarray(segments), jnp.asarray(show_clk),
            jnp.asarray(thr), *args)), values, rng)
    out, grad = _torch_grad(lambda v: tsv.fused_seqpool_cvm_with_diff_thres(
        v, torch.from_numpy(segments), torch.from_numpy(show_clk),
        torch.from_numpy(thr), *args), values, g)
    _check(out, ref, grad, ref_grad)


@pytest.mark.parametrize("flags,mode", _cases(
    ((-1, True), (-1, False), (1, True), (2, False)), ((-1, True), (1, True))))
def test_seqpool_cvm_tradew(flags, mode):
    trade_id, use_cvm = mode
    rng = np.random.default_rng(31)
    segments = _stream(rng, drops=3)
    co, tn = 2, 3
    values = _values(rng, len(segments), co + tn + 6)
    show_clk = rng.integers(0, 3, size=(B, co)).astype(np.float32)
    args = (B, S, tn, trade_id, use_cvm, co)
    if trade_id >= 0:
        ref, ref_grad, g = _vjp(flags, lambda v: jsv.fused_seqpool_cvm_tradew(
            v, jnp.asarray(segments), jnp.asarray(show_clk), *args), values,
            rng)
    else:
        # the JAX normal-mode vjp drops ``values`` from its residuals and
        # then reads values.shape (AttributeError): run its forward, and
        # its backward with the values handed back in the residuals
        with flags_scope(**FLAGS[flags]):
            out, res = jsv._fwd_tw(jnp.asarray(values), jnp.asarray(segments),
                                   jnp.asarray(show_clk), *args)
            g = rng.normal(size=out.shape).astype(np.float32)
            (ref_grad,) = jsv._bwd_tw(*args, (res[0], jnp.asarray(values),
                                              *res[2:]), jnp.asarray(g))[:1]
        ref, ref_grad = np.asarray(out), np.asarray(ref_grad)
    out, grad = _torch_grad(lambda v: tsv.fused_seqpool_cvm_tradew(
        v, torch.from_numpy(segments), torch.from_numpy(show_clk), *args),
        values, g)
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)
    col = co + trade_id if trade_id >= 0 else None
    rest = [c for c in range(values.shape[1]) if c != col]
    np.testing.assert_array_equal(grad[:, rest], ref_grad[:, rest])
    if col is not None:   # Σ g·embed: an f32 sum in another order
        np.testing.assert_allclose(grad[:, col], ref_grad[:, col], rtol=0,
                                   atol=1e-6)
    assert np.abs(grad).sum() > 0


@pytest.mark.parametrize("flags,mode", _cases(
    ((True, False), (True, True), (False, False)), ((True, True),)))
def test_seqpool_cvm_with_credit(flags, mode):
    use_cvm, show_filter = mode
    rng = np.random.default_rng(37)
    segments = _stream(rng, drops=3)
    values = _values(rng, len(segments), 4 + 5, cvm_cols=4)
    batch_cvm = rng.integers(0, 4, size=(B, 4)).astype(np.float32)
    ref, ref_grad, g = _vjp(flags, lambda v: (
        jsv.fused_seqpool_cvm_with_credit(
            v, jnp.asarray(segments), jnp.asarray(batch_cvm), B, S, use_cvm,
            show_filter)), values, rng)
    out, grad = _torch_grad(lambda v: tsv.fused_seqpool_cvm_with_credit(
        v, torch.from_numpy(segments), torch.from_numpy(batch_cvm), B, S,
        use_cvm, show_filter), values, g)
    _check(out, ref, grad, ref_grad)


@pytest.mark.parametrize("flags,use_cvm", _cases((True, False), (True,)))
def test_seqpool_cvm_with_pcoc(flags, use_cvm):
    rng = np.random.default_rng(41)
    segments = _stream(rng, drops=3)
    p = 2
    values = _values(rng, len(segments), 4 + p + 5, cvm_cols=4 + p)
    batch_cvm = rng.integers(0, 4, size=(B, 4 + p)).astype(np.float32)
    q_values = rng.normal(size=(B, p)).astype(np.float32)
    ref, ref_grad, g = _vjp(flags, lambda v: jsv.fused_seqpool_cvm_with_pcoc(
        v, jnp.asarray(segments), jnp.asarray(batch_cvm),
        jnp.asarray(q_values), B, S, use_cvm), values, rng)
    out, grad = _torch_grad(lambda v: tsv.fused_seqpool_cvm_with_pcoc(
        v, torch.from_numpy(segments), torch.from_numpy(batch_cvm),
        torch.from_numpy(q_values), B, S, use_cvm), values, g)
    _check(out, ref, grad, ref_grad)


# ---------------------------------------------------------------------------
# cvm, and the negative-id grad head
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_cvm", [True, False])
def test_cvm_and_grad_passthrough(use_cvm):
    rng = np.random.default_rng(43)
    x = _values(rng, 12, 6)
    batch_cvm = rng.integers(0, 4, size=(12, 2)).astype(np.float32)
    ref, ref_grad, g = _vjp("xla", lambda v: j_cvm(
        v, jnp.asarray(batch_cvm), use_cvm), x, rng)
    out, grad = _torch_grad(lambda v: t_cvm(
        v, torch.from_numpy(batch_cvm), use_cvm), x, g)
    _check(out, ref, grad, ref_grad)
    ref, ref_grad, g = _vjp("xla", j_passthrough, x, rng)
    out, grad = _torch_grad(t_passthrough, x, g)
    _check(out, ref, grad, ref_grad)


_NEG_CASES = {"full": dict(), "show": dict(clk_filter=True),
              "nocvm_ets": dict(use_cvm=False, embed_thres_size=1)}


@pytest.mark.parametrize("flags,case", _cases(_NEG_CASES, ("full",)))
def test_negative_segment_grad_head(flags, case):
    """A key with a negative segment id: JAX gives it the batch show/clk
    of instance floor(id / S), indexed from the end (then clamped), and
    zero embedx columns (for id −1 under both flag settings; flag off
    reads other embedx rows for ids below −1, flag on zeros). The port
    writes that row."""
    rng = np.random.default_rng(47)
    segments = _stream(rng)
    neg = np.array([-1, -2, -S, -S - 1, -B * S + 2, -B * S - 7], np.int32)
    at = rng.choice(len(segments) - 8, len(neg), replace=False)
    segments[at] = neg
    values = _values(rng, len(segments), 7)
    show_clk = rng.integers(1, 5, size=(B, 2)).astype(np.float32)
    args = dict(use_cvm=True, cvm_offset=2, pad_value=0.0, need_filter=False,
                show_coeff=0.2, clk_coeff=1.0, threshold=0.96, quant_ratio=0,
                clk_filter=False, embed_threshold_filter=False,
                embed_threshold=0.0, embed_thres_size=0)
    args.update(_NEG_CASES[case])
    ref, ref_grad, g = _vjp(flags, lambda v: jsc.fused_seqpool_cvm(
        v, jnp.asarray(segments), jnp.asarray(show_clk), B, S,
        *args.values()), values, rng)
    out, grad = _torch_grad(lambda v: tsc.fused_seqpool_cvm(
        v, torch.from_numpy(segments), torch.from_numpy(show_clk), B, S,
        **args), values, g)
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)
    full_rows = segments >= -1 if flags == "xla" else slice(None)
    np.testing.assert_array_equal(grad[full_rows], ref_grad[full_rows])
    np.testing.assert_array_equal(grad[at, :2], ref_grad[at, :2])
    assert (grad[at, :2] != 0).all() and not grad[at, 2:].any()
