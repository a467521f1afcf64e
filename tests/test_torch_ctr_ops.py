"""The port's CTR op family (rank_attention, batch_fc, cross_norm_hadamard,
data_norm) against the JAX package, on the CPU.

The port runs its plain kernel versions (CPU tensors) inside its autograd
Functions; the JAX side runs its XLA compositions and, with the flags of
``JAX_FLAGS["pallas"]``, its Pallas kernels in interpret mode. Inputs come
from numpy seeds and cross as numpy.

Tolerances are those of tests/test_pallas_ctr.py: rank_attention forward
rtol 1e-5 / atol 1e-6 (another summation order), its grads the same class
here (the same einsums in another framework), rank_attention2's param
grads rtol 1e-4 / atol 1e-6; batch_fc forward and grads rtol 1e-6 /
atol 1e-6; cross_norm forward exact but for the dot column (rtol 1e-5 /
atol 1e-6: the dot sums in another order), dx rtol 1e-4 / atol 1e-6 and
the summary grads rtol 1e-4 / atol 1e-5.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from paddlebox_tpu.config import flags_scope
from paddlebox_tpu.ops import batch_fc as j_batch_fc
from paddlebox_tpu.ops import cross_norm_hadamard as j_cross_norm
from paddlebox_tpu.ops import cross_norm_update as j_cross_norm_update
from paddlebox_tpu.ops import data_norm as j_data_norm
from paddlebox_tpu.ops import data_norm_update as j_data_norm_update
from paddlebox_tpu.ops import init_cross_norm_summary as j_init_summary
from paddlebox_tpu.ops import init_data_norm_summary as j_init_dn
from paddlebox_tpu.ops import rank_attention as j_rank_attention
from paddlebox_tpu.ops import rank_attention2 as j_rank_attention2
from paddlebox_tpu.ops.pallas_ctr import \
    decode_rank_offset as j_decode_rank_offset

from paddlebox_tpu_torch.ops import ctr_kernels as tc
from paddlebox_tpu_torch.ops.batch_fc import batch_fc
from paddlebox_tpu_torch.ops.cross_norm import (cross_norm_hadamard,
                                                cross_norm_update,
                                                init_cross_norm_summary)
from paddlebox_tpu_torch.ops.data_norm import (DataNormSummary, data_norm,
                                               data_norm_update,
                                               init_data_norm_summary)
from paddlebox_tpu_torch.ops.rank_attention import (rank_attention,
                                                    rank_attention2)

MR = 3
JAX_FLAGS = {
    "xla": dict(use_pallas_rank_attention=False, use_pallas_batch_fc=False,
                use_pallas_cross_norm=False),
    "pallas": dict(use_pallas_rank_attention=True, use_pallas_batch_fc=True,
                   use_pallas_cross_norm=True)}
FLAGS = sorted(JAX_FLAGS)


def _t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


def _rank_case(n=37, d=12, p=7, seed=0, all_invalid=False, wild=False):
    """The validity matrix of tests/test_pallas_ctr.py: invalid own ranks
    (col 0 = 0), missing co-shown entries (rank 0), optionally every row
    invalid; ``wild`` adds ranks past max_rank, negative ranks and row
    indices outside [0, N)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    param = rng.normal(size=(MR * MR, d, p)).astype(np.float32)
    ro = np.zeros((n, 1 + 2 * MR), np.int32)
    if not all_invalid:
        own_lo, rank_lo, hi = (-2, -2, MR + 3) if wild else (0, 1, MR + 1)
        ro[:, 0] = rng.integers(own_lo, hi, size=n)
        for k in range(MR):
            on = rng.random(n) < 0.7
            ro[:, 1 + 2 * k] = np.where(
                on, rng.integers(rank_lo, hi, size=n), 0)
            ro[:, 2 + 2 * k] = (rng.integers(-3, n + 3, size=n) if wild
                                else rng.integers(0, n, size=n))
    return x, ro, param


@pytest.mark.parametrize("wild", [False, True])
def test_decode_rank_offset_matches_reference(wild):
    x, ro, _ = _rank_case(seed=11, wild=wild)
    n = x.shape[0]
    jb, ji, jv = (np.asarray(a) for a in j_decode_rank_offset(
        jnp.asarray(ro), MR, n))
    tb, ti, tv = tc.decode_rank_offset(torch.from_numpy(ro), MR, n)
    np.testing.assert_array_equal(tb.numpy(), jb)
    np.testing.assert_array_equal(ti.numpy(), ji)
    np.testing.assert_array_equal(tv.numpy(), jv)


@pytest.mark.parametrize("case", ["mixed", "all_invalid", "wild"])
def test_rank_buckets_plain_matches_numpy(case):
    """rank_buckets_plain (the CUDA bucket pass's plain version) is a
    numpy stable sort of the rows by clipped own rank, own < 0 last."""
    _, ro, _ = _rank_case(n=301, seed=5, all_invalid=case == "all_invalid",
                          wild=case == "wild")
    own = ro[:, 0].astype(np.int64) - 1
    bucket = np.where(own < 0, MR, np.minimum(own, MR - 1))
    want_perm = np.argsort(bucket, kind="stable")
    want_bounds = np.concatenate(
        [[0], np.cumsum(np.bincount(bucket, minlength=MR + 1))])
    perm, bounds = tc.rank_buckets_plain(torch.from_numpy(ro), MR)
    assert perm.dtype == bounds.dtype == torch.int32
    np.testing.assert_array_equal(perm.numpy(), want_perm)
    np.testing.assert_array_equal(bounds.numpy(), want_bounds)


@pytest.mark.parametrize("flags", FLAGS)
@pytest.mark.parametrize("param_2d", [False, True])
@pytest.mark.parametrize("case", ["mixed", "all_invalid", "wild"])
def test_rank_attention_forward_matches_reference(flags, param_2d, case):
    x, ro, param = _rank_case(all_invalid=case == "all_invalid",
                              wild=case == "wild")
    if param_2d:
        param = param.reshape(MR * MR * x.shape[1], -1)
    with flags_scope(**JAX_FLAGS[flags]):
        ref = np.asarray(j_rank_attention(jnp.asarray(x), jnp.asarray(ro),
                                          jnp.asarray(param), MR))
    got = rank_attention(_t(x), _t(ro), _t(param), MR).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    if case == "all_invalid":
        np.testing.assert_array_equal(got, 0.0)


@pytest.mark.parametrize("flags", FLAGS)
@pytest.mark.parametrize("param_2d", [False, True])
@pytest.mark.parametrize("enable_input_bp", [False, True])
def test_rank_attention_grads_match_reference(flags, param_2d,
                                              enable_input_bp):
    x, ro, param = _rank_case(seed=3)
    if param_2d:
        param = param.reshape(MR * MR * x.shape[1], -1)
    w = np.random.default_rng(4).normal(size=(x.shape[0], 7)).astype(
        np.float32)

    def f(xx, pp):
        return jnp.sum(j_rank_attention(xx, jnp.asarray(ro), pp, MR,
                                        enable_input_bp=enable_input_bp)
                       * jnp.asarray(w))
    with flags_scope(**JAX_FLAGS[flags]):
        jgx, jgp = (np.asarray(g) for g in jax.grad(f, argnums=(0, 1))(
            jnp.asarray(x), jnp.asarray(param)))

    tx, tp = _t(x, True), _t(param, True)
    (rank_attention(tx, _t(ro), tp, MR, enable_input_bp=enable_input_bp)
     * _t(w)).sum().backward()
    assert tuple(tp.grad.shape) == param.shape
    np.testing.assert_allclose(tp.grad.numpy(), jgp, rtol=1e-5, atol=1e-6)
    if enable_input_bp:
        np.testing.assert_allclose(tx.grad.numpy(), jgx, rtol=1e-5,
                                   atol=1e-6)
        assert np.abs(tx.grad.numpy()).max() > 0
    else:
        # no dX flows: the reference's is exactly zero
        assert tx.grad is None
        np.testing.assert_array_equal(jgx, 0.0)


@pytest.mark.parametrize("flags", FLAGS)
def test_rank_attention2_param_grads_only(flags):
    x, ro, param = _rank_case(seed=5)

    def f(xx, pp):
        return jnp.sum(j_rank_attention2(xx, jnp.asarray(ro), pp, MR) ** 2)
    with flags_scope(**JAX_FLAGS[flags]):
        jgx, jgp = (np.asarray(g) for g in jax.grad(f, argnums=(0, 1))(
            jnp.asarray(x), jnp.asarray(param)))
    tx, tp = _t(x, True), _t(param, True)
    (rank_attention2(tx, _t(ro), tp, MR) ** 2).sum().backward()
    assert tx.grad is None
    np.testing.assert_array_equal(jgx, 0.0)
    np.testing.assert_allclose(tp.grad.numpy(), jgp, rtol=1e-4, atol=1e-6)


def _fc_case(mode):
    rng = np.random.default_rng(1)
    s, n, i_dim, o_dim = 3, 5, 4, 2
    x3 = rng.normal(size=(s, n, i_dim)).astype(np.float32)
    w = rng.normal(size=(s, i_dim, o_dim)).astype(np.float32)
    b = rng.normal(size=(s, o_dim)).astype(np.float32)
    if mode == "default":
        return (x3, w, b), {}
    if mode == "batchcount":
        return (x3.reshape(s * n, i_dim), w, b), dict(batchcount=s)
    wt = np.swapaxes(w, 1, 2).copy()
    return ((x3.reshape(s * n, i_dim), wt, b),
            dict(batchcount=s, transpose_weight=True))


@pytest.mark.parametrize("flags", FLAGS)
@pytest.mark.parametrize("mode", ["default", "batchcount", "transpose"])
def test_batch_fc_matches_reference(flags, mode):
    args, kw = _fc_case(mode)
    with flags_scope(**JAX_FLAGS[flags]):
        jargs = [jnp.asarray(a) for a in args]
        ref = np.asarray(j_batch_fc(*jargs, **kw))
        jgrads = jax.grad(lambda *a: jnp.sum(j_batch_fc(*a, **kw) * 0.7),
                          argnums=(0, 1, 2))(*jargs)
    targs = [_t(a, True) for a in args]
    out = batch_fc(*targs, **kw)
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=1e-6,
                               atol=1e-6)
    (out * 0.7).sum().backward()
    for t, g in zip(targs, jgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), rtol=1e-6,
                                   atol=1e-6)


def test_batch_fc_strided_input_matches_contiguous():
    """The PV path hands batch_fc the [S, B, D] swapaxes view of the
    pooled block; the result is that of the contiguous copy."""
    rng = np.random.default_rng(9)
    pooled = torch.from_numpy(rng.normal(size=(6, 3, 5)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(3, 5, 5)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(3, 5)).astype(np.float32))
    view = pooled.transpose(0, 1)
    assert not view.is_contiguous()
    torch.testing.assert_close(batch_fc(view, w, b),
                               batch_fc(view.contiguous(), w, b),
                               rtol=0, atol=0)


@pytest.mark.parametrize("kw", [dict(transpose_weight=True),
                                dict(batchcount=0, transpose_weight=True)])
def test_batch_fc_transpose_without_batchcount_raises(kw):
    x = torch.ones((2, 4, 3))
    w = torch.ones((2, 3, 3))
    b = torch.ones((2, 3))
    with pytest.raises(ValueError, match="transpose_weight"):
        batch_fc(x, w, b, **kw)


def _summary_np(n, d, x):
    """A JAX summary folded with one batch (decay 0.5), as numpy."""
    s = j_cross_norm_update(j_init_summary(n, d), jnp.asarray(x), n, d,
                            decay=0.5)
    return [np.asarray(a) for a in s]


def _port_summary(arrays, grad=False):
    return DataNormSummary(*(_t(a, grad) for a in arrays))


@pytest.mark.parametrize("flags", FLAGS)
@pytest.mark.parametrize("n,d", [(2, 5), (1, 8)])
def test_cross_norm_matches_reference(flags, n, d):
    rng = np.random.default_rng(2)
    b = 9
    x = rng.normal(size=(b, 2 * n * d)).astype(np.float32)
    summ = _summary_np(n, d, x)
    with flags_scope(**JAX_FLAGS[flags]):
        jsumm = type(j_init_summary(n, d))(*(jnp.asarray(a) for a in summ))
        ref = np.asarray(j_cross_norm(jnp.asarray(x), jsumm, n, d))
        jdx = np.asarray(jax.grad(lambda xx: jnp.sum(
            j_cross_norm(xx, jsumm, n, d) ** 2))(jnp.asarray(x)))
        jds = jax.grad(lambda s: jnp.sum(
            j_cross_norm(jnp.asarray(x), s, n, d) ** 2))(jsumm)

    tx = _t(x, True)
    tsumm = _port_summary(summ, grad=True)
    out = cross_norm_hadamard(tx, tsumm, n, d)
    got = out.detach().numpy()
    dot = np.zeros(got.shape[1], bool)
    dot[3 * d::3 * d + 1] = True
    np.testing.assert_array_equal(got[:, ~dot], ref[:, ~dot])
    np.testing.assert_allclose(got[:, dot], ref[:, dot], rtol=1e-5,
                               atol=1e-6)
    (out ** 2).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), jdx, rtol=1e-4, atol=1e-6)
    for t, j in zip(tsumm, jds):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j), rtol=1e-4,
                                   atol=1e-5)


def test_cross_norm_update_matches_reference():
    rng = np.random.default_rng(6)
    n, d = 2, 4
    xs = [rng.normal(size=(7, 2 * n * d)).astype(np.float32)
          for _ in range(3)]
    js = j_init_summary(n, d)
    ts = init_cross_norm_summary(n, d, device="cpu")
    for x in xs:
        js = j_cross_norm_update(js, jnp.asarray(x), n, d)
        ts = cross_norm_update(ts, _t(x, True), n, d)
    for t, j in zip(ts, js):
        assert not t.requires_grad
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6,
                                   atol=1e-6)
    # the port's sync_axis is a process group (tests/test_torch_pod_reduce.py
    # runs it across two ranks); a mesh axis name is refused
    with pytest.raises(TypeError, match="process group"):
        cross_norm_update(ts, _t(xs[0]), n, d, sync_axis="data")


@pytest.mark.parametrize("slot_dim", [-1, 3])
def test_data_norm_and_update_match_reference(slot_dim):
    rng = np.random.default_rng(7)
    c = 12
    x = rng.normal(size=(10, c)).astype(np.float32)
    x[2, :3] = 0.0                              # a no-show slot block
    js = j_data_norm_update(j_init_dn(c), jnp.asarray(x), decay=0.5)
    ts = data_norm_update(init_data_norm_summary(c, device="cpu"),
                              _t(x), decay=0.5)
    for t, j in zip(ts, js):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6)
    ref = np.asarray(j_data_norm(jnp.asarray(x), js, slot_dim=slot_dim))
    got = data_norm(_t(x), ts, slot_dim=slot_dim).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)


def test_cpu_wrappers_take_the_plain_versions():
    """On CPU tensors each wrapper is its plain version and counts no
    launch."""
    x, ro, param = _rank_case(seed=8)
    before = (tc.rank_attention.launches, tc.batch_fc.launches,
              tc.cross_norm.launches)
    torch.testing.assert_close(
        tc.rank_attention(_t(x), _t(ro), _t(param), MR),
        tc.rank_attention_plain(_t(x), _t(ro), _t(param), MR), rtol=0,
        atol=0)
    args, _ = _fc_case("default")
    torch.testing.assert_close(tc.batch_fc(*map(_t, args), False),
                               tc.batch_fc_plain(*map(_t, args), False),
                               rtol=0, atol=0)
    xc = _t(np.ones((3, 8), np.float32))
    m, s = torch.zeros(13), torch.ones(13)
    torch.testing.assert_close(tc.cross_norm(xc, m, s, 1, 4),
                               tc.cross_norm_plain(xc, m, s, 1, 4), rtol=0,
                               atol=0)
    assert (tc.rank_attention.launches, tc.batch_fc.launches,
            tc.cross_norm.launches) == before


@pytest.mark.parametrize("x_addr,out_addr,b,n,d,want", [
    (0x1000, 0x2000, 4096, 1, 128, 1),   # the PV shape: the tile kernel
    (0x1000, 0x2000, 257, 3, 5, 1),      # d odd: the spans still align
    (0x1004, 0x2000, 4096, 1, 128, 2),   # x 4 bytes off 16
    (0x1008, 0x2000, 4096, 1, 128, 2),
    (0x1000, 0x200c, 4096, 1, 128, 2),   # out 12 bytes off 16
    (0x1000, 0x2000, 6, 1, 20_000, 2),   # a tile past shared memory
    (0x1000, 0x2000, 6, 1, 1_500, 2),
    (0x1000, 0x2000, 6, 1, 1_000, 1),    # 8 rows of it fit
    (0x1000, 0x2000, 0, 1, 128, 0),      # empty: nothing to launch
    (0x1004, 0x2000, 0, 1, 128, 0),
    (0x1000, 0x2000, 5, 0, 128, 0),
    (0x1000, 0x2000, 5, 1, 0, 1)])       # d 0: the dot column only
def test_cross_norm_branch(x_addr, out_addr, b, n, d, want):
    """The cross_norm kernel the wrapper picks from the addresses and
    sizes: the tile kernel where both bases sit on 16 bytes and a tile's
    input, output, mean and scale fit CROSS_NORM_SMEM, else the rows
    kernel; nothing for an empty output."""
    assert tc.cross_norm_branch(x_addr, out_addr, b, n, d) == want


def test_cross_norm_branch_smem_edge():
    """The widest d whose tile fits CROSS_NORM_SMEM takes the tile kernel,
    the next does not."""
    r = tc.CROSS_NORM_ROWS
    # 4 · (R · (2d + 3d + 1) + 2 · (3d + 1)) bytes at n = 1
    d = next(d for d in range(1, 20_000)
             if 4 * (r * (5 * d + 1) + 2 * (3 * d + 1))
             > tc.CROSS_NORM_SMEM) - 1
    assert tc.cross_norm_branch(0, 0, 9, 1, d) == 1
    assert tc.cross_norm_branch(0, 0, 9, 1, d + 1) == 2
