"""The port's extended CTR ops (``fused_seq_tensor``, ``scaled_fc``,
``scaled_int8fc``, ``shuffle_batch``, ``partial_concat``,
``partial_sum``) against the JAX package's, on the CPU, the cases of
``tests/test_extended_ops.py`` that these ops take.

Inputs come from numpy seeds. Tolerances: reshapes, slices, permutations
and integer-accumulated int8 products exact; float32 elementwise forms
rtol 1e-6; the bf16-operand GEMM with float32 accumulation rtol 1e-5 /
atol 1e-5 against the reference (the same rounded operands, sums in
another order) and the reference's own gate against float32 math.
``shuffle_batch`` draws a jax permutation in the reference; both sides
get that permutation.
"""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

# the reference package re-exports functions named like their modules
jpart = importlib.import_module("paddlebox_tpu.ops.partial_ops")
jsfc = importlib.import_module("paddlebox_tpu.ops.scaled_fc")
jseq = importlib.import_module("paddlebox_tpu.ops.seq_tensor")
jshuf = importlib.import_module("paddlebox_tpu.ops.shuffle_batch")

from paddlebox_tpu_torch import ops


@pytest.mark.parametrize("shape", [(3, 2, 4, 5, 6, 2, 1, 2, 2),
                                   (2, 1, 3, 4, 3, 1, 0, 1, 2)])
def test_fused_seq_tensor_matches_reference(shape):
    ins, bc, slot_num, L, d, ad_s, ad_off, side_s, side_off = shape
    rng = np.random.default_rng(sum(shape))
    x = rng.normal(size=(ins, bc * slot_num * L * d)).astype(np.float32)
    # an empty position: its mask must be 0
    x.reshape(ins, bc, slot_num, L, d)[0, 0, :, 1] = 0.0
    ad = rng.normal(size=(ins, bc * ad_s * d)).astype(np.float32)
    args = (bc, L, slot_num, d, ad_s, ad_off, side_s, side_off)
    want = jseq.fused_seq_tensor(jnp.asarray(x), jnp.asarray(ad), *args)
    got = ops.fused_seq_tensor(torch.from_numpy(x), torch.from_numpy(ad),
                               *args)
    for g, w, name in zip(got, want, ("din", "mask", "side", "ad")):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=0, err_msg=name)
    assert float(got[1][0, 0, 1]) == 0.0


@pytest.mark.parametrize("scales", [(1.0, 1.0), (8.0, 8.0), (4.0, 0.5)])
def test_scaled_fc_matches_reference(scales):
    rng = np.random.default_rng(4)
    x = rng.normal(size=(8, 16)).astype(np.float32)
    w = rng.normal(size=(16, 8)).astype(np.float32)
    b = rng.normal(size=(8,)).astype(np.float32)
    want = np.asarray(jsfc.scaled_fc(jnp.asarray(x), jnp.asarray(w),
                                     jnp.asarray(b), *scales))
    got = ops.scaled_fc(torch.from_numpy(x), torch.from_numpy(w),
                        torch.from_numpy(b), *scales).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    if scales[0] == scales[1]:
        # the reference's gate: bf16 operands against float32 math
        np.testing.assert_allclose(got, x @ w + b[None, :], rtol=0.05,
                                   atol=0.05)


def test_scaled_int8fc_matches_reference():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(8, 16)).astype(np.float32)
    w = rng.normal(size=(16, 8)).astype(np.float32)
    b = rng.normal(size=(8,)).astype(np.float32)
    # a value on a .5 boundary rounds half to even on both sides
    x[0, 0] = 2.5 / 16.0
    want = np.asarray(jsfc.scaled_int8fc(jnp.asarray(x), jnp.asarray(w),
                                         jnp.asarray(b), 16.0, 16.0))
    got = ops.scaled_int8fc(torch.from_numpy(x), torch.from_numpy(w),
                            torch.from_numpy(b), 16.0, 16.0).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got, x @ w + b[None, :], rtol=0.2, atol=0.5)


def test_shuffle_roundtrip_and_grad():
    """The reference's permutation on both sides: the same rows, the
    inverse restores the order, and the grad lands on the source rows."""
    x = np.arange(12.0, dtype=np.float32).reshape(6, 2)
    jy, jidx = jshuf.shuffle_batch(jnp.asarray(x), jax.random.PRNGKey(0))
    perm = torch.from_numpy(np.asarray(jidx).astype(np.int64))
    xt = torch.from_numpy(x).requires_grad_(True)
    y, idx = ops.shuffle_batch(xt, perm=perm)
    np.testing.assert_array_equal(y.detach().numpy(), np.asarray(jy))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(
        ops.unshuffle_batch(y.detach(), idx).numpy(), x)
    np.testing.assert_array_equal(
        ops.unshuffle_batch(y.detach(), idx).numpy(),
        np.asarray(jshuf.unshuffle_batch(jy, jidx)))
    w = np.arange(6.0, dtype=np.float32)[:, None]

    def loss(v):
        return jnp.sum(jshuf.shuffle_batch(v, jax.random.PRNGKey(0))[0] * w)

    (y * torch.from_numpy(w)).sum().backward()
    np.testing.assert_array_equal(xt.grad.numpy(),
                                  np.asarray(jax.grad(loss)(jnp.asarray(x))))
    # a generator draws a permutation of its own
    g = torch.Generator().manual_seed(3)
    y2, idx2 = ops.shuffle_batch(torch.from_numpy(x), generator=g)
    assert sorted(idx2.tolist()) == list(range(6))
    np.testing.assert_array_equal(y2.numpy(), x[idx2.numpy()])


@pytest.mark.parametrize("start,length", [(1, 2), (-2, -1), (0, -1), (2, 9)])
def test_partial_ops_match_reference(start, length):
    a = np.arange(12.0, dtype=np.float32).reshape(3, 4)
    b = a * 10
    xs = [torch.from_numpy(a), torch.from_numpy(b)]
    jxs = [jnp.asarray(a), jnp.asarray(b)]
    np.testing.assert_array_equal(
        ops.partial_concat(xs, start, length).numpy(),
        np.asarray(jpart.partial_concat(jxs, start, length)))
    np.testing.assert_array_equal(
        ops.partial_sum(xs, start, length).numpy(),
        np.asarray(jpart.partial_sum(jxs, start, length)))
