"""The port's ring and Ulysses attention (``paddlebox_tpu_torch/parallel/
ring_attention.py``) against the JAX package's under ``shard_map`` on the
first 4 of the 8 CPU devices and against the single-device oracle: one
module-scoped gang of 4 gloo CPU ranks (``tests/torch_parallel_worker.py``)
runs every case on its own sequence block (``convert.sequence_block``).
Outputs rtol 2e-4 / atol 2e-5, grads 5e-4 / 5e-5 (the reference's
``tests/test_ring_attention.py`` cases, and the Ulysses grads)."""

from types import SimpleNamespace

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import Mesh

from paddlebox_tpu.parallel.ring_attention import (
    make_context_parallel_attention, reference_attention)

from paddlebox_tpu_torch.parallel.ring_attention import (
    _flash_block, reference_attention as port_reference, ulysses_attention)

from torch_parallel_worker import Gang

N = 4


def _qkv(b=2, t=64, h=4, d=16, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=(b, t, h, d)).astype(np.float32)
                 for _ in range(3))


def _case(kind, causal, grad=False, **shape):
    q, k, v = _qkv(**shape)
    return {"kind": kind, "causal": causal, "grad": grad, "q": q, "k": k,
            "v": v}


def _cases():
    cases = {}
    for kind in ("ring", "ulysses"):
        for causal in (False, True):
            # ulysses reshards heads across the axis → needs H % N == 0
            cases[f"{kind}_{causal}"] = _case(
                kind, causal, h=8 if kind == "ulysses" else 4)
    cases["ring_grad"] = _case("ring", True, True, t=32, h=2, d=8, seed=1)
    cases["ulysses_grad"] = _case("ulysses", True, True, t=32, h=4, d=8,
                                  seed=4)
    # T_global larger than any block; a head count no axis divides
    cases["ring_long"] = _case("ring", False, b=1, t=128, h=3, d=8, seed=2)
    return cases


@pytest.fixture(scope="module", autouse=True)
def gang(tmp_path_factory):
    """The file's gang, started with its first test."""
    return Gang("ring", _cases(), tmp_path_factory.mktemp("ring"))


@pytest.fixture(scope="module")
def mesh():
    return Mesh(np.array(jax.devices()[:N]), ("sp",))


def _blocks(name, ranks):
    return np.concatenate([r[name] for r in ranks], axis=1)


@pytest.mark.parametrize("name", ["ring_False", "ring_True",
                                  "ulysses_False", "ulysses_True",
                                  "ring_long"])
def test_matches_jax_and_reference(gang, mesh, name):
    cases = gang.cfg
    c = cases[name]
    q, k, v = (jnp.asarray(c[a]) for a in "qkv")
    want = np.asarray(reference_attention(q, k, v, causal=c["causal"]))
    attn = make_context_parallel_attention(mesh, "sp", kind=c["kind"],
                                           causal=c["causal"])
    jgot = np.asarray(attn(q, k, v))
    got = _blocks(f"{name}_out", gang.ranks())
    np.testing.assert_allclose(got, jgot, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)
    # the port's own oracle agrees with the reference's
    mine = port_reference(*(torch.from_numpy(c[a]) for a in "qkv"),
                          causal=c["causal"]).numpy()
    np.testing.assert_allclose(mine, want, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("name", ["ring_grad", "ulysses_grad"])
def test_grads_match_jax_and_reference(gang, mesh, name):
    """The backward through the ring's permutations (one packed K/V
    tensor a hop) and Ulysses' all-to-alls: the gradient of sum(out^2)
    against ``jax.grad`` of the JAX function and of the oracle."""
    cases = gang.cfg
    c = cases[name]
    q, k, v = (jnp.asarray(c[a]) for a in "qkv")
    attn = make_context_parallel_attention(mesh, "sp", kind=c["kind"],
                                           causal=True)
    gp = jax.jit(jax.grad(lambda q, k, v: (attn(q, k, v) ** 2).sum(),
                          argnums=(0, 1, 2)))(q, k, v)
    gr = jax.jit(jax.grad(lambda q, k, v: (reference_attention(
        q, k, v, causal=True) ** 2).sum(), argnums=(0, 1, 2)))(q, k, v)
    for a, jp, jr in zip("qkv", gp, gr):
        got = _blocks(f"{name}_d{a}", gang.ranks())
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, np.asarray(jp), rtol=5e-4, atol=5e-5)
        np.testing.assert_allclose(got, np.asarray(jr), rtol=5e-4, atol=5e-5)


def test_ulysses_needs_heads_divisible_by_the_axis():
    q = torch.zeros(1, 4, 3, 8)
    with pytest.raises(ValueError, match="divisible"):
        ulysses_attention(q, q, q, SimpleNamespace(size=N, rank=0))


def test_causal_flash_block_backward_is_finite():
    """A fully masked row (every key after the query) keeps NaN out of the
    backward through ``_flash_block``'s guards, as in the reference."""
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.normal(size=(1, 4, 2, 8)).astype(
        np.float32)).requires_grad_(True) for _ in range(3))
    mask = torch.zeros(4, 4, dtype=torch.bool)       # nothing to attend
    o = torch.zeros_like(q)
    m = torch.full((1, 2, 4), -float("inf"))
    l = torch.zeros(1, 2, 4)
    o, m, l = _flash_block(q, k, v, 0.5, mask, o, m, l)
    o, m, l = _flash_block(q, k, v, 0.5, torch.ones(4, 4, dtype=torch.bool),
                           o, m, l)
    (o / l.transpose(1, 2)[..., None]).sum().backward()
    for t in (q, k, v):
        assert torch.isfinite(t.grad).all()
