"""The port's MoE (``paddlebox_tpu_torch/parallel/moe.py``) against the
JAX package's: the gates on the same logits (dispatch exact, combine and
aux rtol 1e-6), the reference's cases of ``tests/test_moe.py`` on the
port, and the expert-parallel forward on one module-scoped gang of 4 gloo
CPU ranks (``tests/torch_parallel_worker.py``) against the JAX function
under ``shard_map`` on the first 4 of the 8 CPU devices and against the
port's local form, rtol 1e-4 / atol 1e-5."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import Mesh

from paddlebox_tpu.parallel import moe as jmoe

from paddlebox_tpu_torch.parallel.moe import (GATES, moe_forward_local,
                                              naive_gating, top1_gating,
                                              top2_gating)

from torch_parallel_worker import Gang

N = 4


def expert_identity_scale(x, scale):
    return x * scale


def _jax_ffn(x, p):
    w1, w2 = p
    return jax.nn.relu(x @ w1) @ w2


@pytest.mark.parametrize("gate", sorted(GATES))
@pytest.mark.parametrize("capacity", [3, 16])
def test_gates_match_jax(gate, capacity):
    rng = np.random.default_rng(7)
    logits = rng.normal(size=(32, 6)).astype(np.float32)
    jd, jc, ja, jm = jmoe.GATES[gate](jnp.asarray(logits), capacity)
    d, c, a, m = GATES[gate](torch.from_numpy(logits), capacity)
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(float(a), float(ja), rtol=1e-6)
    assert float(m["dropped"]) == float(jm["dropped"])
    np.testing.assert_array_equal(m["load"].numpy(), np.asarray(jm["load"]))


def test_argmax_ties_take_the_first_maximum():
    """Equal logits route to the first expert in both packages."""
    logits = np.zeros((4, 3), np.float32)
    d, _, _, _ = top1_gating(torch.from_numpy(logits), capacity=4)
    jd, _, _, _ = jmoe.top1_gating(jnp.asarray(logits), capacity=4)
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    assert d[:, 0].sum() == 4


def test_top1_gating_routes_and_caps():
    # 4 tokens all preferring expert 1, capacity 2 → 2 dropped
    logits = torch.tensor([[0.0, 5.0]] * 4)
    disp, comb, aux, metrics = top1_gating(logits, capacity=2)
    assert disp.shape == (4, 2, 2)
    assert float(metrics["dropped"]) == 2.0
    kept = disp[:, 1, :].sum(dim=0).numpy()
    np.testing.assert_array_equal(kept, [1.0, 1.0])
    assert float(aux) > 0


def test_top2_gating_weights_sum_to_one():
    rng = np.random.default_rng(0)
    logits = torch.from_numpy(rng.normal(size=(16, 4)).astype(np.float32))
    disp, comb, aux, _ = top2_gating(logits, capacity=16)
    np.testing.assert_allclose(comb.sum(dim=(1, 2)).numpy(), 1.0, rtol=1e-5)


def test_naive_gate_no_drops_no_aux():
    rng = np.random.default_rng(1)
    logits = torch.from_numpy(rng.normal(size=(8, 4)).astype(np.float32))
    disp, comb, aux, metrics = naive_gating(logits)
    assert float(aux) == 0.0
    assert float(metrics["dropped"]) == 0.0


def test_moe_local_identity_experts_reconstruct_and_match_jax():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(8, 6)).astype(np.float32)
    gate_w = rng.normal(size=(6, 4)).astype(np.float32)
    y, aux = moe_forward_local(torch.from_numpy(x), torch.from_numpy(gate_w),
                               expert_identity_scale, torch.ones(4),
                               capacity=8, gate="gshard")
    np.testing.assert_allclose(y.numpy(), x, rtol=1e-5)
    jy, jaux = jmoe.moe_forward_local(
        jnp.asarray(x), jnp.asarray(gate_w), expert_identity_scale,
        jnp.ones((4,)), capacity=8, gate="gshard")
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)


def _cases():
    rng = np.random.default_rng(3)
    f32 = lambda *s: rng.normal(size=s).astype(np.float32)
    E, D, T = 8, 6, 16
    # the reference's case: drop-free capacities, identity-scale experts
    cases = {"scale": {"expert": "scale", "gate": "switch",
                       "capacity": T // N, "x": f32(T, D),
                       "gate_w": f32(D, E),
                       "params": np.arange(1.0, E + 1.0, dtype=np.float32)}}
    # FFN experts (2 a rank) under capacity pressure, both capacity gates
    for gate in ("switch", "gshard"):
        cases[f"ffn_{gate}"] = {
            "expert": "ffn", "gate": gate, "capacity": 2, "x": f32(32, D),
            "gate_w": f32(D, E),
            "params": (f32(E, D, 12) * 0.5, f32(E, 12, D) * 0.5)}
    return cases


@pytest.fixture(scope="module", autouse=True)
def gang(tmp_path_factory):
    """The file's gang, started with its first test."""
    return Gang("moe", _cases(), tmp_path_factory.mktemp("moe"))


def _jax_sharded(c):
    mesh = Mesh(np.array(jax.devices()[:N]), ("ep",))
    fn = expert_identity_scale if c["expert"] == "scale" else _jax_ffn
    params = (jnp.asarray(c["params"]) if c["expert"] == "scale" else
              tuple(jnp.asarray(p) for p in c["params"]))
    fwd = jmoe.moe_forward_sharded(mesh, "ep", fn, capacity=c["capacity"],
                                   gate=c["gate"])
    with mesh:
        y, aux = jax.jit(fwd)(jnp.asarray(c["x"]), jnp.asarray(c["gate_w"]),
                              params)
    return np.asarray(y), float(aux)


@pytest.mark.parametrize("name", ["scale", "ffn_switch", "ffn_gshard"])
def test_moe_sharded_matches_jax_and_local(gang, name):
    cases = gang.cfg
    c = cases[name]
    want_y, want_aux = _jax_sharded(c)
    per = c["x"].shape[0] // N
    for rank, r in enumerate(gang.ranks()):
        np.testing.assert_allclose(r[f"{name}_y"],
                                   want_y[rank * per:(rank + 1) * per],
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(float(r[f"{name}_aux"]), want_aux,
                                   rtol=1e-4, atol=1e-5)
        # the local form on the rank's tokens routes them alike
        np.testing.assert_allclose(r[f"{name}_y"], r[f"{name}_local_y"],
                                   rtol=1e-4, atol=1e-5)
    # the aux loss is the mean of the ranks' local ones
    local_aux = [float(r[f"{name}_local_aux"]) for r in gang.ranks()]
    np.testing.assert_allclose(want_aux, np.mean(local_aux), rtol=1e-4,
                               atol=1e-5)
    if name == "scale":
        # drop-free: the sharded forward equals all tokens through the
        # local form at capacity T
        y, _ = moe_forward_local(
            torch.from_numpy(c["x"]), torch.from_numpy(c["gate_w"]),
            expert_identity_scale, torch.from_numpy(c["params"]),
            capacity=c["x"].shape[0], gate="switch")
        np.testing.assert_allclose(np.concatenate([r["scale_y"]
                                                   for r in gang.ranks()]),
                                   y.numpy(), rtol=1e-4, atol=1e-5)
