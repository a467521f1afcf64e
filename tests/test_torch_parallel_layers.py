"""The port's TP/PP layers and mesh (``paddlebox_tpu_torch/parallel/
layers.py``, ``mesh.py``, ``collectives.py``) against the JAX functions
under ``shard_map`` on the first 4 of the 8 CPU devices: one module-scoped
gang of 4 gloo CPU ranks (``tests/torch_parallel_worker.py``) runs every
case on its own blocks (cut by the ``convert`` helpers). The reference's
cases of ``tests/test_parallel_layers.py``, plus a gradient-scale case
that a ``psum`` whose backward all-reduces would fail by the world size.

Tolerances: the embedding exact; the MLP, the pipeline forward and 5
pipeline SGD steps (losses and weights) rtol 1e-4 / atol 1e-5; the
hierarchical all-reduce against a flat sum 1e-5."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, PartitionSpec as P

from paddlebox_tpu.parallel.layers import (column_parallel_linear,
                                           pipeline_run, pipeline_train_step,
                                           row_parallel_linear,
                                           vocab_parallel_embedding)
from paddlebox_tpu.parallel.mesh import (DCN_AXIS, ICI_AXIS,
                                         hierarchical_allreduce,
                                         make_hierarchical_mesh)

from torch_parallel_worker import Gang

N = 4
STEPS, LR = 5, 0.2


def _smap(f, mesh, in_specs, out_specs, check_vma=True):
    return jax.jit(jax.shard_map(f, mesh=mesh, in_specs=in_specs,
                                 out_specs=out_specs, check_vma=check_vma))


def _cfg():
    rng = np.random.default_rng(0)
    f32 = lambda *s: rng.normal(size=s).astype(np.float32)
    cfg = {"emb": {"w": f32(64, 16),
                   "ids": rng.integers(0, 64, size=(4, 7)).astype(np.int32)},
           "mlp": {"x": f32(8, 12), "w1": f32(12, 32), "b1": f32(32),
                   "w2": f32(32, 6), "b2": f32(6)},
           "gather": {"x": f32(4, 10), "w": f32(10, 24)},
           "pipe": {"x": f32(6, 5, 8), "ws": f32(N, 8, 8) * 0.5},
           "pipe_train": {"x": f32(4, 6, 8), "y": f32(4, 6, 8),
                          "ws": f32(N, 8, 8) * 0.3, "steps": STEPS,
                          "lr": LR},
           "grad_scale": {"w": f32(N * 3, 5)},
           # an odd length exercises the pad path (37 % 2 != 0)
           "hier": {"x": f32(N, 37), "slices": 2}}
    return cfg


@pytest.fixture(scope="module", autouse=True)
def gang(tmp_path_factory):
    """The file's gang, started with its first test."""
    return Gang("layers", _cfg(), tmp_path_factory.mktemp("layers"))


@pytest.fixture(scope="module")
def mesh():
    return Mesh(np.array(jax.devices()[:N]), ("mp",))


def test_vocab_parallel_embedding(gang, mesh):
    cfg = gang.cfg
    c = cfg["emb"]
    f = _smap(functools.partial(vocab_parallel_embedding, axis="mp"), mesh,
              (P(), P("mp", None)), P())
    want = np.asarray(f(jnp.asarray(c["ids"]), jnp.asarray(c["w"])))
    np.testing.assert_array_equal(want, c["w"][c["ids"]])
    for r in gang.ranks():
        np.testing.assert_array_equal(r["emb"], want)


def test_column_then_row_parallel_mlp(gang, mesh):
    cfg = gang.cfg
    c = cfg["mlp"]

    def block(x, w1, b1, w2, b2):
        h = column_parallel_linear(x, w1, b1, gather_output=False)
        return row_parallel_linear(jax.nn.relu(h), w2, b2)

    f = _smap(block, mesh, (P(), P(None, "mp"), P("mp"), P("mp", None), P()),
              P())
    want = np.asarray(f(*(jnp.asarray(c[k])
                          for k in ("x", "w1", "b1", "w2", "b2"))))
    for r in gang.ranks():
        np.testing.assert_allclose(r["mlp"], want, rtol=1e-4, atol=1e-5)


def test_column_parallel_gather_output(gang, mesh):
    cfg = gang.cfg
    c = cfg["gather"]
    f = _smap(functools.partial(column_parallel_linear, gather_output=True),
              mesh, (P(), P(None, "mp")), P(), check_vma=False)
    want = np.asarray(f(jnp.asarray(c["x"]), jnp.asarray(c["w"])))
    for r in gang.ranks():
        np.testing.assert_allclose(r["gather"], want, rtol=1e-4, atol=1e-5)


def _stage(w, a):
    return jnp.tanh(a @ w)


def test_pipeline_matches_jax_and_sequential(gang):
    cfg = gang.cfg
    c = cfg["pipe"]
    mesh = Mesh(np.array(jax.devices()[:N]), ("pp",))

    def run(x_micros, ws_sharded):
        out = pipeline_run(_stage, ws_sharded[0], x_micros, axis="pp")
        return jax.lax.psum(out, "pp")

    want = np.asarray(_smap(run, mesh, (P(), P("pp", None, None)), P())(
        jnp.asarray(c["x"]), jnp.asarray(c["ws"])))
    seq = c["x"]
    for i in range(N):
        seq = np.tanh(seq @ c["ws"][i])
    for r in gang.ranks():
        np.testing.assert_allclose(r["pipe"], want, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(r["pipe"], seq, rtol=1e-4, atol=1e-5)


def test_pipeline_training_matches_jax(gang):
    """5 SGD steps through ``pipeline_train_step``: every step's loss and
    each rank's stage weights against the JAX pipeline on 4 devices (and
    the loss against sequential training of the stacked model)."""
    cfg = gang.cfg
    c = cfg["pipe_train"]
    mesh = Mesh(np.array(jax.devices()[:N]), ("pp",))

    def loss_fn(out, y):
        return jnp.mean((out - y) ** 2)

    def body(w_local, x, y):
        loss, g = pipeline_train_step(_stage, loss_fn, w_local[0], x, y,
                                      axis="pp")
        return loss, (w_local[0] - LR * g)[None]

    step = _smap(body, mesh, (P("pp", None, None), P(), P()),
                 (P(), P("pp", None, None)))
    ws = jnp.asarray(c["ws"])
    losses = []
    for _ in range(STEPS):
        loss, ws = step(ws, jnp.asarray(c["x"]), jnp.asarray(c["y"]))
        losses.append(float(loss))

    def seq_loss(ws, xx, yy):
        a = xx
        for i in range(N):
            a = jnp.tanh(a @ ws[i])
        return jnp.mean((a - yy) ** 2)

    ws_seq = jnp.asarray(c["ws"])
    seq = []
    xx, yy = (jnp.asarray(c[k].reshape(-1, 8)) for k in ("x", "y"))
    for _ in range(STEPS):
        ls, gs = jax.value_and_grad(seq_loss)(ws_seq, xx, yy)
        ws_seq = ws_seq - LR * gs
        seq.append(float(ls))
    ws = np.asarray(ws)
    for rank, r in enumerate(gang.ranks()):
        np.testing.assert_allclose(r["pipe_losses"], losses, rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(r["pipe_losses"], seq, rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(r["pipe_w"], ws[rank], rtol=1e-4,
                                   atol=1e-5)
    assert losses[-1] < losses[0] * 0.98      # it actually learns


def test_psum_gradient_is_not_scaled_by_the_world(gang, mesh):
    """``jax.grad`` of the psum of sum(w^2) over a row-sharded w is 2w on
    each shard; the port's psum backward (the identity) gives the same,
    where ``torch.distributed.nn``'s all-reduce would give 4 * 2w."""
    cfg = gang.cfg
    w = cfg["grad_scale"]["w"]

    def loss(w):
        return _smap(lambda wl: jax.lax.psum(jnp.sum(wl ** 2), "mp"), mesh,
                     (P("mp", None),), P())(w)

    want = np.asarray(jax.grad(loss)(jnp.asarray(w)))
    np.testing.assert_allclose(want, 2 * w, rtol=1e-6)
    per = w.shape[0] // N
    for rank, r in enumerate(gang.ranks()):
        np.testing.assert_allclose(r["grad_scale"],
                                   want[rank * per:(rank + 1) * per],
                                   rtol=1e-6)


def test_hierarchical_allreduce_matches_flat_psum(gang):
    """2 x 2 [dcn, ici]: reduce-scatter over ICI, DCN sum, all-gather over
    ICI equals a flat sum over all 4 ranks, and the JAX ladder."""
    cfg = gang.cfg
    x = cfg["hier"]["x"]
    mesh = make_hierarchical_mesh(n_slices=2, devices=jax.devices()[:N])
    assert mesh.shape == {DCN_AXIS: 2, ICI_AXIS: 2}

    def block(v):
        return hierarchical_allreduce(v.reshape(37))[None]

    want = np.asarray(_smap(block, mesh, P((DCN_AXIS, ICI_AXIS)),
                            P((DCN_AXIS, ICI_AXIS)), check_vma=False)(
                                jnp.asarray(x)))
    for rank, r in enumerate(gang.ranks()):
        # rank r sits at slice r // 2, position r % 2
        np.testing.assert_array_equal(r["hier_axes"],
                                      [rank // 2, 2, rank % 2, 2])
        np.testing.assert_allclose(r["hier"], r["hier_flat"], rtol=1e-5)
        np.testing.assert_allclose(r["hier"], x.sum(axis=0), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(r["hier"], want[rank], rtol=1e-5,
                                   atol=1e-6)
