"""The port's graph store and samplers (``paddlebox_tpu_torch/graph.py``)
against the JAX package's ``graph.py`` on the CPU.

Every sampler's core takes its draws, so each case hands the port's core
the reference's own draws (drawn by the test exactly as the JAX function
draws them from its key) and holds the two packages equal exactly:
uniform, weighted and without-replacement samples, walks, metapath walks,
BFS levels and edges, and the sharded sampler on one module-scoped gang of
4 gloo CPU ranks (``tests/torch_parallel_worker.py``) against the JAX
sampler under ``shard_map`` on the first 4 of the 8 CPU devices. The
reference's own cases of ``tests/test_graph.py`` then run on the port's
own draws (a CPU ``torch.Generator``), ``test_gnn_trains_from_service``
with ``torch.optim.Adam``."""

import time

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import Mesh

from paddlebox_tpu import graph as jg

from paddlebox_tpu_torch import graph as tg
from paddlebox_tpu_torch.graph import (BfsSampler, GraphDataGenerator,
                                       GraphSamplerService, GraphStore,
                                       HeteroGraphStore,
                                       make_generator)

from torch_parallel_worker import Gang

N = 4


def gen(seed=0):
    return make_generator(seed, "cpu")


def _t(a):
    return torch.from_numpy(np.array(a))


def star_graph(pkg=tg):
    # 0 -> {1,2,3}; 1 -> {0}; 2 -> {0}; 3 -> {0}; 4 isolated
    src = np.array([0, 0, 0, 1, 2, 3])
    dst = np.array([1, 2, 3, 0, 0, 0])
    return pkg.GraphStore.from_edges(src, dst, n_nodes=5)


def _random_graph(pkg, n=64, e=400, seed=7, weights=False, hub=0):
    """Random edges, a few isolated nodes (the last id among them), and
    optionally a hub of ``hub`` edges at node 0."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n - 4, size=e)
    dst = rng.integers(0, n, size=e)
    if hub:
        src = np.concatenate([src, np.zeros(hub, np.int64)])
        dst = np.concatenate([dst, rng.integers(0, n, size=hub)])
    w = (rng.lognormal(size=src.size).astype(np.float32) if weights
         else None)
    if weights:
        w[::7] = 0.0                       # zero-weight edges
    return pkg.GraphStore.from_edges(src, dst, n_nodes=n, weights=w)


def _both(**kw):
    return _random_graph(jg, **kw), _random_graph(tg, **kw)


def _nodes(n=64, count=40, seed=3):
    return np.random.default_rng(seed).integers(0, n, size=count).astype(
        np.int32)


# ---- the cores against the reference, given its draws ------------------
def test_store_arrays_equal_the_reference():
    for kw in ({}, {"weights": True}, {"hub": 300}):
        jgs, tgs = _both(**kw)
        np.testing.assert_array_equal(tgs.indptr, jgs.indptr)
        np.testing.assert_array_equal(tgs.indices, jgs.indices)
        if kw.get("weights"):
            np.testing.assert_array_equal(tgs.cumw, jgs.cumw)
    g = tg.GraphStore.from_edges(np.array([0]), np.array([1]), n_nodes=2,
                                 symmetric=True)
    np.testing.assert_array_equal(g.degree(), [1, 1])
    g = star_graph()
    np.testing.assert_array_equal(g.degree(), [3, 1, 1, 1, 0])


@pytest.mark.parametrize("k", [1, 5])
def test_sample_neighbors_core_matches_jax(k):
    jgs, tgs = _both()
    nodes = _nodes()
    key = jax.random.PRNGKey(11)
    want = np.asarray(jg.sample_neighbors(*jgs.to_device(),
                                          jnp.asarray(nodes), k, key))
    u = np.asarray(jax.random.uniform(key, (nodes.size, k)))
    got = tg.sample_neighbors_core(*tgs.to_device("cpu"), _t(nodes), _t(u))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want[np.isin(nodes, np.arange(60, 64))] == -1).all()


def test_random_walk_core_matches_jax():
    jgs, tgs = _both()
    starts = _nodes(count=16)
    key, length = jax.random.PRNGKey(2), 6
    want = np.asarray(jg.random_walk(*jgs.to_device(), jnp.asarray(starts),
                                     length, key))
    us = np.stack([np.asarray(jax.random.uniform(kk, (starts.size, 1)))
                   for kk in jax.random.split(key, length)])
    got = tg.random_walk_core(*tgs.to_device("cpu"), _t(starts), _t(us))
    np.testing.assert_array_equal(got.numpy(), want)


def test_weighted_core_matches_jax():
    jgs, tgs = _both(weights=True)
    nodes, k = _nodes(), 4
    key = jax.random.PRNGKey(5)
    want = np.asarray(jg.sample_neighbors_weighted(
        *jgs.to_device_weighted(), jnp.asarray(nodes), k, key))
    u = np.asarray(jax.random.uniform(key, (nodes.size, k)))
    got = tg.sample_neighbors_weighted_core(
        *tgs.to_device_weighted("cpu"), _t(nodes), _t(u))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("k", [3, 20])
def test_without_replacement_core_matches_jax(weighted, k):
    jgs, tgs = _both(weights=weighted, hub=300)
    nodes = np.concatenate([[0, 0, 63], _nodes()]).astype(np.int32)
    key, max_degree = jax.random.PRNGKey(9), 16
    jcumw = jnp.asarray(jgs.cumw) if weighted else None
    want = np.asarray(jg.sample_neighbors_without_replacement(
        *jgs.to_device(), jnp.asarray(nodes), k, key,
        max_degree=max_degree, cumw=jcumw))
    # the reference's draws, as it takes them from its key
    rng, rng_off = jax.random.split(key)
    deg = jgs.indptr[nodes + 1] - jgs.indptr[nodes]
    over = np.maximum(deg - max_degree, 0)
    off = np.asarray(jax.random.randint(rng_off, (nodes.size,), 0,
                                        jnp.asarray(over) + 1))
    u = np.asarray(jax.random.uniform(rng, (nodes.size, max_degree),
                                      minval=1e-12, maxval=1.0))
    got = tg.sample_neighbors_without_replacement_core(
        *tgs.to_device("cpu"), _t(nodes), k, _t(off), _t(u),
        max_degree=max_degree,
        cumw=_t(tgs.cumw) if weighted else None)
    np.testing.assert_array_equal(got.numpy(), want)


def test_metapath_walk_from_matches_jax():
    stores = {}
    for pkg in (jg, tg):
        a = pkg.GraphStore.from_edges(np.arange(10), np.arange(10) + 10,
                                      n_nodes=200)
        b = pkg.GraphStore.from_edges(np.arange(10, 20),
                                      np.arange(10, 20) + 100, n_nodes=200)
        r = _random_graph(pkg, n=200, e=600, seed=1)
        stores[pkg] = pkg.HeteroGraphStore({"a": a, "b": b, "r": r})
    starts = np.arange(12, dtype=np.int32)
    path = ["r", "a", "b", "r", "b"]
    key = jax.random.PRNGKey(4)
    want = np.asarray(stores[jg].metapath_walk(path, jnp.asarray(starts),
                                               key))
    us, rng = [], key
    for _ in path:
        rng, sub = jax.random.split(rng)
        us.append(np.asarray(jax.random.uniform(sub, (starts.size, 1))))
    got = stores[tg].metapath_walk_from(path, _t(starts), _t(np.stack(us)))
    np.testing.assert_array_equal(got.numpy(), want)


def test_bfs_from_matches_jax():
    jgs, tgs = _both(n=64, e=300)
    seeds = np.array([0, 5, 17, 63], np.int32)
    kpl, budget = (4, 3), 32
    key = jax.random.PRNGKey(6)
    want = jg.BfsSampler(jgs, k_per_level=kpl, node_budget=budget).sample(
        seeds, key)
    us, rng, size = [], key, seeds.size
    for k in kpl:
        rng, sub = jax.random.split(rng)
        us.append(_t(np.asarray(jax.random.uniform(sub, (size, k)))))
        size = budget
    got = BfsSampler(tgs, k_per_level=kpl, node_budget=budget,
                     device="cpu").sample_from(seeds, us)
    assert len(got["levels"]) == len(want["levels"]) == 3
    for a, b in zip(got["levels"], want["levels"]):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(got["edges"], want["edges"]):
        np.testing.assert_array_equal(a, b)


# ---- the reference's cases on the port's own draws ----------------------
def test_sample_neighbors_valid_and_padded():
    g = star_graph()
    indptr, indices = g.to_device("cpu")
    out = tg.sample_neighbors(indptr, indices, torch.tensor([0, 1, 4]), 8,
                              gen()).numpy()
    assert out.shape == (3, 8)
    assert set(out[0]).issubset({1, 2, 3})
    assert (out[1] == 0).all()
    assert (out[2] == -1).all()


def test_random_walk_follows_edges():
    g = star_graph()
    walks = tg.random_walk(*g.to_device("cpu"),
                           torch.tensor([0, 4], dtype=torch.int32), 6,
                           gen(2)).numpy()
    assert walks.shape == (2, 7)
    w = walks[0]
    for t in range(6):
        if w[t] == 0:
            assert w[t + 1] in (1, 2, 3)
        else:
            assert w[t + 1] == 0
    assert (walks[1] == 4).all()


def test_generator_batches_static_shapes():
    g = star_graph()
    batches = list(GraphDataGenerator(g, walk_len=3, batch_size=4, seed=0,
                                      device="cpu").batches(epochs=1))
    assert len(batches) == 2  # ceil(5/4)
    for b in batches:
        assert b.shape == (4, 4)
        assert (b.numpy() >= 0).all()
    # the short tail repeats its last node (the reference's edge padding)
    last = batches[1].numpy()[:, 0]
    assert (last == last[0]).all()
    assert sorted(np.concatenate([batches[0].numpy()[:, 0], last[:1]])) \
        == [0, 1, 2, 3, 4]


def test_weighted_sampling_proportional():
    g = GraphStore.from_edges(np.array([0, 0]), np.array([1, 2]), n_nodes=3,
                              weights=np.array([1.0, 3.0], np.float32))
    indptr, indices, cumw = g.to_device_weighted("cpu")
    out = tg.sample_neighbors_weighted(indptr, indices, cumw,
                                       torch.zeros(2000, dtype=torch.int32),
                                       1, gen()).numpy()[:, 0]
    frac = (out == 2).mean()
    assert 0.70 < frac < 0.80, frac
    iso = tg.sample_neighbors_weighted(indptr, indices, cumw,
                                       torch.full((4,), 2), 3, gen(1))
    assert (iso.numpy() == -1).all()


def test_float64_cumw_draws_every_edge_of_a_large_store_in_proportion():
    # 2^20 edges of lognormal weight, a hub of 1024 distinct neighbours at
    # the store's end, where the f32 cumsum's spacing is 2^-3: the
    # reference's f32 store gives some of the hub's edges a zero span
    # (never drawn); the f64 store draws each in proportion
    rng = np.random.default_rng(5)
    n, hub, m = 1 << 16, 1024, 1 << 22
    src = np.concatenate([np.repeat(np.arange(n - 1), 16),
                          np.full(hub, n - 1)])
    dst = np.concatenate([rng.integers(0, n, (n - 1) * 16),
                          np.arange(hub)])
    w = rng.lognormal(0.0, 1.0, src.size).astype(np.float32)
    p = w[-hub:].astype(np.float64) / w[-hub:].sum(dtype=np.float64)
    expect = m * p
    tested = expect >= 50.0
    nodes = torch.full((m // 8,), n - 1, dtype=torch.int32)
    u = torch.rand((m // 8, 8), generator=gen(4))
    counts = {}
    for dtype in (np.float32, np.float64):
        g = GraphStore.from_edges(src, dst, n_nodes=n, weights=w,
                                  cumw_dtype=dtype)
        assert g.cumw.dtype == dtype
        out = tg.sample_neighbors_weighted_core(
            *g.to_device_weighted("cpu"), nodes, u).numpy().ravel()
        assert (out >= 0).all() and (out < hub).all()
        counts[dtype] = np.bincount(out, minlength=hub)
    zero = (np.diff(GraphStore.from_edges(src, dst, n_nodes=n, weights=w)
                    .cumw[-hub - 1:]) <= 0)
    assert zero.any() and (counts[np.float32][zero & tested] == 0).any()
    dev = np.abs(counts[np.float64] - expect)
    assert (dev[tested] <= 7.0 * np.sqrt(expect[tested])).all()
    assert (counts[np.float64][tested] > 0).all()


def test_without_replacement_no_duplicates():
    rng = np.random.default_rng(0)
    src = np.repeat(np.arange(4), 6)
    dst = rng.choice(30, size=24, replace=False).astype(np.int64)
    g = GraphStore.from_edges(src, dst, n_nodes=30)
    for k in (3, 6, 9):
        out = tg.sample_neighbors_without_replacement(
            *g.to_device("cpu"), torch.arange(4), k, gen(2),
            max_degree=16).numpy()
        assert out.shape == (4, k)
        for row in out:
            real = row[row >= 0]
            assert len(set(real.tolist())) == len(real)
            assert len(real) == min(k, 6)


def test_without_replacement_weighted_prefers_heavy():
    w = np.ones(8, np.float32)
    w[3] = 50.0
    g = GraphStore.from_edges(np.zeros(8, np.int64), np.arange(1, 9),
                              n_nodes=9, weights=w)
    indptr, indices, cumw = g.to_device_weighted("cpu")
    g0 = gen(0)
    hits = sum(int(tg.sample_neighbors_without_replacement(
        indptr, indices, torch.zeros(1, dtype=torch.int32), 1, g0,
        max_degree=8, cumw=cumw)[0, 0] == 4) for _ in range(200))
    assert hits > 150  # ~50/57 probability of the heavy edge first


def test_without_replacement_hub_tail_reachable():
    deg = 64
    g = GraphStore.from_edges(np.zeros(deg, np.int64), np.arange(1, deg + 1),
                              n_nodes=deg + 1)
    seen = set()
    g0 = gen(0)
    for _ in range(60):
        out = tg.sample_neighbors_without_replacement(
            *g.to_device("cpu"), torch.zeros(1, dtype=torch.int32), 8, g0,
            max_degree=16).numpy()
        real = out[out >= 0]
        assert len(set(real.tolist())) == len(real)
        seen.update(real.tolist())
    assert any(v > 16 for v in seen), sorted(seen)
    assert len(seen) > deg * 0.8, sorted(seen)


def test_window_offsets_are_exact_integers_past_2_24():
    """A hub 2^30 edges past the window draws offsets over all of its
    range, exactly (no float quantization to multiples of 2^7)."""
    over = torch.full((4096,), 2 ** 30, dtype=torch.int64)
    off = tg.window_offsets(over, gen(1))
    assert int(off.min()) >= 0 and int(off.max()) <= 2 ** 30
    assert int((off % 128 != 0).sum()) > 3000


def test_metapath_walk_follows_types():
    a = GraphStore.from_edges(np.arange(10), np.arange(10) + 10, n_nodes=200)
    b = GraphStore.from_edges(np.arange(10, 20), np.arange(10, 20) + 100,
                              n_nodes=200)
    h = HeteroGraphStore({"a": a, "b": b})
    starts = torch.arange(5, dtype=torch.int32)
    walks = h.metapath_walk(["a", "b"], starts, gen()).numpy()
    np.testing.assert_array_equal(walks[:, 1], np.arange(5) + 10)
    np.testing.assert_array_equal(walks[:, 2], np.arange(5) + 110)
    walks2 = h.metapath_walk(["b", "a"], starts, gen()).numpy()
    np.testing.assert_array_equal(walks2[:, 1], np.arange(5))  # stall
    np.testing.assert_array_equal(walks2[:, 2], np.arange(5) + 10)


def test_features_for_nodes_pulls_embedding_rows():
    from paddlebox_tpu_torch.graph import features_for_nodes
    from paddlebox_tpu_torch.ps import EmbeddingTable, SparseSGDConfig
    from paddlebox_tpu_torch.ps.table import FIELD_COL
    t = EmbeddingTable(mf_dim=4, capacity=256, device="cpu",
                       cfg=SparseSGDConfig(mf_create_thresholds=0.0))
    rows = t.index.assign(np.array([5, 9], np.uint64))
    t.state.data[torch.from_numpy(rows.astype(np.int64)),
                 FIELD_COL["show"]] = 7.0
    t.state.data[torch.from_numpy(rows.astype(np.int64)),
                 FIELD_COL["embed_w"]] = 0.25
    out = features_for_nodes(t, np.array([5, 9, 77], np.uint64))
    assert out.shape == (3, 7)
    np.testing.assert_allclose(out[:2, 0], 7.0)
    np.testing.assert_allclose(out[:2, 2], 0.25)
    np.testing.assert_allclose(out[2], 0.0)


def _two_cliques(m=20, cross=3, seed=0):
    rng = np.random.default_rng(seed)
    src, dst = [], []
    for base in (0, m):
        for i in range(m):
            for j in range(m):
                if i != j:
                    src.append(base + i)
                    dst.append(base + j)
    for _ in range(cross):
        a, b = rng.integers(0, m), m + rng.integers(0, m)
        src += [a, b]
        dst += [b, a]
    return GraphStore.from_edges(np.array(src), np.array(dst), n_nodes=2 * m)


def test_bfs_sampler_levels_and_edges():
    g = _two_cliques()
    adj = {u: set(g.indices[g.indptr[u]:g.indptr[u + 1]].tolist())
           for u in range(g.n_nodes)}
    s = BfsSampler(g, k_per_level=(5, 3), node_budget=64, device="cpu")
    out = s.sample(np.array([0, 1, 25], np.int32), gen())
    assert len(out["levels"]) == 3
    src, dst = out["edges"]
    assert len(src) > 0
    for u, v in zip(src, dst):
        assert int(v) in adj[int(u)], (u, v)
    lvl_sets = [set(l[l >= 0].tolist()) for l in out["levels"]]
    for u in lvl_sets[1]:
        assert any(u in adj[s0] for s0 in lvl_sets[0])


def test_sampler_service_rate_control_and_feed():
    svc = GraphSamplerService(_two_cliques(), mode="walk", batch_size=8,
                              walk_len=3, rate=20.0, capacity=64, seed=1,
                              device="cpu")
    svc.start()
    it = svc.batches()
    first = next(it)
    assert first.shape == (8, 4)
    t0 = time.monotonic()
    base = svc.produced
    got = 0
    for walks in it:
        assert walks.shape == (8, 4)
        got += 1
        if time.monotonic() - t0 > 1.0:
            break
    produced_window = svc.produced - base
    elapsed = time.monotonic() - t0
    svc.stop()
    assert got >= 1
    assert produced_window <= 20 * elapsed + 3, (produced_window, elapsed)


def test_sampler_service_raises_the_producers_error():
    svc = GraphSamplerService(_two_cliques(), mode="walk", batch_size=8,
                              seed=1, device="cpu")
    svc.store = None                   # the producer fails at its start
    svc.start()
    with pytest.raises(AttributeError):
        list(svc.batches())
    svc.stop()


def test_gnn_trains_from_service():
    """A small GraphSAGE-style classifier trained continuously from the
    background BFS service separates two communities (Adam)."""
    m = 20
    g = _two_cliques(m=m)
    rng = np.random.default_rng(3)
    feats = rng.normal(size=(2 * m, 8)).astype(np.float32)
    labels = (np.arange(2 * m) >= m).astype(np.float32)
    svc = GraphSamplerService(g, mode="bfs", batch_size=16, k_per_level=(6,),
                              capacity=16, seed=2, device="cpu")
    svc.start(max_batches=120)
    w = torch.tensor(rng.normal(size=(16,)) * 0.1, dtype=torch.float32,
                     requires_grad=True)
    opt = torch.optim.Adam([w], lr=5e-2)
    nb = 0
    for batch in svc.batches():
        seeds = batch["levels"][0]
        src, dst = batch["edges"]
        x_seed = feats[seeds]
        x_neigh = np.zeros_like(x_seed)
        for i, sd in enumerate(seeds):
            nb_mask = src == sd
            if nb_mask.any():
                x_neigh[i] = feats[dst[nb_mask]].mean(axis=0)
        h = torch.from_numpy(np.concatenate([x_seed, x_neigh], axis=1))
        loss = torch.nn.functional.binary_cross_entropy_with_logits(
            h @ w, torch.from_numpy(labels[seeds]))
        opt.zero_grad()
        loss.backward()
        opt.step()
        nb += 1
    svc.stop()
    assert nb == 120
    x_neigh_all = np.stack([
        feats[g.indices[g.indptr[u]:g.indptr[u + 1]]].mean(axis=0)
        for u in range(2 * m)])
    logits = np.concatenate([feats, x_neigh_all], axis=1) @ \
        w.detach().numpy()
    acc = ((logits > 0) == (labels > 0.5)).mean()
    assert acc > 0.9, acc


def test_state_defaults_to_the_card(monkeypatch):
    """The device copies and the generators default to the card and raise
    without one; the CPU runs only when asked for."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = star_graph()
    for make in (lambda: g.to_device(), lambda: make_generator(0),
                 lambda: GraphDataGenerator(g),
                 lambda: BfsSampler(g),
                 lambda: GraphSamplerService(g)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    assert g.to_device("cpu")[0].device.type == "cpu"


# ---- the sharded sampler on a gang of 4 ranks ---------------------------
SH_N, SH_K, SH_Q = 64, 4, 16


def _sharded_cfg():
    rng = np.random.default_rng(7)
    src = rng.integers(0, SH_N - 4, size=400)
    dst = rng.integers(0, SH_N, size=400)
    queries = rng.integers(0, SH_N, size=(N, SH_Q)).astype(np.int32)
    keys = np.stack([jax.random.key_data(jax.random.PRNGKey(s))
                     for s in range(N)])
    # the reference's local draws: the shard's key folded with the shard
    draws = np.stack([np.asarray(jax.random.uniform(
        jax.random.fold_in(jax.random.wrap_key_data(jnp.asarray(keys[s])),
                           s), (N * SH_Q, SH_K))) for s in range(N)])
    return {"src": src, "dst": dst, "n": SH_N, "k": SH_K, "q": SH_Q,
            "queries": queries, "keys": keys, "draws": draws}


@pytest.fixture(scope="module", autouse=True)
def gang(tmp_path_factory):
    """The file's gang, started with its first test."""
    return Gang("graph", _sharded_cfg(), tmp_path_factory.mktemp("graph"))


def test_sharded_sampler_matches_jax(gang):
    cfg = gang.cfg
    g = jg.GraphStore.from_edges(cfg["src"], cfg["dst"], n_nodes=cfg["n"])
    sg = jg.ShardedGraphStore(g, N)
    for s, r in enumerate(gang.ranks()):
        # the same padded [S, ...] arrays, byte for byte
        np.testing.assert_array_equal(r["indptr"], sg.indptr[s])
        np.testing.assert_array_equal(r["indices"], sg.indices[s])
        assert int(r["overflow_raised"]) == 1
    mesh = Mesh(np.array(jax.devices()[:N]), ("dp",))
    sampler = sg.make_sampler(mesh, k=SH_K, q_per_shard=SH_Q, axis="dp")
    want = np.asarray(sampler(jnp.asarray(sg.indptr),
                              jnp.asarray(sg.indices),
                              jnp.asarray(cfg["queries"]),
                              jnp.asarray(cfg["keys"])))
    for s, r in enumerate(gang.ranks()):
        np.testing.assert_array_equal(r["jax_draws"], want[s])
    # on the port's own per-rank streams: true edges, -1 for isolated
    adj = {u: set() for u in range(SH_N)}
    for u, v in zip(cfg["src"], cfg["dst"]):
        adj[int(u)].add(int(v))
    for r, qrow in zip(gang.ranks(), cfg["queries"]):
        for got, q in zip(r["own_draws"], qrow):
            if not adj[int(q)]:
                assert (got == -1).all()
            else:
                assert all(int(x) in adj[int(q)] for x in got), (q, got)
