"""Graph store + neighbor sampling (GNN training support) — counterpart
of ``paddlebox_tpu/graph.py``.

Reference: the GPU graph PS in heter_ps — ``GpuPsCommGraph`` (CSR
neighbor lists per shard), ``GpuPsGraphTable`` (graph_neighbor_sample),
``graph_sampler`` walk generation, and ``GraphDataGenerator``.

The graph lives as two tensors on the card (CSR ``indptr``/``indices``).
Uniform neighbor draws are ``indptr[n] + floor(u * deg)`` with isolated
nodes padded to -1; weighted draws one ``searchsorted`` over the per-node
cumulative-weight spans; draws without replacement the Gumbel top-k over
a bounded neighbor window; typed graphs walk metapaths; a store sharded
by node % S routes queries by ``all_to_all`` over a mesh axis.

Every sampler takes an explicit ``torch.Generator`` and is split into the
draws and a core that takes them (``*_core`` / ``*_from``), so a test can
hand the core the reference's own draws and hold the two packages equal
exactly. Whatever builds state on a device (``GraphStore.to_device``, the
generators of ``GraphDataGenerator``, ``BfsSampler`` and
``GraphSamplerService``) defaults to the card and raises without one.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from paddlebox_tpu_torch.device import resolve_device, seeded_generator
from paddlebox_tpu_torch.parallel.collectives import all_to_all


def make_generator(seed: int, device: Any = "cuda") -> torch.Generator:
    """A generator on ``device`` (default the card) seeded with ``seed``."""
    g = torch.Generator(device=resolve_device(device))
    g.manual_seed(seed)
    return g


class GraphStore:
    """CSR graph with dense node ids [0, n_nodes); optional per-edge
    weights (cumulative sums precomputed for weighted draws, in
    ``cumw_dtype``: float32 as in the reference, or float64 for a store
    past its limit, below)."""

    def __init__(self, indptr: np.ndarray, indices: np.ndarray,
                 weights: Optional[np.ndarray] = None,
                 cumw_dtype: Any = np.float32) -> None:
        self.indptr = np.asarray(indptr, np.int32)
        self.indices = np.asarray(indices, np.int32)
        self.n_nodes = self.indptr.size - 1
        if weights is not None:
            weights = np.asarray(weights, np.float32)
            if weights.shape != self.indices.shape:
                raise ValueError("one weight per edge required")
            if (weights < 0).any():
                raise ValueError("edge weights must be non-negative")
        self.weights = weights
        # Global cumulative weights: monotone, so a per-node weighted
        # draw is ONE searchsorted into its [indptr[n], indptr[n+1]) span.
        # Weights are NORMALIZED to mean 1 before the (f64) cumsum so the
        # f32 device copy's total ≈ edge count E. Its spacing there is
        # ~E·2^-23, so a weight below half of it gets a zero span (the
        # edge is never drawn) and a small one a coarsely rounded span
        # (``chip_smoke.py`` phase 21a counts them on a 17M-edge graph of
        # lognormal weights). The reference names sharding as the way
        # out, but its ShardedGraphStore carries no weights and a shard's
        # own cumsum keeps the same spacing for its own E. A large
        # weighted store keeps the f64 cumsum (cumw_dtype=np.float64).
        if weights is not None and weights.size:
            mean_w = float(weights.mean())
            if mean_w <= 0:
                raise ValueError("edge weights must not all be zero")
            self.cumw = np.cumsum(weights / mean_w,
                                  dtype=np.float64).astype(cumw_dtype)
        else:
            self.cumw = None
        self._dev: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = {}
        self._dev_cumw: Dict[str, torch.Tensor] = {}

    @classmethod
    def from_edges(cls, src: np.ndarray, dst: np.ndarray,
                   n_nodes: Optional[int] = None,
                   symmetric: bool = False,
                   weights: Optional[np.ndarray] = None,
                   cumw_dtype: Any = np.float32) -> "GraphStore":
        src = np.asarray(src, np.int64)
        dst = np.asarray(dst, np.int64)
        if weights is not None:
            weights = np.asarray(weights, np.float32)
        if symmetric:
            src, dst = (np.concatenate([src, dst]),
                        np.concatenate([dst, src]))
            if weights is not None:
                weights = np.concatenate([weights, weights])
        n = int(n_nodes if n_nodes is not None
                else (max(src.max(), dst.max()) + 1 if src.size else 0))
        if src.size and (src.min() < 0 or dst.min() < 0
                         or src.max() >= n or dst.max() >= n):
            raise ValueError(
                f"edge node ids must lie in [0, {n}); got src range "
                f"[{src.min()}, {src.max()}], dst range "
                f"[{dst.min()}, {dst.max()}]")
        order = np.argsort(src, kind="stable")
        src, dst = src[order], dst[order]
        counts = np.bincount(src, minlength=n)
        indptr = np.zeros(n + 1, np.int64)
        np.cumsum(counts, out=indptr[1:])
        return cls(indptr, dst,
                   weights[order] if weights is not None else None,
                   cumw_dtype)

    def degree(self, nodes: Optional[np.ndarray] = None) -> np.ndarray:
        deg = np.diff(self.indptr)
        return deg if nodes is None else deg[np.asarray(nodes)]

    def to_device(self, device: Any = "cuda"
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(indptr, indices) as int32 tensors on ``device`` (default the
        card), copied once a device."""
        dev = resolve_device(device)
        key = str(dev)
        if key not in self._dev:
            self._dev[key] = (torch.from_numpy(self.indptr).to(dev),
                              torch.from_numpy(self.indices).to(dev))
        return self._dev[key]

    def to_device_weighted(self, device: Any = "cuda"):
        """(indptr, indices, cumw) on ``device``."""
        if self.cumw is None:
            raise ValueError("graph has no edge weights")
        dev = resolve_device(device)
        key = str(dev)
        if key not in self._dev_cumw:
            self._dev_cumw[key] = torch.from_numpy(self.cumw).to(dev)
        return (*self.to_device(dev), self._dev_cumw[key])


def _rand(shape, generator: torch.Generator) -> torch.Tensor:
    return torch.rand(tuple(shape), generator=generator,
                      device=generator.device)


def _clamp_edges(idx: torch.Tensor, n_edges: int) -> torch.Tensor:
    """Edge positions clamped into the array, as XLA's gather clamps (a
    padded lane of an isolated last node points one past the end)."""
    return idx.clamp(0, max(n_edges - 1, 0)).long()


def sample_neighbors(indptr: torch.Tensor, indices: torch.Tensor,
                     nodes: torch.Tensor, k: int,
                     generator: torch.Generator) -> torch.Tensor:
    """Uniform with-replacement k-neighbor sample per node → int32 [N, k];
    isolated nodes yield -1 (the reference pads its sample results the
    same way: default_value in graph_neighbor_sample)."""
    return sample_neighbors_core(indptr, indices, nodes,
                                 _rand((nodes.shape[0], k), generator))


def sample_neighbors_core(indptr: torch.Tensor, indices: torch.Tensor,
                          nodes: torch.Tensor, u: torch.Tensor
                          ) -> torch.Tensor:
    """``sample_neighbors`` given its draws ``u`` [N, k] in [0, 1):
    offset ``floor(u · max(deg, 1))`` in float32."""
    nodes = nodes.long()
    start = indptr[nodes]                                    # [N]
    deg = indptr[nodes + 1] - start                          # [N]
    if indices.numel() == 0:
        return torch.full(u.shape, -1, dtype=torch.int32, device=u.device)
    off = torch.floor(u * torch.clamp(deg, min=1)[:, None]).to(torch.int32)
    neigh = indices[_clamp_edges(start[:, None] + off, indices.numel())]
    return torch.where(deg[:, None] > 0, neigh, -1)


def random_walk(indptr: torch.Tensor, indices: torch.Tensor,
                starts: torch.Tensor, length: int,
                generator: torch.Generator) -> torch.Tensor:
    """DeepWalk-style uniform walks → int32 [N, length+1] (first column =
    starts). A walk stalls (repeats its node) at isolated nodes."""
    return random_walk_core(indptr, indices, starts,
                            _rand((length, starts.shape[0], 1), generator))


def random_walk_core(indptr: torch.Tensor, indices: torch.Tensor,
                     starts: torch.Tensor, us: torch.Tensor
                     ) -> torch.Tensor:
    """``random_walk`` given its draws ``us`` [length, N, 1], hop by hop."""
    cur = starts.to(torch.int32)
    cols = [cur]
    for u in us:
        nxt = sample_neighbors_core(indptr, indices, cur, u)[:, 0]
        cur = torch.where(nxt < 0, cur, nxt)
        cols.append(cur)
    return torch.stack(cols, dim=1)


class GraphDataGenerator:
    """Walk-batch generator feeding skip-gram style training (reference:
    GraphDataGenerator data_feed.h:908 — sample walks, emit id batches)."""

    def __init__(self, store: GraphStore, walk_len: int = 5,
                 batch_size: int = 256, seed: int = 0,
                 device: Any = "cuda") -> None:
        self.store = store
        self.walk_len = walk_len
        self.batch_size = batch_size
        self.device = resolve_device(device)
        self.generator = make_generator(seed, self.device)

    def batches(self, epochs: int = 1):
        indptr, indices = self.store.to_device(self.device)
        n = self.store.n_nodes
        for _ in range(epochs):
            perm = torch.randperm(n, generator=self.generator,
                                  device=self.device).to(torch.int32)
            for i in range(0, n, self.batch_size):
                chunk = perm[i:i + self.batch_size]
                if chunk.numel() < self.batch_size:  # static shapes: pad
                    chunk = torch.cat([chunk, chunk[-1:].expand(
                        self.batch_size - chunk.numel())])
                yield random_walk(indptr, indices, chunk, self.walk_len,
                                  self.generator)


def sample_neighbors_weighted(indptr: torch.Tensor, indices: torch.Tensor,
                              cumw: torch.Tensor, nodes: torch.Tensor,
                              k: int, generator: torch.Generator
                              ) -> torch.Tensor:
    """Weight-proportional with-replacement k-sample per node → [N, k];
    isolated / zero-weight nodes yield -1. One vectorized searchsorted
    into each node's cumulative-weight span (the WeightedSampleKernel of
    the reference's sampler, without per-thread rejection loops)."""
    return sample_neighbors_weighted_core(
        indptr, indices, cumw, nodes, _rand((nodes.shape[0], k), generator))


def sample_neighbors_weighted_core(indptr: torch.Tensor,
                                   indices: torch.Tensor,
                                   cumw: torch.Tensor, nodes: torch.Tensor,
                                   u: torch.Tensor) -> torch.Tensor:
    """``sample_neighbors_weighted`` given its draws ``u`` [N, k]."""
    nodes = nodes.long()
    start = indptr[nodes].long()
    end = indptr[nodes + 1].long()
    if indices.numel() == 0:
        return torch.full(u.shape, -1, dtype=torch.int32, device=u.device)
    lo = torch.where(start > 0, cumw[(start - 1).clamp(min=0)], 0.0)
    hi = cumw[(end - 1).clamp(min=0)]
    total = torch.where(end > start, hi - lo, 0.0)
    # strictly inside the span: searchsorted returns the owning edge
    target = lo[:, None] + u * torch.clamp(total, min=1e-30)[:, None]
    idx = torch.searchsorted(cumw, target, right=False)
    idx = torch.clamp(idx, start[:, None], (end[:, None] - 1).clamp(min=0))
    neigh = indices[_clamp_edges(idx, indices.numel())]
    return torch.where(total[:, None] > 0, neigh, -1)


def window_offsets(over: torch.Tensor,
                   generator: torch.Generator) -> torch.Tensor:
    """An exact integer draw in [0, over] a node: a 63-bit integer modulo
    ``over + 1`` (an f32 ``u · span`` would quantize the offsets of a hub
    with more than 2^24 excess edges and hide its tail again)."""
    r = torch.randint(0, 2 ** 63 - 1, tuple(over.shape), generator=generator,
                      device=generator.device, dtype=torch.int64)
    return r % (over.long() + 1)


def sample_neighbors_without_replacement(
        indptr: torch.Tensor, indices: torch.Tensor, nodes: torch.Tensor,
        k: int, generator: torch.Generator, max_degree: int = 128,
        cumw: Optional[torch.Tensor] = None) -> torch.Tensor:
    """WITHOUT-replacement k-sample per node → [N, k] (uniform, or
    weight-proportional when ``cumw`` is given) — the Gumbel top-k
    trick: per candidate edge key = log(w) + Gumbel noise, take top-k
    (exactly Plackett-Luce sequential sampling without replacement).

    Gathers a bounded [N, max_degree] neighbor window and runs ONE
    ``topk``. Nodes with degree > max_degree sample from a
    max_degree-wide window whose offset is drawn uniformly at random PER
    CALL, so every edge of a hub is sampleable across calls. Slots beyond
    a node's degree (or beyond k available) are -1."""
    n = nodes.shape[0]
    nodes_l = nodes.long()
    over = torch.clamp(indptr[nodes_l + 1] - indptr[nodes_l] - max_degree,
                       min=0)
    off = window_offsets(over, generator)
    u = _rand((n, max_degree), generator) * (1.0 - 1e-12) + 1e-12
    return sample_neighbors_without_replacement_core(
        indptr, indices, nodes, k, off, u, max_degree, cumw)


def sample_neighbors_without_replacement_core(
        indptr: torch.Tensor, indices: torch.Tensor, nodes: torch.Tensor,
        k: int, off: torch.Tensor, u: torch.Tensor, max_degree: int = 128,
        cumw: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``sample_neighbors_without_replacement`` given its draws: ``off``
    [N] the window offsets in [0, max(deg − max_degree, 0)], ``u``
    [N, max_degree] uniforms in [1e-12, 1) for the Gumbel noise."""
    n = nodes.shape[0]
    nodes = nodes.long()
    start = indptr[nodes].long()
    full_deg = indptr[nodes + 1].long() - start
    deg = torch.clamp(full_deg, max=max_degree)
    pos = torch.arange(max_degree, device=u.device)[None, :]
    edge = torch.clamp(start[:, None] + off.long()[:, None] + pos,
                       max=max(indices.numel() - 1, 0))
    valid = pos < deg[:, None]
    if indices.numel() == 0:
        return torch.full((n, k), -1, dtype=torch.int32, device=u.device)
    if cumw is not None:
        w_hi = cumw[edge]
        w_lo = torch.where(edge > 0, cumw[(edge - 1).clamp(min=0)], 0.0)
        span = w_hi - w_lo
        # zero-weight edges are NOT sampleable (matches the
        # with-replacement sampler's zero-total -> -1 contract)
        logw = torch.where(span > 0, torch.log(torch.clamp(span, min=1e-30)),
                           -float("inf"))
    else:
        logw = torch.zeros((n, max_degree), device=u.device)
    g = -torch.log(-torch.log(u))
    keys = torch.where(valid, logw + g, -float("inf"))
    top, arg = torch.topk(keys, min(k, max_degree), dim=1)
    neigh = torch.gather(indices[edge], 1, arg)              # [N, <=k]
    neigh = torch.where(torch.isfinite(top), neigh, -1)
    if neigh.shape[1] < k:                                   # k > max_degree
        pad = torch.full((n, k - neigh.shape[1]), -1, dtype=neigh.dtype,
                         device=neigh.device)
        neigh = torch.cat([neigh, pad], dim=1)
    return neigh


class HeteroGraphStore:
    """Typed-edge graph: one CSR per edge type over a SHARED node id
    space (the reference's per-type graph index, idx arg of
    graph_neighbor_sample_v2 / add_graph_table)."""

    def __init__(self, stores) -> None:
        self.stores = dict(stores)
        if not self.stores:
            raise ValueError("need at least one edge type")

    def edge_types(self):
        return sorted(self.stores)

    def metapath_walk(self, metapath, starts: torch.Tensor,
                      generator: torch.Generator) -> torch.Tensor:
        """Walk following the given edge-type sequence (graph_sampler
        metapath schedules): hop i samples one neighbor through
        ``metapath[i]``'s CSR. Stalls at dead ends. → [N, len+1]."""
        return self.metapath_walk_from(
            metapath, starts,
            _rand((len(metapath), starts.shape[0], 1), generator))

    def metapath_walk_from(self, metapath, starts: torch.Tensor,
                           us: torch.Tensor) -> torch.Tensor:
        """``metapath_walk`` given its draws ``us`` [len, N, 1]."""
        cur = starts.to(torch.int32)
        cols = [cur]
        for et, u in zip(metapath, us):
            indptr, indices = self.stores[et].to_device(starts.device)
            nxt = sample_neighbors_core(indptr, indices, cur, u)[:, 0]
            cur = torch.where(nxt < 0, cur, nxt)
            cols.append(cur)
        return torch.stack(cols, dim=1)


class ShardedGraphStore:
    """Sharded graph table: node n lives on shard n % S (the multi-GPU
    GpuPsGraphTable partition, heter_comm key%N routing).

    Shards are stacked, padded CSR arrays ([S, ...], the same bytes as
    the reference's); rank s of a mesh axis of S ranks holds row s
    (``convert.graph_shard``). Sampling runs on every rank: queries
    all-to-all to their owner shard, sample locally, all-to-all back."""

    def __init__(self, store: GraphStore, n_shards: int) -> None:
        self.n = n_shards
        self.n_nodes = store.n_nodes
        indptrs, indices_l = [], []
        all_deg = np.diff(store.indptr)
        for s in range(n_shards):
            own = np.arange(s, store.n_nodes, n_shards)
            deg = all_deg[own] if own.size else np.zeros(0, np.int64)
            ip = np.zeros(own.size + 1, np.int64)
            np.cumsum(deg, out=ip[1:])
            # one vectorized gather per shard (no per-node python):
            # edge position j of the shard belongs to owned node
            # searchsorted(ip, j, 'right')-1 at offset j - ip[node]
            total = int(ip[-1])
            if total:
                node_of = np.repeat(np.arange(own.size), deg)
                off = np.arange(total) - ip[node_of]
                idx = store.indices[store.indptr[own][node_of] + off]
            else:
                idx = np.zeros(0, np.int32)
            indptrs.append(ip)
            indices_l.append(idx.astype(np.int32, copy=False))
        ip_pad = max(a.size for a in indptrs)
        ix_pad = max(max(a.size for a in indices_l), 1)
        self.indptr = np.zeros((n_shards, ip_pad), np.int32)
        self.indices = np.zeros((n_shards, ix_pad), np.int32)
        for s in range(n_shards):
            # pad indptr by repeating the tail: padded local nodes read
            # degree 0
            self.indptr[s, :indptrs[s].size] = indptrs[s]
            self.indptr[s, indptrs[s].size:] = indptrs[s][-1] \
                if indptrs[s].size else 0
            self.indices[s, :indices_l[s].size] = indices_l[s]

    def make_sampler(self, axis, k: int, q_per_shard: int, seed: int = 0):
        """The sampler of this rank of ``axis`` (S ranks, rank s holding
        shard s): ``(indptr [ip_pad], indices [ix_pad], queries [Q]
        global node ids, draws=None) → [Q, k]`` neighbors (global ids;
        -1 pads) for this rank's queries, wherever their owners are.
        ``q_per_shard`` is the per-owner bucket capacity; Q must not
        exceed it (checked), since overflow would route queries to the
        wrong shard. The local sample draws ``u`` [S * q_per_shard, k]
        from this rank's own stream (``seed``, the rank), or takes
        ``draws``."""
        n = self.n
        if axis.size != n:
            raise ValueError(f"{n} shards over an axis of {axis.size} ranks")
        cap = q_per_shard
        gen = seeded_generator(axis.device, seed, axis.rank)

        def run(indptr: torch.Tensor, indices: torch.Tensor,
                queries: torch.Tensor,
                draws: Optional[torch.Tensor] = None) -> torch.Tensor:
            if queries.shape[0] > q_per_shard:
                raise ValueError(
                    f"{queries.shape[0]} queries/shard exceeds the "
                    f"bucket capacity q_per_shard={q_per_shard}")
            owner = queries % n
            # bucket queries by owner (stable sort → positions to undo)
            order = torch.argsort(owner, stable=True)
            routed = queries[order]
            # equal-split all_to_all needs uniform buckets: count per
            # owner and scatter into [n, cap] slots
            dest = owner[order]
            rank_in = torch.arange(dest.numel(), device=dest.device) \
                - torch.searchsorted(dest, dest, right=False)
            slots = torch.clamp(dest.long() * cap + rank_in, 0, n * cap - 1)
            buf = torch.full((n * cap,), -1, dtype=queries.dtype,
                             device=queries.device)
            buf[slots] = routed
            # route to owners; local ids = node // n
            flat = all_to_all(buf.view(n, cap), axis, 0, 0).reshape(-1)
            ok = flat >= 0
            local_ids = torch.where(ok, flat // n, 0)
            u = draws if draws is not None else _rand((n * cap, k), gen)
            got = sample_neighbors_core(indptr, indices, local_ids, u)
            got = torch.where(ok[:, None], got, -1)
            # send answers back
            back = all_to_all(got.view(n, cap, k), axis, 0, 0)
            # un-bucket: answer for routed[i] sits at slots[i]
            ans_sorted = back.reshape(n * cap, k)[slots]
            out = torch.zeros((queries.shape[0], k), dtype=torch.int32,
                              device=queries.device)
            out[order] = ans_sorted
            return out

        return run


def features_for_nodes(table, nodes: np.ndarray) -> np.ndarray:
    """get_feature_of_nodes (graph_gpu_ps_table.h:141): pull the
    embedding-PS feature rows for (walk) node ids — node id == feature
    key. Unknown nodes read zeros. → [n, 3 + mf]."""
    return table.host_pull(np.asarray(nodes, np.uint64).ravel())


class BfsSampler:
    """Batched BFS frontier sampler — the BasicBfsGraphSampler role
    (graph_sampler.h:77-110: per-level neighbor sampling from a seed
    frontier with per-node and per-level budgets).

    Each level is ONE ``sample_neighbors`` gather over the current
    frontier ([node_budget], -1 pads); the next frontier is the sorted
    unique sampled nodes clipped to the budget. Returns per-level node
    arrays and the sampled (src, dst) edges on the host."""

    def __init__(self, store: GraphStore, k_per_level=(10, 5),
                 node_budget: int = 4096, device: Any = "cuda") -> None:
        self.store = store
        self.k_per_level = tuple(k_per_level)
        self.node_budget = node_budget
        self.device = resolve_device(device)

    def sample(self, seeds: np.ndarray, generator: torch.Generator):
        """→ {"levels": [seeds, l1, l2, ...], "edges": (src, dst)}.
        Levels past the seeds are FIXED-BUDGET (-1-padded to
        ``node_budget``). Edges are the sampled adjacency (every dst in
        level i+1 came from a src in level i)."""
        sizes = [len(seeds)] + [self.node_budget] * (len(self.k_per_level)
                                                     - 1)
        us = [_rand((m, k), generator)
              for m, k in zip(sizes, self.k_per_level)]
        return self.sample_from(seeds, us)

    def sample_from(self, seeds: np.ndarray,
                    us: Sequence[torch.Tensor]) -> dict:
        """``sample`` given each level's draws ``us[i]`` [frontier, k_i]."""
        indptr, indices = self.store.to_device(self.device)
        levels = [np.asarray(seeds, np.int32)]
        srcs: List[np.ndarray] = []
        dsts: List[np.ndarray] = []
        frontier = torch.from_numpy(levels[0]).to(self.device)
        for u in us:
            neigh = sample_neighbors_core(indptr, indices,
                                          frontier.clamp(min=0), u)
            neigh = torch.where(frontier[:, None] >= 0, neigh, -1)
            src = frontier[:, None].expand(neigh.shape)
            m = neigh.reshape(-1) >= 0
            dst = neigh.reshape(-1)[m]
            srcs.append(src.reshape(-1)[m].cpu().numpy())
            dsts.append(dst.cpu().numpy())
            nxt = torch.unique(dst)[:self.node_budget]   # budget clip
            pad = torch.full((self.node_budget,), -1, dtype=torch.int32,
                             device=self.device)
            pad[:nxt.numel()] = nxt
            levels.append(pad.cpu().numpy())
            frontier = pad
        return {"levels": levels,
                "edges": (np.concatenate(srcs) if srcs else
                          np.zeros(0, np.int32),
                          np.concatenate(dsts) if dsts else
                          np.zeros(0, np.int32))}


class GraphSamplerService:
    """Background sampling service — the graph_sampler.h:25-110 role:
    a thread continuously drives a sampler (random walks or BFS
    subgraphs) into a bounded channel feeding the training loop, with
    SAMPLE-RATE control (max batches/sec; the reference's sample-rate
    knob, test_sample_rate.cu).

    The trainer consumes via ``batches()`` — a generator that blocks on
    the channel, so sampling overlaps training. Walk batches are int32
    [batch, walk_len + 1] host arrays, BFS batches ``BfsSampler``'s dicts.
    The producer's draws come from one generator on ``device`` (default
    the card) seeded with ``seed``."""

    def __init__(self, store: GraphStore, mode: str = "walk",
                 batch_size: int = 256, walk_len: int = 5,
                 k_per_level=(10, 5), rate: Optional[float] = None,
                 capacity: int = 8, seed: int = 0,
                 device: Any = "cuda") -> None:
        if mode not in ("walk", "bfs"):
            raise ValueError(f"unknown sampler mode {mode!r}")
        from paddlebox_tpu_torch.utils.channel import Channel
        self.store = store
        self.mode = mode
        self.batch_size = batch_size
        self.walk_len = walk_len
        self.device = resolve_device(device)
        self.bfs = (BfsSampler(store, k_per_level=k_per_level,
                               device=self.device)
                    if mode == "bfs" else None)
        self.rate = rate
        self.chan = Channel(capacity=capacity)
        self.generator = make_generator(seed, self.device)
        self._thread = None
        self._stop = False
        self._err: Optional[BaseException] = None
        self.produced = 0

    # ---- producer thread ----
    def _run(self, max_batches: Optional[int]) -> None:
        import time as _time
        from paddlebox_tpu_torch.utils.channel import ChannelClosed
        try:
            indptr, indices = self.store.to_device(self.device)
            n = self.store.n_nodes
            perm = None
            pos = 0
            t0 = _time.monotonic()
            while not self._stop:
                if max_batches is not None \
                        and self.produced >= max_batches:
                    break
                if self.rate is not None:
                    # token-bucket pacing: never exceed rate batches/sec
                    budget = (_time.monotonic() - t0) * self.rate
                    if self.produced >= budget:
                        _time.sleep(min(0.05,
                                        (self.produced - budget + 1)
                                        / self.rate))
                        continue
                if perm is None or pos + self.batch_size > n:
                    perm = torch.randperm(
                        n, generator=self.generator,
                        device=self.device).to(torch.int32).cpu().numpy()
                    pos = 0
                seeds = perm[pos:pos + self.batch_size]
                if seeds.size < self.batch_size:
                    seeds = np.pad(seeds,
                                   (0, self.batch_size - seeds.size),
                                   mode="edge")
                pos += self.batch_size
                if self.mode == "walk":
                    out = random_walk(
                        indptr, indices, torch.from_numpy(seeds).to(
                            self.device), self.walk_len,
                        self.generator).cpu().numpy()
                else:
                    out = self.bfs.sample(seeds, self.generator)
                try:
                    self.chan.put(out)
                except ChannelClosed:  # stop() raced us
                    break
                self.produced += 1
        except BaseException as e:  # handed to the consumer, re-raised there
            self._err = e
        finally:
            self.chan.close()

    # ---- service surface ----
    def start(self, max_batches: Optional[int] = None
              ) -> "GraphSamplerService":
        import threading
        if self._thread is not None:
            raise RuntimeError("service already started")
        if self._stop:
            raise RuntimeError(
                "service was stopped (its channel is closed) — create a "
                "new GraphSamplerService instead of restarting this one")
        self._thread = threading.Thread(
            target=self._run, args=(max_batches,), daemon=True)
        self._thread.start()
        return self

    def batches(self):
        """Drain the channel until the producer finishes/stops; raises
        the producer's error, if any."""
        from paddlebox_tpu_torch.utils.channel import ChannelClosed
        while True:
            try:
                item = self.chan.get()
            except ChannelClosed:
                break
            yield item
        if self._err is not None:
            err, self._err = self._err, None
            raise err

    def stop(self) -> None:
        self._stop = True
        self.chan.close()
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._err is not None:
            err, self._err = self._err, None
            raise err
