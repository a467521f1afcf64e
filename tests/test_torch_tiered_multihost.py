"""The multi-process tiered table (``ps/tiered_multihost.py``) on the CPU.

- One process owning every shard (a gloo process group of one) equals
  the plain ``TieredShardedEmbeddingTable`` bit for bit through two
  ``BoxPSHelper`` passes of a pod ``ShardedTrainer`` (the reference's
  ``tests/test_tiered_multihost.py::
  test_multihost_tiered_single_process_matches_plain``), and
  ``load_reshard`` takes a 4-shard save into 2 shards
  (``tests/test_elastic.py::test_tiered_multihost_load_reshard``), as the
  JAX table does the same save.
- Two rank processes over gloo (``tests/torch_pod_worker.py``, scenario
  ``tiered``): each rank's host tier holds exactly its owned shards' keys,
  the passes' write-backs equal a single-process plain tiered table's,
  and the two ranks' per-process saves re-shard into a 2-shard world.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from paddlebox_tpu.parallel import make_mesh
from paddlebox_tpu.ps import SparseSGDConfig as JCfg
from paddlebox_tpu.ps.tiered_multihost import \
    MultihostTieredShardedTable as JMultihost

from paddlebox_tpu_torch import DeepFM
from paddlebox_tpu_torch.ps.box_helper import BoxPSHelper
from paddlebox_tpu_torch.ps.sgd import SparseSGDConfig
from paddlebox_tpu_torch.ps.tiered import TieredShardedEmbeddingTable
from paddlebox_tpu_torch.ps.tiered_multihost import \
    MultihostTieredShardedTable
from paddlebox_tpu_torch.train.multihost import global_mesh
from paddlebox_tpu_torch.train.sharded import ShardedTrainer

from test_torch_multihost import _synth_blob
from test_torch_sharded import (BS, CFG, DENSE, MF, S, _arrays, _base_blob,
                                _datasets, _descs)
from torch_pod_worker import free_port, launch_pod

N = 4
CAP = 1024


@pytest.fixture
def world_of_one():
    """A gloo process group of one in this process, for the test."""
    dist.init_process_group("gloo",
                            init_method=f"tcp://127.0.0.1:{free_port()}",
                            world_size=1, rank=0)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _host_rows(t, s):
    keys, fields = t.hosts[s].export_rows(clear_touched=False)
    order = np.argsort(keys)
    return keys[order], {f: v[order] for f, v in fields.items()}


def _assert_hosts_equal(a, b, shards):
    for s in shards:
        ka, fa = _host_rows(a, s)
        kb, fb = _host_rows(b, s)
        np.testing.assert_array_equal(ka, kb)
        assert set(fa) == set(fb)
        for f in fa:
            np.testing.assert_array_equal(fa[f], fb[f], err_msg=f)


def test_single_process_matches_plain(world_of_one):
    """Owned = every shard: the same AUC, params and host tiers as the
    plain tiered table, bit for bit, and the same staged counts."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        pod = global_mesh(N, device="cpu")
        assert pod.owned == list(range(N)) and pod.world == 1
        _, tds = _datasets(_arrays(BS * 8, seed=31))
        _, desc = _descs()
        base = _base_blob(seed=7)
        cfg = dict(CFG, learning_rate=0.1, mf_learning_rate=0.1)
        kw = dict(mf_dim=MF, capacity_per_shard=CAP,
                  cfg=SparseSGDConfig(**cfg), req_bucket_min=64,
                  serve_bucket_min=128)
        ta = TieredShardedEmbeddingTable(N, devices="cpu", **kw)
        tb = MultihostTieredShardedTable(pod, **kw)
        runs = []
        ta.load(base)
        # a single-table base is a foreign save for the per-process load
        tb.load_reshard([base])
        for t, p in ((ta, None), (tb, pod)):
            torch.manual_seed(11)
            model = DeepFM(S, 3 + MF, DENSE, hidden=(16, 16),
                           compute_dtype=torch.float32)
            tr = ShardedTrainer(
                model, t, desc,
                tx=lambda q: torch.optim.Adam(q, lr=2e-3), seed=5, pod=p)
            helper = BoxPSHelper(t, trainer=tr)
            res = None
            for _ in range(2):
                helper.begin_pass(tds)
                res = tr.train_pass(tds)
                helper.end_pass(tds)
            runs.append((tr, res))
        (tra, ra), (trb, rb) = runs
        assert rb["ins_num"] == ra["ins_num"]
        assert rb["auc"] == ra["auc"]
        for x, y in zip(tra.model.parameters(), trb.model.parameters()):
            assert torch.equal(x, y)
        _assert_hosts_equal(ta, tb, range(N))
        assert tb.feature_count() == ta.feature_count()
        # delta staging engaged on pass 2 identically
        assert tb.last_pass_stats["resident"] > 0
        assert tb.last_pass_stats["staged"] == ta.last_pass_stats["staged"]
    finally:
        torch.set_num_threads(threads)


def test_load_reshard_four_to_two(world_of_one, tmp_path):
    """A 4-shard save epoch re-imports into 2 shards: every row on its
    key % 2 owner, the junk a shard held before wiped, the values bit
    for bit; the JAX table does the same save alike."""
    cfg = dict(mf_create_thresholds=0.0, mf_initial_range=0.0)

    def mk(n):
        return MultihostTieredShardedTable(
            global_mesh(n, device="cpu"), mf_dim=4, capacity_per_shard=256,
            cfg=SparseSGDConfig(**cfg), req_bucket_min=64,
            serve_bucket_min=64)

    keys = np.arange(1, 97, dtype=np.uint64)
    src = str(tmp_path / "src.npz")
    np.savez(src, **_synth_blob(keys))
    t4 = mk(4)
    assert t4.load_reshard([src]) == len(keys)
    saved = str(tmp_path / "epoch4.npz")
    assert t4.save_base(saved) == len(keys)
    t2 = mk(2)
    junk = _synth_blob(np.array([999], np.uint64))
    t2.hosts[0].import_rows(junk["keys"], {f: v for f, v in junk.items()
                                           if f != "keys"})
    assert t2.load_reshard([saved]) == len(keys)
    want = {}
    for s in range(4):
        ks, f = _host_rows(t4, s)
        for i, k in enumerate(ks):
            want[int(k)] = f["embed_w"][i].tobytes()
    have = {}
    for s in range(2):
        ks, f = _host_rows(t2, s)
        assert (ks % np.uint64(2) == np.uint64(s)).all()
        for i, k in enumerate(ks):
            have[int(k)] = f["embed_w"][i].tobytes()
    assert have == want
    # the reference's table over the same save
    j2 = JMultihost(make_mesh(2), mf_dim=4, capacity_per_shard=256,
                    cfg=JCfg(**cfg), req_bucket_min=64, serve_bucket_min=64)
    assert j2.load_reshard([saved]) == len(keys)
    for s in range(2):
        jk, _ = j2.hosts[s].index.items()
        jk = np.sort(jk)
        np.testing.assert_array_equal(jk, _host_rows(t2, s)[0])
        np.testing.assert_array_equal(j2.hosts[s].fetch(jk)["embed_w"],
                                      _host_rows(t2, s)[1]["embed_w"])


def test_two_ranks_own_disjoint_host_tiers(tmp_path, monkeypatch):
    """Two ranks, 2 of 4 shards each: each host tier holds exactly its
    shards' keys and the plain single-process table's rows after the
    same two passes; the per-process saves re-shard into 2 shards."""
    rng = np.random.default_rng(3)
    keys = np.unique(rng.integers(1, 4000, size=900).astype(np.uint64))
    base = _synth_blob(keys[:500])
    passes = [np.unique(rng.choice(keys, 300)) for _ in range(2)]
    cfg = dict(shards=N, mf=4, cap=512, sgd=dict(mf_create_thresholds=0.0,
                                                mf_initial_range=0.0),
               table=base, passes=passes, work=str(tmp_path),
               shrink_threshold=0.05, spill_threshold=0.5)
    ranks = launch_pod("tiered", cfg, tmp_path, monkeypatch)

    # the single-process twin: the plain tiered table, the same passes
    plain = TieredShardedEmbeddingTable(
        N, mf_dim=4, capacity_per_shard=512,
        cfg=SparseSGDConfig(**cfg["sgd"]), req_bucket_min=64,
        serve_bucket_min=64, devices="cpu")
    plain.load(base)
    for i, ks in enumerate(passes):
        plain.stage(ks, background=False)
        plain.begin_pass()
        for s in range(N):
            mine = np.unique(ks[ks % np.uint64(N) == np.uint64(s)])
            rows = plain.indexes[s].lookup(mine)
            plain.states[s].data[torch.from_numpy(rows.astype(np.int64)),
                                 4] = torch.from_numpy(
                mine.astype(np.float32) * (0.001 * (i + 1)))
            plain._touched[s][rows] = True
        plain.end_pass()

    seen = set()
    for r, out in enumerate(ranks):
        assert out["owned"] == [2 * r, 2 * r + 1]
        assert out["loaded"] == sum(
            int((base["keys"] % np.uint64(N) == np.uint64(s)).sum())
            for s in out["owned"])
        assert out["feature_count"] == sum(len(v) for v in
                                           out["host_keys"].values())
        for s in out["owned"]:
            hk = out["host_keys"][s]
            assert (hk % np.uint64(N) == np.uint64(s)).all()
            assert not (set(hk.tolist()) & seen)
            seen |= set(hk.tolist())
            pk, pf = _host_rows(plain, s)
            k, f = out["host_rows"][s]
            order = np.argsort(k)
            np.testing.assert_array_equal(k[order], pk)
            for name in pf:
                np.testing.assert_array_equal(f[name][order], pf[name],
                                              err_msg=name)
    assert seen == set(np.concatenate([base["keys"]] + passes).tolist())
    assert sum(o["saved"] for o in ranks) == len(seen)
    # the 2-shard world from both ranks' files: every key on key % 2
    got = {}
    for r, out in enumerate(ranks):
        assert out["owned2"] == [r]
        k, f = out["reshard_rows"][r]
        assert (k % np.uint64(2) == np.uint64(r)).all()
        for i, key in enumerate(k):
            got[int(key)] = f["embed_w"][i].tobytes()
    want = {}
    for s in range(N):
        pk, pf = _host_rows(plain, s)
        for i, key in enumerate(pk):
            want[int(key)] = pf["embed_w"][i].tobytes()
    assert got == want
    # the per-process lifecycle against the plain table's, shard by shard
    assert sum(o["delta"] for o in ranks) == plain.save_delta(
        str(tmp_path / "plain_delta.npz"))
    plain.save_base(str(tmp_path / "plain_base.npz"))
    for out in ranks:
        assert out["reloaded"] == out["saved"]
        for s in out["owned"]:
            k, f = out["reload_rows"][s]
            pk, pf = _host_rows(plain, s)
            order = np.argsort(k)
            np.testing.assert_array_equal(k[order], pk)
            for name in pf:
                np.testing.assert_array_equal(f[name][order], pf[name])
    assert sum(o["merged"] for o in ranks) == plain.merge_model(base)
    assert sum(o["shrunk"] for o in ranks) == plain.shrink(
        delete_threshold=cfg["shrink_threshold"], decay=1.0)
    plain.save_delta(str(tmp_path / "plain_delta2.npz"))
    assert sum(o["spilled"] for o in ranks) == plain.spill_cold(
        str(tmp_path / "plain_spill"), cfg["spill_threshold"])
    assert sum(o["shrunk"] for o in ranks) > 0
    assert sum(o["spilled"] for o in ranks) > 0
    for out in ranks:
        for s in out["owned"]:
            k, f = out["after"][s]
            pk, pf = _host_rows(plain, s)
            order = np.argsort(k)
            np.testing.assert_array_equal(k[order], pk)
            for name in pf:
                np.testing.assert_array_equal(f[name][order], pf[name])
