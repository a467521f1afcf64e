"""The pod reductions and the multi-process helpers on the CPU.

- ``metrics_ext._pod_sum_tree`` / ``_pod_gather_varlen`` and a
  ``WuAucMetric`` across two rank processes over gloo
  (``tests/torch_pod_worker.py``, scenario ``reduce``): exact for
  int64 / uint64 / float64 (the 64-bit transport), equal to the JAX
  package's single-controller result over the concatenated inputs.
- ``cross_norm_update(sync_axis=group)`` on two ranks against the JAX
  ``cross_norm_update(sync_axis=...)`` under ``shard_map`` on two CPU
  devices (rtol 1e-6).
- ``train/multihost``: ``make_straggler_watchdog`` in a single process
  (``tests/test_obs.py::test_make_straggler_watchdog_single_process``),
  ``ElasticStreamRunner`` with a scripted controller (the digest after
  a re-shard equals the boundary digest), the flags, and ``global_mesh``
  on the card by default.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from paddlebox_tpu import metrics_ext as j_metrics_ext
from paddlebox_tpu.config import Flags as JFlags
from paddlebox_tpu.ops.cross_norm import cross_norm_update as j_update
from paddlebox_tpu.ops.cross_norm import init_cross_norm_summary as j_init

from paddlebox_tpu_torch.config import Flags
from paddlebox_tpu_torch.obs.watchdog import (DirHeartbeatStore,
                                              LocalHeartbeatStore)
from paddlebox_tpu_torch.train import multihost

from torch_pod_worker import free_port, launch_pod

FIELDS, EMBED = 2, 4


def _parts():
    rng = np.random.default_rng(9)
    parts = []
    for r, n in enumerate((5, 3)):
        parts.append({
            "tree": {
                "i64": rng.integers(2 ** 61, 2 ** 62, size=4, dtype=np.int64),
                "u64": rng.integers(2 ** 62, 2 ** 63, size=4,
                                    dtype=np.uint64),
                "f64": (1e17 + rng.random(4)).astype(np.float64),
                "f32": rng.random(3).astype(np.float32),
                "auc": (rng.random((2, 6)).astype(np.float32),
                        torch.from_numpy(rng.random(5))),
            },
            "varlen": [rng.integers(2 ** 60, 2 ** 63, size=n,
                                    dtype=np.int64),
                       rng.random(n), rng.integers(0, 2, size=n) * 1.0],
            "x": rng.normal(size=(4, 2 * FIELDS * EMBED)).astype(np.float32),
            "pred": rng.random(6).astype(np.float32),
            "label": (rng.random(6) < 0.5).astype(np.float32),
            "uid": rng.integers(0, 3, size=6).astype(np.int64) + 2 ** 40,
        })
    return parts


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    try:
        cfg = dict(parts=_parts(), fields=FIELDS, embed=EMBED)
        return launch_pod("reduce", cfg, tmp_path_factory.mktemp("reduce"),
                          mp)
    finally:
        mp.undo()


def test_pod_sum_tree_is_exact_for_64_bit_dtypes(ranks):
    parts = _parts()
    for k in ("i64", "u64", "f64", "f32"):
        want = parts[0]["tree"][k] + parts[1]["tree"][k]
        # the JAX single controller over the summed partials
        jax_want = j_metrics_ext._pod_sum_tree(want)
        for r in ranks:
            got = r["sum"][k]
            assert got.dtype == want.dtype, k
            np.testing.assert_array_equal(got, want, err_msg=k)
            np.testing.assert_array_equal(got, jax_want, err_msg=k)
    for r in ranks:
        a, t = r["sum"]["auc"]
        np.testing.assert_array_equal(
            a, parts[0]["tree"]["auc"][0] + parts[1]["tree"]["auc"][0])
        assert torch.is_tensor(t) and t.dtype == torch.float64
        assert torch.equal(t, parts[0]["tree"]["auc"][1]
                           + parts[1]["tree"]["auc"][1])


def test_pod_gather_varlen_concatenates_in_rank_order(ranks):
    parts = _parts()
    want = [np.concatenate([p["varlen"][i] for p in parts])
            for i in range(3)]
    jax_want = j_metrics_ext._pod_gather_varlen(want)
    for r in ranks:
        for g, w, jw in zip(r["varlen"], want, jax_want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
            np.testing.assert_array_equal(g, jw)


def test_wuauc_over_both_ranks_equals_the_whole(ranks):
    parts = _parts()
    m = j_metrics_ext.WuAucMetric("w")
    m.add(np.concatenate([p["pred"] for p in parts]),
          np.concatenate([p["label"] for p in parts]),
          uid=np.concatenate([p["uid"] for p in parts]))
    want = m.compute()
    for r in ranks:
        assert r["wuauc"] == pytest.approx(want, rel=0, abs=1e-12)
        assert r["wuauc"]["ins_num"] == 12.0


def test_cross_norm_sync_matches_jax_shard_map(ranks):
    parts = _parts()
    xg = np.concatenate([p["x"] for p in parts])
    mesh = Mesh(np.array(jax.devices()[:2]), ("data",))
    summ = j_init(FIELDS, EMBED)

    def upd(x_blk):
        return j_update(summ, x_blk, FIELDS, EMBED, sync_axis="data")

    f = jax.jit(jax.shard_map(upd, mesh=mesh, in_specs=P("data"),
                              out_specs=P(), check_vma=False))
    want = f(jnp.asarray(xg))
    for r in ranks:
        assert len(r["cross_norm"]) == len(want)
        for got, w in zip(r["cross_norm"], want):
            np.testing.assert_allclose(got.numpy(), np.asarray(w),
                                       rtol=1e-6, atol=0)
    # the two ranks fold the same global stats: identical summaries
    for a, b in zip(ranks[0]["cross_norm"], ranks[1]["cross_norm"]):
        assert torch.equal(a, b)


def test_multihost_flags_match_the_reference():
    for name in ("straggler_heartbeat_dir", "straggler_step_lag",
                 "straggler_timeout_sec", "straggler_abort_sec",
                 "restore_consensus_dir", "elastic_dir", "elastic_ttl_sec",
                 "elastic_dead_checks"):
        assert getattr(Flags(), name) == getattr(JFlags(), name), name


def test_make_straggler_watchdog_single_process(tmp_path):
    wd = multihost.make_straggler_watchdog(start=False)
    assert isinstance(wd.store, LocalHeartbeatStore)
    wd2 = multihost.make_straggler_watchdog(
        heartbeat_dir=str(tmp_path / "hb"), start=False)
    assert isinstance(wd2.store, DirHeartbeatStore)
    wd2.beat(5)
    assert wd2.store.read()[wd2.process_index][0] == 5
    with pytest.raises(ValueError, match="SHARED"):
        multihost.make_elastic_manager("job")
    with pytest.raises(ValueError, match="SHARED"):
        multihost.make_restore_consensus()
    m = multihost.make_elastic_manager("job", elastic_dir=str(tmp_path / "e"))
    assert (m.host, m.np) == ("host0", 1)
    c = multihost.make_restore_consensus(str(tmp_path / "c"))
    assert (c.process_index, c.num_processes) == (0, 1)


class Scripted:
    """A controller replaying boundary → decision, no detection."""

    def __init__(self, decisions):
        self.decisions = decisions
        self.window = -1
        self.reshards = []

    def publish(self, path, pass_id):
        self.window = pass_id

    def poll(self):
        return self.decisions.get(self.window)

    def agree_boundary(self, local_step, survivors=None):
        return local_step

    def note_reshard(self, old_np, new_np, step=-1):
        self.reshards.append((old_np, new_np, step))


def test_elastic_stream_runner_reshards_losslessly(tmp_path):
    """2 hosts → 1 → 2 at boundaries 0 and 1 (2 shards a host): each
    re-shard's digest after the re-import equals its boundary digest,
    and the world follows the schedule."""
    from paddlebox_tpu_torch import CheckpointManager, DeepFM
    from paddlebox_tpu_torch.ps.sgd import SparseSGDConfig
    from paddlebox_tpu_torch.ps.sharded import ShardedEmbeddingTable
    from paddlebox_tpu_torch.train.sharded import ShardedTrainer
    from test_torch_sharded import (DENSE, MF, S, _arrays, _datasets,
                                    _descs)

    _, desc = _descs()
    windows = [_datasets(_arrays(96, seed=40 + w))[1] for w in range(3)]
    root = str(tmp_path / "ckpt")

    def make_world(np_hosts):
        table = ShardedEmbeddingTable(
            2 * np_hosts, mf_dim=MF, capacity_per_shard=2048,
            cfg=SparseSGDConfig(mf_create_thresholds=0.0,
                                mf_initial_range=0.0),
            devices="cpu", req_bucket_min=64, serve_bucket_min=128)
        torch.manual_seed(4)
        model = DeepFM(S, 3 + MF, DENSE, hidden=(8,),
                       compute_dtype=torch.float32)
        return (ShardedTrainer(model, table, desc,
                               tx=lambda p: torch.optim.Adam(p, lr=1e-2)),
                CheckpointManager(root, keep=10))

    ctl = Scripted({0: {"np": 1, "lost": ["h1"]},
                    1: {"np": 2, "joined": ["h1"]}})
    recs = multihost.ElasticStreamRunner(
        make_world, lambda w: windows[w], 3, controller=ctl).run(2)
    assert [r["np"] for r in recs] == [2, 1, 2]
    for w in (0, 1):
        rs = recs[w]["reshard"]
        assert rs["digest_after"] == recs[w]["digest"]
        assert rs["agreed_step"] == recs[w]["step"]
    assert "reshard" not in recs[2]
    assert [x[:2] for x in ctl.reshards] == [(2, 1), (1, 2)]


def test_global_mesh_defaults_to_the_card(monkeypatch):
    """A pod's device is the card unless the caller asks for the CPU: a
    world of one on a host without a card raises."""
    with pytest.raises(RuntimeError, match="process group"):
        multihost.global_mesh(4)
    dist.init_process_group("gloo",
                            init_method=f"tcp://127.0.0.1:{free_port()}",
                            world_size=1, rank=0)
    try:
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            multihost.global_mesh(4)
        pod = multihost.global_mesh(4, device="cpu")
        assert (pod.owned, pod.staged, pod.backend) == (
            [0, 1, 2, 3], False, "gloo")
        # the staging helpers: each owned row of a stacked host array on
        # its shard's device, or the whole array replicated
        arr = np.arange(12, dtype=np.float32).reshape(4, 3)
        rows = multihost.stage_global(pod, arr)
        assert [r.tolist() for r in rows] == arr.tolist()
        assert torch.equal(multihost.stage_global(pod, arr,
                                                  shard_dim0=False),
                           torch.from_numpy(arr))
        model = torch.nn.Linear(3, 2)
        want = {k: v.clone() for k, v in model.state_dict().items()}
        multihost.globalize_state(pod, model)
        multihost.globalize_state(pod, model, check=True)
        for k, v in model.state_dict().items():
            assert torch.equal(v, want[k]), k
        # a pod names the table's devices: a second list is refused
        from paddlebox_tpu_torch.ps.sharded import ShardedEmbeddingTable
        with pytest.raises(ValueError, match="pod"):
            ShardedEmbeddingTable(4, mf_dim=4, capacity_per_shard=16,
                                  devices="cpu", pod=pod)
        t = ShardedEmbeddingTable(4, mf_dim=4, capacity_per_shard=16,
                                  pod=pod)
        assert t.owned == [0, 1, 2, 3]
        assert all(st.data.device.type == "cpu" for st in t.states)
    finally:
        dist.destroy_process_group()
