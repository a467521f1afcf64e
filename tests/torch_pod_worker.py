"""One rank of the multi-process CPU tests (``tests/test_torch_multihost.py``,
``test_torch_tiered_multihost.py``, ``test_torch_pod_reduce.py``,
``test_torch_launch.py``, ``test_torch_a2a_probe.py``): started by
``distributed.launch.launch_local`` with ``PBOX_TORCH_DISTRIBUTED=1``
over gloo, it forms the process group with ``init_runtime_env``, runs
one scenario and writes its results to ``<out>/rank<r>.pt``. The port
only: no JAX here.

    python tests/torch_pod_worker.py <scenario> <in.pt> <out_dir>
"""

import os
import sys

import numpy as np
import torch

from paddlebox_tpu_torch.distributed.launch import init_runtime_env


class StepRecorder:
    """A ``ShardedTrainStep`` stand-in that keeps every step's loss."""

    def __init__(self, step) -> None:
        self._step = step
        self.losses = []

    def __call__(self, *args, **kwargs):
        out = self._step(*args, **kwargs)
        self.losses.append(float(out["loss"]))
        return out

    def run_resident(self, *args, **kwargs):
        out = self._step.run_resident(*args, **kwargs)
        losses = out[0] if isinstance(out, tuple) else out
        self.losses += [float(x) for x in losses]
        return out

    def __getattr__(self, name):
        return getattr(self._step, name)


def _records(arrays):
    from paddlebox_tpu_torch.data import SlotRecord
    return [SlotRecord(k, o, d, lab, 1.0, lab) for k, o, d, lab in arrays]


def _desc(cfg):
    from paddlebox_tpu_torch.data import DataFeedDesc, SlotDef
    slots = ([SlotDef("label", "float", 1),
              SlotDef("d", "float", cfg["dense"])]
             + [SlotDef(f"S{i}", "uint64") for i in range(cfg["slots"])])
    return DataFeedDesc(slots=slots, label_slot="label",
                        batch_size=cfg["batch"], key_bucket_min=128)


def make_trainer(cfg, pod=None, table_src=None):
    """A ``ShardedTrainer`` over ``cfg``'s start state (or the save
    ``table_src``), on one controller or as this rank of ``pod``."""
    from paddlebox_tpu_torch import DeepFM
    from paddlebox_tpu_torch.config import flags_scope
    from paddlebox_tpu_torch.ps.sgd import SparseSGDConfig
    from paddlebox_tpu_torch.ps.sharded import ShardedEmbeddingTable
    from paddlebox_tpu_torch.train.sharded import ShardedTrainer

    # a pod names the rank's device itself
    where = (dict(devices=cfg.get("device", "cpu")) if pod is None
             else dict(pod=pod))
    table = ShardedEmbeddingTable(
        cfg["shards"], mf_dim=cfg["mf"], capacity_per_shard=cfg["cap"],
        cfg=SparseSGDConfig(**cfg["sgd"]), **where, **cfg["table_kw"])
    table.load(cfg["table"] if table_src is None else table_src)
    model = DeepFM(cfg["slots"], 3 + cfg["mf"], cfg["dense"],
                   hidden=cfg["hidden"], compute_dtype=torch.float32)
    model.load_state_dict(cfg["params"])
    with flags_scope(a2a_chunks=cfg["chunks"]):
        return ShardedTrainer(
            model, table, _desc(cfg),
            tx=lambda p: torch.optim.Adam(p, lr=1e-2, eps=1e-8), seed=3,
            zero1=cfg["zero1"], pod=pod)


def run_trainer(cfg, pod=None, dump_dir=None):
    """The sharded scenario of ``cfg`` on one controller (``pod`` None) or
    as this rank of the pod: two ``train_pass`` calls, an ``eval_pass``
    and the snapshot. Returns what the tests compare."""
    from paddlebox_tpu_torch import InMemoryDataset
    from paddlebox_tpu_torch.utils.dump import DumpConfig

    tr = make_trainer(cfg, pod)
    table, desc = tr.table, tr.desc
    tr.step_fn = rec = StepRecorder(tr.step_fn)
    tr.metrics.init_metric("auc", "auc")
    if dump_dir:
        tr.set_dump(DumpConfig(os.path.join(dump_dir, "dump"), interval=1))
    ds = InMemoryDataset(desc)
    ds.records = _records(cfg["arrays"])
    if cfg.get("resident"):
        # the resident pass: staged once (a rank its own shards' blocks)
        res = [tr.train_pass_resident(ds) for _ in range(2)]
    else:
        res = [tr.train_pass(ds) for _ in range(2)]
    tr.set_dump(None)
    ev = tr.eval_pass(ds)
    rows = {}
    for s in table.owned:
        keys, r = table.indexes[s].items()
        order = np.argsort(keys)
        rows[s] = (keys[order], table._rows_host(s, r[order]))
    return {"res": res, "eval": ev, "losses": rec.losses, "rows": rows,
            "params": {k: v.clone() for k, v in
                       tr.model.state_dict().items()},
            "snapshot": tr.dense_snapshot(),
            "registry": tr.metrics.get_metric_msg("auc"),
            "nbytes": None if pod is None else dict(pod.nbytes),
            "trainer": tr}


def scenario_train(cfg, out_dir, rank):
    """``run_trainer`` as this rank, then a per-process save, and a fresh
    pod trainer restored from the save set and the snapshot."""
    from paddlebox_tpu_torch.ops import kernels as K
    from paddlebox_tpu_torch.train.multihost import global_mesh
    dev = cfg.get("device", "cpu")
    # a card's rank takes the group's device (nccl: its own card)
    pod = global_mesh(cfg["shards"], device=None if dev == "cuda" else dev)
    names = ("gather_rows", "pool_cvm", "segment_gather",
             "scatter_add_update")
    for name in names:
        getattr(K, name).launches = 0
    dump_dir = os.path.join(out_dir, "dump") if cfg.get("dump") else None
    out = run_trainer(cfg, pod=pod, dump_dir=dump_dir)
    out["launches"] = {name: getattr(K, name).launches for name in names}
    out["owned"] = pod.owned
    # a per-process save (the owned shards' blocks) and, after every
    # rank wrote its file, a restore from the whole set
    tr = out.pop("trainer")
    path = os.path.join(out_dir, f"base_r{rank}.npz")
    out["saved"] = tr.table.save_base(path)
    pod.barrier()
    paths = [os.path.join(out_dir, f"base_r{r}.npz")
             for r in range(pod.world)]
    fresh = make_trainer(cfg, pod, table_src=paths)
    snap = out["snapshot"]
    fresh.restore_state(snap["model"], snap["opt"], snap["auc"],
                        tr.global_step)
    fresh.globalize_dense_state(check=True)
    out["restored_snapshot"] = fresh.dense_snapshot()
    out["restored_rows"] = {
        s: fresh.table._rows_host(s, fresh.table.indexes[s].lookup(
            out["rows"][s][0])) for s in pod.owned}
    return out


def run_probe(cfg, pod=None):
    """One ``train_pass`` of ``cfg``'s sharded trainer, then
    ``train/a2a_probe.probe_exchange`` (reps 1) on the dataset's first
    global batch; the report and, per owned shard, the logical rows
    after it, and the params."""
    from paddlebox_tpu_torch import InMemoryDataset
    from paddlebox_tpu_torch.train.a2a_probe import probe_exchange

    tr = make_trainer(cfg, pod)
    ds = InMemoryDataset(tr.desc)
    ds.records = _records(cfg["arrays"])
    tr.train_pass(ds)
    pr = probe_exchange(tr, dataset=ds, reps=1)
    rows = {}
    for s in tr.table.owned:
        keys, r = tr.table.indexes[s].items()
        order = np.argsort(keys)
        rows[s] = (keys[order], tr.table._rows_host(s, r[order]))
    return {"probe": pr, "rows": rows,
            "params": {k: v.clone() for k, v in
                       tr.model.state_dict().items()}}


def scenario_probe(cfg, out_dir, rank):
    """``run_probe`` as this rank of a pod on the CPU."""
    from paddlebox_tpu_torch.train.multihost import global_mesh
    pod = global_mesh(cfg["shards"], device="cpu")
    return dict(run_probe(cfg, pod=pod), owned=pod.owned)


def scenario_tiered(cfg, out_dir, rank):
    """Two passes over the multi-process tiered table, the host tiers'
    keys, a save per rank and ``load_reshard`` of the whole save set into
    a table of another shard count."""
    from paddlebox_tpu_torch.ps.sgd import SparseSGDConfig
    from paddlebox_tpu_torch.ps.tiered_multihost import \
        MultihostTieredShardedTable
    from paddlebox_tpu_torch.train.multihost import global_mesh
    import torch.distributed as dist

    out = {}
    pod = global_mesh(cfg["shards"], device="cpu")
    t = MultihostTieredShardedTable(
        pod, mf_dim=cfg["mf"], capacity_per_shard=cfg["cap"],
        cfg=SparseSGDConfig(**cfg["sgd"]), req_bucket_min=64,
        serve_bucket_min=64)
    out["loaded"] = t.load_reshard([cfg["table"]])
    for i, keys in enumerate(cfg["passes"]):
        t.stage(keys, background=False)
        t.begin_pass()
        # the "training": every owned window row of the pass gets a
        # key-derived value (the same on the single-process twin)
        for s in t.owned:
            ks = keys[keys % np.uint64(t.n) == np.uint64(s)]
            rows = t.indexes[s].lookup(np.unique(ks))
            vals = torch.from_numpy(np.unique(ks).astype(np.float32)
                                    * (0.001 * (i + 1)))
            t.states[s].data[torch.from_numpy(rows.astype(np.int64)), 4] = \
                vals
            t._touched[s][rows] = True
        t.end_pass()
    out["host_keys"] = {s: np.sort(t.hosts[s].index.items()[0])
                        for s in t.owned}
    out["host_rows"] = {s: t.hosts[s].export_rows(clear_touched=False)
                        for s in t.owned}
    out["feature_count"] = t.feature_count()
    out["delta"] = t.save_delta(os.path.join(cfg["work"],
                                             f"delta_r{rank}.npz"))
    save = os.path.join(cfg["work"], f"save_r{rank}.npz")
    out["saved"] = t.save_base(save)
    # the per-process lifecycle on a second table: this rank's own file,
    # a merge, a shrink and a spill, each over the owned shards only
    t3 = MultihostTieredShardedTable(
        pod, mf_dim=cfg["mf"], capacity_per_shard=cfg["cap"],
        cfg=SparseSGDConfig(**cfg["sgd"]), req_bucket_min=64,
        serve_bucket_min=64)
    out["reloaded"] = t3.load(save)
    out["reload_rows"] = {s: t3.hosts[s].export_rows(clear_touched=False)
                          for s in t3.owned}
    out["merged"] = t3.merge_model(cfg["table"])
    out["shrunk"] = t3.shrink(delete_threshold=cfg["shrink_threshold"],
                              decay=1.0)
    # only rows already saved spill (a delta clears the touched flags)
    t3.save_delta(os.path.join(cfg["work"], f"delta2_r{rank}.npz"))
    out["spilled"] = t3.spill_cold(
        os.path.join(cfg["work"], f"spill_r{rank}"), cfg["spill_threshold"])
    out["after"] = {s: t3.hosts[s].export_rows(clear_touched=False)
                    for s in t3.owned}
    dist.barrier()
    # the elastic re-shard: a 2-shard world reads the whole 4-shard set
    sub = dist.new_group([0, 1])
    pod2 = global_mesh(2, device="cpu", group=sub)
    t2 = MultihostTieredShardedTable(
        pod2, mf_dim=cfg["mf"], capacity_per_shard=cfg["cap"],
        cfg=SparseSGDConfig(**cfg["sgd"]), req_bucket_min=64,
        serve_bucket_min=64)
    paths = [os.path.join(cfg["work"], f"save_r{r}.npz")
             for r in range(pod.world)]
    out["resharded"] = t2.load_reshard(paths)
    out["reshard_rows"] = {s: t2.hosts[s].export_rows(clear_touched=False)
                           for s in t2.owned}
    out["owned"], out["owned2"] = pod.owned, pod2.owned
    return out


def scenario_reduce(cfg, out_dir, rank):
    """The pod reductions: ``metrics_ext._pod_sum_tree`` /
    ``_pod_gather_varlen`` on this rank's partials, and
    ``cross_norm_update(sync_axis=)`` on this rank's rows."""
    import torch.distributed as dist
    from paddlebox_tpu_torch import metrics_ext
    from paddlebox_tpu_torch.ops.cross_norm import (cross_norm_update,
                                                    init_cross_norm_summary)

    mine = cfg["parts"][rank]
    out = {"sum": metrics_ext._pod_sum_tree(mine["tree"]),
           "varlen": metrics_ext._pod_gather_varlen(mine["varlen"])}
    summary = init_cross_norm_summary(cfg["fields"], cfg["embed"],
                                      device="cpu")
    x = torch.from_numpy(mine["x"])
    out["cross_norm"] = tuple(cross_norm_update(
        summary, x, cfg["fields"], cfg["embed"], sync_axis=dist.group.WORLD))
    m = metrics_ext.WuAucMetric("w")
    m.add(torch.from_numpy(mine["pred"]), torch.from_numpy(mine["label"]),
          uid=mine["uid"])
    out["wuauc"] = m.compute()
    return out


SCENARIOS = {"train": scenario_train, "tiered": scenario_tiered,
             "reduce": scenario_reduce, "probe": scenario_probe}

WORKER = os.path.abspath(__file__)
REPO = os.path.dirname(os.path.dirname(WORKER))


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch_pod(scenario: str, cfg: dict, work, monkeypatch, nproc: int = 2,
               timeout: float = 120.0, backend: str = "gloo") -> list:
    """Run ``scenario`` as ``nproc`` ranks over ``backend`` through the
    port's ``launch_local`` (each rank stopped past ``timeout``); returns
    each rank's results, rank order."""
    from paddlebox_tpu_torch.distributed.launch import (LaunchConfig,
                                                        launch_local)
    work = str(work)
    cfg_path = os.path.join(work, f"{scenario}_cfg.pt")
    out_dir = os.path.join(work, f"{scenario}_out")
    os.makedirs(out_dir, exist_ok=True)
    torch.save(cfg, cfg_path)
    monkeypatch.setenv("PYTHONPATH", REPO + os.pathsep
                       + os.environ.get("PYTHONPATH", ""))
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    rc = launch_local(
        [sys.executable, WORKER, scenario, cfg_path, out_dir],
        LaunchConfig(nproc=nproc, coordinator=f"127.0.0.1:{free_port()}",
                     distributed=True, backend=backend, timeout_sec=timeout,
                     stop_grace_sec=2.0))
    assert rc == 0, f"{scenario}: the ranks exited {rc}"
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                       weights_only=False) for r in range(nproc)]


def main() -> int:
    scenario, cfg_path, out_dir = sys.argv[1:4]
    torch.set_num_threads(1)
    cfg = torch.load(cfg_path, weights_only=False)
    if cfg.get("device", "cpu") == "cuda":
        # the card's runs repeat bit for bit only in this mode
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.use_deterministic_algorithms(True)
    info = init_runtime_env()
    rank = info["rank"]
    out = SCENARIOS[scenario](cfg, out_dir, rank)
    out["backend"] = info["backend"]
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    import torch.distributed as dist
    dist.barrier()
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
