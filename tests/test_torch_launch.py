"""The port's launcher (``distributed/launch.py``) against the reference's
``tests/test_distributed_launch.py`` cases: ranks stamped into the env,
an elastic gang restart that resumes from the published checkpoint
pointer, and the port's additions: the explicit backend rule, the
process-group bootstrap, and a gang stopped at its time limit."""

import os
import sys

import pytest
import torch

from paddlebox_tpu.distributed.launch import LaunchConfig as JLaunchConfig
from paddlebox_tpu.distributed.launch import launch_local as j_launch_local

from paddlebox_tpu_torch.distributed.elastic import (ElasticManager,
                                                     FileKVStore)
from paddlebox_tpu_torch.distributed.launch import (TIMEOUT_EXIT,
                                                    LaunchConfig,
                                                    choose_backend,
                                                    init_runtime_env,
                                                    launch_local, main)

RANK_CODE = (
    "import os, pathlib; "
    "pathlib.Path(os.environ['OUT'], os.environ['PBOX_RANK'])"
    ".write_text(os.environ['PBOX_WORLD_SIZE'] + ' ' "
    "+ os.environ.get('PBOX_BACKEND', '-') + ' ' "
    "+ os.environ.get('PBOX_TORCH_DISTRIBUTED', '0'))"
)


@pytest.mark.parametrize("launch", [launch_local, j_launch_local],
                         ids=["port", "jax"])
def test_launch_local_ranks(launch, tmp_path, monkeypatch):
    """Three ranks, each stamped with its rank and the world size, in
    both packages' launchers (a host-only job: no backend exported)."""
    out = tmp_path / "ranks"
    out.mkdir()
    monkeypatch.setenv("OUT", str(out))
    cfg = (LaunchConfig if launch is launch_local else JLaunchConfig)(nproc=3)
    assert launch([sys.executable, "-c", RANK_CODE], cfg) == 0
    assert sorted(os.listdir(out)) == ["0", "1", "2"]
    assert (out / "0").read_text() == "3 - 0"


def test_launch_exports_the_backend_when_distributed(tmp_path, monkeypatch):
    out = tmp_path / "ranks"
    out.mkdir()
    monkeypatch.setenv("OUT", str(out))
    rc = launch_local([sys.executable, "-c", RANK_CODE],
                      LaunchConfig(nproc=2, distributed=True,
                                   backend="gloo"))
    assert rc == 0
    assert (out / "1").read_text() == "2 gloo 1"
    with pytest.raises(ValueError, match="backend"):
        launch_local([sys.executable, "-c", "pass"],
                     LaunchConfig(distributed=True, backend="mpi"))


def test_launch_elastic_restart_resumes_from_checkpoint(tmp_path,
                                                        monkeypatch):
    """The first gang run fails; the launcher restarts it with the
    published checkpoint path in PBOX_RESUME_CKPT; the second succeeds."""
    kvroot = tmp_path / "kv"
    marker = tmp_path / "attempts"
    marker.mkdir()
    boot = ElasticManager(FileKVStore(str(kvroot)), "jobL", "seed", np=1)
    boot.publish_checkpoint(str(tmp_path / "ckpt_pass3"), pass_id=3)
    code = (
        "import os, pathlib, sys\n"
        "d = pathlib.Path(os.environ['MARK'])\n"
        "n = len(list(d.iterdir()))\n"
        "(d / str(n)).write_text(os.environ.get('PBOX_RESUME_CKPT', ''))\n"
        "sys.exit(1 if n == 0 else 0)\n"
    )
    monkeypatch.setenv("MARK", str(marker))
    rc = launch_local([sys.executable, "-c", code],
                      LaunchConfig(nproc=1, job_id="jobL",
                                   elastic_root=str(kvroot), max_restarts=2))
    assert rc == 0
    assert sorted(os.listdir(marker)) == ["0", "1"]
    # both attempts saw the checkpoint pointer
    assert (marker / "0").read_text().endswith("ckpt_pass3")
    assert (marker / "1").read_text().endswith("ckpt_pass3")


def test_a_failed_rank_fails_the_gang_and_a_hung_one_times_out(tmp_path):
    code = ("import os, sys, time\n"
            "if os.environ['PBOX_RANK'] == '1':\n"
            "    sys.exit(3)\n"
            "time.sleep(60)\n")
    assert launch_local([sys.executable, "-c", code],
                        LaunchConfig(nproc=2, stop_grace_sec=1.0)) == 3
    rc = launch_local([sys.executable, "-c", "import time; time.sleep(60)"],
                      LaunchConfig(nproc=2, timeout_sec=1.0,
                                   stop_grace_sec=1.0))
    assert rc == TIMEOUT_EXIT


def test_backend_rule_and_bootstrap(monkeypatch):
    """nccl only when every local rank has a card of its own; a worker
    without ``PBOX_TORCH_DISTRIBUTED=1`` forms no group, and one with it
    but without ``PBOX_BACKEND`` refuses to guess."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert choose_backend(1) == "nccl"
    assert choose_backend(2) == "gloo"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert choose_backend(1) == "gloo"
    monkeypatch.setenv("PBOX_RANK", "1")
    monkeypatch.setenv("PBOX_WORLD_SIZE", "2")
    monkeypatch.delenv("PBOX_TORCH_DISTRIBUTED", raising=False)
    assert init_runtime_env() == {"rank": 1, "world_size": 2,
                                  "backend": None}
    monkeypatch.setenv("PBOX_TORCH_DISTRIBUTED", "1")
    monkeypatch.delenv("PBOX_BACKEND", raising=False)
    with pytest.raises(RuntimeError, match="PBOX_BACKEND"):
        init_runtime_env()
    monkeypatch.setenv("PBOX_BACKEND", "mpi")
    with pytest.raises(ValueError, match="backend"):
        init_runtime_env()


def test_main_runs_the_worker_command(tmp_path, monkeypatch):
    out = tmp_path / "ranks"
    out.mkdir()
    monkeypatch.setenv("OUT", str(out))
    assert main(["--nproc", "2", "--", sys.executable, "-c",
                 RANK_CODE]) == 0
    assert sorted(os.listdir(out)) == ["0", "1"]
    assert (out / "1").read_text() == "2 - 0"
    # --distributed: the launcher picks the backend by its rule for two
    # local ranks and exports it
    assert main(["--nproc", "2", "--distributed", "--", sys.executable,
                 "-c", RANK_CODE]) == 0
    assert (out / "1").read_text() == f"2 {choose_backend(2)} 1"


ELASTIC_WORKER = """
import json, os, pathlib, sys
import numpy as np
import torch
torch.set_num_threads(1)

from paddlebox_tpu_torch.config import FLAGS
from paddlebox_tpu_torch.data import DataFeedDesc, DatasetFactory
from paddlebox_tpu_torch.data.criteo import generate_criteo_files
from paddlebox_tpu_torch.distributed import ElasticManager, TcpKVStore
from paddlebox_tpu_torch.models import DeepFM
from paddlebox_tpu_torch.ps import (BoxPSHelper, ShardedEmbeddingTable,
                                    SparseSGDConfig,
                                    TieredShardedEmbeddingTable)
from paddlebox_tpu_torch.train.checkpoint import CheckpointManager
from paddlebox_tpu_torch.train.sharded import ShardedTrainer

rank = int(os.environ["PBOX_RANK"])
table_kind = os.environ.get("TABLE_KIND", "sharded")
world = int(os.environ["PBOX_WORLD_SIZE"])
out_dir = pathlib.Path(sys.argv[1])
n_passes = int(os.environ["N_PASSES"])
kill_after = os.environ.get("KILL_RANK1_AFTER_PASS")
resume = os.environ.get("PBOX_RESUME_CKPT")
FLAGS.log_period_steps = 10 ** 9

# membership over the network KV; checkpoint pointers publish to the
# launcher's job id ("jobE"), where launch_local reads the restart pointer
kv = TcpKVStore(os.environ["KV_ENDPOINT"])
em = ElasticManager(kv, "jobE-workers", f"host{rank}", np=world,
                    min_np=world, ttl=5.0)
pub = ElasticManager(kv, "jobE", f"pub{rank}", np=1)  # not registered
em.register()
em.wait_for_np(timeout=60)

data_dir = out_dir / f"data_r{rank}"
files = generate_criteo_files(str(data_dir), num_files=1,
                              rows_per_file=600, vocab_per_slot=30,
                              seed=100 + rank)
desc = DataFeedDesc.criteo(batch_size=32)
desc.key_bucket_min = 1024
ds = DatasetFactory().create_dataset("InMemoryDataset", desc)
ds.set_filelist(files)
ds.load_into_memory()

MESH_N = 4
cfg = SparseSGDConfig(mf_create_thresholds=0.0, mf_initial_range=0.0,
                      learning_rate=0.1, mf_learning_rate=0.1)
kw = dict(mf_dim=4, capacity_per_shard=4096, cfg=cfg, req_bucket_min=128,
          serve_bucket_min=128, devices=["cpu"] * MESH_N)
if table_kind == "tiered":
    # per-process host stores fronting the pass windows: a replacement
    # rank has EMPTY stores and rebuilds them from the base + delta chain
    table = TieredShardedEmbeddingTable(MESH_N, **kw)
else:
    table = ShardedEmbeddingTable(MESH_N, **kw)
torch.manual_seed(7 + rank)
model = DeepFM(26, 3 + 4, 13, hidden=(16, 16))
tr = ShardedTrainer(model, table, desc, seed=7 + rank,
                    tx=lambda p: torch.optim.Adam(p, lr=2e-3))
helper = BoxPSHelper(table, trainer=tr) if table_kind == "tiered" else None
nb_per_pass = sum(1 for _ in tr._group_iter(ds.batches()))

cm = CheckpointManager(str(out_dir / f"ckpt_r{rank}"), keep=10)
start_pass = 0
if resume:
    restored = cm.restore(tr)
    if restored is not None:
        start_pass = restored // nb_per_pass
        print(f"rank {rank}: resumed step {restored} -> pass {start_pass}",
              flush=True)

res = None
for p in range(start_pass, n_passes):
    if helper is not None:
        helper.begin_pass(ds)
    res = tr.train_pass(ds)
    if helper is not None:
        helper.end_pass(ds)
    if kill_after is not None and resume is None and rank == 1 \\
            and p == int(kill_after):
        # die WITHOUT checkpointing this pass, once rank 0 has published
        # a pointer (else the restart sees none and dies again)
        import time as _time
        deadline = _time.time() + 120
        reader = ElasticManager(kv, "jobE", f"rd{rank}", np=1)
        while _time.time() < deadline \\
                and reader.latest_checkpoint() is None:
            _time.sleep(0.2)
        os._exit(1)
    cm.save(tr, delta=(table_kind == "tiered" and p > 0))
    if rank == 0:
        pub.publish_checkpoint(str(out_dir), pass_id=p)

if res is not None:
    params = torch.cat([q.detach().reshape(-1)
                        for q in tr.model.parameters()]).numpy()
    out = dict(rank=rank, auc=float(res["auc"]),
               last_loss=float(res["last_loss"]),
               global_step=int(tr.global_step),
               param_sum=float(np.abs(params).sum()),
               features=int(table.feature_count()))
    if table_kind == "tiered":
        hsum = 0.0
        for hs in table.hosts:
            ks, _ = hs.index.items()
            if len(ks):
                hsum += float(np.abs(
                    hs.fetch(np.sort(ks))["embed_w"]).sum())
        out["host_sum"] = hsum
    with open(out_dir / f"final_r{rank}.json", "w") as fh:
        json.dump(out, fh)
    np.save(out_dir / f"params_r{rank}.npy", params)
else:
    # this rank had finished before a peer-triggered gang restart: its
    # final artifacts are on disk from the first attempt
    assert (out_dir / f"final_r{rank}.json").exists()
em.deregister()
"""


@pytest.mark.slow
@pytest.mark.parametrize("table_kind", ["sharded", "tiered"])
def test_elastic_restart_of_real_sharded_trainer(tmp_path, monkeypatch,
                                                 table_kind):
    """The reference's gang restart of real sharded trainers
    (``tests/test_distributed_launch.py``) on the port: a gang of 2 ranks,
    each its own ``ShardedTrainer`` over 4 CPU shards with its own
    ``CheckpointManager``, membership over the port's ``TcpKVStore``.
    Rank 1 dies after pass 1 without saving it; the launcher restarts the
    gang from the published pointer; both ranks resume at their last pass
    boundary, and the final AUC, loss, params (and, tiered, the host
    tiers rebuilt from the base + delta chain) match an uninterrupted
    run."""
    import json

    import numpy as np

    from paddlebox_tpu_torch.distributed import KVServer

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    worker = tmp_path / "worker.py"
    worker.write_text(ELASTIC_WORKER)
    monkeypatch.setenv("PBOX_WORLD_SIZE", "2")
    monkeypatch.setenv("N_PASSES", "4")
    monkeypatch.setenv("TABLE_KIND", table_kind)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setenv("PYTHONPATH", repo + os.pathsep
                       + os.environ.get("PYTHONPATH", ""))

    def run(out_dir, kill: bool) -> int:
        out_dir.mkdir()
        srv = KVServer()
        try:
            monkeypatch.setenv("KV_ENDPOINT", srv.endpoint)
            if kill:
                monkeypatch.setenv("KILL_RANK1_AFTER_PASS", "1")
            else:
                monkeypatch.delenv("KILL_RANK1_AFTER_PASS", raising=False)
            return launch_local(
                [sys.executable, str(worker), str(out_dir)],
                LaunchConfig(nproc=2, job_id="jobE",
                             elastic_endpoint=srv.endpoint, max_restarts=2,
                             stop_grace_sec=15.0, timeout_sec=600.0))
        finally:
            srv.close()

    assert run(tmp_path / "killed", kill=True) == 0
    assert run(tmp_path / "clean", kill=False) == 0
    for r in range(2):
        a = json.load(open(tmp_path / "killed" / f"final_r{r}.json"))
        b = json.load(open(tmp_path / "clean" / f"final_r{r}.json"))
        assert a["global_step"] == b["global_step"], (a, b)
        assert a["features"] == b["features"], (a, b)
        assert np.isclose(a["auc"], b["auc"], atol=1e-6), (a, b)
        assert np.isclose(a["last_loss"], b["last_loss"], atol=1e-6), (a, b)
        pa = np.load(tmp_path / "killed" / f"params_r{r}.npy")
        pb = np.load(tmp_path / "clean" / f"params_r{r}.npy")
        np.testing.assert_allclose(pa, pb, rtol=1e-6, atol=1e-7)
        if table_kind == "tiered":
            assert np.isclose(a["host_sum"], b["host_sum"], rtol=1e-6), \
                (a, b)
