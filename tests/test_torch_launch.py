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
