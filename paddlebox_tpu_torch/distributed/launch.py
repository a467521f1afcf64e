"""Multi-process launcher (counterpart of
``paddlebox_tpu/distributed/launch.py``).

Reference: python/paddle/distributed/launch.py + fleet/launch.py (spawn
one trainer process per device, export PADDLE_TRAINER_ID /
PADDLE_TRAINER_ENDPOINTS, restart on failure when elastic is on).

The launcher's unit is a rank process. It

- exports ``PBOX_*`` env (rank, world size, coordinator address, the
  process-group backend) and, in the worker, ``init_runtime_env()``
  hands them to ``torch.distributed.init_process_group``;
- spawns N local worker processes (one host, or tests), each seeing a
  disjoint rank;
- integrates ElasticManager: on a worker death (or scale event) it stops
  the survivors and restarts everyone from the latest published
  checkpoint pointer; a gang past ``timeout_sec`` is stopped and fails.

The backend is chosen once, by the launcher, in the open: whatever
``LaunchConfig.backend`` names, else ``nccl`` when every local rank has a
card of its own and ``gloo`` otherwise (ranks sharing a card, or the
CPU). It reaches the worker as ``PBOX_BACKEND``, which a worker that
forms a group must have: the worker guesses nothing. Nothing tries NCCL
and falls back: an NCCL init that fails raises.
"""

from __future__ import annotations

import argparse
import dataclasses
import datetime
import os
import signal
import subprocess
import sys
import time
from typing import Dict, List, Optional, Sequence

from paddlebox_tpu_torch.distributed.elastic import ElasticManager, FileKVStore
from paddlebox_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

ENV_RANK = "PBOX_RANK"
ENV_WORLD = "PBOX_WORLD_SIZE"
ENV_COORD = "PBOX_COORDINATOR"
ENV_RESUME = "PBOX_RESUME_CKPT"
ENV_BACKEND = "PBOX_BACKEND"
# "1": the worker forms a torch.distributed process group (the
# reference's PBOX_JAX_DISTRIBUTED); "0" (default): a host-only job
# (TcpShuffler / TcpCollective) that needs none
ENV_DISTRIBUTED = "PBOX_TORCH_DISTRIBUTED"
# seconds a process-group rendezvous or collective may wait
PG_TIMEOUT_SEC = 300.0

BACKENDS = ("nccl", "gloo")

# exit code of a gang stopped at LaunchConfig.timeout_sec (timeout(1)'s)
TIMEOUT_EXIT = 124


@dataclasses.dataclass
class LaunchConfig:
    nproc: int = 1                      # local worker processes
    coordinator: str = "127.0.0.1:8476"
    job_id: str = "default"
    elastic_root: Optional[str] = None  # KV dir; enables elastic restarts
    # network KV (host:port of a KVServer) — elastic restarts with NO
    # shared filesystem (TcpKVStore; overrides elastic_root)
    elastic_endpoint: Optional[str] = None
    max_restarts: int = 3
    stop_grace_sec: float = 5.0
    # the workers form a torch.distributed process group (ENV_DISTRIBUTED)
    distributed: bool = False
    # "nccl" | "gloo" | None: None picks by choose_backend(nproc)
    backend: Optional[str] = None
    # a gang still running after this many seconds is stopped and the
    # launch returns TIMEOUT_EXIT (None: no limit)
    timeout_sec: Optional[float] = None


def choose_backend(local_ranks: int) -> str:
    """``nccl`` when each of ``local_ranks`` ranks has a card of its own
    (NCCL puts one rank on a device), else ``gloo``."""
    import torch
    if torch.cuda.is_available() and torch.cuda.device_count() >= local_ranks:
        return "nccl"
    return "gloo"


def _check_backend(backend: str) -> str:
    if backend not in BACKENDS:
        raise ValueError(f"unknown process-group backend {backend!r}; one "
                         f"of {BACKENDS}")
    return backend


def init_runtime_env() -> Dict[str, object]:
    """Worker-side bootstrap: read the env the launcher exported and, when
    ``PBOX_TORCH_DISTRIBUTED=1``, form the process group over
    ``tcp://<PBOX_COORDINATOR>`` with the backend ``PBOX_BACKEND`` names
    (required then: only the launcher sees how many ranks share a host,
    so a worker started by hand names its backend too). Under ``nccl``
    the rank's card (``rank % device_count``) becomes the current device
    first. Returns ``{rank, world_size, backend}`` (backend None when no
    group was formed)."""
    rank = int(os.environ.get(ENV_RANK, "0"))
    world = int(os.environ.get(ENV_WORLD, "1"))
    backend = None
    if os.environ.get(ENV_DISTRIBUTED, "0") == "1":
        import torch
        import torch.distributed as dist
        if not os.environ.get(ENV_BACKEND):
            raise RuntimeError(
                f"{ENV_DISTRIBUTED}=1 needs {ENV_BACKEND} (one of "
                f"{BACKENDS}); launch_local exports it")
        backend = _check_backend(os.environ[ENV_BACKEND])
        if backend == "nccl":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        log.info("rank %d/%d: process group over %s at %s", rank, world,
                 backend, os.environ[ENV_COORD])
        dist.init_process_group(
            backend, init_method=f"tcp://{os.environ[ENV_COORD]}",
            world_size=world, rank=rank,
            timeout=datetime.timedelta(seconds=PG_TIMEOUT_SEC))
    return {"rank": rank, "world_size": world, "backend": backend}


def _spawn(cmd: Sequence[str], rank: int, world: int, cfg: LaunchConfig,
           resume: Optional[str], backend: Optional[str]
           ) -> subprocess.Popen:
    env = dict(os.environ)
    env[ENV_RANK] = str(rank)
    env[ENV_WORLD] = str(world)
    env[ENV_COORD] = cfg.coordinator
    if cfg.distributed:
        env[ENV_DISTRIBUTED] = "1"
        env[ENV_BACKEND] = backend
    if resume:
        env[ENV_RESUME] = resume
    return subprocess.Popen(list(cmd), env=env)


def _stop_all(procs: List[subprocess.Popen], grace: float) -> None:
    for p in procs:
        if p.poll() is None:
            p.send_signal(signal.SIGTERM)
    deadline = time.time() + grace
    for p in procs:
        left = max(0.1, deadline - time.time())
        try:
            p.wait(timeout=left)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


def launch_local(cmd: Sequence[str], cfg: LaunchConfig) -> int:
    """Run ``cmd`` as cfg.nproc rank-stamped local processes; restart the
    gang (from the latest checkpoint pointer) on failure when elastic is
    enabled. Returns the final exit code (0 = all ranks clean;
    ``TIMEOUT_EXIT`` = stopped at ``cfg.timeout_sec``)."""
    backend = None
    if cfg.distributed:
        backend = _check_backend(cfg.backend or choose_backend(cfg.nproc))
        log.info("launch: %d ranks over %s (%s)", cfg.nproc, backend,
                 "given" if cfg.backend else "chosen")
    manager: Optional[ElasticManager] = None
    if cfg.elastic_endpoint or cfg.elastic_root:
        if cfg.elastic_endpoint:
            from paddlebox_tpu_torch.distributed.kv_server import TcpKVStore
            kv = TcpKVStore(cfg.elastic_endpoint)
        else:
            kv = FileKVStore(cfg.elastic_root)
        manager = ElasticManager(
            kv, cfg.job_id,
            host=f"local-{os.getpid()}", np=1, ttl=10.0)
        manager.register()

    restarts = 0
    t_start = time.monotonic()
    try:
        while True:
            resume = None
            if manager is not None:
                ckpt = manager.latest_checkpoint()
                if ckpt:
                    resume = ckpt["path"]
                    log.info("starting gang from checkpoint %s", resume)
            procs = [_spawn(cmd, r, cfg.nproc, cfg, resume, backend)
                     for r in range(cfg.nproc)]
            # poll instead of wait: one crashed rank must not leave hung
            # survivors blocking the restart (peer-loss in a collective)
            failed = timed_out = False
            while True:
                codes = [p.poll() for p in procs]
                if any(c is not None and c != 0 for c in codes):
                    failed = True
                    break
                if all(c == 0 for c in codes):
                    break
                if manager is not None and manager.scale_event() is not None:
                    log.warning("membership changed; restarting gang")
                    failed = True
                    break
                if (cfg.timeout_sec is not None
                        and time.monotonic() - t_start > cfg.timeout_sec):
                    failed = timed_out = True
                    break
                time.sleep(0.05)
            if not failed:
                return 0
            codes = [p.poll() for p in procs]
            log.warning("gang %s with codes %s",
                        "timed out" if timed_out else "failed", codes)
            _stop_all(procs, cfg.stop_grace_sec)
            if timed_out:
                return TIMEOUT_EXIT
            codes = [p.returncode for p in procs]
            restarts += 1
            if manager is None or restarts > cfg.max_restarts:
                return max((c for c in codes if c), default=1)
            log.info("elastic restart %d/%d", restarts, cfg.max_restarts)
    finally:
        if manager is not None:
            manager.deregister()


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m paddlebox_tpu_torch.distributed.launch",
        description="PaddleBox job launcher (PyTorch port)")
    ap.add_argument("--nproc", type=int, default=1,
                    help="local worker processes")
    ap.add_argument("--coordinator", default="127.0.0.1:8476")
    ap.add_argument("--job-id", default="default")
    ap.add_argument("--elastic-root", default=None,
                    help="shared KV dir; enables elastic restart")
    ap.add_argument("--elastic-endpoint", default=None,
                    help="KVServer host:port (network KV, no shared "
                         "filesystem); enables elastic restart and "
                         "overrides --elastic-root")
    ap.add_argument("--max-restarts", type=int, default=3)
    ap.add_argument("--distributed", action="store_true",
                    help="the workers form a torch.distributed process "
                         "group (init_runtime_env) over nccl when every "
                         "rank has a card of its own, else gloo")
    ap.add_argument("cmd", nargs=argparse.REMAINDER,
                    help="worker command (e.g. python train.py ...)")
    args = ap.parse_args(argv)
    cmd = args.cmd
    if cmd and cmd[0] == "--":
        cmd = cmd[1:]
    if not cmd:
        ap.error("missing worker command")
    cfg = LaunchConfig(nproc=args.nproc, coordinator=args.coordinator,
                       job_id=args.job_id, elastic_root=args.elastic_root,
                       elastic_endpoint=args.elastic_endpoint,
                       max_restarts=args.max_restarts,
                       distributed=args.distributed)
    return launch_local(cmd, cfg)


if __name__ == "__main__":
    sys.exit(main())
