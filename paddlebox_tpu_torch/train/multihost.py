"""Multi-process execution of the sharded trainers — counterpart of
``paddlebox_tpu/train/multihost.py`` (the TPU pod model).

The reference runs ONE process per host, every process executing the
same program over one global device mesh. The port runs one rank
process per node over ``torch.distributed`` (``distributed/launch.py``
``init_runtime_env`` forms the process group): ``global_mesh`` is the
port's global mesh, a ``Pod`` — the process group, this rank's device
and the shards it owns (N shards in ``world`` contiguous blocks, rank r
the r-th). The sharded step (``train/sharded.py``, ``pod=``) runs the
owned shards and moves both exchanges and the dense sync across the
ranks through the ``Pod``'s collectives. This replaces the reference's
per-node NCCL + inter-node MPI hierarchy (SyncDense,
boxps_worker.cc:1191-1258).

The host side follows the SPMD contract: every rank builds IDENTICAL
global batches and routing plans (deterministic duplicated prep over a
shared file list — the standard recipe for host-count ≪ chip-count CTR
jobs), then each rank stages only its OWNED entries of every global
array (``stage_global`` / ``stage_global_batch``).

Backends: ``nccl`` passes CUDA tensors straight to its collectives (one
rank a card); ``gloo`` moves CPU tensors, so on a card each block is
staged through pinned host memory on the step's stream (copy out, wait
for that stream, the collective, copy back in). ``Pod.nbytes`` counts
both.
"""

from __future__ import annotations

import hashlib
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from paddlebox_tpu_torch.device import resolve_device


class Pod:
    """This rank's view of the multi-process job (the reference's global
    mesh): the process group, ``rank`` of ``world``, ``device``, the N
    shards' devices as this rank sees them (every shard on ``device``),
    and ``owned``, the shards whose rows, destinations and ZeRO-1
    chunks this rank holds."""

    def __init__(self, num_shards: int,
                 device: Optional[Any] = None, group=None) -> None:
        import torch.distributed as dist
        if not (dist.is_available() and dist.is_initialized()):
            raise RuntimeError(
                "global_mesh needs a process group: call "
                "distributed.launch.init_runtime_env() (with "
                "PBOX_TORCH_DISTRIBUTED=1) or init_process_group first")
        self.group = group
        self.rank = dist.get_rank(group)
        self.world = dist.get_world_size(group)
        self.backend = dist.get_backend(group)
        if num_shards % self.world:
            raise ValueError(f"{num_shards} shards do not split over "
                             f"{self.world} ranks")
        self.n = num_shards
        self.k = num_shards // self.world
        self.owned = list(range(self.rank * self.k,
                                (self.rank + 1) * self.k))
        if device is None:
            device = (f"cuda:{torch.cuda.current_device()}"
                      if self.backend == "nccl" else "cuda")
        self.device = resolve_device(device)
        if self.backend == "nccl" and self.device.type != "cuda":
            raise ValueError("an nccl process group moves CUDA tensors: "
                             f"device {self.device} is not a card")
        self.devices = [self.device] * num_shards
        # gloo on a card: every collective's blocks go through pinned
        # host memory
        self.staged = self.backend == "gloo" and self.device.type == "cuda"
        # bytes this rank sent to the other ranks, and bytes it copied
        # between the card and pinned memory for gloo
        self.nbytes = {"exchanged": 0, "staged": 0}

    # ---- collectives ---------------------------------------------------
    def _to_host(self, t: torch.Tensor) -> torch.Tensor:
        """A pinned host copy of ``t``, complete when this returns (the
        copy is queued on the current stream, which is then waited for)."""
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        h.copy_(t, non_blocking=True)
        torch.cuda.current_stream(t.device).synchronize()
        self.nbytes["staged"] += t.numel() * t.element_size()
        return h

    def _from_host(self, h: torch.Tensor) -> torch.Tensor:
        self.nbytes["staged"] += h.numel() * h.element_size()
        return h.to(self.device, non_blocking=True)

    def all_to_all(self, send: torch.Tensor) -> torch.Tensor:
        """``send`` [world, ...]: block q goes to rank q; returns
        [world, ...] with block p from rank p."""
        import torch.distributed as dist
        send = send.contiguous()
        self.nbytes["exchanged"] += (send.numel() * send.element_size()
                                     * (self.world - 1) // self.world)
        if self.staged:
            hs = self._to_host(send)
            ho = torch.empty(hs.shape, dtype=hs.dtype, pin_memory=True)
            dist.all_to_all_single(ho, hs, group=self.group)
            return self._from_host(ho)
        out = torch.empty_like(send)
        dist.all_to_all_single(out, send, group=self.group)
        return out

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """[world, *t.shape]: every rank's ``t`` in rank order."""
        import torch.distributed as dist
        t = t.contiguous()
        self.nbytes["exchanged"] += (t.numel() * t.element_size()
                                     * (self.world - 1))
        if self.staged:
            h = self._to_host(t)
            out = torch.empty((self.world,) + tuple(t.shape), dtype=t.dtype,
                              pin_memory=True)
            dist.all_gather(list(out.unbind(0)), h, group=self.group)
            return self._from_host(out)
        out = torch.empty((self.world,) + tuple(t.shape), dtype=t.dtype,
                          device=t.device)
        dist.all_gather(list(out.unbind(0)), t, group=self.group)
        return out

    def all_gather_object(self, obj) -> list:
        """Every rank's picklable ``obj`` in rank order."""
        import torch.distributed as dist
        out: list = [None] * self.world
        dist.all_gather_object(out, obj, group=self.group)
        return out

    def broadcast_(self, t: torch.Tensor, src: int = 0) -> None:
        """``t`` in place from rank ``src``."""
        import torch.distributed as dist
        if self.staged:
            h = self._to_host(t.contiguous())
            dist.broadcast(h, src, group=self.group)
            with torch.no_grad():
                t.copy_(self._from_host(h))
            return
        with torch.no_grad():
            buf = t.contiguous()
            dist.broadcast(buf, src, group=self.group)
            if buf.data_ptr() != t.data_ptr():
                t.copy_(buf)

    def barrier(self) -> None:
        import torch.distributed as dist
        dist.barrier(group=self.group)

    def exchange(self, blocks: Sequence[Optional[torch.Tensor]]
                 ) -> List[Optional[torch.Tensor]]:
        """The step's all-to-all across the ranks (``train/sharded.
        exchange``'s counterpart): ``blocks[s]`` [N, ...] (s owned) holds
        what owner s sends each destination; returns ``out[d]`` [N, ...]
        (d owned) = the blocks of every owner s for d, in shard order.
        One ``all_to_all`` moves a [k, k, ...] block between each pair of
        ranks (the copies within a rank ride it too)."""
        k, world = self.k, self.world
        send = torch.stack([blocks[s] for s in self.owned])  # [k_s, N, ...]
        rest = tuple(send.shape[2:])
        # [k_s, world, k_d, ...] → block q = [k_s, k_d, ...] for rank q
        send = send.view((k, world, k) + rest).transpose(0, 1)
        recv = self.all_to_all(send)          # [world, k_s, k_d, ...]
        out: List[Optional[torch.Tensor]] = [None] * self.n
        for j, d in enumerate(self.owned):
            out[d] = recv[:, :, j].reshape((self.n,) + rest)
        return out


def global_mesh(num_shards: int, device: Optional[Any] = None,
                group=None) -> Pod:
    """The port's global mesh: the process group (after
    ``init_runtime_env``) with ``num_shards`` shards split over its
    ranks; ``device`` defaults to the rank's card."""
    return Pod(num_shards, device=device, group=group)


def stage_global(pod: Pod, arr: np.ndarray,
                 shard_dim0: bool = True) -> List[Optional[torch.Tensor]]:
    """Stage one globally-identical host array: ``arr`` must be
    byte-identical on every rank (the SPMD host contract); with
    ``shard_dim0`` its leading axis is the shard and each owned row goes
    to ``pod.devices[s]`` (None elsewhere), else the whole array is
    replicated onto ``pod.device``."""
    a = np.ascontiguousarray(arr)
    if not shard_dim0 or a.ndim == 0:
        return torch.from_numpy(a).to(pod.device)
    if a.shape[0] != pod.n:
        raise ValueError(f"leading axis {a.shape[0]} is not the "
                         f"{pod.n} shards")
    return [torch.from_numpy(a[s]).to(pod.devices[s])
            if s in pod.owned else None for s in range(pod.n)]


def stage_global_batch(pod: Pod, batches, idx):
    """``train/sharded.make_global_batch`` for this rank: the group's
    stacked host arrays (the same on every rank) with only the owned
    shards' entries staged."""
    from paddlebox_tpu_torch.train.sharded import make_global_batch
    return make_global_batch(batches, idx, pod.devices, owned=pod.owned)


def _state_digest(module: torch.nn.Module) -> str:
    h = hashlib.sha256()
    for name, t in module.state_dict().items():
        h.update(name.encode())
        h.update(np.ascontiguousarray(t.detach().cpu().numpy()).tobytes())
    return h.hexdigest()


def globalize_state(pod: Pod, model: torch.nn.Module,
                    check: bool = False) -> None:
    """Make every rank's dense state rank 0's: each param and buffer of
    ``model`` broadcast in place (init is seeded, so a fresh job's
    ranks hold the same values anyway; a restore may not). With
    ``check``, raise unless every rank already holds rank 0's state."""
    if check:
        digests = pod.all_gather_object(_state_digest(model))
        if any(d != digests[0] for d in digests):
            raise RuntimeError(
                "dense state differs across ranks: "
                + ", ".join(f"rank {r} {d[:12]}"
                            for r, d in enumerate(digests)))
        return
    for t in list(model.parameters()) + list(model.buffers()):
        pod.broadcast_(t.data, src=0)


def _process_index() -> int:
    import torch.distributed as dist
    return (dist.get_rank() if dist.is_available() and dist.is_initialized()
            else 0)


def _process_count() -> int:
    import torch.distributed as dist
    return (dist.get_world_size()
            if dist.is_available() and dist.is_initialized() else 1)


# ---- heartbeat + straggler watchdog (obs/watchdog) ---------------------
def make_straggler_watchdog(heartbeat_dir: Optional[str] = None,
                            start: bool = True, **kwargs):
    """Build the pod's straggler watchdog for THIS rank.

    Every rank calls this once after the process group forms and then
    calls ``wd.beat(step)`` once per pass (or step window): the monitor
    thread flags any rank whose step counter falls behind the front
    runner by ``FLAGS.straggler_step_lag`` or whose heartbeat goes stale
    past ``FLAGS.straggler_timeout_sec`` — "WHICH rank is stalling" when
    a collective hangs. With ``FLAGS.straggler_abort_sec > 0`` a
    persistent stall makes the next ``beat()`` raise
    ``StragglerTimeout`` so the launcher (elastic runtime) can replace
    the rank instead of hanging forever.

    ``heartbeat_dir`` must be shared across hosts (NFS/FUSE); defaults
    to ``FLAGS.straggler_heartbeat_dir``. A world of one gets a
    process-local store (stale-heartbeat detection still fires when the
    training thread wedges). ``kwargs`` override any
    ``StragglerWatchdog`` parameter (tests inject ``clock``; pass
    ``escalations=[(after_sec, action), ...]`` for the staged ladder)."""
    from paddlebox_tpu_torch.config import FLAGS
    from paddlebox_tpu_torch.obs.watchdog import (DirHeartbeatStore,
                                                  LocalHeartbeatStore,
                                                  StragglerWatchdog)
    hb_dir = heartbeat_dir or FLAGS.straggler_heartbeat_dir
    if hb_dir:
        store = DirHeartbeatStore(hb_dir)
    elif _process_count() == 1:
        store = LocalHeartbeatStore()
    else:
        raise ValueError(
            "a multi-process watchdog needs a SHARED heartbeat dir: pass "
            "heartbeat_dir= or set FLAGS.straggler_heartbeat_dir")
    kw = dict(
        step_lag=FLAGS.straggler_step_lag,
        heartbeat_timeout=FLAGS.straggler_timeout_sec,
        abort_after=(FLAGS.straggler_abort_sec
                     if FLAGS.straggler_abort_sec > 0 else None))
    kw.update(kwargs)
    wd = StragglerWatchdog(store, _process_index(), _process_count(), **kw)
    return wd.start() if start else wd


# ---- elastic membership (distributed/elastic) --------------------------
def make_elastic_manager(job_id: str, host: Optional[str] = None,
                         np: Optional[int] = None,
                         elastic_dir: Optional[str] = None,
                         store=None, **kwargs):
    """Build THIS rank's elastic membership agent. ``elastic_dir``
    (default ``FLAGS.elastic_dir``) must be shared across hosts; pass
    ``store=`` (e.g. a ``TcpKVStore``) to skip the filesystem. ``host``
    defaults to ``host<rank>``, ``np`` to the world size; ``kwargs``
    override any ``ElasticManager`` parameter."""
    from paddlebox_tpu_torch.config import FLAGS
    from paddlebox_tpu_torch.distributed.elastic import (ElasticManager,
                                                         FileKVStore)
    if store is None:
        d = elastic_dir or FLAGS.elastic_dir
        if not d:
            raise ValueError(
                "elastic membership needs a SHARED dir: pass "
                "elastic_dir=/store= or set FLAGS.elastic_dir")
        store = FileKVStore(d)
    kw = dict(ttl=FLAGS.elastic_ttl_sec,
              dead_checks=FLAGS.elastic_dead_checks)
    kw.update(kwargs)
    return ElasticManager(
        store, job_id,
        host if host is not None else f"host{_process_index()}",
        np if np is not None else _process_count(), **kw)


class ElasticController:
    """Boundary membership decisions for an elastic stream job: wraps an
    ``ElasticManager`` (+ optional ``RestoreConsensus``) behind the tiny
    protocol the training loops poll at every completed pass/window
    boundary — ``poll`` (did the world change?), ``agree_boundary``
    (which step do the survivors resume from?), ``evict`` (the
    watchdog's shrink-and-continue rung), ``publish``/``note_reshard``
    (restart pointer + bookkeeping). The re-shard itself is the caller's
    move (``ElasticStreamRunner.run`` is the reference driver)."""

    def __init__(self, manager, consensus=None) -> None:
        self.manager = manager
        self.consensus = consensus

    def poll(self) -> Optional[Dict]:
        """One boundary membership check. None = steady world; else a
        decision dict ``{hosts, np, lost, joined, ts}``."""
        hosts = self.manager.scale_event()
        if hosts is None:
            return None
        ev = dict(self.manager.last_event or {})
        ev.setdefault("hosts", hosts)
        ev["np"] = len(hosts)
        return ev

    def evict(self, host: str, reason: str = "") -> None:
        self.manager.evict_host(host, reason)

    def agree_boundary(self, local_step,
                       survivors: Optional[list] = None):
        """Consensus over the surviving world on the boundary step to
        resume from (``RestoreConsensus.agree_restore_step`` — the min);
        ``survivors`` narrows the participant set first; with no
        consensus wired, the local step IS the agreement."""
        if self.consensus is None:
            return local_step
        if survivors is not None:
            self.consensus.set_participants(survivors)
        return self.consensus.agree_restore_step(local_step)

    def publish(self, path: str, pass_id: int) -> None:
        self.manager.publish_checkpoint(path, pass_id)

    def note_reshard(self, old_np: int, new_np: int,
                     step: int = -1) -> None:
        self.manager.note_reshard(old_np, new_np, step=step)


class ElasticStreamRunner:
    """Windowed stream driver with pass-boundary membership churn — the
    re-shard state machine:

    per window: train → boundary save → publish restart pointer →
    ``controller.poll()``; on a scale event: coordinated stop (the
    boundary IS the stop point) → ``agree_boundary`` over the survivors
    → rebuild the world at the new size (``make_world(np)`` — a fresh
    trainer and table with ``num_shards`` matching) → re-import the
    agreed boundary checkpoint (``key % num_shards`` makes the re-shard
    a deterministic re-import; ``CheckpointManager.restore`` replays it)
    → continue the stream at the next window.

    ``make_world(np) -> (trainer, checkpoint_manager)`` owns the host
    count → shard mapping; every checkpoint manager shares one root.
    ``controller`` is duck-typed (``ElasticController``, or a scripted
    schedule in gates and oracles). ``on_boundary(widx, trainer)`` runs
    after the save and before the poll.

    Returns one record per window: ``{window, np, step, digest,
    train_sec, reshard?}`` — ``reshard`` carries {old_np, new_np,
    agreed_step, digest_after, stall_sec} and ``digest_after`` must
    equal the boundary ``digest`` (the lossless re-import proof)."""

    def __init__(self, make_world, make_dataset, num_windows: int,
                 controller=None, on_boundary=None,
                 digest_fn=None, clock=None) -> None:
        import time
        from paddlebox_tpu_torch.train.checkpoint import elastic_state_digest
        self.make_world = make_world
        self.make_dataset = make_dataset
        self.num_windows = int(num_windows)
        self.controller = controller
        self.on_boundary = on_boundary
        self.digest_fn = digest_fn or elastic_state_digest
        self.clock = clock or time.monotonic

    def run(self, start_np: int) -> list:
        trainer, cm = self.make_world(start_np)
        np_cur = int(start_np)
        records = []
        for widx in range(self.num_windows):
            ds = self.make_dataset(widx)
            t0 = self.clock()
            trainer.train_pass(ds)
            train_sec = self.clock() - t0
            step = int(trainer.global_step)
            cm.save(trainer)  # boundary base: re-shard import source
            rec = {"window": widx, "np": np_cur, "step": step,
                   "digest": self.digest_fn(trainer),
                   "train_sec": train_sec}
            if self.controller is not None:
                self.controller.publish(cm.root, widx)
                if self.on_boundary is not None:
                    self.on_boundary(widx, trainer)
                decision = self.controller.poll()
                if decision is not None and decision["np"] != np_cur:
                    rec["reshard"] = self._reshard(decision, step, np_cur)
                    np_cur = int(decision["np"])
                    trainer, cm = self._world
            records.append(rec)
        return records

    def _reshard(self, decision: Dict, step: int, old_np: int) -> Dict:
        t0 = self.clock()
        agreed = self.controller.agree_boundary(
            step, survivors=decision.get("survivor_ranks"))
        new_np = int(decision["np"])
        trainer, cm = self.make_world(new_np)
        restored = cm.restore(trainer, step=agreed)
        if restored != agreed:
            raise RuntimeError(
                f"elastic re-shard: agreed boundary step {agreed} did "
                f"not restore (got {restored}) — the boundary save is "
                "missing from the shared checkpoint root")
        self.controller.note_reshard(old_np, new_np, step=agreed)
        self._world = (trainer, cm)
        return {"old_np": old_np, "new_np": new_np,
                "agreed_step": int(agreed),
                "lost": decision.get("lost", []),
                "joined": decision.get("joined", []),
                "digest_after": self.digest_fn(trainer),
                "stall_sec": self.clock() - t0}


# ---- consistent recovery (resilience/consensus) ------------------------
def make_restore_consensus(consensus_dir: Optional[str] = None, **kwargs):
    """Build this rank's restore-consensus client. Every rank constructs
    one after the process group forms and recovers through it:

        consensus = make_restore_consensus()
        step = consensus_restore(cm, trainer, consensus)   # agreed min
        sync_shared_quarantine(ds, consensus)              # same drops

    so every rank restores the SAME step and drops the SAME quarantined
    files — preserving the identical-batches SPMD contract above.
    ``consensus_dir`` must be shared across hosts; defaults to
    ``FLAGS.restore_consensus_dir``. ``epoch`` defaults to the
    launcher-provided ``PBOX_RESTORE_EPOCH`` env."""
    import os
    from paddlebox_tpu_torch.config import FLAGS
    from paddlebox_tpu_torch.resilience.consensus import (DirConsensusStore,
                                                          RestoreConsensus)
    d = consensus_dir or FLAGS.restore_consensus_dir
    if not d:
        raise ValueError(
            "restore consensus needs a SHARED dir: pass consensus_dir= "
            "or set FLAGS.restore_consensus_dir")
    kwargs.setdefault("epoch",
                      int(os.environ.get("PBOX_RESTORE_EPOCH", "0")))
    return RestoreConsensus(DirConsensusStore(d), _process_index(),
                            _process_count(), **kwargs)
