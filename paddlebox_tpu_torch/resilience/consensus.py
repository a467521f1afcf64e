"""Multihost-consistent recovery: shared-dir consensus on the restore
step and on the quarantine set (docs/RESILIENCE.md §Multihost-consistent
restore). (Copy of ``paddlebox_tpu/resilience/consensus.py``, over the
port's ``CheckpointManager``, ``InMemoryDataset`` and ``QueueDataset``.)

The SPMD host contract (the reference's train/multihost.py) demands
byte-identical batches on every process. Two recovery paths used to be able to break
it silently:

- **restore**: after a crash, each process restores its own "latest"
  checkpoint — but an interrupted save can leave the newest step on
  only SOME hosts, so ranks would train from different steps;
- **quarantine**: the per-file quarantine is a *process-local*
  decision — a file that only one host fails to read would be dropped
  on that host alone, skewing every batch after it.

Both are fixed by the same primitive: every process publishes its local
view into a shared directory (the ``DirHeartbeatStore`` NFS/FUSE
pattern — atomic write-then-rename JSON files, torn reads tolerated),
waits for the full mesh, and applies a deterministic pure function of
the gathered set (``min`` for steps, sorted union for quarantines) so
every process reaches the same answer from the same data.

Chaos seam: ``restore.consensus`` fires on every publish, so a seeded
plan can kill a specific rank's publish deterministically and tests can
assert the timeout/abort behavior.
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional, Sequence

from paddlebox_tpu_torch.resilience import faults
from paddlebox_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)


class ConsensusTimeout(RuntimeError):
    """The mesh did not fully publish within the timeout — some process
    is dead or unreachable; the launcher must resolve membership before
    recovery can proceed."""


class DirConsensusStore:
    """One ``<topic>_<process>.json`` per process per topic in a shared
    directory (NFS/FUSE on real pods). Same conventions as
    ``obs.watchdog.DirHeartbeatStore``: atomic write-then-rename so
    readers never see a torn file; unreadable/foreign files are skipped
    (the next poll sees the completed rename)."""

    def __init__(self, path: str) -> None:
        self.path = path
        os.makedirs(path, exist_ok=True)

    def publish(self, topic: str, process: int, payload: dict) -> None:
        from paddlebox_tpu_torch.utils.fsio import atomic_write_json
        atomic_write_json(
            os.path.join(self.path, f"{topic}_{process}.json"),
            dict(payload, process=process))

    def read(self, topic: str) -> Dict[int, dict]:
        from paddlebox_tpu_torch.utils.fsio import read_json
        out: Dict[int, dict] = {}
        prefix = f"{topic}_"
        try:
            names = os.listdir(self.path)
        except OSError:
            return out
        for n in names:
            if not (n.startswith(prefix) and n.endswith(".json")):
                continue
            try:
                int(n[len(prefix):-len(".json")])
            except ValueError:
                continue  # a different topic sharing the prefix
            d = read_json(os.path.join(self.path, n))
            try:
                out[int(d["process"])] = d
            except (TypeError, ValueError, KeyError):
                continue  # torn/foreign file
        return out

    def clear_process(self, process: int) -> None:
        """Drop every file THIS process published (any topic). Only
        rank ``process`` ever writes ``*_<process>.json``, so this is
        race-free — the restart hygiene each ``RestoreConsensus``
        instance applies for its own rank."""
        suffix = f"_{process}.json"
        try:
            names = os.listdir(self.path)
        except OSError:
            return
        for n in names:
            if n.endswith(suffix):
                try:
                    os.unlink(os.path.join(self.path, n))
                except OSError:
                    pass


class RestoreConsensus:
    """Publish-then-agree over a shared dir for one recovery episode.

    ``epoch`` namespaces the topic files so a directory reused across
    restarts (or across retry attempts) never lets a previous episode's
    answers satisfy this one — pass a value that changes per episode
    (the launcher's restart counter; tests use the default 0).

    LOCKSTEP CONTRACT: every process must issue the same sequence of
    agreement calls on its own instance. Each instance additionally
    counts its gathers per topic and bakes the count into the topic
    name, so repeated agreements (a quarantine sync per pass, a second
    restore after another failure) never read a previous call's stale
    files — matching calls across ranks land on matching topics.
    """

    def __init__(self, store, process_index: int, num_processes: int,
                 timeout: Optional[float] = None,
                 poll_interval: float = 0.05, epoch: int = 0,
                 clock=time.monotonic, sleep=time.sleep,
                 participants: Optional[Sequence[int]] = None) -> None:
        if isinstance(store, str):
            store = DirConsensusStore(store)
        self.store = store
        self.process_index = int(process_index)
        self.num_processes = int(num_processes)
        # elastic worlds: the set of ranks expected to publish. Default
        # = the full mesh; after a scale-down the survivors call
        # set_participants() so agreements stop waiting on the dead.
        self._participants: List[int] = sorted(
            int(p) for p in (participants
                             if participants is not None
                             else range(int(num_processes))))
        if timeout is None:
            from paddlebox_tpu_torch.config import FLAGS
            timeout = FLAGS.consensus_timeout_sec
        self.timeout = float(timeout)
        self.poll_interval = poll_interval
        self.epoch = int(epoch)
        self.clock = clock
        self.sleep = sleep
        self._gathers: Dict[str, int] = {}  # per-topic call counter
        # restart hygiene: drop THIS rank's files from any previous
        # episode reusing the directory (race-free: only we write them).
        # Other ranks' stale files are defeated by the confirm barrier
        # in _gather.
        if hasattr(self.store, "clear_process"):
            self.store.clear_process(self.process_index)

    # ---- elastic membership --------------------------------------------
    @property
    def participants(self) -> List[int]:
        return list(self._participants)

    def set_participants(self, ranks: Sequence[int]) -> None:
        """Restrict agreements to ``ranks`` (the surviving world after a
        scale event). Every surviving rank must apply the SAME set
        before its next agreement call — the set is part of the lockstep
        contract. Publishes from non-participants are ignored, so a dead
        rank's stale (or late) files can neither satisfy nor skew a
        survivor agreement."""
        ranks = sorted(int(p) for p in ranks)
        if not ranks:
            raise ValueError("participants must be non-empty")
        if self.process_index not in ranks:
            raise ValueError(
                f"process {self.process_index} cannot agree in a world "
                f"it is not part of ({ranks})")
        if ranks != self._participants:
            log.info("restore consensus: participants %s -> %s",
                     self._participants, ranks)
        self._participants = ranks

    # ---- core gather ---------------------------------------------------
    def _gather_once(self, topic: str, payload: dict) -> Dict[int, dict]:
        """Publish this process's view under a per-call topic, then
        block until every process of the mesh has published it (or the
        timeout expires)."""
        n = self._gathers.get(topic, 0)
        self._gathers[topic] = n + 1
        topic = f"e{self.epoch}_c{n}_{topic}"
        faults.inject("restore.consensus", op=f"publish:{topic}",
                      process=self.process_index)
        self.store.publish(topic, self.process_index, payload)
        deadline = self.clock() + self.timeout
        while True:
            got = self.store.read(topic)
            got = {p: d for p, d in got.items()
                   if p in set(self._participants)}
            missing = [p for p in self._participants if p not in got]
            if not missing:
                return got
            if self.clock() > deadline:
                raise ConsensusTimeout(
                    f"consensus on {topic!r} timed out after "
                    f"{self.timeout:.1f}s: process(es) {missing} never "
                    "published — resolve mesh membership before "
                    "restoring")
            self.sleep(self.poll_interval)

    def _gather(self, topic: str, payload: dict) -> Dict[int, dict]:
        """Gather + digest-confirm barrier. The per-instance call
        counters (lockstep contract above) keep repeated agreements on
        fresh topics, and the confirm round makes a stale file from a
        previous episode HARMLESS: if any rank gathered different data
        (e.g. a leftover pre-crash publish it read before that rank
        restarted and overwrote it), the digests mismatch and every
        rank that saw the mismatch retries on fresh topics — divergent
        data can never be silently agreed on; the worst case is a loud
        ConsensusTimeout."""
        import hashlib
        import json as _json
        last = None
        for attempt in range(5):
            got = self._gather_once(topic, payload)
            digest = hashlib.sha256(_json.dumps(
                got, sort_keys=True).encode()).hexdigest()
            conf = self._gather_once(f"{topic}.confirm",
                                     {"digest": digest})
            digests = {d.get("digest") for d in conf.values()}
            if len(digests) == 1:
                return got
            last = sorted(d or "?" for d in digests)
            log.warning("consensus gather on %r round %d: digests "
                        "disagree (%s) — stale episode files suspected, "
                        "retrying on fresh topics", topic, attempt, last)
        raise ConsensusTimeout(
            f"consensus on {topic!r} never converged: digests kept "
            f"disagreeing across retries ({last}) — clear the consensus "
            "dir or bump the epoch")

    # ---- restore-step agreement ----------------------------------------
    def agree_restore_step(self,
                           local_step: Optional[int]) -> Optional[int]:
        """Publish this process's latest locally-verified restorable
        step; return ``min`` over the mesh once everyone has published.
        ``None``/-1 means "no restorable checkpoint here", which forces
        the agreed answer to None (fresh start) — restoring a step ANY
        process lacks would diverge the mesh."""
        mine = -1 if local_step is None else int(local_step)
        got = self._gather("restore_step", {"step": mine})
        steps = {p: int(d.get("step", -1)) for p, d in got.items()}
        agreed = min(steps.values())
        self._emit("step", local=mine, agreed=agreed,
                   steps={str(p): s for p, s in sorted(steps.items())})
        log.info("restore consensus: local step %s, mesh %s -> agreed %s",
                 mine, sorted(steps.values()), agreed)
        return None if agreed < 0 else agreed

    def agree_restore_set(self,
                          local_steps: Sequence[int]) -> Optional[int]:
        """Publish EVERY locally-verified restorable step; return the
        newest step present on the WHOLE mesh (max of the intersection),
        or None when no step is commonly restorable. Stricter than
        :meth:`agree_restore_step`: the agreed step is guaranteed to
        exist (and verify) on every rank even when retention windows
        have drifted apart."""
        mine = sorted({int(s) for s in local_steps})
        got = self._gather("restore_set", {"steps": mine})
        sets = [set(d.get("steps", [])) for d in got.values()]
        common = set.intersection(*sets) if sets else set()
        agreed = max(common) if common else None
        self._emit("step", local=mine[-1] if mine else -1,
                   agreed=-1 if agreed is None else agreed,
                   common=sorted(common))
        log.info("restore consensus: local steps %s -> commonly "
                 "restorable %s -> agreed %s", mine, sorted(common),
                 agreed)
        return agreed

    # ---- quarantine agreement ------------------------------------------
    def _quarantine_round(self, files: Sequence[str], rnd: int
                          ) -> tuple:
        """One quarantine barrier round: publish ``files``, gather the
        mesh. Returns ``(union, converged)`` — converged is True when
        every process published the same set (a pure function of the
        gathered data, so every process sees the same answer)."""
        mine = sorted(set(files))
        got = self._gather(f"quarantine_r{rnd}", {"files": mine})
        published = [frozenset(d.get("files", [])) for d in got.values()]
        union = sorted(frozenset().union(*published))
        self._emit("quarantine", round=rnd, local=len(mine),
                   agreed=len(union), files=union)
        return union, all(s == frozenset(union) for s in published)

    def agree_quarantine(self, files: Sequence[str],
                         round: int = 0) -> List[str]:
        """Publish this process's quarantine list for ``round``; return
        the sorted mesh-wide union. Every process must call with the
        same round sequence (see :func:`sync_shared_quarantine`)."""
        return self._quarantine_round(files, round)[0]

    def _emit(self, kind: str, **fields) -> None:
        try:
            from paddlebox_tpu_torch.obs.hub import get_hub
            hub = get_hub()
            hub.counter("pbox_restore_consensus_total",
                        "consensus agreements reached").inc(kind=kind)
            if hub.active:
                hub.emit("restore_consensus", kind=kind,
                         process=self.process_index, **fields)
        except Exception:
            log.debug("consensus telemetry emit failed", exc_info=True)


def consensus_restore(checkpoint, trainer, consensus: RestoreConsensus
                      ) -> Optional[int]:
    """Multihost-consistent restore: every process publishes its
    locally-verified restorable steps (full base+delta chain
    checksummed — ``CheckpointManager.verified_steps``), the mesh
    agrees on the newest COMMON step, and every process restores THAT
    step. Publishing the full verified set (not just the newest step)
    means the agreed step is guaranteed to exist on every rank even
    when crash timing or retention windows made the rank's checkpoint
    sets drift apart. Returns the restored step, or None when no step
    is commonly restorable (fresh start everywhere — the only
    mesh-consistent answer)."""
    local = checkpoint.verified_steps()
    agreed = consensus.agree_restore_set(local)
    if agreed is None:
        log.warning("consensus restore: mesh has no commonly-restorable "
                    "step — starting fresh")
        return None
    restored = checkpoint.restore(trainer, step=agreed)
    if local and agreed != local[-1]:
        log.warning("consensus restore: rolled back from local step %d "
                    "to mesh-agreed step %d", local[-1], agreed)
    return restored


def sync_shared_quarantine(dataset, consensus: RestoreConsensus,
                           max_rounds: int = 4) -> List[str]:
    """Make quarantine decisions mesh-consistent: publish this process's
    quarantined files and adopt the union, so every process drops the
    SAME files and the byte-identical-batches contract survives a
    single-process file fault.

    Runs in rounds, each a full-mesh barrier every process executes in
    lockstep. A round where the published sets are NOT all equal makes
    every process adopt the union (reloading without the newly-dropped
    files — which may quarantine new files, feeding the next round).
    The stop condition — "all published sets equal" — is a pure
    function of the gathered data, so every process stops at the same
    round. Returns the final agreed quarantine list.

    Needs a dataset that can reload (``load_into_memory``) — i.e. the
    in-memory family that the SPMD identical-batches contract applies
    to — OR a WINDOWED streaming QueueDataset, whose quarantine union
    is adopted as a preseeded skip set instead of a reload (records of
    not-yet-consumed files simply never stream; files a rank partially
    read before quarantining fall under the stream's documented
    at-least-once accounting, not the byte-identical-batches contract).
    Legacy unwindowed streams are still refused up front.

    TIMEOUT SIZING: a rank that adopts peer drops RELOADS the pass
    between rounds while its peers already wait in the next round's
    gather — ``FLAGS.consensus_timeout_sec`` (or the consensus's
    ``timeout=``) must therefore cover a full pass reload, not just
    filesystem latency."""
    if not hasattr(dataset, "load_into_memory"):
        if getattr(dataset, "windowed", False) and \
                hasattr(dataset, "preseed_quarantine"):
            return _sync_stream_quarantine(dataset, consensus,
                                           max_rounds)
        raise TypeError(
            "sync_shared_quarantine needs an in-memory dataset (it "
            "reloads without the mesh-quarantined files) or a WINDOWED "
            "streaming QueueDataset (FLAGS.stream_window_files, which "
            "adopts the union as a skip set); "
            f"{type(dataset).__name__} can do neither")
    applied = {p for p, _ in dataset.quarantined_files}
    for rnd in range(max_rounds):
        local = sorted({p for p, _ in dataset.quarantined_files}
                       | applied)
        union, converged = consensus._quarantine_round(local, rnd)
        if converged:
            applied = set(union)
            break  # everyone published the same set: mesh converged
        in_list = [p for p in union if p in dataset.filelist]
        # locally-quarantined files already excluded their records —
        # only files a PEER dropped (still loaded here) force a reload
        local_q = {p for p, _ in dataset.quarantined_files}
        extra = [p for p in in_list if p not in local_q]
        if in_list:
            dataset.set_filelist(
                [p for p in dataset.filelist if p not in union])
        if extra:
            log.warning("shared quarantine: dropping %d file(s) "
                        "quarantined on peer process(es): %s",
                        len(extra), extra)
            dataset.load_into_memory()  # fresh failures join next round
        applied = set(union)
    else:
        raise RuntimeError(
            f"shared quarantine did not converge in {max_rounds} rounds "
            f"— files keep failing; last union: {sorted(applied)}")
    have = dict(dataset.quarantined_files)
    with dataset._quarantine_lock:
        dataset.quarantined_files = [
            (p, have.get(p, "quarantined on a peer process"))
            for p in sorted(applied)]
    return sorted(applied)


def _sync_stream_quarantine(dataset, consensus: RestoreConsensus,
                            max_rounds: int = 4) -> List[str]:
    """Quarantine-union agreement for a WINDOWED streaming dataset: the
    mesh union is adopted as a PRESEEDED skip set
    (``QueueDataset.preseed_quarantine`` — budget-free, carried forward
    by every later stream cursor) so every rank's future windows drop
    the same files. Same lockstep round contract as the in-memory path
    (``agree_quarantine`` rounds must align across ranks)."""
    union: List[str] = []
    for rnd in range(max_rounds):
        local = sorted({p for p, _ in dataset.quarantined_files})
        union, converged = consensus._quarantine_round(local, rnd)
        if converged:
            break
        extra = [p for p in union if p not in set(local)]
        if extra:
            log.warning("shared quarantine (stream): preseeding %d "
                        "file(s) quarantined on peer process(es): %s",
                        len(extra), extra)
        dataset.preseed_quarantine(union)
    else:
        raise RuntimeError(
            f"shared quarantine did not converge in {max_rounds} "
            f"rounds — files keep failing; last union: {union}")
    dataset.preseed_quarantine(union)
    return sorted(union)
