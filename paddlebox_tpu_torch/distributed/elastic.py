"""Elastic membership / fault detection.
(Copy of ``paddlebox_tpu/distributed/elastic.py``.)

Reference: python/paddle/distributed/fleet/elastic/manager.py:131
(ElasticManager) — etcd-backed: each node registers under a job prefix
with a TTL lease refreshed by a heartbeat thread; a watch on the node
prefix fires scale events; np (node count) may float in [min_np, max_np]
(ELASTIC level) or must stay fixed (FAULT_TOLERANCE level, restart only).

No etcd dependency — membership rides a pluggable ``KVStore``. The
default ``FileKVStore`` uses a shared directory (works for multi-process
single host and for multi-host over NFS/GCS-fuse; the device runtime's
own rendezvous is not this layer's, it only decides *when to restart and
with how many hosts*). Leases are
mtime-based: a key is alive while its last heartbeat is younger than the
TTL.

Hardening + protocol (docs/RESILIENCE.md §Elastic membership):

* ``put`` publishes through ``utils.fsio.atomic_write_bytes`` — fsync
  before the rename, so a host crash can't leave a torn or
  empty-but-visible lease for survivors to mis-read.
* Heartbeats refresh the lease with ``touch`` (an ``os.utime`` on the
  lease file) instead of the old get-then-put: a concurrent payload
  update can no longer be resurrected with stale bytes, and a *deleted*
  lease (watchdog eviction, explicit deregister) stops the heartbeat
  thread instead of silently re-creating the lease — a rejoin requires
  an explicit ``register()``.
* Key escaping is reversible (percent-encoding): a host name containing
  ``__`` or ``/`` round-trips through ``list_prefix`` intact.
* Dead-rank detection carries ``for_count``-style hysteresis
  (``dead_checks``): a host missing from one ``alive_hosts()`` poll — a
  delayed-but-alive heartbeat, an NFS hiccup — does NOT fire a scale
  event; only ``dead_checks`` consecutive misses (or an explicit
  ``evict_host``) confirm the death. Joins are admitted immediately.
* Every KV op passes the ``elastic.kv`` fault seam and manager-level
  reads retry transient failures on the seeded ``RetryPolicy``
  (site ``elastic.kv``); rendezvous polls pass ``elastic.rendezvous``.
"""

from __future__ import annotations

import json
import os
import threading
import time
import urllib.parse
from typing import Dict, List, Optional, Set

from paddlebox_tpu_torch.resilience import faults
from paddlebox_tpu_torch.resilience.retry import RetryPolicy, TransientError
from paddlebox_tpu_torch.utils.fsio import atomic_write_bytes
from paddlebox_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)


class ElasticLevel:
    FAULT_TOLERANCE = 1  # fixed np; dead node ⇒ wait for it to come back
    ELASTIC = 2          # np floats in [min_np, max_np]


class KVStore:
    """Minimal KV interface the manager needs (etcd analogue)."""

    def put(self, key: str, value: bytes) -> None:
        raise NotImplementedError

    def get(self, key: str) -> Optional[bytes]:
        raise NotImplementedError

    def delete(self, key: str) -> None:
        raise NotImplementedError

    def list_prefix(self, prefix: str) -> Dict[str, bytes]:
        raise NotImplementedError

    def mtime(self, key: str) -> float:
        raise NotImplementedError

    def touch(self, key: str) -> bool:
        """Refresh the key's lease mtime WITHOUT rewriting its payload.
        Returns False when the key no longer exists (deleted lease — the
        holder was evicted or deregistered)."""
        raise NotImplementedError


class FileKVStore(KVStore):
    """Shared-directory KV store; key = relative path, one file per key.

    Keys are flattened to single filenames via percent-encoding
    (``urllib.parse.quote(..., safe="")``), which is reversible — unlike
    the old ``/``→``__`` scheme, a host name that itself contains ``__``
    survives the ``list_prefix`` round trip. Quoting is per-character,
    so logical-prefix matching reduces to filename-prefix matching.
    """

    def __init__(self, root: str) -> None:
        self.root = root
        os.makedirs(root, exist_ok=True)

    def _path(self, key: str) -> str:
        return os.path.join(self.root, self._escape(key))

    @staticmethod
    def _escape(key: str) -> str:
        return urllib.parse.quote(key.strip("/"), safe="")

    @staticmethod
    def _unescape(name: str) -> str:
        return urllib.parse.unquote(name)

    def put(self, key: str, value: bytes) -> None:
        faults.inject("elastic.kv", op="put", key=key)
        # fsync'd atomic publish: a crashed writer can't leave a torn
        # lease, and the payload is durable before it becomes visible
        atomic_write_bytes(self._path(key), value)

    def get(self, key: str) -> Optional[bytes]:
        faults.inject("elastic.kv", op="get", key=key)
        try:
            with open(self._path(key), "rb") as f:
                return f.read()
        except FileNotFoundError:
            return None

    def delete(self, key: str) -> None:
        faults.inject("elastic.kv", op="delete", key=key)
        try:
            os.remove(self._path(key))
        except FileNotFoundError:
            pass

    def list_prefix(self, prefix: str) -> Dict[str, bytes]:
        faults.inject("elastic.kv", op="list", key=prefix)
        pfx = self._escape(prefix)
        out: Dict[str, bytes] = {}
        for name in os.listdir(self.root):
            if name.startswith(pfx) and ".tmp" not in name:
                try:
                    with open(os.path.join(self.root, name), "rb") as f:
                        out[self._unescape(name)] = f.read()
                except FileNotFoundError:
                    continue
        return out

    def mtime(self, key: str) -> float:
        faults.inject("elastic.kv", op="mtime", key=key)
        try:
            return os.stat(self._path(key)).st_mtime
        except FileNotFoundError:
            return 0.0

    def touch(self, key: str) -> bool:
        faults.inject("elastic.kv", op="touch", key=key)
        try:
            os.utime(self._path(key), None)
            return True
        except FileNotFoundError:
            return False


class ElasticManager:
    """Per-node membership agent.

    Usage: ``register()`` once, keep the heartbeat alive; the launcher
    polls ``scale_event()`` and, on a change, stops workers at the pass
    boundary, waits for ``wait_for_np()``, and restarts them from the
    latest checkpoint (re-sharded to the new world size — see
    ``train.multihost.ElasticStreamRunner``).

    ``dead_checks`` is the detection hysteresis: a host must be missing
    from that many *consecutive* ``scale_event()`` polls before it is
    confirmed dead (``evict_host`` bypasses the grace — an explicit
    eviction is already a confirmed decision). Joins take effect on the
    first poll that sees them.
    """

    def __init__(self, store: KVStore, job_id: str, host: str,
                 np: int, min_np: int = 0, max_np: int = 0,
                 ttl: float = 10.0, heartbeat_period: Optional[float] = None,
                 dead_checks: int = 1) -> None:
        self.store = store
        self.prefix = f"paddlebox/{job_id}"
        self.node_prefix = f"{self.prefix}/nodes"
        self.host = host
        self.np = np
        self.min_np = min_np or np
        self.max_np = max_np or np
        self.ttl = ttl
        self.heartbeat_period = heartbeat_period or ttl / 3.0
        self.dead_checks = max(int(dead_checks), 1)
        self.level = (ElasticLevel.ELASTIC if self.max_np > self.min_np
                      else ElasticLevel.FAULT_TOLERANCE)
        self._hb_thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._key = f"{self.node_prefix}/{host}"
        self._members: Optional[List[str]] = None
        self._miss_counts: Dict[str, int] = {}
        self._forced_dead: Set[str] = set()
        self._retry = RetryPolicy.from_flags(site="elastic.kv")
        self.last_scale_event_ts = 0.0
        self.last_event: Optional[dict] = None
        self.reshard_count = 0

    # -- membership ---------------------------------------------------------

    def register(self, payload: Optional[dict] = None) -> None:
        body = dict(payload or {})
        body["host"] = self.host
        self._retry.call(self.store.put, self._key,
                         json.dumps(body).encode())
        self._stop.clear()
        self._hb_thread = threading.Thread(
            target=self._heartbeat_loop, daemon=True,
            name=f"elastic-hb-{self.host}")
        self._hb_thread.start()
        self._register_probe()

    def _heartbeat_loop(self) -> None:
        while not self._stop.wait(self.heartbeat_period):
            try:
                alive = self._retry.call(self.store.touch, self._key)
            except Exception:
                # a failed refresh is survivable while the lease TTL
                # holds; the next beat retries
                log.warning("elastic heartbeat refresh failed (%s)",
                            self.host, exc_info=True)
                continue
            if not alive:
                # lease file gone = we were evicted (or deregistered by
                # another thread): do NOT resurrect it — rejoining the
                # job requires an explicit register()
                log.warning("elastic lease for %s disappeared; stopping "
                            "heartbeat (evicted?)", self.host)
                return

    def deregister(self) -> None:
        self._stop.set()
        if self._hb_thread is not None:
            self._hb_thread.join(timeout=2 * self.heartbeat_period)
            self._hb_thread = None
        self.store.delete(self._key)

    def alive_hosts(self) -> List[str]:
        now = time.time()
        hosts = []
        listing = self._retry.call(self.store.list_prefix, self.node_prefix)
        for key in listing:
            if now - self.store.mtime(key) <= self.ttl:
                hosts.append(key.rsplit("/", 1)[-1])
        return sorted(hosts)

    # -- events -------------------------------------------------------------

    def scale_event(self) -> Optional[List[str]]:
        """Returns the new effective-membership list when it changed
        since the last call (the etcd watch-callback analogue), else
        None. A host only *leaves* the effective membership after
        ``dead_checks`` consecutive polls without a fresh lease, or an
        explicit ``evict_host`` — one delayed heartbeat is not a death.
        """
        fresh = set(self.alive_hosts())
        if self._members is None:
            self._members = sorted(fresh)
            return None
        members = set(self._members)
        for host in fresh:
            self._miss_counts.pop(host, None)
            self._forced_dead.discard(host)  # re-registered: clean slate
        confirmed_dead: Set[str] = set()
        for host in members - fresh:
            if host in self._forced_dead:
                confirmed_dead.add(host)
                continue
            misses = self._miss_counts.get(host, 0) + 1
            self._miss_counts[host] = misses
            if misses >= self.dead_checks:
                confirmed_dead.add(host)
        effective = sorted((members - confirmed_dead) | fresh)
        if effective == self._members:
            return None
        lost = sorted(members - set(effective))
        joined = sorted(set(effective) - members)
        log.info("scale event: %s -> %s (lost=%s joined=%s)",
                 self._members, effective, lost, joined)
        self._members = effective
        for host in lost:
            self._miss_counts.pop(host, None)
            self._forced_dead.discard(host)
        self.last_scale_event_ts = time.time()
        self.last_event = {"hosts": effective, "lost": lost,
                           "joined": joined,
                           "ts": self.last_scale_event_ts}
        self._observe_event(effective, lost, joined)
        return effective

    def evict_host(self, host: str, reason: str = "") -> None:
        """Force-remove ``host`` from the membership (the watchdog
        shrink-and-continue rung): delete its lease so its heartbeat
        thread stops at the next beat, and bypass the dead-check grace —
        the next ``scale_event()`` confirms the removal immediately."""
        log.warning("elastic: evicting host %s (%s)", host, reason or "-")
        self._forced_dead.add(host)
        self.store.delete(f"{self.node_prefix}/{host}")

    def world_ok(self) -> bool:
        n = len(self.alive_hosts())
        if self.level == ElasticLevel.FAULT_TOLERANCE:
            return n == self.np
        return self.min_np <= n <= self.max_np

    def wait_for_np(self, timeout: float = 60.0) -> List[str]:
        """Block until the alive set satisfies the level constraints
        (= the rendezvous barrier before a restart). On timeout the
        error names the hosts that were expected but missing."""
        deadline = time.time() + timeout
        attempt = 0
        while time.time() < deadline:
            attempt += 1
            try:
                faults.inject("elastic.rendezvous", attempt=attempt)
                if self.world_ok():
                    hosts = self.alive_hosts()
                    self._members = hosts
                    self._miss_counts.clear()
                    return hosts
            except TransientError:
                # a flaky poll (injected or real) is just a missed
                # observation; the rendezvous window absorbs it
                log.warning("elastic rendezvous poll %d failed; retrying",
                            attempt, exc_info=True)
            time.sleep(self.heartbeat_period)
        alive = []
        try:
            alive = self.alive_hosts()
        except Exception:
            log.warning("elastic rendezvous: final alive poll failed",
                        exc_info=True)
        missing = sorted(set(self._members or []) - set(alive))
        raise TimeoutError(
            f"elastic rendezvous: alive={alive} does not satisfy "
            f"np∈[{self.min_np},{self.max_np}] within {timeout}s"
            + (f"; missing hosts: {missing}" if missing else ""))

    # -- checkpoint pointer (restart resume source) -------------------------

    def publish_checkpoint(self, path: str, pass_id: int) -> None:
        self._retry.call(
            self.store.put, f"{self.prefix}/ckpt",
            json.dumps({"path": path, "pass_id": pass_id}).encode())

    def latest_checkpoint(self) -> Optional[dict]:
        raw = self._retry.call(self.store.get, f"{self.prefix}/ckpt")
        return json.loads(raw) if raw else None

    # -- observability ------------------------------------------------------

    def note_reshard(self, old_np: int, new_np: int, step: int = -1) -> None:
        """Record one completed re-shard (the controller calls this after
        the world is rebuilt at the new size)."""
        self.reshard_count += 1
        try:
            from paddlebox_tpu_torch.obs.hub import get_hub
            hub = get_hub()
            if hub.active:
                hub.counter("pbox_membership_reshards_total",
                            "completed elastic re-shards").inc()
                hub.emit("reshard", old_np=old_np, new_np=new_np,
                         step=step, count=self.reshard_count)
        except Exception:
            log.debug("reshard bookkeeping failed", exc_info=True)

    def membership_status(self) -> dict:
        """The /healthz ``membership`` block (hub membership probe)."""
        members = list(self._members or [])
        return {
            "host": self.host,
            "alive": members,
            "np": len(members) if self._members is not None else self.np,
            "target_np": self.np,
            "min_np": self.min_np,
            "max_np": self.max_np,
            "level": ("ELASTIC" if self.level == ElasticLevel.ELASTIC
                      else "FAULT_TOLERANCE"),
            "last_scale_event_ts": self.last_scale_event_ts,
            "reshard_count": self.reshard_count,
        }

    def _register_probe(self) -> None:
        try:
            from paddlebox_tpu_torch.obs.hub import get_hub
            get_hub().set_membership_probe(self.membership_status)
        except Exception:
            log.debug("membership probe registration failed", exc_info=True)

    def _observe_event(self, hosts: List[str], lost: List[str],
                       joined: List[str]) -> None:
        try:
            from paddlebox_tpu_torch.obs.hub import get_hub
            hub = get_hub()
            if hub.active:
                hub.gauge("pbox_membership_alive",
                          "effective membership size").set(len(hosts))
                hub.gauge("pbox_membership_degraded",
                          "1 while membership below target np").set(
                              1.0 if len(hosts) < self.np else 0.0)
                ctr = hub.counter("pbox_membership_scale_events_total",
                                  "membership scale events")
                if lost:
                    ctr.inc(len(lost), direction="lost")
                if joined:
                    ctr.inc(len(joined), direction="joined")
                hub.emit("membership_change", hosts=list(hosts),
                         lost=list(lost), joined=list(joined),
                         np=len(hosts), target_np=self.np)
        except Exception:
            log.debug("membership event bookkeeping failed", exc_info=True)
        try:
            from paddlebox_tpu_torch.obs import flightrec
            flightrec.trigger(
                "membership_change",
                reason=f"lost={lost} joined={joined}",
                hosts=list(hosts), np=len(hosts), target_np=self.np)
        except Exception:
            log.debug("membership flightrec trigger failed", exc_info=True)
