"""Versioned, crash-safe artifact/publishing layer (copy of
``paddlebox_tpu/artifacts.py``): the
"xbox publish" flow, day/delta model shipping from training to serving.
The on-disk layout and the ``MANIFEST.json`` schema are the reference's
byte for byte, so a store either package publishes opens and verifies
under the other.

One registry directory, where a published version is one
self-describing, checksummed manifest:

    <root>/
        versions/<aid>/
            MANIFEST.json       (see below)
            MANIFEST.sha256     (sidecar digest of the manifest itself)
            <payload files>     (sparse.npz / sparse_delta.npz /
                                 dense.pt / cursor.json / ...)
        leases/<aid>.<pid>-<token>.lease   (reader lease files)
        .stage-<pid>-<token>/   (in-flight publishes; swept when the
                                 writer is provably dead)

``MANIFEST.json``::

    {"format": 1,
     "artifact": "v0000000007",     # the version's id (aid)
     "epoch": 7,                    # monotone publish counter
     "kind": "base" | "delta",
     "parent": "v0000000006",       # lineage link (delta chains); null
                                    # for a base
     "created_unix": 1754...,
     "writer": {"pid": ..., "host": ...},
     "files": {"sparse_delta.npz": {"sha256": "...", "bytes": N}, ...},
     "refs": {"spill_manifest": {...}, "cursor": {...}},  # references,
                                    # not payloads: SSD spill-manifest
                                    # digest, stream-cursor position
     "meta": {...}}                 # producer extras (step, pass id...)

Robustness contract:

- **Atomic publish**: payloads + manifest land in a stage dir, every
  file AND the dir are fsynced, then ONE ``os.replace`` makes the
  version visible (the ``utils/fsio.atomic_write_json`` discipline at
  directory granularity). A crash mid-publish leaves a stage carcass,
  never a half-readable version; carcasses from provably-dead writers
  are swept on store open.
- **Verify before adopt**: ``open()`` verifies the FULL checksum chain
  (manifest sidecar, every payload, every lineage parent) before any
  consumer touches state, refuses loudly (``ArtifactCorruptError``) on
  the first mismatch, and — when no explicit version was requested —
  degrades to the newest version that DOES verify.
- **Lease-fenced readers**: ``open()`` takes a lease file (pid +
  heartbeat mtime) before verifying, so the retention sweep can never
  delete a version out from under a reader mid-adoption. Retention
  reaps only provably-stale leases (same-host dead pid, or heartbeat
  older than the TTL) — and because wall-clock staleness can reap a
  merely-PAUSED reader (SIGSTOP/debugger), every handle access
  re-checks the lease file and raises ``ArtifactLeaseLostError``
  instead of serving from possibly-swept files; the reader re-opens.
- **Retention**: ``retain(keep)`` keeps the newest ``keep`` versions,
  every leased version, and the transitive parent lineage of everything
  kept (a delta restores through its whole chain), then sweeps the
  rest.

Fault seams (resilience/faults.py): ``artifact.publish`` fires just
before the atomic publish rename (a ``fail`` is a crash-mid-publish; a
transient one retries on the seeded RetryPolicy), ``artifact.read``
fires on every manifest/payload read (``corrupt`` mangles the bytes so
the checksum verify refuses).

"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import secrets
import shutil
import socket
import time
from typing import Callable, Dict, List, Optional, Union

from paddlebox_tpu_torch.resilience import faults
from paddlebox_tpu_torch.resilience.retry import RetryPolicy, TransientError
from paddlebox_tpu_torch.utils.fsio import atomic_write_json

log = logging.getLogger(__name__)

MANIFEST = "MANIFEST.json"
MANIFEST_SIDECAR = "MANIFEST.sha256"
_FORMAT = 1
# a reader lease whose heartbeat is older than this (or whose same-host
# writer pid is dead) may be reaped by the retention sweep
LEASE_TTL_SEC = 300.0


class ArtifactCorruptError(RuntimeError):
    """A version's manifest or payload fails its recorded sha256 (or
    the manifest is torn/unreadable) — the version must not be adopted.
    ``ArtifactStore.open()`` degrades to the newest verifiable version
    when no explicit version was requested."""


class ArtifactLineageError(RuntimeError):
    """A delta's lineage does not extend the consumer's current state
    (wrong/unknown parent, or a chain that never reaches a base) —
    applying it would silently merge out-of-order rows."""


class ArtifactLeaseLostError(RuntimeError):
    """The reader's lease file is gone (reaped as stale while the
    reader was paused, or released elsewhere) — the version's files may
    already be swept. Re-open the store instead of serving from them."""


# ---------------------------------------------------------------------------
# small helpers
# ---------------------------------------------------------------------------

def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except (PermissionError, OSError):
        return True  # exists but not ours / can't tell: assume alive
    return True


def _hostname() -> str:
    try:
        return socket.gethostname()
    except OSError:
        return "unknown"


def _io_retry(site: str) -> RetryPolicy:
    return RetryPolicy.from_flags(site=site,
                                  retryable=(OSError, TransientError))


def _read_bytes(path: str, seam: Optional[str] = "artifact.read") -> bytes:
    """Read a registry file through the ``artifact.read`` fault seam
    (transient failures retry; ``corrupt`` mangles the bytes so the
    caller's digest check refuses)."""
    def read() -> bytes:
        with open(path, "rb") as fh:
            blob = fh.read()
        if seam:
            blob = faults.inject(seam, blob, path=path)
        return blob
    return _io_retry("artifact.read").call(read)


def file_digest(path: str, seam: Optional[str] = "artifact.read",
                chunk: int = 1 << 20) -> str:
    """Streaming sha256 of a registry file (payloads can be multi-GB —
    never buffer them whole), read through the fault seam: the seam
    fires once per file on the first chunk, which is where ``corrupt``
    mangles and where a transient ``fail`` raises into the retry."""
    def digest() -> str:
        h = hashlib.sha256()
        with open(path, "rb") as fh:
            buf = fh.read(chunk)
            if seam:
                buf = faults.inject(seam, buf, path=path)
            while buf:
                h.update(buf)
                buf = fh.read(chunk)
        return h.hexdigest()
    return _io_retry("artifact.read").call(digest)


def hardlink_or_copy(src: str, dst: str) -> None:
    """Hardlink a payload into a stage dir (free for same-filesystem
    publishes of already-written checkpoint files — both sides treat
    the bytes as immutable once published) or copy when linking is
    unsupported (cross-device, FUSE)."""
    try:
        os.link(src, dst)
    except OSError:
        shutil.copyfile(src, dst)


def _fsync_file(path: str) -> None:
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass  # FUSE/NFS may refuse; the rename convention still holds
    finally:
        os.close(fd)


def _counter(name: str, help_: str, **labels) -> None:
    try:
        from paddlebox_tpu_torch.obs.hub import get_hub
        get_hub().counter(name, help_).inc(**labels)
    except Exception:
        log.debug("artifact counter failed", exc_info=True)


def _emit(event: str, **fields) -> None:
    try:
        from paddlebox_tpu_torch.obs.hub import get_hub
        hub = get_hub()
        if hub.active:
            hub.emit(event, **fields)
    except Exception:
        log.debug("artifact event emit failed", exc_info=True)


# ---------------------------------------------------------------------------
# leases
# ---------------------------------------------------------------------------

class Lease:
    """One reader's claim on one artifact (or checkpoint step): a file
    whose mtime is the heartbeat. The lease FENCES reads — every access
    through :meth:`check` verifies the file still exists, so a reader
    whose lease was reaped while it was paused (SIGSTOP, debugger, VM
    migration) finds out on its next read instead of serving from files
    the retention sweep may already have deleted."""

    def __init__(self, registry: "LeaseRegistry", name: str,
                 path: str) -> None:
        self.registry = registry
        self.name = name
        self.path = path
        self._released = False

    def alive(self) -> bool:
        return not self._released and os.path.isfile(self.path)

    def check(self) -> None:
        """Raise ``ArtifactLeaseLostError`` unless the lease still
        holds. Called by every handle access — the reader-side half of
        the stale-lease protocol (reaping alone cannot be safe: the
        reaper can only prove staleness, not reader death). A passing
        check also refreshes the heartbeat, so an ACTIVELY reading
        consumer never ages past the TTL — only idle (or same-host
        dead) holders can be reaped."""
        if not self.alive():
            raise ArtifactLeaseLostError(
                f"lease {self.name!r} ({os.path.basename(self.path)}) "
                "is gone — it was reaped as stale (or released); the "
                "leased files may already be swept. Re-open the store "
                "to adopt a live version.")
        try:
            os.utime(self.path, None)
        except OSError:
            pass  # raced with a reap: the next access fences

    def heartbeat(self) -> None:
        """Refresh the lease mtime; raises if the lease was lost (a
        paused reader must re-open, never resurrect a reaped lease —
        the sweep may already be deleting its files)."""
        self.check()
        try:
            os.utime(self.path, None)
        except OSError as e:
            raise ArtifactLeaseLostError(
                f"lease {self.name!r} heartbeat failed: {e!r}") from e

    def release(self) -> None:
        if self._released:
            return
        self._released = True
        try:
            os.unlink(self.path)
        except OSError:
            pass

    def __enter__(self) -> "Lease":
        return self

    def __exit__(self, *exc) -> None:
        self.release()


class LeaseRegistry:
    """Shared-dir lease files: ``<name>.<pid>-<token>.lease`` holding
    ``{name, pid, host, created_unix}``. Heartbeat = file mtime (the
    heartbeat-store convention from obs/watchdog). A lease is
    **provably stale** when its writer pid is dead on OUR host, or its
    heartbeat mtime is older than ``ttl_sec`` — those are the only
    leases :meth:`reap_stale` removes."""

    SUFFIX = ".lease"

    def __init__(self, root: str, ttl_sec: float = LEASE_TTL_SEC) -> None:
        self.root = root
        self.ttl_sec = float(ttl_sec)
        os.makedirs(root, exist_ok=True)

    # ---- acquire -------------------------------------------------------
    def acquire(self, name: str) -> Lease:
        token = secrets.token_hex(4)
        fname = f"{name}.{os.getpid()}-{token}{self.SUFFIX}"
        path = os.path.join(self.root, fname)
        atomic_write_json(path, {"name": name, "pid": os.getpid(),
                                 "host": _hostname(),
                                 "created_unix": time.time()})
        return Lease(self, name, path)

    # ---- enumeration ---------------------------------------------------
    def _entries(self) -> List[str]:
        try:
            return [n for n in os.listdir(self.root)
                    if n.endswith(self.SUFFIX)]
        except OSError:
            return []

    def _name_of(self, fname: str) -> str:
        # "<name>.<pid>-<token>.lease" — name may itself contain dots
        return fname[:-len(self.SUFFIX)].rsplit(".", 1)[0]

    def _is_stale(self, fname: str) -> bool:
        """Provably stale: the holder pid is dead on OUR host — or,
        for a lease we cannot test liveness on (another host / torn
        file), a heartbeat older than the TTL. A same-host ALIVE
        holder is never stale, however old its heartbeat: a reader
        blocked in a long chain load is a slow reader, not a dead
        one."""
        path = os.path.join(self.root, fname)
        info = {}
        try:
            with open(path) as fh:
                info = json.load(fh)
        except (OSError, ValueError):
            pass
        try:
            if info.get("host") == _hostname():
                return not _pid_alive(int(info["pid"]))
        except (ValueError, KeyError, TypeError):
            pass
        try:
            age = time.time() - os.stat(path).st_mtime
        except OSError:
            return False  # raced away — someone else handled it
        return self.ttl_sec >= 0 and age > self.ttl_sec

    def holders(self, name: str, include_stale: bool = False) -> List[str]:
        """Lease files currently claiming ``name`` (provably-stale ones
        excluded unless asked for)."""
        out = []
        for fname in self._entries():
            if self._name_of(fname) != name:
                continue
            if include_stale or not self._is_stale(fname):
                out.append(os.path.join(self.root, fname))
        return out

    def held(self, name: str) -> bool:
        return bool(self.holders(name))

    def active_names(self) -> List[str]:
        """Names with at least one live (non-stale) lease."""
        out = set()
        for fname in self._entries():
            if not self._is_stale(fname):
                out.add(self._name_of(fname))
        return sorted(out)

    # ---- reaping -------------------------------------------------------
    def reap_stale(self) -> List[str]:
        """Remove provably-stale leases; returns the reaped names. A
        PAUSED reader past the TTL is reaped too — that is the
        unavoidable half of wall-clock staleness; the reader-side
        ``Lease.check`` fence is what keeps it safe (the resumed reader
        refuses to serve and re-opens)."""
        reaped = []
        for fname in self._entries():
            if self._is_stale(fname):
                try:
                    os.unlink(os.path.join(self.root, fname))
                    reaped.append(self._name_of(fname))
                    log.warning("reaped stale lease %s", fname)
                except OSError:
                    pass
        return reaped


# ---------------------------------------------------------------------------
# the store
# ---------------------------------------------------------------------------

#: a payload source: an existing file (hardlinked/copied in) or a
#: writer callable invoked with the stage-dir destination path (lets
#: producers like ``EmbeddingTable.save_base`` write straight into the
#: stage with no intermediate copy)
PayloadSource = Union[str, Callable[[str], object]]


class ArtifactHandle:
    """A leased, verified view of one published version (plus its
    lineage chain). Every accessor re-checks the lease — see
    :class:`Lease`."""

    def __init__(self, store: "ArtifactStore", chain: List[dict],
                 lease: Lease) -> None:
        self.store = store
        self.chain = chain          # manifests, base → ... → target
        self.lease = lease

    @property
    def aid(self) -> str:
        return self.chain[-1]["artifact"]

    @property
    def manifest(self) -> dict:
        return self.chain[-1]

    def heartbeat(self) -> None:
        self.lease.heartbeat()

    def path(self, name: str, aid: Optional[str] = None) -> str:
        """Absolute path of payload ``name`` in version ``aid``
        (default: the handle's target). Lease-fenced."""
        self.lease.check()
        aid = self.aid if aid is None else aid
        p = os.path.join(self.store.version_dir(aid), name)
        if not os.path.isfile(p):
            raise FileNotFoundError(
                f"artifact {aid} has no payload {name!r}")
        return p

    def read(self, name: str, aid: Optional[str] = None) -> bytes:
        """Payload bytes, lease-fenced AND re-verified against the
        manifest checksum (belt for readers that hold a handle across
        a long pause: even if the files were swept+recreated, a stale
        read can never return silently-wrong bytes)."""
        self.lease.check()
        aid = self.aid if aid is None else aid
        m = next(m for m in self.chain if m["artifact"] == aid)
        blob = _read_bytes(os.path.join(self.store.version_dir(aid),
                                        name))
        want = m["files"][name]["sha256"]
        got = hashlib.sha256(blob).hexdigest()
        if got != want:
            raise ArtifactCorruptError(
                f"artifact {aid}/{name}: sha256 {got[:12]}… != manifest "
                f"{want[:12]}…")
        return blob

    def close(self) -> None:
        self.lease.release()

    def __enter__(self) -> "ArtifactHandle":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class ArtifactStore:
    """The registry. See the module docstring for the layout and the
    robustness contract."""

    def __init__(self, root: str, keep: int = 0,
                 lease_ttl_sec: float = LEASE_TTL_SEC,
                 sweep: bool = True) -> None:
        self.root = root
        self.keep = int(keep)   # 0 = retain() keeps everything
        self.versions_dir = os.path.join(root, "versions")
        os.makedirs(self.versions_dir, exist_ok=True)
        self._leases = LeaseRegistry(os.path.join(root, "leases"),
                                     ttl_sec=lease_ttl_sec)
        if sweep:
            self.sweep_carcasses()

    # ---- naming --------------------------------------------------------
    @staticmethod
    def aid_for(epoch: int) -> str:
        return f"v{epoch:010d}"

    @staticmethod
    def epoch_of(aid: str) -> int:
        return int(aid[1:])

    def version_dir(self, aid: str) -> str:
        return os.path.join(self.versions_dir, aid)

    def versions(self) -> List[str]:
        """Published version ids, oldest → newest (only dirs with a
        manifest — a half-swept dir is invisible, like checkpoint
        ``steps()``)."""
        out = []
        try:
            names = os.listdir(self.versions_dir)
        except OSError:
            return []
        for name in names:
            if not name.startswith("v"):
                continue
            try:
                self.epoch_of(name)
            except ValueError:
                continue
            if os.path.isfile(os.path.join(self.versions_dir, name,
                                           MANIFEST)):
                out.append(name)
        return sorted(out, key=self.epoch_of)

    def latest(self) -> Optional[str]:
        vs = self.versions()
        return vs[-1] if vs else None

    def _next_epoch(self) -> int:
        vs = self.versions()
        return (self.epoch_of(vs[-1]) + 1) if vs else 1

    # ---- carcass sweep -------------------------------------------------
    def sweep_carcasses(self) -> List[str]:
        """Remove ``.stage-*`` dirs whose writer is PROVABLY dead: the
        crash-mid-publish leftovers. Proof: the stage marker's (or dir
        name's) pid is dead on OUR host. A same-host pid that is ALIVE
        is never swept — not even past the TTL, a long-running
        multi-GB staging is a live publisher, not a carcass. Only a
        stage provably from another host (marker names a foreign host)
        falls back to the wall-clock TTL rule, where pid liveness
        cannot be tested."""
        swept = []
        try:
            names = os.listdir(self.root)
        except OSError:
            return swept
        for name in names:
            if not name.startswith(".stage-"):
                continue
            path = os.path.join(self.root, name)
            if not os.path.isdir(path):
                continue
            info = {}
            try:
                with open(os.path.join(path, "stage.json")) as fh:
                    info = json.load(fh)
            except (OSError, ValueError):
                pass
            pid = info.get("pid")
            if pid is None:   # marker gone/torn: the dir name has it
                try:
                    pid = int(name.split("-")[1])
                except (IndexError, ValueError):
                    pid = None
            host = info.get("host")
            if host == _hostname():
                dead = pid is not None and not _pid_alive(int(pid))
            elif host is None and pid is not None \
                    and _pid_alive(int(pid)):
                # no host proof but a locally-alive pid: could be OUR
                # live publisher — never sweep on a maybe
                dead = False
            else:
                try:
                    age = time.time() - os.stat(path).st_mtime
                    ttl = self._leases.ttl_sec
                    dead = ttl >= 0 and age > ttl
                except OSError:
                    continue
            if dead:
                shutil.rmtree(path, ignore_errors=True)
                swept.append(name)
                log.warning("swept half-published artifact carcass %s",
                            name)
        return swept

    # ---- publish -------------------------------------------------------
    def publish(self, files: Dict[str, PayloadSource], kind: str = "base",
                parent: Optional[str] = None,
                refs: Optional[dict] = None,
                meta: Optional[dict] = None,
                adoptable: bool = True) -> str:
        """Publish one version; returns its aid. ``files`` maps payload
        name → source path (hardlinked/copied) or writer callable
        (invoked ONCE with the stage destination — retries re-run only
        the commit, so a producer whose writer has side effects, e.g.
        ``save_delta``'s touched-clear, never double-fires). A ``delta``
        must name its ``parent``; lineage is verified at adoption.

        ``adoptable=False`` marks a CHAIN-ONLY link: it participates in
        lineage (and retention's closure) and can be opened explicitly,
        but unpinned ``open(None)`` skips it when picking the newest
        version — the mid-pass backfill links of
        ``CheckpointManager.restore`` use this so a serving reader
        never lands on a half-trained pass state."""
        if kind not in ("base", "delta"):
            raise ValueError(f"unknown artifact kind {kind!r}")
        if kind == "delta" and parent is None:
            raise ArtifactLineageError(
                "a delta artifact must name its parent version — an "
                "unparented delta could never be chain-verified")
        if parent is not None and not os.path.isfile(
                os.path.join(self.version_dir(parent), MANIFEST)):
            raise ArtifactLineageError(
                f"parent artifact {parent!r} is not published in "
                f"{self.root} — publish the base/previous delta first")
        stage = os.path.join(
            self.root, f".stage-{os.getpid()}-{secrets.token_hex(4)}")
        os.makedirs(stage)
        try:
            atomic_write_json(os.path.join(stage, "stage.json"),
                              {"pid": os.getpid(), "host": _hostname(),
                               "created_unix": time.time()})
            checksums: Dict[str, dict] = {}
            for name, src in files.items():
                if name in (MANIFEST, MANIFEST_SIDECAR, "stage.json"):
                    raise ValueError(f"reserved payload name {name!r}")
                dst = os.path.join(stage, name)
                if callable(src):
                    src(dst)
                else:
                    hardlink_or_copy(src, dst)
                # digest WITHOUT the read seam: we just wrote these
                # bytes; the seam models consumer-side reads
                checksums[name] = {
                    "sha256": file_digest(dst, seam=None),
                    "bytes": os.path.getsize(dst)}

            def commit() -> str:
                epoch = self._next_epoch()
                aid = self.aid_for(epoch)
                manifest = {"format": _FORMAT, "artifact": aid,
                            "epoch": epoch, "kind": kind,
                            "parent": parent,
                            "adoptable": bool(adoptable),
                            "created_unix": time.time(),
                            "writer": {"pid": os.getpid(),
                                       "host": _hostname()},
                            "files": checksums, "refs": refs or {},
                            "meta": meta or {}}
                mpath = os.path.join(stage, MANIFEST)
                with open(mpath, "w") as fh:
                    json.dump(manifest, fh, sort_keys=True)
                with open(os.path.join(stage, MANIFEST_SIDECAR),
                          "w") as fh:
                    fh.write(file_digest(mpath, seam=None))
                # the writer-liveness marker protected the stage from
                # the carcass sweep through staging + retries; it must
                # not ride into the published version
                try:
                    os.unlink(os.path.join(stage, "stage.json"))
                except OSError:
                    pass
                # durability: payload bytes AND dir entries hit disk
                # BEFORE the publish rename exposes them
                for name in os.listdir(stage):
                    _fsync_file(os.path.join(stage, name))
                _fsync_file(stage)
                # chaos seam: a "fail" here is the writer dying after
                # staging but before the atomic publish; recovery =
                # carcass sweep + the previous complete version
                faults.inject("artifact.publish", path=stage,
                              artifact=aid)
                # one rename publishes; a concurrent publisher that won
                # this epoch makes the target non-empty → OSError →
                # the retry re-allocates the next epoch
                os.replace(stage, self.version_dir(aid))
                _fsync_file(self.versions_dir)
                return aid

            aid = _io_retry("artifact.publish").call(commit)
        except BaseException as e:
            # a surviving process that failed to publish removes its
            # own stage; an InjectedCrash models the process DYING
            # mid-publish, so the stage stays behind exactly like a
            # real dead writer's — the carcass the sweep handles
            if not isinstance(e, faults.InjectedCrash) \
                    and os.path.isdir(stage):
                shutil.rmtree(stage, ignore_errors=True)
            raise
        _counter("pbox_artifact_published_total",
                 "artifact versions published", kind=kind)
        _emit("artifact_published", artifact=aid, kind=kind,
              parent=parent or "", files=sorted(checksums),
              epoch=self.epoch_of(aid))
        log.info("published artifact %s (%s, parent=%s, %d files)",
                 aid, kind, parent, len(checksums))
        return aid

    # ---- verification --------------------------------------------------
    def read_manifest(self, aid: str, verify: bool = True) -> dict:
        """The version's manifest; ``verify`` checks the sidecar digest
        first (a torn manifest refuses like any corrupt link)."""
        d = self.version_dir(aid)
        mpath = os.path.join(d, MANIFEST)
        try:
            blob = _read_bytes(mpath)
        except (OSError, ValueError) as e:
            raise ArtifactCorruptError(
                f"artifact {aid}: unreadable manifest ({e!r})") from e
        if verify:
            try:
                want = _read_bytes(
                    os.path.join(d, MANIFEST_SIDECAR)).decode().strip()
            except (OSError, ValueError) as e:
                raise ArtifactCorruptError(
                    f"artifact {aid}: unreadable manifest sidecar "
                    f"({e!r})") from e
            got = hashlib.sha256(blob).hexdigest()
            if got != want:
                raise ArtifactCorruptError(
                    f"artifact {aid}: manifest is torn/corrupt (sha256 "
                    f"{got[:12]}… != sidecar {want[:12]}…) — refuse to "
                    "trust this version")
        try:
            m = json.loads(blob)
        except ValueError as e:
            raise ArtifactCorruptError(
                f"artifact {aid}: manifest is not JSON ({e!r})") from e
        if m.get("artifact") != aid:
            raise ArtifactCorruptError(
                f"artifact {aid}: manifest names {m.get('artifact')!r} "
                "— foreign/misplaced version dir")
        return m

    def verify_version(self, aid: str) -> dict:
        """Verify ONE version (manifest + every payload digest);
        returns the manifest. No lineage walk — see verify_chain."""
        m = self.read_manifest(aid)
        d = self.version_dir(aid)
        for name, rec in m.get("files", {}).items():
            p = os.path.join(d, name)
            try:
                got = file_digest(p)
            except OSError as e:
                raise ArtifactCorruptError(
                    f"artifact {aid}/{name}: unreadable ({e!r})") from e
            if got != rec["sha256"]:
                raise ArtifactCorruptError(
                    f"artifact {aid}/{name} is corrupt: sha256 "
                    f"{got[:12]}… != manifest {rec['sha256'][:12]}… — "
                    "refuse to adopt this version")
        return m

    def verify_chain(self, aid: str) -> List[dict]:
        """Verify ``aid`` AND its whole parent lineage down to a base;
        returns the manifests base → … → aid. Every adoption runs this
        BEFORE any consumer state is touched."""
        chain: List[dict] = []
        seen = set()
        cur: Optional[str] = aid
        while cur is not None:
            if cur in seen:
                raise ArtifactCorruptError(
                    f"artifact {aid}: lineage cycle at {cur}")
            seen.add(cur)
            m = self.verify_version(cur)
            chain.append(m)
            parent = m.get("parent")
            if parent is None:
                if m.get("kind") != "base":
                    raise ArtifactLineageError(
                        f"artifact {aid}: chain ends at {cur} which is "
                        f"a {m.get('kind')!r}, not a base — the lineage "
                        "never reaches a full snapshot")
                break
            if not os.path.isdir(self.version_dir(parent)):
                raise ArtifactLineageError(
                    f"artifact {aid}: lineage parent {parent} is gone "
                    "(swept or lost) — the delta chain cannot be "
                    "replayed")
            cur = parent
        chain.reverse()
        return chain

    # ---- adoption ------------------------------------------------------
    def open(self, version: Optional[str] = None) -> ArtifactHandle:
        """Lease + verify + hand out a version. With ``version=None``
        adopts the NEWEST verifiable version, refusing corrupt ones
        loudly along the way (the degrade path); an explicit version
        that fails verification raises instead. The lease is taken
        BEFORE verification so the retention sweep can never race the
        adoption."""
        explicit = version is not None
        candidates = ([version] if explicit
                      else list(reversed(self.versions())))
        if not candidates:
            raise FileNotFoundError(
                f"no published versions in {self.root}")
        last_err: Optional[Exception] = None
        for aid in candidates:
            lease = self._leases.acquire(aid)
            try:
                if not explicit and not self.read_manifest(
                        aid, verify=False).get("adoptable", True):
                    # chain-only link (mid-pass backfill): never the
                    # tip an unpinned reader lands on
                    lease.release()
                    continue
                chain = self.verify_chain(aid)
            except (ArtifactCorruptError, ArtifactLineageError,
                    OSError, ValueError) as e:
                lease.release()
                last_err = e
                reason = ("corrupt"
                          if isinstance(e, ArtifactCorruptError)
                          else "lineage" if isinstance(
                              e, ArtifactLineageError) else "io")
                _counter("pbox_artifact_refused_total",
                         "artifact versions refused at adoption",
                         reason=reason)
                _emit("artifact_refused", artifact=aid, reason=reason,
                      error=repr(e))
                log.error("REFUSING artifact %s: %s", aid, e)
                if explicit:
                    raise
                continue
            _counter("pbox_artifact_adopted_total",
                     "artifact versions adopted by readers",
                     kind=chain[-1].get("kind", "base"))
            _emit("artifact_adopted", artifact=aid,
                  chain=[m["artifact"] for m in chain])
            return ArtifactHandle(self, chain, lease)
        raise last_err if last_err is not None else FileNotFoundError(
            f"no adoptable versions in {self.root}")

    # ---- retention -----------------------------------------------------
    def leased_versions(self) -> List[str]:
        return [n for n in self._leases.active_names()
                if n in set(self.versions())]

    def lease_registry(self) -> LeaseRegistry:
        return self._leases

    def retain(self, keep: Optional[int] = None) -> List[str]:
        """Sweep old versions; returns what was removed. NEVER removes
        a leased version or any lineage parent of a kept one; reaps
        provably-stale leases first. ``keep<=0`` keeps everything (only
        stale leases and carcasses are cleaned)."""
        keep = self.keep if keep is None else keep
        self._leases.reap_stale()
        self.sweep_carcasses()
        vs = self.versions()
        if keep is None or keep <= 0 or len(vs) <= keep:
            return []
        kept = set(vs[-keep:])
        kept.update(self.leased_versions())
        # lineage closure: a kept delta needs its whole parent chain
        frontier = list(kept)
        while frontier:
            aid = frontier.pop()
            try:
                parent = self.read_manifest(aid,
                                            verify=False).get("parent")
            except (ArtifactCorruptError, OSError, ValueError):
                continue  # unreadable: nothing to protect through it
            if parent is not None and parent in set(vs) \
                    and parent not in kept:
                kept.add(parent)
                frontier.append(parent)
        removed = []
        for aid in vs:
            if aid in kept:
                continue
            # narrow the lease-vs-sweep window: a reader may have
            # leased this version AFTER the kept-set snapshot above —
            # re-check right before the delete. (The residual race is
            # closed from the reader side: open() verifies AFTER
            # leasing, so a sweep that slips through surfaces as a
            # loud refusal + degrade/retry, never as silent garbage.)
            if self._leases.held(aid):
                log.info("retention deferring %s (late lease)", aid)
                continue
            shutil.rmtree(self.version_dir(aid), ignore_errors=True)
            removed.append(aid)
            log.info("retention swept artifact %s", aid)
        return removed


# ---------------------------------------------------------------------------
# sidecar helpers (legacy path + manifest coexistence — serving.py)
# ---------------------------------------------------------------------------

def manifest_beside(path: str) -> Optional[dict]:
    """The verified MANIFEST.json sitting next to ``path`` (i.e. the
    payload lives inside a published version dir), or None for a plain
    legacy file. Raises ``ArtifactCorruptError`` on a torn manifest —
    a payload that CLAIMS to be managed never degrades silently."""
    d = os.path.dirname(os.path.abspath(path))
    mpath = os.path.join(d, MANIFEST)
    if not os.path.isfile(mpath):
        return None
    blob = _read_bytes(mpath)
    side = os.path.join(d, MANIFEST_SIDECAR)
    if os.path.isfile(side):
        want = _read_bytes(side).decode().strip()
        got = hashlib.sha256(blob).hexdigest()
        if got != want:
            raise ArtifactCorruptError(
                f"manifest next to {path} is torn/corrupt (sha256 "
                f"{got[:12]}… != sidecar {want[:12]}…)")
    try:
        return json.loads(blob)
    except ValueError as e:
        raise ArtifactCorruptError(
            f"manifest next to {path} is not JSON ({e!r})") from e


def verify_payload(manifest: dict, path: str) -> None:
    """Check one payload file against its manifest record; raises
    ``ArtifactCorruptError`` on mismatch or an unmanifested name."""
    name = os.path.basename(path)
    rec = manifest.get("files", {}).get(name)
    if rec is None:
        raise ArtifactCorruptError(
            f"{name} is not in artifact {manifest.get('artifact')}'s "
            "manifest — refusing an unverifiable payload")
    got = file_digest(path)
    if got != rec["sha256"]:
        raise ArtifactCorruptError(
            f"artifact {manifest.get('artifact')}/{name} is corrupt: "
            f"sha256 {got[:12]}… != manifest {rec['sha256'][:12]}…")
