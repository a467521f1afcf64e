"""Unified checkpoint manager — sparse base/delta + dense state, atomic
(counterpart of ``paddlebox_tpu/train/checkpoint.py``).

Reference surface (SURVEY.md §3.4/§5.4): day-level ``SaveBase`` (full
batch model), incremental ``SaveDelta`` ("xbox delta" for online serving),
dense ``io.save_persistables``, and resume =
``InitializeGPUAndLoadModel(model_path)`` (box_wrapper.cc:1298,1383,1406).

One directory per checkpoint:

    <root>/ckpt-<step>/
        sparse.npz | sparse_delta.npz   (EmbeddingTable save_base/save_delta)
        dense.pt                        (model + optimizer state_dicts + auc)
        cursor.json, metrics.pkl        (mid-pass saves only)
        meta.json, meta.sha256          (step, kind, chain links, digests)
    <root>/LATEST                       (atomic pointer file)

The sparse files are the reference's format (they load in either
package). The dense part is the port's own: ``dense.pt`` is a
``torch.save`` of plain tensors and numbers (``Trainer.dense_snapshot``),
read back with ``weights_only=True``; ``convert.dense_from_jax_checkpoint``
turns a reference ``dense.pkl`` into the same contents.

Writes land in a temp dir then ``os.replace`` — a crash mid-save never
corrupts the latest restorable state (the property the reference gets from
day-level directory convention + AFS rename). ``restore`` replays base +
the delta chain up to the requested step. Retention keeps the last
``keep`` checkpoints but never drops a base an alive delta depends on.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import pickle
import shutil
from typing import Dict, List, Optional

import numpy as np
import torch

from paddlebox_tpu_torch.artifacts import ArtifactStore, LeaseRegistry
from paddlebox_tpu_torch.resilience import faults
from paddlebox_tpu_torch.resilience.retry import RetryPolicy

log = logging.getLogger(__name__)

DENSE = "dense.pt"

#: files whose content digests are recorded in meta.json and verified
#: on restore (meta.json itself is covered by the meta.sha256 sidecar)
_CHECKSUMMED = ("sparse.npz", "sparse_delta.npz", DENSE,
                "cursor.json", "metrics.pkl", "spill_manifest.json")


class CheckpointCorruptError(RuntimeError):
    """A checkpoint file's content digest does not match its meta.json
    record — the chain link is corrupt and must not be restored."""


def _digest(path: str, chunk: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as fh:
        while True:
            buf = fh.read(chunk)
            if not buf:
                break
            h.update(buf)
    return h.hexdigest()


def _io_retry() -> RetryPolicy:
    """Checkpoint file IO runs under the flag-configured retry policy
    (transient NFS/FUSE hiccups on shared checkpoint roots)."""
    return RetryPolicy.from_flags(site="checkpoint.io",
                                  retryable=(OSError,))


def _fsync_path(path: str) -> None:
    """Best-effort durability flush for a file OR directory (directory
    fsync flushes its entries, i.e. renames). Best-effort because some
    FUSE/NFS mounts — the very deployment target of this hardening —
    reject fsync; the write-then-rename convention still holds there,
    so a refusal must not fail the save."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


class CheckpointManager:
    def __init__(self, root: str, keep: int = 3, artifacts=None) -> None:
        self.root = root
        self.keep = keep
        # the step this manager's TRAINER STATE descends from: set by
        # restore() and save(). After a rollback-restore to an older
        # step, the next delta must link to THAT step — not to
        # latest_step(), which may still point at a newer checkpoint of
        # the abandoned timeline (chaining through it would replay
        # abandoned state into the restore).
        self._lineage_tip: Optional[int] = None
        os.makedirs(root, exist_ok=True)
        # reader leases (artifacts.LeaseRegistry): restore() holds one
        # while it adopts a chain, external readers (serving loads,
        # consensus restores) take one via lease(step) — and _retain
        # routes every sweep decision through them, so a concurrent
        # adoption can never have its chain deleted underneath it
        self._leases = LeaseRegistry(os.path.join(root, ".leases"))
        # optional publishing layer: boundary checkpoints also publish
        # as lineage-linked ArtifactStore versions (a path opens one)
        if isinstance(artifacts, str):
            artifacts = ArtifactStore(artifacts)
        self.artifacts = artifacts
        #: last artifact this manager's lineage published/adopted —
        #: the parent link for the next boundary delta publish — and
        #: the checkpoint step it snapshots
        self._artifact_tip: Optional[str] = None
        self._artifact_tip_step: Optional[int] = None
        self._recover()

    def _recover(self) -> None:
        """Finish interrupted re-saves: a crash between the two renames in
        save() leaves 'ckpt-N.old-<pid>' with no 'ckpt-N' — restore the
        aside copy; if both exist the save completed, drop the aside."""
        for name in os.listdir(self.root):
            if ".old-" not in name or not name.startswith("ckpt-"):
                continue
            aside = os.path.join(self.root, name)
            final = os.path.join(self.root, name.split(".old-")[0])
            if os.path.isdir(final):
                shutil.rmtree(aside, ignore_errors=True)
            else:
                os.replace(aside, final)
                log.warning("recovered interrupted checkpoint %s", final)

    # ---- paths ----
    def _dir(self, step: int) -> str:
        return os.path.join(self.root, f"ckpt-{step:012d}")

    def steps(self) -> List[int]:
        """Steps with a complete-looking ``ckpt-*`` dir. A dir missing
        its ``meta.json`` (a half-deleted checkpoint — retention or an
        operator interrupted mid-rmtree) is skipped with a warning
        instead of blowing up the next ``_retain``/``restore``."""
        out = []
        for name in os.listdir(self.root):
            if not name.startswith("ckpt-"):
                continue
            try:
                s = int(name[5:])
            except ValueError:
                continue
            if not os.path.isfile(os.path.join(self.root, name,
                                               "meta.json")):
                log.warning("ignoring half-deleted checkpoint %s "
                            "(no meta.json)", name)
                continue
            out.append(s)
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        p = os.path.join(self.root, "LATEST")
        try:
            with open(p) as fh:
                s = int(fh.read().strip())
            if os.path.isfile(os.path.join(self._dir(s), "meta.json")):
                return s
        except (OSError, ValueError):
            pass
        # stale/missing pointer: fall back to newest dir on disk
        steps = self.steps()
        return steps[-1] if steps else None

    def _meta(self, step: int) -> dict:
        def read() -> dict:
            path = os.path.join(self._dir(step), "meta.json")
            faults.inject("checkpoint.io", path=path)
            with open(path) as fh:
                return json.load(fh)
        return _io_retry().call(read)

    def verify(self, step: int) -> None:
        """Check every checksummed file in ``ckpt-<step>`` against its
        meta.json digest; raises ``CheckpointCorruptError`` on mismatch.
        meta.json itself is covered by its ``meta.sha256`` sidecar, so a
        torn meta write is detected like any other corrupt chain link.
        Checkpoints written before checksums/sidecars existed verify
        trivially."""
        d = self._dir(step)
        side = os.path.join(d, "meta.sha256")
        if os.path.isfile(side):
            want = _io_retry().call(
                lambda: open(side).read().strip())
            got = _io_retry().call(_digest, os.path.join(d, "meta.json"))
            if got != want:
                raise CheckpointCorruptError(
                    f"checkpoint {d}/meta.json is torn/corrupt: sha256 "
                    f"{got[:12]}… != sidecar {want[:12]}… — refuse to "
                    f"trust this chain link. Delete {d} and restore an "
                    "older base, or resave from a healthy trainer.")
        meta = self._meta(step)
        for name, want in meta.get("checksums", {}).items():
            p = os.path.join(d, name)
            got = _io_retry().call(_digest, p)
            if got != want:
                raise CheckpointCorruptError(
                    f"checkpoint {d}/{name} is corrupt: sha256 {got[:12]}… "
                    f"!= recorded {want[:12]}… — refuse to restore this "
                    f"chain link. Delete {d} and restore an older "
                    "base (restore(step=...)), or resave from a healthy "
                    "trainer.")

    # ---- save ----
    def save(self, trainer, step: Optional[int] = None,
             delta: bool = False, cursor: Optional[dict] = None,
             metrics=None, clear_touched: Optional[bool] = None) -> str:
        """Snapshot the trainer. ``delta=True`` = save_delta (rows touched
        since the previous save) referencing the most recent base.

        ``cursor`` marks a MID-PASS checkpoint: the dict (pass position —
        ``Trainer._pass_cursor``, schema v2: batch position + optional
        ``stream`` block for windowed streaming) lands in ``cursor.json``
        so a restart resumes the pass from this position instead of
        replaying it; ``metrics`` (a MetricRegistry) snapshots the metric
        accumulators alongside (``metrics.pkl``). Checkpoints without a
        cursor are pass-boundary checkpoints — as are STREAM-BOUNDARY
        checkpoints, whose cursor's ``stream`` block has an empty open
        window (``latest_boundary_step`` treats both as safe rollback
        targets).

        ``clear_touched`` overrides the touched-row bookkeeping: the
        default (None) clears on cursor-free saves and keeps on cursor
        saves (mid-pass deltas must stay cumulative — see below); stream
        BOUNDARY saves pass ``clear_touched=True`` explicitly, since
        their cursor records stream position, not a mid-pass state."""
        step = trainer.global_step if step is None else step
        base_step = None
        # chain link: the state we descend from — the last step this
        # manager saved or restored (falls back to latest_step() for a
        # fresh manager continuing an existing root)
        prev_step = (self._lineage_tip if self._lineage_tip is not None
                     else self.latest_step())
        if prev_step == step:
            # re-save at the same step: the predecessor is whatever the
            # existing checkpoint pointed at (never itself — _chain loops)
            try:
                old = self._meta(step)
            except (OSError, ValueError, KeyError):
                old = {}
            if delta and old.get("kind") == "base":
                raise ValueError(
                    f"step {step} holds a BASE checkpoint; a delta re-save "
                    "would destroy it and leave an unrestorable chain — "
                    "save a base instead")
            prev_step = old.get("prev_step")
        if delta:
            base_step = self._latest_base()
            if base_step is None:
                raise ValueError("delta save with no base checkpoint yet")
        tmp = os.path.join(self.root, f".tmp-{os.getpid()}-{step}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        trainer.sync_table()
        # drain the async pass epilogue (ps/epilogue) before capturing:
        # a checkpoint published over an in-flight (or silently failed)
        # end_pass write-back would snapshot a host tier missing the
        # pass's rows — preemption/emergency saves come through here too
        fence = getattr(trainer.table, "fence", None)
        if fence is not None:
            fence()
        # mid-pass (cursor) saves must not clear the table's touched
        # set: with the prefetch pipeline preparing ahead, a mid-pass
        # clear drops assigned-but-not-yet-pushed rows from every later
        # delta. A table type without the kwarg fails loudly here —
        # silently clearing would corrupt the chain.
        if clear_touched is None:
            kw = {} if cursor is None else {"clear_touched": False}
        else:
            kw = {"clear_touched": clear_touched}
        if delta:
            n = trainer.table.save_delta(
                os.path.join(tmp, "sparse_delta.npz"), **kw)
        else:
            n = trainer.table.save_base(os.path.join(tmp, "sparse.npz"),
                                        **kw)
        blob = trainer.dense_snapshot()

        def write_dense() -> None:
            path = os.path.join(tmp, DENSE)
            faults.inject("checkpoint.io", path=path)
            torch.save(blob, path)
        _io_retry().call(write_dense)
        if cursor is not None:
            def write_cursor() -> None:
                path = os.path.join(tmp, "cursor.json")
                faults.inject("checkpoint.cursor", path=path, op="save")
                with open(path, "w") as fh:
                    json.dump(cursor, fh)
            _io_retry().call(write_cursor)
            if metrics is not None and len(metrics):
                with open(os.path.join(tmp, "metrics.pkl"), "wb") as fh:
                    pickle.dump(metrics, fh)
        # SSD spill manifest (ps/ssd.py; docs/STORAGE.md): segment paths
        # + sha256 of the table's disk tier AT THIS CHECKPOINT (the
        # manifest call seals the active segment, so every recorded
        # file is immutable from here). The checkpoint itself stays
        # self-contained — save_base/save_delta merged the tier rows —
        # but restore() verifies the recorded segments so a corrupt
        # tier surfaces loudly instead of promoting garbage later.
        manifest_fn = getattr(trainer.table, "spill_manifest", None)
        if manifest_fn is not None:
            manifest = manifest_fn()
            if manifest:
                def write_manifest() -> None:
                    path = os.path.join(tmp, "spill_manifest.json")
                    faults.inject("checkpoint.io", path=path)
                    with open(path, "w") as fh:
                        json.dump(manifest, fh)
                _io_retry().call(write_manifest)
        # content digests: restore refuses a bit-rotted chain link
        # instead of silently loading garbage rows
        checksums: Dict[str, str] = {
            name: _digest(os.path.join(tmp, name))
            for name in _CHECKSUMMED
            if os.path.isfile(os.path.join(tmp, name))}
        with open(os.path.join(tmp, "meta.json"), "w") as fh:
            json.dump({"step": step, "kind": "delta" if delta else "base",
                       "base_step": base_step,
                       "prev_step": prev_step if delta else None,
                       "sparse_rows": n, "checksums": checksums}, fh)
        # meta.sha256 sidecar: a torn meta.json write is detected on
        # verify like any other corrupt chain link
        with open(os.path.join(tmp, "meta.sha256"), "w") as fh:
            fh.write(_digest(os.path.join(tmp, "meta.json")))
        # crash consistency: flush file contents AND the temp dir's
        # entries before the publish rename — otherwise a power cut
        # after os.replace could expose a ckpt dir with empty files
        for name in os.listdir(tmp):
            _fsync_path(os.path.join(tmp, name))
        _fsync_path(tmp)
        # chaos seam: a "fail" fault here models the process dying after
        # writing the temp dir but BEFORE the atomic publish — recovery
        # must come from the rename convention (tests/test_resilience.py)
        faults.inject("checkpoint.save_commit", step=step)
        final = self._dir(step)
        if os.path.isdir(final):
            # move the old dir aside BEFORE the swap — a crash between the
            # two renames leaves either the old or the new dir in place,
            # never neither (latest_step falls back to dirs on disk)
            aside = final + f".old-{os.getpid()}"
            os.replace(final, aside)
            os.replace(tmp, final)
            shutil.rmtree(aside, ignore_errors=True)
        else:
            os.replace(tmp, final)
        _fsync_path(self.root)  # persist the publish rename itself
        self._lineage_tip = step
        self._write_latest(step)
        # BOUNDARY checkpoints (no cursor, or a stream cursor with an
        # empty open window) also publish into the artifact store when
        # one is attached — the day/delta "xbox publish" flow serving
        # consumes (artifacts.py; docs/RESILIENCE.md §Publishing).
        # Mid-pass cursor saves stay checkpoint-only: a consumer must
        # never adopt a state whose pass is half trained.
        stream = cursor.get("stream") if cursor else None
        is_boundary = cursor is None or (
            isinstance(stream, dict) and not stream.get("window_files"))
        if self.artifacts is not None and is_boundary:
            # best-effort: the checkpoint above is already DURABLE — a
            # registry hiccup (ENOSPC, exhausted retries) must not fail
            # the save; the next boundary publish backfills the gap.
            # An InjectedCrash still propagates: it models the process
            # dying, not the registry failing.
            try:
                self._publish_artifact(final, step, delta,
                                       prev_step=prev_step)
            except faults.InjectedCrash:
                raise
            except Exception as e:
                log.error(
                    "artifact publish failed at step %d (checkpoint "
                    "is durable; the next boundary publish will "
                    "backfill the chain): %r", step, e)
        self._retain()
        log.info("checkpoint %s saved at step %d (%d sparse rows%s)",
                 "delta" if delta else "base", step, n,
                 ", mid-pass cursor" if cursor is not None else "")
        return final

    def _write_latest(self, step: int) -> None:
        tmp = os.path.join(self.root, ".LATEST.tmp")
        with open(tmp, "w") as fh:
            fh.write(str(step))
            fh.flush()
            try:
                os.fsync(fh.fileno())
            except OSError:
                pass  # best-effort (FUSE): rename stays atomic
        os.replace(tmp, os.path.join(self.root, "LATEST"))

    # ---- artifact publishing (artifacts.py) ----------------------------
    def _step_artifact_map(self) -> Dict[int, str]:
        """{step: newest published aid} for THIS checkpoint root — ONE
        scan over the store serves a whole backfill/lookup, instead of
        one scan per chain step. The root scope matters: several jobs
        may share one store and step counters overlap — matching on
        step alone could cross-link lineages."""
        me = os.path.abspath(self.root)
        out: Dict[int, str] = {}
        for aid in self.artifacts.versions():   # epoch order: newest
            try:                                # wins per step
                m = self.artifacts.read_manifest(aid, verify=False)
            except Exception:
                continue
            meta = m.get("meta", {})
            if (meta.get("producer") == "checkpoint"
                    and meta.get("root") == me
                    and meta.get("step") is not None):
                out[meta["step"]] = aid
        return out

    def _lookup_step_artifact(self, step: int) -> Optional[str]:
        return self._step_artifact_map().get(step)

    def _is_boundary_step(self, step: int) -> bool:
        """Whether ``ckpt-<step>`` is a BOUNDARY checkpoint (no cursor,
        or a stream cursor with an empty open window) — the
        latest_boundary_step rule, for one step."""
        path = os.path.join(self._dir(step), "cursor.json")
        if not os.path.isfile(path):
            return True
        try:
            with open(path) as fh:
                stream = json.load(fh).get("stream")
        except (OSError, ValueError, AttributeError):
            return False
        return isinstance(stream, dict) \
            and not stream.get("window_files")

    def _backfill_artifacts(self, chain: List[int],
                            boundaries_only: bool = False
                            ) -> Optional[str]:
        """Publish the checkpoint-chain steps missing from the store,
        oldest first, parent-linking successively — the chain-heal
        path. Used (a) by ``restore()`` onto a step that never
        published (publishing would otherwise halt until the next base
        — and linking past the gap would lose the gap's rows), with
        the FULL chain so the restored state is exactly representable;
        and (b) before a delta publish whose predecessor boundary
        failed to publish, with ``boundaries_only=True`` (mid-pass
        deltas are subsets of their boundary's cumulative delta, so
        only unpublished BOUNDARIES break the chain). Leaves
        ``_artifact_tip`` at the newest published link."""
        start = 0
        self._artifact_tip = self._artifact_tip_step = None
        published = self._step_artifact_map()   # ONE store scan
        for i in reversed(range(len(chain))):
            aid = published.get(chain[i])
            if aid is not None:
                self._artifact_tip = aid
                self._artifact_tip_step = chain[i]
                start = i + 1
                break
        for s in chain[start:]:
            if boundaries_only and not self._is_boundary_step(s):
                continue
            try:
                meta = self._meta(s)
            except Exception as e:
                log.warning("artifact backfill stopped at step %d "
                            "(%r)", s, e)
                break
            if self._publish_artifact(
                    self._dir(s), s, meta.get("kind") == "delta",
                    prev_step=meta.get("prev_step"),
                    backfill=True) is None:
                break
        return self._artifact_tip

    def _publish_artifact(self, final: str, step: int, delta: bool,
                          prev_step: Optional[int] = None,
                          backfill: bool = False) -> Optional[str]:
        """Publish the just-committed boundary checkpoint dir as an
        artifact version. Payloads hardlink (same filesystem) so the
        publish is metadata-cost; the files are immutable once the
        checkpoint committed. A delta links to the last artifact this
        lineage published — sound because boundary deltas are
        cumulative since the previous boundary CLEAR (mid-pass saves
        never clear the touched set). When the predecessor boundary
        never published (fresh manager, or its publish failed), the
        chain heals first via ``_backfill_artifacts`` — linking past
        an unpublished boundary would silently drop its rows from the
        artifact chain."""
        kind = "delta" if delta else "base"
        parent = None
        if delta:
            if not backfill and prev_step is not None and (
                    self._artifact_tip is None
                    or self._artifact_tip_step != prev_step):
                # the step we descend from has no published artifact
                # under our tip: publish any missing BOUNDARY
                # ancestors before linking (a tip pointing at the last
                # boundary while prev_step is a mid-pass save is the
                # benign case — backfill finds it published and
                # changes nothing)
                try:
                    chain = self._chain(prev_step)
                except Exception:
                    chain = []
                if chain:
                    self._backfill_artifacts(chain,
                                             boundaries_only=True)
            parent = self._artifact_tip
            if parent is None:
                log.warning(
                    "artifact publish skipped at step %d: delta has no "
                    "published parent in %s (publish a base first)",
                    step, self.artifacts.root)
                return None
        files = {name: os.path.join(final, name)
                 for name in sorted(os.listdir(final))
                 if os.path.isfile(os.path.join(final, name))}
        refs: Dict[str, object] = {}
        spill = os.path.join(final, "spill_manifest.json")
        if os.path.isfile(spill):
            try:
                with open(spill) as fh:
                    m = json.load(fh)
                refs["spill_manifest"] = {
                    "file": "spill_manifest.json",
                    "digest": m.get("digest"),
                    "live_rows": m.get("live_rows"),
                    "shards": len(m.get("shards", {}))}
            except (OSError, ValueError):
                pass
        cpath = os.path.join(final, "cursor.json")
        if os.path.isfile(cpath):
            try:
                with open(cpath) as fh:
                    cur = json.load(fh)
                stream = cur.get("stream") or {}
                refs["cursor"] = {
                    "file": "cursor.json",
                    "files_completed": len(
                        stream.get("files_completed", []) or []),
                    "windows_completed": stream.get("windows_completed"),
                    "global_step": cur.get("global_step")}
                if cur.get("lifecycle"):
                    # feature-aging decisions this boundary was built
                    # under (online.OnlineLearner shrink cycles) — the
                    # manifest records the live-key-set provenance so
                    # a consumer can tell WHICH shrink state a version
                    # serves (docs/ONLINE.md)
                    refs["lifecycle"] = dict(cur["lifecycle"])
            except (OSError, ValueError):
                pass
        boundary = self._is_boundary_step(step)
        aid = self.artifacts.publish(
            files, kind=kind, parent=parent, refs=refs,
            # mid-pass links (restore backfill) are chain-only: an
            # unpinned reader must never land on a half-trained pass
            adoptable=boundary,
            meta={"step": step, "producer": "checkpoint",
                  "root": os.path.abspath(self.root),
                  "boundary": boundary})
        self._artifact_tip = aid
        self._artifact_tip_step = step
        self.artifacts.retain()
        return aid

    def _latest_base(self) -> Optional[int]:
        for s in reversed(self.steps()):
            try:
                if self._meta(s)["kind"] == "base":
                    return s
            except (OSError, ValueError, KeyError) as e:
                # a half-deleted/corrupt dir must not kill save/_retain
                log.warning("skipping unreadable checkpoint %d while "
                            "looking for a base: %r", s, e)
        return None

    def has_base(self) -> bool:
        """True once a base checkpoint exists (delta saves are legal)."""
        return self._latest_base() is not None

    # ---- reader leases (artifacts.py; docs/RESILIENCE.md §Publishing) --
    @staticmethod
    def _lease_name(step: int) -> str:
        return f"step-{step}"

    def lease(self, step: int):
        """Claim ``ckpt-<step>`` against retention while adopting it —
        ``with cm.lease(step): ...`` around any out-of-manager read
        (serving load, consensus restore staging). ``restore()`` takes
        one itself. The returned ``Lease`` fences: after a stale-reap,
        its ``check()``/``heartbeat()`` raise ``ArtifactLeaseLostError``
        instead of letting the reader serve from swept files."""
        return self._leases.acquire(self._lease_name(step))

    def _leased_steps(self) -> set:
        out = set()
        for name in self._leases.active_names():
            if name.startswith("step-"):
                try:
                    out.add(int(name[5:]))
                except ValueError:
                    pass
        return out

    def _retain(self) -> None:
        # finish/clean interrupted re-saves too (same logic as init):
        # a long-running process otherwise accumulates aside dirs from
        # crashes it survived without re-instantiating the manager
        self._recover()
        # provably-stale leases (dead same-host pid / heartbeat older
        # than the TTL) are reaped; LIVE leases defer deletion below
        self._leases.reap_stale()
        # sweep half-deleted carcasses: steps() hides meta-less dirs
        # from restore, but their payloads (GBs of sparse.npz) must
        # not accumulate on disk forever
        for name in os.listdir(self.root):
            if not name.startswith("ckpt-") or ".old-" in name:
                continue
            try:
                int(name[5:])
            except ValueError:
                continue
            if not os.path.isfile(os.path.join(self.root, name,
                                               "meta.json")):
                log.warning("removing half-deleted checkpoint %s", name)
                shutil.rmtree(os.path.join(self.root, name),
                              ignore_errors=True)
        steps = self.steps()
        if len(steps) <= self.keep:
            return
        kept = set(steps[-self.keep:])
        # a LEASED step is mid-adoption somewhere (serving load,
        # consensus restore, a restore() in flight) — deleting it (or
        # its chain, closed over below) would hand that reader a
        # half-deleted checkpoint; the lease defers the sweep
        leased = self._leased_steps() & set(steps)
        if leased:
            log.info("retention deferring %s (held leases)",
                     sorted(leased))
            kept |= leased
        # a delta restores by replaying its base + EVERY intermediate
        # delta (each delta covers only rows touched since the previous
        # save) — the whole chain of every kept checkpoint must survive
        for s in kept.copy():
            try:
                kept.update(self._chain(s))
            except (OSError, ValueError, KeyError):
                pass  # broken/half-deleted link: keep what we can
        for s in steps:
            if s not in kept and not self._leases.held(
                    self._lease_name(s)):   # late-lease re-check
                shutil.rmtree(self._dir(s), ignore_errors=True)

    # ---- mid-pass cursor (docs/RESILIENCE.md §Preemption) ----
    def load_cursor(self, step: Optional[int] = None) -> Optional[dict]:
        """The resume cursor stored with ``ckpt-<step>`` (default:
        latest), or None for a pass-boundary checkpoint / no checkpoint.
        An unreadable cursor is treated as absent (the pass replays from
        this step's state) rather than fatal."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        path = os.path.join(self._dir(step), "cursor.json")
        faults.inject("checkpoint.cursor", path=path, op="load")
        if not os.path.isfile(path):
            return None
        try:
            with open(path) as fh:
                return json.load(fh)
        except (OSError, ValueError):
            log.warning("unreadable cursor.json at step %s — ignoring "
                        "(full pass replay)", step)
            return None

    def load_metrics(self, step: Optional[int] = None):
        """The MetricRegistry snapshot stored with a mid-pass
        checkpoint, or None."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        path = os.path.join(self._dir(step), "metrics.pkl")
        if not os.path.isfile(path):
            return None
        try:
            with open(path, "rb") as fh:
                return pickle.load(fh)
        except (OSError, ValueError, pickle.UnpicklingError):
            log.warning("unreadable metrics.pkl at step %s — metric "
                        "accumulators restart for this pass", step)
            return None

    def latest_boundary_step(self) -> Optional[int]:
        """Newest checkpoint at a BOUNDARY — the safe rollback target
        when a mid-pass cursor can't be applied (e.g. the dataset
        changed): either no cursor at all (a pass-boundary checkpoint),
        or a v2 STREAM cursor whose open window is empty (a
        stream-boundary checkpoint: every recorded file is fully
        consumed, nothing needs replay). Read WITHOUT the
        ``checkpoint.cursor`` fault seam: this is a scan, not a resume
        — firing the seam here would shift seeded chaos-plan counters."""
        for s in reversed(self.steps()):
            path = os.path.join(self._dir(s), "cursor.json")
            if not os.path.isfile(path):
                return s
            try:
                with open(path) as fh:
                    cur = json.load(fh)
                stream = cur.get("stream")
            except (OSError, ValueError, AttributeError):
                continue  # unreadable cursor: not provably a boundary
            if isinstance(stream, dict) and not stream.get("window_files"):
                return s
        return None

    def verified_steps(self) -> List[int]:
        """Every step whose ENTIRE base+delta chain verifies locally —
        what a process publishes into the restore consensus
        (resilience/consensus.consensus_restore): agreeing over full
        sets lets the mesh pick a step that exists EVERYWHERE even when
        retention windows drifted apart."""
        out: List[int] = []
        verified: Dict[int, bool] = {}

        def ok(link: int) -> bool:
            if link not in verified:
                try:
                    self.verify(link)
                    verified[link] = True
                except Exception as e:
                    log.warning("step %d fails local verification (%r)",
                                link, e)
                    verified[link] = False
            return verified[link]

        for s in self.steps():
            try:
                if all(ok(link) for link in self._chain(s)):
                    out.append(s)
            except Exception as e:
                log.warning("step %d has a broken chain (%r)", s, e)
        return out

    def latest_verified_step(self) -> Optional[int]:
        """Newest step whose whole chain verifies locally, or None."""
        steps = self.verified_steps()
        return steps[-1] if steps else None

    # ---- restore ----
    def restore(self, trainer, step: Optional[int] = None) -> Optional[int]:
        """Restore to ``step`` (default: latest). Replays the base + delta
        chain for sparse state; returns the restored step or None if no
        checkpoint exists."""
        target = self.latest_step() if step is None else step
        if target is None:
            return None
        # lease the target for the whole adoption: a concurrent
        # _retain (another process sharing this root) must defer the
        # sweep of this chain until the restore finishes
        with self.lease(target):
            chain = self._chain(target)
            for s in chain:  # verify the WHOLE chain before touching state
                self.verify(s)
            self._verify_spill_manifest(target)
            first = True
            for s in chain:
                d = self._dir(s)
                meta = self._meta(s)
                if meta["kind"] == "base":
                    trainer.table.load(os.path.join(d, "sparse.npz"),
                                       merge=not first)
                else:
                    trainer.table.load(os.path.join(d, "sparse_delta.npz"),
                                       merge=True)
                first = False
            def read_dense():
                path = os.path.join(self._dir(target), DENSE)
                faults.inject("checkpoint.io", path=path)
                return read_dense_file(path)
            dense = _io_retry().call(read_dense)
        trainer.restore_state(dense["model"], dense["opt"], dense["auc"],
                              target)
        self._lineage_tip = target
        if self.artifacts is not None:
            # the next boundary delta publish must link to the artifact
            # of the state we now descend from. A restore onto a step
            # that never published (e.g. a mid-pass crash checkpoint)
            # BACKFILLS the missing chain links from the checkpoint
            # dirs — publishing must neither halt until the next base
            # nor link past the gap (the gap's rows would silently
            # leave the artifact chain). Backfilled mid-pass links
            # carry their cursor ref, marking them.
            try:
                tip = self._lookup_step_artifact(target)
                if tip is not None:
                    self._artifact_tip = tip
                    self._artifact_tip_step = target
                else:
                    self._backfill_artifacts(chain)
            except faults.InjectedCrash:
                raise
            except Exception as e:
                # the trainer state is fully restored — a registry
                # failure must not fail the restore; the next boundary
                # publish re-attempts the backfill
                log.error("artifact backfill failed after restore to "
                          "step %d (will retry at the next boundary "
                          "publish): %r", target, e)
        log.info("restored step %d (chain: %s)", target, chain)
        return target

    def _verify_spill_manifest(self, step: int) -> None:
        """Verify the SSD-tier segments recorded with ``ckpt-<step>``
        against their manifest sha256 — the spill-tier link of the
        checksum chain (docs/STORAGE.md). A MISSING segment is fine
        (compaction unlinks dead segments and restore re-imports every
        row from the checkpoint itself); a PRESENT-but-different one is
        real corruption and raising here stops the restore before any
        later promote could read garbage rows."""
        path = os.path.join(self._dir(step), "spill_manifest.json")
        if not os.path.isfile(path):
            return
        try:
            with open(path) as fh:
                manifest = json.load(fh)
        except (OSError, ValueError) as e:
            # the file itself is covered by meta.json checksums — an
            # unreadable manifest that PASSED verify() means a pre-
            # checksum writer; treat as absent
            log.warning("unreadable spill_manifest.json at step %d "
                        "(%r) — skipping tier verification", step, e)
            return
        from paddlebox_tpu_torch.ps.ssd import (SegmentCorruptError,
                                                verify_manifest)
        missing: List[str] = []
        for shard, m in manifest.get("shards", {}).items():
            try:
                missing += verify_manifest(m)
            except SegmentCorruptError as e:
                raise CheckpointCorruptError(
                    f"checkpoint {step} spill manifest (shard {shard}): "
                    f"{e} ") from e
        if missing:
            log.info("spill manifest at step %d: %d segment(s) no "
                     "longer on disk (compacted/reset) — checkpoint is "
                     "self-contained, continuing", step, len(missing))

    def _chain(self, target: int) -> List[int]:
        """base → …deltas… → target, walking each delta's prev_step link
        backwards. A MISSING link raises (each delta covers only rows
        touched since the previous save — a gap would restore silently
        stale rows)."""
        chain = [target]
        cur = target
        while True:
            meta = self._meta(cur)
            if meta["kind"] == "base":
                return chain
            prev = meta.get("prev_step")
            if prev is None:
                # every delta written by this manager records prev_step
                # (the base for the first delta); a missing link means a
                # foreign/corrupt meta — refuse rather than restore with
                # intermediate deltas silently skipped
                raise ValueError(
                    f"delta checkpoint {cur} has no prev_step link — "
                    "unsupported checkpoint format")
            if prev >= cur:
                # a delta can only descend from an OLDER state; a
                # forward link means a foreign/abandoned-timeline meta
                raise ValueError(
                    f"delta checkpoint {cur} links forward to {prev} — "
                    "corrupt or abandoned-timeline chain; restore an "
                    "older base or resave")
            if not os.path.isdir(self._dir(prev)):
                raise FileNotFoundError(
                    f"checkpoint chain broken: {cur} needs {prev} "
                    "(deleted or lost) — restore an older base or resave")
            chain.insert(0, prev)
            cur = prev


def adopt_artifact(trainer, store, version: Optional[str] = None
                   ) -> Optional[int]:
    """Restore a trainer FROM the artifact store alone (no checkpoint
    root needed — the consumer side of the publish flow). Verifies the
    full checksum chain before touching any state, holds the reader
    lease across the whole adoption, and replays base → deltas exactly
    like ``CheckpointManager.restore``. Returns the restored step.

    With ``version=None`` this adopts the newest VERIFIABLE version —
    corrupt tips are refused loudly (``ArtifactCorruptError`` logged +
    ``pbox_artifact_refused_total``) and the adoption degrades to the
    newest chain that checks out."""
    with store.open(version) as h:
        first = True
        for m in h.chain:
            name = ("sparse.npz" if m["kind"] == "base"
                    else "sparse_delta.npz")
            trainer.table.load(h.path(name, m["artifact"]),
                               merge=not first)
            first = False
        dense = read_dense_file(h.path(DENSE))
        step = int(h.manifest.get("meta", {}).get("step") or 0)
    trainer.restore_state(dense["model"], dense["opt"], dense["auc"], step)
    log.info("adopted artifact %s (step %s)", h.aid, step)
    return step


def state_digest(trainer) -> str:
    """sha256 over the trainer's LOGICAL state: every table row keyed and
    sorted by feasign (row-id assignment order cancels out — a resumed
    run allocates rows in another order than an uninterrupted one), then
    every tensor of ``Trainer.dense_snapshot`` (model, optimizer, AUC) in
    sorted-key order with its name. Two trainers with equal digests hold
    byte-identical model state."""
    trainer.sync_table()
    table = trainer.table
    h = hashlib.sha256()
    with table.host_lock:
        keys, rows = table.index.items()
    order = np.argsort(keys)
    keys, rows = keys[order], rows[order]
    h.update(np.ascontiguousarray(keys).tobytes())
    blob = table._gather_host(rows)
    for f in sorted(blob):
        h.update(f.encode())
        h.update(np.ascontiguousarray(blob[f]).tobytes())
    for name, t in _tensor_leaves(trainer.dense_snapshot()):
        h.update(name.encode())
        h.update(np.ascontiguousarray(t.numpy()).tobytes())
    return h.hexdigest()


def elastic_state_digest(trainer) -> str:
    """sha256 over a ``ShardedTrainer``'s LOGICAL state, the same for any
    shard count: every shard's rows keyed by feasign and sorted as one
    list (the ``key % N`` owner and the row order cancel out), then every
    tensor of ``dense_snapshot`` (model, optimizer, the destinations' AUC
    states summed into one), as ``state_digest`` hashes them."""
    trainer.sync_table()
    table = trainer.table
    with table.host_lock:
        per_shard = [table.indexes[s].items() for s in range(table.n)]
    keys = np.concatenate([np.ascontiguousarray(k, np.uint64)
                           for k, _ in per_shard])
    rows = np.concatenate([table._rows_host(s, r)
                           for s, (_, r) in enumerate(per_shard)])
    order = np.argsort(keys, kind="stable")
    h = hashlib.sha256()
    h.update(np.ascontiguousarray(keys[order]).tobytes())
    h.update(np.ascontiguousarray(rows[order]).tobytes())
    for name, t in _tensor_leaves(trainer.dense_snapshot()):
        h.update(name.encode())
        h.update(np.ascontiguousarray(t.numpy()).tobytes())
    return h.hexdigest()


def sharded_state_digest(trainer) -> str:
    """sha256 over a ``ShardedTrainer``'s RAW state: the dense params,
    each shard's whole table state and each destination's AUC state.
    Stricter than ``elastic_state_digest``: the row each key sits in
    counts too, so two schedules over the same batches (``a2a_chunks``)
    must also assign the same rows to digest alike."""
    h = hashlib.sha256()
    for t in trainer.model.state_dict().values():
        h.update(np.ascontiguousarray(t.detach().cpu().numpy()).tobytes())
    for st in trainer.state.tables:
        h.update(st.data.detach().cpu().numpy().tobytes())
    for auc in trainer.state.auc:
        for t in auc:
            h.update(t.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def _tensor_leaves(obj, prefix: str = ""):
    """(path, tensor) of every tensor in a nest of dicts, lists and
    tuples, dict keys in sorted order."""
    if torch.is_tensor(obj):
        yield prefix, obj
    elif isinstance(obj, dict):
        for k in sorted(obj, key=str):
            yield from _tensor_leaves(obj[k], f"{prefix}/{k}")
    elif isinstance(obj, (list, tuple)):
        for i, v in enumerate(obj):
            yield from _tensor_leaves(v, f"{prefix}/{i}")


def read_dense_file(path: str) -> dict:
    """A ``dense.pt`` (``Trainer.dense_snapshot`` contents) on the
    CPU."""
    return torch.load(path, map_location="cpu", weights_only=True)
