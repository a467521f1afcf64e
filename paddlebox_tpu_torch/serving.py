"""Online-serving loader — the consumer of base/delta model exports
(counterpart of ``paddlebox_tpu/serving.py``).

The ``.npz`` files ``EmbeddingTable.save_base/save_delta`` write (in
either package) load into a read-only ``ServingModel`` that answers:

- ``embed_lookup(keys)`` — raw feature rows; unknown keys read zeros;
- ``predict(batch)``     — the full CTR forward (pull → fused_seqpool_cvm
  → DeepFM → sigmoid) with eval semantics: nothing trains;
- ``predict_many(...)``  — micro-batches a request stream through ONE
  snapshot.

Queries never read mutable loader state. Every load materializes an
immutable ``ServingSnapshot`` (copy-on-publish: a frozen key index, the
device table, a host mirror and the dense model, captured together) and
swaps it in with one attribute assignment. A query reads ``self._snap``
once and then works only off that snapshot, so a concurrent reload can
neither block nor tear it.

The consumer side of the artifact store (``artifacts.py``): ``adopt``
verifies a published version's whole checksum and lineage chain under a
reader lease before it touches any state; ``hot_reload`` applies only the
new deltas when the store's tip extends the adopted version (a full
re-adopt otherwise); a payload loaded by path from inside a published
version is verified against its manifest, and a delta whose parent is
not the loaded version is refused. :class:`ReloadLoop` polls the store in
the background and, on a corrupt or torn tip, keeps serving the prior
snapshot, backs off on the seeded retry schedule and reports staleness.
"""

from __future__ import annotations

import copy
import dataclasses
import logging
import os
import threading
import time
from typing import Dict, List, Mapping, Optional, Union

import numpy as np
import torch
from torch import nn

from paddlebox_tpu_torch.artifacts import (ArtifactCorruptError,
                                           ArtifactLineageError,
                                           manifest_beside, verify_payload)
from paddlebox_tpu_torch.config import FLAGS
from paddlebox_tpu_torch.data.batch import BatchBuilder, SlotBatch
from paddlebox_tpu_torch.data.schema import DataFeedDesc
from paddlebox_tpu_torch.device import resolve_device
from paddlebox_tpu_torch.ps.multi_mf import MultiMfEmbeddingTable
from paddlebox_tpu_torch.ps.sgd import SparseSGDConfig
from paddlebox_tpu_torch.ps.table import EmbeddingTable
from paddlebox_tpu_torch.resilience import faults
from paddlebox_tpu_torch.resilience.retry import RetryPolicy
from paddlebox_tpu_torch.train.checkpoint import DENSE, read_dense_file
from paddlebox_tpu_torch.train.multi_mf_step import (class_device_batches,
                                                     multi_mf_forward)
from paddlebox_tpu_torch.train.step import ctr_forward, make_device_batch

log = logging.getLogger(__name__)


class ServingSnapshot:
    """One immutable read view: a frozen ``EmbeddingTable`` (private
    index, its device state), a host mirror of the rows for lookups, the
    dense model and the artifact identity they were captured with.
    Nothing mutates a snapshot after construction."""

    __slots__ = ("table", "model", "host_data", "aid", "epoch",
                 "created_unix", "adopted_ts", "rows")

    def __init__(self, table: EmbeddingTable, model: Optional[nn.Module],
                 host_data: np.ndarray, aid: Optional[str] = None,
                 epoch: Optional[int] = None,
                 created_unix: Optional[float] = None) -> None:
        self.table = table
        self.model = model
        self.host_data = host_data
        self.aid = aid
        self.epoch = epoch
        self.created_unix = created_unix
        self.adopted_ts = time.time()
        self.rows = len(table.index)

    def lookup(self, keys: np.ndarray) -> np.ndarray:
        """[n] uint64 → [n, 3+mf] pull values off the host mirror;
        unknown keys → zeros."""
        return self.table.host_pull(keys, data=self.host_data)

    def digest(self) -> str:
        """sha256 over the snapshot's logical rows sorted by feasign."""
        return self.table.rows_digest()


class ServingModel:
    """Read-only base+delta consumer (the xbox-server role)."""

    def __init__(self, model: nn.Module, desc: DataFeedDesc, mf_dim: int,
                 capacity: int = 1 << 20, use_cvm: bool = True,
                 cvm_offset: int = 2, need_filter: bool = False,
                 quant_ratio: int = 0,
                 cfg: Optional[SparseSGDConfig] = None,
                 device: Union[str, torch.device] = "cuda") -> None:
        """The seqpool knobs (cvm_offset/need_filter/quant_ratio) must
        match the training step that produced the dense params — they
        change the pooled features. ``cfg`` is the table's optimizer
        config (it sets the row width)."""
        self.device = resolve_device(device)
        self.model = model
        self.desc = desc
        self.use_cvm = use_cvm
        self.cvm_offset = cvm_offset
        self.need_filter = need_filter
        self.quant_ratio = quant_ratio
        self.mf_dim = mf_dim
        self.capacity = capacity
        self._cfg = cfg or SparseSGDConfig()
        #: the LOADER table: the working state the load paths mutate.
        #: Queries never read it — they read the snapshot built from it.
        self.table = self._new_table()
        self.params: Optional[nn.Module] = None
        # the one pointer queries read; writers serialize on the lock and
        # assign a fully built replacement
        self._snap: Optional[ServingSnapshot] = None
        self._reload_lock = threading.RLock()
        # the published version the loaded state descends from, and the
        # open handle whose lease pins it while it serves
        self._adopted_aid: Optional[str] = None
        self._handle = None
        # False after a failed/partial chain load: the next reload must
        # re-adopt from scratch instead of stacking deltas on a state of
        # unknown completeness
        self._loader_clean = True
        self._last_reload_ts: Optional[float] = None
        self._staleness_sec = 0.0
        #: what the last store load applied: the adopted version, the
        #: chain index it started from, the versions it loaded, and
        #: whether it began from an empty table
        self.last_load: Optional[Dict[str, object]] = None

    def _new_table(self) -> EmbeddingTable:
        return EmbeddingTable(mf_dim=self.mf_dim, capacity=self.capacity,
                              cfg=self._cfg, device=self.device)

    @property
    def adopted_aid(self) -> Optional[str]:
        return self._adopted_aid

    # ---- loading by path ----
    def _verify_managed(self, path, parent_check: bool) -> Optional[dict]:
        """When ``path`` sits inside a published version dir (a
        MANIFEST.json beside it), verify the payload's sha256 and, for a
        delta, that the version's parent IS the loaded version. Returns
        the manifest, or None for a plain file (or an in-memory mapping).
        A wrong-parent or bit-flipped delta raises instead of merging."""
        m = (manifest_beside(path) if isinstance(path, (str, os.PathLike))
             else None)
        if m is None:
            if parent_check and self._adopted_aid is not None:
                raise ArtifactLineageError(
                    f"refusing unmanaged delta {path!r}: this model was "
                    f"adopted from artifact {self._adopted_aid} and a "
                    "manifest-less delta cannot be lineage-verified — "
                    "publish the delta or load_base a fresh state")
            return None
        verify_payload(m, path)
        if parent_check and m.get("parent") != self._adopted_aid:
            raise ArtifactLineageError(
                f"refusing out-of-order delta {os.path.basename(path)}: "
                f"artifact {m.get('artifact')} descends from "
                f"{m.get('parent')!r} but the loaded state is "
                f"{self._adopted_aid!r} — apply the chain in lineage "
                "order")
        return m

    def load_base(self, path: Union[str, Mapping[str, np.ndarray]]) -> int:
        """Replace the table with a save_base file (or mapping). A base
        inside a published version dir is checksum-verified first and
        pins the lineage every later ``apply_delta`` must extend."""
        with self._reload_lock:
            m = self._verify_managed(path, parent_check=False)
            self._loader_clean = False
            n = self.table.load(path, merge=False)
            self._loader_clean = True
            self._adopted_aid = m.get("artifact") if m else None
            self._rebase_handle(self._adopted_aid)
            self._refresh_snapshot(m)
        return n

    def apply_delta(self, path: Union[str, Mapping[str, np.ndarray]]
                    ) -> int:
        """Apply a save_delta file (or mapping) on top. A delta from a
        published version is verified first (payload sha256, parent ==
        the loaded version); a plain file is refused once the loaded
        state came from an artifact."""
        with self._reload_lock:
            m = self._verify_managed(path, parent_check=True)
            self._loader_clean = False
            n = self.table.load(path, merge=True)
            self._loader_clean = True
            if m is not None:
                self._adopted_aid = m.get("artifact")
            self._rebase_handle(self._adopted_aid)
            self._refresh_snapshot(m)
        return n

    def _rebase_handle(self, aid: Optional[str]) -> None:
        """A path load rebases the lineage: drop a lease on another
        version, which would otherwise pin it against retention while
        nothing serves from it."""
        if self._handle is not None and self._handle.aid != aid:
            self._handle.close()
            self._handle = None

    def _model_from(self, state_dict: Mapping[str, torch.Tensor]
                    ) -> nn.Module:
        model = copy.deepcopy(self.model)
        model.load_state_dict(state_dict)
        return model.to(self.device).eval()

    def load_params(self, state_dict: Mapping[str, torch.Tensor]) -> None:
        """Publish dense params: a copy of the model takes
        ``state_dict`` (see ``convert.deepfm_state_dict_from_flax``) and
        swaps in beside the current table (same frozen table, new
        model), so a dense-only refresh reaches queries at once."""
        model = self._model_from(state_dict)
        with self._reload_lock:
            self.params = model
            snap = self._snap
            if snap is not None:
                self._snap = ServingSnapshot(
                    snap.table, model, snap.host_data, aid=snap.aid,
                    epoch=snap.epoch, created_unix=snap.created_unix)

    def load_dense(self, path: str) -> None:
        """``load_params`` from a file: a checkpoint's ``dense.pt`` or a
        ``Trainer.save`` ``.dense.pt`` (only the model part is used)."""
        self.load_params(read_dense_file(path)["model"])

    # ---- snapshot materialization (copy-on-publish) ----
    def _materialize(self, manifest: Optional[dict]) -> ServingSnapshot:
        """Freeze the loader's current state: a private copy of the key
        index (the loader table is private to this model and never
        trained, and every load builds it a new device state, so that
        state is shared) and one host mirror of the rows."""
        loader = self.table
        with loader.host_lock:
            keys, rows = loader.index.items()
        frozen = self._new_table()
        order = np.argsort(rows)
        if not np.array_equal(frozen.index.assign(keys[order]),
                              rows[order]):
            raise RuntimeError("frozen index allocated other rows than "
                               "the loader")
        frozen.state = loader.state
        host_data = loader.state.data.cpu().numpy()
        m = manifest or {}
        return ServingSnapshot(frozen, self.params, host_data,
                               aid=self._adopted_aid, epoch=m.get("epoch"),
                               created_unix=m.get("created_unix"))

    def _refresh_snapshot(self, manifest: Optional[dict] = None) -> None:
        """Build-then-swap (caller holds ``_reload_lock``)."""
        self._snap = self._materialize(manifest)
        self._last_reload_ts = time.time()
        self._staleness_sec = 0.0

    def snapshot(self) -> ServingSnapshot:
        """The currently serving snapshot (one atomic read; the first
        query before any load materializes the empty table)."""
        snap = self._snap
        if snap is not None:
            return snap
        with self._reload_lock:
            if self._snap is None:
                self._refresh_snapshot()
            return self._snap

    def serving_status(self) -> dict:
        """Adopted version, its epoch and rows, the last reload's wall
        clock, the staleness against the newest published version and
        its verdict against ``FLAGS.serving_staleness_max_sec``."""
        snap = self._snap
        stale_max = FLAGS.serving_staleness_max_sec
        return {
            "adopted": self._adopted_aid,
            "epoch": snap.epoch if snap is not None else None,
            "rows": snap.rows if snap is not None else 0,
            "last_reload_ts": self._last_reload_ts,
            "staleness_sec": round(self._staleness_sec, 3),
            "stale": bool(stale_max > 0
                          and self._staleness_sec > stale_max),
        }

    # ---- store adoption (the lease-fenced consumer path) ----
    def adopt(self, store, version: Optional[str] = None) -> str:
        """Adopt a published version from an ``ArtifactStore``: take a
        reader lease, verify the FULL checksum and lineage chain before
        touching any state, load base → deltas (and the dense model when
        the version carries ``dense.pt``), then swap the snapshot in.
        ``version=None`` adopts the newest verifiable version. Returns
        its id; the lease holds until ``release`` or the next adoption,
        so retention cannot sweep the version while it serves."""
        with self._reload_lock:
            handle = store.open(version)
            self._load_from(handle, start=0, fresh=True)
            log.info("serving: adopted artifact %s (chain %s)", handle.aid,
                     [m["artifact"] for m in handle.chain])
            return handle.aid

    def _load_from(self, handle, start: int, fresh: bool) -> None:
        """Load a (suffix of a) verified chain from an open handle into
        the loader, then swap the snapshot and take over the lease. On
        any failure the handle closes, the old snapshot keeps serving and
        the loader is marked dirty (the next reload re-adopts)."""
        applied = [m["artifact"] for m in handle.chain[start:]]
        try:
            if fresh:
                # copy-on-publish: a FRESH loader absorbs the chain
                self.table = self._new_table()
            self._loader_clean = False
            first = fresh
            for m in handle.chain[start:]:
                name = ("sparse.npz" if m["kind"] == "base"
                        else "sparse_delta.npz")
                self.table.load(handle.path(name, m["artifact"]),
                                merge=not first)
                first = False
            if DENSE in handle.manifest.get("files", {}):
                # set directly: the snapshot below publishes the table
                # and the model together
                self.params = self._model_from(
                    read_dense_file(handle.path(DENSE))["model"])
            self._loader_clean = True
        except BaseException:
            handle.close()
            raise
        if self._handle is not None:
            self._handle.close()
        self._handle = handle
        self._adopted_aid = handle.aid
        self._refresh_snapshot(handle.manifest)
        self.last_load = {"aid": handle.aid, "start": start,
                          "applied": applied, "fresh": fresh}

    def hot_reload(self, store) -> Optional[str]:
        """Advance to the newest verifiable version, applying ONLY the
        new deltas when its chain extends the adopted state; a full
        re-adopt when the lineage diverged or a previous load left the
        loader dirty. None when already current. Queries keep serving
        the prior snapshot until the new one is verified and built."""
        with self._reload_lock:
            handle = store.open()
            if handle.aid == self._adopted_aid:
                handle.close()
                self._staleness_sec = 0.0
                return None
            chain_ids = [m["artifact"] for m in handle.chain]
            if self._adopted_aid in chain_ids and self._loader_clean:
                self._load_from(
                    handle, start=chain_ids.index(self._adopted_aid) + 1,
                    fresh=False)
            else:
                self._load_from(handle, start=0, fresh=True)
            log.info("serving: hot-reloaded to artifact %s", handle.aid)
            return handle.aid

    def release(self) -> None:
        """Drop the artifact lease (retention may then sweep the
        version). Idempotent; readers inside the current snapshot are
        unaffected — its data is in memory."""
        with self._reload_lock:
            if self._handle is not None:
                self._handle.close()
                self._handle = None

    def note_staleness(self, sec: float) -> None:
        """ReloadLoop's staleness report (serving epoch age against the
        newest published version)."""
        self._staleness_sec = float(sec)

    # ---- queries ----
    def embed_lookup(self, keys: np.ndarray) -> np.ndarray:
        """[n] uint64 → [n, 3+mf] pull values (show, clk, w, embedx…);
        unknown keys → zeros."""
        return self.snapshot().lookup(keys)

    def _predict_on(self, snap: ServingSnapshot, batch: SlotBatch,
                    return_valid: bool):
        if snap.model is None:
            raise RuntimeError("load_params first")
        idx = snap.table.prepare_eval(batch)
        dev = make_device_batch(batch, idx, self.device)
        with torch.inference_mode():
            pred, ins_w = ctr_forward(
                snap.table.state, snap.model, dev, batch.batch_size,
                batch.num_slots, self.use_cvm, self.cvm_offset,
                self.need_filter, self.quant_ratio)
        if return_valid:
            return pred.cpu().numpy(), ins_w.cpu().numpy()
        return pred.cpu().numpy()

    def predict(self, batch: SlotBatch, return_valid: bool = False):
        """CTR predictions [B] for one batch (unknown keys pull zeros).

        A batch shorter than ``desc.batch_size`` is padded; padding
        entries hold the net's output on zero rows, NOT real predictions
        — ``return_valid=True`` also returns the 0/1 validity mask."""
        return self._predict_on(self.snapshot(), batch, return_valid)

    def predict_many(self, requests, batch_max: int = 0,
                     return_valid: bool = False):
        """Run a request stream through ONE pinned snapshot.
        ``requests`` is an iterable of ``SlotBatch`` or a sequence of
        ``SlotRecord``; records are micro-batched into chunks of at most
        ``batch_max`` (0 = the desc batch size) and only the valid
        predictions are returned, concatenated."""
        snap = self.snapshot()
        reqs = list(requests)
        preds: List[np.ndarray] = []
        valids: List[np.ndarray] = []

        def run(batch: SlotBatch, n_valid: int) -> None:
            pred, ins_w = self._predict_on(snap, batch, return_valid=True)
            preds.append(pred[:n_valid])
            valids.append(ins_w[:n_valid])

        if reqs and not isinstance(reqs[0], SlotBatch):
            cap = self.desc.batch_size
            chunk = cap if batch_max <= 0 else max(1, min(int(batch_max),
                                                          cap))
            builder = BatchBuilder(
                self.desc if chunk == cap
                else dataclasses.replace(self.desc, batch_size=chunk))
            for i in range(0, len(reqs), chunk):
                part = reqs[i:i + chunk]
                run(builder.build(part), len(part))
        else:
            for b in reqs:
                run(b, b.batch_size)
        if not preds:
            empty = np.empty(0, np.float32)
            return (empty, empty) if return_valid else empty
        pred = np.concatenate(preds)
        if return_valid:
            return pred, np.concatenate(valids)
        return pred


class ReloadLoop:
    """Background hot-reload: polls the ``ArtifactStore`` tip every
    ``FLAGS.serving_reload_poll_sec`` and advances the serving snapshot
    through ``ServingModel.hot_reload``.

    - verify-before-swap: adoption rides the store's lease and full
      checksum-chain verification; the snapshot swaps only after the new
      state is fully built;
    - degrade, never crash or block: a failed poll (corrupt tip, torn
      manifest, IO past its retries, an injected ``serving.reload``
      fault) leaves the prior snapshot serving, counts a refusal and
      re-polls on the seeded RetryPolicy backoff (site
      ``serving.reload``);
    - staleness: how long a newer adoptable version has been published
      without the snapshot advancing (0 when current); past
      ``FLAGS.serving_staleness_max_sec`` the status flips ``stale``.
    """

    def __init__(self, model: ServingModel, store,
                 poll_sec: Optional[float] = None) -> None:
        self.model = model
        self.store = store
        self.poll_sec = (FLAGS.serving_reload_poll_sec
                         if poll_sec is None else float(poll_sec))
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._backoff = None   # armed after a failed poll
        self.polls = 0
        self.adopted = 0
        self.refused = 0
        self.degraded = 0

    def poll_once(self) -> Optional[str]:
        """One reload poll: the newly adopted artifact id, or None when
        already current or the poll failed. Never raises."""
        self.polls += 1
        try:
            faults.inject("serving.reload", op="poll",
                          adopted=self.model.adopted_aid or "")
            aid = self.model.hot_reload(self.store)
        except Exception as e:
            self.refused += 1
            reason = ("corrupt" if isinstance(e, ArtifactCorruptError)
                      else "lineage" if isinstance(e, ArtifactLineageError)
                      else "empty" if isinstance(e, FileNotFoundError)
                      else "io")
            log.error("serving hot-reload REFUSED (%s) — keeping the "
                      "prior snapshot (%s): %s", reason,
                      self.model.adopted_aid, e)
            if self._backoff is None:
                self._backoff = RetryPolicy.from_flags(
                    site="serving.reload").delays()
            self._note_staleness()
            return None
        self._backoff = None
        if aid is not None:
            self.adopted += 1
        self._note_staleness()
        return aid

    def _note_staleness(self) -> None:
        """0 when the snapshot IS the newest adoptable version, else how
        long that version has existed unadopted (a corrupt tip counts:
        that is the degraded state to show)."""
        lag, tip = 0.0, None
        try:
            adopted = self.model.adopted_aid
            for aid in reversed(self.store.versions()):
                try:
                    m = self.store.read_manifest(aid, verify=False)
                except Exception:
                    m = None   # torn manifest: still a newer tip
                if m is not None and not m.get("adoptable", True):
                    continue   # chain-only link: never a serving tip
                tip = aid
                if aid != adopted:
                    created = (m or {}).get("created_unix")
                    if created is None:
                        try:
                            created = os.stat(
                                self.store.version_dir(aid)).st_mtime
                        except OSError:
                            created = time.time()
                    lag = max(0.0, time.time() - float(created))
                break
        except Exception:
            log.debug("staleness probe failed", exc_info=True)
        self.model.note_staleness(lag)
        if lag > 0.0 and tip is not None:
            self.degraded += 1
            if FLAGS.serving_staleness_max_sec > 0 \
                    and lag > FLAGS.serving_staleness_max_sec:
                log.error("serving snapshot STALE: %s published %.1fs "
                          "ago, still serving %s (SLO %.1fs)", tip, lag,
                          self.model.adopted_aid,
                          FLAGS.serving_staleness_max_sec)

    # ---- thread lifecycle ----
    def start(self) -> "ReloadLoop":
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="serving-reload")
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                self.poll_once()
            except Exception:   # poll_once is defensive; belt anyway
                log.warning("reload poll crashed", exc_info=True)
            delay = (next(self._backoff, self.poll_sec)
                     if self._backoff is not None else self.poll_sec)
            self._stop.wait(delay)

    def stop(self, join: bool = True) -> None:
        self._stop.set()
        t = self._thread
        if join and t is not None:
            t.join(timeout=30)
        self._thread = None

    def __enter__(self) -> "ReloadLoop":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


class MultiMfServingModel:
    """Read-only base+delta consumer for MULTI-MF saves (per-slot
    embedding dims, feature_value.h:42-185): loads the per-dim-class
    files ``MultiMfEmbeddingTable.save_base/save_delta`` write
    (``{path}.mf{d}.npz``, either package's), answers per-slot-width
    lookups and full CTR predictions through the canonical slot-ordered
    pooled concat, the forward of ``MultiMfTrainStep``. It has no
    snapshot or hot reload (the reference's has none): loads and queries
    are not meant to overlap."""

    def __init__(self, model: nn.Module, desc: DataFeedDesc, slot_mf_dims,
                 capacity: int = 1 << 20, use_cvm: bool = True,
                 cvm_offset: int = 2,
                 cfg: Optional[SparseSGDConfig] = None,
                 device: Union[str, torch.device] = "cuda") -> None:
        """``model`` takes (flat [B, W], dense); ``cfg`` is the class
        tables' optimizer config (it sets their row widths)."""
        self.device = resolve_device(device)
        self.model = model
        self.desc = desc
        self.use_cvm = use_cvm
        self.cvm_offset = cvm_offset
        self.table = MultiMfEmbeddingTable(
            slot_mf_dims, capacity=capacity, cfg=cfg or SparseSGDConfig(),
            device=self.device)
        self.params: Optional[nn.Module] = None
        self._route = self.table.slot_route()
        self._class_slots = [len(s) for s in self.table.class_slots]

    # ---- artifact loading (the multi-mf save format) ----
    def load_base(self, path: str) -> int:
        """Load a ``MultiMfEmbeddingTable.save_base`` file set."""
        n = self.table.load(path, merge=False)
        log.info("serving: loaded multi-mf base %s (%d rows)", path, n)
        return n

    def apply_delta(self, path: str) -> int:
        n = self.table.load(path, merge=True)
        log.info("serving: applied multi-mf delta %s (%d rows)", path, n)
        return n

    def load_params(self, state_dict: Mapping[str, torch.Tensor]) -> None:
        """A copy of the model takes ``state_dict`` and serves."""
        model = copy.deepcopy(self.model)
        model.load_state_dict(state_dict)
        self.params = model.to(self.device).eval()

    def load_dense(self, path: str) -> None:
        """``load_params`` from a ``dense.pt`` (only the model part)."""
        self.load_params(read_dense_file(path)["model"])

    # ---- queries ----
    def embed_lookup(self, keys: np.ndarray,
                     slots: np.ndarray) -> np.ndarray:
        """[n] keys + their slot ids → [n, 3 + max_mf] pull values with
        PER-SLOT widths (columns beyond the key's slot width are zero) —
        the dy_mf CopyForPull contract. Unknown keys read zeros."""
        return self.table.pull(keys, slots)

    def slot_width(self, slot: int) -> int:
        """Embedding width (3 + mf_dim) served for a slot."""
        return 3 + int(self.table.slot_mf_dims[slot])

    def predict(self, batch: SlotBatch, return_valid: bool = False):
        """CTR predictions [B] (eval semantics: unknown keys read zeros,
        nothing trains); ``return_valid`` also returns the 0/1 mask of
        the batch's real records."""
        if self.params is None:
            raise RuntimeError("load_dense first")
        devs = class_device_batches(self.table.prepare_eval(batch),
                                    self.device)
        with torch.inference_mode():
            pred, ins_w = multi_mf_forward(
                [t.state for t in self.table.tables], self.params, devs,
                batch.batch_size, self._class_slots, self._route,
                self.use_cvm, self.cvm_offset)
        if return_valid:
            return pred.cpu().numpy(), ins_w.cpu().numpy()
        return pred.cpu().numpy()
