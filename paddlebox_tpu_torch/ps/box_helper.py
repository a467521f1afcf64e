"""BoxPSHelper — the pass-pipeline driver (BoxHelper/``core.BoxPS`` role);
the port of ``paddlebox_tpu/ps/box_helper.py``, over the port's
``PaddleBoxDataset`` and ``ArtifactStore``.

Reference: fleet/box_wrapper.h:1043-1295 — ``ReadData2Memory`` (:1086),
``PreLoadIntoMemory``/``WaitFeedPassDone`` (:1142,:1156) double-buffered
pass pipelining, and the Python pass protocol in SURVEY.md §3.3:

    ds.preload_into_memory()     # pass k+1 IO overlaps pass k training
    ...train pass k...
    ds.wait_feed_pass_done()
    ds.begin_pass()              # working set → HBM
    trainer.train_pass(ds)
    ds.end_pass(save_delta)      # HBM → host store

Split of work: dataset IO/parse/key-dedup runs on reader
threads (overlappable); the host-store fetch + HBM promotion runs inside
``begin_pass`` after the previous ``end_pass`` write-back, so values are
never stale (the reference's closed PS enforces the same order between
EndPass and the next BeginPass).
"""

from __future__ import annotations

from typing import Optional

from paddlebox_tpu_torch.artifacts import ArtifactLineageError
from paddlebox_tpu_torch.data.dataset import PaddleBoxDataset


class BoxPSHelper:
    """Couples a pass-scoped table (+ optional trainer) to the pass
    protocol. Works with both ``PassScopedTable`` (single chip, backing
    store at ``table.host``) and ``TieredShardedEmbeddingTable`` (mesh,
    per-shard host stores with lifecycle methods on the table itself)."""

    def __init__(self, table, trainer=None) -> None:
        self.table = table
        self.trainer = trainer
        self.pass_id = 0
        #: last artifact published through this helper (the parent
        #: lineage link for the next publish_delta)
        self._published_tip = None

    def _store(self):
        """The full-model lifecycle surface: the single HostStore behind a
        PassScopedTable, or the tiered sharded table itself."""
        return getattr(self.table, "host", self.table)

    # ---- dataset attachment (Paddle-style ds.begin_pass() hooks) ----
    def attach(self, ds: PaddleBoxDataset) -> PaddleBoxDataset:
        ds.on_begin_pass = lambda d: self.begin_pass(d)
        ds.on_end_pass = lambda d, save_delta: self.end_pass(
            d, need_save_delta=save_delta)
        return ds

    # ---- pass protocol ----
    def read_data_to_memory(self, ds: PaddleBoxDataset) -> None:
        """Synchronous load (ReadData2Memory, box_wrapper.h:1086)."""
        ds.load_into_memory()

    def preload_into_memory(self, ds: PaddleBoxDataset) -> None:
        """Start pass k+1's IO while pass k trains (box_wrapper.h:1142)."""
        ds.preload_into_memory()

    def wait_feed_pass_done(self, ds: PaddleBoxDataset) -> None:
        ds.wait_preload_done()

    def stage_pass(self, ds: PaddleBoxDataset) -> None:
        """Overlap the NEXT pass's host-tier fetch with the OPEN pass's
        training (pre_build_thread, ps_gpu_wrapper.cc:913) — tiered
        tables only fetch keys missing from the resident HBM window,
        which are by construction outside the open pass's write-back
        set. Call after wait_feed_pass_done(ds_next), while the current
        pass still trains; the later begin_pass(ds_next) consumes the
        stage after reconciling it against the window.

        Overlap (staging while a pass is open) requires a table with the
        persistent-window reconcile (``supports_overlap_stage`` — both
        PassScopedTable and the tiered sharded tables have it; the guard
        below protects third-party tables without it)."""
        if (getattr(self.table, "in_pass", False)
                and not getattr(self.table, "supports_overlap_stage",
                                False)):
            raise RuntimeError(
                f"{type(self.table).__name__} cannot stage while a pass "
                "is open — call stage_pass between end_pass and "
                "begin_pass, or use a tiered sharded table")
        if getattr(self.table, "wants_slot_keys", False):
            self.table.stage(*ds.pass_key_slots())
        else:
            self.table.stage(ds.pass_keys())

    def begin_pass(self, ds: PaddleBoxDataset) -> int:
        """Promote the pass working set into the card's window and point
        the trainer's state at it."""
        self.pass_id += 1
        if getattr(self.table, "wants_slot_keys", False):
            # multi-mf tiered: keys route by their slot's dim class
            n = self.table.begin_pass(*ds.pass_key_slots())
        else:
            n = self.table.begin_pass(ds.pass_keys())
        if self.trainer is not None:
            self.trainer.adopt_table()
        return n

    def train_pass(self, ds: PaddleBoxDataset, **kw) -> dict:
        if self.trainer is None:
            raise RuntimeError("no trainer bound")
        return self.trainer.train_pass(ds, **kw)

    def end_pass(self, ds: Optional[PaddleBoxDataset] = None,
                 need_save_delta: bool = False,
                 delta_path: Optional[str] = None) -> int:
        """Close the pass. With the async epilogue (ps/epilogue,
        FLAGS.async_end_pass) ``table.end_pass()`` returns in dispatch
        time and the HBM→host write-back drains in the background —
        the delta dump below fences implicitly (every HostStore read
        entry point drains the epilogue first), so the saved delta
        always contains the full pass."""
        if self.trainer is not None:
            self.trainer.sync_table()
        n = self.table.end_pass()
        if need_save_delta:
            path = delta_path or f"xbox_delta_pass{self.pass_id}.npz"
            self._store().save_delta(path)
        return n

    def fence(self) -> None:
        """Drain the table's async end_pass epilogue (no-op for tables
        without one); surfaces the first write-back failure."""
        f = getattr(self.table, "fence", None)
        if f is not None:
            f()

    # ---- model lifecycle (box_helper_py.cc:70-165) ----
    def save_base(self, path: str) -> int:
        return self._store().save_base(path)

    def save_delta(self, path: str) -> int:
        return self._store().save_delta(path)

    # ---- versioned publishing (artifacts.ArtifactStore — the xbox
    # day/delta publish flow, docs/RESILIENCE.md §Publishing) ----
    # Two-phase flag discipline: the save STAGES with
    # clear_touched=False (writer callables dump straight into the
    # store's stage dir), and the delta bookkeeping is cleared only
    # AFTER the publish commits — a publish that fails (or crashes)
    # between the two loses no delta rows; the retry re-exports them.

    def _publish_store(self):
        """The staged-publish capability check: a clear error up front
        beats a TypeError from inside the stage writer for table types
        whose save surface predates the two-phase kwargs."""
        store = self._store()
        if not hasattr(store, "clear_touched_flags"):
            raise TypeError(
                f"{type(store).__name__} does not support staged "
                "publishing — it needs save_base/save_delta("
                "clear_touched=) plus clear_touched_flags() "
                "(EmbeddingTable, HostStore and the tiered sharded "
                "table have them); save to a file and publish the "
                "path instead")
        return store

    def publish_base(self, artifacts, **meta) -> str:
        """``save_base`` straight into a crash-safe artifact version;
        returns the artifact id, which becomes the parent of the next
        :meth:`publish_delta`."""
        self._check_no_pass("publish_base")
        store = self._publish_store()
        self.fence()
        refs = {}
        manifest_fn = getattr(self.table, "spill_manifest", None)
        if manifest_fn is not None:
            m = manifest_fn()
            if m:
                refs["spill_manifest"] = {"digest": m.get("digest"),
                                          "live_rows": m.get("live_rows")}
        aid = artifacts.publish(
            {"sparse.npz":
             lambda p: store.save_base(p, clear_touched=False)},
            kind="base", refs=refs,
            meta={"pass_id": self.pass_id, "producer": "box_helper",
                  **meta})
        store.clear_touched_flags()   # the publish COMMITTED
        self._published_tip = aid
        return aid

    def publish_delta(self, artifacts, **meta) -> str:
        """``save_delta`` as a lineage-linked artifact version on top
        of the last publish through THIS helper. Refuses without a
        published parent — an unparented delta could never be
        chain-verified by a consumer (serving.ServingModel.adopt)."""
        parent = getattr(self, "_published_tip", None)
        if parent is None:
            raise ArtifactLineageError(
                "publish_delta before any publish_base — the delta "
                "would have no verifiable parent version")
        self._check_no_pass("publish_delta")
        store = self._publish_store()
        self.fence()
        aid = artifacts.publish(
            {"sparse_delta.npz":
             lambda p: store.save_delta(p, clear_touched=False)},
            kind="delta", parent=parent,
            meta={"pass_id": self.pass_id, "producer": "box_helper",
                  **meta})
        store.clear_touched_flags()   # the publish COMMITTED
        self._published_tip = aid
        return aid

    def _check_no_pass(self, what: str) -> None:
        """Refuse host-tier mutation BEFORE applying it when a pass is
        open — the guard must precede the mutation or a caller that
        catches the error is left with a half-applied lifecycle op whose
        load/decay the still-resident window would overwrite at
        end_pass (tiered tables guard internally; this covers the
        PassScopedTable path where the store is mutated directly)."""
        if getattr(self.table, "in_pass", False):
            raise RuntimeError(
                f"{what} while a pass is open — the window's updates "
                "are not in the host store yet; end_pass first")

    def _invalidate_window(self) -> None:
        """After a host-tier mutation through a store that is NOT the
        table itself (PassScopedTable's HostStore), resident window rows
        would shadow the updated host values — drop them. Tiered tables
        drop their own window inside load/shrink/merge."""
        if (self._store() is not self.table
                and hasattr(self.table, "drop_window")):
            self.table.drop_window()

    def load_model(self, path: str, merge: bool = False) -> int:
        self._check_no_pass("load_model")
        self.fence()  # an in-flight write-back must not land atop a load
        n = self._store().load(path, merge=merge)
        self._invalidate_window()
        return n

    def shrink_table(self, **kw) -> int:
        self._check_no_pass("shrink_table")
        self.fence()  # decay/score must see every written-back row
        store = self._store()
        if store is self.table:  # tiered: scores with its own cfg coeffs
            return store.shrink(**kw)
        # score with the table's optimizer coefficients so host- and
        # device-side shrink agree on what to drop
        kw.setdefault("nonclk_coeff", self.table.cfg.nonclk_coeff)
        kw.setdefault("clk_coeff", self.table.cfg.clk_coeff)
        n = store.shrink(**kw)
        self._invalidate_window()
        return n
