"""Seeded end-to-end streaming-ingest check (the port's counterpart of
``scripts/stream_check.py``).

Proves the streaming survival kit deterministically:

1. **oracle** — an uninterrupted windowed stream (``Trainer.train_stream``
   over a windowed ``QueueDataset``, ``FLAGS.stream_window_files``)
   publishes a stream-boundary checkpoint after every window and records
   its logical state digests.
2. **killed** — the same seeded run under a
   ``preempt.signal:fail:nth=K`` plan (simulated SIGTERM at the K-th
   batch boundary, landing mid-window): the stream raises
   ``PreemptedError`` after an emergency checkpoint whose v2 cursor
   records the completed files + the open window.
3. **resume** — a fresh trainer restores the emergency checkpoint and
   ``train_stream`` continues: completed windows are SKIPPED, the open
   window REPLAYS (at-least-once), and the stream runs to the end.

Asserted, per run:

- record accounting (``Trainer.on_batch_trained``): every input record
  trained at-least-once; completed-window records exactly once; only
  open-window records may train twice,
- replay accounting: exactly the open window's files replayed
  (``QueueDataset.files_replayed`` + the telemetry counter),
- ``state_digest`` of the killed run's checkpoint at the LAST COMMON
  WINDOW BOUNDARY equals the no-kill oracle's at the same step,
- ``supports_cursor_resume`` is True in windowed mode while the legacy
  unwindowed stream still refuses ``start_batch != 0``,

and the whole scenario runs twice with the same seed — outcomes must be
byte-identical (streaming recovery is reproducible, not lucky).

Usage::

    python -m paddlebox_tpu_torch.tools.stream_check [--seed 7]
        [--preempt-at 8] [--device cuda|cpu]

The trainers run on the card unless ``--device cpu``.

Exit code 0 == resumed with at-least-once accounting + deterministic.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import shutil
import sys
import tempfile

#: stream geometry: WINDOW files per window, FILES files total,
#: ROWS records per file — small enough for the tier-1 wiring
#: (tests/test_torch_gates.py), big enough for 3 windows with several
#: batches each
WINDOW, FILES, ROWS, BS = 2, 6, 48, 16


def _record_sigs(batch) -> list:
    """Stable per-record signatures of a trained batch (criteo layout:
    one key per slot, record-major key block) — collision-free for the
    synthetic data's random 26-key rows."""
    import numpy as np
    n = int((batch.show > 0).sum())
    S = batch.num_slots
    keys = batch.keys[:n * S].reshape(n, S)
    return [keys[i].tobytes() + bytes([int(batch.label[i])])
            for i in range(n)]


def _file_sigs(files, desc) -> dict:
    """path -> set of record signatures, built the same way the batch
    side builds them (same parser, same key layout)."""
    from paddlebox_tpu_torch.data.parser import get_parser
    out = {}
    for path in files:
        parser = get_parser(desc)
        sigs = set()
        with open(path) as fh:
            for line in fh:
                rec = parser.parse(line)
                if rec is not None:
                    sigs.add(rec.keys.tobytes()
                             + bytes([int(rec.label)]))
        out[path] = sigs
    return out


def run_scenario(workdir: str, seed: int, preempt_at: int,
                 device: str = "cuda") -> dict:
    """One full streaming preemption round-trip on ``device``; returns
    the outcome."""
    import torch

    from paddlebox_tpu_torch.config import flags_scope
    from paddlebox_tpu_torch.data import DataFeedDesc, DatasetFactory
    from paddlebox_tpu_torch.data.criteo import generate_criteo_files
    from paddlebox_tpu_torch.models import CtrDnn
    from paddlebox_tpu_torch.obs.hub import reset_hub
    from paddlebox_tpu_torch.ps.sgd import SparseSGDConfig
    from paddlebox_tpu_torch.ps.table import EmbeddingTable
    from paddlebox_tpu_torch.resilience import preemption
    from paddlebox_tpu_torch.resilience.faults import FaultPlan, installed
    from paddlebox_tpu_torch.resilience.preemption import PreemptedError
    from paddlebox_tpu_torch.train.trainer import Trainer
    from paddlebox_tpu_torch.train.checkpoint import (CheckpointManager,
                                                state_digest)

    reset_hub()
    preemption.clear_stop()
    jsonl = os.path.join(workdir, "telemetry.jsonl")
    files = generate_criteo_files(os.path.join(workdir, "data"),
                                  num_files=FILES, rows_per_file=ROWS,
                                  vocab_per_slot=40, seed=seed)
    cfg = SparseSGDConfig(mf_create_thresholds=0.0, mf_initial_range=0.0)

    # ONE reader thread: the digest comparison needs a deterministic
    # batch order within each window (resume correctness itself — the
    # at-least-once window replay — does not)
    with flags_scope(seed=seed, telemetry_jsonl=jsonl,
                     stream_window_files=WINDOW,
                     stream_ckpt_every_windows=1, read_thread_num=1):
        desc = DataFeedDesc.criteo(batch_size=BS)
        desc.key_bucket_min = 2048
        sigs_by_file = _file_sigs(files, desc)

        def mk() -> Trainer:
            table = EmbeddingTable(mf_dim=4, capacity=1 << 12, cfg=cfg,
                                   unique_bucket_min=2048, device=device)
            torch.manual_seed(seed)
            return Trainer(CtrDnn(26, 3 + 4, 13, hidden=(8,)), table, desc,
                           tx=lambda p: torch.optim.Adam(p, lr=1e-2),
                           seed=seed, device=device)

        def mkds():
            ds = DatasetFactory().create_dataset("QueueDataset", desc)
            ds.set_filelist(files)
            return ds

        # windowed-mode contract (acceptance criterion): cursor resume
        # is advertised ONLY in windowed mode; the legacy stream refuses
        ds_probe = mkds()
        assert ds_probe.supports_cursor_resume, \
            "windowed QueueDataset must support cursor resume"
        with flags_scope(stream_window_files=0):
            assert not ds_probe.supports_cursor_resume
            try:
                next(ds_probe.batches(start_batch=1))
                raise AssertionError("unwindowed stream accepted "
                                     "start_batch != 0")
            except ValueError:
                pass

        def digest_of(root: str, step: int) -> str:
            t = mk()
            assert CheckpointManager(root).restore(t, step=step) == step
            return state_digest(t)

        # (1) oracle: uninterrupted stream, boundary ckpt per window
        oracle_root = os.path.join(workdir, "ckpt_oracle")
        oracle = mk()
        out_oracle = oracle.train_stream(mkds(),
                                         CheckpointManager(oracle_root))
        assert out_oracle["windows"] == FILES // WINDOW, out_oracle
        assert out_oracle["replayed_files"] == 0
        oracle_steps = CheckpointManager(oracle_root).steps()

        # (2) killed run: simulated SIGTERM at the K-th batch boundary
        root = os.path.join(workdir, "ckpt")
        trained = collections.Counter()
        killed = mk()
        killed.on_batch_trained = \
            lambda b: trained.update(_record_sigs(b))
        cm = CheckpointManager(root)
        plan = FaultPlan.parse(f"preempt.signal:fail:nth={preempt_at}",
                               seed=seed)
        preempted = False
        try:
            with installed(plan):
                killed.train_stream(mkds(), cm)
        except PreemptedError as e:
            preempted = True
            assert e.checkpointed, "emergency checkpoint missing"
        assert preempted, "preempt fault never fired"
        cursor = cm.load_cursor()
        assert cursor is not None and "stream" in cursor, cursor
        stream = cursor["stream"]
        # completed-file history older than the last boundary ckpt is
        # FOLDED to a count+fingerprint (cursor compaction):
        # expand it from the known consumption order, checking the
        # chained digest on the way
        fold = stream.get("files_folded") or {}
        nfold = int(fold.get("count", 0) or 0)
        if nfold:
            from paddlebox_tpu_torch.data.dataset import chain_digest
            assert chain_digest("", files[:nfold]) == fold["sha256"], (
                "folded cursor fingerprint does not match the stream's "
                "consumption order")
        completed_at_kill = files[:nfold] + list(
            stream["files_completed"])
        open_window = list(stream["window_files"])
        assert open_window, "kill was meant to land MID-window"
        marker = preemption.read_resume_marker(root)
        assert marker and marker["exit_code"] == preemption.EXIT_RESUME

        # (3) restart: fresh trainer resumes; open window replays
        preemption.clear_stop()
        resumed = mk()
        resumed.on_batch_trained = \
            lambda b: trained.update(_record_sigs(b))
        cm2 = CheckpointManager(root)
        restored = cm2.restore(resumed)
        assert restored == cursor["global_step"], (restored, cursor)
        ds_res = mkds()
        out_res = resumed.train_stream(ds_res, cm2)
        assert preemption.read_resume_marker(root) is None, \
            "resume marker not consumed"
        assert out_res["replayed_files"] == len(open_window), out_res
        assert ds_res.files_completed[-1] == files[-1]  # drained

        # ---- record accounting: at-least-once, completed exactly-once
        done_files = set(completed_at_kill) \
            | (set(files) - set(open_window))
        for path in files:
            for sig in sigs_by_file[path]:
                n = trained[sig]
                assert n >= 1, f"record of {path} never trained"
                if path in done_files:
                    assert n == 1, (f"completed-window record of {path} "
                                    f"trained {n}x")
                else:
                    assert n <= 2, (f"open-window record of {path} "
                                    f"trained {n}x")
        replay_counts = sorted(
            {trained[s] for s in set().union(
                *(sigs_by_file[p] for p in open_window))})
        # the open window holds BOTH replayed-after-training records
        # (2x) and not-yet-reached ones (1x) — the kill landed mid-window
        assert replay_counts == [1, 2], replay_counts

        # ---- digest at the last common window boundary
        common = sorted(set(cm2.steps()) & set(oracle_steps))
        boundary_steps = [s for s in common
                          if s <= int(cursor["global_step"])]
        assert boundary_steps, "no common pre-kill boundary checkpoint"
        last_common = boundary_steps[-1]
        d_oracle = digest_of(oracle_root, last_common)
        d_killed = digest_of(root, last_common)
        assert d_oracle == d_killed, (
            "killed run diverged from the oracle at the last common "
            f"window boundary (step {last_common}):\n"
            f"  oracle {d_oracle}\n  killed {d_killed}")

    with open(jsonl) as fh:
        events = [json.loads(line) for line in fh]
    names = {e["event"] for e in events}
    for want in ("stream_window", "preempt_requested",
                 "emergency_checkpoint", "cursor_resume",
                 "stream_replay"):
        assert want in names, f"telemetry missing {want!r}: {sorted(names)}"
    resumes = [e for e in events if e["event"] == "cursor_resume"
               and e.get("stream")]
    assert resumes and resumes[-1]["replay_files"] == len(open_window)

    return dict(
        ok=True,
        oracle_windows=int(out_oracle["windows"]),
        completed_at_kill=[os.path.basename(p)
                           for p in completed_at_kill],
        open_window=[os.path.basename(p) for p in open_window],
        resumed_windows=int(out_res["windows"]),
        replayed_files=int(out_res["replayed_files"]),
        last_common_boundary=int(last_common),
        boundary_digest=d_oracle,
        fault_stats=plan.stats(),
        events={n: sum(1 for e in events if e["event"] == n)
                for n in ("stream_window", "stream_replay",
                          "emergency_checkpoint", "cursor_resume")},
    )


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--preempt-at", type=int, default=8,
                    help="batch boundary the simulated SIGTERM lands on "
                         "(default 8: mid-window-2 of the 3-window run)")
    ap.add_argument("--device", default="cuda",
                    help="where the trainers run (cuda or cpu)")
    ap.add_argument("--workdir", default=None,
                    help="scratch dir (default: a fresh temp dir)")
    ap.add_argument("--keep", action="store_true",
                    help="keep the scratch dir for inspection")
    args = ap.parse_args()

    base = args.workdir or tempfile.mkdtemp(prefix="pbox_stream_")
    outcomes = []
    try:
        for run in (1, 2):  # same seed twice: outcome must be identical
            wd = os.path.join(base, f"run{run}")
            os.makedirs(wd, exist_ok=True)
            print(f"--- stream run {run} (seed={args.seed}, preempt at "
                  f"batch {args.preempt_at}) ---")
            outcomes.append(run_scenario(wd, args.seed, args.preempt_at,
                                        args.device))
            print(json.dumps(outcomes[-1], indent=2, sort_keys=True))
        if outcomes[0] != outcomes[1]:
            print("FAIL: stream outcome differs across "
                  "identically-seeded runs:")
            print(json.dumps(outcomes[0], sort_keys=True))
            print(json.dumps(outcomes[1], sort_keys=True))
            return 1
        print(f"PASS: preempted stream resumed with at-least-once "
              f"accounting (replayed {outcomes[0]['replayed_files']} "
              f"open-window file(s), completed windows exactly once), "
              f"boundary digest matches the oracle; outcome "
              f"deterministic across 2 runs (seed={args.seed})")
        return 0
    finally:
        if not args.keep and args.workdir is None:
            shutil.rmtree(base, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
