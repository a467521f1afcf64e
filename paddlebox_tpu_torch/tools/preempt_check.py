"""Seeded end-to-end preemption check (the port's counterpart of
``scripts/preempt_check.py``).

Proves the preemption survival kit end-to-end, deterministically:

1. **baseline** — an uninterrupted pass records its logical state
   digest (``train.checkpoint.state_digest``: per-key table rows +
   dense/opt/AUC leaves, row-assignment order cancelled out).
2. **preempted** — the same seeded run under a
   ``preempt.signal:fail:nth=K`` fault plan (a simulated SIGTERM at the
   K-th batch boundary) with periodic in-pass cursor checkpoints
   (``FLAGS_ckpt_every_batches``): the pass raises ``PreemptedError``
   after writing an emergency checkpoint + ``RESUME.json`` marker.
3. **restart** — a fresh trainer restores the emergency checkpoint and
   ``run_pass`` resumes from the cursor, replaying ONLY the batches
   after it; the final digest must equal the baseline digest exactly,
   and the resume marker must be consumed.

The whole scenario runs twice with the same seed and the outcome
summaries must be identical — preemption recovery is reproducible, not
lucky. The telemetry JSONL must carry the new event catalog entries
(``preempt_requested``, ``emergency_checkpoint``, ``cursor_resume``).

Usage::

    python -m paddlebox_tpu_torch.tools.preempt_check [--seed 7]
        [--preempt-at 4] [--device cuda|cpu]

The trainers run on the card unless ``--device cpu``.

Exit code 0 == resumed byte-identically + deterministic.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile


def run_scenario(workdir: str, seed: int, preempt_at: int,
                 device: str = "cuda") -> dict:
    """One full preemption round-trip on ``device``; returns the outcome
    summary."""
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
                                  num_files=2, rows_per_file=160,
                                  vocab_per_slot=40, seed=seed)
    ckpt_root = os.path.join(workdir, "ckpt")
    cfg = SparseSGDConfig(mf_create_thresholds=0.0, mf_initial_range=0.0)

    with flags_scope(seed=seed, telemetry_jsonl=jsonl,
                     ckpt_every_batches=3):
        desc = DataFeedDesc.criteo(batch_size=32)
        desc.key_bucket_min = 2048

        def mk() -> Trainer:
            table = EmbeddingTable(mf_dim=4, capacity=1 << 12, cfg=cfg,
                                   unique_bucket_min=2048, device=device)
            torch.manual_seed(seed)
            return Trainer(CtrDnn(26, 3 + 4, 13, hidden=(8,)), table, desc,
                           tx=lambda p: torch.optim.Adam(p, lr=1e-2),
                           seed=seed, device=device)

        ds = DatasetFactory().create_dataset("InMemoryDataset", desc)
        ds.set_filelist(files)
        ds.load_into_memory()

        # (1) baseline: uninterrupted pass
        baseline = mk()
        out_base = baseline.train_pass(ds)
        digest_base = state_digest(baseline)
        total_batches = int(out_base["batches"])

        # (2) preempted run: simulated SIGTERM at the K-th boundary
        trainer = mk()
        cm = CheckpointManager(ckpt_root)
        plan = FaultPlan.parse(f"preempt.signal:fail:nth={preempt_at}",
                               seed=seed)
        preempted = False
        try:
            with installed(plan):
                trainer.run_pass(ds, checkpoint=cm)
        except PreemptedError as e:
            preempted = True
            assert e.checkpointed, "emergency checkpoint missing"
        assert preempted, "preempt fault never fired"
        cursor = cm.load_cursor()
        assert cursor is not None, "no resume cursor on latest ckpt"
        assert cursor["batch_index"] == preempt_at, cursor
        marker = preemption.read_resume_marker(ckpt_root)
        assert marker and marker["exit_code"] == preemption.EXIT_RESUME

        # (3) restart: fresh trainer resumes from the cursor
        preemption.clear_stop()
        resumed = mk()
        cm2 = CheckpointManager(ckpt_root)
        restored = cm2.restore(resumed)
        assert restored == cursor["global_step"], (restored, cursor)
        out_res = resumed.run_pass(ds, checkpoint=cm2)
        replayed = int(out_res["batches"])
        assert replayed == total_batches - preempt_at, (
            f"replayed {replayed}, want {total_batches - preempt_at}")
        assert preemption.read_resume_marker(ckpt_root) is None, \
            "resume marker not consumed"
        digest_resumed = state_digest(resumed)
        assert digest_resumed == digest_base, (
            "resumed state diverged from the uninterrupted run:\n"
            f"  baseline {digest_base}\n  resumed  {digest_resumed}")

    with open(jsonl) as fh:
        events = [json.loads(line) for line in fh]
    names = {e["event"] for e in events}
    for want in ("preempt_requested", "emergency_checkpoint",
                 "cursor_resume"):
        assert want in names, f"telemetry missing {want!r}: {sorted(names)}"

    return dict(
        total_batches=total_batches,
        preempted_at=int(cursor["batch_index"]),
        replayed_batches=replayed,
        digest=digest_base,
        digest_match=digest_resumed == digest_base,
        fault_stats=plan.stats(),
        events={n: sum(1 for e in events if e["event"] == n)
                for n in ("preempt_requested", "emergency_checkpoint",
                          "inpass_checkpoint", "cursor_resume")},
    )


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--preempt-at", type=int, default=4,
                    help="batch boundary the simulated SIGTERM lands on")
    ap.add_argument("--device", default="cuda",
                    help="where the trainers run (cuda or cpu)")
    ap.add_argument("--workdir", default=None,
                    help="scratch dir (default: a fresh temp dir)")
    ap.add_argument("--keep", action="store_true",
                    help="keep the scratch dir for inspection")
    args = ap.parse_args()

    base = args.workdir or tempfile.mkdtemp(prefix="pbox_preempt_")
    outcomes = []
    try:
        for run in (1, 2):  # same seed twice: outcome must be identical
            wd = os.path.join(base, f"run{run}")
            os.makedirs(wd, exist_ok=True)
            print(f"--- preemption run {run} (seed={args.seed}, "
                  f"preempt at batch {args.preempt_at}) ---")
            outcomes.append(run_scenario(wd, args.seed, args.preempt_at,
                                        args.device))
            print(json.dumps(outcomes[-1], indent=2, sort_keys=True))
        if outcomes[0] != outcomes[1]:
            print("FAIL: preemption outcome differs across "
                  "identically-seeded runs:")
            print(json.dumps(outcomes[0], sort_keys=True))
            print(json.dumps(outcomes[1], sort_keys=True))
            return 1
        print(f"PASS: preempted run resumed from the cursor "
              f"byte-identically ({outcomes[0]['replayed_batches']} of "
              f"{outcomes[0]['total_batches']} batches replayed); "
              f"outcome deterministic across 2 runs (seed={args.seed})")
        return 0
    finally:
        if not args.keep and args.workdir is None:
            shutil.rmtree(base, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
