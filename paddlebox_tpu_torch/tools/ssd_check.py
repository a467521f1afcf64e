"""Deterministic SSD-third-tier gates (the port's counterpart of
``scripts/ssd_check.py``; docs/STORAGE.md).

CORRECTNESS gate (``run_ssd_check``): drives the tiered pass protocol
over an alternating A/B working set with a ``host_store_capacity``
deliberately SMALLER than |A ∪ B| — every pass boundary evicts the old
set to the host tier, the watermark demoter spills the cold half to SSD
segments, and re-staging the old set PROMOTES it back — and asserts:

(a) the final full-model digest (host RAM + SSD tier, via
    ``export_rows``) is IDENTICAL to an UNCAPPED oracle run of the same
    job — demote → segment write → promote round trips are bit-exact
    and no row is ever lost or resurrected stale;
(b) demotion and promotion actually happened (nonzero
    ``pbox_ssd_{demoted,promoted}_rows_total`` accounting);
(c) the whole capped outcome (digest + tier row accounting) is
    byte-identical across two identically-seeded runs — the async
    demote path is deterministic, not racy.

OVERLAP gate (``run_overlap_check``): the LoadSSD2Mem scheduling
property — with the stage fetch overlapped against the open pass (the
production pre_build_thread shape), the per-pass promote WAIT on the
critical path must fall well below the synchronous control where
``begin_pass`` itself pays the segment reads. Measured up to 3 times,
gated on the best attempt (noise only ever inflates waits).

Usage::

    python -m paddlebox_tpu_torch.tools.ssd_check [--device cpu]

The pass windows live on the card unless ``--device cpu``. Prints one
JSON line per gate; exit code 0 == both gates passed.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from paddlebox_tpu_torch.tools.pipeline_check import (_tiered_table,
                                                      _train_mutate,
                                                      host_tier_digest)


def _key_sets(keys_per_set: int) -> Tuple[np.ndarray, np.ndarray]:
    a = np.arange(1, 1 + keys_per_set, dtype=np.uint64)
    b = np.arange(100_001, 100_001 + keys_per_set, dtype=np.uint64)
    return a, b


def _run_job(passes: int, shards: int, keys_per_set: int,
             host_capacity: int, ssd_dir: Optional[str],
             window_cap: int, overlap: bool = False,
             train_sleep: float = 0.0, device: str = "cuda") -> Dict:
    """One A/B-alternating tiered job → digest + tier accounting +
    per-pass begin_stall breakdown. ``overlap=False`` stages
    synchronously on the main thread — every fetch barriers on the
    epilogue first, so the demote/promote interleaving is fully
    serialized and the run is deterministic by construction."""
    from paddlebox_tpu_torch.config import flags_scope
    with flags_scope(ssd_dir="", async_end_pass=True,
                     # small sealed segments + an aggressive live-frac
                     # threshold so the gate exercises compaction too
                     ssd_segment_rows=128, ssd_compact_live_frac=0.6):
        table = _tiered_table(shards, window_cap, device,
                              host_capacity=host_capacity, ssd_dir=ssd_dir)
        a, b = _key_sets(keys_per_set)
        sets = [a if p % 2 == 0 else b for p in range(passes)]
        table.stage(sets[0], background=False)
        table.begin_pass(sets[0])
        waits: List[float] = []
        promos: List[float] = []
        rows_promoted: List[float] = []
        for p in range(passes):
            _train_mutate(table, p)
            if overlap and p + 1 < passes:
                # production shape: the next pass's host fetch (and any
                # SSD promote it needs) rides the open pass's training
                table.stage(sets[p + 1], background=True)
                time.sleep(train_sleep)   # stand-in for device train
            table.end_pass()
            if p + 1 < passes:
                table.begin_pass(sets[p + 1])
                lp = table.last_pass_stats
                waits.append(float(lp.get("ssd_promote_wait_sec", 0.0)))
                promos.append(float(lp.get("ssd_promote_sec", 0.0)))
                rows_promoted.append(
                    float(lp.get("ssd_promoted_rows", 0.0)))
        table.fence()
        st = table.ssd_stats()
        return {
            "digest": host_tier_digest(table),
            "rows": table.feature_count(),
            "ssd": {k: round(float(st.get(k, 0.0)), 6)
                    for k in ("live_rows", "segments", "demoted_rows",
                              "promoted_rows", "compacted_rows")},
            "promote_wait_sec": waits,
            "promote_sec": promos,
            "promoted_rows_per_pass": rows_promoted,
        }


def run_ssd_check(passes: int = 6, shards: int = 2,
                  keys_per_set: int = 512,
                  host_capacity: int = 340,
                  window_cap: int = 300, device: str = "cuda") -> Dict:
    """The correctness gate. Raises AssertionError on any violated
    invariant; returns the evidence record."""
    assert passes >= 4, "the A/B revisit pattern needs >= 4 passes"
    # uncapped oracle: everything stays in host RAM, no tier attached
    oracle = _run_job(passes, shards, keys_per_set,
                      host_capacity=1 << 22, ssd_dir=None,
                      window_cap=window_cap, device=device)
    assert oracle["ssd"]["demoted_rows"] == 0, (
        "oracle run unexpectedly touched an SSD tier")
    capped = []
    for run in range(2):   # determinism: identical outcome twice
        with tempfile.TemporaryDirectory(prefix="pbox_ssd_") as td:
            capped.append(_run_job(passes, shards, keys_per_set,
                                   host_capacity=host_capacity,
                                   ssd_dir=td, window_cap=window_cap,
                                   device=device))
    c = capped[0]
    assert c["ssd"]["demoted_rows"] > 0, (
        f"capped run never demoted — the watermark policy is dead "
        f"({c['ssd']})")
    assert c["ssd"]["promoted_rows"] > 0, (
        f"capped run never promoted (pbox_ssd_promoted_rows_total == "
        f"0) — re-staged working sets came from nowhere ({c['ssd']})")
    # compaction is asserted white-box (tests/test_torch_tiered.py —
    # this workload's sets promote whole segments dead, which the
    # dead-segment fast path reclaims without a rewrite); the gate
    # still reports compacted_rows for runs whose layout fragments
    assert c["digest"] == oracle["digest"], (
        "capped (demote+promote) run produced a DIFFERENT full-model "
        f"state than the uncapped oracle: {c['digest'][:16]}… != "
        f"{oracle['digest'][:16]}… — rows were lost or resurrected "
        "stale crossing the SSD tier")
    assert capped[1]["digest"] == c["digest"] and (
        capped[1]["ssd"] == c["ssd"]), (
        "capped outcome differs across identically-seeded runs: "
        f"{c['ssd']} vs {capped[1]['ssd']} — the demote/promote path "
        "is nondeterministic")
    return {
        "check": "ssd_check",
        "ok": True,
        "passes": passes,
        "shards": shards,
        "keys_per_set": keys_per_set,
        "host_capacity": host_capacity,
        "digest": c["digest"],
        "rows": c["rows"],
        "ssd": c["ssd"],
    }


def run_overlap_check(passes: int = 5, shards: int = 2,
                      keys_per_set: int = 2048,
                      host_capacity: int = 1300,
                      window_cap: int = 1100,
                      train_sleep: float = 0.15,
                      device: str = "cuda") -> Dict:
    """The promote-overlap gate: steady-state critical-path promote
    wait with overlapped staging must fall below half the synchronous
    control's (which pays the full segment-read time inside
    begin_pass). Timing property — measured up to 3 times, gated on
    the best attempt."""
    best = None
    for attempt in range(3):
        with tempfile.TemporaryDirectory(prefix="pbox_ssd_ov_") as td:
            ov = _run_job(passes, shards, keys_per_set, host_capacity,
                          td, window_cap, overlap=True,
                          train_sleep=train_sleep, device=device)
        with tempfile.TemporaryDirectory(prefix="pbox_ssd_sy_") as td:
            sy = _run_job(passes, shards, keys_per_set, host_capacity,
                          td, window_cap, overlap=False, device=device)
        # steady state skips the first boundary (cold spill layout)
        wait_ov = sum(ov["promote_wait_sec"][1:])
        wait_sy = sum(sy["promote_wait_sec"][1:])
        rec = {"wait_overlap_sec": round(wait_ov, 4),
               "wait_sync_sec": round(wait_sy, 4),
               "promote_sec_overlap": round(
                   sum(ov["promote_sec"][1:]), 4),
               "promoted_rows": sum(ov["promoted_rows_per_pass"][1:])}
        if best is None or rec["wait_overlap_sec"] < \
                best["wait_overlap_sec"]:
            best = rec
        if (rec["promoted_rows"] > 0 and wait_sy > 0
                and wait_ov <= 0.5 * wait_sy):
            best = rec
            break
    assert best["promoted_rows"] > 0, (
        f"overlap gate never promoted ({best}) — the working set no "
        "longer exceeds the capped host store")
    assert best["wait_sync_sec"] > 0, (
        f"synchronous control shows no promote wait ({best}) — the "
        "gate no longer exercises the LoadSSD2Mem path")
    assert best["wait_overlap_sec"] <= 0.5 * best["wait_sync_sec"], (
        f"overlapped promote wait {best['wait_overlap_sec']}s did not "
        f"drop below half the synchronous control "
        f"{best['wait_sync_sec']}s — LoadSSD2Mem is not riding the "
        f"stage thread ({best})")
    return {"check": "ssd_overlap_check", "ok": True, **best}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="where the pass windows live (cuda or cpu)")
    args = ap.parse_args()
    t0 = time.perf_counter()
    print(json.dumps(run_ssd_check(device=args.device)))
    print(json.dumps(run_overlap_check(device=args.device)))
    print(f"PASS: SSD tier gates held on {args.device} in "
          f"{time.perf_counter() - t0:.1f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
