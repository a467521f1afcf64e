"""Deterministic pass-pipeline gates (the port's counterpart of
``scripts/pipeline_check.py``; docs/PERFORMANCE.md).

EPILOGUE gate (``run_check``): runs the SAME small 3-pass tiered job
twice — once with the asynchronous end_pass epilogue
(FLAGS.async_end_pass=True, the default) and once fully synchronous —
and asserts:

(a) the final host-tier state digests are IDENTICAL (the async
    epilogue's fence rules preserve the bit-for-bit delta==full
    semantics of the pass lifecycle), and
(b) the async run measured end_pass overlap > 0 (write-back seconds
    that never blocked the main thread — the epilogue actually left
    the critical path).

The job drives the tiered table's pass protocol directly with a
deterministic device mutation per pass (value = f(key, pass)) over
sliding ~90%-overlap working sets, staging pass k+1 overlapped while
pass k is open — the production pipeline shape (stage_pass /
pre_build_thread) without a model in the loop, so the gate is fast and
bit-exact by construction.

PROLOGUE gate (``run_prologue_check``): the depth-N preload pipeline's
twin —

(a) scheduling property: with deterministic sleep-timed builds
    (bimodal, avg build < train), the depth-N pipeline's steady-state
    per-pass wait drops vs depth-1 (the queue absorbs the slow builds
    instead of joining on each), and
(b) bit-identity: a REAL 4-pass single-table resident training job run
    at depth N produces the exact logical-state digest
    (train/checkpoint.state_digest: table rows keyed+sorted by
    feasign, dense params, optimizer, AUC) of the depth-1 run — the
    deeper pipeline changes scheduling only, never results.

TIERED PROLOGUE gate (``run_tiered_prologue_check``): the depth-N
``PassPipeline`` over a tiered table reproduces the sequential oracle's
host-tier digest and cuts the steady-state boundary stall.

Usage::

    python -m paddlebox_tpu_torch.tools.pipeline_check [--device cpu]

The tables and the trainer live on the card unless ``--device cpu``.
Prints one JSON line per gate; exit code 0 == every gate passed.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import time
from typing import Dict, List

import numpy as np


def _pass_keys(p: int, keys_per_pass: int, overlap_frac: float
               ) -> np.ndarray:
    """Sliding key window: consecutive passes share ~overlap_frac."""
    step = max(1, int(round(keys_per_pass * (1.0 - overlap_frac))))
    base = 1 + p * step
    return np.arange(base, base + keys_per_pass, dtype=np.uint64)


def _mutate_rows(table, s: int, keys: np.ndarray, rows: np.ndarray,
                 p: int) -> None:
    """Shard s's rows: embed_w = f(key, p), show += 1, marked touched
    (caller holds host_lock). The window is updated in place; the
    sentinel row is never among ``rows``."""
    import torch

    from paddlebox_tpu_torch.ps.table import FIELD_COL
    data = table.states[s].data
    idx = torch.from_numpy(rows.astype(np.int64)).to(data.device)
    data[idx, FIELD_COL["embed_w"]] = torch.from_numpy(
        (keys.astype(np.float64) * 0.001 + (p + 1)).astype(
            np.float32)).to(data.device)
    data[idx, FIELD_COL["show"]] += 1.0
    table._touched[s][rows] = True


def _train_mutate(table, p: int) -> None:
    """Deterministic stand-in for a training pass: every resident
    working-set row's embed_w becomes f(key, p); rows marked touched as
    prepare()/mark_trained_rows would."""
    with table.host_lock:
        for s in range(table.n):
            keys, rows = table.indexes[s].items()
            if len(rows):
                _mutate_rows(table, s, keys, rows, p)


def host_tier_digest(table) -> str:
    """sha256 over every shard's sorted (keys, fields) export — fences
    the epilogue implicitly (HostStore.read_barrier)."""
    h = hashlib.sha256()
    for s in range(table.n):
        keys, fields = table.hosts[s].export_rows()
        order = np.argsort(keys)
        h.update(np.ascontiguousarray(keys[order]).tobytes())
        for f in sorted(fields):
            h.update(f.encode())
            h.update(np.ascontiguousarray(fields[f][order]).tobytes())
    return h.hexdigest()


def _tiered_table(shards: int, capacity_per_shard: int, device: str,
                  **kw):
    from paddlebox_tpu_torch.ps.sgd import SparseSGDConfig
    from paddlebox_tpu_torch.ps.tiered import TieredShardedEmbeddingTable
    return TieredShardedEmbeddingTable(
        shards, mf_dim=2, capacity_per_shard=capacity_per_shard,
        cfg=SparseSGDConfig(mf_create_thresholds=0.0, mf_initial_range=0.0),
        devices=device, **kw)


def _run_job(async_mode: bool, passes: int, shards: int,
             keys_per_pass: int, overlap_frac: float,
             capacity_per_shard: int, device: str) -> Dict:
    from paddlebox_tpu_torch.config import flags_scope
    with flags_scope(async_end_pass=async_mode):
        table = _tiered_table(shards, capacity_per_shard, device)
        key_sets = [_pass_keys(p, keys_per_pass, overlap_frac)
                    for p in range(passes)]
        table.stage(key_sets[0], background=False)
        table.begin_pass(key_sets[0])
        for p in range(passes):
            _train_mutate(table, p)
            if p + 1 < passes:
                # the production overlap shape: pass p+1's host fetch
                # rides pass p's open window (stage_pass)
                table.stage(key_sets[p + 1], background=True)
            table.end_pass()
            # stand-in for the next pass's TRAIN time: the gate asserts
            # overlap > 0, which needs the worker some wall-clock before
            # the next fence point — on a starved single-core runner the
            # worker might otherwise only get scheduled inside a fence,
            # clamping overlap to 0 with no code defect (a main-thread
            # sleep yields the core exactly like device compute would)
            time.sleep(0.02)
            if p + 1 < passes:
                table.begin_pass(key_sets[p + 1])
        digest = host_tier_digest(table)  # fences the epilogue
        eps = table.endpass_stats()
        return {"digest": digest,
                "rows": table.feature_count(),
                "endpass": {k: round(v, 6) if isinstance(v, float) else v
                            for k, v in eps.items()}}


def run_check(passes: int = 3, shards: int = 4, keys_per_pass: int = 512,
              overlap_frac: float = 0.9,
              capacity_per_shard: int = 1024,
              device: str = "cuda") -> Dict:
    """The gate. Raises AssertionError on any violated invariant;
    returns the evidence record."""
    assert passes >= 3, "the gate's pipeline shape needs >= 3 passes"
    sync = _run_job(False, passes, shards, keys_per_pass, overlap_frac,
                    capacity_per_shard, device)
    async_ = _run_job(True, passes, shards, keys_per_pass, overlap_frac,
                      capacity_per_shard, device)
    assert async_["rows"] == sync["rows"], (
        f"row count diverged: async {async_['rows']} != sync "
        f"{sync['rows']}")
    assert async_["digest"] == sync["digest"], (
        "async end_pass produced a DIFFERENT host-tier state than the "
        f"synchronous path: {async_['digest'][:16]}… != "
        f"{sync['digest'][:16]}…")
    eps = async_["endpass"]
    assert eps["jobs_run"] >= passes, (
        f"expected >= {passes} async write-back jobs, ran "
        f"{eps['jobs_run']}")
    assert eps["pending"] == 0, "digest fenced, yet jobs still pending"
    assert eps["overlap_sec"] > 0.0, (
        "async epilogue measured ZERO overlap — every write-back second "
        f"blocked the main thread ({eps})")
    return {
        "check": "pipeline_check",
        "ok": True,
        "passes": passes,
        "shards": shards,
        "keys_per_pass": keys_per_pass,
        "overlap_frac_keys": overlap_frac,
        "digest": async_["digest"],
        "rows": async_["rows"],
        "async_endpass": async_["endpass"],
    }


# ---- prologue gate: the depth-N preload pipeline -------------------


class _TimedPass:
    """Synthetic staged-pass token for the scheduling-property check:
    the preloader only needs upload()/nbytes() from it."""

    def upload(self, device=None) -> None:
        pass

    def nbytes(self) -> int:
        return 0


def measure_preload_waits(depth: int, passes: int, train_sec: float,
                          build_secs, device: str = "cuda") -> List[float]:
    """Per-pass consumer wait with sleep-timed builds: deterministic by
    construction (the waits are structural — build/train overlap
    arithmetic — not load-dependent)."""
    from paddlebox_tpu_torch.config import flags_scope
    from paddlebox_tpu_torch.train.device_pass import PassPreloader

    def build(d: float) -> _TimedPass:
        time.sleep(d)
        return _TimedPass()

    durations = [build_secs[i % len(build_secs)] for i in range(passes)]
    with flags_scope(preload_hbm_budget_mb=0):
        pre = PassPreloader(iter(durations), build_fn=build, depth=depth,
                            device=device)
    pre.start_next()
    waits: List[float] = []
    while True:
        t0 = time.perf_counter()
        rp = pre.wait()
        if rp is None:
            break
        waits.append(time.perf_counter() - t0)
        pre.start_next()
        time.sleep(train_sec)  # stand-in for device train time
    pre.drain()
    return waits


def _make_pass_dataset(desc, num_records: int, seed: int):
    """Tiny synthetic in-memory pass (criteo-shaped, 4 sparse slots)."""
    from paddlebox_tpu_torch.data import InMemoryDataset
    from paddlebox_tpu_torch.data.record import SlotRecord
    rng = np.random.default_rng(seed)
    n_slots = len(desc.sparse_slots)
    offsets = np.arange(n_slots + 1, dtype=np.int32)
    ds = InMemoryDataset(desc)
    for i in range(num_records):
        label = float(rng.random() < 0.3)
        ds.records.append(SlotRecord(
            keys=(rng.integers(0, 500, size=n_slots)
                  + np.arange(n_slots) * 500).astype(np.uint64),
            slot_offsets=offsets,
            dense=rng.normal(size=desc.dense_dim).astype(np.float32),
            label=label, show=1.0, clk=label))
    return ds


def _resident_job_digest(depth: int, passes: int, num_records: int,
                         device: str) -> str:
    """One small single-table resident training job driven through the
    depth-``depth`` preload pipeline → logical-state digest."""
    import torch

    from paddlebox_tpu_torch.data import DataFeedDesc, SlotDef
    from paddlebox_tpu_torch.models import DeepFM
    from paddlebox_tpu_torch.ps.sgd import SparseSGDConfig
    from paddlebox_tpu_torch.ps.table import EmbeddingTable
    from paddlebox_tpu_torch.train.checkpoint import state_digest
    from paddlebox_tpu_torch.train.trainer import Trainer
    slots = [SlotDef("label", "float", 1), SlotDef("dense", "float", 4)]
    slots += [SlotDef(f"C{i}", "uint64") for i in range(1, 5)]
    desc = DataFeedDesc(slots=slots, batch_size=64, label_slot="label",
                        key_bucket_min=256)
    cfg = SparseSGDConfig(mf_create_thresholds=0.0, mf_initial_range=0.0)
    table = EmbeddingTable(mf_dim=4, capacity=1 << 12, cfg=cfg,
                           unique_bucket_min=256, device=device)
    torch.manual_seed(7)
    tr = Trainer(DeepFM(4, 3 + 4, 4, hidden=(8,)), table, desc,
                 tx=lambda p: torch.optim.Adam(p, lr=1e-2), seed=7,
                 device=device)
    datasets = [_make_pass_dataset(desc, num_records, seed=s % 2)
                for s in range(passes)]
    results = tr.train_passes_resident(datasets, depth=depth)
    assert len(results) == passes
    return state_digest(tr)


def run_prologue_check(passes: int = 9, train_sec: float = 0.1,
                       build_secs=(0.02, 0.16),
                       real_passes: int = 4,
                       real_records: int = 192,
                       depth: int = 2, device: str = "cuda") -> Dict:
    """The depth-N preload gate. Raises AssertionError on any violated
    invariant; returns the evidence record."""
    assert passes >= 6, "steady-state needs a few passes past warmup"
    # the wait arithmetic is deterministic for an ideal scheduler, but
    # a loaded box can delay one worker wakeup by ~100 ms and eat the
    # margin — measure up to 3 times and gate on the best attempt (a
    # scheduling PROPERTY holds if any clean measurement shows it;
    # noise only ever inflates waits)
    steady1 = steadyn = 0.0
    w1 = wn = []
    for attempt in range(3):
        w1 = measure_preload_waits(1, passes, train_sec, build_secs, device)
        wn = measure_preload_waits(depth, passes, train_sec, build_secs,
                                   device)
        assert len(w1) == len(wn) == passes
        # steady state skips the first two passes (cold build + fill)
        steady1 = sum(w1[2:])
        steadyn = sum(wn[2:])
        if steady1 > train_sec / 4 and steadyn <= 0.5 * steady1:
            break
    # with avg build < train, depth-1 still waits on every slow build;
    # the depth-N queue buffers them — wait must at least halve (it
    # lands near zero; 0.5 leaves room for scheduler wakeup noise)
    assert steady1 > train_sec / 4, (
        f"depth-1 baseline shows no prologue stall ({steady1:.3f}s) — "
        "the gate's build/train timing no longer exercises the "
        f"pipeline (waits: {w1})")
    assert steadyn <= 0.5 * steady1, (
        f"depth-{depth} steady-state preload wait {steadyn:.3f}s did "
        f"not drop >=50% vs depth-1 {steady1:.3f}s "
        f"(depth-1 {w1}, depth-{depth} {wn})")
    d1 = _resident_job_digest(1, real_passes, real_records, device)
    dn = _resident_job_digest(depth, real_passes, real_records, device)
    assert dn == d1, (
        f"depth-{depth} resident training produced a DIFFERENT "
        f"logical state than depth-1: {dn[:16]}… != {d1[:16]}…")
    return {
        "check": "prologue_check",
        "ok": True,
        "depth": depth,
        "passes": passes,
        "steady_wait_sec_depth1": round(steady1, 4),
        f"steady_wait_sec_depth{depth}": round(steadyn, 4),
        "wait_drop_frac": round(1.0 - steadyn / max(steady1, 1e-9), 4),
        "real_passes": real_passes,
        "digest": dn,
    }


# ---- tiered prologue gate: the unified pass pipeline ---------------


def _train_mutate_keys(table, keys: np.ndarray, p: int) -> None:
    """Deterministic stand-in for training ONE pass: only the pass's
    WORKING-SET rows mutate (embed_w = f(key, p)) and get marked
    touched — exactly the trainer's footprint (mark_trained_rows).
    Unlike ``_train_mutate`` it never touches other resident rows, so
    future passes' plan-pending rows stay value-less and pinned (the
    depth-N pipeline keeps several pending at once)."""
    with table.host_lock:
        for s, ks in enumerate(table._split_by_owner(keys)):
            rows = table.indexes[s].lookup(ks)
            ok = rows >= 0
            if ok.any():
                _mutate_rows(table, s, ks[ok], rows[ok], p)


def _tiered_pipeline_job(depth: int, passes: int, shards: int,
                         keys_per_pass: int, overlap_frac: float,
                         capacity_per_shard: int, build_delay: float,
                         train_sec: float, device: str) -> Dict:
    """One tiered job through train/device_pass.PassPipeline at the
    given depth: the build_fn mimics a routing-plan build (plan-assigns
    the pass keys — PassPipeline brackets it in plan_scope, so new keys
    become pending rows) plus a deterministic ``build_delay`` sleep
    standing in for the dedup/pack/H2D work; the host fetch then rides
    the same worker (stage queue). Training is the deterministic
    ``_train_mutate_keys`` device mutation + a ``train_sec`` sleep
    standing in for device compute. depth=0 = the sequential
    kick-per-pass oracle (build+stage strictly between passes). Returns
    the host-tier digest and the per-pass critical-path boundary stall
    (preload wait + begin_pass)."""
    from paddlebox_tpu_torch.config import flags_scope
    from paddlebox_tpu_torch.train.device_pass import PassPipeline
    with flags_scope(async_end_pass=True):
        table = _tiered_table(shards, capacity_per_shard, device)
        key_sets = [_pass_keys(p, keys_per_pass, overlap_frac)
                    for p in range(passes)]

        def build(keys_arr) -> _TimedPass:
            # the routing-plan assign of a real build (ps/sharded
            # prepare_global under plan_scope): new keys become
            # value-less PENDING rows the begin_pass reconcile fills
            for s, ks in enumerate(table._split_by_owner(keys_arr)):
                if not len(ks):
                    continue
                with table.host_lock:
                    pre = table.indexes[s].lookup(ks)
                    table.indexes[s].assign(ks)
                    if (pre < 0).any():
                        table._note_plan_assigned(s, ks[pre < 0])
            time.sleep(build_delay)   # dedup/pack/H2D stand-in
            return _TimedPass()

        pipe = PassPipeline(iter(key_sets), build_fn=build,
                            window_table=table, depth=depth,
                            keys_of=lambda k: k, device=device)
        pipe.start_next()
        stalls: List[float] = []
        for p in range(passes):
            t0 = time.perf_counter()
            rp = pipe.wait()
            assert rp is not None
            pipe.begin_pass()
            stalls.append(time.perf_counter() - t0)
            if depth > 0:
                pipe.start_next()
            _train_mutate_keys(table, key_sets[p], p)
            time.sleep(train_sec)     # device-compute stand-in
            pipe.end_pass()
            if depth == 0:
                # sequential oracle: the next build+stage only AFTER
                # this pass fully closed (kick-per-pass credit)
                pipe.start_next()
        pipe.drain()
        table.fence()
        digest = host_tier_digest(table)
        return {"digest": digest, "rows": table.feature_count(),
                "stalls": stalls}


def run_tiered_prologue_check(passes: int = 5, shards: int = 4,
                              keys_per_pass: int = 512,
                              overlap_frac: float = 0.9,
                              capacity_per_shard: int = 1024,
                              build_delay: float = 0.05,
                              train_sec: float = 0.1,
                              depth: int = 2, device: str = "cuda") -> Dict:
    """The tiered pipeline gate: (a) a depth-``depth`` tiered run
    through the unified PassPipeline reproduces the depth-0 sequential
    oracle's host-tier state digest BIT-FOR-BIT, ×2 seeded runs (the
    pipeline changes scheduling only, never results — and both runs of
    each depth agree, proving determinism), and (b) the steady-state
    begin_delta boundary stall (preload wait + begin_pass) drops ≥50%
    vs the no-overlap control. Raises AssertionError on any violated
    invariant; returns the evidence record."""
    assert passes >= 4, "steady state needs passes past the cold fill"

    def pair():
        seq = _tiered_pipeline_job(0, passes, shards, keys_per_pass,
                                   overlap_frac, capacity_per_shard,
                                   build_delay, train_sec, device)
        pipe = _tiered_pipeline_job(depth, passes, shards, keys_per_pass,
                                    overlap_frac, capacity_per_shard,
                                    build_delay, train_sec, device)
        return seq, pipe

    # ×2 seeded runs: the digest must agree between depths AND between
    # repeat runs (determinism of the whole pipeline machinery)
    digests = []
    steady0 = steadyn = 0.0
    s0 = sn = []
    for attempt in range(3):   # ≥2 always; 3rd is a timing-noise retry
        seq, pipe = pair()
        assert pipe["rows"] == seq["rows"], (pipe["rows"], seq["rows"])
        assert pipe["digest"] == seq["digest"], (
            f"depth-{depth} tiered pipeline produced a DIFFERENT "
            f"host-tier state than the sequential oracle: "
            f"{pipe['digest'][:16]}… != {seq['digest'][:16]}…")
        digests.append(pipe["digest"])
        s0, sn = seq["stalls"], pipe["stalls"]
        steady0 = sum(s0[2:])
        steadyn = sum(sn[2:])
        if len(digests) >= 2 and steady0 > build_delay \
                and steadyn <= 0.5 * steady0:
            break
    assert len(set(digests)) == 1, (
        f"tiered pipeline digest changed between seeded runs: {digests}")
    assert steady0 > build_delay, (
        f"sequential control shows no boundary stall ({steady0:.3f}s) — "
        f"the gate's build/train timing no longer exercises the "
        f"pipeline (stalls: {s0})")
    assert steadyn <= 0.5 * steady0, (
        f"depth-{depth} steady-state begin_delta stall {steadyn:.3f}s "
        f"did not drop >=50% vs the sequential control {steady0:.3f}s "
        f"(control {s0}, depth-{depth} {sn})")
    return {
        "check": "tiered_prologue_check",
        "ok": True,
        "depth": depth,
        "passes": passes,
        "runs": 2 * len(digests),
        "steady_stall_sec_seq": round(steady0, 4),
        f"steady_stall_sec_depth{depth}": round(steadyn, 4),
        "stall_drop_frac": round(1.0 - steadyn / max(steady0, 1e-9), 4),
        "digest": digests[0],
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="where the tables and the trainer live "
                         "(cuda or cpu)")
    args = ap.parse_args()
    shards = int(os.environ.get("PIPECHECK_SHARDS", "4"))
    passes = int(os.environ.get("PIPECHECK_PASSES", "3"))
    keys = int(os.environ.get("PIPECHECK_KEYS", "4096"))
    t0 = time.perf_counter()
    out = run_check(passes=passes, shards=shards, keys_per_pass=keys,
                    capacity_per_shard=max(1024, keys), device=args.device)
    print(json.dumps(out))
    print(json.dumps(run_prologue_check(device=args.device)))
    print(json.dumps(run_tiered_prologue_check(device=args.device)))
    print(f"PASS: pipeline gates held on {args.device} in "
          f"{time.perf_counter() - t0:.1f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
