#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (paddlebox_tpu_torch) on one GPU.

    python3 chip_smoke.py [--batches 8] [--seed 0] [--out chiprun_out/chip_smoke]

Phases, each of which fails the run:

1. require a CUDA device; print the card's name and power limit;
2. build every kernel of the serving and training paths from
   ``paddlebox_tpu_torch/csrc`` (one ``nvcc`` per source, all at once)
   and print the build seconds;
3. at the full-width shapes of those paths, hold each kernel against its
   plain PyTorch version on the card (``gather_rows``, ``segment_gather``
   in both modes and ``scatter_add_update`` exact, ``pool_cvm`` in all
   four CVM modes within rtol 3e-5 / atol 1e-6; the key index's insert
   and lookup exact in rows and new-masks, with the pass's unique keys
   going into a copy of an index seeded with the train base's keys) and
   time kernel, plain version and the nearest single PyTorch call with
   CUDA events;
4. serve ragged DeepFM batches end to end: a seeded ``save_base``-format
   table of 2.6M keyed rows loads into ``ServingModel(device="cuda")``
   with seeded random dense params, and ``predict`` answers ``--batches``
   batches of 4096 records (26 slots, 1 + Poisson(4) keys per slot,
   13 dense). Predictions must be finite, in (0, 1), and match the same
   forward through the plain versions; both kernels' launch counters
   must advance once per batch;
5. train on the same batches: ``EmbeddingTable(device="cuda")`` loads a
   seeded ``save_base``-format file of the keys with id < 90 000 of each
   slot (so every step also assigns new rows, and a quarter of the
   loaded rows have no mf yet, so lazy mf creation runs), and
   ``Trainer.train_pass`` takes ``--batches`` steps of DeepFM (512, 256,
   128) with sparse Adagrad and dense Adam. The loss must be finite at every step, each of the four
   kernels must launch once per step, the sentinel row must stay zero,
   rows the pass did not touch must stay bit-identical, and the trained
   table's ``save_base`` must load into ``ServingModel`` and predict.
   Then the same batches run twice more from the same start with the
   float32 tower and TF32 off, once through the kernels and once through
   the plain versions (passed in explicitly): touched table rows and
   dense params must agree within rtol 2e-4 / atol 2e-5. These two runs
   time each step synchronized, split into prepare, h2d and step;
6. train the same batches through the resident pass with the device key
   index (``use_pallas_index``): a fresh table loads the same base file,
   its ``DeviceKeyIndex`` is seeded from the host kv (insert kernel), and
   ``Trainer.train_pass_resident`` runs a pass whose rows were assigned
   on the card (device dedup + insert kernel). The index must not
   degrade, the insert kernel must launch for the seed and for the build
   and the four step kernels once per step, ``lookup_rows`` of the kv's
   keys (lookup kernel) must give the kv's rows, the pass's pull indexes
   and host kv must equal those of the host route on a second table, the
   sentinel row must stay zero and untouched rows bit-identical, and the
   loss finite. Then, with the float32 tower, TF32 off and no lazy-mf
   draws (``mf_initial_range`` 0: the two passes lay a batch's unique
   rows out differently, so their draws land on other rows), the
   resident pass and ``train_pass`` from the same start must agree
   within rtol 2e-4 / atol 2e-5.

The second-to-last line is the ``kernels`` JSON object, the last line
``{"ok": true, "device": {...}}``. Details (build logs, per-batch times)
go to ``<out>.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

# the slice's configuration: bench.py's "ragged" DeepFM shape
NUM_SLOTS = 26
DENSE_DIM = 13
MF_DIM = 8                       # Adagrad → row width 8 + 8 = 16
AVG_KEYS = 5.0                   # keys per (record, slot) = 1 + Poisson(4)
VOCAB_PER_SLOT = 100_000
TRAIN_BASE_VOCAB = 90_000        # the train base holds ids < this per slot
BATCH = 4096
CAPACITY = 1 << 23               # table [8 388 609, 16] f32 = 512 MiB
HIDDEN = (512, 256, 128)

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and f32 FLOP/s
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
POOL_RTOL, POOL_ATOL = 3e-5, 1e-6
# bf16 tower: the plain and kernel forwards differ in the f32 pooling
# order only; a flipped bf16 rounding of a tower input moves a
# probability by far less than this
PRED_ATOL = 2e-3
# the ragged train-state class. The plain pool sums in the kernel's key
# order and every other kernel is exact, so the kernel and plain training
# runs should agree bit for bit; a pooling-order difference of 1 ulp can
# flip a ReLU of the tower and move a few rows by ~1e-3, far past this
STATE_RTOL, STATE_ATOL = 2e-4, 2e-5


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, flush, iters: int = 20, warmup: int = 3,
            setup=None) -> float:
    """Mean device ms of ``fn`` over ``iters`` launches, each after an L2
    flush (the caller's inputs are not assumed cache-resident) and after
    ``setup``, untimed (restores what ``fn`` changes in place)."""
    for _ in range(warmup):
        if setup is not None:
            setup()
        fn()
    total = 0.0
    for _ in range(iters):
        if setup is not None:
            setup()
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def base_keys(vocab: int) -> np.ndarray:
    """The keys with id < ``vocab`` of every slot, slot by slot: the rows
    of a loaded base file, in row order."""
    return (np.arange(NUM_SLOTS, dtype=np.uint64)[:, None]
            * np.uint64(VOCAB_PER_SLOT)
            + np.arange(vocab, dtype=np.uint64)[None, :]).reshape(-1)


def make_table_blob(rng, convert, vocab: int = VOCAB_PER_SLOT,
                    no_mf: float = 0.0):
    """The keys with id < ``vocab`` of every slot (2.6M for the whole
    vocabulary) with seeded logical rows; a ``no_mf`` share of them has
    no mf yet (mf_size 0)."""
    keys = base_keys(vocab)
    n = len(keys)
    rows = np.zeros((n, 8 + MF_DIM), np.float32)
    show = rng.integers(1, 200, size=n).astype(np.float32)
    rows[:, 0] = show
    rows[:, 1] = np.floor(show * rng.random(n, dtype=np.float32) * 0.3)
    rows[:, 2] = rng.random(n, dtype=np.float32)
    rows[:, 3] = (keys // VOCAB_PER_SLOT).astype(np.float32)
    rows[:, 4] = rng.normal(0, 0.05, size=n).astype(np.float32)
    rows[:, 5:7] = 3.0
    rows[:, 7] = 1.0                       # mf_size > 0: embedx served
    rows[:, 8:] = rng.normal(0, 0.05, size=(n, MF_DIM)).astype(np.float32)
    if no_mf:
        lazy = rng.random(n) < no_mf
        rows[lazy, 7] = 0.0
        rows[lazy, 8:] = 0.0
    return convert.table_rows_from_logical(keys, rows, MF_DIM)


def make_records(rng, n: int, SlotRecord):
    counts = 1 + rng.poisson(AVG_KEYS - 1.0, size=(n, NUM_SLOTS))
    offs = np.zeros((n, NUM_SLOTS + 1), np.int32)
    np.cumsum(counts, axis=1, out=offs[:, 1:])
    total = offs[:, -1]
    base = np.repeat(np.tile(np.arange(NUM_SLOTS, dtype=np.uint64)
                             * np.uint64(VOCAB_PER_SLOT), n),
                     counts.reshape(-1))
    flat = rng.integers(0, VOCAB_PER_SLOT,
                        size=int(total.sum())).astype(np.uint64) + base
    starts = np.concatenate([[0], np.cumsum(total)[:-1]])
    dense = rng.normal(size=(n, DENSE_DIM)).astype(np.float32)
    labels = (rng.random(n) < 0.25).astype(np.float32)
    return [SlotRecord(keys=flat[starts[i]:starts[i] + total[i]],
                       slot_offsets=offs[i], dense=dense[i],
                       label=float(labels[i]), show=1.0,
                       clk=float(labels[i]))
            for i in range(n)]


def check_close(name, got, ref, rtol, atol) -> float:
    """Max abs error of ``got`` against ``ref``; raises where an element
    is outside rtol/atol (a NaN passes only where both are NaN)."""
    err = (got.double() - ref.double()).abs()
    both_nan = got.isnan() & ref.isnan()
    bad = ~(err <= atol + rtol * ref.double().abs()) & ~both_nan
    if bool(bad.any()):
        raise AssertionError(
            f"{name}: {int(bad.sum())} elements outside rtol {rtol} / atol "
            f"{atol}, max abs err {float(err.max()):.3g}")
    return float(err.nan_to_num(0.0).max())


def profile_step(torch, step, state, batch, gen):
    """Device time per kernel (name, ms, launches) of one synchronized
    training step under ``torch.profiler``, largest first. Only the
    device-side kernel events count: the ops that launched them, and
    annotated ranges on the device timeline (the optimizer's step),
    carry the same time and would count it twice."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(state, batch, gen)
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        if (not str(e.device_type).endswith("CUDA")
                or getattr(e, "is_user_annotation", False)):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if us > 0:
            rows.append((e.key, us / 1e3, e.count))
    return sorted(rows, key=lambda r: -r[1])


def index_phase(torch, batches, flush, card, details):
    """Phase 3, the key index: the pass's unique keys inserted into a copy
    of an index seeded with the train base's keys, through the insert
    kernel and through its plain version (rows and new-masks exact), then
    looked up through both lookups in both indexes (rows exact). Returns
    the two kernels' rows of the ``kernels`` line."""
    from paddlebox_tpu_torch.ops import index as IX
    from paddlebox_tpu_torch.ops.device_unique import dedup_keys_first_seen
    cuda = torch.device("cuda")
    base = base_keys(TRAIN_BASE_VOCAB)
    n_base = len(base)
    seeded = IX.DeviceKeyIndex(CAPACITY, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = seeded.assign_unique(base)
    seed_s = time.perf_counter() - t0
    if (out is None or not np.array_equal(out[0], np.arange(n_base))
            or not out[1].all()):
        raise AssertionError("seeding the key index did not give rows "
                             "0..n-1")
    keys = torch.from_numpy(np.concatenate(
        [b.keys[:b.num_keys] for b in batches]).view(np.int64)).to(cuda)
    uniq, _, _, u = dedup_keys_first_seen(keys)
    uniq = uniq[:u].contiguous()
    work = (seeded.keys.clone(), seeded.rows.clone())
    plain = (seeded.keys.clone(), seeded.rows.clone())
    rows, new, failed = IX.insert(*work, uniq, n_base, CAPACITY)
    rows_p, new_p, failed_p = IX.insert_plain(*plain, uniq, n_base, CAPACITY)
    torch.cuda.synchronize()
    if bool(failed) or bool(failed_p):
        raise AssertionError("the key index overflowed")
    if not (torch.equal(rows, rows_p) and torch.equal(new, new_p)):
        raise AssertionError("index_insert differs from its plain version")
    n_new = int(new.sum())
    for what, got in (
            ("kernel, kernel's index", IX.lookup(*work, uniq)),
            ("plain, kernel's index", IX.lookup_plain(*work, uniq)),
            ("kernel, plain index", IX.lookup(*plain, uniq)),
            ("plain, plain index", IX.lookup_plain(*plain, uniq))):
        if not torch.equal(got, rows):
            raise AssertionError(f"index_lookup ({what}) differs from the "
                                 f"inserted rows")
    # probe steps of this run's keys in the kernel's index: a key that
    # sits d buckets from its home took d + 1 steps to claim or match it
    # in the insert, and takes d + 1 in the lookup
    nb = seeded.n_buckets
    occ = torch.nonzero(work[1] >= 0).squeeze(1)
    off = (occ - IX._hash32(work[0][occ])) & (nb - 1)
    off_of_row = torch.zeros(CAPACITY, dtype=torch.int64, device=cuda)
    off_of_row[work[1][occ].long()] = off
    key_off = off_of_row[rows.long()]
    steps = int((key_off + 1).sum())

    def restore(dst):
        def fn():
            dst[0].copy_(seeded.keys)
            dst[1].copy_(seeded.rows)
        return fn

    src = "paddlebox_tpu_torch/csrc/key_index.cu"
    ins = {"name": "index_insert", "route": "cuda", "source": src,
           "replaces": "paddlebox_tpu/ops/pallas_index.py:233",
           "max_abs_err": 0.0,
           "ms": time_ms(torch, lambda: IX.insert(
               *work, uniq, n_base, CAPACITY), flush, setup=restore(work)),
           "plain_ms": time_ms(torch, lambda: IX.insert_plain(
               *plain, uniq, n_base, CAPACITY), flush, setup=restore(plain)),
           "library_ms": None,
           # keys read, rows and new-mask written, one 32-byte sector of
           # each bucket array per probe step
           "bound_ms": (u * (8 + 4 + 4) + steps * 64) / PEAK_BYTES * 1e3,
           "bound_by": "bytes"}
    lk = {"name": "index_lookup", "route": "cuda", "source": src,
          "replaces": "paddlebox_tpu/ops/pallas_index.py:344",
          "max_abs_err": 0.0,
          "ms": time_ms(torch, lambda: IX.lookup(*work, uniq), flush),
          "plain_ms": time_ms(torch, lambda: IX.lookup_plain(*work, uniq),
                              flush),
          "library_ms": None,
          "bound_ms": (u * (8 + 4) + steps * 64) / PEAK_BYTES * 1e3,
          "bound_by": "bytes"}
    details["index"] = {
        "seed_keys": n_base, "seed_s": seed_s, "pass_uniques": u,
        "new_keys": n_new, "probe_steps": steps,
        "max_probe_offset": int(key_off.max()), "n_buckets": nb}
    log(f"key index: {u} pass uniques ({n_new} new) into an index seeded "
        f"with {n_base} keys ({nb} buckets, seeded in {seed_s:.3f}s); "
        f"insert and lookup equal their plain versions; {steps} probe "
        f"steps, longest chain {int(key_off.max()) + 1}")
    for r in (ins, lk):
        log(f"  {r['name']}: {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} "
            f"ms, library -, bound {r['bound_ms'] * 1e3:.2f} us ({card})")
    return ins, lk


def train_phase(torch, args, card, desc, records, batches, details):
    """Phases 5 and 6: ``Trainer.train_pass`` at full width from a seeded
    base file, its invariants, the trained table served, and the
    kernel-vs-plain training runs; then the resident pass from the same
    base file. Returns each kernel's launches during the pass that drove
    it (the four step kernels: phase 5's; the key index: phase 6's)."""
    from paddlebox_tpu_torch import convert
    base = make_table_blob(np.random.default_rng(args.seed + 1), convert,
                           vocab=TRAIN_BASE_VOCAB, no_mf=0.25)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "train_base.npz")
        np.savez(path, **base)
        n_base = len(base["keys"])
        del base
        launches = _train(torch, args, card, desc, records, batches,
                          details, tmp, path, n_base)
        launches.update(_resident(torch, args, card, desc, records,
                                  batches, details, path, n_base))
        return launches


def _train(torch, args, card, desc, records, batches, details, tmp,
           base_path, n_base):
    from paddlebox_tpu_torch import (DeepFM, EmbeddingTable, InMemoryDataset,
                                     ServingModel, Trainer)
    from paddlebox_tpu_torch.device import seeded_generator
    from paddlebox_tpu_torch.metrics import init_auc_state
    from paddlebox_tpu_torch.ops import kernels as K
    from paddlebox_tpu_torch.ps.table import TableState
    from paddlebox_tpu_torch.train.step import (StepState, TrainStep,
                                                default_tx,
                                                make_device_batch)

    cuda = torch.device("cuda")

    def fresh_table():
        t = EmbeddingTable(mf_dim=MF_DIM, capacity=CAPACITY, seed=args.seed,
                           device="cuda")
        t.load(base_path)
        return t

    t0 = time.perf_counter()
    table = fresh_table()
    start = table.state.data.clone()
    torch.manual_seed(args.seed + 2)
    model = DeepFM(NUM_SLOTS, 3 + MF_DIM, DENSE_DIM, hidden=HIDDEN)
    init_params = {k: v.clone() for k, v in model.state_dict().items()}
    trainer = Trainer(model, table, desc, seed=args.seed,
                      check_nan_inf=True, device="cuda")
    ds = InMemoryDataset(desc)
    ds.records = records
    torch.cuda.synchronize()
    log(f"train setup: base file of {n_base} rows loaded in "
        f"{time.perf_counter() - t0:.2f}s")

    fns = (K.gather_rows, K.pool_cvm, K.segment_gather, K.scatter_add_update)
    for fn in fns:
        fn.launches = 0
    # check_nan_inf: the loss is read, and must be finite, at every step
    res = trainer.train_pass(ds)
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in fns}
    for name, n in launches.items():
        if n != len(batches):
            raise AssertionError(f"train: {name} launched {n} times for "
                                 f"{len(batches)} steps")
    if res["batches"] != len(batches) or not np.isfinite(res["last_loss"]):
        raise AssertionError(f"train pass went wrong: {res}")
    data = table.state.data
    if bool(data[CAPACITY].any()):
        raise AssertionError("the sentinel row was written")
    touched = torch.from_numpy(table._touched).to(cuda)
    changed = (data != start).any(dim=1)
    if bool((changed & ~touched).any()):
        raise AssertionError("rows the pass did not touch changed")
    n_touched, n_changed = int(touched.sum()), int(changed.sum())
    n_new = len(table.index) - n_base
    created = int(((start[:, 7] == 0) & (data[:, 7] > 0)
                   & (start[:, 0] > 0)).sum())
    if n_new <= 0 or created <= 0 or n_changed <= 0:
        raise AssertionError(f"train pass assigned {n_new} new rows, "
                             f"created {created} mf blocks, changed "
                             f"{n_changed} rows")
    del start, changed, touched
    stages = {k: [x * 1e3 for x in v]
              for k, v in trainer.stage_timers.seconds.items()}
    log(f"train pass: {res['batches']} steps of {BATCH}, "
        f"{res['examples_per_sec']:.0f} examples/s (bf16 tower, prefetch "
        f"pipeline, loss read every step), auc {res['auc']:.4f}, last "
        f"loss {res['last_loss']:.4f}; {n_new} new rows, {created} mf "
        f"created, {n_changed} of {n_touched} touched rows changed "
        f"({card})")

    # the trained table's save_base serves
    path = os.path.join(tmp, "trained.npz")
    t0 = time.perf_counter()
    n_saved = table.save_base(path)
    save_s = time.perf_counter() - t0
    srv = ServingModel(DeepFM(NUM_SLOTS, 3 + MF_DIM, DENSE_DIM,
                              hidden=HIDDEN), desc, mf_dim=MF_DIM,
                       capacity=CAPACITY, device="cuda")
    if srv.load_base(path) != n_saved:
        raise AssertionError("save_base rows did not all load")
    srv.load_params(model.state_dict())
    pred, ins_w = srv.predict(batches[0], return_valid=True)
    live = pred[ins_w > 0]
    if (pred.shape != (BATCH,) or not np.isfinite(pred).all()
            or not ((live > 0) & (live < 1)).all()):
        raise AssertionError("the trained table serves bad predictions")
    del srv
    log(f"save_base: {n_saved} rows in {save_s:.2f}s, served batch 0")

    # kernel vs plain training, from the same start, f32 tower, TF32 off;
    # the index work (prepare) runs once and both runs replay it
    fresh = fresh_table()
    prep_ms, idxs = [], []
    for b in batches:
        t0 = time.perf_counter()
        idxs.append(fresh.prepare(b))
        prep_ms.append((time.perf_counter() - t0) * 1e3)
    rows_t = torch.from_numpy(np.nonzero(fresh._touched)[0]).to(cuda)

    def run(ops):
        m = DeepFM(NUM_SLOTS, 3 + MF_DIM, DENSE_DIM, hidden=HIDDEN,
                   compute_dtype=torch.float32).to(cuda)
        m.load_state_dict(init_params)
        st = StepState(table=TableState(fresh.state.data.clone(),
                                        fresh.state.ext),
                       model=m, opt=default_tx(m.parameters()),
                       auc=init_auc_state(device=cuda))
        step = TrainStep(fresh.cfg, BATCH, NUM_SLOTS, ops=ops)
        h2d, step_ms, losses = [], [], []
        for i, (b, ix) in enumerate(zip(batches, idxs), start=1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            dv = make_device_batch(b, ix, cuda)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            stats = step(st, dv, seeded_generator(cuda, args.seed + 1, i))
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            h2d.append((t1 - t0) * 1e3)
            step_ms.append((t2 - t1) * 1e3)
            losses.append(float(stats["loss"]))
        if not np.isfinite(losses).all():
            raise AssertionError(f"non-finite loss: {losses}")
        return st, h2d, step_ms, losses

    sk, h2d_k, step_k, loss_k = run(K.KERNELS)
    sp, h2d_p, step_p, loss_p = run(K.PLAIN)
    row_err = check_close("train: touched table rows, kernels vs plain",
                          sk.table.data[rows_t], sp.table.data[rows_t],
                          STATE_RTOL, STATE_ATOL)
    pk, pp = sk.model.state_dict(), sp.model.state_dict()
    param_err = max(check_close(f"train: dense param {k}", pk[k], pp[k],
                                STATE_RTOL, STATE_ATOL) for k in pk)
    split = {"prepare_ms": float(np.median(prep_ms)),
             "h2d_ms": float(np.median(h2d_k)),
             "step_ms": float(np.median(step_k))}
    step_p50 = sum(split.values())
    log(f"train steps (f32 tower, synchronized): p50 "
        f"{step_p50:.2f} ms = "
        f"{json.dumps({k: round(v, 3) for k, v in split.items()})}, "
        f"{BATCH / step_p50 * 1e3:.0f} examples/s; device step p50 "
        f"{split['step_ms']:.3f} ms through the kernels, "
        f"{float(np.median(step_p)):.3f} ms through the plain versions; "
        f"kernels vs plain max abs err rows {row_err:.3g}, params "
        f"{param_err:.3g} ({card})")
    # where one device step's time goes (kernel state, batch 0 again)
    prof = profile_step(torch, TrainStep(fresh.cfg, BATCH, NUM_SLOTS), sk,
                        make_device_batch(batches[0], idxs[0], cuda),
                        seeded_generator(cuda, args.seed + 1, 0))
    busy = sum(r[1] for r in prof)
    log(f"train step profile (f32 tower): device busy {busy:.3f} ms in "
        f"{sum(r[2] for r in prof)} launches, {busy / split['step_ms']:.1%} "
        f"of the step p50; top: "
        + "; ".join(f"{name[:48]} {ms:.3f} ms x{n}"
                    for name, ms, n in prof[:8]) + f" ({card})")
    details["train"] = {
        "profile_device_ms": prof, "profile_busy_ms": busy,
        "pass": res, "stage_ms": stages, "new_rows": n_new,
        "mf_created": created, "rows_changed": n_changed,
        "rows_touched": n_touched, "saved_rows": n_saved,
        "save_base_s": save_s, "launches": launches,
        "prepare_ms": prep_ms, "h2d_ms": h2d_k, "step_ms": step_k,
        "plain_h2d_ms": h2d_p, "plain_step_ms": step_p,
        "loss_kernels": loss_k, "loss_plain": loss_p,
        "step_p50_ms": step_p50, "split_p50_ms": split,
        "row_max_abs_err": row_err, "param_max_abs_err": param_err}
    return launches


def _resident(torch, args, card, desc, records, batches, details,
              base_path, n_base):
    """Phase 6: ``Trainer.train_pass_resident`` with the device key index
    from the train base file (see the module docstring). Returns the
    index kernels' launches in that run."""
    from paddlebox_tpu_torch import (DeepFM, EmbeddingTable, InMemoryDataset,
                                     Trainer)
    from paddlebox_tpu_torch.config import flags_scope
    from paddlebox_tpu_torch.ops import index as IX
    from paddlebox_tpu_torch.ops import kernels as K
    from paddlebox_tpu_torch.ps.sgd import SparseSGDConfig
    from paddlebox_tpu_torch.train.device_pass import ResidentPass

    cuda = torch.device("cuda")
    nb = len(batches)

    def fresh_table(cfg=None):
        t = EmbeddingTable(mf_dim=MF_DIM, capacity=CAPACITY, cfg=cfg,
                           seed=args.seed, device="cuda")
        t.load(base_path)
        return t

    def model(dtype=None):
        torch.manual_seed(args.seed + 2)      # phase 5's initial params
        kw = {} if dtype is None else {"compute_dtype": dtype}
        return DeepFM(NUM_SLOTS, 3 + MF_DIM, DENSE_DIM, hidden=HIDDEN, **kw)

    ds = InMemoryDataset(desc)
    ds.records = records
    table = fresh_table()
    start = table.state.data.clone()
    trainer = Trainer(model(), table, desc, seed=args.seed,
                      check_nan_inf=True, device="cuda")
    torch.cuda.synchronize()

    fns = {"index_insert": IX.insert, "index_lookup": IX.lookup,
           "gather_rows": K.gather_rows, "pool_cvm": K.pool_cvm,
           "segment_gather": K.segment_gather,
           "scatter_add_update": K.scatter_add_update}
    for fn in fns.values():
        fn.launches = 0
    ticks0 = dict(IX.DISPATCH)
    with flags_scope(use_pallas_index=True):
        t0 = time.perf_counter()
        dev = table._device_index()          # seeded from the host kv
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        rp = ResidentPass.build(ds, table)
        t2 = time.perf_counter()
        res = trainer.train_pass_resident(rp)
        t3 = time.perf_counter()
        keys, rows = table.index.items()
        mirror = dev.lookup_rows(keys)
    launches = {name: fn.launches for name, fn in fns.items()}
    ticks = {k: v - ticks0.get(k, 0) for k, v in IX.DISPATCH.items()
             if v != ticks0.get(k, 0)}
    seed_s, build_s, pass_s = t1 - t0, t2 - t1, t3 - t2

    if dev.degraded:
        raise AssertionError(f"the device key index degraded: "
                             f"{dev.degrade_reason}")
    if ticks != {("index.assign", "device"): 1}:
        raise AssertionError(f"index dispatch decisions {ticks}")
    want = {"index_insert": 2, "index_lookup": 1, "gather_rows": nb,
            "pool_cvm": nb, "segment_gather": nb, "scatter_add_update": nb}
    if launches != want:
        raise AssertionError(f"resident: launches {launches}, expected "
                             f"{want} (insert: seed + build)")
    if not np.array_equal(mirror, rows.astype(np.int64)) \
            or dev.next_row != len(keys):
        raise AssertionError("the device index does not mirror the kv")
    if res["batches"] != nb or not np.isfinite(res["last_loss"]):
        raise AssertionError(f"resident pass went wrong: {res}")
    data = table.state.data
    if bool(data[CAPACITY].any()):
        raise AssertionError("resident: the sentinel row was written")
    touched = torch.from_numpy(table._touched).to(cuda)
    changed = (data != start).any(dim=1)
    if bool((changed & ~touched).any()):
        raise AssertionError("resident: rows the pass did not touch "
                             "changed")
    n_new = len(keys) - n_base
    created = int(((start[:, 7] == 0) & (data[:, 7] > 0)
                   & (start[:, 0] > 0)).sum())
    n_changed = int(changed.sum())
    if n_new <= 0 or created <= 0 or n_changed <= 0:
        raise AssertionError(f"resident pass assigned {n_new} new rows, "
                             f"created {created} mf blocks, changed "
                             f"{n_changed} rows")
    del start, changed, touched

    # the host route on a second table gives the same pull indexes and
    # kv; that table then trains the pass through train_pass (its kv
    # already holds the rows train_pass would assign)
    cfg0 = SparseSGDConfig(mf_initial_range=0.0)
    host = fresh_table(cfg0)
    with flags_scope(use_pallas_index=False):
        t0 = time.perf_counter()
        rp_host = ResidentPass.build(ds, host)
        host_s = time.perf_counter() - t0
    host_stats = rp_host.build_stats
    for a in ("uniq", "gidx", "meta", "segs"):
        if not np.array_equal(getattr(rp, a), getattr(rp_host, a)):
            raise AssertionError(f"resident: {a} of the device route "
                                 f"differs from the host route's")
    if (host.index._map != table.index._map
            or not np.array_equal(host.slot_host, table.slot_host)):
        raise AssertionError("resident: the device route's kv differs "
                             "from the host route's")
    del rp_host, table, trainer, dev

    # resident vs train_pass from the same start: f32 tower, TF32 off
    stream = Trainer(model(torch.float32), host, desc, seed=args.seed,
                     check_nan_inf=True, device="cuda")
    res_s = stream.train_pass(ds)
    resident_t = fresh_table(cfg0)
    resident = Trainer(model(torch.float32), resident_t, desc,
                       seed=args.seed, check_nan_inf=True, device="cuda")
    with flags_scope(use_pallas_index=True):
        res_r = resident.train_pass_resident(ds)
    rows_t = torch.from_numpy(np.nonzero(host._touched
                                         | resident_t._touched)[0]).to(cuda)
    row_err = check_close("resident vs train_pass: touched rows",
                          resident_t.state.data[rows_t],
                          host.state.data[rows_t], STATE_RTOL, STATE_ATOL)
    ps, pr = stream.model.state_dict(), resident.model.state_dict()
    param_err = max(check_close(f"resident vs train_pass: {k}", pr[k],
                                ps[k], STATE_RTOL, STATE_ATOL) for k in ps)
    auc_diff = abs(res_r["auc"] - res_s["auc"])
    del host, resident_t, stream, resident

    n_rec = rp.num_records
    stats = {k: round(v, 4) for k, v in rp.build_stats.items()}
    phase5 = details["train"]["pass"]["examples_per_sec"]
    log(f"resident pass: {nb} steps of {BATCH}, index seeded with "
        f"{n_base} keys in {seed_s:.3f}s; build {build_s:.3f}s "
        f"{json.dumps(stats)}; steps {res['elapsed_sec']:.3f}s; "
        f"{n_rec / (build_s + res['elapsed_sec']):.0f} examples/s with "
        f"the build, {res['examples_per_sec']:.0f} without (bf16 tower; "
        f"phase 5 train_pass {phase5:.0f}); auc {res['auc']:.4f}, last "
        f"loss {res['last_loss']:.4f}; {n_new} new rows, {created} mf "
        f"created; host-route build {host_s:.3f}s "
        f"{json.dumps({k: round(v, 4) for k, v in host_stats.items()})} "
        f"({card})")
    log(f"resident vs train_pass (f32 tower, no mf draws): max abs err "
        f"rows {row_err:.3g}, params {param_err:.3g}, auc {auc_diff:.3g} "
        f"({card})")
    details["resident"] = {
        "pass": res, "seed_s": seed_s, "build_s": build_s,
        "pass_s": pass_s, "build_stats": rp.build_stats,
        "host_build_s": host_s, "host_build_stats": host_stats,
        "launches": launches, "new_rows": n_new,
        "mf_created": created, "rows_changed": n_changed,
        "examples_per_sec_with_build": n_rec / (build_s
                                                + res["elapsed_sec"]),
        "wire_bytes": rp.nbytes(), "row_max_abs_err": row_err,
        "param_max_abs_err": param_err, "auc_diff": auc_diff,
        "train_pass_f32": res_s, "resident_f32": res_r}
    return {k: launches[k] for k in ("index_insert", "index_lookup")}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batches", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="chiprun_out/chip_smoke")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    card = card_line()
    log(f"card: {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from paddlebox_tpu_torch import DeepFM, ServingModel, convert
    from paddlebox_tpu_torch.data import (BatchBuilder, DataFeedDesc,
                                          SlotDef, SlotRecord)
    from paddlebox_tpu_torch.ops import _build
    from paddlebox_tpu_torch.ops import kernels as K
    from paddlebox_tpu_torch.ps.table import expand_pull, pull_values
    from paddlebox_tpu_torch.train.step import ctr_forward, make_device_batch

    details: dict = {"card": card, "config": {
        "num_slots": NUM_SLOTS, "dense_dim": DENSE_DIM, "mf_dim": MF_DIM,
        "avg_keys_per_slot": AVG_KEYS, "vocab_per_slot": VOCAB_PER_SLOT,
        "batch": BATCH, "capacity": CAPACITY, "hidden": HIDDEN,
        "batches": args.batches, "seed": args.seed}}

    # ---- phase 2: build ----
    t0 = time.perf_counter()
    secs = _build.build()
    log(f"build: {json.dumps({k: round(v, 2) for k, v in secs.items()})} "
        f"wall {time.perf_counter() - t0:.2f}s")
    details["build_s"] = secs
    details["build_logs"] = dict(_build.build_logs)
    for name, text in _build.build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    # ---- data: table file, records, params (all from the seed) ----
    rng = np.random.default_rng(args.seed)
    t0 = time.perf_counter()
    blob = make_table_blob(rng, convert)
    records = make_records(rng, BATCH * args.batches, SlotRecord)
    slots = ([SlotDef("label", "float", 1),
              SlotDef("dense", "float", DENSE_DIM)]
             + [SlotDef(f"C{i}", "uint64") for i in range(1, NUM_SLOTS + 1)])
    desc = DataFeedDesc(slots=slots, batch_size=BATCH, label_slot="label",
                        key_bucket_min=4096)
    builder = BatchBuilder(desc)
    batches = [builder.build(records[i:i + BATCH])
               for i in range(0, len(records), BATCH)]
    torch.manual_seed(args.seed)
    model = DeepFM(NUM_SLOTS, 3 + MF_DIM, DENSE_DIM, hidden=HIDDEN)
    params = {k: v.clone() for k, v in model.state_dict().items()}
    log(f"data: {len(blob['keys'])} keyed rows, {len(batches)} batches, "
        f"{batches[0].num_keys} keys in batch 0 (K_pad "
        f"{batches[0].key_capacity}) in {time.perf_counter() - t0:.2f}s")

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "base.npz")
        np.savez(path, **blob)
        del blob
        t0 = time.perf_counter()
        srv = ServingModel(model, desc, mf_dim=MF_DIM, capacity=CAPACITY,
                           device="cuda")
        n_rows = srv.load_base(path)
    srv.load_params(params)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    log(f"load: {n_rows} rows into [{CAPACITY + 1}, "
        f"{srv.table.state.feat}] in {load_s:.2f}s")
    details["load_s"] = load_s
    snap = srv.snapshot()
    table = snap.table.state.data
    flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")

    # ---- phase 3: each kernel against its plain version ----
    b0 = batches[0]
    idx = snap.table.prepare_eval(b0)
    dev = make_device_batch(b0, idx, srv.device)
    rows = dev.unique_rows
    u_real = idx.num_unique
    got = K.gather_rows(table, rows)
    ref = K.gather_rows_plain(table, rows)
    torch.cuda.synchronize()
    if not torch.equal(got, ref):
        raise AssertionError("gather_rows differs from its plain version")
    rows_c = torch.where(rows.long() > CAPACITY, CAPACITY, rows.long())
    feat = table.shape[1]
    g = {"name": "gather_rows", "route": "cuda",
         "source": "paddlebox_tpu_torch/csrc/gather_rows.cu",
         "replaces": "paddlebox_tpu/ops/pallas_kernels.py:120",
         "max_abs_err": 0.0,
         "ms": time_ms(torch, lambda: K.gather_rows(table, rows), flush),
         "plain_ms": time_ms(torch, lambda: K.gather_rows_plain(table, rows),
                             flush),
         "library_ms": time_ms(
             torch, lambda: torch.index_select(table, 0, rows_c), flush),
         "bound_ms": (2 * u_real * feat * 4 + u_real * 4) / PEAK_BYTES * 1e3,
         "bound_by": "bytes"}

    # the path pools the batch's real keys (the key bucket's padded tail
    # is dropped before the expand, see train/step.py _expand_pool)
    k_real = b0.num_keys
    values = expand_pull(pull_values(ref, MF_DIM), dev.gather_idx[:k_real])
    values = values.contiguous()
    segs = dev.segments[:k_real].contiguous()
    keep = K.show_clk_keep(values, 0.2, 1.0, 0.96).float()
    n_seg = BATCH * NUM_SLOTS
    pool_err = 0.0
    for mode, off, pad in ((K.CVM_NONE, 2, 0.0), (K.CVM_FULL, 2, 0.0),
                           (K.CVM_SHOW, 2, 0.25), (K.CVM_CONV, 3, 0.25)):
        out = K.pool_cvm(values, segs, keep, BATCH, NUM_SLOTS, mode, off, 0,
                         pad)
        want = K.pool_cvm_plain(values, segs, keep, BATCH, NUM_SLOTS, mode,
                                off, 0, pad)
        torch.cuda.synchronize()
        pool_err = max(pool_err, check_close(f"pool_cvm mode {mode}", out,
                                             want, POOL_RTOL, POOL_ATOL))
    d = values.shape[1]
    valid = (segs >= 0) & (segs < n_seg)
    lengths = torch.bincount(segs[valid].long(), minlength=n_seg)
    vals_valid = (values * keep[:, None])[valid].contiguous()
    p = {"name": "pool_cvm", "route": "cuda",
         "source": "paddlebox_tpu_torch/csrc/pool_cvm.cu",
         "replaces": "paddlebox_tpu/ops/pallas_kernels.py:654",
         "max_abs_err": pool_err,
         "ms": time_ms(torch, lambda: K.pool_cvm(
             values, segs, None, BATCH, NUM_SLOTS), flush),
         "plain_ms": time_ms(torch, lambda: K.pool_cvm_plain(
             values, segs, None, BATCH, NUM_SLOTS), flush),
         "library_ms": time_ms(torch, lambda: torch.segment_reduce(
             vals_valid, "sum", lengths=lengths), flush),
         "bound_ms": max((k_real * (d + 2) * 4 + n_seg * d * 4) / PEAK_BYTES,
                         k_real * d / PEAK_F32) * 1e3,
         "bound_by": "bytes"}
    # the pool kernel alone, without its wrapper's id-stream preparation
    seg_s = K._suffix_min(torch.where(valid, segs, n_seg), n_seg)
    keep_s = valid.float()
    out_s = torch.empty((n_seg, d), dtype=torch.float32, device="cuda")
    raw = _build.function("pool_cvm", "pbx_pool_cvm", K._POOL_ARGS)
    stream = torch.cuda.current_stream().cuda_stream
    details["pool_cvm_kernel_only_ms"] = time_ms(torch, lambda: raw(
        values.data_ptr(), seg_s.data_ptr(), keep_s.data_ptr(),
        out_s.data_ptr(), values.shape[0], n_seg, d, d, K.CVM_FULL, 2, 0,
        0.0, stream), flush)

    # segment_gather at the pool backward's shapes: the output grad of
    # the pooled [B, S, 3 + MF] block with its two head columns sliced
    # off (a strided view) and the batch show/clk head; the path passes
    # no mask (need_filter off), the check adds one as well
    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed)
    g_out = torch.randn((n_seg, d), generator=gen, device="cuda")
    src = g_out[:, 2:]
    head = dev.show_clk.contiguous()
    for mode, extra in (("gather", ()),
                        ("fused", (head, None, BATCH, NUM_SLOTS, 0)),
                        ("fused, masked", (head, keep, BATCH, NUM_SLOTS, 1))):
        got = K.segment_gather(src, segs, *extra)
        want = K.segment_gather_plain(src, segs, *extra)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"segment_gather ({mode} mode) differs "
                                 f"from its plain version")
    w = src.shape[1]
    n_src = int(torch.unique(segs[valid]).numel())
    live_ids = torch.where(valid, segs.long(), n_seg)
    src_z = torch.cat([src, src.new_zeros((1, w))])
    sg = {"name": "segment_gather", "route": "cuda",
          "source": "paddlebox_tpu_torch/csrc/segment_gather.cu",
          "replaces": "paddlebox_tpu/ops/pallas_kernels.py:531",
          "max_abs_err": 0.0,
          "ms": time_ms(torch, lambda: K.segment_gather(
              src, segs, head, None, BATCH, NUM_SLOTS), flush),
          "plain_ms": time_ms(torch, lambda: K.segment_gather_plain(
              src, segs, head, None, BATCH, NUM_SLOTS), flush),
          "library_ms": time_ms(
              torch, lambda: torch.index_select(src_z, 0, live_ids), flush),
          # ids + head + the distinct src rows read, [K, 2 + w] written
          "bound_ms": (k_real * 4 + head.numel() * 4 + n_src * w * 4
                       + k_real * (2 + w) * 4) / PEAK_BYTES * 1e3,
          "bound_by": "bytes"}
    details["segment_gather_gather_mode_ms"] = time_ms(
        torch, lambda: K.segment_gather(src, segs), flush)

    # scatter_add_update at the push's shapes: the batch's unique rows
    # into the [C, 16] table (copies: the serving table stays as it is)
    rows_u = dev.unique_rows.contiguous()
    u_pad = rows_u.shape[0]
    deltas = torch.randn((u_pad, feat), generator=gen, device="cuda") * 1e-3
    vals_k = table[:CAPACITY].clone()
    vals_p = vals_k.clone()
    K.scatter_add_update(vals_k, rows_u, deltas)
    K.scatter_add_update_plain(vals_p, rows_u, deltas)
    torch.cuda.synchronize()
    if not torch.equal(vals_k, vals_p):
        raise AssertionError("scatter_add_update differs from its plain "
                             "version")
    kept = (rows_u >= 0) & (rows_u < CAPACITY)
    rows_kept, deltas_kept = rows_u[kept].long(), deltas[kept]
    sa = {"name": "scatter_add_update", "route": "cuda",
          "source": "paddlebox_tpu_torch/csrc/scatter_add_update.cu",
          "replaces": "paddlebox_tpu/ops/pallas_index.py:412",
          "max_abs_err": 0.0,
          "ms": time_ms(torch, lambda: K.scatter_add_update(
              vals_k, rows_u, deltas), flush),
          "plain_ms": time_ms(torch, lambda: K.scatter_add_update_plain(
              vals_p, rows_u, deltas), flush),
          "library_ms": time_ms(torch, lambda: vals_p.index_add_(
              0, rows_kept, deltas_kept), flush),
          # every id read; each kept row: its delta and table row read,
          # the table row written
          "bound_ms": (u_pad * 4 + u_real * 3 * feat * 4) / PEAK_BYTES * 1e3,
          "bound_by": "bytes"}
    del vals_k, vals_p, g_out, src_z
    log(f"kernels vs plain: gather_rows, segment_gather (3 modes), "
        f"scatter_add_update exact; pool_cvm 4 modes max abs err "
        f"{pool_err:.3g}")
    for r in (g, p, sg, sa):
        log(f"  {r['name']}: {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} "
            f"ms, library {r['library_ms']:.4f} ms, bound "
            f"{r['bound_ms'] * 1e3:.2f} us ({card})")
    log(f"  pool_cvm kernel alone: "
        f"{details['pool_cvm_kernel_only_ms']:.4f} ms ({card})")
    ins, lk = index_phase(torch, batches, flush, card, details)

    # ---- phase 4: the serving path end to end ----
    K.gather_rows.launches = 0
    K.pool_cvm.launches = 0
    preds, lat = [], []
    for b in batches:
        t0 = time.perf_counter()
        pred, ins_w = srv.predict(b, return_valid=True)
        lat.append((time.perf_counter() - t0) * 1e3)
        preds.append((pred, ins_w))
    launches = {"gather_rows": K.gather_rows.launches,
                "pool_cvm": K.pool_cvm.launches}
    for name, n in launches.items():
        if n != len(batches):
            raise AssertionError(f"{name} launched {n} times for "
                                 f"{len(batches)} batches")
    # the same forward through the plain versions, on the card
    err = 0.0
    for b, (pred, ins_w) in zip(batches, preds):
        if pred.shape != (BATCH,) or not np.isfinite(pred).all():
            raise AssertionError("non-finite or misshapen predictions")
        live = pred[ins_w > 0]
        if not ((live > 0) & (live < 1)).all():
            raise AssertionError("predictions outside (0, 1)")
        ix = snap.table.prepare_eval(b)
        dv = make_device_batch(b, ix, srv.device)
        with torch.inference_mode():
            nk = b.num_keys
            v = expand_pull(pull_values(K.gather_rows_plain(
                table, dv.unique_rows), MF_DIM), dv.gather_idx[:nk])
            pooled = K.pool_cvm_plain(v, dv.segments[:nk], None, BATCH,
                                      NUM_SLOTS)
            want = torch.sigmoid(snap.model(pooled, dv.dense)).cpu().numpy()
        err = max(err, float(np.abs(pred - want).max()))
    if err > PRED_ATOL:
        raise AssertionError(f"predictions differ from the plain forward "
                             f"by {err:.3g} > {PRED_ATOL}")

    # where a predict's time goes: host lookup, H2D, device forward
    parts = {"prepare_ms": [], "h2d_ms": [], "forward_ms": []}
    for b in batches:
        t0 = time.perf_counter()
        ix = snap.table.prepare_eval(b)
        t1 = time.perf_counter()
        dv = make_device_batch(b, ix, srv.device)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        with torch.inference_mode():
            ctr_forward(snap.table.state, snap.model, dv, BATCH, NUM_SLOTS)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        parts["prepare_ms"].append((t1 - t0) * 1e3)
        parts["h2d_ms"].append((t2 - t1) * 1e3)
        parts["forward_ms"].append((t3 - t2) * 1e3)
    p50 = float(np.median(lat))
    split = {k: float(np.median(v)) for k, v in parts.items()}
    log(f"serve: {len(batches)} batches of {BATCH}, predict p50 {p50:.2f} "
        f"ms, {BATCH / p50 * 1e3:.0f} examples/s; p50 split "
        f"{json.dumps({k: round(v, 3) for k, v in split.items()})}; "
        f"max |pred - plain| {err:.3g} ({card})")
    details.update(predict_ms=lat, predict_p50_ms=p50, split_p50_ms=split,
                   pred_max_abs_err=err, serve_launches=launches)

    # ---- phases 5 and 6: the training paths ----
    train_launches = train_phase(torch, args, card, desc, records, batches,
                                 details)
    kernels = [g, p, sg, sa, ins, lk]
    for r in kernels:
        r["launches"] = train_launches[r["name"]]
    details["kernels"] = kernels

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out + ".json", "w") as fh:
        json.dump(details, fh, indent=1, default=str)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
