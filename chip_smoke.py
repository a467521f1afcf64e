#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (paddlebox_tpu_torch) on one GPU.

    python3 chip_smoke.py [--batches 8] [--seed 0] [--out chiprun_out/chip_smoke]

Phases, each of which fails the run:

1. require a CUDA device; print the card's name and power limit;
2. build every kernel of the serving path from ``paddlebox_tpu_torch/csrc``
   (one ``nvcc`` per source, all at once) and print the build seconds;
3. at the serving path's full-width shapes, hold each kernel against its
   plain PyTorch version on the card (``gather_rows`` exact, ``pool_cvm``
   in all four CVM modes within rtol 3e-5 / atol 1e-6) and time kernel,
   plain version and the nearest single PyTorch call with CUDA events;
4. serve ragged DeepFM batches end to end: a seeded ``save_base``-format
   table of 2.6M keyed rows loads into ``ServingModel(device="cuda")``
   with seeded random dense params, and ``predict`` answers ``--batches``
   batches of 4096 records (26 slots, 1 + Poisson(4) keys per slot,
   13 dense). Predictions must be finite, in (0, 1), and match the same
   forward through the plain versions; both kernels' launch counters
   must advance once per batch.

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


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, flush, iters: int = 20, warmup: int = 3) -> float:
    """Mean device ms of ``fn`` over ``iters`` launches, each after an L2
    flush (the caller's inputs are not assumed cache-resident)."""
    for _ in range(warmup):
        fn()
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def make_table_blob(rng, convert):
    """Every key of the vocabulary (2.6M) with a seeded logical row."""
    n = NUM_SLOTS * VOCAB_PER_SLOT
    keys = np.arange(n, dtype=np.uint64)   # slot * VOCAB + id
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

    values = expand_pull(pull_values(ref, MF_DIM), dev.gather_idx)
    values = values.contiguous()
    segs = dev.segments.contiguous()
    keep = K.show_clk_keep(values, 0.2, 1.0, 0.96).float()
    n_seg = BATCH * NUM_SLOTS
    k_real = b0.num_keys
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
    log(f"kernels vs plain: gather_rows exact; pool_cvm 4 modes max abs err "
        f"{pool_err:.3g}")
    for r in (g, p):
        log(f"  {r['name']}: {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} "
            f"ms, library {r['library_ms']:.4f} ms, bound "
            f"{r['bound_ms'] * 1e3:.2f} us ({card})")
    log(f"  pool_cvm kernel alone: "
        f"{details['pool_cvm_kernel_only_ms']:.4f} ms ({card})")

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
            v = expand_pull(pull_values(K.gather_rows_plain(
                table, dv.unique_rows), MF_DIM), dv.gather_idx)
            pooled = K.pool_cvm_plain(v, dv.segments, None, BATCH,
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
    g["launches"] = launches["gather_rows"]
    p["launches"] = launches["pool_cvm"]
    details.update(predict_ms=lat, predict_p50_ms=p50, split_p50_ms=split,
                   pred_max_abs_err=err, kernels=[g, p])

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out + ".json", "w") as fh:
        json.dump(details, fh, indent=1, default=str)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in (g, p)]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
