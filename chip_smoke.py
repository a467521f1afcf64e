#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (paddlebox_tpu_torch) on one GPU.

    python3 chip_smoke.py [--batches 8] [--seed 0] [--out chiprun_out/chip_smoke]

Phases, each of which fails the run:

1. require a CUDA device; print the card's name and power limit;
2. build every kernel of the serving, training, PV and seqpool paths
   (13 kernels) from the eleven sources of ``paddlebox_tpu_torch/csrc``
   (one ``nvcc`` per source, all at once) and the native host library
   (``paddlebox_tpu_torch/native/kv_index.cpp`` and ``slot_parser.cpp``,
   one g++ call, at the same time) and print the build seconds;
3. at the full-width shapes of those paths, hold each kernel against its
   plain PyTorch version on the card (``gather_rows``, ``segment_gather``
   in both modes and ``scatter_add_update`` exact, ``pool_cvm`` in all
   four CVM modes within rtol 3e-5 / atol 1e-6; the key index's insert
   and lookup exact in rows and new-masks, with the pass's unique keys
   going into a copy of an index seeded with the train base's keys, and
   the seed's insert (the train base's keys, all new, into an empty
   index) exact too, each timed beside its bound and the two-array
   layout's bound, with probes of what bounds them (the insert of keys
   already present, the lookup of keys at their home bucket, a random
   ``index_select`` and ``index_fill_`` of the home buckets' rows, a
   ``copy_`` of the insert's bound bytes);
   ``rank_attention`` on a real PV batch's rank_offset and on a
   hand-built one with zero, negative and out-of-range ranks and rows
   within rtol 1e-5 / atol 1e-6, ``batch_fc`` in its three modes within
   rtol 1e-6 / atol 1e-6, ``cross_norm`` exact but for its dot column,
   which holds rtol 1e-5 / atol 1e-6) and time kernel, plain version and
   the nearest single PyTorch call with CUDA events after an L2 flush
   (``torch.baddbmm`` for batch_fc; for rank_attention the einsum over
   the already grouped input, without the decode, gather and grouping;
   none for cross_norm); rank_attention and batch_fc through their
   wrappers against those calls in 5 alternating repeats (median and
   spread), rank_attention bit-equal across two calls and its C call's
   halves alone: the bucket pass, which must equal
   ``rank_buckets_plain``, and the tile kernel, which must equal the
   wrapper; batch_fc's per-element kernel alone; and the launch floor,
   a one-element ``zero_`` on the same timer. ``cross_norm`` is also
   bit-equal across two calls, and each kernel of its source (the tile
   kernel, the rows kernel) forced through ``pbx_cross_norm_path``
   equals the wrapper bit for bit; its wrapper is timed against a
   ``copy_`` of the same bytes and the launch floor in 5 alternating
   repeats, each kernel alone after both flushes, and the device
   duration of each read from ``torch.profiler``, as is the device time
   of its plain backward. ``pool_cvm`` through its
   wrapper and ``torch.segment_reduce`` are timed in 5 alternating
   repeats (median and spread); the two halves of its C call run alone
   as well: the segment bounds pass, which must equal
   ``segment_bounds_plain``, and the tile kernel over those bounds,
   which must equal the wrapper.
   ``segment_gather``'s fused call is timed the same way against
   ``index_select`` on the real keys and on batch 0's whole key bucket
   (pads included), and its C entry alone, which must equal the
   wrapper; each kernel-alone time is also taken after a read-only L2
   flush, which leaves no dirty lines for the kernel to write back;
4. serve ragged DeepFM batches end to end: a seeded ``save_base``-format
   table of 2.6M keyed rows loads into ``ServingModel(device="cuda")``
   with seeded random dense params, and ``predict`` answers ``--batches``
   batches of 4096 records (26 slots, 1 + Poisson(4) keys per slot,
   13 dense). Predictions must be finite, in (0, 1), and match the same
   forward through the plain versions; both kernels' launch counters
   must advance once per batch. The host key index of the loader and of
   the snapshot must take the native route (``kv_route``). Then the
   batches' ``prepare_eval`` runs on twins of the snapshot's index on
   each route in turns (native, python, python, native: the python
   ``PyKV`` is a named comparison here, not a fallback): both routes
   must give identical ``PullIndex`` arrays, and both medians print;
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
   time each step synchronized, split into prepare, h2d and step; the
   prepare they replay runs once on each route of the host key index in
   turns from the same start, as phase 4's lookups do (the table's index
   must be native);
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
   loss finite. The host-route build runs on each route of the host key
   index in turns from the same start (its dedup stage printed by
   route). Then, with the float32 tower, TF32 off and no lazy-mf
   draws (``mf_initial_range`` 0: the two passes lay a batch's unique
   rows out differently, so their draws land on other rows), the
   resident pass and ``train_pass`` from the same start must agree
   within rtol 2e-4 / atol 2e-5;
7. train bench.py's PV ads-ranking configuration (``measure_pv``): 8192
   PVs of 2-4 ads (shuffled ranks, cmatch 222) through
   ``PvBatchBuilder`` into batches of 512 PVs padded to 4096 rows, 8
   slots of one key from 10 000 ids each, 4 dense; an
   ``EmbeddingTable`` (mf_dim 8, Adagrad, capacity 2^20) loaded from a
   seeded file of the ids < 9 000 of each slot, a quarter without mf;
   ``AdsRank(d_model=128, max_rank=3, hidden=(128, 64), slot_fc=True,
   cross_norm=True)`` with a bf16 tower and a fixed cross-norm summary;
   Adam 5e-3. ``--batches`` steps of prepare → pull → fused_seqpool_cvm
   (segments passed, so the pool kernels run) → AdsRank → ins_w-weighted
   BCE → backward and Adam → embed grads scaled by −B → push. The loss
   must be finite at every step; rank_attention, batch_fc, cross_norm,
   pool_cvm, segment_gather and scatter_add_update must launch once a
   step and gather_rows twice (pull and push); the sentinel row must
   stay zero and untouched rows bit-identical; the batches' prepare runs
   on each route of the host key index in turns from the same start.
   Then the same steps run
   twice more from the same start with the float32 tower, TF32 off and
   ``mf_initial_range`` 0, through the kernels and through the plain
   versions: table rows within rtol 2e-4 / atol 2e-5, dense params
   within rtol 2e-3 / atol 2e-4. Those two runs time each step
   synchronized, split into prepare, h2d and step; one more f32 step
   runs under ``torch.profiler``: its device time per kernel against the
   synchronized step's p50;
8. run the seqpool op family on phase 3's ragged batch 0 (B 4096, S 26,
   its real keys and segment stream; the pulled rows of width 11, seeded
   extra cvm columns where a variant needs them): the concat form (k 3,
   clk_filter and no-cvm, pad_value 0.25, embedx_concate_filter),
   embed_threshold_filter, conv with show_filter, four slot groups,
   fused_seqpool_concat, fused_embed_pool_cvm, diff_thres with per-slot
   thresholds, tradew (3 trade columns, both modes), credit, pcoc (p 2)
   and cvm, each forward and backward through the kernels (counted: every
   op that pools through segment_sum must launch it) and again through
   the kernels and the plain versions: forwards within rtol 3e-5 / atol
   1e-6, grads exact but tradew's trade column (atol 1e-6); the slot
   groups must equal the monolithic pool. Then ``segment_sum`` on the
   concat path's stream and on ``_pool_core``'s (each timed as phase 3
   times ``pool_cvm``: alternating repeats against ``segment_reduce``,
   the bounds pass and the tile kernel alone), and ``scatter_rows``,
   ``scatter_rows_dma`` and ``gather_rows_dma`` (no consumer in either
   package: their counted run is a pull and write-back round trip of the
   batch's 2^19-padded unique rows on a copy of the table, which must
   restore it) against their plain versions (exact but the racy
   sentinel row) and timed: ``scatter_rows_dma`` and ``gather_rows_dma``
   as phase 3 times ``segment_gather`` (against ``index_copy_`` and
   ``index_select``), and their C entries alone, first checked against
   the wrapper;
9. the table lifecycle on the ragged cell at full width, once with
   ``SparseAdamConfig(shared=False)`` (row width 37) and once with
   ``shared=True`` (23), each through the kernels and again through the
   plain versions: a table (capacity 2^23) loads phase 5's base file,
   trains batches 0-1 (f32 tower), ``save_base``, ``shrink`` (threshold
   5.0, decay 0.98) must free a nonzero share of rows and zero them, a
   flag-on ``bulk_assign_unique`` of batches 2-3's keys must degrade
   (the kv has holes), ``merge_model`` of the save must bring every
   saved key back, batches 2-3 train, and a flag-on
   ``bulk_assign_unique`` of the other batches' keys must run on the
   card (the merge refilled every hole), its index mirroring the kv.
   The kernel run must launch the four step kernels once a step and the
   key index's insert twice (seed, assign) and lookup once; kernels vs
   plain: rows after 2 and 4 steps and dense params within rtol 2e-4 /
   atol 2e-5, freed rows, ``feature_count`` and ``rows_digest`` equal.
   Then row 13's scalar (vec = 1) branch at that width and the Adam
   pull (row 1) at batch 0's shapes, each exact against its plain
   version and timed;
10. checkpoint, preemption resume and publishing, then adoption and hot
   reload, at phase 5's width, with ``torch.use_deterministic_algorithms``
   on (``CUBLAS_WORKSPACE_CONFIG`` is set before torch starts): run A
   trains the batches from phase 5's base file through
   ``Trainer.run_pass`` with a ``CheckpointManager`` publishing into an
   ``ArtifactStore`` (a base at step 0, cursor checkpoints every 3
   batches, a boundary delta at the end); run B starts from a copy of
   A's step-0 checkpoint and is preempted at batch 5 by
   ``preempt.signal:fail:nth=5`` (an emergency checkpoint at batch 5),
   and new objects restore it and resume. The resumed ``state_digest``
   must equal A's bit for bit. A ``ServingModel`` adopts the base,
   predicts, ``hot_reload``s (which must apply only the delta) and
   predicts again; a second one adopts the tip, and its predictions must
   equal the hot-reloaded ones bit for bit and trainer A's own forward
   within ``PRED_ATOL``; a ``ReloadLoop`` poll of the current store
   adopts nothing. The four step kernels must launch; their counts join
   the ``kernels`` line. Times: ``save_base`` against ``np.savez`` of
   the same blob, each sparse save, ``verify``, ``restore``, the resume,
   ``adopt`` and ``hot_reload``;
11. the pipelined resident passes at phase 5's width, under
   ``torch.use_deterministic_algorithms``: the ``--batches`` batches cut
   into 4 passes of whole batches, each dataset ``columnarize()``d, and
   ``Trainer.train_passes_resident`` at depth 2 (``PassPreloader``: the
   builds on a worker thread with its own CUDA stream, pinned
   non-blocking copies, each pass ordered by its event) in three
   configs, each from phase 5's base file: A, bench.py's resident lane
   (``EmbeddingTable(arena_slots=26, unique_bucket_min=4096)``, q8
   floats): every pass must ship the compact wire, no fallback; B, the
   dedup wire with ``use_pallas_index`` on and f32 floats: the index must
   not degrade, the insert kernel must launch once for the seed and once
   a build, all from the preload worker, and ``lookup_rows`` of the kv's
   keys (lookup kernel) must give the kv's rows; C, the dedup wire with
   bf16 floats. Each config runs again at depth 0 from the same start and
   its ``state_digest`` must equal the depth-2 run's bit for bit; B's
   must also equal four sequential ``train_pass_resident`` calls. Config
   A runs twice more with the f32 tower and no lazy-mf draws, through the
   kernels and through the plain versions: touched rows and dense params
   within rtol 2e-4 / atol 2e-5. In each depth-2 run the four step
   kernels must launch once a step, the sentinel row stay zero and
   untouched rows bit-identical. Printed: each wire's formats, staged
   bytes against the host int32/f32 bytes, each pass's build stages and
   preload wait, examples/s over the passes with their builds at depth 2
   and 0, and the record front against the columnar front on pass 0 in
   turns (outputs equal). The three depth-2 runs' launches join the
   ``kernels`` line.
12. the data pipeline and streaming ingest at phase 5's width, under
   ``torch.use_deterministic_algorithms``: the ``--batches`` x 4096
   records written to one slot_text file a batch (dense with 9
   significant digits); an ``InMemoryDataset`` loaded natively
   (``native/slot_parser.cpp``, 8 pool threads) and per line
   (``native_parse`` off, 1 reader thread), timed in turns (native,
   python, python, native): each load must take its route
   (``parse_route``; no fallback), its columnar arrays must equal the
   records' and its batches phase 5's, array for array. ``train_pass``
   from the file-loaded dataset and from the records, from the same
   params and a seeded base file (the ids < 9 000 of each slot), must
   give the same ``state_digest``; the first step from files runs again
   through the kernels and the plain versions (f32 tower, no lazy-mf
   draws): touched rows and dense params within rtol 2e-4 / atol 2e-5.
   Then the stream scenario (a windowed ``QueueDataset``, windows of 2
   files, 1 reader thread): the oracle ``train_stream`` with a boundary
   checkpoint every window must end at ``train_pass``'s digest; the same
   stream under ``preempt.signal:fail:nth=5`` raises ``PreemptedError``
   inside window 3; new objects restore and stream again, replaying
   exactly window 3's two files; the killed run's step-4 checkpoint must
   hold the oracle's step-4 digest; every batch trains once but window
   3's first, which trains twice (``on_batch_trained``). Last, the
   Criteo walkthrough (``paddlebox_tpu_torch.examples.train_criteo``,
   32 768 rows, batch 4096, 2 resident passes, vocabulary 100 000 a
   slot, capacity 2^23, DeepFM (512, 256, 128)): native load, last pass
   and eval AUC above 0.5, finite served predictions; the native criteo
   parse of its files must equal the per-line parse (dense within the
   reference's own rtol 1e-6: the native parser's log1p is float32).
   Printed: records/s and MB/s by route, the stream's examples/s
   against ``train_pass``'s, the share of the stream's wall time spent
   in the per-line parse. The train_pass from files, the three streams
   and the walkthrough are the phase's main path: their step kernel
   launches join the ``kernels`` line.
13. the sharded table and the multi-shard trainer at phase 5's width:
   ``ShardedEmbeddingTable`` with 4 shards of 2^20 rows on the card,
   loaded from phase 5's base file (split by key % 4), over 16 batches
   of the phase's own seeded records (4 global steps of 4 x 4096): the
   sharded pull of the first global batch must equal one
   ``EmbeddingTable``'s pull of the same keys exactly; the first global
   step through the kernels against the plain versions (f32 tower,
   TF32 off): each owner's pushed grads and the show/clk/delta_score/
   slot columns exact, rows and dense params within rtol 2e-4 / atol
   2e-5; the synchronized split of a global step into
   ``prepare_global``, staging and the device step. Then, under
   ``torch.use_deterministic_algorithms``, the main path: the 4-shard
   ``train_pass`` (bf16 tower) with the host index, and ``train_pass``
   and ``eval_pass`` with ``use_pallas_index`` (every shard's device
   index must stay undegraded); the two must be equal by
   ``elastic_state_digest`` and eval AUC; ``a2a_chunks=4`` must equal
   the monolithic run by ``sharded_state_digest``; the trained table's
   ``save_base`` loaded into a new table under a trainer restored from
   ``dense_snapshot`` must equal it by ``elastic_state_digest``. The
   resident pass: its first global step, decoded from the staged wire,
   through the kernels against the plain versions (the classes above);
   ``train_pass_resident`` must equal the streaming ``train_pass`` by
   ``sharded_state_digest``, monolithic and with ``a2a_chunks=4``; with
   ``use_pallas_index`` the host index's by ``elastic_state_digest``;
   two passes through a depth-2 ``PassPreloader(build_fn=...)`` must
   equal depth 0 (passes of half the batches); the q8 float wire's AUC
   within 5e-3 of the f32 wire's on those batches. Printed: examples/s beside phase 5's ``train_pass``; the
   resident pass's examples/s (staged, and with the build) beside the
   streaming pass's, its build split (plans, re-pad or re-route,
   encode, h2d) and its staged wire bytes. The main path's launches
   (rows 1, 6, 7, 11, 12, 13) join the ``kernels`` line.
14. the other CTR models at phase 5's width: ``CtrDnn``, ``WideDeep``,
   ``DCNv2`` (parallel) and ``MMoESingle`` at the registry's widths, on
   one table loaded from phase 5's base file and one 4-shard table on
   the card: each model's first step on phase 5's batch 0 through the
   kernels against the plain versions (f32 tower, TF32 off; show/clk
   exact, rows and params within rtol 2e-4 / atol 2e-5); then, under
   ``torch.use_deterministic_algorithms``, the main path:
   ``Trainer.train_pass`` of 2 batches (bf16 tower), one batch with an
   ``lr_map`` that freezes one layer (its params unchanged bit for
   bit) and one ``ShardedTrainer`` ZeRO-1 global step with the same
   ``lr_map`` (the same check). Printed: each model's examples/s and
   errors, the phase's seconds. The main path's launches (rows 1, 6,
   7, 13) join the ``kernels`` line.
15. the tiered store, under ``torch.use_deterministic_algorithms``
   (``tiered_phase``). 15a, bench.py's ``measure_tiered`` at its
   "uniform" shape: a ``TieredShardedEmbeddingTable`` of 4 shards of
   2^20 rows with an SSD tier, DeepFM, two seeded columnar datasets of
   32 768 one-key-a-slot records (~96% key overlap) alternating through
   ``tiered_pass_pipeline`` at ``FLAGS.preload_depth``: a cold, a warm
   and 4 measured passes. The same passes at depth 0 must equal them by
   ``rows_digest`` and the dense params; the cold pass stages its whole
   working set and each later pass exactly its keys not yet resident;
   the first resident step through the kernels against the plain
   versions (phase 13's classes). Then the ``drop_window`` full
   re-stage, and the whole model demoted to SSD segments and promoted
   back inline (``rows_digest`` unchanged) and overlapped. 15b, a window
   smaller than the model: phase 5's base file in 4 windows of 2^19
   rows over host stores of 2^19 rows with SSD tiers, phase 13's 16
   local batches as 4 passes of one global step through
   ``train_passes_tiered`` at depth 0: no window above its capacity,
   rows evicted, written back and promoted from segments, and (with
   ``mf_initial_range`` 0) the model read back through the host tiers
   equal to a plain 4 x 2^20 ``ShardedEmbeddingTable`` trained over the
   same passes (show/clk exact, rows and params within rtol 2e-4 / atol
   2e-5). Kernel rows 3 and 4 against their plain versions at the
   passes' delta and write-back sizes, timed there beside
   ``index_copy_`` / ``index_select`` and rows 2 and 1 in alternating
   repeats. Printed: each pass's wait, begin, training, end_pass submit,
   staged, evicted and written-back rows, SSD promote seconds, the
   epilogue's write-back seconds and overlapped share, examples/s with
   the boundaries. The main path's launches (rows 1, 3, 4, 6, 7, 13)
   join the ``kernels`` line.
16. multi-mf, per-slot embedding widths (``multi_mf_phase``): 10 slots
   of mf 4, 10 of 8 and 6 of 16 (row widths 12, 16, 24; pooled width
   294 + 13 dense), ``CtrDnn`` (400, 400, 400), one base file a dim
   class from phase 5's base ids. 16a: ``MultiMfEmbeddingTable`` of
   2^21 rows a class; the first step through the kernels against the
   plain versions; rows 1, 7, 6 and 13 against their plain versions at
   every class width, timed alone beside their bounds; under
   deterministic algorithms ``MultiMfTrainer.train_pass`` over phase 5's
   batches and ``train_pass_resident`` over the same batches, bit for
   bit; ``save_base`` → ``MultiMfServingModel`` → ``predict`` against
   the trainer's forward. 16b: ``MultiMfShardedTable`` of 4 x 2^20 rows
   a class over phase 13's batches; the first global step, kernels
   against plain; ``train_pass`` and the overlapped push order bit for
   bit, with the synchronized split; the sharded save pulled through a
   single table. 16c: ``MultiMfTieredShardedTable`` through
   ``BoxPSHelper``, the same batches as 4 passes, each class's window
   between a pass's per-shard working set and the per-shard model, SSD
   tiers; the model equal to 16b's bit for bit; an overlapped stage
   leaves nothing to stage. 16d: ``ExtendedEmbeddingTable`` pull/push
   kernels against plain, ``ReplicaCache`` against numpy. The main
   path's launches (rows 1, 3, 4, 6, 7, 13) join the ``kernels`` line.

The second-to-last line is the ``kernels`` JSON object, the last line
``{"ok": true, "device": {...}}``. Details (build logs, per-batch times)
go to ``<out>.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor

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

# phase 7: bench.py's PV ads-ranking configuration (measure_pv,
# bench.py:596-627)
PV_PVS = 8192                    # 2-4 ads each, shuffled ranks, cmatch 222
PV_BATCH = 4096                  # rows; 512 PVs (~1 536 ads) a batch
PV_SLOTS = 8                     # one key per slot
PV_VOCAB = 10_000                # ids per slot
PV_BASE_VOCAB = 9_000            # the PV table file holds ids < this
PV_DENSE = 4
PV_DMODEL = 128
PV_MAX_RANK = 3
PV_HIDDEN = (128, 64)
PV_CAPACITY = 1 << 20

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
# the CTR kernels against their plain versions (tests/test_pallas_ctr.py):
# float32 sums in another order; cross_norm is exact but for its dot
RA_RTOL, RA_ATOL = 1e-5, 1e-6
FC_RTOL, FC_ATOL = 1e-6, 1e-6
DOT_RTOL, DOT_ATOL = 1e-5, 1e-6
# PV kernel-vs-plain training: table rows in STATE_*, dense params in
# the class of tests/test_pallas_train_gate.py:273
PARAM_RTOL, PARAM_ATOL = 2e-3, 2e-4


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, flush, iters: int = 20, warmup: int = 3,
            setup=None, clean: bool = False) -> float:
    """Mean device ms of ``fn`` over ``iters`` launches, each after an L2
    flush (the caller's inputs are not assumed cache-resident) and after
    ``setup``, untimed (restores what ``fn`` changes in place). The flush
    writes 256 MB, so L2 is left full of dirty lines that ``fn``'s
    traffic must write back; ``clean`` flushes by reading the buffer
    instead, which leaves L2 clean (a probe of that write-back's cost)."""
    for _ in range(warmup):
        if setup is not None:
            setup()
        fn()
    total = 0.0
    for _ in range(iters):
        if setup is not None:
            setup()
        if clean:
            flush.sum()
        else:
            flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def alternating_ms(torch, fns: dict, flush, repeats: int = 5) -> dict:
    """Each of ``fns`` (name → fn) timed by :func:`time_ms` ``repeats``
    times in turns, the order reversed every round (a, b, b, a, a, b,
    ...): name → {"runs", "median", "spread" (max − min)} in ms."""
    runs = {name: [] for name in fns}
    names = list(fns)
    for r in range(repeats):
        for name in names if r % 2 == 0 else names[::-1]:
            runs[name].append(time_ms(torch, fns[name], flush))
    return {name: {"runs": v, "median": float(np.median(v)),
                   "spread": max(v) - min(v)} for name, v in runs.items()}


def pool_parts_ms(torch, lib, ids, n, tiles_args, out, want, flush
                  ) -> dict:
    """The two halves of a pool kernel's C call, checked and timed alone:
    the bounds pass (a memset + key-parallel atomics) against
    ``segment_bounds_plain`` (exact), and the tile kernel over bounds
    computed once beforehand, whose ``out`` must equal ``want`` (the
    wrapper's result). ``tiles_args(bounds)`` gives the tile entry's
    arguments before the stream."""
    from paddlebox_tpu_torch.ops import _build
    from paddlebox_tpu_torch.ops import kernels as K
    stream = torch.cuda.current_stream().cuda_stream
    bounds = torch.empty((2, n), dtype=torch.int32, device="cuda")
    fb = _build.function(lib, f"pbx_{lib}_bounds", K._BOUNDS_ARGS)
    ft = _build.function(lib, f"pbx_{lib}_tiles", K._POOL_ARGS
                         if lib == "pool_cvm" else K._SEG_SUM_ARGS)
    b_args = (ids.data_ptr(), ids.shape[0], n, bounds.data_ptr(), stream)
    _build.check(fb(*b_args), f"{lib} bounds")
    _build.check(ft(*tiles_args(bounds), stream), f"{lib} tiles")
    torch.cuda.synchronize()
    if not torch.equal(bounds, K.segment_bounds_plain(ids, n)):
        raise AssertionError(f"{lib}: the bounds pass differs from "
                             f"segment_bounds_plain")
    if not torch.equal(out, want):
        raise AssertionError(f"{lib}: the tile kernel alone differs from "
                             f"its wrapper")
    return {"bounds_only_ms": time_ms(torch, lambda: fb(*b_args), flush),
            "kernel_only_ms": time_ms(torch, lambda: ft(
                *tiles_args(bounds), stream), flush)}


def alone_ms(torch, call, check, flush) -> dict:
    """A kernel's C entry called straight, without its wrapper: after one
    ``call()``, ``check()`` must hold (exact against the wrapper's
    result); then ``call`` timed after the usual flush and after a clean
    one (:func:`time_ms`)."""
    call()
    torch.cuda.synchronize()
    check()
    return {"kernel_only_ms": time_ms(torch, call, flush),
            "kernel_only_clean_l2_ms": time_ms(torch, call, flush,
                                               clean=True)}


def rank_parts_ms(torch, x, ro, param, mr, want, flush) -> dict:
    """Row 8's C call in its two halves, checked and timed alone: the
    bucket pass against ``rank_buckets_plain`` (exact), then the tile
    kernel over that scratch, whose output must equal ``want`` (the
    wrapper's result) bit for bit."""
    from paddlebox_tpu_torch.ops import _build
    from paddlebox_tpu_torch.ops import ctr_kernels as C
    (n, d), p = x.shape, param.shape[2]
    stream = torch.cuda.current_stream().cuda_stream
    scratch = torch.empty(n + mr + 2, dtype=torch.int32, device="cuda")
    fb = _build.function("rank_attention", "pbx_rank_buckets",
                         C._RANK_BUCKETS_ARGS)
    ft = _build.function("rank_attention", "pbx_rank_attention_tiles",
                         C._RANK_TILES_ARGS)
    b_args = (ro.data_ptr(), scratch.data_ptr(), n, mr, ro.shape[1], stream)
    _build.check(fb(*b_args), "rank_attention buckets")
    perm, bounds = C.rank_buckets_plain(ro, mr)
    torch.cuda.synchronize()
    if not (torch.equal(scratch[:n], perm) and torch.equal(scratch[n:],
                                                           bounds)):
        raise AssertionError("rank_attention: the bucket pass differs from "
                             "rank_buckets_plain")
    out = torch.full_like(want, float("nan"))
    t_args = (x.data_ptr(), ro.data_ptr(), param.data_ptr(),
              scratch.data_ptr(), out.data_ptr(), n, d, p, mr, ro.shape[1],
              stream)
    _build.check(ft(*t_args), "rank_attention tiles")
    torch.cuda.synchronize()
    if not torch.equal(out, want):
        raise AssertionError("rank_attention: the tile kernel alone differs "
                             "from its wrapper")
    return {"buckets_only_ms": time_ms(torch, lambda: fb(*b_args), flush),
            "tiles_only_ms": time_ms(torch, lambda: ft(*t_args), flush)}


def gather_timing(torch, src, ids, head, flush) -> dict:
    """Row 6, the pool backward's fused call on one id stream: through its
    wrapper against ``index_select`` of the same src rows (the gathered
    columns only, a zero row for an id outside [0, N)) in alternating
    repeats, and its C entry alone. Bound: the ids, the head, the
    distinct src rows of the live keys read once, the [K, H + w] output
    written once (a pad's zero row reads nothing)."""
    from paddlebox_tpu_torch.ops import _build
    from paddlebox_tpu_torch.ops import kernels as K
    (n, w), k = src.shape, ids.shape[0]
    valid = (ids >= 0) & (ids < n)
    live = torch.where(valid, ids.long(), n)
    src_z = torch.cat([src, src.new_zeros((1, w))])
    args = (src, ids, head, None, BATCH, NUM_SLOTS)
    want = K.segment_gather(*args)
    reps = alternating_ms(torch, {
        "kernel": lambda: K.segment_gather(*args),
        "library": lambda: torch.index_select(src_z, 0, live)}, flush)
    fn = _build.function("segment_gather", "pbx_segment_gather",
                         K._SEG_GATHER_ARGS)
    out = torch.empty_like(want)
    c_args = (src.data_ptr(), src.stride(0), ids.data_ptr(),
              head.data_ptr(), None, out.data_ptr(), k, n, w, head.shape[1],
              0, NUM_SLOTS, BATCH, torch.cuda.current_stream().cuda_stream)

    def check():
        if not torch.equal(out, want):
            raise AssertionError("segment_gather: the C entry alone "
                                 "differs from its wrapper")
    n_src = int(torch.unique(ids[valid]).numel())
    # what bounds it: the same call with every key a pad (the same
    # output written, no src or head read)
    pads = torch.full_like(ids, n)
    c_pads = c_args[:2] + (pads.data_ptr(),) + c_args[3:]
    pad_ms = alone_ms(
        torch, lambda: _build.check(fn(*c_pads), "segment_gather"),
        lambda: None, flush)
    # the wrapper's host cost: 200 calls enqueued back to back
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(200):
        K.segment_gather(*args)
    host_us = (time.perf_counter() - t0) / 200 * 1e6
    torch.cuda.synchronize()
    return {"keys": k, "live": int(valid.sum()), "repeats": reps,
            "wrapper_host_us": host_us,
            "alone": {"kernel": alone_ms(
                torch, lambda: _build.check(fn(*c_args), "segment_gather"),
                check, flush)},
            "probe": dict(pad_ms, what="every key a pad"),
            # the same output written by PyTorch's fill, nothing read
            "output_zero_ms": time_ms(torch, out.zero_, flush),
            "bound_ms": (k * 4 + head.numel() * 4 + n_src * w * 4
                         + k * (head.shape[1] + w) * 4) / PEAK_BYTES * 1e3}


def row_dma_timing(torch, name, kern, lib, table, rows, vals, want_table,
                   flush) -> dict:
    """Rows 3 and 4 on the round trip's rows: the wrapper against its
    library call in alternating repeats, and the C entry alone, first
    checked exact against the wrapper's result (the racy sentinel row
    aside). ``want_table`` is the table the scatter wrapper wrote."""
    from paddlebox_tpu_torch.ops import _build
    from paddlebox_tpu_torch.ops import kernels as K
    reps = alternating_ms(torch, {"kernel": kern, "library": lib}, flush)
    cap, d = table.shape[0] - 1, table.shape[1]
    k = rows.shape[0]
    fn = _build.function("row_dma", f"pbx_{name}", K._ROW_ARGS)
    stream = torch.cuda.current_stream().cuda_stream
    scatter = name == "scatter_rows_dma"
    if scatter:
        dst = table.clone()
        io, want = vals, want_table[:cap]
    else:
        dst = torch.empty((k, d), dtype=torch.float32, device=table.device)
        dst.fill_(float("nan"))
        io, want = dst, K.gather_rows_dma(table, rows)

    def call(ids):
        _build.check(fn((dst if scatter else table).data_ptr(),
                        ids.data_ptr(), io.data_ptr(), k, cap, d,
                        K._dma_vec(d, table, io), stream), name)

    def check():
        if not torch.equal(dst[:cap] if scatter else dst, want):
            raise AssertionError(f"{name}: the C entry alone differs from "
                                 f"its wrapper")
    alone = alone_ms(torch, lambda: call(rows), check, flush)
    # what bounds it: the same copy of rows 0..k-1 in order (the same
    # bytes, the table side contiguous instead of scattered), and the
    # same bytes moved by PyTorch's dense copy of the [k, d] block
    seq = torch.arange(k, dtype=torch.int32, device=table.device)
    probe = alone_ms(torch, lambda: call(seq), lambda: None, flush)
    dense = torch.empty_like(vals)
    return {"repeats": reps, "alone": {"kernel": alone},
            "probe": dict(probe, what="rows 0..k-1 in order"),
            "dense_copy_ms": time_ms(torch, lambda: dense.copy_(vals),
                                     flush)}


def log_copy_timing(name: str, t: dict, lib: str, card: str) -> None:
    """One line for a copy kernel timed as rows 3, 4 and 6 are: wrapper
    against its library call in alternating repeats, kernel alone."""
    reps = t["repeats"]
    alone = "; ".join(
        f"{mode}: {a['kernel_only_ms']:.4f} ms "
        f"({t['bound_ms'] / a['kernel_only_ms']:.1%} of the bound), clean "
        f"L2 {a['kernel_only_clean_l2_ms']:.4f}"
        for mode, a in t["alone"].items())
    alone += (f"; probe, {t['probe']['what']}: "
              f"{t['probe']['kernel_only_ms']:.4f} ms")
    if "output_zero_ms" in t:
        alone += f"; zero_ of the output {t['output_zero_ms']:.4f} ms"
    if "dense_copy_ms" in t:
        alone += f"; copy_ of the [k, d] block {t['dense_copy_ms']:.4f} ms"
    log(f"  {name}: wrapper {reps['kernel']['median']:.4f} ms (spread "
        f"{reps['kernel']['spread']:.4f}) vs {lib} "
        f"{reps['library']['median']:.4f} (spread "
        f"{reps['library']['spread']:.4f}), medians of "
        f"{len(reps['kernel']['runs'])} alternating repeats; alone, "
        f"{alone}; bound {t['bound_ms'] * 1e3:.2f} us"
        + (f"; wrapper host {t['wrapper_host_us']:.1f} us a call"
           if "wrapper_host_us" in t else "") + f" ({card})")


def log_pool_timing(name: str, t: dict, card: str) -> None:
    reps = t["repeats"]
    log(f"  {name}: wrapper {reps['kernel']['median']:.4f} ms (spread "
        f"{reps['kernel']['spread']:.4f}) vs segment_reduce "
        f"{reps['library']['median']:.4f} (spread "
        f"{reps['library']['spread']:.4f}), medians of "
        f"{len(reps['kernel']['runs'])} alternating repeats; alone: bounds "
        f"pass {t['bounds_only_ms']:.4f} ms, tile kernel "
        f"{t['kernel_only_ms']:.4f} ms, "
        f"{t['bound_ms'] / t['kernel_only_ms']:.1%} of its bound "
        f"{t['bound_ms'] * 1e3:.2f} us ({card})")


def base_keys(vocab: int, num_slots: int = NUM_SLOTS,
              stride: int = VOCAB_PER_SLOT) -> np.ndarray:
    """The keys with id < ``vocab`` of every slot (slot s holds ids from
    s * stride), slot by slot: the rows of a loaded base file, in row
    order."""
    return (np.arange(num_slots, dtype=np.uint64)[:, None]
            * np.uint64(stride)
            + np.arange(vocab, dtype=np.uint64)[None, :]).reshape(-1)


def make_table_blob(rng, convert, vocab: int = VOCAB_PER_SLOT,
                    no_mf: float = 0.0, num_slots: int = NUM_SLOTS,
                    stride: int = VOCAB_PER_SLOT):
    """The keys with id < ``vocab`` of every slot (2.6M for the whole
    ragged vocabulary) with seeded logical rows; a ``no_mf`` share of
    them has no mf yet (mf_size 0)."""
    keys = base_keys(vocab, num_slots, stride)
    n = len(keys)
    rows = np.zeros((n, 8 + MF_DIM), np.float32)
    show = rng.integers(1, 200, size=n).astype(np.float32)
    rows[:, 0] = show
    rows[:, 1] = np.floor(show * rng.random(n, dtype=np.float32) * 0.3)
    rows[:, 2] = rng.random(n, dtype=np.float32)
    rows[:, 3] = (keys // np.uint64(stride)).astype(np.float32)
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


def make_pv_records(rng, SlotRecord):
    """bench.py build_pv_records: PV_PVS search pages of 2-4 ads with
    shuffled 1-based ranks and cmatch 222, one key per slot."""
    recs = []
    for sid in range(PV_PVS):
        n_ads = int(rng.integers(2, 5))
        ranks = rng.permutation(n_ads) + 1
        for a in range(n_ads):
            keys = (rng.integers(0, PV_VOCAB, PV_SLOTS)
                    + np.arange(PV_SLOTS) * PV_VOCAB).astype(np.uint64)
            label = float(rng.random() < 0.25)
            recs.append(SlotRecord(
                keys=keys,
                slot_offsets=np.arange(PV_SLOTS + 1, dtype=np.int32),
                dense=rng.normal(size=PV_DENSE).astype(np.float32),
                label=label, show=1.0, clk=label, search_id=sid,
                rank=int(ranks[a]), cmatch=222))
    return recs


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


def require_native(what: str, table) -> str:
    """The host key index's route of ``table``; raises unless it is the
    native one (phases 4-7 and 9 run on it)."""
    route = table.index.kv_route
    if route != "native":
        raise AssertionError(f"{what}: the host key index took the "
                             f"{route} route")
    return route


def kv_twin(kv, capacity: int, route: str):
    """A copy of index ``kv`` on ``route`` ("native": ``make_kv``;
    "python": ``PyKV``, the named comparison) holding the same key→row
    map: its keys assigned in row order (the rows are dense), checked
    row for row."""
    from paddlebox_tpu_torch.ps.kv import PyKV, make_kv
    keys, rows = kv.items()
    order = np.argsort(rows, kind="stable")
    twin = make_kv(capacity) if route == "native" else PyKV(capacity)
    if twin.kv_route != route:
        raise AssertionError(f"kv twin took the {twin.kv_route} route")
    if not np.array_equal(twin.assign(keys[order]), rows[order]):
        raise AssertionError("kv twin allocated other rows")
    return twin


def _same_outputs(a, b) -> bool:
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_same_outputs(x, y)
                                        for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return (isinstance(b, np.ndarray) and a.dtype == b.dtype
                and np.array_equal(a, b))
    return a == b


def timed_calls(fn, items):
    """(outputs, host ms of each call) of ``fn`` over ``items``."""
    outs, ms = [], []
    for x in items:
        t0 = time.perf_counter()
        outs.append(fn(x))
        ms.append((time.perf_counter() - t0) * 1e3)
    return outs, ms


def route_pair(table, run) -> tuple:
    """``run(table)`` → (outputs, ms list), four times in turns (native,
    python, python, native), each on a twin of the table's index as it
    stands now (``kv_twin``): a within-run pair of the host key index's
    two routes over the same work. Every turn must give the same
    outputs. Returns ({route: median ms, route + "_ms": all ms}, the
    outputs); the table keeps the last native turn's index."""
    base = table.index
    ms = {"native": [], "python": []}
    first = None
    for route in ("native", "python", "python", "native"):
        table.index = kv_twin(base, table.capacity, route)
        out, t = run(table)
        ms[route] += t
        if first is None:
            first = out
        elif not _same_outputs(out, first):
            raise AssertionError(f"the {route} route's outputs differ "
                                 f"from the native route's")
    return ({"native": float(np.median(ms["native"])),
             "python": float(np.median(ms["python"])),
             "native_ms": ms["native"], "python_ms": ms["python"]}, first)


def log_route_pair(what: str, pair: dict, card: str,
                   outputs: str = "PullIndex arrays") -> None:
    log(f"{what} by host index route (within-run pair native, python, "
        f"python, native): native p50 {pair['native']:.3f} ms, python p50 "
        f"{pair['python']:.3f} ms, {pair['python'] / pair['native']:.1f}x; "
        f"identical {outputs} ({card})")


def _profiled(torch, step, state, batch, gen):
    """One synchronized call of ``step`` under ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(state, batch, gen)
        torch.cuda.synchronize()
    return prof


def _device_event(e) -> bool:
    """A device-side kernel, copy or fill event: the ops that launched
    them, and annotated ranges on the device timeline (the optimizer's
    step), carry the same time and would count it twice."""
    return (str(e.device_type).endswith("CUDA")
            and not getattr(e, "is_user_annotation", False))


def device_window(prof) -> dict:
    """The profiled call's own device window: its span from the first
    device event's start to the last one's end, the time inside it that
    some device event covers (overlaps counted once), and their ratio,
    the busy share of that one window."""
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if _device_event(e))
    if not spans:
        raise AssertionError("the profiler saw no device event")
    busy, reach = 0.0, spans[0][0]
    for start, end in spans:
        busy += max(0.0, end - max(start, reach))
        reach = max(reach, end)
    span = reach - spans[0][0]
    return {"span_ms": span / 1e3, "busy_ms": busy / 1e3,
            "busy_share": busy / span if span > 0 else 1.0}


def profile_step(torch, step, state, batch, gen, prof=None):
    """Device time per kernel (name, ms, launches) of one synchronized
    training step under ``torch.profiler`` (or of the profile ``prof``
    already taken), largest first. Only device-side events count
    (:func:`_device_event`)."""
    if prof is None:
        prof = _profiled(torch, step, state, batch, gen)
    rows = []
    for e in prof.key_averages():
        if not _device_event(e):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if us > 0:
            rows.append((e.key, us / 1e3, e.count))
    return sorted(rows, key=lambda r: -r[1])


def device_ms(torch, fn, flush, match, iters: int = 20,
              clean: bool = False) -> dict:
    """The device duration of the kernels (or copies) whose name holds
    ``match`` (a string, or a tuple of them), per call of ``fn``, each
    after an L2 flush as :func:`time_ms` makes it (none where ``flush`` is
    None), from the device-side events :func:`profile_step` reads: no
    launch overhead."""
    def calls(*_):
        for _ in range(iters):
            if flush is not None and clean:
                flush.sum()
            elif flush is not None:
                flush.zero_()
            fn()
    match = (match,) if isinstance(match, str) else match
    rows = [r for r in profile_step(torch, calls, None, None, None)
            if any(m in r[0] for m in match)]
    if not rows:
        raise AssertionError(f"the profiler saw no {match} kernel")
    return {"device_ms": sum(r[1] for r in rows) / iters,
            "launches_per_call": sum(r[2] for r in rows) / iters,
            "kernels": [r[0] for r in rows]}


def cross_norm_inputs(torch, gen):
    """Row 10 at the PV shape: h = [proj, attention] [4096, 256] and the
    mean/scale of a summary folded from it."""
    from paddlebox_tpu_torch.ops.cross_norm import (cross_norm_update,
                                                    init_cross_norm_summary)
    from paddlebox_tpu_torch.ops.data_norm import data_norm_mean_scale
    h = torch.randn((PV_BATCH, 2 * PV_DMODEL), generator=gen, device="cuda")
    summ = cross_norm_update(init_cross_norm_summary(1, PV_DMODEL,
                                                     device="cuda"),
                             h, 1, PV_DMODEL, decay=0.5)
    mean, scale = data_norm_mean_scale(summ, 1e-4)
    return h, mean, scale


def cross_norm_probe(torch, h, mean, scale, flush) -> dict:
    """Row 10's wrapper in 5 alternating repeats beside its two
    yardsticks, a ``copy_`` that moves the same bytes (half of them read,
    half written: the practical floor) and a one-element ``zero_`` (the
    launch floor); and the device duration of its kernels."""
    from paddlebox_tpu_torch.ops import ctr_kernels as C
    dm = PV_DMODEL
    moved = h.numel() + 2 * mean.numel() + h.shape[0] * (3 * dm + 1)
    src = torch.zeros(moved // 2, device="cuda")
    dst = torch.empty_like(src)
    one = torch.zeros(1, device="cuda")
    def kernel():
        C.cross_norm(h, mean, scale, 1, dm)

    def copy():
        dst.copy_(src)

    reps = alternating_ms(torch, {"kernel": kernel, "copy": copy,
                                  "floor": one.zero_}, flush)
    dev = device_ms(torch, kernel, flush, "cross_norm")
    # the same after a read-only flush (no dirty lines to write back), and
    # the copy_'s own device time (a DtoD memcpy or a copy kernel)
    dev["device_clean_l2_ms"] = device_ms(torch, kernel, flush, "cross_norm",
                                          clean=True)["device_ms"]
    for clean in (False, True):
        dev["copy_device_clean_l2_ms" if clean else "copy_device_ms"] = \
            device_ms(torch, copy, flush, ("Memcpy", "copy"),
                      clean=clean)["device_ms"]
    # the least a kernel lasts on the device: the one-element zero_, with
    # no flush (the flush is a zero_ too)
    dev["floor_device_ms"] = device_ms(torch, one.zero_, None,
                                       "Fill")["device_ms"]
    return {"repeats": reps, "copy_bytes": 2 * src.numel() * 4, **dev}


def _probe_steps(torch, IX, keys, rows, of_rows=None):
    """Probe chains of the keys in the index ``(keys, rows)`` views: a key
    that sits d buckets from its home took d + 1 steps to claim or match
    it in the insert, and takes d + 1 in the lookup. Returns (steps, the
    longest offset, each key's home bucket, each key's offset) over every
    occupied bucket, or over the buckets of the rows ``of_rows`` (in
    their order) where given."""
    nb = rows.shape[0]
    occ = torch.nonzero(rows >= 0).squeeze(1)
    home = IX._hash32(keys[occ]).long() & (nb - 1)
    off = (occ - home) & (nb - 1)
    if of_rows is not None:
        at = torch.zeros(int(rows.max()) + 1, dtype=torch.int64,
                         device=rows.device)
        at[rows[occ].long()] = torch.arange(occ.shape[0],
                                            device=rows.device)
        pick = at[of_rows.long()]
        home, off = home[pick], off[pick]
    return int((off + 1).sum()), int(off.max()), home, off


def _sectors(torch, home, off, nb):
    """32-byte sectors (two 16-byte buckets each) that the probe chains
    home .. home + off touch, each sector counted once however many
    steps or chains touch it: the index bytes a probe must read."""
    first = home >> 1
    n = ((home + off) >> 1) - first + 1      # nb is even: wraps align
    at = torch.repeat_interleave(first - (torch.cumsum(n, 0) - n), n)
    idx = at + torch.arange(int(n.sum()), device=home.device)
    return int(torch.unique(idx & (nb // 2 - 1)).shape[0])


def index_phase(torch, batches, flush, card, details):
    """Phase 3, the key index: the pass's unique keys inserted into a copy
    of an index seeded with the train base's keys, through the insert
    kernel and through its plain version (rows and new-masks exact), then
    looked up through both lookups in both indexes (rows exact); the
    seed itself (the train base's keys, all new, into an empty index)
    through both inserts (exact); each timed, with probes that split what
    bounds them. Returns the two kernels' rows of the ``kernels`` line."""
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
    work_b, plain_b = seeded.buckets.clone(), seeded.buckets.clone()
    work, plain = IX.bucket_views(work_b), IX.bucket_views(plain_b)
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
    nb = seeded.n_buckets
    steps, max_off, key_home, key_off = _probe_steps(torch, IX, *work,
                                                     rows)
    # the index bytes the inputs need: each sector of the chains read
    # once, each sector of a claimed bucket written back once
    sectors = _sectors(torch, key_home, key_off, nb)
    last = ((key_home + key_off) & (nb - 1))[new.bool()]
    claimed = _sectors(torch, last, torch.zeros_like(last), nb)

    # the other launch's shape: the seed, all new, into an empty index
    base_t = torch.from_numpy(base.view(np.int64)).to(cuda)
    empty = IX.new_buckets(nb, cuda)
    seed_b, seed_pb = empty.clone(), empty.clone()
    seed_idx = IX.bucket_views(seed_b)
    srows, snew, sfail = IX.insert(*seed_idx, base_t, 0, CAPACITY)
    prows, pnew, pfail = IX.insert_plain(*IX.bucket_views(seed_pb), base_t,
                                         0, CAPACITY)
    torch.cuda.synchronize()
    if (bool(sfail) or bool(pfail) or not torch.equal(srows, prows)
            or not torch.equal(snew, pnew) or not bool(snew.all())
            or not torch.equal(srows, torch.arange(
                n_base, dtype=torch.int32, device=cuda))):
        raise AssertionError("index_insert (seed shape) differs from its "
                             "plain version or from rows 0..n-1")
    seed_steps, seed_max_off, seed_home, seed_off = _probe_steps(
        torch, IX, *seed_idx)
    seed_sectors = _sectors(torch, seed_home, seed_off, nb)
    seed_last = (seed_home + seed_off) & (nb - 1)
    seed_claimed = _sectors(torch, seed_last, torch.zeros_like(seed_last),
                            nb)
    del seed_home, seed_off, seed_last
    del seed_pb, prows, pnew

    def restore(dst, src):
        return lambda: dst.copy_(src)

    src = "paddlebox_tpu_torch/csrc/key_index.cu"
    # bounds: keys read, rows (and the insert's new-mask) written, each
    # 32-byte sector of the probe chains read once, and the insert writes
    # each sector of a claimed bucket back once; "old": the two-array
    # layout's two sectors a probe step
    ins_bytes = u * 16 + sectors * 32 + claimed * 32
    seed_bytes = n_base * 16 + seed_sectors * 32 + seed_claimed * 32
    lk_bytes = u * 12 + sectors * 32
    ins = {"name": "index_insert", "route": "cuda", "source": src,
           "replaces": "paddlebox_tpu/ops/pallas_index.py:233",
           "max_abs_err": 0.0,
           "ms": time_ms(torch, lambda: IX.insert(
               *work, uniq, n_base, CAPACITY), flush,
               setup=restore(work_b, seeded.buckets)),
           "plain_ms": time_ms(torch, lambda: IX.insert_plain(
               *plain, uniq, n_base, CAPACITY), flush,
               setup=restore(plain_b, seeded.buckets)),
           "library_ms": None,
           "bound_ms": ins_bytes / PEAK_BYTES * 1e3, "bound_by": "bytes"}
    lk = {"name": "index_lookup", "route": "cuda", "source": src,
          "replaces": "paddlebox_tpu/ops/pallas_index.py:344",
          "max_abs_err": 0.0,
          "ms": time_ms(torch, lambda: IX.lookup(*work, uniq), flush),
          "plain_ms": time_ms(torch, lambda: IX.lookup_plain(*work, uniq),
                              flush),
          "library_ms": None,
          "bound_ms": lk_bytes / PEAK_BYTES * 1e3, "bound_by": "bytes"}
    seed = {"ms": time_ms(torch, lambda: IX.insert(
                *seed_idx, base_t, 0, CAPACITY), flush,
                setup=restore(seed_b, empty)),
            "bound_ms": seed_bytes / PEAK_BYTES * 1e3,
            "old_bound_ms": (n_base * 16 + seed_steps * 64)
            / PEAK_BYTES * 1e3}
    ins["old_bound_ms"] = (u * 16 + steps * 64) / PEAK_BYTES * 1e3
    lk["old_bound_ms"] = (u * 12 + steps * 64) / PEAK_BYTES * 1e3

    # probes of what bounds them: the insert finding every key (no claim,
    # no write-back), the lookup of keys that all sit at home (one step
    # each), one random 4-byte read a key from its home bucket's sector
    # (index_select) and one random 4-byte write (index_fill_, last: it
    # spoils the kernel's index), and a streaming copy_ of the insert's
    # bound bytes
    again, again_new, again_fail = IX.insert(*work, uniq, n_base + n_new,
                                             CAPACITY)
    home = uniq[key_off == 0].contiguous()
    home_rows = IX.lookup(*work, home)
    torch.cuda.synchronize()
    if (bool(again_fail) or bool(again_new.any())
            or not torch.equal(again, rows)
            or not torch.equal(home_rows, rows[key_off == 0])):
        raise AssertionError("index probes: the insert of present keys or "
                             "the lookup of home keys went wrong")
    # the row word of each key's home bucket in the flat bucket tensor
    home_word = ((IX._hash32(uniq) & (nb - 1)) * 4 + 2).contiguous()
    flat = work_b.view(-1)
    half = torch.empty(ins_bytes // 2 // 4, dtype=torch.int32, device=cuda)
    dst = torch.empty_like(half)
    probes = {
        "insert_no_new_ms": time_ms(torch, lambda: IX.insert(
            *work, uniq, n_base + n_new, CAPACITY), flush),
        "lookup_home_keys": int(home.shape[0]),
        "lookup_home_ms": time_ms(torch, lambda: IX.lookup(*work, home),
                                  flush),
        "index_select_home_ms": time_ms(
            torch, lambda: flat.index_select(0, home_word), flush),
        "copy_insert_bytes_ms": time_ms(torch, lambda: dst.copy_(half),
                                        flush),
        "index_fill_home_ms": time_ms(
            torch, lambda: flat.index_fill_(0, home_word, -1), flush)}
    del half, dst, empty, seed_b, work_b, plain_b
    details["index"] = {
        "seed_keys": n_base, "seed_s": seed_s, "pass_uniques": u,
        "new_keys": n_new, "probe_steps": steps,
        "probe_sectors": sectors, "claimed_sectors": claimed,
        "max_probe_offset": max_off, "n_buckets": nb,
        "insert_ms": ins["ms"], "insert_bound_ms": ins["bound_ms"],
        "insert_old_bound_ms": ins["old_bound_ms"],
        "lookup_ms": lk["ms"], "lookup_bound_ms": lk["bound_ms"],
        "lookup_old_bound_ms": lk["old_bound_ms"],
        "seed": {**seed, "keys": n_base, "probe_steps": seed_steps,
                 "probe_sectors": seed_sectors,
                 "claimed_sectors": seed_claimed,
                 "max_probe_offset": seed_max_off},
        "probes": probes}
    log(f"key index: {u} pass uniques ({n_new} new) into an index seeded "
        f"with {n_base} keys ({nb} buckets, seeded in {seed_s:.3f}s); "
        f"insert and lookup equal their plain versions, the seed-shape "
        f"insert too; {steps} probe steps over {sectors} sectors, "
        f"{claimed} sectors claimed, longest chain {max_off + 1} (seed "
        f"{seed_steps} over {seed_sectors}, {seed_claimed} claimed, "
        f"{seed_max_off + 1})")
    for name, r in (("index_insert", ins), ("index_lookup", lk),
                    ("index_insert (seed shape)", seed)):
        plain_txt = f", plain {r['plain_ms']:.4f} ms" if "plain_ms" in r \
            else ""
        log(f"  {name}: {r['ms']:.4f} ms{plain_txt}, library -, bound "
            f"{r['bound_ms'] * 1e3:.2f} us ({r['bound_ms'] / r['ms']:.1%}; "
            f"two-array bound {r['old_bound_ms'] * 1e3:.2f} us) ({card})")
    log(f"  probes: {json.dumps({k: round(v, 4) for k, v in probes.items()})}"
        f" ({card})")
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
    kv_route = require_native("train", table)
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
        f"created, {n_changed} of {n_touched} touched rows changed; host "
        f"key index route {kv_route} ({card})")

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
    # the index work (prepare) runs once and both runs replay it. It runs
    # on each route of the host key index in turns, from the same start
    fresh = fresh_table()
    pair, idxs = route_pair(fresh, lambda t: timed_calls(t.prepare,
                                                         batches))
    prep_ms = pair["native_ms"]
    log_route_pair("train prepare", pair, card)
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
    traced = _profiled(torch, TrainStep(fresh.cfg, BATCH, NUM_SLOTS), sk,
                       make_device_batch(batches[0], idxs[0], cuda),
                       seeded_generator(cuda, args.seed + 1, 0))
    prof = profile_step(torch, None, None, None, None, prof=traced)
    win = device_window(traced)
    busy = sum(r[1] for r in prof)
    log(f"train step profile (f32 tower): device time {busy:.3f} ms in "
        f"{sum(r[2] for r in prof)} launches; the step's device window "
        f"{win['span_ms']:.3f} ms (first to last device event), busy "
        f"{win['busy_share']:.1%} of it; top: "
        + "; ".join(f"{name[:48]} {ms:.3f} ms x{n}"
                    for name, ms, n in prof[:8]) + f" ({card})")
    details["train"] = {
        "profile_device_ms": prof, "profile_busy_ms": busy,
        "profile_window": win,
        "pass": res, "stage_ms": stages, "new_rows": n_new,
        "mf_created": created, "rows_changed": n_changed,
        "rows_touched": n_touched, "saved_rows": n_saved,
        "save_base_s": save_s, "launches": launches, "kv_route": kv_route,
        "prepare_by_route": pair,
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
    kv_route = require_native("resident", table)
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
    # kv, on each route of the host key index in turns from the same
    # start; that table then trains the pass through train_pass (its kv
    # already holds the rows train_pass would assign)
    cfg0 = SparseSGDConfig(mf_initial_range=0.0)
    host = fresh_table(cfg0)
    host_stats = {}

    def host_build(t):
        with flags_scope(use_pallas_index=False):
            t0 = time.perf_counter()
            rp_h = ResidentPass.build(ds, t)
            ms = (time.perf_counter() - t0) * 1e3
        host_stats.setdefault(t.index.kv_route, []).append(rp_h.build_stats)
        return [getattr(rp_h, a) for a in ("uniq", "gidx", "meta",
                                           "segs")], [ms]

    pair, arrays = route_pair(host, host_build)
    host_s = pair["native"] / 1e3
    log_route_pair("resident host-route build", pair, card,
                   outputs="pass arrays")
    log("  its dedup stage (of which the host index's assign), s: "
        + json.dumps({r: [[round(st["dedup"], 4), round(st["index_host"], 4)]
                          for st in v] for r, v in host_stats.items()})
        + f" ({card})")
    for a, got in zip(("uniq", "gidx", "meta", "segs"), arrays):
        if not _same_outputs(getattr(rp, a), got):
            raise AssertionError(f"resident: {a} of the device route "
                                 f"differs from the host route's")
    keys_h, rows_h = host.index.items()
    if (not np.array_equal(table.index.lookup(keys_h), rows_h)
            or len(host.index) != len(table.index)
            or not np.array_equal(host.slot_host, table.slot_host)):
        raise AssertionError("resident: the device route's kv differs "
                             "from the host route's")
    host_stats = host_stats["native"][-1]
    del table, trainer, dev

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
        f"{json.dumps({k: round(v, 4) for k, v in host_stats.items()})}; "
        f"host key index route {kv_route} ({card})")
    log(f"resident vs train_pass (f32 tower, no mf draws): max abs err "
        f"rows {row_err:.3g}, params {param_err:.3g}, auc {auc_diff:.3g} "
        f"({card})")
    details["resident"] = {
        "pass": res, "seed_s": seed_s, "build_s": build_s,
        "pass_s": pass_s, "build_stats": rp.build_stats,
        "host_build_s": host_s, "host_build_stats": host_stats,
        "host_build_by_route": pair, "kv_route": kv_route,
        "launches": launches, "new_rows": n_new,
        "mf_created": created, "rows_changed": n_changed,
        "examples_per_sec_with_build": n_rec / (build_s
                                                + res["elapsed_sec"]),
        "wire_bytes": rp.nbytes(), "row_max_abs_err": row_err,
        "param_max_abs_err": param_err, "auc_diff": auc_diff,
        "train_pass_f32": res_s, "resident_f32": res_r}
    return {k: launches[k] for k in ("index_insert", "index_lookup")}


def _bound(nbytes: float, ops: float):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    float32 operations over the peak rate."""
    by_bytes, by_ops = nbytes / PEAK_BYTES * 1e3, ops / PEAK_F32 * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                          "operations")


def ctr_phase(torch, pv_batches, flush, card, details, gen):
    """Phase 3, the CTR kernels at the PV path's shapes, each against its
    plain version: rank_attention on a real PV batch's rank_offset (and
    on a hand-built one with zero, negative and out-of-range ranks and
    rows), batch_fc in its three modes, cross_norm with a summary folded
    from one batch. Returns the three kernels' rows of the ``kernels``
    line."""
    from paddlebox_tpu_torch.ops import ctr_kernels as C
    cuda = torch.device("cuda")
    n, dm, mr = PV_BATCH, PV_DMODEL, PV_MAX_RANK

    # rank_attention: proj [4096, 128] f32, rank_param [9, 128, 128]
    ro = torch.from_numpy(pv_batches[0][1]).to(cuda)
    x = torch.randn((n, dm), generator=gen, device=cuda)
    param = torch.randn((mr * mr, dm, dm), generator=gen, device=cuda) * 0.02
    rng = np.random.default_rng(5)
    wild = np.full((n, 1 + 2 * mr), -1, np.int32)
    wild[:, 0] = rng.integers(-2, mr + 3, size=n)
    wild[:, 1::2] = rng.integers(-2, mr + 3, size=(n, mr))
    wild[:, 2::2] = rng.integers(-3, n + 3, size=(n, mr))
    wild = torch.from_numpy(wild).to(cuda)
    ra_err = 0.0
    for what, r in (("PV batch", ro), ("hand-built ranks", wild)):
        got = C.rank_attention(x, r, param, mr)
        want = C.rank_attention_plain(x, r, param, mr)
        torch.cuda.synchronize()
        ra_err = max(ra_err, check_close(f"rank_attention ({what})", got,
                                         want, RA_RTOL, RA_ATOL))
    blk, idx, valid = C.decode_rank_offset(ro, mr, n)
    n_valid = int(valid.sum())
    gmat, _ = C._grouped_input(x, blk, idx, valid, mr * mr)
    want_ra = C.rank_attention(x, ro, param, mr)
    again = C.rank_attention(x, ro, param, mr)
    torch.cuda.synchronize()
    if not torch.equal(want_ra, again):
        raise AssertionError("rank_attention: two calls differ")
    # the wrapper against the product over the grouped input only (the
    # library call leaves out the decode, the row gather and the grouping)
    ra_reps = alternating_ms(torch, {
        "kernel": lambda: C.rank_attention(x, ro, param, mr),
        "library": lambda: torch.einsum("bnd,bdp->np", gmat, param)}, flush)
    ra = {"name": "rank_attention", "route": "cuda",
          "source": "paddlebox_tpu_torch/csrc/rank_attention.cu",
          "replaces": "paddlebox_tpu/ops/pallas_ctr.py:138",
          "max_abs_err": ra_err, "ms": ra_reps["kernel"]["median"],
          "plain_ms": time_ms(torch, lambda: C.rank_attention_plain(
              x, ro, param, mr), flush),
          "library_ms": ra_reps["library"]["median"]}
    ra_parts = rank_parts_ms(torch, x, ro, param, mr, want_ra, flush)
    # x, rank_offset and the param blocks read, [N, P] written; 2·D·P
    # operations per valid (row, co-shown ad) entry of this batch
    ra["bound_ms"], ra["bound_by"] = _bound(
        (n * dm + ro.numel() + param.numel() + n * dm) * 4,
        2.0 * n_valid * dm * dm)

    # batch_fc: the slot_fc tower, [S, B, D] (the pooled block's strided
    # swapaxes view) x [S, D, D] + [S, D], D = 3 + mf_dim
    s, dd = PV_SLOTS, 3 + MF_DIM
    pooled = torch.randn((n, s, dd), generator=gen, device=cuda)
    xs = pooled.transpose(0, 1)
    w = torch.randn((s, dd, dd), generator=gen, device=cuda) * 0.3
    bias = torch.randn((s, dd), generator=gen, device=cuda)
    flat = xs.reshape(s * n, dd)
    fc_err = 0.0
    for what, args in (("default, strided x", (xs, w, bias, False)),
                       ("batchcount", (flat.view(s, n, dd), w, bias, False)),
                       ("transpose", (flat.view(s, n, dd),
                                      w.transpose(1, 2).contiguous(), bias,
                                      True))):
        got = C.batch_fc(*args)
        want = C.batch_fc_plain(*args)
        torch.cuda.synchronize()
        fc_err = max(fc_err, check_close(f"batch_fc ({what})", got, want,
                                         FC_RTOL, FC_ATOL))
    fc_reps = alternating_ms(torch, {
        "kernel": lambda: C.batch_fc(xs, w, bias, False),
        "library": lambda: torch.baddbmm(bias[:, None, :], xs, w)}, flush)
    bfc = {"name": "batch_fc", "route": "cuda",
           "source": "paddlebox_tpu_torch/csrc/batch_fc.cu",
           "replaces": "paddlebox_tpu/ops/pallas_ctr.py:248",
           "max_abs_err": fc_err, "ms": fc_reps["kernel"]["median"],
           "plain_ms": time_ms(torch, lambda: C.batch_fc_plain(
               xs, w, bias, False), flush),
           "library_ms": fc_reps["library"]["median"]}
    # the per-element kernel (the path of weight blocks past the tile's
    # shared memory) at the same shape, checked exact against the wrapper
    from paddlebox_tpu_torch.ops import _build
    f_path = _build.function("batch_fc", "pbx_batch_fc_path",
                             C._BATCH_FC_PATH_ARGS)
    want_fc = C.batch_fc(xs, w, bias, False)
    out_fc = torch.empty_like(want_fc)
    e_args = (xs.data_ptr(), *xs.stride(), w.data_ptr(), bias.data_ptr(),
              out_fc.data_ptr(), s, n, dd, dd, 0, 2,
              torch.cuda.current_stream().cuda_stream)
    _build.check(f_path(*e_args), "batch_fc per-element")
    torch.cuda.synchronize()
    if not torch.equal(out_fc, want_fc):
        raise AssertionError("batch_fc: the per-element kernel differs from "
                             "the tile kernel")
    fc_elem_ms = time_ms(torch, lambda: f_path(*e_args), flush)
    bfc["bound_ms"], bfc["bound_by"] = _bound(
        (2 * s * n * dd + w.numel() + bias.numel()) * 4,
        2.0 * s * n * dd * dd)

    cn, cn_details = cross_norm_check(torch, flush, card, gen)
    # the launch floor: the least a timed call can take on this timer
    one = torch.zeros(1, device=cuda)
    floor_ms = time_ms(torch, one.zero_, flush)
    details["ctr"] = {"rank_attention_valid_entries": n_valid,
                      "pv_batch0_rows": int((ro[:, 0] != -1).sum()),
                      "rank_attention_repeats": ra_reps,
                      "rank_attention_parts": ra_parts,
                      "batch_fc_repeats": fc_reps,
                      "batch_fc_elem_ms": fc_elem_ms,
                      "launch_floor_ms": floor_ms, **cn_details}
    log(f"CTR kernels vs plain at the PV shapes: rank_attention max abs err "
        f"{ra_err:.3g} ({n_valid} valid entries in batch 0), bit-equal "
        f"across calls, batch_fc 3 modes {fc_err:.3g}, cross_norm exact but "
        f"the dot, dot {cn['max_abs_err']:.3g}, bit-equal across calls and "
        f"its two kernels")
    for r in (ra, bfc, cn):
        lib = ("-" if r["library_ms"] is None
               else f"{r['library_ms']:.4f} ms")
        log(f"  {r['name']}: {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} "
            f"ms, library {lib}, bound {r['bound_ms'] * 1e3:.2f} us "
            f"({r['bound_by']}) ({card})")
    for r, reps, lib in ((ra, ra_reps, "einsum"), (bfc, fc_reps, "baddbmm")):
        log(f"  {r['name']}: wrapper {reps['kernel']['median']:.4f} ms "
            f"(spread {reps['kernel']['spread']:.4f}) vs {lib} "
            f"{reps['library']['median']:.4f} (spread "
            f"{reps['library']['spread']:.4f}), medians of "
            f"{len(reps['kernel']['runs'])} alternating repeats ({card})")
    log(f"  rank_attention alone: bucket pass "
        f"{ra_parts['buckets_only_ms']:.4f} ms "
        f"({ra['bound_ms'] / ra_parts['buckets_only_ms']:.1%} of the bound), "
        f"tile kernel {ra_parts['tiles_only_ms']:.4f} ms "
        f"({ra['bound_ms'] / ra_parts['tiles_only_ms']:.1%}) ({card})")
    log(f"  batch_fc: per-element kernel at the same shape {fc_elem_ms:.4f} "
        f"ms; launch floor (a one-element zero_) {floor_ms:.4f} ms ({card})")
    return ra, bfc, cn


def log_cross_norm_probe(probe: dict, bound_ms: float, card: str) -> None:
    reps = probe["repeats"]
    k, c, f = reps["kernel"], reps["copy"], reps["floor"]
    log(f"  cross_norm: wrapper {k['median']:.4f} ms (spread "
        f"{k['spread']:.4f}), copy_ of the same {probe['copy_bytes']} bytes "
        f"{c['median']:.4f} (spread {c['spread']:.4f}), launch floor "
        f"{f['median']:.4f}, medians of 5 alternating repeats; device "
        f"duration {probe['device_ms']:.5f} ms in "
        f"{probe['launches_per_call']:.0f} kernel a call: "
        f"{bound_ms / probe['device_ms']:.1%} of the {bound_ms:.5f} ms bound "
        f"({bound_ms / k['median']:.1%} through the wrapper); after a clean "
        f"flush {probe['device_clean_l2_ms']:.5f}; the copy_ on the device "
        f"{probe['copy_device_ms']:.5f} (clean "
        f"{probe['copy_device_clean_l2_ms']:.5f}), the one-element zero_ "
        f"{probe['floor_device_ms']:.5f} ({card})")


def cross_norm_check(torch, flush, card, gen):
    """Row 10 in phase 3 at the PV shape: the wrapper against its plain
    version (exact but the dot column) and bit-equal across two calls;
    each kernel of ``csrc/cross_norm.cu`` forced through its C entry and
    equal to the wrapper, alone after both flushes with its device
    duration; the wrapper's probe
    (:func:`cross_norm_probe`); and the device time of the plain backward.
    Returns the ``kernels`` row and the details."""
    from paddlebox_tpu_torch.ops import _build
    from paddlebox_tpu_torch.ops import ctr_kernels as C
    from paddlebox_tpu_torch.ops import kernels as K
    n, dm = PV_BATCH, PV_DMODEL
    # cross_norm: h = [proj, attention] [4096, 256] → [4096, 385]
    h, mean, scale = cross_norm_inputs(torch, gen)
    got = C.cross_norm(h, mean, scale, 1, dm)
    again = C.cross_norm(h, mean, scale, 1, dm)
    want = C.cross_norm_plain(h, mean, scale, 1, dm)
    torch.cuda.synchronize()
    w_out = 3 * dm + 1
    if not torch.equal(got[:, :3 * dm], want[:, :3 * dm]):
        raise AssertionError("cross_norm differs from its plain version "
                             "outside the dot column")
    cn_err = check_close("cross_norm (dot column)", got[:, 3 * dm:],
                         want[:, 3 * dm:], DOT_RTOL, DOT_ATOL)
    if not torch.equal(got, again):
        raise AssertionError("cross_norm: two calls differ")
    if C.cross_norm_branch(h.data_ptr(), got.data_ptr(), n, 1, dm) != 1:
        raise AssertionError("cross_norm: the PV shape misses the tile "
                             "kernel")
    cn_probe = cross_norm_probe(torch, h, mean, scale, flush)
    cn = {"name": "cross_norm", "route": "cuda",
          "source": "paddlebox_tpu_torch/csrc/cross_norm.cu",
          "replaces": "paddlebox_tpu/ops/pallas_ctr.py:363",
          "max_abs_err": cn_err,
          "ms": cn_probe["repeats"]["kernel"]["median"],
          "plain_ms": time_ms(torch, lambda: C.cross_norm_plain(
              h, mean, scale, 1, dm), flush),
          "library_ms": None}
    cn["bound_ms"], cn["bound_by"] = _bound(
        (h.numel() + 2 * w_out + n * w_out) * 4, 5.0 * n * w_out)
    # each kernel of cross_norm.cu through its C entry, forced: the tile
    # kernel (1) and the rows kernel (2), each equal to the wrapper bit for
    # bit (one dot order in both), alone after both flushes
    f_cn = _build.function("cross_norm", "pbx_cross_norm_path",
                           C._CROSS_NORM_PATH_ARGS)
    out_cn = torch.empty_like(got)
    stream = torch.cuda.current_stream().cuda_stream

    def cn_call(path):
        return lambda: _build.check(f_cn(
            h.data_ptr(), mean.data_ptr(), scale.data_ptr(),
            out_cn.data_ptr(), n, 1, dm, path, stream),
            f"cross_norm path {path}")

    def cn_same(path):
        def check():
            if not torch.equal(out_cn, got):
                raise AssertionError(f"cross_norm: kernel {path} alone "
                                     f"differs from the wrapper")
        return check

    cn_alone = {}
    for path, what in ((1, "tile"), (2, "rows")):
        out_cn.fill_(float("nan"))
        cn_alone[what] = alone_ms(torch, cn_call(path), cn_same(path), flush)
        cn_alone[what].update(device_ms(torch, cn_call(path), flush,
                                        "cross_norm"))
    # the backward, plain PyTorch (the JAX package has no kernel for it):
    # dx only, as the PV path's fixed summary asks for
    hx = h.clone().requires_grad_(True)
    y = C.CrossNormFn.apply(hx, mean, scale, 1, dm, K.KERNELS)
    gy = torch.randn(y.shape, generator=gen, device="cuda")
    cn_bwd = device_ms(torch, lambda: torch.autograd.grad(
        y, hx, gy, retain_graph=True), None, "", iters=5)
    log_cross_norm_probe(cn_probe, cn["bound_ms"], card)
    log("  cross_norm alone: " + ", ".join(
        f"{what} {t['kernel_only_ms']:.4f} ms (clean L2 "
        f"{t['kernel_only_clean_l2_ms']:.4f}, device {t['device_ms']:.5f}, "
        f"{cn['bound_ms'] / t['device_ms']:.1%} of the bound)"
        for what, t in cn_alone.items()) + f" ({card})")
    log(f"  cross_norm backward (plain PyTorch, dx): "
        f"{cn_bwd['launches_per_call']:.0f} kernels, device "
        f"{cn_bwd['device_ms']:.4f} ms a call ({card})")
    return cn, {"cross_norm_probe": cn_probe, "cross_norm_alone": cn_alone,
                "cross_norm_backward": cn_bwd}


class PvDeviceBatch:
    """One PV batch's tensors on the card (the H2D of the PV loop)."""

    def __init__(self, torch, batch, ro, device) -> None:
        def dev(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)
        self.segments = dev(batch.segments)
        self.show_clk = dev(np.stack([batch.show, batch.clk], axis=1))
        self.dense = dev(batch.dense)
        self.label = dev(batch.label)
        self.ro = dev(ro)
        self.ins_w = dev((batch.show > 0).astype(np.float32))


def pv_step(torch, table, model, opt, summary, idx, dv, ops):
    """One step of bench.py's PV loop: pull → fused_seqpool_cvm → AdsRank
    → ins_w-weighted BCE → backward and Adam → embed grads scaled by −B →
    push. Returns the loss (a device tensor)."""
    import torch.nn.functional as F

    from paddlebox_tpu_torch.ops.seqpool_cvm import fused_seqpool_cvm
    values_k = table.pull(idx, ops).requires_grad_(True)
    pooled = fused_seqpool_cvm(values_k, dv.segments, dv.show_clk, PV_BATCH,
                               PV_SLOTS, ops=ops)
    logits = model(pooled, dv.dense, dv.ro, summary)
    ls = F.binary_cross_entropy_with_logits(logits, dv.label,
                                            reduction="none")
    loss = (ls * dv.ins_w).sum() / dv.ins_w.sum().clamp_min(1.0)
    opt.zero_grad(set_to_none=True)
    loss.backward()
    opt.step()
    gk = values_k.grad
    gk[:, 2:] *= -1.0 * PV_BATCH
    table.push(idx, gk, ops=ops)
    return loss.detach()


def pv_phase(torch, args, card, pv_batches, details):
    """Phase 7: the PV ads-ranking path (see the module docstring).
    Returns the three CTR kernels' launches in its main run."""
    from paddlebox_tpu_torch import AdsRank, EmbeddingTable, convert
    from paddlebox_tpu_torch.ops import ctr_kernels as C
    from paddlebox_tpu_torch.ops import kernels as K
    from paddlebox_tpu_torch.ops.cross_norm import init_cross_norm_summary
    from paddlebox_tpu_torch.ps.sgd import SparseSGDConfig

    cuda = torch.device("cuda")
    batches = pv_batches[:args.batches]
    nb = len(batches)
    ads = int(sum((b.show > 0).sum() for b, _ in batches))
    base = make_table_blob(np.random.default_rng(args.seed + 3), convert,
                           vocab=PV_BASE_VOCAB, no_mf=0.25,
                           num_slots=PV_SLOTS, stride=PV_VOCAB)
    summary = init_cross_norm_summary(1, PV_DMODEL, device=cuda)  # fixed

    def fresh_table(path, cfg):
        t = EmbeddingTable(mf_dim=MF_DIM, capacity=PV_CAPACITY, cfg=cfg,
                           seed=args.seed, unique_bucket_min=512,
                           device="cuda")
        t.load(path)
        return t

    def fresh_model(dtype):
        torch.manual_seed(args.seed + 4)
        return AdsRank(PV_SLOTS, 3 + MF_DIM, PV_DENSE, d_model=PV_DMODEL,
                       max_rank=PV_MAX_RANK, hidden=PV_HIDDEN,
                       compute_dtype=dtype, slot_fc=True,
                       cross_norm=True).to(cuda)

    def run(table, model, ops, timed):
        model.ops = ops
        opt = torch.optim.Adam(model.parameters(), lr=5e-3, eps=1e-8)
        losses = []
        split = {"prepare_ms": [], "h2d_ms": [], "step_ms": []}
        for batch, ro in batches:
            if timed:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            idx = table.prepare(batch)
            t1 = time.perf_counter()
            dv = PvDeviceBatch(torch, batch, ro, cuda)
            if timed:
                torch.cuda.synchronize()
            t2 = time.perf_counter()
            loss = pv_step(torch, table, model, opt, summary, idx, dv, ops)
            losses.append(float(loss))             # reading it syncs
            t3 = time.perf_counter()
            for k, a, b in (("prepare_ms", t0, t1), ("h2d_ms", t1, t2),
                            ("step_ms", t2, t3)):
                split[k].append((b - a) * 1e3)
            if not np.isfinite(losses[-1]):
                raise AssertionError(f"PV: non-finite loss {losses}")
        return losses, split, opt

    cfg = SparseSGDConfig(mf_create_thresholds=0.0, mf_initial_range=1e-3)
    cfg0 = SparseSGDConfig(mf_create_thresholds=0.0, mf_initial_range=0.0)
    fns = {"gather_rows": K.gather_rows, "pool_cvm": K.pool_cvm,
           "segment_gather": K.segment_gather,
           "scatter_add_update": K.scatter_add_update,
           "rank_attention": C.rank_attention, "batch_fc": C.batch_fc,
           "cross_norm": C.cross_norm}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "pv_base.npz")
        np.savez(path, **base)
        n_base = len(base["keys"])
        del base
        table = fresh_table(path, cfg)
        kv_route = require_native("PV", table)
        start = table.state.data.clone()
        model = fresh_model(torch.bfloat16)
        torch.cuda.synchronize()

        # the main path: bf16 tower, the kernels
        for fn in fns.values():
            fn.launches = 0
        t0 = time.perf_counter()
        losses, _, _ = run(table, model, K.KERNELS, timed=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in fns.items()}
        want = {name: nb for name in fns}
        want["gather_rows"] = 2 * nb            # the pull's and the push's
        if launches != want:
            raise AssertionError(f"PV: launches {launches}, expected {want}")
        data = table.state.data
        if bool(data[PV_CAPACITY].any()):
            raise AssertionError("PV: the sentinel row was written")
        touched = torch.from_numpy(table._touched).to(cuda)
        changed = (data != start).any(dim=1)
        if bool((changed & ~touched).any()):
            raise AssertionError("PV: rows the pass did not touch changed")
        n_new = len(table.index) - n_base
        created = int(((start[:, 7] == 0) & (data[:, 7] > 0)
                       & (start[:, 0] > 0)).sum())
        n_changed = int(changed.sum())
        if n_new <= 0 or created <= 0 or n_changed <= 0:
            raise AssertionError(f"PV: {n_new} new rows, {created} mf "
                                 f"created, {n_changed} rows changed")
        del table, start, changed, touched, model

        # the batches' prepare on each route of the host key index, in
        # turns from the same start
        pair, _ = route_pair(fresh_table(path, cfg0), lambda t: timed_calls(
            t.prepare, [b for b, _ in batches]))
        log_route_pair("PV prepare", pair, card)

        # kernels vs plain from the same start: f32 tower, no mf draws
        tk, tp = fresh_table(path, cfg0), fresh_table(path, cfg0)
        mk, mp = fresh_model(torch.float32), fresh_model(torch.float32)
        loss_k, split_k, opt_k = run(tk, mk, K.KERNELS, timed=True)
        loss_p, split_p, _ = run(tp, mp, K.PLAIN, timed=True)
    rows_t = torch.from_numpy(np.nonzero(tk._touched | tp._touched)[0]).to(
        cuda)
    row_err = check_close("PV: touched table rows, kernels vs plain",
                          tk.state.data[rows_t], tp.state.data[rows_t],
                          STATE_RTOL, STATE_ATOL)
    pk, pp = mk.state_dict(), mp.state_dict()
    param_err = max(check_close(f"PV: dense param {k}", pk[k], pp[k],
                                PARAM_RTOL, PARAM_ATOL) for k in pk)
    p50 = {k: float(np.median(v)) for k, v in split_k.items()}
    step_p50 = sum(p50.values())
    # one more f32 step through the kernels, profiled: device time per
    # kernel (and copy), and the busy share of the step's own device window
    batch, ro = batches[0]
    idx = tk.prepare(batch)
    dv = PvDeviceBatch(torch, batch, ro, cuda)
    traced = _profiled(torch, lambda *_: pv_step(
        torch, tk, mk, opt_k, summary, idx, dv, K.KERNELS), None, None, None)
    prof = profile_step(torch, None, None, None, None, prof=traced)
    win = device_window(traced)
    kern_ms = sum(r[1] for r in prof)
    cn_fwd = sum(r[1] for r in prof if "cross_norm" in r[0])
    pv_prof = {"kernel_ms": kern_ms, "launches": sum(r[2] for r in prof),
               "window": win, "cross_norm_fwd_ms": cn_fwd,
               "top": [{"kernel": k, "ms": ms, "launches": c}
                       for k, ms, c in prof[:12]]}
    ads_per_batch = ads / nb
    log(f"PV train: {nb} steps of {PV_BATCH} rows ({ads} ads, "
        f"{len(batches[0][0].keys)} key slots a batch), "
        f"{ads / wall:.0f} examples/s (bf16 tower, loss read every step), "
        f"last loss {losses[-1]:.4f}; {n_new} new rows, {created} mf "
        f"created, {n_changed} rows changed; launches "
        f"{json.dumps(launches)}; host key index route {kv_route} ({card})")
    log(f"PV steps (f32 tower, synchronized): p50 {step_p50:.2f} ms = "
        f"{json.dumps({k: round(v, 3) for k, v in p50.items()})}, "
        f"{ads_per_batch / step_p50 * 1e3:.0f} examples/s; device step p50 "
        f"{p50['step_ms']:.3f} ms through the kernels, "
        f"{float(np.median(split_p['step_ms'])):.3f} ms through the plain "
        f"versions; kernels vs plain max abs err rows {row_err:.3g}, "
        f"params {param_err:.3g} ({card})")
    log(f"PV profiled f32 step: {kern_ms:.3f} ms of device time (kernels "
        f"and copies) in {pv_prof['launches']} launches; the step's device "
        f"window {win['span_ms']:.3f} ms (first to last device event), busy "
        f"{win['busy_share']:.1%} of it; cross_norm forward {cn_fwd:.4f} ms ({cn_fwd / kern_ms:.2%} of the "
        f"device time); top: " + "; ".join(
            f"{r['kernel'][:60]} {r['ms']:.4f} ms x{r['launches']}"
            for r in pv_prof["top"][:6]) + f" ({card})")
    details["pv"] = {
        "batches": nb, "ads": ads, "wall_s": wall,
        "examples_per_sec": ads / wall, "losses": losses,
        "launches": launches, "new_rows": n_new, "mf_created": created,
        "rows_changed": n_changed, "split_ms": split_k,
        "kv_route": kv_route, "prepare_by_route": pair,
        "plain_split_ms": split_p, "split_p50_ms": p50,
        "step_p50_ms": step_p50, "loss_kernels_f32": loss_k,
        "loss_plain_f32": loss_p, "row_max_abs_err": row_err,
        "param_max_abs_err": param_err, "profiled_step": pv_prof}
    return {k: launches[k] for k in ("rank_attention", "batch_fc",
                                     "cross_norm")}


SEQPOOL_GROUPS = 4              # phase 8: slot_group_bounds(26, 4)
SEQPOOL_KK = 3                  # phase 8: the concat form's k


def _seqpool_ops(torch, values, segs, show_clk, gen):
    """Phase 8's op table on the ragged batch: (name, pools through
    segment_sum, the op's input values [K, D], fn(v, ops) → output).
    Variants that need more cvm columns get seeded ones in front of the
    pulled embed columns."""
    from paddlebox_tpu_torch.ops import kernels as K
    from paddlebox_tpu_torch.ops import seqpool_cvm as SC
    from paddlebox_tpu_torch.ops import seqpool_variants as SV
    from paddlebox_tpu_torch.ops.cvm import cvm, cvm_grad_passthrough
    cuda = torch.device("cuda")
    b, s = BATCH, NUM_SLOTS
    k = values.shape[0]

    def counts(n_cols):
        return torch.floor(torch.rand((k, n_cols), generator=gen,
                                      device=cuda) * 4)

    def heads(n_cols, rows=b):
        return torch.floor(torch.rand((rows, n_cols), generator=gen,
                                      device=cuda) * 5)

    show_clk_v, embed = values[:, :2], values[:, 2:]
    conv_head = heads(3)
    credit_v = torch.cat([show_clk_v, counts(2), embed], 1).contiguous()
    credit_head = heads(4)
    pcoc_v = torch.cat([show_clk_v, counts(4), embed], 1).contiguous()
    pcoc_head, q_values = heads(6), torch.randn((b, 2), generator=gen,
                                                device=cuda)
    trade_v = torch.cat([show_clk_v, torch.rand((k, 3), generator=gen,
                                                device=cuda), embed],
                        1).contiguous()
    thr = (0.2 + 1.8 * torch.rand(s, generator=gen, device=cuda))
    concat = dict(embedx_concate_size=SEQPOOL_KK, pad_value=0.25,
                  need_filter=True, embedx_concate_filter=True)
    slot = segs.long() % s
    bounds = SC.slot_group_bounds(s, SEQPOOL_GROUPS)
    picks = [torch.nonzero((slot >= lo) & (slot < hi)).squeeze(1)
             for lo, hi in bounds]

    def slot_groups(v, ops):
        return torch.cat([SC.fused_seqpool_cvm_slot_group(
            v[pk], segs[pk].contiguous(), show_clk, b, s, lo, hi, ops=ops)
            for (lo, hi), pk in zip(bounds, picks)], dim=1)

    def cvm_pair(v, ops):
        x = SC.fused_seqpool_concat(v, segs, b, s, ops=ops).reshape(b * s,
                                                                    -1)
        return cvm(cvm_grad_passthrough(x), x[:, :2].detach())

    return [
        ("concat_kk3_show", True, values, lambda v, ops: SC.fused_seqpool_cvm(
            v, segs, show_clk, b, s, clk_filter=True, ops=ops, **concat)),
        ("concat_kk3_nocvm", True, values,
         lambda v, ops: SC.fused_seqpool_cvm(
             v, segs, show_clk, b, s, use_cvm=False, ops=ops, **concat)),
        ("embed_threshold_filter", False, values,
         lambda v, ops: SC.fused_seqpool_cvm(
             v, segs, show_clk, b, s, need_filter=True,
             embed_threshold_filter=True, embed_threshold=0.15, ops=ops)),
        ("conv_show_filter", False, values,
         lambda v, ops: SC.fused_seqpool_cvm_with_conv(
             v, segs, conv_head, b, s, show_filter=True, need_filter=True,
             ops=ops)),
        ("slot_group_4", False, values, slot_groups),
        ("seqpool_concat", True, values,
         lambda v, ops: SC.fused_seqpool_concat(v, segs, b, s, 0.25,
                                                ops=ops)),
        ("embed_pool_cvm", False, values,
         lambda v, ops: K.fused_embed_pool_cvm(
             v, segs, show_clk, b, s, need_filter=True, ops=ops)),
        ("diff_thres", True, values,
         lambda v, ops: SV.fused_seqpool_cvm_with_diff_thres(
             v, segs, show_clk, thr, b, s, pad_value=0.25, ops=ops)),
        ("tradew", True, trade_v, lambda v, ops: SV.fused_seqpool_cvm_tradew(
            v, segs, show_clk, b, s, 3, ops=ops)),
        ("tradew_trade_id", True, trade_v,
         lambda v, ops: SV.fused_seqpool_cvm_tradew(
             v, segs, show_clk, b, s, 3, trade_id=1, ops=ops)),
        ("credit", True, credit_v,
         lambda v, ops: SV.fused_seqpool_cvm_with_credit(
             v, segs, credit_head, b, s, ops=ops)),
        ("pcoc_p2", True, pcoc_v,
         lambda v, ops: SV.fused_seqpool_cvm_with_pcoc(
             v, segs, pcoc_head, q_values, b, s, ops=ops)),
        ("cvm", True, values, cvm_pair),
    ]


def _run_op(torch, fn, x, ops, gout_seed):
    """One op forward and backward through ``ops``: (output, grad of the
    input, synchronized ms). The output grad is seeded, so the kernel and
    plain runs see the same one."""
    v = x.detach().requires_grad_(True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(v, ops)
    g = torch.randn(out.shape, device=out.device,
                    generator=torch.Generator(device=out.device).manual_seed(
                        gout_seed))
    (grad,) = torch.autograd.grad(out, v, g)
    torch.cuda.synchronize()
    return out.detach(), grad, (time.perf_counter() - t0) * 1e3


def seqpool_phase(torch, values, segs, show_clk, table, rows_u, u_real,
                  flush, card, details, gen):
    """Phase 8: the seqpool op family at the ragged batch's full width
    (see the module docstring), then segment_sum and the three row
    copies against their plain versions and timed. Returns the four
    kernels' rows of the ``kernels`` line."""
    from paddlebox_tpu_torch.ops import kernels as K
    from paddlebox_tpu_torch.ops import seqpool_cvm as SC
    cuda = torch.device("cuda")
    b, s = BATCH, NUM_SLOTS
    n = b * s
    ops = _seqpool_ops(torch, values, segs, show_clk, gen)
    fam = (K.segment_sum, K.pool_cvm, K.segment_gather)

    # the main path: every op forward and backward through the kernels
    for fn in fam:
        fn.launches = 0
    per_op = {}
    for i, (name, pools, x, fn) in enumerate(ops):
        before = K.segment_sum.launches
        out, grad, _ = _run_op(torch, fn, x, K.KERNELS, i)
        per_op[name] = K.segment_sum.launches - before
        if pools and per_op[name] == 0:
            raise AssertionError(f"seqpool: {name} did not launch "
                                 f"segment_sum")
        if not (torch.isfinite(out).all() and torch.isfinite(grad).all()):
            raise AssertionError(f"seqpool: {name} is not finite")
    fam_launches = {fn.__name__: fn.launches for fn in fam}

    # kernels against plain, op by op (timed, synchronized)
    fwd_err = grad_err = 0.0
    op_ms = {}
    for i, (name, _, x, fn) in enumerate(ops):
        out_k, grad_k, ms_k = _run_op(torch, fn, x, K.KERNELS, i)
        out_p, grad_p, ms_p = _run_op(torch, fn, x, K.PLAIN, i)
        op_ms[name] = {"kernels_ms": ms_k, "plain_ms": ms_p,
                       "out_shape": list(out_k.shape)}
        fwd_err = max(fwd_err, check_close(f"seqpool {name} forward", out_k,
                                           out_p, POOL_RTOL, POOL_ATOL))
        if name == "tradew_trade_id":    # Σ g·embed: an f32 sum
            col = 2 + 1
            rest = torch.ones(grad_k.shape[1], dtype=torch.bool, device=cuda)
            rest[col] = False
            grad_err = max(grad_err, check_close(
                f"seqpool {name} trade grad", grad_k[:, col],
                grad_p[:, col], 0.0, 1e-6))
            grad_k, grad_p = grad_k[:, rest], grad_p[:, rest]
        if not torch.equal(grad_k, grad_p):
            raise AssertionError(f"seqpool: {name} grad differs from the "
                                 f"plain version's")
    # the slot groups, in slot order, are the monolithic op
    mono = SC.fused_seqpool_cvm(values, segs, show_clk, b, s)
    slot_groups = {name: fn for name, _, _, fn in ops}["slot_group_4"]
    if not torch.equal(slot_groups(values, K.KERNELS), mono):
        raise AssertionError("seqpool: slot groups differ from the "
                             "monolithic pool")

    # segment_sum on its two streams: the concat path's (−1 markers,
    # 3 x B*S bins) and _pool_core's (B*S + 1 bins, pads at B*S)
    rank = SC._segment_ranks(segs)
    drop = rank >= SEQPOOL_KK
    seg2 = torch.where(drop, -1, segs * SEQPOOL_KK + rank).to(
        torch.int32).contiguous()
    vv = torch.where(drop[:, None], 0.0, values).contiguous()
    d = values.shape[1]
    ss_err, streams = 0.0, {}
    for what, v, ids, nb in (("concat", vv, seg2, SEQPOOL_KK * n + 1),
                             ("pool_core", values, segs, n + 1)):
        got = K.segment_sum(v, ids, nb)
        want = K.segment_sum_plain(v, ids, nb)
        torch.cuda.synchronize()
        ss_err = max(ss_err, check_close(f"segment_sum ({what})", got, want,
                                         POOL_RTOL, POOL_ATOL))
        ok = (ids >= 0) & (ids < nb)
        lengths = torch.bincount(ids[ok].long(), minlength=nb)
        v_ok = v[ok].contiguous()
        kk = v.shape[0]
        reps = alternating_ms(torch, {
            "kernel": lambda: K.segment_sum(v, ids, nb),
            "library": lambda: torch.segment_reduce(v_ok, "sum",
                                                    lengths=lengths)}, flush)
        streams[what] = {
            "num_segments": nb, "keys": kk, "kept": int(ok.sum()),
            "ms": reps["kernel"]["median"],
            "plain_ms": time_ms(torch, lambda: K.segment_sum_plain(
                v, ids, nb), flush),
            "library_ms": reps["library"]["median"], "repeats": reps,
            # values and ids read once, the [N, D] sums written once
            "bound_ms": (kk * (d + 1) * 4 + nb * d * 4) / PEAK_BYTES * 1e3}
        out_s = torch.empty((nb, d), dtype=torch.float32, device=cuda)
        streams[what].update(pool_parts_ms(
            torch, "segment_sum", ids, nb,
            lambda bd: (v.data_ptr(), ids.data_ptr(), bd.data_ptr(),
                        out_s.data_ptr(), kk, nb, d), out_s, got, flush))
    main = streams["pool_core"]
    ss = {"name": "segment_sum", "route": "cuda",
          "source": "paddlebox_tpu_torch/csrc/segment_sum.cu",
          "replaces": "paddlebox_tpu/ops/pallas_kernels.py:420",
          "max_abs_err": ss_err, "ms": main["ms"],
          "plain_ms": main["plain_ms"], "library_ms": main["library_ms"],
          "bound_ms": main["bound_ms"], "bound_by": "bytes",
          "launches": fam_launches["segment_sum"]}

    # rows 2-4: no consumer; their path here is a pull and write-back
    # round trip of the batch's unique rows on a copy of the table
    row_fns = (K.gather_rows_dma, K.scatter_rows_dma, K.scatter_rows)
    for fn in row_fns:
        fn.launches = 0
    pulled = K.gather_rows_dma(table, rows_u)
    work = table.clone()
    K.scatter_rows_dma(work, rows_u, pulled + 1.0)
    moved = not torch.equal(work[:CAPACITY], table[:CAPACITY])
    K.scatter_rows(work, rows_u, pulled)
    torch.cuda.synchronize()
    row_launches = {fn.__name__: fn.launches for fn in row_fns}
    if not moved or not torch.equal(work[:CAPACITY], table[:CAPACITY]):
        raise AssertionError("row copies: the round trip did not restore "
                             "the table")
    del work
    u_pad, feat = rows_u.shape[0], table.shape[1]
    vals = torch.randn((u_pad, feat), generator=gen, device=cuda)
    rows_c = torch.where((rows_u >= 0) & (rows_u <= CAPACITY), rows_u,
                         CAPACITY).long()
    if not torch.equal(K.gather_rows_dma(table, rows_u),
                       K.gather_rows_dma_plain(table, rows_u)):
        raise AssertionError("gather_rows_dma differs from its plain "
                             "version")
    copies = {}
    for name, kern, plain in (
            ("scatter_rows_dma", K.scatter_rows_dma,
             K.scatter_rows_dma_plain),
            ("scatter_rows", K.scatter_rows, K.scatter_rows_plain)):
        t_k, t_p = table.clone(), table.clone()
        kern(t_k, rows_u, vals)
        plain(t_p, rows_u, vals)
        torch.cuda.synchronize()
        if not torch.equal(t_k[:CAPACITY], t_p[:CAPACITY]):
            raise AssertionError(f"{name} differs from its plain version "
                                 f"(the sentinel row aside)")
        copies[name] = (t_k, t_p)
    # ids read; u_real distinct rows + the sentinel on one side, every
    # padded row on the other
    row_bound = (u_pad * 4 + (u_pad + u_real + 1) * feat * 4) / PEAK_BYTES \
        * 1e3
    rows_out, dma_t = [], {}
    for name, src, line, kern, plain, lib in (
            ("scatter_rows", "scatter_rows.cu", 155,
             lambda: K.scatter_rows(copies["scatter_rows"][0], rows_u, vals),
             lambda: K.scatter_rows_plain(copies["scatter_rows"][1], rows_u,
                                          vals),
             lambda: copies["scatter_rows"][1].index_copy_(0, rows_c, vals)),
            ("scatter_rows_dma", "row_dma.cu", 243,
             lambda: K.scatter_rows_dma(copies["scatter_rows_dma"][0],
                                        rows_u, vals),
             lambda: K.scatter_rows_dma_plain(
                 copies["scatter_rows_dma"][1], rows_u, vals),
             lambda: copies["scatter_rows_dma"][1].index_copy_(0, rows_c,
                                                                vals)),
            ("gather_rows_dma", "row_dma.cu", 278,
             lambda: K.gather_rows_dma(table, rows_u),
             lambda: K.gather_rows_dma_plain(table, rows_u),
             lambda: torch.index_select(table, 0, rows_c))):
        r = {"name": name, "route": "cuda",
             "source": f"paddlebox_tpu_torch/csrc/{src}",
             "replaces": f"paddlebox_tpu/ops/pallas_kernels.py:{line}",
             "max_abs_err": 0.0, "plain_ms": time_ms(torch, plain, flush),
             "bound_ms": row_bound, "bound_by": "bytes",
             "launches": row_launches[name]}
        if name == "scatter_rows":
            r.update(ms=time_ms(torch, kern, flush),
                     library_ms=time_ms(torch, lib, flush))
        else:
            t = dma_t[name] = row_dma_timing(
                torch, name, kern, lib, table, rows_u, vals,
                copies["scatter_rows_dma"][0], flush)
            t["bound_ms"] = row_bound
            r.update(ms=t["repeats"]["kernel"]["median"],
                     library_ms=t["repeats"]["library"]["median"])
        rows_out.append(r)
    del copies
    details["seqpool"] = {
        "ops": op_ms, "segment_sum_launches_per_op": per_op,
        "main_path_launches": fam_launches, "row_launches": row_launches,
        "forward_max_abs_err": fwd_err, "grad_max_abs_err": grad_err,
        "segment_sum_streams": streams, "row_dma_timing": dma_t,
        "keys": int(values.shape[0]),
        "segments": n, "unique_rows": u_real, "padded_rows": u_pad}
    log(f"seqpool family: {len(ops)} ops forward and backward at B {b}, "
        f"S {s}, K {values.shape[0]} through the kernels and the plain "
        f"versions: forward max abs err {fwd_err:.3g}, grads exact (tradew "
        f"trade column {grad_err:.3g}); main-path launches "
        f"{json.dumps(fam_launches)}, segment_sum per op "
        f"{json.dumps(per_op)}; rows round trip launches "
        f"{json.dumps(row_launches)}")
    log("  op ms (kernels / plain, fwd+bwd synchronized): " + "; ".join(
        f"{k} {v['kernels_ms']:.2f}/{v['plain_ms']:.2f}"
        for k, v in op_ms.items()) + f" ({card})")
    for what, r in streams.items():
        log(f"  segment_sum ({what}, {r['num_segments']} bins): plain "
            f"{r['plain_ms']:.4f} ms ({card})")
        log_pool_timing(f"segment_sum ({what})", r, card)
    for r in rows_out:
        log(f"  {r['name']}: {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} "
            f"ms, library {r['library_ms']:.4f} ms, bound "
            f"{r['bound_ms'] * 1e3:.2f} us ({card})")
    for name, t in dma_t.items():
        log_copy_timing(name, t, "index_copy_" if name.startswith("scatter")
                        else "index_select", card)
    return [ss] + rows_out


LIFE_THRESHOLD = 5.0            # phase 9: shrink's delete threshold


def _batch_keys(batches):
    """The real keys of ``batches`` and each key's slot."""
    keys = np.concatenate([b.keys[:b.num_keys] for b in batches])
    slots = np.concatenate([(b.segments[:b.num_keys] % b.num_slots)
                            for b in batches]).astype(np.int16)
    return keys, slots


def _life_run(torch, args, cfg, ops, batches, base_path, save_path):
    """One run of phase 9 with ``cfg`` through ``ops`` (KERNELS or
    PLAIN): load the train base; train batches 0-1; save_base; shrink;
    a flag-on bulk assignment (must degrade: the kv has holes);
    merge_model of the save; train batches 2-3; a flag-on bulk
    assignment of the other batches' keys (must run on the card: the
    merge refilled every hole). Returns what the comparison reads."""
    from paddlebox_tpu_torch import DeepFM, EmbeddingTable
    from paddlebox_tpu_torch.config import flags_scope
    from paddlebox_tpu_torch.device import seeded_generator
    from paddlebox_tpu_torch.metrics import init_auc_state
    from paddlebox_tpu_torch.ops import index as IX
    from paddlebox_tpu_torch.train.step import (StepState, TrainStep,
                                                default_tx,
                                                make_device_batch)
    cuda = torch.device("cuda")
    secs = {}

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
        return out

    t = EmbeddingTable(mf_dim=MF_DIM, capacity=CAPACITY, cfg=cfg,
                       seed=args.seed, device="cuda")
    timed("load_s", lambda: t.load(base_path))
    require_native("lifecycle", t)
    torch.manual_seed(args.seed + 2)
    model = DeepFM(NUM_SLOTS, 3 + MF_DIM, DENSE_DIM, hidden=HIDDEN,
                   compute_dtype=torch.float32).to(cuda)
    st = StepState(table=t.state, model=model,
                   opt=default_tx(model.parameters()),
                   auc=init_auc_state(device=cuda))
    step = TrainStep(cfg, BATCH, NUM_SLOTS, ops=ops)
    losses = []

    def train(bs, first):
        for i, b in enumerate(bs, start=first):
            dv = make_device_batch(b, t.prepare(b), cuda)
            stats = step(st, dv, seeded_generator(cuda, args.seed + 1, i))
            losses.append(float(stats["loss"]))

    def rows_t(rows):
        return torch.from_numpy(rows.astype(np.int64)).to(cuda)

    timed("train_2_s", lambda: train(batches[0:2], 1))
    mid_rows = np.nonzero(t._touched)[0]
    mid = t.state.data[rows_t(mid_rows)].clone()
    n_saved = timed("save_base_s", lambda: t.save_base(save_path))
    keys0, rows0 = t.index.items()
    n_freed = timed("shrink_s", lambda: t.shrink(LIFE_THRESHOLD))
    freed_rows = np.sort(rows0[t.index.lookup(keys0) < 0])
    if n_freed != len(freed_rows) or not 0 < n_freed < len(keys0):
        raise AssertionError(f"lifecycle: shrink freed {n_freed} of "
                             f"{len(keys0)} rows ({len(freed_rows)} gone)")
    if bool(t.state.data[rows_t(freed_rows)].any()):
        raise AssertionError("lifecycle: a freed row is not zero")
    after_shrink = t.feature_count

    def flag_on_assign(bs):
        keys, slots = _batch_keys(bs)
        ticks0 = dict(IX.DISPATCH)
        with flags_scope(use_pallas_index=True):
            t.bulk_assign_unique(keys, slots)
        return {k[1]: v - ticks0.get(k, 0) for k, v in IX.DISPATCH.items()
                if k[0] == "index.assign" and v != ticks0.get(k, 0)}

    ticks = timed("degraded_assign_s", lambda: flag_on_assign(batches[2:4]))
    dev = t._dev_index
    if not dev.degraded or ticks != {"host": 1}:
        raise AssertionError(f"lifecycle: the bulk assignment after the "
                             f"shrink did not degrade ({ticks})")
    degrade_reason = dev.degrade_reason
    n_merged = timed("merge_model_s", lambda: t.merge_model(save_path))
    if n_merged != n_saved or not (t.index.lookup(keys0) >= 0).all():
        raise AssertionError("lifecycle: merge_model did not bring every "
                             "saved key back")
    timed("train_2_more_s", lambda: train(batches[2:4], 3))
    ticks = timed("device_assign_s", lambda: flag_on_assign(batches[4:]))
    dev = t._dev_index
    keys, rows = t.index.items()
    if dev.degraded or ticks != {"device": 1} \
            or not np.array_equal(dev.lookup_rows(keys), rows):
        raise AssertionError(f"lifecycle: the bulk assignment after the "
                             f"merge did not run on the card ({ticks}, "
                             f"{dev.degrade_reason})")
    if not np.isfinite(losses).all():
        raise AssertionError(f"lifecycle: non-finite loss {losses}")
    return {"table": t, "model": model, "losses": losses,
            "mid_rows": mid_rows, "mid": mid, "freed_rows": freed_rows,
            "n_saved": n_saved, "n_freed": n_freed,
            "after_shrink": after_shrink, "n_merged": n_merged,
            "feature_count": t.feature_count, "digest": t.rows_digest(),
            "degrade_reason": degrade_reason, "secs": secs}


def _row13_vec1(torch, t, batch, flush, gen):
    """Row 13's scalar (vec = 1) branch at an Adam row width, and the
    Adam pull (row 1 at that width), on copies of the table at the push's
    shapes (batch 0's unique rows): each exact against its plain version,
    timed as phase 3 times them."""
    from paddlebox_tpu_torch.ops import kernels as K
    from paddlebox_tpu_torch.train.step import make_device_batch
    dv = make_device_batch(batch, t.prepare_eval(batch), torch.device(
        "cuda"))
    rows = dv.unique_rows.contiguous()
    u_pad, width = rows.shape[0], t.state.feat
    u_real = int(((rows >= 0) & (rows < CAPACITY)).sum())
    if width % 4 == 0:
        raise AssertionError(f"row width {width} takes the vec = 4 branch")
    got = K.gather_rows(t.state.data, rows)
    if not torch.equal(got, K.gather_rows_plain(t.state.data, rows)):
        raise AssertionError(f"gather_rows at width {width} differs from "
                             f"its plain version")
    deltas = torch.randn((u_pad, width), generator=gen,
                         device="cuda") * 1e-3
    vals_k = t.state.data[:CAPACITY].clone()
    vals_p = vals_k.clone()
    K.scatter_add_update(vals_k, rows, deltas)
    K.scatter_add_update_plain(vals_p, rows, deltas)
    torch.cuda.synchronize()
    if not torch.equal(vals_k, vals_p):
        raise AssertionError(f"scatter_add_update (vec = 1, width "
                             f"{width}) differs from its plain version")
    kept = (rows >= 0) & (rows < CAPACITY)
    rows_kept, deltas_kept = rows[kept].long(), deltas[kept]
    out = {"width": width, "u_pad": u_pad, "u_real": u_real,
           "scatter_add_update": {
               "ms": time_ms(torch, lambda: K.scatter_add_update(
                   vals_k, rows, deltas), flush),
               "plain_ms": time_ms(torch, lambda: K.scatter_add_update_plain(
                   vals_p, rows, deltas), flush),
               "library_ms": time_ms(torch, lambda: vals_p.index_add_(
                   0, rows_kept, deltas_kept), flush),
               "bound_ms": (u_pad * 4 + u_real * 3 * width * 4)
               / PEAK_BYTES * 1e3},
           "gather_rows": {
               "ms": time_ms(torch, lambda: K.gather_rows(t.state.data,
                                                          rows), flush),
               "plain_ms": time_ms(torch, lambda: K.gather_rows_plain(
                   t.state.data, rows), flush),
               "bound_ms": (2 * u_real * width * 4 + u_pad * 4)
               / PEAK_BYTES * 1e3}}
    del vals_k, vals_p
    return out


def lifecycle_phase(torch, args, card, batches, flush, details):
    """Phase 9: the table lifecycle with each sparse Adam config on the
    ragged cell at full width (see the module docstring). Returns each
    path kernel's launches in the kernel runs."""
    from paddlebox_tpu_torch import convert
    from paddlebox_tpu_torch.ops import index as IX
    from paddlebox_tpu_torch.ops import kernels as K
    from paddlebox_tpu_torch.ps.sgd import SparseAdamConfig
    if len(batches) < 5:
        raise AssertionError("phase 9 needs at least 5 batches")
    fns = {"gather_rows": K.gather_rows, "pool_cvm": K.pool_cvm,
           "segment_gather": K.segment_gather,
           "scatter_add_update": K.scatter_add_update,
           "index_insert": IX.insert, "index_lookup": IX.lookup}
    base = make_table_blob(np.random.default_rng(args.seed + 1), convert,
                           vocab=TRAIN_BASE_VOCAB, no_mf=0.25)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed + 9)
    out, total = {}, {name: 0 for name in fns}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "life_base.npz")
        np.savez(path, **base)
        del base
        for shared in (False, True):
            cfg = SparseAdamConfig(shared=shared)
            name = "shared_adam" if shared else "adam"
            for fn in fns.values():
                fn.launches = 0
            rk = _life_run(torch, args, cfg, K.KERNELS, batches, path,
                           os.path.join(tmp, f"{name}_k.npz"))
            launches = {n: fn.launches for n, fn in fns.items()}
            # four steps; the insert: the device index's seed and assign
            want = {n: 4 for n in fns}
            want.update(index_insert=2, index_lookup=1)
            if launches != want:
                raise AssertionError(f"lifecycle {name}: launches "
                                     f"{launches}, expected {want}")
            for n, v in launches.items():
                total[n] += v
            rp = _life_run(torch, args, cfg, K.PLAIN, batches, path,
                           os.path.join(tmp, f"{name}_p.npz"))
            if not np.array_equal(rk["mid_rows"], rp["mid_rows"]):
                raise AssertionError(f"lifecycle {name}: the runs touched "
                                     f"other rows")
            mid_err = check_close(f"lifecycle {name}: rows after 2 steps",
                                  rk["mid"], rp["mid"], STATE_RTOL,
                                  STATE_ATOL)
            tk, tp = rk["table"], rp["table"]
            keys, rows = tk.index.items()
            rows_d = torch.from_numpy(rows.astype(np.int64)).to("cuda")
            rows_p = torch.from_numpy(tp.index.lookup(keys).astype(
                np.int64)).to("cuda")
            row_err = check_close(f"lifecycle {name}: rows after 4 steps",
                                  tk.state.data[rows_d],
                                  tp.state.data[rows_p], STATE_RTOL,
                                  STATE_ATOL)
            pk, pp = rk["model"].state_dict(), rp["model"].state_dict()
            param_err = max(check_close(f"lifecycle {name}: {k}", pk[k],
                                        pp[k], STATE_RTOL, STATE_ATOL)
                            for k in pk)
            for what in ("n_freed", "feature_count", "digest"):
                if rk[what] != rp[what]:
                    raise AssertionError(f"lifecycle {name}: {what} "
                                         f"{rk[what]} (kernels) vs "
                                         f"{rp[what]} (plain)")
            if not np.array_equal(rk["freed_rows"], rp["freed_rows"]):
                raise AssertionError(f"lifecycle {name}: other rows freed")
            r13 = _row13_vec1(torch, tk, batches[0], flush, gen)
            sa, gr = r13["scatter_add_update"], r13["gather_rows"]
            secs = {k: round(v, 3) for k, v in rk["secs"].items()}
            log(f"lifecycle {name} (row width {r13['width']}): 4 steps, "
                f"losses {[round(x, 4) for x in rk['losses']]}; "
                f"save_base {rk['n_saved']} rows, shrink (threshold "
                f"{LIFE_THRESHOLD}) freed {rk['n_freed']} "
                f"({rk['n_freed'] / rk['n_saved']:.1%}), post-shrink "
                f"flag-on assignment degraded ({rk['degrade_reason']}), "
                f"merge_model {rk['n_merged']} rows, feature_count "
                f"{rk['feature_count']}, post-merge flag-on assignment on "
                f"the card; launches {json.dumps(launches)}; kernels vs "
                f"plain: max abs err rows {mid_err:.3g} / {row_err:.3g}, "
                f"params {param_err:.3g}, freed rows, feature_count and "
                f"rows_digest equal; host s {json.dumps(secs)} ({card})")
            log(f"  row 13 vec = 1 at width {r13['width']} (U {r13['u_pad']}"
                f", {r13['u_real']} real) exact: {sa['ms']:.4f} ms, plain "
                f"{sa['plain_ms']:.4f} ms, index_add_ {sa['library_ms']:.4f}"
                f" ms, bound {sa['bound_ms'] * 1e3:.2f} us; row 1 at that "
                f"width exact: {gr['ms']:.4f} ms, plain {gr['plain_ms']:.4f}"
                f" ms, bound {gr['bound_ms'] * 1e3:.2f} us ({card})")
            out[name] = {
                "launches": launches, "losses_kernels": rk["losses"],
                "losses_plain": rp["losses"], "n_saved": rk["n_saved"],
                "n_freed": rk["n_freed"],
                "after_shrink": rk["after_shrink"],
                "n_merged": rk["n_merged"],
                "feature_count": rk["feature_count"],
                "digest": rk["digest"],
                "degrade_reason": rk["degrade_reason"],
                "mid_max_abs_err": mid_err, "row_max_abs_err": row_err,
                "param_max_abs_err": param_err, "secs_kernels": rk["secs"],
                "secs_plain": rp["secs"], "row13_vec1": r13}
            del rk, rp, tk, tp, rows_d, rows_p
            torch.cuda.empty_cache()
    details["lifecycle"] = out
    return total


CKPT_EVERY = 3                   # phase 10: cursor checkpoint cadence
CKPT_PREEMPT = 5                 # phase 10: run B stops at this batch
CKPT_METRICS = (                 # phase 10: the registry the passes feed
    ("auc", "auc", {}),
    ("cmatch_rank", "cmatch_rank_auc", {"cmatch_rank_group": "222:1,223:2"}))
CKPT_SERVE_BATCHES = 2           # phase 10: batches each model predicts


def _timed(log_to: list, fn):
    """``fn`` wrapped to append each call's wall seconds to ``log_to``."""
    def run(*a, **kw):
        t0 = time.perf_counter()
        try:
            return fn(*a, **kw)
        finally:
            log_to.append(time.perf_counter() - t0)
    return run


def checkpoint_phase(torch, args, card, desc, records, batches, details,
                     dev: str = "cuda") -> dict:
    """Phase 10: checkpoint, preemption resume and publishing on the
    training side, adoption and hot reload on the serving side, at
    phase 5's width, under ``torch.use_deterministic_algorithms``. The
    passes feed a metric registry (side channels drawn from the seed),
    which rides the cursor checkpoints. Returns the four step kernels'
    launches in the phase's main path."""
    import dataclasses
    import shutil

    from paddlebox_tpu_torch import (ArtifactStore, CheckpointManager,
                                     DeepFM, EmbeddingTable,
                                     InMemoryDataset, ReloadLoop,
                                     ServingModel, Trainer, convert)
    from paddlebox_tpu_torch.config import flags_scope
    from paddlebox_tpu_torch.ops import kernels as K
    from paddlebox_tpu_torch.resilience import preemption
    from paddlebox_tpu_torch.resilience.faults import FaultPlan, installed
    from paddlebox_tpu_torch.resilience.preemption import PreemptedError
    from paddlebox_tpu_torch.train.checkpoint import state_digest
    from paddlebox_tpu_torch.train.step import ctr_forward, make_device_batch

    if len(batches) <= CKPT_PREEMPT:
        raise AssertionError(f"phase 10 needs more than {CKPT_PREEMPT} "
                             "batches")
    sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)
    t_phase = time.perf_counter()
    base = make_table_blob(np.random.default_rng(args.seed + 1), convert,
                           vocab=TRAIN_BASE_VOCAB, no_mf=0.25)
    side = np.random.default_rng(args.seed + 3)
    n_rec = len(records)
    uid = side.integers(0, 1 << 20, n_rec)
    rank = side.integers(1, 4, n_rec)
    cmatch = side.choice([222, 223], n_rec)
    records = [dataclasses.replace(r, uid=int(u), rank=int(k), cmatch=int(c))
               for r, u, k, c in zip(records, uid, rank, cmatch)]
    fns = (K.gather_rows, K.pool_cvm, K.segment_gather, K.scatter_add_update)
    torch.use_deterministic_algorithms(True)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            base_path = os.path.join(tmp, "train_base.npz")
            np.savez(base_path, **base)
            n_base = len(base["keys"])
            del base
            saves: list = []

            def trainer(load=True):
                t = EmbeddingTable(mf_dim=MF_DIM, capacity=CAPACITY,
                                   seed=args.seed, device=dev)
                if load:          # a trainer about to restore needs none
                    t.load(base_path)
                t.save_base = _timed(saves, t.save_base)
                t.save_delta = _timed(saves, t.save_delta)
                torch.manual_seed(args.seed + 2)
                model = DeepFM(NUM_SLOTS, 3 + MF_DIM, DENSE_DIM,
                               hidden=HIDDEN)
                tr = Trainer(model, t, desc, seed=args.seed, device=dev)
                for name, method, kw in CKPT_METRICS:
                    tr.metrics.init_metric(name, method, **kw)
                return tr

            def dataset():
                ds = InMemoryDataset(desc)
                ds.records = records
                return ds

            store = ArtifactStore(os.path.join(tmp, "store"))
            root_a = os.path.join(tmp, "ckpt_a")
            root_b = os.path.join(tmp, "ckpt_b")
            t = {}
            for fn in fns:
                fn.launches = 0
            # ---- run A: uninterrupted, publishing its boundaries ----
            tr_a = trainer()
            cm_a = CheckpointManager(root_a, artifacts=store)
            t0 = time.perf_counter()
            cm_a.save(tr_a)                          # step-0 base
            t["base_save_s"] = time.perf_counter() - t0
            t["save_base_s"] = saves[-1]
            # the same rows through uncompressed np.savez, for comparison
            keys, rows = tr_a.table.index.items()
            blob = tr_a.table._gather_host(rows)
            path = os.path.join(tmp, "plain.npz")
            t0 = time.perf_counter()
            np.savez(path, keys=keys, **blob)
            t["savez_uncompressed_s"] = time.perf_counter() - t0
            t["savez_uncompressed_mb"] = os.path.getsize(path) / 2**20
            t["save_base_mb"] = os.path.getsize(os.path.join(
                cm_a._dir(0), "sparse.npz")) / 2**20
            rows_saved = len(keys)
            os.unlink(path)
            del blob, keys, rows
            with flags_scope(ckpt_every_batches=CKPT_EVERY):
                n_saves = len(saves)
                t0 = time.perf_counter()
                res_a = tr_a.run_pass(dataset(), checkpoint=cm_a)
                sync()
                t["run_a_s"] = time.perf_counter() - t0
                t["run_a_saves_s"] = saves[n_saves:]
            v_base, v_tip = store.versions()
            # ---- run B: preempted at batch 5, resumed by new objects ----
            # B is run A restarted from its step-3 cursor checkpoint (a
            # copy of A's step-0 base and step-3 delta: the states B
            # would have written), so it restores a chain, resumes, and
            # is preempted at batch 5, its second batch boundary
            os.makedirs(root_b)
            for step in (0, CKPT_EVERY):
                shutil.copytree(cm_a._dir(step), os.path.join(
                    root_b, os.path.basename(cm_a._dir(step))))
            with flags_scope(ckpt_every_batches=CKPT_EVERY):
                tr_b = trainer(load=False)
                cm_b = CheckpointManager(root_b)
                t0 = time.perf_counter()
                if cm_b.restore(tr_b) != CKPT_EVERY:
                    raise AssertionError("run B did not restore step "
                                         f"{CKPT_EVERY}")
                sync()
                t["restore_b_s"] = time.perf_counter() - t0
                plan = FaultPlan.parse("preempt.signal:fail:nth="
                                       f"{CKPT_PREEMPT - CKPT_EVERY}")
                n_saves = len(saves)
                try:
                    with installed(plan):
                        tr_b.run_pass(dataset(), checkpoint=cm_b)
                    raise AssertionError("run B was not preempted")
                except PreemptedError as e:
                    if not e.checkpointed or e.batch_index != CKPT_PREEMPT:
                        raise AssertionError(
                            f"preemption: checkpointed {e.checkpointed}, "
                            f"batch {e.batch_index}") from e
                t["preempt_saves_s"] = saves[n_saves:]
                preemption.clear_stop()
                del tr_b, cm_b
            # the resumed pass's cursor save would fall on its last batch,
            # where the closing boundary save writes the same step again:
            # the resume runs without the cadence and saves once
            with flags_scope(ckpt_every_batches=0):
                tr_r = trainer(load=False)
                cm_r = CheckpointManager(root_b)
                t0 = time.perf_counter()
                cm_r.verify(CKPT_PREEMPT)
                t["verify_s"] = time.perf_counter() - t0
                t0 = time.perf_counter()
                restored = cm_r.restore(tr_r)
                sync()
                t["restore_s"] = time.perf_counter() - t0
                if restored != CKPT_PREEMPT:
                    raise AssertionError(f"restored step {restored}")
                t0 = time.perf_counter()
                res_r = tr_r.run_pass(dataset(), checkpoint=cm_r)
                sync()
                t["resume_s"] = time.perf_counter() - t0
            if res_r["batches"] != len(batches) - CKPT_PREEMPT:
                raise AssertionError(f"resume trained {res_r['batches']} "
                                     "batches")
            # ---- serving: adopt the base, hot-reload the delta ----
            def serving():
                return ServingModel(DeepFM(NUM_SLOTS, 3 + MF_DIM, DENSE_DIM,
                                           hidden=HIDDEN), desc,
                                    mf_dim=MF_DIM, capacity=CAPACITY,
                                    device=dev)

            probe = batches[:CKPT_SERVE_BATCHES]
            srv = serving()
            t0 = time.perf_counter()
            srv.adopt(store, version=v_base)
            sync()
            t["adopt_base_s"] = time.perf_counter() - t0
            pred_base = [srv.predict(b) for b in probe]
            t0 = time.perf_counter()
            if srv.hot_reload(store) != v_tip:
                raise AssertionError("hot_reload did not reach the tip")
            sync()
            t["hot_reload_s"] = time.perf_counter() - t0
            if srv.last_load["applied"] != [v_tip] or \
                    srv.last_load["start"] != 1:
                raise AssertionError(f"hot_reload applied "
                                     f"{srv.last_load}, not the delta")
            pred_hot = [srv.predict(b) for b in probe]
            fresh = serving()
            t0 = time.perf_counter()
            fresh.adopt(store)
            sync()
            t["adopt_tip_s"] = time.perf_counter() - t0
            pred_fresh = [fresh.predict(b) for b in probe]
            if ReloadLoop(srv, store).poll_once() is not None:
                raise AssertionError("a poll of a current store adopted")
            sync()
            launches = {fn.__name__: fn.launches for fn in fns}
            # ---- checks (outside the counted path) ----
            for name, n in launches.items():
                if n == 0:
                    raise AssertionError(f"phase 10: {name} never launched")
            d_a, d_r = state_digest(tr_a), state_digest(tr_r)
            if d_a != d_r:
                raise AssertionError(f"resumed digest {d_r[:16]} != "
                                     f"uninterrupted {d_a[:16]}")
            msgs = {}
            for name, _, _ in CKPT_METRICS:
                m_a = tr_a.metrics.get_metric_msg(name)
                m_r = tr_r.metrics.get_metric_msg(name)
                if m_a != m_r or not m_a["ins_num"] > 0:
                    raise AssertionError(f"metric {name}: resumed {m_r} != "
                                         f"uninterrupted {m_a}")
                msgs[name] = m_a
            for h, f in zip(pred_hot, pred_fresh):
                if not np.array_equal(h, f):
                    raise AssertionError("hot-reloaded predictions differ "
                                         "from a fresh adoption's")
            err = 0.0
            with torch.inference_mode():
                for b, h in zip(probe, pred_hot):
                    ix = tr_a.table.prepare_eval(b)
                    want, _ = ctr_forward(
                        tr_a.state.table, tr_a.model,
                        make_device_batch(b, ix, tr_a.device), BATCH,
                        NUM_SLOTS)
                    err = max(err, float(np.abs(
                        h - want.cpu().numpy()).max()))
            if err > PRED_ATOL:
                raise AssertionError(f"served predictions differ from "
                                     f"trainer A's by {err:.3g}")
            moved = max(float(np.abs(a - b).max())
                        for a, b in zip(pred_base, pred_hot))
            if moved == 0.0:
                raise AssertionError("the hot reload changed no prediction")
            del srv, fresh
    finally:
        torch.use_deterministic_algorithms(False)
    t["phase_s"] = time.perf_counter() - t_phase
    log(f"checkpoint: phase 10 took {t['phase_s']:.1f}s; {n_base} base rows; run A {res_a['batches']} steps "
        f"with cursor saves every {CKPT_EVERY}; run B preempted at batch "
        f"{CKPT_PREEMPT}, restored and resumed {res_r['batches']} steps by "
        f"new objects: state_digest equal ({d_a[:16]}), deterministic "
        f"algorithms on; metric messages equal (auc, ins_num) "
        f"{json.dumps({k: (v['auc'], v['ins_num']) for k, v in msgs.items()})}"
        f"; launches {json.dumps(launches)}")
    log(f"checkpoint times: save_base {t['save_base_s']:.2f}s "
        f"({rows_saved} rows, {t['save_base_mb']:.0f} MiB compressed) vs "
        f"np.savez of the same blob {t['savez_uncompressed_s']:.2f}s "
        f"({t['savez_uncompressed_mb']:.0f} MiB); step-0 checkpoint + "
        f"publish {t['base_save_s']:.2f}s; run A {t['run_a_s']:.2f}s "
        f"(sparse saves {[round(x, 2) for x in t['run_a_saves_s']]} s); "
        f"run B: restore at step {CKPT_EVERY} {t['restore_b_s']:.2f}s, "
        f"emergency save {[round(x, 2) for x in t['preempt_saves_s']]} s; "
        f"verify "
        f"{t['verify_s']:.2f}s, restore {t['restore_s']:.2f}s, resume "
        f"{t['resume_s']:.2f}s ({card})")
    log(f"serve reload: adopt base {t['adopt_base_s']:.2f}s, hot_reload "
        f"(the delta only) {t['hot_reload_s']:.2f}s, adopt tip fresh "
        f"{t['adopt_tip_s']:.2f}s; hot-reloaded == fresh adoption bit for "
        f"bit, max |served - trainer A| {err:.3g} ({card})")
    details["checkpoint"] = dict(t, digest=d_a, launches=launches,
                                 metrics=msgs,
                                 pred_max_abs_err=err, rows=rows_saved,
                                 run_a=res_a, resumed=res_r)
    return launches


PIPE_PASSES = 4                  # phase 11: passes of the --batches batches
PIPE_ARENA_SLOTS = NUM_SLOTS     # phase 11 config A: bench.py's arena lane
PIPE_UNIQUE_MIN = 4096           # phase 11: bench.py's unique_bucket_min


def _same_front(a, b) -> bool:
    """The record front and the columnar front agree: every batch's keys,
    slots, pad segment and segments, the float block, the layout and the
    record count (the key capacity is each front's own ladder)."""
    if len(a[0]) != len(b[0]) or a[3:5] != b[3:5]:
        return False
    if not np.array_equal(a[1], b[1]):
        return False
    for x, y in zip(a[0], b[0]):
        if not (np.array_equal(x[0], y[0]) and np.array_equal(x[1], y[1])
                and x[3] == y[3]
                and (x[4] is None) == (y[4] is None)
                and (x[4] is None or np.array_equal(x[4], y[4]))):
            return False
    return True


def pipeline_phase(torch, args, card, desc, records, details,
                   dev: str = "cuda") -> dict:
    """Phase 11: the pipelined resident passes at phase 5's width
    (``Trainer.train_passes_resident`` over ``PassPreloader``), three
    configs, each again at depth 0 from the same start, under
    deterministic algorithms. Returns the kernels' launches in the three
    depth-2 runs (the phase's main path)."""
    import logging

    from paddlebox_tpu_torch import (DeepFM, EmbeddingTable,
                                     InMemoryDataset, Trainer, convert)
    from paddlebox_tpu_torch.config import flags_scope
    from paddlebox_tpu_torch.ops import index as IX
    from paddlebox_tpu_torch.ops import kernels as K
    from paddlebox_tpu_torch.ps.sgd import SparseSGDConfig
    from paddlebox_tpu_torch.train.checkpoint import state_digest
    from paddlebox_tpu_torch.train.device_pass import ResidentPass
    from paddlebox_tpu_torch.train.step import TrainStep

    sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)
    t_phase = time.perf_counter()
    per = len(records) // PIPE_PASSES
    if per % BATCH or per == 0:
        raise AssertionError("phase 11 cuts the batches into "
                             f"{PIPE_PASSES} passes of whole batches")
    recs = [records[i * per:(i + 1) * per] for i in range(PIPE_PASSES)]

    def datasets():
        out = []
        for r in recs:
            ds = InMemoryDataset(desc)
            ds.records = r
            ds.columnarize()
            out.append(ds)
        return out

    passes = datasets()
    base = make_table_blob(np.random.default_rng(args.seed + 1), convert,
                           vocab=TRAIN_BASE_VOCAB, no_mf=0.25)
    step_fns = {"gather_rows": K.gather_rows, "pool_cvm": K.pool_cvm,
                "segment_gather": K.segment_gather,
                "scatter_add_update": K.scatter_add_update,
                "index_insert": IX.insert, "index_lookup": IX.lookup}
    fallbacks = []

    class _Fallbacks(logging.Handler):
        def emit(self, record):
            if "compact wire unavailable" in record.getMessage():
                fallbacks.append(record.getMessage())

    watch = _Fallbacks()
    logging.getLogger("paddlebox_tpu_torch.train.device_pass").addHandler(
        watch)
    out = {}
    launches = {k: 0 for k in step_fns}
    torch.use_deterministic_algorithms(True)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            base_path = os.path.join(tmp, "train_base.npz")
            np.savez(base_path, **base)
            del base

            def trainer(arena: bool, f32: bool = False, ops=None):
                cfg = (SparseSGDConfig(mf_initial_range=0.0) if f32
                       else None)
                t = EmbeddingTable(
                    mf_dim=MF_DIM, capacity=CAPACITY, cfg=cfg,
                    seed=args.seed, unique_bucket_min=PIPE_UNIQUE_MIN,
                    device=dev,
                    arena_slots=PIPE_ARENA_SLOTS if arena else None)
                t.load(base_path)
                torch.manual_seed(args.seed + 2)
                kw = {"compute_dtype": torch.float32} if f32 else {}
                model = DeepFM(NUM_SLOTS, 3 + MF_DIM, DENSE_DIM,
                               hidden=HIDDEN, **kw)
                tr = Trainer(model, t, desc, seed=args.seed,
                             check_nan_inf=True, device=dev)
                if ops is not None:
                    tr.step_fn = TrainStep(t.cfg, BATCH, NUM_SLOTS, ops=ops)
                return tr

            def run(tr, depth, floats, main=False):
                """One train_passes_resident run; each pass's wire, formats,
                staged and host bytes and build stages are read from the
                pass as it reaches train_pass_resident."""
                seen = []
                inner = tr.train_pass_resident

                def spy(rp, **kw):
                    host = (rp.uniq.nbytes + rp.gidx.nbytes
                            + rp.floats.size * 4
                            + (0 if rp.segs is None else rp.segs.nbytes))
                    seen.append({"wire": rp.wire, "formats": rp.formats,
                                 "staged_bytes": rp.nbytes(),
                                 "host_bytes": host,
                                 "build_stats": dict(rp.build_stats)})
                    return inner(rp, **kw)

                tr.train_pass_resident = spy
                start = tr.table.state.data.clone() if main else None
                sync()
                if main:
                    for fn in step_fns.values():
                        fn.launches = 0
                t0 = time.perf_counter()
                res = tr.train_passes_resident(passes, depth=depth,
                                               floats_dtype=floats)
                sync()
                wall = time.perf_counter() - t0
                got = ({k: fn.launches for k, fn in step_fns.items()}
                       if main else None)
                del tr.train_pass_resident
                steps = sum(r["batches"] for r in res)
                n_ex = sum(r["examples"] for r in res)
                if (len(res) != PIPE_PASSES
                        or not all(np.isfinite(r["last_loss"]) for r in res)):
                    raise AssertionError(f"pipeline run went wrong: {res}")
                if main:
                    for k in ("gather_rows", "pool_cvm", "segment_gather",
                              "scatter_add_update"):
                        if got[k] != steps:
                            raise AssertionError(
                                f"pipeline: {k} launched {got[k]} times for "
                                f"{steps} steps")
                    data = tr.table.state.data
                    if bool(data[CAPACITY].any()):
                        raise AssertionError("pipeline: the sentinel row "
                                             "was written")
                    touched = torch.from_numpy(tr.table._touched).to(
                        data.device)
                    changed = (data != start).any(dim=1)
                    if bool((changed & ~touched).any()):
                        raise AssertionError("pipeline: rows no pass "
                                             "touched changed")
                    del start, changed, touched
                return {"res": res, "passes": seen, "wall_s": wall,
                        "examples_per_sec": n_ex / wall, "launches": got,
                        "digest": state_digest(tr)}

            def free(*trs):
                for tr in trs:
                    del tr.table.state, tr.state
                sync()
                if dev == "cuda":
                    torch.cuda.empty_cache()

            # ---- config A: bench.py's resident lane (compact, q8) ----
            tr = trainer(arena=True)
            out["A"] = {"depth2": run(tr, 2, "q8", main=True)}
            free(tr)
            if fallbacks or any(p["wire"] != "compact" or
                                p["formats"]["floats"] != "q8"
                                for p in out["A"]["depth2"]["passes"]):
                raise AssertionError(f"config A left the compact q8 wire: "
                                     f"{fallbacks}")
            tr = trainer(arena=True)
            out["A"]["depth0"] = run(tr, 0, "q8")
            free(tr)
            # kernels against the plain versions: f32 tower, no mf draws
            tk_, tp_ = (trainer(arena=True, f32=True),
                        trainer(arena=True, f32=True, ops=K.PLAIN))
            run(tk_, 2, "q8")
            run(tp_, 2, "q8")
            rows_t = torch.from_numpy(np.nonzero(
                tk_.table._touched | tp_.table._touched)[0]).to(dev)
            row_err = check_close("pipeline A: touched rows, kernels vs "
                                  "plain", tk_.table.state.data[rows_t],
                                  tp_.table.state.data[rows_t], STATE_RTOL,
                                  STATE_ATOL)
            pk, pp = tk_.model.state_dict(), tp_.model.state_dict()
            param_err = max(check_close(f"pipeline A: dense param {k}",
                                        pk[k], pp[k], STATE_RTOL, STATE_ATOL)
                            for k in pk)
            out["A"].update(row_max_abs_err=row_err,
                            param_max_abs_err=param_err)
            free(tk_, tp_)
            del rows_t, pk, pp

            # ---- config B: the dedup wire, device key index, f32 ----
            # the thread of each index call that inserts (the seed's and
            # each build's), recorded around the index's own methods
            threads = []
            calls = {n: getattr(IX.DeviceKeyIndex, n)
                     for n in ("assign_unique", "assign_raw")}

            def on_thread(fn):
                def call(self, *a, **kw):
                    threads.append(threading.current_thread().name)
                    return fn(self, *a, **kw)
                return call

            with flags_scope(use_pallas_index=True):
                for n, fn in calls.items():
                    setattr(IX.DeviceKeyIndex, n, on_thread(fn))
                try:
                    tr = trainer(arena=False)
                    out["B"] = {"depth2": run(tr, 2, np.float32, main=True)}
                finally:
                    for n, fn in calls.items():
                        setattr(IX.DeviceKeyIndex, n, fn)
                devi = tr.table._dev_index
                keys, rows = tr.table.index.items()
                IX.lookup.launches = 0
                mirror = devi.lookup_rows(keys)
                out["B"]["depth2"]["launches"]["index_lookup"] = \
                    IX.lookup.launches
                if devi.degraded:
                    raise AssertionError(f"pipeline B: the device key index "
                                         f"degraded: {devi.degrade_reason}")
                if not np.array_equal(mirror, rows.astype(np.int64)):
                    raise AssertionError("pipeline B: the device index does "
                                         "not mirror the kv")
                ins = out["B"]["depth2"]["launches"]["index_insert"]
                if (ins != 1 + PIPE_PASSES or len(threads) != ins
                        or any(t != "pbx-preload" for t in threads)):
                    raise AssertionError(
                        f"pipeline B: insert launched {ins} times from "
                        f"threads {threads}, expected the seed and one per "
                        f"build, all on the preload worker")
                free(tr)
                del keys, rows, mirror, devi
                tr = trainer(arena=False)
                out["B"]["depth0"] = run(tr, 0, np.float32)
                free(tr)
                tr = trainer(arena=False)
                sync()
                t0 = time.perf_counter()
                for ds in passes:
                    tr.train_pass_resident(ds)
                sync()
                out["B"]["sequential_s"] = time.perf_counter() - t0
                out["B"]["sequential_digest"] = state_digest(tr)
                free(tr)
            if out["B"]["sequential_digest"] != out["B"]["depth2"]["digest"]:
                raise AssertionError("pipeline B: depth 2 differs from four "
                                     "sequential train_pass_resident calls")

            # ---- config C: the dedup wire with bf16 floats ----
            out["C"] = {}
            for depth, name in ((2, "depth2"), (0, "depth0")):
                tr = trainer(arena=False)
                out["C"][name] = run(tr, depth, torch.bfloat16,
                                     main=depth == 2)
                free(tr)
            for cfg in ("A", "B", "C"):
                if out[cfg]["depth2"]["digest"] != \
                        out[cfg]["depth0"]["digest"]:
                    raise AssertionError(f"pipeline {cfg}: depth 2 differs "
                                         f"from depth 0")
                for k, n in out[cfg]["depth2"]["launches"].items():
                    launches[k] += n
            if out["C"]["depth2"]["passes"][0]["formats"]["floats"] != "bf16":
                raise AssertionError("config C did not ship bf16 floats")

            # ---- the record front against the columnar front ----
            rec_ds = InMemoryDataset(desc)
            rec_ds.records = recs[0]
            fronts = {"record": [], "columnar": []}
            outs = {}
            for kind in ("record", "columnar", "columnar", "record"):
                ds = rec_ds if kind == "record" else passes[0]
                t0 = time.perf_counter()
                outs[kind] = ResidentPass._front(ds, np.float32)
                fronts[kind].append(time.perf_counter() - t0)
            if not _same_front(outs["record"], outs["columnar"]):
                raise AssertionError("the columnar front differs from the "
                                     "record front")
            del outs
    finally:
        torch.use_deterministic_algorithms(False)
        logging.getLogger("paddlebox_tpu_torch.train.device_pass") \
            .removeHandler(watch)
    phase_s = time.perf_counter() - t_phase

    for cfg, what in (("A", "compact wire, q8 floats, arena table"),
                      ("B", "dedup wire, f32, device key index"),
                      ("C", "dedup wire, bf16 floats")):
        d2, d0 = out[cfg]["depth2"], out[cfg]["depth0"]
        p0 = d2["passes"][0]
        log(f"pipeline {cfg} ({what}): formats {json.dumps(p0['formats'])}; "
            f"staged {[p['staged_bytes'] for p in d2['passes']]} B a pass "
            f"against host int32/f32 "
            f"{[p['host_bytes'] for p in d2['passes']]} B; depth 2 "
            f"{d2['examples_per_sec']:.0f} examples/s over "
            f"{PIPE_PASSES} passes with their builds ({d2['wall_s']:.3f} s), "
            f"depth 0 {d0['examples_per_sec']:.0f} ({d0['wall_s']:.3f} s); "
            f"state_digest depth 2 == depth 0 ({d2['digest'][:16]}) ({card})")
        log(f"  {cfg} per pass at depth 2: wait s "
            f"{[round(r['preload_wait_sec'], 4) for r in d2['res']]}, build "
            f"stages s "
            + json.dumps([{k: round(v, 4) for k, v in p["build_stats"].items()}
                          for p in d2["passes"]])
            + f"; at depth 0: wait s "
            f"{[round(r['preload_wait_sec'], 4) for r in d0['res']]} "
            f"({card})")
    log(f"pipeline A kernels vs plain (f32 tower, no mf draws): max abs err "
        f"rows {out['A']['row_max_abs_err']:.3g}, params "
        f"{out['A']['param_max_abs_err']:.3g}; B depth 2 == 4 sequential "
        f"train_pass_resident ({out['B']['sequential_s']:.3f} s); B's insert "
        f"on the preload worker {out['B']['depth2']['launches']['index_insert']}"
        f" times (seed + {PIPE_PASSES} builds), lookup mirror exact ({card})")
    log(f"front: record {[round(x, 4) for x in fronts['record']]} s, "
        f"columnar {[round(x, 4) for x in fronts['columnar']]} s for "
        f"{per} records, outputs equal; phase 11 took {phase_s:.1f}s; "
        f"launches {json.dumps(launches)} ({card})")
    details["pipeline"] = dict(out, fronts_s=fronts, phase_s=phase_s,
                               launches=launches)
    return launches


DATA_FILES = 8                   # phase 12: files of BATCH records each
DATA_WINDOW = 2                  # phase 12: files a stream window
DATA_PREEMPT = 5                 # phase 12: the killed stream stops here
DATA_BASE_VOCAB = 9_000          # phase 12: ids of each slot in its base
DATA_THREADS = 8                 # phase 12: the native load's pool


def write_slot_text(path: str, recs) -> int:
    """``recs`` as slot_text lines (label, the dense group with 9
    significant digits — ``strtof`` and ``float`` give back the same
    float32 — then each slot's count and keys); returns the bytes."""
    lines = []
    for r in recs:
        parts = ["1", "%.9g" % r.label, str(len(r.dense)),
                 " ".join("%.9g" % v for v in r.dense.tolist())]
        offs = r.slot_offsets.tolist()
        ks = r.keys.tolist()
        for j in range(len(offs) - 1):
            parts.append(str(offs[j + 1] - offs[j]))
            parts.extend(map(str, ks[offs[j]:offs[j + 1]]))
        lines.append(" ".join(parts))
    text = ("\n".join(lines) + "\n").encode()
    with open(path, "wb") as fh:
        fh.write(text)
    return len(text)


def _same_arrays(what: str, a, b, fields) -> None:
    for f in fields:
        x, y = getattr(a, f), getattr(b, f)
        if x.dtype != y.dtype or not np.array_equal(x, y):
            raise AssertionError(f"{what}: {f} differs")


class _OneBatch:
    """A dataset of one prebuilt batch (the first step, run through the
    kernels and through the plain versions)."""

    def __init__(self, batch) -> None:
        self.batch = batch

    def batches(self, **kw):
        return iter([self.batch])


def data_phase(torch, args, card, desc, records, batches, details,
               dev: str = "cuda") -> dict:
    """Phase 12: the data pipeline and streaming ingest at phase 5's
    width, under ``torch.use_deterministic_algorithms``: phase 5's
    records written to ``DATA_FILES`` slot_text files, loaded natively and
    per line (timed in turns), ``train_pass`` from files against the
    records, the stream scenario (oracle, killed at batch
    ``DATA_PREEMPT``, resumed) and the Criteo walkthrough. Returns the
    step kernels' launches in the phase's main path (the train_pass from
    files, the three streams, the walkthrough)."""
    import hashlib

    from paddlebox_tpu_torch import (CheckpointManager, DeepFM,
                                     EmbeddingTable, InMemoryDataset,
                                     Trainer, convert)
    from paddlebox_tpu_torch.config import flags_scope
    from paddlebox_tpu_torch.data import DataFeedDesc, QueueDataset
    from paddlebox_tpu_torch.data.columnar import ColumnarRecords
    from paddlebox_tpu_torch.data.parser import CriteoParser, SlotTextParser
    from paddlebox_tpu_torch.examples import train_criteo
    from paddlebox_tpu_torch.ops import kernels as K
    from paddlebox_tpu_torch.ps.sgd import SparseSGDConfig
    from paddlebox_tpu_torch.resilience import faults, preemption
    from paddlebox_tpu_torch.resilience.faults import FaultPlan, installed
    from paddlebox_tpu_torch.resilience.preemption import PreemptedError
    from paddlebox_tpu_torch.train.checkpoint import state_digest
    from paddlebox_tpu_torch.train.step import TrainStep

    if len(records) != DATA_FILES * BATCH:
        raise AssertionError(f"phase 12 writes {DATA_FILES} files of "
                             f"{BATCH} records")
    sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)
    t_phase = time.perf_counter()
    step_fns = {"gather_rows": K.gather_rows, "pool_cvm": K.pool_cvm,
                "segment_gather": K.segment_gather,
                "scatter_add_update": K.scatter_add_update}
    launches = {k: 0 for k in step_fns}

    def counted(fn, *a, **kw):
        """``fn`` on the phase's main path: the step kernels' launches
        are zeroed before and added up after."""
        for f in step_fns.values():
            f.launches = 0
        try:
            return fn(*a, **kw)
        finally:
            sync()
            for k, f in step_fns.items():
                launches[k] += f.launches

    base = make_table_blob(np.random.default_rng(args.seed + 1), convert,
                           vocab=DATA_BASE_VOCAB, no_mf=0.25)
    rec_cols = ("keys", "key_slot", "offsets", "dense", "label", "show",
                "clk")
    batch_cols = ("keys", "segments", "dense", "label", "show", "clk")
    t = {}
    preemption.clear_stop()
    faults.clear_plan()
    torch.use_deterministic_algorithms(True)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            base_path = os.path.join(tmp, "data_base.npz")
            np.savez(base_path, **base)
            n_base = len(base["keys"])
            del base

            def trainer(load=True, f32=False, ops=None):
                cfg = SparseSGDConfig(mf_initial_range=0.0) if f32 else None
                tb = EmbeddingTable(mf_dim=MF_DIM, capacity=CAPACITY,
                                    cfg=cfg, seed=args.seed, device=dev)
                if load:
                    tb.load(base_path)
                torch.manual_seed(args.seed + 2)
                kw = {"compute_dtype": torch.float32} if f32 else {}
                tr = Trainer(DeepFM(NUM_SLOTS, 3 + MF_DIM, DENSE_DIM,
                                    hidden=HIDDEN, **kw), tb, desc,
                             seed=args.seed, check_nan_inf=True, device=dev)
                if ops is not None:
                    tr.step_fn = TrainStep(tb.cfg, BATCH, NUM_SLOTS, ops=ops)
                return tr

            def free(*trs):
                for tr in trs:
                    del tr.table.state, tr.state
                sync()
                if dev == "cuda":
                    torch.cuda.empty_cache()

            # ---- 1. the files ----
            data_dir = os.path.join(tmp, "data")
            os.makedirs(data_dir)
            files = [os.path.join(data_dir, f"part-{i:03d}.txt")
                     for i in range(DATA_FILES)]
            t0 = time.perf_counter()
            nbytes = sum(write_slot_text(f, records[i * BATCH:
                                                    (i + 1) * BATCH])
                         for i, f in enumerate(files))
            t["write_s"] = time.perf_counter() - t0

            # ---- 2, 3. native and per-line loads, in turns ----
            loads = {"native": [], "python": []}
            loaded = {}
            for route in ("native", "python", "python", "native"):
                native = route == "native"
                with flags_scope(native_parse=native):
                    ds = InMemoryDataset(desc)
                    ds.set_filelist(files)
                    ds.set_thread(DATA_THREADS if native else 1)
                    t0 = time.perf_counter()
                    ds.load_into_memory()
                    ds.columnarize()
                    loads[route].append(time.perf_counter() - t0)
                if ds.parse_route != route:
                    raise AssertionError(
                        f"the {route} load took the {ds.parse_route} route "
                        f"({ds.parse_route_reason})")
                loaded.setdefault(route, ds)
            want = ColumnarRecords.from_records(records, DENSE_DIM)
            _same_arrays("native load vs the records", loaded["native"]
                         .columnar, want, rec_cols)
            _same_arrays("per-line load vs the native load",
                         loaded["python"].columnar,
                         loaded["native"].columnar, rec_cols)
            del want
            n_b = 0
            for got, ref in zip(loaded["native"].batches(), batches):
                _same_arrays(f"native batch {n_b} vs phase 5's", got, ref,
                             batch_cols)
                n_b += 1
            if n_b != len(batches):
                raise AssertionError(f"native load gave {n_b} batches")
            file_ds = loaded["native"]
            del loaded

            # ---- 4. train once from files, against the records ----
            rec_ds = InMemoryDataset(desc)
            rec_ds.records = records
            tr_f = trainer()
            sync()
            t0 = time.perf_counter()
            res_f = counted(tr_f.train_pass, file_ds)
            t["train_files_s"] = time.perf_counter() - t0
            d_files = state_digest(tr_f)
            free(tr_f)
            tr_r = trainer()
            tr_r.train_pass(rec_ds)
            d_recs = state_digest(tr_r)
            free(tr_r)
            if d_files != d_recs:
                raise AssertionError("train_pass from files differs from "
                                     "train_pass from the records")
            # the step kernels against their plain versions on the first
            # step from files (f32 tower, no lazy-mf draws)
            first = _OneBatch(next(iter(file_ds.batches())))
            tk_, tp_ = trainer(f32=True), trainer(f32=True, ops=K.PLAIN)
            tk_.train_pass(first)
            tp_.train_pass(first)
            rows_t = torch.from_numpy(np.nonzero(
                tk_.table._touched | tp_.table._touched)[0]).to(dev)
            row_err = check_close("data: first step's touched rows, "
                                  "kernels vs plain",
                                  tk_.table.state.data[rows_t],
                                  tp_.table.state.data[rows_t], STATE_RTOL,
                                  STATE_ATOL)
            pk, pp = tk_.model.state_dict(), tp_.model.state_dict()
            param_err = max(check_close(f"data: dense param {k}", pk[k],
                                        pp[k], STATE_RTOL, STATE_ATOL)
                            for k in pk)
            free(tk_, tp_)
            del rows_t, pk, pp, first, file_ds, rec_ds

            # ---- 5. the stream scenario ----
            sig = {hashlib.sha1(b.keys.tobytes()).hexdigest(): i
                   for i, b in enumerate(batches)}
            trained = [0] * DATA_FILES

            def on_batch(b):
                i = sig[hashlib.sha1(b.keys.tobytes()).hexdigest()]
                if not np.array_equal(b.dense, batches[i].dense):
                    raise AssertionError("a streamed batch differs from "
                                         f"phase 5's batch {i}")
                trained[i] += 1

            def stream_ds():
                ds = QueueDataset(desc)
                ds.set_filelist(files)
                return ds

            parse_s = []
            inner_parse = SlotTextParser.parse

            def timed_parse(self, line):
                t0 = time.perf_counter()
                try:
                    return inner_parse(self, line)
                finally:
                    parse_s.append(time.perf_counter() - t0)

            with flags_scope(stream_window_files=DATA_WINDOW,
                             read_thread_num=1,
                             stream_ckpt_every_windows=1):
                # (a) the oracle, uninterrupted
                oracle = trainer()
                at_boundary = {}

                def boundary(widx, ds):
                    # the last boundary the killed run also reaches
                    if oracle.global_step == DATA_PREEMPT - 1:
                        at_boundary[oracle.global_step] = \
                            state_digest(oracle)
                oracle.on_window_complete = boundary
                oracle.on_batch_trained = on_batch
                root_o = os.path.join(tmp, "ckpt_oracle")
                SlotTextParser.parse = timed_parse
                try:
                    sync()
                    t0 = time.perf_counter()
                    out_o = counted(oracle.train_stream, stream_ds(),
                                    CheckpointManager(root_o))
                    t["stream_oracle_s"] = time.perf_counter() - t0
                finally:
                    SlotTextParser.parse = inner_parse
                d_oracle = state_digest(oracle)
                free(oracle)
                shutil.rmtree(root_o)
                if d_oracle != d_files:
                    raise AssertionError("the oracle stream's final digest "
                                         "differs from train_pass's")
                if trained != [1] * DATA_FILES:
                    raise AssertionError(f"oracle trained {trained}")
                trained[:] = [0] * DATA_FILES
                # (b) killed inside window 3
                root = os.path.join(tmp, "ckpt_stream")
                killed = trainer()
                killed.on_batch_trained = on_batch
                plan = FaultPlan.parse(
                    f"preempt.signal:fail:nth={DATA_PREEMPT}")
                t0 = time.perf_counter()
                try:
                    with installed(plan):
                        counted(killed.train_stream, stream_ds(),
                                CheckpointManager(root))
                    raise AssertionError("the stream was not preempted")
                except PreemptedError as e:
                    if not e.checkpointed or \
                            killed.global_step != DATA_PREEMPT:
                        raise AssertionError(
                            f"stream preempted at step {killed.global_step}"
                            f", checkpointed {e.checkpointed}") from e
                t["stream_killed_s"] = time.perf_counter() - t0
                preemption.clear_stop()
                free(killed)
                cur = CheckpointManager(root).load_cursor()["stream"]
                window = files[2 * DATA_WINDOW:3 * DATA_WINDOW]
                if cur["window_files"] != window:
                    raise AssertionError(f"the emergency cursor's open "
                                         f"window is {cur['window_files']}")
                # (c) new objects restore and stream again
                resumed = trainer(load=False)
                resumed.on_batch_trained = on_batch
                cm = CheckpointManager(root)
                t0 = time.perf_counter()
                if cm.restore(resumed) != DATA_PREEMPT:
                    raise AssertionError("the resume did not restore the "
                                         "emergency checkpoint")
                out_r = counted(resumed.train_stream, stream_ds(), cm)
                sync()
                t["stream_resumed_s"] = time.perf_counter() - t0
                free(resumed)
                if out_r["replayed_files"] != DATA_WINDOW:
                    raise AssertionError(f"the resume replayed "
                                         f"{out_r['replayed_files']} files")
                # the killed run's last common boundary
                at4 = trainer(load=False)
                step4 = DATA_PREEMPT - 1
                if CheckpointManager(root).restore(at4, step=step4) != step4:
                    raise AssertionError(f"no step-{step4} checkpoint")
                d_killed4 = state_digest(at4)
                free(at4)
                if d_killed4 != at_boundary.get(step4):
                    raise AssertionError(f"the killed run's step-{step4} "
                                         "checkpoint differs from the "
                                         "oracle's state there")
            again = [c - 1 for c in trained]
            want_again = [int(i == DATA_PREEMPT - 1)
                          for i in range(DATA_FILES)]
            if again != want_again:
                raise AssertionError(f"records trained {again} extra times "
                                     f"per file, want {want_again}")

            # ---- 6. the Criteo walkthrough at full width ----
            demo = os.path.join(tmp, "demo")
            t0 = time.perf_counter()
            walk = counted(train_criteo.main, [
                "--rows", str(DATA_FILES * BATCH), "--batch-size",
                str(BATCH), "--passes", "2", "--workdir", demo,
                "--device", dev, "--vocab-per-slot", str(VOCAB_PER_SLOT),
                "--capacity", str(CAPACITY),
                "--hidden", ",".join(map(str, HIDDEN))])
            t["walkthrough_s"] = time.perf_counter() - t0
            # the trained model's AUCs: the last pass's and the eval's
            aucs = [walk["passes"][-1]["auc"], walk["eval"]["auc"]]
            if walk["parse_route"] != "native" or not all(
                    np.isfinite(a) and a > 0.5 for a in aucs) \
                    or not walk["preds_finite"] or walk["served"] <= 0:
                raise AssertionError(f"walkthrough went wrong: {walk}")
            cdesc = DataFeedDesc.criteo(batch_size=BATCH)
            cparser = CriteoParser(cdesc)
            dense_err = 0.0
            t0 = time.perf_counter()
            for f in sorted(os.listdir(os.path.join(demo, "data"))):
                path = os.path.join(demo, "data", f)
                nat = cparser.parse_file_columnar(path)
                with open(path) as fh:
                    ref = ColumnarRecords.from_records(
                        [cparser.parse(line) for line in fh], 13)
                for k in ("keys", "key_slot", "offsets", "label", "show",
                          "clk"):
                    if not np.array_equal(nat[k], getattr(ref, k)):
                        raise AssertionError(f"criteo {f}: native {k} "
                                             "differs from per line")
                dense_err = max(dense_err, check_close(
                    f"criteo {f} dense", torch.from_numpy(nat["dense"]),
                    torch.from_numpy(ref.dense), 1e-6, 0.0))
            t["criteo_check_s"] = time.perf_counter() - t0
    finally:
        torch.use_deterministic_algorithms(False)
        preemption.clear_stop()
        faults.clear_plan()
    phase_s = time.perf_counter() - t_phase
    n_rec = len(records)
    rates = {route: {"records_per_s": n_rec / float(np.median(s)),
                     "mb_per_s": nbytes / 2**20 / float(np.median(s)),
                     "s": s} for route, s in loads.items()}
    ex_stream = out_o["examples"] / t["stream_oracle_s"]
    ex_pass = res_f["examples"] / t["train_files_s"]
    share = sum(parse_s) / t["stream_oracle_s"]
    for k in step_fns:
        if launches[k] == 0:
            raise AssertionError(f"phase 12: {k} never launched")
    log(f"data: {DATA_FILES} slot_text files, {n_rec} records, "
        f"{nbytes / 2**20:.1f} MiB written in {t['write_s']:.2f}s; load by "
        f"route (in turns native, python, python, native): native "
        f"{rates['native']['records_per_s']:.0f} records/s "
        f"{rates['native']['mb_per_s']:.1f} MB/s ({DATA_THREADS} threads), "
        f"python {rates['python']['records_per_s']:.0f} records/s "
        f"{rates['python']['mb_per_s']:.1f} MB/s (1 thread); columnar "
        f"arrays equal to the records', {len(batches)} batches equal to "
        f"phase 5's, per-line == native ({card})")
    log(f"data: train_pass from files == from records (state_digest "
        f"{d_files[:16]}), {ex_pass:.0f} examples/s; first step kernels vs "
        f"plain max abs err rows {row_err:.3g} params {param_err:.3g}; "
        f"{n_base} base rows ({card})")
    log(f"stream: oracle {out_o['windows']} windows of {DATA_WINDOW} files, "
        f"{ex_stream:.0f} examples/s ({t['stream_oracle_s']:.2f}s, 4 "
        f"boundary checkpoints) against train_pass {ex_pass:.0f}; per-line "
        f"parse {sum(parse_s):.2f}s = {share:.1%} of the stream's wall; "
        f"final digest == train_pass's; killed at batch {DATA_PREEMPT} "
        f"({t['stream_killed_s']:.2f}s), resumed by new objects "
        f"({t['stream_resumed_s']:.2f}s) replaying {out_r['replayed_files']}"
        f" files (window 3); step-{DATA_PREEMPT - 1} checkpoint == oracle; "
        f"extra trainings per file {again} ({card})")
    log(f"walkthrough: {json.dumps({'pass_auc': [p['auc'] for p in walk['passes']], 'eval_auc': walk['eval']['auc'], 'served': walk['served'], 'mean_ctr': walk['mean_ctr'], 'adopted': walk['adopted']})}"
        f" in {t['walkthrough_s']:.2f}s; native criteo parse == per line "
        f"(dense max abs err {dense_err:.3g}, rtol 1e-6) checked in "
        f"{t['criteo_check_s']:.2f}s; phase 12 took {phase_s:.1f}s; "
        f"launches {json.dumps(launches)} ({card})")
    details["data"] = dict(t, load_by_route=rates, bytes=nbytes,
                           digest=d_files, stream_examples_per_sec=ex_stream,
                           train_pass_examples_per_sec=ex_pass,
                           parse_share=share, parse_s=sum(parse_s),
                           row_max_abs_err=row_err,
                           param_max_abs_err=param_err,
                           walkthrough={k: walk[k] for k in
                                        ("passes", "eval", "served",
                                         "mean_ctr", "adopted")},
                           criteo_dense_max_abs_err=dense_err,
                           extra_trainings=again, phase_s=phase_s,
                           launches=launches)
    return launches


SHARD_N = 4                      # phase 13: shards, all on the one card
SHARD_CAPACITY = 1 << 20         # phase 13: rows a shard (the reference's
                                 # FLAGS.table_capacity_per_shard)
SHARD_BATCHES = 16               # phase 13: local batches, 4 global steps
SHARD_CHUNKS = 4                 # phase 13: a2a_chunks of the chunked run


def sharded_phase(torch, args, card, desc, details, dev: str = "cuda"
                  ) -> dict:
    """Phase 13: the sharded streaming path at phase 5's width, N =
    ``SHARD_N`` shards on the one card, each of ``SHARD_CAPACITY`` rows,
    loaded from phase 5's base file (split by key % N), over
    ``SHARD_BATCHES`` local batches from the phase's own seeded records:
    the sharded pull against one ``EmbeddingTable``'s (exact); the first
    global step through the kernels against the plain versions (counters,
    slots and pushed grads exact, rows and params in the ragged
    train-state class) and the synchronized split of a global step; then,
    under deterministic algorithms, the main path (``train_pass``
    monolithic with the host index; ``train_pass`` and ``eval_pass`` with
    ``use_pallas_index``), the chunked run against it by
    ``sharded_state_digest``, flag on against off by
    ``elastic_state_digest`` and eval AUC, and a ``save_base`` → ``load``
    → ``restore_state`` round trip by ``elastic_state_digest``; the
    resident pass against ``train_pass`` (monolithic and chunked) by
    ``sharded_state_digest``, with the device index by
    ``elastic_state_digest``, a depth-2 preloader against depth 0, and
    the q8 wire's AUC against the f32 wire's. Before the main path, the
    resident pass's first step kernels against plain, and a ZeRO-1 SGD
    step with the shards on the card and the CPU in turns (copies
    between devices in both exchanges, a CPU replica of the model,
    ZeRO-1 chunks on both) against the same step on the card alone: the
    card's destinations' predictions and the refreshed replica exact,
    the rest in the ragged train-state class; one step, since at the
    second a ReLU flip between the card's and the CPU's float order
    takes a few rows out of the class, all on the CPU as much as mixed.
    Returns the kernels' launches in the main path."""
    import copy
    import dataclasses

    from paddlebox_tpu_torch import (DeepFM, EmbeddingTable, InMemoryDataset,
                                     convert)
    from paddlebox_tpu_torch.config import flags_scope
    from paddlebox_tpu_torch.data import BatchBuilder, SlotRecord
    from paddlebox_tpu_torch.ops import index as IX
    from paddlebox_tpu_torch.ops import kernels as K
    from paddlebox_tpu_torch.ps.sharded import ShardedEmbeddingTable
    from paddlebox_tpu_torch.ps.table import TableState
    from paddlebox_tpu_torch.train import sharded as SH
    from paddlebox_tpu_torch.train.checkpoint import (elastic_state_digest,
                                                      sharded_state_digest)
    from paddlebox_tpu_torch.train.device_pass import PassPreloader
    from paddlebox_tpu_torch.train.step import default_tx

    sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)
    t_phase = time.perf_counter()
    t = {}
    t0 = time.perf_counter()
    base = make_table_blob(np.random.default_rng(args.seed + 1), convert,
                           vocab=TRAIN_BASE_VOCAB, no_mf=0.25)
    n_base = len(base["keys"])
    records = make_records(np.random.default_rng(args.seed + 13),
                           BATCH * SHARD_BATCHES, SlotRecord)
    builder = BatchBuilder(desc)
    batches = [builder.build(records[i:i + BATCH])
               for i in range(0, len(records), BATCH)]
    groups = list(SH.group_batches(batches, SHARD_N))
    t["data_s"] = time.perf_counter() - t0

    def fresh():
        tab = ShardedEmbeddingTable(SHARD_N, mf_dim=MF_DIM,
                                    capacity_per_shard=SHARD_CAPACITY,
                                    devices=dev)
        tab.load(base)
        for kv in tab.indexes:
            if kv.kv_route != "native":
                raise AssertionError("sharded: a shard's host key index "
                                     f"took the {kv.kv_route} route")
        return tab

    def model(dtype=None):
        torch.manual_seed(args.seed + 2)      # phase 5's initial params
        kw = {} if dtype is None else {"compute_dtype": dtype}
        return DeepFM(NUM_SLOTS, 3 + MF_DIM, DENSE_DIM, hidden=HIDDEN, **kw)

    def dataset(n_batches=SHARD_BATCHES):
        """The phase's records, or its first ``n_batches`` batches'."""
        ds = InMemoryDataset(desc)
        ds.records = records[:n_batches * BATCH]
        return ds

    t0 = time.perf_counter()
    table = fresh()
    sync()
    t["load_s"] = time.perf_counter() - t0
    per_shard = [len(kv) for kv in table.indexes]
    table_mb = sum(st.data.numel() * 4 for st in table.states) / 2**20

    # ---- the sharded pull against one table's, exactly ----
    single = EmbeddingTable(mf_dim=MF_DIM, capacity=CAPACITY, device=dev)
    single.load(base)
    plan = table.prepare_global_eval(groups[0])
    gb = SH.make_global_batch(groups[0], plan, table.devices)
    step_k = SH.ShardedTrainStep(default_tx, table.cfg, table.devices,
                                 BATCH, NUM_SLOTS, ops=K.KERNELS)
    pulled = step_k.pull(table.states, gb)
    for d, b in enumerate(groups[0]):
        want = single.pull(single.prepare_eval(b))[:b.num_keys]
        if not torch.equal(pulled[d], want):
            raise AssertionError(f"sharded pull of destination {d} differs "
                                 "from the single table's")
    del single, pulled, want, gb

    # ---- the first global step, kernels against plain; the split ----
    prep_ms, stage_ms, plans, staged = [], [], [], []
    for g in groups:
        t0 = time.perf_counter()
        plans.append(table.prepare_global(g))
        t1 = time.perf_counter()
        staged.append(SH.make_global_batch(g, plans[-1], table.devices))
        sync()
        prep_ms.append((t1 - t0) * 1e3)
        stage_ms.append((time.perf_counter() - t1) * 1e3)
    start = [st.data.clone() for st in table.states]

    def stepper(ops, devs=None, cfg=None, tx=default_tx, zero1=False):
        devs = devs or table.devices
        tab = copy.copy(table)
        tab.states = [TableState(x.to(d, copy=True), table.opt_ext)
                      for x, d in zip(start, devs)]
        step = SH.ShardedTrainStep(tx, cfg or table.cfg, devs,
                                   BATCH, NUM_SLOTS, zero1=zero1, ops=ops)
        return step, step.init_state(tab, model(torch.float32))

    runs = {}
    step_ms = []
    for name, ops in (("kernels", K.KERNELS), ("plain", K.PLAIN)):
        step, st = stepper(ops)
        n_steps = len(groups) if name == "kernels" else 1
        for i in range(n_steps):
            sync()
            t0 = time.perf_counter()
            out = step(st, staged[i], SH.push_generators(
                table.devices, args.seed, i + 1))
            sync()
            if name == "kernels":
                step_ms.append((time.perf_counter() - t0) * 1e3)
            if not np.isfinite(float(out["loss"])):
                raise AssertionError(f"sharded {name} step {i}: "
                                     "non-finite loss")
            if i == 0:
                runs[name] = (out, [x.data.clone() for x in st.tables],
                              {k: v.clone() for k, v in
                               st.model.state_dict().items()})
        del step, st
    def kernels_vs_plain(what, runs):
        (ok, tk_, pk), (op, tp, pp) = runs["kernels"], runs["plain"]
        for s in range(SHARD_N):
            if not torch.equal(ok["pushed"][s], op["pushed"][s]):
                raise AssertionError(f"{what}: shard {s}'s pushed grads, "
                                     "kernels vs plain, differ")
            if not torch.equal(tk_[s][:, :4], tp[s][:, :4]):
                raise AssertionError(f"{what}: shard {s}'s show/clk/"
                                     "delta_score/slot, kernels vs plain, "
                                     "differ")
        row_err = max(check_close(f"{what}: shard {s} rows, kernels vs "
                                  "plain", tk_[s], tp[s], STATE_RTOL,
                                  STATE_ATOL) for s in range(SHARD_N))
        param_err = max(check_close(f"{what}: dense param {k}", pk[k],
                                    pp[k], STATE_RTOL, STATE_ATOL)
                        for k in pk)
        return row_err, param_err

    row_err, param_err = kernels_vs_plain("sharded", runs)
    del runs, staged

    # ---- the resident pass's first global step, kernels against plain:
    # the step decoded from the staged wire (its rows are the streaming
    # plans', assigned in the same order from the same base) ----
    t0 = time.perf_counter()
    probe = SH.ShardedTrainer(model(), fresh(), desc, seed=args.seed)
    rp0 = probe.build_resident_pass(dataset(SHARD_N))   # the first group
    rp0.upload()
    rp0.wait_ready()
    gb_res = SH._decode_wire_step(rp0, 0)
    runs = {}
    for name, ops in (("kernels", K.KERNELS), ("plain", K.PLAIN)):
        step, st = stepper(ops)
        out = step(st, gb_res, SH.push_generators(table.devices, args.seed,
                                                  1), rp0.sections)
        runs[name] = (out, [x.data.clone() for x in st.tables],
                      {k: v.clone() for k, v in
                       st.model.state_dict().items()})
        del step, st
    res_row_err, res_param_err = kernels_vs_plain("sharded resident", runs)
    t["resident_check_s"] = time.perf_counter() - t0
    del runs, probe, rp0, gb_res

    # ---- shards on two devices against one device: a ZeRO-1 step ----
    # lazy mf draws nothing (mf_initial_range 0): the CPU's generator is
    # not the card's. One step: at the second, one example's ReLU input
    # in destination 3's last hidden layer sits within 5e-8 of zero and
    # takes the other sign on the CPU than on the card (GEMM order), and
    # that example's keys leave the train-state class. All shards on the
    # CPU leave it on the same elements, while the mixed run stays within
    # 7.2e-7 of the all-CPU run (PERF.md §6, PR 16 review round)
    cfg0 = dataclasses.replace(table.cfg, mf_initial_range=0.0)
    mixed_devs = [torch.device(dev), torch.device("cpu")] * (SHARD_N // 2)
    t0 = time.perf_counter()
    one_step = {}
    for name, devs in (("one", table.devices), ("mixed", mixed_devs)):
        step, st = stepper(K.KERNELS, devs, cfg0, zero1=True,
                           tx=lambda p: torch.optim.SGD(p, lr=0.05))
        out = step(st, SH.make_global_batch(groups[0], plans[0], devs),
                   SH.push_generators(devs, args.seed, 1))
        sync()
        kinds = [d.type for d in mixed_devs]
        if name == "mixed" and (
                [x.data.device.type for x in st.tables] != kinds
                or [c.device.type for c in st.opt.chunks] != kinds
                or list(step._replicas) != [d for d in mixed_devs[1:2]
                                            if d != mixed_devs[0]]):
            raise AssertionError("sharded mixed devices: a shard, a ZeRO-1 "
                                 "chunk or a replica is not where it should "
                                 "be")
        for rep in step._replicas.values():
            # the replica refreshed after the dense update
            for q, p in zip(rep.parameters(), st.model.parameters()):
                if not torch.equal(q.to(p.device), p):
                    raise AssertionError("sharded mixed devices: a model "
                                         "replica was not refreshed")
        one_step[name] = dict(
            tables=[x.data.to(dev) for x in st.tables],
            params={k: v.to(dev) for k, v in st.model.state_dict().items()},
            pred=[x.to(dev) for x in out["pred"]],
            pushed=[x.to(dev) for x in out["pushed"]])
        del step, st, out
    t["mixed_s"] = time.perf_counter() - t0
    one, mixed = one_step["one"], one_step["mixed"]
    for d, dv in enumerate(mixed_devs):
        # a destination on the card pools values pulled from both
        # devices: the exchange's copies are exact
        if dv == mixed_devs[0] and not torch.equal(mixed["pred"][d],
                                                   one["pred"][d]):
            raise AssertionError(f"sharded mixed devices: destination {d} "
                                 "on the card predicts other values")
    for s in range(SHARD_N):
        if not torch.equal(one["tables"][s][:, [0, 1, 3]],
                           mixed["tables"][s][:, [0, 1, 3]]):
            raise AssertionError(f"sharded mixed devices: shard {s}'s "
                                 "show/clk/slot differ from one device's")
    mixed_err = max(
        [check_close(f"sharded mixed devices: shard {s} {what}",
                     mixed[what][s], one[what][s], STATE_RTOL, STATE_ATOL)
         for s in range(SHARD_N) for what in ("tables", "pushed", "pred")]
        + [check_close(f"sharded mixed devices: dense param {k}",
                       mixed["params"][k], v, STATE_RTOL, STATE_ATOL)
           for k, v in one["params"].items()])
    del one_step, one, mixed, start, table
    split = {"prepare_global_ms": float(np.median(prep_ms)),
             "stage_ms": float(np.median(stage_ms)),
             "step_ms": float(np.median(step_ms))}
    step_p50 = sum(split.values())
    a_need = [p.req_need for p in plans]
    a2_need = [p.serve_need for p in plans]
    wire_mb = (SHARD_N * SHARD_N * plans[0].req_capacity * (3 + MF_DIM) * 4
               / 2**20)
    del plans

    # ---- the main path, deterministic: monolithic, then flag on ----
    fns = {"gather_rows": K.gather_rows, "pool_cvm": K.pool_cvm,
           "segment_gather": K.segment_gather,
           "scatter_add_update": K.scatter_add_update,
           "index_insert": IX.insert, "index_lookup": IX.lookup}
    torch.use_deterministic_algorithms(True)
    try:
        for f in fns.values():
            f.launches = 0
        t0 = time.perf_counter()
        mono = SH.ShardedTrainer(model(), fresh(), desc, seed=args.seed)
        res = mono.train_pass(dataset())
        sync()
        t["mono_s"] = time.perf_counter() - t0
        stages = {k: [x * 1e3 for x in v]
                  for k, v in mono.stage_timers.seconds.items()}
        with flags_scope(use_pallas_index=True):
            on = SH.ShardedTrainer(model(), fresh(), desc, seed=args.seed)
            res_on = on.train_pass(dataset())
            ev_on = on.eval_pass(dataset())
        sync()
        if any(d is None or d.degraded for d in on.table._dev_indexes):
            raise AssertionError("phase 13: a shard's device index "
                                 "degraded")
        ev = mono.eval_pass(dataset())
        for name, r in (("mono", res), ("flag on", res_on)):
            if r["batches"] != len(groups) or not np.isfinite(
                    r["last_loss"]):
                raise AssertionError(f"sharded {name} pass: {r}")
        if ev_on["auc"] != ev["auc"] or not 0.0 < ev["auc"] < 1.0:
            raise AssertionError(f"sharded eval auc: flag on "
                                 f"{ev_on['auc']} vs off {ev['auc']}")
        d_mono = sharded_state_digest(mono)
        e_mono = elastic_state_digest(mono)
        if elastic_state_digest(on) != e_mono:
            raise AssertionError("sharded: use_pallas_index on != off by "
                                 "elastic_state_digest")
        del on
        with flags_scope(a2a_chunks=SHARD_CHUNKS):
            chunked = SH.ShardedTrainer(model(), fresh(), desc,
                                        seed=args.seed)
            res_chunked = chunked.train_pass(dataset())
        if res_chunked["chunked_batches"] != len(groups):
            raise AssertionError(
                f"sharded: {res_chunked['chunked_batches']} of "
                f"{len(groups)} global batches ran the chunked schedule "
                "(the grouped plan fell back to the monolithic one)")
        if sharded_state_digest(chunked) != d_mono:
            raise AssertionError(f"sharded: a2a_chunks={SHARD_CHUNKS} != 1 "
                                 "by sharded_state_digest")
        del chunked

        # ---- the resident pass: staged once, no host plan per step ----
        res_tr = SH.ShardedTrainer(model(), fresh(), desc, seed=args.seed)
        t0 = time.perf_counter()
        rp = res_tr.build_resident_pass(dataset())
        rp.upload()
        sync()
        t["resident_build_s"] = time.perf_counter() - t0
        build_split = dict(rp.build_stats)
        wire_bytes = rp.nbytes()
        wire_fmt = dict(rp.fmt)
        t0 = time.perf_counter()
        r_res = res_tr.train_pass_resident(rp)
        sync()
        t["resident_train_s"] = time.perf_counter() - t0
        if sharded_state_digest(res_tr) != d_mono:
            raise AssertionError("sharded: train_pass_resident != "
                                 "train_pass by sharded_state_digest")
        del res_tr, rp
        with flags_scope(a2a_chunks=SHARD_CHUNKS):
            res_ch = SH.ShardedTrainer(model(), fresh(), desc,
                                       seed=args.seed)
            r_ch = res_ch.train_pass_resident(dataset())
        if r_ch["chunked_batches"] != len(groups):
            raise AssertionError("sharded resident: the chunked pass fell "
                                 "back to the monolithic schedule")
        if sharded_state_digest(res_ch) != d_mono:
            raise AssertionError(f"sharded: resident a2a_chunks="
                                 f"{SHARD_CHUNKS} != train_pass by "
                                 "sharded_state_digest")
        del res_ch
        with flags_scope(use_pallas_index=True):
            on_res = SH.ShardedTrainer(model(), fresh(), desc,
                                       seed=args.seed)
            on_res.train_pass_resident(dataset())
        if any(d is None or d.degraded for d in on_res.table._dev_indexes):
            raise AssertionError("sharded resident: a shard's device index "
                                 "degraded")
        if elastic_state_digest(on_res) != e_mono:
            raise AssertionError("sharded resident: use_pallas_index on != "
                                 "the host index by elastic_state_digest")
        del on_res
        # two passes (of half the batches each) through a depth-2
        # preloader against depth 0
        half = SHARD_BATCHES // 2
        pre_digests, pre_wait, pre_first = {}, {}, {}
        for depth in (2, 0):
            tr_d = SH.ShardedTrainer(model(), fresh(), desc, seed=args.seed)
            pre = PassPreloader(iter([dataset(half), dataset(half)]),
                                build_fn=tr_d.build_resident_pass,
                                depth=depth, device=dev)
            passes = []
            try:
                pre.start_next()
                while (rp_d := pre.wait()) is not None:
                    more = pre.start_next()
                    passes.append(tr_d.train_pass_resident(rp_d))
                    if not more:
                        break
            finally:
                pre.drain()
            if len(passes) != 2:
                raise AssertionError(f"sharded preloader depth {depth}: "
                                     f"{len(passes)} passes")
            pre_digests[depth] = sharded_state_digest(tr_d)
            pre_wait[depth] = pre.wait_sec_total
            pre_first[depth] = passes[0]
            del tr_d, pre
        if pre_digests[2] != pre_digests[0]:
            raise AssertionError("sharded preloader: depth 2 != depth 0 by "
                                 "sharded_state_digest")
        # the q8 float wire trains within the reference's gate of the f32
        # wire's AUC (the depth-0 run's first pass, the same batches)
        q8 = SH.ShardedTrainer(model(), fresh(), desc, seed=args.seed,
                               float_wire="q8")
        r_q8 = q8.train_pass_resident(dataset(half))
        r_f32 = pre_first[0]
        if abs(r_q8["auc"] - r_f32["auc"]) >= 5e-3:
            raise AssertionError(f"sharded q8 wire auc {r_q8['auc']} vs "
                                 f"f32 {r_f32['auc']}")
        del q8
        sync()
        launches = {k: f.launches for k, f in fns.items()}
        for k, n in launches.items():
            if n == 0:
                raise AssertionError(f"phase 13: {k} never launched")
        # save_base → load → restore_state gives the same logical state
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "sharded.npz")
            t0 = time.perf_counter()
            n_saved = mono.table.save_base(path)
            t["save_base_s"] = time.perf_counter() - t0
            back = ShardedEmbeddingTable(SHARD_N, mf_dim=MF_DIM,
                                         capacity_per_shard=SHARD_CAPACITY,
                                         devices=dev)
            if back.load(path) != n_saved:
                raise AssertionError("sharded save_base rows did not load")
        again = SH.ShardedTrainer(model(), back, desc, seed=args.seed)
        snap = mono.dense_snapshot()
        again.restore_state(snap["model"], snap["opt"], snap["auc"],
                            mono.global_step)
        if elastic_state_digest(again) != e_mono:
            raise AssertionError("sharded: save_base → load round trip "
                                 "changed elastic_state_digest")
        new_rows = mono.table.feature_count() - n_base
        del again, back, mono, base
    finally:
        torch.use_deterministic_algorithms(False)
    phase_s = time.perf_counter() - t_phase
    phase5 = details.get("train", {}).get("pass", {}).get(
        "examples_per_sec", float("nan"))
    log(f"sharded: {SHARD_N} shards of {SHARD_CAPACITY} rows on one card "
        f"({table_mb:.0f} MiB of tables), phase 5's base {n_base} rows "
        f"split {per_shard} in {t['load_s']:.2f}s; {len(groups)} global "
        f"steps of {SHARD_N} x {BATCH}; pull == single table's, exact; "
        f"first step kernels vs plain: pushed grads and show/clk/slot "
        f"exact, max abs err rows {row_err:.3g} params {param_err:.3g}; "
        f"a ZeRO-1 SGD step with shards on {dev}/cpu/{dev}/cpu vs all on "
        f"{dev}: card destinations' preds, show/clk/slot and the "
        f"replica exact, max abs err {mixed_err:.3g} "
        f"({t['mixed_s']:.1f}s) ({card})")
    log(f"sharded plan: A need {a_need}, A2 need {a2_need}, pull wire "
        f"{wire_mb:.1f} MiB a step; synchronized step p50 {step_p50:.2f} ms "
        f"= {json.dumps({k: round(v, 3) for k, v in split.items()})}, "
        f"{SHARD_N * BATCH / step_p50 * 1e3:.0f} examples/s (f32 tower) "
        f"({card})")
    res_eps = len(records) / t["resident_train_s"]
    log(f"sharded resident pass (bf16 tower, deterministic algorithms): "
        f"{res_eps:.0f} examples/s staged, {r_res['examples_per_sec']:.0f} "
        f"as train_pass_resident reports it, "
        f"{len(records) / (t['resident_build_s'] + t['resident_train_s']):.0f}"
        f" with the build, beside train_pass {res['examples_per_sec']:.0f}; "
        f"build {t['resident_build_s']:.2f}s = "
        f"{json.dumps({k: round(v, 3) for k, v in build_split.items()})}; "
        f"staged wire {wire_bytes / 2**20:.1f} MiB a pass "
        f"{json.dumps(wire_fmt)}; == train_pass, monolithic and "
        f"a2a_chunks={SHARD_CHUNKS}, by sharded_state_digest; index on == "
        f"off by elastic_state_digest; depth-2 preloader == depth 0 over 2 "
        f"passes of {SHARD_BATCHES // 2 // SHARD_N} global steps (wait "
        f"{pre_wait[2]:.2f}s / {pre_wait[0]:.2f}s); q8 wire auc "
        f"{r_q8['auc']:.6f} vs f32 {r_f32['auc']:.6f}; first resident step "
        f"kernels vs plain: pushed grads and show/clk/slot exact, max abs "
        f"err rows {res_row_err:.3g} params {res_param_err:.3g} ({card})")
    log(f"sharded train_pass (bf16 tower, prefetch, deterministic "
        f"algorithms): {res['examples_per_sec']:.0f} examples/s beside "
        f"phase 5's train_pass {phase5:.0f}, auc {res['auc']:.4f}, last "
        f"loss {res['last_loss']:.4f}, {new_rows} new rows; eval auc "
        f"{ev['auc']:.6f} flag on == off; a2a_chunks={SHARD_CHUNKS} == 1 by "
        f"sharded_state_digest; index on == off and save_base ({n_saved} "
        f"rows, {t['save_base_s']:.2f}s) → load == trained by "
        f"elastic_state_digest; phase 13 took {phase_s:.1f}s; launches "
        f"{json.dumps(launches)} ({card})")
    details["sharded"] = dict(
        t, pass_=res, pass_flag_on=res_on, eval=ev, stage_ms=stages,
        split_p50_ms=split, step_p50_ms=step_p50, prepare_ms=prep_ms,
        stage_sync_ms=stage_ms, step_ms=step_ms, req_need=a_need,
        serve_need=a2_need, wire_mb=wire_mb, per_shard_rows=per_shard,
        row_max_abs_err=row_err, param_max_abs_err=param_err,
        mixed_max_abs_err=mixed_err,
        new_rows=new_rows, saved_rows=n_saved, phase_s=phase_s,
        launches=launches, resident=dict(
            pass_=r_res, chunked=r_ch, q8=r_q8, f32_half=r_f32,
            build_split_s=build_split,
            wire_bytes=wire_bytes, wire_fmt=wire_fmt,
            examples_per_sec_staged=res_eps, preload_wait_s=pre_wait,
            row_max_abs_err=res_row_err, param_max_abs_err=res_param_err))
    return launches


# phase 14: each CTR model of the registry but DeepFM (phases 5-13) and
# AdsRank (phase 7): (registry name, constructor arguments, the layer
# its lr_map freezes)
MODEL_SPECS = (("ctr_dnn", {}, "hidden.0"),
               ("wide_deep", {}, "hidden.0"),
               ("dcn_v2", {"structure": "parallel"}, "cross.0"),
               ("mmoe", {}, "mmoe.gates.0"))
MODEL_BATCHES = 2                # phase 14: batches of each train_pass


def models_phase(torch, args, card, desc, records, batches, details,
                 dev: str = "cuda") -> dict:
    """Phase 14: ``CtrDnn``, ``WideDeep``, ``DCNv2`` (parallel) and
    ``MMoESingle`` (the registry's widths) at phase 5's width, each
    model from a seeded init, on one table loaded from phase 5's base
    file (capacity ``CAPACITY``) and one ``ShardedEmbeddingTable`` of
    ``SHARD_N`` x ``SHARD_CAPACITY`` rows on the card: the first step of
    phase 5's batch 0 through the kernels against the plain versions
    (f32 tower, TF32 off; show/clk exact, rows and params in the ragged
    train-state class), then, under deterministic algorithms, the main
    path: ``Trainer.train_pass`` of ``MODEL_BATCHES`` batches (bf16
    tower), a ``train_pass`` of one batch with an ``lr_map`` that
    freezes one layer (its params unchanged bit for bit, another layer's
    changed), and one ``ShardedTrainer`` ZeRO-1 global step with the
    same ``lr_map`` (the same check). Returns the kernels' launches in
    the main path."""
    from paddlebox_tpu_torch import (EmbeddingTable, InMemoryDataset,
                                     Trainer, convert)
    from paddlebox_tpu_torch.device import seeded_generator
    from paddlebox_tpu_torch.metrics import init_auc_state
    from paddlebox_tpu_torch.models import MODEL_REGISTRY
    from paddlebox_tpu_torch.ops import kernels as K
    from paddlebox_tpu_torch.ps.sharded import ShardedEmbeddingTable
    from paddlebox_tpu_torch.ps.table import TableState
    from paddlebox_tpu_torch.train.sharded import ShardedTrainer
    from paddlebox_tpu_torch.train.step import (StepState, TrainStep,
                                                default_tx,
                                                make_device_batch)

    sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)
    t_phase = time.perf_counter()
    base = make_table_blob(np.random.default_rng(args.seed + 1), convert,
                           vocab=TRAIN_BASE_VOCAB, no_mf=0.25)
    table = EmbeddingTable(mf_dim=MF_DIM, capacity=CAPACITY, seed=args.seed,
                           device=dev)
    table.load(base)
    sharded = ShardedEmbeddingTable(SHARD_N, mf_dim=MF_DIM,
                                    capacity_per_shard=SHARD_CAPACITY,
                                    devices=dev)
    sharded.load(base)
    del base
    idx0 = table.prepare(batches[0])
    fns = (K.gather_rows, K.pool_cvm, K.segment_gather, K.scatter_add_update)
    launches = {f.__name__: 0 for f in fns}

    def dataset(n):
        ds = InMemoryDataset(desc)
        ds.records = records[:n * BATCH]
        return ds

    def changed(before, after, prefix):
        return {k: not torch.equal(before[k], after[k]) for k in before
                if k.startswith(prefix + ".")}

    out = {}
    for name, kw, frozen in MODEL_SPECS:
        cls = MODEL_REGISTRY[name]
        t_model = time.perf_counter()

        def make(dtype=None):
            torch.manual_seed(args.seed + 3)
            extra = {} if dtype is None else {"compute_dtype": dtype}
            return cls(NUM_SLOTS, 3 + MF_DIM, DENSE_DIM, **kw, **extra)

        # ---- the first step, kernels against plain, from one start ----
        start = table.state.data.clone()
        steps = {}
        for what, ops in (("kernels", K.KERNELS), ("plain", K.PLAIN)):
            m = make(torch.float32).to(dev)
            st = StepState(table=TableState(start.clone(), table.state.ext),
                           model=m, opt=default_tx(m.parameters()),
                           auc=init_auc_state(device=dev))
            stats = TrainStep(table.cfg, BATCH, NUM_SLOTS, ops=ops)(
                st, make_device_batch(batches[0], idx0, dev),
                seeded_generator(dev, args.seed + 1, 1))
            if not np.isfinite(float(stats["loss"])):
                raise AssertionError(f"models {name} {what}: non-finite loss")
            steps[what] = st
        del start
        sk, sp = steps["kernels"], steps["plain"]
        if not torch.equal(sk.table.data[:, :2], sp.table.data[:, :2]):
            raise AssertionError(f"models {name}: show/clk, kernels vs "
                                 "plain, differ")
        row_err = check_close(f"models {name}: table rows, kernels vs plain",
                              sk.table.data, sp.table.data, STATE_RTOL,
                              STATE_ATOL)
        pk, pp = sk.model.state_dict(), sp.model.state_dict()
        param_err = max(check_close(f"models {name}: dense param {k}",
                                    pk[k], pp[k], STATE_RTOL, STATE_ATOL)
                        for k in pk)
        del steps, sk, sp, pk, pp

        # ---- the main path, deterministic ----
        torch.use_deterministic_algorithms(True)
        try:
            for f in fns:
                f.launches = 0
            tr = Trainer(make(), table, desc, seed=args.seed, device=dev)
            t0 = time.perf_counter()
            res = tr.train_pass(dataset(MODEL_BATCHES))
            sync()
            pass_s = time.perf_counter() - t0
            if res["batches"] != MODEL_BATCHES or not np.isfinite(
                    res["last_loss"]):
                raise AssertionError(f"models {name} train_pass: {res}")
            lr_map = {frozen: 0.0}
            frz = Trainer(make(), table, desc, seed=args.seed, device=dev,
                          lr_map=lr_map, lr_map_base=1e-3)
            before = {k: v.clone() for k, v in frz.model.state_dict().items()}
            frz.train_pass(dataset(1))
            moved = changed(before, frz.model.state_dict(), frozen)
            if not moved or any(moved.values()):
                raise AssertionError(f"models {name}: lr_map {lr_map} left "
                                     f"{frozen} changed: {moved}")
            if all(torch.equal(v, frz.model.state_dict()[k])
                   for k, v in before.items()):
                raise AssertionError(f"models {name}: nothing trained")
            shd = ShardedTrainer(make(), sharded, desc, seed=args.seed,
                                 zero1=True, lr_map=lr_map,
                                 lr_map_base=1e-3)
            before = {k: v.clone() for k, v in shd.model.state_dict().items()}
            r_shd = shd.train_pass(dataset(SHARD_N))
            moved = changed(before, shd.model.state_dict(), frozen)
            if r_shd["batches"] != 1 or not moved or any(moved.values()):
                raise AssertionError(f"models {name}: sharded ZeRO-1 lr_map "
                                     f"left {frozen} changed: {moved}")
            sync()
            for f in fns:
                if f.launches == 0:
                    raise AssertionError(f"phase 14: {f.__name__} never "
                                         f"launched for {name}")
                launches[f.__name__] += f.launches
        finally:
            torch.use_deterministic_algorithms(False)
        del tr, frz, shd, before
        out[name] = dict(pass_=res, pass_s=pass_s, row_max_abs_err=row_err,
                         param_max_abs_err=param_err,
                         frozen=frozen, model_s=time.perf_counter() - t_model,
                         params=sum(p.numel() for p in make().parameters()))
        log(f"models {name} ({out[name]['params']} params): first step "
            f"kernels vs plain show/clk exact, max abs err rows "
            f"{row_err:.3g} params {param_err:.3g}; train_pass of "
            f"{MODEL_BATCHES} batches {res['examples_per_sec']:.0f} "
            f"examples/s (bf16 tower), auc {res['auc']:.4f}; lr_map "
            f"freezing {frozen}: unchanged bit for bit, Trainer and "
            f"ShardedTrainer ZeRO-1 ({card})")
    phase_s = time.perf_counter() - t_phase
    log(f"models: phase 14 took {phase_s:.1f}s; launches "
        f"{json.dumps(launches)} ({card})")
    details["models"] = dict(out, phase_s=phase_s, launches=launches)
    return launches


TIER_N = 4                       # phase 15: shards, all on the one card
TIER_SLOTS = 26                  # 15a: bench.py measure_tiered "uniform":
TIER_BATCH = 8192                # one key a slot, batch 8192,
TIER_RECORDS = 32768             # 32 768 records a pass,
TIER_VOCAB = 10_000              # from 10 000 ids a slot
TIER_CAPACITY = 1 << 20          # 15a: (1 << 22) // 4 rows a shard
TIER_BUCKET_MIN = 1 << 12        # 15a: request and serve bucket minimums
TIER_MEASURED = 4                # 15a: passes after the cold and warm ones
WINDOW_CAPACITY = 1 << 19        # 15b: window rows a shard
WINDOW_HOST = 1 << 19            # 15b: host-RAM rows a shard


def _uniform_records(rng, n: int, SlotRecord):
    """bench.py ``build_records`` at the "uniform" shape: one key in each
    of ``TIER_SLOTS`` slots (slot s holds ids from s * TIER_VOCAB), 13
    dense, label 1 with probability 0.25."""
    keys = (rng.integers(0, TIER_VOCAB, size=(n, TIER_SLOTS))
            + np.arange(TIER_SLOTS) * TIER_VOCAB).astype(np.uint64)
    dense = rng.normal(size=(n, DENSE_DIM)).astype(np.float32)
    labels = (rng.random(n) < 0.25).astype(np.float32)
    offs = np.arange(TIER_SLOTS + 1, dtype=np.int32)
    return [SlotRecord(keys=keys[i], slot_offsets=offs, dense=dense[i],
                       label=float(labels[i]), show=1.0,
                       clk=float(labels[i])) for i in range(n)]


def _dense_digest(tr) -> str:
    """sha256 of a trainer's model and optimizer tensors."""
    import hashlib
    h = hashlib.sha256()
    for t in tr.model.state_dict().values():
        h.update(np.ascontiguousarray(t.detach().float().cpu().numpy())
                 .tobytes())
    for st in tr.state.opt.state_dict()["state"].values():
        for v in st.values():
            if hasattr(v, "detach"):
                h.update(np.ascontiguousarray(
                    v.detach().float().cpu().numpy()).tobytes())
    return h.hexdigest()


def _host_model(table):
    """(keys sorted, rows [n, F]) of a table's whole model: the tiered
    table's host tiers (RAM and SSD) or a plain sharded table's shards."""
    keys, rows = [], []
    if hasattr(table, "hosts"):
        from paddlebox_tpu_torch.ps.table import rows_from_store_fields
        table.fence()
        for h in table.hosts:
            k, f = h.export_rows(clear_touched=False)
            keys.append(k)
            rows.append(rows_from_store_fields(f, table.mf_dim,
                                               table.opt_ext))
    else:
        for s in range(table.n):
            k, r = table.indexes[s].items()
            keys.append(k)
            rows.append(table._rows_host(s, r))
    keys = np.concatenate(keys)
    order = np.argsort(keys)
    return keys[order], np.concatenate(rows)[order]


def tiered_phase(torch, args, card, desc, details, dev: str = "cuda"
                 ) -> dict:
    """Phase 15: the tiered store on the card, under
    ``torch.use_deterministic_algorithms``.

    15a, bench.py's ``measure_tiered`` at its "uniform" shape: a
    ``TieredShardedEmbeddingTable`` of ``TIER_N`` shards of
    ``TIER_CAPACITY`` rows with an SSD tier, ``DeepFM`` at phase 5's
    widths, two seeded columnar datasets (~96% key overlap) alternating
    through ``tiered_pass_pipeline`` at ``FLAGS.preload_depth``: a cold
    pass, a warm pass and ``TIER_MEASURED`` measured passes. The same
    passes at depth 0 must equal them by ``rows_digest`` and the dense
    params' bytes; the cold pass stages its whole working set and each
    later pass exactly its keys not yet resident. Then the
    ``drop_window`` full re-stage control, and the SSD section: the whole
    model demoted to segments, a ``begin_pass`` paying the promote
    inline (the model's ``rows_digest`` unchanged by the round trip) and
    one whose promote rode the previous pass's training. The first
    resident step through the kernels against the plain versions (phase
    13's classes).

    15b, a window smaller than the model: phase 5's base file loads into
    ``TIER_N`` windows of ``WINDOW_CAPACITY`` rows over host stores of
    ``WINDOW_HOST`` rows with SSD tiers (the coldest rows past the
    watermark go to segments), and phase 13's ``SHARD_BATCHES`` local
    batches run as passes of one global step through
    ``train_passes_tiered`` at depth 0. With ``mf_initial_range`` 0 the
    model read back through the host tier must equal a plain
    ``ShardedEmbeddingTable`` of ``SHARD_CAPACITY`` rows a shard trained
    over the same passes (show/clk exact, rows and dense params within
    rtol 2e-4 / atol 2e-5); no window exceeds its capacity; the evicted,
    written-back, staged and SSD-promoted counts are not all zero.
    Kernel rows 3 and 4 against their plain versions at the passes' real
    delta and write-back sizes, timed there beside ``index_copy_`` /
    ``index_select`` and rows 2 and 1 in alternating repeats. Returns the
    kernels' launches in the main path (15a's depth-2 pipeline and 15b's
    passes)."""
    import copy

    from paddlebox_tpu_torch import DeepFM, InMemoryDataset, convert
    from paddlebox_tpu_torch.config import FLAGS
    from paddlebox_tpu_torch.data import DataFeedDesc, SlotDef, SlotRecord
    from paddlebox_tpu_torch.ops import index as IX
    from paddlebox_tpu_torch.ops import kernels as K
    from paddlebox_tpu_torch.ps import BoxPSHelper, SparseSGDConfig
    from paddlebox_tpu_torch.ps.sharded import ShardedEmbeddingTable
    from paddlebox_tpu_torch.ps.table import TableState
    from paddlebox_tpu_torch.ps.tiered import TieredShardedEmbeddingTable
    from paddlebox_tpu_torch.train import sharded as SH
    from paddlebox_tpu_torch.train.step import default_tx

    sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)
    t_phase = time.perf_counter()
    fns = {"gather_rows": K.gather_rows, "pool_cvm": K.pool_cvm,
           "segment_gather": K.segment_gather,
           "scatter_add_update": K.scatter_add_update,
           "scatter_rows_dma": K.scatter_rows_dma,
           "gather_rows_dma": K.gather_rows_dma,
           "index_insert": IX.insert, "index_lookup": IX.lookup}
    launches = {k: 0 for k in fns}

    def count(run):
        """``run()`` with every count set to 0 before and read after."""
        for f in fns.values():
            f.launches = 0
        out = run()
        sync()
        for k, f in fns.items():
            launches[k] += f.launches
        return out

    # ---- 15a: data, the model, the table ----
    t = {}
    t0 = time.perf_counter()
    slots = [SlotDef("label", "float", 1), SlotDef("dense", "float",
                                                   DENSE_DIM)]
    slots += [SlotDef(f"C{i}", "uint64") for i in range(1, TIER_SLOTS + 1)]
    udesc = DataFeedDesc(slots=slots, batch_size=TIER_BATCH,
                         label_slot="label",
                         key_bucket_min=TIER_BATCH * TIER_SLOTS)
    pool = []
    for s in range(2):
        ds = InMemoryDataset(udesc)
        ds.records = _uniform_records(np.random.default_rng(args.seed + 70
                                                            + s),
                                      TIER_RECORDS, SlotRecord)
        ds.columnarize()
        pool.append(ds)
    keys_a, keys_b = pool[0].pass_keys(), pool[1].pass_keys()
    overlap = len(np.intersect1d(keys_a, keys_b)) / len(keys_b)
    t["data_s"] = time.perf_counter() - t0
    cfg_a = SparseSGDConfig(mf_create_thresholds=0.0, mf_initial_range=1e-3)

    def umodel(dtype=None):
        torch.manual_seed(args.seed + 2)
        kw = {} if dtype is None else {"compute_dtype": dtype}
        return DeepFM(TIER_SLOTS, 3 + MF_DIM, DENSE_DIM, hidden=HIDDEN, **kw)

    def utable(ssd_root):
        return TieredShardedEmbeddingTable(
            TIER_N, mf_dim=MF_DIM, capacity_per_shard=TIER_CAPACITY,
            cfg=cfg_a, req_bucket_min=TIER_BUCKET_MIN,
            serve_bucket_min=TIER_BUCKET_MIN, ssd_dir=ssd_root,
            devices=dev)

    seq = [pool[i % 2] for i in range(TIER_MEASURED + 2)]
    tmp = tempfile.mkdtemp(prefix="pbx_tiered_")
    torch.use_deterministic_algorithms(True)
    try:
        # ---- 15a: the pipeline at preload depth, then at depth 0 ----
        depth = int(FLAGS.preload_depth)
        table = utable(os.path.join(tmp, "a"))
        tr = SH.ShardedTrainer(umodel(), table, udesc, seed=args.seed)
        pipe = tr.tiered_pass_pipeline(iter(seq), depth=depth)

        eps0 = {}

        def pipeline_passes():
            out = []
            pipe.start_next()
            for i in range(len(seq)):
                t0 = time.perf_counter()
                rp = pipe.wait()
                t_wait = time.perf_counter() - t0
                t1 = time.perf_counter()
                pipe.begin_pass()
                t_begin = time.perf_counter() - t1
                pipe.start_next()
                t2 = time.perf_counter()
                r = tr.train_pass_resident(rp)
                sync()
                t_train = time.perf_counter() - t2
                t3 = time.perf_counter()
                pipe.end_pass()
                t_end = time.perf_counter() - t3
                out.append(dict(wait=t_wait, begin=t_begin, train=t_train,
                                end_submit=t_end, auc=r["auc"],
                                stats=dict(table.last_pass_stats)))
                if i == 1:
                    # the measured passes' epilogue accounting starts
                    # here (the cold and warm passes drained)
                    table.fence()
                    eps0.update(table.endpass_stats())
            table.fence()
            pipe.drain()
            return out

        t0 = time.perf_counter()
        runs = count(pipeline_passes)
        t["pipeline_s"] = time.perf_counter() - t0
        eps1 = table.endpass_stats()
        ep = {k: eps1[k] - eps0[k] for k in
              ("jobs_run", "writeback_sec", "critical_fence_wait_sec")}
        ep["overlap_frac"] = (max(0.0, ep["writeback_sec"]
                                  - ep["critical_fence_wait_sec"])
                              / max(ep["writeback_sec"], 1e-9))
        digest2, dense2 = table.rows_digest(), _dense_digest(tr)
        staged = [r["stats"]["staged"] for r in runs]
        want = [len(keys_a), len(np.setdiff1d(keys_b, keys_a))] + \
            [0] * TIER_MEASURED
        if staged != want:
            raise AssertionError(f"phase 15a: staged rows {staged}, the "
                                 f"keys not yet resident {want}")
        t0 = time.perf_counter()
        t_d0 = utable(os.path.join(tmp, "a0"))
        tr_d0 = SH.ShardedTrainer(umodel(), t_d0, udesc, seed=args.seed)
        tr_d0.train_passes_tiered(seq, depth=0)
        sync()
        t["depth0_s"] = time.perf_counter() - t0
        if t_d0.rows_digest() != digest2 or _dense_digest(tr_d0) != dense2:
            raise AssertionError(f"phase 15a: depth {depth} != depth 0 by "
                                 "rows_digest and the dense params")
        del tr_d0, t_d0

        # ---- 15a: the first resident step, kernels against plain ----
        rp0 = tr.build_resident_pass(pool[0])
        rp0.upload()
        rp0.wait_ready()
        gb0 = SH._decode_wire_step(rp0, 0)
        start = [st.data.clone() for st in table.states]
        first = {}
        for name, ops in (("kernels", K.KERNELS), ("plain", K.PLAIN)):
            step = SH.ShardedTrainStep(default_tx, table.cfg, table.devices,
                                       TIER_BATCH, TIER_SLOTS, ops=ops)
            tab = copy.copy(table)
            tab.states = [TableState(x.clone(), table.opt_ext)
                          for x in start]
            st = step.init_state(tab, umodel(torch.float32))
            out = step(st, gb0, SH.push_generators(table.devices,
                                                   args.seed, 1),
                       rp0.sections)
            first[name] = (out, [x.data for x in st.tables],
                           st.model.state_dict())
        (ok, tk_, pk), (op, tp, pp) = first["kernels"], first["plain"]
        for s in range(TIER_N):
            if not torch.equal(ok["pushed"][s], op["pushed"][s]) or \
                    not torch.equal(tk_[s][:, :4], tp[s][:, :4]):
                raise AssertionError(f"phase 15a: shard {s}'s pushed "
                                     "grads or show/clk/slot, kernels vs "
                                     "plain, differ")
        first_err = max(
            [check_close(f"phase 15a: shard {s} rows", tk_[s], tp[s],
                         STATE_RTOL, STATE_ATOL) for s in range(TIER_N)]
            + [check_close(f"phase 15a: param {k}", pk[k], pp[k],
                           STATE_RTOL, STATE_ATOL) for k in pk])
        del first, start, rp0, gb0, tk_, tp

        # ---- 15a: the full re-stage control, then the SSD section ----
        helper = BoxPSHelper(table, trainer=tr)
        table.drop_window()
        t0 = time.perf_counter()
        helper.begin_pass(pool[1])
        sync()
        begin_full = time.perf_counter() - t0
        staged_full = table.last_pass_stats["staged"]
        helper.end_pass(None)
        table.fence()
        before = table.rows_digest()
        table.drop_window()
        t0 = time.perf_counter()
        demoted = sum(h.demote_cold() for h in table.hosts)
        demote_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        helper.begin_pass(pool[1])              # the promote paid inline
        sync()
        begin_ssd_sync = time.perf_counter() - t0
        sync_st = dict(table.last_pass_stats)
        helper.end_pass(None)
        if table.rows_digest() != before:
            raise AssertionError("phase 15a: the demote → promote round "
                                 "trip changed rows_digest")
        table.drop_window()
        sum(h.demote_cold() for h in table.hosts)
        helper.begin_pass(pool[0])
        helper.stage_pass(pool[1])              # B's promote rides A's pass
        tr.train_pass_resident(pool[0])
        helper.end_pass(pool[0])
        t0 = time.perf_counter()
        helper.begin_pass(pool[1])
        sync()
        begin_ssd_overlap = time.perf_counter() - t0
        ov_st = dict(table.last_pass_stats)
        helper.end_pass(None)
        table.fence()
        ssd_a = table.ssd_stats()
        del helper, tr, table, pipe
        t["a_s"] = time.perf_counter() - t_phase

        # ---- 15b: a window smaller than the model ----
        t_b = time.perf_counter()
        base = make_table_blob(np.random.default_rng(args.seed + 1), convert,
                               vocab=TRAIN_BASE_VOCAB, no_mf=0.25)
        records = make_records(np.random.default_rng(args.seed + 13),
                               BATCH * SHARD_BATCHES, SlotRecord)
        per_pass = SHARD_N
        passes = []
        for i in range(0, SHARD_BATCHES, per_pass):
            ds = InMemoryDataset(desc)
            ds.records = records[i * BATCH:(i + per_pass) * BATCH]
            passes.append(ds)
        ws = [len(ds.pass_keys()) for ds in passes]
        per_shard_ws = [int(np.bincount(
            (ds.pass_keys() % np.uint64(TIER_N)).astype(np.int64),
            minlength=TIER_N).max()) for ds in passes]
        log(f"phase 15b: {len(passes)} passes of {per_pass} x {BATCH} "
            f"records; working set a pass {ws}, the fullest shard's "
            f"{per_shard_ws} against a window of {WINDOW_CAPACITY} rows a "
            f"shard; model {len(base['keys'])} base rows")
        if max(per_shard_ws) > WINDOW_CAPACITY:
            raise AssertionError("phase 15b: a pass does not fit a window")
        cfg_b = SparseSGDConfig(mf_create_thresholds=0.0,
                                mf_initial_range=0.0)

        def bmodel():
            torch.manual_seed(args.seed + 2)
            return DeepFM(NUM_SLOTS, 3 + MF_DIM, DENSE_DIM, hidden=HIDDEN)

        t0 = time.perf_counter()
        win = TieredShardedEmbeddingTable(
            TIER_N, mf_dim=MF_DIM, capacity_per_shard=WINDOW_CAPACITY,
            cfg=cfg_b, host_capacity=WINDOW_HOST,
            ssd_dir=os.path.join(tmp, "b"), devices=dev)
        win.load(base)
        t["b_load_s"] = time.perf_counter() - t0
        load_ssd = int(win.ssd_stats().get("live_rows", 0))
        tr_w = SH.ShardedTrainer(bmodel(), win, desc, seed=args.seed)
        orig_begin, orig_end = win.begin_pass, win.end_pass
        pass_log = []
        mark = [0.0]

        def begin(keys=None):
            # at depth 0 the time since the last end_pass (or the start)
            # is the wait for the pass's build and host fetch
            t0 = time.perf_counter()
            n = orig_begin(keys)
            sync()
            pass_log.append(dict(wait_s=t0 - mark[0],
                                 begin_s=time.perf_counter() - t0))
            return n

        def end():
            t0 = time.perf_counter()
            n = orig_end()
            mark[0] = time.perf_counter()
            pass_log[-1].update(end_submit_s=mark[0] - t0,
                                stats=dict(win.last_pass_stats),
                                window=[len(ix) for ix in win.indexes])
            return n

        win.begin_pass, win.end_pass = begin, end
        t0 = mark[0] = time.perf_counter()
        res_w = count(lambda: tr_w.train_passes_tiered(passes, depth=0))
        win.fence()
        t["b_passes_s"] = time.perf_counter() - t0
        win.begin_pass, win.end_pass = orig_begin, orig_end
        for p in pass_log:
            if max(p["window"]) > WINDOW_CAPACITY:
                raise AssertionError(f"phase 15b: a window holds "
                                     f"{max(p['window'])} rows")
        totals = {k: sum(p["stats"].get(k, 0) for p in pass_log)
                  for k in ("staged", "evicted", "evicted_writeback",
                            "written_back", "evict_async_rows",
                            "ssd_promoted_rows")}
        if not all(totals[k] for k in ("staged", "written_back")) or not (
                totals["evicted"] + totals["evict_async_rows"]):
            raise AssertionError(f"phase 15b: no eviction or write-back "
                                 f"{totals}")
        ssd_b = win.ssd_stats()
        ep_b = win.endpass_stats()
        # the plain sharded table over the same passes
        t0 = time.perf_counter()
        plain = ShardedEmbeddingTable(SHARD_N, mf_dim=MF_DIM,
                                      capacity_per_shard=SHARD_CAPACITY,
                                      cfg=cfg_b, devices=dev)
        plain.load(base)
        tr_p = SH.ShardedTrainer(bmodel(), plain, desc, seed=args.seed)
        res_p = [tr_p.train_pass_resident(ds) for ds in passes]
        sync()
        t["b_plain_s"] = time.perf_counter() - t0
        wk, wr = _host_model(win)
        pk_, pr = _host_model(plain)
        if not np.array_equal(wk, pk_):
            raise AssertionError("phase 15b: the tiered model's keys differ "
                                 "from the plain table's")
        if not np.array_equal(wr[:, :2], pr[:, :2]):
            raise AssertionError("phase 15b: show/clk differ from the "
                                 "plain table's")
        b_row_err = check_close("phase 15b: rows vs the plain table",
                                torch.from_numpy(wr), torch.from_numpy(pr),
                                STATE_RTOL, STATE_ATOL)
        sd_w, sd_p = tr_w.model.state_dict(), tr_p.model.state_dict()
        b_param_err = max(check_close(f"phase 15b: param {k}", sd_w[k],
                                      sd_p[k], STATE_RTOL, STATE_ATOL)
                          for k in sd_w)
        auc_w = [r["auc"] for r in res_w]
        auc_p = [r["auc"] for r in res_p]
        del wr, pr, tr_p, plain

        # ---- rows 3 and 4 at the window's real sizes (timed outside
        # the deterministic mode: index_copy_ and index_select are the
        # library's calls as they run by default) ----
        torch.use_deterministic_algorithms(False)
        flush = torch.empty(1 << 26, dtype=torch.float32, device=dev) \
            if dev == "cuda" else None
        data = win.states[0].data
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        last = pass_log[-1]["stats"]
        k_scatter = max(1, int(max(p["stats"]["staged"]
                                   for p in pass_log[1:]) // TIER_N))
        k_gather = max(1, int(last["written_back"] // TIER_N))
        copy_t = {}
        for name, k in (("scatter", k_scatter), ("gather", k_gather)):
            rows = torch.randperm(WINDOW_CAPACITY, generator=gen,
                                  device=dev)[:k].int()
            kp = k if k <= 2048 else -(-k // 2048) * 2048
            rows_p = torch.full((kp,), WINDOW_CAPACITY, dtype=torch.int32,
                                device=dev)
            rows_p[:k] = rows
            rows_l = rows_p.long()
            feat = data.shape[1]
            row_bound = (kp * 4 + (k + 1) * feat * 4 * 2) / PEAK_BYTES * 1e3
            if name == "scatter":
                vals = torch.randn((kp, feat), generator=gen, device=dev)
                vals[k:] = 0.0
                a, b_ = data.clone(), data.clone()
                K.scatter_rows_dma(a, rows_p, vals)
                K.scatter_rows_dma_plain(b_, rows_p, vals)
                sync()
                if not torch.equal(a, b_):
                    raise AssertionError("phase 15b: scatter_rows_dma "
                                         "differs from its plain version "
                                         f"at {k} rows")
                fns_t = {"kernel": lambda: K.scatter_rows_dma(a, rows_p,
                                                              vals),
                         "index_copy_": lambda: b_.index_copy_(0, rows_l,
                                                               vals),
                         "scatter_rows": lambda: K.scatter_rows(a, rows_p,
                                                                vals)}
                plain_fn = lambda: K.scatter_rows_dma_plain(b_, rows_p,
                                                            vals)
            else:
                got = K.gather_rows_dma(data, rows_p)
                if not torch.equal(got, K.gather_rows_dma_plain(data,
                                                                rows_p)):
                    raise AssertionError("phase 15b: gather_rows_dma "
                                         "differs from its plain version "
                                         f"at {k} rows")
                fns_t = {"kernel": lambda: K.gather_rows_dma(data, rows_p),
                         "index_select": lambda: torch.index_select(
                             data, 0, rows_l),
                         "gather_rows": lambda: K.gather_rows(data, rows_p)}
                plain_fn = lambda: K.gather_rows_dma_plain(data, rows_p)
            if dev == "cuda":
                reps = alternating_ms(torch, fns_t, flush)
                copy_t[name] = dict(
                    rows=k, padded=kp, bound_ms=row_bound,
                    plain_ms=time_ms(torch, plain_fn, flush),
                    medians={n: r["median"] for n, r in reps.items()},
                    spreads={n: r["spread"] for n, r in reps.items()})
            else:
                copy_t[name] = dict(rows=k, padded=kp, bound_ms=row_bound)
        del flush, win, tr_w
        t["b_s"] = time.perf_counter() - t_b
    finally:
        torch.use_deterministic_algorithms(False)
        shutil.rmtree(tmp, ignore_errors=True)
    for k in ("gather_rows", "pool_cvm", "segment_gather",
              "scatter_add_update", "scatter_rows_dma", "gather_rows_dma"):
        if dev == "cuda" and launches[k] == 0:
            raise AssertionError(f"phase 15: {k} never launched")
    phase_s = time.perf_counter() - t_phase
    meas = runs[2:]
    walls = [r["wait"] + r["begin"] + r["train"] + r["end_submit"]
             for r in meas]
    eps_a = TIER_RECORDS * len(meas) / sum(walls)
    log(f"tiered 15a: {TIER_N} shards of {TIER_CAPACITY} rows, "
        f"{len(seq)} passes of {TIER_RECORDS} uniform records "
        f"({TIER_SLOTS} one-key slots, batch {TIER_BATCH}, key overlap "
        f"{overlap:.3f}) at depth {depth}: staged {staged}; cold pass "
        f"wait+begin {runs[0]['wait'] + runs[0]['begin']:.3f}s, warm "
        f"{runs[1]['wait'] + runs[1]['begin']:.3f}s; measured preload wait "
        f"{[round(r['wait'], 4) for r in meas]}s, reconcile-only begin "
        f"{[round(r['begin'], 4) for r in meas]}s, train "
        f"{[round(r['train'], 4) for r in meas]}s, end_pass submit "
        f"{[round(r['end_submit'], 4) for r in meas]}s, written back "
        f"{[r['stats']['written_back'] for r in runs]}, evicted "
        f"{[r['stats']['evicted'] for r in runs]}, SSD promote "
        f"{[r['stats'].get('ssd_promote_sec') for r in runs]}s; {eps_a:.0f} "
        f"examples/s with the boundaries; epilogue {ep['jobs_run']} jobs, "
        f"write-back {ep['writeback_sec']:.3f}s, main-thread fence wait "
        f"{ep['critical_fence_wait_sec']:.3f}s, overlapped "
        f"{ep['overlap_frac']:.1%}; depth {depth} == depth 0 by "
        f"rows_digest and the dense params ({t['depth0_s']:.1f}s); first "
        f"resident step kernels vs plain max abs err {first_err:.3g} "
        f"({card})")
    log(f"tiered 15a control and SSD: drop_window full re-stage of "
        f"{staged_full} rows {begin_full:.3f}s; demote_cold of the model "
        f"{demoted} rows {demote_s:.3f}s; begin_pass with the promote "
        f"inline {begin_ssd_sync:.3f}s (promoted "
        f"{sync_st.get('ssd_promoted_rows')} rows, "
        f"{sync_st.get('ssd_promote_sec')}s, main thread "
        f"{sync_st.get('ssd_promote_wait_sec')}s), with the promote ridden "
        f"on the previous pass {begin_ssd_overlap:.3f}s (promoted "
        f"{ov_st.get('ssd_promoted_rows')} rows, "
        f"{ov_st.get('ssd_promote_sec')}s, main thread "
        f"{ov_st.get('ssd_promote_wait_sec')}s); round trip == by "
        f"rows_digest ({card})")
    for i, p in enumerate(pass_log):
        st = p["stats"]
        log(f"tiered 15b pass {i}: build and fetch wait {p['wait_s']:.3f}s, "
            f"reconcile begin {p['begin_s']:.3f}s, train "
            f"{res_w[i]['elapsed_sec']:.3f}s, end_pass "
            f"submit {p['end_submit_s']:.3f}s, staged {st['staged']}, "
            f"resident {st['resident']}, evicted {st['evicted']} (written "
            f"back {st['evicted_writeback']}), evicted ahead "
            f"{st.get('evict_async_rows')}, written back "
            f"{st['written_back']}, SSD promoted "
            f"{st.get('ssd_promoted_rows')} rows in "
            f"{st.get('ssd_promote_sec')}s, windows {p['window']} ({card})")
    n_b = BATCH * SHARD_BATCHES
    log(f"tiered 15b: base {len(base['keys'])} rows into {TIER_N} windows "
        f"of {WINDOW_CAPACITY} over host stores of {WINDOW_HOST} "
        f"({load_ssd} rows to segments at load, {t['b_load_s']:.2f}s); "
        f"{len(passes)} passes at depth 0 in {t['b_passes_s']:.2f}s "
        f"({n_b / t['b_passes_s']:.0f} examples/s with the boundaries; "
        f"the plain table {n_b / t['b_plain_s']:.0f} with its load); totals "
        f"{json.dumps(totals)}; SSD {json.dumps({k: round(v, 4) for k, v in ssd_b.items()})}; "
        f"epilogue write-back {ep_b['writeback_sec']:.3f}s, overlapped "
        f"{ep_b['overlap_sec'] / max(ep_b['writeback_sec'], 1e-9):.1%}; "
        f"== the plain sharded table: show/clk exact, max abs err rows "
        f"{b_row_err:.3g} params {b_param_err:.3g}; auc {auc_w} vs "
        f"{auc_p} ({card})")
    for name, c in copy_t.items():
        if "medians" in c:
            log(f"  window {name} of {c['rows']} rows ({c['padded']} "
                f"padded) a shard: "
                + ", ".join(f"{n} {v:.4f} ms (spread {c['spreads'][n]:.4f})"
                            for n, v in c["medians"].items())
                + f", medians of 5 alternating repeats; plain "
                f"{c['plain_ms']:.4f} ms; bound {c['bound_ms'] * 1e3:.2f} "
                f"us ({card})")
    log(f"phase 15 took {phase_s:.1f}s (15a {t['a_s']:.1f}, 15b "
        f"{t['b_s']:.1f}); launches {json.dumps(launches)} ({card})")
    details["tiered"] = dict(
        t, depth=depth, staged=staged, passes=runs, epilogue=ep,
        overlap=overlap, examples_per_sec=eps_a, first_step_err=first_err,
        begin_full_s=begin_full, staged_full=staged_full,
        demoted=demoted, demote_s=demote_s, begin_ssd_sync_s=begin_ssd_sync,
        ssd_sync=sync_st, begin_ssd_overlap_s=begin_ssd_overlap,
        ssd_overlap=ov_st, ssd_a=ssd_a, window=dict(
            passes=pass_log, totals=totals, ssd=ssd_b, epilogue=ep_b,
            load_ssd_rows=load_ssd, row_err=b_row_err,
            param_err=b_param_err, auc=auc_w, auc_plain=auc_p,
            working_set=ws, per_shard_working_set=per_shard_ws),
        copies=copy_t, launches=launches, phase_s=phase_s)
    return launches


MMF_DIMS = [4] * 10 + [8] * 10 + [16] * 6  # phase 16: the class pattern of
                                           # examples/train_multi_mf.py
MMF_HIDDEN = (400, 400, 400)     # phase 16: CtrDnn at the registry width
MMF_CAPACITY = 1 << 21           # 16a: rows a class table
MMF_SERVE_BATCHES = 2            # 16a: batches the server predicts
MMF_EXT_SKIP = (0, 13)           # 16d: the extended table's skipped slots
MMF_EXT_CAPACITY = 1 << 20       # 16d: rows of each of its two tables
MMF_REPLICA_ROWS = 100_000       # 16d: replica cache rows, 8 wide


def make_mmf_blobs(rng, convert, dims, vocab: int = TRAIN_BASE_VOCAB,
                   no_mf: float = 0.25, num_slots: int = NUM_SLOTS,
                   stride: int = VOCAB_PER_SLOT):
    """Phase 5's base ids split by dim class: per class (widths in
    ascending order) the keys with id < ``vocab`` of its slots, with
    seeded logical rows 8 + d wide, a ``no_mf`` share without mf yet."""
    keys = base_keys(vocab, num_slots, stride)
    dim_of_key = np.asarray(dims)[(keys // np.uint64(stride)).astype(
        np.int64)]
    out = []
    for d in sorted(set(dims)):
        k = keys[dim_of_key == d]
        n = len(k)
        rows = np.zeros((n, 8 + d), np.float32)
        show = rng.integers(1, 200, size=n).astype(np.float32)
        rows[:, 0] = show
        rows[:, 1] = np.floor(show * rng.random(n, dtype=np.float32) * 0.3)
        rows[:, 2] = rng.random(n, dtype=np.float32)
        rows[:, 3] = (k // np.uint64(stride)).astype(np.float32)
        rows[:, 4] = rng.normal(0, 0.05, size=n).astype(np.float32)
        rows[:, 5:7] = 3.0
        rows[:, 7] = 1.0
        rows[:, 8:] = rng.normal(0, 0.05, size=(n, d)).astype(np.float32)
        lazy = rng.random(n) < no_mf
        rows[lazy, 7] = 0.0
        rows[lazy, 8:] = 0.0
        out.append(convert.table_rows_from_logical(k, rows, d))
    return out


def _class_width_timing(torch, K, state, cb, dev, flush, gen) -> dict:
    """Rows 1, 7, 6 and 13 on one class's sub-batch of batch 0 at its
    widths, each against its plain version (exact but the pool, which
    holds the pooling class) and, on the card, timed alone beside its
    plain version with its bound (bytes over ``PEAK_BYTES``)."""
    from paddlebox_tpu_torch.ps.table import expand_pull, pull_values
    from paddlebox_tpu_torch.train.step import make_device_batch
    table = state.data
    cap, feat = table.shape[0] - 1, table.shape[1]
    d = feat - 8
    b = cb.batch.batch_size
    s_c = cb.batch.num_slots
    dv = make_device_batch(cb.batch, cb.index, dev)
    rows = dv.unique_rows
    u = cb.index.num_unique
    k = cb.batch.num_keys
    n_seg = b * s_c
    out = {"mf_dim": d, "row_floats": feat, "value_floats": 3 + d,
           "slots": s_c, "unique_rows": u, "keys": k}
    timed = dev == "cuda"
    # row 1: the pull's gather of the class's unique rows
    got = K.gather_rows(table, rows)
    if not torch.equal(got, K.gather_rows_plain(table, rows)):
        raise AssertionError(f"phase 16: gather_rows differs at width {feat}")
    values = expand_pull(pull_values(got, d),
                         dv.gather_idx[:k]).contiguous()
    segs = dv.segments[:k].contiguous()
    # row 7: the pool over the class's slots at value width 3 + d
    pooled = K.pool_cvm(values, segs, None, b, s_c)
    err7 = check_close(f"phase 16: pool_cvm at width {3 + d}", pooled,
                       K.pool_cvm_plain(values, segs, None, b, s_c),
                       POOL_RTOL, POOL_ATOL)
    # row 6: the pool backward's fused gather (head show/clk)
    g_out = torch.randn((n_seg, 3 + d), generator=gen, device=dev)
    src = g_out[:, 2:]
    head = dv.show_clk.contiguous()
    sg_args = (src, segs, head, None, b, s_c, 0)
    if not torch.equal(K.segment_gather(*sg_args),
                       K.segment_gather_plain(*sg_args)):
        raise AssertionError(f"phase 16: segment_gather differs at width "
                             f"{3 + d}")
    # row 13: the push's write-back into a copy of the class table
    deltas = torch.randn((rows.shape[0], feat), generator=gen,
                         device=dev) * 1e-3
    vals_k, vals_p = table[:cap].clone(), table[:cap].clone()
    K.scatter_add_update(vals_k, rows, deltas)
    K.scatter_add_update_plain(vals_p, rows, deltas)
    if not torch.equal(vals_k, vals_p):
        raise AssertionError(f"phase 16: scatter_add_update differs at "
                             f"width {feat}")
    out["pool_max_abs_err"] = err7
    n_src = int(torch.unique(segs[(segs >= 0) & (segs < n_seg)]).numel())
    bounds = {
        "gather_rows": (2 * u * feat * 4 + u * 4),
        "pool_cvm": max(k * (3 + d + 1) * 4 + n_seg * (3 + d) * 4,
                        k * (3 + d) * PEAK_BYTES / PEAK_F32),
        "segment_gather": (k * 4 + head.numel() * 4 + n_src * (d + 1) * 4
                           + k * (3 + d) * 4),
        "scatter_add_update": (rows.shape[0] * 4 + u * 3 * feat * 4)}
    out["bound_ms"] = {n: v / PEAK_BYTES * 1e3 for n, v in bounds.items()}
    if timed:
        calls = {
            "gather_rows": (lambda: K.gather_rows(table, rows),
                            lambda: K.gather_rows_plain(table, rows)),
            "pool_cvm": (lambda: K.pool_cvm(values, segs, None, b, s_c),
                         lambda: K.pool_cvm_plain(values, segs, None, b,
                                                  s_c)),
            "segment_gather": (lambda: K.segment_gather(*sg_args),
                               lambda: K.segment_gather_plain(*sg_args)),
            "scatter_add_update": (
                lambda: K.scatter_add_update(vals_k, rows, deltas),
                lambda: K.scatter_add_update_plain(vals_p, rows, deltas))}
        out["ms"] = {n: time_ms(torch, c[0], flush)
                     for n, c in calls.items()}
        out["plain_ms"] = {n: time_ms(torch, c[1], flush)
                           for n, c in calls.items()}
    return out


def multi_mf_phase(torch, args, card, desc, records, batches, details,
                   dev: str = "cuda") -> dict:
    """Phase 16: multi-mf, per-slot embedding widths (``MMF_DIMS``: 10
    slots of 4, 10 of 8, 6 of 16; pooled width 294 + 13 dense) at phase
    5's width, ``CtrDnn`` at ``MMF_HIDDEN`` with phase 5's Adagrad, one
    base file a dim class from phase 5's base ids.

    16a, the single table (``MultiMfEmbeddingTable``, ``MMF_CAPACITY``
    rows a class): the first step of batch 0 through the kernels against
    the plain versions (f32 tower; the per-class pulls and show/clk
    exact, rows and params in the ragged train-state class); rows 1, 7,
    6 and 13 against their plain versions at each class width, timed
    alone with their bounds; under deterministic algorithms the main
    path, ``MultiMfTrainer.train_pass`` over phase 5's batches, and
    ``train_pass_resident`` over the same batches from the same start,
    bit for bit; ``save_base`` → ``MultiMfServingModel`` ``load_base`` +
    ``load_dense`` → ``predict`` on ``MMF_SERVE_BATCHES`` batches against
    the trainer's forward (atol ``PRED_ATOL``).

    16b, sharded (``MultiMfShardedTable``, ``SHARD_N`` shards of
    ``SHARD_CAPACITY`` rows a class, on the one card) over phase 13's
    local batches, lazy mf drawing nothing: the first global step,
    kernels against plain (pushed grads, show/clk and slots exact);
    ``train_pass`` (the main path) and the overlapped push order
    (``a2a_chunks`` ``SHARD_CHUNKS``) step by step with the synchronized
    split, bit for bit; the sharded model's rows (its save's fields, in
    memory: phase 13 writes and reads a sharded save on the card) loaded
    into a single ``MultiMfEmbeddingTable`` pull the same values.

    16c, tiered (``MultiMfTieredShardedTable`` through ``BoxPSHelper``
    and ``MultiMfShardedTrainer``): the same batches as passes of one
    global step, each class's window a shard between the largest
    per-shard working set of a pass and the class's per-shard model, host
    stores below the model with SSD tiers; the model read back through
    the host tiers and the dense params equal 16b's plain table bit for
    bit; a ``stage_pass`` of the open pass leaves ``staged == 0`` at the
    next ``begin_pass``; rows 3 and 4 against their plain versions at
    each class width on the last pass's delta and write-back rows.

    16d, the remaining PS helpers: an ``ExtendedEmbeddingTable`` (mf 8 +
    extend 8, ``MMF_EXT_SKIP`` skipped) pull/push on batch 0 through the
    kernels against the plain versions, and ``ReplicaCache`` on the card
    against numpy. Returns the kernels' launches in the main path (16a's
    and 16b's ``train_pass``, 16c's passes, 16d's kernel run)."""
    from paddlebox_tpu_torch import InMemoryDataset, convert
    from paddlebox_tpu_torch.config import flags_scope
    from paddlebox_tpu_torch.data import BatchBuilder, SlotRecord
    from paddlebox_tpu_torch.metrics import init_auc_state
    from paddlebox_tpu_torch.models import CtrDnn
    from paddlebox_tpu_torch.ops import kernels as K
    from paddlebox_tpu_torch.ps import (BoxPSHelper, ExtendedEmbeddingTable,
                                        MultiMfEmbeddingTable,
                                        MultiMfShardedTable,
                                        MultiMfTieredShardedTable,
                                        ReplicaCache, SparseSGDConfig)
    from paddlebox_tpu_torch.ps.multi_mf import SlotClassMap
    from paddlebox_tpu_torch.ps.table import (RowsToHost, TableState,
                                              rows_from_store_fields,
                                              scatter_window_rows)
    from paddlebox_tpu_torch.serving import MultiMfServingModel
    from paddlebox_tpu_torch.train import sharded as SH
    from paddlebox_tpu_torch.train.multi_mf_sharded import (
        MultiMfShardedTrainer, MultiMfShardedTrainStep,
        class_push_generators, make_mmf_global_batch)
    from paddlebox_tpu_torch.train.multi_mf_step import (
        MultiMfStepState, MultiMfTrainer, MultiMfTrainStep,
        class_device_batches, class_generators, multi_mf_forward)
    from paddlebox_tpu_torch.train.step import default_tx

    sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)
    t_phase = time.perf_counter()
    t = {}
    fns = {"gather_rows": K.gather_rows, "pool_cvm": K.pool_cvm,
           "segment_gather": K.segment_gather,
           "scatter_add_update": K.scatter_add_update,
           "scatter_rows_dma": K.scatter_rows_dma,
           "gather_rows_dma": K.gather_rows_dma}
    launches = {k: 0 for k in fns}
    part_launches = {}

    def count(part, run):
        """``run()`` with every count set to 0 before and read after."""
        for f in fns.values():
            f.launches = 0
        out = run()
        sync()
        got = {k: f.launches for k, f in fns.items()}
        part_launches[part] = got
        for k, n in got.items():
            launches[k] += n
        return out

    flush = (torch.empty(1 << 26, dtype=torch.float32, device=dev)
             if dev == "cuda" else None)
    gen = torch.Generator(device=dev).manual_seed(args.seed + 16)
    t0 = time.perf_counter()
    blobs = make_mmf_blobs(np.random.default_rng(args.seed + 16), convert,
                           MMF_DIMS)
    t["data_s"] = time.perf_counter() - t0
    n_base = [len(b["keys"]) for b in blobs]

    def model(dtype=None):
        torch.manual_seed(args.seed + 16)
        kw = {} if dtype is None else {"compute_dtype": dtype}
        return CtrDnn(1, SlotClassMap(MMF_DIMS).pooled_width(), DENSE_DIM,
                      hidden=MMF_HIDDEN, **kw)

    def single_table(cfg=None):
        tab = MultiMfEmbeddingTable(MMF_DIMS, capacity=MMF_CAPACITY,
                                    cfg=cfg, seed=args.seed, device=dev)
        convert.load_multi_mf(tab, blobs)
        return tab

    tmp = tempfile.mkdtemp(prefix="mmf_smoke_")
    out = {"dims": sorted(set(MMF_DIMS)), "base_rows": n_base}
    try:
        # ==== 16a: the single table ====
        t_a = time.perf_counter()
        t0 = time.perf_counter()
        table = single_table()
        sync()
        t["a_load_s"] = time.perf_counter() - t0
        route = table.slot_route()
        class_slots = [len(s) for s in table.class_slots]
        nc = table.num_classes
        cbs0 = table.prepare(batches[0])
        start = [tb.state.data.clone() for tb in table.tables]
        steps = {}
        for what, ops in (("kernels", K.KERNELS), ("plain", K.PLAIN)):
            m = model(torch.float32).to(dev)
            st = MultiMfStepState(
                tables=[TableState(s.clone(), tb.state.ext)
                        for s, tb in zip(start, table.tables)],
                model=m, opt=default_tx(m.parameters()),
                auc=init_auc_state(device=dev))
            devs = class_device_batches(cbs0, dev)
            pulls = [ops.gather_rows(s.data, dv.unique_rows)
                     for s, dv in zip(st.tables, devs)]
            stats = MultiMfTrainStep(table, BATCH, ops=ops)(
                st, devs, class_generators(dev, args.seed, 1, nc),
                [cb.index.num_unique for cb in cbs0])
            if not np.isfinite(float(stats["loss"])):
                raise AssertionError(f"phase 16a {what}: non-finite loss")
            steps[what] = (st, pulls)
        del start
        (sk, pk), (sp, pp) = steps["kernels"], steps["plain"]
        for a, b in zip(pk, pp):
            if not torch.equal(a, b):
                raise AssertionError("phase 16a: a class pull, kernels vs "
                                     "plain, differs")
        a_row_err = 0.0
        for c, (a, b) in enumerate(zip(sk.tables, sp.tables)):
            if not torch.equal(a.data[:, :2], b.data[:, :2]):
                raise AssertionError(f"phase 16a: class {c} show/clk, "
                                     "kernels vs plain, differ")
            a_row_err = max(a_row_err, check_close(
                f"phase 16a: class {c} rows, kernels vs plain", a.data,
                b.data, STATE_RTOL, STATE_ATOL))
        pk_, pp_ = sk.model.state_dict(), sp.model.state_dict()
        a_param_err = max(check_close(f"phase 16a: param {k}", pk_[k],
                                      pp_[k], STATE_RTOL, STATE_ATOL)
                          for k in pk_)
        del steps, sk, sp, pk, pp, pk_, pp_
        widths = [_class_width_timing(torch, K, tb.state, cb, dev, flush,
                                      gen)
                  for tb, cb in zip(table.tables, cbs0)]
        out["class_widths"] = widths

        def dataset(recs):
            ds = InMemoryDataset(desc)
            ds.records = recs
            return ds

        torch.use_deterministic_algorithms(True)
        try:
            tr_a = MultiMfTrainer(model(), table, desc, seed=args.seed)
            t0 = time.perf_counter()
            res_a = count("16a", lambda: tr_a.train_pass(dataset(records)))
            t["a_pass_s"] = time.perf_counter() - t0
            if res_a["batches"] != len(batches) or not np.isfinite(
                    res_a["last_loss"]):
                raise AssertionError(f"phase 16a train_pass: {res_a}")
            tr_r = MultiMfTrainer(model(), single_table(), desc,
                                  seed=args.seed)
            t0 = time.perf_counter()
            res_r = tr_r.train_pass_resident(dataset(records))
            sync()
            t["a_resident_s"] = time.perf_counter() - t0
            diffs = [float((a.state.data - b.state.data).abs().max())
                     for a, b in zip(table.tables, tr_r.table.tables)]
            pdiff = max(float((v - tr_r.model.state_dict()[k]).abs().max())
                        for k, v in tr_a.model.state_dict().items())
            if max(diffs) or pdiff or res_r["auc"] != res_a["auc"]:
                raise AssertionError(
                    f"phase 16a: the resident pass differs from train_pass"
                    f" (rows max abs {diffs}, params {pdiff}, auc "
                    f"{res_r['auc']} vs {res_a['auc']})")
            del tr_r
        finally:
            torch.use_deterministic_algorithms(False)

        # save_base → the multi-mf server → predict
        t0 = time.perf_counter()
        path = os.path.join(tmp, "mmf_base")
        n_saved = table.save_base(path)
        dense_path = os.path.join(tmp, "dense.pt")
        torch.save({"model": tr_a.model.state_dict()}, dense_path)
        t["a_save_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        srv = MultiMfServingModel(model(), desc, MMF_DIMS,
                                  capacity=MMF_CAPACITY, device=dev)
        if srv.load_base(path) != n_saved:
            raise AssertionError("phase 16a: the server loaded another "
                                 "row count")
        srv.load_dense(dense_path)
        sync()
        t["a_srv_load_s"] = time.perf_counter() - t0
        lat, pred_err = [], 0.0
        tr_a.model.eval()
        for b in batches[:MMF_SERVE_BATCHES]:
            t0 = time.perf_counter()
            pred, ins_w = srv.predict(b, return_valid=True)
            lat.append((time.perf_counter() - t0) * 1e3)
            if pred.shape != (BATCH,) or not np.isfinite(pred).all():
                raise AssertionError("phase 16a: misshapen or non-finite "
                                     "predictions")
            with torch.inference_mode():
                want, _ = multi_mf_forward(
                    tr_a.state.tables, tr_a.model,
                    class_device_batches(table.prepare_eval(b), dev), BATCH,
                    class_slots, route)
            pred_err = max(pred_err, float(np.abs(
                pred - want.cpu().numpy()).max()))
        tr_a.model.train()
        if pred_err > PRED_ATOL:
            raise AssertionError(f"phase 16a: served predictions differ "
                                 f"from the trainer's by {pred_err:.3g}")
        del srv
        out["a"] = dict(
            first_step=dict(row_max_abs_err=a_row_err,
                            param_max_abs_err=a_param_err),
            train_pass=res_a, resident=res_r, saved_rows=n_saved,
            predict_ms=lat, predict_p50_ms=float(np.median(lat)),
            pred_max_abs_err=pred_err,
            features=[tb.feature_count for tb in table.tables])
        del table, tr_a
        t["a_s"] = time.perf_counter() - t_a

        # ==== 16b: sharded ====
        t_b = time.perf_counter()
        sh_records = make_records(np.random.default_rng(args.seed + 13),
                                  BATCH * SHARD_BATCHES, SlotRecord)
        builder = BatchBuilder(desc)
        sh_batches = [builder.build(sh_records[i:i + BATCH])
                      for i in range(0, len(sh_records), BATCH)]
        groups = list(SH.group_batches(sh_batches, SHARD_N))
        cfg0 = SparseSGDConfig(mf_create_thresholds=0.0,
                               mf_initial_range=0.0)

        def sharded(cls=MultiMfShardedTable, **kw):
            kw.setdefault("capacity_per_shard", SHARD_CAPACITY)
            tab = cls(SHARD_N, MMF_DIMS, cfg=cfg0, devices=dev, **kw)
            convert.load_multi_mf(tab, blobs)
            return tab

        t0 = time.perf_counter()
        plain = sharded()
        sync()
        t["b_load_s"] = time.perf_counter() - t0
        subs = [plain.split_batch(b)[0] for b in groups[0]]
        gb = make_mmf_global_batch(
            groups[0], subs, plain.prepare_global_from_subs(subs),
            plain.devices)
        runs = {}
        for what, ops in (("kernels", K.KERNELS), ("plain", K.PLAIN)):
            step = MultiMfShardedTrainStep(default_tx, plain, BATCH,
                                           ops=ops)
            st = step.init_state(model(torch.float32))
            st.tables = [[TableState(s.data.clone(), s.ext)
                          for s in tb.states] for tb in plain.tables]
            stats = step(st, gb, class_push_generators(
                plain.devices, args.seed, 1, nc))
            runs[what] = (st, stats)
        (sk, k_), (sp, p_) = runs["kernels"], runs["plain"]
        for ck, cp in zip(k_["pushed"], p_["pushed"]):
            for a, b in zip(ck, cp):
                if not torch.equal(a, b):
                    raise AssertionError("phase 16b: pushed grads, kernels "
                                         "vs plain, differ")
        b_row_err = 0.0
        for c, (ck, cp) in enumerate(zip(sk.tables, sp.tables)):
            for a, b in zip(ck, cp):
                if not torch.equal(a.data[:, [0, 1, 3]],
                                   b.data[:, [0, 1, 3]]):
                    raise AssertionError(f"phase 16b: class {c} show/clk/"
                                         "slot, kernels vs plain, differ")
                b_row_err = max(b_row_err, check_close(
                    f"phase 16b: class {c} rows, kernels vs plain", a.data,
                    b.data, STATE_RTOL, STATE_ATOL))
        pk_, pp_ = sk.model.state_dict(), sp.model.state_dict()
        b_param_err = max(check_close(f"phase 16b: param {k}", pk_[k],
                                      pp_[k], STATE_RTOL, STATE_ATOL)
                          for k in pk_)
        del runs, sk, sp, k_, p_, pk_, pp_, gb

        torch.use_deterministic_algorithms(True)
        try:
            tr_1 = MultiMfShardedTrainer(model(), plain, desc,
                                         seed=args.seed)
            t0 = time.perf_counter()
            res_1 = count("16b", lambda: tr_1.train_pass(
                dataset(sh_records)))
            t["b_pass_s"] = time.perf_counter() - t0
            if res_1["batches"] != len(groups) or not np.isfinite(
                    res_1["last_loss"]):
                raise AssertionError(f"phase 16b train_pass: {res_1}")
            # the overlapped push order, one global step at a time with
            # the synchronized split
            with flags_scope(a2a_chunks=SHARD_CHUNKS):
                tab2 = sharded()
                tr_2 = MultiMfShardedTrainer(model(), tab2, desc,
                                             seed=args.seed)
            if not tr_2.step_fn.a2a_overlap:
                raise AssertionError("phase 16b: the overlap order is off")
            split = {"plan_ms": [], "stage_ms": [], "step_ms": []}
            for g in groups:
                t0 = time.perf_counter()
                subs = [tab2.split_batch(b)[0] for b in g]
                plans = tab2.prepare_global_from_subs(subs)
                t1 = time.perf_counter()
                gb = make_mmf_global_batch(g, subs, plans, tab2.devices)
                sync()
                t2 = time.perf_counter()
                tr_2.global_step += 1
                tr_2.step_fn(tr_2.state, gb,
                             tr_2.generators(tr_2.global_step))
                sync()
                t3 = time.perf_counter()
                split["plan_ms"].append((t1 - t0) * 1e3)
                split["stage_ms"].append((t2 - t1) * 1e3)
                split["step_ms"].append((t3 - t2) * 1e3)
            for c, (ta, tb) in enumerate(zip(plain.tables, tab2.tables)):
                for a, b in zip(ta.states, tb.states):
                    if not torch.equal(a.data, b.data):
                        raise AssertionError(
                            f"phase 16b: class {c}: the overlapped order "
                            "differs from the sequential one")
            for k, v in tr_1.model.state_dict().items():
                if not torch.equal(v, tr_2.model.state_dict()[k]):
                    raise AssertionError(f"phase 16b: param {k}: the "
                                         "overlapped order differs")
            del tr_2, tab2, gb
        finally:
            torch.use_deterministic_algorithms(False)
        # the sharded model's rows (the fields its save writes, kept in
        # memory), loaded into one single table a class
        t0 = time.perf_counter()
        plain_rows = []
        for pb in plain.tables:
            items = [pb.indexes[s].items() for s in range(SHARD_N)]
            plain_rows.append((
                np.concatenate([k for k, _ in items]),
                np.concatenate([pb._rows_host(s, r)
                                for s, (_, r) in enumerate(items)])))
        n_sh = plain.feature_count()
        one = MultiMfEmbeddingTable(MMF_DIMS, capacity=MMF_CAPACITY,
                                    cfg=cfg0, device=dev)
        if convert.load_multi_mf(one, [
                convert.table_rows_from_logical(k, r, d)
                for (k, r), d in zip(plain_rows, plain.dims)]) != n_sh:
            raise AssertionError("phase 16b: the single table loaded "
                                 "another row count")
        probe = sh_batches[0]
        pkeys = probe.keys[:probe.num_keys]
        pslots = (probe.segments[:probe.num_keys]
                  % probe.num_slots).astype(np.int32)
        if not np.array_equal(one.pull(pkeys, pslots),
                              plain.pull(pkeys, pslots)):
            raise AssertionError("phase 16b: the single table's pull of "
                                 "the sharded save differs")
        del one
        t["b_rows_load_s"] = time.perf_counter() - t0
        med = {k: float(np.median(v)) for k, v in split.items()}
        step_total = sum(med.values())
        out["b"] = dict(
            first_step=dict(row_max_abs_err=b_row_err,
                            param_max_abs_err=b_param_err),
            train_pass=res_1, split_ms=split, split_median_ms=med,
            examples_per_sec_split=BATCH * SHARD_N / step_total * 1e3,
            rows=n_sh, features=[tb.feature_count()
                                       for tb in plain.tables])
        t["b_s"] = time.perf_counter() - t_b

        # ==== 16c: tiered ====
        t_c = time.perf_counter()
        passes = [dataset(sh_records[i * SHARD_N * BATCH:
                                     (i + 1) * SHARD_N * BATCH])
                  for i in range(len(groups))]
        ws = [0] * nc
        for ds in passes:
            keys_p, slots_p = ds.pass_key_slots()
            for c, kc in enumerate(plain.split_keys_by_class(keys_p,
                                                             slots_p)):
                ws[c] = max(ws[c], int(np.bincount(
                    (kc % np.uint64(SHARD_N)).astype(np.int64),
                    minlength=SHARD_N).max()))
        model_rows = [min(len(ix) for ix in tb.indexes)
                      for tb in plain.tables]
        windows, hosts = {}, []
        for c, d in enumerate(plain.dims):
            if ws[c] < model_rows[c]:
                windows[d] = (ws[c] + model_rows[c]) // 2
            else:
                log(f"phase 16c: class mf {d}: no window lies between the "
                    f"pass working set ({ws[c]}) and the model "
                    f"({model_rows[c]} rows a shard); the window holds "
                    "the working set")
                windows[d] = ws[c]
            # a pass's write-back fits; the model spills to SSD
            hosts.append(windows[d] + (model_rows[c] - windows[d]) // 2)
        # one host store size for every class: the largest class's need
        host = max(hosts)
        log(f"phase 16c: per class (mf {plain.dims}) the largest per-shard "
            f"pass working set {ws}, per-shard model rows {model_rows}, "
            f"windows {[windows[d] for d in plain.dims]}; host stores "
            f"{host} rows a shard")
        t0 = time.perf_counter()
        tiered = sharded(MultiMfTieredShardedTable,
                         capacity_per_shard=None,
                         capacity_per_class=windows, host_capacity=host,
                         ssd_dir=os.path.join(tmp, "ssd"))
        t["c_load_s"] = time.perf_counter() - t0
        tr_t = MultiMfShardedTrainer(model(), tiered, desc, seed=args.seed)
        helper = BoxPSHelper(tiered, trainer=tr_t)
        pass_log = []

        def run_passes():
            for i, ds in enumerate(passes):
                t0 = time.perf_counter()
                helper.begin_pass(ds)
                sync()
                t1 = time.perf_counter()
                begin = [dict(tb.last_pass_stats) for tb in tiered.tables]
                window = [max(len(ix) for ix in tb.indexes)
                          for tb in tiered.tables]
                if i == len(passes) - 1:
                    helper.stage_pass(ds)   # overlapped, the open pass's
                res = tr_t.train_pass(ds)
                sync()
                t2 = time.perf_counter()
                helper.end_pass(ds)
                pass_log.append(dict(
                    begin_s=t1 - t0, train_s=t2 - t1,
                    end_submit_s=time.perf_counter() - t2, window=window,
                    begin_stats=begin, res=res,
                    end_stats=[dict(tb.last_pass_stats)
                               for tb in tiered.tables]))

        torch.use_deterministic_algorithms(True)
        try:
            t0 = time.perf_counter()
            count("16c", run_passes)
            tiered.fence()
            t["c_passes_s"] = time.perf_counter() - t0
        finally:
            torch.use_deterministic_algorithms(False)
        for p in pass_log:
            for c, d in enumerate(tiered.dims):
                if p["window"][c] > windows[d]:
                    raise AssertionError(f"phase 16c: class mf {d}'s window "
                                         f"holds {p['window'][c]} rows")
        # the overlapped stage left nothing to stage
        helper.begin_pass(passes[-1])
        restaged = [tb.last_pass_stats["staged"] for tb in tiered.tables]
        helper.end_pass(passes[-1])
        tiered.fence()
        if any(restaged):
            raise AssertionError(f"phase 16c: begin_pass after the "
                                 f"overlapped stage staged {restaged}")
        # rows 3 and 4 at each class width, on shard 0's window: the last
        # pass's keys that the pass before it lacked (the begin-pass
        # delta, with seeded values) scattered into copies, and the last
        # pass's rows (its end-pass write-back) gathered, each through
        # the kernels and the plain versions
        last = tiered.split_keys_by_class(*passes[-1].pass_key_slots())
        prev = tiered.split_keys_by_class(*passes[-2].pass_key_slots())
        vrng = np.random.default_rng(args.seed + 19)
        dma_rows = []
        for c, tb in enumerate(tiered.tables):
            k_last = tb._split_by_owner(last[c])[0]
            k_new = np.setdiff1d(k_last, tb._split_by_owner(prev[c])[0])
            wb_rows = tb.indexes[0].lookup(k_last)
            new_rows = tb.indexes[0].lookup(k_new)
            if (wb_rows < 0).any() or (new_rows < 0).any() or not len(
                    new_rows):
                raise AssertionError(f"phase 16c: class {c}: no delta, or "
                                     "a key of the last pass left shard "
                                     "0's window")
            st0 = tb.states[0]
            feat = st0.data.shape[1]
            vals = vrng.normal(0, 0.05, size=(len(new_rows), feat)).astype(
                np.float32)
            sc = {}
            for what, ops in (("kernels", K.KERNELS), ("plain", K.PLAIN)):
                sc[what] = TableState(st0.data.clone(), st0.ext)
                scatter_window_rows(sc[what], new_rows, vals, ops)
            if not torch.equal(sc["kernels"].data, sc["plain"].data):
                raise AssertionError(f"phase 16c: scatter_rows_dma differs "
                                     f"from its plain version at width "
                                     f"{feat}")
            del sc
            if not np.array_equal(RowsToHost(st0, wb_rows, K.KERNELS).wait(),
                                  RowsToHost(st0, wb_rows, K.PLAIN).wait()):
                raise AssertionError(f"phase 16c: gather_rows_dma differs "
                                     f"from its plain version at width "
                                     f"{feat}")
            dma_rows.append(dict(mf_dim=tb.mf_dim, row_floats=feat,
                                 scattered=len(new_rows),
                                 gathered=len(wb_rows)))
        per_class = {}
        for c, d in enumerate(tiered.dims):
            per_class[d] = {k: int(sum(p["begin_stats"][c].get(k, 0)
                                       for p in pass_log))
                            for k in ("staged", "resident", "evicted",
                                      "evicted_writeback",
                                      "evict_async_rows")}
            per_class[d]["written_back"] = int(sum(
                p["end_stats"][c].get("written_back", 0) for p in pass_log))
            per_class[d]["ssd"] = tiered.tables[c].ssd_stats()
        if not any(v["evicted"] + v["evict_async_rows"]
                   for v in per_class.values()) or not all(
                v["written_back"] for v in per_class.values()):
            raise AssertionError(f"phase 16c: no eviction or write-back "
                                 f"{per_class}")
        c_err = 0.0
        for c, (tb, (pkeys_, prows)) in enumerate(zip(tiered.tables,
                                                      plain_rows)):
            keys, rows = [], []
            for h in tb.hosts:
                k, f = h.export_rows(clear_touched=False)
                keys.append(k)
                rows.append(rows_from_store_fields(f, tb.mf_dim,
                                                   tb.opt_ext))
            keys = np.concatenate(keys)
            o, po = np.argsort(keys), np.argsort(pkeys_)
            if not np.array_equal(keys[o], pkeys_[po]):
                raise AssertionError(f"phase 16c: class {c}: the tiered "
                                     "model's keys differ from the plain "
                                     "table's")
            diff = np.abs(np.concatenate(rows)[o] - prows[po])
            c_err = max(c_err, float(diff.max()))
        pdiff = max(float((v - tr_t.model.state_dict()[k]).abs().max())
                    for k, v in tr_1.model.state_dict().items())
        if c_err or pdiff:
            raise AssertionError(f"phase 16c: the tiered model differs from "
                                 f"the plain sharded table (rows max abs "
                                 f"{c_err}, params {pdiff})")
        out["c"] = dict(
            working_set=ws, model_rows=model_rows,
            windows=[windows[d] for d in tiered.dims],
            host=host, per_class=per_class, dma_rows=dma_rows,
            passes=pass_log, max_abs_err=c_err, restaged=restaged,
            endpass=tiered.endpass_stats())
        del tiered, tr_t, helper, plain, plain_rows, tr_1
        t["c_s"] = time.perf_counter() - t_c

        # ==== 16d: the remaining PS helpers ====
        t_d = time.perf_counter()
        b0 = batches[0]
        ext = {}
        for what, ops in (("kernels", K.KERNELS), ("plain", K.PLAIN)):
            tab = ExtendedEmbeddingTable(
                MF_DIM, MF_DIM, capacity=MMF_EXT_CAPACITY,
                cfg=SparseSGDConfig(mf_create_thresholds=0.0),
                seed=args.seed, skip_extend_slots=MMF_EXT_SKIP, device=dev)
            g = torch.Generator(device=dev).manual_seed(args.seed + 17)

            def step(tab=tab, ops=ops, g=g):
                idx = tab.prepare(b0)
                first = tab.pull(idx, ops)
                kp = b0.key_capacity
                tab.push(idx, torch.randn((kp, 3 + MF_DIM), generator=g,
                                          device=dev) * 1e-2,
                         torch.randn((kp, 3 + MF_DIM), generator=g,
                                     device=dev) * 1e-2, ops=ops)
                return idx, first, tab.pull(idx, ops)

            ext[what] = (count("16d", step) if ops is K.KERNELS
                         else step())
        (ik, fk, ak), (ip, fp, ap) = ext["kernels"], ext["plain"]
        for a, b in zip(fk + ak, fp + ap):
            if not torch.equal(a, b):
                raise AssertionError("phase 16d: the extended table's "
                                     "pulls, kernels vs plain, differ")
        skipped = np.isin(b0.segments[:b0.num_keys] % b0.num_slots,
                          MMF_EXT_SKIP)
        if fk[1][:b0.num_keys][torch.from_numpy(skipped).to(dev)].abs(
                ).sum() != 0:
            raise AssertionError("phase 16d: a skipped slot pulled expand "
                                 "values")
        del ext
        rng = np.random.default_rng(args.seed + 18)
        rows = rng.normal(size=(MMF_REPLICA_ROWS, MF_DIM)).astype(np.float32)
        rc = ReplicaCache(MF_DIM, device=dev)
        rc.add_items(rows[:MMF_REPLICA_ROWS // 2])
        rc.add_items(rows[MMF_REPLICA_ROWS // 2:])
        ids = rng.integers(-5, MMF_REPLICA_ROWS + 5, size=(BATCH, NUM_SLOTS))
        got = rc.pull(torch.from_numpy(ids).to(dev)).cpu().numpy()
        if not np.array_equal(got, rows[np.clip(ids, 0,
                                                MMF_REPLICA_ROWS - 1)]):
            raise AssertionError("phase 16d: ReplicaCache.pull differs from "
                                 "numpy")
        out["d"] = dict(extended_keys=int(b0.num_keys),
                        skipped_keys=int(skipped.sum()),
                        replica_rows=MMF_REPLICA_ROWS,
                        replica_ids=int(ids.size))
        t["d_s"] = time.perf_counter() - t_d
    finally:
        torch.use_deterministic_algorithms(False)
        shutil.rmtree(tmp, ignore_errors=True)
    want = {"16a": ("gather_rows", "pool_cvm", "segment_gather",
                    "scatter_add_update"),
            "16b": ("gather_rows", "pool_cvm", "segment_gather",
                    "scatter_add_update"),
            "16c": ("gather_rows", "pool_cvm", "segment_gather",
                    "scatter_add_update", "scatter_rows_dma",
                    "gather_rows_dma"),
            "16d": ("gather_rows", "scatter_add_update")}
    for part, names in want.items():
        for k in names:
            if dev == "cuda" and part_launches[part][k] == 0:
                raise AssertionError(f"phase {part}: {k} never launched")
    phase_s = time.perf_counter() - t_phase

    # ---- the log ----
    a, b_, c_ = out["a"], out["b"], out["c"]
    ctr = details.get("models", {}).get("ctr_dnn", {}).get("pass_", {})
    log(f"multi-mf 16a: classes mf {out['dims']} over base rows "
        f"{n_base}; first step kernels vs plain pulls and show/clk exact, "
        f"max abs err rows {a['first_step']['row_max_abs_err']:.3g} params "
        f"{a['first_step']['param_max_abs_err']:.3g}; train_pass of "
        f"{len(batches)} batches {a['train_pass']['examples_per_sec']:.0f} "
        f"examples/s (phase 14's CtrDnn on one table: "
        f"{ctr.get('examples_per_sec', float('nan')):.0f}); resident "
        f"{a['resident']['examples_per_sec']:.0f} examples/s with its "
        f"build, bit for bit equal; save_base {a['saved_rows']} rows, "
        f"predict p50 {a['predict_p50_ms']:.2f} ms, max |pred - trainer| "
        f"{a['pred_max_abs_err']:.3g} ({card})")
    for w in out["class_widths"]:
        line = (f"  class mf {w['mf_dim']} (rows {w['row_floats']} floats, "
                f"values {w['value_floats']}, {w['slots']} slots, "
                f"{w['unique_rows']} unique rows, {w['keys']} keys): "
                f"kernels vs plain exact, pool max abs err "
                f"{w['pool_max_abs_err']:.3g}")
        if "ms" in w:
            line += "; " + ", ".join(
                f"{n} {w['ms'][n]:.4f} ms (plain {w['plain_ms'][n]:.4f}, "
                f"bound {w['bound_ms'][n] * 1e3:.2f} us)" for n in w["ms"])
        log(line + f" ({card})")
    log(f"multi-mf 16b: {SHARD_N} x {SHARD_CAPACITY} rows a class; first "
        f"global step kernels vs plain pushed grads, show/clk/slot exact, "
        f"max abs err rows {b_['first_step']['row_max_abs_err']:.3g} "
        f"params {b_['first_step']['param_max_abs_err']:.3g}; train_pass "
        f"{b_['train_pass']['examples_per_sec']:.0f} examples/s; overlapped "
        f"order equals sequential bit for bit; global step split medians "
        f"{json.dumps({k: round(v, 2) for k, v in b_['split_median_ms'].items()})}"
        f" → {b_['examples_per_sec_split']:.0f} examples/s; the sharded "
        f"model's rows ({b_['rows']}) pull alike from a single table "
        f"({card})")
    for d, v in c_["per_class"].items():
        log(f"multi-mf 16c class mf {d}: staged {v['staged']}, resident "
            f"{v['resident']}, evicted {v['evicted']} at begin_pass "
            f"({v['evicted_writeback']} written back there) and "
            f"{v['evict_async_rows']} ahead, written back at end_pass "
            f"{v['written_back']}; SSD {json.dumps(v['ssd'])}")
    for r in c_["dma_rows"]:
        log(f"  class mf {r['mf_dim']} (rows {r['row_floats']} floats): "
            f"scatter_rows_dma of {r['scattered']} delta rows and "
            f"gather_rows_dma of {r['gathered']} write-back rows on shard "
            f"0's window, kernels vs plain exact ({card})")
    log(f"multi-mf 16c: {len(passes)} passes, windows "
        f"{c_['windows']} over host stores of {c_['host']} rows a shard; "
        f"the model through the host tiers equals the plain table bit for "
        f"bit (max abs err {c_['max_abs_err']}); after the overlapped "
        f"stage begin_pass staged {c_['restaged']}; passes took "
        f"{t['c_passes_s']:.1f}s ({card})")
    log(f"multi-mf 16d: ExtendedEmbeddingTable pull/push on batch 0 "
        f"({out['d']['extended_keys']} keys, {out['d']['skipped_keys']} "
        f"in skipped slots) kernels vs plain exact; ReplicaCache of "
        f"{MMF_REPLICA_ROWS} rows, {out['d']['replica_ids']} ids, exact "
        f"against numpy ({card})")
    log(f"multi-mf: phase 16 took {phase_s:.1f}s "
        f"{json.dumps({k: round(v, 1) for k, v in t.items()})}; launches "
        f"{json.dumps(part_launches)} ({card})")
    details["multi_mf"] = dict(out, seconds=t, phase_s=phase_s,
                               launches=part_launches)
    return launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batches", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="chiprun_out/chip_smoke")
    args = ap.parse_args()
    t_start = time.perf_counter()

    # phase 10 runs with deterministic algorithms: cuBLAS reads this when
    # it creates its handle, before the first GEMM
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
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
                                          PvBatchBuilder, SlotDef,
                                          SlotRecord)
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
    from paddlebox_tpu_torch import native
    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:      # g++ beside the nvcc builds
        host_lib = pool.submit(lambda: (native.load(),
                                        time.perf_counter() - t0)[1])
        secs = _build.build()
        secs["native kv_index + slot_parser (g++)"] = host_lib.result()
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
    t0 = time.perf_counter()
    pv_records = make_pv_records(np.random.default_rng(args.seed + 5),
                                 SlotRecord)
    pv_slots = ([SlotDef("label", "float", 1),
                 SlotDef("dense", "float", PV_DENSE)]
                + [SlotDef(f"C{i}", "uint64") for i in range(PV_SLOTS)])
    pv_desc = DataFeedDesc(slots=pv_slots, batch_size=PV_BATCH,
                           label_slot="label", pv_batch_size=PV_BATCH // 8,
                           key_bucket_min=PV_BATCH * PV_SLOTS)
    pv_batches = PvBatchBuilder(pv_desc, max_rank=PV_MAX_RANK).batches(
        pv_records)
    log(f"PV data: {len(pv_records)} ads in {PV_PVS} PVs, "
        f"{len(pv_batches)} batches of {PV_BATCH // 8} PVs, "
        f"{int((pv_batches[0][0].show > 0).sum())} ads in batch 0 in "
        f"{time.perf_counter() - t0:.2f}s")
    del pv_records

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
    vals_valid = values[valid].contiguous()
    out_s = torch.empty((n_seg, d), dtype=torch.float32, device="cuda")
    # the timed calls pass no keep: the values and ids read once, the
    # [N, D] output written once
    reps = alternating_ms(torch, {
        "kernel": lambda: K.pool_cvm(values, segs, None, BATCH, NUM_SLOTS),
        "library": lambda: torch.segment_reduce(vals_valid, "sum",
                                                lengths=lengths)}, flush)
    p = {"name": "pool_cvm", "route": "cuda",
         "source": "paddlebox_tpu_torch/csrc/pool_cvm.cu",
         "replaces": "paddlebox_tpu/ops/pallas_kernels.py:654",
         "max_abs_err": pool_err, "ms": reps["kernel"]["median"],
         "plain_ms": time_ms(torch, lambda: K.pool_cvm_plain(
             values, segs, None, BATCH, NUM_SLOTS), flush),
         "library_ms": reps["library"]["median"],
         "bound_ms": max((k_real * (d + 1) * 4 + n_seg * d * 4) / PEAK_BYTES,
                         k_real * d / PEAK_F32) * 1e3,
         "bound_by": "bytes"}
    parts = pool_parts_ms(
        torch, "pool_cvm", segs, n_seg,
        lambda bd: (values.data_ptr(), segs.data_ptr(), None, bd.data_ptr(),
                    out_s.data_ptr(), k_real, n_seg, d, d, K.CVM_FULL, 2, 0,
                    0.0), out_s,
        K.pool_cvm(values, segs, None, BATCH, NUM_SLOTS).view(n_seg, d),
        flush)
    details["pool_cvm_timing"] = dict(parts, repeats=reps,
                                      bound_ms=p["bound_ms"])

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
    # the real keys, which phase 5's steps pass (train/step.py
    # _expand_pool drops the bucket's padded tail), and batch 0's whole
    # key bucket, pads included, which the PV steps' shape resembles
    sg_t = {what: gather_timing(torch, src, ids, head, flush)
            for what, ids in (("real keys", segs),
                              ("key bucket", dev.segments.contiguous()))}
    real = sg_t["real keys"]
    sg = {"name": "segment_gather", "route": "cuda",
          "source": "paddlebox_tpu_torch/csrc/segment_gather.cu",
          "replaces": "paddlebox_tpu/ops/pallas_kernels.py:531",
          "max_abs_err": 0.0, "ms": real["repeats"]["kernel"]["median"],
          "plain_ms": time_ms(torch, lambda: K.segment_gather_plain(
              src, segs, head, None, BATCH, NUM_SLOTS), flush),
          "library_ms": real["repeats"]["library"]["median"],
          "bound_ms": real["bound_ms"], "bound_by": "bytes"}
    details["segment_gather_timing"] = sg_t
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
    del vals_k, vals_p, g_out
    log(f"kernels vs plain: gather_rows, segment_gather (3 modes), "
        f"scatter_add_update exact; pool_cvm 4 modes max abs err "
        f"{pool_err:.3g}")
    for r in (g, p, sg, sa):
        log(f"  {r['name']}: {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} "
            f"ms, library {r['library_ms']:.4f} ms, bound "
            f"{r['bound_ms'] * 1e3:.2f} us ({card})")
    log_pool_timing("pool_cvm", details["pool_cvm_timing"], card)
    for what, t in sg_t.items():
        log_copy_timing(f"segment_gather ({what}, K {t['keys']}, "
                        f"{t['live']} live)", t, "index_select", card)
    ins, lk = index_phase(torch, batches, flush, card, details)
    ra, bfc, cn = ctr_phase(torch, pv_batches, flush, card, details, gen)

    # ---- phase 4: the serving path end to end ----
    kv_route = {"loader": require_native("serve", srv.table),
                "snapshot": require_native("serve", snap.table)}
    log(f"serve: host key index route {json.dumps(kv_route)}")
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
    # the same lookups on each route of the host key index, in turns
    pair, _ = route_pair(snap.table, lambda t: timed_calls(
        t.prepare_eval, batches))
    log_route_pair("serve prepare_eval", pair, card)
    details.update(predict_ms=lat, predict_p50_ms=p50, split_p50_ms=split,
                   pred_max_abs_err=err, serve_launches=launches,
                   serve_kv_route=kv_route, serve_prepare_by_route=pair)

    # ---- phases 5 and 6: the training paths ----
    train_launches = train_phase(torch, args, card, desc, records, batches,
                                 details)

    # ---- phase 7: the PV ads-ranking path ----
    train_launches.update(pv_phase(torch, args, card, pv_batches, details))
    kernels = [g, p, sg, sa, ins, lk, ra, bfc, cn]
    for r in kernels:
        r["launches"] = train_launches[r["name"]]

    # ---- phase 8: the seqpool op family ----
    kernels += seqpool_phase(torch, values, segs, dev.show_clk.contiguous(),
                             table, rows_u, u_real, flush, card, details,
                             gen)

    # ---- phase 9: the table lifecycle with sparse Adam ----
    life_launches = lifecycle_phase(torch, args, card, batches, flush,
                                    details)
    log(f"lifecycle launches (both Adam configs' kernel runs): "
        f"{json.dumps(life_launches)}")

    # ---- phase 10: checkpoint, resume, publish; adopt, hot reload ----
    ckpt_launches = checkpoint_phase(torch, args, card, desc, records,
                                     batches, details)
    for r in kernels:
        r["launches"] += ckpt_launches.get(r["name"], 0)

    # ---- phase 11: the pipelined resident passes ----
    pipe_launches = pipeline_phase(torch, args, card, desc, records, details)
    for r in kernels:
        r["launches"] += pipe_launches.get(r["name"], 0)

    # ---- phase 12: the data pipeline and streaming ingest ----
    data_launches = data_phase(torch, args, card, desc, records, batches,
                               details)
    for r in kernels:
        r["launches"] += data_launches.get(r["name"], 0)

    # ---- phase 13: the sharded table and the multi-shard trainer ----
    shard_launches = sharded_phase(torch, args, card, desc, details)
    for r in kernels:
        r["launches"] += shard_launches.get(r["name"], 0)

    # ---- phase 14: the other CTR models, lr_map on both trainers ----
    model_launches = models_phase(torch, args, card, desc, records, batches,
                                  details)
    for r in kernels:
        r["launches"] += model_launches.get(r["name"], 0)

    # ---- phase 15: the tiered store ----
    tier_launches = tiered_phase(torch, args, card, desc, details)
    for r in kernels:
        r["launches"] += tier_launches.get(r["name"], 0)

    # ---- phase 16: multi-mf, the remaining PS helpers ----
    mmf_launches = multi_mf_phase(torch, args, card, desc, records, batches,
                                  details)
    for r in kernels:
        r["launches"] += mmf_launches.get(r["name"], 0)
    details["kernels"] = kernels
    details["wall_s"] = time.perf_counter() - t_start
    log(f"chip_smoke: {details['wall_s']:.1f}s wall, the build included")

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
