"""Device-resident pass — counterpart of
``paddlebox_tpu/train/device_pass.py``.

A pass's batches are packed on the host once and staged on the device
before the first step; ``ResidentPassRunner`` then runs the staged
batches through ``TrainStep``, slicing and decoding each batch's view on
the device: no host→device copy per step.

- **Build.** ``ResidentPass.build`` gives every key of the pass its row
  in ONE bulk assignment (``EmbeddingTable.bulk_assign_unique``, on the
  device key index when ``FLAGS.use_pallas_index`` is on) and cuts each
  batch's pull index out of it: the sorted unique rows and each key's
  position among them. ``upload`` stages it. ``build_streamed`` does
  both at once: the float block's copy starts before the dedup, and the
  index blocks pack in chunks whose copies are issued while later chunks
  pack.
- **Fronts.** The record front walks ``dataset.batches()``; the columnar
  front (``_front_columnar``) slices a ``columnarize()``d dataset's
  arrays for the whole pass; the q8 streaming front walks a dataset
  twice instead of holding a whole-pass f32 block.
- **Wires** (``ops/bitpack.py``): unique rows as u8/u16 deltas, 16+8-bit
  halves or raw; positions as 16+2 bits or raw; ragged segments as a u8
  (record, slot) count grid, u8 slots plus u16 record counts, or u18;
  floats as f32, bf16 or q8 (per-column affine u8). A table with a slot
  arena (``arena_slots``) ships the COMPACT wire instead: per-key
  slot-local rows plus the arena's chunk map, deduped on the device
  (``ops/device_unique.dedup_rows``). The formats are chosen once per
  pass, from the data, narrowest first; ``rp.formats`` names them.
- **Pipeline.** ``PassPreloader`` builds passes ahead of training on
  one worker thread with its own CUDA stream, through a bounded queue of
  ``FLAGS.preload_depth`` passes. Host blocks go through pinned buffers
  with ``non_blocking`` copies; each pass carries a CUDA event recorded
  after its copies (and after any device key-index work of its build),
  and the consumer's stream waits on it before the first step: the
  host never waits for a copy, and no copy runs on the training stream.

``PassPipeline`` drives a pass-window table (``ps/tiered.py``) through
the same worker: plan build and host fetch ahead of training, a
reconcile-only ``begin_pass``, the write-back on the table's epilogue
worker.

Telemetry (``obs/``): the worker runs on the ``preload.worker`` lane and
times each build in a ``pass.build`` span whose id rides the pass
(``rp._trace_span_id``) for the consumer's ``pass.consume`` link; the
preloader books ``pbox_preload_{builds, build_seconds, wait_seconds,
depth_clamps}_total`` and the ``pbox_preload_queue_depth`` gauge, and
reports its blocked wait (``build_wait``) and the pipeline's boundary
stalls into the next pass event's critical path. Spans read the host
clock only: a span on the worker never reads a tensor of its stream.
"""

from __future__ import annotations

import collections
import contextlib
import logging
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from paddlebox_tpu_torch.config import FLAGS
from paddlebox_tpu_torch.data.dataset import InMemoryDataset
from paddlebox_tpu_torch.device import resolve_device, seeded_generator
from paddlebox_tpu_torch.obs import trace
from paddlebox_tpu_torch.obs.hub import active_hub
from paddlebox_tpu_torch.ops.bitpack import (as_wire, pack_delta,
                                             pack_u12, pack_u16m, pack_u18,
                                             pack_u24, unpack_delta16,
                                             unpack_u12, unpack_u16m,
                                             unpack_u18, unpack_u24,
                                             widen_u16)
from paddlebox_tpu_torch.ops.device_unique import dedup_rows
from paddlebox_tpu_torch.ps.epilogue import hang_timeout, wait_with_deadline
from paddlebox_tpu_torch.ps.table import (fill_oob_pads, next_bucket,
                                          next_bucket_fine)
from paddlebox_tpu_torch.resilience import preemption
from paddlebox_tpu_torch.train.step import (StepState, TrainStep, bf16_bits,
                                            dequantize_floats, pack_floats,
                                            quantize_floats, unpack_floats)

log = logging.getLogger(__name__)


class PreloadBuildAborted(RuntimeError):
    """A background pass build saw the stop flag between stages and
    aborted, so a long build does not eat the stop's grace window. Raised
    only on worker threads; the preloader treats it as a clean end of
    stream, never an error."""


_PRELOAD_TLS = threading.local()  # .abort: set on the preloader's worker


def poll_preload_abort() -> None:
    """The stop poll of background pass builds, called between build
    stages: honours the owning preloader's ``stop()`` and the process-wide
    graceful-stop flag. A no-op on the main thread."""
    abort = getattr(_PRELOAD_TLS, "abort", None)
    if abort is not None and abort():
        raise PreloadBuildAborted("pass build aborted (preloader stop)")
    if threading.current_thread() is threading.main_thread():
        return
    if preemption.stop_pending():
        raise PreloadBuildAborted(
            f"pass build aborted ({preemption.stop_reason()})")


def float_wire(floats_dtype) -> str:
    """The float wire a ``floats_dtype`` names: "f32" (``np.float32``),
    "bf16" (``torch.bfloat16``) or "q8"."""
    if isinstance(floats_dtype, str):
        if floats_dtype in ("f32", "bf16", "q8"):
            return floats_dtype
    elif floats_dtype is torch.bfloat16:
        return "bf16"
    elif np.dtype(floats_dtype) == np.float32:
        return "f32"
    raise ValueError(f"unsupported float wire {floats_dtype!r}")


def _floats_format(floats: np.ndarray) -> str:
    """The float wire of a host float block (bf16 rides as int16 bits)."""
    return {np.dtype(np.uint8): "q8", np.dtype(np.int16): "bf16",
            np.dtype(np.float32): "f32"}[floats.dtype]


def _segs_format(enc) -> str:
    if enc is None:
        return "trivial"
    if len(enc) == 1:
        return "grid" if enc[0].dtype == np.uint8 else "raw"
    return "slot" if enc[0].dtype == np.uint8 else "u18"


def _locals_format(enc) -> str:
    if len(enc) == 2:
        return f"u16m{8 * enc[1].shape[-1] // enc[0].shape[-1]}"
    return {np.dtype(np.uint8): "u12", np.dtype(np.uint16): "u16",
            np.dtype(np.int32): "raw"}[enc[0].dtype]


class _Stager:
    """The host→device copies of one pass, issued on the calling thread's
    current stream. On the card each host block is copied into a pinned
    buffer and sent with ``non_blocking=True`` (a pageable copy would make
    the host wait); ``finish`` records the event after the last copy. On
    the CPU a staged tensor shares the host array's memory."""

    def __init__(self, device: torch.device) -> None:
        self.device = device
        self.cuda = device.type == "cuda"
        self.pinned: List[torch.Tensor] = []

    def put(self, a: np.ndarray) -> torch.Tensor:
        a = np.ascontiguousarray(as_wire(a))
        if not self.cuda:
            return torch.from_numpy(a)
        buf = torch.from_numpy(a).pin_memory()
        self.pinned.append(buf)
        return buf.to(self.device, non_blocking=True)

    def floats(self, floats: np.ndarray) -> torch.Tensor:
        t = self.put(floats)
        return t.view(torch.bfloat16) if floats.dtype == np.int16 else t

    def finish(self) -> Optional[torch.cuda.Event]:
        if not self.cuda:
            return None
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self.device))
        return ev

    def settle(self) -> None:
        """Wait out every copy issued so far (an aborted build)."""
        if self.cuda:
            torch.cuda.current_stream(self.device).synchronize()


class ResidentPass:
    """One pass's batches, packed on the host, then staged on the device.

    Arrays (nb = batches, K = uniform per-batch key capacity, U =
    uniform per-batch unique capacity):
      uniq:   int32 [nb, U]  per-batch unique table rows, ascending, then
              DISTINCT out-of-bounds pads (``fill_oob_pads``: gathers read
              the zero sentinel row, scatters drop them)
      gidx:   int32 [nb, K]  per-key position in uniq; key pads → the
              first pad position (num_unique)
      floats: [nb, B, D+3]   [dense | label | show | clk] as f32, bf16
              (int16 bits) or q8 (uint8, with ``qmeta`` f32 [2, D])
      meta:   int32 [nb, 4]  [num_keys, pad_segment, num_unique,
              first unique row]; stays on the host
      segs:   int32 [nb, K] | None  None when every batch has the trivial
              one-key-per-slot layout

    The compact wire (``wire == "compact"``) keeps the per-key global
    rows in ``uniq`` and the slot-local rows in ``gidx``.

    ``dev`` = (uniq leaves, gidx leaves, floats, segs leaves or None,
    qmeta or None) on the device, the encoded wire; on the card ``ready``
    is the event recorded after its copies."""

    def __init__(self, uniq: np.ndarray, gidx: np.ndarray,
                 floats: np.ndarray, meta: np.ndarray,
                 segs: Optional[np.ndarray], num_records: int,
                 qmeta: Optional[np.ndarray] = None,
                 side: Optional[Dict] = None) -> None:
        self.uniq = uniq
        self.gidx = gidx
        self.floats = floats
        self.meta = meta
        self.segs = segs
        self.num_records = num_records
        self.qmeta = qmeta
        self.dev: Optional[Tuple] = None
        self.ready: Optional[torch.cuda.Event] = None
        self._pinned: List[torch.Tensor] = []
        # "dedup" (host-deduped pull index) or "compact" (slot-local rows
        # plus the arena chunk map, deduped on the device)
        self.wire = "dedup"
        self.chunk_bits: Optional[int] = None
        # the wire format of each staged block (after upload)
        self.formats: Dict[str, str] = {}
        # columnar side channels for the post-pass metric feed (or None)
        self.side = side
        # host seconds per build stage: front, dedup (of which index_host
        # and index_dev on the bulk path), pack, h2d (copy issue)
        self.build_stats: Dict[str, float] = {}

    @property
    def num_batches(self) -> int:
        return self.gidx.shape[0]

    @property
    def key_capacity(self) -> int:
        return self.gidx.shape[1]

    @property
    def unique_capacity(self) -> int:
        return self.uniq.shape[1]

    # ---- builds ----
    @classmethod
    def build(cls, dataset: InMemoryDataset, table,
              floats_dtype=np.float32) -> "ResidentPass":
        """Pack a dataset's batches: assign table rows for every key and
        dedup per batch; ``upload`` stages it.

        The table's touched flags are NOT set here: a pass built ahead
        has not trained yet. The trainer marks the pass's rows after it
        runs (``mark_trained_rows``)."""
        stats: Dict[str, float] = {}
        t0 = time.perf_counter()
        per_batch, floats, qmeta, trivial, nrec, side = cls._front(
            dataset, floats_dtype)
        t1 = time.perf_counter()
        dedup, u_pad, k_max = cls._dedup_phase(per_batch, table,
                                               stats=stats)
        t2 = time.perf_counter()
        uniq, gidx, meta, segs = cls._pack_chunk(per_batch, dedup, u_pad,
                                                 k_max, trivial,
                                                 table.capacity)
        stats.update(front=t1 - t0, dedup=t2 - t1,
                     pack=time.perf_counter() - t2)
        rp = cls(uniq, gidx, floats, meta, segs, nrec, qmeta=qmeta,
                 side=side)
        rp.build_stats = stats
        return rp

    @classmethod
    def build_streamed(cls, dataset: InMemoryDataset, table,
                       floats_dtype=np.float32, threads: int = 4,
                       block: bool = True) -> "ResidentPass":
        """Build with the copies IN FLIGHT, on the calling thread's
        current stream, to ``table.device``. The float block's copy is
        issued before the dedup begins; the index blocks pack on the
        thread pool in chunks of ``FLAGS.preload_pack_chunk_batches``,
        each encoded in the format chosen once from the whole pass's
        dedup (the choice ``upload`` makes), each chunk's copy issued
        while later chunks pack; the device stitches the chunks. The
        staged bytes equal ``upload``'s. ``block=False`` returns with the
        copies in flight: the consumer's stream waits on ``rp.ready``.

        On a worker thread the build polls the stop flag between stages;
        an abort waits out the copies it already issued before it raises
        ``PreloadBuildAborted``. Per-stage seconds land in
        ``rp.build_stats`` (front, dedup, index_host, index_dev, pack,
        h2d)."""
        stats: Dict[str, float] = {}
        t0 = time.perf_counter()
        per_batch, floats, qmeta, trivial, nrec, side = cls._front(
            dataset, floats_dtype)
        stats["front"] = time.perf_counter() - t0
        stager = _Stager(table.device)
        floats_t = stager.floats(floats)
        qm = None if qmeta is None else stager.put(qmeta)
        try:
            rp = cls._build_streamed_tail(
                per_batch, floats, qmeta, trivial, nrec, side, table,
                stager, floats_t, qm, threads, stats)
        except PreloadBuildAborted:
            # no copy of this build may still be in flight when the
            # abort surfaces (an emergency checkpoint follows)
            stager.settle()
            raise
        rp._staged(stager, block)
        rp.build_stats = stats
        return rp

    @classmethod
    def _build_streamed_tail(cls, per_batch, floats, qmeta, trivial, nrec,
                             side, table, stager: _Stager, floats_t, qm,
                             threads: int, stats: Dict[str, float]
                             ) -> "ResidentPass":
        if table.index.arena_enabled:
            rp = cls._compact_tail(per_batch, floats, qmeta, trivial, nrec,
                                   table, stager, floats_t, qm, side=side,
                                   stats=stats)
            if rp is not None:
                return rp
            log.warning("compact wire unavailable for this pass (foreign "
                        "rows or width overflow); using the dedup wire")
        poll_preload_abort()
        t0 = time.perf_counter()
        dedup, u_pad, k_max = cls._dedup_phase(per_batch, table, threads,
                                               stats=stats)
        # the index stages report apart, so the stages partition the wall
        stats["dedup"] = max(0.0, time.perf_counter() - t0
                             - stats.get("index_host", 0.0)
                             - stats.get("index_dev", 0.0))
        poll_preload_abort()
        # formats decided ONCE for the whole pass, from the dedup results
        # before packing, so the chunks encode alike and the bytes equal
        # upload()'s: the largest uniq value is a real row or the last
        # fill_oob_pads id (cap + pads); a batch's largest position is u
        # (the pad value) when it has key pads, else u - 1
        cap = table.capacity
        vmax = max(max(int(u[-1]) if len(u) else 0,
                       cap + (u_pad - len(u)) if len(u) < u_pad else 0)
                   for u, _ in dedup)
        gmax = max(len(u) if len(keys) < k_max else len(u) - 1
                   for (keys, *_), (u, _) in zip(per_batch, dedup))
        ufmt = cls._choose_uniq_fmt([u for u, _ in dedup], vmax)
        gfmt = cls._choose_gidx_fmt(gmax, k_max)
        nb = len(per_batch)
        step = FLAGS.preload_pack_chunk_batches
        step = nb if step <= 0 else min(step, nb)
        t_pack = t_h2d = 0.0
        uniq_parts: List[tuple] = []
        gidx_parts: List[tuple] = []
        host_parts: List[tuple] = []
        with ThreadPoolExecutor(max_workers=threads) as pool:
            futs = [pool.submit(cls._pack_chunk, per_batch[a:a + step],
                                dedup[a:a + step], u_pad, k_max, trivial,
                                table.capacity)
                    for a in range(0, nb, step)]
            for f in futs:
                t0 = time.perf_counter()
                uniq_c, gidx_c, meta_c, segs_c = f.result()
                t_pack += time.perf_counter() - t0
                poll_preload_abort()
                t0 = time.perf_counter()
                ue = cls._encode_uniq_fmt(ufmt, uniq_c, meta_c)
                ge = cls._encode_gidx_fmt(gfmt, gidx_c)
                t_pack += time.perf_counter() - t0
                t0 = time.perf_counter()
                uniq_parts.append(tuple(stager.put(a) for a in ue))
                gidx_parts.append(tuple(stager.put(a) for a in ge))
                host_parts.append((uniq_c, gidx_c, meta_c, segs_c))
                t_h2d += time.perf_counter() - t0
        t0 = time.perf_counter()
        if len(host_parts) == 1:
            uniq, gidx, meta, segs = host_parts[0]
            uniq_t, gidx_t = uniq_parts[0], gidx_parts[0]
            t_pack += time.perf_counter() - t0
        else:
            uniq = np.concatenate([p[0] for p in host_parts])
            gidx = np.concatenate([p[1] for p in host_parts])
            meta = np.concatenate([p[2] for p in host_parts])
            segs = (None if trivial else
                    np.concatenate([p[3] for p in host_parts]))
            t_pack += time.perf_counter() - t0
            # stitch the staged chunks on the device, behind their copies
            t0 = time.perf_counter()
            uniq_t = tuple(torch.cat([p[j] for p in uniq_parts])
                           for j in range(len(uniq_parts[0])))
            gidx_t = tuple(torch.cat([p[j] for p in gidx_parts])
                           for j in range(len(gidx_parts[0])))
            t_h2d += time.perf_counter() - t0
        t0 = time.perf_counter()
        segs_enc = (None if segs is None else
                    cls._encode_segs_or_fallback(segs, meta, floats))
        t_pack += time.perf_counter() - t0
        t0 = time.perf_counter()
        segs_t = (None if segs_enc is None
                  else tuple(stager.put(a) for a in segs_enc))
        rp = cls(uniq, gidx, floats, meta, segs, nrec, qmeta=qmeta,
                 side=side)
        rp.dev = (uniq_t, gidx_t, floats_t, segs_t, qm)
        rp.formats = {"uniq": ufmt, "gidx": gfmt,
                      "segs": _segs_format(segs_enc),
                      "floats": _floats_format(floats)}
        stats["h2d"] = t_h2d + (time.perf_counter() - t0)
        stats["pack"] = t_pack
        return rp

    def _staged(self, stager: _Stager, block: bool) -> None:
        """Take over a finished stager's event and pinned buffers;
        ``block`` waits for the copies on the host."""
        self.ready = stager.finish()
        self._pinned = stager.pinned
        if block:
            self.settle()

    def settle(self) -> None:
        """Wait on the host until the pass's copies are done, and release
        its pinned buffers."""
        if self.ready is not None:
            self.ready.synchronize()
        self._pinned = []

    def wait_ready(self, device: torch.device) -> None:
        """Order ``device``'s current stream after the pass's copies, on
        the device (the host does not wait), and tell the allocator that
        stream uses the staged tensors."""
        if self.ready is None:
            return
        cur = torch.cuda.current_stream(device)
        cur.wait_event(self.ready)
        for t in self._leaves():
            t.record_stream(cur)

    def release_host_buffers(self) -> None:
        """Drop the pinned buffers once their copies are done."""
        if self.ready is None or self.ready.query():
            self._pinned = []

    def _leaves(self) -> List[torch.Tensor]:
        uniq_t, gidx_t, floats_t, segs_t, qm = self.dev
        out = list(uniq_t) + list(gidx_t) + [floats_t] + list(segs_t or ())
        return out + ([] if qm is None else [qm])

    # ---- wire formats, chosen once per pass ----
    _EXC = 32    # per-batch budget of >= 2^16 delta gaps in the u16 wire
    _EXC8 = 64   # per-batch budget of >= 2^8 gaps in the u8 wire

    @classmethod
    def _choose_uniq_fmt(cls, reals, vmax: int, delta: bool = True) -> str:
        """The uniq wire, narrowest first: u8 DELTAS + sparse gap
        exceptions, u16 deltas, 16+8-bit halves, raw int32. ``reals`` are
        each batch's real unique rows; the exception counts are
        ``pack_delta``'s (gaps over the real prefix). ``vmax`` is the
        largest value shipped, pads included. A batch whose rows do not
        ascend, or ``delta=False`` (a hand-built pass without the base
        column), leaves the order-agnostic u24 / raw."""
        exc8 = exc16 = 0
        for r in reals if delta else ():
            d = np.diff(r.astype(np.int64, copy=False))
            if (d < 0).any():
                delta = False
                break
            exc8 = max(exc8, int((d >= (1 << 8)).sum()))
            exc16 = max(exc16, int((d >= (1 << 16)).sum()))
        if delta and exc8 <= cls._EXC8:
            return "d8"
        if delta and exc16 <= cls._EXC:
            return "d16"
        return "u24" if vmax < (1 << 24) else "raw"

    @staticmethod
    def _choose_gidx_fmt(gmax: int, k: int) -> str:
        """The position wire: 16+2 bits while every value is below 2^18
        and the key capacity ``k`` packs whole bytes, else raw int32."""
        return "u18" if gmax < (1 << 18) and k % 4 == 0 else "raw"

    @classmethod
    def _encode_uniq_fmt(cls, fmt: str, uniq: np.ndarray, meta: np.ndarray):
        """Encode unique rows (a chunk or the pass) in a chosen format."""
        if fmt == "d8":
            out = pack_delta(uniq, meta[:, 2], cls._EXC8, bits=8)
        elif fmt == "d16":
            out = pack_delta(uniq, meta[:, 2], cls._EXC, bits=16)
        elif fmt == "u24":
            return pack_u24(uniq)
        else:
            return (uniq,)
        if out is None:
            raise AssertionError("the chosen delta wire must fit")
        return out

    @staticmethod
    def _encode_gidx_fmt(fmt: str, gidx: np.ndarray):
        return pack_u18(gidx) if fmt == "u18" else (gidx,)

    @classmethod
    def _encode_segs_or_fallback(cls, segs, meta, floats):
        """The GRID / SLOT segment wire, else the position wire."""
        enc = cls._encode_segs_slotwire(segs, meta, floats.shape[1])
        if enc is not None:
            return enc
        fmt = cls._choose_gidx_fmt(int(segs.max(initial=0)), segs.shape[1])
        return cls._encode_gidx_fmt(fmt, segs)

    # ---- the compact wire (slot-arena tables) ----
    @classmethod
    def _compact_tail(cls, per_batch, floats, qmeta, trivial: bool,
                      nrec: int, table, stager: _Stager, floats_t, qm,
                      side: Optional[Dict] = None,
                      stats: Optional[Dict[str, float]] = None
                      ) -> Optional["ResidentPass"]:
        """COMPACT wire for slot-arena tables: per-key slot-LOCAL rows
        plus the arena's chunk map; the device rebuilds the global rows
        ((chunk_map[slot, local >> CB] << CB) | low bits) and dedups each
        batch (``dedup_rows``). No per-batch unique stream, no host
        sort. Returns None (the caller takes the dedup wire) when a key's
        row lives outside its slot's arena or the locals need more than
        24 bits."""
        nb = len(per_batch)
        k_max = max(kc for _, _, kc, _, _ in per_batch)
        cap = table.capacity
        n_arena = int(table.arena_slots)
        if any(int(sk.max(initial=0)) >= n_arena
               for _, sk, _, _, _ in per_batch):
            return None  # slots beyond the arena → dedup wire
        locs = np.zeros((nb, k_max), np.int32)
        rows_g = np.full((nb, k_max), cap + 1, np.int32)
        meta = np.zeros((nb, 4), np.int32)
        segs = None if trivial else np.empty((nb, k_max), np.int32)
        t0 = time.perf_counter()
        bulk = FLAGS.bulk_pass_assign
        if bulk:
            # ONE host_lock round trip for the pass; assign_slotted walks
            # the keys in order, so the rows equal the per-batch loop's
            keys_all = np.concatenate([k for k, *_ in per_batch])
            slots_all = np.concatenate([s for _, s, *_ in per_batch])
            with table.host_lock:
                r_all, l_all = table.index.assign_slotted(
                    keys_all, slots_all.astype(np.uint16, copy=False))
                table.slot_host[r_all] = slots_all
            if (l_all < 0).any():
                return None
            bounds = np.cumsum([0] + [len(k) for k, *_ in per_batch])
        for i, (keys, slot_of_key, _, pad_seg, seg_arr) in \
                enumerate(per_batch):
            nk = len(keys)
            if bulk:
                a = bounds[i]
                r, loc = r_all[a:a + nk], l_all[a:a + nk]
            else:
                su = slot_of_key.astype(np.uint16, copy=False)
                with table.host_lock:
                    r, loc = table.index.assign_slotted(keys, su)
                    table.slot_host[r] = slot_of_key
                if (loc < 0).any():
                    return None
            locs[i, :nk] = loc
            rows_g[i, :nk] = r
            meta[i] = (nk, pad_seg, 0, 0)
            if segs is not None:
                segs[i, :nk] = seg_arr
                segs[i, nk:] = pad_seg
        if stats is not None:  # key assignment (the dedup stage's twin)
            stats["dedup"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        bits = max(int(locs.max()).bit_length(), 1)
        if bits > 24:
            return None
        with table.host_lock:
            cs_map, cr_map = table.index.arena_export()
        valid = cs_map < n_arena  # the default (slotless) arena excluded
        stride = int(cr_map[valid].max()) + 1 if valid.any() else 1
        # a power-of-two ladder keeps the chunk map's shape stable as
        # slots grow new chunks across passes
        stride = min(next_bucket(8, stride),
                     (cap >> int(table.arena_chunk_bits)) + 1)
        cmap = np.zeros((n_arena, stride), np.int32)
        cmap[cs_map[valid], cr_map[valid]] = \
            np.nonzero(valid)[0].astype(np.int32)
        loc_enc = cls._encode_locals(locs, bits)
        segs_enc = (None if segs is None else
                    cls._encode_segs_or_fallback(segs, meta, floats))
        rp = cls(rows_g, locs, floats, meta, segs, nrec, qmeta=qmeta,
                 side=side)
        rp.wire = "compact"
        rp.chunk_bits = int(table.arena_chunk_bits)
        rp.dev = (tuple(stager.put(a) for a in loc_enc),
                  (stager.put(cmap),), floats_t,
                  None if segs_enc is None
                  else tuple(stager.put(a) for a in segs_enc), qm)
        rp.formats = {"locals": _locals_format(loc_enc),
                      "segs": _segs_format(segs_enc),
                      "floats": _floats_format(floats)}
        if stats is not None:  # encode + copy issue
            stats["pack"] = time.perf_counter() - t0
        return rp

    @staticmethod
    def _encode_locals(locs: np.ndarray, bits: int):
        """Wire for slot-local rows, narrowest first: u12 byte triples,
        plain u16, 16-bit lows + m-bit packed highs (``pack_u16m``), raw
        int32."""
        k = locs.shape[-1]
        if bits <= 12 and k % 2 == 0:
            return pack_u12(locs)
        if bits <= 16:
            return (locs.astype(np.uint16),)
        for m in (1, 2, 4, 8):
            if bits <= 16 + m and k % (8 // m) == 0:
                return pack_u16m(locs, m)
        return (locs,)

    # ---- fronts ----
    @classmethod
    def _front(cls, dataset: InMemoryDataset, floats_dtype=np.float32):
        """Slice the pass into per-batch key views and pack the float
        block. Returns (per_batch, floats, qmeta, trivial, num_records,
        side); per_batch entries are (keys, slot_of_key, key_capacity,
        pad_segment, segments)."""
        wire = float_wire(floats_dtype)
        col = getattr(dataset, "columnar", None)
        if col is not None:
            return cls._front_columnar(dataset, col, wire)
        if (wire == "q8" and FLAGS.q8_streaming_front
                and getattr(dataset, "supports_reiteration", False)):
            return cls._front_q8_streaming(dataset)
        per_batch = []
        floats_l = []
        trivial = True
        nrec = 0
        # q8 here stages the whole pass f32 for its range stats; the other
        # wires cast batch by batch
        batch_dtype = torch.bfloat16 if wire == "bf16" else np.float32
        for b in dataset.batches():
            poll_preload_abort()
            nk = b.num_keys
            slot_of_key = (b.segments[:nk] % b.num_slots).astype(np.int16)
            per_batch.append((b.keys[:nk], slot_of_key, b.key_capacity,
                              b.pad_segment,
                              b.segments[:nk].astype(np.int32, copy=False)))
            floats_l.append(pack_floats(b.dense, b.label, b.show, b.clk,
                                        dtype=batch_dtype))
            nrec += int((b.show > 0).sum())
            trivial = trivial and b.segments_trivial
        if not per_batch:
            raise ValueError("empty pass")
        floats = np.stack(floats_l)
        qmeta = None
        if wire == "q8":
            floats, qmeta = cls._encode_floats(floats, wire)
        return per_batch, floats, qmeta, trivial, nrec, None

    @classmethod
    def _front_q8_streaming(cls, dataset: InMemoryDataset):
        """q8 front without a whole-pass f32 block: the first walk takes
        the key views, the per-column min/max over REAL rows (show > 0,
        ``quantize_floats``' ``valid``) and the exact-u8 checks of
        label/show/clk; the second walk casts each batch straight to u8
        with the pass's qmeta. Unlike ``quantize_floats`` it cannot
        winsorize (that needs the whole distribution): heavy-tailed
        columns keep the raw min/max. Data that does not fit the u8 wire
        falls back to bf16, as ``_encode_floats`` does."""
        per_batch = []
        trivial = True
        nrec = 0
        lo = hi = None
        n_valid = 0
        first_row = None
        fits = True
        for b in dataset.batches():
            poll_preload_abort()
            nk = b.num_keys
            slot_of_key = (b.segments[:nk] % b.num_slots).astype(np.int16)
            per_batch.append((b.keys[:nk], slot_of_key, b.key_capacity,
                              b.pad_segment,
                              b.segments[:nk].astype(np.int32, copy=False)))
            nrec += int((b.show > 0).sum())
            trivial = trivial and b.segments_trivial
            d = b.dense.astype(np.float32, copy=False)
            if fits:
                lsc = np.stack([b.label, b.show, b.clk], axis=1)
                if (not np.isfinite(d).all() or (lsc < 0).any()
                        or (lsc > 255).any()
                        or (lsc != np.rint(lsc)).any()):
                    fits = False
            if first_row is None and d.shape[0]:
                first_row = d[:1].copy()
            valid = b.show > 0
            if valid.any():
                stat = d[valid]
                n_valid += stat.shape[0]
                blo, bhi = stat.min(axis=0), stat.max(axis=0)
                lo = blo if lo is None else np.minimum(lo, blo)
                hi = bhi if hi is None else np.maximum(hi, bhi)
        if not per_batch:
            raise ValueError("empty pass")
        if n_valid == 0:  # quantize_floats' stat = d[:1] fallback
            lo = first_row.min(axis=0)
            hi = first_row.max(axis=0)
        if not fits:
            log.warning("q8 float wire: data out of range, using bf16")
            floats = np.stack([
                pack_floats(b.dense, b.label, b.show, b.clk,
                            dtype=torch.bfloat16)
                for b in dataset.batches()])
            return per_batch, floats, None, trivial, nrec, None
        scale = (hi - lo) / 255.0
        scale = np.where(scale > 0, scale, 1.0).astype(np.float32)
        lo = lo.astype(np.float32)
        qmeta = np.stack([scale, lo])
        floats_u8 = None
        for i, b in enumerate(dataset.batches()):
            poll_preload_abort()
            d = b.dense.astype(np.float32, copy=False)
            q = np.clip(np.rint((d - lo[None, :]) / scale[None, :]), 0, 255)
            blk = np.concatenate(
                [q, np.stack([b.label, b.show, b.clk], axis=1)],
                axis=1).astype(np.uint8)
            if floats_u8 is None:
                floats_u8 = np.zeros((len(per_batch),) + blk.shape,
                                     np.uint8)
            floats_u8[i] = blk
        return per_batch, floats_u8, qmeta, trivial, nrec, None

    @classmethod
    def _front_columnar(cls, dataset: InMemoryDataset, col, wire: str):
        """Whole-pass front of a columnar dataset: array slices and bulk
        reshapes, no batch objects and no per-record Python."""
        desc = dataset.desc
        bs = desc.batch_size
        s = len(desc.sparse_slots)
        r = col.num_records
        if r == 0:
            raise ValueError("empty pass")
        nb = (r + bs - 1) // bs
        offsets = col.offsets
        bounds = offsets[np.minimum(np.arange(nb + 1) * bs, r)]
        nk_arr = np.diff(bounds)
        # ONE uniform key capacity for the pass: the fine ladder pads
        # ~6% where the batch builder's power-of-two bucket pads up to 2x
        k_max = next_bucket_fine(desc.key_bucket_min, int(nk_arr.max()))
        counts = np.diff(offsets)
        # trivial = exactly one key per slot per record, in slot order
        trivial = (col.key_slot.size == r * s and bool((counts == s).all())
                   and bool((col.key_slot.reshape(r, s)
                             == np.arange(s, dtype=np.int32)).all()))
        pad_seg = bs * s
        segs_global = None
        if not trivial:
            rec_of_key = np.repeat(np.arange(r, dtype=np.int64), counts)
            segs_global = ((rec_of_key % bs) * s
                           + col.key_slot).astype(np.int32)
        per_batch = []
        for i in range(nb):
            a, b = int(bounds[i]), int(bounds[i + 1])
            per_batch.append((
                col.keys[a:b], col.key_slot[a:b].astype(np.int16),
                k_max, pad_seg,
                None if trivial else segs_global[a:b]))
        # the float block for the whole pass, the tail batch zero-padded
        floats_full = pack_floats(col.dense, col.label, col.show, col.clk)
        d3 = floats_full.shape[1]
        if nb * bs != r:
            padded = np.zeros((nb * bs, d3), np.float32)
            padded[:r] = floats_full
            floats_full = padded
        floats, qmeta = cls._encode_floats(floats_full.reshape(nb, bs, d3),
                                           wire)
        # side channels for the post-pass metric feed (record j of batch
        # i is columnar row i*bs + j); references, not copies
        side = {"label": col.label, "show": col.show, "uid": col.uid,
                "rank": col.rank, "cmatch": col.cmatch,
                "batch_size": bs, "num_records": r}
        return (per_batch, floats, qmeta, trivial,
                int((col.show > 0).sum()), side)

    @staticmethod
    def _encode_floats(floats: np.ndarray, wire: str):
        """The float wire of a packed f32 block [nb, B, D+3]: "q8" →
        per-column affine uint8 over the whole pass (``quantize_floats``,
        range over real rows, show > 0; bf16 when the data does not fit),
        "bf16" → the bf16 bits, "f32" as it is. Returns (block, qmeta or
        None)."""
        if wire == "q8":
            nb, b, d3 = floats.shape
            flat = floats.reshape(nb * b, d3)
            q = quantize_floats(flat[:, :-3], flat[:, -3], flat[:, -2],
                                flat[:, -1], valid=flat[:, -2] > 0)
            if q is not None:
                block, qmeta = q
                return block.reshape(nb, b, d3), qmeta
            log.warning("q8 float wire: data out of range, using bf16")
            wire = "bf16"
        if wire == "bf16":
            return bf16_bits(floats), None
        return floats.astype(np.float32, copy=False), None

    # ---- dedup and pack ----
    @classmethod
    def _dedup_phase(cls, per_batch, table, threads: int = 4,
                     stats: Optional[Dict[str, float]] = None):
        """Pass-level row assignment and per-batch dedup. Returns
        ([(uniq_sorted, gidx)] per batch, u_pad, k_max).

        BULK path (``FLAGS.bulk_pass_assign``, default): every batch's
        keys concatenated, ONE first-seen dedup + assignment
        (``table.bulk_assign_unique``; ``stats`` gets its host kv and
        device index seconds), then the per-batch sort/rank splits on a
        thread pool (numpy releases the GIL). New rows come in first-seen
        order over the pass, the rows a serial batch walk of the
        first-occurrence index gives.

        SERIAL path (flag off): one index round trip per batch."""
        if FLAGS.bulk_pass_assign:
            keys_all = np.concatenate([k for k, *_ in per_batch])
            slots_all = np.concatenate([s for _, s, *_ in per_batch])
            rows_u, inv = table.bulk_assign_unique(keys_all, slots_all)
            if stats is not None:
                las = table.last_assign_seconds
                stats["index_host"] = las["index_host"]
                stats["index_dev"] = las["index_device"]
            rows_of_key = rows_u[inv]
            bounds = np.cumsum([0] + [len(k) for k, *_ in per_batch])
            poll_preload_abort()

            def batch_dedup(a, b):
                u, g = np.unique(rows_of_key[a:b], return_inverse=True)
                return (u.astype(np.int32, copy=False),
                        g.astype(np.int32, copy=False))

            with ThreadPoolExecutor(max_workers=threads) as pool:
                dedup = list(pool.map(batch_dedup, bounds[:-1], bounds[1:]))
        else:
            dedup = cls._dedup_serial(per_batch, table, threads)
        u_max = max(len(u) + 1 for u, _ in dedup)
        u_pad = next_bucket_fine(table.unique_bucket_min, u_max)
        k_max = max(kc for _, _, kc, _, _ in per_batch)
        return dedup, u_pad, k_max

    @classmethod
    def _dedup_serial(cls, per_batch, table, threads: int = 4):
        """The per-batch assignment loop: one ``host_lock`` acquisition
        and index round trip per batch. Arena tables assign slotted here
        too, so keys seen first on the dedup wire land in their slot's
        arena and do not keep the compact wire off for later passes."""

        def sort_rank(rows_u, inv):
            u = len(rows_u)
            order = np.argsort(rows_u, kind="stable")
            rank = np.empty(u, np.int32)
            rank[order] = np.arange(u, dtype=np.int32)
            return rows_u[order], rank[inv]

        slotted = table.index.arena_enabled
        futs = []
        with ThreadPoolExecutor(max_workers=threads) as pool:
            for keys, slot_of_key, *_ in per_batch:
                with table.host_lock:
                    if slotted:
                        rows_u, inv = table.index.assign_unique_slotted(
                            keys, slot_of_key.astype(np.uint16, copy=False))
                    else:
                        rows_u, inv = table.index.assign_unique(keys)
                    table.record_slots(rows_u, inv, slot_of_key)
                futs.append(pool.submit(sort_rank, rows_u, inv))
            return [f.result() for f in futs]

    @classmethod
    def _pack_chunk(cls, per_batch, dedup, u_pad: int, k_max: int,
                    trivial: bool, cap: int):
        """Pack the batches into uniform host arrays (uniq, gidx, meta,
        segs-or-None), unique rows ascending (so the wire ships deltas)."""
        nb = len(per_batch)
        uniq = np.empty((nb, u_pad), np.int32)
        gidx = np.empty((nb, k_max), np.int32)
        meta = np.empty((nb, 4), np.int32)
        segs = None if trivial else np.empty((nb, k_max), np.int32)
        for i, ((keys, _, _, pad_seg, seg_arr),
                (uniq_s, gidx_i)) in enumerate(zip(per_batch, dedup)):
            nk, u = len(keys), len(uniq_s)
            uniq[i, :u] = uniq_s
            fill_oob_pads(uniq[i], u, cap)
            gidx[i, :nk] = gidx_i
            gidx[i, nk:] = u  # key pads → first OOB pad position
            meta[i] = (nk, pad_seg, u, uniq[i, 0])
            if segs is not None:
                segs[i, :nk] = seg_arr
                segs[i, nk:] = pad_seg
        return uniq, gidx, meta, segs

    # ---- staging ----
    def upload(self, device: torch.device) -> None:
        """Stage the pass on ``device``, bit-packed for the wire: each
        block in the narrowest format the choosers that ``build_streamed``
        applies find for the whole pass. The copies are issued on the
        current stream and not waited for (``ready``; ``settle`` waits on
        the host). The per-batch key counts stay on the host (``meta``).
        Encoding adds to ``build_stats["pack"]``, the copies' issue is
        ``build_stats["h2d"]``. A no-op once staged."""
        if self.dev is not None:
            return
        t0 = time.perf_counter()
        uniq, meta = self.uniq, self.meta
        # the delta wire's base column is each batch's first row
        ufmt = self._choose_uniq_fmt(
            [uniq[i, :n] for i, n in enumerate(meta[:, 2])],
            int(uniq.max(initial=0)),
            delta=bool((meta[:, 3] == uniq[:, 0]).all()))
        gfmt = self._choose_gidx_fmt(int(self.gidx.max(initial=0)),
                                     self.key_capacity)
        ue = self._encode_uniq_fmt(ufmt, uniq, meta)
        ge = self._encode_gidx_fmt(gfmt, self.gidx)
        se = (None if self.segs is None else
              self._encode_segs_or_fallback(self.segs, meta, self.floats))
        t1 = time.perf_counter()
        stager = _Stager(device)
        self.dev = (tuple(stager.put(a) for a in ue),
                    tuple(stager.put(a) for a in ge),
                    stager.floats(self.floats),
                    None if se is None else tuple(stager.put(a) for a in se),
                    None if self.qmeta is None else stager.put(self.qmeta))
        self.formats = {"uniq": ufmt, "gidx": gfmt,
                        "segs": _segs_format(se),
                        "floats": _floats_format(self.floats)}
        self._staged(stager, block=False)
        self.build_stats["pack"] = (self.build_stats.get("pack", 0.0)
                                    + t1 - t0)
        self.build_stats["h2d"] = time.perf_counter() - t1

    @staticmethod
    def _encode_segs_slotwire(segs: np.ndarray, meta: np.ndarray,
                              batch_size: int):
        """Segment wire for ragged layouts, narrowest first.

        GRID wire: with keys ordered by (record, slot), the batch builder's
        layout, the segment stream is the per-(record, slot) key COUNTS,
        one u8 [B, S] grid (~S bytes a record instead of ~1 byte a key).

        SLOT wire: per-key SLOT ids (u8) + per-record key COUNTS (u16);
        needs record grouping only.

        Preconditions for either (else None → the u18 wire): S ≤ 255,
        pad_segment == B·S, keys record-grouped; GRID also needs
        nondecreasing segments within each batch, counts ≤ 255, and must
        be the smaller wire. Pads decode for free in both."""
        nb, k = segs.shape
        b = batch_size
        s = int(meta[0, 1]) // b          # pad_segment == bs * S
        if s <= 0 or s > 255 or int(meta[0, 1]) != b * s:
            return None
        rec = segs // s
        # GRID only when it is the smaller wire: b*s bytes against the
        # SLOT wire's k + 2b a batch
        grid_ok = b * s < k + 2 * b
        grid = (np.zeros((nb, b * s), np.int64) if grid_ok else None)
        counts = np.zeros((nb, b), np.int64)
        for i in range(nb):
            nk = int(meta[i, 0])
            r = rec[i, :nk]
            if nk and (np.diff(r) < 0).any():
                return None               # keys not record-grouped
            if nk and int(r.max()) >= b:
                return None
            if segs[i, nk:].size and (segs[i, nk:] != b * s).any():
                return None               # pads must be the discard bin
            if grid_ok and nk and (np.diff(segs[i, :nk]) < 0).any():
                grid_ok = False
            if grid_ok:
                grid[i] = np.bincount(segs[i, :nk], minlength=b * s)
                counts[i] = grid[i].reshape(b, s).sum(axis=1)
            else:
                counts[i] = np.bincount(r, minlength=b)
        if grid_ok and int(grid.max()) <= 255:
            return (grid.reshape(nb, b, s).astype(np.uint8),)
        if int(counts.max()) > 65535:
            return None
        return (segs % s).astype(np.uint8), counts.astype(np.uint16)

    def nbytes(self) -> int:
        """Bytes staged on the device (after upload; before it, the host
        int32/f32 bytes)."""
        if self.dev is not None:
            return sum(t.numel() * t.element_size() for t in self._leaves())
        n = self.uniq.nbytes + self.gidx.nbytes + self.floats.nbytes
        return n + (self.segs.nbytes if self.segs is not None else 0)

    def mark_trained_rows(self, table) -> None:
        """Flag this pass's rows as touched since the last save — called
        AFTER the pass trains. The OOB pad ids are dropped first."""
        rows = self.uniq.ravel()
        rows = rows[rows <= table.capacity]
        with table.host_lock:
            table._touched[rows] = True


class _BatchView:
    """One staged batch, decoded on the device, duck-typed to the
    ``DeviceBatch`` fields that ``TrainStep`` reads."""

    def __init__(self, unique_rows: torch.Tensor, gather_idx: torch.Tensor,
                 segments: Optional[torch.Tensor], dense: torch.Tensor,
                 label: torch.Tensor, show: torch.Tensor, clk: torch.Tensor,
                 num_keys: int) -> None:
        self.unique_rows = unique_rows
        self.gather_idx = gather_idx
        self.pool_segments = segments  # None: the trivial layout
        self.num_keys = num_keys
        self.dense, self.label, self.show = dense, label, show
        self.show_clk = torch.stack([show, clk], dim=1)


class ResidentPassRunner:
    """Runs a staged pass through a ``TrainStep``, one step per batch,
    each batch's view sliced and decoded on the device."""

    def __init__(self, step: TrainStep, trivial_segments: bool,
                 chunk: int = 0, wire: str = "dedup",
                 num_slots: Optional[int] = None,
                 chunk_bits: Optional[int] = None) -> None:
        self.step = step
        self.trivial = trivial_segments
        self.chunk = chunk
        self.wire = wire              # "dedup" | "compact"
        # compact: a key's slot is its segment % S
        self.num_slots = (num_slots if num_slots is not None
                          else getattr(step, "num_slots", None))
        self.chunk_bits = chunk_bits

    @staticmethod
    def _decode_segs(segs: tuple, pad_seg: int, k_pad: int) -> torch.Tensor:
        """The segment ids of one batch from its wire: raw int32, a u18
        pair (uint16-as-int16 lows), the GRID wire (one u8 [B, S] count
        grid) or the SLOT wire (u8 slots + u16 record counts), told apart
        by leaf count, dtype and rank. Both count wires decode with the
        scatter+cumsum identity: out[p] = #{cells whose cumulative count
        <= p}. Pads saturate at B·S (GRID) or land on it (SLOT)."""

        def cum_decode(counts_flat, k):
            # empty cells stack duplicate marks, hence the accumulate;
            # marks past the end go to a spare bin that is cut off
            cum = torch.cumsum(counts_flat, 0, dtype=torch.int32)
            marks = torch.zeros(k + 1, dtype=torch.int32,
                                device=counts_flat.device)
            marks.index_put_((cum.clamp(max=k).long(),),
                             torch.ones_like(cum), accumulate=True)
            return torch.cumsum(marks[:k], 0, dtype=torch.int32)

        if len(segs) == 1:
            if segs[0].dtype == torch.uint8 and segs[0].dim() == 2:
                return cum_decode(segs[0].reshape(-1).to(torch.int32), k_pad)
            return segs[0]
        if segs[0].dtype == torch.uint8:
            slot = segs[0].to(torch.int32)              # [K]
            counts = widen_u16(segs[1])                      # [B]
            s = pad_seg // counts.shape[0]
            return cum_decode(counts, slot.shape[0]) * s + slot
        return unpack_u16m(segs[0], segs[1], 2)

    @staticmethod
    def _decode_floats(floats: torch.Tensor, qmeta: Optional[torch.Tensor]):
        if floats.dtype == torch.uint8:  # the q8 wire
            return dequantize_floats(floats, qmeta)
        return unpack_floats(floats)

    def _make_view(self, rp: ResidentPass, i: int,
                   capacity: int) -> _BatchView:
        nk, pad_seg, nu, base = (int(v) for v in rp.meta[i])
        uniq_t, gidx_t, floats_t, segs_t, qm = rp.dev
        if self.wire == "compact":
            return self._make_view_compact(
                tuple(a[i] for a in uniq_t), gidx_t[0], floats_t[i],
                None if segs_t is None else tuple(a[i] for a in segs_t),
                qm, nk, pad_seg, capacity)
        u = tuple(a[i] for a in uniq_t)
        if len(u) == 3:
            # delta wire; the pad region is derived (the fill_oob_pads
            # pattern: distinct, > capacity)
            upos = torch.arange(u[0].shape[0], dtype=torch.int32,
                                device=u[0].device)
            uniq = torch.where(upos < nu, unpack_delta16(*u, base=base),
                               capacity + 1 + upos)
        elif len(u) == 2:
            uniq = unpack_u24(*u)
        else:
            uniq = u[0]
        g = tuple(a[i] for a in gidx_t)
        gidx = unpack_u18(*g) if len(g) == 2 else g[0]
        segments = (None if self.trivial else self._decode_segs(
            tuple(a[i] for a in segs_t), pad_seg, gidx.shape[0]))
        dense, label, show, clk = self._decode_floats(floats_t[i], qm)
        return _BatchView(uniq, gidx, segments, dense, label, show, clk, nk)

    def _make_view_compact(self, loc: tuple, cmap: torch.Tensor,
                           floats: torch.Tensor, segs: Optional[tuple],
                           qmeta: Optional[torch.Tensor], nk: int,
                           pad_seg: int, capacity: int) -> _BatchView:
        """Decode the compact wire: slot-local rows → global rows through
        the arena chunk map, then the batch's dedup on the device."""
        if len(loc) == 2:
            k = loc[0].shape[-1]
            local = unpack_u16m(loc[0], loc[1], 8 * loc[1].shape[-1] // k)
        elif loc[0].dtype == torch.uint8:   # u12 byte triples
            local = unpack_u12(loc[0])
        elif loc[0].dtype == torch.int16:   # plain u16
            local = widen_u16(loc[0])
        else:
            local = loc[0]
        k = local.shape[-1]
        pos = torch.arange(k, dtype=torch.int32, device=local.device)
        s = self.num_slots
        if self.trivial:
            segments = None
            slot = pos % s
        else:
            segments = self._decode_segs(segs, pad_seg, k)
            slot = segments % s
        cb = self.chunk_bits
        stride = cmap.shape[1]
        chunk = cmap.reshape(-1)[(slot * stride + (local >> cb)).long()]
        rows = (chunk << cb) | (local & ((1 << cb) - 1))
        rows = torch.where(pos < nk, rows, capacity)
        uniq, gidx = dedup_rows(rows, capacity)
        dense, label, show, clk = self._decode_floats(floats, qmeta)
        return _BatchView(uniq, gidx, segments, dense, label, show, clk, nk)

    def run_pass(self, state: StepState, rp: ResidentPass, seed: int,
                 global_step: int, chunk: Optional[int] = None,
                 collect_preds: bool = False):
        """Run every staged batch, updating ``state`` in place. Step i
        draws its lazy-mf values from ``seeded_generator(device, seed + 1,
        global_step + i + 1)``, the generator ``Trainer.train_pass`` gives
        the same global step. The current stream first waits, on the
        device, for the pass's copies. The host queues ``chunk`` steps
        (default: the runner's, else the whole pass) before it waits for
        the card. Returns the per-step losses (device tensors); with
        ``collect_preds``, (losses, preds [nb, B]) — the predictions the
        post-pass metric feed reads."""
        device = state.table.data.device
        rp.upload(device)
        rp.wait_ready(device)
        capacity = state.table.capacity
        nb = rp.num_batches
        c = chunk or self.chunk or nb
        losses, preds = [], []
        for i in range(nb):
            gen = seeded_generator(device, seed + 1, global_step + i + 1)
            stats = self.step(state, self._make_view(rp, i, capacity), gen)
            losses.append(stats["loss"])
            if collect_preds:
                preds.append(stats["pred"])
            if (i + 1) % c == 0:
                losses[-1].item()   # the chunk is done on the card
        rp.release_host_buffers()
        if collect_preds:
            return losses, torch.stack(preds)
        return losses


class PassPreloader:
    """Depth-N pass pipeline (the reference's preload_into_memory /
    wait_feed_pass_done for resident passes): ONE persistent worker
    thread builds and stages passes ahead of training through a bounded
    queue of ``depth`` passes (``FLAGS.preload_depth``, default 2); pass
    k+2's build starts the moment k+1's finishes.

    On the card the worker runs on its own CUDA stream; a pass's copies
    (and its build's device key-index work) are ordered before the
    consumer's first step by the pass's event (``ResidentPass.
    wait_ready``), never by a host wait.

    Device memory guard: after each build the staged bytes
    (``rp.nbytes()``) clamp the EFFECTIVE depth to ``max(1, budget //
    bytes)`` (``FLAGS.preload_hbm_budget_mb``), loudly; the clamp never
    rises again.

    Preemption: the worker polls the graceful-stop flag before every
    build and every build polls it between stages
    (``poll_preload_abort``); staged passes stay consumable, and
    ``drain()`` joins the worker and waits out every copy.

    A build failure is held and raised by the ``wait()`` that would have
    returned that pass: passes built before it are served first, and
    every ``wait()`` after the raise returns None.

    ``depth=0`` is the manual mode: one build per ``start_next()``."""

    def __init__(self, datasets: Iterator[InMemoryDataset], table=None,
                 floats_dtype=np.float32, build_fn=None,
                 depth: Optional[int] = None, device=None) -> None:
        """``build_fn(dataset) -> pass`` replaces the default
        ``ResidentPass.build_streamed`` on ``table``. ``depth`` overrides
        ``FLAGS.preload_depth``. ``device`` (default: the table's, else
        the card) is where the passes are staged."""
        if table is None and build_fn is None:
            raise ValueError("need a table or a build_fn")
        self._it = iter(datasets)
        self._table = table
        self._floats_dtype = floats_dtype
        self._build_fn = build_fn
        self._device = (table.device if table is not None and device is None
                        else resolve_device(device or "cuda"))
        depth = FLAGS.preload_depth if depth is None else depth
        self._manual = depth == 0
        self._credits = 0
        self.depth = max(1, depth)
        self._budget = FLAGS.preload_hbm_budget_mb * (1 << 20)
        self._cv = threading.Condition()
        self._q: collections.deque = collections.deque()
        self._building = False
        self._exhausted = False   # source iterator drained
        self._stopped = False     # stop()/abort: no further builds
        self._err: Optional[BaseException] = None
        self._worker: Optional[threading.Thread] = None
        self._stream = None       # the worker's CUDA stream
        self._cuda_index = 0      # its device, fixed when it starts
        self._effective_depth = self.depth
        self.depth_clamped = False
        # accounting: builds, their seconds in all and by stage, and the
        # seconds the consumer blocked in wait()
        self.build_stage_sec: Dict[str, float] = {}
        self.builds = 0
        self.build_sec_total = 0.0
        self.wait_sec_total = 0.0

    # ---- worker ----
    def _build(self, ds):
        if self._build_fn is not None:
            rp = self._build_fn(ds)
            rp.upload(self._device)  # a no-op if the build staged it
            return rp
        return ResidentPass.build_streamed(
            ds, self._table, floats_dtype=self._floats_dtype, block=False)

    def _run(self) -> None:
        # the builds' stage polls see THIS preloader's stop()
        _PRELOAD_TLS.abort = lambda: self._stopped
        trace.set_lane(trace.LANE_PRELOAD)
        ctx = contextlib.nullcontext()
        if self._device.type == "cuda":
            # a new thread starts on device 0: take the caller's device
            torch.cuda.set_device(self._cuda_index)
            self._stream = torch.cuda.Stream(self._cuda_index)
            ctx = torch.cuda.stream(self._stream)
        with ctx:
            self._loop()

    def _loop(self) -> None:
        while True:
            with self._cv:
                while not self._stopped and (
                        len(self._q) + (1 if self._building else 0)
                        >= self._effective_depth
                        or (self._manual and self._credits <= 0)):
                    self._cv.wait()
                if self._stopped:
                    return
                if self._manual:
                    self._credits -= 1
                self._building = True
            rp = None
            try:
                if preemption.stop_pending():
                    raise PreloadBuildAborted(
                        f"preload stopped ({preemption.stop_reason()})")
                ds = next(self._it, None)
                if ds is None:
                    with self._cv:
                        self._building = False
                        self._exhausted = True
                        self._cv.notify_all()
                    return
                t0 = time.perf_counter()
                # the build span on the preload.worker lane; its id rides
                # the pass so the main thread's consume span links back
                with trace.span("pass.build",
                                pass_seq=self.builds + 1) as sp:
                    rp = self._build(ds)
                if sp.span_id:
                    try:
                        rp._trace_span_id = sp.span_id
                    except AttributeError:
                        pass  # slotted pass objects skip the link
                self._note_built(rp, time.perf_counter() - t0)
            except PreloadBuildAborted as e:
                log.warning("pass preload pipeline stopped: %s", e)
                with self._cv:
                    self._building = False
                    self._stopped = True
                    self._cv.notify_all()
                return
            except BaseException as e:  # held for the consuming wait()
                with self._cv:
                    self._building = False
                    self._err = e
                    self._cv.notify_all()
                return
            with self._cv:
                self._building = False
                dropped = self._stopped
                if not dropped:
                    self._q.append(rp)
                depth = len(self._q)
                self._cv.notify_all()
            if dropped:
                # drained mid-build: wait out the pass's copies before
                # dropping it, so drain() means "no copy in flight"
                _settle(rp)
                return
            self._mirror_queue(depth)

    def _note_built(self, rp, build_sec: float) -> None:
        """Accounting and the budget clamp, off the queue lock."""
        self.builds += 1
        self.build_sec_total += build_sec
        hub = active_hub()
        for stage, sec in (getattr(rp, "build_stats", None) or {}).items():
            self.build_stage_sec[stage] = \
                self.build_stage_sec.get(stage, 0.0) + sec
            if hub is not None:
                hub.counter("pbox_preload_build_seconds_total",
                            "pass preload build seconds by stage"
                            ).inc(sec, stage=stage)
        if hub is not None:
            hub.counter("pbox_preload_builds_total",
                        "passes built by the preload pipeline").inc()
        if self._budget <= 0:
            return
        nbytes = int(rp.nbytes())
        if nbytes <= 0:
            return
        fit = max(1, int(self._budget // nbytes))
        with self._cv:
            if fit >= self._effective_depth:
                return
            self._effective_depth = fit
            self.depth_clamped = True
        log.warning(
            "preload device-memory budget: a staged pass is ~%.1f MB but "
            "the budget is %.1f MB — clamping preload depth %d -> %d "
            "(raise FLAGS.preload_hbm_budget_mb to restore the deeper "
            "pipeline)", nbytes / 1e6, self._budget / 1e6, self.depth, fit)
        hub = active_hub()
        if hub is not None:
            hub.counter("pbox_preload_depth_clamps_total",
                        "preload depth reductions forced by the "
                        "device-memory budget").inc()

    # ---- consumer ----
    def start_next(self) -> bool:
        """Start the worker if needed (and, at depth 0, grant one build).
        Returns False only when the source is KNOWN exhausted and nothing
        remains: the next ``wait()`` would return None."""
        with self._cv:
            if self._manual:
                self._credits += 1
                self._cv.notify_all()
        if self._worker is None:
            if self._device.type == "cuda":
                self._cuda_index = (self._device.index
                                    if self._device.index is not None
                                    else torch.cuda.current_device())
            self._worker = threading.Thread(
                target=self._run, daemon=True, name="pbx-preload")
            self._worker.start()
        with self._cv:
            return not (self._exhausted and not self._q
                        and not self._building and self._err is None)

    def wait(self) -> Optional[ResidentPass]:
        """Block until the next pass is staged and pop it; None at the end
        of the stream (or after ``stop()`` or a raised build failure).
        The blocked seconds (the pipeline's prologue stall) add to
        ``wait_sec_total``. With ``FLAGS.pipeline_wait_timeout_sec > 0``
        a wait during which no build completes for that long raises
        ``PipelineHangError``."""
        if self._worker is None:
            return None
        t0 = time.perf_counter()
        err = None
        with self._cv:
            wait_with_deadline(
                self._cv,
                done=lambda: bool(self._q) or self._exhausted
                or self._stopped or self._err is not None,
                progress=lambda: self.builds,
                stage="preload.build",
                message=lambda: (
                    f"pass preload wait hung: stage 'preload.build' made "
                    f"no progress for {hang_timeout():.1f}s — 0 staged "
                    f"pass(es) queued (building={self._building}, "
                    f"builds_done={self.builds}, effective_depth="
                    f"{self._effective_depth}, worker_alive="
                    f"{self._worker.is_alive()})"))
            waited = time.perf_counter() - t0
            if self._q:
                rp = self._q.popleft()
            else:
                rp = None
                if self._err is not None:
                    err, self._err = self._err, None
                    self._stopped = True
            depth = len(self._q)
            self._cv.notify_all()  # a build slot just freed
        self.wait_sec_total += waited
        hub = active_hub()
        if hub is not None:
            if waited > 1e-4:
                hub.counter("pbox_preload_wait_seconds_total",
                            "seconds the trainer blocked on pass preload"
                            ).inc(waited)
                # the blocked wait is the consuming pass's build stall
                # (its pass event's critical_path block)
                trace.note_pass_part("build_wait", waited)
            hub.gauge("pbox_preload_queue_depth",
                      "staged passes queued ahead of training").set(depth)
        if err is not None:
            raise err
        return rp

    # ---- shutdown ----
    def stop(self) -> None:
        """No new builds; an in-flight build aborts at its next stage
        poll. Staged passes stay consumable."""
        with self._cv:
            self._stopped = True
            self._cv.notify_all()

    def drain(self, timeout: Optional[float] = None) -> None:
        """``stop()``, join the worker, then wait out every copy the
        pipeline issued: after this returns no preload copy is in flight
        (call it before an emergency checkpoint)."""
        self.stop()
        w = self._worker
        if w is not None and w.is_alive():
            w.join(timeout)
        if self._stream is not None:
            self._stream.synchronize()
        with self._cv:
            staged = list(self._q)
        for rp in staged:
            _settle(rp)

    @property
    def staged(self) -> int:
        """Passes built and not yet consumed."""
        with self._cv:
            return len(self._q)

    @staticmethod
    def _mirror_queue(depth: int) -> None:
        hub = active_hub()
        if hub is not None:
            hub.gauge("pbox_preload_queue_depth",
                      "staged passes queued ahead of training").set(depth)


def _settle(rp) -> None:
    settle = getattr(rp, "settle", None)
    if settle is not None:
        settle()


class PassPipeline:
    """The pass pipeline — build → stage → consume → epilogue — shared by
    plain resident tables and pass-window tables:

      build    the host pack of the pass (``build_fn``: e.g.
               ``ShardedTrainer.build_resident_pass``)
      stage    the pass's bytes to where training reads them: the wire
               upload, plus for a pass-WINDOW table the host-tier fetch
               (``table.stage``)
      consume  ``begin_pass`` (the window table's reconcile) and the
               resident train loop
      epilogue ``end_pass``'s write-back on the table's ``PassEpilogue``
               worker, which also carries the eviction for the next
               queued pass and the SSD watermark demotion

    For a plain resident table (``window_table=None``) this is the
    depth-N ``PassPreloader`` with an empty epilogue. For a window table
    (``TieredShardedEmbeddingTable``) each build runs on the worker
    inside the table's ``plan_scope`` and ``pin_working_set``, followed
    there by the host fetch, queued in pass order
    (``table.stage(keys, background=False, queue=True)``): by the time
    ``wait()`` hands a pass out, its plan is baked (plan-pending rows),
    its wire is staged, its host values are fetched and its spilled rows
    promoted (``prefetch_promote`` inside the build), so ``begin_pass()``
    only reconciles.

        pipe = PassPipeline(datasets, build_fn=tr.build_resident_pass,
                            window_table=table, trainer=tr)
        pipe.start_next()
        while (rp := pipe.wait()) is not None:
            pipe.begin_pass()                  # reconcile-only
            pipe.start_next()
            tr.train_pass_resident(rp)
            pipe.end_pass()                    # submit; the worker drains
        pipe.drain()

    ``depth=0`` is the sequential kick-per-pass control."""

    def __init__(self, datasets: Iterator, build_fn, window_table=None,
                 trainer=None, depth: Optional[int] = None,
                 keys_of=None, device=None) -> None:
        """The passes are staged on ``device`` (default: the
        ``trainer``'s, its first shard's for a sharded trainer, else the
        card). ``keys_of(ds)`` gives a pass's working set (default
        ``ds.pass_keys()``)."""
        self.table = window_table
        self.trainer = trainer
        self._keys_of = keys_of or (lambda ds: ds.pass_keys())
        # key sets of built-and-staged passes, in build order: begin_pass
        # checks the head queued stage against them
        self._key_q: collections.deque = collections.deque()
        self._lock = threading.Lock()
        # the table's fence-wait seconds at the last end_pass: its
        # endpass_stats are cumulative, and a new pipeline over a
        # long-lived table must not book old waits into its first pass
        self._fence_wait_mark = 0.0
        if window_table is not None:
            eps = getattr(window_table, "endpass_stats", None)
            if eps is not None:
                self._fence_wait_mark = float(
                    eps().get("critical_fence_wait_sec", 0.0))
        build = build_fn if window_table is None else self._window_build(
            build_fn)
        if device is None and trainer is not None:
            device = getattr(trainer, "device", None)
            if device is None:
                device = trainer.devices[0]
        self.pre = PassPreloader(iter(datasets), build_fn=build,
                                 depth=depth, device=device)

    def _window_build(self, build_fn):
        """``build_fn`` wrapped for a pass-window table: the plan build
        and the host fetch in ONE outer ``plan_scope`` (an abort or a
        fetch failure between them rolls the pass's plan-pending rows
        back), with the working set pinned against eviction from the
        plan's first row lookup until the queued stage takes the pin
        over."""
        table = self.table

        def build(ds):
            keys = self._keys_of(ds)
            scope = getattr(table, "plan_scope", None)
            pin = getattr(table, "pin_working_set", None)
            with (scope() if scope is not None
                  else contextlib.nullcontext()):
                if pin is not None:
                    pin(keys)
                try:
                    t0 = time.perf_counter()
                    rp = build_fn(ds)
                    t_build = time.perf_counter() - t0
                    poll_preload_abort()
                    t0 = time.perf_counter()
                    table.stage(keys, background=False, queue=True)
                    t_stage = time.perf_counter() - t0
                except BaseException:
                    if pin is not None:
                        table.unpin_working_set()
                    raise
            stats = dict(getattr(rp, "build_stats", None) or {})
            stats.setdefault("build", t_build)
            stats["stage_fetch"] = t_stage
            try:
                rp.build_stats = stats
            except AttributeError:
                pass  # a slotted pass object skips the attribution
            with self._lock:
                self._key_q.append(keys)
            return rp

        return build

    def start_next(self) -> bool:
        return self.pre.start_next()

    def wait(self):
        """The next staged pass (for a window table: build, wire and host
        fetch complete), or None at the end of the stream."""
        return self.pre.wait()

    def begin_pass(self) -> int:
        """Consume the head queued stage: the window table reconciles the
        staged working set into the window, then the trainer adopts it.
        Nothing to reconcile for a plain resident table."""
        if self.table is None:
            return 0
        with self._lock:
            if not self._key_q:
                raise RuntimeError("begin_pass with no staged pass — "
                                   "call wait() first")
            keys = self._key_q[0]
        # pop only AFTER the table accepted the pass: a raising begin
        # leaves both queues aligned (the table restores a consumed stage
        # to its queue head), so drain() still releases every pin
        n = self.table.begin_pass(keys)
        with self._lock:
            if self._key_q and self._key_q[0] is keys:
                self._key_q.popleft()
        # boundary attribution for the upcoming pass event (its
        # critical_path block): the begin-stall pieces the table just
        # measured (~0 in steady state, the point of the pipeline)
        lp = getattr(self.table, "last_pass_stats", None) or {}
        for stage, key in (("stage_wait", "stage_wait_sec"),
                           ("evict_scatter", "evict_scatter_sec"),
                           ("evict_emergency", "evict_emergency_sec"),
                           ("ssd_promote", "ssd_promote_wait_sec")):
            trace.note_pass_part(stage, float(lp.get(key, 0.0) or 0.0))
        if self.trainer is not None:
            self.trainer.adopt_table()
        return n

    def end_pass(self) -> int:
        """Close the open pass: ``trainer.sync_table()``, then the
        table's ``end_pass`` (the write-back goes to its epilogue
        worker). No write-back for a plain resident table. The submit
        cost and the fence wait it exposed go into the NEXT pass event's
        critical path (they stall the next boundary)."""
        if self.table is None:
            return 0
        if self.trainer is not None:
            self.trainer.sync_table()
        t0 = time.perf_counter()
        n = self.table.end_pass()
        trace.note_pass_part("end_submit", time.perf_counter() - t0)
        eps = getattr(self.table, "endpass_stats", None)
        if eps is not None:
            cur = float(eps().get("critical_fence_wait_sec", 0.0))
            mark, self._fence_wait_mark = self._fence_wait_mark, cur
            trace.note_pass_part("fence_wait", cur - mark)
        return n

    def drain(self, timeout: Optional[float] = None) -> None:
        """Stop building, join the worker, settle the copies in flight,
        and discard the queued stages that will never begin (releasing
        their plan-pending pins)."""
        self.pre.drain(timeout)
        if self.table is not None:
            discard = getattr(self.table, "discard_queued_stages", None)
            if discard is not None:
                discard()
        with self._lock:
            self._key_q.clear()

    # ---- accounting pass-throughs ----
    @property
    def depth(self) -> int:
        return self.pre.depth

    @property
    def builds(self) -> int:
        return self.pre.builds

    @property
    def build_sec_total(self) -> float:
        return self.pre.build_sec_total

    @property
    def wait_sec_total(self) -> float:
        return self.pre.wait_sec_total

    @property
    def build_stage_sec(self) -> Dict[str, float]:
        return self.pre.build_stage_sec

    @property
    def depth_clamped(self) -> bool:
        return self.pre.depth_clamped
