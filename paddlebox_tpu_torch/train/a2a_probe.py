"""Measured exchange/compute attribution of the sharded step — counterpart
of ``paddlebox_tpu/train/a2a_probe.py``.

The chunked schedule (``ShardedTrainStep`` with a grouped plan's
``plan_sections``, ``FLAGS.a2a_chunks`` > 1) splits the embedding
exchange into one exchange a slot group and pools each group alone, so
the exchanges and the pooling are independent; whether the device
overlaps them is measured here, not assumed. The probe runs the step's
own pieces one at a time (the methods ``ShardedTrainStep.__call__``
runs, on the same staged batch) and the two whole schedules, and
reports:

- per chunk, the pull exchange's seconds (``a2a_pull_sec``) beside its
  pool's (``pool_sec``): the chunk-width signal;
- ``exchange_overlap_frac``: the share of the whole exchange time that
  the chunked schedule hid, from an A/B of the monolithic and the
  chunked step over the SAME staged batch (a grouped plan is a valid
  input to both);
- ``exchange_wait_sec``: the exchange time not hidden, reported into
  the pass critical path (``obs/trace.note_pass_part("exchange_wait")``)
  so the next pass event's ``critical_path`` block carries it.

Every timing is wall time on the host clock: one warm call, then the
best of ``reps``, each bracketed by a synchronize of every local shard's
device. The last timed call of each exchange and pool piece runs inside
a span (``a2a.pull.<g>``, ``pool.<g>``, ``a2a.push``) on the
``device.a2a`` lane, which records only while a span sink is attached;
every pull chunk and the push book ``pbox_a2a_chunk_seconds_total
{chunk}``. On a pod (``trainer.pod``) every rank calls the probe in
lockstep and times its own shards; the exchanges are the step's
``torch.distributed`` all-to-alls.

NOTE: the probe's A/B steps are REAL training steps: they update the
table, the dense params and the optimizer state in place (the
decomposed pieces change nothing). Run it after every number it would
disturb is taken. The steps draw the lazy-mf values of step counter 0
(``push_generators(devices, seed, 0)``), which no pass uses, and leave
``trainer.global_step`` as it was.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict, List, Optional

import torch

from paddlebox_tpu_torch.obs import trace
from paddlebox_tpu_torch.obs.hub import get_hub
from paddlebox_tpu_torch.ps.sharded import plan_sections, section_offsets
from paddlebox_tpu_torch.train.sharded import push_generators


def _sync(devices) -> None:
    """Wait for every card among ``devices`` (the CPU runs eagerly)."""
    for dev in {torch.device(d) for d in devices}:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


def _timed(fn: Callable, sync: Callable, reps: int = 2,
           span: Optional[str] = None, **attrs):
    """(result, best-of-reps seconds) after one warm call; with ``span``
    the last timed call runs inside that span on the device lane."""
    out = fn()
    sync()
    best = float("inf")
    n = max(1, reps)
    for i in range(n):
        with (trace.span(span, lane=trace.LANE_DEVICE, **attrs)
              if span is not None and i == n - 1
              else contextlib.nullcontext()):
            t0 = time.perf_counter()
            out = fn()
            sync()
            best = min(best, time.perf_counter() - t0)
    return out, best


def probe_exchange(trainer, dataset=None, group: Optional[list] = None,
                   chunks: Optional[int] = None, reps: int = 2) -> Dict:
    """Measure the exchange/compute schedule of ``trainer``'s (a
    ``ShardedTrainer``) sharded step on one global batch: the first group
    of ``dataset`` unless ``group`` (a list of N ``SlotBatch``) is given.
    ``chunks`` overrides ``trainer.a2a_chunks``, so one trainer can sweep
    widths. Returns the reference's keys (module docstring) and keeps
    them as ``trainer._last_exchange_probe``, which the next
    ``train_pass_resident`` event reports."""
    sf = trainer.step_fn
    n, local = trainer.n, sf.local
    if group is None:
        if dataset is None:
            raise ValueError("probe_exchange needs a dataset or a group")
        group = next(iter(trainer._group_iter(dataset.batches())))
    c = trainer.a2a_chunks if chunks is None else max(1, int(chunks))
    idx = trainer.table.prepare_global(group, groups=c)
    gb = trainer._stage_batch(group, idx)
    sections = plan_sections(idx)
    a = gb.resp_idx[local[0]].shape[1]
    a2 = gb.serve_rows[local[0]].shape[0]
    a_secs = sections[0] if sections else (a,)
    state = trainer.state
    devs = [sf.devices[s] for s in local]

    def sync():
        _sync(devs)

    # ---- serve gather (each owner's own rows, no exchange) ----
    (_, serve_vals), t_serve = _timed(
        lambda: sf._serve(state.tables, gb), sync, reps)

    # ---- per-chunk pull exchange ----
    a2a_ctr = get_hub().counter("pbox_a2a_chunk_seconds_total",
                                "measured seconds per sharded exchange "
                                "chunk")
    recvs: List[list] = []
    t_a2a: List[float] = []
    for g, (lo, ag) in enumerate(zip(section_offsets(a_secs), a_secs)):
        recv_g, t = _timed(
            lambda lo=lo, ag=ag: sf._pull_section(serve_vals, gb, lo, ag),
            sync, reps, span=f"a2a.pull.{g}", chunk=g, section=int(ag))
        recvs.append(recv_g)
        t_a2a.append(t)
        a2a_ctr.inc(t, chunk=str(g))

    # ---- per-chunk pool, each destination's keys of the chunk ----
    pooled_parts: List[list] = []
    t_pool: List[float] = []
    for g in range(len(a_secs)):
        keys = sum(gb.key_counts[d][g] for d in local)
        part, t = _timed(
            lambda g=g: [sf._pool_section(recvs[g][d], gb, d, a, sections, g)
                         if d in local else None for d in range(n)],
            sync, reps, span=f"pool.{g}", chunk=g, keys=int(keys))
        pooled_parts.append(part)
        t_pool.append(t)
    pooled = [None if d not in local else
              (pooled_parts[0][d] if len(pooled_parts) == 1 else
               torch.cat([p[d] for p in pooled_parts], dim=1))
              for d in range(n)]

    # ---- dense forward and backward on the pooled input ----
    wsum = torch.tensor(gb.weight_sum, dtype=torch.float32, device=sf.home)

    def dense():
        grads: List[Optional[list]] = [None] * n
        losses: List[Optional[torch.Tensor]] = [None] * n
        for d in local:
            model = sf._model_on(state.model, sf.devices[d])
            leaf = pooled[d].detach().requires_grad_(True)
            _, loss, _, _ = sf._loss(model, leaf, gb, d, wsum)
            params = list(model.parameters())
            out = torch.autograd.grad(loss, [leaf] + params,
                                      allow_unused=True)
            grads[d] = list(out[1:])
            losses[d] = loss.detach()
        return grads, losses

    (dense_grads, losses), t_dense = _timed(dense, sync, reps)

    # ---- push exchange + owner-side merge (pseudo-grads: the received
    # values themselves, the same shapes, layout and transfer) ----
    dd = serve_vals[local[0]].shape[1]
    g_vals = [None if d not in local else
              torch.cat([recvs[g][d].view(n, ag, dd)
                         for g, ag in enumerate(a_secs)], dim=1)
              for d in range(n)]
    _, t_push = _timed(lambda: sf._push_merge(g_vals, gb, a, a2), sync,
                       reps, span="a2a.push")
    a2a_ctr.inc(t_push, chunk="push")

    # ---- dense sync (the sum the push overlaps with) ----
    _, t_sync = _timed(lambda: sf._dense_reduce(state, dense_grads, losses),
                       sync, reps)

    # ---- the A/B: both whole schedules over the SAME staged batch ----
    def run_step(secs) -> float:
        def once() -> float:
            gens = push_generators(trainer.devices, trainer.seed, 0)
            sync()
            t0 = time.perf_counter()
            trainer.step_fn(trainer.state, gb, gens, secs)
            sync()
            return time.perf_counter() - t0

        once()                      # warm
        return min(once() for _ in range(max(1, reps)))

    t_mono = run_step(())
    t_chunk = run_step(sections) if sections else t_mono

    exchange_total = sum(t_a2a) + t_push
    overlap_sec = max(0.0, t_mono - t_chunk)
    frac = (min(1.0, overlap_sec / exchange_total)
            if exchange_total > 0 else 0.0)
    wait = max(0.0, exchange_total - overlap_sec)
    # rides the NEXT pass event's critical_path as its own part
    trace.note_pass_part("exchange_wait", wait)
    result = {
        "a2a_chunks": len(a_secs),
        "a2a_sections": [int(x) for x in a_secs],
        "serve_sec": round(t_serve, 6),
        "a2a_pull_sec": [round(t, 6) for t in t_a2a],
        "pool_sec": [round(t, 6) for t in t_pool],
        "dense_sec": round(t_dense, 6),
        "push_sec": round(t_push, 6),
        "dense_sync_sec": round(t_sync, 6),
        "step_monolithic_sec": round(t_mono, 6),
        "step_chunked_sec": round(t_chunk, 6),
        "exchange_sec_total": round(exchange_total, 6),
        "exchange_overlap_sec": round(min(overlap_sec, exchange_total), 6),
        "exchange_overlap_frac": round(frac, 4),
        "exchange_wait_sec": round(wait, 6),
    }
    # later pass events report the measured fraction
    # (ShardedTrainer.train_pass_resident → emit_pass_event →
    # telemetry_report's "a2a ovl" column)
    trainer._last_exchange_probe = result
    return result
