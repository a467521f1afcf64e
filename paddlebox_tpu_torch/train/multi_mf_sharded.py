"""The multi-mf sharded step and trainer — the port of
``paddlebox_tpu/train/multi_mf_sharded.py``.

The sharded analogue of ``train/multi_mf_step.py``: C dim classes, each a
``ShardedEmbeddingTable`` over the same devices. One global step runs,
single-controller as ``train/sharded.py`` does:

    per class: each owner's gather_full_rows (kernel gather_rows) →
        pull_values → expand by resp_idx → exchange
    per destination d: per class the pool over its S_c slots (kernels
        pool_cvm / segment_gather) → canonical slot-order concat → the
        model on d's device → BCE over the global weight sum → backward
    per class: exchange the grads back → merge_rows → embed grads ×
        −B·N → apply_push (kernel scatter_add_update) with the plan's
        touched rows and GLOBAL serve slots
    the dense grads summed over d in order, one optimizer step (or
        ZeRO-1's chunked one)

``FLAGS.a2a_chunks > 1`` selects the reference's overlapped push order
(every class's grad exchange first, the dense update next, the class
merges and pushes last); the ops and their math are the same, so both
orders give the same bits.

Random numbers: owner s of class c draws at global step t from
``seeded_generator(devices[s], seed + 1, (t * C + c) * N + s)``
(``class_push_generators``: ``push_generators`` of counter t * C + c),
each for its real serve rows only.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from paddlebox_tpu_torch.config import FLAGS
from paddlebox_tpu_torch.data.batch import SlotBatch
from paddlebox_tpu_torch.metrics import (AucState, auc_add_batch,
                                         auc_compute, auc_merge)
from paddlebox_tpu_torch.ops.kernels import KERNELS, KernelSet
from paddlebox_tpu_torch.ps.multi_mf_sharded import MultiMfShardedTable
from paddlebox_tpu_torch.ps.sharded import ShardedPullIndex
from paddlebox_tpu_torch.ps.table import (TableState, apply_push,
                                          merge_rows)
from paddlebox_tpu_torch.train.multi_mf_step import canonical_concat
from paddlebox_tpu_torch.train.sharded import (_DEVICE_FIELDS, GlobalBatch,
                                               ShardedTrainStep,
                                               _key_counts, _serve_counts,
                                               exchange, group_batches,
                                               init_sharded_auc,
                                               make_global_arrays,
                                               push_generators)
from paddlebox_tpu_torch.train.step import (OptimizerFactory, default_tx,
                                            pack_floats, unpack_floats)
from paddlebox_tpu_torch.train.trainer import PREFETCH_DEPTH
from paddlebox_tpu_torch.utils.prefetch import prefetch_iter
from paddlebox_tpu_torch.utils.profiler import StageTimers

log = logging.getLogger(__name__)


def class_push_generators(devices: Sequence[torch.device], seed: int,
                          step: int, num_classes: int
                          ) -> List[List[torch.Generator]]:
    """The lazy-mf generators of global step ``step``, per class then
    per owner shard (see the module docstring)."""
    return [push_generators(devices, seed, step * num_classes + c)
            for c in range(num_classes)]


class MmfGlobalBatch(NamedTuple):
    """One global batch of a multi-mf table, staged: per class a
    ``GlobalBatch`` (its plan, its sub-batches' gather_idx and
    class-local segments), all sharing each shard's one float block."""

    classes: List[GlobalBatch]
    floats: List[torch.Tensor]       # f32 [B, Dd + 3] per destination


def make_mmf_global_batch(group: List[SlotBatch],
                          subs: List[List[SlotBatch]],
                          plans: Sequence[ShardedPullIndex],
                          devices: Sequence[torch.device]
                          ) -> MmfGlobalBatch:
    """Stage a global batch: per shard ONE int32 block (every class's
    resp_idx, serve_rows, live request positions, gather_idx and
    segments) and ONE float32 block (every class's serve_valid and
    serve_slot, then the batch's floats), sliced there."""
    n = len(group)
    hosts = [make_global_arrays([subs[d][c] for d in range(n)], p)
             for c, p in enumerate(plans)]
    per_class: List[Dict[str, list]] = [
        {f: [] for f in _DEVICE_FIELDS} for _ in plans]
    floats = []
    for s in range(n):
        ints, flts, cuts = [], [], []
        for h in hosts:
            a2 = h["serve_rows"].shape[1]
            resp = h["resp_idx"][s]
            # a request that is not real points at the sentinel slot
            live = np.flatnonzero(resp.reshape(-1) != a2 - 1).astype(
                np.int32)
            parts = [resp.reshape(-1), h["serve_rows"][s], live,
                     h["gather_idx"][s], h["segments"][s]]
            ints += parts
            cuts.append([len(x) for x in parts])
            flts += [h["serve_valid"][s], h["serve_slot"][s]]
        b = group[s]
        flts.append(pack_floats(b.dense, b.label, b.show, b.clk).reshape(-1))
        ti = torch.from_numpy(np.concatenate(ints).astype(np.int32)).to(
            devices[s])
        tf = torch.from_numpy(np.concatenate(flts).astype(np.float32)).to(
            devices[s])
        oi = of = 0
        for c, (h, cut) in enumerate(zip(hosts, cuts)):
            blocks = []
            for w in cut:
                blocks.append(ti[oi:oi + w])
                oi += w
            out = per_class[c]
            out["resp_idx"].append(blocks[0].view(h["resp_idx"][s].shape))
            out["serve_rows"].append(blocks[1])
            out["live"].append(blocks[2])
            out["gather_idx"].append(blocks[3])
            out["segments"].append(blocks[4])
            a2 = h["serve_rows"].shape[1]
            out["serve_valid"].append(tf[of:of + a2])
            out["serve_slot"].append(tf[of + a2:of + 2 * a2])
            of += 2 * a2
        floats.append(tf[of:].view(b.batch_size, -1))
    classes = []
    for c, p in enumerate(plans):
        out = per_class[c]
        out["floats"] = floats
        k = hosts[c]["gather_idx"].shape[1]
        classes.append(GlobalBatch(
            key_counts=tuple(_key_counts(p.key_valid[d], (k,))
                             for d in range(n)),
            serve_counts=_serve_counts(p.serve_valid), **out))
    return MmfGlobalBatch(classes=classes, floats=floats)


@dataclasses.dataclass
class MmfShardedStepState:
    """What a step updates, in place: per class the shards' table
    states, the dense model and its optimizer, one AUC state per
    destination, and the step count."""

    tables: List[List[TableState]]
    model: nn.Module
    opt: Any
    auc: List[AucState]
    step: int = 0


class MultiMfShardedTrainStep:
    """One global multi-mf step over a ``MultiMfShardedTable`` (module
    docstring), eager."""

    def __init__(self, tx: OptimizerFactory, table: MultiMfShardedTable,
                 batch_size: int, use_cvm: bool = True,
                 cvm_offset: int = 2, zero1: bool = False,
                 a2a_overlap: bool = False,
                 ops: KernelSet = KERNELS) -> None:
        """``a2a_overlap``: the overlapped push order (same bits).
        ``zero1`` shards the dense optimizer state (``Zero1``)."""
        self.table = table
        self.devices = list(table.devices)
        self.n = len(self.devices)
        self.batch_size = batch_size
        self.cfg = table.cfg
        self.ops = ops
        self.a2a_overlap = a2a_overlap
        self.route = table.slot_route()
        # the dense side (replicas, the summed update, ZeRO-1) is the
        # single-table sharded step's; each class's pull and pool are a
        # sharded step's over the class's slots
        self.dense = ShardedTrainStep(tx, self.cfg, self.devices,
                                      batch_size, table.num_slots,
                                      use_cvm=use_cvm, cvm_offset=cvm_offset,
                                      zero1=zero1, ops=ops)
        self.class_steps = [
            ShardedTrainStep(tx, self.cfg, self.devices, batch_size,
                             len(slots), use_cvm=use_cvm,
                             cvm_offset=cvm_offset, ops=ops)
            for slots in table.class_slots]

    def init_state(self, model: nn.Module) -> MmfShardedStepState:
        st = self.dense.init_state(self.table.tables[0], model)
        return MmfShardedStepState(
            tables=[list(t.states) for t in self.table.tables],
            model=st.model, opt=st.opt, auc=st.auc)

    def __call__(self, state: MmfShardedStepState, gb: MmfGlobalBatch,
                 generators: Sequence[Sequence[torch.Generator]]
                 ) -> Dict[str, Any]:
        """One global step. ``generators[c][s]``
        (``class_push_generators``) draw owner s's lazy-mf values for
        class c. Returns the summed loss, each destination's predictions
        and each (class, owner)'s pushed grads (device tensors)."""
        n, b = self.n, self.batch_size
        nc = len(self.class_steps)
        home = self.devices[0]
        pulls = [cs._pull(state.tables[c], gb.classes[c],
                          (gb.classes[c].resp_idx[0].shape[1],))
                 for c, cs in enumerate(self.class_steps)]
        ins_w = [(f[:, -2] > 0).float() for f in gb.floats]
        wsum = ins_w[0].sum().to(home)
        for w in ins_w[1:]:
            wsum = wsum + w.sum().to(home)

        losses, preds, dense_grads = [], [], []
        g_vals: List[List[torch.Tensor]] = [[] for _ in range(nc)]
        for d in range(n):
            dev = self.devices[d]
            model = self.dense._model_on(state.model, dev)
            leaves = [pulls[c][1][0][d].detach().requires_grad_(True)
                      for c in range(nc)]
            parts = [cs._pool([leaves[c]], gb.classes[c], d,
                              gb.classes[c].resp_idx[0].shape[1], ())
                     for c, cs in enumerate(self.class_steps)]
            dense, label, _, _ = unpack_floats(gb.floats[d])
            logits = model(canonical_concat(parts, self.route), dense)
            ls = F.binary_cross_entropy_with_logits(logits, label,
                                                    reduction="none")
            loss = (ls * ins_w[d]).sum() / wsum.to(dev).clamp_min(1.0)
            params = list(model.parameters())
            grads = torch.autograd.grad(loss, leaves + params,
                                        allow_unused=True)
            for c, (x, g) in enumerate(zip(leaves, grads[:nc])):
                a = gb.classes[c].resp_idx[0].shape[1]
                g = torch.zeros_like(x) if g is None else g
                g_vals[c].append(g.view(n, a, x.shape[1]))
            dense_grads.append(list(grads[nc:]))
            losses.append(loss.detach())
            pred = torch.sigmoid(logits.detach())
            auc_add_batch(state.auc[d], pred, label, ins_w[d])
            preds.append(pred)

        def push_class(c: int, backs: List[torch.Tensor]) -> List:
            cgb = gb.classes[c]
            a = cgb.resp_idx[0].shape[1]
            a2 = cgb.serve_rows[0].shape[0]
            pushed = []
            for s, g_back in enumerate(backs):
                live = cgb.live[s].long()
                dd = g_back.shape[-1]
                g_serve = merge_rows(g_back.reshape(n * a, dd)[live],
                                     cgb.resp_idx[s].reshape(-1)[live], a2)
                # PushCopy scaling (box_wrapper.cu:368): the loss is the
                # global mean
                g_serve[:, 2:] *= -1.0 * b * n
                apply_push(state.tables[c][s], cgb.serve_rows[s], g_serve,
                           self.cfg, generator=generators[c][s],
                           rows_full=pulls[c][0][s], ops=self.ops,
                           touched=cgb.serve_valid[s] > 0,
                           slot_val=cgb.serve_slot[s],
                           draw_rows=cgb.serve_counts[s])
                pushed.append(g_serve)
            return pushed

        if self.a2a_overlap:
            # every class's grad exchange, then the dense update, then
            # the merges and pushes: the same ops in another order
            backs = [exchange(g_vals[c], self.devices) for c in range(nc)]
            loss = self.dense._dense_sync(state, dense_grads, losses)
            pushed = [push_class(c, backs[c]) for c in range(nc)]
        else:
            pushed = [push_class(c, exchange(g_vals[c], self.devices))
                      for c in range(nc)]
            loss = self.dense._dense_sync(state, dense_grads, losses)
        state.step += 1
        return {"loss": loss, "pred": preds, "pushed": pushed}


class MultiMfShardedTrainer:
    """Streaming multi-shard trainer over a ``MultiMfShardedTable`` (the
    PSGPUTrainer role for mixed-dim tables): groups the batch stream into
    global batches of N, splits, plans and stages them on two producer
    threads, and runs the step."""

    def __init__(self, model: nn.Module, table: MultiMfShardedTable, desc,
                 tx: Optional[OptimizerFactory] = None,
                 use_cvm: bool = True, prefetch: int = PREFETCH_DEPTH,
                 seed: int = 0, zero1: bool = False,
                 ops: KernelSet = KERNELS) -> None:
        """``model`` (params set, input width ``table.pooled_width()`` +
        the dense dim) moves to the table's first device.
        ``FLAGS.a2a_chunks > 1`` selects the overlapped push order."""
        self.table = table
        self.desc = desc
        self.n = table.n
        self.devices = table.devices
        self.step_fn = MultiMfShardedTrainStep(
            tx or default_tx, table, desc.batch_size, use_cvm=use_cvm,
            zero1=zero1, a2a_overlap=max(1, int(FLAGS.a2a_chunks)) > 1,
            ops=ops)
        self.state = self.step_fn.init_state(model)
        self.model = self.state.model
        self.seed = seed
        self.global_step = 0
        self.prefetch = prefetch
        self.stage_timers = StageTimers()

    def generators(self, step: int) -> List[List[torch.Generator]]:
        return class_push_generators(self.devices, self.seed, step,
                                     self.table.num_classes)

    def _prefetch_iter(self, batches):
        """(group, staged batch) with the split + plans and the staging
        on two chained producer threads."""
        st = self.stage_timers

        def do_prep(group):
            with st.stage("prepare"):
                # one split serves both the plans and the segments
                subs = [self.table.split_batch(b)[0] for b in group]
                return group, subs, self.table.prepare_global_from_subs(
                    subs)

        def do_stage(t):
            with st.stage("stage"):
                return t[0], make_mmf_global_batch(*t, self.devices)

        planned = prefetch_iter(group_batches(batches, self.n), do_prep,
                                capacity=self.prefetch)
        return prefetch_iter(planned, do_stage, capacity=self.prefetch)

    def train_pass(self, dataset, log_prefix: str = "") -> Dict[str, float]:
        """One pass in global batches of N. Returns the accumulated AUC
        result, the pass's global batches and examples, its wall seconds
        and examples/s, and the last loss."""
        self.stage_timers.reset()
        t0 = time.perf_counter()
        nb = n_ex = 0
        stats = None
        for group, gb in self._prefetch_iter(dataset.batches()):
            self.global_step += 1
            with self.stage_timers.stage("step"):
                stats = self.step_fn(self.state, gb,
                                     self.generators(self.global_step))
            nb += 1
            n_ex += sum(int((bt.show > 0).sum()) for bt in group)
        elapsed = time.perf_counter() - t0
        self.sync_table()
        out = auc_compute(auc_merge(self.state.auc)).as_dict()
        out.update(batches=nb, examples=n_ex, elapsed_sec=elapsed,
                   examples_per_sec=n_ex / max(elapsed, 1e-9),
                   last_loss=(float(stats["loss"]) if stats is not None
                              else float("nan")))
        log.info("%smulti-mf sharded pass: %d global batches, %.0f ex/s, "
                 "auc=%.4f", log_prefix, nb, out["examples_per_sec"],
                 out["auc"])
        return out

    def reset_metrics(self) -> None:
        self.state.auc = init_sharded_auc(self.devices)

    def sync_table(self) -> None:
        """Point the class tables at the trained states (the step writes
        them in place, so this matters only after one side was
        replaced)."""
        for t, sts in zip(self.table.tables, self.state.tables):
            t.states = list(sts)

    def adopt_table(self) -> None:
        """Point the step state at every class table's states (after a
        tiered begin_pass; its windows are updated in place, so this
        matters only where a state was replaced)."""
        self.state.tables = [list(t.states) for t in self.table.tables]
