"""Multi-shard training — counterpart of ``paddlebox_tpu/train/sharded.py``
(the streaming path).

Reference execution model (SURVEY.md §2.6): one worker thread per GPU
(BoxPSTrainer), an allreduce of the dense grads (SyncParam,
boxps_worker.cc:1191-1258), HeterComm P2P copies for the sparse pull and
push. The JAX package runs all of it as one program over a device mesh.
The port drives the N shards of a ``ShardedEmbeddingTable`` from one
process, each shard on a device of the table's ``devices`` list, and
makes both exchanges explicit copies between those devices (on one
device the copies are the ``stack`` of each destination's blocks). One
global step:

    for each owner s: gather_full_rows → pull_values → expand by resp_idx
    exchange: recv[d] = stack_s resp[s][d]
    for each destination d: expand by gather_idx → fused_seqpool_cvm
        (or one slot group at a time in the chunked schedule) → model →
        BCE over the global weight sum → backward
    exchange back, merge_rows by resp_idx, embed grads × −B·N, apply_push
    dense grads summed over d in order (the psum), one optimizer step

Random numbers: the lazy-mf draws of owner shard s at global step t
come from ``seeded_generator(devices[s], seed + 1, t * N + s)``
(``push_generators``): the port's ``Trainer`` stream (seed + 1, t)
spread over the shards (N = 1 gives ``Trainer``'s stream; the draws
then go to the served rows in row order, ``Trainer``'s to its unique
rows in first-seen order). The reference folds the shard index into the
step's key
(``fold_in(fold_in(rng, t), s)``); the two agree only through
``mf_initial_range == 0`` or explicit draws.

Not here yet: the sharded resident pass (``ShardedResidentPass``,
``run_resident``, ``build_resident_pass``, ``train_pass_resident``;
ROADMAP queue 1, the item after this one), the tiered pipeline and the
table hooks it needs (``tiered_pass_pipeline``, ``train_passes_tiered``,
``fence_table``, ``adopt_table``: item 10) and the multi-process form
(``globalize_dense_state``, the pod branches: item 13).
"""

from __future__ import annotations

import copy
import dataclasses
import logging
import time
from typing import (Any, Callable, Dict, Iterable, Iterator, List,
                    NamedTuple, Optional, Sequence, Tuple)

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from paddlebox_tpu_torch.config import FLAGS
from paddlebox_tpu_torch.data.batch import SlotBatch
from paddlebox_tpu_torch.device import seeded_generator
from paddlebox_tpu_torch.metrics import (AUC_NUM_BUCKETS, AucState,
                                         MetricRegistry, auc_add_batch,
                                         auc_compute, auc_merge,
                                         init_auc_state)
from paddlebox_tpu_torch.ops.kernels import KERNELS, KernelSet
from paddlebox_tpu_torch.ops.seqpool_cvm import (fused_seqpool_cvm,
                                                 fused_seqpool_cvm_slot_group)
from paddlebox_tpu_torch.ps.sgd import SparseSGDConfig
from paddlebox_tpu_torch.ps.sharded import (ShardedEmbeddingTable,
                                            ShardedPullIndex,
                                            chunk_local_positions,
                                            plan_sections, section_offsets)
from paddlebox_tpu_torch.ps.table import (TableState, apply_push,
                                          expand_pull, gather_full_rows,
                                          merge_rows, pull_values)
from paddlebox_tpu_torch.train.step import (OptimizerFactory, default_tx,
                                            pack_floats, unpack_floats)
from paddlebox_tpu_torch.train.trainer import (PREFETCH_DEPTH, StageTimers,
                                               _to_cpu)
from paddlebox_tpu_torch.utils.dump import DumpConfig, DumpWriter
from paddlebox_tpu_torch.utils.prefetch import prefetch_iter

log = logging.getLogger(__name__)


class GlobalBatch(NamedTuple):
    """One global batch staged for the step. Entry s of every list lies
    on shard s's device: owner s's serve side and destination s's batch.
    Each shard's ints and floats arrive in one copy each."""

    resp_idx: List[torch.Tensor]     # int32 [N, A] per owner
    serve_rows: List[torch.Tensor]   # int32 [A2]
    serve_valid: List[torch.Tensor]  # f32   [A2]
    serve_slot: List[torch.Tensor]   # f32   [A2]
    live: List[torch.Tensor]         # int32 [L] positions of real requests
    gather_idx: List[torch.Tensor]   # int32 [K] per destination
    segments: List[torch.Tensor]     # int32 [K]
    floats: List[torch.Tensor]       # f32 [B, Dd + 3] = dense|label|show|clk
    key_counts: Tuple[Tuple[int, ...], ...]  # real keys per key section


def make_global_arrays(batches: List[SlotBatch],
                       idx: ShardedPullIndex) -> Dict[str, np.ndarray]:
    """The N local batches and their routing plan as stacked host arrays
    (the reference's layout, leading dim = shard)."""
    dense = np.stack([b.dense for b in batches])
    label = np.stack([b.label for b in batches])
    show = np.stack([b.show for b in batches])
    clk = np.stack([b.clk for b in batches])
    plan = dict(resp_idx=idx.resp_idx, serve_rows=idx.serve_rows,
                serve_valid=idx.serve_valid, serve_slot=idx.serve_slot)
    if idx.key_segments is not None:
        # grouped plan: the key stream was re-laid group-contiguous, so
        # its segments come from the plan, not the batches
        return dict(plan, gather_idx=idx.gather_idx,
                    segments=idx.key_segments, dense=dense, label=label,
                    show=show, clk=clk)
    k_pad = max(b.keys.shape[0] for b in batches)
    segs = np.full((len(batches), k_pad), batches[0].pad_segment, np.int32)
    for d, b in enumerate(batches):
        segs[d, :b.segments.shape[0]] = b.segments
    gi = idx.gather_idx
    if gi.shape[1] < k_pad:
        gi = np.pad(gi, ((0, 0), (0, k_pad - gi.shape[1])),
                    constant_values=gi.max())
    return dict(plan, gather_idx=gi, segments=segs, dense=dense,
                label=label, show=show, clk=clk)


def make_global_batch(batches: List[SlotBatch], idx: ShardedPullIndex,
                      devices: Sequence[torch.device]) -> GlobalBatch:
    """``make_global_arrays`` staged on the shards' devices: per shard one
    int32 block (resp_idx, serve_rows, the live request positions,
    gather_idx, segments) and one float32 block (serve_valid,
    serve_slot, the batch's floats), sliced there."""
    host = make_global_arrays(batches, idx)
    n = len(batches)
    a2 = host["serve_rows"].shape[1]
    k = host["gather_idx"].shape[1]
    secs = idx.key_sections or (k,)
    offs = section_offsets(secs)
    out: Dict[str, List[torch.Tensor]] = {f: [] for f in GlobalBatch._fields
                                          if f != "key_counts"}
    counts = []
    for s in range(n):
        resp = host["resp_idx"][s]
        # a request that is not real points at the sentinel slot A2 - 1
        live = np.flatnonzero(resp.reshape(-1) != a2 - 1).astype(np.int32)
        ints = np.concatenate([resp.reshape(-1), host["serve_rows"][s],
                               live, host["gather_idx"][s],
                               host["segments"][s]]).astype(np.int32)
        flts = np.concatenate([
            host["serve_valid"][s], host["serve_slot"][s],
            pack_floats(host["dense"][s], host["label"][s], host["show"][s],
                        host["clk"][s]).reshape(-1)])
        ti = torch.from_numpy(ints).to(devices[s])
        tf = torch.from_numpy(flts).to(devices[s])
        na = resp.size
        o = [0, na, na + a2, na + a2 + len(live), na + a2 + len(live) + k]
        out["resp_idx"].append(ti[:na].view(resp.shape))
        out["serve_rows"].append(ti[o[1]:o[2]])
        out["live"].append(ti[o[2]:o[3]])
        out["gather_idx"].append(ti[o[3]:o[4]])
        out["segments"].append(ti[o[4]:])
        out["serve_valid"].append(tf[:a2])
        out["serve_slot"].append(tf[a2:2 * a2])
        out["floats"].append(tf[2 * a2:].view(len(host["label"][s]), -1))
        kv = idx.key_valid[s]
        counts.append(tuple(int(kv[lo:lo + w].sum())
                            for lo, w in zip(offs, secs)))
    return GlobalBatch(key_counts=tuple(counts), **out)


def exchange(blocks: Sequence[torch.Tensor],
             devices: Sequence[torch.device]) -> List[torch.Tensor]:
    """The all-to-all: ``blocks[s]`` [N, ...] holds what shard s sends
    each shard; returns ``out[d]`` = stack over s of ``blocks[s][d]``, on
    ``devices[d]``."""
    n = len(blocks)
    return [torch.stack([blocks[s][d].to(devices[d]) for s in range(n)])
            for d in range(n)]


def push_generators(devices: Sequence[torch.device], seed: int,
                    step: int) -> List[torch.Generator]:
    """The lazy-mf generators of global step ``step``, one per owner
    shard (see the module docstring)."""
    n = len(devices)
    return [seeded_generator(dev, seed + 1, step * n + s)
            for s, dev in enumerate(devices)]


def init_sharded_auc(devices: Sequence[torch.device],
                     nbins: int = AUC_NUM_BUCKETS) -> List[AucState]:
    """One zeroed AUC state per destination shard, on its device."""
    return [init_auc_state(nbins, device=dev) for dev in devices]


def _assert_elementwise_tx(tx: OptimizerFactory) -> None:
    """ZeRO-1 steps ``tx`` on each shard's flat param chunk, which is
    right only for an elementwise optimizer (element i's update reads
    element i alone: Adam, Adagrad, SGD). Probe: stepping half a vector
    must equal the first half of stepping the whole vector."""
    g = torch.linspace(0.5, 4.0, 8)
    full = nn.Parameter(torch.ones(8))
    half = nn.Parameter(torch.ones(4))
    for p, gp in ((full, g), (half, g[:4].clone())):
        opt = tx([p])
        p.grad = gp
        opt.step()
    if not torch.allclose(full.detach()[:4], half.detach(), rtol=1e-6,
                          atol=1e-12):
        raise ValueError(
            "zero1=True needs an ELEMENTWISE optimizer: it steps each "
            "shard's flat param chunk on its own, and this one computes "
            "statistics across elements (a global grad norm, a trust "
            "ratio), which would become per-chunk statistics")


class Zero1:
    """ZeRO-1 dense update (BoxPSWorker's sharding stage,
    boxps_worker.cc:601): the flat params split into N chunks, chunk s
    and its optimizer state on ``devices[s]``. A step cuts the summed
    grad into the same chunks (the reduce-scatter), steps each chunk's
    optimizer, and writes the chunks back into the params (the
    all-gather). Each chunk is read from the params before its step, so
    params set from outside (a restore) are what the next step updates."""

    def __init__(self, params: List[nn.Parameter], tx: OptimizerFactory,
                 devices: Sequence[torch.device]) -> None:
        self.params = params
        self.devices = list(devices)
        n = len(self.devices)
        self.psize = sum(p.numel() for p in params)
        self.chunk = -(-self.psize // n)
        self.chunks = [nn.Parameter(torch.zeros(self.chunk, device=dev))
                       for dev in self.devices]
        self.opts = [tx([c]) for c in self.chunks]

    def _flat(self, tensors: List[torch.Tensor]) -> torch.Tensor:
        flat = torch.cat([t.reshape(-1) for t in tensors])
        return F.pad(flat, (0, len(self.devices) * self.chunk - self.psize))

    def step(self, grads: List[torch.Tensor]) -> None:
        g = self._flat(grads)
        p = self._flat([q.detach() for q in self.params])
        c = self.chunk
        with torch.no_grad():
            for s, (chunk, opt) in enumerate(zip(self.chunks, self.opts)):
                chunk.copy_(p[s * c:(s + 1) * c])
                chunk.grad = g[s * c:(s + 1) * c].to(self.devices[s])
                opt.step()
                chunk.grad = None
            home = self.params[0].device
            flat = torch.cat([ch.detach().to(home) for ch in self.chunks])
            off = 0
            for q in self.params:
                q.copy_(flat[off:off + q.numel()].view_as(q))
                off += q.numel()

    def state_dict(self) -> List[Dict[str, Any]]:
        return [opt.state_dict() for opt in self.opts]

    def load_state_dict(self, sd: List[Dict[str, Any]]) -> None:
        for opt, part in zip(self.opts, sd):
            opt.load_state_dict(part)


@dataclasses.dataclass
class ShardedStepState:
    """What a step updates, all in place: the shards' table states, the
    dense model and its optimizer (a ``Zero1`` under ZeRO-1), one AUC
    state per destination shard, and the step count."""

    tables: List[TableState]
    model: nn.Module
    opt: Any
    auc: List[AucState]
    step: int = 0


class ShardedTrainStep:
    """One global step of the sharded path (module docstring), eager.

    The reference's ``init_params`` has no counterpart: a torch model
    carries its params from construction (a caller sets them, e.g.
    through ``convert.deepfm_state_dict_from_flax``), as for
    ``TrainStep``."""

    def __init__(self, tx: OptimizerFactory, sgd_cfg: SparseSGDConfig,
                 devices: Sequence[torch.device], batch_size: int,
                 num_slots: int, use_cvm: bool = True, cvm_offset: int = 2,
                 zero1: bool = False, ops: KernelSet = KERNELS) -> None:
        """``ops`` selects the device functions: the kernels, unless a
        check on the card passes ``kernels.PLAIN``. ``zero1`` shards the
        dense optimizer state over the devices (``Zero1``)."""
        if zero1:
            _assert_elementwise_tx(tx)
        self.tx = tx
        self.sgd_cfg = sgd_cfg
        self.devices = list(devices)
        self.n = len(self.devices)
        self.batch_size = batch_size
        self.num_slots = num_slots
        self.use_cvm = use_cvm
        self.cvm_offset = cvm_offset
        self.zero1 = zero1
        self.ops = ops
        # model replicas on the destinations' other devices, refreshed
        # after every dense update
        self._replicas: Dict[torch.device, nn.Module] = {}

    def init_state(self, table: ShardedEmbeddingTable,
                   model: nn.Module) -> ShardedStepState:
        model = model.to(self.devices[0])
        params = list(model.parameters())
        opt = (Zero1(params, self.tx, self.devices) if self.zero1
               else self.tx(params))
        self._replicas = {}
        return ShardedStepState(tables=list(table.states), model=model,
                                opt=opt, auc=init_sharded_auc(self.devices))

    def _model_on(self, model: nn.Module, dev: torch.device) -> nn.Module:
        if dev == self.devices[0]:
            return model
        rep = self._replicas.get(dev)
        if rep is None:
            rep = self._replicas[dev] = copy.deepcopy(model).to(dev)
        return rep

    def _refresh_replicas(self, model: nn.Module) -> None:
        with torch.no_grad():
            for rep in self._replicas.values():
                for q, p in zip(rep.parameters(), model.parameters()):
                    q.copy_(p)

    # ---- dense grad sync + optimizer (both schedules) ----
    def _dense_sync(self, state: ShardedStepState,
                    grads: List[List[torch.Tensor]]) -> None:
        """Sum every destination's dense grads in shard order on the
        model's device (the psum, SyncParam's allreduce), then one
        optimizer step (or ZeRO-1's chunked one)."""
        home = self.devices[0]
        total = [g.to(home) for g in grads[0]]
        for gd in grads[1:]:
            total = [a + b.to(home) for a, b in zip(total, gd)]
        if self.zero1:
            state.opt.step(total)
        else:
            params = list(state.model.parameters())
            for p, g in zip(params, total):
                p.grad = g
            state.opt.step()
            for p in params:
                p.grad = None
        self._refresh_replicas(state.model)

    def _pull(self, tables: List[TableState], gb: GlobalBatch,
              a_secs: Sequence[int]):
        """Owner-side gathers and the pull exchange(s): (rows_full per
        owner, per section the received [N*A_g, D] block per
        destination)."""
        n = self.n
        rows_full, serve_vals = [], []
        for s in range(n):
            rf = gather_full_rows(tables[s], gb.serve_rows[s], self.ops)
            rows_full.append(rf)
            serve_vals.append(pull_values(rf, tables[s].mf_dim))
        d = serve_vals[0].shape[1]
        recvs, lo = [], 0
        for ag in a_secs:
            resp = [expand_pull(serve_vals[s],
                                gb.resp_idx[s][:, lo:lo + ag].reshape(-1))
                    .view(n, ag, d) for s in range(n)]
            recvs.append([r.reshape(n * ag, d)
                          for r in exchange(resp, self.devices)])
            lo += ag
        return rows_full, recvs

    def _pool(self, recvs_d: List[torch.Tensor], gb: GlobalBatch, d: int,
              a: int, sections: tuple) -> torch.Tensor:
        """Destination ``d``'s pooled [B, S, D'] block from its received
        values, over its real keys only (the padded keys pool into the
        discard bin in the reference and take no grad)."""
        b, s, counts = self.batch_size, self.num_slots, gb.key_counts[d]
        show_clk = gb.floats[d][:, -2:]
        if not sections:
            nk = counts[0]
            return fused_seqpool_cvm(
                expand_pull(recvs_d[0], gb.gather_idx[d][:nk]),
                gb.segments[d][:nk], show_clk, b, s, self.use_cvm,
                self.cvm_offset, ops=self.ops)
        a_secs, k_secs, s_secs = sections
        a_off, k_off = section_offsets(a_secs), section_offsets(k_secs)
        s_off = section_offsets(s_secs)
        parts = []
        for g, (ag, sg) in enumerate(zip(a_secs, s_secs)):
            lo, nk = k_off[g], counts[g]
            # global position owner*A + j → the chunk's own positions
            local = chunk_local_positions(
                gb.gather_idx[d][lo:lo + nk].long(), a, a_off[g], ag)
            parts.append(fused_seqpool_cvm_slot_group(
                expand_pull(recvs_d[g], local), gb.segments[d][lo:lo + nk],
                show_clk, b, s, s_off[g], s_off[g] + sg, self.use_cvm,
                self.cvm_offset, ops=self.ops))
        return torch.cat(parts, dim=1)

    def __call__(self, state: ShardedStepState, gb: GlobalBatch,
                 generators: Sequence[torch.Generator],
                 sections: tuple = ()) -> Dict[str, Any]:
        """One global step. ``generators`` (``push_generators``) draw
        each owner's lazy-mf values. ``sections`` = () runs the
        monolithic schedule; a grouped plan's ``plan_sections`` runs the
        chunked one (one exchange per slot group, each group pooled
        alone), which gives the same bits. Returns the summed loss, each
        destination's predictions and each owner's pushed grads
        (device tensors)."""
        n, b = self.n, self.batch_size
        a = gb.resp_idx[0].shape[1]
        a2 = gb.serve_rows[0].shape[0]
        a_secs = sections[0] if sections else (a,)
        rows_full, recvs = self._pull(state.tables, gb, a_secs)
        home = self.devices[0]
        ins_w = [(f[:, -2] > 0).float() for f in gb.floats]
        wsum = ins_w[0].sum().to(home)
        for w in ins_w[1:]:
            wsum = wsum + w.sum().to(home)

        losses, preds, dense_grads, g_vals = [], [], [], []
        for d in range(n):
            dev = self.devices[d]
            model = self._model_on(state.model, dev)
            leaves = [recvs[g][d].detach().requires_grad_(True)
                      for g in range(len(a_secs))]
            dense, label, _, _ = unpack_floats(gb.floats[d])
            logits = model(self._pool(leaves, gb, d, a, sections), dense)
            ls = F.binary_cross_entropy_with_logits(logits, label,
                                                    reduction="none")
            loss = (ls * ins_w[d]).sum() / wsum.to(dev).clamp_min(1.0)
            params = list(model.parameters())
            grads = torch.autograd.grad(loss, leaves + params,
                                        allow_unused=True)
            # a section none of d's keys reads gets no grad: zeros
            g_leaf = [torch.zeros_like(x) if g is None else g
                      for x, g in zip(leaves, grads[:len(leaves)])]
            g_params = grads[len(leaves):]
            dd = g_leaf[0].shape[1]
            g_vals.append(torch.cat([g.view(n, ag, dd) for g, ag in
                                     zip(g_leaf, a_secs)], dim=1))
            dense_grads.append(list(g_params))
            losses.append(loss.detach())
            pred = torch.sigmoid(logits.detach())
            auc_add_batch(state.auc[d], pred, label, ins_w[d])
            preds.append(pred)

        # ---- push: grads back to their owners, merge, update ----
        pushed = []
        for s, g_back in enumerate(exchange(g_vals, self.devices)):
            live = gb.live[s].long()
            dd = g_back.shape[-1]
            g_serve = merge_rows(g_back.reshape(n * a, dd)[live],
                                 gb.resp_idx[s].reshape(-1)[live], a2)
            # PushCopy scaling (box_wrapper.cu:368): negate the embed
            # grads and scale by the global batch (the loss is the
            # global mean)
            g_serve[:, 2:] *= -1.0 * b * n
            apply_push(state.tables[s], gb.serve_rows[s], g_serve,
                       self.sgd_cfg, generator=generators[s],
                       rows_full=rows_full[s], ops=self.ops,
                       touched=gb.serve_valid[s] > 0,
                       slot_val=gb.serve_slot[s])
            pushed.append(g_serve)

        self._dense_sync(state, dense_grads)
        state.step += 1
        loss = losses[0].to(home)
        for x in losses[1:]:
            loss = loss + x.to(home)
        return {"loss": loss, "pred": preds, "pushed": pushed}

    # ---- forward-only eval (the test-phase run) ----
    def pull(self, tables: List[TableState], gb: GlobalBatch
             ) -> List[torch.Tensor]:
        """Each destination's pulled values [K_real, 3 + mf] through the
        owners' gathers and the exchange."""
        a = gb.resp_idx[0].shape[1]
        _, recvs = self._pull(tables, gb, (a,))
        return [expand_pull(recvs[0][d],
                            gb.gather_idx[d][:gb.key_counts[d][0]])
                for d in range(self.n)]

    def eval(self, tables: List[TableState], model: nn.Module,
             auc: List[AucState], gb: GlobalBatch) -> List[torch.Tensor]:
        """Forward only; each destination's AUC state accumulates.
        Returns each destination's predictions [B]."""
        a = gb.resp_idx[0].shape[1]
        preds = []
        with torch.no_grad():
            _, recvs = self._pull(tables, gb, (a,))
            for d in range(self.n):
                m = self._model_on(model, self.devices[d])
                dense, label, show, _ = unpack_floats(gb.floats[d])
                logits = m(self._pool([recvs[0][d]], gb, d, a, ()), dense)
                pred = torch.sigmoid(logits)
                auc_add_batch(auc[d], pred, label, (show > 0).float())
                preds.append(pred)
        return preds


def group_batches(batches: Iterable[SlotBatch], n: int
                  ) -> Iterator[List[SlotBatch]]:
    """Pack a batch stream into groups of ``n``; the tail group is padded
    by repeating the last batch with show=0 and clk=0, so neither the
    loss, the metrics nor the pushed counters see the copies."""
    group: List[SlotBatch] = []
    for bt in batches:
        group.append(bt)
        if len(group) == n:
            yield group
            group = []
    if group:
        filler = group[-1]
        dead = dataclasses.replace(filler, show=np.zeros_like(filler.show),
                                   clk=np.zeros_like(filler.clk))
        while len(group) < n:
            group.append(dead)
        yield group


class ShardedTrainer:
    """Multi-shard trainer: groups the batch stream into global batches
    of N, builds their routing plans and stages them on producer threads,
    and runs the sharded step (the BoxPSTrainer::Run role)."""

    def __init__(self, model: nn.Module, table: ShardedEmbeddingTable,
                 desc, tx: Optional[OptimizerFactory] = None,
                 use_cvm: bool = True, prefetch: int = PREFETCH_DEPTH,
                 seed: int = 0, zero1: bool = False,
                 lr_map: Optional[dict] = None,
                 ops: KernelSet = KERNELS) -> None:
        """``model`` (params already set) moves to the table's first
        device. ``tx`` builds the dense optimizer (default: Adam, lr
        1e-3). ``FLAGS.a2a_chunks`` is read here: > 1 runs the chunked
        schedule. ``lr_map`` needs ``train/dense_modes.build_lr_scales``,
        which is not ported yet."""
        if lr_map:
            raise NotImplementedError(
                "lr_map needs train/dense_modes.build_lr_scales "
                "(ROADMAP queue 1 item 8), not ported yet")
        self.a2a_chunks = max(1, int(FLAGS.a2a_chunks))
        self.table = table
        self.desc = desc
        self.n = table.n
        self.devices = table.devices
        self.step_fn = ShardedTrainStep(
            tx or default_tx, table.cfg, self.devices, desc.batch_size,
            len(desc.sparse_slots), use_cvm=use_cvm, zero1=zero1, ops=ops)
        self.state = self.step_fn.init_state(table, model)
        self.model = self.state.model
        self.seed = seed
        self.global_step = 0
        self.prefetch = prefetch
        self.stage_timers = StageTimers()
        self._dump_cfg: Optional[DumpConfig] = None
        # the metric variants fed every batch, per destination row
        self.metrics = MetricRegistry()

    def set_dump(self, cfg: Optional[DumpConfig]) -> None:
        """Per-sample prediction dump for later passes; None turns it
        off. Each destination row of the global batch writes its own
        ``.part-<rank + d>`` file (one dump channel per worker,
        boxps_worker.cc:1595)."""
        self._dump_cfg = cfg

    def _group_iter(self, batches):
        return group_batches(batches, self.n)

    def _stage_batch(self, group: List[SlotBatch],
                     idx: ShardedPullIndex) -> GlobalBatch:
        return make_global_batch(group, idx, self.devices)

    def _prefetch_iter(self, batches, prepare: Callable = None):
        """(group, staged batch, sections) with the plan build and the
        staging on two chained producer threads."""
        st = self.stage_timers
        prep = prepare or (lambda g: self.table.prepare_global(
            g, groups=self.a2a_chunks))

        def do_prep(group):
            with st.stage("prepare"):
                return group, prep(group)

        def do_stage(t):
            with st.stage("stage"):
                return t[0], self._stage_batch(*t), plan_sections(t[1])

        planned = prefetch_iter(self._group_iter(batches), do_prep,
                                capacity=self.prefetch)
        return prefetch_iter(planned, do_stage, capacity=self.prefetch)

    def _prefetch_iter_eval(self, batches):
        # read-only routing: lookups, unknown keys serve the zero row
        return self._prefetch_iter(batches,
                                   prepare=self.table.prepare_global_eval)

    def _feed_rows(self, group: List[SlotBatch], preds, writer_for,
                   want_dump: bool) -> None:
        """The registry feed (AddAucMonitor) and the dump, one
        destination row at a time, skipping tail-group fillers."""
        for d, (bt, pred) in enumerate(zip(group, preds)):
            n_real = int((bt.show > 0).sum())
            if n_real == 0:
                continue
            if len(self.metrics):
                self.metrics.add_batch(
                    pred, bt.label, (bt.show > 0).astype(np.float32),
                    uid=bt.uid, rank=bt.rank, cmatch=bt.cmatch)
            if want_dump:
                writer_for(d).add_batch(
                    bt.ins_ids, {"pred": pred, "label": bt.label,
                                 "show": bt.show, "clk": bt.clk}, n_real)

    def train_pass(self, dataset, log_prefix: str = "") -> Dict[str, float]:
        """One pass over the dataset in global batches of N. Returns the
        AUC result of the accumulated tables (cumulative until
        ``reset_metrics``), the pass's global batches (and how many ran
        the chunked schedule: a grouped plan falls back to the
        monolithic one per batch) and examples, its wall seconds and
        examples/s, and the last loss."""
        self.stage_timers.reset()
        t0 = time.perf_counter()
        nb = n_ex = n_chunked = 0
        stats = None
        writers: Dict[int, DumpWriter] = {}

        def writer_for(d: int) -> DumpWriter:
            if d not in writers:
                cfg = copy.copy(self._dump_cfg)
                cfg.rank = cfg.rank + d
                writers[d] = DumpWriter(cfg)
            return writers[d]

        if self._dump_cfg is not None:
            # every row gets its (maybe empty) part file
            for d in range(self.n):
                writer_for(d)
        try:
            for group, gb, secs in self._prefetch_iter(dataset.batches()):
                self.global_step += 1
                gens = push_generators(self.devices, self.seed,
                                       self.global_step)
                with self.stage_timers.stage("step"):
                    stats = self.step_fn(self.state, gb, gens, secs)
                nb += 1
                n_chunked += bool(secs)
                n_ex += sum(int((bt.show > 0).sum()) for bt in group)
                want_dump = (self._dump_cfg is not None
                             and nb % self._dump_cfg.interval == 0)
                if len(self.metrics) or want_dump:
                    self._feed_rows(group, stats["pred"], writer_for,
                                    want_dump)
        finally:
            for w in writers.values():
                w.close()
        elapsed = time.perf_counter() - t0
        self.sync_table()
        out = auc_compute(self._finalize_auc(self.state.auc)).as_dict()
        out.update(batches=nb, chunked_batches=n_chunked, examples=n_ex,
                   elapsed_sec=elapsed,
                   examples_per_sec=n_ex / max(elapsed, 1e-9),
                   last_loss=(float(stats["loss"]) if stats is not None
                              else float("nan")))
        log.info("%ssharded pass done: %d global batches, %.0f ex/s, "
                 "auc=%.4f", log_prefix, nb, out["examples_per_sec"],
                 out["auc"])
        return out

    @staticmethod
    def _finalize_auc(auc: List[AucState]) -> AucState:
        """The destinations' AUC states summed into one."""
        return auc_merge(auc)

    def reset_metrics(self) -> None:
        self.state.auc = init_sharded_auc(self.devices)

    # ---- checkpoint hooks ----
    def sync_table(self) -> None:
        """Point the table at the trained states (the step writes them in
        place, so this matters only after one side was replaced)."""
        self.table.states = list(self.state.tables)

    def dense_snapshot(self) -> Dict[str, Any]:
        """The dense state a checkpoint stores: the model and optimizer
        ``state_dict``s and the destinations' AUC states summed into
        one (additive, restored as shard 0's with zeros elsewhere)."""
        auc = self._finalize_auc(self.state.auc)
        return {"model": _to_cpu(self.model.state_dict()),
                "opt": _to_cpu(self.state.opt.state_dict()),
                "auc": {"buckets": auc.buckets.detach().cpu().clone(),
                        "sums": auc.sums.detach().cpu().clone()}}

    def restore_state(self, model_sd, opt_sd, auc, step: int) -> None:
        """Rebind the dense and metric state after a restore (the table
        was already loaded). ``auc`` None keeps the current states."""
        self.model.load_state_dict(model_sd)
        self.state.opt.load_state_dict(opt_sd)
        self.step_fn._refresh_replicas(self.model)
        if auc is not None:
            states = init_sharded_auc(self.devices,
                                      auc["buckets"].shape[1])
            states[0].buckets.copy_(auc["buckets"])
            states[0].sums.copy_(auc["sums"])
            self.state.auc = states
        self.state.tables = list(self.table.states)
        self.state.step = int(step)
        self.global_step = int(step)

    def eval_pass(self, dataset, log_prefix: str = "") -> Dict[str, float]:
        """Forward-only pass: the pull and the model over every shard, no
        push, no dense update, no index growth; the AUC summed over the
        destinations (the test-phase run)."""
        auc = init_sharded_auc(self.devices)
        self.stage_timers.reset()
        t0 = time.perf_counter()
        nb = 0
        self.model.eval()
        try:
            for group, gb, _ in self._prefetch_iter_eval(dataset.batches()):
                with self.stage_timers.stage("step"):
                    preds = self.step_fn.eval(self.state.tables, self.model,
                                              auc, gb)
                if len(self.metrics):
                    self._feed_rows(group, preds, None, False)
                nb += 1
        finally:
            self.model.train()
        res = auc_compute(self._finalize_auc(auc))
        elapsed = time.perf_counter() - t0
        out = res.as_dict()
        out.update(batches=nb, elapsed_sec=elapsed,
                   examples_per_sec=res.ins_num / max(elapsed, 1e-9))
        log.info("%ssharded eval pass: %d global batches, auc=%.4f",
                 log_prefix, nb, res.auc)
        return out
