"""Multi-shard training — counterpart of ``paddlebox_tpu/train/sharded.py``:
the streaming path and the resident pass.

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
rows in first-seen order). Each owner draws for its real serve rows
only, so a plan's padding (power-of-two when streaming, the fine ladder
when resident) changes no draw. The reference folds the shard index
into the step's key (``fold_in(fold_in(rng, t), s)``); the two agree
only through ``mf_initial_range == 0`` or explicit draws.

The resident pass (``ShardedResidentPass``, ``train_pass_resident``,
``PassPreloader(build_fn=trainer.build_resident_pass)``): the pass's
routing plans are built once with uniform widths, stacked, bit-packed
(the reference's wire, byte for byte) and staged on the shards' devices;
``run_resident`` then decodes each step there (``_decode_wire_step``)
and runs ``ShardedTrainStep.__call__``, with no host plan and no copy a
step. What a decode would have to read from the device (each owner's
count of real requests, the serve rows' count and base, the keys a
section) stays on the host, computed at build time. It equals the
streaming ``train_pass`` over the same batches bit for bit.

The tiered pipeline (``tiered_pass_pipeline``, ``train_passes_tiered``):
over a ``ps/tiered.TieredShardedEmbeddingTable``, ``build_resident_pass``
brackets each build in the table's ``plan_scope`` (a future pass's new
keys become plan-pending rows) and promotes the pass's spilled rows
host-ward (``prefetch_promote``), so a ``train/device_pass.PassPipeline``
builds, stages and fetches the next passes on its worker while one
trains; ``begin_pass`` only reconciles and ``end_pass`` writes back on
the table's epilogue worker. Telemetry (``obs/``): each pass ends with
a ``train_pass_sharded`` / ``train_pass_resident_sharded`` pass event
when a sink is attached, and a resident pass's steps run in a
``pass.consume`` span linked to its build span.

The multi-process form (``pod=``, a ``train/multihost.Pod`` from
``global_mesh``): each rank process holds only its owned shards' table
states, the model (a replica on every rank) and, under ZeRO-1, its
owned optimizer chunks; every rank builds the same global batches and
plans (the SPMD host contract) and stages only its owned entries. The
loops above run over the owned shards; both exchanges are one
``all_to_all`` across the ranks each (copies within a rank); the dense
grads of every destination are all-gathered and summed in shard order
(ZeRO-1: an all-to-all of the grad chunks, each rank summing its
chunks' slices in shard order, its chunks' update, an all-gather of the
chunks), as are the losses and, at the end of a pass, the AUC tables.
So a pod run equals the single-controller run over the same shards bit
for bit.
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
from paddlebox_tpu_torch.obs import trace
from paddlebox_tpu_torch.obs.hub import emit_pass_event, get_hub
from paddlebox_tpu_torch.ops.kernels import KERNELS, KernelSet
from paddlebox_tpu_torch.ops.seqpool_cvm import (fused_seqpool_cvm,
                                                 fused_seqpool_cvm_slot_group)
from paddlebox_tpu_torch.ps.sgd import SparseSGDConfig
from paddlebox_tpu_torch.ps.sharded import (ShardedEmbeddingTable,
                                            ShardedPullIndex,
                                            chunk_local_positions,
                                            plan_sections, section_offsets)
from paddlebox_tpu_torch.ops.bitpack import (pack_delta_auto, pack_u16m,
                                             pack_u24, unpack_delta16,
                                             unpack_u16m, unpack_u24,
                                             widen_u16)
from paddlebox_tpu_torch.ps.table import (TableState, apply_push,
                                          expand_pull, fill_oob_pads,
                                          gather_full_rows, merge_rows,
                                          next_bucket_fine, pull_values)
from paddlebox_tpu_torch.train.device_pass import (PassPipeline,
                                                   poll_preload_abort)
from paddlebox_tpu_torch.train.dense_modes import (build_lr_scales,
                                                   lr_map_transform,
                                                   scale_update)
from paddlebox_tpu_torch.train.step import (OptimizerFactory, default_tx,
                                            pack_floats, quantize_floats,
                                            unpack_floats)
from paddlebox_tpu_torch.train.trainer import PREFETCH_DEPTH, _to_cpu
from paddlebox_tpu_torch.utils.dump import DumpConfig, DumpWriter
from paddlebox_tpu_torch.utils.profiler import StageTimers
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
    serve_counts: Tuple[int, ...]    # real serve rows per owner
    # shown examples of the whole global batch (host): the loss's weight
    # sum, also where a rank holds only its own destinations
    weight_sum: float = 0.0
    # the plan's ``plan_sections`` (host), () for a monolithic plan
    plan_sections: Tuple = ()


# the GlobalBatch fields that hold one device tensor a shard
_DEVICE_FIELDS = tuple(f for f in GlobalBatch._fields
                       if not f.endswith("_counts")
                       and f not in ("weight_sum", "plan_sections"))


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
                      devices: Sequence[torch.device],
                      owned: Optional[Sequence[int]] = None) -> GlobalBatch:
    """``make_global_arrays`` staged on the shards' devices: per shard one
    int32 block (resp_idx, serve_rows, the live request positions,
    gather_idx, segments) and one float32 block (serve_valid,
    serve_slot, the batch's floats), sliced there. ``owned`` (a rank's
    shards, ``train/multihost.stage_global_batch``) stages those
    entries only; the others stay None."""
    host = make_global_arrays(batches, idx)
    n = len(batches)
    a2 = host["serve_rows"].shape[1]
    k = host["gather_idx"].shape[1]
    secs = idx.key_sections or (k,)
    mine = set(range(n) if owned is None else owned)
    out: Dict[str, List[Optional[torch.Tensor]]] = {
        f: [None] * n for f in _DEVICE_FIELDS}
    counts = []
    for s in range(n):
        counts.append(_key_counts(idx.key_valid[s], secs))
        if s not in mine:
            continue
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
        out["resp_idx"][s] = ti[:na].view(resp.shape)
        out["serve_rows"][s] = ti[o[1]:o[2]]
        out["live"][s] = ti[o[2]:o[3]]
        out["gather_idx"][s] = ti[o[3]:o[4]]
        out["segments"][s] = ti[o[4]:]
        out["serve_valid"][s] = tf[:a2]
        out["serve_slot"][s] = tf[a2:2 * a2]
        out["floats"][s] = tf[2 * a2:].view(len(host["label"][s]), -1)
    return GlobalBatch(key_counts=tuple(counts),
                       serve_counts=_serve_counts(idx.serve_valid),
                       weight_sum=float((host["show"] > 0).sum()),
                       plan_sections=plan_sections(idx), **out)


def _key_counts(key_valid: np.ndarray, secs) -> Tuple[int, ...]:
    """Real keys of one destination per key section (host ints)."""
    return tuple(int(key_valid[lo:lo + w].sum())
                 for lo, w in zip(section_offsets(secs), secs))


def _serve_counts(serve_valid: np.ndarray) -> Tuple[int, ...]:
    """Real serve rows per owner (host ints): the lazy-mf draws cover
    exactly these, so a plan's padded width draws nothing."""
    return tuple(int(v) for v in (serve_valid > 0).sum(axis=-1))


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
                     nbins: int = AUC_NUM_BUCKETS,
                     owned: Optional[Sequence[int]] = None
                     ) -> List[Optional[AucState]]:
    """One zeroed AUC state per destination shard, on its device (per
    ``owned`` shard only; None for the others)."""
    mine = set(range(len(devices)) if owned is None else owned)
    return [init_auc_state(nbins, device=dev) if d in mine else None
            for d, dev in enumerate(devices)]


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
    all-gather); ``ShardedTrainStep._dense_sync`` drives the three.
    Each chunk is read from the params before its step, so params set
    from outside (a restore) are what the next step updates. ``owned``
    (a rank's shards in the multi-process form) keeps only those chunks
    and their optimizers."""

    def __init__(self, params: List[nn.Parameter], tx: OptimizerFactory,
                 devices: Sequence[torch.device],
                 lr_scales: Optional[Sequence[float]] = None,
                 owned: Optional[Sequence[int]] = None) -> None:
        """``lr_scales`` (one multiplier a param, ``dense_modes.
        build_lr_scales``) scale each chunk's update elementwise after its
        step, raveled as the params are (lr_map through the flat
        chunks)."""
        self.params = params
        self.devices = list(devices)
        n = len(self.devices)
        self.owned = list(range(n)) if owned is None else list(owned)
        self.psize = sum(p.numel() for p in params)
        self.chunk = -(-self.psize // n)
        self.chunks = [nn.Parameter(torch.zeros(self.chunk,
                                                device=self.devices[s]))
                       for s in self.owned]
        self.opts = [tx([c]) for c in self.chunks]
        self.scales: Optional[List[torch.Tensor]] = None
        if lr_scales is not None:
            flat = F.pad(torch.cat([torch.full((p.numel(),), float(sc))
                                    for p, sc in zip(params, lr_scales)]),
                         (0, n * self.chunk - self.psize), value=1.0)
            self.scales = [flat[s * self.chunk:(s + 1) * self.chunk].to(
                self.devices[s]) for s in self.owned]

    def _flat(self, tensors: List[torch.Tensor]) -> torch.Tensor:
        flat = torch.cat([t.reshape(-1) for t in tensors])
        return F.pad(flat, (0, len(self.devices) * self.chunk - self.psize))

    def step_chunks(self, grad_of: Callable[[int], torch.Tensor]) -> None:
        """Step each owned chunk s on ``grad_of(s)``, its summed grad."""
        p = self._flat([q.detach() for q in self.params])
        c = self.chunk
        with torch.no_grad():
            for i, (s, chunk, opt) in enumerate(zip(self.owned, self.chunks,
                                                    self.opts)):
                chunk.copy_(p[s * c:(s + 1) * c])
                old = chunk.detach().clone() if self.scales else None
                chunk.grad = grad_of(s).to(self.devices[s])
                opt.step()
                chunk.grad = None
                if self.scales:
                    chunk.copy_(scale_update(old, chunk, self.scales[i]))

    def write_params(self, flat: torch.Tensor) -> None:
        """The params from the [N * chunk] flat chunks (the all-gather's
        result)."""
        with torch.no_grad():
            off = 0
            for q in self.params:
                q.copy_(flat[off:off + q.numel()].view_as(q))
                off += q.numel()

    def state_dict(self) -> List[Dict[str, Any]]:
        """The owned chunks' optimizer states, in shard order."""
        return [opt.state_dict() for opt in self.opts]

    def load_state_dict(self, sd: List[Dict[str, Any]]) -> None:
        """From all N chunks' states (a snapshot's): each owned chunk
        takes its own."""
        if len(sd) != len(self.devices):
            raise ValueError(f"ZeRO-1 state of {len(sd)} chunks for "
                             f"{len(self.devices)}")
        for opt, s in zip(self.opts, self.owned):
            opt.load_state_dict(sd[s])


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
                 zero1: bool = False, ops: KernelSet = KERNELS,
                 lr_scales: Optional[Sequence[float]] = None,
                 pod=None) -> None:
        """``ops`` selects the device functions: the kernels, unless a
        check on the card passes ``kernels.PLAIN``. ``zero1`` shards the
        dense optimizer state over the devices (``Zero1``). ``lr_scales``
        (one multiplier a model param, in ``parameters()`` order) scale
        each param's update after the optimizer's step: the per-param
        lr_map, in either mode. ``pod`` (``train/multihost.Pod``) runs
        the multi-process form: this rank's shards ``pod.owned`` only,
        the exchanges and the dense sync across the ranks."""
        if zero1:
            _assert_elementwise_tx(tx)
        self.tx = tx
        self.sgd_cfg = sgd_cfg
        self.devices = list(devices)
        self.n = len(self.devices)
        self.pod = pod
        # the shards (owners and destinations) this process runs
        self.local = list(range(self.n)) if pod is None else list(pod.owned)
        self.home = self.devices[self.local[0]]
        self.batch_size = batch_size
        self.num_slots = num_slots
        self.use_cvm = use_cvm
        self.cvm_offset = cvm_offset
        self.zero1 = zero1
        self.ops = ops
        self.lr_scales = None if lr_scales is None else list(lr_scales)
        # model replicas on the destinations' other devices, refreshed
        # after every dense update
        self._replicas: Dict[torch.device, nn.Module] = {}

    def init_state(self, table: ShardedEmbeddingTable,
                   model: nn.Module) -> ShardedStepState:
        model = model.to(self.home)
        params = list(model.parameters())
        if self.zero1:
            opt = Zero1(params, self.tx, self.devices, self.lr_scales,
                        owned=self.local)
        elif self.lr_scales is not None:
            opt = lr_map_transform(self.tx, self.lr_scales)(params)
        else:
            opt = self.tx(params)
        self._replicas = {}
        return ShardedStepState(
            tables=list(table.states), model=model, opt=opt,
            auc=init_sharded_auc(self.devices, owned=self.local))

    def _model_on(self, model: nn.Module, dev: torch.device) -> nn.Module:
        if dev == self.home:
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

    def _exchange(self, blocks: Sequence[Optional[torch.Tensor]]
                  ) -> List[Optional[torch.Tensor]]:
        """``exchange`` over this process's shards: the copies between
        devices, or (pod) one all-to-all across the ranks."""
        if self.pod is None:
            return exchange(blocks, self.devices)
        return self.pod.exchange(blocks)

    # ---- dense grad sync + optimizer (both schedules) ----
    def _gather(self, rows: torch.Tensor) -> torch.Tensor:
        """[k, ...] rows of this process's shards → [N, ...] rows of every
        shard in shard order: the rows themselves on a single controller,
        an all-gather over the ranks on a pod."""
        if self.pod is None:
            return rows
        return self.pod.all_gather(rows).reshape((self.n,) + rows.shape[1:])

    def _chunk_spans(self, rows: torch.Tensor, c: int) -> torch.Tensor:
        """ZeRO-1's reduce-scatter exchange: [k, N * c] flat grad rows of
        this process's shards → [N, k * c], every shard's row cut to this
        process's chunks (all of them on a single controller; on a pod
        one all-to-all of the ranks' spans)."""
        if self.pod is None:
            return rows
        k, world = self.pod.k, self.pod.world
        send = rows.view(k, world, k * c).transpose(0, 1)
        return self.pod.all_to_all(send).reshape(self.n, k * c)

    def _dense_reduce(self, state: ShardedStepState,
                      grads: List[Optional[List[torch.Tensor]]],
                      losses: List[Optional[torch.Tensor]]
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The dense sync's sum (the psum, SyncParam's allreduce): every
        destination's dense grads and losses summed in shard order on the
        model's device. Each owned destination's grads are one flat row;
        only how every shard's rows reach this process differs between a
        single controller and a pod (``_gather``, ``_chunk_spans``), so
        both sum the same numbers in the same order. Returns the summed
        flat grads (under ZeRO-1 this process's chunk span of them) and
        the summed loss; reads and changes no state."""
        home = self.home
        params = list(state.model.parameters())

        def flat(d):
            return torch.cat([(torch.zeros_like(p) if g is None else g)
                              .reshape(-1).to(home)
                              for p, g in zip(params, grads[d])])

        def fold(rows):
            acc = rows[0]
            for r in rows[1:]:
                acc = acc + r
            return acc

        loss_rows = [losses[d].reshape(1).to(home) for d in self.local]
        if self.zero1:
            opt = state.opt
            rows = torch.stack([opt._flat([flat(d)]) for d in self.local])
            span = fold(self._chunk_spans(rows, opt.chunk))
            return span, fold(self._gather(torch.cat(loss_rows)))
        rows = torch.stack([torch.cat([flat(d), lr])
                            for d, lr in zip(self.local, loss_rows)])
        allg = self._gather(rows)
        return fold(allg[:, :-1]), fold(allg[:, -1])

    def _dense_apply(self, state: ShardedStepState,
                     summed: torch.Tensor) -> None:
        """One optimizer step on ``_dense_reduce``'s sum (or ZeRO-1's
        chunked one: the owned chunks stepped, the chunks gathered into
        the params), then the replicas refreshed."""
        params = list(state.model.parameters())
        if self.zero1:
            opt, c, lo = state.opt, state.opt.chunk, self.local[0]
            opt.step_chunks(
                lambda s: summed[(s - lo) * c:(s - lo + 1) * c])
            opt.write_params(self._gather(torch.stack(
                [ch.detach().to(self.home) for ch in opt.chunks]
            )).reshape(-1))
        else:
            off = 0
            for p in params:
                # a tensor of its own a param
                p.grad = summed[off:off + p.numel()].view_as(p).clone()
                off += p.numel()
            state.opt.step()
            for p in params:
                p.grad = None
        self._refresh_replicas(state.model)

    def _dense_sync(self, state: ShardedStepState,
                    grads: List[Optional[List[torch.Tensor]]],
                    losses: List[Optional[torch.Tensor]]) -> torch.Tensor:
        """``_dense_reduce`` then ``_dense_apply``; returns the summed
        loss."""
        summed, loss = self._dense_reduce(state, grads, losses)
        self._dense_apply(state, summed)
        return loss

    def _serve(self, tables: List[TableState], gb: GlobalBatch):
        """The owners' side of the pull: (rows_full, served values
        [A2, D]) per owner, None at the shards of other ranks."""
        rows_full: List[Optional[torch.Tensor]] = [None] * self.n
        serve_vals: List[Optional[torch.Tensor]] = [None] * self.n
        for s in self.local:
            rf = gather_full_rows(tables[s], gb.serve_rows[s], self.ops)
            rows_full[s] = rf
            serve_vals[s] = pull_values(rf, tables[s].mf_dim)
        return rows_full, serve_vals

    def _pull_section(self, serve_vals: List[Optional[torch.Tensor]],
                      gb: GlobalBatch, lo: int, ag: int
                      ) -> List[Optional[torch.Tensor]]:
        """One section's pull exchange: each owner's values expanded by
        its requests [lo, lo + ag), exchanged; per destination the
        received [N*ag, D] block."""
        n = self.n
        d = serve_vals[self.local[0]].shape[1]
        resp = [None if serve_vals[s] is None else
                expand_pull(serve_vals[s],
                            gb.resp_idx[s][:, lo:lo + ag].reshape(-1))
                .view(n, ag, d) for s in range(n)]
        return [None if r is None else r.reshape(n * ag, d)
                for r in self._exchange(resp)]

    def _pull(self, tables: List[TableState], gb: GlobalBatch,
              a_secs: Sequence[int]):
        """Owner-side gathers and the pull exchange(s): (rows_full per
        owner, per section the received [N*A_g, D] block per
        destination), None at the shards of other ranks."""
        rows_full, serve_vals = self._serve(tables, gb)
        recvs = [self._pull_section(serve_vals, gb, lo, ag)
                 for lo, ag in zip(section_offsets(a_secs), a_secs)]
        return rows_full, recvs

    def _pool_section(self, recv: torch.Tensor, gb: GlobalBatch, d: int,
                      a: int, sections: tuple, g: int = 0,
                      whole: bool = False) -> torch.Tensor:
        """Destination ``d``'s pooled block of section ``g`` from its
        received values (``sections`` = (): the whole [B, S, D'] block),
        over its real keys only (the padded keys pool into the discard
        bin in the reference and take no grad). ``whole``: ``recv`` is
        the monolithic exchange's [N*A, D] block, which the section's
        global positions index as they are."""
        b, s, counts = self.batch_size, self.num_slots, gb.key_counts[d]
        show_clk = gb.floats[d][:, -2:]
        if not sections:
            nk = counts[0]
            return fused_seqpool_cvm(
                expand_pull(recv, gb.gather_idx[d][:nk]),
                gb.segments[d][:nk], show_clk, b, s, self.use_cvm,
                self.cvm_offset, ops=self.ops)
        a_secs, k_secs, s_secs = sections
        lo, nk = section_offsets(k_secs)[g], counts[g]
        s_lo = section_offsets(s_secs)[g]
        pos = gb.gather_idx[d][lo:lo + nk]
        if not whole:
            # global position owner*A + j → the chunk's own positions
            pos = chunk_local_positions(pos.long(), a,
                                        section_offsets(a_secs)[g],
                                        a_secs[g])
        return fused_seqpool_cvm_slot_group(
            expand_pull(recv, pos), gb.segments[d][lo:lo + nk],
            show_clk, b, s, s_lo, s_lo + s_secs[g], self.use_cvm,
            self.cvm_offset, ops=self.ops)

    def _pool(self, recvs_d: List[torch.Tensor], gb: GlobalBatch, d: int,
              a: int, sections: tuple) -> torch.Tensor:
        """Destination ``d``'s pooled [B, S, D'] block, one section at a
        time in the chunked schedule. The monolithic schedule over a
        grouped plan (``gb.plan_sections``) pools its one block section
        by section too, so it sums what the chunked schedule sums."""
        if sections:
            return torch.cat([self._pool_section(r, gb, d, a, sections, g)
                              for g, r in enumerate(recvs_d)], dim=1)
        secs = gb.plan_sections
        if secs:
            return torch.cat([self._pool_section(recvs_d[0], gb, d, a,
                                                 secs, g, whole=True)
                              for g in range(len(secs[0]))], dim=1)
        return self._pool_section(recvs_d[0], gb, d, a, ())

    def _loss(self, model: nn.Module, pooled: torch.Tensor,
              gb: GlobalBatch, d: int, wsum: torch.Tensor):
        """Destination ``d``'s (logits, loss, label, instance weights):
        the model on its pooled block, the weighted BCE over the global
        batch's weight sum."""
        dense, label, _, _ = unpack_floats(gb.floats[d])
        ins_w = (gb.floats[d][:, -2] > 0).float()
        logits = model(pooled, dense)
        ls = F.binary_cross_entropy_with_logits(logits, label,
                                                reduction="none")
        loss = (ls * ins_w).sum() / wsum.to(pooled.device).clamp_min(1.0)
        return logits, loss, label, ins_w

    def _push_merge(self, g_vals: List[Optional[torch.Tensor]],
                    gb: GlobalBatch, a: int, a2: int
                    ) -> List[Optional[torch.Tensor]]:
        """The push exchange (grads back to their owners) and each
        owner's merge of its real requests: per owner the [A2, D] grads
        of its served rows, unscaled."""
        n = self.n
        merged: List[Optional[torch.Tensor]] = [None] * n
        g_backs = self._exchange(g_vals)
        for s in self.local:
            g_back = g_backs[s]
            live = gb.live[s].long()
            dd = g_back.shape[-1]
            merged[s] = merge_rows(g_back.reshape(n * a, dd)[live],
                                   gb.resp_idx[s].reshape(-1)[live], a2)
        return merged

    def __call__(self, state: ShardedStepState, gb: GlobalBatch,
                 generators: Sequence[torch.Generator],
                 sections: tuple = ()) -> Dict[str, Any]:
        """One global step. ``generators`` (``push_generators``) draw
        each owner's lazy-mf values. ``sections`` = () runs the
        monolithic schedule; a grouped plan's ``plan_sections`` runs the
        chunked one (one exchange per slot group, each group pooled
        alone), which gives the same bits. Returns the summed loss, each
        destination's predictions and each owner's pushed grads
        (device tensors; None at the shards of other ranks)."""
        n, b = self.n, self.batch_size
        lo = self.local[0]
        a = gb.resp_idx[lo].shape[1]
        a2 = gb.serve_rows[lo].shape[0]
        a_secs = sections[0] if sections else (a,)
        rows_full, recvs = self._pull(state.tables, gb, a_secs)
        # every destination's weights, the other ranks' too (host; an
        # integer count, exact in f32)
        wsum = torch.tensor(gb.weight_sum, dtype=torch.float32,
                            device=self.home)

        losses: List[Optional[torch.Tensor]] = [None] * n
        preds: List[Optional[torch.Tensor]] = [None] * n
        dense_grads: List[Optional[list]] = [None] * n
        g_vals: List[Optional[torch.Tensor]] = [None] * n
        for d in self.local:
            model = self._model_on(state.model, self.devices[d])
            leaves = [recvs[g][d].detach().requires_grad_(True)
                      for g in range(len(a_secs))]
            logits, loss, label, ins_w = self._loss(
                model, self._pool(leaves, gb, d, a, sections), gb, d, wsum)
            params = list(model.parameters())
            grads = torch.autograd.grad(loss, leaves + params,
                                        allow_unused=True)
            # a section none of d's keys reads gets no grad: zeros
            g_leaf = [torch.zeros_like(x) if g is None else g
                      for x, g in zip(leaves, grads[:len(leaves)])]
            g_params = grads[len(leaves):]
            dd = g_leaf[0].shape[1]
            g_vals[d] = torch.cat([g.view(n, ag, dd) for g, ag in
                                   zip(g_leaf, a_secs)], dim=1)
            dense_grads[d] = list(g_params)
            losses[d] = loss.detach()
            pred = torch.sigmoid(logits.detach())
            auc_add_batch(state.auc[d], pred, label, ins_w)
            preds[d] = pred

        # ---- push: grads back to their owners, merge, update ----
        pushed = self._push_merge(g_vals, gb, a, a2)
        for s in self.local:
            g_serve = pushed[s]
            # PushCopy scaling (box_wrapper.cu:368): negate the embed
            # grads and scale by the global batch (the loss is the
            # global mean)
            g_serve[:, 2:] *= -1.0 * b * n
            # the lazy-mf draws cover the real serve rows only: the
            # streaming and resident plans pad A2 differently
            apply_push(state.tables[s], gb.serve_rows[s], g_serve,
                       self.sgd_cfg, generator=generators[s],
                       rows_full=rows_full[s], ops=self.ops,
                       touched=gb.serve_valid[s] > 0,
                       slot_val=gb.serve_slot[s],
                       draw_rows=gb.serve_counts[s])

        loss = self._dense_sync(state, dense_grads, losses)
        state.step += 1
        return {"loss": loss, "pred": preds, "pushed": pushed}

    # ---- forward-only eval (the test-phase run) ----
    def pull(self, tables: List[TableState], gb: GlobalBatch
             ) -> List[Optional[torch.Tensor]]:
        """Each destination's pulled values [K_real, 3 + mf] through the
        owners' gathers and the exchange."""
        a = gb.resp_idx[self.local[0]].shape[1]
        _, recvs = self._pull(tables, gb, (a,))
        return [None if recvs[0][d] is None else
                expand_pull(recvs[0][d],
                            gb.gather_idx[d][:gb.key_counts[d][0]])
                for d in range(self.n)]

    def eval(self, tables: List[TableState], model: nn.Module,
             auc: List[AucState], gb: GlobalBatch
             ) -> List[Optional[torch.Tensor]]:
        """Forward only; each destination's AUC state accumulates.
        Returns each destination's predictions [B]."""
        a = gb.resp_idx[self.local[0]].shape[1]
        preds: List[Optional[torch.Tensor]] = [None] * self.n
        with torch.no_grad():
            _, recvs = self._pull(tables, gb, (a,))
            for d in self.local:
                m = self._model_on(model, self.devices[d])
                dense, label, show, _ = unpack_floats(gb.floats[d])
                logits = m(self._pool([recvs[0][d]], gb, d, a, ()), dense)
                pred = torch.sigmoid(logits)
                auc_add_batch(auc[d], pred, label, (show > 0).float())
                preds[d] = pred
        return preds


    # ---- the resident pass: a loop over the staged global batches ----
    def run_resident(self, state: ShardedStepState,
                     rp: "ShardedResidentPass", seed: int, global_step: int,
                     chunk: int = 0, collect_preds: bool = False):
        """Run every staged global batch of ``rp`` (``upload``ed and
        ordered by ``wait_ready``), updating ``state`` in place. Step i
        decodes its batch on the shards' devices (no host plan, no copy)
        and draws from ``push_generators(devices, seed, global_step + i +
        1)``, the generators ``ShardedTrainer.train_pass`` gives that
        global step. The host queues ``chunk`` steps (default: the whole
        pass) before it waits for the devices. Returns the per-step
        losses; with ``collect_preds`` also each destination's
        predictions [nb, B] (device tensors; None at other ranks'
        destinations), for the metric feed."""
        nb = rp.num_batches
        c = chunk or nb
        losses: List[torch.Tensor] = []
        preds: List[List[torch.Tensor]] = [[] for _ in range(self.n)]
        for i in range(nb):
            gb = _decode_wire_step(rp, i)
            stats = self(state, gb, push_generators(
                self.devices, seed, global_step + i + 1), rp.sections)
            losses.append(stats["loss"])
            if collect_preds:
                for d in self.local:
                    preds[d].append(stats["pred"][d])
            if (i + 1) % c == 0:
                losses[-1].item()     # the chunk is done on the devices
        if not collect_preds:
            return losses
        return losses, [torch.stack(p) if p else None for p in preds]


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
    and runs the sharded step (the BoxPSTrainer::Run role). With ``pod``
    it is one rank of the multi-process form (module docstring): every
    rank calls every method in lockstep over the same datasets."""

    def __init__(self, model: nn.Module, table: ShardedEmbeddingTable,
                 desc, tx: Optional[OptimizerFactory] = None,
                 use_cvm: bool = True, prefetch: int = PREFETCH_DEPTH,
                 seed: int = 0, zero1: bool = False, float_wire: str = "f32",
                 lr_map: Optional[dict] = None, lr_map_base: float = 1.0,
                 ops: KernelSet = KERNELS, pod=None) -> None:
        """``model`` (params already set) moves to the table's first
        device. ``tx`` builds the dense optimizer (default: Adam, lr
        1e-3). ``FLAGS.a2a_chunks`` is read here: > 1 runs the chunked
        schedule. ``float_wire="q8"`` ships a resident pass's dense,
        label, show and clk as the int8 affine wire (~1e-2 dense
        rounding). ``lr_map``: per-param dense lr overrides, name
        (``dense_modes.lr_pattern_matches``) → lr against ``lr_map_base``
        (the optimizer's lr); each matched param's update scales by lr /
        lr_map_base, so 0.0 freezes it (box_wrapper.cc:1303-1335), in the
        replicated and the ZeRO-1 mode alike. ``pod``
        (``train/multihost.global_mesh``) makes this trainer one rank of
        the multi-process form: ``table`` holds the states of
        ``pod.owned`` only (``ShardedEmbeddingTable(pod=)``)."""
        if pod is not None and list(table.owned) != list(pod.owned):
            raise ValueError(f"the table holds shards {list(table.owned)}, "
                             f"the rank owns {list(pod.owned)}")
        self.pod = pod
        self.a2a_chunks = max(1, int(FLAGS.a2a_chunks))
        self.float_wire = float_wire
        self.table = table
        self.desc = desc
        self.n = table.n
        self.devices = table.devices
        scales = None
        if lr_map:
            named = build_lr_scales(model, lr_map, lr_map_base)
            scales = [named[k] for k, _ in model.named_parameters()]
        self.step_fn = ShardedTrainStep(
            tx or default_tx, table.cfg, self.devices, desc.batch_size,
            len(desc.sparse_slots), use_cvm=use_cvm, zero1=zero1, ops=ops,
            lr_scales=scales, pod=pod)
        self.local = self.step_fn.local
        self.state = self.step_fn.init_state(table, model)
        self.model = self.state.model
        self.seed = seed
        self.global_step = 0
        self.prefetch = prefetch
        self.stage_timers = StageTimers()
        self._dump_cfg: Optional[DumpConfig] = None
        # the metric variants fed every batch, per destination row
        self.metrics = MetricRegistry()
        # the last train/a2a_probe result: its exchange_overlap_frac rides
        # the resident pass events
        self._last_exchange_probe: Optional[Dict[str, Any]] = None

    def set_dump(self, cfg: Optional[DumpConfig]) -> None:
        """Per-sample prediction dump for later passes; None turns it
        off. Each destination row of the global batch writes its own
        ``.part-<rank + d>`` file (one dump channel per worker,
        boxps_worker.cc:1595); on a pod each rank writes its own rows'
        files, which concatenated in rank order are the single
        controller's."""
        self._dump_cfg = cfg

    def _group_iter(self, batches):
        return group_batches(batches, self.n)

    def _stage_batch(self, group: List[SlotBatch],
                     idx: ShardedPullIndex) -> GlobalBatch:
        if self.pod is not None:
            from paddlebox_tpu_torch.train.multihost import \
                stage_global_batch
            return stage_global_batch(self.pod, group, idx)
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
            if n_real == 0 or pred is None:
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
            for d in self.local:
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
        if get_hub().active:
            emit_pass_event("train_pass_sharded",
                            dict(out, global_step=self.global_step),
                            table=self.table, examples=n_ex)
        return out

    def _finalize_auc(self, auc: List[Optional[AucState]]) -> AucState:
        """The destinations' AUC states summed into one in shard order;
        on a pod each rank's tables are all-gathered first
        (``ShardedTrainStep._gather``), so every rank sums the same N
        states."""
        nb = auc[self.local[0]].buckets.shape[1]
        home = self.step_fn.home
        rows = self.step_fn._gather(torch.stack([
            torch.cat([auc[d].buckets.reshape(-1), auc[d].sums]).to(home)
            for d in self.local]))
        return auc_merge([AucState(r[:2 * nb].view(2, nb), r[2 * nb:])
                          for r in rows])

    def reset_metrics(self) -> None:
        self.state.auc = init_sharded_auc(self.devices, owned=self.local)

    # ---- checkpoint hooks ----
    def sync_table(self) -> None:
        """Point the table at the trained states (the step writes them in
        place, so this matters only after one side was replaced)."""
        self.table.states = list(self.state.tables)

    def fence_table(self) -> None:
        """Drain the table's asynchronous end_pass write-back
        (``ps/epilogue``) and raise the first failure; a no-op for a
        table without one. Checkpoint capture and every host-tier read
        fence by themselves: this is the explicit hook for code that
        reads the host stores directly."""
        fence = getattr(self.table, "fence", None)
        if fence is not None:
            fence()

    def adopt_table(self) -> None:
        """Point the step state at the table's states (after a window
        table's begin_pass; its windows are updated in place, so this
        matters only where a state was replaced)."""
        self.state.tables = list(self.table.states)

    def globalize_dense_state(self, check: bool = False) -> None:
        """On a pod, make every rank's dense state rank 0's (a broadcast of
        the model's params and buffers), or with ``check`` raise unless
        they already agree; a no-op on one controller."""
        if self.pod is not None:
            from paddlebox_tpu_torch.train.multihost import globalize_state
            globalize_state(self.pod, self.model, check=check)
            self.step_fn._refresh_replicas(self.model)

    def dense_snapshot(self) -> Dict[str, Any]:
        """The dense state a checkpoint stores: the model and optimizer
        ``state_dict``s and the destinations' AUC states summed into
        one (additive, restored as shard 0's with zeros elsewhere). On a
        pod every rank returns the same snapshot as the single
        controller (ZeRO-1: every rank's chunk states gathered in shard
        order); collective."""
        auc = self._finalize_auc(self.state.auc)
        opt = _to_cpu(self.state.opt.state_dict())
        if self.pod is not None and isinstance(self.state.opt, Zero1):
            opt = [sd for part in self.pod.all_gather_object(opt)
                   for sd in part]
        return {"model": _to_cpu(self.model.state_dict()),
                "opt": opt,
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
                                      auc["buckets"].shape[1],
                                      owned=self.local)
            if states[0] is not None:
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
        auc = init_sharded_auc(self.devices, owned=self.local)
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

    # ---- the resident pass ----
    def build_resident_pass(self, dataset) -> "ShardedResidentPass":
        """Build one pass's staged plans (on a preloader's worker, ahead
        of training: ``PassPreloader(build_fn=trainer.
        build_resident_pass)``). A tiered table gets the build bracketed
        in its ``plan_scope``: new keys become value-less PENDING rows
        that the next begin_pass reconciles with their staged host
        values, which makes a preloader legal over a pass-window table
        (preload_into_memory, box_wrapper.h:1142-1156). Each build of a
        depth-N preloader gets its own bracket; the window must hold the
        union of the open and every queued pass's working sets. With an
        SSD tier holding rows, the pass's spilled rows are then promoted
        host-ward (``prefetch_promote``; on a preloader's worker this
        overlaps the open pass's training, so begin_pass never waits on
        segment reads)."""
        scope = getattr(self.table, "plan_scope", None)
        if scope is None:
            rp = ShardedResidentPass.build(dataset, self)
        else:
            with scope():
                rp = ShardedResidentPass.build(dataset, self)
        pf = getattr(self.table, "prefetch_promote", None)
        if (pf is not None and hasattr(dataset, "pass_keys")
                and self.table.has_spilled_rows()):
            poll_preload_abort()
            pf(dataset.pass_keys())
        return rp

    def tiered_pass_pipeline(self, datasets, depth: Optional[int] = None
                             ) -> PassPipeline:
        """A ``train/device_pass.PassPipeline`` wired for this trainer's
        pass-window table: builds (plan_scope + prefetch_promote), the
        wire and the host-tier fetch ride the depth-N worker,
        ``begin_pass`` is reconcile-only, and ``end_pass``'s epilogue
        worker carries the eviction for the next pass. ``depth=0`` is
        the sequential kick-per-pass control."""
        return PassPipeline(iter(datasets),
                            build_fn=self.build_resident_pass,
                            window_table=self.table, trainer=self,
                            depth=depth)

    def train_passes_tiered(self, datasets, depth: Optional[int] = None,
                            log_prefix: str = "") -> List[Dict[str, float]]:
        """Train tiered resident passes end to end through the pipeline;
        returns the per-pass results of ``train_pass_resident`` (the
        tiered twin of ``Trainer.train_passes_resident``)."""
        pipe = self.tiered_pass_pipeline(datasets, depth=depth)
        pipe.start_next()
        sequential = depth == 0
        results = []
        try:
            while True:
                rp = pipe.wait()
                if rp is None:
                    break
                pipe.begin_pass()
                if not sequential:
                    pipe.start_next()
                results.append(self.train_pass_resident(
                    rp, log_prefix=log_prefix))
                pipe.end_pass()
                if sequential:
                    # the next build and fetch only after this pass closed
                    pipe.start_next()
        finally:
            pipe.drain()
        return results

    def _feed_registry_resident(self, rp: "ShardedResidentPass",
                                preds: List[torch.Tensor]) -> None:
        """The post-pass registry feed (AddAucMonitor) from the
        predictions collected on the devices: one copy a destination
        ([nb, B]), then the pass's batches in order, tail-group fillers
        skipped."""
        sd = rp.side
        for d, pred_d in enumerate(preds):
            if pred_d is None:
                continue
            pred_d = pred_d.cpu()
            for i in range(rp.num_batches):
                ins_w = (sd["show"][i, d] > 0).astype(np.float32)
                if not ins_w.any():
                    continue
                self.metrics.add_batch(
                    pred_d[i], sd["label"][i, d], ins_w,
                    **{f: None if sd[f] is None else sd[f][i, d]
                       for f in ("uid", "rank", "cmatch")})

    def train_pass_resident(self, pass_or_dataset,
                            log_prefix: str = "") -> Dict[str, float]:
        """The pass's global batches (routing plans and features) staged
        on the shards' devices once, then every step decoded there: no
        host plan and no host→device copy per step; the exchanges and
        the dense sum run as in ``train_pass``, which it equals bit for
        bit over the same batches. Takes a dataset or a pass from
        ``build_resident_pass`` (a preloader's)."""
        t0 = time.perf_counter()
        rp = (pass_or_dataset
              if isinstance(pass_or_dataset, ShardedResidentPass)
              else self.build_resident_pass(pass_or_dataset))
        want_metrics = len(self.metrics) > 0
        if want_metrics and rp.side is None:
            log.warning("registry metrics need the pass's side channels: "
                        "this pass was built before the registry had a "
                        "metric; rebuild it with build_resident_pass")
            want_metrics = False
        rp.upload()
        # the consume span links back to this pass's build span on the
        # preloader lane; it ends with the last loss on the host (the
        # pass's device work done)
        with trace.span("pass.consume",
                        link_from=getattr(rp, "_trace_span_id", 0)):
            rp.wait_ready()
            out = self.step_fn.run_resident(self.state, rp, self.seed,
                                            self.global_step,
                                            collect_preds=want_metrics)
            losses, preds = out if want_metrics else (out, None)
            last_loss = float(losses[-1])
        rp.release_host_buffers()
        rp.mark_trained_rows(self.table)
        if want_metrics:
            self._feed_registry_resident(rp, preds)
        self.global_step += rp.num_batches
        elapsed = time.perf_counter() - t0
        self.sync_table()
        out = auc_compute(self._finalize_auc(self.state.auc)).as_dict()
        out.update(batches=rp.num_batches,
                   chunked_batches=rp.num_batches if rp.sections else 0,
                   examples=rp.num_records, elapsed_sec=elapsed,
                   examples_per_sec=rp.num_records / max(elapsed, 1e-9),
                   last_loss=last_loss)
        log.info("%ssharded resident pass: %d global batches, %.0f ex/s, "
                 "auc=%.4f", log_prefix, rp.num_batches,
                 out["examples_per_sec"], out["auc"])
        if get_hub().active:
            ev = dict(out, global_step=self.global_step)
            pr = self._last_exchange_probe
            if pr is not None:
                # telemetry_report's "a2a ovl" column
                ev["exchange_overlap_frac"] = pr["exchange_overlap_frac"]
            emit_pass_event("train_pass_resident_sharded", ev,
                            table=self.table, examples=rp.num_records)
        return out


# ---------------------------------------------------------------------------
# the sharded resident pass
# ---------------------------------------------------------------------------

class ShardedResidentPass:
    """A pass's global batches, each field stacked on a leading step axis
    ([nb, N, ...], N = shard), bit-packed on the host (``_encode_wire``)
    and staged once on the shards' devices (entry s of the shard axis on
    ``devices[s]``). Routing plans are rebuilt with uniform A / A2 (or
    per-group section) widths when batches landed in different ones,
    since gather_idx encodes owner*A + j.

    Host side (never staged): ``wire["srmeta"]`` (real serve rows and
    first row per (step, owner), the delta wire's count and base),
    ``wire["meta"]`` (num_keys and pad_segment per (step, destination)
    for trivial segments), ``live_len`` (real requests per (step,
    owner)), ``key_counts`` and ``serve_counts``. The real request
    positions ``live`` ship padded to the pass's widest and are sliced
    by ``live_len``, so a step's decode reads no device value. On a pod
    every rank builds the same pass and stages its ``owned`` shards'
    entries only."""

    def __init__(self, arrays: Dict[str, np.ndarray],
                 plans: Sequence[ShardedPullIndex], num_records: int,
                 devices: Sequence[torch.device], capacity: int,
                 sections: tuple = (), trivial: bool = False,
                 float_wire: str = "f32",
                 owned: Optional[Sequence[int]] = None) -> None:
        """``arrays``: the pass's stacked fields ([nb, N, ...]), from
        ``plans`` (uniform widths); ``sections``: their chunk-schedule
        key, or () for the monolithic schedule; ``owned``: the shards
        this process stages (default all)."""
        self.num_records = num_records
        self.devices = list(devices)
        self.owned = (list(range(len(self.devices))) if owned is None
                      else list(owned))
        # shown examples of each global batch (the step's weight sum)
        self.weight_sums = [float(x) for x in
                            (arrays["show"] > 0).sum(axis=(1, 2))]
        self.capacity = capacity
        self.num_batches = arrays["label"].shape[0]
        self.sections = sections
        # host side channels for the post-pass metric feed ({label, show,
        # uid, rank, cmatch} as [nb, N, B], None where a batch lacked
        # the channel), set by build()
        self.side: Optional[Dict[str, Optional[np.ndarray]]] = None
        n = len(self.devices)
        self.key_counts = [
            tuple(_key_counts(p.key_valid[d], sections[1] if sections
                              else (p.key_valid.shape[1],))
                  for d in range(n)) for p in plans]
        self.serve_counts = [_serve_counts(p.serve_valid) for p in plans]
        # host seconds per build stage: plans, repad (re-pad or re-route
        # to the uniform widths), encode, h2d (the copies' issue)
        self.build_stats: Dict[str, float] = {}
        self.dev: Optional[Dict[str, List[Tuple[torch.Tensor, ...]]]] = None
        self.dev_live: Optional[List[torch.Tensor]] = None
        self._ready: Dict[torch.device, Any] = {}
        self._pinned: List[torch.Tensor] = []
        self._encode_wire(arrays, capacity, trivial, float_wire)
        self._set_live(arrays["resp_idx"])

    @classmethod
    def build(cls, dataset, trainer: "ShardedTrainer"
              ) -> "ShardedResidentPass":
        """Plan every global batch of the pass (``prepare_global``), make
        the widths uniform, stack and encode. A background (preloader)
        build polls the stop flag between groups."""
        table = trainer.table
        groups = list(trainer._group_iter(dataset.batches()))
        if not groups:
            raise ValueError("empty pass")
        t0 = time.perf_counter()
        chunks = trainer.a2a_chunks
        plans = []
        for g in groups:
            poll_preload_abort()
            plans.append(table.prepare_global(g, groups=chunks))
        poll_preload_abort()
        t1 = time.perf_counter()
        sections: tuple = ()
        if chunks > 1 and all(p.a2a_sections for p in plans):
            # chunked pass: per-group section widths uniform over the pass
            # (the max per section); plans off the common shape re-route
            # with forced sections (re-preparing re-assigns nothing new).
            # The serve width keeps the grouped builder's power-of-two
            # ladder, so plans of a same-shaped workload mostly match.
            c = len(plans[0].a2a_sections)
            a2 = max(p.serve_capacity for p in plans)
            req_secs = tuple(max(p.a2a_sections[g] for p in plans)
                             for g in range(c))
            key_secs = tuple(max(p.key_sections[g] for p in plans)
                             for g in range(c))
            uniformed = []
            for g, p in zip(groups, plans):
                if (p.a2a_sections != req_secs or p.key_sections != key_secs
                        or p.serve_capacity != a2):
                    poll_preload_abort()
                    p = table.prepare_global(
                        g, serve_capacity=a2, groups=chunks,
                        req_sections=req_secs, key_sections=key_secs)
                uniformed.append(p)
            plans = uniformed
            sections = plan_sections(plans[0])
        else:
            if chunks > 1:
                # a batch fell back to the monolithic plan: the whole pass
                # runs the monolithic schedule (one shape a pass), so the
                # grouped survivors are planned again, monolithic
                rebuilt = []
                for g, p in zip(groups, plans):
                    if p.a2a_sections:
                        poll_preload_abort()
                        p = table.prepare_global(g)
                    rebuilt.append(p)
                plans = rebuilt
                poll_preload_abort()
            # one uniform shape a pass: the fine ladder (~6% padding) in
            # place of the streaming power-of-two buckets, by array
            # surgery on the host (no second routing pass)
            a = next_bucket_fine(1, max(p.req_need for p in plans))
            a2 = next_bucket_fine(1, max(p.serve_need for p in plans))
            repadded = []
            for g, p in zip(groups, plans):
                q = cls._repad_plan(p, a, a2, trainer.n, table.capacity)
                if q is None:  # an exactly full request bucket: re-route
                    q = table.prepare_global(g, req_capacity=a,
                                             serve_capacity=a2)
                repadded.append(q)
            plans = repadded
        t2 = time.perf_counter()
        gbs = [make_global_arrays(g, p) for g, p in zip(groups, plans)]
        k = max(gb["gather_idx"].shape[1] for gb in gbs)
        # inert pad values: gather_idx pads → the recv sentinel slot
        # (n*A - 1, zero values), segment pads → the discard bin (B * S).
        # A chunked pass's forced sections give every batch one width.
        pad_of = ({} if sections else
                  {"gather_idx": trainer.n * a - 1,
                   "segments": trainer.desc.batch_size *
                   len(trainer.desc.sparse_slots)})
        arrays: Dict[str, np.ndarray] = {}
        for f in _WIRE_FIELDS:
            parts = []
            for gb in gbs:
                arr = gb[f]
                if f in pad_of and arr.shape[1] < k:
                    arr = np.pad(arr, ((0, 0), (0, k - arr.shape[1])),
                                 constant_values=pad_of[f])
                parts.append(arr)
            arrays[f] = np.stack(parts)
        n_rec = sum(int((b.show > 0).sum()) for g in groups for b in g)
        # the trivial-segment meta assumes the original slot-ordered key
        # stream; a chunked pass re-laid it, so it ships the segments
        trivial = (not sections and all(b.segments_trivial
                                        for g in groups for b in g))
        if trivial:
            arrays["meta"] = np.stack([
                np.array([[b.num_keys, b.pad_segment] for b in g], np.int32)
                for g in groups])
        rp = cls(arrays, plans, n_rec, table.devices, table.capacity,
                 sections=sections, trivial=trivial,
                 float_wire=trainer.float_wire, owned=trainer.local)

        def stack_opt(field):
            if any(getattr(b, field) is None for g in groups for b in g):
                return None
            return np.stack([np.stack([getattr(b, field) for b in g])
                             for g in groups])

        # side channels only when the registry replays them
        if len(trainer.metrics) > 0:
            rp.side = {"label": arrays["label"], "show": arrays["show"],
                       "uid": stack_opt("uid"), "rank": stack_opt("rank"),
                       "cmatch": stack_opt("cmatch")}
        t3 = time.perf_counter()
        rp.build_stats.update(plans=t1 - t0, repad=t2 - t1,
                              encode=t3 - t2)
        return rp

    @staticmethod
    def _repad_plan(p: ShardedPullIndex, a: int, a2: int, n: int,
                    capacity: int) -> Optional[ShardedPullIndex]:
        """A plan's A / A2 padding changed without routing again: the
        serve lists and slots are the same under any padding; only the
        pad regions, the resp_idx pad sentinel (A2 - 1) and gather_idx's
        owner*A + j stride encode the widths. None when the old request
        bucket is exactly full: its gather pad sentinel (n*A_old - 1)
        would alias a real position, so the caller routes again."""
        if p.req_capacity == a and p.serve_capacity == a2:
            return p
        a_old, a2_old = p.req_capacity, p.serve_capacity
        if p.req_need >= a_old:
            return None
        # real serve prefix per owner (always < a2_old: the +1 slot)
        u = p.serve_valid.astype(bool).sum(1)
        serve_rows = np.empty((n, a2), np.int32)
        serve_valid = np.zeros((n, a2), np.float32)
        serve_slot = np.zeros((n, a2), np.float32)
        resp_idx = np.full((n, n, a), a2 - 1, np.int32)
        w = min(a, a_old)
        for s in range(n):
            us = int(u[s])
            serve_rows[s, :us] = p.serve_rows[s, :us]
            fill_oob_pads(serve_rows[s], us, capacity)
            serve_valid[s, :us] = 1.0
            serve_slot[s, :us] = p.serve_slot[s, :us]
            # request prefix per (owner, dst): real serve indices are
            # < u < a2_old - 1, so counting the non-pad entries is exact
            cnt = (p.resp_idx[s] != a2_old - 1).sum(1)
            m = np.arange(w)[None, :] < cnt[:, None]
            resp_idx[s][:, :w][m] = p.resp_idx[s][:, :w][m]
        # gather positions re-stride from owner*A_old + j to owner*A + j;
        # the pad sentinel maps to the new one
        gi = p.gather_idx
        pad_mask = gi == n * a_old - 1
        owner, j = gi // a_old, gi % a_old
        gather_idx = np.where(pad_mask, n * a - 1,
                              owner * a + j).astype(np.int32)
        return p._replace(resp_idx=resp_idx, serve_rows=serve_rows,
                          serve_valid=serve_valid, serve_slot=serve_slot,
                          gather_idx=gather_idx, req_capacity=a,
                          serve_capacity=a2)

    def _encode_wire(self, a: Dict[str, np.ndarray], capacity: int,
                     trivial: bool, float_wire: str) -> None:
        """Bit-pack the stacked pass (``ops/bitpack`` ladders, as the
        reference's wire byte for byte): index arrays to 18 / 24-bit
        forms, serve_rows as u8 / u16 deltas with the pads derived,
        serve_valid derived from the ``fill_oob_pads`` contract, slot ids
        to u8 / u16, floats raw or, with ``float_wire="q8"``, the int8
        affine wire."""
        from paddlebox_tpu_torch.train.device_pass import ResidentPass
        fmt: Dict[str, str] = {}
        wire: Dict[str, tuple] = {}

        def enc_int(name, arr):
            vmax = int(arr.max(initial=0))
            nonneg = int(arr.min(initial=0)) >= 0
            if nonneg and vmax < (1 << 18) and arr.shape[-1] % 4 == 0:
                fmt[name], wire[name] = "u18", pack_u16m(arr, 2)
            elif nonneg and vmax < (1 << 24):
                fmt[name], wire[name] = "u24", pack_u24(arr)
            else:
                fmt[name], wire[name] = "raw", (arr,)

        enc_int("resp_idx", a["resp_idx"])
        # serve rows ascend per (step, owner) (np.unique, then ascending
        # OOB pads): the delta wire, pads regenerated from the count
        sr = a["serve_rows"]
        nbk, n, a2 = sr.shape
        flat = sr.reshape(-1, a2)
        counts = (flat <= capacity).sum(1).astype(np.int32)
        delta = pack_delta_auto(flat, counts, ResidentPass._EXC8,
                                ResidentPass._EXC)
        if delta is not None:
            fmt["serve_rows"] = "delta"
            wire["serve_rows"] = tuple(
                d.reshape((nbk, n) + d.shape[1:]) for d in delta)
            wire["srmeta"] = (np.stack(
                [counts.reshape(nbk, n),
                 flat[:, 0].reshape(nbk, n).astype(np.int32)], axis=-1),)
        else:
            enc_int("serve_rows", sr)
        enc_int("gather_idx", a["gather_idx"])
        derived = (sr <= capacity).astype(np.float32)
        if np.array_equal(derived, a["serve_valid"]):
            fmt["serve_valid"] = "derive"
        else:
            fmt["serve_valid"] = "raw"
            wire["serve_valid"] = (a["serve_valid"],)
        sl = a["serve_slot"]
        whole = (sl >= 0).all() and (sl == np.rint(sl)).all()
        if whole and (sl < 256).all():
            fmt["serve_slot"], wire["serve_slot"] = "u8", (
                sl.astype(np.uint8),)
        elif whole and (sl < 65536).all():
            fmt["serve_slot"], wire["serve_slot"] = "u16", (
                sl.astype(np.uint16),)
        else:
            fmt["serve_slot"], wire["serve_slot"] = "raw", (sl,)
        if trivial:
            fmt["segments"] = "trivial"
            wire["meta"] = (a["meta"],)
        else:
            enc_int("segments", a["segments"])
        nbk, n, b, dd = a["dense"].shape
        q = None
        if float_wire == "q8":
            q = quantize_floats(
                a["dense"].reshape(-1, dd), a["label"].reshape(-1),
                a["show"].reshape(-1), a["clk"].reshape(-1),
                valid=a["show"].reshape(-1) > 0)
        if q is not None:
            block, qmeta = q
            fmt["dense"] = "q8"
            wire["dense"] = (block[:, :-3].reshape(nbk, n, b, dd),)
            wire["qmeta"] = (qmeta,)
            for j, f in enumerate(("label", "show", "clk")):
                fmt[f] = "u8"
                wire[f] = (block[:, dd + j].reshape(nbk, n, b),)
        else:
            for f in ("dense", "label", "show", "clk"):
                fmt[f], wire[f] = "raw", (a[f],)
        self.fmt, self.wire = fmt, wire
        self.serve_rows = sr      # for mark_trained_rows and the live pads

    def _set_live(self, resp_idx: np.ndarray) -> None:
        """The real request positions of each (step, owner) in its
        flattened resp_idx [N*A] (a pad points at the sentinel A2 - 1),
        padded to the pass's widest with 0, and their counts."""
        nbk, n = resp_idx.shape[:2]
        a2 = self.serve_rows.shape[-1]
        flat = resp_idx.reshape(nbk, n, -1)
        real = flat != a2 - 1
        self.live_len = real.sum(-1)
        live = np.zeros((nbk, n, max(1, int(self.live_len.max()))),
                        np.int32)
        for i in range(nbk):
            for s in range(n):
                pos = np.flatnonzero(real[i, s])
                live[i, s, :len(pos)] = pos
        self.live = live

    # ---- staging ----
    def _host_leaves(self):
        """(name, shard, host array) of every staged block of the owned
        shards: the wire's blocks split along the shard axis (qmeta
        replicated), then live."""
        for name, arrs in self.wire.items():
            if name in _HOST_ONLY:
                continue
            for s in self.owned:
                yield name, s, tuple(x if name == "qmeta" else x[:, s]
                                     for x in arrs)
        for s in self.owned:
            yield "live", s, (self.live[:, s],)

    def upload(self, device=None) -> None:
        """Stage the wire on the shards' devices (entry s of the shard
        axis on ``devices[s]``; ``device``, the preloader's, is not
        used). The copies are issued on each device's current stream,
        from pinned buffers, and not waited for (``wait_ready`` orders a
        stream after them, ``settle`` waits on the host). A no-op once
        staged; the issue seconds are ``build_stats["h2d"]``."""
        from paddlebox_tpu_torch.train.device_pass import _Stager
        if self.dev is not None:
            return
        t0 = time.perf_counter()
        stagers = {self.devices[s]: _Stager(self.devices[s])
                   for s in self.owned}
        dev: Dict[str, List] = {}
        n = len(self.devices)
        for name, s, arrs in self._host_leaves():
            st = stagers[self.devices[s]]
            dev.setdefault(name, [None] * n)[s] = tuple(st.put(x)
                                                         for x in arrs)
        self.dev_live = [None if t is None else t[0]
                         for t in dev.pop("live")]
        self.dev = dev
        for d, st in stagers.items():
            ev = st.finish()
            if ev is not None:
                self._ready[d] = ev
            self._pinned += st.pinned
        self.build_stats["h2d"] = time.perf_counter() - t0

    def wait_ready(self, device=None) -> None:
        """Order every shard device's current stream after the pass's
        copies, on the device (the host does not wait), and tell the
        allocator those streams use the staged tensors. ``device`` is
        not used: the pass spans the table's device list."""
        for d, ev in self._ready.items():
            cur = torch.cuda.current_stream(d)
            cur.wait_event(ev)
            for s in self.owned:
                if self.devices[s] == d:
                    for t in self._leaves(s):
                        t.record_stream(cur)

    def settle(self) -> None:
        """Wait on the host until the pass's copies are done, and release
        its pinned buffers."""
        for ev in self._ready.values():
            ev.synchronize()
        self._pinned = []

    def release_host_buffers(self) -> None:
        """Drop the pinned buffers once their copies are done."""
        if all(ev.query() for ev in self._ready.values()):
            self._pinned = []

    def _leaves(self, s: int) -> List[torch.Tensor]:
        out = [t for blocks in self.dev.values() for t in blocks[s]]
        return out + [self.dev_live[s]]

    def nbytes(self) -> int:
        """Bytes staged on the devices (before upload, the wire's host
        bytes that upload stages)."""
        if self.dev is not None:
            return sum(t.numel() * t.element_size()
                       for s in self.owned for t in self._leaves(s))
        return sum(x.nbytes for _, _, arrs in self._host_leaves()
                   for x in arrs)

    def mark_trained_rows(self, table: ShardedEmbeddingTable) -> None:
        """Flag each shard's served rows as touched since the last save,
        AFTER the pass trained (the pads' out-of-bounds ids dropped)."""
        sr = self.serve_rows
        with table.host_lock:
            for s in range(sr.shape[1]):
                rows = np.unique(sr[:, s])
                table._touched[s][rows[rows < table.capacity]] = True


# the GlobalBatch fields a pass stacks (the reference's), and the wire
# blocks that stay on the host
_WIRE_FIELDS = ("resp_idx", "serve_rows", "serve_valid", "serve_slot",
                "gather_idx", "segments", "dense", "label", "show", "clk")
_HOST_ONLY = ("srmeta", "meta")


def _decode_wire_step(rp: ShardedResidentPass, i: int) -> GlobalBatch:
    """Step ``i`` of a staged pass as the step's ``GlobalBatch``, decoded
    on each shard's device from views of the staged blocks and host ints
    (the counterpart of the reference's in-trace ``_decode_wire_step``)."""
    fmt, dev, cap = rp.fmt, rp.dev, rp.capacity
    n = len(rp.devices)

    def dec_int(name, s):
        t = dev[name][s]
        if fmt[name] == "u18":
            return unpack_u16m(t[0][i], t[1][i], 2)
        if fmt[name] == "u24":
            return unpack_u24(t[0][i], t[1][i])
        return t[0][i]

    out: Dict[str, List[Optional[torch.Tensor]]] = {
        f: [None] * n for f in _DEVICE_FIELDS}
    for s in rp.owned:
        if fmt["serve_rows"] == "delta":
            count, base = (int(v) for v in rp.wire["srmeta"][0][i, s])
            d = dev["serve_rows"][s]
            dec = unpack_delta16(d[0][i], d[1][i], d[2][i], base)
            pos = torch.arange(dec.shape[0], dtype=torch.int32,
                               device=dec.device)
            # the pads regenerate as distinct ascending OOB ids
            serve_rows = torch.where(pos < count, dec, cap + 1 + pos)
        else:
            serve_rows = dec_int("serve_rows", s)
        gather_idx = dec_int("gather_idx", s)
        if fmt["serve_valid"] == "derive":
            serve_valid = (serve_rows <= cap).float()
        else:
            serve_valid = dev["serve_valid"][s][0][i]
        sl = dev["serve_slot"][s][0][i]
        serve_slot = (widen_u16(sl) if fmt["serve_slot"] == "u16"
                      else sl).float()
        if fmt["segments"] == "trivial":
            nk, pad_seg = (int(v) for v in rp.wire["meta"][0][i, s])
            pos = torch.arange(gather_idx.shape[0], dtype=torch.int32,
                               device=gather_idx.device)
            segments = torch.where(pos < nk, pos, pad_seg)
        else:
            segments = dec_int("segments", s)
        if fmt["dense"] == "q8":
            qm = dev["qmeta"][s][0]
            dense = (dev["dense"][s][0][i].float() * qm[0][None, :]
                     + qm[1][None, :])
        else:
            dense = dev["dense"][s][0][i]
        lsc = [dev[f][s][0][i].float()[:, None]
               for f in ("label", "show", "clk")]
        out["resp_idx"][s] = dec_int("resp_idx", s)
        out["serve_rows"][s] = serve_rows
        out["serve_valid"][s] = serve_valid
        out["serve_slot"][s] = serve_slot
        out["live"][s] = rp.dev_live[s][i, :int(rp.live_len[i, s])]
        out["gather_idx"][s] = gather_idx
        out["segments"][s] = segments
        out["floats"][s] = torch.cat([dense.float()] + lsc, dim=1)
    return GlobalBatch(key_counts=rp.key_counts[i],
                       serve_counts=rp.serve_counts[i],
                       weight_sum=rp.weight_sums[i],
                       plan_sections=rp.sections, **out)
