"""Tensor- and pipeline-parallel building blocks — counterpart of
``paddlebox_tpu/parallel/layers.py``.

Reference: ``VocabParallelEmbedding``, ``ColumnParallelLinear``,
``RowParallelLinear`` (mp_layers.py) and the pipeline engine
(``PipelineLayer`` + section_worker.cc scope queues).

The layers are plain functions that every rank of a model axis calls on
its own weight shard (the JAX package calls them inside ``shard_map``);
the reference's c_allreduce / c_concat ops are the differentiable
``psum`` / ``all_gather`` of ``collectives``. The pipeline is a GPipe
schedule as a Python loop of ticks with a ``ppermute`` ring between the
stage ranks; autograd runs the backward pipeline through the
permutations' inverses.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from paddlebox_tpu_torch.parallel.collectives import (Axis, all_gather,
                                                      ppermute, psum)

MODEL_AXIS = "mp"
PIPE_AXIS = "pp"


def vocab_parallel_embedding(ids: torch.Tensor, weight_shard: torch.Tensor,
                             axis: Axis) -> torch.Tensor:
    """Vocab-sharded embedding lookup (VocabParallelEmbedding).

    weight_shard: [vocab/P, dim] — this rank's contiguous vocab range.
    Out-of-range ids contribute zero locally; a psum assembles the full
    lookup."""
    per = weight_shard.shape[0]
    local = ids.long() - axis.rank * per
    ok = (local >= 0) & (local < per)
    rows = weight_shard[local.clamp(0, per - 1)]
    rows = rows * ok[..., None].to(rows.dtype)
    return psum(rows, axis)


def column_parallel_linear(x: torch.Tensor, weight_shard: torch.Tensor,
                           bias_shard: Optional[torch.Tensor] = None,
                           gather_output: bool = True, *,
                           axis: Axis) -> torch.Tensor:
    """Column-split linear (ColumnParallelLinear): weight [in, out/P];
    each rank computes its output columns. gather_output=True all-gathers
    to the full [.., out] (c_concat), else the result stays
    column-sharded for a following row-parallel layer."""
    y = x @ weight_shard
    if bias_shard is not None:
        y = y + bias_shard
    if gather_output:
        y = all_gather(y, axis, -1)
    return y


def row_parallel_linear(x_shard: torch.Tensor, weight_shard: torch.Tensor,
                        bias: Optional[torch.Tensor] = None, *,
                        axis: Axis) -> torch.Tensor:
    """Row-split linear (RowParallelLinear): weight [in/P, out]; input
    arrives column-sharded (from a gather_output=False column layer);
    partial products reduce with psum (c_allreduce_sum). Bias is full
    [out], added once after the reduce."""
    y = psum(x_shard @ weight_shard, axis)
    if bias is not None:
        y = y + bias
    return y


def pipeline_run(stage_fn: Callable, stage_params, x_micros: torch.Tensor,
                 axis: Axis) -> torch.Tensor:
    """GPipe schedule over the pipeline axis, run by every stage rank.

    stage_fn(params, act) -> act: one stage's compute (shape-preserving
    across stages). stage_params: this rank's stage weights. x_micros:
    [M, mb, d] microbatched input (read on stage 0). Returns [M, mb, d]:
    the last stage's outputs (zeros elsewhere; psum to collect).

    Tick t: stage i computes microbatch m = t − i (when 0 ≤ m < M), then
    the activations ppermute one hop down the ring. Differentiable:
    every step is a torch op with a backward, and every rank's graph has
    the same collectives (rank 0 selects its input with ``torch.where``,
    so the activation it received stays in its graph and its backward
    sends), so ``backward`` runs the reverse pipeline."""
    s = axis.size
    i = axis.rank
    m_count = x_micros.shape[0]
    ticks = m_count + s - 1
    dev = x_micros.device
    first = torch.tensor(i == 0, device=dev)
    perm = [(j, (j + 1) % s) for j in range(s)]
    act = torch.zeros_like(x_micros[0])
    out = torch.zeros_like(x_micros)
    for t in range(ticks):
        inp = torch.where(first, x_micros[min(t, m_count - 1)], act)
        y = stage_fn(stage_params, inp)
        m = t - (s - 1)
        valid = i == s - 1 and 0 <= m < m_count
        slot = torch.tensor([min(max(m, 0), m_count - 1)], device=dev)
        out = torch.where(torch.tensor(valid, device=dev),
                          out.index_put((slot,), y[None]), out)
        if t < ticks - 1:      # the last tick's rotation feeds nothing
            act = ppermute(y, axis, perm)
    # only the last stage holds real outputs; mask so callers can psum
    return out * float(i == s - 1)


def pipeline_train_step(stage_fn: Callable, loss_fn: Callable,
                        stage_params, x_micros: torch.Tensor,
                        y_micros: torch.Tensor, axis: Axis):
    """One training step through the pipeline: the forward GPipe
    schedule, the loss on the last stage's microbatch outputs, the
    backward through the schedule. Returns ``(loss, grads)`` as
    ``jax.value_and_grad`` does: ``loss`` the psum of the loss masked to
    the last stage (every rank gets the true loss), ``grads`` shaped like
    ``stage_params`` (a tensor or a tuple of tensors; this rank's stage
    weights). loss_fn(out, y) -> scalar mean loss, written as if
    single-device. Mathematically identical to sequential training on the
    concatenated microbatches."""
    single = isinstance(stage_params, torch.Tensor)
    leaves = tuple(p.detach().requires_grad_(True)
                   for p in ((stage_params,) if single else stage_params))
    with torch.enable_grad():
        out = pipeline_run(stage_fn, leaves[0] if single else leaves,
                           x_micros, axis)
        last = torch.tensor(axis.rank == axis.size - 1,
                            device=x_micros.device)
        # out is zero off the last stage; mask the loss there too so a
        # mean-style loss_fn's constant terms do not psum in
        loss = torch.where(last, loss_fn(out, y_micros),
                           torch.zeros((), device=x_micros.device))
        total = psum(loss, axis)
        grads = torch.autograd.grad(total, leaves)
    return total.detach(), grads[0] if single else grads
