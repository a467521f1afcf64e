"""Tensor, pipeline, expert and context parallelism over
``torch.distributed`` process groups — counterpart of
``paddlebox_tpu/parallel/``. A mesh axis is a ``collectives.Axis``; the
functions run on every rank of it, each on its own block."""

from paddlebox_tpu_torch.parallel.mesh import make_mesh, data_axis_size
from paddlebox_tpu_torch.parallel.layers import (
    vocab_parallel_embedding, column_parallel_linear, row_parallel_linear,
    pipeline_run,
    pipeline_train_step,
)
from paddlebox_tpu_torch.parallel.moe import (
    moe_forward_local, moe_forward_sharded, naive_gating, top1_gating,
    top2_gating,
)
from paddlebox_tpu_torch.parallel.ring_attention import (
    make_context_parallel_attention, reference_attention, ring_attention,
    ulysses_attention,
)

__all__ = [
    "make_mesh", "data_axis_size", "vocab_parallel_embedding",
    "column_parallel_linear", "row_parallel_linear", "pipeline_run",
    "pipeline_train_step",
    "moe_forward_local", "moe_forward_sharded", "naive_gating",
    "top1_gating", "top2_gating",
    "make_context_parallel_attention", "reference_attention",
    "ring_attention", "ulysses_attention",
]
