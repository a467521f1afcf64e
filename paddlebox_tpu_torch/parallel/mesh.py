"""Mesh axes over ``torch.distributed`` — counterpart of
``paddlebox_tpu/parallel/mesh.py``.

The reference collapses the reference system's NCCL rings, MPI and Gloo
stacks into XLA collectives over one ``jax`` Mesh. The port's mesh axis
is a process group (``collectives.Axis``): one rank process a device, the
``dp`` axis the default group, a two-level ``[dcn, ici]`` mesh two
families of sub-groups.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from paddlebox_tpu_torch.parallel.collectives import (Axis, all_gather,
                                                      psum, psum_scatter)

DATA_AXIS = "dp"
ICI_AXIS = "ici"   # chips within a slice (fast interconnect)
DCN_AXIS = "dcn"   # across slices/pods (data-center network)


def make_mesh(group=None, axis_name: str = DATA_AXIS,
              device: Optional[Any] = None) -> Axis:
    """The ``axis_name`` axis over ``group`` (None: the default group,
    every rank): this rank's :class:`Axis`. Where the reference takes the
    first ``n_devices`` devices, the port takes a group of those ranks
    (``torch.distributed.new_group``)."""
    return Axis(group, axis_name, device)


def data_axis_size(axis: Axis) -> int:
    return axis.size


def make_hierarchical_mesh(n_slices: int,
                           devices_per_slice: Optional[int] = None,
                           device: Optional[Any] = None
                           ) -> Tuple[Axis, Axis]:
    """The 2-level ``[dcn, ici]`` mesh over the default group: rank
    ``r`` sits at slice ``r // per``, position ``r % per``. Returns this
    rank's ``(dcn, ici)`` axes: ``ici`` the ranks of its slice, ``dcn``
    the ranks at its position in every slice. Every rank creates every
    sub-group, in the same order (``new_group`` is collective), so every
    rank of the default group calls this."""
    import torch.distributed as dist
    world = dist.get_world_size()
    per = devices_per_slice or world // n_slices
    if n_slices * per != world:
        raise ValueError(f"a {n_slices} x {per} mesh needs {n_slices * per} "
                         f"ranks; the group has {world}")
    me = dist.get_rank()
    ici = dcn = None
    for s in range(n_slices):
        g = dist.new_group([s * per + j for j in range(per)])
        if me // per == s:
            ici = g
    for j in range(per):
        g = dist.new_group([s * per + j for s in range(n_slices)])
        if me % per == j:
            dcn = g
    return Axis(dcn, DCN_AXIS, device), Axis(ici, ICI_AXIS, device)


def hierarchical_allreduce(x: torch.Tensor, ici: Axis,
                           dcn: Axis) -> torch.Tensor:
    """Bandwidth-optimal 2-level all-reduce: pad to a multiple of the ICI
    size, reduce-scatter over ICI, all-reduce the 1/n_ici part over DCN,
    all-gather over ICI (the reference's ncclReduceScatter →
    ``BoxWrapper::SyncDense`` → ncclAllGather ladder), so the slow DCN hop
    carries only 1/n_ici of the bytes."""
    n = ici.size
    flat = x.reshape(-1)
    pad = (-flat.numel()) % n
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    part = psum_scatter(flat, ici, 0)
    part = psum(part, dcn)
    out = all_gather(part, ici, 0)
    return out[:x.numel()].reshape(x.shape)
