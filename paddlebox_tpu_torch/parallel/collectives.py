"""The port's counterparts of the ``jax.lax`` collectives that the JAX
package's ``parallel/`` modules and ``graph.py`` call inside
``shard_map``.

A mesh axis of the JAX package is a name that ``shard_map`` binds; here
it is an :class:`Axis`: a ``torch.distributed`` process group, one rank
process a device. A function that the JAX package calls inside
``shard_map`` is, in the port, a function that every rank of the axis
calls on its own local block.

Every collective that carries a gradient is a ``torch.autograd.Function``
whose backward is JAX's transpose of it:

=======================  ================  ========================
JAX                      here              backward
=======================  ================  ========================
``psum``                 ``psum``          the identity
``all_gather(tiled)``    ``all_gather``    ``psum_scatter``
``psum_scatter(tiled)``  ``psum_scatter``  ``all_gather``
``all_to_all(tiled)``    ``all_to_all``    the inverse all-to-all
``ppermute``             ``ppermute``      the inverse permutation
``axis_index``           ``Axis.rank``     --
``psum(1)``              ``Axis.size``     --
=======================  ================  ========================

``psum``'s backward is the identity on each rank, as under ``shard_map``:
the cotangent of a replicated result reaches each rank's partial
unchanged (``torch.distributed.nn``'s all-reduce sums the cotangents as
well, which would scale every gradient by the axis size).

On a world of one every call is a copy and sends nothing. Every rank of
an axis must issue its collectives in the same order, in the forward and
in the backward: the same program on every rank gives both (autograd runs
the backward of one graph in one order).

Transport: ``nccl`` moves CUDA tensors directly; ``gloo`` moves CPU
tensors, so on a card (``Axis.staged``) every block goes through pinned
host memory on the current stream. ``Axis.nbytes`` counts the bytes this
rank sent to the other ranks (``exchanged``) and the bytes it copied
between the card and pinned memory (``staged``). ``train/multihost.Pod``
is an ``Axis`` with shard fields, so the sharded step moves and counts
its blocks the same way.
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple

import torch

from paddlebox_tpu_torch.device import resolve_device


class Axis:
    """One mesh axis: the process group ``group`` (None: the default
    group), its ``name``, this rank's ``rank`` of ``size``, and the
    ``device`` its tensors live on (default: the rank's card; under
    ``nccl`` the current device)."""

    def __init__(self, group=None, name: str = "dp",
                 device: Optional[Any] = None) -> None:
        import torch.distributed as dist
        if not (dist.is_available() and dist.is_initialized()):
            raise RuntimeError(
                "a mesh axis needs a process group: call "
                "distributed.launch.init_runtime_env() (with "
                "PBOX_TORCH_DISTRIBUTED=1) or init_process_group first")
        self.group = group
        self.name = name
        self.rank = dist.get_rank(group)
        self.size = dist.get_world_size(group)
        self.backend = dist.get_backend(group)
        if device is None:
            device = (f"cuda:{torch.cuda.current_device()}"
                      if self.backend == "nccl" else "cuda")
        self.device = resolve_device(device)
        if self.backend == "nccl" and self.device.type != "cuda":
            raise ValueError("an nccl process group moves CUDA tensors: "
                             f"device {self.device} is not a card")
        # the members' ranks in the default group, in this group's order
        # (point-to-point ops name their peer by its global rank)
        self.ranks = ([dist.get_global_rank(group, r)
                       for r in range(self.size)] if group is not None
                      else list(range(self.size)))
        self.staged = self.backend == "gloo" and self.device.type == "cuda"
        self.nbytes = {"exchanged": 0, "staged": 0}

    # ---- transport (no autograd) ---------------------------------------
    def _out(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` as the collective sends it: contiguous; staged, a pinned
        host copy, complete when this returns (the copy is queued on the
        current stream, which is then waited for)."""
        t = t.contiguous()
        if not self.staged:
            return t
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        h.copy_(t, non_blocking=True)
        torch.cuda.current_stream(t.device).synchronize()
        self.nbytes["staged"] += t.numel() * t.element_size()
        return h

    def _buf(self, shape, dtype, like: torch.Tensor) -> torch.Tensor:
        if self.staged:
            return torch.empty(tuple(shape), dtype=dtype, pin_memory=True)
        return torch.empty(tuple(shape), dtype=dtype, device=like.device)

    def _in(self, h: torch.Tensor) -> torch.Tensor:
        """What a collective received, on ``device`` (staged: copied
        from pinned memory on the current stream)."""
        if not self.staged:
            return h
        self.nbytes["staged"] += h.numel() * h.element_size()
        return h.to(self.device, non_blocking=True)

    def _sent(self, t: torch.Tensor, num: int, den: int = 1) -> None:
        """Count ``num / den`` of ``t``'s bytes as sent (rounded down)."""
        self.nbytes["exchanged"] += t.numel() * t.element_size() * num // den

    def all_reduce_raw(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of every rank's ``t`` (a new tensor)."""
        import torch.distributed as dist
        if self.size == 1:
            return t.clone()
        # all_reduce writes in place: the send buffer is a copy either way
        buf = self._out(t) if self.staged else \
            t.clone(memory_format=torch.contiguous_format)
        # a ring all-reduce sends 2 (n - 1) / n of the bytes
        self._sent(t, 2 * (self.size - 1), self.size)
        dist.all_reduce(buf, group=self.group)
        return self._in(buf)

    def all_gather_raw(self, t: torch.Tensor) -> torch.Tensor:
        """[size, *t.shape]: every rank's ``t`` in rank order."""
        import torch.distributed as dist
        if self.size == 1:
            return t.clone()[None]
        h = self._out(t)
        out = self._buf((self.size,) + tuple(t.shape), t.dtype, t)
        self._sent(t, self.size - 1)
        dist.all_gather(list(out.unbind(0)), h, group=self.group)
        return self._in(out)

    def all_to_all_raw(self, send: torch.Tensor) -> torch.Tensor:
        """``send`` [size, ...]: block q goes to rank q; returns [size, ...]
        with block p from rank p."""
        import torch.distributed as dist
        if self.size == 1:
            return send.clone()
        h = self._out(send)
        out = self._buf(h.shape, h.dtype, send)
        self._sent(send, self.size - 1, self.size)
        dist.all_to_all_single(out, h, group=self.group)
        return self._in(out)

    def ppermute_raw(self, t: torch.Tensor,
                     perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
        """``t`` sent along ``perm`` ((source, destination) pairs of axis
        ranks, each rank at most once on either side); a rank that
        receives nothing gets zeros."""
        import torch.distributed as dist
        dst = [d for s, d in perm if s == self.rank]
        src = [s for s, d in perm if d == self.rank]
        if len(dst) > 1 or len(src) > 1:
            raise ValueError(f"rank {self.rank} appears more than once in "
                             f"the permutation {list(perm)}")
        if not src and not dst:
            return torch.zeros_like(t)
        if src == [self.rank] and dst == [self.rank]:
            return t.clone()
        ops = []
        if dst and dst[0] != self.rank:
            h = self._out(t)
            self._sent(t, 1)
            ops.append(dist.P2POp(dist.isend, h, self.ranks[dst[0]],
                                  group=self.group))
        out = None
        if src and src[0] != self.rank:
            out = self._buf(t.shape, t.dtype, t)
            ops.append(dist.P2POp(dist.irecv, out, self.ranks[src[0]],
                                  group=self.group))
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return torch.zeros_like(t) if out is None else self._in(out)

    def all_gather_object(self, obj) -> list:
        """Every rank's picklable ``obj`` in rank order."""
        import torch.distributed as dist
        out: list = [None] * self.size
        dist.all_gather_object(out, obj, group=self.group)
        return out

    def broadcast_(self, t: torch.Tensor, src: int = 0) -> None:
        """``t`` in place from rank ``src``."""
        import torch.distributed as dist
        with torch.no_grad():
            buf = self._out(t)
            dist.broadcast(buf, src, group=self.group)
            if self.staged:
                t.copy_(self._in(buf))
            elif buf.data_ptr() != t.data_ptr():
                t.copy_(buf)

    def barrier(self) -> None:
        import torch.distributed as dist
        dist.barrier(group=self.group)


# ---- the tiled shapes, on top of the transport ------------------------
def _gather_tiled(x: torch.Tensor, axis: Axis, dim: int) -> torch.Tensor:
    return torch.cat(list(axis.all_gather_raw(x).unbind(0)), dim=dim)


def _scatter_tiled(x: torch.Tensor, axis: Axis, dim: int) -> torch.Tensor:
    n = axis.size
    xs = x.movedim(dim, 0)
    if xs.shape[0] % n:
        raise ValueError(f"dimension {dim} of size {xs.shape[0]} does not "
                         f"split over {n} ranks")
    blocks = xs.reshape((n, xs.shape[0] // n) + tuple(xs.shape[1:]))
    # block q of every rank reaches rank q, which sums them in rank order
    got = axis.all_to_all_raw(blocks).sum(0)
    return got.movedim(0, dim)


def _a2a_tiled(x: torch.Tensor, axis: Axis, split: int,
               concat: int) -> torch.Tensor:
    n = axis.size
    split %= x.dim()
    concat %= x.dim()
    xs = x.movedim(split, 0)
    if xs.shape[0] % n:
        raise ValueError(f"dimension {split} of size {xs.shape[0]} does not "
                         f"split over {n} ranks")
    send = xs.reshape((n, xs.shape[0] // n) + tuple(xs.shape[1:]))
    recv = axis.all_to_all_raw(send)
    return torch.cat([b.movedim(0, split) for b in recv.unbind(0)],
                     dim=concat)


def _inverse(perm: Sequence[Tuple[int, int]]) -> List[Tuple[int, int]]:
    return [(d, s) for s, d in perm]


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return axis.all_reduce_raw(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return _gather_tiled(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return _scatter_tiled(g, ctx.axis, ctx.dim), None, None


class _PsumScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return _scatter_tiled(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return _gather_tiled(g, ctx.axis, ctx.dim), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, split, concat):
        ctx.axis, ctx.split, ctx.concat = axis, split, concat
        return _a2a_tiled(x, axis, split, concat)

    @staticmethod
    def backward(ctx, g):
        return (_a2a_tiled(g, ctx.axis, ctx.concat, ctx.split),
                None, None, None)


class _Ppermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, perm):
        ctx.axis, ctx.perm = axis, perm
        return axis.ppermute_raw(x, perm)

    @staticmethod
    def backward(ctx, g):
        return ctx.axis.ppermute_raw(g, _inverse(ctx.perm)), None, None


def psum(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """``jax.lax.psum``: the sum over the axis; backward the identity."""
    return _Psum.apply(x, axis)


def pmean(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """``jax.lax.pmean``: the mean over the axis."""
    return psum(x, axis) / axis.size


def all_gather(x: torch.Tensor, axis: Axis, dim: int = 0) -> torch.Tensor:
    """``jax.lax.all_gather(x, axis, axis=dim, tiled=True)``: every rank's
    ``x`` concatenated along ``dim`` in rank order."""
    return _AllGather.apply(x, axis, dim)


def psum_scatter(x: torch.Tensor, axis: Axis, dim: int = 0
                 ) -> torch.Tensor:
    """``jax.lax.psum_scatter(x, axis, scatter_dimension=dim,
    tiled=True)``: block ``rank`` (along ``dim``) of the sum over the
    axis. Each block goes to its rank by one all-to-all and is summed
    there in rank order (gloo has no reduce-scatter)."""
    return _PsumScatter.apply(x, axis, dim)


def all_to_all(x: torch.Tensor, axis: Axis, split_axis: int,
               concat_axis: int) -> torch.Tensor:
    """``jax.lax.all_to_all(x, axis, split_axis, concat_axis,
    tiled=True)``: block q of ``x`` along ``split_axis`` goes to rank q;
    the blocks received are concatenated along ``concat_axis`` in rank
    order. One ``all_to_all_single`` over a reshaped view."""
    return _AllToAll.apply(x, axis, split_axis, concat_axis)


def ppermute(x: torch.Tensor, axis: Axis,
             perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """``jax.lax.ppermute``: ``x`` sent along ``perm`` ((source,
    destination) pairs); one ``batch_isend_irecv`` a call. A rank that
    receives nothing gets zeros."""
    return _Ppermute.apply(x, axis, tuple(tuple(p) for p in perm))
