"""Host-side collectives over the TCP mesh — the MPI metric allreduce.
(Copy of ``paddlebox_tpu/distributed/collective.py``.)

Reference: BasicAucCalculator's cross-worker reduce
(fleet/metrics.cc:288-304): every trainer allreduces its 1e6-bucket
pos/neg tables plus the scalar error sums over MPI before computing one
GLOBAL AUC (``metrics.auc_compute_global``). Device collectives cover
tensors; this plane covers the MULTI-PROCESS world (launcher +
TcpShuffler ranks), where metric state lives in host numpy between
passes."""

from __future__ import annotations

import struct
from typing import List, Sequence

import numpy as np

from paddlebox_tpu_torch.distributed.shuffle import TcpMesh


class TcpCollective(TcpMesh):
    """allreduce over host float arrays on the full TCP mesh. Small
    worlds (CPU trainer fleets): allgather + local sum, one round."""

    def allreduce_sum(self, arrays: Sequence[np.ndarray]
                      ) -> List[np.ndarray]:
        blob = _pack(arrays)
        inbox = self.exchange_bytes(
            {dst: blob for dst in range(self.world) if dst != self.rank})
        # fold in FIXED rank order (own contribution at its own rank) so
        # the f64 sums — and anything decided from them — are
        # bit-identical on every rank
        mine = [np.asarray(a, np.float64) for a in arrays]
        out = [np.zeros_like(a) for a in mine]
        for src in range(self.world):
            theirs = mine if src == self.rank else _unpack(inbox[src])
            for acc, t in zip(out, theirs):
                if acc.shape != t.shape:
                    raise ValueError(
                        f"allreduce shape mismatch vs rank {src}: "
                        f"{acc.shape} != {t.shape}")
                acc += t
        return out


def _pack(arrays: Sequence[np.ndarray]) -> bytes:
    parts = [struct.pack("<i", len(arrays))]
    for a in arrays:
        # NOT ascontiguousarray: it promotes 0-d scalars to 1-d and the
        # shape must round-trip exactly for the allreduce shape check
        a = np.asarray(a, np.float64, order="C")
        parts.append(struct.pack("<i", a.ndim))
        parts.append(struct.pack(f"<{a.ndim}q", *a.shape))
        parts.append(a.tobytes())
    return b"".join(parts)


def _unpack(buf: bytes) -> List[np.ndarray]:
    (n,) = struct.unpack_from("<i", buf, 0)
    pos = 4
    out = []
    for _ in range(n):
        (ndim,) = struct.unpack_from("<i", buf, pos)
        pos += 4
        shape = struct.unpack_from(f"<{ndim}q", buf, pos)
        pos += 8 * ndim
        size = int(np.prod(shape)) if ndim else 1
        out.append(np.frombuffer(buf, np.float64, size, pos)
                   .reshape(shape).copy())
        pos += 8 * size
    return out
