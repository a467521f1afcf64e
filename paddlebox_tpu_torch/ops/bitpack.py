"""Wire bit-packing for resident pass uploads — counterpart of
``paddlebox_tpu/ops/bitpack.py``: the host packers (numpy, copied as
they are) and the device unpackers (torch).

The resident pass ships index data whose values need far fewer than 32
bits (unique table rows fit 24 bits at 2^23 rows, per-key positions 18
bits at CTR batch sizes), so the pack splits them into narrow arrays and
the step reassembles them on the device:

  - "u24": uint16 low + uint8 high (3 B/value instead of 4)
  - "u16m": uint16 low + m-bit highs packed 8/m to a byte; "u18" is m=2
  - "u12": value pairs as 3 bytes
  - delta: ascending rows as u8/u16 deltas plus sparse gap exceptions

The unpackers are exact. torch has no full set of uint16 operations on
the card, so a uint16 wire array travels as its int16 view (the same
bytes) and the unpackers widen it with ``& 0xFFFF`` (``widen_u16``);
``as_wire`` makes that view on the host.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def as_wire(a: np.ndarray) -> np.ndarray:
    """The array a host→device copy ships: uint16 as its int16 view (the
    same bytes), everything else unchanged."""
    return a.view(np.int16) if a.dtype == np.uint16 else a


def widen_u16(t: torch.Tensor) -> torch.Tensor:
    """An int16 (uint16-view) or uint8 wire tensor widened to int32."""
    return t.to(torch.int32) & 0xFFFF


def pack_u24(values: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """int array (any shape, values in [0, 2^24)) → (lo uint16, hi uint8)."""
    v = values.astype(np.uint32, copy=False)
    assert v.max(initial=0) < (1 << 24), "pack_u24 range"
    return (v & 0xFFFF).astype(np.uint16), (v >> 16).astype(np.uint8)


def unpack_u24(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """(lo uint16-as-int16, hi uint8) → int32, elementwise."""
    return widen_u16(lo) | (hi.to(torch.int32) << 16)


def pack_delta(values: np.ndarray, num_real: np.ndarray,
               max_exceptions: int, bits: int = 16):
    """Ascending per-row sequences → ``bits``-wide (8 or 16) delta wire.

    ``values`` int [nb, U]; rows must be ASCENDING over their real prefix
    ``num_real[i]`` (checked — returns None on violation, as a negative
    delta would wrap mod 2^bits and silently decode to a wrong value).
    Returns (d uint{bits} [nb, U], epos int32 [nb, E], eext int32 [nb, E])
    — deltas relative to values[:, 0] (the base travels separately), with
    up to E per-row gap exceptions (delta ≥ 2^bits) as position+remainder
    pairs (unused slots: epos = U, eext = 0) — or None when a row needs
    more than E exceptions (caller falls back to a wider encoding).

    Decode contract (:func:`unpack_delta16`): value[j] = base +
    cumsum(d)[j] + Σ_e [j ≥ epos_e] · eext_e for j < num_real."""
    assert bits in (8, 16)
    d = _delta_matrix(values, num_real)
    if d is None:
        return None
    return _pack_delta_from(d, max_exceptions, bits)


def _delta_matrix(values: np.ndarray, num_real: np.ndarray):
    """Per-row deltas over the real prefix (int64 [nb, U]), or None if
    any real-prefix row is not ascending."""
    nb, u_pad = values.shape
    d = np.zeros((nb, u_pad), np.int64)
    d[:, 1:] = values[:, 1:].astype(np.int64) - values[:, :-1].astype(np.int64)
    real = np.arange(u_pad)[None, :] < num_real[:, None]
    d[~real] = 0
    if (d < 0).any():
        return None
    return d


def _pack_delta_from(d: np.ndarray, max_exceptions: int, bits: int):
    nb, u_pad = d.shape
    big = d >= (1 << bits)
    if int(big.sum(axis=1).max(initial=0)) > max_exceptions:
        return None
    dn = d.astype(np.uint8 if bits == 8 else np.uint16)
    epos = np.full((nb, max_exceptions), u_pad, np.int32)
    eext = np.zeros((nb, max_exceptions), np.int32)
    for i in range(nb):
        bj = np.nonzero(big[i])[0]
        epos[i, :len(bj)] = bj
        eext[i, :len(bj)] = (d[i, bj] - dn[i, bj]).astype(np.int64)
    return dn, epos, eext


def pack_delta_auto(values: np.ndarray, num_real: np.ndarray,
                    max_exc8: int, max_exc16: int):
    """One delta scan, narrowest width that fits: u8 wire (≤ max_exc8
    gap exceptions per row), else u16 (≤ max_exc16), else None."""
    d = _delta_matrix(values, num_real)
    if d is None:
        return None
    return (_pack_delta_from(d, max_exc8, 8)
            or _pack_delta_from(d, max_exc16, 16))


def unpack_delta16(d: torch.Tensor, epos: torch.Tensor, eext: torch.Tensor,
                   base: int) -> torch.Tensor:
    """One row of the delta wire (d uint8, or uint16-as-int16) → int32
    [U] absolute values, valid over the real prefix (callers mask the
    tail). The reference adds each exception over a [U, E] comparison;
    here each exception's remainder lands at its position (unused slots,
    epos = U, in a spare bin that is cut off) and rides the same cumsum —
    the same int32 sums, so the same values."""
    u_pad = d.shape[-1]
    step = (d.to(torch.int32) if d.dtype == torch.uint8 else widen_u16(d))
    extra = torch.zeros(u_pad + 1, dtype=torch.int32, device=d.device)
    extra.index_put_((epos.long().clamp(0, u_pad),), eext.to(torch.int32),
                     accumulate=True)
    return base + torch.cumsum(step + extra[:u_pad], 0, dtype=torch.int32)


def pack_u16m(values: np.ndarray, mbits: int
              ) -> Tuple[np.ndarray, np.ndarray]:
    """int array [..., K] (values in [0, 2^(16+m)), m ∈ {1,2,4,8},
    K % (8/m) == 0) → (lo uint16 [..., K], hi uint8 [..., K*m/8] —
    8/m m-bit highs per byte, little-endian within the byte)."""
    assert mbits in (1, 2, 4, 8)
    v = values.astype(np.uint32, copy=False)
    assert v.max(initial=0) < (1 << (16 + mbits)), "pack_u16m range"
    per = 8 // mbits
    assert v.shape[-1] % per == 0, "pack_u16m alignment"
    lo = (v & 0xFFFF).astype(np.uint16)
    hi = (v >> 16).astype(np.uint8)
    h = hi.reshape(*hi.shape[:-1], -1, per)
    packed = np.zeros(h.shape[:-1], np.uint8)
    for j in range(per):
        packed |= h[..., j] << (j * mbits)
    return lo, packed


def unpack_u16m(lo: torch.Tensor, hi: torch.Tensor,
                mbits: int) -> torch.Tensor:
    """(lo uint16-as-int16 [..., K], hi uint8 [..., K*m/8]) → int32
    [..., K]: each high byte's 8/m fields shifted out at once."""
    per = 8 // mbits
    shifts = torch.arange(per, dtype=torch.int32, device=hi.device) * mbits
    h = (hi.to(torch.int32)[..., None] >> shifts) & ((1 << mbits) - 1)
    return widen_u16(lo) | (h.reshape(lo.shape) << 16)


def pack_u12(values: np.ndarray) -> Tuple[np.ndarray]:
    """int array [..., K] (values in [0, 2^12), K % 2 == 0) → one uint8
    stream [..., K*3/2]: value pairs ride as 3 bytes (lo8_a,
    hi4_a | lo4_b<<4, hi8_b) — slot-local rows of vocabularies of a few
    thousand entries fit 12 bits."""
    v = values.astype(np.uint32, copy=False)
    assert v.max(initial=0) < (1 << 12), "pack_u12 range"
    assert v.shape[-1] % 2 == 0, "pack_u12 alignment"
    p = v.reshape(*v.shape[:-1], -1, 2)
    out = np.empty((*p.shape[:-1], 3), np.uint8)
    out[..., 0] = p[..., 0] & 0xFF
    out[..., 1] = ((p[..., 0] >> 8) & 0xF) | ((p[..., 1] & 0xF) << 4)
    out[..., 2] = (p[..., 1] >> 4) & 0xFF
    return (out.reshape(*v.shape[:-1], -1),)


def unpack_u12(b: torch.Tensor) -> torch.Tensor:
    """uint8 [..., K*3/2] → int32 [..., K]."""
    t = b.reshape(*b.shape[:-1], -1, 3).to(torch.int32)
    a = t[..., 0] | ((t[..., 1] & 0xF) << 8)
    c = (t[..., 1] >> 4) | (t[..., 2] << 4)
    return torch.stack([a, c], dim=-1).reshape(*b.shape[:-1], -1)


def pack_u18(values: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """18-bit :func:`pack_u16m`."""
    return pack_u16m(values, 2)


def unpack_u18(lo: torch.Tensor, hi2: torch.Tensor) -> torch.Tensor:
    """(lo uint16-as-int16 [K], hi2 uint8 [K/4]) → int32 [K]."""
    return unpack_u16m(lo, hi2, 2)
