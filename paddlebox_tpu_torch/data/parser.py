"""Text parsers: line → SlotRecord, and file → columnar arrays (copy of
``paddlebox_tpu/data/parser.py``).

Reference: paddle/fluid/framework/data_feed.{h,cc} — ``MultiSlotDataFeed``
text format parsing (data_feed.cc) and the plugin parser API
``CustomParser``/``ISlotParser`` loaded via dlopen (data_feed.h:450,:1984,
``DLManager`` :698). Parsers are registered python callables (a custom
parser is just an imported class); the bulk fast path of the slot_text and
criteo formats is the port's native library (``native/slot_parser.cpp``).

Unlike the reference, a native library that cannot be built does not turn
the bulk path into a per-line fallback: ``native.load()`` raises with the
compiler's output. The per-line route runs only where the reference's
dataset takes it by choice (see ``data/dataset.py``).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Type

import numpy as np

from paddlebox_tpu_torch.data.record import SlotRecord
from paddlebox_tpu_torch.data.schema import DataFeedDesc

_HEXDIGITS = set("0123456789abcdefABCDEF")


class BaseParser:
    """Parse one text line into a SlotRecord (None = drop the line)."""

    def __init__(self, desc: DataFeedDesc) -> None:
        self.desc = desc

    def parse(self, line: str) -> Optional[SlotRecord]:
        raise NotImplementedError

    def parse_file_columnar(self, path: str) -> Optional[dict]:
        """Bulk fast path: parse a whole file straight into columnar
        arrays (native/slot_parser.cpp), bypassing per-line python and
        SlotRecord objects. Returns a dict with keys / key_slot /
        offsets / dense / label / show / clk / dropped, or None when the
        format has no native fast path (the caller parses per line)."""
        return None


def _slot_text_spec(desc: DataFeedDesc) -> np.ndarray:
    """Compact slot spec for native slot_text_parse: per slot (kind, dim);
    kinds: 0 sparse, 1 dense, 2 label, 3 show, 4 clk, 5 skip."""
    spec = np.zeros((len(desc.slots), 2), np.int32)
    for i, slot in enumerate(desc.slots):
        if slot.type == "uint64":
            spec[i, 0] = 0 if slot.is_used else 5
        elif slot.name == desc.label_slot:
            spec[i, 0] = 2
        elif slot.name == desc.show_slot:
            spec[i, 0] = 3
        elif slot.name == desc.clk_slot:
            spec[i, 0] = 4
        elif slot.is_used:
            spec[i, 0] = 1
            spec[i, 1] = slot.dim
        else:
            spec[i, 0] = 5
    return spec


def _native_lib():
    """The port's native library; raises when it cannot be built."""
    from paddlebox_tpu_torch import native
    return native.load()


def _read_bytes(path: str) -> bytes:
    with open(path, "rb") as fh:
        return fh.read()


def _line_count(buf: bytes) -> int:
    n = buf.count(b"\n")
    return n + (1 if buf and not buf.endswith(b"\n") else 0)


def _bulk_slot_text_parse(fn, desc: DataFeedDesc,
                          path: str) -> Optional[dict]:
    """Shared caller of the bulk columnar C ABI (slot_text_parse
    signature — native lib or user plugin .so): buffer sizing, the
    retry-on-key-arena-overflow loop (n == -1 → double), result slicing."""
    import ctypes
    buf = _read_bytes(path)
    max_rec = buf.count(b"\n") + 1
    spec = _slot_text_spec(desc)
    dense_dim = desc.dense_dim
    key_cap = max(1024, max_rec * max(1, len(desc.sparse_slots)))
    while True:
        keys = np.empty(key_cap, np.uint64)
        key_slot = np.empty(key_cap, np.int32)
        offs = np.empty(max_rec + 1, np.int64)
        dense = np.empty((max_rec, dense_dim), np.float32)
        label = np.empty(max_rec, np.float32)
        show = np.empty(max_rec, np.float32)
        clk = np.empty(max_rec, np.float32)
        ptr = lambda a: a.ctypes.data_as(ctypes.c_void_p)
        n = fn(ctypes.c_char_p(buf), ctypes.c_int64(len(buf)), ptr(spec),
               ctypes.c_int64(len(desc.slots)), ctypes.c_int64(dense_dim),
               ctypes.c_int64(max_rec), ctypes.c_int64(key_cap),
               ptr(keys), ptr(key_slot), ptr(offs), ptr(dense),
               ptr(label), ptr(show), ptr(clk))
        if n == -1:  # key arena overflowed: double and retry
            key_cap *= 2
            continue
        n = int(n)
        nk = int(offs[n])
        return dict(keys=keys[:nk].copy(),
                    key_slot=key_slot[:nk].copy(),
                    offsets=offs[:n + 1].copy(),
                    dense=dense[:n].copy(), label=label[:n].copy(),
                    show=show[:n].copy(), clk=clk[:n].copy(),
                    dropped=_line_count(buf) - n)


class _NativeSlotTextMixin:
    """parse_file_columnar via native slot_text_parse."""

    def parse_file_columnar(self, path: str) -> Optional[dict]:
        return _bulk_slot_text_parse(_native_lib().slot_text_parse,
                                     self.desc, path)


class _NativeCriteoMixin:
    """parse_file_columnar via native criteo_parse."""

    def parse_file_columnar(self, path: str) -> Optional[dict]:
        import ctypes
        lib = _native_lib()
        buf = _read_bytes(path)
        max_rec = buf.count(b"\n") + 1
        keys = np.empty((max_rec, 26), np.uint64)
        dense = np.empty((max_rec, 13), np.float32)
        label = np.empty(max_rec, np.float32)
        ptr = lambda a: a.ctypes.data_as(ctypes.c_void_p)
        n = int(lib.criteo_parse(buf, len(buf), max_rec, ptr(keys),
                                 ptr(dense), ptr(label)))
        label = label[:n].copy()
        return dict(
            keys=keys[:n].reshape(-1).copy(),
            key_slot=np.tile(np.arange(26, dtype=np.int32), n),
            offsets=np.arange(n + 1, dtype=np.int64) * 26,
            dense=dense[:n].copy(), label=label,
            show=np.ones(n, np.float32), clk=label.copy(),
            dropped=_line_count(buf) - n)


class SlotTextParser(_NativeSlotTextMixin, BaseParser):
    """Generic multi-slot text format, one record per line:

        <num> v0 v1 ... <num> v0 ...        (one group per slot, schema order)

    — the ``MultiSlotDataFeed`` wire format (data_feed.cc text path). Sparse
    slot values are uint64 feasigns; float slot groups must carry exactly
    ``dim`` values. The slot named by desc.label_slot feeds ``label``;
    show/clk slots likewise if configured.
    """

    def parse(self, line: str) -> Optional[SlotRecord]:
        toks = line.split()
        desc = self.desc
        pos = 0
        sparse_chunks: List[np.ndarray] = []
        offsets = [0]
        dense_parts: List[float] = []
        label = show = clk = None
        try:
            for slot in desc.slots:
                n = int(toks[pos]); pos += 1
                vals = toks[pos:pos + n]; pos += n
                if len(vals) != n:
                    return None
                if slot.type == "uint64":
                    if slot.is_used:
                        arr = np.array(vals, dtype=np.uint64)
                        sparse_chunks.append(arr)
                        offsets.append(offsets[-1] + n)
                else:
                    fvals = [float(v) for v in vals]
                    if slot.name == desc.label_slot:
                        label = fvals[0] if fvals else 0.0
                    elif slot.name == desc.show_slot:
                        show = fvals[0] if fvals else 1.0
                    elif slot.name == desc.clk_slot:
                        clk = fvals[0] if fvals else 0.0
                    elif slot.is_used:
                        if len(fvals) != slot.dim:
                            return None
                        dense_parts.extend(fvals)
        except (ValueError, IndexError, OverflowError):
            # OverflowError: negative/oversized tokens in a uint64 slot —
            # drop the line (the native parser rejects them the same way)
            return None
        keys = (np.concatenate(sparse_chunks) if sparse_chunks
                else np.empty(0, dtype=np.uint64))
        return SlotRecord(
            keys=keys,
            slot_offsets=np.array(offsets, dtype=np.int32),
            dense=np.array(dense_parts, dtype=np.float32),
            label=0.0 if label is None else label,
            show=1.0 if show is None else show,
            clk=(label if clk is None and label is not None else (clk or 0.0)),
        )


class CriteoParser(_NativeCriteoMixin, BaseParser):
    """Criteo display-ads TSV: label \\t I1..I13 \\t C1..C26 (hex).

    Dense ints get the standard log(x+1) transform; missing dense → 0;
    missing categorical → slot-salted sentinel key. Each categorical value is
    salted with its slot index so ids don't collide across slots in a single
    shared table (the reference keeps per-slot feasign spaces; we fold the
    slot id into the key's high bits instead — one unified key space is the
    layout for a single sharded table)."""

    _SLOT_SHIFT = 52  # 26 slots fit in high bits; low 52 bits hash payload

    def parse(self, line: str) -> Optional[SlotRecord]:
        f = line.rstrip("\n").split("\t")
        if len(f) != 40:
            return None
        try:
            label = float(f[0])
        except ValueError:
            return None
        dense = np.zeros(13, dtype=np.float32)
        for i in range(13):
            v = f[1 + i]
            if v:
                try:
                    dense[i] = np.log1p(max(float(v), 0.0))
                except ValueError:
                    pass
        keys = np.empty(26, dtype=np.uint64)
        mask = (np.uint64(1) << np.uint64(self._SLOT_SHIFT)) - np.uint64(1)
        hexdigits = _HEXDIGITS
        for i in range(26):
            v = f[14 + i]
            # strict bare-hex only (no 0x/+/_ forms int() would take),
            # invalid → missing-value sentinel, overlong wraps mod 2^64 —
            # all matching native parse_hex64 exactly
            if v and not (set(v) - hexdigits):
                h = np.uint64(int(v, 16) & 0xFFFFFFFFFFFFFFFF)
            else:
                h = np.uint64(0xFFFFFFFF)
            keys[i] = (np.uint64(i + 1) << np.uint64(self._SLOT_SHIFT)) | (h & mask)
        offsets = np.arange(27, dtype=np.int32)  # one key per slot
        return SlotRecord(keys=keys, slot_offsets=offsets, dense=dense,
                          label=label, show=1.0, clk=label)


_PARSERS: Dict[str, Type[BaseParser]] = {}


def register_parser(name: str, cls: Type[BaseParser]) -> None:
    _PARSERS[name] = cls


def get_parser(desc: DataFeedDesc) -> BaseParser:
    try:
        return _PARSERS[desc.parser](desc)
    except KeyError:
        raise KeyError(
            f"unknown parser {desc.parser!r}; registered: {sorted(_PARSERS)}"
        ) from None


class _PluginSoParser(SlotTextParser):
    """Parser backed by a user shared library exposing the bulk columnar
    C ABI (same signature as native/slot_parser.cpp ``slot_text_parse``).
    Per-line fallback is the slot_text format."""

    _lib = None
    _symbol = "slot_text_parse"

    def parse_file_columnar(self, path: str) -> Optional[dict]:
        import ctypes
        fn = getattr(type(self)._lib, type(self)._symbol)
        fn.restype = ctypes.c_int64
        return _bulk_slot_text_parse(fn, self.desc, path)


def load_parser_plugin(spec: str, name: Optional[str] = None) -> List[str]:
    """Load a custom parser plugin and register its parsers — the
    ``DLManager``/``CustomParser`` extension point (data_feed.h:450,:698,
    ``LoadIntoMemoryByLib`` data_feed.h:1675), without requiring the
    paddle .so ABI. Three plugin forms:

    - ``"pkg.module"`` / ``"pkg.module:attr"``: imported; the module either
      self-registers via :func:`register_parser` or exposes a ``PARSERS``
      dict of {name: BaseParser subclass}.
    - ``"/path/to/plugin.py"``: executed as a module, same contract.
    - ``"/path/to/libcustom.so"`` or ``".so:symbol"``: ctypes-loaded
      library exposing the bulk columnar C ABI (the signature of
      native/slot_parser.cpp ``slot_text_parse``); registered under
      ``name`` (default: the file stem).

    Returns the list of parser names registered by this call."""
    import ctypes
    import importlib
    import importlib.util
    import os

    before = set(_PARSERS)

    path, sym = spec, None
    head, colon, tail = spec.rpartition(":")
    if colon and not spec.endswith(".so") and not spec.endswith(".py"):
        path, sym = head, tail

    if path.endswith(".so"):
        lib = ctypes.CDLL(path)
        pname = name or os.path.splitext(os.path.basename(path))[0]
        cls = type(f"PluginParser_{pname}", (_PluginSoParser,),
                   {"_lib": lib, "_symbol": sym or "slot_text_parse"})
        register_parser(pname, cls)
        return [pname]

    if path.endswith(".py"):
        modname = name or os.path.splitext(os.path.basename(path))[0]
        mspec = importlib.util.spec_from_file_location(
            f"pbox_parser_plugin_{modname}", path)
        mod = importlib.util.module_from_spec(mspec)
        mspec.loader.exec_module(mod)
    else:
        mod = importlib.import_module(path)
        if sym:
            mod = getattr(mod, sym)

    for pname, cls in getattr(mod, "PARSERS", {}).items():
        register_parser(pname, cls)
    return sorted(set(_PARSERS) - before)


register_parser("slot_text", SlotTextParser)
register_parser("criteo", CriteoParser)
