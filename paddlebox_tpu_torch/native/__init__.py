"""The port's native host library, built with g++ from two sources into
one library and loaded by ctypes: ``kv_index.cpp`` (the key→row index
and the one-pass first-seen dedup) and ``slot_parser.cpp`` (the bulk
file→columnar parsers of ``data/parser.py``). ``ctypes.CDLL`` releases
the GIL for the duration of each call, so files parse in parallel on
the dataset's thread pool.

The library builds on first use into ``build/native/`` at the checkout
root, never into the source tree, named by a hash of both sources, the
flags and the compiler's resolved ``-march=native`` target (a checkout
copied to another machine never loads a build for another CPU). The
compiler writes a temp file named by the process id, which
``os.replace`` moves into place, so processes that build at once never
load a half-written library. A failed build raises with g++'s output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

SRC = Path(__file__).resolve().parent / "kv_index.cpp"
PARSER_SRC = Path(__file__).resolve().parent / "slot_parser.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-fPIC", "-shared")

class NativeBuildError(RuntimeError):
    """The native library could not be built or loaded (the compiler's
    output is in the message)."""


_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_error: NativeBuildError | None = None

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I32 = ctypes.c_int32
_C = ctypes.c_char_p
# (restype, argtypes) of every entry: kv_* of kv_index.cpp, the two
# parsers of slot_parser.cpp
_SIGNATURES = {
    "kv_create": (_P, [_I64, _I32]),
    "kv_destroy": (None, [_P]),
    "kv_size": (_I64, [_P]),
    "kv_assign": (_I64, [_P, _P, _I64, _P]),
    "kv_lookup": (None, [_P, _P, _I64, _P]),
    "kv_release": (_I64, [_P, _P, _I64, _P]),
    "kv_items": (None, [_P, _P, _P]),
    "kv_assign_unique": (_I64, [_P, _P, _I64, _P, _P]),
    "kv_lookup_unique": (_I64, [_P, _P, _I64, _I32, _P, _P]),
    "kv_arena_enable": (_I32, [_P, _I32, _I32]),
    "kv_assign_slotted": (_I64, [_P, _P, _P, _I64, _P, _P]),
    "kv_assign_unique_slotted": (_I64, [_P, _P, _P, _I64, _P, _P]),
    "kv_arena_chunk_count": (_I32, [_P]),
    "kv_arena_export": (_I32, [_P, _P, _P]),
    "kv_dedup_first_seen": (_I64, [_P, _I64, _P, _P, _P]),
    "criteo_parse": (_I64, [_C, _I64, _I64, _P, _P, _P]),
    "slot_text_parse": (_I64, [_C, _I64, _P, _I64, _I64, _I64, _I64,
                               _P, _P, _P, _P, _P, _P, _P]),
}


def _sources() -> tuple:
    return (SRC, PARSER_SRC)


def _cxx() -> str:
    found = shutil.which("g++")
    if found is None:
        raise NativeBuildError("native build: g++ not found on PATH")
    return found


def library_path(cxx: str) -> Path:
    """The build of the library for this machine: named by a hash of both
    sources, the flags and what ``-march=native`` resolves to here, so
    an edit to either source rebuilds it."""
    target = subprocess.run([cxx, "-march=native", "-Q", "--help=target"],
                            capture_output=True, timeout=60).stdout
    h = hashlib.sha256()
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    h.update(target)
    return BUILD_DIR / f"libpbx_native-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless this machine's build is there; returns
    its path. Raises with g++'s output when the build fails."""
    cxx = _cxx()
    out = library_path(cxx)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        proc = subprocess.run([cxx, *CXX_FLAGS, *map(str, _sources()), "-o",
                               str(tmp)],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            names = ", ".join(s.name for s in _sources())
            raise NativeBuildError(f"g++ failed for {names} (exit "
                                   f"{proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
    return out


def load() -> ctypes.CDLL:
    """The native library, built on first use, with the ctypes signatures
    of its entries set. A failed build raises, here and on every
    later call of this process."""
    global _lib, _error
    with _lock:
        if _lib is not None:
            return _lib
        if _error is not None:
            raise _error
        try:
            lib = ctypes.CDLL(str(build()))
        except (OSError, subprocess.SubprocessError) as e:
            _error = NativeBuildError(f"native library unavailable: {e}")
            raise _error from e
        except NativeBuildError as e:
            _error = e
            raise
        for name, (restype, argtypes) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.restype = restype
            fn.argtypes = argtypes
        _lib = lib
        return lib
