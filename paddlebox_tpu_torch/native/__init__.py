"""The port's native host library (``kv_index.cpp``: the key→row index
and the one-pass first-seen dedup), built with g++ and loaded by ctypes.

The library builds on first use into ``build/native/`` at the checkout
root, never into the source tree, named by a hash of the source, the
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
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-fPIC", "-shared")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_error: RuntimeError | None = None

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I32 = ctypes.c_int32
# (restype, argtypes) of every kv_* entry of kv_index.cpp
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
}


def _cxx() -> str:
    found = shutil.which("g++")
    if found is None:
        raise RuntimeError("native build: g++ not found on PATH")
    return found


def library_path(cxx: str) -> Path:
    """The build of ``kv_index.cpp`` for this machine: named by a hash of
    the source, the flags and what ``-march=native`` resolves to here."""
    target = subprocess.run([cxx, "-march=native", "-Q", "--help=target"],
                            capture_output=True, timeout=60).stdout
    h = hashlib.sha256(SRC.read_bytes())
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
        proc = subprocess.run([cxx, *CXX_FLAGS, str(SRC), "-o", str(tmp)],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed for {SRC.name} (exit "
                               f"{proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
    return out


def load() -> ctypes.CDLL:
    """The native library, built on first use, with the ctypes signatures
    of its ``kv_*`` entries set. A failed build raises, here and on every
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
            _error = RuntimeError(f"native library unavailable: {e}")
            raise _error from e
        except RuntimeError as e:
            _error = e
            raise
        for name, (restype, argtypes) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.restype = restype
            fn.argtypes = argtypes
        _lib = lib
        return lib
