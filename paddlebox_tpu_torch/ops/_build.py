"""Build the port's CUDA kernels with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` compiles on first use into its own shared library
under ``build/kernels/`` at the checkout root, with a plain C entry point
(no PyTorch headers, so a build takes seconds). The library name carries a
hash of the source and the flags, so an edited source never loads a stale
build. ``build`` compiles several sources at once, one ``nvcc`` process
each. A failed build raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Sequence

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
KERNELS = ("gather_rows", "pool_cvm", "segment_gather",
           "scatter_add_update", "key_index")

_lock = threading.Lock()
_fns: Dict[str, object] = {}
#: compiler output (``-Xptxas -v`` register and spill report) per kernel
build_logs: Dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for root in ([home] if home else []) + ["/usr/local/cuda"]:
        cand = Path(root) / "bin" / "nvcc"
        if cand.exists():
            return str(cand)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = KERNELS) -> Dict[str, float]:
    """Compile every named kernel that has no current build, all at once
    (one ``nvcc`` each). Returns the seconds each build took (0.0 when
    the library was already there)."""
    nvcc = None
    procs = {}
    secs: Dict[str, float] = {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    try:
        for name in names:
            out = library_path(name)
            if out.exists():
                secs[name] = 0.0
                continue
            nvcc = nvcc or _nvcc()
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp),
                   str(CSRC / f"{name}.cu")]
            procs[name] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), tmp, out, time.perf_counter())
        for name, (proc, tmp, out, t0) in list(procs.items()):
            log, _ = proc.communicate()
            del procs[name]
            secs[name] = time.perf_counter() - t0
            build_logs[name] = log
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed for {name}.cu (exit {proc.returncode}):"
                    f"\n{log}")
            os.replace(tmp, out)
    finally:
        for proc, tmp, _, _ in procs.values():
            proc.kill()
            proc.wait()
            tmp.unlink(missing_ok=True)
    return secs


def function(name: str, symbol: str, argtypes: Sequence):
    """The C entry ``symbol`` of kernel library ``name``, building and
    loading it on first use. Every entry returns a ``cudaError_t``."""
    with _lock:
        fn = _fns.get(symbol)
        if fn is None:
            build([name])
            fn = getattr(ctypes.CDLL(str(library_path(name))), symbol)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
            _fns[symbol] = fn
    return fn


def stream(t: torch.Tensor) -> int:
    """The current CUDA stream of ``t``'s device, as a handle for a C
    entry."""
    return torch.cuda.current_stream(t.device).cuda_stream


def require_cuda(name: str, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor is contiguous and on one CUDA device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {dev} and {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: non-contiguous input")
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")


def check(rc: int, what: str) -> None:
    """Raise when a C entry reported a CUDA error for its launch."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {rc}")
