"""Build the port's CUDA kernels with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` compiles on first use into its own shared library
under ``build/kernels/`` at the checkout root, with a plain C entry point
(no PyTorch headers, so a build takes seconds). The library name carries a
hash of the source, the shared headers (``csrc/*.cuh``) and the flags, so
an edited source or header never loads a stale build. ``build`` compiles
several sources at once, one ``nvcc`` process each. A failed build raises
with the compiler's output.

``book`` is every wrapper's dispatch counter:
``pbox_kernel_dispatch_total{kernel, impl}`` in the telemetry hub,
booked only while the hub is active (one attribute read otherwise).
``impl`` is ``cuda`` where the wrapper launches its kernel (beside its
``.launches`` count, so the two agree) and ``plain`` where a CPU tensor
runs the plain version. The reference books at jit trace time, once per
compiled program; the eager port books once per call.
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

from paddlebox_tpu_torch.obs import hub as _obs_hub

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
KERNELS = ("gather_rows", "pool_cvm", "segment_gather",
           "scatter_add_update", "key_index", "rank_attention", "batch_fc",
           "cross_norm", "segment_sum", "scatter_rows", "row_dma")

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
    """The build of ``csrc/<name>.cu``, named by a hash of the source, of
    every shared header in ``csrc/`` and of the flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
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
    entry (the raw handle PyTorch's own generated kernels launch on,
    without building a ``torch.cuda.Stream``)."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


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


def book(wrapper, impl: str) -> None:
    """Book one ``pbox_kernel_dispatch_total{kernel, impl}`` tick for a
    kernel wrapper when the hub is active: ``kernel`` is the wrapper's
    ``label`` (set beside its ``launches``); the inert path is one
    attribute read."""
    hub = _obs_hub._HUB
    if hub.active:
        book_label(wrapper.label, impl)


def book_label(kernel: str, impl: str) -> None:
    """Book one ``pbox_kernel_dispatch_total{kernel, impl}`` tick under
    an explicit label when the hub is active (the index seam's
    ``index.<op>`` decisions)."""
    hub = _obs_hub._HUB
    if hub.active:
        hub.counter("pbox_kernel_dispatch_total",
                    "device-kernel dispatch decisions by kernel and impl"
                    ).inc(kernel=kernel, impl=impl)
