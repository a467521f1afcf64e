"""Global named int64 stat registry (copy of
``paddlebox_tpu/utils/monitor.py``) and the device memory report.

Reference: paddle/fluid/platform/monitor.h:80 (``StatRegistry``; ``STAT_ADD``
macro :133), e.g. ``STAT_total_feasign_num_in_mem``. Thread-safe counters,
queryable and resettable by name.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Union

import torch

from paddlebox_tpu_torch.device import resolve_device


class StatRegistry:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._stats: Dict[str, int] = {}

    def add(self, name: str, value: int) -> None:
        with self._lock:
            self._stats[name] = self._stats.get(name, 0) + int(value)

    def set(self, name: str, value: int) -> None:
        with self._lock:
            self._stats[name] = int(value)

    def get(self, name: str) -> int:
        with self._lock:
            return self._stats.get(name, 0)

    def reset(self, name: Optional[str] = None) -> None:
        with self._lock:
            if name is None:
                self._stats.clear()
            else:
                self._stats.pop(name, None)

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._stats)


STATS = StatRegistry()


def stat_add(name: str, value: int = 1) -> None:
    STATS.add(name, value)


def device_mem_used(device: Union[str, torch.device] = "cuda"
                    ) -> Dict[str, int]:
    """Device memory usage — the ``GpuMemUsed`` report
    (fleet/box_wrapper.h:420): {bytes_in_use, peak_bytes_in_use,
    bytes_limit} from the CUDA caching allocator
    (``torch.cuda.memory_stats``) and the card's total memory. The card
    unless the caller asks for the CPU (raises without one); the CPU has
    no allocator stats and reports 0s, as the reference does for a
    device whose backend exposes none."""
    device = resolve_device(device)
    if device.type != "cuda":
        return {"bytes_in_use": 0, "peak_bytes_in_use": 0,
                "bytes_limit": 0}
    stats = torch.cuda.memory_stats(device)
    return {"bytes_in_use": int(stats.get("allocated_bytes.all.current",
                                          0)),
            "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak",
                                               0)),
            "bytes_limit": int(torch.cuda.get_device_properties(
                device).total_memory)}


def log_device_mem(tag: str = "", device: Union[str, torch.device] = "cuda"
                   ) -> Dict[str, int]:
    """Record device memory usage into the stat registry and return it."""
    m = device_mem_used(device)
    prefix = f"hbm_{tag}_" if tag else "hbm_"
    for k, v in m.items():
        STATS.set(prefix + k, v)
    return m
