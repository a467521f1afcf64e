"""Replicated small dense-embedding caches + host side-input table; the
port of ``paddlebox_tpu/ps/replica_cache.py``.

Reference:
- ``GpuReplicaCache`` (fleet/box_wrapper.h:63-122 + box_wrapper.cu:1210):
  a small dense embedding table built on host (``AddItems``), replicated
  into every GPU's memory (``ToHBM``) and looked up by row id
  (``pull_cache_value_kernel``) — for tiny high-traffic vocabularies that
  would waste PS round-trips.
- ``InputTable`` (fleet/box_wrapper.h:124-197): string-keyed dense
  side-input rows on host, batch-looked-up and copied to the device
  (``LookupInput``), feeding the ``InputTableDataFeed`` variant.

The replica cache is one tensor on the card (one copy a device when
several ask for it); a lookup is a tensor index. The input table keeps a
host string→row dict and stages each batch's rows as one tensor.
"""

from __future__ import annotations

import logging
import threading
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from paddlebox_tpu_torch.device import resolve_device

log = logging.getLogger(__name__)


class ReplicaCache:
    """GpuReplicaCache analogue: build rows on host, freeze to the
    device."""

    def __init__(self, emb_dim: int,
                 device: Union[str, torch.device] = "cuda") -> None:
        self.emb_dim = emb_dim
        self.device = resolve_device(device)
        self._rows: List[np.ndarray] = []
        self._dev: Optional[torch.Tensor] = None

    def add_items(self, rows: np.ndarray) -> int:
        """Append [n, emb_dim] rows; returns the first new row id."""
        rows = np.asarray(rows, np.float32).reshape(-1, self.emb_dim)
        first = self.size
        self._rows.append(rows)
        self._dev = None
        return first

    @property
    def size(self) -> int:
        return sum(r.shape[0] for r in self._rows)

    def to_hbm(self) -> torch.Tensor:
        """Freeze to one device tensor (ToHBM), built once per change."""
        if self._dev is None:
            host = (np.concatenate(self._rows, axis=0) if self._rows
                    else np.zeros((0, self.emb_dim), np.float32))
            self._dev = torch.from_numpy(host).to(self.device)
        return self._dev

    def pull(self, ids) -> torch.Tensor:
        """Row lookup (pull_cache_value_kernel): ids [...] → [..., dim].
        Ids are clamped into range (the CUDA kernel does no bounds check
        either); an empty cache is a caller bug and raises."""
        table = self.to_hbm()
        if table.shape[0] == 0:
            raise ValueError("ReplicaCache.pull on an empty cache — "
                             "add_items first")
        ids = torch.as_tensor(ids, device=table.device).long()
        return table[ids.clamp(0, table.shape[0] - 1)]


class InputTable:
    """Host string-keyed dense side-input (InputTable, box_wrapper.h:124)."""

    def __init__(self, dim: int,
                 device: Union[str, torch.device] = "cuda") -> None:
        self.dim = dim
        self.device = resolve_device(device)
        self._map: Dict[str, int] = {}
        self._rows: List[np.ndarray] = []

    def add_input(self, key: str, values: Sequence[float]) -> int:
        v = np.asarray(values, np.float32)
        if v.shape != (self.dim,):
            raise ValueError(f"row for {key!r} has shape {v.shape}, "
                             f"want ({self.dim},)")
        if key in self._map:
            self._rows[self._map[key]] = v
            return self._map[key]
        self._map[key] = len(self._rows)
        self._rows.append(v)
        return self._map[key]

    def __len__(self) -> int:
        return len(self._rows)

    def lookup(self, keys: Sequence[str]) -> torch.Tensor:
        """Batch lookup → [n, dim] device tensor; misses read zeros
        (LookupInput's copy)."""
        out = np.zeros((len(keys), self.dim), np.float32)
        for i, k in enumerate(keys):
            r = self._map.get(k)
            if r is not None:
                out[i] = self._rows[r]
        return torch.from_numpy(out).to(self.device)

    def load_index_filelist(self, filelist: Sequence[str],
                            parse_index_line=None,
                            thread_num: int = 4) -> int:
        """The ``InputIndexDataFeed`` role (data_feed.h:2289,
        data_feed.cc:4637; driven by InputTableDataset::
        LoadIndexIntoMemory, data_set.cc:3195): load index files of
        ``key → float vector`` rows into this table with a reader-thread
        pool and a pluggable line parser.

        ``parse_index_line(line) -> (key, values) | None`` is the
        ``ISlotParser::ParseIndexData`` hook; the default parses
        ``key<TAB>v0 v1 ...`` (space- or comma-separated floats). Bad
        LINES/ROWS are skipped with a warning (the reference's reader
        callback contract); a missing/unreadable FILE raises. Files
        parse in parallel but apply in FILELIST ORDER — a key appearing
        in several files deterministically keeps the last file's row.
        Returns the number of rows applied (overwrites included)."""

        def default_parse(line: str):
            parts = line.rstrip("\n").split("\t", 1)
            if len(parts) != 2:
                return None
            vals = parts[1].replace(",", " ").split()
            return parts[0], [float(v) for v in vals]

        parse = parse_index_line or default_parse
        lock = threading.Lock()
        files = list(filelist)
        fidx = [0]
        parsed: List[Optional[list]] = [None] * len(files)
        errors: List[BaseException] = []

        def worker() -> None:
            while True:
                with lock:
                    if errors or fidx[0] >= len(files):
                        return
                    i = fidx[0]
                    fidx[0] += 1
                path = files[i]
                try:
                    rows = []
                    with open(path, "r") as fh:
                        for line in fh:
                            try:
                                item = parse(line)
                            except (ValueError, IndexError):
                                item = None
                            if item is None:
                                log.warning("index feed: bad line in %s "
                                            "skipped", path)
                                continue
                            rows.append(item)
                    parsed[i] = rows
                except BaseException as e:
                    # a missing/unreadable FILE is an error, not a skip
                    with lock:
                        errors.append(e)
                    return

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(max(1, thread_num))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
        # apply in FILELIST order: duplicate keys keep the last file's row
        # whatever order the reader threads finished in
        added = 0
        for i, rows in enumerate(parsed):
            for key, vals in rows or ():
                try:
                    self.add_input(key, vals)
                    added += 1
                except ValueError:
                    # a wrong-width vector skips the row, as the
                    # reference's reader callback does
                    log.warning("index feed: bad row %r in %s skipped",
                                key, files[i])
        return added
