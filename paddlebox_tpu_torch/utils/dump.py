"""Per-sample prediction dump and parameter dump (counterpart of
``paddlebox_tpu/utils/dump.py``).

Reference: BoxPSWorker::DumpField/DumpParam (boxps_worker.cc:1595-1858):
sample lines (ins_id and named field values, for offline eval and
debugging) go through a channel to sharded files; the param dump writes
named parameter tensors. The trainer enqueues (ins_ids, device pred,
host label) per batch; a writer thread reads the tensors back and
formats them, so the training loop never waits on file IO.
"""

from __future__ import annotations

import logging
import os
import threading
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from paddlebox_tpu_torch.utils.channel import Channel, ChannelClosed

log = logging.getLogger(__name__)


class DumpConfig:
    """dump_fields semantics (trainer_desc dump_fields/dump_interval)."""

    def __init__(self, path: str, fields: Sequence[str] = ("pred", "label"),
                 interval: int = 1, rank: int = 0) -> None:
        self.path = path
        self.fields = list(fields)
        self.interval = interval
        self.rank = rank


def _host(v) -> np.ndarray:
    return v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)


class DumpWriter:
    """Channel-buffered sharded line writer (DumpField role)."""

    def __init__(self, cfg: DumpConfig) -> None:
        self.cfg = cfg
        os.makedirs(os.path.dirname(cfg.path) or ".", exist_ok=True)
        self._file = open(f"{cfg.path}.part-{cfg.rank:05d}", "w")
        self._ch: Channel = Channel(capacity=64)
        self._exc: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        self.lines = 0

    def _raise_pending(self) -> None:
        if self._exc is not None:
            exc, self._exc = self._exc, None
            raise exc

    def add_batch(self, ins_ids: Optional[List[str]],
                  fields: Dict[str, object], num_real: int) -> None:
        """fields: name → array-like [B] (device tensors too — read back
        on the writer thread)."""
        self._raise_pending()
        try:
            self._ch.put((ins_ids, fields, num_real))
        except ChannelClosed:
            # the writer thread died and cancelled the channel
            self._raise_pending()
            raise

    def _run(self) -> None:
        try:
            for ins_ids, fields, n in self._ch:
                cols = {k: _host(v) for k, v in fields.items()}
                for i in range(n):
                    ins = ins_ids[i] if ins_ids else str(self.lines)
                    vals = "\t".join(
                        f"{k}:{float(cols[k][i]):.6g}"
                        for k in self.cfg.fields if k in cols)
                    self._file.write(f"{ins}\t{vals}\n")
                    self.lines += 1
        except BaseException as e:
            self._exc = e
            # cancel so blocked and later producers fail fast instead of
            # waiting on a full channel
            self._ch.cancel()

    def close(self) -> int:
        self._ch.close()
        self._thread.join()
        self._file.close()
        self._raise_pending()
        log.info("dump: %d lines -> %s", self.lines, self._file.name)
        return self.lines


def dump_param(model: nn.Module, path: str) -> int:
    """Write the named parameter tensors (DumpParam,
    boxps_worker.cc:1633) to ``path`` as ``.npz``, keyed by their
    ``state_dict`` names. Returns the number of tensors written."""
    out = {name: t.detach().cpu().numpy()
           for name, t in model.state_dict().items()}
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez_compressed(path, **out)
    return len(out)
