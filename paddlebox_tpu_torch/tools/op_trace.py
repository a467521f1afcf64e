"""Op-by-op digest of a CPU training window, to find the first op whose
float order differs between two processes.

``OpDigest`` is a ``TorchDispatchMode`` that hashes every floating-point
CPU output of every op run in its thread, in order. ``run`` trains phase
18b's window (``chip_smoke._online_daemon`` on the CPU, window 1 of the
first two files of the smoke's records) under it and writes one JSON
line an op; with ``--after-18a`` it first runs phase 18a on the card in
the same process, as the smoke does. ``compare`` prints the first op at
which each log differs from the first one.

    python -m paddlebox_tpu_torch.tools.op_trace run OUT.jsonl [--after-18a] [--flag-off]
    python -m paddlebox_tpu_torch.tools.op_trace compare A.jsonl B.jsonl ...

Run from the checkout's root (it imports ``chip_smoke``). ``--flag-off``
trains without ``torch.use_deterministic_algorithms(True)``, which the
smoke's phase 18 sets.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import tempfile
from typing import List, Optional

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves


class OpDigest(TorchDispatchMode):
    """(op, output index, shape, blake2b of the bytes) of every float
    CPU output, in order, in ``log``."""

    def __init__(self):
        super().__init__()
        self.log: List[list] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for i, t in enumerate(tree_leaves(out)):
            if (isinstance(t, torch.Tensor) and t.device.type == "cpu"
                    and t.dtype.is_floating_point and t.numel()):
                a = t.detach().contiguous().numpy()
                self.log.append([str(func), i, list(t.shape),
                                 hashlib.blake2b(memoryview(a).cast("B"),
                                                 digest_size=8).hexdigest()])
        return out


def first_difference(a: list, b: list) -> Optional[int]:
    """Index of the first entry where two logs differ (None if equal)."""
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return i
    return None if len(a) == len(b) else min(len(a), len(b))


def run(out: str, after_18a: bool, flag_off: bool) -> int:
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from paddlebox_tpu_torch import convert, native
    from paddlebox_tpu_torch.config import flags_scope
    from paddlebox_tpu_torch.data import BatchBuilder, SlotRecord
    from paddlebox_tpu_torch.obs import reset_hub
    native.load()
    rng = np.random.default_rng(0)
    cs.make_table_blob(rng, convert)          # the smoke's draw order
    records = cs.make_records(rng, cs.BATCH * 8, SlotRecord)
    desc = cs.ragged_desc()
    args = argparse.Namespace(seed=0)
    tmp = tempfile.mkdtemp(prefix="pbx_op_trace_")
    os.makedirs(os.path.join(tmp, "data"))
    files = [os.path.join(tmp, "data", f"part-{i:03d}.txt") for i in range(6)]
    for i, f in enumerate(files):
        cs.write_slot_text(f, records[i * cs.BATCH:(i + 1) * cs.BATCH])
    torch.use_deterministic_algorithms(not flag_off)
    if after_18a:
        from paddlebox_tpu_torch.ops import _build
        _build.build()
        batches = [BatchBuilder(desc).build(records[i:i + cs.BATCH])
                   for i in range(0, len(records), cs.BATCH)]
        cs.online_serve_run(torch, args, desc, files, batches[0],
                            os.path.join(tmp, "a"), "cuda", {})
    digest = OpDigest()
    with flags_scope(**cs._online_flags(args)):
        learner, _, _, _ = cs._online_daemon(
            torch, args, desc, os.path.join(tmp, "b"), files, "cpu",
            checkpoint=False, max_windows=1)
        with digest:
            learner.run()
    reset_hub()
    with open(out, "w") as fh:
        for entry in digest.log:
            fh.write(json.dumps(entry) + "\n")
    print(f"{len(digest.log)} ops at {torch.get_num_threads()} threads "
          f"into {out}")
    return 0


def compare(paths: List[str]) -> int:
    logs = [[json.loads(line) for line in open(p)] for p in paths]
    differ = 0
    for path, log in zip(paths[1:], logs[1:]):
        i = first_difference(logs[0], log)
        if i is None:
            print(f"{path}: equal to {paths[0]}, {len(log)} ops")
            continue
        differ += 1
        print(f"{path}: first differs at op {i} of {len(logs[0])}: "
              f"{logs[0][i] if i < len(logs[0]) else None} | "
              f"{log[i] if i < len(log) else None}")
    return 1 if differ else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("run")
    r.add_argument("out")
    r.add_argument("--after-18a", action="store_true")
    r.add_argument("--flag-off", action="store_true")
    c = sub.add_parser("compare")
    c.add_argument("logs", nargs="+")
    a = ap.parse_args(argv)
    if a.cmd == "run":
        return run(a.out, a.after_18a, a.flag_off)
    return compare(a.logs)


if __name__ == "__main__":
    raise SystemExit(main())
