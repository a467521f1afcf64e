"""Crash-safe small-file IO (copy of ``paddlebox_tpu/utils/fsio.py``):
the write-tmp → flush → fsync → ``os.replace`` publish that the resume
marker and the artifact leases use. Readers never see a torn file, and
the payload is durable before the rename makes it visible.
"""

from __future__ import annotations

import json
import os


def atomic_write_bytes(path: str, data: bytes, fsync: bool = True) -> str:
    """Atomically publish ``data`` at ``path``. The temp file carries the
    writer's pid, so concurrent writers never collide."""
    tmp = path + f".tmp{os.getpid()}"
    with open(tmp, "wb") as fh:
        fh.write(data)
        if fsync:
            fh.flush()
            try:
                os.fsync(fh.fileno())
            except OSError:
                pass  # some FUSE mounts reject fsync; rename still atomic
    os.replace(tmp, path)
    return path


def atomic_write_json(path: str, payload: dict, fsync: bool = True) -> str:
    """Atomically publish ``payload`` as JSON at ``path``."""
    return atomic_write_bytes(path, json.dumps(payload).encode(), fsync)


def read_json(path: str):
    """Read a JSON file published by :func:`atomic_write_json`; None on a
    missing, torn or foreign file."""
    try:
        with open(path) as fh:
            return json.load(fh)
    except (OSError, ValueError):
        return None
