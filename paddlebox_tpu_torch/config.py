"""Process-wide flags of the port: the two that the resident training
pass reads, with the names and defaults of ``paddlebox_tpu/config.py``.
Tests change them with ``flags_scope``.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Iterator


@dataclasses.dataclass
class Flags:
    # route the resident pass's bulk row assignment
    # (``EmbeddingTable.bulk_assign_unique``) through the device key
    # index (``ops/index.py``): first-seen dedup and a linear-probe hash
    # insert on the card, the host kv mirrored with the NEW keys only.
    # Any state the device index cannot mirror exactly degrades, loudly
    # and for good, to the host index. Off = the host index.
    use_pallas_index: bool = False
    # whole-pass bulk key assignment: one index round trip per pass
    # instead of one per batch (False = the serial per-batch path)
    bulk_pass_assign: bool = True

    def update(self, **kwargs: Any) -> None:
        for k, v in kwargs.items():
            if not hasattr(self, k):
                raise AttributeError(f"unknown flag: {k}")
            setattr(self, k, v)


FLAGS = Flags()


@contextlib.contextmanager
def flags_scope(**kwargs: Any) -> Iterator[Flags]:
    """Override flags for the duration of the block."""
    old = {k: getattr(FLAGS, k) for k in kwargs}
    FLAGS.update(**kwargs)
    try:
        yield FLAGS
    finally:
        FLAGS.update(**old)
