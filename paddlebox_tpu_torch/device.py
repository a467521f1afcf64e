"""Device selection for the port's entry points: they run on the card
unless the caller asks for the CPU, and never fall back on their own."""

from __future__ import annotations

from typing import Union

import torch


def resolve_device(device: Union[str, torch.device] = "cuda"
                   ) -> torch.device:
    """``device`` as a ``torch.device``; raises when it names CUDA and no
    CUDA device is present (there is no silent move to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but no CUDA device is available; "
            "pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def seeded_generator(device: torch.device, seed: int,
                     counter: int) -> torch.Generator:
    """A generator on ``device`` seeded from (seed, counter), so a run
    that replays the same counters draws the same numbers (Philox on the
    card, the Mersenne twister on the CPU)."""
    g = torch.Generator(device=device)
    g.manual_seed(((seed & 0xFFFFFFFF) << 32) | (counter & 0xFFFFFFFF))
    return g
