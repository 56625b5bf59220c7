"""Device resolution shared by every entry point of the port."""

from __future__ import annotations

from typing import Callable, Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device an entry point runs on: `cuda` unless the caller names
    another. Raises when CUDA is wanted and absent, so nothing carries
    on quietly on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return dev


def seeded_model(make: Callable[[torch.Generator], torch.nn.Module], device: torch.device,
                 seed: int) -> torch.nn.Module:
    """make(g), the model built on `device` and drawn from a generator there
    seeded `seed`: every rank draws the same weights (FSDP2 broadcasts
    none), and on a CUDA device a full-width draw takes milliseconds where
    a host draw takes seconds."""
    with torch.device(device):
        return make(torch.Generator(device).manual_seed(seed))
