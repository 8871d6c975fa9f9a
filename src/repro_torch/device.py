"""Device selection for the port's entry points."""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means the card.  Raises when CUDA is asked for and absent:
    a caller who wants the CPU says ``device="cpu"``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("repro_torch runs on CUDA by default and no CUDA "
                           "device is available; pass device='cpu' to run "
                           "on the CPU")
    return dev


def sync(device: Optional[torch.device]) -> None:
    """Wait for the device (the port's ``block_until_ready``)."""
    if device is not None and device.type == "cuda":
        torch.cuda.synchronize(device)
