"""Hand-written Hopper kernels of the port (CUDA C++ in ``csrc/``).

Each kernel module (``<name>/ops.py``) holds a wrapper that checks its
inputs and launches the kernel on CUDA tensors (or raises), the plain
PyTorch version of the same function (used for CPU tensors and by the
tests), and counts its launches in ``LAUNCHES[<name>]``: one per call that
launched the kernel, and nowhere else.  ``reset_launches`` sets every count
to 0, so a caller can show that a run went through the kernels.
``WKV_LAUNCHES_BY_T`` splits the ``wkv`` count by the sequence length T of
the call (its three regimes: decode steps, prefills, scores).
"""
from __future__ import annotations

from typing import Dict

KERNELS = ("decode_attention", "flash_attention", "spec_verify", "cache_roll",
           "cache_slot_write", "paged_gather", "paged_decode_attention",
           "wkv")

LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}
WKV_LAUNCHES_BY_T: Dict[int, int] = {}


def reset_launches() -> None:
    for name in KERNELS:
        LAUNCHES[name] = 0
    WKV_LAUNCHES_BY_T.clear()
