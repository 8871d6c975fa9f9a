"""Hand-written Hopper kernels of the port (CUDA C++ in ``csrc/``).

Each kernel module (``<name>/ops.py``) holds a wrapper that checks its
inputs and launches the kernel on CUDA tensors (or raises), the plain
PyTorch version of the same function (used for CPU tensors and by the
tests), and counts its launches in ``LAUNCHES[<name>]``: one per call that
launched the kernel, and nowhere else.  ``reset_launches`` sets every count
to 0, so a caller can show that a run went through the kernels.
``WKV_LAUNCHES_BY_T`` and ``MAMBA_LAUNCHES_BY_T`` split the ``wkv`` and
``mamba_scan`` counts by the sequence length T of the call (their three
regimes: decode steps, prefills, scores);
``DECODE_LAUNCHES_BY_T`` splits the two decode kernels' counts by their
query block T (1 for a decode step, k + 1 for a draft-verify block).

The kernels are forward-only: they write their outputs through raw
pointers, so an output has no ``grad_fn``.  Every wrapper therefore starts
with ``refuse_grad``, which raises when grad is enabled and an input
requires it, on the CPU as on the card: a gradient through a kernel would
come out zero with no error.  The model, not the wrapper, chooses the
differentiable route (``models/attention.py``, ``models/rwkv.py``,
``models/mamba.py``).
"""
from __future__ import annotations

from typing import Dict

import torch

KERNELS = ("decode_attention", "flash_attention", "spec_verify", "cache_roll",
           "cache_slot_write", "paged_gather", "paged_decode_attention",
           "wkv", "mamba_scan")

LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}
WKV_LAUNCHES_BY_T: Dict[int, int] = {}
MAMBA_LAUNCHES_BY_T: Dict[int, int] = {}
DECODE_LAUNCHES_BY_T: Dict[str, Dict[int, int]] = {
    "decode_attention": {}, "paged_decode_attention": {}}


def reset_launches() -> None:
    for name in KERNELS:
        LAUNCHES[name] = 0
    WKV_LAUNCHES_BY_T.clear()
    MAMBA_LAUNCHES_BY_T.clear()
    for by_t in DECODE_LAUNCHES_BY_T.values():
        by_t.clear()


def refuse_grad(name: str, *inputs) -> None:
    """Raise ``RuntimeError`` when grad is enabled and an input of kernel
    ``name`` requires it (``None`` inputs are skipped)."""
    if not torch.is_grad_enabled():
        return
    if any(isinstance(t, torch.Tensor) and t.requires_grad for t in inputs):
        raise RuntimeError(
            f"{name}: an input requires grad, but the kernel is forward-only "
            "and its output would carry no gradient; run it under "
            "torch.no_grad(), or take the model's differentiable route")
