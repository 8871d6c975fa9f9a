"""KV-cache compaction primitives (port of ``repro/kernels/cache_gather``).

``cache_roll`` right-rotates each (S, D) row of a flattened cache buffer by
a per-row shift — the primitive behind ``model.realign_decode_cache``.  It
launches the CUDA kernel (``csrc/cache_roll.cu``, which replaces
``cache_roll_pallas``, ``repro/kernels/cache_gather/kernel.py:38``) on CUDA
tensors and runs ``cache_roll_plain`` on CPU tensors; both work out of place
and agree bit for bit.

``paged_gather`` materialises the dense logical view of a paged block pool
(``out[r, i] = pool[table[r, i]]``), which the paged realign rolls and
re-pages.  It launches ``csrc/paged_gather.cu`` (which replaces
``paged_gather_pallas``, ``repro/kernels/cache_gather/kernel.py:63``) on
CUDA tensors and runs ``paged_gather_plain`` on CPU tensors.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import LAUNCHES, refuse_grad
from repro_torch.kernels._build import launch


def cache_roll_plain(buf: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """out[r, j] = buf[r, (j - shift[r]) mod S] by advanced indexing."""
    R, S = buf.shape[:2]
    j = torch.arange(S, dtype=torch.int64, device=buf.device)[None, :]
    src = torch.remainder(j - shift.to(torch.int64)[:, None], S)
    rows = torch.arange(R, device=buf.device)[:, None]
    return buf[rows, src]


def cache_roll_cuda(buf: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    R, S = buf.shape[:2]
    row_bytes = buf[0, 0].numel() * buf.element_size()
    if not buf.is_contiguous() or buf.data_ptr() % 16 or row_bytes % 16:
        raise ValueError("cache_roll kernel needs a contiguous, 16-byte "
                         "aligned buffer whose rows are a multiple of 16 bytes")
    if shift.shape != (R,) or shift.dtype != torch.int32 or \
            not shift.is_contiguous() or shift.device != buf.device:
        raise ValueError("cache_roll kernel needs shift (R,) int32 on the "
                         "buffer's device")
    out = torch.empty_like(buf)
    launch("repro_cache_roll", buf.device, buf.data_ptr(), shift.data_ptr(),
           out.data_ptr(), R, S, row_bytes)
    LAUNCHES["cache_roll"] += 1
    return out


def cache_roll(buf: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """buf: (R, S, D); shift: (R,) int in [0, S].  Returns a new (R, S, D)
    buffer.  CUDA tensors launch the kernel (or raise); CPU tensors take the
    plain version."""
    refuse_grad("cache_roll", buf)
    if buf.ndim != 3:
        raise ValueError(f"cache_roll wants (R, S, D), got {tuple(buf.shape)}")
    shift = shift.to(torch.int32).contiguous()
    if buf.device.type == "cuda":
        return cache_roll_cuda(buf, shift)
    if buf.device.type != "cpu":
        raise ValueError(f"cache_roll: no kernel for {buf.device}")
    return cache_roll_plain(buf, shift)


def paged_gather_plain(pool: torch.Tensor, table: torch.Tensor
                       ) -> torch.Tensor:
    """out[r, i] = pool[table[r, i]] by ``index_select``."""
    R, nb = table.shape
    return pool.index_select(0, table.reshape(-1).to(torch.int64)).reshape(
        (R, nb) + tuple(pool.shape[1:]))


def paged_gather_cuda(pool: torch.Tensor, table: torch.Tensor
                      ) -> torch.Tensor:
    R, nb = table.shape
    block_bytes = pool[0].numel() * pool.element_size()
    if not pool.is_contiguous() or pool.data_ptr() % 16 or block_bytes % 16:
        raise ValueError("paged_gather kernel needs a contiguous, 16-byte "
                         "aligned pool whose blocks are a multiple of 16 bytes")
    if table.dtype != torch.int32 or not table.is_contiguous() or \
            table.device != pool.device:
        raise ValueError("paged_gather kernel needs table (R, nb) int32 on "
                         "the pool's device")
    out = torch.empty((R, nb) + tuple(pool.shape[1:]), dtype=pool.dtype,
                      device=pool.device)
    launch("repro_paged_gather", pool.device, pool.data_ptr(),
           table.data_ptr(), out.data_ptr(), R * nb, block_bytes)
    LAUNCHES["paged_gather"] += 1
    return out


def paged_gather(pool: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """pool: (NB, X, D); table: (R, nb) int in [0, NB).  Returns a new
    (R, nb, X, D) tensor with out[r, i] = pool[table[r, i]].  CUDA tensors
    launch the kernel (or raise); CPU tensors take the plain version."""
    refuse_grad("paged_gather", pool)
    if pool.ndim != 3 or table.ndim != 2:
        raise ValueError(f"paged_gather wants pool (NB, X, D) and table "
                         f"(R, nb), got {tuple(pool.shape)}, "
                         f"{tuple(table.shape)}")
    table = table.to(torch.int32).contiguous()
    if pool.device.type == "cuda":
        return paged_gather_cuda(pool, table)
    if pool.device.type != "cpu":
        raise ValueError(f"paged_gather: no kernel for {pool.device}")
    return paged_gather_plain(pool, table)
