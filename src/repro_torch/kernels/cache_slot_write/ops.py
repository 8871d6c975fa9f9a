"""Serving slot admission scatter (port of ``repro/kernels/cache_slot_write``).

``cache_slot_write`` writes freshly prefilled source rows into selected
rows of a flattened KV-cache buffer: the primitive behind
``model.write_cache_slots``, which admits new requests into the persistent
decode batch.  ``paged_slot_write`` is the same scatter on the rows of a
paged block pool.  Both launch the CUDA kernel (``csrc/cache_slot_write.cu``,
which replaces ``cache_slot_write_pallas``,
``repro/kernels/cache_slot_write/kernel.py:30``) on CUDA tensors and run
``cache_slot_write_plain`` on CPU tensors.

JAX returns a new buffer; the port writes ``dst`` in place (and returns
it): its caches are the caller's tensors, and a row nobody admits is then
never touched.  Duplicate destinations are deterministic: the last source
row that targets a destination wins, through the inverted map
``_invert_rows`` that both versions walk.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import LAUNCHES, refuse_grad
from repro_torch.kernels._build import launch


def _invert_rows(dst_rows: torch.Tensor, n_dst: int, n_src: int
                 ) -> torch.Tensor:
    """dst_rows (Rs,) in [0, n_dst) -> src_for_dst (n_dst,) int32, -1 for
    untouched rows; on duplicates the highest source index (the last) wins,
    a scatter-max as in JAX."""
    inv = torch.full((n_dst,), -1, dtype=torch.int64, device=dst_rows.device)
    inv.scatter_reduce_(0, dst_rows.to(torch.int64),
                        torch.arange(n_src, dtype=torch.int64,
                                     device=dst_rows.device),
                        reduce="amax")
    return inv.to(torch.int32)


def cache_slot_write_plain(dst: torch.Tensor, src: torch.Tensor,
                           src_for_dst: torch.Tensor) -> torch.Tensor:
    """In place: dst[d] = src[src_for_dst[d]] where the index is >= 0."""
    rows = torch.nonzero(src_for_dst >= 0).reshape(-1)
    dst[rows] = src[src_for_dst[rows].long()].to(dst.dtype)
    return dst


def cache_slot_write_cuda(dst: torch.Tensor, src: torch.Tensor,
                          src_for_dst: torch.Tensor) -> torch.Tensor:
    Rd = dst.shape[0]
    row_bytes = dst[0].numel() * dst.element_size() if Rd else 0
    if src.dtype != dst.dtype or src.shape[1:] != dst.shape[1:]:
        raise ValueError(f"cache_slot_write kernel needs src rows like dst "
                         f"rows: {src.dtype} {tuple(src.shape)} vs "
                         f"{dst.dtype} {tuple(dst.shape)}")
    for name, t in (("dst", dst), ("src", src)):
        if not t.is_contiguous() or t.data_ptr() % 16 or row_bytes % 16:
            raise ValueError(f"cache_slot_write kernel needs a contiguous, "
                             f"16-byte aligned {name} whose rows are a "
                             f"multiple of 16 bytes")
        if t.device != dst.device:
            raise ValueError(f"{name} is on {t.device}, dst on {dst.device}")
    if src_for_dst.shape != (Rd,) or src_for_dst.dtype != torch.int32 or \
            not src_for_dst.is_contiguous() or \
            src_for_dst.device != dst.device:
        raise ValueError("cache_slot_write kernel needs src_for_dst (Rd,) "
                         "int32 on dst's device")
    launch("repro_cache_slot_write", dst.device, dst.data_ptr(),
           src.data_ptr(), src_for_dst.data_ptr(), Rd, row_bytes)
    LAUNCHES["cache_slot_write"] += 1
    return dst


def cache_slot_write(dst: torch.Tensor, src: torch.Tensor,
                     dst_rows: torch.Tensor) -> torch.Tensor:
    """dst: (Rd, ...); src: (Rs, ...) rows of dst's shape; dst_rows: (Rs,)
    int in [0, Rd).  In place: dst[dst_rows[i]] = src[i], the last source
    row winning on duplicates; every other row untouched.  Returns dst.
    CUDA tensors launch the kernel (or raise); CPU tensors take the plain
    version."""
    refuse_grad("cache_slot_write", dst, src)
    if dst.shape[1:] != src.shape[1:] or dst_rows.shape != (src.shape[0],):
        raise ValueError(f"cache_slot_write: dst {tuple(dst.shape)}, src "
                         f"{tuple(src.shape)}, dst_rows "
                         f"{tuple(dst_rows.shape)} do not fit")
    src_for_dst = _invert_rows(dst_rows, dst.shape[0], src.shape[0])
    if dst.device.type == "cuda":
        return cache_slot_write_cuda(dst, src.to(dst.dtype), src_for_dst)
    if dst.device.type != "cpu":
        raise ValueError(f"cache_slot_write: no kernel for {dst.device}")
    return cache_slot_write_plain(dst, src, src_for_dst)


def paged_slot_write(pool: torch.Tensor, src: torch.Tensor,
                     tables: torch.Tensor) -> torch.Tensor:
    """Paged admission: cut dense rows into blocks and write each to the
    physical block its table names (``repro`` ``paged_slot_write``).

    pool: (run, NB, Hkv, bs, D) block pool; src: (run, R, Hkv, S, D) with
    S == nb * bs; tables: (run, R, nb) int block ids.  An MLA latent pool
    (run, NB, bs, r) with src (run, R, S, r) is written as one head.  The
    pool's blocks are viewed as (run * NB, Hkv * bs, D) rows, the block ids
    become destination rows, and ``cache_slot_write`` scatters in place.
    Returns the pool."""
    if pool.ndim == 4:
        paged_slot_write(pool.unsqueeze(2), src.unsqueeze(2), tables)
        return pool
    run_len, NB, Hkv, bs, D = pool.shape
    R, nb = tables.shape[1], tables.shape[2]
    if tables.shape != (run_len, R, nb) or src.shape != (run_len, R, Hkv,
                                                         nb * bs, D):
        raise ValueError(f"paged_slot_write: pool {tuple(pool.shape)}, src "
                         f"{tuple(src.shape)}, tables {tuple(tables.shape)} "
                         "do not fit")
    blocks = (src.to(pool.dtype).reshape(run_len, R, Hkv, nb, bs, D)
              .transpose(2, 3).reshape(run_len * R * nb, Hkv * bs, D))
    r0 = torch.arange(run_len, dtype=torch.int64,
                      device=pool.device)[:, None, None]
    rows = (r0 * NB + tables.to(torch.int64)).reshape(-1)
    cache_slot_write(pool.view(run_len * NB, Hkv * bs, D), blocks, rows)
    return pool
