"""The kernels on local shards (port of ``repro/distributed/shard_wrap.py``).

A Pallas call is a black box to GSPMD, so JAX wraps each in ``shard_map``
to run it on every device's local block.  In the port every rank already
holds local blocks: a data rank its rows (``mesh.DataRows``), a model rank
its heads (``mesh.shard_params``), so the model's forward calls each
kernel on its local shard directly.  This module keeps the rules that
decide the split, JAX's ``batch_shardable`` and ``model_axis``, and:

* ``sharded_decode_attention`` and ``sharded_spec_verify``: JAX's
  wrappers, whole arrays in and out; each rank runs the kernel on its
  rows (and on its heads, when both head counts divide the model axis) and
  the outputs are gathered.  ``core/verify.py:verify_drafts`` takes the
  second on its whole scores;
* ``gather_heads`` and ``local_heads``: a GQA whose KV heads the model
  axis does not divide (JAX then shards ``wq`` and replicates ``wk`` and
  ``wv``: 6 query heads and 3 KV heads on a 2-way axis give a rank the
  query heads {0, 1, 2}, which read the KV heads {0, 0, 1}: no uniform
  GQA) gathers its local query columns whole, runs the kernel over every
  head, and keeps its own columns for the row-parallel ``wo``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.spec_verify.ops import spec_verify

from .comm import (all_gather_cat, gather_from_model, group_rank,
                   group_size)
from .mesh import DataRows, model_group, model_rank, model_size
from .mesh import batch_shardable  # noqa: F401  (JAX's rule, kept here too)


def model_axis(mesh, *dims: int):
    """``"model"`` when the mesh has a model axis that every ``dim``
    divides, else ``None``."""
    m = model_size(mesh)
    if m <= 1:
        return None
    if all(d % m == 0 and d >= m for d in dims):
        return "model"
    return None


def gather_heads(x: torch.Tensor, group) -> torch.Tensor:
    """A rank's query columns (..., C / m) gathered whole (..., C); the
    gradient keeps this rank's columns (only its heads reach ``wo``)."""
    return gather_from_model(x, group, dim=-1)


def local_heads(x: torch.Tensor, group) -> torch.Tensor:
    """This rank's columns (..., C / m) of a whole (..., C) output (a
    slice: its gradient is zero in the other ranks' columns)."""
    n = x.shape[-1] // group_size(group)
    r = group_rank(group)
    return x[..., r * n:(r + 1) * n]


def _heads(mesh, t: torch.Tensor) -> torch.Tensor:
    m, r = model_size(mesh), model_rank(mesh)
    return t.chunk(m, dim=1)[r]


def sharded_decode_attention(mesh, q, k, v, q_pos, k_pos, lengths, starts,
                             *, window: int = 0) -> torch.Tensor:
    """``decode_attention`` on a mesh: whole inputs in (q (B, Hq, T, Dk),
    k/v (B, Hkv, S, D), q_pos, k_pos, lengths, starts), the whole output
    (B, Hq, T, Dv) out.  Rows go over the data axis, heads over the model
    axis when both head counts divide it; each rank runs the kernel on its
    block and the blocks are gathered."""
    B, Hq, Hkv = q.shape[0], q.shape[1], k.shape[1]
    rows = DataRows(mesh, B)
    heads = mesh is not None and model_axis(mesh, Hq, Hkv) is not None
    q, k, v, q_pos, k_pos, lengths, starts = (
        rows.take(x) for x in (q, k, v, q_pos, k_pos, lengths, starts))
    if heads:
        q, k, v = _heads(mesh, q), _heads(mesh, k), _heads(mesh, v)
    out = decode_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                           q_pos, k_pos, lengths, starts, window=window)
    if heads:
        out = all_gather_cat(out, model_group(mesh), dim=1)
    return rows.gather(out)


def sharded_spec_verify(mesh, lp_curr, lp_prev, u, valid_len,
                        log_lenience: float) -> torch.Tensor:
    """``spec_verify`` on a mesh: whole (B, N) inputs, each data rank
    verifies its rows, and the (B,) rejection positions are gathered."""
    B = lp_curr.shape[0]
    rows = DataRows(mesh, B)
    n = spec_verify(*(rows.take(x) for x in (lp_curr, lp_prev, u,
                                             valid_len)), log_lenience)
    return rows.gather(n)
