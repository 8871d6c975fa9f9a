"""The collectives of the port's mesh, over ``torch.distributed`` groups.

Every collective the mesh runs goes through here: the all-reduce after a
row-parallel matmul, the gathers of the logits along the vocabulary, of a
gathered query's heads and of a data shard's rows, and the object gathers
of the serving metrics and snapshots.  They take the tensors where they lie,
CUDA tensors included: NCCL takes them, and so does this PyTorch's ``gloo``
(which stages a CUDA tensor through host memory itself), so no collective
moves a tensor to the CPU here and the compute never leaves the card.
"""
from __future__ import annotations

from typing import Any, List

import torch
import torch.distributed as dist


def group_size(group) -> int:
    return dist.get_world_size(group)


def group_rank(group) -> int:
    return dist.get_rank(group)


def group_ranks(group) -> tuple:
    """The global ranks of ``group``, in group order."""
    return tuple(dist.get_process_group_ranks(group))


def all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    """Sum ``t`` over ``group`` in place; returns ``t``."""
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def all_gather_cat(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Every member's ``t`` concatenated along ``dim``, in group order."""
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(group_size(group))]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim=dim)


def all_gather_objects(obj: Any, group) -> List[Any]:
    """Every member's picklable ``obj``, in group order."""
    out: List[Any] = [None] * group_size(group)
    dist.all_gather_object(out, obj, group=group)
    return out


def broadcast_(t: torch.Tensor, group, src_index: int = 0) -> torch.Tensor:
    """``t`` of the group's member ``src_index``, written into every
    member's ``t`` in place; returns ``t``."""
    dist.broadcast(t, src=group_ranks(group)[src_index], group=group)
    return t
