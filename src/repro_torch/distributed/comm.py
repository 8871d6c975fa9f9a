"""The collectives of the port's mesh, over ``torch.distributed`` groups.

Every collective the mesh runs goes through here: the all-reduce after a
row-parallel matmul, the gathers of the logits along the vocabulary, of a
gathered query's heads and of a data shard's rows, and the object gathers
of the serving metrics and snapshots.

The collectives inside the model's forward carry a gradient (Megatron's
"f" and "g", as ``torch.autograd.Function``s): ``copy_to_model`` (the
input of a column-parallel block: identity forward, the gradient summed
over the model group backward), ``reduce_from_model`` (the output of a
row-parallel block and the vocabulary-sharded lookup: sum forward,
identity backward) and ``gather_from_model`` (the logits along the
vocabulary and a gathered query's heads: all-gather forward, this rank's
slice backward).  Every model rank computes the same loss from the same
gathered logits, so the identity and slice backwards are exact where the
functional collectives of ``torch.distributed.nn`` would sum the loss's
gradient over the ranks and scale it by the model size.  With no graph
to carry they run the plain collectives, so a no-grad forward stays what
it was bit for bit.  They take the tensors where they lie,
CUDA tensors included: NCCL takes them, and so does this PyTorch's ``gloo``
(which stages a CUDA tensor through host memory itself), so the compute
never leaves the card.  The one collective that moves tensors to the host
is a snapshot's gather (``gather_cat_to_host``), whose result is for the
host.
"""
from __future__ import annotations

from typing import Any, List, Optional

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


def gather_cat_to_host(t: torch.Tensor, group, dim: int = 0
                       ) -> Optional[torch.Tensor]:
    """Every member's ``t`` concatenated along ``dim``, on the host of the
    group's first member alone (``None`` on the others): a snapshot's
    gather, whose whole tensor one process writes.  ``gloo`` gathers host
    tensors, so its members move their shards to the host first; NCCL
    gathers on the cards."""
    first = group_ranks(group)[0]
    lead = dist.get_rank() == first
    src = t.detach().contiguous()
    if dist.get_backend(group) == "gloo":
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(group_size(group))] \
        if lead else None
    dist.gather(src, parts, dst=first, group=group)
    return torch.cat(parts, dim=dim).cpu() if lead else None


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather_cat(x, group, dim=dim)

    @staticmethod
    def backward(ctx, g):
        n = g.shape[ctx.dim] // group_size(ctx.group)
        r = group_rank(ctx.group)
        return g.narrow(ctx.dim, r * n, n).contiguous(), None, None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """The input of a column-parallel block ("f"): ``x`` forward, the
    gradient summed over ``group`` backward."""
    if not x.requires_grad:
        return x
    return _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group`` ("g"), the gradient passed through
    backward; in place when no graph is carried."""
    if not x.requires_grad:
        return all_reduce_(x, group)
    return _ReduceFromModel.apply(x, group)


def gather_from_model(x: torch.Tensor, group, dim: int = -1) -> torch.Tensor:
    """Every member's ``x`` concatenated along ``dim``; backward, this
    rank's slice of the gradient."""
    if not x.requires_grad:
        return all_gather_cat(x, group, dim=dim)
    return _GatherFromModel.apply(x, group, dim % x.ndim)


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
