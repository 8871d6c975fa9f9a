"""Primitive layers (port of ``repro/models/layers.py``): dense, RMSNorm,
LayerNorm, rotary embeddings, softcap.

Parameters live in small ``nn.Module`` containers whose attribute names are
the JAX pytree's keys (``kernel``, ``scale``), so ``models/convert.py`` maps
one onto the other by name.  The math is in plain functions with the JAX
names.  Dense kernels are stored ``(in, out)`` and applied as ``x @ kernel``.

On the mesh (``distributed/mesh.py:shard_params``) a row-parallel
``Dense`` holds its rank's rows of the kernel and a ``reduce_group``:
``apply_dense`` then sums the partial products over that group before
adding the bias (``comm.reduce_from_model``: the gradient passes through
to every rank's rows).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from repro_torch.distributed.comm import reduce_from_model


class Dense(nn.Module):
    """``{"kernel": (in, out)[, "bias": (out,)]}``; ``init_scale`` is the
    truncated-normal std the JAX init uses (fan-in unless overridden)."""

    def __init__(self, in_dim: int, out_dim: int, *, bias: bool = False,
                 scale: Optional[float] = None, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.init_scale = scale if scale is not None else 1.0 / math.sqrt(in_dim)
        self.kernel = nn.Parameter(torch.empty(in_dim, out_dim, dtype=dtype,
                                               device=device),
                                   requires_grad=False)
        if bias:
            self.bias = nn.Parameter(torch.zeros(out_dim, dtype=dtype,
                                                 device=device),
                                     requires_grad=False)
        else:
            self.bias = None
        self.reduce_group = None     # row-parallel on the mesh: sum over it

    def reset(self, generator: torch.Generator) -> None:
        w = torch.empty(self.kernel.shape, dtype=torch.float32,
                        device=self.kernel.device)
        nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
        self.kernel.copy_(w * self.init_scale)
        if self.bias is not None:
            self.bias.zero_()


def raw_param(*shape, dtype, device, fill=None) -> nn.Parameter:
    """A frozen parameter that is a raw array in the JAX tree (no
    container), filled with ``fill`` if given."""
    t = torch.empty(shape, dtype=dtype, device=device)
    if fill is not None:
        t.fill_(fill)
    return nn.Parameter(t, requires_grad=False)


def normal_(p: nn.Parameter, std: float, generator: torch.Generator) -> None:
    """``p`` from a float32 normal draw times ``std``, cast to its dtype."""
    t = torch.empty(p.shape, dtype=torch.float32, device=p.device)
    t.normal_(0.0, 1.0, generator=generator)
    p.copy_(t * std)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, *, dtype=torch.float32, device=None):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim, dtype=dtype, device=device),
                                  requires_grad=False)

    def reset(self, generator: torch.Generator) -> None:
        self.scale.fill_(1.0)


class LayerNorm(nn.Module):
    """``{"scale", "bias"}`` (the RWKV blocks' norms)."""

    def __init__(self, dim: int, *, dtype=torch.float32, device=None):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim, dtype=dtype, device=device),
                                  requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(dim, dtype=dtype, device=device),
                                 requires_grad=False)

    def reset(self, generator: torch.Generator) -> None:
        self.scale.fill_(1.0)
        self.bias.zero_()


def apply_dense(p: Dense, x: torch.Tensor) -> torch.Tensor:
    y = x @ p.kernel.to(x.dtype)
    if p.reduce_group is not None:
        y = reduce_from_model(y, p.reduce_group)
    if p.bias is not None:
        y = y + p.bias.to(x.dtype)
    return y


def apply_rmsnorm(p: RMSNorm, x: torch.Tensor, eps: float = 1e-6
                  ) -> torch.Tensor:
    """Computes in float32 and casts back to ``x``'s dtype."""
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * p.scale.float()).to(x.dtype)


def apply_layernorm(p: LayerNorm, x: torch.Tensor, eps: float = 1e-5
                    ) -> torch.Tensor:
    """Computes in float32 (biased variance, as ``jnp.var``) and casts back
    to ``x``'s dtype."""
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, correction=0)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * p.scale.float() + p.bias.float()).to(x.dtype)


def rope_frequencies(head_dim: int, theta: float, device) -> torch.Tensor:
    half = head_dim // 2
    expo = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                        device=device), expo)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """Split-half rotary embedding.

    x: (B, H, T, D) with even D; positions: (B, T) int (-1 on padding, whose
    rotation is irrelevant because attention masks those slots)."""
    d = x.shape[-1]
    freqs = rope_frequencies(d, theta, x.device)
    ang = positions.float()[:, None, :, None] * freqs        # (B,1,T,d/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def softcap(logits: torch.Tensor, cap: float) -> torch.Tensor:
    if not cap:
        return logits
    return cap * torch.tanh(logits / cap)
