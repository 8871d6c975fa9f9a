"""Mamba (S6) block, as interleaved inside Jamba (port of
``repro/models/mamba.py``).

in_proj splits into the SSM input and the gate z; a causal depthwise conv
and SiLU; x_proj gives dt, B and C, each RMS-normalised (Jamba's norms),
dt through dt_proj and softplus; the selective scan (per channel d, state
size ds)::

    s_t = exp(dt_t · A) ⊙ s_{t-1} + (dt_t · u_t) · B_t
    y_t = C_t · s_t + D u_t

with A = -exp(A_log); then y ⊙ silu(z) and out_proj.

With grad off the scan goes through ``kernels.mamba_scan`` for every T:
the prompt at prefill, prompt ⊕ draft at the verify score, one token at a
decode step.  With grad on and an input that requires it (the actor's
forward in the train step) it goes through ``ssm_scan``, the plain
recurrence under autograd, chunked under checkpoint as JAX's is.

Padding: the conv input is zeroed and dt forced to 0 at invalid positions,
so pads leave the state untouched.

The cache ``{"conv": (B, dc - 1, di) cfg.dtype, "ssm": (B, di, ds)
float32}`` is updated in place, every row (done rows too, as JAX's new
cache is): the conv history after it was read, the state by the kernel.
At T > 1 the conv starts from a zero history even with a cache (the
prefill), as JAX's does; the state starts from ``cache["ssm"]`` at any T.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.mamba_scan.ops import mamba_scan, mamba_scan_plain

from .attention import needs_grad
from .config import ModelConfig
from .layers import (Dense, RMSNorm, apply_dense, apply_rmsnorm, normal_,
                     raw_param)


class Mamba(nn.Module):
    """``{"in_proj", "conv_w": (dc, di), "conv_b", "x_proj", "dt_proj"
    (with bias), "A_log": (di, ds), "D", "out_proj", "dt_norm", "b_norm",
    "c_norm"}``, JAX's leaves; the raw arrays are parameters of their
    own."""

    def __init__(self, cfg: ModelConfig, *, dtype, device=None):
        super().__init__()
        d, di, ds = cfg.d_model, cfg.mamba_d_inner, cfg.mamba_d_state
        dtr, dc = cfg.resolved_dt_rank, cfg.mamba_d_conv
        kw = dict(dtype=dtype, device=device)
        self.in_proj = Dense(d, 2 * di, **kw)
        self.conv_w = raw_param(dc, di, **kw)
        self.conv_b = raw_param(di, **kw, fill=0.0)
        self.x_proj = Dense(di, dtr + 2 * ds, **kw)
        self.dt_proj = Dense(dtr, di, bias=True, **kw)
        self.A_log = raw_param(di, ds, **kw)
        self.D = raw_param(di, **kw, fill=1.0)
        self.out_proj = Dense(di, d, scale=1.0 / math.sqrt(di), **kw)
        self.dt_norm = RMSNorm(dtr, **kw)
        self.b_norm = RMSNorm(ds, **kw)
        self.c_norm = RMSNorm(ds, **kw)

    def reset(self, generator: torch.Generator) -> None:
        """The raw leaves (the Dense and RMSNorm children reset
        themselves): conv_w ~ N(0, 1/dc), conv_b = 0, A_log = log(1..ds)
        on every channel, D = 1."""
        dc, ds = self.conv_w.shape[0], self.A_log.shape[1]
        normal_(self.conv_w, 1.0 / math.sqrt(dc), generator)
        self.conv_b.zero_()
        self.A_log.copy_(torch.log(torch.arange(
            1, ds + 1, dtype=torch.float32, device=self.A_log.device)
        ).expand(self.A_log.shape))
        self.D.fill_(1.0)


def init_mamba_cache(cfg: ModelConfig, batch: int, dtype, device):
    di, ds, dc = cfg.mamba_d_inner, cfg.mamba_d_state, cfg.mamba_d_conv
    return {
        "conv": torch.zeros((batch, dc - 1, di), dtype=dtype, device=device),
        "ssm": torch.zeros((batch, di, ds), dtype=torch.float32,
                           device=device),
    }


def ssm_scan(dt, u, Bc, Cc, A, D, s0, chunk: int = 64):
    """Differentiable scan (the reference's ``lax.scan`` at
    ``mamba.py:101-128``): ``mamba_scan_plain`` under autograd, arguments
    as ``mamba_scan``'s.  Returns (y, final state).  When T > chunk and
    chunk divides T, each chunk runs under ``torch.utils.checkpoint``, as
    JAX wraps its chunk in ``jax.checkpoint``: the backward keeps only the
    states at chunk boundaries and recomputes the rest, instead of T
    states of (B, di, ds)."""
    T = dt.shape[1]
    if not (T > chunk and T % chunk == 0):
        return mamba_scan_plain(dt, u, Bc, Cc, A, D, s0)
    s, ys = s0, []
    for c0 in range(0, T, chunk):
        sl = slice(c0, c0 + chunk)
        y, s = checkpoint(mamba_scan_plain, dt[:, sl], u[:, sl], Bc[:, sl],
                          Cc[:, sl], A, D, s, use_reentrant=False)
        ys.append(y)
    return torch.cat(ys, dim=1), s


def _causal_conv(p: Mamba, xin, conv_hist):
    """Depthwise causal conv of xin (B, T, di) over the history
    ``conv_hist`` (B, dc - 1, di) in float32, cast back to xin's dtype.
    Returns (xc, the new history: the last dc - 1 inputs)."""
    T, dc = xin.shape[1], p.conv_w.shape[0]
    hist = torch.cat([conv_hist.to(xin.dtype), xin], dim=1)  # (B,T+dc-1,di)
    w = p.conv_w.float()
    xc = sum(hist[:, i:i + T].float() * w[i] for i in range(dc))
    return xc.to(xin.dtype), hist[:, hist.shape[1] - (dc - 1):]


def _ssm_inputs(p: Mamba, cfg: ModelConfig, xc, valid):
    """dt (softplus, 0 on pads), B and C (B, T, ·) in float32 from the
    post-conv activations xc."""
    dtr, ds = cfg.resolved_dt_rank, cfg.mamba_d_state
    proj = apply_dense(p.x_proj, xc)
    dt, Bc, Cc = torch.split(proj, [dtr, ds, ds], dim=-1)
    dt = apply_rmsnorm(p.dt_norm, dt, cfg.norm_eps)
    Bc = apply_rmsnorm(p.b_norm, Bc, cfg.norm_eps).float()
    Cc = apply_rmsnorm(p.c_norm, Cc, cfg.norm_eps).float()
    dt = F.softplus(apply_dense(p.dt_proj, dt).float())
    return dt * valid[..., None].float(), Bc, Cc


def apply_mamba(p: Mamba, cfg: ModelConfig, x, positions, *, cache=None):
    """x: (B, T, d); positions: (B, T) (-1 on pads); cache: one layer's
    ``{"conv", "ssm"}`` views, updated in place.  Returns the block's
    output (B, T, d)."""
    B, T, _ = x.shape
    di, ds, dc = cfg.mamba_d_inner, cfg.mamba_d_state, cfg.mamba_d_conv
    valid = positions >= 0

    xin, z = apply_dense(p.in_proj, x).chunk(2, dim=-1)
    xin = xin * valid[..., None].to(xin.dtype)
    if cache is not None and T == 1:
        hist0 = cache["conv"]
    else:
        hist0 = torch.zeros((B, dc - 1, di), dtype=xin.dtype, device=x.device)
    xc, new_conv = _causal_conv(p, xin, hist0)
    xc = F.silu(xc + p.conv_b.to(xc.dtype))

    dt, Bc, Cc = _ssm_inputs(p, cfg, xc, valid)
    A = -torch.exp(p.A_log.float())
    u = xc.float()
    D = p.D.float()
    if cache is None and needs_grad(dt, u, Bc, Cc, A, D):
        s0 = torch.zeros((B, di, ds), dtype=torch.float32, device=x.device)
        y, _ = ssm_scan(dt, u, Bc, Cc, A, D, s0, cfg.scan_chunk)
    else:
        s = (cache["ssm"] if cache is not None else
             torch.zeros((B, di, ds), dtype=torch.float32, device=x.device))
        y = mamba_scan(dt, u, Bc, Cc, A, D, s)
    if cache is not None:
        cache["conv"].copy_(new_conv)
    y = y.to(x.dtype) * F.silu(z)
    return apply_dense(p.out_proj, y)
