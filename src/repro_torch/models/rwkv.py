"""RWKV6 ("Finch") block (port of ``repro/models/rwkv.py``): the
data-dependent-decay time mix and the channel mix.

Per head (k-dim = v-dim = head_dim), with data-dependent per-channel decay
``w_t`` and bonus ``u``::

    y_t = r_t · (S_{t-1} + diag(u) k_t v_tᵀ)
    S_t = diag(w_t) S_{t-1} + k_t v_tᵀ

With grad off the recurrence goes through ``kernels.rwkv6_wkv`` for every
T: the prompt at prefill, prompt ⊕ draft at the verify score, one token at
a decode step.  With grad on and an input that requires it (the actor's
forward in the train step) it goes through ``wkv_scan``, the port of JAX's
differentiable recurrence, which is what JAX's train forward runs.
Token shift uses the RWKV6 "ddlerp": a low-rank data-dependent
interpolation between x_t and x_{t-1} per projection stream.

Padding: the trunk zeroes embeddings at invalid positions, and k is masked
and w forced to 1 there, so pads leave the state untouched.

The cache ``{"shift_t", "shift_c": (B, d) cfg.dtype, "wkv": (B, H, hd, hd)
float32}`` is updated in place, every row (done rows too, as JAX's new
cache is): the shift rows after they were read, the state by the kernel.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.rwkv6_wkv.ops import wkv

from .attention import needs_grad
from .config import ModelConfig
from .layers import Dense, apply_dense, normal_, raw_param

STREAMS = ("r", "k", "v", "w", "g")


class RWKVTimeMix(nn.Module):
    """``{"mu_base", "mu", "lora_a", "lora_b", "wr", "wk", "wv", "wg",
    "wo", "w0", "w_lora_a", "w_lora_b", "u", "ln_x_scale", "ln_x_bias"}``;
    ``lora_b`` (5, rank, d), ``w_lora_b`` (rank, d) and ``u`` (d,) are raw
    arrays, as in JAX."""

    def __init__(self, cfg: ModelConfig, *, dtype, device=None):
        super().__init__()
        d, rank = cfg.d_model, cfg.rwkv_lora_rank
        H, hd = cfg.rwkv_num_heads, cfg.rwkv_head_dim
        kw = dict(dtype=dtype, device=device)
        self.mu_base = raw_param(d, **kw, fill=0.0)
        self.mu = raw_param(len(STREAMS), d, **kw, fill=0.0)
        self.lora_a = Dense(d, len(STREAMS) * rank, **kw)
        self.lora_b = raw_param(len(STREAMS), rank, d, **kw)
        self.wr = Dense(d, d, **kw)
        self.wk = Dense(d, d, **kw)
        self.wv = Dense(d, d, **kw)
        self.wg = Dense(d, d, **kw)
        self.wo = Dense(d, d, scale=1.0 / math.sqrt(d), **kw)
        self.w0 = raw_param(d, **kw, fill=-6.0)
        self.w_lora_a = Dense(d, rank, **kw)
        self.w_lora_b = raw_param(rank, d, **kw)
        self.u = raw_param(d, **kw)
        self.ln_x_scale = raw_param(H, hd, **kw, fill=1.0)
        self.ln_x_bias = raw_param(H, hd, **kw, fill=0.0)

    def reset(self, generator: torch.Generator) -> None:
        """The raw leaves (the Dense children reset themselves)."""
        self.mu_base.zero_()
        self.mu.zero_()
        self.w0.fill_(-6.0)
        normal_(self.lora_b, 0.01, generator)
        normal_(self.w_lora_b, 0.01, generator)
        normal_(self.u, 0.1, generator)
        self.ln_x_scale.fill_(1.0)
        self.ln_x_bias.zero_()


class RWKVChannelMix(nn.Module):
    """``{"mu_k", "mu_r", "wk", "wv", "wr"}``."""

    def __init__(self, cfg: ModelConfig, *, dtype, device=None):
        super().__init__()
        d, ff = cfg.d_model, cfg.d_ff
        kw = dict(dtype=dtype, device=device)
        self.mu_k = raw_param(d, **kw, fill=0.5)
        self.mu_r = raw_param(d, **kw, fill=0.5)
        self.wk = Dense(d, ff, **kw)
        self.wv = Dense(ff, d, scale=1.0 / math.sqrt(ff), **kw)
        self.wr = Dense(d, d, **kw)

    def reset(self, generator: torch.Generator) -> None:
        self.mu_k.fill_(0.5)
        self.mu_r.fill_(0.5)


def init_rwkv_cache(cfg: ModelConfig, batch: int, dtype, device):
    H, hd = cfg.rwkv_num_heads, cfg.rwkv_head_dim
    return {
        "shift_t": torch.zeros((batch, cfg.d_model), dtype=dtype,
                               device=device),
        "shift_c": torch.zeros((batch, cfg.d_model), dtype=dtype,
                               device=device),
        "wkv": torch.zeros((batch, H, hd, hd), dtype=torch.float32,
                           device=device),
    }


def _token_shift(x, x_prev_row):
    """(B, T, d) -> the previous-token tensor; slot 0 takes x_prev_row
    (B, d)."""
    return torch.cat([x_prev_row[:, None, :], x[:, :-1, :]], dim=1)


def _ddlerp(p: RWKVTimeMix, x, xprev):
    """RWKV6 data-dependent token shift for the 5 streams r, k, v, w, g."""
    xx = xprev - x
    base = x + xx * p.mu_base.to(x.dtype)
    lora = torch.tanh(apply_dense(p.lora_a, base))
    B, T, _ = x.shape
    rank = p.lora_b.shape[1]
    lora = lora.reshape(B, T, len(STREAMS), rank)
    dmu = torch.einsum("btsr,srd->btsd", lora, p.lora_b.to(x.dtype))
    return [x + xx * (p.mu[i].to(x.dtype) + dmu[:, :, i, :])
            for i in range(len(STREAMS))]


def _group_norm(p: RWKVTimeMix, y, eps: float):
    """y: (B, T, H, hd) per-head layer norm (biased variance, as
    ``jnp.var``)."""
    mu = y.mean(dim=-1, keepdim=True)
    var = y.var(dim=-1, keepdim=True, correction=0)
    yn = (y - mu) * torch.rsqrt(var + eps)
    return yn * p.ln_x_scale.to(y.dtype) + p.ln_x_bias.to(y.dtype)


def _scan_steps(s, r, k, v, w, u):
    """The recurrence step by step over (B, T, H, hd) inputs from state s
    (B, H, hd, hd).  Returns (y (B, T, H, hd), final state)."""
    ys = []
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]           # (B,H,hd,hd)
        ys.append(torch.einsum("bhk,bhkv->bhv", r[:, t],
                               s + u[None, :, :, None] * kv))
        s = w[:, t, :, :, None] * s + kv
    return torch.stack(ys, dim=1), s


def wkv_scan(r, k, v, w, u, s0, chunk: int = 64):
    """Differentiable recurrence (port of JAX's ``wkv_scan``).

    r, k, v, w: (B, T, H, hd) float32; u: (H, hd); s0: (B, H, hd, hd).
    Returns (y (B, T, H, hd), final state).  When T > chunk and chunk
    divides T, each chunk runs under ``torch.utils.checkpoint``, as JAX
    wraps its chunk in ``jax.checkpoint``: the backward keeps only the
    states at chunk boundaries and recomputes the rest, instead of T states
    of (B, H, hd, hd)."""
    T = r.shape[1]
    if not (T > chunk and T % chunk == 0):
        return _scan_steps(s0, r, k, v, w, u)
    s, ys = s0, []
    for c0 in range(0, T, chunk):
        sl = slice(c0, c0 + chunk)
        y, s = checkpoint(_scan_steps, s, r[:, sl], k[:, sl], v[:, sl],
                          w[:, sl], u, use_reentrant=False)
        ys.append(y)
    return torch.cat(ys, dim=1), s


def apply_rwkv_time_mix(p: RWKVTimeMix, cfg: ModelConfig, x, positions, *,
                        cache=None):
    """x: (B, T, d); positions: (B, T) (-1 on pads); cache: one layer's
    ``{"shift_t", "wkv", ...}`` views, updated in place.  Returns the
    mix's output (B, T, d)."""
    B, T, d = x.shape
    H, hd = cfg.rwkv_num_heads, cfg.rwkv_head_dim
    valid = (positions >= 0)[..., None].float()

    xprev_row = (cache["shift_t"].to(x.dtype) if cache is not None
                 else torch.zeros((B, d), dtype=x.dtype, device=x.device))
    xprev = _token_shift(x, xprev_row)
    xr, xk, xv, xw, xg = _ddlerp(p, x, xprev)

    r = apply_dense(p.wr, xr).float()
    k = apply_dense(p.wk, xk).float() * valid
    v = apply_dense(p.wv, xv).float()
    g = F.silu(apply_dense(p.wg, xg))

    logw = p.w0.float() + (torch.tanh(apply_dense(p.w_lora_a, xw)).float()
                           @ p.w_lora_b.float())
    w = torch.exp(-torch.exp(logw))                      # (B, T, d) in (0, 1)
    w = torch.where(valid > 0, w, torch.ones_like(w))    # pads: no decay

    shp = (B, T, H, hd)
    u = p.u.float().reshape(H, hd)
    if cache is None and needs_grad(r, k, v, w, u):
        s0 = torch.zeros((B, H, hd, hd), dtype=torch.float32, device=x.device)
        y, _ = wkv_scan(r.reshape(shp), k.reshape(shp), v.reshape(shp),
                        w.reshape(shp), u, s0, cfg.scan_chunk)
    elif cache is not None:
        y, _ = wkv(r.reshape(shp), k.reshape(shp), v.reshape(shp),
                   w.reshape(shp), u, cache["wkv"], s_out=cache["wkv"])
        cache["shift_t"].copy_(x[:, -1, :])
    else:
        s0 = torch.zeros((B, H, hd, hd), dtype=torch.float32, device=x.device)
        y, _ = wkv(r.reshape(shp), k.reshape(shp), v.reshape(shp),
                   w.reshape(shp), u, s0, s_out=s0)

    y = _group_norm(p, y.to(x.dtype), cfg.norm_eps).reshape(B, T, d)
    return apply_dense(p.wo, y * g)


def apply_rwkv_channel_mix(p: RWKVChannelMix, cfg: ModelConfig, x,
                           positions, *, cache=None):
    """x: (B, T, d).  Updates ``cache["shift_c"]`` in place after reading
    it.  Returns the mix's output (B, T, d)."""
    B, T, d = x.shape
    xprev_row = (cache["shift_c"].to(x.dtype) if cache is not None
                 else torch.zeros((B, d), dtype=x.dtype, device=x.device))
    xx = _token_shift(x, xprev_row) - x
    if cache is not None:
        cache["shift_c"].copy_(x[:, -1, :])
    xk = x + xx * p.mu_k.to(x.dtype)
    xr = x + xx * p.mu_r.to(x.dtype)
    k = torch.square(torch.relu(apply_dense(p.wk, xk)))
    kv = apply_dense(p.wv, k)
    return torch.sigmoid(apply_dense(p.wr, xr)) * kv
