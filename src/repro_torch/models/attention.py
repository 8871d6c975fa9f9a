"""GQA attention with qk-norm and RoPE over a dense KV cache (port of the
GQA part of ``repro/models/attention.py``).

Masking is by position, as in JAX: a query at ``pq`` attends to a key at
``pk`` iff ``pk >= 0 and pk <= pq`` (and ``pq - pk < window`` when a
sliding window is set); padding slots carry ``-1``.

Routing (all through ``repro_torch.kernels``, which launch the Hopper
kernels on CUDA tensors and run their plain versions on CPU tensors):

* T == 1 with a cache (every decode token): ``decode_attention``.
* Everything else (prefill, verify, score: T > 1): ``flash_attention``.
  Short draft blocks (T = k + 1) go there too until the draft engine's
  slice routes them to the decode kernel, which already takes T > 1.
  The JAX package reaches its flash kernel only under ``use_pallas``; the
  port always takes its own kernel on this path.  JAX's plain
  ``dot_product_attention`` is ``flash_attention_plain`` here, which CPU
  tensors take.

The cache is written in place: ``cache["k"][..., s:s+T, :] = k`` on the
caller's tensors (JAX returns new arrays; the caches the port hands back
are the same objects it was given).
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.flash_attention.ops import flash_attention

from .config import ModelConfig
from .layers import Dense, RMSNorm, apply_dense, apply_rmsnorm, apply_rope


class GQA(nn.Module):
    """``{"wq", "wk", "wv", "wo"[, "q_norm", "k_norm"]}``."""

    def __init__(self, cfg: ModelConfig, *, dtype, device=None):
        super().__init__()
        hd = cfg.resolved_head_dim
        kw = dict(dtype=dtype, device=device)
        self.wq = Dense(cfg.d_model, cfg.num_heads * hd, bias=cfg.qkv_bias, **kw)
        self.wk = Dense(cfg.d_model, cfg.num_kv_heads * hd, bias=cfg.qkv_bias, **kw)
        self.wv = Dense(cfg.d_model, cfg.num_kv_heads * hd, bias=cfg.qkv_bias, **kw)
        self.wo = Dense(cfg.num_heads * hd, cfg.d_model,
                        scale=1.0 / (cfg.num_heads * hd) ** 0.5, **kw)
        if cfg.qk_norm:
            self.q_norm = RMSNorm(hd, **kw)
            self.k_norm = RMSNorm(hd, **kw)
        else:
            self.q_norm = self.k_norm = None


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
                  device) -> dict:
    hd = cfg.resolved_head_dim
    shape = (batch, cfg.num_kv_heads, max_len, hd)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "pos": torch.full((batch, max_len), -1, dtype=torch.int32,
                          device=device),
    }


def _cache_write(buf: torch.Tensor, update: torch.Tensor, start: int,
                 dim: int = -2) -> None:
    """In place: ``buf[..., start:start+T, (:)] = update`` along ``dim``.

    ``start`` is one slot for the whole batch (prefill, lockstep decode),
    clamped like ``dynamic_update_slice`` so the window fits.  Per-row
    starts belong to the slot-serving slice."""
    if isinstance(start, torch.Tensor):
        raise NotImplementedError("per-row cache_start arrives with slot "
                                  "serving (ROADMAP Queue 1 item 10)")
    T = update.shape[dim]
    S = buf.shape[dim]
    s = min(max(int(start), 0), S - T)
    buf.narrow(dim, s, T).copy_(update)


def _decode_attention(q, k, v, q_pos, kv_pos, *,
                      window: int, cache_start, kv_length, kv_start):
    """Decode-shaped call: live bounds ``[kv_start, kv_length)`` per row."""
    B, _, T = q.shape[:3]
    dev = q.device
    if kv_length is None:
        kv_length = int(cache_start) + T
    lengths = torch.as_tensor(kv_length, dtype=torch.int32, device=dev
                              ).reshape(-1).expand(B)
    starts = None if kv_start is None else torch.as_tensor(
        kv_start, dtype=torch.int32, device=dev).reshape(-1).expand(B)
    if window > 0 and starts is not None:
        # contiguous layout: keys at or below start + q_pos - window are
        # outside the window of the earliest query; skip their slots
        qp = q_pos[:, 0].to(torch.int32)
        starts = torch.maximum(starts, starts + qp - window + 1)
    return decode_attention(q, k.to(q.dtype), v.to(q.dtype), q_pos, kv_pos,
                            lengths, starts, window=window)


def apply_gqa(p: GQA, cfg: ModelConfig, x, positions, *, cache=None,
              cache_start=None, kv_length=None, kv_start=None):
    """Causal self-attention.  x: (B, T, d); positions: (B, T) int32.  With
    ``cache`` (a layer's
    ``{"k", "v": (B, Hkv, S, D), "pos": (B, S)}`` views), writes K/V/pos at
    ``cache_start`` in place and attends over the whole cache.  Returns
    (out (B, T, d), cache or None)."""
    B, T, _ = x.shape
    hd = cfg.resolved_head_dim
    q = apply_dense(p.wq, x).view(B, T, cfg.num_heads, hd).transpose(1, 2)
    k = apply_dense(p.wk, x).view(B, T, cfg.num_kv_heads, hd).transpose(1, 2)
    v = apply_dense(p.wv, x).view(B, T, cfg.num_kv_heads, hd).transpose(1, 2)
    if cfg.qk_norm:
        q = apply_rmsnorm(p.q_norm, q, cfg.norm_eps)
        k = apply_rmsnorm(p.k_norm, k, cfg.norm_eps)
    if cfg.pos_embed != "rope":
        raise NotImplementedError("learned positions arrive with the "
                                  "whisper slice (ROADMAP Queue 1 item 13)")
    q = apply_rope(q, positions, cfg.rope_theta).contiguous()
    k = apply_rope(k, positions, cfg.rope_theta)
    kv_pos = positions

    if cache is not None:
        _cache_write(cache["k"], k.to(cache["k"].dtype), cache_start)
        _cache_write(cache["v"], v.to(cache["v"].dtype), cache_start)
        _cache_write(cache["pos"], positions.to(torch.int32), cache_start,
                     dim=-1)
        k, v, kv_pos = cache["k"], cache["v"], cache["pos"]

    if cache is not None and T == 1:
        out = _decode_attention(q, k, v, positions, kv_pos,
                                window=cfg.sliding_window,
                                cache_start=cache_start, kv_length=kv_length,
                                kv_start=kv_start)
    else:
        out = flash_attention(q, k.to(q.dtype).contiguous(),
                              v.to(q.dtype).contiguous(), positions, kv_pos,
                              window=cfg.sliding_window)
    out = out.transpose(1, 2).reshape(B, T, cfg.num_heads * hd)
    return apply_dense(p.wo, out.to(x.dtype)), cache
