"""Decoder blocks and the layer stack (port of ``repro/models/blocks.py``):
attention blocks (GQA, or MLA for deepseek-v3) and Mamba blocks, each with
a dense FFN or a mixture-of-experts, and RWKV6 blocks.  A hybrid trunk
(jamba) mixes attention and Mamba layers.  An encoder-decoder's decoder
blocks (whisper) add a cross-attention over the encoder's output after
the self-attention; its K/V are recomputed from ``encoder_out`` at every
call, so the cross attention has no cache entry.

Layers are an ``nn.ModuleList`` run by a Python loop (JAX scans stacked
parameters).  The caches keep JAX's per-run stacked layout so that
``model._roll_rows`` flattens (run, batch, head) rows exactly as JAX does:
for an attention run ``caches[run] = {"self": {"k", "v": (run_len, B, Hkv,
S, D), "pos": (run_len, B, S)}}``, or with ``cfg.cache_layout == "paged"``
``{"k", "v": (run_len, NB, Hkv, bs, D) pools, "pos": (run_len, B, S),
"table": (run_len, B, nb)}``; an MLA run holds the latent in place of K/V,
``{"ckv": (run_len, B, S, r), "krope": (run_len, B, S, rope), "pos"}`` or
paged ``{"ckv": (run_len, NB, bs, r), "krope": (run_len, NB, bs, rope),
"pos", "table"}`` (``attention.CACHE_LEAVES`` names each kind's leaves);
for an RWKV run ``caches[run] = {"rwkv":
{"shift_t", "shift_c": (run_len, B, d), "wkv": (run_len, B, H, hd, hd)}}``;
for a Mamba run ``caches[run] = {"mamba": {"conv": (run_len, B, dc - 1,
di), "ssm": (run_len, B, di, ds)}}``.  Layer ``i`` of a run reads and
writes the views ``buf[i]`` of its run's buffers in place.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch
from torch import nn

from .attention import GQA, MLA, apply_attention, apply_gqa, init_kv_cache
from .config import ATTN, MAMBA, RWKV, ModelConfig
from .layers import LayerNorm, RMSNorm, apply_layernorm, apply_rmsnorm
from .mamba import Mamba, apply_mamba, init_mamba_cache
from .moe import MoE, apply_ffn, apply_moe, make_ffn
from .rwkv import (RWKVChannelMix, RWKVTimeMix, apply_rwkv_channel_mix,
                   apply_rwkv_time_mix, init_rwkv_cache)

BlockSig = Tuple[str, bool, bool]  # (kind, is_moe, cross_attention)


def block_signatures(cfg: ModelConfig) -> List[BlockSig]:
    return [(kind, moe, cfg.cross_attention) for kind, moe in cfg.layer_plan()]


def signature_runs(cfg: ModelConfig) -> List[Tuple[BlockSig, int]]:
    """Consecutive runs of identical block signatures: [(sig, run_len), ...]."""
    runs: List[Tuple[BlockSig, int]] = []
    for sig in block_signatures(cfg):
        if runs and runs[-1][0] == sig:
            runs[-1] = (sig, runs[-1][1] + 1)
        else:
            runs.append((sig, 1))
    return runs


SUPPORTED = ((ATTN, False, False), (ATTN, True, False), (ATTN, False, True),
             (MAMBA, False, False), (MAMBA, True, False), (RWKV, False, False))
# the cache entry of each block kind
CACHE_KEYS = {ATTN: "self", MAMBA: "mamba", RWKV: "rwkv"}


def check_supported(cfg: ModelConfig) -> None:
    """The port runs attention trunks (GQA or MLA, a dense FFN or MoE, an
    MTP head) over a dense or paged cache, attention + Mamba hybrids
    (jamba), RWKV6 trunks, a vision prefix (pixtral) and an encoder-decoder
    with a cross-attention in every decoder block (whisper): every config
    of the reference.  A block signature that none of them uses is
    refused."""
    for sig in block_signatures(cfg):
        if sig not in SUPPORTED:
            raise NotImplementedError(
                f"{cfg.name}: block {sig} is in no config of the reference, "
                "and the port does not build it")


def _add_ffn(block: nn.Module, cfg: ModelConfig, is_moe: bool, kw) -> None:
    if is_moe:
        block.moe = MoE(cfg, **kw)
    else:
        block.mlp = make_ffn(cfg.d_model, cfg.d_ff, kind=cfg.ffn_kind, **kw)


class Block(nn.Module):
    """An attention block: ``{"norm1", "attn", "norm2", "mlp"}``, or with
    ``is_moe`` ``{"norm1", "attn", "norm2", "moe"}``; ``attn`` is an
    ``MLA`` when ``cfg.attention_kind == "mla"``, else a ``GQA``; with
    ``cross`` also ``{"norm_ca", "cross_attn"}`` (a GQA without qk-norm,
    as JAX makes it)."""

    def __init__(self, cfg: ModelConfig, *, is_moe: bool = False,
                 cross: bool = False, dtype, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.norm1 = RMSNorm(cfg.d_model, **kw)
        self.attn = (MLA(cfg, **kw) if cfg.attention_kind == "mla" else
                     GQA(cfg, **kw))
        self.norm2 = RMSNorm(cfg.d_model, **kw)
        if cross:
            self.norm_ca = RMSNorm(cfg.d_model, **kw)
            self.cross_attn = GQA(cfg.replace(qk_norm=False), **kw)
        _add_ffn(self, cfg, is_moe, kw)


class MambaBlock(nn.Module):
    """``{"norm1", "mamba", "norm2", "mlp" | "moe"}``, RMSNorms; run by
    ``apply_block`` as an attention block is."""

    def __init__(self, cfg: ModelConfig, *, is_moe: bool = False, dtype,
                 device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.norm1 = RMSNorm(cfg.d_model, **kw)
        self.mamba = Mamba(cfg, **kw)
        self.norm2 = RMSNorm(cfg.d_model, **kw)
        _add_ffn(self, cfg, is_moe, kw)


class RWKVBlock(nn.Module):
    """``{"norm1", "time_mix", "norm2", "channel_mix"}``, LayerNorms."""

    def __init__(self, cfg: ModelConfig, *, dtype, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.norm1 = LayerNorm(cfg.d_model, **kw)
        self.time_mix = RWKVTimeMix(cfg, **kw)
        self.norm2 = LayerNorm(cfg.d_model, **kw)
        self.channel_mix = RWKVChannelMix(cfg, **kw)


def make_block(cfg: ModelConfig, sig: BlockSig, *, dtype, device=None):
    if sig[0] == RWKV:
        return RWKVBlock(cfg, dtype=dtype, device=device)
    if sig[0] == MAMBA:
        return MambaBlock(cfg, is_moe=sig[1], dtype=dtype, device=device)
    return Block(cfg, is_moe=sig[1], cross=sig[2], dtype=dtype,
                 device=device)


def apply_rwkv_block(p: RWKVBlock, cfg: ModelConfig, x, positions, *,
                     cache=None):
    """LayerNorm (eps 1e-5, JAX's default) -> time mix -> residual, then
    LayerNorm -> channel mix -> residual."""
    h = apply_layernorm(p.norm1, x)
    x = x + apply_rwkv_time_mix(p.time_mix, cfg, h, positions, cache=cache)
    h = apply_layernorm(p.norm2, x)
    return x + apply_rwkv_channel_mix(p.channel_mix, cfg, h, positions,
                                      cache=cache)


def apply_block(p: Block | MambaBlock, cfg: ModelConfig, x, positions, *,
                cache=None, cache_start=None, kv_length=None, kv_start=None,
                causal: bool = True, encoder_out=None,
                encoder_positions=None, router_stats=None):
    """RMSNorm -> attention or Mamba -> residual, then (a cross block)
    RMSNorm -> cross-attention over ``encoder_out`` -> residual, then
    RMSNorm -> FFN or MoE -> residual.  Returns (x, aux): the MoE layer's
    aux dict, ``{}`` for a dense FFN.  A Mamba block ignores the attention
    arguments.  ``router_stats``: a list that takes a MoE layer's router
    statistics (``models/moe.py:_router``).

    A cross block refuses to run without ``encoder_out``: JAX's then
    attends the decoder's own tokens without a causal mask
    (``repro/models/attention.py:407-423``), so position t would see the
    tokens after it (ROADMAP Queue 3, "Kept on purpose")."""
    h = apply_rmsnorm(p.norm1, x, cfg.norm_eps)
    if hasattr(p, "mamba"):
        out = apply_mamba(p.mamba, cfg, h, positions, cache=cache)
    else:
        out, _ = apply_attention(p.attn, cfg, h, positions, cache=cache,
                                 cache_start=cache_start,
                                 kv_length=kv_length, kv_start=kv_start,
                                 causal=causal)
    x = x + out
    if hasattr(p, "cross_attn"):
        if encoder_out is None:
            raise ValueError("a cross-attention trunk needs encoder_out: "
                             "without it the cross-attention would attend "
                             "the decoder's own later tokens")
        h = apply_rmsnorm(p.norm_ca, x, cfg.norm_eps)
        out, _ = apply_gqa(p.cross_attn, cfg, h, positions, causal=False,
                           kv_x=encoder_out, kv_positions=encoder_positions)
        x = x + out
    h = apply_rmsnorm(p.norm2, x, cfg.norm_eps)
    if hasattr(p, "moe"):
        out, aux = apply_moe(p.moe, cfg, h, router_stats)
        return x + out, aux
    return x + apply_ffn(p.mlp, h, cfg.act), {}


def init_trunk_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
                     device):
    caches = []
    for sig, run_len in signature_runs(cfg):
        if sig[0] == RWKV:
            one = init_rwkv_cache(cfg, batch, dtype, device)
        elif sig[0] == MAMBA:
            one = init_mamba_cache(cfg, batch, dtype, device)
        else:
            one = init_kv_cache(cfg, batch, max_len, dtype, device)
        caches.append({CACHE_KEYS[sig[0]]: {
            name: buf[None].repeat((run_len,) + (1,) * buf.ndim)
            for name, buf in one.items()}})
    return caches


def apply_trunk(layers: nn.ModuleList, cfg: ModelConfig, x, positions, *,
                caches=None, cache_start=None, kv_length=None,
                kv_start=None, causal: bool = True, encoder_out=None,
                encoder_positions=None, router_stats=None):
    """Run all layers; the caches (if given) are updated in place and
    returned.  The attention arguments (cache_start, kv_length, kv_start,
    causal, the encoder's output and positions) go unused by RWKV and
    Mamba layers; ``causal=False`` is the encoder's self-attention.
    Returns (x, caches, aux_mean): each aux key averaged over the layers
    that reported it (``{}`` without MoE).  ``router_stats``: a list that
    takes each MoE layer's router statistics, in layer order."""
    aux_sums: Dict[str, torch.Tensor] = {}
    aux_counts: Dict[str, int] = {}
    i = 0
    for run_idx, (sig, run_len) in enumerate(signature_runs(cfg)):
        rwkv = sig[0] == RWKV
        sc = None if caches is None else caches[run_idx][CACHE_KEYS[sig[0]]]
        for j in range(run_len):
            layer_cache = None if sc is None else {
                name: buf[j] for name, buf in sc.items()}
            if rwkv:
                x = apply_rwkv_block(layers[i], cfg, x, positions,
                                     cache=layer_cache)
            else:
                x, aux = apply_block(layers[i], cfg, x, positions,
                                     cache=layer_cache,
                                     cache_start=cache_start,
                                     kv_length=kv_length, kv_start=kv_start,
                                     causal=causal, encoder_out=encoder_out,
                                     encoder_positions=encoder_positions,
                                     router_stats=router_stats)
                for k, v in aux.items():
                    aux_sums[k] = aux_sums[k] + v if k in aux_sums else v
                    aux_counts[k] = aux_counts.get(k, 0) + 1
            i += 1
    aux_mean = {k: aux_sums[k] / aux_counts[k] for k in aux_sums}
    return x, caches, aux_mean
