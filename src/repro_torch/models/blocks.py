"""Decoder blocks and the layer stack (port of ``repro/models/blocks.py``,
attention blocks with a dense FFN).

Layers are an ``nn.ModuleList`` run by a Python loop (JAX scans stacked
parameters).  The caches keep JAX's per-run stacked layout so that
``model._roll_rows`` flattens (run, batch, head) rows exactly as JAX does:
``caches[run] = {"self": {"k", "v": (run_len, B, Hkv, S, D),
"pos": (run_len, B, S)}}``, or with ``cfg.cache_layout == "paged"``
``{"k", "v": (run_len, NB, Hkv, bs, D) pools, "pos": (run_len, B, S),
"table": (run_len, B, nb)}``.  Layer ``i`` of a run reads and writes the
views ``k[i]``, ``v[i]``, ``pos[i]`` (and ``table[i]``) in place.
"""
from __future__ import annotations

from typing import List, Tuple

from torch import nn

from .attention import GQA, apply_gqa, init_kv_cache
from .config import ATTN, ModelConfig
from .layers import RMSNorm, apply_rmsnorm
from .moe import apply_ffn, make_ffn

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


def check_supported(cfg: ModelConfig) -> None:
    """The port runs dense attention trunks over a dense or paged cache."""
    for sig in block_signatures(cfg):
        if sig != (ATTN, False, False):
            raise NotImplementedError(
                f"{cfg.name}: block {sig} needs the other model families "
                "(ROADMAP Queue 1 item 13)")
    if cfg.attention_kind != "gqa":
        raise NotImplementedError("MLA arrives with ROADMAP Queue 1 item 13")
    if cfg.encoder_layers or cfg.num_prefix_embeddings or cfg.mtp:
        raise NotImplementedError("encoder, vision prefix and MTP arrive "
                                  "with ROADMAP Queue 1 item 13")


class Block(nn.Module):
    """``{"norm1", "attn", "norm2", "mlp"}``."""

    def __init__(self, cfg: ModelConfig, *, dtype, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.norm1 = RMSNorm(cfg.d_model, **kw)
        self.attn = GQA(cfg, **kw)
        self.norm2 = RMSNorm(cfg.d_model, **kw)
        self.mlp = make_ffn(cfg.d_model, cfg.d_ff, kind=cfg.ffn_kind, **kw)


def apply_block(p: Block, cfg: ModelConfig, x, positions, *, cache=None,
                cache_start=None, kv_length=None, kv_start=None):
    h = apply_rmsnorm(p.norm1, x, cfg.norm_eps)
    out, _ = apply_gqa(p.attn, cfg, h, positions, cache=cache,
                       cache_start=cache_start, kv_length=kv_length,
                       kv_start=kv_start)
    x = x + out
    h = apply_rmsnorm(p.norm2, x, cfg.norm_eps)
    return x + apply_ffn(p.mlp, h, cfg.act)


def init_trunk_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
                     device):
    caches = []
    for _, run_len in signature_runs(cfg):
        one = init_kv_cache(cfg, batch, max_len, dtype, device)
        caches.append({"self": {
            name: buf[None].repeat((run_len,) + (1,) * buf.ndim)
            for name, buf in one.items()}})
    return caches


def apply_trunk(layers: nn.ModuleList, cfg: ModelConfig, x, positions, *,
                caches=None, cache_start=None, kv_length=None,
                kv_start=None):
    """Run all layers; the caches (if given) are updated in place and
    returned."""
    i = 0
    for run_idx, (_, run_len) in enumerate(signature_runs(cfg)):
        sc = caches[run_idx]["self"] if caches is not None else None
        for j in range(run_len):
            layer_cache = None if sc is None else {
                name: buf[j] for name, buf in sc.items()}
            x = apply_block(layers[i], cfg, x, positions, cache=layer_cache,
                            cache_start=cache_start, kv_length=kv_length,
                            kv_start=kv_start)
            i += 1
    return x, caches
