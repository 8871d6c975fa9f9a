"""GQA attention with qk-norm and RoPE over a dense or a paged KV cache,
cross-attention over an encoder's output, and DeepSeek-V3's multi-head
latent attention (MLA) over a latent cache (port of
``repro/models/attention.py``).

Masking is by position, as in JAX: a query at ``pq`` attends to a key at
``pk`` iff ``pk >= 0 and pk <= pq`` (and ``pq - pk < window`` when a
sliding window is set); padding slots carry ``-1``.  A non-causal call
(the encoder's self-attention, every cross-attention) drops ``pk <= pq``.
With learned positions (whisper) no RoPE is applied; a cross-attention
applies none either, its keys come from the encoder.

Routing.  With grad off (every rollout and scoring forward) the
attention runs through ``repro_torch.kernels``, which launch the Hopper
kernels on CUDA tensors and run their plain versions on CPU tensors:

* A decode-shaped call, JAX's ``_decode_shaped``: T == 1 with a cache
  (every decode token), or a cached block of T <= ``DECODE_BLOCK_MAX_T``
  (64) that comes with explicit per-row live bounds ``kv_length`` (the §9
  draft-verify forward, T = k + 1).  With a dense cache:
  ``decode_attention``.
* The same with a paged cache: ``paged_decode_attention``, which reads the
  block pools directly.  JAX reaches its paged kernel only under
  ``decode_impl`` "pallas"/"interpret" (``attention.py:199``) and with
  "auto" decodes over the gathered view; the port takes its own kernel on
  this path, as it does for ``flash_attention``.  Its plain version gathers
  the view and runs the dense plain version, so on the CPU the paged layout
  is bit-identical to the dense one.
* Every other T > 1 (prefill, verify, score: none carries ``kv_length``):
  ``flash_attention``, over the gathered logical view for a paged cache
  (``gather_paged_kv``, plain ``index_select`` as JAX's ``_paged_gather``
  is ``jnp.take``).  The JAX package reaches its flash kernel only under
  ``use_pallas``; the port always takes its own kernel here.
* Every non-causal call at any T, T = 1 included: ``flash_attention`` with
  ``causal=False`` (the encoder at T = S = frames; the cross-attention's
  queries over the encoder's frames, at prefill and at every decode
  step).  The decode kernels mask ``k_pos <= q_pos``, which would hide the
  frames past the decoder's position.

On the mesh (``distributed/mesh.py``) a GQA runs its rank's heads: the
head counts come from the projections' shapes, never from ``cfg``, the
cache holds the rank's KV heads, and the row-parallel ``wo`` sums the
heads' shares over the model group.  When the model axis does not divide
the KV heads (replicated then, as JAX's rules replicate them), the rank's
query columns are gathered whole, the kernel runs over every head, and
the rank keeps its own columns of the output for ``wo``.  The collectives
carry the gradient (``distributed/comm.py``): the block's input enters
through ``copy_to_model``, the gathered queries leave their gradient's
own columns to each rank, and ``local_heads`` is a slice.

With grad on and an input that requires it (the actor's forward in the
train step), every T goes to ``dot_product_attention``: the port of JAX's
XLA function (``repro/models/attention.py:53``, ``impl="naive"``), which
is what JAX's train forward runs (``M.forward`` has ``use_pallas=False``).
The kernels are forward-only and their wrappers refuse an input that
requires grad, so no gradient can silently come out zero.

The cache is written in place (JAX returns new arrays; the caches the port
hands back are the same objects it was given): ``_cache_write`` for dense
buffers and ``pos``, a T-token block at one slot for the whole batch or at
a slot per row (the slot engine's and the drafted loops' rows sit at their
own depths); ``_paged_write`` through the block table for the pools, a
row's block crossing block boundaries where its slots do.  Both are plain
scatters, as in JAX.

Paged layer cache (DESIGN.md §13): ``{"k", "v": (NB, Hkv, bs, D) pools,
"pos": (B, S) logical positions, "table": (B, nb) block ids}``; the logical
width S is unrounded, only the pools are whole blocks.

MLA (``apply_mla``).  The q path is d -> ``q_lora_rank`` -> RMSNorm -> H x
(nope + rope) (or d -> H x (nope + rope) without a q LoRA); the kv path is
d -> ``kv_lora_rank`` latent (RMSNorm) plus one RoPE key of ``rope`` shared
by every head.  The cache holds the latent alone: ``{"ckv": (B, S, r),
"krope": (B, S, rope), "pos"}``, or paged ``{"ckv": (NB, bs, r), "krope":
(NB, bs, rope), "pos", "table"}``.  Every call decompresses the whole
cache through ``wkv_b`` to H heads of K (nope ⊕ the shared rope key, Dk =
nope + rope) and V (Dv), then attends as MHA (G = 1) with Dk != Dv (192
and 128 at deepseek-v3-671b), routed as GQA is: the differentiable
function with grad on, ``decode_attention`` for a decode-shaped call and
``flash_attention`` for every other T > 1.  JAX sends MLA's decode to its
jnp blocked path and its prefill to jnp (``use_pallas=False``); the port
takes its own kernels, as it does for GQA's prefill.  A paged latent cache
is read through the dense gather, as in JAX, so MLA never reaches
``paged_decode_attention``.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.distributed.comm import copy_to_model
from repro_torch.distributed.shard_wrap import gather_heads, local_heads
from repro_torch.kernels.decode_attention.ops import (decode_attention,
                                                     gather_paged_kv,
                                                     paged_decode_attention)
from repro_torch.kernels.flash_attention.ops import flash_attention

from .config import ModelConfig
from .layers import Dense, RMSNorm, apply_dense, apply_rmsnorm, apply_rope

NEG_INF = -1e30
# the largest cached query block routed to the decode kernels when it comes
# with explicit live bounds (k + 1 for a draft block): JAX's
DECODE_BLOCK_MAX_T = 64
# the per-slot leaves of a layer's cache by attention kind ("pos" and a
# paged "table" aside): GQA's K and V, MLA's latent and shared RoPE key
CACHE_LEAVES = {"gqa": ("k", "v"), "mla": ("ckv", "krope")}


def cache_leaves(sc) -> tuple:
    """The per-slot leaves of one layer's (or run's) cache dict."""
    return CACHE_LEAVES["mla" if "ckv" in sc else "gqa"]


def dot_product_attention(q, k, v, q_pos, k_pos, *, window: int = 0,
                          causal: bool = True) -> torch.Tensor:
    """Grouped-query attention with position-based masking, differentiable
    (port of JAX's ``dot_product_attention``, ``impl="naive"``): the
    (T, S) scores materialised in float32, masked by position, softmax,
    rows that see no key set to 0.

    q: (B, Hq, T, D); k/v: (B, Hkv, S, D); q_pos: (B, T); k_pos: (B, S).
    Returns (B, Hq, T, Dv) float32."""
    B, Hq, T, D = q.shape
    Hkv = k.shape[1]
    G = Hq // Hkv
    qg = q.reshape(B, Hkv, G, T, D)
    scale = 1.0 / torch.sqrt(torch.tensor(D, dtype=torch.float32,
                                          device=q.device))
    scores = torch.einsum("bhgtd,bhsd->bhgts", qg.float(), k.float()) * scale
    kp = k_pos[:, None, None, None, :]
    qp = q_pos[:, None, None, :, None]
    mask = kp >= 0
    if causal:
        mask = mask & (kp <= qp)
    if window > 0:
        mask = mask & ((qp - kp) < window)
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    w = torch.softmax(scores, dim=-1)
    # fully-masked rows: softmax of all -inf is uniform garbage; zero them
    w = torch.where(mask.any(dim=-1, keepdim=True), w, torch.zeros_like(w))
    out = torch.einsum("bhgts,bhsd->bhgtd", w, v.float())
    return out.reshape(B, Hq, T, v.shape[-1])


def needs_grad(*tensors) -> bool:
    """Whether autograd records an op on these tensors now: the model's
    signal to take its differentiable route instead of a kernel."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


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
        # on the mesh, with KV heads the model axis does not divide: the
        # queries are gathered whole over wo's group (distributed/shard_wrap)
        self.gather_q = False


class MLA(nn.Module):
    """``{"wq_a", "q_norm", "wq_b" | "wq", "wkv_a", "kv_norm", "wkv_b",
    "wo"}`` (JAX's ``make_mla``): ``wq`` only without a q LoRA."""

    def __init__(self, cfg: ModelConfig, *, dtype, device=None):
        super().__init__()
        H = cfg.num_heads
        nd, rd, vd = (cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
                      cfg.v_head_dim)
        kw = dict(dtype=dtype, device=device)
        d = cfg.d_model
        if cfg.q_lora_rank:
            self.wq_a = Dense(d, cfg.q_lora_rank, **kw)
            self.q_norm = RMSNorm(cfg.q_lora_rank, **kw)
            self.wq_b = Dense(cfg.q_lora_rank, H * (nd + rd), **kw)
            self.wq = None
        else:
            self.wq = Dense(d, H * (nd + rd), **kw)
        self.wkv_a = Dense(d, cfg.kv_lora_rank + rd, **kw)
        self.kv_norm = RMSNorm(cfg.kv_lora_rank, **kw)
        self.wkv_b = Dense(cfg.kv_lora_rank, H * (nd + vd), **kw)
        self.wo = Dense(H * vd, d, **kw)


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
                  device) -> dict:
    if cfg.cache_layout == "paged":
        return init_paged_kv_cache(cfg, batch, max_len, dtype, device)
    if cfg.attention_kind == "mla":
        shapes = {"ckv": (batch, max_len, cfg.kv_lora_rank),
                  "krope": (batch, max_len, cfg.qk_rope_head_dim)}
    else:
        shape = (batch, cfg.num_kv_heads, max_len, cfg.resolved_head_dim)
        shapes = {"k": shape, "v": shape}
    cache = {name: torch.zeros(shape, dtype=dtype, device=device)
             for name, shape in shapes.items()}
    cache["pos"] = torch.full((batch, max_len), -1, dtype=torch.int32,
                              device=device)
    return cache


def init_paged_kv_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
                        device, *, num_blocks=None, table=None) -> dict:
    """Paged layer cache.  Without ``table``, identity-stripe tables: row b
    owns blocks [b * nb, (b + 1) * nb) of the pool, nb = ceil(max_len /
    bs).  The logical width stays ``max_len`` (``pos`` is the dense
    layout's), so every gather slices back to it and paged outputs equal
    dense ones.  ``num_blocks``/``table`` let the serving engine supply its
    own pool size (with the block-0 sink) and allocator-issued tables."""
    bs = cfg.kv_block_size
    nb = -(-max_len // bs)
    if table is None:
        table = torch.arange(batch * nb, dtype=torch.int32,
                             device=device).reshape(batch, nb)
        num_blocks = batch * nb if num_blocks is None else num_blocks
    elif tuple(table.shape) != (batch, nb) or num_blocks is None:
        raise ValueError(f"a table of {tuple(table.shape)} for ({batch}, "
                         f"{nb}) rows, num_blocks {num_blocks}")
    if cfg.attention_kind == "mla":
        shapes = {"ckv": (num_blocks, bs, cfg.kv_lora_rank),
                  "krope": (num_blocks, bs, cfg.qk_rope_head_dim)}
    else:
        shape = (num_blocks, cfg.num_kv_heads, bs, cfg.resolved_head_dim)
        shapes = {"k": shape, "v": shape}
    cache = {name: torch.zeros(shape, dtype=dtype, device=device)
             for name, shape in shapes.items()}
    cache["pos"] = torch.full((batch, max_len), -1, dtype=torch.int32,
                              device=device)
    cache["table"] = torch.as_tensor(table, dtype=torch.int32, device=device)
    return cache


def _row_starts(start, B: int, S: int, T: int, device) -> torch.Tensor:
    """(B,) int64 first slot per row, clamped like ``dynamic_update_slice``
    so the T-slot window fits in S."""
    s = torch.as_tensor(start, dtype=torch.int64, device=device
                        ).reshape(-1).expand(B)
    return torch.clamp(s, 0, S - T)


def _cache_write(buf: torch.Tensor, update: torch.Tensor, start,
                 dim: int = -2) -> None:
    """In place: ``buf[b, ..., s_b:s_b+T, (:)] = update[b]`` along ``dim``.

    ``start`` is one slot for the whole batch (prefill, lockstep decode) or
    a (B,) tensor of slots, one per row (the slot engine); each is clamped
    like ``dynamic_update_slice`` so the window fits."""
    T = update.shape[dim]
    S = buf.shape[dim]
    if not isinstance(start, torch.Tensor):
        s = min(max(int(start), 0), S - T)
        buf.narrow(dim, s, T).copy_(update)
        return
    B = buf.shape[0]
    d = dim % buf.ndim
    idx = (_row_starts(start, B, S, T, buf.device)[:, None]
           + torch.arange(T, device=buf.device)[None, :])       # (B, T)
    rows = torch.arange(B, device=buf.device)[:, None]
    # advanced indices on dims 0 and d: move d next to the batch dim
    buf.movedim(d, 1)[rows, idx] = update.movedim(d, 1).to(buf.dtype)


def _paged_write(pool: torch.Tensor, update: torch.Tensor, start,
                 table: torch.Tensor, s_logical: int) -> None:
    """In place: the T-token update (B, Hkv, T, D) lands at logical slots
    [start, start + T) of each row (clamped to the logical width like the
    dense write), token t at ``pool[table[b, (s+t) // bs], :, (s+t) % bs]``.
    An MLA latent pool (NB, bs, r) takes a (B, T, r) update, written
    through a view with one head.

    A block-aligned prefill (one start, T >= bs) writes whole blocks,
    zero-padding a ragged tail (those slots keep pos -1 until a decode step
    claims them); a short update at one start writes token by token, and
    a block at a slot per row (a decode step or a draft block of the slot
    engine and the drafted loops) in one scatter of its (B, T) tokens."""
    if pool.ndim == 3:
        pool, update = pool.unsqueeze(1), update.unsqueeze(1)
    update = update.to(pool.dtype)
    bs = pool.shape[-2]
    B = table.shape[0]
    T = update.shape[2]
    if isinstance(start, torch.Tensor):          # a slot per row
        idx = (_row_starts(start, B, s_logical, T, pool.device)[:, None]
               + torch.arange(T, device=pool.device)[None, :])    # (B, T)
        rows = torch.arange(B, device=pool.device)[:, None]
        # one scatter of the (B, T) tokens: indices on dims 0 and 2 put
        # the (B, T) dims first, then the heads
        pool[table[rows, idx // bs].long(), :, idx % bs] = \
            update.transpose(1, 2)
        return
    s0 = min(max(int(start), 0), s_logical - T)
    if T < bs:
        for t in range(T):
            blk, off = divmod(s0 + t, bs)
            pool[table[:, blk].long(), :, off] = update[:, :, t]
        return
    pad = (-T) % bs
    if pad:
        update = torch.nn.functional.pad(update, (0, 0, 0, pad))
    nbw = (T + pad) // bs
    chunks = update.reshape(B, update.shape[1], nbw, bs, -1)
    for i in range(nbw):
        pool[table[:, s0 // bs + i].long()] = chunks[:, :, i]


def _decode_shaped(cache, causal: bool, T: int, kv_length) -> bool:
    """JAX's ``_decode_shaped``: a cached causal call of one token, or of a
    block of T <= ``DECODE_BLOCK_MAX_T`` that carries its live bounds."""
    return causal and cache is not None and (
        T == 1 or (kv_length is not None and T <= DECODE_BLOCK_MAX_T))


def _decode_attention(q, k, v, q_pos, kv_pos, *, window: int, cache_start,
                      kv_length, kv_start, table=None):
    """Decode-shaped call: live bounds ``[kv_start, kv_length)`` per row.
    With ``table``, k and v are the block pools."""
    B, _, T = q.shape[:3]
    dev = q.device
    if kv_length is None:
        kv_length = torch.as_tensor(cache_start, device=dev) + T
    lengths = torch.as_tensor(kv_length, dtype=torch.int32, device=dev
                              ).reshape(-1).expand(B)
    starts = None if kv_start is None else torch.as_tensor(
        kv_start, dtype=torch.int32, device=dev).reshape(-1).expand(B)
    if window > 0 and starts is not None:
        # contiguous layout: keys at or below start + q_pos - window are
        # outside the window of the earliest query; skip their slots
        qp = q_pos[:, 0].to(torch.int32)
        starts = torch.maximum(starts, starts + qp - window + 1)
    if table is not None:
        return paged_decode_attention(q, k.to(q.dtype), v.to(q.dtype), table,
                                      q_pos, kv_pos, lengths, starts,
                                      window=window)
    return decode_attention(q, k.to(q.dtype), v.to(q.dtype), q_pos, kv_pos,
                            lengths, starts, window=window)


def apply_gqa(p: GQA, cfg: ModelConfig, x, positions, *, cache=None,
              cache_start=None, kv_length=None, kv_start=None,
              causal: bool = True, kv_x=None, kv_positions=None):
    """Self-attention, causal unless ``causal=False`` (an encoder), or
    with ``kv_x`` (B, S, d) and ``kv_positions`` (B, S) a cross-attention
    over them (non-causal, no RoPE).  x: (B, T, d); positions: (B, T)
    int32.  With ``cache`` (a layer's ``{"k", "v": (B, Hkv, S, D), "pos":
    (B, S)}`` views, or its paged pools, ``pos`` and ``table``), writes
    K/V/pos at ``cache_start`` (one slot, or (B,) slots) in place and
    attends over the whole cache.  Returns (out (B, T, d), cache or
    None)."""
    B, T, _ = x.shape
    hd = cfg.resolved_head_dim
    S = (x if kv_x is None else kv_x).shape[1]
    # head counts from the projections: on the mesh a rank holds its heads,
    # and the block's input enters the model-parallel region (its gradient
    # is summed over the model group: every rank's heads read all of it)
    if p.wo.reduce_group is not None:
        x = copy_to_model(x, p.wo.reduce_group)
        if kv_x is not None:
            kv_x = copy_to_model(kv_x, p.wo.reduce_group)
    src = x if kv_x is None else kv_x
    q = apply_dense(p.wq, x)
    if p.gather_q:
        q = gather_heads(q, p.wo.reduce_group)
    Hq = q.shape[-1] // hd
    q = q.view(B, T, Hq, hd).transpose(1, 2)
    k = apply_dense(p.wk, src)
    Hkv = k.shape[-1] // hd
    k = k.view(B, S, Hkv, hd).transpose(1, 2)
    v = apply_dense(p.wv, src).view(B, S, Hkv, hd).transpose(1, 2)
    if p.q_norm is not None:
        q = apply_rmsnorm(p.q_norm, q, cfg.norm_eps)
        k = apply_rmsnorm(p.k_norm, k, cfg.norm_eps)
    if kv_x is None:
        kv_pos = positions
        if cfg.pos_embed == "rope":
            q = apply_rope(q, positions, cfg.rope_theta)
            k = apply_rope(k, positions, cfg.rope_theta)
    else:
        if kv_positions is None or cache is not None:
            raise ValueError("a cross-attention takes kv_positions and no "
                             "cache")
        kv_pos = kv_positions
    q = q.contiguous()

    table = None
    if cache is not None:
        _cache_write(cache["pos"], positions.to(torch.int32), cache_start,
                     dim=-1)
        kv_pos = cache["pos"]
        if "table" in cache:
            table = cache["table"]
            S_log = kv_pos.shape[-1]
            _paged_write(cache["k"], k, cache_start, table, S_log)
            _paged_write(cache["v"], v, cache_start, table, S_log)
        else:
            _cache_write(cache["k"], k.to(cache["k"].dtype), cache_start)
            _cache_write(cache["v"], v.to(cache["v"].dtype), cache_start)
        k, v = cache["k"], cache["v"]

    if needs_grad(q, k, v):
        out = dot_product_attention(q, k.to(q.dtype), v.to(q.dtype),
                                    positions, kv_pos,
                                    window=cfg.sliding_window, causal=causal)
    elif _decode_shaped(cache, causal, T, kv_length):
        out = _decode_attention(q, k, v, positions, kv_pos,
                                window=cfg.sliding_window,
                                cache_start=cache_start, kv_length=kv_length,
                                kv_start=kv_start, table=table)
    else:
        if table is not None:
            S_log = kv_pos.shape[-1]
            k = gather_paged_kv(k, table, S_log)
            v = gather_paged_kv(v, table, S_log)
        out = flash_attention(q, k.to(q.dtype).contiguous(),
                              v.to(q.dtype).contiguous(), positions, kv_pos,
                              causal=causal, window=cfg.sliding_window)
    out = out.transpose(1, 2).reshape(B, T, Hq * hd)
    if p.gather_q:
        out = local_heads(out, p.wo.reduce_group)
    return apply_dense(p.wo, out.to(x.dtype)), cache


def _gather_latent(pool: torch.Tensor, table: torch.Tensor, width: int
                   ) -> torch.Tensor:
    """Dense logical view (B, width, r) of an MLA latent pool (NB, bs, r)."""
    return gather_paged_kv(pool.unsqueeze(1), table, width)[:, 0]


def apply_mla(p: MLA, cfg: ModelConfig, x, positions, *, cache=None,
              cache_start=None, kv_length=None, kv_start=None,
              causal: bool = True):
    """Multi-head latent attention (JAX's ``apply_mla``).  x: (B, T, d);
    positions: (B, T) int32.  With ``cache`` (a layer's ``{"ckv", "krope",
    "pos"}`` views, or its paged pools, ``pos`` and ``table``), writes the
    latent, the RoPE key and pos at ``cache_start`` (one slot, or (B,)
    slots) in place and attends over the whole cache, decompressed.
    Returns (out (B, T, d), cache or None)."""
    B, T, _ = x.shape
    H = cfg.num_heads
    nd, rd, vd = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    r = cfg.kv_lora_rank
    if p.wq is None:
        q = apply_dense(p.wq_b, apply_rmsnorm(
            p.q_norm, apply_dense(p.wq_a, x), cfg.norm_eps))
    else:
        q = apply_dense(p.wq, x)
    q = q.view(B, T, H, nd + rd).transpose(1, 2)
    q = torch.cat([q[..., :nd], apply_rope(q[..., nd:], positions,
                                           cfg.rope_theta)], dim=-1)
    kv_a = apply_dense(p.wkv_a, x)
    ckv = apply_rmsnorm(p.kv_norm, kv_a[..., :r], cfg.norm_eps)
    k_rope = apply_rope(kv_a[:, None, :, r:], positions,
                        cfg.rope_theta)[:, 0]                   # (B, T, rd)

    kv_pos = positions
    if cache is not None:
        _cache_write(cache["pos"], positions.to(torch.int32), cache_start,
                     dim=-1)
        kv_pos = cache["pos"]
        if "table" in cache:
            # paged: the latents live in block pools and are read through
            # the dense gather (decompression needs the whole view anyway)
            table = cache["table"]
            S_log = kv_pos.shape[-1]
            _paged_write(cache["ckv"], ckv, cache_start, table, S_log)
            _paged_write(cache["krope"], k_rope, cache_start, table, S_log)
            ckv = _gather_latent(cache["ckv"], table, S_log)
            k_rope = _gather_latent(cache["krope"], table, S_log)
        else:
            _cache_write(cache["ckv"], ckv, cache_start)
            _cache_write(cache["krope"], k_rope, cache_start)
            ckv, k_rope = cache["ckv"], cache["krope"]

    # decompress the latent to H heads of K (nope ⊕ the shared rope key)
    # and V
    kv = apply_dense(p.wkv_b, ckv.to(x.dtype))
    S = kv.shape[1]
    kv = kv.view(B, S, H, nd + vd).transpose(1, 2)
    k = torch.cat([kv[..., :nd], k_rope.to(x.dtype)[:, None].expand(
        B, H, S, rd)], dim=-1)
    v = kv[..., nd:].contiguous()

    if needs_grad(q, k, v):
        out = dot_product_attention(q, k, v, positions, kv_pos, causal=causal)
    elif _decode_shaped(cache, causal, T, kv_length):
        out = _decode_attention(q, k, v, positions, kv_pos, window=0,
                                cache_start=cache_start, kv_length=kv_length,
                                kv_start=kv_start)
    else:
        out = flash_attention(q, k, v, positions, kv_pos, causal=causal)
    out = out.transpose(1, 2).reshape(B, T, H * vd)
    return apply_dense(p.wo, out.to(x.dtype)), cache


def apply_attention(p: GQA | MLA, cfg: ModelConfig, x, positions, **kw):
    """A block's self-attention: MLA or GQA by the parameters' kind."""
    if isinstance(p, MLA):
        return apply_mla(p, cfg, x, positions, **kw)
    return apply_gqa(p, cfg, x, positions, **kw)
