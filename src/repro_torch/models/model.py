"""Top-level language model (port of ``repro/models/model.py``, GQA or
MLA trunks with a dense FFN or mixture-of-experts, RWKV6 trunks and
attention + Mamba hybrids): embeddings, trunk, head, the modality
frontends, deepseek-v3's multi-token prediction head (MTP), and the cache
operations of the one-pass rollout (attention trunks only: a recurrent
state cannot be compacted, so a trunk with any RWKV6 or Mamba layer takes
the two-pass branch).  The cache operations run over each run's own
per-slot leaves (``attention.cache_leaves``: GQA's k and v, MLA's ckv and
krope), through the same kernels.

Frontends are stubs, as in JAX: the caller supplies embeddings (B, P,
d_model).  A vision prefix (pixtral, ``prefix_embeds``) goes in front of
the token embeddings, its positions 0..Pv-1 ahead of the tokens', and
comes off before the head.  Audio frames go through ``encode`` (whisper's
encoder: non-causal attention blocks and a final RMSNorm), whose output
and positions (``encoder_out``, ``encoder_positions``) every decoder
block's cross-attention reads.  Learned positions (``pos_table``) are
added to the token embeddings, clipped at ``max_seq_len - 1``.

Entry points mirror JAX's, with the params pytree replaced by an ``LM``:

``forward``      full-sequence logits, no cache.
``prefill``      fills caches at slots [0, T) from a left-padded prompt.
``decode_step``  a short token block against the caches: one token a row,
                 or a (k+1)-token draft-verify block (DESIGN.md §9).

Caches are updated in place and returned (see ``models/blocks.py`` for the
dense and paged layouts).  ``realign_decode_cache`` returns new k/v buffers
for a dense cache (the roll works out of place, as in JAX) and new ``pos``
arrays; a paged cache's pools are gathered, rolled and re-paged in place.
``write_cache_slots`` admits prefilled rows into the slot engine's
persistent cache in place.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed.comm import (copy_to_model, gather_from_model,
                                          reduce_from_model)
from repro_torch.distributed.mesh import DataRows
from repro_torch.kernels.cache_gather.ops import cache_roll, paged_gather
from repro_torch.kernels.cache_slot_write.ops import (cache_slot_write,
                                                      paged_slot_write)

from .attention import cache_leaves
from .blocks import (Block, apply_block, apply_trunk, block_signatures,
                     check_supported, init_trunk_cache, make_block)
from .config import ATTN, ModelConfig
from .layers import Dense, RMSNorm, apply_dense, apply_rmsnorm, softcap

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


def encoder_config(cfg: ModelConfig) -> ModelConfig:
    """The config an encoder's blocks run by (JAX's ``enc_cfg``)."""
    return cfg.replace(num_layers=cfg.encoder_layers, cross_attention=False,
                       num_experts=0, block_kind="attn", attn_period=0)


class Encoder(nn.Module):
    """``{"trunk", "final_norm"}``: the encoder's attention blocks, one
    module a layer, and its final RMSNorm."""

    def __init__(self, cfg: ModelConfig, **kw):
        super().__init__()
        enc_cfg = encoder_config(cfg)
        self.cfg = enc_cfg
        self.trunk = nn.ModuleList(make_block(enc_cfg, sig, **kw)
                                   for sig in block_signatures(enc_cfg))
        self.final_norm = RMSNorm(cfg.d_model, **kw)


class MTP(nn.Module):
    """DeepSeek-V3's multi-token prediction head, ``{"proj", "block",
    "norm"}``: ``proj`` (2 d -> d), one attention block with a dense FFN
    (``d_ff``), and the RMSNorm of the trunk's hidden state."""

    def __init__(self, cfg: ModelConfig, **kw):
        super().__init__()
        self.proj = Dense(2 * cfg.d_model, cfg.d_model, **kw)
        self.block = Block(cfg, **kw)
        self.norm = RMSNorm(cfg.d_model, **kw)


class LM(nn.Module):
    """``{"embed", "layers", "final_norm"[, "lm_head"][, "pos_table"][,
    "encoder"][, "mtp"]}``; ``layers[i]`` is global layer i (JAX stacks
    them per run under ``trunk``)."""

    def __init__(self, cfg: ModelConfig, *, device=None):
        super().__init__()
        cfg.validate()
        check_supported(cfg)
        dtype = torch_dtype(cfg.param_dtype)
        kw = dict(dtype=dtype, device=device)
        self.cfg = cfg
        # every parameter is built frozen (the rollout is inference); the
        # trainer turns grad on for the actor alone
        self.embed = nn.Parameter(torch.empty(cfg.vocab_size, cfg.d_model, **kw),
                                  requires_grad=False)
        self.layers = nn.ModuleList(make_block(cfg, sig, **kw)
                                    for sig in block_signatures(cfg))
        self.final_norm = RMSNorm(cfg.d_model, **kw)
        self.lm_head = (None if cfg.tie_embeddings else
                        Dense(cfg.d_model, cfg.vocab_size, **kw))
        self.pos_table = (nn.Parameter(
            torch.empty(cfg.max_seq_len, cfg.d_model, **kw),
            requires_grad=False) if cfg.pos_embed == "learned" else None)
        self.encoder = Encoder(cfg, **kw) if cfg.encoder_layers else None
        self.mtp = MTP(cfg, **kw) if cfg.mtp else None
        # the mesh's cut (distributed/mesh.py:shard_params): the model
        # group, the vocabulary rows [lo, hi) of a sharded embed, and
        # whether the head's logits are gathered along the vocabulary
        self.tp = None
        self.vocab_shard = None
        self.logits_sharded = False

    @property
    def device(self) -> torch.device:
        return self.embed.device


@torch.no_grad()
def init_lm(cfg: ModelConfig, *, seed: int, device: DeviceLike = None) -> LM:
    """Random parameters from an explicit ``torch.Generator`` seeded with
    ``seed`` on ``device`` (the card unless ``device="cpu"``).  Same
    distributions as ``repro.models.model.init_lm``, not the same numbers:
    tests carry JAX's parameters across with ``convert.from_jax_params``."""
    dev = resolve_device(device)
    model = LM(cfg, device=dev)
    draw_parameters(model, seed)
    return model


@torch.no_grad()
def draw_parameters(module: nn.Module, seed: int) -> None:
    """Fill a module holding ``embed`` and containers with ``reset`` (an
    ``LM``, a critic) from a generator seeded with ``seed`` on its device:
    the embedding normal with std 0.02 (and so a learned position table),
    then each container its own leaves."""
    gen = torch.Generator(device=module.embed.device)
    gen.manual_seed(seed)
    tables = [module.embed]
    if getattr(module, "pos_table", None) is not None:
        tables.append(module.pos_table)
    for table in tables:
        emb = torch.empty(table.shape, dtype=torch.float32,
                          device=table.device)
        emb.normal_(0.0, 1.0, generator=gen)
        table.copy_(emb * 0.02)
        del emb
    for mod in module.modules():
        if hasattr(mod, "reset"):
            mod.reset(gen)


def count_params(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


def _lookup(model, tokens) -> torch.Tensor:
    """Embedding rows of ``tokens`` (of an ``LM`` or a critic).  On the
    mesh a rank holds the rows [lo, hi) of the vocabulary: it looks up the
    tokens it holds, zeroes the others and sums over the model group
    (exact: one rank holds each row; the gradient reaches each rank's rows
    whole)."""
    if getattr(model, "vocab_shard", None) is None:
        return model.embed[tokens.long()]
    lo, hi = model.vocab_shard
    t = tokens.long() - lo
    mine = (t >= 0) & (t < hi - lo)
    rows = model.embed[torch.where(mine, t, torch.zeros_like(t))]
    rows = torch.where(mine[..., None], rows, torch.zeros_like(rows))
    return reduce_from_model(rows, model.tp)


def _embed(model: LM, cfg: ModelConfig, tokens, positions):
    x = _lookup(model, tokens).to(torch_dtype(cfg.dtype))
    if cfg.pos_embed == "learned":
        pos = torch.clamp(positions, 0, cfg.max_seq_len - 1).long()
        x = x + model.pos_table[pos].to(x.dtype)
    return torch.where((positions >= 0)[..., None], x, torch.zeros_like(x))


def _embed_with_prefix(model: LM, cfg: ModelConfig, tokens, positions,
                       prefix_embeds):
    """Token embeddings, behind the vision prefix when there is one
    (``positions`` then covers prefix and tokens, (B, Pv + T))."""
    if prefix_embeds is None:
        return _embed(model, cfg, tokens, positions)
    Pv = prefix_embeds.shape[1]
    x = _embed(model, cfg, tokens, positions[:, Pv:])
    return torch.cat([prefix_embeds.to(x.dtype), x], dim=1)


def _drop_prefix(x, prefix_embeds):
    return x if prefix_embeds is None else x[:, prefix_embeds.shape[1]:]


@torch.no_grad()
def encode(model: LM, cfg: ModelConfig, frames):
    """The whisper encoder over stub frame embeddings (B, F, d_model):
    non-causal attention blocks at positions 0..F-1 (the encoder has no
    positional embedding of its own, as in JAX), then its final RMSNorm.
    Returns (encoder_out (B, F, d_model), encoder_positions (B, F))."""
    frames = torch.as_tensor(frames, device=model.device)
    B, F, _ = frames.shape
    pos = torch.arange(F, dtype=torch.int32, device=model.device
                       )[None].expand(B, F).contiguous()
    x, _, _ = apply_trunk(model.encoder.trunk, model.encoder.cfg,
                          frames.to(torch_dtype(cfg.dtype)), pos,
                          causal=False)
    return apply_rmsnorm(model.encoder.final_norm, x, cfg.norm_eps), pos


def _logits(model: LM, cfg: ModelConfig, x):
    """The head.  A vocabulary-sharded head takes ``x`` into the
    model-parallel region (its gradient summed over the model group) and
    gathers its columns of the logits."""
    if model.logits_sharded:
        x = copy_to_model(x, model.tp)
    if cfg.tie_embeddings:
        logits = x @ model.embed.to(x.dtype).T
    else:
        logits = apply_dense(model.lm_head, x)
    if model.logits_sharded:
        # the rank's vocabulary columns, gathered in the matmul's dtype
        logits = gather_from_model(logits, model.tp, dim=-1)
    return softcap(logits.float(), cfg.logit_softcap)


def forward(model: LM, cfg: ModelConfig, tokens, positions, *,
            encoder_out=None, encoder_positions=None, prefix_embeds=None,
            return_mtp: bool = False, router_stats=None):
    """tokens: (B, T) int; positions: (B, T) int32 with -1 on padding, or
    with ``prefix_embeds`` (B, Pv, d) (B, Pv + T) over prefix and tokens;
    ``encoder_out``/``encoder_positions``: ``encode``'s, for a
    cross-attention trunk.  Returns (logits over the token slots (B, T, V)
    float32, aux dict): a MoE trunk's
    ``moe_lb_loss``, ``moe_z_loss``, ``moe_expert_frac`` and (``dispatch``
    and ``sort``) ``moe_drop_frac``, each averaged over its layers as JAX
    does; ``{}`` without MoE.  Prefill, decode and score ignore them.
    With ``return_mtp`` and an MTP head, also ``mtp_logits`` (B, T, V)
    float32 (``_mtp_logits``); no trainer path reads them.
    ``router_stats``: a list that takes each MoE layer's router statistics
    (``models/moe.py:_router``; the mesh's whole-batch router losses,
    ``distributed/mesh.py:LossRows.router_loss``).

    Carries the graph when grad is enabled and the parameters require it
    (the actor in the train step): the attention and the recurrences then
    take their differentiable routes (``attention.dot_product_attention``,
    ``rwkv.wkv_scan``, ``mamba.ssm_scan``).  Its no-grad callers
    (``score``, ``verify``, the rollout) reach the kernels."""
    x, aux = hidden_states(model, cfg, tokens, positions,
                           encoder_out=encoder_out,
                           encoder_positions=encoder_positions,
                           prefix_embeds=prefix_embeds,
                           router_stats=router_stats)
    if cfg.mtp and return_mtp:
        aux["mtp_logits"] = _mtp_logits(model, cfg, x, tokens,
                                        _drop_prefix(positions, prefix_embeds))
    return _logits(model, cfg, x), aux


def hidden_states(model: LM, cfg: ModelConfig, tokens, positions, *,
                  encoder_out=None, encoder_positions=None,
                  prefix_embeds=None, router_stats=None):
    """``forward`` without the head (JAX's ``return_hidden=True,
    compute_logits=False``): the final norm's output over the token slots
    (B, T, d) and the aux dict."""
    x = _embed_with_prefix(model, cfg, tokens, positions, prefix_embeds)
    x, _, aux = apply_trunk(model.layers, cfg, x, positions,
                            encoder_out=encoder_out,
                            encoder_positions=encoder_positions,
                            router_stats=router_stats)
    x = _drop_prefix(apply_rmsnorm(model.final_norm, x, cfg.norm_eps),
                     prefix_embeds)
    return x, aux


def _mtp_logits(model: LM, cfg: ModelConfig, hidden, tokens, positions):
    """Multi-token prediction (JAX's ``_mtp_logits``): the logits of token
    t + 2 from the RMSNorm of h_t beside the embedding of token t + 1,
    through ``proj`` and the MTP block (no cache), then the head.  The
    last slot's next embedding is zero, and positions do not mask it, as
    in JAX."""
    emb = model.embed
    nxt = tokens[:, 1:].long()
    emb_next = torch.cat([emb[nxt], torch.zeros_like(emb[tokens[:, :1].long()])],
                         dim=1).to(hidden.dtype)
    h = apply_dense(model.mtp.proj, torch.cat(
        [apply_rmsnorm(model.mtp.norm, hidden, cfg.norm_eps), emb_next],
        dim=-1))
    h, _ = apply_block(model.mtp.block, cfg, h, positions)
    return _logits(model, cfg, h)


def cache_config(model: LM, cfg: ModelConfig) -> ModelConfig:
    """The config a model's caches are built by: ``cfg``, with the KV
    heads this rank holds on the mesh (the first attention layer's ``wk``
    columns; every layer is cut alike)."""
    if model.tp is None or cfg.attention_kind != "gqa":
        return cfg
    attn = next(layer.attn for layer in model.layers
                if hasattr(layer, "attn"))
    kv = attn.wk.kernel.shape[1] // cfg.resolved_head_dim
    return cfg if kv == cfg.num_kv_heads else cfg.replace(num_kv_heads=kv)


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: DeviceLike = None):
    return init_trunk_cache(cfg, batch, max_len, torch_dtype(cfg.dtype),
                            resolve_device(device))


@torch.no_grad()
def prefill(model: LM, cfg: ModelConfig, tokens, positions, caches, *,
            encoder_out=None, encoder_positions=None, prefix_embeds=None):
    """Run the prompt through the model, filling caches at slots [0, T)
    (with a vision prefix, [0, Pv + T): the prefix first, ``positions``
    over both as in ``forward``).

    Returns (logits over the token slots (B, T, V), caches)."""
    x = _embed_with_prefix(model, cfg, tokens, positions, prefix_embeds)
    x, caches, _ = apply_trunk(model.layers, cfg, x, positions,
                               caches=caches, cache_start=0,
                               encoder_out=encoder_out,
                               encoder_positions=encoder_positions)
    x = apply_rmsnorm(model.final_norm, x, cfg.norm_eps)
    return _logits(model, cfg, _drop_prefix(x, prefix_embeds)), caches


@torch.no_grad()
def decode_step(model: LM, cfg: ModelConfig, token, position, caches,
                cache_start, *, kv_length=None, kv_start=None,
                encoder_out=None, encoder_positions=None):
    """One decode step over a short token block.

    token, position: (B, T), T = 1 for a decode step or k + 1 for a §9
    draft-verify block (-1 marks done rows and draft padding); cache_start:
    the first slot the block is written at, one int for the whole batch
    (lockstep decode) or (B,) slots, one per row (the slot engine and the
    drafted loops, whose rows sit at their own depths).  The T tokens land
    at slots [cache_start, cache_start + T) before attending, so causality
    inside the block is ordinary position masking.  kv_length: per-row live
    cache extent (int or (B,)); at T = 1 it defaults to ``cache_start +
    1``, and a block of T > 1 reaches the decode kernels only with it given
    (JAX's ``_decode_shaped``; without it the block takes
    ``flash_attention`` over the whole cache).  kv_start: per-row first
    live slot, only for contiguous layouts (not behind a vision prefix).
    Both become (B,) int32 tensors once here, not once per layer.  RWKV and
    Mamba layers ignore cache_start, kv_length and kv_start: their cache
    is a running state.  ``encoder_out``/``encoder_positions`` feed a
    cross-attention trunk at every step.  Returns (logits (B, T, V),
    caches)."""
    B, T = token.shape
    dev = token.device
    if not isinstance(cache_start, int):
        cache_start = torch.as_tensor(cache_start, dtype=torch.int32,
                                      device=dev).reshape(-1).expand(B)
    if kv_length is None and T == 1:
        kv_length = cache_start + T
    if kv_length is not None:
        kv_length = torch.as_tensor(kv_length, dtype=torch.int32, device=dev
                                    ).reshape(-1).expand(B).contiguous()
    if kv_start is not None:
        kv_start = torch.as_tensor(kv_start, dtype=torch.int32, device=dev
                                   ).reshape(-1).expand(B).contiguous()
    x = _embed(model, cfg, token, position)
    x, caches, _ = apply_trunk(model.layers, cfg, x, position, caches=caches,
                               cache_start=cache_start, kv_length=kv_length,
                               kv_start=kv_start, encoder_out=encoder_out,
                               encoder_positions=encoder_positions)
    x = apply_rmsnorm(model.final_norm, x, cfg.norm_eps)
    return _logits(model, cfg, x), caches


def supports_cache_realign(cfg: ModelConfig) -> bool:
    """Compaction needs per-slot KV state in every trunk layer."""
    return all(kind == ATTN for kind, _ in cfg.layer_plan())


def supports_drafting(cfg: ModelConfig, model_kwargs=None) -> bool:
    """Whether the §9 draft-verify decode loop applies: a rejected draft
    token must leave no trace, which an attention cache gives (its slot is
    invalidated, pos -1, and overwritten by the next block) and a recurrent
    state (RWKV6, Mamba) cannot (every forwarded token is folded in).  The gate is
    slot serving's."""
    return supports_slot_serving(cfg, model_kwargs)


@torch.no_grad()
def pad_cache(cfg: ModelConfig, caches, extra: int):
    """Append ``extra`` empty slots (pos -1, zero K/V) to every cache's
    sequence axis: the drafted loop writes a static (k + 1)-token block at
    each row's write offset, so its last step may touch up to ``draft_k``
    slots past the last kept token.  A dense cache gets new buffers; a
    paged one grows its logical width by ``extra`` and its pool only by
    whole blocks (the rounding slack first; then fresh zero blocks at the
    pool's end, one identity stripe of them a row, appended to the tables,
    as JAX's ``_pad_paged_run``).  Returns new caches."""
    if extra <= 0:
        return caches
    if not supports_cache_realign(cfg):
        raise ValueError("pad_cache needs attention trunks")
    F = torch.nn.functional
    new_caches = []
    for run in caches:
        sc = run["self"]
        leaves = cache_leaves(sc)
        new_sc = {"pos": F.pad(sc["pos"], (0, extra), value=-1)}
        if "table" not in sc:
            for name in leaves:
                new_sc[name] = F.pad(sc[name], (0, 0, 0, extra))
            new_caches.append({"self": new_sc})
            continue
        table = sc["table"]
        run_len, B, nb = table.shape
        ref = sc[leaves[0]]
        NB, bs = ref.shape[1], ref.shape[-2]
        add = -(-(sc["pos"].shape[-1] + extra) // bs) - nb
        if add == 0:
            new_sc.update({name: sc[name] for name in leaves}, table=table)
        else:
            fresh = NB + torch.arange(B * add, dtype=torch.int32,
                                      device=table.device).reshape(B, add)
            new_sc["table"] = torch.cat(
                [table, fresh[None].expand(run_len, B, add)], dim=-1)
            for name in leaves:
                # the pool axis (1) grows: pairs of pads from the last axis
                new_sc[name] = F.pad(sc[name], (0, 0) * (sc[name].ndim - 2)
                                     + (0, B * add))
        new_caches.append({"self": new_sc})
    return new_caches


def _roll_rows(buf, shift):
    """Right-rotate ``buf`` (run, B, H, S, D), or an MLA latent (run, B, S,
    r), along the S axis, per-batch shift (B,) int32, over the flattened
    (run, B[, H]) rows as JAX does."""
    lead = buf.shape[:-2]
    reps = 1
    for d in lead:
        reps *= d
    per_b = reps // (lead[0] * lead[1])          # heads folded after batch
    shift_r = (shift.to(torch.int32).repeat_interleave(per_b)
               .repeat(lead[0]).contiguous())
    # a gathered paged view sliced to its logical width is strided
    flat = buf.reshape((reps,) + tuple(buf.shape[-2:])).contiguous()
    return cache_roll(flat, shift_r).reshape(buf.shape)


def _paged_run_gather(sc):
    """Dense logical view of one paged cache run's leaves: {"k", "v": (run,
    B, Hkv, S, D)} or {"ckv", "krope": (run, B, S, r)} with S the logical
    (``pos``) width, through the ``paged_gather`` kernel with heads folded
    into the block rows."""
    table = sc["table"]
    run_len, B, nb = table.shape
    S_log = sc["pos"].shape[-1]
    out = {}
    for name in cache_leaves(sc):
        pool = sc[name]
        NB, bs, D = pool.shape[1], pool.shape[-2], pool.shape[-1]
        H = pool.shape[2] if pool.ndim == 5 else 1
        r0 = torch.arange(run_len, dtype=torch.int32,
                          device=pool.device)[:, None, None]
        tab = (r0 * NB + table.to(torch.int32)).reshape(run_len * B, nb)
        g = paged_gather(pool.view(run_len * NB, H * bs, D), tab)
        g = (g.view(run_len, B, nb, H, bs, D).transpose(2, 3)
             .reshape(run_len, B, H, nb * bs, D)[..., :S_log, :])
        out[name] = g if pool.ndim == 5 else g[:, :, 0]
    return out


def _pad_to_blocks(buf, nb: int, bs: int):
    """Zero-pad a dense logical buffer (..., S, D) to the block-rounded
    width nb * bs so it cuts into whole blocks for re-paging."""
    S = buf.shape[-2]
    if S == nb * bs:
        return buf
    return torch.nn.functional.pad(buf, (0, 0, 0, nb * bs - S))


@torch.no_grad()
def realign_decode_cache(cfg: ModelConfig, caches, shift, valid_len,
                         width: int, mesh=None):
    """Compact verify-prefill caches to the left-aligned decode layout.

    Row b's accepted context occupies slots [P - p_len, P + n) after the
    prefill over [prompt | draft]; rotating right by ``shift[b] = width -
    (P + n[b])`` lands it at [width - valid_len, width).  ``pos`` is
    rewritten in closed form (-1 outside the valid range); only the per-slot
    leaves (k and v, or MLA's ckv and krope) are rolled, so wrapped-in
    slots keep their stale entries, as in JAX.

    A paged cache (§13, identity-stripe tables the rollout owns alone) is
    gathered to its dense logical view (``paged_gather``), rolled like the
    dense one, and re-paged in place through the unchanged tables
    (``paged_slot_write``).  Returns new caches (a dense cache's rolled
    k/v are new tensors).

    ``mesh``: ``caches`` hold this data rank's rows and its KV heads, and
    ``shift`` and ``valid_len`` are the whole batch's; the roll runs on
    the rank's rows."""
    if not supports_cache_realign(cfg):
        raise ValueError("realign needs attention-only trunks")
    rows = DataRows(mesh, len(shift))
    shift, valid_len = rows.take(shift), rows.take(valid_len)
    new_caches = []
    for run in caches:
        sc = run["self"]
        run_len, B, S = sc["pos"].shape
        dev = sc["pos"].device
        j = torch.arange(S, dtype=torch.int32, device=dev)[None, :]
        start = (width - valid_len.to(torch.int32))[:, None]
        pos_row = torch.where((j >= start) & (j < width), j - start,
                              torch.full_like(j, -1))
        new_sc = {"pos": pos_row[None].repeat(run_len, 1, 1)}
        if "table" in sc:
            nb = sc["table"].shape[-1]
            bs = sc[cache_leaves(sc)[0]].shape[-2]
            for name, buf in _paged_run_gather(sc).items():
                rolled = _pad_to_blocks(_roll_rows(buf, shift), nb, bs)
                new_sc[name] = paged_slot_write(sc[name], rolled, sc["table"])
            new_sc["table"] = sc["table"]
        else:
            for name in cache_leaves(sc):
                new_sc[name] = _roll_rows(sc[name], shift)
        new_caches.append({"self": new_sc})
    return new_caches


def supports_slot_serving(cfg: ModelConfig, model_kwargs=None) -> bool:
    """Whether the slot engine (DESIGN.md §6) applies: per-slot KV state in
    every layer and none of the modality extras the persistent decode
    batch does not carry."""
    kw = model_kwargs or {}
    return (supports_cache_realign(cfg)
            and not cfg.encoder_layers
            and not cfg.num_prefix_embeddings
            and kw.get("encoder_out") is None
            and kw.get("prefix_embeds") is None)


@torch.no_grad()
def write_cache_slots(cfg: ModelConfig, dst_caches, src_caches, slots):
    """Admit prefilled rows into the persistent serving batch, in place.

    dst_caches: trunk caches over B slots; src_caches: the same structure
    over R admitted rows (same sequence length); slots: (R,) destination
    slot per source row.  Row ``slots[i]`` of every per-slot buffer (K/V,
    or MLA's latent) is replaced by source row ``i`` through the
    ``cache_slot_write`` kernel on the flattened (run, batch[, head]) rows,
    the layout ``cache_roll`` rolls; the
    last source row wins on a duplicate slot (the admission path pads a
    group by repeating its row 0).  ``pos`` rides a plain scatter.  Every
    other slot is untouched.  Returns dst_caches."""
    if not supports_cache_realign(cfg):
        raise ValueError("slot serving needs attention trunks")
    if any("table" in run["self"] for run in dst_caches):
        return _write_cache_slots_paged(dst_caches, src_caches, slots)
    for dst_run, src_run in zip(dst_caches, src_caches):
        dsc, ssc = dst_run["self"], src_run["self"]
        dev = dsc["pos"].device
        sl = torch.as_tensor(slots, dtype=torch.int64, device=dev)
        dsc["pos"][:, sl] = ssc["pos"]
        for name in cache_leaves(dsc):
            d, s = dsc[name], ssc[name]
            run_len, B = d.shape[:2]
            H = d.shape[2] if d.ndim == 5 else 1
            R = s.shape[1]
            r0 = torch.arange(run_len, device=dev)[:, None, None]
            h = torch.arange(H, device=dev)[None, None, :]
            rows = ((r0 * B + sl[None, :, None]) * H + h).reshape(-1)
            cache_slot_write(d.view((run_len * B * H,) + tuple(d.shape[-2:])),
                             s.reshape((run_len * R * H,) + tuple(s.shape[-2:])),
                             rows)
    return dst_caches


def _write_cache_slots_paged(dst_caches, src_caches, slots):
    """Admit dense prefilled rows into a paged persistent cache (§13), in
    place: each admitted row is re-paged into the blocks its table row
    references (``paged_slot_write``).  The addressed blocks must belong to
    those rows alone.  A dense source narrower than the logical width is
    padded with empty slots (pos -1), and its K/V zero-padded to the
    block-rounded width so the scatter lands on whole blocks."""
    for dst_run, src_run in zip(dst_caches, src_caches):
        dsc, ssc = dst_run["self"], src_run["self"]
        dev = dsc["pos"].device
        sl = torch.as_tensor(slots, dtype=torch.int64, device=dev)
        S_paged, S_src = dsc["pos"].shape[-1], ssc["pos"].shape[-1]
        if S_src > S_paged:
            raise ValueError(f"admitted rows ({S_src} slots) are wider than "
                             f"the paged cache ({S_paged})")
        leaves = cache_leaves(dsc)
        nb = dsc["table"].shape[-1]
        bs = dsc[leaves[0]].shape[-2]
        dsc["pos"][:, sl] = torch.nn.functional.pad(
            ssc["pos"], (0, S_paged - S_src), value=-1)
        table = dsc["table"][:, sl]                      # (run, R, nb)
        for name in leaves:
            paged_slot_write(dsc[name], _pad_to_blocks(ssc[name], nb, bs),
                             table)
    return dst_caches
