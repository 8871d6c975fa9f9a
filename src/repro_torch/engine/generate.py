"""Batched generation and teacher-forced scoring (port of
``repro/engine/generate.py``).

``generate`` is prefill then the decode loop; ``resume_from_cache`` is the
decode loop alone, started from a populated cache (the one-pass SPEC-RL
entry).  JAX's ``lax.while_loop`` becomes a host loop over a fixed-shape
step that keeps JAX's key-split order and done-row behaviour: a done row
stores the pad token, feeds position -1 (its embedding is zeroed and its
cache slot is still written, with pos -1), and the loop runs until every
row is done or N tokens were taken.

``key`` is a scalar key or a key batch (``engine/sampling.py``); with a key
batch each row samples from its own stream, which is what makes the slot
engine's rows equal a fixed batch's, row for row.

Modality conditioning rides ``**model_kwargs``, as in JAX: ``encoder_out``
and ``encoder_positions`` (``models/model.py:encode``) go to the prefill
and to every decode step; ``prefix_embeds`` (B, Pv, d) goes in front of
the prompt at the prefill only, at positions 0..Pv-1 with the tokens'
shifted by Pv, so its Pv cache slots lie ahead of each row's left padding
and the decode reads the cache from slot 0 (no ``kv_start``).  ``score``
builds those full positions too: the reference's builds positions over
the tokens alone and raises (ROADMAP Queue 3, "Kept on purpose").

``mesh=`` (DESIGN.md §8, ``distributed/mesh.py``): the whole batch goes in
and the whole outputs come out on every rank, as JAX's global arrays;
each data rank runs its own rows with its own caches, the model's
collectives run inside the forward, and the outputs are gathered over the
data group.  A scalar key draws the whole batch's noise on every data
rank and each keeps its rows, so tokens do not depend on the layout.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import torch

from repro_torch.distributed.mesh import DataRows, LossRows
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig

from .sampling import entropy_of, logprobs_of, sample, split_key

PAD = 0


def positions_from_mask(mask: torch.Tensor) -> torch.Tensor:
    """mask: (B, T) bool -> positions (B, T) int32, -1 where invalid."""
    pos = torch.cumsum(mask.to(torch.int32), dim=1, dtype=torch.int32) - 1
    return torch.where(mask, pos, torch.full_like(pos, -1))


@dataclass(frozen=True)
class GenerateConfig:
    max_new_tokens: int = 64
    temperature: float = 1.0
    top_p: float = 1.0
    eos_id: int = 2
    pad_id: int = PAD


def _on(model: M.LM, x, dtype=None) -> torch.Tensor:
    return torch.as_tensor(x, dtype=dtype, device=model.device)


def model_extras(model: M.LM, model_kwargs) -> Dict[str, torch.Tensor]:
    """The encoder memory of ``model_kwargs`` on the model's device (the
    arguments every forward takes)."""
    out = {}
    for name, dtype in (("encoder_out", None),
                        ("encoder_positions", torch.int32)):
        x = model_kwargs.get(name)
        out[name] = None if x is None else _on(model, x, dtype)
    return out


def _prefix(model: M.LM, model_kwargs):
    x = model_kwargs.get("prefix_embeds")
    return None if x is None else _on(model, x)


def prefix_positions(positions: torch.Tensor, Pv: int) -> torch.Tensor:
    """Positions over [vision prefix | tokens]: 0..Pv-1, then the tokens'
    shifted by Pv (-1 stays -1).  (B, Pv + T)."""
    B = positions.shape[0]
    vis = torch.arange(Pv, dtype=torch.int32, device=positions.device
                       )[None].expand(B, Pv)
    return torch.cat([vis, torch.where(positions >= 0, positions + Pv,
                                       torch.full_like(positions, -1))], dim=1)


def _gather_rows(rows: DataRows, out: Dict[str, torch.Tensor]
                 ) -> Dict[str, torch.Tensor]:
    """A data shard's decode outputs joined into the whole batch's."""
    if not rows.sharded:
        return out
    full = {name: rows.gather(out[name])
            for name in ("tokens", "logprobs", "length")}
    full["n_generated"] = full["length"].sum()
    return full


@torch.no_grad()
def generate(model: M.LM, cfg: ModelConfig, gen: GenerateConfig, prompt,
             prompt_mask, key, initial_done=None, row_budget=None,
             mesh=None, **model_kwargs) -> Dict[str, torch.Tensor]:
    """prompt: (B, P) int left-padded; prompt_mask: (B, P) bool (arrays or
    tensors; moved to the model's device); ``model_kwargs``: the modality
    extras (module docstring).  Returns ``tokens`` (B, N), ``logprobs``
    (B, N), ``length`` (B,) and ``n_generated``.

    ``mesh``: the whole batch in, the whole outputs out; this data rank
    prefills and decodes its rows (``distributed/mesh.py:DataRows``)."""
    rows = DataRows(mesh, len(prompt))
    if rows.sharded:
        return _gather_rows(rows, generate(
            model, cfg, gen, rows.take(prompt), rows.take(prompt_mask),
            rows.take(key), rows.take(initial_done), rows.take(row_budget),
            **{k: rows.take(v) for k, v in model_kwargs.items()}))
    prompt = _on(model, prompt, torch.int32)
    prompt_mask = _on(model, prompt_mask, torch.bool)
    B, P = prompt.shape
    N = gen.max_new_tokens
    positions = positions_from_mask(prompt_mask)
    extras = model_extras(model, model_kwargs)
    prefix_embeds = _prefix(model, model_kwargs)
    p_len = prompt_mask.sum(dim=1, dtype=torch.int32)
    Pv = 0 if prefix_embeds is None else prefix_embeds.shape[1]
    if Pv:
        positions = prefix_positions(positions, Pv)
    caches = M.init_cache(M.cache_config(model, cfg), B, P + N + Pv,
                          device=model.device)
    logits, caches = M.prefill(model, cfg, prompt, positions, caches,
                               prefix_embeds=prefix_embeds, **extras)
    # the vision slots [0, Pv) are live ahead of the prompt's left padding:
    # then the context is not contiguous from one start slot
    kv_start = None if Pv else P - p_len
    seed_logits = logits[:, -1].clone()
    del logits
    return _decode_loop(model, cfg, gen, caches, seed_logits, p_len + Pv,
                        P + Pv, key, initial_done, row_budget, extras,
                        kv_start=kv_start)


def _decode_loop(model: M.LM, cfg: ModelConfig, gen: GenerateConfig, caches,
                 seed_logits, next_pos, write_offset: int, key,
                 initial_done, row_budget, extras, kv_start=None
                 ) -> Dict[str, torch.Tensor]:
    """Sample from ``seed_logits``, then decode until every row is done or N
    tokens were taken.  Key-split order is JAX's: one split before the first
    sample, one after every decode step (row by row for a key batch)."""
    B = seed_logits.shape[0]
    N = gen.max_new_tokens
    dev = seed_logits.device
    key, sub = split_key(key)
    cur_tok, cur_lp = sample(sub, seed_logits, gen.temperature, gen.top_p)

    tokens_buf = torch.full((B, N), gen.pad_id, dtype=torch.int32, device=dev)
    lp_buf = torch.zeros((B, N), dtype=torch.float32, device=dev)
    done = (torch.zeros(B, dtype=torch.bool, device=dev) if initial_done is None
            else torch.as_tensor(initial_done, dtype=torch.bool, device=dev))
    budget = (torch.full((B,), N, dtype=torch.int32, device=dev)
              if row_budget is None else
              torch.as_tensor(row_budget, dtype=torch.int32, device=dev))
    done = done | (budget <= 0)
    count = torch.zeros(B, dtype=torch.int32, device=dev)
    next_pos = next_pos.to(torch.int32)
    pad = torch.full_like(cur_tok, gen.pad_id)
    zero = torch.zeros_like(cur_lp)
    minus1 = torch.full_like(next_pos, -1)

    step = 0
    while step < N and not bool(done.all()):
        tok_store = torch.where(done, pad, cur_tok)
        tokens_buf[:, step] = tok_store
        lp_buf[:, step] = torch.where(done, zero, cur_lp)
        count += (~done).to(torch.int32)
        done_next = done | (cur_tok == gen.eos_id) | (count >= budget)
        # live cache extent: [kv_start, write_offset + step] — the dead left
        # padding and the unwritten tail are skipped by the decode kernel
        logits, caches = M.decode_step(
            model, cfg, tok_store[:, None],
            torch.where(done, minus1, next_pos)[:, None],
            caches, write_offset + step,
            kv_length=write_offset + 1 + step, kv_start=kv_start, **extras)
        key, sub = split_key(key)
        cur_tok, cur_lp = sample(sub, logits[:, 0], gen.temperature, gen.top_p)
        done = done_next
        next_pos = next_pos + 1
        step += 1
    return {"tokens": tokens_buf, "logprobs": lp_buf, "length": count,
            "n_generated": count.sum()}


@torch.no_grad()
def resume_from_cache(model: M.LM, cfg: ModelConfig, gen: GenerateConfig,
                      caches, seed_logits, next_pos, write_offset: int, key,
                      initial_done=None, row_budget=None, mesh=None,
                      **model_kwargs) -> Dict[str, torch.Tensor]:
    """Continue decoding from a compacted cache: slots [0, write_offset)
    hold [left-aligned prompt ⊕ accepted prefix]; seed_logits (B, V) are the
    logits of the last accepted token; next_pos (B,) = prompt_len + n;
    ``model_kwargs``: the encoder memory, if any.  Returns the same dict as
    ``generate``.

    ``mesh``: ``caches`` hold this data rank's rows (as
    ``verify_and_prefill`` and ``realign_decode_cache`` leave them); every
    other per-row argument is the whole batch's, and so are the outputs."""
    rows = DataRows(mesh, len(seed_logits))
    if rows.sharded:
        return _gather_rows(rows, resume_from_cache(
            model, cfg, gen, caches, rows.take(seed_logits),
            rows.take(next_pos), write_offset, rows.take(key),
            rows.take(initial_done), rows.take(row_budget),
            **{k: rows.take(v) for k, v in model_kwargs.items()}))
    next_pos = next_pos.to(torch.int32)
    return _decode_loop(model, cfg, gen, caches, seed_logits, next_pos,
                        write_offset, key, initial_done, row_budget,
                        model_extras(model, model_kwargs),
                        kv_start=write_offset - next_pos)


@torch.no_grad()
def score(model: M.LM, cfg: ModelConfig, tokens, mask, *,
          temperature: float = 1.0, top_p: float = 1.0,
          return_entropy: bool = False, mesh=None, **model_kwargs
          ) -> Dict[str, torch.Tensor]:
    """Teacher-forced log-prob of every token given its prefix (and the
    modality extras of ``model_kwargs``; with a vision prefix the
    positions cover it, as ``generate``'s prefill does).
    tokens: (B, L) left-padded; mask: (B, L) bool.  ``mesh``: this data
    rank scores its rows; the outputs are the whole batch's."""
    rows = DataRows(mesh, len(tokens))
    if rows.sharded:
        out = score(model, cfg, rows.take(tokens), rows.take(mask),
                    temperature=temperature, top_p=top_p,
                    return_entropy=return_entropy,
                    **{k: rows.take(v) for k, v in model_kwargs.items()})
        return {name: rows.gather(t) for name, t in out.items()}
    tokens = _on(model, tokens, torch.int32)
    mask = _on(model, mask, torch.bool)
    positions = positions_from_mask(mask)
    prefix_embeds = _prefix(model, model_kwargs)
    if prefix_embeds is not None:
        positions = prefix_positions(positions, prefix_embeds.shape[1])
    logits, _ = M.forward(model, cfg, tokens, positions,
                          prefix_embeds=prefix_embeds,
                          **model_extras(model, model_kwargs))
    lp_next = logprobs_of(logits[:, :-1], tokens[:, 1:], temperature, top_p)
    lp = torch.cat([torch.zeros_like(lp_next[:, :1]), lp_next], dim=1)
    valid = mask & torch.cat([torch.zeros_like(mask[:, :1]), mask[:, :-1]],
                             dim=1)
    out = {"logprobs": torch.where(valid, lp, torch.zeros_like(lp)),
           "valid": valid}
    if return_entropy:
        ent = entropy_of(logits[:, :-1], temperature)
        ent = torch.cat([torch.zeros_like(ent[:, :1]), ent], dim=1)
        out["entropy"] = torch.where(valid, ent, torch.zeros_like(ent))
    return out


@torch.no_grad()
def moe_aux(model: M.LM, cfg: ModelConfig, tokens, mask, *, mesh=None
            ) -> Dict[str, torch.Tensor]:
    """A MoE trunk's aux diagnostics of a no-grad forward over ``tokens``
    (B, L) left-padded with ``mask`` (B, L) bool: ``moe_lb_loss``,
    ``moe_z_loss``, ``moe_expert_frac`` and (``dispatch``, ``sort``)
    ``moe_drop_frac``, each its layers' mean, over the whole batch.
    ``mesh``: this data rank runs its rows and the values are the whole
    batch's, as JAX's global forward gives them
    (``distributed/mesh.py:LossRows.whole_aux``)."""
    rows = LossRows(mesh, len(tokens))
    tokens = _on(model, rows.take(tokens), torch.int32)
    mask = _on(model, rows.take(mask), torch.bool)
    stats: list = []
    _, aux = M.forward(model, cfg, tokens, positions_from_mask(mask),
                       router_stats=stats)
    return rows.whole_aux(cfg, aux, stats)


def token_logprobs(model: M.LM, cfg: ModelConfig, tokens, mask,
                   temperature: float = 1.0, top_p: float = 1.0, *,
                   entropy_grad: bool = False, router_stats=None):
    """Teacher-forced log-prob and entropy of every token given its prefix,
    carrying the graph (the differentiable part of JAX's
    ``_actor_loss_fn``): forward, ``logprobs_of`` and ``entropy_of`` of the
    logits, shifted by one so that column t holds token t's (column 0 is
    0).  Unlike ``score``, nothing is masked: the loss masks.

    The entropy carries a graph only with ``entropy_grad`` (an entropy
    bonus in the loss); otherwise it is computed from detached logits, so
    its float32 (B, L, V) intermediates are not kept for a backward that
    never reads them.  Returns (logprobs (B, L), entropy (B, L), aux): the
    forward's aux dict (a MoE trunk's router losses, with their graph;
    ``{}`` without MoE).  ``router_stats``: as ``models/model.py:
    forward``'s."""
    tokens = _on(model, tokens, torch.int32)
    mask = _on(model, mask, torch.bool)
    positions = positions_from_mask(mask)
    logits, aux = M.forward(model, cfg, tokens, positions,
                            router_stats=router_stats)
    lp_next = logprobs_of(logits[:, :-1], tokens[:, 1:], temperature, top_p)
    lp = torch.cat([torch.zeros_like(lp_next[:, :1]), lp_next], dim=1)
    with torch.set_grad_enabled(entropy_grad and torch.is_grad_enabled()):
        src = logits if entropy_grad else logits.detach()
        ent_next = entropy_of(src[:, :-1], temperature)
    ent = torch.cat([torch.zeros_like(ent_next[:, :1]), ent_next], dim=1)
    return lp, ent, aux
