"""The draft-verify decode step shared by every drafted decode loop (port
of ``repro/drafting/step.py``).

One macro-step replaces up to ``K + 1`` single-token decode steps with ONE
forward of a (K+1)-token block — [current token | K drafted tokens] — and
turns the drafts into kept output by rejection sampling:

1. **forward**: the block is written at the per-row cache slots
   [write_idx, write_idx + K] and attends through the decode kernels
   (``decode_attention`` / ``paged_decode_attention`` at T = K + 1) over
   each row's live bounds.  Draft padding and done rows carry position -1.
2. **verify**: draft token i is scored by the logits at block column i;
   acceptance is the ``spec_verify`` kernel's first-rejection reduction
   with ``lp_prev = 0`` (the n-gram proposal is a point mass) and zero
   lenience: accept g_i iff u_i <= p(g_i).  Under greedy (temperature <=
   0) the log-ratio is built from the argmax (0 on a match, -1e30
   otherwise) against a constant u, so acceptance is exactly "draft ==
   argmax".
3. **accept / truncate**: the vanilla loop's done-semantics are replayed
   over the candidates [cur_tok | accepted drafts]: stop at the first eos
   or when the budget runs out.  Cache slots written past the kept tokens
   get pos -1; the next block overwrites them.
4. **correct**: the next carry token is sampled at block column n, from
   the residual distribution (draft masked) on a rejection and from the
   plain one on a full accept (the bonus token), by
   ``sampling.residual_sample``.

Per-row accepts advance per-row write offsets unevenly: the (write_idx,
budget, count) machinery the slot engine already carries, which is why
this one step serves ``drafted_generate``, ``drafted_resume`` and the slot
engine's draft chunks.  The step takes no ``mesh``, unlike JAX's: on the
mesh it runs a data rank's rows (``drafting/engine.py`` cuts them) with
the model's collectives inside the forward, so ``spec_verify`` runs on
local rows as JAX's ``shard_map`` runs it.
"""
from __future__ import annotations

import torch

from repro_torch.engine.generate import GenerateConfig
from repro_torch.engine.sampling import (logprobs_of, residual_sample,
                                         split_key)
from repro_torch.kernels.spec_verify.ops import spec_verify
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.obs.alerts import register_jit_entry

NEG_INF = -1e30


def _uniforms(key, B: int, K: int) -> torch.Tensor:
    """(B, K) acceptance uniforms: from one scalar key, or row b's from key
    b of a key batch (JAX's vmap'd draw)."""
    return key.uniform((B, K))


def _invalidate_slots(caches, lo, hi) -> None:
    """pos = -1, in place, on cache slots j with lo[b] <= j < hi[b] (the
    rejected drafts' slots)."""
    for run in caches:
        pos = run["self"]["pos"]                      # (run, B, S)
        j = torch.arange(pos.shape[-1], dtype=torch.int32,
                         device=pos.device)[None, :]
        kill = (j >= lo[:, None]) & (j < hi[:, None])  # (B, S)
        pos.masked_fill_(kill[None], -1)


def block_width(max_proposed: int, k_max: int) -> int:
    """The draft width of this macro-step: the power-of-two cover of the
    widest live proposal, capped at the engine's draft_k.  The block is K +
    1 tokens wide whatever gets accepted, so proposing less pays only if
    the width shrinks with it; powers of two keep the distinct widths at
    log2(draft_k) + 1 (T = K + 1 in {2, 3, 5, 9} at draft_k = 8)."""
    w = 1 << max(0, int(max_proposed) - 1).bit_length()
    return max(1, min(w, k_max))


@torch.no_grad()
def draft_step(model: M.LM, cfg: ModelConfig, gen: GenerateConfig, caches,
               cur_tok, cur_lp, done, count, budget, next_pos, write_idx,
               keys, draft_tokens, draft_len, *, K: int, u_width: int = 0):
    """One draft-verify macro-step for all B rows.

    cur_tok/cur_lp: (B,) carry token (sampled, not yet stored) and its
    behaviour log-prob; done/count/budget/next_pos: (B,) vanilla decode
    state (count counts STORED tokens, budget caps them); write_idx: (B,)
    per-row first free cache slot; keys: a scalar key or a key batch;
    draft_tokens: (B, K) right-padded proposals; draft_len: (B,) int32.
    Every tensor is on the model's device; the caches are written in place.

    The caller must have allocated spare cache slots past the last token it
    will keep (``model.pad_cache`` with its draft_k >= K): the block write
    is K + 1 wide whatever gets accepted.

    ``u_width`` (0 = K) is the width of the acceptance-uniform draw, sliced
    to K: engines that bucket K per macro-step (``block_width``) pass their
    draft_k, so a row's draws, and so its sampled stream, do not depend on
    the bucket its co-batched rows chose.

    Returns a dict with the advanced state plus:
      tokens/logprobs (B, K+1)  kept tokens this step, left-packed, padded
      emitted          (B,)     how many of those columns are real
      accepted         (B,)     raw rejection-sampling accepts
      proposed         (B,)     drafts actually verified (0 for done rows)
    """
    if K < 1:
        raise ValueError(f"a draft step verifies K >= 1 drafts, got {K}")
    B = cur_tok.shape[0]
    dev = cur_tok.device
    bidx = torch.arange(K + 1, dtype=torch.int32, device=dev)[None, :]
    zero_i = torch.zeros_like(count)
    eff_len = torch.where(done, zero_i, draft_len.to(torch.int32))
    pad = torch.full_like(cur_tok, gen.pad_id)

    # ---- block forward: [cur_tok | drafts], one write + one attention ----
    tok_store = torch.where(done, pad, cur_tok)
    drafts = torch.where(bidx[:, :K] < eff_len[:, None], draft_tokens,
                         torch.full_like(draft_tokens, gen.pad_id))
    block = torch.cat([tok_store[:, None], drafts.to(tok_store.dtype)],
                      dim=1)                                    # (B, K+1)
    valid = (~done[:, None]) & (bidx <= eff_len[:, None])
    pos_block = torch.where(valid, next_pos[:, None] + bidx,
                            torch.full_like(bidx, -1))
    logits, caches = M.decode_step(
        model, cfg, block, pos_block, caches, write_idx,
        kv_length=write_idx + 1 + K, kv_start=write_idx - next_pos)

    # ---- verify: block column i scores draft i -------------------------
    lp_draft = logprobs_of(logits[:, :K], draft_tokens, gen.temperature,
                           gen.top_p)                           # (B, K)
    if gen.temperature <= 0.0:
        # greedy: accept iff draft == argmax, as an exact log-ratio (0 or
        # -1e30) against a constant uniform; the keys stay unused, as in
        # sample()'s greedy branch
        am = torch.argmax(logits[:, :K], dim=-1)
        lp_acc = torch.where(am == draft_tokens.long(),
                             torch.zeros_like(lp_draft),
                             torch.full_like(lp_draft, NEG_INF))
        u = torch.full((B, K), 0.5, dtype=torch.float32, device=dev)
    else:
        lp_acc = lp_draft
        keys, sub = split_key(keys)
        # drawn at u_width, sliced to K, and made contiguous here: the
        # kernel reads rows of K
        u = _uniforms(sub, B, max(u_width, K))[:, :K].contiguous()
    n = spec_verify(lp_acc, torch.zeros_like(lp_acc), u, eff_len, 0.0)

    # ---- accept/truncate: replay vanilla done-semantics over the kept
    # candidates [cur_tok | draft[:n]] ----------------------------------
    avail = torch.where(done, zero_i, 1 + n)
    is_stop = (block == gen.eos_id) | \
        ((count[:, None] + bidx + 1) >= budget[:, None])
    stop_in = is_stop & (bidx < avail[:, None])
    any_stop = stop_in.any(dim=1)
    first_stop = torch.argmax(stop_in.to(torch.int32), dim=1).to(torch.int32)
    m = torch.where(done, zero_i,
                    torch.where(any_stop, first_stop + 1, avail))
    done_next = done | any_stop

    lp_block = torch.cat([cur_lp[:, None], lp_draft], dim=1)
    emit = bidx < m[:, None]
    toks_out = torch.where(emit, block, torch.full_like(block, gen.pad_id))
    lps_out = torch.where(emit, lp_block, torch.zeros_like(lp_block))

    # invalidate written-but-rejected slots; the next block overwrites them
    _invalidate_slots(caches, write_idx + m, write_idx + K + 1)

    # ---- correction / bonus sample at block column n -------------------
    rows = torch.arange(B, device=dev)
    nxt_logits = logits[rows, n.long()]
    rejected = n < eff_len
    rej_tok = draft_tokens[rows, torch.clamp(n, 0, K - 1).long()]
    keys, sub = split_key(keys)
    nxt, nlp = residual_sample(sub, nxt_logits, rej_tok, rejected,
                               gen.temperature, gen.top_p)

    return {
        "caches": caches,
        "cur_tok": torch.where(done_next, cur_tok, nxt.to(cur_tok.dtype)),
        "cur_lp": torch.where(done_next, cur_lp, nlp),
        "done": done_next,
        "count": count + m,
        "next_pos": next_pos + m,
        "write_idx": write_idx + m,
        "keys": keys,
        "tokens": toks_out,
        "logprobs": lps_out,
        "emitted": m,
        "accepted": torch.minimum(n, eff_len),
        "proposed": eff_len,
    }


# §14 recompile sentinel (obs/alerts.py): draft_step is shared by every
# drafted loop, so its signatures count for all of them
draft_step = register_jit_entry(
    "draft_step", draft_step,
    static=("cfg", "gen", "K", "u_width", "verify_impl", "mesh"))
