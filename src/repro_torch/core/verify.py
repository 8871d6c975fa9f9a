"""SPEC-RL draft verification (port of ``repro/core/verify.py``).

One teacher-forced forward of the current policy over [prompt | draft]
yields ``p_curr``; the accept/first-reject test (``kernels.spec_verify``)
yields the rejection position ``n`` per row.  Two flavours:

* ``verify_drafts``: scoring only (no caches), for the two-pass branch
  (recurrent trunks and ``one_pass="off"``);
* ``verify_and_prefill``: the same forward through ``M.prefill``, so the
  decode caches come out filled, for the one-pass branch.

Both take the modality extras as ``**model_kwargs`` (JAX's): the encoder
memory for either, a vision prefix for the scoring one only (the one-pass
branch does not model its cache slots, ``spec_rollout.use_one_pass``).
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.distributed.mesh import DataRows
from repro_torch.distributed.shard_wrap import sharded_spec_verify
from repro_torch.engine.generate import (model_extras, positions_from_mask,
                                         score)
from repro_torch.engine.sampling import logprobs_of
from repro_torch.kernels.spec_verify.ops import spec_verify
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.obs.alerts import register_jit_entry


def _accept_uniforms(key, B: int, N: int) -> torch.Tensor:
    """Per-token acceptance uniforms u (B, N): one stream for the batch
    from a scalar key, row b's from key b alone from a key batch (so the
    rejection position is a per-request quantity, whatever the admission
    group)."""
    return key.uniform((B, N))


def _packed(prompt, prompt_mask, draft_tokens, draft_len):
    """[prompt | draft] with the draft's padding zeroed, and its mask."""
    N = draft_tokens.shape[1]
    didx = torch.arange(N, dtype=torch.int32, device=prompt.device)[None, :]
    draft_mask = didx < draft_len[:, None]
    full = torch.cat([prompt, torch.where(draft_mask, draft_tokens,
                                          torch.zeros_like(draft_tokens))],
                     dim=1)
    return full, torch.cat([prompt_mask, draft_mask], dim=1)


@torch.no_grad()
def verify_drafts(model: M.LM, cfg: ModelConfig, prompt, prompt_mask,
                  draft_tokens, draft_logprobs, draft_len, key,
                  log_lenience: float, *, temperature: float = 1.0,
                  top_p: float = 1.0, mesh=None, **model_kwargs
                  ) -> Dict[str, torch.Tensor]:
    """prompt: (B, P) left-padded; draft_*: (B, N) right-padded (tensors on
    the model's device).  ``engine.score`` over [prompt | draft] (with the
    extras of ``model_kwargs``), then the accept test.

    Returns ``n`` (B,) int32 in [0, draft_len], ``lp_curr`` (B, N) (the
    current policy's log-probs of the draft tokens) and ``accept_rate``.
    ``mesh``: the score and the accept test run on this data rank's rows
    (JAX's order: the whole scores, then ``sharded_spec_verify``)."""
    B, P = prompt.shape
    N = draft_tokens.shape[1]
    full, mask = _packed(prompt, prompt_mask, draft_tokens, draft_len)
    sc = score(model, cfg, full, mask, temperature=temperature, top_p=top_p,
               mesh=mesh, **model_kwargs)
    lp_curr = sc["logprobs"][:, P:].contiguous()                 # (B, N)
    u = _accept_uniforms(key, B, N)
    n = sharded_spec_verify(mesh, lp_curr, draft_logprobs, u, draft_len,
                            log_lenience)
    total = torch.clamp(draft_len.sum(), min=1)
    return {"n": n, "lp_curr": lp_curr, "accept_rate": n.sum() / total}


@torch.no_grad()
def verify_and_prefill(model: M.LM, cfg: ModelConfig, prompt, prompt_mask,
                       draft_tokens, draft_logprobs, draft_len, key,
                       log_lenience: float, *, temperature: float = 1.0,
                       top_p: float = 1.0, mesh=None, **model_kwargs
                       ) -> Dict[str, torch.Tensor]:
    """prompt: (B, P) left-padded; draft_*: (B, N) right-padded (tensors on
    the model's device); ``model_kwargs``: the encoder memory, if any (a
    vision prefix raises: its cache slots are not compacted).

    Returns ``n`` (B,) int32 in [0, draft_len], ``lp_curr`` (B, N),
    ``accept_rate``, ``caches`` (slots [0, W) = [prompt | draft], width
    W + N) and ``seed_logits`` (B, V), the logits at index P + n - 1 (the
    last prompt token when n == 0).

    Only the logits at [P - 1, W - 1) feed ``lp_curr``; the log-softmax is
    taken over those rows alone (the same values as JAX's full-width pass,
    without its extra (B, P, V) copy).

    ``mesh``: this data rank prefills and verifies its rows (``spec_verify``
    on local rows), so ``caches`` hold its rows alone; ``n``, ``lp_curr``
    and ``seed_logits`` are gathered whole."""
    if model_kwargs.get("prefix_embeds") is not None:
        raise ValueError("verify_and_prefill takes no prefix_embeds: the "
                         "one-pass branch does not compact a vision prefix")
    rows = DataRows(mesh, len(prompt))
    if rows.sharded:
        out = verify_and_prefill(
            model, cfg, *(rows.take(x) for x in (
                prompt, prompt_mask, draft_tokens, draft_logprobs,
                draft_len, key)), log_lenience, temperature=temperature,
            top_p=top_p, **{k: rows.take(v) for k, v in model_kwargs.items()})
        for name in ("n", "lp_curr", "seed_logits"):
            out[name] = rows.gather(out[name])
        out["accept_rate"] = out["n"].sum() / torch.clamp(draft_len.sum(),
                                                          min=1)
        return out
    B, P = prompt.shape
    N = draft_tokens.shape[1]
    W = P + N
    dev = prompt.device
    full, mask = _packed(prompt, prompt_mask, draft_tokens, draft_len)
    positions = positions_from_mask(mask)
    caches = M.init_cache(M.cache_config(model, cfg), B, W + N, device=dev)
    logits, caches = M.prefill(model, cfg, full, positions, caches,
                               **model_extras(model, model_kwargs))

    # logits[t] predicts token t+1 (engine.score's extraction)
    lp = logprobs_of(logits[:, P - 1:W - 1], full[:, P:], temperature, top_p)
    valid = mask[:, P:] & mask[:, P - 1:W - 1]
    lp_curr = torch.where(valid, lp, torch.zeros_like(lp))       # (B, N)
    del lp

    u = _accept_uniforms(key, B, N)
    n = spec_verify(lp_curr, draft_logprobs, u, draft_len, log_lenience)

    seed_idx = (P + n - 1).long()                    # n == 0 -> last prompt tok
    seed_logits = logits[torch.arange(B, device=dev), seed_idx]
    del logits
    total = torch.clamp(draft_len.sum(), min=1)
    return {"n": n, "lp_curr": lp_curr, "accept_rate": n.sum() / total,
            "caches": caches, "seed_logits": seed_logits}


# §14 recompile sentinel (obs/alerts.py): both verify entry points — the
# two-pass scorer and the fused one-pass admission program — under the
# reference's names and its jit's static arguments
verify_drafts = register_jit_entry(
    "verify_drafts", verify_drafts,
    static=("cfg", "temperature", "top_p", "impl", "mesh"))
verify_and_prefill = register_jit_entry(
    "verify_and_prefill", verify_and_prefill,
    static=("cfg", "temperature", "top_p", "impl", "mesh"))
