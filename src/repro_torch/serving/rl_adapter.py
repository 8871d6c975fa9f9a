"""RL-side adapter: drain a training prompt batch through the slot engine
(port of ``repro/serving/rl_adapter.py``, variants ``off``, ``spec`` and
``delayed``; as in JAX, the ``random`` and ``full`` ablations have no slot
path).

``core/spec_rollout.rollout`` with ``spec.backfill == 'slots'`` lands here:
instead of one fixed decode batch that idles on its long tail, the batch's
prompts become requests on the ``SlotEngine`` — a row that finishes
immediately picks up the next pending prompt (straggler backfill), with
cached SPEC-RL drafts entering through speculative-prefix admission.

Correctness contract: with per-request keys (a key batch), the
slot-scheduled step is token-identical to the fixed-batch ``rollout``
under the same keys — per-request key streams are split exactly as
``rollout`` splits its key batch, the admission programs are the one-pass
path's device code, and the final assembly is the same ``assemble``.  A
scalar key is first expanded to per-request keys with ``fold_in``
(deterministic, but a different stream from fixed-batch scalar-key
sampling, which draws batch-coupled noise).
"""
from __future__ import annotations

import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.cache import RolloutCache
from repro_torch.core.spec_rollout import (RolloutBatch, SpecConfig, _np,
                                           _update_cache, assemble,
                                           use_drafting, use_one_pass)
from repro_torch.engine.generate import GenerateConfig
from repro_torch.engine.sampling import request_keys, split_key
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig

from .mesh_server import make_slot_engine
from .request import FINISH_FULL_REUSE, Request


def rollout_via_slots(model: M.LM, cfg: ModelConfig, gen: GenerateConfig,
                      spec: SpecConfig, prompts, prompt_mask,
                      prompt_ids: Sequence[int],
                      cache: Optional[RolloutCache], key, step: int,
                      mesh=None, **model_kwargs) -> RolloutBatch:
    """Slot-scheduled equivalent of ``rollout`` (same RolloutBatch
    contract, ``n`` included); the slot engine carries no modality
    extras, so ``model_kwargs`` with any raises.

    Under a ``mesh`` with a data axis the batch drains through the
    ``MeshSlotServer`` (one scheduler per data shard, shard-local
    admission, DESIGN.md §8); a model-only mesh runs one engine over the
    model group.  Either way the per-request key streams keep the output
    token for token the fixed batch's, and the batch is whole on every
    rank."""
    if spec.variant not in ("off", "spec", "delayed"):
        raise ValueError(f"backfill='slots' supports variants off/spec/"
                         f"delayed, not {spec.variant!r}")
    if not M.supports_slot_serving(cfg, model_kwargs):
        raise ValueError("backfill='slots' needs an attention-only trunk "
                         "and no modality extras")
    if spec.variant != "off" and spec.one_pass == "off":
        raise ValueError("backfill='slots' is a one-pass engine path; "
                         "one_pass='off' contradicts it")

    prompts_np = _np(prompts).astype(np.int32)
    mask_np = _np(prompt_mask).astype(bool)
    B, P = prompts_np.shape
    N = gen.max_new_tokens
    num_slots = spec.backfill_slots or max(1, B // 2)
    t0 = time.perf_counter()
    metrics: Dict[str, float] = {"step": step}
    keys = request_keys(key, B)

    use_cache = spec.variant != "off" and cache is not None
    drafts = cache.batch_get(prompt_ids, N, spec.cache_lag) if use_cache \
        else None
    have_drafts = use_cache and int(drafts["draft_len"].sum()) > 0
    if have_drafts:
        assert use_one_pass(cfg, spec)
        # mirror rollout's one-pass splits: verify stream, then decode stream
        keys, verify_keys = split_key(keys)
        keys, decode_keys = split_key(keys)
    else:
        # mirror rollout's vanilla split: one stream for generate
        keys, decode_keys = split_key(keys)
        verify_keys = None

    drafting = use_drafting(cfg, spec)
    engine = make_slot_engine(model, cfg, gen, mesh=mesh,
                              num_slots=num_slots,
                              prompt_width=P, spec_prefix=have_drafts,
                              log_lenience=spec.log_lenience,
                              draft=spec.draft if drafting else None)
    corpora = (cache.batch_siblings(prompt_ids, spec.cache_lag)
               if drafting and use_cache else None)
    for i in range(B):
        p_len = int(mask_np[i].sum())
        req = Request(request_id=i, prompt=prompts_np[i, P - p_len:],
                      key=decode_keys[i], max_new_tokens=N)
        if cache is not None and cache.group_size > 1:
            # GRPO sibling handle (§13): the paged engine prefills each
            # group's shared prompt once and CoW-shares its blocks; dense
            # engines ignore the field
            req.group_id = int(prompt_ids[i]) // cache.group_size
        if have_drafts:
            L = int(drafts["draft_len"][i])
            req.verify_key = verify_keys[i]
            req.draft_tokens = drafts["draft_tokens"][i, :L]
            req.draft_logprobs = drafts["draft_logprobs"][i, :L]
            req.draft_eos = bool(drafts["draft_eos"][i])
        if corpora is not None:
            req.ngram_corpus = corpora[i]
        engine.submit(req)
    responses = engine.run()
    sched = engine.stats()

    # ---- reassemble in training-batch order --------------------------------
    cont_tok = np.zeros((B, N), np.int32)
    cont_lp = np.zeros((B, N), np.float32)
    cont_len = np.zeros((B,), np.int32)
    n = np.zeros((B,), np.int32)
    prefix_lp = np.zeros((B, N), np.float32)
    full_reuse = np.zeros((B,), bool)
    for i in range(B):
        r = responses[i]
        cont_tok[i, :r.length] = r.tokens
        cont_lp[i, :r.length] = r.logprobs
        cont_len[i] = r.length
        n[i] = r.n_accepted
        full_reuse[i] = r.finish_reason == FINISH_FULL_REUSE
        if r.prefix_logprobs is not None:
            prefix_lp[i] = r.prefix_logprobs

    ta0 = time.perf_counter()
    if have_drafts:
        t = torch.as_tensor
        resp, lp, resp_mask, length = (_np(x) for x in assemble(
            t(drafts["draft_tokens"]), t(prefix_lp), t(n), t(cont_tok),
            t(cont_lp), t(cont_len), pad_id=gen.pad_id))
        draft_len = np.asarray(drafts["draft_len"])
        accept_rate = float(n.sum() / max(int(draft_len.sum()), 1))
        draft_coverage = float((draft_len > 0).mean())
    else:
        resp, lp, length = cont_tok, cont_lp, cont_len
        resp_mask = np.arange(N)[None, :] < length[:, None]
        accept_rate = 0.0
        draft_coverage = 0.0
    assembly_time = time.perf_counter() - ta0

    _update_cache(cache, prompt_ids, resp, lp, length, step, gen.eos_id)

    rollout_time = time.perf_counter() - t0
    metrics.update(
        n_generated=int(cont_len.sum()),
        n_reused=int(n.sum()),
        verified_prefix_mean=float(n.mean()),
        full_reuse_ratio=float(full_reuse.mean()),
        accept_rate=accept_rate,
        draft_coverage=draft_coverage,
        verify_time=sched["admit_time"],
        rollout_time=rollout_time,
        assembly_time=assembly_time,
        compact_time=sched["slot_write_time"],
        decode_time=sched["decode_time"],
        one_pass=1.0 if have_drafts else 0.0,
        prefill_passes=1.0,
        backfill_slots=sched["num_slots"],
        engine_steps=sched["engine_steps"],
        slot_occupancy=sched["occupancy"],
        admissions=sched["admitted"],
        # §9 draft telemetry, from the engine's DraftStats
        draft_accept_rate=sched["accept_rate"],
        draft_mean_len=sched["mean_draft_len"],
        tokens_per_forward=sched["tokens_per_forward"] if drafting else 1.0,
        decode_forwards=sched["decode_forwards"])
    return RolloutBatch(
        prompt=prompts_np, prompt_mask=mask_np, response=resp,
        response_mask=resp_mask, behaviour_logprobs=lp, length=length,
        metrics=metrics, n=n)
