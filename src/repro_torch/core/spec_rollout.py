"""SPEC-RL speculative rollout (port of ``repro/core/spec_rollout.py``).

Per step, for each prompt: take the cached previous rollout as a draft,
verify it with the current policy over prompt ⊕ draft, keep the accepted
prefix, decode the rest, and assemble ``y = draft[:n] ⊕ continuation``.
A batch with no drafts (cold cache, or ``variant="off"``) is a vanilla
``generate``.  The continuation runs on one of two engine paths:

* **one-pass** (attention trunks, ``spec`` and ``delayed``): the verify
  forward is a prefill, its caches are compacted to the accepted region
  and decoding resumes from them;
* **two-pass** (recurrent trunks such as RWKV6 and jamba's Mamba
  layers, ``one_pass="off"``, and
  the ``random`` and ``full`` ablations): ``left_align`` packs prompt ⊕
  accepted prefix and ``generate`` prefills it again; ``spec`` and
  ``delayed`` first score prompt ⊕ draft (``verify_drafts``).

Variants (paper Table 2 / §4.3): ``spec`` (the method), ``delayed``
(drafts from two visits ago, ``cache_lag`` 2), ``random`` (a uniform
rejection position per row, the draft's stale behaviour log-probs, no
verification pass), ``full`` (ℓ → ∞: reuse every draft whole) and ``off``
(vanilla RLVR).

``backfill="slots"`` drains the batch through the serving slot engine
instead (``serving/rl_adapter.py``: a row that finishes picks up the next
prompt; drafts enter through speculative-prefix admission).

``spec.draft`` (a ``DraftConfig``, off by default) turns on the §9 draft
engine on an attention trunk (``use_drafting``): the vanilla branch decodes
through ``drafted_generate`` with the rows' sibling corpus, the one-pass
branch continues through ``drafted_resume`` from contexts prompt ⊕
``draft[:n]``; the two-pass branch, a recurrent trunk and the ablations
decode vanilla, as in JAX.

``mesh`` (DESIGN.md §8, ``distributed/mesh.py``): a ``DeviceMesh`` with a
data and a model axis and a model cut by ``shard_params``.  The rollout
stays whole on every rank (the ``RolloutBatch``, the ``RolloutCache`` and
the metrics, as JAX's global arrays are); each stage hands the whole
batch's prompts, keys and drafts to its entry point, which runs this data
rank's rows (``generate``, ``verify_and_prefill``, ``realign_decode_cache``,
``resume_from_cache``, the drafted loops) and gathers what they return.
GQA attention with dense FFN or MoE layers runs on the mesh; the other
families come with part 3 of ROADMAP Queue 1 item 11 (the mesh).

§11/§14 observatory, as in JAX: each step draws its stage spans on the
process-global tracer's ``rollout`` lane and feeds the ``rollout.*``
histograms and counters of the process-global registry (the stage stamps
are the timers' own), and, with a ledger configured, lays down one
provenance row per batch row: the prompt, then ``REUSED_PREFIX`` for the
verified prefix and ``FRESH`` for the continuation, finalized against the
row's length.  A drafted continuation is bound to the same rows and
extends them itself (``drafting/engine.py``).  The ledger reads only host
values the step already has (the prompt mask, ``n``, the lengths).

``key`` may be a scalar key (one stream for the batch) or a key batch (one
key per row, ``engine/sampling.py``), which makes every row's tokens
independent of how rows are grouped: the contract slot backfill rests on.

Stage timers wait for the device with ``torch.cuda.synchronize()`` where
JAX calls ``block_until_ready``.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.device import sync
from repro_torch.distributed.mesh import check_mesh_family
from repro_torch.drafting import DraftConfig
from repro_torch.engine.generate import (GenerateConfig, generate,
                                         resume_from_cache)
from repro_torch.engine.sampling import split_key
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.obs import get_ledger, get_registry, get_tracer
from repro_torch.obs.ledger import FRESH, REUSED_PREFIX

from .cache import RolloutCache
from .metrics import DraftStats
from .verify import verify_and_prefill, verify_drafts

VARIANTS = ("off", "spec", "random", "delayed", "full")


@dataclass(frozen=True)
class SpecConfig:
    variant: str = "spec"
    lenience: float = math.e ** 0.5     # paper default for GRPO
    cache_history: int = 4
    one_pass: str = "auto"              # 'auto' | 'on' | 'off' (two-pass)
    backfill: str = "none"              # 'none' | 'slots' (slot engine)
    backfill_slots: int = 0             # decode slots for 'slots'
                                        # (0 -> half the prompt batch)
    cache_max_prompts: Optional[int] = None  # RolloutCache LRU bound
    draft: DraftConfig = DraftConfig()  # §9 continuation draft engine
                                        # (kind='off' = vanilla decoding)

    @property
    def cache_lag(self) -> int:
        return 2 if self.variant == "delayed" else 1

    @property
    def log_lenience(self) -> float:
        return math.log(self.lenience) if math.isfinite(self.lenience) else 1e9


@dataclass
class RolloutBatch:
    """Uniform output consumed by the RL trainer, whatever the variant.

    ``n`` is the per-row verified prefix length (zeros for a vanilla step);
    the JAX package reports it only through its observatory
    (``rollout.reuse_len``)."""
    prompt: np.ndarray            # (B, P) left-padded
    prompt_mask: np.ndarray       # (B, P)
    response: np.ndarray          # (B, N) right-padded
    response_mask: np.ndarray     # (B, N)
    behaviour_logprobs: np.ndarray  # (B, N)
    length: np.ndarray            # (B,)
    metrics: Dict[str, float] = field(default_factory=dict)
    n: Optional[np.ndarray] = None  # (B,)


def left_align(tokens, mask):
    """Shift each row so its last valid token sits in the last column.

    Requires the columns after the last valid one to be padding (true for
    [left-padded prompt | right-padded prefix] layouts).  One gather with
    modular source indices serves every variant: JAX's per-row
    ``impl="roll"`` (kept there for the ``random``/``full`` ablations
    because a dynamic roll lowers poorly on TPU) gives the same result."""
    W = tokens.shape[1]
    idx = torch.arange(W, dtype=torch.int64, device=tokens.device)[None, :]
    end = torch.where(mask, idx + 1, torch.zeros_like(idx)).amax(dim=1)
    shift = W - end
    src = torch.remainder(idx - shift[:, None], W)
    return torch.gather(tokens, 1, src), torch.gather(mask, 1, src)


def assemble(draft_tokens, prefix_lp, n, cont_tokens, cont_lp, cont_len, *,
             pad_id: int = 0):
    """y = draft[:n] ⊕ continuation, right-padded to N columns.
    Returns (tokens, lp, mask, length)."""
    B, N = draft_tokens.shape
    j = torch.arange(N, dtype=torch.int32, device=draft_tokens.device)[None, :]
    in_prefix = j < n[:, None]
    total = n + cont_len
    in_resp = j < total[:, None]
    gather = torch.clamp(j - n[:, None], 0, N - 1).long()
    cont_tok_shift = torch.gather(cont_tokens, 1, gather)
    cont_lp_shift = torch.gather(cont_lp, 1, gather)
    tokens = torch.where(in_prefix, draft_tokens,
                         torch.where(in_resp, cont_tok_shift,
                                     torch.full_like(cont_tok_shift, pad_id)))
    lp = torch.where(in_prefix, prefix_lp,
                     torch.where(in_resp, cont_lp_shift,
                                 torch.zeros_like(cont_lp_shift)))
    return tokens, lp, in_resp, total


def _draft_metrics(stats=None) -> Dict[str, float]:
    """Rollout-metric view of a DraftStats (JAX's zeros when drafting is
    off).  ``accept_rate`` is taken by the SPEC-RL prefix, so the draft
    ratios carry a ``draft_`` prefix; ``tokens_per_forward`` is 1.0 for
    vanilla decoding."""
    st = stats or DraftStats()
    return {"draft_accept_rate": st.accept_rate,
            "draft_mean_len": st.mean_draft_len,
            "tokens_per_forward": st.tokens_per_forward if st.forwards
            else 1.0,
            "decode_forwards": float(st.forwards)}


def _emit_rollout_obs(spec, metrics, t0, stages, n=None):
    """§11 per-step rollout telemetry: stage spans on the 'rollout' lane
    plus registry histograms/counters for the paper's headline diagnostics
    (reuse length, acceptance, lenience).  Host side only: the stage
    endpoints are the perf_counter stamps the metrics already took after
    each stage's device wait, so with the default NULL_TRACER and an idle
    registry this adds no syncs and no clock reads."""
    tr = get_tracer()
    reg = get_registry()
    step = int(metrics.get("step", 0))
    t_end = max((ts + dur) for _, ts, dur in stages)
    if tr.enabled:
        tr.complete("rollout", "rollout", t0, t_end, cat="rollout",
                    step=step, n_reused=metrics.get("n_reused", 0),
                    accept_rate=metrics.get("accept_rate", 0.0))
        for name, ts, dur in stages:
            tr.complete(name, "rollout", ts, ts + dur, cat="rollout",
                        step=step)
    for name, ts, dur in stages:
        reg.observe(f"rollout.{name}_s", dur)
    reg.observe("rollout.step_s", t_end - t0)
    reg.observe("rollout.accept_rate", metrics.get("accept_rate", 0.0))
    reg.set("rollout.lenience", float(spec.lenience)
            if math.isfinite(spec.lenience) else 0.0)
    reg.set("rollout.step", float(step), agg="max")
    reg.inc("rollout.generated_tokens", metrics.get("n_generated", 0))
    reg.inc("rollout.reused_tokens", metrics.get("n_reused", 0))
    if n is not None:
        for v in np.asarray(n).reshape(-1):
            reg.observe("rollout.reuse_len", float(v))


def _ledger_rows(led, B: int, mask_np: np.ndarray):
    """Reserve + begin one §14 provenance row per batch row from the host
    prompt mask.  Returns (row_ids, prompt_lens)."""
    p_np = mask_np.sum(axis=1).astype(np.int64)
    base = led.reserve(B)
    rows = [base + b for b in range(B)]
    for b in range(B):
        led.begin_row(rows[b], int(p_np[b]))
    return rows, p_np


def use_drafting(cfg: ModelConfig, spec: SpecConfig,
                 model_kwargs=None) -> bool:
    """Whether the §9 drafted decode loop replaces the vanilla one: an
    enabled ``spec.draft`` on a trunk whose cache can drop a rejected draft
    and no modality extras (``model.supports_drafting``; a recurrent or
    conditioned trunk decodes vanilla)."""
    return spec.draft.enabled and M.supports_drafting(cfg, model_kwargs)


def use_one_pass(cfg: ModelConfig, spec: SpecConfig,
                 model_kwargs=None) -> bool:
    """Whether the fused verify→compact→resume path applies: per-slot KV
    state in every layer and no vision prefix (whose cache slots the
    compaction does not model)."""
    if spec.variant not in ("spec", "delayed") or spec.one_pass == "off":
        return False
    ok = (M.supports_cache_realign(cfg)
          and (model_kwargs or {}).get("prefix_embeds") is None)
    if spec.one_pass == "on" and not ok:
        raise ValueError("one_pass='on' requires an attention-only trunk "
                         "and no prefix_embeds")
    return ok


def _check_ported(spec: SpecConfig, cfg: ModelConfig, mesh) -> None:
    if spec.variant not in VARIANTS:
        raise ValueError(f"unknown variant {spec.variant!r}")
    if spec.backfill not in ("none", "slots"):
        raise ValueError(f"unknown backfill {spec.backfill!r}")
    if mesh is not None:
        check_mesh_family(cfg, mesh)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


@torch.no_grad()
def rollout(model: M.LM, cfg: ModelConfig, gen: GenerateConfig,
            spec: SpecConfig, prompts, prompt_mask, prompt_ids: Sequence[int],
            cache: Optional[RolloutCache], key, step: int, mesh=None,
            **model_kwargs) -> RolloutBatch:
    """One rollout step for a prompt batch, on the model's device.

    prompts: (B, P) left-padded, prompt_mask: (B, P) (arrays or tensors);
    prompt_ids: stable cache keys; cache: the host-side ``RolloutCache``
    (refreshed in place); key: a scalar key or a key batch
    (``engine.sampling``); ``model_kwargs``: the modality extras of every
    row (``encoder_out`` and ``encoder_positions``, or ``prefix_embeds``),
    passed to each forward as JAX's are.  A vision prefix takes the
    two-pass branch: its continuation re-prefills prompt ⊕ accepted prefix
    behind the same prefix."""
    _check_ported(spec, cfg, mesh)
    if spec.backfill == "slots":
        from repro_torch.serving.rl_adapter import rollout_via_slots
        return rollout_via_slots(model, cfg, gen, spec, prompts, prompt_mask,
                                 prompt_ids, cache, key, step, mesh=mesh,
                                 **model_kwargs)
    dev = model.device
    # the host copy of the mask serves the ledger and the returned batch
    mask_np = _np(prompt_mask).astype(bool)
    prompts = torch.as_tensor(prompts, dtype=torch.int32, device=dev)
    prompt_mask = torch.as_tensor(prompt_mask, dtype=torch.bool, device=dev)
    B, P = prompts.shape
    N = gen.max_new_tokens
    t0 = time.perf_counter()
    metrics: Dict[str, float] = {"step": step}
    led = get_ledger()

    use_cache = spec.variant != "off" and cache is not None
    drafts = cache.batch_get(prompt_ids, N, spec.cache_lag) if use_cache else None
    have_drafts = use_cache and int(drafts["draft_len"].sum()) > 0
    drafting = use_drafting(cfg, spec, model_kwargs)

    if not have_drafts:
        key, sub = split_key(key)
        rows = p_np = None
        if led.enabled:
            rows, p_np = _ledger_rows(led, B, mask_np)
        if drafting:
            from repro_torch.drafting import drafted_generate
            corpus = (cache.batch_siblings(prompt_ids, spec.cache_lag)
                      if use_cache else None)
            # the drafted loop's provenance appends land on these rows
            if rows is not None:
                led.bind(rows)
            try:
                out = drafted_generate(model, cfg, gen, prompts, prompt_mask,
                                       sub, spec.draft, corpus=corpus,
                                       mesh=mesh)
            finally:
                if rows is not None:
                    led.unbind()
        else:
            out = generate(model, cfg, gen, prompts, prompt_mask, sub,
                           mesh=mesh, **model_kwargs)
        resp, lp, length = out["tokens"], out["logprobs"], out["length"]
        resp_mask = torch.arange(N, device=dev)[None, :] < length[:, None]
        n_generated = int(out["n_generated"])
        rollout_time = time.perf_counter() - t0
        metrics.update(
            n_generated=n_generated, n_reused=0,
            verified_prefix_mean=0.0, full_reuse_ratio=0.0,
            accept_rate=0.0, draft_coverage=0.0,
            verify_time=0.0, rollout_time=rollout_time,
            assembly_time=0.0, compact_time=0.0, decode_time=rollout_time,
            one_pass=0.0, prefill_passes=1.0,
            **_draft_metrics(out.get("stats")))
        _emit_rollout_obs(spec, metrics, t0,
                          [("generate", t0, rollout_time)])
        _update_cache(cache, prompt_ids, resp, lp, length, step, gen.eos_id)
        length_np = _np(length)
        if rows is not None:
            for b in range(B):
                if not drafting:   # drafted rows were filled by _DraftLoop
                    led.append(rows[b], FRESH, int(length_np[b]))
                led.finalize(rows[b], int(p_np[b]) + int(length_np[b]))
        return RolloutBatch(
            prompt=_np(prompts), prompt_mask=mask_np,
            response=_np(resp), response_mask=_np(resp_mask),
            behaviour_logprobs=_np(lp), length=length_np, metrics=metrics,
            n=np.zeros((B,), np.int32))

    draft_tokens = torch.as_tensor(drafts["draft_tokens"], device=dev)
    draft_lp = torch.as_tensor(drafts["draft_logprobs"], device=dev)
    draft_len = torch.as_tensor(drafts["draft_len"], device=dev)
    draft_eos = torch.as_tensor(drafts["draft_eos"], device=dev)
    one_pass = use_one_pass(cfg, spec, model_kwargs)
    led_rows = led_p = None
    if led.enabled:
        led_rows, led_p = _ledger_rows(led, B, mask_np)

    # ---- verify: one forward of the current policy over prompt ⊕ draft ---
    # (one-pass: a prefill that fills the caches; two-pass: a score); the
    # random/full ablations take their prefix without one
    tv0 = time.perf_counter()
    ver = None
    if spec.variant in ("spec", "delayed"):
        key, sub = split_key(key)
        verify = verify_and_prefill if one_pass else verify_drafts
        ver = verify(model, cfg, prompts, prompt_mask, draft_tokens, draft_lp,
                     draft_len, sub, spec.log_lenience,
                     temperature=gen.temperature, top_p=gen.top_p,
                     mesh=mesh, **model_kwargs)
        n = ver["n"]
        prefix_lp = ver["lp_curr"]          # current-policy probs (exact)
        accept_rate = float(ver["accept_rate"])
        prefill_passes = 1.0 if one_pass else 2.0
    elif spec.variant == "random":
        # one uniform per row: a scalar key draws (B,) from one stream, a
        # key batch one from each row's key (JAX's vmap'd uniform)
        key, sub = split_key(key)
        frac = sub.uniform((B,)).to(dev)
        n = torch.floor(frac * (draft_len + 1)).to(torch.int32)
        n = torch.minimum(n, draft_len.to(torch.int32))
        prefix_lp = draft_lp                # stale behaviour probs (biased)
        total = int(draft_len.sum())
        accept_rate = float(n.sum().float() / max(total, 1)) if total else 0.0
        prefill_passes = 1.0
    else:  # full
        n = draft_len.to(torch.int32)
        prefix_lp = draft_lp
        accept_rate = 1.0
        prefill_passes = 1.0
    sync(dev)
    verify_time = time.perf_counter() - tv0
    full_reuse = (n == draft_len) & draft_eos

    # ---- one-pass: compact the caches to [prompt | draft[:n]],
    # left-aligned at W; two-pass: left-align prompt ⊕ draft[:n] ----------
    W = P + N
    tc0 = time.perf_counter()
    if one_pass:
        p_len = prompt_mask.sum(dim=1, dtype=torch.int32)
        caches = M.realign_decode_cache(cfg, ver.pop("caches"),
                                        (N - n).to(torch.int32), p_len + n, W,
                                        mesh=mesh)
    else:
        prefix_mask = torch.arange(N, device=dev)[None, :] < n[:, None]
        combined = torch.cat([prompts, torch.where(
            prefix_mask, draft_tokens.to(torch.int32),
            torch.full_like(prompts[:, :1], gen.pad_id))], dim=1)
        aligned, aligned_mask = left_align(
            combined, torch.cat([prompt_mask, prefix_mask], dim=1))
    sync(dev)
    compact_time = time.perf_counter() - tc0

    # ---- decode: one-pass resumes from the compacted cache (no second
    # prefill); two-pass prefills the aligned prefix again ----------------
    td0 = time.perf_counter()
    key, sub = split_key(key)
    if one_pass and drafting:
        # §9: draft the continuation too, the n-gram index seeded with
        # prompt ⊕ accepted prefix and the sibling corpus
        from repro_torch.drafting import drafted_resume
        n_np = _np(n)
        prompts_np, dt_np = _np(prompts), _np(draft_tokens)
        contexts = [np.concatenate([prompts_np[b][mask_np[b]],
                                    dt_np[b, :int(n_np[b])]])
                    for b in range(B)]
        # §14: the verified prefix is reused provenance; the bound rows let
        # the drafted continuation extend them in place
        if led_rows is not None:
            for b in range(B):
                led.append(led_rows[b], REUSED_PREFIX, int(n_np[b]))
            led.bind(led_rows)
        try:
            cont = drafted_resume(model, cfg, gen, caches,
                                  ver["seed_logits"], p_len + n, W, sub,
                                  spec.draft, contexts,
                                  corpus=cache.batch_siblings(
                                      prompt_ids, spec.cache_lag),
                                  initial_done=full_reuse, row_budget=N - n,
                                  mesh=mesh)
        finally:
            if led_rows is not None:
                led.unbind()
        del caches
    elif one_pass:
        cont = resume_from_cache(model, cfg, gen, caches, ver["seed_logits"],
                                 p_len + n, W, sub, initial_done=full_reuse,
                                 row_budget=N - n, mesh=mesh, **model_kwargs)
        del caches
    else:
        cont = generate(model, cfg, gen, aligned, aligned_mask, sub,
                        initial_done=full_reuse, row_budget=N - n,
                        mesh=mesh, **model_kwargs)
    del ver
    sync(dev)
    decode_time = time.perf_counter() - td0
    rollout_time = compact_time + decode_time

    # ---- assembly ----------------------------------------------------------
    ta0 = time.perf_counter()
    resp, lp, resp_mask, length = assemble(
        draft_tokens, prefix_lp, n, cont["tokens"], cont["logprobs"],
        cont["length"], pad_id=gen.pad_id)
    sync(dev)
    assembly_time = time.perf_counter() - ta0

    _update_cache(cache, prompt_ids, resp, lp, length, step, gen.eos_id)
    n_fin, len_fin = _np(n), _np(length)
    if led_rows is not None:
        drafted_cont = one_pass and drafting
        for b in range(B):
            if not drafted_cont:   # drafted rows were extended by _DraftLoop
                led.append(led_rows[b], REUSED_PREFIX, int(n_fin[b]))
                led.append(led_rows[b], FRESH,
                           int(len_fin[b]) - int(n_fin[b]))
            led.finalize(led_rows[b], int(led_p[b]) + int(len_fin[b]))
    metrics.update(
        n_generated=int(cont["n_generated"]),
        n_reused=int(n.sum()),
        verified_prefix_mean=float(n.float().mean()),
        full_reuse_ratio=float(full_reuse.float().mean()),
        accept_rate=accept_rate,
        draft_coverage=float((draft_len > 0).float().mean()),
        verify_time=verify_time, rollout_time=rollout_time,
        assembly_time=assembly_time, compact_time=compact_time,
        decode_time=decode_time, one_pass=float(one_pass),
        prefill_passes=prefill_passes, **_draft_metrics(cont.get("stats")))
    _emit_rollout_obs(spec, metrics, t0,
                      [("verify", tv0, verify_time),
                       ("compact", tc0, compact_time),
                       ("decode", td0, decode_time),
                       ("assembly", ta0, assembly_time)], n=n_fin)
    return RolloutBatch(
        prompt=_np(prompts), prompt_mask=mask_np,
        response=_np(resp), response_mask=_np(resp_mask),
        behaviour_logprobs=_np(lp), length=len_fin, metrics=metrics,
        n=n_fin)


def _update_cache(cache: Optional[RolloutCache], prompt_ids, resp, lp, length,
                  step, eos_id):
    if cache is None:
        return
    cache.batch_put(prompt_ids, _np(resp), _np(lp), _np(length), step, eos_id)
