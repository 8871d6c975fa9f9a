"""Host-driven drafted decode loops (port of ``repro/drafting/engine.py``):
the §9 counterparts of ``engine/generate.generate`` and
``resume_from_cache``.

Drafting needs the host in the loop (the n-gram proposal is a hash-map
lookup), so these run the vanilla loops' stages but step through
``drafting.step.draft_step``, proposing between steps:

    prefill  ->  [propose (host) -> draft_step (device)]*  ->  pack

Contracts, as in JAX:

* the same output dict (``tokens``/``logprobs``/``length``/
  ``n_generated``, on the model's device) plus a ``stats`` DraftStats;
* the same greedy token stream as the vanilla loops (acceptance under
  temperature <= 0 is exactly "draft == argmax", correction is argmax);
* the same per-token marginal under temperature / top-p (the rejection-
  sampling guarantee); with keys that draw as JAX's do, JAX's drafted
  stream token for token;
* caches that end equal to the vanilla loop's over the live region
  (rejected slots get pos -1 and are overwritten).

Each macro-step reads back what the host needs (done flags, carry tokens
and their log-probs, positions, the kept tokens and their log-probs,
emitted/accepted/proposed counts) in one device-to-host transfer.

``mesh=`` (DESIGN.md §8): the whole batch in, the whole outputs out; each
data rank runs the loop over its rows (their proposals, acceptances and
key streams are per row, so nothing crosses rows), and the tokens, the
log-probs, the lengths and the ``DraftStats`` (sums over rows) are
gathered.  The ledger and the decision log are fed from the loop's rows,
which on a data-sharded mesh are a rank's share: the loop writes into
``_ShardSinks``, whose events the data group gathers and replays into the
process's sinks by whole-batch row, in the single process's order (a
row's macro-steps do not depend on the other rows: the acceptance draws
stay at ``u_width``), so every rank holds the single process's records.

§11/§14 observatory, as in JAX, fed only from that readback and the
host's own state: one span per macro-step on the process-global tracer's
``draft`` lane, the ``draft.*_per_step`` histograms, ledger rows (the
caller's rows when it bound them, as the one-pass rollout does; else rows
of the loop's own with each context as the prompt plane) extended by
``categorize_draft_block`` per step, and one decision record per live row
and macro-step (surprisal ``-cur_lp`` of the pending token, position,
acceptance EMA, draft length, source; the outcomes and the step's wall
time).  Clock reads happen only when the tracer or the decision log is on.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.metrics import DraftStats
from repro_torch.distributed.mesh import DataRows
from repro_torch.engine.generate import GenerateConfig, positions_from_mask
from repro_torch.engine.sampling import sample, split_key
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.obs import (get_decision_log, get_ledger, get_registry,
                             get_tracer)
from repro_torch.obs.ledger import SOURCE_NGRAM, categorize_draft_block

from .controller import DraftConfig, DraftController
from .ngram import NGramDraftSource
from .step import block_width, draft_step


@torch.no_grad()
def _prefill_seed(model: M.LM, cfg: ModelConfig, gen: GenerateConfig, prompt,
                  prompt_mask, key, *, extra: int):
    """``generate``'s prefill stage with ``extra`` spare cache slots, plus
    the seed sample, in ``_decode_loop``'s key-split order."""
    B, P = prompt.shape
    positions = positions_from_mask(prompt_mask)
    caches = M.init_cache(M.cache_config(model, cfg), B,
                          P + gen.max_new_tokens + extra,
                          device=model.device)
    logits, caches = M.prefill(model, cfg, prompt, positions, caches)
    seed_logits = logits[:, -1].clone()
    del logits
    key, sub = split_key(key)
    tok0, lp0 = sample(sub, seed_logits, gen.temperature, gen.top_p)
    next_pos = prompt_mask.sum(dim=1, dtype=torch.int32)
    return {"caches": caches, "tok0": tok0, "lp0": lp0,
            "next_pos": next_pos, "key": key}


@torch.no_grad()
def _pad_seed(cfg: ModelConfig, gen: GenerateConfig, caches, seed_logits,
              key, *, extra: int):
    """``resume_from_cache``'s entry: pad the compacted caches with draft
    headroom and seed-sample in the vanilla key-split order."""
    caches = M.pad_cache(cfg, caches, extra)
    key, sub = split_key(key)
    tok0, lp0 = sample(sub, seed_logits, gen.temperature, gen.top_p)
    return {"caches": caches, "tok0": tok0, "lp0": lp0, "key": key}


_ROW_INTS = ("emitted", "accepted", "proposed", "done", "cur_tok", "count",
             "next_pos", "write_idx")


def step_readback(out) -> Dict[str, np.ndarray]:
    """The host's view of a ``draft_step`` result in one device-to-host
    transfer: the kept tokens and log-probs (B, K+1), and per row the
    emitted / accepted / proposed counts, the advanced state (done, carry
    token and its log-prob, count, next_pos, write_idx), as numpy."""
    W = out["tokens"].shape[1]
    cols = [out[name].to(torch.int32) for name in _ROW_INTS]
    ints = torch.cat([
        out["tokens"].to(torch.int32),
        out["logprobs"].float().view(torch.int32),
        torch.stack(cols + [out["cur_lp"].float().view(torch.int32)], dim=1)],
        dim=1).cpu().numpy()
    h = {"tokens": ints[:, :W],
         "logprobs": np.ascontiguousarray(ints[:, W:2 * W]).view(np.float32)}
    for i, name in enumerate(_ROW_INTS):
        h[name] = ints[:, 2 * W + i].copy()
    h["done"] = h["done"].astype(bool)
    h["cur_lp"] = np.ascontiguousarray(ints[:, -1]).view(np.float32)
    return h


class _DraftLoop:
    """Shared host loop: device state vectors + propose/step/harvest."""

    def __init__(self, model: M.LM, cfg: ModelConfig, gen: GenerateConfig,
                 draft: DraftConfig, caches, tok0, lp0, next_pos, key,
                 write_idx, initial_done, row_budget, contexts, corpus,
                 sinks=None):
        dev = model.device
        B = int(next_pos.shape[0])
        N = gen.max_new_tokens
        self.model, self.cfg, self.gen = model, cfg, gen
        self.K = draft.draft_k
        self.caches = caches
        self.cur_tok = tok0
        self.cur_lp = lp0
        self.key = key
        self.next_pos = torch.as_tensor(next_pos, dtype=torch.int32,
                                        device=dev)
        self.write_idx = torch.as_tensor(write_idx, dtype=torch.int32,
                                         device=dev)
        budget = (torch.full((B,), N, dtype=torch.int32, device=dev)
                  if row_budget is None else
                  torch.as_tensor(row_budget, dtype=torch.int32, device=dev))
        done0 = (torch.zeros((B,), dtype=torch.bool, device=dev)
                 if initial_done is None else
                 torch.as_tensor(initial_done, dtype=torch.bool, device=dev))
        self.done = done0 | (budget <= 0)
        self.budget = budget
        self.count = torch.zeros((B,), dtype=torch.int32, device=dev)
        self.source = NGramDraftSource(draft, B)
        self.controller = DraftController(draft, B)
        for b in range(B):
            self.source.reset(b, contexts[b],
                              corpus[b] if corpus is not None else None)
        self.acc_tok: List[List[np.ndarray]] = [[] for _ in range(B)]
        self.acc_lp: List[List[np.ndarray]] = [[] for _ in range(B)]
        self.stats = DraftStats()
        self.B, self.N = B, N
        # §14 provenance: append to the rows the caller bound (the one-pass
        # rollout's continuation extends the rollout's own rows); otherwise
        # reserve rows and lay each row's context down as its prompt plane
        self.ledger = led = sinks.ledger if sinks else get_ledger()
        self.decisions = sinks.decisions if sinks else get_decision_log()
        self._rows: List = [None] * B
        self._carry_bonus = np.zeros(B, bool)
        if led.enabled:
            bound = [led.bound_row(b) for b in range(B)]
            if all(r is not None for r in bound):
                self._rows = bound
            else:
                base = led.reserve(B)
                self._rows = [base + b for b in range(B)]
                for b in range(B):
                    led.begin_row(self._rows[b], len(contexts[b]))

    def run(self) -> Dict[str, torch.Tensor]:
        dev = self.model.device
        tr, reg, led = get_tracer(), get_registry(), self.ledger
        dec = self.decisions
        # the entry readback carries the decision features' carry log-prob
        # and position along with the done flags and carry tokens
        host = torch.stack([self.done.to(torch.int32),
                            self.cur_tok.to(torch.int32),
                            self.cur_lp.float().view(torch.int32),
                            self.next_pos]).cpu().numpy()
        done_np, cur_np = host[0].astype(bool), host[1]
        cur_lp_np = np.ascontiguousarray(host[2]).view(np.float32)
        pos_np = host[3]
        macro_step = 0
        while not done_np.all():
            t0 = (tr.now() if tr.enabled else
                  time.perf_counter() if dec.enabled else 0.0)
            dt = np.zeros((self.B, self.K), np.int32)
            dl = np.zeros((self.B,), np.int32)
            feats: Dict[int, Dict[str, float]] = {}
            for b in range(self.B):
                if done_np[b]:
                    continue
                d = self.source.propose(b, self.controller.draft_len(b),
                                        pending=int(cur_np[b]))
                dt[b, :len(d)] = d
                dl[b] = len(d)
                if dec.enabled:
                    # §14 decision features, captured pre-step (the
                    # fixed-batch loop has no queue or pool: those are 0)
                    feats[b] = {
                        "surprisal": -float(cur_lp_np[b]),
                        "position": float(pos_np[b]),
                        "accept_ema": float(self.controller.rate[b]),
                        "draft_k": float(len(d)),
                        "draft_source": SOURCE_NGRAM,
                        "slot_age": float(macro_step),
                    }
            # the block at the power-of-two cover of the widest live
            # proposal: adaptive lengths narrow the forward; the acceptance
            # draws stay at u_width = draft_k, so streams do not depend on
            # the bucket
            K_step = block_width(int(dl.max()), self.K)
            out = draft_step(
                self.model, self.cfg, self.gen, self.caches, self.cur_tok,
                self.cur_lp, self.done, self.count, self.budget,
                self.next_pos, self.write_idx, self.key,
                torch.as_tensor(dt[:, :K_step], device=dev),
                torch.as_tensor(dl, device=dev), K=K_step, u_width=self.K)
            self.caches = out["caches"]
            for name in ("cur_tok", "cur_lp", "done", "count", "next_pos",
                         "write_idx"):
                setattr(self, name, out[name])
            self.key = out["keys"]
            h = step_readback(out)
            emitted, accepted, proposed = (h["emitted"], h["accepted"],
                                           h["proposed"])
            t1 = (tr.now() if tr.enabled else
                  time.perf_counter() if dec.enabled else 0.0)
            for b in range(self.B):
                mb = int(emitted[b])
                if mb:
                    self.acc_tok[b].append(h["tokens"][b, :mb])
                    self.acc_lp[b].append(h["logprobs"][b, :mb])
                    self.source.extend(b, h["tokens"][b, :mb])
                    if led.enabled:
                        for cat, nrun in categorize_draft_block(
                                mb, bool(self._carry_bonus[b])):
                            led.append(self._rows[b], cat, nrun)
                self._carry_bonus[b] = bool(
                    proposed[b] > 0 and accepted[b] == proposed[b])
                self.controller.update(b, int(proposed[b]), int(accepted[b]))
            if dec.enabled and feats:
                step_ms = (t1 - t0) * 1e3
                for b, f in feats.items():
                    prop, acc = int(proposed[b]), int(accepted[b])
                    mb = int(emitted[b])
                    dec.record(self._rows[b] if self._rows[b] is not None
                               else b, macro_step, f, {
                                   "proposed": prop, "accepted": acc,
                                   "bonus": 1.0 if (prop > 0 and acc == prop
                                                    and mb > acc) else 0.0,
                                   "emitted": mb, "step_ms": step_ms})
            # per-ROW forward counting: one batched forward serves the live
            # rows, so tokens_per_forward is per row with 1.0 as the
            # vanilla baseline
            n_prop, n_acc = int(proposed.sum()), int(accepted.sum())
            n_live, n_em = int((~done_np).sum()), int(emitted.sum())
            self.stats.add_step(forwards=n_live, proposed=n_prop,
                                accepted=n_acc, emitted=n_em,
                                draft_forwards=int((dl > 0).sum()))
            reg.observe("draft.proposed_per_step", n_prop)
            reg.observe("draft.accepted_per_step", n_acc)
            if tr.enabled:
                tr.complete("draft_step", "draft", t0, tr.now(), cat="draft",
                            step=macro_step, live=n_live, proposed=n_prop,
                            accepted=n_acc, emitted=n_em)
            macro_step += 1
            done_np, cur_np = h["done"], h["cur_tok"]
            cur_lp_np, pos_np = h["cur_lp"], h["next_pos"]
        return self._pack()

    def _pack(self) -> Dict[str, torch.Tensor]:
        tokens = np.full((self.B, self.N), self.gen.pad_id, np.int32)
        lps = np.zeros((self.B, self.N), np.float32)
        length = np.zeros((self.B,), np.int32)
        for b in range(self.B):
            row = (np.concatenate(self.acc_tok[b]) if self.acc_tok[b]
                   else np.zeros(0, np.int32))
            lp_row = (np.concatenate(self.acc_lp[b]) if self.acc_lp[b]
                      else np.zeros(0, np.float32))
            L = min(len(row), self.N)
            tokens[b, :L] = row[:L]
            lps[b, :L] = lp_row[:L]
            length[b] = L
        dev = self.model.device
        length_t = torch.as_tensor(length, device=dev)
        return {"tokens": torch.as_tensor(tokens, device=dev),
                "logprobs": torch.as_tensor(lps, device=dev),
                "length": length_t, "n_generated": length_t.sum(),
                "stats": self.stats}


def _require_drafting(cfg: ModelConfig) -> None:
    if not M.supports_drafting(cfg):
        raise ValueError("drafting needs an attention-only trunk (a "
                         "recurrent state cannot drop a rejected draft)")


class _LocalBase:
    """The base of the rows a data shard's loop reserves: ``base + b`` is
    the local row ``("local", lo + b)``, given its ledger id at replay."""

    def __init__(self, lo: int):
        self.lo = lo

    def __add__(self, b: int):
        return ("local", self.lo + int(b))


class _ShardLedger:
    """The ledger protocol of ``_DraftLoop`` over a data shard's rows: the
    bound rows are the caller's whole-batch rows from ``lo``; reserved
    rows are local until replayed; ``begin_row`` and ``append`` are
    recorded."""

    def __init__(self, led, lo: int):
        self.enabled = led.enabled
        self.lo = lo
        self.bound = led._bound[-1] if led.enabled and led._bound else None
        self.reserved = False
        self.events: List = []

    def bound_row(self, b: int):
        return None if self.bound is None else self.bound[self.lo + b]

    def reserve(self, n: int) -> _LocalBase:
        self.reserved = True
        return _LocalBase(self.lo)

    def begin_row(self, rid, prompt_len: int = 0) -> None:
        self.events.append(("begin", rid, int(prompt_len)))

    def append(self, rid, cat: int, n: int = 1) -> None:
        self.events.append(("append", rid, int(cat), int(n)))


class _ShardDecisions:
    def __init__(self, dec):
        self.enabled = dec.enabled
        self.recs: List = []

    def record(self, row, step, features, outcomes) -> None:
        self.recs.append((row, int(step), dict(features), dict(outcomes)))


class _ShardSinks:
    """Where a data shard's drafted loop writes its ledger appends and
    decision records on the mesh; ``replay`` (a collective of the data
    group) gathers every shard's and writes them into the process's
    ledger and decision log as the single process's loop over the whole
    batch would: rows by their whole-batch ids (a loop that reserved its
    rows reserves the whole batch's once), decision records by (macro-step,
    whole-batch row)."""

    def __init__(self, rows: DataRows):
        self.rows = rows
        self.ledger = _ShardLedger(get_ledger(), rows.lo)
        self.decisions = _ShardDecisions(get_decision_log())

    def replay(self) -> None:
        led, dec = get_ledger(), get_decision_log()
        if not (led.enabled or dec.enabled):
            return
        parts = self.rows.gather_objects((self.ledger.events,
                                          self.ledger.reserved,
                                          self.decisions.recs))
        base = (led.reserve(self.rows.batch)
                if any(p[1] for p in parts) else 0)
        pos_of = {rid: i for i, rid in enumerate(self.ledger.bound or ())}

        def rid_of(r):
            return base + r[1] if isinstance(r, tuple) else r

        for events, _, _ in parts:
            for ev in events:
                if ev[0] == "begin":
                    led.begin_row(rid_of(ev[1]), ev[2])
                else:
                    led.append(rid_of(ev[1]), ev[2], ev[3])
        recs = []
        for d, (_, _, shard_recs) in enumerate(parts):
            lo = d * (self.rows.batch // len(parts))
            for row, step, f, o in shard_recs:
                if isinstance(row, tuple):
                    pos, rid = row[1], rid_of(row)
                elif not led.enabled:
                    pos = rid = lo + row            # the loop's own index
                else:
                    pos, rid = pos_of[row], row
                recs.append((step, pos, rid, f, o))
        for step, _, rid, f, o in sorted(recs, key=lambda r: r[:2]):
            dec.record(rid, step, f, o)


def _gather_loop(rows: DataRows, out: Dict) -> Dict:
    """A data shard's drafted outputs joined into the whole batch's."""
    if not rows.sharded:
        return out
    full = {name: rows.gather(out[name])
            for name in ("tokens", "logprobs", "length")}
    full["n_generated"] = full["length"].sum()
    stats = DraftStats()
    for st in rows.gather_objects(out["stats"]):
        stats.add_step(forwards=st.forwards, proposed=st.proposed,
                       accepted=st.accepted, emitted=st.emitted,
                       draft_forwards=st.draft_forwards)
    full["stats"] = stats
    return full


@torch.no_grad()
def drafted_generate(model: M.LM, cfg: ModelConfig, gen: GenerateConfig,
                     prompt, prompt_mask, key, draft: DraftConfig, *,
                     corpus: Optional[Sequence[Sequence[np.ndarray]]] = None,
                     initial_done=None, row_budget=None, mesh=None,
                     _sinks=None) -> Dict[str, torch.Tensor]:
    """``generate`` with the drafted decode loop (same output contract,
    plus ``stats``).  ``corpus[b]`` optionally holds row b's sibling /
    previous-rollout trajectories for the n-gram index.  (``_sinks``: a
    data shard's, from the mesh's own call.)"""
    _require_drafting(cfg)
    rows = DataRows(mesh, len(prompt))
    if rows.sharded:
        sinks = _ShardSinks(rows)
        out = drafted_generate(
            model, cfg, gen, rows.take(prompt), rows.take(prompt_mask),
            rows.take(key), draft, corpus=rows.take(corpus),
            initial_done=rows.take(initial_done),
            row_budget=rows.take(row_budget), _sinks=sinks)
        sinks.replay()
        return _gather_loop(rows, out)
    dev = model.device
    prompt = torch.as_tensor(prompt, dtype=torch.int32, device=dev)
    prompt_mask = torch.as_tensor(prompt_mask, dtype=torch.bool, device=dev)
    B, P = prompt.shape
    pre = _prefill_seed(model, cfg, gen, prompt, prompt_mask, key,
                        extra=draft.draft_k)
    prompt_np = prompt.cpu().numpy()
    mask_np = prompt_mask.cpu().numpy()
    contexts = [prompt_np[b][mask_np[b]] for b in range(B)]
    loop = _DraftLoop(model, cfg, gen, draft, pre["caches"], pre["tok0"],
                      pre["lp0"], pre["next_pos"], pre["key"],
                      np.full((B,), P, np.int32), initial_done, row_budget,
                      contexts, corpus, sinks=_sinks)
    return loop.run()


@torch.no_grad()
def drafted_resume(model: M.LM, cfg: ModelConfig, gen: GenerateConfig,
                   caches, seed_logits, next_pos, write_offset: int, key,
                   draft: DraftConfig, contexts: Sequence[Sequence[int]], *,
                   corpus: Optional[Sequence[Sequence[np.ndarray]]] = None,
                   initial_done=None, row_budget=None, mesh=None,
                   _sinks=None) -> Dict[str, torch.Tensor]:
    """``resume_from_cache`` with the drafted decode loop: the one-pass
    SPEC-RL continuation drafts past the verified prefix (DESIGN.md §9).
    ``contexts[b]`` holds row b's prompt ⊕ accepted-prefix tokens (the
    n-gram index needs the token values; the caches hold only K/V).
    ``mesh``: ``caches`` hold this data rank's rows; the other per-row
    arguments and the outputs are the whole batch's."""
    _require_drafting(cfg)
    rows = DataRows(mesh, len(seed_logits))
    if rows.sharded:
        sinks = _ShardSinks(rows)
        out = drafted_resume(
            model, cfg, gen, caches, rows.take(seed_logits),
            rows.take(next_pos), write_offset, rows.take(key), draft,
            rows.take(contexts), corpus=rows.take(corpus),
            initial_done=rows.take(initial_done),
            row_budget=rows.take(row_budget), _sinks=sinks)
        sinks.replay()
        return _gather_loop(rows, out)
    B = seed_logits.shape[0]
    pre = _pad_seed(cfg, gen, caches, seed_logits, key, extra=draft.draft_k)
    loop = _DraftLoop(model, cfg, gen, draft, pre["caches"], pre["tok0"],
                      pre["lp0"], next_pos, pre["key"],
                      np.full((B,), write_offset, np.int32), initial_done,
                      row_budget, contexts, corpus, sinks=_sinks)
    return loop.run()
