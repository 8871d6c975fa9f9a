"""Persistent continuous-batching decode loop over slot-replaced caches
(port of ``repro/serving/engine_loop.py``, its clean path).

The engine keeps ONE decode batch of ``num_slots`` rows alive over dense
``(run, B, Hkv, S, D)`` cache slabs.  Whenever a row emits EOS or exhausts
its per-slot budget, the next queued request is prefilled — through
``verify_and_prefill`` when a cached SPEC-RL draft becomes its speculative
prefix — and written into the freed slot by the ``cache_slot_write``
kernel (``model.write_cache_slots``).  No other row notices: the decode
batch never drains to its slowest member.

Three device programs, as in JAX:

* ``_admit_vanilla``  — prefill an admission group + seed sample;
* ``_admit_spec``     — fused verify+prefill over [prompt | draft], compact
  to the accepted prefix, seed sample at the last accepted token;
* ``_decode_chunk``   — ``chunk_steps`` decode steps for all B slots with
  per-row write offsets (each slot sits at its own depth), per-row keys
  and per-row budgets.  JAX's ``lax.scan`` becomes a host loop whose body
  is term-for-term ``engine/generate._decode_loop``'s (store → count/done
  → ``decode_step`` at the per-row ``write_idx`` with ``kv_length =
  write_idx + 1`` and ``kv_start = write_idx - next_pos`` → split →
  sample), which is what makes slot-scheduled output token-identical to
  fixed-batch ``generate`` under per-row keys.

Host side: numpy state vectors and the ``SlotScheduler``; the slots' keys
stay on the device as one key batch (``engine/sampling.py``), assigned by
row at admission.  Admission groups are padded to ``num_slots`` rows by
repeating their row 0 (the duplicate slot writes carry identical bytes, and
the slot-write kernel's inverted map keeps them deterministic).  Time edges
wait with ``torch.cuda.synchronize()`` where JAX calls
``block_until_ready``.

Left for later slices (a constructor argument that asks for one raises
``NotImplementedError`` naming its ROADMAP item): the §9 draft chunk
(ROADMAP Queue 1 item 6, the draft engine); §10 faults, deadlines,
retries, backoff, quarantine and ``state_dict`` (ROADMAP Queue 1 item 7,
§10 hardening); the §11/§14 tracer, ledger and decision log (ROADMAP
Queue 1 item 9, the observatory hooks); the §8 mesh (ROADMAP Queue 1
item 11, the mesh); the paged engine (ROADMAP Queue 1 item 5, the
PagedSlotEngine).  The §10
decode-implementation ladder (pallas → blocked → naive) is a silent
fallback and is not ported.
"""
from __future__ import annotations

import time
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.verify import verify_and_prefill
from repro_torch.device import sync
from repro_torch.engine.generate import GenerateConfig, positions_from_mask
from repro_torch.engine.sampling import sample, split_key, stack_keys
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig

from .request import (DECODING, FINISH_BUDGET, FINISH_EOS, FINISH_FULL_REUSE,
                      Request, Response)
from .scheduler import SlotScheduler


@torch.no_grad()
def _admit_vanilla(model: M.LM, cfg: ModelConfig, gen: GenerateConfig,
                   prompts, mask, keys):
    """Prefill an admission group; mirrors ``generate`` up to the seed token.

    prompts: (R, P) left-padded; keys: R per-request decode keys.  Returns
    caches sized P + N per row (the layout fixed-batch ``generate``
    builds), the seed token/logprob and the carry keys."""
    R, P = prompts.shape
    caches = M.init_cache(cfg, R, P + gen.max_new_tokens, device=model.device)
    logits, caches = M.prefill(model, cfg, prompts, positions_from_mask(mask),
                               caches)
    keys, sub = split_key(keys)
    tok0, lp0 = sample(sub, logits[:, -1], gen.temperature, gen.top_p)
    return {"caches": caches, "tok0": tok0, "lp0": lp0,
            "next_pos": mask.sum(dim=1, dtype=torch.int32), "keys": keys}


@torch.no_grad()
def _admit_spec(model: M.LM, cfg: ModelConfig, gen: GenerateConfig, prompts,
                mask, draft_tokens, draft_lp, draft_len, draft_eos,
                verify_keys, decode_keys, log_lenience: float):
    """Speculative-prefix admission: one forward over [prompt | draft].

    The fixed-batch one-pass rollout's device program (verify_and_prefill
    → realign_decode_cache → seed sample), so a request admitted here
    continues from the same compacted cache, seed logits and key stream as
    ``rollout`` would give it."""
    R, P = prompts.shape
    N = draft_tokens.shape[1]
    W = P + N
    ver = verify_and_prefill(model, cfg, prompts, mask, draft_tokens,
                             draft_lp, draft_len, verify_keys, log_lenience,
                             temperature=gen.temperature, top_p=gen.top_p)
    n = ver["n"]
    p_len = mask.sum(dim=1, dtype=torch.int32)
    caches = M.realign_decode_cache(cfg, ver.pop("caches"),
                                    (N - n).to(torch.int32), p_len + n, W)
    full_reuse = (n == draft_len) & draft_eos
    keys, sub = split_key(decode_keys)
    tok0, lp0 = sample(sub, ver["seed_logits"], gen.temperature, gen.top_p)
    return {"caches": caches, "tok0": tok0, "lp0": lp0, "n": n,
            "lp_curr": ver["lp_curr"], "full_reuse": full_reuse,
            "next_pos": p_len + n, "keys": keys}


@torch.no_grad()
def _decode_chunk(model: M.LM, cfg: ModelConfig, gen: GenerateConfig, caches,
                  cur_tok, cur_lp, done, count, budget, next_pos, write_idx,
                  keys, *, steps: int):
    """``steps`` decode steps over all slots; per-row write offsets/keys.

    Term-for-term the body of ``engine/generate._decode_loop`` (store →
    count/done update → decode_step → split → sample), except that the
    cache write lands at the per-row ``write_idx`` and the loop never stops
    early: idle and done rows keep stepping with position -1 (masked
    everywhere; the slot is rewritten at its next admission).  The caches
    are written in place."""
    pad = torch.full_like(cur_tok, gen.pad_id)
    zero = torch.zeros_like(cur_lp)
    minus1 = torch.full_like(next_pos, -1)
    toks, lps = [], []
    for _ in range(steps):
        tok_store = torch.where(done, pad, cur_tok)
        toks.append(tok_store)
        lps.append(torch.where(done, zero, cur_lp))
        count = count + (~done).to(torch.int32)
        done_next = done | (cur_tok == gen.eos_id) | (count >= budget)
        # per-row live extents: each slot sits at its own decode depth, so
        # the decode kernel stops at write_idx + 1 and skips the dead left
        # padding below write_idx - next_pos (the admitted context is
        # contiguous: prefill or compacted layout)
        logits, caches = M.decode_step(
            model, cfg, tok_store[:, None],
            torch.where(done, minus1, next_pos)[:, None], caches, write_idx,
            kv_length=write_idx + 1, kv_start=write_idx - next_pos)
        keys, sub = split_key(keys)
        cur_tok, cur_lp = sample(sub, logits[:, 0], gen.temperature,
                                 gen.top_p)
        done = done_next
        next_pos = next_pos + 1
        write_idx = write_idx + 1
    return {"caches": caches, "cur_tok": cur_tok, "cur_lp": cur_lp,
            "done": done, "count": count, "next_pos": next_pos,
            "write_idx": write_idx, "keys": keys,
            "tokens": torch.stack(toks, dim=1),
            "logprobs": torch.stack(lps, dim=1)}       # (B, steps)


def _unported(**asked) -> None:
    """Raise for a constructor argument whose feature a later slice ports."""
    items = {"draft": "the §9 draft chunk (ROADMAP Queue 1 item 6, the "
                      "draft engine)",
             "faults": "§10 fault injection (ROADMAP Queue 1 item 7)",
             "deadline_steps": "§10 deadlines (ROADMAP Queue 1 item 7)",
             "max_queue": "§10 backpressure (ROADMAP Queue 1 item 7)",
             "retry_backoff": "§10 retry backoff (ROADMAP Queue 1 item 7)",
             "tracer": "the §11 tracer (ROADMAP Queue 1 item 9, the "
                       "observatory)",
             "ledger": "the §14 ledger (ROADMAP Queue 1 item 9, the "
                       "observatory)",
             "mesh": "the §8 mesh (ROADMAP Queue 1 item 11)"}
    for name, value in asked.items():
        if value is not None:
            raise NotImplementedError(f"SlotEngine({name}=...): "
                                      f"{items[name]} is not ported yet")


class SlotEngine:
    """Continuous-batching generation engine with spec-prefix admission."""

    def __init__(self, model: M.LM, cfg: ModelConfig, gen: GenerateConfig, *,
                 num_slots: int, prompt_width: int, spec_prefix: bool = False,
                 log_lenience: float = 0.0, chunk_steps: int = 8,
                 draft=None, mesh=None, faults=None, deadline_steps=None,
                 max_queue=None, overflow: str = "reject",
                 retry_backoff=None, tracer=None, ledger=None):
        _unported(draft=draft, mesh=mesh, faults=faults,
                  deadline_steps=deadline_steps, max_queue=max_queue,
                  retry_backoff=retry_backoff, tracer=tracer, ledger=ledger)
        if overflow != "reject":
            raise NotImplementedError("§10 backpressure (ROADMAP Queue 1 "
                                      "item 7) is not ported yet")
        if cfg.cache_layout == "paged":
            raise NotImplementedError("slot serving over a paged cache is "
                                      "the PagedSlotEngine (ROADMAP Queue 1 "
                                      "item 5)")
        if not M.supports_slot_serving(cfg):
            raise ValueError("slot serving needs an attention-only trunk "
                             "without modality extras; use fixed-batch "
                             "generate otherwise")
        self.model, self.cfg, self.gen = model, cfg, gen
        self.device = model.device
        self.P = int(prompt_width)
        self.N = int(gen.max_new_tokens)
        self.spec_prefix = bool(spec_prefix)
        self.log_lenience = float(log_lenience)
        self.chunk_steps = max(1, int(chunk_steps))
        # context ends at write_base; decode token t lands at write_base + t
        # (vanilla: prefill layout [0, P); spec: compacted layout [0, P+N))
        self.write_base = self.P + (self.N if spec_prefix else 0)
        self.cache_len = self.write_base + self.N

        B = int(num_slots)
        self.caches = M.init_cache(cfg, B, self.cache_len, device=self.device)
        self.scheduler = SlotScheduler(B)
        self.cur_tok = np.zeros(B, np.int32)
        self.cur_lp = np.zeros(B, np.float32)
        self.done = np.ones(B, bool)
        self.count = np.zeros(B, np.int32)
        self.budget = np.zeros(B, np.int32)
        self.next_pos = np.zeros(B, np.int32)
        self.write_idx = np.full(B, self.write_base, np.int32)
        self.keys = None        # the slots' key batch, built at first admission
        self._acc_tok: List[List[np.ndarray]] = [[] for _ in range(B)]
        self._acc_lp: List[List[np.ndarray]] = [[] for _ in range(B)]
        self._slot_n = np.zeros(B, np.int32)
        self._slot_draft_len = np.zeros(B, np.int32)
        self._slot_full_reuse = np.zeros(B, bool)
        self._slot_prefix_lp: List[Optional[np.ndarray]] = [None] * B
        self.responses: Dict[int, Response] = {}
        self.steps = 0                      # engine decode steps elapsed
        self.time_admit = 0.0
        self.time_slot_write = 0.0
        self.time_decode = 0.0
        self._t0 = time.perf_counter()

    # ------------------------------------------------------------- frontend

    def _now(self) -> float:
        return time.perf_counter() - self._t0

    def submit(self, req: Request) -> None:
        if len(req.prompt) > self.P or not 0 <= req.max_new_tokens <= self.N:
            raise ValueError(f"request {req.request_id}: prompt of "
                             f"{len(req.prompt)} (width {self.P}) or budget "
                             f"{req.max_new_tokens} (max {self.N}) too large")
        self.scheduler.submit(req, now=self._now())

    def run(self, arrivals: Optional[Iterable[Tuple[int, Request]]] = None,
            max_chunks: Optional[int] = None) -> Dict[int, Response]:
        """Drive the loop until queue + slots drain (and arrivals exhaust).

        arrivals: optional (due_step, Request) stream sorted by due_step —
        requests arriving while the engine runs; the loop idles forward to
        the next due step when it would otherwise drain."""
        it = iter(arrivals) if arrivals is not None else None
        nxt = next(it, None) if it is not None else None
        chunks = 0
        while True:
            while nxt is not None and nxt[0] <= self.steps:
                self.submit(nxt[1])
                nxt = next(it, None)
            self._admit()
            if self.scheduler.idle:
                if nxt is None:
                    break
                self.steps = max(self.steps, int(nxt[0]))  # idle fast-forward
                continue
            self._run_chunk()
            self._harvest()
            chunks += 1
            if max_chunks is not None and chunks >= max_chunks:
                break
        return self.responses

    def stats(self) -> Dict[str, float]:
        sch = self.scheduler.stats()
        out = {k: float(sch[k]) for k in (
            "num_slots", "submitted", "admitted", "completed", "pending",
            "occupancy", "mean_queue_wait", "mean_serve_time")}
        out.update(
            engine_steps=float(self.steps),
            generated_tokens=float(sum(r.length
                                       for r in self.responses.values())),
            reused_tokens=float(sum(r.n_accepted
                                    for r in self.responses.values())),
            admit_time=self.time_admit,
            slot_write_time=self.time_slot_write,
            decode_time=self.time_decode)
        return out

    # ------------------------------------------------------------ admission

    def _pad_group(self, rows: list) -> list:
        """Pad a group to num_slots rows by repeating row 0."""
        return rows + [rows[0]] * (self.scheduler.num_slots - len(rows))

    def _tensor(self, rows: list, dtype) -> torch.Tensor:
        return torch.as_tensor(np.stack(self._pad_group(rows)), dtype=dtype,
                               device=self.device)

    def _admit(self) -> None:
        while True:
            group = self.scheduler.reserve(self._now())
            if not group:
                return
            self._admit_group(group)

    def _prep_prompts(self, reqs: List[Request]):
        prom = np.zeros((len(reqs), self.P), np.int32)
        mask = np.zeros((len(reqs), self.P), bool)
        for j, r in enumerate(reqs):
            L = len(r.prompt)
            prom[j, self.P - L:] = np.asarray(r.prompt, np.int32)
            mask[j, self.P - L:] = True
        return prom, mask

    def _admit_group(self, group: List[Tuple[int, Request]]) -> None:
        t0 = time.perf_counter()
        B = self.scheduler.num_slots
        slots = [s for s, _ in group]
        reqs = [r for _, r in group]
        prom, mask = self._prep_prompts(reqs)
        prompts = self._tensor(list(prom), torch.int32)
        masks = self._tensor(list(mask), torch.bool)
        keys = stack_keys(self._pad_group([r.key for r in reqs]))

        dn = np.zeros((len(group),), np.int32)
        if self.spec_prefix:
            dt = np.zeros((len(group), self.N), np.int32)
            dl = np.zeros((len(group), self.N), np.float32)
            de = np.zeros((len(group),), bool)
            for j, r in enumerate(reqs):
                if r.has_draft:
                    L = min(len(r.draft_tokens), self.N)
                    dt[j, :L] = r.draft_tokens[:L]
                    dl[j, :L] = r.draft_logprobs[:L]
                    dn[j] = L
                    de[j] = r.draft_eos and L == len(r.draft_tokens)
            vkeys = stack_keys(self._pad_group([r.verify_key for r in reqs]))
            out = _admit_spec(
                self.model, self.cfg, self.gen, prompts, masks,
                self._tensor(list(dt), torch.int32),
                self._tensor(list(dl), torch.float32),
                self._tensor(list(dn), torch.int32),
                self._tensor(list(de), torch.bool), vkeys, keys,
                self.log_lenience)
        else:
            out = _admit_vanilla(self.model, self.cfg, self.gen, prompts,
                                 masks, keys)
        sync(self.device)
        t1 = time.perf_counter()
        self.time_admit += t1 - t0

        slot_ids = np.array(slots + [slots[0]] * (B - len(slots)), np.int64)
        self.caches = M.write_cache_slots(self.cfg, self.caches,
                                          out["caches"], slot_ids)
        del out["caches"]
        sync(self.device)
        self.time_slot_write += time.perf_counter() - t1

        def host(name):
            return out[name].cpu().numpy()

        n = host("n") if self.spec_prefix else np.zeros(B, np.int32)
        fr = host("full_reuse") if self.spec_prefix else np.zeros(B, bool)
        lp_curr = host("lp_curr") if self.spec_prefix else None
        self._apply_admission(group, host("tok0"), host("lp0"),
                              host("next_pos"), out["keys"], n, fr, lp_curr,
                              dn)
        # full-reuse / zero-budget admissions finish without decoding;
        # harvesting them here lets the loop keep back-filling
        self._harvest()

    def _apply_admission(self, group, tok0, lp0, npos, nkeys, n, fr,
                         lp_curr, dn) -> None:
        """Per-request host bookkeeping after an admission: state vectors,
        keys, activation.  Arrays are indexed by the request's position
        ``j`` in ``group``."""
        if self.keys is None:
            self.keys = stack_keys([nkeys[0]] * self.scheduler.num_slots)
        for j, (slot, req) in enumerate(group):
            nj = int(n[j])
            budget = max(0, req.max_new_tokens - nj)
            self.cur_tok[slot] = tok0[j]
            self.cur_lp[slot] = lp0[j]
            self.count[slot] = 0
            self.budget[slot] = budget
            self.next_pos[slot] = npos[j]
            self.write_idx[slot] = self.write_base
            self.keys[slot] = nkeys[j]
            self.done[slot] = bool(fr[j]) or budget <= 0
            self._acc_tok[slot] = []
            self._acc_lp[slot] = []
            self._slot_n[slot] = nj
            self._slot_draft_len[slot] = int(dn[j]) if self.spec_prefix else 0
            self._slot_full_reuse[slot] = bool(fr[j])
            self._slot_prefix_lp[slot] = (lp_curr[j] if lp_curr is not None
                                          else None)
            self.scheduler.activate(slot)

    # ---------------------------------------------------------- decode loop

    def _run_chunk(self) -> None:
        steps = self.chunk_steps
        busy = sum(1 for s in self.scheduler.active if not self.done[s])
        dev = self.device

        def dev_t(a):
            return torch.as_tensor(a, device=dev)

        t0 = time.perf_counter()
        out = _decode_chunk(
            self.model, self.cfg, self.gen, self.caches,
            dev_t(self.cur_tok), dev_t(self.cur_lp), dev_t(self.done),
            dev_t(self.count), dev_t(self.budget), dev_t(self.next_pos),
            dev_t(self.write_idx), self.keys, steps=steps)
        self.caches, self.keys = out["caches"], out["keys"]
        toks = out["tokens"].cpu().numpy()          # (B, steps); waits
        lps = out["logprobs"].cpu().numpy()
        for name in ("cur_tok", "cur_lp", "done", "count", "next_pos",
                     "write_idx"):
            setattr(self, name, out[name].cpu().numpy())
        self.time_decode += time.perf_counter() - t0
        for slot in self.scheduler.active:
            self._acc_tok[slot].append(toks[slot])
            self._acc_lp[slot].append(lps[slot])
        self.steps += steps
        self.scheduler.tick(busy, steps)

    # -------------------------------------------------------------- harvest

    def _stitch(self, req: Request, n1: int, plp, toks, lps):
        """Split a serving session's output at the caller's draft boundary
        (JAX's retry-blind split; the identity for a request that was never
        retried, the only kind this slice serves)."""
        base = max(0, int(req.base_draft_len))
        orig = min(n1, base)
        if n1 > orig:
            toks = np.concatenate([np.asarray(req.draft_tokens,
                                              np.int32)[orig:n1], toks])
            lps = np.concatenate([np.asarray(plp, np.float32)[orig:n1], lps])
        return toks.astype(np.int32), lps.astype(np.float32), orig

    def _harvest(self) -> List[Response]:
        eos = self.gen.eos_id
        finished = []
        for slot in [s for s in self.scheduler.active
                     if self.done[s]
                     and self.scheduler.active[s].state == DECODING]:
            req = self.scheduler.active[slot]
            cnt = int(self.count[slot])
            toks = (np.concatenate(self._acc_tok[slot])[:cnt]
                    if self._acc_tok[slot] else np.zeros(0, np.int32))
            lps = (np.concatenate(self._acc_lp[slot])[:cnt]
                   if self._acc_lp[slot] else np.zeros(0, np.float32))
            if self._slot_full_reuse[slot]:
                reason = FINISH_FULL_REUSE
            elif cnt > 0 and toks[-1] == eos:
                reason = FINISH_EOS
            else:
                reason = FINISH_BUDGET
            now = self._now()
            toks, lps, orig = self._stitch(req, int(self._slot_n[slot]),
                                           self._slot_prefix_lp[slot],
                                           toks, lps)
            resp = Response(
                request_id=req.request_id, tokens=toks, logprobs=lps,
                length=len(toks), finish_reason=reason, n_accepted=orig,
                prefix_logprobs=self._slot_prefix_lp[slot],
                draft_len=int(self._slot_draft_len[slot]), slot=slot,
                queue_time=req.admitted_at - req.queued_at,
                serve_time=now - req.admitted_at, retries=req.retries)
            self.responses[req.request_id] = resp
            self.scheduler.complete(slot, now=now)
            self._acc_tok[slot] = []
            self._acc_lp[slot] = []
            self._slot_prefix_lp[slot] = None
            finished.append(resp)
        return finished
