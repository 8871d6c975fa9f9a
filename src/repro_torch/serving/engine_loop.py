"""Persistent continuous-batching decode loop over slot-replaced caches
(port of ``repro/serving/engine_loop.py``).

The engine keeps ONE decode batch of ``num_slots`` rows alive — over dense
``(run, B, Hkv, S, D)`` cache slabs, or over a paged block pool when built
as the ``PagedSlotEngine`` subclass (serving/paged_engine.py, DESIGN.md
§13).  Whenever a row emits EOS or exhausts its per-slot budget, the next
queued request is prefilled — through ``verify_and_prefill`` when a cached
SPEC-RL draft becomes its speculative prefix — and written into the freed
slot by the ``cache_slot_write`` kernel (``model.write_cache_slots``).  No
other row notices: the decode batch never drains to its slowest member.

Three device programs, as in JAX:

* ``_admit_vanilla``  — prefill an admission group + seed sample (the seed
  logits ride along for the paged engine's GRPO prompt sharing);
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
``block_until_ready``.  The layout hooks (``_make_caches``, ``_admit_cfg``,
``_register_groups``, ``_on_slot_freed``, ``_write_admitted``) are the
identity here and overridden by the paged engine.

Fault tolerance (DESIGN.md §10): a non-finite-logit guard inside
``_decode_chunk`` quarantines the offending row in-chunk (its garbage
token is never stored; every other row decodes on); it is a few
elementwise ops a step on the device, read back once a chunk with the
tokens, never a sync a step.  Per-request deadlines bound how long a
straggler may hold a slot; a reclaimed request retries through
speculative-prefix admission — its already-generated tokens become the
retry's draft and are *verified*, not regenerated; a bounded queue sheds
under backpressure (``max_queue``, ``overflow``); ``retry_backoff`` holds
retries on the engine's step clock.  All of it is counted in ``stats()``,
injected deterministically by a ``FaultPlan`` (serving/faults.py), and the
whole engine state round-trips through ``state_dict``/``load_state_dict``
for exact kill-and-resume (``checkpoint/io.save_server_state``).

One divergence from JAX, on purpose: JAX's second quarantine of a request
walks the decode-attention implementation down a ladder (pallas → blocked
→ naive).  In the port the only other implementation is the plain
version, and routing the card to it would hide the kernel; so the second
strike is counted (``Request.nan_strikes``) and the request retries on the
kernel, ``cfg.decode_impl`` unchanged and ``fault_impl_fallbacks`` 0
(ROADMAP Queue 3).

§9 draft engine: with ``draft`` (an enabled ``DraftConfig``) a chunk is
one draft-verify macro-step over all slots (``_run_draft_chunk``, the
fixed-batch loops' ``drafting.step.draft_step``), with a per-slot n-gram
source and length controller reset at each admission (prompt ⊕ accepted
prefix, the request's ``ngram_corpus``) and ``draft_k`` slots of headroom
in the cache.  A ``draft_exc`` fault, or a real proposal error, turns
drafting off for that request (``fault_draft_errors``,
``fault_draft_disabled``); such a row, like a quarantined one, decodes
through a plain (B, 2) block.  The non-finite guard of a draft chunk runs
on the host over the block's log-probs.  ``stats()`` carries the
``DraftStats`` counters (zeros for an engine that does not draft).

§11/§14 observatory, as in JAX: ``tracer=`` (else the process-global
tracer) draws an ``engine`` lane (admit, slot_write, decode_chunk /
draft_chunk spans) and one ``req/<id>`` lane per sampled request (queued,
admit, decode chunks, fault and retry instants, the whole request); the
engine's own registry holds the ``serve.*`` latency histograms (queue
wait, TTFT, admit and slot-write time, chunk, step and token time, serve
time, retries, reuse length) and travels in ``state_dict``;
``metrics_registry()`` joins them to every counter, the sentinel's
``compiles.*`` gauges, the CUDA allocator's ``device.*`` gauges and the
ledger's ``ledger.tokens_*`` tallies, and ``stats()`` is its flat view.
``ledger=`` (else the process-global one) keys provenance rows by
``request_id``: the prompt, the accepted prefix split at the caller's
draft boundary (``REUSED_PREFIX``, then ``RETRY_STITCHED`` /
``QUARANTINE_CLAMPED`` for a retry's re-verified partial output), then
``FRESH`` per chunk or ``categorize_draft_block`` runs per draft block
clamped to what the guard kept; a row is finalized against prompt ⊕
caller prefix ⊕ continuation when its response is written.  The ledger is
not in ``state_dict`` (by design, as in JAX), so a restored engine neither
extends nor finalizes a row it never saw begin; JAX's engine appends to
such a row (``TokenLedger.append`` opens it) and then fails its
conservation check (ROADMAP Queue 3).  A drafted engine writes one
decision record per live slot and macro-step to the process-global
decision log.  Every stamp is one the ``time_*`` accounting already
takes, and every value comes from what a chunk already read back.

§8 mesh: ``mesh=`` takes a model-only (sub)mesh, such as one data
shard's of ``distributed/mesh.py:data_submeshes``.  The engine runs the
model cut over that group (``shard_params``; a model cut for it already
is kept), so its persistent caches hold the rank's KV heads and every
slot (JAX's ``shard_caches(batch=False)``): the persistent batch stays
whole on the shard, and data parallelism lives one level up, in
``MeshSlotServer``.  Every rank of the group makes the same host
decisions, because every rank computes the same logits.
"""
from __future__ import annotations

import math
import time
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.backoff import BackoffConfig
from repro_torch.core.metrics import DraftStats, FaultStats
from repro_torch.core.verify import verify_and_prefill
from repro_torch.device import sync
from repro_torch.distributed.mesh import data_size, shard_params
from repro_torch.engine.generate import GenerateConfig, positions_from_mask
from repro_torch.engine.sampling import KeyBatch, sample, split_key, stack_keys
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.obs import (MetricsRegistry, get_decision_log, get_ledger,
                             get_tracer)
from repro_torch.obs.alerts import (record_compile_gauges,
                                    record_device_memory, register_jit_entry)
from repro_torch.obs.ledger import (FRESH, PROMPT, REUSED_PREFIX,
                                    SOURCE_NGRAM, categorize_draft_block)

from .faults import EngineKilled, FaultPlan
from .request import (DECODING, FINISH_BUDGET, FINISH_EOS, FINISH_FULL_REUSE,
                      FINISH_QUARANTINE, FINISH_SHED, FINISH_TIMEOUT,
                      Request, Response)
from .scheduler import SlotScheduler


@torch.no_grad()
def _admit_vanilla(model: M.LM, cfg: ModelConfig, gen: GenerateConfig,
                   prompts, mask, keys):
    """Prefill an admission group; mirrors ``generate`` up to the seed token.

    prompts: (R, P) left-padded; keys: R per-request decode keys.  Returns
    caches sized P + N per row (the layout fixed-batch ``generate``
    builds), the seed token/logprob, the carry keys and the seed logits
    (a paged follower re-samples from its leader's with its own key)."""
    R, P = prompts.shape
    caches = M.init_cache(M.cache_config(model, cfg), R, P + gen.max_new_tokens,
                          device=model.device)
    logits, caches = M.prefill(model, cfg, prompts, positions_from_mask(mask),
                               caches)
    keys, sub = split_key(keys)
    seed_logits = logits[:, -1]
    tok0, lp0 = sample(sub, seed_logits, gen.temperature, gen.top_p)
    return {"caches": caches, "tok0": tok0, "lp0": lp0,
            "next_pos": mask.sum(dim=1, dtype=torch.int32), "keys": keys,
            "seed_logits": seed_logits}


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
                  keys, nan_inject=None, *, steps: int):
    """``steps`` decode steps over all slots; per-row write offsets/keys.

    Term-for-term the body of ``engine/generate._decode_loop`` (store →
    count/done update → decode_step → split → sample), except that the
    cache write lands at the per-row ``write_idx`` and the loop never stops
    early: idle and done rows keep stepping with position -1 (masked
    everywhere; the slot is rewritten at its next admission).  The caches
    are written in place.

    §10 non-finite guard: a row whose logits go NaN/inf is *quarantined*
    in-chunk — its garbage sample is drawn from safe (zero) logits and
    never stored, because quarantine sets ``done`` before the next store.
    Every other row decodes on undisturbed.  ``nan_inject`` (B,) int32 is
    the fault-injection hook: the step of this chunk at which a row's
    logits are corrupted, -1 never (None: no row, and no ops for it).  The
    guard is ``where``-selects on the device, so a clean run's values are
    the pre-guard loop's; ``quarantined`` comes back with the tokens."""
    pad = torch.full_like(cur_tok, gen.pad_id)
    zero = torch.zeros_like(cur_lp)
    minus1 = torch.full_like(next_pos, -1)
    quar = torch.zeros_like(done)
    toks, lps = [], []
    for step_i in range(steps):
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
        lg = logits[:, 0]
        if nan_inject is not None:
            lg = lg.masked_fill((nan_inject == step_i)[:, None], float("nan"))
        bad = ~torch.isfinite(lg).all(dim=-1)
        newly = bad & ~done_next        # rows finishing anyway aren't pulled
        quar = quar | newly
        done_next = done_next | newly
        lg = lg.masked_fill(bad[:, None], 0.0)  # sample something finite;
        keys, sub = split_key(keys)             # done_next gates its store
        cur_tok, cur_lp = sample(sub, lg, gen.temperature, gen.top_p)
        done = done_next
        next_pos = next_pos + 1
        write_idx = write_idx + 1
    return {"caches": caches, "cur_tok": cur_tok, "cur_lp": cur_lp,
            "done": done, "count": count, "next_pos": next_pos,
            "write_idx": write_idx, "keys": keys, "quarantined": quar,
            "tokens": torch.stack(toks, dim=1),
            "logprobs": torch.stack(lps, dim=1)}       # (B, steps)


@torch.no_grad()
def _write_slots(cfg: ModelConfig, dst_caches, src_caches, slots, *,
                 pad_src: int = 0):
    """Scatter the admission caches into the persistent batch (in place).
    A drafted engine keeps draft_k spare slots per row (§9 block headroom),
    so its admission caches are padded to the persistent width first."""
    if pad_src:
        src_caches = M.pad_cache(cfg, src_caches, pad_src)
    return M.write_cache_slots(cfg, dst_caches, src_caches, slots)


# §14 recompile sentinel (obs/alerts.py): the engine's device programs under
# the reference's names and its jit's static arguments — their signature
# counts are what the `recompile_steady_state` alert rule watches
_admit_vanilla = register_jit_entry("admit_vanilla", _admit_vanilla,
                                    static=("cfg", "gen", "mesh"))
_admit_spec = register_jit_entry(
    "admit_spec", _admit_spec,
    static=("cfg", "gen", "verify_impl", "compact_impl", "mesh"))
_write_slots = register_jit_entry("write_slots", _write_slots,
                                  static=("cfg", "impl", "pad_src", "mesh"))
_decode_chunk = register_jit_entry("decode_chunk", _decode_chunk,
                                   static=("cfg", "gen", "steps", "mesh"))

_DRAFT_COUNTERS = ("forwards", "draft_forwards", "proposed", "accepted",
                   "emitted")


class SlotEngine:
    """Continuous-batching generation engine with spec-prefix admission."""

    # the key-batch class (engine/sampling.py) that snapshot words are
    # rebuilt into: the slots' keys at load_state_dict, and the keys of
    # restored requests at their admission (tests swap in JAX-drawing keys)
    key_type = KeyBatch

    def __init__(self, model: M.LM, cfg: ModelConfig, gen: GenerateConfig, *,
                 num_slots: int, prompt_width: int, spec_prefix: bool = False,
                 log_lenience: float = 0.0, chunk_steps: int = 8,
                 draft=None, mesh=None, faults: Optional[FaultPlan] = None,
                 deadline_steps: Optional[int] = None,
                 max_queue: Optional[int] = None, overflow: str = "reject",
                 retry_backoff: Optional[BackoffConfig] = None,
                 tracer=None, ledger=None):
        if mesh is not None:
            if data_size(mesh) > 1:
                raise ValueError("a SlotEngine runs one data shard: a mesh "
                                 "with a data axis takes MeshSlotServer")
            model = shard_params(mesh, cfg, model)
        self.mesh = mesh
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
        # §9 continuation draft engine: a DraftConfig turns each chunk into
        # one draft-verify block with per-slot n-gram sources and length
        # controllers
        self.draft = draft if (draft is not None and draft.enabled) else None
        # context ends at write_base; decode token t lands at write_base + t
        # (vanilla: prefill layout [0, P); spec: compacted layout [0, P+N));
        # a drafted engine adds draft_k headroom for the block write
        self.write_base = self.P + (self.N if spec_prefix else 0)
        self.cache_len = self.write_base + self.N + \
            (self.draft.draft_k if self.draft else 0)

        B = int(num_slots)
        if self.draft:
            from repro_torch.drafting import DraftController, NGramDraftSource
            self._draft_source = NGramDraftSource(self.draft, B)
            self._draft_ctrl = DraftController(self.draft, B)
        self.draft_stats = DraftStats()
        self.caches = self._make_caches(B)
        self.scheduler = SlotScheduler(B, max_queue=max_queue,
                                       overflow=overflow)
        # §10 hardening state: engine-default deadline (a request's own
        # deadline_steps wins), the injected fault schedule, and the
        # pending targeted faults held until their request is in a slot
        self.deadline_steps = deadline_steps
        self.faults = faults
        self.fault_stats = FaultStats()
        # called after every chunk of ``run`` (a mesh server's
        # ``MetricsBoard`` publishes the shard's registry there)
        self.on_chunk: Optional[Callable[[], None]] = None
        # §12 backoff: with a BackoffConfig a reclaimed request is held
        # until the engine step clock passes its due step; None keeps the
        # immediate resubmit
        self.retry_backoff = retry_backoff
        self._retry_hold: List[Tuple[int, Request]] = []
        self.slot_age = np.zeros(B, np.int64)   # engine steps spent DECODING
        self._nan_due: set = set()              # request_ids awaiting nan
        self._stall_due: Dict[int, int] = {}    # request_id -> phantom steps
        self._draft_exc_due: set = set()        # request_ids awaiting exc
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
        # §14: whether a slot's pending carry token is a free bonus sample
        # (its previous draft block was fully accepted); ledger bookkeeping
        # only, deliberately not in state_dict (the ledger is not either)
        self._carry_bonus = np.zeros(B, bool)
        self._slot_n = np.zeros(B, np.int32)
        self._slot_draft_len = np.zeros(B, np.int32)
        self._slot_full_reuse = np.zeros(B, bool)
        self._slot_prefix_lp: List[Optional[np.ndarray]] = [None] * B
        self.responses: Dict[int, Response] = {}
        self.steps = 0                      # engine decode steps elapsed
        self.time_admit = 0.0
        self.time_slot_write = 0.0
        self.time_decode = 0.0
        # §11/§14 observatory sinks, inert by default (NULL_TRACER,
        # NULL_LEDGER and NULL_DECISION_LOG early-return everywhere); the
        # engine-owned registry holds the latency histograms
        self.tracer = tracer if tracer is not None else get_tracer()
        self.ledger = ledger if ledger is not None else get_ledger()
        self.decisions = get_decision_log()
        self._etrack = "engine"
        self.metrics = MetricsRegistry()
        self._t0 = time.perf_counter()

    # ------------------------------------------------------------- frontend

    def _now(self) -> float:
        return time.perf_counter() - self._t0

    def _abs(self, rel: float) -> float:
        """Engine-relative seconds → the tracer's perf_counter timeline."""
        return self._t0 + rel

    def submit(self, req: Request) -> None:
        if len(req.prompt) > self.P or not 0 <= req.max_new_tokens <= self.N:
            raise ValueError(f"request {req.request_id}: prompt of "
                             f"{len(req.prompt)} (width {self.P}) or budget "
                             f"{req.max_new_tokens} (max {self.N}) too large")
        shed = self.scheduler.submit(req, now=self._now())
        if shed is not None:
            # backpressure acted: the shed request resolves immediately with
            # an empty, explicitly-marked response (§10)
            self.fault_stats.add(failed=1)
            self.responses[shed.request_id] = Response(
                request_id=shed.request_id, tokens=np.zeros(0, np.int32),
                logprobs=np.zeros(0, np.float32), length=0,
                finish_reason=FINISH_SHED, slot=-1, retries=shed.retries)

    def _release_retries(self) -> None:
        """Re-queue held backoff retries whose due step has passed (§12);
        a retry bypasses backpressure, as an immediate resubmit does."""
        if not self._retry_hold:
            return
        now = self._now()
        due = [r for d, r in self._retry_hold if d <= self.steps]
        self._retry_hold = [(d, r) for d, r in self._retry_hold
                            if d > self.steps]
        for req in due:
            self.scheduler.resubmit(req, now=now)

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
            self._apply_faults()       # may raise EngineKilled (kind 'kill')
            self._release_retries()    # held backoff retries now due
            while nxt is not None and nxt[0] <= self.steps:
                self.submit(nxt[1])
                nxt = next(it, None)
            self._admit()
            if self.scheduler.idle:
                if self._retry_hold:   # backoff holds are pending work
                    due = min(d for d, _ in self._retry_hold)
                    if nxt is not None:
                        due = min(due, int(nxt[0]))
                    self.steps = max(self.steps, due)      # idle fast-forward
                    continue
                if nxt is None:
                    break
                self.steps = max(self.steps, int(nxt[0]))  # idle fast-forward
                continue
            self._run_chunk()
            self._harvest()
            self._enforce_deadlines()
            chunks += 1
            if self.on_chunk is not None:
                self.on_chunk()
            if max_chunks is not None and chunks >= max_chunks:
                break
        return self.responses

    def metrics_registry(self) -> MetricsRegistry:
        """The engine's full telemetry as ONE typed registry (§11): every
        scheduler lifecycle counter, §9 draft counter and §10 fault counter
        with its merge semantics attached (counters sum, peak gauges max,
        ratios re-derive from summed parts), the §14 sentinels and ledger
        tallies, and the engine's latency histograms."""
        sch = self.scheduler
        reg = MetricsRegistry()
        # shape/config gauges (sum across shards where extensive)
        reg.set("num_slots", float(sch.num_slots), agg="sum")
        reg.set("num_shards", 1.0, agg="sum")
        reg.set("pending", float(len(sch.queue)), agg="sum")
        reg.set("max_queue", float(sch.max_queue or 0), agg="sum")
        reg.set("engine_steps", float(self.steps), agg="max")
        reg.set("wall_time", self._now(), agg="max")
        # scheduler lifecycle counters
        reg.inc("submitted", sch.submitted)
        reg.inc("admitted", sch.admitted)
        reg.inc("completed", sch.completed)
        reg.inc("busy_slot_steps", sch.busy_slot_steps)
        reg.inc("total_slot_steps", sch.total_slot_steps)
        reg.inc("queue_wait_total", sch.queue_wait_total)
        reg.inc("serve_time_total", sch.serve_time_total)
        reg.inc("timeouts", sch.timeouts)
        reg.inc("quarantined_requests", sch.quarantines)
        reg.inc("retried_requests", sch.retries)
        reg.inc("shed_requests", sch.sheds)
        reg.inc("rejected_requests", sch.rejected)
        reg.ratio("occupancy", "busy_slot_steps", "total_slot_steps")
        reg.ratio("mean_queue_wait", "queue_wait_total", "completed")
        reg.ratio("mean_serve_time", "serve_time_total", "completed")
        # engine throughput counters
        reg.inc("generated_tokens",
                sum(r.length for r in self.responses.values()))
        reg.inc("reused_tokens",
                sum(r.n_accepted for r in self.responses.values()))
        reg.inc("admit_time", self.time_admit)
        reg.inc("slot_write_time", self.time_slot_write)
        reg.inc("decode_time", self.time_decode)
        # §9 draft telemetry (zeros for an engine that does not draft)
        ds = self.draft_stats
        reg.inc("draft_proposed", ds.proposed)
        reg.inc("draft_accepted", ds.accepted)
        reg.inc("decode_forwards", ds.forwards)
        reg.inc("decode_emitted", ds.emitted)
        reg.inc("draft_forwards", ds.draft_forwards)
        reg.ratio("accept_rate", "draft_accepted", "draft_proposed")
        reg.ratio("mean_draft_len", "draft_proposed", "draft_forwards")
        reg.ratio("tokens_per_forward", "decode_emitted", "decode_forwards")
        # §10 recovery telemetry under the uniform fault_ schema: the
        # engine-owned counters plus a mirror of the scheduler's
        fs = FaultStats(**{k: getattr(self.fault_stats, k)
                           for k in FaultStats.FIELDS})
        fs.timeouts = sch.timeouts
        fs.retries = sch.retries
        fs.sheds = sch.sheds
        fs.rejected = sch.rejected
        for k, v in fs.as_dict().items():
            reg.inc(k, v)
        # §14 sentinels: per-entry signature counts and the CUDA
        # allocator's gauges (process-global, so agg="max")
        record_compile_gauges(reg)
        record_device_memory(reg)
        # §14 provenance tallies — the ledger may be process-global too
        if self.ledger.enabled:
            for cname, nv in self.ledger.counts_dict().items():
                reg.set(f"ledger.tokens_{cname}", float(nv), agg="max")
        # §11 latency histograms accumulated by the serving loop itself
        reg.merge(self.metrics)
        return reg

    def stats(self) -> Dict[str, float]:
        return self.metrics_registry().as_dict()

    # ------------------------------------------------------------ admission

    def _pad_group(self, rows: list) -> list:
        """Pad a group to num_slots rows by repeating row 0."""
        return rows + [rows[0]] * (self.scheduler.num_slots - len(rows))

    def _tensor(self, rows: list, dtype) -> torch.Tensor:
        return torch.as_tensor(np.stack(self._pad_group(rows)), dtype=dtype,
                               device=self.device)

    def _key(self, key):
        """A request's key as a one-row key batch: as the caller gave it,
        or rebuilt from the words a snapshot stored."""
        if hasattr(key, "split"):
            return key
        return self.key_type.from_words(np.asarray(key), self.device)

    def _stack_keys(self, keys: list):
        return stack_keys(self._pad_group([self._key(k) for k in keys]))

    # Layout hooks, overridden by PagedSlotEngine (DESIGN.md §13).  The
    # dense engine's behaviour is the identity on all five.

    def _make_caches(self, B: int):
        """Build the persistent decode caches (dense slabs by default)."""
        return M.init_cache(M.cache_config(self.model, self.cfg), B,
                            self.cache_len, device=self.device)

    def _admit_cfg(self) -> ModelConfig:
        """Config the admission programs build their throwaway caches with.
        The paged engine admits DENSELY and re-pages at the slot write."""
        return self.cfg

    def _register_groups(self, group, out) -> None:
        """Post-admission hook: the paged engine registers each new GRPO
        group's prompt blocks + seed logits here for CoW sharing."""

    def _on_slot_freed(self, slot: int) -> None:
        """A request left ``slot`` (completed or reclaimed); the paged
        engine releases its block-table row here."""

    def _write_admitted(self, src_caches, slot_ids: np.ndarray):
        """Scatter the admission caches into the persistent batch."""
        return _write_slots(self.cfg, self.caches, src_caches, slot_ids,
                            pad_src=self.draft.draft_k if self.draft else 0)

    def _prompt_category(self, req: Request) -> int:
        """Provenance of the prompt plane: the paged engine overrides this
        for CoW followers, whose prompt blocks are mapped, not prefilled."""
        return PROMPT

    def _pool_pressure(self) -> float:
        """KV backing-store pressure in [0, 1]: 0 for dense slabs (they
        cannot run dry); the paged engine reports block-pool occupancy."""
        return 0.0

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
        keys = self._stack_keys([r.key for r in reqs])

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
            vkeys = self._stack_keys([r.verify_key for r in reqs])
            out = _admit_spec(
                self.model, self._admit_cfg(), self.gen, prompts, masks,
                self._tensor(list(dt), torch.int32),
                self._tensor(list(dl), torch.float32),
                self._tensor(list(dn), torch.int32),
                self._tensor(list(de), torch.bool), vkeys, keys,
                self.log_lenience)
        else:
            out = _admit_vanilla(self.model, self._admit_cfg(), self.gen,
                                 prompts, masks, keys)
        sync(self.device)
        t1 = time.perf_counter()
        self.time_admit += t1 - t0

        slot_ids = np.array(slots + [slots[0]] * (B - len(slots)), np.int64)
        self.caches = self._write_admitted(out.pop("caches"), slot_ids)
        sync(self.device)
        t2 = time.perf_counter()
        self.time_slot_write += t2 - t1

        # §11: admit/slot-write timings reuse t0/t1/t2, the stamps the
        # time_* accounting above already took
        self.metrics.observe("serve.admit_ms", (t1 - t0) * 1e3)
        self.metrics.observe("serve.slot_write_ms", (t2 - t1) * 1e3)
        tr = self.tracer
        if tr.enabled:
            tr.complete("admit", self._etrack, t0, t1, cat="admit",
                        rows=len(group))
            tr.complete("slot_write", self._etrack, t1, t2, cat="admit")

        self._register_groups(group, out)

        def host(name):
            return out[name].cpu().numpy()

        n = host("n") if self.spec_prefix else np.zeros(B, np.int32)
        fr = host("full_reuse") if self.spec_prefix else np.zeros(B, bool)
        lp_curr = host("lp_curr") if self.spec_prefix else None
        self._apply_admission(group, host("tok0"), host("lp0"),
                              host("next_pos"), out["keys"], n, fr, lp_curr,
                              dn, t0, t1)
        # full-reuse / zero-budget admissions finish without decoding;
        # harvesting them here lets the loop keep back-filling
        self._harvest()

    def _apply_admission(self, group, tok0, lp0, npos, nkeys, n, fr,
                         lp_curr, dn, t0: float, t1: float) -> None:
        """Per-request host bookkeeping after an admission (any path):
        state vectors, keys, telemetry, draft-source reset, activation.
        Arrays are indexed by the request's position ``j`` in ``group``;
        t0/t1 are the admission's stamps."""
        if self.keys is None:
            self.keys = stack_keys([nkeys[0]] * self.scheduler.num_slots)
        tr = self.tracer
        led = self.ledger
        for j, (slot, req) in enumerate(group):
            nj = int(n[j])
            budget = max(0, req.max_new_tokens - nj)
            if led.enabled:
                # §14: (re)build the provenance plane.  The accepted prefix
                # splits at the caller's draft boundary: up to it SPEC-RL
                # reuse; past it the request's own re-verified partial
                # output from an earlier occupancy (§10 retry)
                base = max(0, int(req.base_draft_len))
                led.begin_row(req.request_id, len(req.prompt),
                              prompt_cat=self._prompt_category(req))
                led.append(req.request_id, REUSED_PREFIX, min(nj, base))
                led.append(req.request_id,
                           led.retry_category(req.request_id),
                           nj - min(nj, base))
            # §11 per-request admission telemetry: queue wait, TTFT
            # (queued → seed token, which admission just produced) and the
            # SPEC-RL reuse length; span endpoints are the scheduler's
            # engine-relative stamps
            self.metrics.observe("serve.queue_wait_ms",
                                 (req.admitted_at - req.queued_at) * 1e3)
            self.metrics.observe("serve.ttft_ms",
                                 ((t1 - self._t0) - req.queued_at) * 1e3)
            if self.spec_prefix:
                self.metrics.observe("serve.reuse_len", nj)
            if tr.enabled and tr.sampled(req.request_id):
                lane = f"req/{req.request_id}"
                tr.complete("queued", lane, self._abs(req.queued_at),
                            self._abs(req.admitted_at), cat="queue",
                            retries=req.retries)
                tr.complete("admit", lane, t0, t1, cat="admit",
                            slot=slot, n_accepted=nj)
            self.cur_tok[slot] = tok0[j]
            self.cur_lp[slot] = lp0[j]
            self.count[slot] = 0
            self.budget[slot] = budget
            self.next_pos[slot] = npos[j]
            self.write_idx[slot] = self.write_base
            self.keys[slot] = nkeys[j]
            self.slot_age[slot] = 0     # deadline clock is per-occupancy
            self.done[slot] = bool(fr[j]) or budget <= 0
            self._acc_tok[slot] = []
            self._acc_lp[slot] = []
            self._carry_bonus[slot] = False   # the seed sample is fresh
            self._slot_n[slot] = nj
            self._slot_draft_len[slot] = int(dn[j]) if self.spec_prefix else 0
            self._slot_full_reuse[slot] = bool(fr[j])
            self._slot_prefix_lp[slot] = (lp_curr[j] if lp_curr is not None
                                          else None)
            if self.draft:
                # n-gram index over prompt ⊕ accepted prefix, shadowing the
                # request's sibling corpus (DESIGN.md §9)
                ctx = list(np.asarray(req.prompt, np.int32))
                if self.spec_prefix and req.has_draft:
                    ctx.extend(np.asarray(req.draft_tokens[:nj], np.int32))
                self._draft_source.reset(slot, ctx, req.ngram_corpus)
                self._draft_ctrl.reset(slot)
            self.scheduler.activate(slot)

    # ---------------------------------------------------------- decode loop

    def _run_chunk(self, steps: Optional[int] = None) -> None:
        if self.draft:
            return self._run_draft_chunk()
        steps = steps or self.chunk_steps
        live = [s for s in self.scheduler.active if not self.done[s]]
        busy = len(live)
        dev_t = self._dev_t

        # §10 fault hook: corrupt the logits of pending nan targets on the
        # first step of this chunk (None: no target, the clean path)
        inject = None
        for slot, req in self.scheduler.active.items():
            if req.request_id in self._nan_due and not self.done[slot]:
                self._nan_due.discard(req.request_id)
                if inject is None:
                    inject = np.full(self.scheduler.num_slots, -1, np.int32)
                inject[slot] = 0
        t0 = time.perf_counter()
        out = _decode_chunk(
            self.model, self.cfg, self.gen, self.caches,
            dev_t(self.cur_tok), dev_t(self.cur_lp), dev_t(self.done),
            dev_t(self.count), dev_t(self.budget), dev_t(self.next_pos),
            dev_t(self.write_idx), self.keys,
            None if inject is None else dev_t(inject), steps=steps)
        self.caches, self.keys = out["caches"], out["keys"]
        toks = out["tokens"].cpu().numpy()          # (B, steps); waits
        lps = out["logprobs"].cpu().numpy()
        quar = out["quarantined"].cpu().numpy()
        count0 = self.count
        for name in ("cur_tok", "cur_lp", "done", "count", "next_pos",
                     "write_idx"):
            setattr(self, name, out[name].cpu().numpy())
        t1 = time.perf_counter()
        self.time_decode += t1 - t0
        # §11 chunk telemetry: t0/t1 are the time_decode stamps; the
        # emitted count comes from the state just read back
        emitted = int((self.count[live] - count0[live]).sum()) if live else 0
        self.metrics.observe("serve.decode_chunk_ms", (t1 - t0) * 1e3)
        self.metrics.observe("serve.decode_step_ms", (t1 - t0) / steps * 1e3)
        if emitted > 0:
            self.metrics.observe("serve.token_ms", (t1 - t0) / emitted * 1e3)
        tr = self.tracer
        if tr.enabled:
            tr.complete("decode_chunk", self._etrack, t0, t1, cat="decode",
                        steps=steps, busy=busy, emitted=emitted)
            for slot in live:
                req = self.scheduler.active[slot]
                if tr.sampled(req.request_id):
                    tr.complete("decode_chunk", f"req/{req.request_id}",
                                t0, t1, cat="decode", slot=slot)
        for slot in self.scheduler.active:
            self._acc_tok[slot].append(toks[slot])
            self._acc_lp[slot].append(lps[slot])
            self.slot_age[slot] += steps
        led = self.ledger
        if led.enabled:
            # §14: a slot's valid emission this chunk is its count delta
            # (the accumulators keep whole chunk rows and trim at harvest);
            # a row admitted before a kill-and-resume was never begun here
            # and gets no bytes, so its finish skips it
            for slot, req in self.scheduler.active.items():
                if led.has_row(req.request_id):
                    led.append(req.request_id, FRESH,
                               int(self.count[slot]) - int(count0[slot]))
        self.steps += steps
        self.scheduler.tick(busy, steps)
        # §10 quarantine: rows the in-chunk guard pulled out (their valid
        # prefix is in _acc; the corrupted sample was never stored) leave
        # the decode batch before harvest sees them as completions
        for slot in [s for s in list(self.scheduler.active) if quar[s]]:
            self.fault_stats.add(nan_events=1)
            self._reclaim(slot, FINISH_QUARANTINE)

    def _dev_t(self, a) -> torch.Tensor:
        return torch.as_tensor(a, device=self.device)

    def _run_draft_chunk(self) -> None:
        """One §9 draft-verify macro-step over all slots: the fixed-batch
        loops' ``draft_step``, whose per-row write offsets, budgets and key
        streams are the machinery this engine already carries, so a slot
        absorbs a variable-length accept as a fixed-batch row does.  The
        step's host-side results come back in one transfer."""
        from repro_torch.drafting.engine import step_readback
        from repro_torch.drafting.step import block_width, draft_step
        K = self.draft.draft_k
        B = self.scheduler.num_slots
        busy = sum(1 for s in self.scheduler.active if not self.done[s])
        dt = np.zeros((B, K), np.int32)
        dl = np.zeros((B,), np.int32)
        dec = self.decisions
        feats: Dict[int, Dict[str, float]] = {}
        for slot in self.scheduler.active:
            if self.done[slot]:
                continue
            req = self.scheduler.active[slot]
            if req.draft_off:
                continue                # degraded row: plain (B, 2) decode
            try:
                # §10 fault hook: a targeted draft-source exception, then
                # the guard any real proposal error falls into: drafting
                # dies for this row, the request decodes on
                if req.request_id in self._draft_exc_due:
                    self._draft_exc_due.discard(req.request_id)
                    raise RuntimeError("injected draft-source fault")
                d = self._draft_source.propose(
                    slot, self._draft_ctrl.draft_len(slot),
                    pending=int(self.cur_tok[slot]))
            except Exception:
                self.fault_stats.add(draft_errors=1, draft_disabled=1)
                req.draft_off = True
                continue
            dt[slot, :len(d)] = d
            dl[slot] = len(d)
            if dec.enabled:
                # §14 decision record, feature half, from host state the
                # loop already holds (surprisal: -logp of the pending token)
                feats[slot] = {
                    "surprisal": -float(self.cur_lp[slot]),
                    "position": float(self.next_pos[slot]),
                    "accept_ema": float(self._draft_ctrl.rate[slot]),
                    "draft_k": float(len(d)),
                    "draft_source": SOURCE_NGRAM,
                    "queue_depth": float(len(self.scheduler.queue)),
                    "slot_age": float(self.slot_age[slot]),
                    "pool_pressure": self._pool_pressure(),
                }
        # the bucketed block width (drafting/step.py:block_width); u_width
        # = draft_k keeps a request's stream independent of the bucket
        K_step = block_width(int(dl.max()), K)
        dev_t = self._dev_t
        t0 = time.perf_counter()
        out = draft_step(
            self.model, self.cfg, self.gen, self.caches, dev_t(self.cur_tok),
            dev_t(self.cur_lp), dev_t(self.done), dev_t(self.count),
            dev_t(self.budget), dev_t(self.next_pos), dev_t(self.write_idx),
            self.keys, dev_t(dt[:, :K_step]), dev_t(dl), K=K_step,
            u_width=K)
        self.caches, self.keys = out["caches"], out["keys"]
        h = step_readback(out)                       # one transfer; waits
        t1 = time.perf_counter()
        self.time_decode += t1 - t0
        for name in ("cur_tok", "cur_lp", "done", "count", "next_pos",
                     "write_idx"):
            setattr(self, name, h[name])
        toks, lps = h["tokens"], h["logprobs"]
        emitted, accepted, proposed = (h["emitted"], h["accepted"],
                                       h["proposed"])
        # §11 draft macro-step telemetry (t0/t1 = the time_decode stamps)
        n_em = int(emitted.sum())
        self.metrics.observe("serve.draft_chunk_ms", (t1 - t0) * 1e3)
        if n_em > 0:
            self.metrics.observe("serve.token_ms", (t1 - t0) / n_em * 1e3)
        tr = self.tracer
        if tr.enabled:
            tr.complete("draft_chunk", self._etrack, t0, t1, cat="draft",
                        busy=busy, proposed=int(proposed.sum()),
                        accepted=int(accepted.sum()), emitted=n_em)
            for slot in self.scheduler.active:
                if self.done[slot] and not emitted[slot]:
                    continue
                req = self.scheduler.active[slot]
                if tr.sampled(req.request_id):
                    tr.complete("draft_chunk", f"req/{req.request_id}",
                                t0, t1, cat="draft", slot=slot,
                                proposed=int(proposed[slot]),
                                accepted=int(accepted[slot]),
                                emitted=int(emitted[slot]))
        quarantined: List[int] = []
        led = self.ledger
        for slot in self.scheduler.active:
            req = self.scheduler.active[slot]
            m = int(emitted[slot])
            # §10 non-finite guard, host-side for drafted chunks: from the
            # first bad log-prob of the block on, the block is poisoned and
            # rolled back (an injected nan poisons it at 0)
            poison = m
            if req.request_id in self._nan_due and m > 0:
                self._nan_due.discard(req.request_id)
                poison = 0
            elif m > 0:
                bad = ~np.isfinite(lps[slot, :m])
                if bad.any():
                    poison = int(np.argmax(bad))
            if led.enabled and m and led.has_row(req.request_id):
                # §14: carry (fresh/bonus) + accepted-draft runs for this
                # block, clamped to what the guard kept
                kept = min(poison, m)
                for cat, nrun in categorize_draft_block(
                        m, bool(self._carry_bonus[slot])):
                    if kept <= 0:
                        break
                    led.append(req.request_id, cat, min(nrun, kept))
                    kept -= nrun
            # a fully accepted proposal makes the NEXT carry token a free
            # bonus sample
            self._carry_bonus[slot] = bool(
                proposed[slot] > 0 and accepted[slot] == proposed[slot])
            if poison < m:
                if poison:
                    self._acc_tok[slot].append(toks[slot, :poison])
                    self._acc_lp[slot].append(lps[slot, :poison])
                self.count[slot] -= m - poison      # drop the poisoned tail
                quarantined.append(slot)
                continue
            if m:
                self._acc_tok[slot].append(toks[slot, :m])
                self._acc_lp[slot].append(lps[slot, :m])
                self._draft_source.extend(slot, toks[slot, :m])
            self._draft_ctrl.update(slot, int(proposed[slot]),
                                    int(accepted[slot]))
        if dec.enabled and feats:
            # §14 decision record, outcome half: the pre-step features
            # joined to what the verify returned (step_ms from t0/t1)
            step_ms = (t1 - t0) * 1e3
            for slot, f in feats.items():
                req = self.scheduler.active.get(slot)
                if req is None:
                    continue
                prop, acc = int(proposed[slot]), int(accepted[slot])
                m = int(emitted[slot])
                dec.record(req.request_id, self.steps, f, {
                    "proposed": prop, "accepted": acc,
                    "bonus": 1.0 if (prop > 0 and acc == prop and m > acc)
                    else 0.0,
                    "emitted": m, "step_ms": step_ms})
        for slot in self.scheduler.active:
            self.slot_age[slot] += 1
        self.draft_stats.add_step(forwards=busy,
                                  proposed=int(proposed.sum()),
                                  accepted=int(accepted.sum()),
                                  emitted=int(emitted.sum()),
                                  draft_forwards=int((dl > 0).sum()))
        self.steps += 1                     # one forward = one engine step
        self.scheduler.tick(busy, 1)
        for slot in quarantined:
            self.fault_stats.add(nan_events=1)
            self._reclaim(slot, FINISH_QUARANTINE)

    # ------------------------------------------------- §10 fault tolerance

    def _apply_faults(self) -> None:
        """Consume due FaultPlan events at a chunk boundary (the only points
        where host state is consistent).  Targeted events (nan / stall /
        draft_exc) are held pending until their request occupies a slot;
        bursts submit through the bounded queue; a kill raises out of
        ``run`` — recovery is ``load_state_dict``."""
        if self.faults is None:
            return
        step = self.steps
        for e in self.faults.due(step, "burst"):
            self.fault_stats.add(injected=1)
            for req in self.faults.next_burst_requests(e.count):
                self.submit(req)
        for e in self.faults.due(step, "nan"):
            self.fault_stats.add(injected=1)
            self._nan_due.add(e.request_id)
        for e in self.faults.due(step, "stall"):
            self.fault_stats.add(injected=1)
            self._stall_due[e.request_id] = e.count
        for e in self.faults.due(step, "draft_exc"):
            self.fault_stats.add(injected=1)
            self._draft_exc_due.add(e.request_id)
        if self.faults.due(step, "kill"):
            self.fault_stats.add(injected=1)
            raise EngineKilled(f"injected kill at engine step {step}")

    def _enforce_deadlines(self) -> None:
        """Reclaim slots whose request outstayed its decode-step deadline."""
        # pending stalls first: phantom aging lands the moment its target
        # is in a slot, deterministically tripping the deadline below
        for slot, req in self.scheduler.active.items():
            if req.request_id in self._stall_due and not self.done[slot]:
                self.slot_age[slot] += self._stall_due.pop(req.request_id)
        for slot in list(self.scheduler.active):
            req = self.scheduler.active[slot]
            if self.done[slot]:
                continue
            ddl = req.deadline_steps if req.deadline_steps is not None \
                else self.deadline_steps
            if ddl is not None and self.slot_age[slot] >= ddl:
                self._reclaim(slot, FINISH_TIMEOUT)

    def _reclaim(self, slot: int, reason: str) -> None:
        """Pull the request out of ``slot`` without finishing it (§10).

        Its valid partial output is preserved: a retry re-enters through
        the queue with that output grown onto its draft, so spec-prefix
        admission re-VERIFIES the tokens instead of regenerating them.
        Retries exhausted → a failure Response carrying the best-effort
        partial output.  A quarantine turns the request's drafting off
        (JAX's ladder rung 1); a second one is counted in its
        ``nan_strikes`` and changes no route (the module's docstring)."""
        req = self.scheduler.active[slot]
        cnt = max(0, int(self.count[slot]))
        toks = (np.concatenate(self._acc_tok[slot])[:cnt]
                if self._acc_tok[slot] else
                np.zeros(0, np.int32)).astype(np.int32)
        lps = (np.concatenate(self._acc_lp[slot])[:cnt]
               if self._acc_lp[slot] else
               np.zeros(0, np.float32)).astype(np.float32)
        n1 = int(self._slot_n[slot])
        plp = self._slot_prefix_lp[slot]
        if reason == FINISH_QUARANTINE:
            req.nan_strikes += 1
            self.fault_stats.add(quarantines=1)
            if not req.draft_off:
                req.draft_off = True        # ladder rung 1: stop speculating
                if self.draft:
                    self.fault_stats.add(draft_disabled=1)
        now = self._now()
        # §14: remember WHY the slot was lost — the partial output that
        # re-enters through spec-prefix verification on retry is
        # RETRY_STITCHED (timeout/stall) or QUARANTINE_CLAMPED, not reuse
        self.ledger.note_retry(req.request_id, reason)
        self.scheduler.reclaim(slot, now=now, reason=reason)
        self._on_slot_freed(slot)
        tr = self.tracer
        lane = f"req/{req.request_id}"
        if tr.enabled and tr.sampled(req.request_id):
            # fault instant on the request lane: quarantine / timeout
            tr.event(reason, lane, cat="fault", ts=self._abs(now),
                     slot=slot, retries=req.retries)
        if req.retries < req.max_retries:
            if self.spec_prefix:
                # accepted prefix ⊕ partial output becomes the retry draft;
                # lp_curr stands in for behaviour logprobs (both are this
                # policy's own logprobs, so re-verification accepts them)
                prev_t = (np.asarray(req.draft_tokens, np.int32)[:n1]
                          if req.draft_tokens is not None
                          else np.zeros(0, np.int32))
                prev_l = (np.asarray(plp, np.float32)[:n1]
                          if plp is not None else np.zeros(0, np.float32))
                req.draft_tokens = np.concatenate([prev_t,
                                                   toks]).astype(np.int32)
                req.draft_logprobs = np.concatenate(
                    [prev_l, lps]).astype(np.float32)
                req.draft_eos = False
            if self.retry_backoff is not None:
                # §12: hold the retry until its backoff due step; it
                # re-enters the queue via _release_retries
                delay = self.retry_backoff.delay(req.retries)
                self._retry_hold.append(
                    (self.steps + max(0, math.ceil(delay)), req))
            else:
                self.scheduler.resubmit(req, now=now)
            if tr.enabled and tr.sampled(req.request_id):
                tr.event("retry", lane, cat="fault", ts=self._abs(now),
                         retry=req.retries)
        else:
            toks2, lps2, orig = self._stitch(req, n1, plp, toks, lps)
            self.fault_stats.add(failed=1)
            if self.ledger.enabled and self.ledger.has_row(req.request_id):
                # conservation holds for failure responses too: the plane
                # covers prompt + caller prefix + best-effort continuation
                self.ledger.finalize(req.request_id,
                                     len(req.prompt) + orig + len(toks2))
            self.responses[req.request_id] = Response(
                request_id=req.request_id, tokens=toks2, logprobs=lps2,
                length=len(toks2), finish_reason=reason, n_accepted=orig,
                prefix_logprobs=plp,
                draft_len=int(self._slot_draft_len[slot]), slot=slot,
                queue_time=req.admitted_at - req.queued_at,
                serve_time=now - req.admitted_at, retries=req.retries)
            self.metrics.observe("serve.serve_ms",
                                 (now - req.admitted_at) * 1e3)
            self.metrics.observe("serve.retries_per_request", req.retries)
            if tr.enabled and tr.sampled(req.request_id):
                # retroactive whole-lifecycle span: queued → failed
                tr.complete("request", lane, self._abs(req.queued_at),
                            self._abs(now), cat="request", reason=reason,
                            tokens=len(toks2), retries=req.retries)
        self.done[slot] = True
        self._acc_tok[slot] = []
        self._acc_lp[slot] = []
        self._slot_prefix_lp[slot] = None

    def _stitch(self, req: Request, n1: int, plp, toks, lps):
        """Split a serving session's output at the CALLER's draft boundary.

        ``n1`` is the final admission's accepted-prefix length; past
        ``base_draft_len`` it covers the request's own re-verified partial
        output, which belongs in the *continuation* (the Response contract
        is retry-blind).  For never-retried requests n1 <= base and this is
        the identity."""
        base = max(0, int(req.base_draft_len))
        orig = min(n1, base)
        if n1 > orig:
            toks = np.concatenate([np.asarray(req.draft_tokens,
                                              np.int32)[orig:n1], toks])
            lps = np.concatenate([np.asarray(plp, np.float32)[orig:n1], lps])
        return toks.astype(np.int32), lps.astype(np.float32), orig

    # -------------------------------------------------------------- harvest

    def _harvest(self) -> List[Response]:
        eos = self.gen.eos_id
        finished = []
        # a slot still PREFILLING belongs to a partially-admitted group (the
        # paged engine admits leaders before CoW followers): its done flag
        # is stale state from the previous occupant, not a finished request
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
            # retry-blind response split (§10): re-verified partial output
            # from earlier attempts moves from the accepted prefix back
            # into the continuation (identity for never-retried requests)
            toks, lps, orig = self._stitch(req, int(self._slot_n[slot]),
                                           self._slot_prefix_lp[slot],
                                           toks, lps)
            if self.ledger.enabled and self.ledger.has_row(req.request_id):
                # §14 conservation invariant: the provenance plane exactly
                # partitions prompt ⊕ caller prefix ⊕ continuation
                self.ledger.finalize(req.request_id,
                                     len(req.prompt) + orig + len(toks))
                self.ledger.clear_retry(req.request_id)
            resp = Response(
                request_id=req.request_id, tokens=toks, logprobs=lps,
                length=len(toks), finish_reason=reason, n_accepted=orig,
                prefix_logprobs=self._slot_prefix_lp[slot],
                draft_len=int(self._slot_draft_len[slot]), slot=slot,
                queue_time=req.admitted_at - req.queued_at,
                serve_time=now - req.admitted_at, retries=req.retries)
            self.responses[req.request_id] = resp
            self.scheduler.complete(slot, now=now)
            self._on_slot_freed(slot)
            self.metrics.observe("serve.serve_ms", resp.serve_time * 1e3)
            self.metrics.observe("serve.retries_per_request", req.retries)
            tr = self.tracer
            if tr.enabled and tr.sampled(req.request_id):
                # retroactive whole-lifecycle span: queued → finished
                tr.complete("request", f"req/{req.request_id}",
                            self._abs(req.queued_at), self._abs(now),
                            cat="request", reason=reason, tokens=len(toks),
                            n_accepted=orig, slot=slot, retries=req.retries)
            self._acc_tok[slot] = []
            self._acc_lp[slot] = []
            self._slot_prefix_lp[slot] = None
            finished.append(resp)
        return finished

    # ----------------------------------------------- exact kill-and-resume

    _VEC_FIELDS = ("cur_tok", "cur_lp", "done", "count", "budget",
                   "next_pos", "write_idx", "slot_age", "_slot_n",
                   "_slot_draft_len", "_slot_full_reuse")

    def state_dict(self) -> Dict:
        """Everything the decode loop's future depends on, as an all-array
        pytree (``checkpoint/io.save_pytree``-compatible): the caches (CPU
        copies of the tensors, bf16 included), every per-slot state vector,
        the slots' key batch as its int64 words, the partial token
        accumulators, the scheduler (queued + in-flight requests,
        bit-exact), finished responses, held retries, the §9 draft state
        (controller EMAs, n-gram streams and corpora: the index is rebuilt
        on load in the order that built it) and all counters.  NOT
        covered, by design: the model and config (the caller rebuilds the
        engine the same way — asserted via meta) and the FaultPlan (a
        restored engine resumes clean).  ``load_state_dict(state_dict())``
        resumes token-identically."""
        B = self.scheduler.num_slots
        words = (np.zeros((B, 2), np.int64) if self.keys is None
                 else np.asarray(self.keys).astype(np.int64))
        st: Dict = {
            "meta": {
                "num_slots": np.int64(B),
                "prompt_width": np.int64(self.P),
                "max_new_tokens": np.int64(self.N),
                "spec_prefix": np.bool_(self.spec_prefix),
                "steps": np.int64(self.steps),
                "elapsed": np.float64(self._now()),
                "time_admit": np.float64(self.time_admit),
                "time_slot_write": np.float64(self.time_slot_write),
                "time_decode": np.float64(self.time_decode),
            },
            "caches": [{kind: {name: buf.to("cpu", copy=True)
                               for name, buf in sc.items()}
                        for kind, sc in run.items()} for run in self.caches],
            "vec": {k: np.array(getattr(self, k)) for k in self._VEC_FIELDS},
            "keys": words,
            "acc_tok": {str(s): np.concatenate(a).astype(np.int32)
                        for s, a in enumerate(self._acc_tok) if a},
            "acc_lp": {str(s): np.concatenate(a).astype(np.float32)
                       for s, a in enumerate(self._acc_lp) if a},
            "prefix_lp": {str(s): np.asarray(p, np.float32)
                          for s, p in enumerate(self._slot_prefix_lp)
                          if p is not None},
            "scheduler": self.scheduler.state_dict(),
            "responses": {str(rid): r.to_state()
                          for rid, r in self.responses.items()},
            "fault_stats": {k: np.int64(getattr(self.fault_stats, k))
                            for k in FaultStats.FIELDS},
            # §11: the latency histograms resume with the engine, so a
            # kill-and-resume run keeps monotonic counters and percentiles
            "obs": self.metrics.state_dict(),
        }
        if self._retry_hold:
            # §12 backoff holds are in-flight work; written only when
            # non-empty, so default snapshots keep their layout
            st["retry_hold"] = {
                str(i): {"due": np.int64(d), "req": r.to_state()}
                for i, (d, r) in enumerate(self._retry_hold)}
        if self.draft:
            st["draft"] = {
                "rate": np.asarray(self._draft_ctrl.rate, np.float64),
                "stream": {str(s): np.asarray(v, np.int64)
                           for s, v in enumerate(self._draft_source._stream)},
                "corpus": {str(s): {str(j): np.asarray(seq, np.int32)
                                    for j, seq in enumerate(v)}
                           for s, v in
                           enumerate(self._draft_source._corpus)},
                "stats": {k: np.int64(getattr(self.draft_stats, k))
                          for k in _DRAFT_COUNTERS},
            }
        return st

    def load_state_dict(self, state: Dict) -> None:
        meta = state["meta"]
        if not (int(meta["num_slots"]) == self.scheduler.num_slots
                and int(meta["prompt_width"]) == self.P
                and int(meta["max_new_tokens"]) == self.N
                and bool(meta["spec_prefix"]) == self.spec_prefix):
            raise ValueError("engine was constructed with a different shape "
                             "than the snapshot")
        self.caches = [{kind: {name: torch.as_tensor(buf).to(
                                   self.device, copy=True)
                               for name, buf in sc.items()}
                        for kind, sc in run.items()}
                       for run in state["caches"]]
        for k in self._VEC_FIELDS:
            setattr(self, k, np.array(state["vec"][k]))
        self._slot_full_reuse = self._slot_full_reuse.astype(bool)
        self.done = self.done.astype(bool)
        self.keys = self.key_type.from_words(np.asarray(state["keys"]),
                                             self.device)
        B = self.scheduler.num_slots
        self._acc_tok = [[np.asarray(state["acc_tok"][str(s)], np.int32)]
                         if str(s) in state["acc_tok"] else []
                         for s in range(B)]
        self._acc_lp = [[np.asarray(state["acc_lp"][str(s)], np.float32)]
                        if str(s) in state["acc_lp"] else []
                        for s in range(B)]
        self._slot_prefix_lp = [
            np.asarray(state["prefix_lp"][str(s)], np.float32)
            if str(s) in state["prefix_lp"] else None for s in range(B)]
        self.scheduler.load_state_dict(state["scheduler"])
        self.responses = {int(rid): Response.from_state(rs)
                          for rid, rs in state["responses"].items()}
        for k in FaultStats.FIELDS:
            setattr(self.fault_stats, k, int(state["fault_stats"][k]))
        if "obs" in state:          # absent in snapshots without histograms
            self.metrics.load_state_dict(state["obs"])
        hold = state.get("retry_hold", {})
        self._retry_hold = [
            (int(hold[str(i)]["due"]), Request.from_state(hold[str(i)]["req"]))
            for i in range(len(hold))]
        if self.draft and "draft" in state:
            d = state["draft"]
            self._draft_ctrl.rate = np.array(d["rate"], np.float64)
            for s in range(B):
                stream = [int(t) for t in np.asarray(d["stream"][str(s)])]
                corp = d["corpus"].get(str(s), {})
                corpus = [np.asarray(corp[str(j)], np.int32)
                          for j in range(len(corp))]
                # reset() registers corpus then stream, the order the
                # incremental indexing used: the same index, the same
                # proposals
                self._draft_source.reset(s, stream, corpus)
            for k in _DRAFT_COUNTERS:
                setattr(self.draft_stats, k, int(d["stats"][k]))
        self.steps = int(meta["steps"])
        self.time_admit = float(meta["time_admit"])
        self.time_slot_write = float(meta["time_slot_write"])
        self.time_decode = float(meta["time_decode"])
        self._t0 = time.perf_counter() - float(meta["elapsed"])
