"""Paged continuous-batching engine: block-table slots + CoW GRPO sharing
(port of ``repro/serving/paged_engine.py``).

``PagedSlotEngine`` is the ``SlotEngine`` with its cache layout swapped out
(DESIGN.md §13): instead of one dense ``(run, B, Hkv, S, D)`` slab per
run, the persistent decode batch addresses a shared pool of fixed-size KV
blocks through per-slot block tables, managed host-side by a
``BlockAllocator`` (serving/block_table.py).  Everything else — admission
programs, the decode chunk, scheduling, §10 hardening — is inherited
unchanged; the subclass only overrides the layout hooks the base class
exposes.  Decode reads the pools through the ``paged_decode_attention``
kernel.

Token identity with the dense engine is by construction:

* Admission runs the *dense* device programs on throwaway caches
  (``_admit_cfg`` flips ``cache_layout`` back to ``'dense'``), then the
  slot write re-pages each admitted row through its freshly installed
  block table (``models/model.py:_write_cache_slots_paged``, the
  ``cache_slot_write`` kernel on the pool's block rows).
* The paged decode step reads K/V through the table over the same
  *logical* width the dense cache holds, so the chunk is term-for-term the
  dense program.

Copy-on-write GRPO prompt sharing: the G sibling rollouts of a GRPO group
carry the same prompt (``Request.group_id``).  The first sibling admitted
(the *leader*) prefills normally; the engine registers its
``ceil(P/bs)`` prompt blocks plus its seed logits.  Every later sibling
(*follower*) skips prefill — it maps the leader's prompt blocks read-only
(refcounted), allocates fresh blocks for its continuation, and samples its
seed token from the leader's registered prefill logits with its OWN key
(prefill is row-independent, so the leader's last-token logits are the
logits the follower's own prefill would produce).  One prefill and ONE
physical prompt copy per group.

A shared block is forked the moment a row is about to write into it:
before every decode chunk, ``_cow_fork_walk`` scans each live row's write
span and copies any block with refcount > 1 to a private block (a plain
device copy of the block's K/V rows in every layer, then the table entry).
Only the prompt *boundary* block (when P % block_size != 0) can ever be
both shared and written, so steady-state decode forks at most once per
follower.

Admission pressure: the default pool (``1 + B·nb`` blocks) never runs dry;
a caller-shrunk pool (``kv_pool_blocks``) turns allocation failure into
load shedding — admission caps itself to the rows the pool can table (the
rest stay QUEUED, in order), a row that cannot fork mid-decode is
reclaimed through the §10 retry machinery, and a request that cannot be
tabled even on an EMPTY batch is shed at once (FINISH_SHED).  Idle rows
keep stepping: a freed row's table points at the sink block 0 and its pos
row is -1, so its writes land in garbage that nothing reads as live.

§11/§14 observatory, as in JAX: a follower admission draws an
``admit_shared`` span on the engine lane and a ``serve.admit_ms`` sample,
its prompt plane is ``SHARED_PROMPT_BLOCK`` (prefilled once by the leader,
mapped here), and ``metrics_registry()`` adds the pool gauges and sharing
counters.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.engine.generate import GenerateConfig
from repro_torch.engine.sampling import sample, split_key
from repro_torch.models import model as M
from repro_torch.models.attention import cache_leaves, init_paged_kv_cache
from repro_torch.models.blocks import signature_runs
from repro_torch.models.config import ModelConfig
from repro_torch.obs import MetricsRegistry
from repro_torch.obs.ledger import PROMPT, SHARED_PROMPT_BLOCK

from .block_table import BlockAllocator, PoolExhausted
from .engine_loop import SlotEngine
from .request import FINISH_SHED, Request, Response


@torch.no_grad()
def _seed_from_logits(gen: GenerateConfig, seed_logits, keys):
    """Exactly ``_admit_vanilla``'s tail: split each request's decode key
    and sample its seed token — here from the LEADER's prefill logits."""
    keys, sub = split_key(keys)
    tok0, lp0 = sample(sub, seed_logits, gen.temperature, gen.top_p)
    return tok0, lp0, keys


class PagedSlotEngine(SlotEngine):
    """SlotEngine over a paged block pool with CoW GRPO prompt sharing."""

    # §14: raised around follower admission so the ledger tags those
    # prompt planes SHARED_PROMPT_BLOCK instead of PROMPT
    _admitting_followers = False

    def __init__(self, model: M.LM, cfg: ModelConfig, gen: GenerateConfig, *,
                 kv_pool_blocks: Optional[int] = None, **kw):
        if cfg.cache_layout != "paged":
            raise ValueError("PagedSlotEngine needs cfg.cache_layout='paged'")
        # consumed by _make_caches, which super().__init__ calls
        self._pool_blocks = kv_pool_blocks
        super().__init__(model, cfg, gen, **kw)

    # ------------------------------------------------------- layout hooks

    def _make_caches(self, B: int):
        cfg, dev = self.cfg, self.device
        bs = cfg.kv_block_size
        self.nb = -(-self.cache_len // bs)        # blocks per slot row
        self._pb = -(-self.P // bs)               # prompt blocks (CoW share)
        # default pool: the block-0 sink + one full row per slot — sized so
        # the engine can never run dry (sharing only ever FREES blocks, and
        # a fork transiently needs one free block, which sharing guarantees)
        self.NB = self._pool_blocks if self._pool_blocks is not None \
            else 1 + B * self.nb
        self.allocator = BlockAllocator(self.NB, bs)
        # slot -> list of physical block ids (None = slot empty, table=sink)
        self._slot_blocks: List[Optional[List[int]]] = [None] * B
        # group_id -> registered prompt blocks + seed logits (§13 sharing)
        self._groups: Dict[int, Dict] = {}
        dtype = M.torch_dtype(cfg.dtype)
        table = torch.zeros((B, self.nb), dtype=torch.int32, device=dev)
        caches = []
        blk_bytes = 0
        for _, run_len in signature_runs(cfg):
            one = init_paged_kv_cache(M.cache_config(self.model, cfg), B,
                                      self.cache_len, dtype, dev,
                                      num_blocks=self.NB, table=table)
            caches.append({"self": {
                name: buf[None].repeat((run_len,) + (1,) * buf.ndim)
                for name, buf in one.items()}})
            del one
            for name in cache_leaves(caches[-1]["self"]):
                buf = caches[-1]["self"][name]
                blk_bytes += run_len * buf[0, 0].numel() * buf.element_size()
        # bytes ONE block holds across every layer of the trunk — the unit
        # shared_prompt_bytes_saved counts in
        self._block_bytes = blk_bytes
        return caches

    def _admit_cfg(self) -> ModelConfig:
        # admissions prefill throwaway caches DENSELY — the dense engine's
        # device programs; the slot write re-pages
        return self.cfg.replace(cache_layout="dense")

    # ---------------------------------------------------------- admission

    def _admit(self) -> None:
        while True:
            self._gc_groups()
            cap = self.allocator.free_blocks // self.nb
            if cap == 0:
                if self.scheduler.active or not self.scheduler.queue:
                    # §13 admission pressure: decode completions will free
                    # blocks; queued requests wait their turn in order
                    return
                # empty batch and still no room for a full row: admit ONE
                # request and let allocation failure shed it — progress
                # instead of a livelocked queue (a follower may still fit,
                # needing only nb - pb fresh blocks)
                limit: Optional[int] = 1
            else:
                limit = cap
            group = self.scheduler.reserve(self._now(), limit=limit)
            if not group:
                return
            self._admit_group(group)

    def _admit_group(self, group: List[Tuple[int, Request]]) -> None:
        if self.spec_prefix:
            # spec-prefix admissions never share (the compacted prefix is
            # per-request); every row gets a freshly allocated full table
            ok = []
            for slot, req in group:
                if self._try_alloc_row(slot) is None:
                    self._shed_admission(slot, req)
                else:
                    ok.append((slot, req))
            if ok:
                super()._admit_group(ok)
            return
        leaders: List[Tuple[int, Request]] = []
        followers: List[Tuple[int, Request]] = []
        batch_leaders: Dict[int, np.ndarray] = {}   # gid -> leader prompt
        for slot, req in group:
            gid = req.group_id
            prompt = np.asarray(req.prompt, np.int32)
            sharable = gid is not None and (
                (gid in self._groups
                 and np.array_equal(self._groups[gid]["prompt"], prompt))
                or (gid in batch_leaders
                    and np.array_equal(batch_leaders[gid], prompt)))
            if sharable:
                followers.append((slot, req))
                continue
            if self._try_alloc_row(slot) is None:
                self._shed_admission(slot, req)
                continue
            if gid is not None:
                batch_leaders[gid] = prompt
            leaders.append((slot, req))
        if leaders:
            # registers this batch's new gids via _register_groups, so the
            # same-batch followers below share through the registry too
            super()._admit_group(leaders)
        if followers:
            self._admit_followers(followers)

    def _try_alloc_row(self, slot: int) -> Optional[List[int]]:
        try:
            row = self.allocator.alloc(self.nb)
        except PoolExhausted:
            return None
        self._slot_blocks[slot] = row
        return row

    def _shed_admission(self, slot: int, req: Request) -> None:
        """Pool cannot table this request on an empty batch: shed it now
        (no retry — re-queueing what cannot fit would livelock)."""
        now = self._now()
        self.scheduler.reclaim(slot, now=now, reason="shed")
        self._on_slot_freed(slot)
        self.fault_stats.add(failed=1)
        self.responses[req.request_id] = Response(
            request_id=req.request_id, tokens=np.zeros(0, np.int32),
            logprobs=np.zeros(0, np.float32), length=0,
            finish_reason=FINISH_SHED, slot=-1,
            queue_time=now - req.queued_at, serve_time=0.0,
            retries=req.retries)

    def _write_admitted(self, src_caches, slot_ids: np.ndarray):
        # install the freshly allocated tables FIRST — the paged slot write
        # re-pages each dense admission row through dst's table
        rows = np.stack([self._slot_blocks[s] for s in slot_ids])
        self._set_device_tables(slot_ids, rows)
        return super()._write_admitted(src_caches, slot_ids)

    def _register_groups(self, group, out) -> None:
        if "seed_logits" not in out:
            return                                  # spec path: no sharing
        for j, (slot, req) in enumerate(group):
            gid = req.group_id
            if gid is None or gid in self._groups:
                continue
            blocks = list(self._slot_blocks[slot][:self._pb])
            for b in blocks:                        # registry's own refs
                self.allocator.share(b)
            L = len(req.prompt)
            pos_row = np.full(self.cache_len, -1, np.int32)
            pos_row[self.P - L:self.P] = np.arange(L, dtype=np.int32)
            self._groups[gid] = {
                "blocks": blocks,
                "prompt": np.asarray(req.prompt, np.int32).copy(),
                "pos_row": pos_row,
                "seed_logits": out["seed_logits"][j].clone(),
            }

    def _admit_followers(self, fl: List[Tuple[int, Request]]) -> None:
        """Admit GRPO siblings WITHOUT prefill: map the leader's prompt
        blocks CoW, install the admission-time pos row, seed-sample from the
        leader's registered prefill logits with the follower's own key."""
        t0 = time.perf_counter()
        ok: List[Tuple[int, Request]] = []
        for slot, req in fl:
            g = self._groups[req.group_id]
            try:
                fresh = self.allocator.alloc(self.nb - self._pb)
            except PoolExhausted:
                self._shed_admission(slot, req)
                continue
            shared = list(g["blocks"])
            for b in shared:
                self.allocator.share(b)
            self._slot_blocks[slot] = shared + fresh
            self.allocator.shared_prompt_bytes_saved += \
                self._pb * self._block_bytes
            ok.append((slot, req))
        if not ok:
            return
        slots = [s for s, _ in ok]
        rows = np.stack([self._slot_blocks[s] for s in slots])
        pos_rows = np.stack([self._groups[r.group_id]["pos_row"]
                             for _, r in ok])
        self._set_device_tables(slots, rows, pos_rows=pos_rows)
        seeds = torch.stack(self._pad_group(
            [self._groups[r.group_id]["seed_logits"] for _, r in ok]))
        keys = self._stack_keys([r.key for _, r in ok])
        tok0, lp0, nkeys = _seed_from_logits(self.gen, seeds, keys)
        tok0, lp0 = tok0.cpu().numpy(), lp0.cpu().numpy()      # waits
        t1 = time.perf_counter()
        self.time_admit += t1 - t0
        self.metrics.observe("serve.admit_ms", (t1 - t0) * 1e3)
        if self.tracer.enabled:
            self.tracer.complete("admit_shared", self._etrack, t0, t1,
                                 cat="admit", rows=len(ok))
        B = self.scheduler.num_slots
        npos = np.zeros(B, np.int32)
        npos[:len(ok)] = [len(r.prompt) for _, r in ok]
        zi, zb = np.zeros(B, np.int32), np.zeros(B, bool)
        # §14: these rows' prompts exist in the pool because the leader
        # prefilled them once, not because this admission paid for them
        self._admitting_followers = True
        try:
            self._apply_admission(ok, tok0, lp0, npos, nkeys, zi, zb, None,
                                  zi, t0, t1)
        finally:
            self._admitting_followers = False
        self._harvest()

    def _set_device_tables(self, slots, rows, pos_rows=None) -> None:
        """Write host block-table rows (and optionally pos rows) into the
        device caches for ``slots``, in place.  Duplicate slots carry
        identical rows (admission padding), like the slot write itself."""
        dev = self.device
        sl = torch.as_tensor(np.asarray(slots), dtype=torch.int64, device=dev)
        tb = torch.as_tensor(np.asarray(rows), dtype=torch.int32, device=dev)
        pr = None if pos_rows is None else torch.as_tensor(
            np.asarray(pos_rows), dtype=torch.int32, device=dev)
        for run in self.caches:
            sc = run["self"]
            sc["table"][:, sl] = tb
            if pr is not None:
                sc["pos"][:, sl] = pr

    def _gc_groups(self) -> None:
        """Drop group registrations no pending request can still share.

        An entry holds its own refcounts on the prompt blocks, so dropping
        it is what lets a finished group's prompt copy actually free.
        Siblings arriving AFTER their group left the queue simply prefill
        as fresh leaders — sharing is an optimisation, never a dependency.
        """
        if not self._groups:
            return
        pending = {r.group_id for r in self.scheduler.queue
                   if r.group_id is not None}
        pending |= {r.group_id for _, r in self._retry_hold
                    if r.group_id is not None}
        for gid in [g for g in self._groups if g not in pending]:
            self.allocator.free_table(self._groups.pop(gid)["blocks"])

    # --------------------------------------------------------- decode loop

    def _run_chunk(self, steps: Optional[int] = None) -> None:
        # a drafted chunk writes one block of draft_k + 1 slots
        span = (self.draft.draft_k + 1) if self.draft \
            else (steps or self.chunk_steps)
        self._cow_fork_walk(span)
        super()._run_chunk(steps)

    def _cow_fork_walk(self, span: int) -> None:
        """Fork every shared block a live row is about to write (§13 CoW).

        The write span of the coming chunk is [w, w + span) clamped to the
        cache (the drafted block write clamps the same way); only the
        prompt boundary block can ever be both shared and in that span, so
        this walk is O(active rows) with at most one fork per follower's
        first chunk.  A fork that finds the pool dry
        reclaims the row through the §10 retry machinery (its blocks free
        on reclaim, so later rows in the same walk may succeed)."""
        bs = self.cfg.kv_block_size
        srcs: List[int] = []
        dsts: List[int] = []
        upd: List[Tuple[int, int, int]] = []        # (slot, idx, new block)
        for slot in list(self.scheduler.active):
            row = self._slot_blocks[slot]
            if row is None or self.done[slot]:
                continue
            w = min(int(self.write_idx[slot]), self.cache_len - span)
            lo = max(0, w) // bs
            hi = min(w + span - 1, self.cache_len - 1) // bs
            for i in range(lo, hi + 1):
                if self.allocator.refcount[row[i]] <= 1:
                    continue
                try:
                    nb = self.allocator.fork(row[i])
                except PoolExhausted:
                    self._reclaim(slot, FINISH_SHED)
                    break
                srcs.append(row[i])
                dsts.append(nb)
                upd.append((slot, i, nb))
                row[i] = nb
        if srcs:
            self._apply_forks(srcs, dsts, upd)

    def _apply_forks(self, srcs, dsts, upd) -> None:
        """``pool[:, dst] = pool[:, src]`` for every K/V pool (a plain
        device copy, as JAX's ``.at[].set``), then the table entries."""
        dev = self.device

        def idx(vals):
            return torch.as_tensor(vals, dtype=torch.int64, device=dev)

        s, d = idx(srcs), idx(dsts)
        sl, ix = idx([u[0] for u in upd]), idx([u[1] for u in upd])
        nv = torch.as_tensor([u[2] for u in upd], dtype=torch.int32,
                             device=dev)
        for run in self.caches:
            sc = run["self"]
            for name in cache_leaves(sc):
                sc[name][:, d] = sc[name][:, s]
            sc["table"][:, sl, ix] = nv

    # ------------------------------------------------------------- release

    def _on_slot_freed(self, slot: int) -> None:
        row = self._slot_blocks[slot]
        if row is None:
            return
        self.allocator.free_table(row)
        self._slot_blocks[slot] = None
        # point the freed row's table at the sink and blank its pos row, so
        # its (gated, never-stored) idle decode writes land in garbage block
        # 0 instead of blocks the allocator may hand to the next admission
        for run in self.caches:
            sc = run["self"]
            sc["table"][:, slot] = 0
            sc["pos"][:, slot] = -1

    # ------------------------------------------------------------- metrics

    def metrics_registry(self) -> MetricsRegistry:
        reg = super().metrics_registry()
        a = self.allocator
        # §13: pool occupancy gauges + sharing counters (extensive across
        # engines: each owns its pool), and the byte view of live/peak pool
        # usage (block bytes are known exactly)
        reg.set("paged_num_blocks", float(a.num_blocks), agg="sum")
        reg.set("paged_blocks_in_use", float(a.blocks_in_use), agg="sum")
        reg.set("paged_peak_blocks_in_use", float(a.peak_blocks_in_use),
                agg="sum")
        reg.inc("paged_cow_forks", a.cow_forks)
        reg.inc("paged_alloc_failures", a.alloc_failures)
        reg.inc("paged_shared_prompt_bytes_saved",
                a.shared_prompt_bytes_saved)
        reg.set("paged_pool_pressure", self._pool_pressure())
        reg.set("paged_bytes_in_use",
                float(a.blocks_in_use) * self._block_bytes, agg="sum")
        reg.set("paged_peak_bytes_in_use",
                float(a.peak_blocks_in_use) * self._block_bytes, agg="sum")
        return reg

    def _prompt_category(self, req: Request) -> int:
        return SHARED_PROMPT_BLOCK if self._admitting_followers else PROMPT

    def _pool_pressure(self) -> float:
        """KV pool pressure in [0, 1]: the share of blocks not free."""
        return 1.0 - float(self.allocator.free_blocks) / max(1, self.NB)

    # ------------------------------------------- exact kill-and-resume §10

    def state_dict(self) -> Dict:
        st = super().state_dict()
        st["paged"] = {
            "allocator": self.allocator.state_dict(),
            "slot_blocks": {str(s): np.asarray(row, np.int32)
                            for s, row in enumerate(self._slot_blocks)
                            if row is not None},
            "groups": {str(g): {"blocks": np.asarray(e["blocks"], np.int32),
                                "prompt": e["prompt"],
                                "pos_row": e["pos_row"],
                                "seed_logits": e["seed_logits"].to(
                                    "cpu", copy=True)}
                       for g, e in self._groups.items()},
        }
        return st

    def load_state_dict(self, st: Dict) -> None:
        super().load_state_dict(st)
        p = st["paged"]
        self.allocator.load_state_dict(p["allocator"])
        self._slot_blocks = [None] * self.scheduler.num_slots
        for s, row in p["slot_blocks"].items():
            self._slot_blocks[int(s)] = [int(b) for b in np.asarray(row)]
        self._groups = {
            int(g): {"blocks": [int(b) for b in np.asarray(e["blocks"])],
                     "prompt": np.asarray(e["prompt"], np.int32),
                     "pos_row": np.asarray(e["pos_row"], np.int32),
                     "seed_logits": torch.as_tensor(e["seed_logits"]).to(
                         self.device, copy=True)}
            for g, e in p["groups"].items()}
