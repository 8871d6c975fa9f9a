"""SPEC-RL rollout cache (paper §3.2).

Host-side store of the most recent rollout (tokens + behaviour log-probs)
per prompt.  A short history ring per prompt supports the *Delayed Reuse*
ablation (drafts from ``lag`` epochs/visits ago).  The cache is refreshed
immediately after every step for the prompts that were rolled — the paper's
"immediate cache-updating strategy" (Table 2 shows why it matters).

Sibling groups (DESIGN.md §9): GRPO rolls ``G`` responses per problem, and
the dataset assigns slot ``g`` of problem ``p`` the cache key
``p * G + g`` — so the cache doubles as the draft-engine's n-gram corpus:
``siblings(prompt_id)`` returns the other group members' latest rollouts,
a highly-correlated draft source for the continuation past the verified
prefix.  Group membership is registered on ``put`` and unregistered on
eviction, so LRU pressure never leaves a group pointing at evicted entries.
"""
from __future__ import annotations

from collections import OrderedDict, deque
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Set

import numpy as np


@dataclass
class CacheEntry:
    tokens: np.ndarray        # (L,) int32 response tokens (no pads)
    logprobs: np.ndarray      # (L,) float32 behaviour log-probs
    step: int                 # training step that produced it
    ends_with_eos: bool


class RolloutCache:
    """Maps prompt_id -> recent rollouts (most recent last).

    ``max_prompts`` bounds host memory: millions of distinct prompt_ids must
    not grow the store without limit, so when set, the least-recently-used
    prompt (by put *or* hit) is evicted on overflow.  An eviction only costs
    a cold-start rollout for that prompt on its next visit — SPEC-RL stays
    correct, it just loses the reuse speedup there — and ``stats()`` reports
    the eviction counter so the trainer can see the pressure.

    ``group_size`` enables sibling lookups: prompt_id ``p*G + g`` belongs to
    group ``p`` (the dataset's cache-key contract).  Pass an explicit
    ``group`` to ``put`` for non-contiguous schemes.
    """

    def __init__(self, history: int = 4, max_prompts: Optional[int] = None,
                 group_size: int = 0):
        self.history = max(2, history)
        assert max_prompts is None or max_prompts > 0, max_prompts
        assert group_size >= 0, group_size
        self.max_prompts = max_prompts
        self.group_size = group_size
        self._store: "OrderedDict[int, deque]" = OrderedDict()
        self._groups: Dict[int, Set[int]] = {}     # group id -> member pids
        self._group_of: Dict[int, int] = {}        # pid -> group id
        self.puts = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._store)

    def _default_group(self, pid: int) -> Optional[int]:
        return pid // self.group_size if self.group_size > 0 else None

    def _unlink_group(self, pid: int) -> None:
        gid = self._group_of.pop(pid, None)
        if gid is None:
            return
        members = self._groups.get(gid)
        if members is not None:
            members.discard(pid)
            if not members:
                del self._groups[gid]

    def put(self, prompt_id: int, tokens: np.ndarray, logprobs: np.ndarray,
            length: int, step: int, eos_id: int = 2,
            group: Optional[int] = None) -> None:
        tokens = np.asarray(tokens[:length], np.int32)
        logprobs = np.asarray(logprobs[:length], np.float32)
        ends = bool(length > 0 and tokens[-1] == eos_id)
        pid = int(prompt_id)
        q = self._store.get(pid)
        if q is None:
            q = self._store[pid] = deque(maxlen=self.history)
        else:
            self._store.move_to_end(pid)
        q.append(CacheEntry(tokens, logprobs, step, ends))
        gid = group if group is not None else self._default_group(pid)
        if gid is not None and self._group_of.get(pid) != gid:
            self._unlink_group(pid)
            self._group_of[pid] = gid
            self._groups.setdefault(gid, set()).add(pid)
        self.puts += 1
        while self.max_prompts is not None and len(self._store) > self.max_prompts:
            evicted, _ = self._store.popitem(last=False)  # least recently used
            self._unlink_group(evicted)
            self.evictions += 1

    def get(self, prompt_id: int, lag: int = 1) -> Optional[CacheEntry]:
        """lag=1: most recent rollout; lag=2: one before it (Delayed Reuse)."""
        q = self._store.get(int(prompt_id))
        if not q or len(q) < lag:
            self.misses += 1
            return None
        self.hits += 1
        self._store.move_to_end(int(prompt_id))      # LRU touch
        return q[-lag]

    def siblings(self, prompt_id: int, lag: int = 1) -> List[CacheEntry]:
        """Latest rollouts of the other members of ``prompt_id``'s group.

        The draft-engine corpus lookup (DESIGN.md §9).  Does NOT touch LRU
        recency and does not count as hits/misses — reading a sibling for
        n-gram material should not keep it alive over prompts that are
        actually being rolled.  Every returned entry is backed by the
        store (eviction unregisters members, so nothing dangles).
        """
        pid = int(prompt_id)
        gid = self._group_of.get(pid)
        if gid is None:
            gid = self._default_group(pid)
        if gid is None:
            return []
        members = self._groups.get(gid, set())
        out = []
        for other in sorted(members):
            if other == pid:
                continue
            q = self._store.get(other)
            assert q is not None, f"dangling sibling {other} in group {gid}"
            if len(q) >= lag:
                out.append(q[-lag])
        return out

    def batch_get(self, prompt_ids: Sequence[int], max_len: int, lag: int = 1
                  ) -> Dict[str, np.ndarray]:
        """Right-padded draft batch for verification.

        Returns dict with draft_tokens (B, max_len) int32, draft_logprobs
        (B, max_len) f32, draft_len (B,) int32 (0 = no draft),
        draft_eos (B,) bool.
        """
        B = len(prompt_ids)
        toks = np.zeros((B, max_len), np.int32)
        lps = np.zeros((B, max_len), np.float32)
        lens = np.zeros((B,), np.int32)
        eos = np.zeros((B,), bool)
        for i, pid in enumerate(prompt_ids):
            e = self.get(pid, lag)
            if e is None:
                continue
            L = min(len(e.tokens), max_len)
            toks[i, :L] = e.tokens[:L]
            lps[i, :L] = e.logprobs[:L]
            lens[i] = L
            eos[i] = e.ends_with_eos and L == len(e.tokens)
        return {"draft_tokens": toks, "draft_logprobs": lps,
                "draft_len": lens, "draft_eos": eos}

    def batch_siblings(self, prompt_ids: Sequence[int], lag: int = 1
                       ) -> List[List[np.ndarray]]:
        """Per-row n-gram corpora: each row's own latest rollout (when
        cached) plus its siblings' token arrays."""
        out: List[List[np.ndarray]] = []
        for pid in prompt_ids:
            corpus = []
            q = self._store.get(int(pid))
            if q and len(q) >= lag:
                corpus.append(q[-lag].tokens)
            corpus.extend(e.tokens for e in self.siblings(pid, lag))
            out.append(corpus)
        return out

    def batch_put(self, prompt_ids: Sequence[int], tokens: np.ndarray,
                  logprobs: np.ndarray, lengths: np.ndarray, step: int,
                  eos_id: int = 2) -> None:
        for i, pid in enumerate(prompt_ids):
            self.put(pid, tokens[i], logprobs[i], int(lengths[i]), step, eos_id)

    def stats(self) -> Dict[str, float]:
        total = self.hits + self.misses
        return {"size": len(self._store), "puts": self.puts,
                "hit_rate": self.hits / total if total else 0.0,
                "evictions": self.evictions,
                "groups": len(self._groups),
                "max_prompts": self.max_prompts or 0}
