"""N-gram draft source: suffix hash map over each row's own token stream
plus its GRPO sibling trajectories (the port's own copy of
``repro/drafting/ngram.py``).

Why this works for RL rollouts: the G sibling rollouts of a GRPO group are
sampled from the same policy on the same prompt, and consecutive-epoch
rollouts of the same prompt overlap heavily (the redundancy SPEC-RL's
prefix reuse exploits, paper Fig. 2).  Both corpora sit in ``RolloutCache``
already — so after the verified prefix diverges, the *continuation* can
still be speculated nearly for free: match the row's current suffix
against its own history and its siblings, and propose the tokens that
followed the match last time.

Mechanics (host-side, O(1) per lookup):

* every indexed sequence registers, for each position p and each gram
  length m in [min_ngram, max_ngram], the mapping
  ``tuple(seq[p-m:p]) -> (seq_ref, p)`` — "this m-gram was last seen
  continuing at position p of seq_ref".  Later registrations win, so the
  row's own stream (indexed incrementally as tokens are emitted) shadows
  the sibling corpus, and recent occurrences shadow old ones.
* a proposal looks up the stream's current suffix (including the pending
  just-sampled-but-not-yet-stored token), longest gram first, and copies
  up to k continuation tokens from the match site.

Proposals are **deterministic** functions of the row's context — a point
mass q = δ(draft) — which is what makes the §9 rejection-sampling
acceptance exact: the residual distribution is p with the draft token
masked out (engine/sampling.residual_sample).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .controller import DraftConfig

# seq_ref -1 means "the row's own stream"; >= 0 indexes the sibling corpus
SELF = -1


class NGramDraftSource:
    """Per-row suffix hash maps with incremental own-stream indexing."""

    def __init__(self, cfg: DraftConfig, rows: int):
        cfg.validate()
        self.cfg = cfg
        self._stream: List[List[int]] = [[] for _ in range(rows)]
        self._corpus: List[List[np.ndarray]] = [[] for _ in range(rows)]
        self._index: List[Dict[Tuple[int, ...], Tuple[int, int]]] = \
            [{} for _ in range(rows)]

    @property
    def rows(self) -> int:
        return len(self._stream)

    # ------------------------------------------------------------- indexing

    def _register(self, row: int, seq: Sequence[int], seq_ref: int,
                  start: int) -> None:
        """Index grams ending just before each position p >= max(start, 1)."""
        idx = self._index[row]
        lo, hi = self.cfg.min_ngram, self.cfg.max_ngram
        for p in range(max(start, 1), len(seq)):
            for m in range(lo, min(hi, p) + 1):
                idx[tuple(seq[p - m:p])] = (seq_ref, p)

    def reset(self, row: int, context: Sequence[int],
              corpus: Optional[Sequence[np.ndarray]] = None) -> None:
        """(Re)seed a row: context = prompt ⊕ already-kept tokens; corpus =
        sibling / previous-rollout trajectories (indexed first, so the
        row's own stream shadows them on gram collisions)."""
        self._stream[row] = [int(t) for t in context]
        self._corpus[row] = []
        self._index[row] = {}
        if corpus and self.cfg.use_siblings:
            for seq in corpus:
                seq = np.asarray(seq, np.int32)
                if len(seq) == 0:
                    continue
                sid = len(self._corpus[row])
                self._corpus[row].append(seq)
                self._register(row, [int(t) for t in seq], sid, 1)
        self._register(row, self._stream[row], SELF, 1)

    def extend(self, row: int, tokens: Sequence[int]) -> None:
        """Append newly kept tokens to the row's stream and index them."""
        if len(tokens) == 0:
            return
        start = len(self._stream[row])
        self._stream[row].extend(int(t) for t in tokens)
        self._register(row, self._stream[row], SELF, start)

    # ------------------------------------------------------------- proposal

    def propose(self, row: int, k: int,
                pending: Optional[int] = None) -> np.ndarray:
        """Up to ``k`` draft tokens continuing the row's current suffix.

        ``pending`` is the just-sampled token that will start the next
        decode block — the suffix must end with it even though it is not
        in the stream yet.  Returns an empty array on no match.
        """
        if k <= 0:
            return np.zeros(0, np.int32)
        stream = self._stream[row]
        # only the trailing max_ngram tokens are ever matched on — slice
        # instead of copying the whole stream in the decode hot loop
        tail = stream[-self.cfg.max_ngram:]
        if pending is not None:
            tail = tail + [int(pending)]
        idx = self._index[row]
        for m in range(min(self.cfg.max_ngram, len(tail)),
                       self.cfg.min_ngram - 1, -1):
            hit = idx.get(tuple(tail[-m:]))
            if hit is None:
                continue
            ref, p = hit
            if ref == SELF:
                cont = stream[p:p + k]
            else:
                cont = self._corpus[row][ref][p:p + k]
            if len(cont):
                return np.asarray(cont, np.int32)
        return np.zeros(0, np.int32)
