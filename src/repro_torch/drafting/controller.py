"""Draft configuration and the per-row adaptive draft-length controller
(the port's own copy of ``repro/drafting/controller.py``).

``DraftController`` follows the ``core/lenience.py`` controller pattern —
a small host-side object with a query method and an ``update`` fed by the
observed signal.  Here the signal is the per-row *running acceptance rate*
of drafted tokens, and the control variable is how many tokens to draft on
the row's next forward.  The lever is real because the decode loops
run the verify block at the power-of-two cover of the widest live
proposal (``step.block_width``): rows whose drafts keep being rejected
fall back toward plain single-token decoding (k -> k_min, a (B, 2) block)
instead of paying a full (B, draft_k + 1) forward for tokens that never
land, while rows whose sibling / history drafts track the policy
speculate deeper (k -> draft_k).

The schedule uses the classic speculative-decoding yield argument: with
per-token acceptance probability r, the expected number of accepted tokens
of an unbounded draft is r / (1 - r), so the controller drafts
``floor(r / (1 - r)) + 1`` tokens, clipped to [k_min, draft_k].
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class DraftConfig:
    """Draft-engine knobs (host-side; the step itself sees only draft_k).

    kind: 'off' disables drafting; 'ngram' proposes from the suffix hash
    map over the row's own prompt ⊕ generated stream plus its sibling
    trajectories (drafting/ngram.py).
    """
    kind: str = "off"            # 'off' | 'ngram'
    draft_k: int = 8             # max drafted tokens per forward
    min_ngram: int = 1           # shortest suffix n-gram to match on
    max_ngram: int = 3           # longest (tried first; most specific wins)
    use_siblings: bool = True    # index GRPO sibling trajectories too
    adaptive: bool = True        # per-row draft length from acceptance rate
    accept_ema: float = 0.7      # EMA decay of the running acceptance rate
    accept_init: float = 0.5     # optimistic prior: start at draft_len ~ 2
    k_min: int = 0               # floor (0 = allow falling back to vanilla)

    @property
    def enabled(self) -> bool:
        return self.kind != "off"

    def validate(self) -> None:
        assert self.kind in ("off", "ngram"), self.kind
        assert 1 <= self.min_ngram <= self.max_ngram, \
            (self.min_ngram, self.max_ngram)
        assert 0 < self.draft_k, self.draft_k
        assert 0 <= self.k_min <= self.draft_k, (self.k_min, self.draft_k)
        assert 0.0 <= self.accept_ema < 1.0, self.accept_ema


class DraftController:
    """Per-row draft length from a running acceptance-rate EMA."""

    def __init__(self, cfg: DraftConfig, rows: int):
        cfg.validate()
        self.cfg = cfg
        self.rate = np.full(rows, cfg.accept_init, np.float64)

    def reset(self, row: int) -> None:
        """Forget a slot's history (serving slot reuse)."""
        self.rate[row] = self.cfg.accept_init

    def draft_len(self, row: int) -> int:
        """How many tokens to draft for ``row``'s next forward."""
        if not self.cfg.adaptive:
            return self.cfg.draft_k
        r = min(float(self.rate[row]), 0.98)
        opt = math.floor(r / (1.0 - r)) + 1
        return max(self.cfg.k_min, min(self.cfg.draft_k, opt))

    def update(self, row: int, proposed: int, accepted: int) -> None:
        """Fold one verify outcome into the row's acceptance EMA.

        ``accepted`` is the raw rejection-sampling acceptance count (before
        eos/budget truncation — those say nothing about draft quality)."""
        if proposed <= 0:
            return
        e = self.cfg.accept_ema
        self.rate[row] = e * self.rate[row] + (1 - e) * (accepted / proposed)
