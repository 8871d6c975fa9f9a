"""Rollout diagnostics and diversity metrics from the paper, plus the
draft-engine telemetry accumulator (own copy of ``repro/core/metrics.py``,
which imports no JAX).

- ROUGE-1 token overlap between consecutive-epoch rollouts (Fig. 2)
- Distinct-1 (Li et al. 2016) and Self-BLEU (Zhu et al. 2018) (Fig. 6)
- policy entropy / KL / clip-fraction summaries (Fig. 5) are computed in the
  RL trainer and aggregated here.
- ``DraftStats`` (DESIGN.md §9): acceptance / draft-length / tokens-per-
  forward counters shared by the drafted decode loops, the serving slot
  engine and the trainer step logs.
- ``FaultStats`` (DESIGN.md §10): recovery-event counters — timeouts,
  retries, sheds, quarantines, degradations — shared by the slot engine,
  the mesh server's gathered view and the trainer watchdog logs.
"""
from __future__ import annotations

import math
from collections import Counter
from dataclasses import dataclass
from typing import Dict, List, Sequence

import numpy as np


@dataclass
class DraftStats:
    """Draft-and-verify telemetry (DESIGN.md §9).

    Counters accumulate over decode forwards; the derived ratios are the
    three numbers that characterise a drafted decode run:

    * ``accept_rate``       — accepted / proposed draft tokens (the
      rejection-sampling yield; the DraftController's steering signal);
    * ``mean_draft_len``    — proposed draft tokens per drafting forward
      (how deep the controller is speculating);
    * ``tokens_per_forward``— emitted tokens per model forward, the
      end-to-end speedup lever (1.0 = vanilla decode; up to draft_k + 1).
    """
    forwards: int = 0          # decode forwards (drafted or not)
    draft_forwards: int = 0    # forwards that verified >= 1 draft token
    proposed: int = 0          # draft tokens verified
    accepted: int = 0          # draft tokens accepted by rejection sampling
    emitted: int = 0           # tokens actually kept (stored) by decode

    def add_step(self, forwards: int, proposed: int, accepted: int,
                 emitted: int, draft_forwards: int = 0) -> None:
        self.forwards += int(forwards)
        self.draft_forwards += int(draft_forwards)
        self.proposed += int(proposed)
        self.accepted += int(accepted)
        self.emitted += int(emitted)

    @property
    def accept_rate(self) -> float:
        return self.accepted / self.proposed if self.proposed else 0.0

    @property
    def mean_draft_len(self) -> float:
        return self.proposed / self.draft_forwards if self.draft_forwards \
            else 0.0

    @property
    def tokens_per_forward(self) -> float:
        return self.emitted / self.forwards if self.forwards else 0.0

    def as_dict(self, prefix: str = "") -> Dict[str, float]:
        return {
            f"{prefix}accept_rate": self.accept_rate,
            f"{prefix}mean_draft_len": self.mean_draft_len,
            f"{prefix}tokens_per_forward": self.tokens_per_forward,
            f"{prefix}draft_proposed": float(self.proposed),
            f"{prefix}draft_accepted": float(self.accepted),
            f"{prefix}decode_forwards": float(self.forwards),
            f"{prefix}decode_emitted": float(self.emitted),
            f"{prefix}draft_forwards": float(self.draft_forwards),
        }


@dataclass
class FaultStats:
    """Failure / recovery telemetry (DESIGN.md §10).

    Every recovery action the serving layer can take is a counter here, so
    "did the degradation ladder fire?" is always answerable from ``stats()``
    instead of from log archaeology.  The schema is uniform across engines
    (zeros when a path never fired), which lets ``MeshSlotServer.stats()``
    sum shards field-by-field and the trainer log the same keys.
    """
    injected: int = 0          # fault-plan events actually applied
    timeouts: int = 0          # deadline expiries -> slot reclamation
    retries: int = 0           # reclaimed requests re-admitted
    sheds: int = 0             # requests dropped by queue backpressure
    rejected: int = 0          # new submissions refused (reject-new policy)
    nan_events: int = 0        # non-finite logit rows caught by the guard
    quarantines: int = 0       # rows pulled out of the decode batch
    draft_errors: int = 0      # draft-source exceptions caught
    draft_disabled: int = 0    # rows whose drafting was switched off
    impl_fallbacks: int = 0    # decode_impl ladder steps (pallas->...->naive)
    failed: int = 0            # requests finished with a failure reason

    FIELDS = ("injected", "timeouts", "retries", "sheds", "rejected",
              "nan_events", "quarantines", "draft_errors", "draft_disabled",
              "impl_fallbacks", "failed")

    def add(self, **counts: int) -> None:
        for k, v in counts.items():
            assert k in self.FIELDS, k
            setattr(self, k, getattr(self, k) + int(v))

    def merge(self, other: "FaultStats") -> None:
        for k in self.FIELDS:
            setattr(self, k, getattr(self, k) + getattr(other, k))

    def as_dict(self, prefix: str = "fault_") -> Dict[str, float]:
        return {f"{prefix}{k}": float(getattr(self, k)) for k in self.FIELDS}

    @classmethod
    def from_dict(cls, d: Dict[str, float], prefix: str = "fault_"
                  ) -> "FaultStats":
        return cls(**{k: int(d.get(f"{prefix}{k}", 0)) for k in cls.FIELDS})


def rouge1_overlap(a: Sequence[int], b: Sequence[int]) -> float:
    """Unigram F1 overlap between two token sequences (Fig. 2 metric)."""
    if len(a) == 0 or len(b) == 0:
        return 0.0
    ca, cb = Counter(a), Counter(b)
    inter = sum((ca & cb).values())
    p = inter / max(len(b), 1)
    r = inter / max(len(a), 1)
    return 2 * p * r / (p + r) if (p + r) else 0.0


def batch_overlap(prev: List[np.ndarray], curr: List[np.ndarray]) -> float:
    vals = [rouge1_overlap(p.tolist(), c.tolist()) for p, c in zip(prev, curr)]
    return float(np.mean(vals)) if vals else 0.0


def prefix_match_fraction(prev: np.ndarray, curr: np.ndarray) -> float:
    """Longest-common-prefix fraction — the redundancy SPEC-RL exploits."""
    L = min(len(prev), len(curr))
    if L == 0:
        return 0.0
    neq = prev[:L] != curr[:L]
    lcp = int(np.argmax(neq)) if neq.any() else L
    return lcp / max(len(curr), 1)


def distinct_n(rollouts: List[np.ndarray], n: int = 1) -> float:
    """#unique n-grams / #n-grams across the batch (Distinct-1 for n=1)."""
    grams = set()
    total = 0
    for r in rollouts:
        toks = r.tolist()
        for i in range(len(toks) - n + 1):
            grams.add(tuple(toks[i:i + n]))
            total += 1
    return len(grams) / total if total else 0.0


def _ngram_counts(toks: List[int], n: int) -> Counter:
    return Counter(tuple(toks[i:i + n]) for i in range(len(toks) - n + 1))


def _bleu(cand: List[int], refs: List[List[int]], max_n: int = 4) -> float:
    if not cand:
        return 0.0
    logs = []
    for n in range(1, max_n + 1):
        cc = _ngram_counts(cand, n)
        if not cc:
            break
        best = Counter()
        for r in refs:
            rc = _ngram_counts(r, n)
            for g, c in rc.items():
                best[g] = max(best[g], c)
        match = sum(min(c, best[g]) for g, c in cc.items())
        total = sum(cc.values())
        logs.append(math.log(max(match, 1e-9) / total))
    if not logs:
        return 0.0
    score = math.exp(sum(logs) / len(logs))
    ref_len = min(len(r) for r in refs) if refs else 1
    bp = 1.0 if len(cand) >= ref_len else math.exp(1 - ref_len / max(len(cand), 1))
    return bp * score


def self_bleu(rollouts: List[np.ndarray], max_n: int = 4,
              sample: int = 16) -> float:
    """Mean BLEU of each rollout against the others (lower = more diverse)."""
    seqs = [r.tolist() for r in rollouts if len(r) > 0][:sample]
    if len(seqs) < 2:
        return 0.0
    vals = []
    for i, cand in enumerate(seqs):
        refs = seqs[:i] + seqs[i + 1:]
        vals.append(_bleu(cand, refs, max_n))
    return float(np.mean(vals))


def summarize(history: List[Dict[str, float]], keys: Sequence[str],
              percentiles: bool = False) -> Dict[str, float]:
    """Per-key mean over a metrics history; with ``percentiles=True`` each
    key additionally reports ``{k}_min/_max/_p50/_p95/_p99`` via the §11
    log-bucketed histogram helper (``obs.extend_summary``: the tail, not
    just the mean; the watchdog's stall detector reads the same p95)."""
    from repro_torch.obs import extend_summary
    out = {}
    for k in keys:
        vals = [h[k] for h in history if k in h]
        if not vals:
            continue
        out[k] = float(np.mean(vals))
        if percentiles:
            for suffix, v in extend_summary(vals).items():
                out[f"{k}_{suffix}"] = v
    return out
