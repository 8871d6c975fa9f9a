"""Savings attribution: provenance counts × per-token cost (DESIGN.md §14;
own copy of ``repro/obs/attrib.py``).

The ledger says which mechanism produced each token; this module prices
them.  Every token in a SAVINGS category displaced work a vanilla run
would have done — a sequential decode step for reused/accepted/stitched
tokens, a prefill token's share for a CoW-shared prompt block — so

    saved_s[mechanism] = tokens[mechanism] × unit_cost_s

with the unit costs *measured*, not assumed: callers pass the decode
per-token seconds observed on the same run (``measured_token_cost``: the
registry's ``serve.token_ms`` histogram mean, or the rollout's decode
seconds over its generated tokens).  DRAFT_BONUS is free-but-not-saved:
the bonus token rides a verify forward that was already paid for, so it
appears in the report as produced tokens with zero displaced cost.

The report is exported three ways, all built on §11 primitives:
``to_registry`` (→ ``as_dict``/Prometheus via the normal path), and
``counter_events`` → Chrome-trace "C"-phase counter tracks so the
about://tracing timeline shows stacked seconds-saved per mechanism
alongside the spans that earned them.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Union

import numpy as np

from .ledger import (CATEGORY_NAMES, DRAFT_ACCEPTED, DRAFT_BONUS, FRESH,
                     NUM_CATEGORIES, PROMPT, QUARANTINE_CLAMPED,
                     REUSED_PREFIX, RETRY_STITCHED, SHARED_PROMPT_BLOCK,
                     TokenLedger)
from .registry import MetricsRegistry

#: mechanism → provenance categories it is credited for
MECHANISMS: Dict[str, tuple] = {
    "spec_prefix": (REUSED_PREFIX,),            # SPEC-RL cached-rollout reuse
    "draft": (DRAFT_ACCEPTED,),                 # §9 n-gram continuation drafts
    "retry_reverify": (RETRY_STITCHED, QUARANTINE_CLAMPED),  # §10 recovery
    "shared_prompt": (SHARED_PROMPT_BLOCK,),    # §13 CoW prompt blocks
}

#: categories priced at prefill (not decode) unit cost
_PREFILL_PRICED = frozenset((SHARED_PROMPT_BLOCK,))


@dataclass
class AttributionReport:
    """Per-mechanism seconds-saved for one epoch/run."""
    counts: Dict[str, int]                 # category name → token count
    saved_s: Dict[str, float]              # mechanism → attributed seconds
    t_token_s: float                       # measured decode s/token
    t_prompt_token_s: float                # measured prefill s/token
    total_tokens: int = 0
    fresh_tokens: int = 0
    bonus_tokens: int = 0
    actual_s: Optional[float] = None       # measured rollout wall-clock
    epoch: Optional[int] = None
    extra: Dict[str, float] = field(default_factory=dict)

    @property
    def total_saved_s(self) -> float:
        return float(sum(self.saved_s.values()))

    @property
    def baseline_s(self) -> Optional[float]:
        """Implied vanilla wall-clock: measured actual + attributed saved."""
        if self.actual_s is None:
            return None
        return self.actual_s + self.total_saved_s

    def as_dict(self) -> Dict[str, float]:
        out: Dict[str, float] = {
            "attrib.t_token_s": self.t_token_s,
            "attrib.t_prompt_token_s": self.t_prompt_token_s,
            "attrib.total_tokens": float(self.total_tokens),
            "attrib.fresh_tokens": float(self.fresh_tokens),
            "attrib.bonus_tokens": float(self.bonus_tokens),
            "attrib.total_saved_s": self.total_saved_s,
        }
        for name, n in self.counts.items():
            out[f"attrib.tokens.{name}"] = float(n)
        for mech, s in self.saved_s.items():
            out[f"attrib.saved_s.{mech}"] = float(s)
        if self.actual_s is not None:
            out["attrib.actual_s"] = float(self.actual_s)
            out["attrib.baseline_s"] = float(self.baseline_s)
            out["attrib.speedup"] = (self.baseline_s / self.actual_s
                                     if self.actual_s > 0 else 1.0)
        out.update({f"attrib.{k}": float(v) for k, v in self.extra.items()})
        return out

    # ------------------------------------------------------------- exports

    def to_registry(self, reg: MetricsRegistry) -> MetricsRegistry:
        """Counters for token tallies, gauges for rates/seconds — the §11
        registry then carries attribution through as_dict/Prometheus/merge
        like any other metric."""
        for name, n in self.counts.items():
            if n:
                reg.inc(f"attrib.tokens.{name}", int(n))
        for mech, s in self.saved_s.items():
            reg.set(f"attrib.saved_s.{mech}", float(s))
        reg.set("attrib.total_saved_s", self.total_saved_s)
        reg.set("attrib.t_token_s", self.t_token_s)
        if self.actual_s is not None:
            reg.set("attrib.speedup",
                    self.baseline_s / self.actual_s if self.actual_s > 0
                    else 1.0)
        return reg

    def counter_events(self, ts_s: float = 0.0,
                       track: str = "attrib") -> List[dict]:
        """Chrome-trace counter samples ("C" phase, stacked series) for
        export.chrome_trace(..., counters=...)."""
        return [
            {"name": "tokens_by_provenance", "track": track, "ts": ts_s,
             "values": {n: float(c) for n, c in self.counts.items() if c}},
            {"name": "saved_seconds", "track": track, "ts": ts_s,
             "values": {m: float(s) for m, s in self.saved_s.items()}},
        ]

    def summary(self) -> str:
        """Human-readable table (the analysis CLI prints this)."""
        lines = ["speculation economics"
                 + (f" — epoch {self.epoch}" if self.epoch is not None
                    else ""),
                 f"  decode unit cost   {self.t_token_s * 1e3:9.4f} ms/tok"
                 f"   prefill {self.t_prompt_token_s * 1e3:.4f} ms/tok",
                 f"  {'mechanism':<16}{'tokens':>10}{'saved_s':>12}"]
        for mech, cats in MECHANISMS.items():
            n = sum(self.counts.get(CATEGORY_NAMES[c], 0) for c in cats)
            lines.append(f"  {mech:<16}{n:>10}{self.saved_s[mech]:>12.4f}")
        lines.append(f"  {'fresh (paid)':<16}{self.fresh_tokens:>10}"
                     f"{'—':>12}")
        lines.append(f"  {'bonus (free)':<16}{self.bonus_tokens:>10}"
                     f"{'—':>12}")
        lines.append(f"  total saved {self.total_saved_s:.4f}s")
        if self.actual_s is not None:
            lines.append(f"  actual {self.actual_s:.4f}s  implied baseline "
                         f"{self.baseline_s:.4f}s  speedup "
                         f"{self.baseline_s / max(self.actual_s, 1e-12):.2f}x")
        return "\n".join(lines)


def _counts_array(source: Union[TokenLedger, Dict[str, int],
                                np.ndarray]) -> np.ndarray:
    if isinstance(source, TokenLedger):
        return source.category_counts()
    if isinstance(source, dict):
        out = np.zeros(NUM_CATEGORIES, np.int64)
        for i, name in enumerate(CATEGORY_NAMES):
            out[i] = int(source.get(name, 0))
        return out
    arr = np.asarray(source, np.int64)
    if arr.shape != (NUM_CATEGORIES,):
        raise ValueError(f"counts of shape {arr.shape}, expected "
                         f"({NUM_CATEGORIES},)")
    return arr


def build_report(source: Union[TokenLedger, Dict[str, int], np.ndarray],
                 t_token_s: float,
                 t_prompt_token_s: Optional[float] = None,
                 actual_s: Optional[float] = None,
                 epoch: Optional[int] = None) -> AttributionReport:
    """Price a provenance tally.

    ``source`` is a live ledger, a ``counts_dict()``, or a raw bincount.
    ``t_token_s`` is the measured sequential decode cost per token;
    ``t_prompt_token_s`` the prefill cost per token (defaults to the decode
    cost — dense prefill amortizes far better, so this overstates shared-
    prompt savings unless measured; pass the real number when you have it).
    """
    c = _counts_array(source)
    if t_prompt_token_s is None:
        t_prompt_token_s = float(t_token_s)
    counts = {name: int(c[i]) for i, name in enumerate(CATEGORY_NAMES)}
    saved: Dict[str, float] = {}
    for mech, cats in MECHANISMS.items():
        s = 0.0
        for cat in cats:
            unit = t_prompt_token_s if cat in _PREFILL_PRICED else t_token_s
            s += float(c[cat]) * unit
        saved[mech] = s
    return AttributionReport(
        counts=counts, saved_s=saved, t_token_s=float(t_token_s),
        t_prompt_token_s=float(t_prompt_token_s),
        total_tokens=int(c.sum()),
        fresh_tokens=int(c[FRESH] + c[PROMPT]),
        bonus_tokens=int(c[DRAFT_BONUS]),
        actual_s=actual_s, epoch=epoch)


def measured_token_cost(reg_dict: Dict[str, float]) -> Optional[float]:
    """Decode s/token from a registry dump: the ``serve.token_ms``
    histogram mean (recorded per chunk by both the vanilla and drafted
    decode paths), falling back to the rollout decode-stage totals
    (decode seconds / generated tokens) for trainer runs that never touch
    the slot engine.  None when the run recorded neither."""
    mean_ms = reg_dict.get("serve.token_ms_mean")
    cnt = reg_dict.get("serve.token_ms_count", 0)
    if mean_ms is not None and cnt:
        return float(mean_ms) / 1e3
    dec_s = reg_dict.get("rollout.decode_s_sum", 0.0)
    gen = reg_dict.get("rollout.generated_tokens", 0.0)
    if dec_s and gen:
        return float(dec_s) / float(gen)
    return None
