"""Lenience schedules (the port's own copy of ``repro/core/lenience.py``,
which imports no JAX; importing it would run ``repro/__init__.py``).

The paper uses a fixed ℓ (grid-searched per algorithm: e^0.5 GRPO, e^0.3 PPO,
e^0.15 DAPO) and names adaptive scheduling as future work.  Beyond-paper we
add two controllers:

- ``LinearWarmupLenience``: ℓ ramps from 1 (exact speculative decoding) to
  the target over the first W steps — early training has the largest policy
  gap (paper Fig. 4c), so starting strict avoids early off-policy drift.
- ``AdaptiveLenience``: integral controller steering the *observed KL
  divergence* (or clip fraction) to a budget by moving log ℓ; keeps the
  diagnostics of Fig. 5 inside the stable region automatically.
"""
from __future__ import annotations

import math
from dataclasses import dataclass


class FixedLenience:
    def __init__(self, lenience: float):
        self.lenience = lenience

    def __call__(self, step: int) -> float:
        return self.lenience

    def update(self, observed: float) -> None:  # no-op
        pass


class LinearWarmupLenience:
    def __init__(self, target: float, warmup_steps: int):
        self.target = target
        self.warmup = max(1, warmup_steps)

    def __call__(self, step: int) -> float:
        frac = min(1.0, step / self.warmup)
        return math.exp(frac * math.log(self.target))

    def update(self, observed: float) -> None:
        pass


class AdaptiveLenience:
    """Integral controller: log ℓ += gain * (budget - observed).

    ``observed`` is a per-step diagnostic (KL divergence to the rollout
    distribution, or clip fraction).  When the rollouts drift too far
    off-policy the lenience shrinks toward exactness; when fully on-policy it
    grows to harvest more reuse.
    """

    def __init__(self, init: float = 1.0, budget: float = 0.05,
                 gain: float = 2.0, lo: float = 1.0, hi: float = math.e ** 2):
        self.log_l = math.log(init)
        self.budget = budget
        self.gain = gain
        self.lo, self.hi = math.log(lo), math.log(hi)

    def __call__(self, step: int) -> float:
        return math.exp(self.log_l)

    def update(self, observed: float) -> None:
        self.log_l += self.gain * (self.budget - observed)
        self.log_l = min(max(self.log_l, self.lo), self.hi)


def make_schedule(kind: str, **kw):
    return {"fixed": FixedLenience, "warmup": LinearWarmupLenience,
            "adaptive": AdaptiveLenience}[kind](**kw)
