"""Exponential backoff with deterministic jitter (DESIGN.md §12; own copy
of ``repro/core/backoff.py``, which imports no JAX).

One retry policy for every layer that talks across a failure domain: in
the port, the slot engine's reclaim→resubmit path
(serving/engine_loop.py, ``retry_backoff=``) and the async trainer's
weight publication (serving/rollout_service.py, ``WeightSync``).  The
schedule is a pure function of (config, attempt) — no wall clock, no
global RNG — so tests and the deterministic async scheduler can replay it
exactly, and the same config can express delays in seconds (weight sync)
or in engine steps (slot retries).

``retry`` takes an injectable ``sleep`` so production code sleeps for
real while tests pass a recorder and pay nothing.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple, Type


class RetriesExhausted(RuntimeError):
    """Raised by ``retry`` when every attempt failed; ``__cause__`` is the
    last underlying exception."""


def _unit(seed: int, i: int) -> float:
    """Deterministic uniform in [0, 1) from (seed, attempt) — integer hash
    mix (no process-global RNG, no PYTHONHASHSEED sensitivity)."""
    x = (seed * 1000003 + i * 2654435761 + 0x9E3779B9) & 0xFFFFFFFF
    x ^= x >> 16
    x = (x * 0x45D9F3B) & 0xFFFFFFFF
    x ^= x >> 16
    x = (x * 0x45D9F3B) & 0xFFFFFFFF
    x ^= x >> 16
    return x / 2.0 ** 32


@dataclass(frozen=True)
class BackoffConfig:
    """Exponential schedule: attempt ``i`` waits
    ``min(max_delay, base * factor**i)``, optionally jittered by a
    deterministic ±``jitter`` fraction keyed on (seed, i)."""
    base: float = 0.05
    factor: float = 2.0
    max_delay: float = 2.0
    max_attempts: int = 5
    jitter: float = 0.0          # 0 = none; 0.1 = ±10%, deterministic
    seed: int = 0

    def delay(self, attempt: int) -> float:
        d = min(self.max_delay, self.base * self.factor ** max(0, attempt))
        if self.jitter > 0.0:
            d *= 1.0 + self.jitter * (2.0 * _unit(self.seed, attempt) - 1.0)
        return max(0.0, d)

    def schedule(self) -> List[float]:
        """The full inter-attempt delay sequence (len = max_attempts - 1)."""
        return [self.delay(i) for i in range(max(0, self.max_attempts - 1))]


def retry(fn: Callable[[], object], cfg: BackoffConfig, *,
          sleep: Optional[Callable[[float], None]] = None,
          retry_on: Tuple[Type[BaseException], ...] = (Exception,),
          on_retry: Optional[Callable[[int, BaseException, float], None]] = None,
          describe: str = "operation"):
    """Run ``fn`` up to ``cfg.max_attempts`` times with the backoff
    schedule between attempts.

    ``sleep`` is injectable (defaults to ``time.sleep``); ``on_retry``
    fires before each sleep with (attempt_index, exception, delay) — the
    hook the callers use to count retries in the obs registry.  Raises
    ``RetriesExhausted`` (chained to the last failure) when the budget
    runs out.
    """
    do_sleep = time.sleep if sleep is None else sleep
    last: Optional[BaseException] = None
    for attempt in range(max(1, cfg.max_attempts)):
        try:
            return fn()
        except retry_on as e:                       # noqa: PERF203
            last = e
            if attempt + 1 >= max(1, cfg.max_attempts):
                break
            d = cfg.delay(attempt)
            if on_retry is not None:
                on_retry(attempt, e, d)
            do_sleep(d)
    raise RetriesExhausted(
        f"{describe}: {max(1, cfg.max_attempts)} attempts failed") from last
