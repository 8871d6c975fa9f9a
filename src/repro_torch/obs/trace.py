"""Span tracer for the rollout observatory (DESIGN.md §11; own copy of
``repro/obs/trace.py``, which imports only the standard library).

A ``Tracer`` records *completed* spans (named intervals on a named track)
and typed instant events into bounded ring buffers.  Tracks become lanes
in the Chrome-trace export (obs/export.py): the serving engine emits one
lane per engine plus one per sampled request; the trainer, the SPEC-RL
rollout and the drafted loops emit stage lanes; the async trainer its
degradation and producer-restart events and the trainer watchdog its
restores.

Zero-overhead contract:

* tracing is **host-side only** — it never touches a tensor, so no kernel
  and no device sync is added with tracing on, off, or absent;
* timestamps are taken only at boundaries where the host is *already*
  synchronous — a disabled tracer adds **no host syncs** to any hot loop;
* every recording method early-returns on ``enabled=False`` before touching
  the clock.

The clock is injected (``clock=``) so tests drive a fake monotonic clock
and exports are deterministic.  ``sample_rate`` keeps per-request lanes
bounded under load: request r is traced iff ``sampled(r)``, a
deterministic hash — the same request samples identically on every shard.
"""
from __future__ import annotations

import time
from collections import deque
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional


@dataclass
class Span:
    """One completed (or still-open) named interval on a track."""
    name: str
    track: str
    cat: str
    t0: float
    t1: Optional[float] = None
    depth: int = 0
    args: Dict = field(default_factory=dict)

    @property
    def dur(self) -> float:
        return (self.t1 - self.t0) if self.t1 is not None else 0.0


@dataclass
class Event:
    """An instant event (a point, not an interval) on a track."""
    name: str
    track: str
    cat: str
    ts: float
    args: Dict = field(default_factory=dict)


# Knuth multiplicative hash — deterministic request sampling, identical on
# every shard/process (no PRNG state, no host randomness in the hot loop)
_HASH_MULT = 2654435761


class Tracer:
    """Bounded-ring span/event recorder with an injected monotonic clock."""

    def __init__(self, enabled: bool = True,
                 clock: Optional[Callable[[], float]] = None,
                 capacity: int = 65536, sample_rate: float = 1.0):
        assert capacity > 0, capacity
        self.enabled = bool(enabled)
        self.capacity = int(capacity)
        self.sample_rate = float(sample_rate)
        self._clock = clock if clock is not None else time.perf_counter
        self.spans: deque = deque(maxlen=self.capacity)
        self.events: deque = deque(maxlen=self.capacity)
        self.dropped_spans = 0          # ring evictions (bounded memory)
        self.dropped_events = 0
        self._open: Dict[int, Span] = {}
        self._depth: Dict[str, int] = {}
        self._next = 0

    # ------------------------------------------------------------- recording

    def now(self) -> float:
        return self._clock()

    def sampled(self, request_id: int) -> bool:
        """Deterministic per-request sampling decision (shard-invariant)."""
        if not self.enabled:
            return False
        if self.sample_rate >= 1.0:
            return True
        if self.sample_rate <= 0.0:
            return False
        h = (int(request_id) * _HASH_MULT) & 0xFFFFFFFF
        return h / 2.0 ** 32 < self.sample_rate

    def begin(self, name: str, track: str = "main", cat: str = "",
              **args) -> int:
        """Open a span; returns a handle for ``end``.  −1 when disabled."""
        if not self.enabled:
            return -1
        h = self._next
        self._next += 1
        d = self._depth.get(track, 0)
        self._depth[track] = d + 1
        self._open[h] = Span(name, track, cat, self._clock(), None, d,
                             dict(args))
        return h

    def end(self, handle: int, **args) -> None:
        if not self.enabled or handle < 0:
            return
        sp = self._open.pop(handle, None)
        if sp is None:
            return
        self._depth[sp.track] = max(0, self._depth.get(sp.track, 1) - 1)
        sp.t1 = self._clock()
        if args:
            sp.args.update(args)
        self._push_span(sp)

    @contextmanager
    def span(self, name: str, track: str = "main", cat: str = "", **args):
        """Lexically scoped span (the common case in tests and the trainer)."""
        if not self.enabled:
            yield
            return
        h = self.begin(name, track, cat, **args)
        try:
            yield
        finally:
            self.end(h)

    def complete(self, name: str, track: str, t0: float, t1: float,
                 cat: str = "", **args) -> None:
        """Record a span with explicit endpoints — the engine path.

        Instrumented code re-uses the ``perf_counter`` readings it already
        takes for its time accounting, so tracing never adds a clock call
        (let alone a sync) to a hot loop; retroactive spans (a request's
        whole lifecycle, emitted at finish) are only expressible this way.
        """
        if not self.enabled:
            return
        self._push_span(Span(name, track, cat, t0, t1,
                             self._depth.get(track, 0), dict(args)))

    def event(self, name: str, track: str = "main", cat: str = "",
              ts: Optional[float] = None, **args) -> None:
        if not self.enabled:
            return
        if len(self.events) == self.capacity:
            self.dropped_events += 1
        self.events.append(Event(name, track, cat,
                                 self._clock() if ts is None else ts,
                                 dict(args)))

    # ------------------------------------------------------------ inspection

    def _push_span(self, sp: Span) -> None:
        if len(self.spans) == self.capacity:
            self.dropped_spans += 1
        self.spans.append(sp)

    def tracks(self):
        seen = []
        for sp in self.spans:
            if sp.track not in seen:
                seen.append(sp.track)
        for ev in self.events:
            if ev.track not in seen:
                seen.append(ev.track)
        return seen

    def clear(self) -> None:
        self.spans.clear()
        self.events.clear()
        self._open.clear()
        self._depth.clear()
        self.dropped_spans = self.dropped_events = 0


#: Shared disabled tracer — the default everywhere instrumentation is
#: threaded.  All recording methods early-return; ``sampled`` is False.
NULL_TRACER = Tracer(enabled=False, capacity=1)
