"""Deterministic fault injection for the slot server (DESIGN.md §10); own copy
of ``repro/serving/faults.py``, which imports no JAX.

Every recovery path in the serving layer is exercised by *injected*
failures, not hoped-for ones: a ``FaultPlan`` is a seeded, reproducible
schedule of fault events that the slot engine consults at chunk boundaries
(the only points where host state is consistent).  Replaying the same plan
against the same requests replays the same failures — which is what lets
tests assert exact recovery behaviour (rows untouched by faults stay
token-identical to a fault-free run) and lets ``benchmarks/fault_bench.py``
price recovery overhead against a clean run.

Event kinds (one dataclass, interpreted per kind):

* ``kill``       — raise ``EngineKilled`` at the chunk boundary, simulating
                   a process death mid-serve; recovery is checkpoint/io
                   ``save_server_state``/``load_server_state`` (exact
                   kill-and-resume, tests/serving/test_kill_resume.py).
* ``nan``        — corrupt the logits of the slot serving ``request_id`` on
                   the first step of the next decode chunk; the in-chunk
                   non-finite guard must quarantine the row.
* ``draft_exc``  — make the row's next draft proposal raise; the engine must
                   disable drafting for that row, never crash.
* ``stall``      — age the slot serving ``request_id`` by ``count`` phantom
                   engine steps, deterministically tripping its deadline
                   (the long-tail straggler failure mode).
* ``burst``      — submit ``count`` requests from the plan's
                   ``request_factory`` at once, overflowing the bounded
                   admission queue so the backpressure policy must act.

Events fire once, at the first chunk boundary at or after ``at_step``
(engine decode steps).  The plan is host-only state and deliberately NOT
part of the engine's ``state_dict`` — a restored engine resumes clean.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence

import numpy as np

KINDS = ("kill", "nan", "draft_exc", "stall", "burst")


class EngineKilled(RuntimeError):
    """Simulated process death at a chunk boundary (fault kind 'kill')."""


@dataclass
class FaultEvent:
    kind: str
    at_step: int = 0            # engine-step boundary at/after which it fires
    request_id: int = -1        # target request (nan / draft_exc / stall)
    count: int = 1              # stall: phantom steps; burst: #requests
    fired: bool = False

    def __post_init__(self):
        assert self.kind in KINDS, self.kind


@dataclass
class FaultPlan:
    """A reproducible schedule of fault events.

    ``request_factory(i)`` builds the i-th burst request (set by the test /
    bench harness that knows prompt shapes); unset plans simply never
    contain burst events.
    """
    events: List[FaultEvent] = field(default_factory=list)
    request_factory: Optional[Callable[[int], object]] = None
    _burst_serial: int = 0

    # -------------------------------------------------------------- queries

    def due(self, step: int, kind: str) -> List[FaultEvent]:
        """Unfired events of ``kind`` due at engine step ``step`` (marks
        them fired — each event is applied exactly once)."""
        out = []
        for e in self.events:
            if not e.fired and e.kind == kind and e.at_step <= step:
                e.fired = True
                out.append(e)
        return out

    def peek(self, kind: str) -> List[FaultEvent]:
        """All events of ``kind`` regardless of firing state (introspection
        for tests: which request_ids were ever targeted)."""
        return [e for e in self.events if e.kind == kind]

    def targeted_requests(self) -> set:
        """Request ids touched by any targeted fault — the complement is the
        set whose output must be token-identical to a fault-free run."""
        return {e.request_id for e in self.events
                if e.kind in ("nan", "draft_exc", "stall")
                and e.request_id >= 0}

    def exhausted(self) -> bool:
        return all(e.fired for e in self.events)

    def next_burst_requests(self, count: int) -> List[object]:
        assert self.request_factory is not None, \
            "burst events need a request_factory"
        out = [self.request_factory(self._burst_serial + i)
               for i in range(count)]
        self._burst_serial += count
        return out


def seeded_plan(seed: int, *, request_ids: Sequence[int], max_step: int,
                n_nan: int = 2, n_stall: int = 1, n_draft_exc: int = 0,
                n_burst: int = 0, burst_size: int = 4, kill_at: int = -1,
                stall_steps: int = 10 ** 6,
                request_factory: Optional[Callable[[int], object]] = None
                ) -> FaultPlan:
    """Build a reproducible mixed fault schedule from one integer seed.

    Draws targets / firing steps from ``np.random.default_rng(seed)`` so a
    (seed, request_ids, max_step) triple always yields the same plan — the
    chaos CI lane and fault bench pin their seeds.
    """
    rng = np.random.default_rng(seed)
    ids = list(request_ids)
    events: List[FaultEvent] = []

    def pick_ids(n):
        n = min(n, len(ids))
        return rng.choice(ids, size=n, replace=False) if n else []

    for rid in pick_ids(n_nan):
        events.append(FaultEvent("nan", at_step=int(rng.integers(0, max_step)),
                                 request_id=int(rid)))
    for rid in pick_ids(n_stall):
        events.append(FaultEvent("stall",
                                 at_step=int(rng.integers(0, max_step)),
                                 request_id=int(rid), count=stall_steps))
    for rid in pick_ids(n_draft_exc):
        events.append(FaultEvent("draft_exc",
                                 at_step=int(rng.integers(0, max_step)),
                                 request_id=int(rid)))
    for _ in range(n_burst):
        events.append(FaultEvent("burst",
                                 at_step=int(rng.integers(0, max_step)),
                                 count=burst_size))
    if kill_at >= 0:
        events.append(FaultEvent("kill", at_step=kill_at))
    events.sort(key=lambda e: (e.at_step, e.kind, e.request_id))
    return FaultPlan(events=events, request_factory=request_factory)
