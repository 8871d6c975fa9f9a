"""Slot scheduler: admission queue, slot free-list, occupancy metrics.

Pure host-side bookkeeping — no jax.  The scheduler owns WHICH request runs
WHERE and WHEN; the engine loop (engine_loop.py) owns the device work.  The
decode batch has a fixed number of rows, and admission replaces a finished
row in place — over dense ``(B, S)`` cache slabs (DESIGN.md §3/§6) or, with
``cache_layout='paged'``, over block-table rows whose physical blocks a
``BlockAllocator`` manages one level down (§13, serving/paged_engine.py).

Admission is FIFO over the queue; the free-list is LIFO (a freed slot is the
warmest candidate).  Per-slot budgets live in the engine's state vectors;
the scheduler tracks the request lifecycle and aggregates metrics:
queue-wait, slot occupancy (busy slot-steps / total slot-steps), admissions,
completions.

Hardening (DESIGN.md §10): the queue is optionally *bounded*
(``max_queue``) with an explicit backpressure policy — ``reject`` refuses
the new submission, ``shed-oldest`` drops the head of the queue to make
room — and requests can leave a slot without finishing (``reclaim``: a
deadline expiry or quarantine frees the slot; a bounded number of retries
re-enter through the queue).  Every such event is a counter in ``stats()``.
The whole scheduler state round-trips through ``state_dict`` /
``load_state_dict`` for exact kill-and-resume.
"""
from __future__ import annotations

from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

from .request import DECODING, DONE, PREFILLING, QUEUED, Request

OVERFLOW_POLICIES = ("reject", "shed-oldest")


class SlotScheduler:
    def __init__(self, num_slots: int, max_queue: Optional[int] = None,
                 overflow: str = "reject"):
        assert num_slots > 0, num_slots
        assert max_queue is None or max_queue > 0, max_queue
        assert overflow in OVERFLOW_POLICIES, overflow
        self.num_slots = num_slots
        self.max_queue = max_queue
        self.overflow = overflow
        self.free: List[int] = list(range(num_slots - 1, -1, -1))
        self.queue: Deque[Request] = deque()
        self.active: Dict[int, Request] = {}          # slot -> request
        # metrics
        self.submitted = 0
        self.admitted = 0
        self.completed = 0
        self.busy_slot_steps = 0
        self.total_slot_steps = 0
        self.queue_wait_total = 0.0
        self.serve_time_total = 0.0
        # §10 recovery counters
        self.timeouts = 0
        self.quarantines = 0
        self.retries = 0
        self.sheds = 0
        self.rejected = 0

    # ------------------------------------------------------------ lifecycle

    def submit(self, req: Request, now: float = 0.0) -> Optional[Request]:
        """Queue a request; returns the request SHED by backpressure, if any.

        With an unbounded queue (or room left) the return is None.  At
        capacity, policy ``reject`` refuses and returns ``req`` itself;
        ``shed-oldest`` drops the queue head to admit the newcomer and
        returns the dropped request.  Either way the caller owns emitting
        the shed response — the scheduler only counts it.
        """
        shed: Optional[Request] = None
        if self.max_queue is not None and len(self.queue) >= self.max_queue:
            if self.overflow == "reject":
                self.rejected += 1
                self.sheds += 1
                self.submitted += 1
                return req
            shed = self.queue.popleft()                # shed-oldest
            self.sheds += 1
        req.state = QUEUED
        req.queued_at = now
        if req.base_draft_len < 0:
            # remember where the CALLER's draft ends before any retry grows
            # it with the request's own partial output (§10 retry semantics)
            req.base_draft_len = len(req.draft_tokens) \
                if req.draft_tokens is not None else 0
        self.queue.append(req)
        self.submitted += 1
        return shed

    def resubmit(self, req: Request, now: float = 0.0) -> None:
        """Re-queue a reclaimed request (bounded retry).  Bypasses the
        backpressure bound — a retry holds no NEW work, shedding it would
        turn one fault into a dropped request."""
        req.state = QUEUED
        req.queued_at = now
        req.retries += 1
        self.retries += 1
        self.queue.append(req)

    @property
    def pending(self) -> int:
        return len(self.queue)

    @property
    def num_active(self) -> int:
        return len(self.active)

    @property
    def idle(self) -> bool:
        return not self.queue and not self.active

    def reserve(self, now: float = 0.0,
                limit: Optional[int] = None) -> List[Tuple[int, Request]]:
        """Pair queued requests (FIFO) with free slots; mark PREFILLING.

        ``limit`` caps how many pairs this call makes (None = all it can):
        the paged engine admits at most as many rows as its block pool can
        table, leaving the rest QUEUED — in order — until decode completions
        free blocks (DESIGN.md §13 admission pressure).
        """
        group: List[Tuple[int, Request]] = []
        while self.free and self.queue and \
                (limit is None or len(group) < limit):
            slot = self.free.pop()
            req = self.queue.popleft()
            req.state = PREFILLING
            req.admitted_at = now
            self.queue_wait_total += max(0.0, now - req.queued_at)
            self.active[slot] = req
            self.admitted += 1
            group.append((slot, req))
        return group

    def activate(self, slot: int) -> None:
        self.active[slot].state = DECODING

    def complete(self, slot: int, now: float = 0.0) -> Request:
        """Finish the request in ``slot`` and return the slot to the pool."""
        req = self.active.pop(slot)
        req.state = DONE
        req.finished_at = now
        self.serve_time_total += max(0.0, now - req.admitted_at)
        self.free.append(slot)
        self.completed += 1
        return req

    def reclaim(self, slot: int, now: float = 0.0,
                reason: str = "timeout") -> Request:
        """Pull a request OUT of its slot without finishing it (§10).

        The slot returns to the free pool immediately so admission can
        back-fill it; the caller decides whether the request retries
        (``resubmit``) or fails out.  Counted separately from completions.
        """
        req = self.active.pop(slot)
        self.free.append(slot)
        if reason == "quarantine":
            self.quarantines += 1
        elif reason == "shed":
            # §13: a row pulled because the paged block pool ran dry is a
            # load-shedding event, not a straggler timeout
            self.sheds += 1
        else:
            self.timeouts += 1
        return req

    # -------------------------------------------------------------- metrics

    def tick(self, busy_slots: int, steps: int = 1) -> None:
        """Account ``steps`` decode steps with ``busy_slots`` rows working."""
        self.busy_slot_steps += busy_slots * steps
        self.total_slot_steps += self.num_slots * steps

    def stats(self) -> Dict[str, float]:
        return {
            "num_slots": self.num_slots,
            "submitted": self.submitted,
            "admitted": self.admitted,
            "completed": self.completed,
            "pending": len(self.queue),
            "occupancy": (self.busy_slot_steps / self.total_slot_steps
                          if self.total_slot_steps else 0.0),
            "mean_queue_wait": (self.queue_wait_total / self.completed
                                if self.completed else 0.0),
            "mean_serve_time": (self.serve_time_total / self.completed
                                if self.completed else 0.0),
            "timeouts": self.timeouts,
            "quarantined_requests": self.quarantines,
            "retried_requests": self.retries,
            "shed_requests": self.sheds,
            "rejected_requests": self.rejected,
            "max_queue": self.max_queue or 0,
        }

    # ----------------------------------------------------- exact state (§10)

    _COUNTERS = ("submitted", "admitted", "completed", "busy_slot_steps",
                 "total_slot_steps", "queue_wait_total", "serve_time_total",
                 "timeouts", "quarantines", "retries", "sheds", "rejected")

    def state_dict(self) -> Dict:
        import numpy as np
        return {
            "free": np.asarray(self.free, np.int64),
            "queue": {str(i): r.to_state()
                      for i, r in enumerate(self.queue)},
            "active": {str(slot): r.to_state()
                       for slot, r in self.active.items()},
            "counters": {k: np.float64(getattr(self, k))
                         for k in self._COUNTERS},
        }

    def load_state_dict(self, state: Dict) -> None:
        import numpy as np
        self.free = [int(s) for s in np.asarray(state["free"])]
        q = state["queue"]
        self.queue = deque(Request.from_state(q[str(i)])
                           for i in range(len(q)))
        self.active = {int(slot): Request.from_state(st)
                       for slot, st in state["active"].items()}
        for k in self._COUNTERS:
            cast = float if k.endswith("_total") else int
            setattr(self, k, cast(state["counters"][k]))
