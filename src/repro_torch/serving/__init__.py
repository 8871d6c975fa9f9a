"""Continuous-batching serving layer of the port (DESIGN.md §6).

- request:     request/response dataclasses (own copy of ``repro``'s)
- scheduler:   admission queue, slot free-list, occupancy metrics (own copy)
- engine_loop: ``SlotEngine``, the persistent decode batch over dense caches
               with in-place slot replacement (``cache_slot_write``) and
               speculative-prefix admission
- mesh_server: ``make_slot_engine``, the engine factory
- rl_adapter:  ``rollout(..., spec.backfill='slots')``: a training batch
               drained through the slot engine (straggler backfill)
"""
from .engine_loop import SlotEngine
from .mesh_server import make_slot_engine
from .request import Request, Response
from .scheduler import SlotScheduler

__all__ = ["Request", "Response", "SlotEngine", "SlotScheduler",
           "make_slot_engine"]
