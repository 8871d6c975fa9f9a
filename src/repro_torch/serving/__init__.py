"""Continuous-batching serving layer of the port (DESIGN.md §6).

- request:     request/response dataclasses (own copy of ``repro``'s)
- scheduler:   admission queue, slot free-list, occupancy metrics and §10
               backpressure (own copy)
- engine_loop: ``SlotEngine``, the persistent decode batch over dense caches
               with in-place slot replacement (``cache_slot_write``),
               speculative-prefix admission and the §10 hardening
               (deadlines, bounded retry, quarantine, exact kill-and-resume)
- block_table: §13 paged-KV host bookkeeping — refcounted BlockAllocator
               over a fixed pool of KV blocks (own copy)
- paged_engine: the SlotEngine over a paged block pool — dense admission
               re-paged at the slot write, copy-on-write GRPO prompt
               sharing (one prefill + one physical prompt copy per group),
               pool-pressure admission capping and load shedding
- faults:      deterministic fault injection (§10), seeded FaultPlans the
               engine consults at chunk boundaries (own copy)
- mesh_server: ``make_slot_engine``, the engine factory, and
               ``MeshSlotServer``, one slot scheduler per data shard of
               the §8 mesh
- rl_adapter:  ``rollout(..., spec.backfill='slots')``: a training batch
               drained through the slot engine (straggler backfill)
- rollout_service: the §12 async producer — drives the shared trainer
               Collector with its own copy of the weights and feeds the
               bounded trajectory buffer; WeightSync is its versioned,
               retrying (core/backoff) weight-publication channel
"""
from .block_table import BlockAllocator, PoolExhausted, identity_table
from .engine_loop import SlotEngine
from .faults import EngineKilled, FaultEvent, FaultPlan, seeded_plan
from .mesh_server import MeshSlotServer, make_slot_engine
from .paged_engine import PagedSlotEngine
from .request import Request, Response
from .rollout_service import RolloutService, SyncFailed, WeightSync
from .scheduler import SlotScheduler

__all__ = ["BlockAllocator", "EngineKilled", "FaultEvent", "FaultPlan",
           "MeshSlotServer", "PagedSlotEngine", "PoolExhausted", "Request",
           "Response",
           "RolloutService", "SlotEngine", "SlotScheduler", "SyncFailed",
           "WeightSync", "identity_table",
           "make_slot_engine", "seeded_plan"]
