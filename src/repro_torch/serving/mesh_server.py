"""Slot-engine factory (port of ``make_slot_engine`` in
``repro/serving/mesh_server.py``).

The one dispatch point shared by ``serving/rl_adapter.py`` and
``launch/serve.py``: a dense ``cfg`` builds the ``SlotEngine``, a paged
one (``cfg.cache_layout == 'paged'``) the ``PagedSlotEngine`` (block pool,
copy-on-write GRPO prompt sharing, DESIGN.md §13), whose pool
``kv_pool_blocks`` may shrink below the never-runs-dry default.  The §10
hardening arguments pass straight through.  A mesh needs the
``MeshSlotServer`` (one scheduler per data shard), which arrives with the
mesh, ROADMAP Queue 1 item 11.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.engine.generate import GenerateConfig
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig

from .engine_loop import SlotEngine


def make_slot_engine(model: M.LM, cfg: ModelConfig, gen: GenerateConfig, *,
                     mesh=None, num_slots: int, prompt_width: int,
                     spec_prefix: bool = False, log_lenience: float = 0.0,
                     chunk_steps: int = 8, draft=None, faults=None,
                     deadline_steps=None, max_queue=None,
                     overflow: str = "reject", retry_backoff=None,
                     tracer=None, ledger=None,
                     kv_pool_blocks: Optional[int] = None) -> SlotEngine:
    """A ``SlotEngine`` (or ``PagedSlotEngine``) over ``model``; the
    arguments of a feature a later slice ports raise in the engine's
    constructor."""
    if mesh is not None:
        raise NotImplementedError("the MeshSlotServer (one scheduler per "
                                  "data shard) arrives with the mesh, "
                                  "ROADMAP Queue 1 item 11")
    kw = dict(num_slots=num_slots, prompt_width=prompt_width,
              spec_prefix=spec_prefix, log_lenience=log_lenience,
              chunk_steps=chunk_steps, draft=draft, faults=faults,
              deadline_steps=deadline_steps, max_queue=max_queue,
              overflow=overflow, retry_backoff=retry_backoff, tracer=tracer,
              ledger=ledger)
    if cfg.cache_layout == "paged":
        from .paged_engine import PagedSlotEngine
        return PagedSlotEngine(model, cfg, gen, kv_pool_blocks=kv_pool_blocks,
                               **kw)
    return SlotEngine(model, cfg, gen, **kw)
