"""Slot-engine factory (port of ``make_slot_engine`` in
``repro/serving/mesh_server.py``).

The one dispatch point shared by ``serving/rl_adapter.py`` and
``launch/serve.py``.  This slice builds the dense ``SlotEngine``; the
other two engines of the reference raise ``NotImplementedError`` and name
their ROADMAP item: a paged ``cfg`` needs the ``PagedSlotEngine`` (block
pool, copy-on-write GRPO prompt sharing; ROADMAP Queue 1 item 5, the
PagedSlotEngine) and a mesh needs the ``MeshSlotServer`` (ROADMAP Queue 1
item 11, the mesh).
"""
from __future__ import annotations

from repro_torch.engine.generate import GenerateConfig
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig

from .engine_loop import SlotEngine


def make_slot_engine(model: M.LM, cfg: ModelConfig, gen: GenerateConfig, *,
                     mesh=None, num_slots: int, prompt_width: int,
                     spec_prefix: bool = False, log_lenience: float = 0.0,
                     chunk_steps: int = 8, draft=None, faults=None,
                     deadline_steps=None, max_queue=None,
                     overflow: str = "reject", tracer=None, ledger=None
                     ) -> SlotEngine:
    """A ``SlotEngine`` over ``model``; the arguments of a feature a later
    slice ports raise in the engine's constructor."""
    if mesh is not None:
        raise NotImplementedError("the MeshSlotServer (one scheduler per "
                                  "data shard) arrives with the mesh, "
                                  "ROADMAP Queue 1 item 11")
    if cfg.cache_layout == "paged":
        raise NotImplementedError("slot serving over a paged cache is the "
                                  "PagedSlotEngine with serving/"
                                  "block_table.py, ROADMAP Queue 1 item 5")
    return SlotEngine(model, cfg, gen, num_slots=num_slots,
                      prompt_width=prompt_width, spec_prefix=spec_prefix,
                      log_lenience=log_lenience, chunk_steps=chunk_steps,
                      draft=draft, faults=faults,
                      deadline_steps=deadline_steps, max_queue=max_queue,
                      overflow=overflow, tracer=tracer, ledger=ledger)
