"""Mesh-parallel slot serving: one scheduler per data shard (port of
``repro/serving/mesh_server.py``, DESIGN.md §8).

The slot engine's admission scatter indexes the persistent batch's rows,
so sharding one engine's batch over the data axis would turn every
admission into a cross-shard write.  The data axis is handled one level up
instead: ``MeshSlotServer`` splits the (data, model) mesh into one
model-only submesh per data shard (``distributed/mesh.py:data_submeshes``)
and runs a whole ``SlotEngine`` (scheduler, free list, persistent caches)
on each.  In the port a shard's engine lives in the processes of its model
group: every rank of the mesh sees every request and the same routing
(a GRPO group by ``group_id % D``, the rest round-robin), and keeps only
what its shard owns, so admission is shard-local and a shard's
parameters and caches spread over its model group alone.

Because every request owns its key streams (``serving/request.py``), a
request's output does not depend on its shard: the server is token for
token a single engine over the same requests.

What a caller reads is whole on every rank, as JAX's gathered view is:
``responses`` is gathered over the data group; ``metrics_registry()`` is
``MetricsRegistry.merged`` over the shard registries (counters sum, peak
gauges max, histograms merge bucket-wise, ratios re-derive from the summed
parts) and ``stats()`` adds ``per_shard``; ``state_dict`` is JAX's layout,
``{"engines": {"0": ..., "1": ...}, "rr": ...}``, with every shard's
snapshot, so a kill and a resume are exact (a snapshot's caches hold the
KV heads of the model rank that took it, and each rank resumes from its
own).  Each of these is a collective: every rank of the mesh calls it.
A live endpoint cannot run one (a scrape reaches one rank, and the shards
keep no common clock), so ``MetricsBoard`` has each shard publish its
registry after its chunks into a directory the ranks share, and merges
the latest of every shard on the rank that serves it.

``make_slot_engine`` is the one dispatch point shared by
``serving/rl_adapter.py`` and ``launch/serve.py``: a mesh with a data axis
builds the ``MeshSlotServer``, anything else one ``SlotEngine`` (or, for a
paged ``cfg``, a ``PagedSlotEngine``: block pool, copy-on-write GRPO
prompt sharing, DESIGN.md §13, whose pool ``kv_pool_blocks`` may shrink
below the never-runs-dry default; each shard owns its pool).  The §10
hardening arguments pass straight through, applied per shard.
"""
from __future__ import annotations

import os
import pickle
import time
from typing import Dict, Iterable, Optional, Tuple

import numpy as np

from repro_torch.distributed.comm import all_gather_objects
from repro_torch.distributed.mesh import (check_mesh_family, data_group,
                                          data_rank, data_size,
                                          data_submeshes, model_rank,
                                          shard_params)
from repro_torch.engine.generate import GenerateConfig
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.obs import MetricsRegistry

from .engine_loop import SlotEngine
from .faults import EngineKilled
from .request import Request, Response


def make_slot_engine(model: M.LM, cfg: ModelConfig, gen: GenerateConfig, *,
                     mesh=None, num_slots: int, prompt_width: int,
                     spec_prefix: bool = False, log_lenience: float = 0.0,
                     chunk_steps: int = 8, draft=None, faults=None,
                     deadline_steps=None, max_queue=None,
                     overflow: str = "reject", retry_backoff=None,
                     tracer=None, ledger=None,
                     kv_pool_blocks: Optional[int] = None):
    """A ``MeshSlotServer`` on a mesh with a data axis (``num_slots``
    rounded down to a multiple of the shard count, at least one a shard),
    else a ``SlotEngine`` or ``PagedSlotEngine`` over ``model`` (cut over
    a model-only ``mesh`` inside the engine)."""
    kw = dict(num_slots=num_slots, prompt_width=prompt_width,
              spec_prefix=spec_prefix, log_lenience=log_lenience,
              chunk_steps=chunk_steps, draft=draft, faults=faults,
              deadline_steps=deadline_steps, max_queue=max_queue,
              overflow=overflow, retry_backoff=retry_backoff, tracer=tracer,
              ledger=ledger)
    if mesh is not None:
        check_mesh_family(cfg, mesh)
    if cfg.cache_layout == "paged":
        kw["kv_pool_blocks"] = kv_pool_blocks
    if mesh is not None and data_size(mesh) > 1:
        D = data_size(mesh)
        kw["num_slots"] = max(D, num_slots - num_slots % D)
        return MeshSlotServer(model, cfg, gen, mesh=mesh, **kw)
    if cfg.cache_layout == "paged":
        from .paged_engine import PagedSlotEngine
        return PagedSlotEngine(model, cfg, gen, mesh=mesh, **kw)
    return SlotEngine(model, cfg, gen, mesh=mesh, **kw)


class MeshSlotServer:
    """Per-data-shard slot engines behind one submit / run / stats
    frontend.  ``num_slots`` is the total, split evenly over the shards
    (it must divide); this rank builds its shard's engine over its model
    group, with its shard's slice of the parameters."""

    def __init__(self, model: M.LM, cfg: ModelConfig, gen: GenerateConfig,
                 *, mesh, num_slots: int, prompt_width: int,
                 faults=None, kv_pool_blocks: Optional[int] = None, **kw):
        subs = data_submeshes(mesh)
        D = len(subs)
        if num_slots % D != 0 or num_slots < D:
            raise ValueError(f"num_slots={num_slots} must split evenly over "
                             f"{D} data shards")
        self.shard = data_rank(mesh)
        self.group = data_group(mesh)
        self._D = D
        # a single FaultPlan lands on shard 0; a sequence maps per shard
        plans = list(faults) if isinstance(faults, (list, tuple)) else \
            [faults] + [None] * (D - 1)
        if len(plans) != D:
            raise ValueError(f"{len(plans)} fault plans for {D} shards")
        sub = subs[self.shard].mesh
        if cfg.cache_layout == "paged":
            from .paged_engine import PagedSlotEngine
            kw["kv_pool_blocks"] = kv_pool_blocks
            make = PagedSlotEngine
        else:
            make = SlotEngine
        self.engine = make(shard_params(sub, cfg, model), cfg, gen,
                           mesh=sub, num_slots=num_slots // D,
                           prompt_width=prompt_width,
                           faults=plans[self.shard], **kw)
        self._rr = 0                       # round-robin submission cursor

    @property
    def num_shards(self) -> int:
        return self._D

    def _route(self, req: Request, j: int) -> int:
        """A GRPO group lands whole on shard ``group_id % D`` (the paged
        engine's prompt sharing is shard-local); the rest round-robin."""
        if req.group_id is not None:
            return req.group_id % self._D
        return j % self._D

    @property
    def responses(self) -> Dict[int, Response]:
        """Every shard's responses (a collective over the data group)."""
        out: Dict[int, Response] = {}
        for part in all_gather_objects(self.engine.responses, self.group):
            out.update(part)
        return out

    # ------------------------------------------------------------- frontend

    def submit(self, req: Request) -> None:
        """Shard-local admission: the request joins its shard's queue (on
        the ranks of that shard; the others only advance the cursor).  A
        request no shard could take raises on every rank."""
        e = self.engine
        if len(req.prompt) > e.P or not 0 <= req.max_new_tokens <= e.N:
            raise ValueError(f"request {req.request_id}: prompt of "
                             f"{len(req.prompt)} (width {e.P}) or budget "
                             f"{req.max_new_tokens} (max {e.N}) too large")
        if req.group_id is not None:
            i = self._route(req, 0)
        else:
            i = self._rr
            self._rr = (self._rr + 1) % self._D
        if i == self.shard:
            self.engine.submit(req)

    def run(self, arrivals: Optional[Iterable[Tuple[int, Request]]] = None,
            max_chunks: Optional[int] = None) -> Dict[int, Response]:
        """Run this rank's shard engine (``SlotEngine.run``) on the
        arrivals its shard owns, routed like ``submit``, each due against
        its shard's own step counter.  Returns every shard's responses.
        A shard whose engine is killed (``EngineKilled``) joins the
        gather of the responses all the same, then raises, so the shards'
        collectives stay in step."""
        mine = None
        if arrivals is not None:
            mine = [(due, req) for j, (due, req) in enumerate(arrivals)
                    if self._route(req, j) == self.shard]
        killed = None
        try:
            self.engine.run(arrivals=mine, max_chunks=max_chunks)
        except EngineKilled as e:
            killed = e
        out = self.responses
        if killed is not None:
            raise killed
        return out

    # -------------------------------------------------------------- metrics

    def metrics_registry(self) -> MetricsRegistry:
        """Type-driven merge of the shard registries (§11)."""
        return MetricsRegistry.merged(all_gather_objects(
            self.engine.metrics_registry(), self.group))

    def stats(self) -> Dict[str, float]:
        """The gathered view over the shard engines plus per-shard dumps."""
        out = self.metrics_registry().as_dict()
        out["per_shard"] = all_gather_objects(self.engine.stats(), self.group)
        return out

    # ----------------------------------------------- exact kill-and-resume

    def state_dict(self) -> Dict:
        """Every shard's engine snapshot and the round-robin cursor: the
        whole server's future (``checkpoint/io.save_server_state``)."""
        parts = all_gather_objects(self.engine.state_dict(), self.group)
        return {"engines": {str(i): st for i, st in enumerate(parts)},
                "rr": np.int64(self._rr)}

    def load_state_dict(self, state: Dict) -> None:
        if len(state["engines"]) != self._D:
            raise ValueError(f"a snapshot of {len(state['engines'])} shards "
                             f"for {self._D}")
        self.engine.load_state_dict(state["engines"][str(self.shard)])
        self._rr = int(state["rr"])


class MetricsBoard:
    """A ``MeshSlotServer``'s merged registry while it runs, for a live
    endpoint (``launch/serve.py --metrics``).  After its chunks (at most
    once every ``PERIOD`` seconds, and at ``publish(force=True)``) each
    data shard's first model rank writes its shard's registry into
    ``directory``, which the ranks share (a file a shard, replaced
    atomically); ``registry()`` merges the latest of every shard there as
    ``metrics_registry()`` merges them (``MetricsRegistry.merged``),
    without a collective.  A scrape sees each shard as of its last
    publication."""

    PERIOD = 1.0        # a scrape's staleness against a chunk's pickle

    def __init__(self, server: MeshSlotServer, mesh, directory: str):
        self.server, self.dir = server, directory
        self.writer = model_rank(mesh) == 0
        self._last = float("-inf")
        server.engine.on_chunk = self.publish

    def _path(self, shard: int) -> str:
        return os.path.join(self.dir, f"shard{shard}.pkl")

    def publish(self, force: bool = False) -> None:
        now = time.monotonic()
        if not self.writer or (not force and now - self._last < self.PERIOD):
            return
        self._last = now
        path = self._path(self.server.shard)
        with open(path + ".tmp", "wb") as f:
            pickle.dump(self.server.engine.metrics_registry(), f)
        os.replace(path + ".tmp", path)

    def registry(self) -> MetricsRegistry:
        regs = []
        for shard in range(self.server.num_shards):
            try:
                with open(self._path(shard), "rb") as f:
                    regs.append(pickle.load(f))
            except FileNotFoundError:          # not yet published
                continue
        return MetricsRegistry.merged(regs)
