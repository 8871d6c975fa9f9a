"""The runtime mesh of the port (port of ``repro/distributed/mesh.py``):
JAX's one-process GSPMD mesh becomes one process a rank over
``torch.distributed``.

* ``MeshConfig(data, model, require).build()`` returns a ``DeviceMesh``
  with dims ``("data", "model")`` over the initialised process group, or
  ``None`` where JAX's returns ``None``: a trivial (1, 1) mesh, or a world
  smaller than ``data * model`` without ``require`` (with it, it raises).
  Every helper takes ``mesh=None`` as the single-device path.
* **Data axis.** A data rank holds its own rows of a batch
  (``shard_batch``, ``DataRows``): the entry points that take ``mesh=``
  (``engine/generate.py``, ``core/verify.py``, ``drafting/engine.py``)
  take the whole batch, as JAX's global arrays are whole, run their rows
  with caches of their rows alone, and gather the outputs over the data
  group, so what they return is whole on every rank.  A batch the data
  axes do not divide runs whole on every data rank (JAX replicates it).
* **Model axis.** Megatron-style tensor parallelism over the model group,
  laid out by JAX's ``param_spec`` rules (``distributed/sharding.py``):
  ``shard_params`` keeps this rank's slice of every parameter and marks
  the modules whose forward needs a collective (``distributed/comm.py``):
  a row-parallel ``Dense`` (``wo``, ``w_down``) all-reduces its output, a
  vocabulary-sharded ``embed`` looks up its rows and all-reduces (exact:
  one rank holds each row), the logits are gathered along the vocabulary,
  and a GQA whose KV heads the axis does not divide gathers its queries
  (``distributed/shard_wrap.py``).  A MoE's experts are cut by their 3-D
  specs (expert-parallel, or tensor-parallel on ``d_ff``) and its output
  is summed over the model group (``models/moe.py``).  A rank's caches
  hold its KV heads (``models/model.py:cache_config``), and every kernel
  runs on local shards.  Every rank of a model group computes the same logits bit for
  bit, so it samples the same tokens and makes the same host decisions.

* **Training.**  The collectives carry the gradient
  (``distributed/comm.py``), so a rank's backward gives the full gradient
  of each of its parameter shards except two sums, which
  ``finish_grads`` adds: a replicated parameter used inside a
  model-parallel region (qk-norm scales, KV projections the axis does not
  divide: ``region_params``, derived from the partition rules and the
  module that uses each parameter) holds only its rank's heads' share and
  is summed over the model group; then every gradient is summed over the
  data group (averaged when the batch is replicated there, as every data
  rank then computed the whole loss).  The AdamW moments take the
  parameters' layout and ``step`` is replicated (JAX's
  ``shard_opt_state``; ``zero_shard_spec`` is the dry run's, not the
  trainer's).  A snapshot gathers a cut model's parameters (and its
  moments) whole to the writing rank's host (``gather_params``), and a
  restore cuts each tensor onto its rank as it is read (``cut_on_read``).
  ``LossRows`` holds the rule of a loss on the mesh (a rank's rows, the
  whole batch's counts, ``finish_grads`` and the data-group sum of the
  loss and diagnostics), for the trainer and ``launch/steps.py``.

GQA attention with dense FFN and MoE layers runs on the mesh (the dense
GQA family and mixtral-8x22b); the other families (Mamba, MLA and MTP,
RWKV6, the modality frontends) arrive there with part 3 of ROADMAP Queue 1
item 11 (the mesh), and ``check_mesh_family`` refuses them until then.

Ranks start one process each: ``torchrun`` (``launch/serve.py``,
``launch/train.py``), or
``run_ranks`` below (tests and ``chip_smoke.py``).  The backend is NCCL
when every rank of a host has a card of its own, else ``gloo`` (ranks
that share one card, or the CPU); ``pick_backend`` logs its choice.
"""
from __future__ import annotations

import copy
import logging
import os
import pickle
import tempfile
import time
import traceback
from dataclasses import dataclass
from datetime import timedelta
from typing import Any, Callable, Dict, List, Mapping, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.config import ATTN, ModelConfig

from .comm import (all_gather_cat, all_gather_objects, all_reduce_,
                   broadcast_, gather_cat_to_host, group_rank, group_ranks,
                   group_size)
from .sharding import axis_sizes, batch_spec, data_shards, params_pspecs

log = logging.getLogger("repro_torch.distributed")

AXES = ("data", "model")


@dataclass(frozen=True)
class MeshConfig:
    """Axis sizes of the runtime (data, model) mesh.  ``build`` lays it
    over the ranks of the initialised process group, which must number
    ``data * model`` (one process a rank: ``torchrun --nproc-per-node
    data*model``, or ``run_ranks``)."""
    data: int = 1
    model: int = 1
    require: bool = False

    @property
    def size(self) -> int:
        return self.data * self.model

    def build(self, device: DeviceLike = None):
        if self.size <= 1:
            return None
        world = dist.get_world_size() if dist.is_initialized() else 1
        if world < self.size:
            if self.require:
                raise RuntimeError(
                    f"MeshConfig({self.data}x{self.model}) needs {self.size} "
                    f"ranks, found {world} (start one process a rank: "
                    f"torchrun --nproc-per-node {self.size})")
            return None
        if world != self.size:
            raise ValueError(f"MeshConfig({self.data}x{self.model}) covers "
                             f"{self.size} ranks of a world of {world}")
        from torch.distributed.device_mesh import init_device_mesh
        return init_device_mesh(resolve_device(device).type,
                                (self.data, self.model), mesh_dim_names=AXES)


# ------------------------------------------------------------------ axis info


def _sizes(mesh) -> dict:
    return {} if mesh is None else axis_sizes(mesh)


def data_size(mesh) -> int:
    return 1 if mesh is None else data_shards(mesh)


def model_size(mesh) -> int:
    return _sizes(mesh).get("model", 1)


def data_rank(mesh) -> int:
    """This process's index along the data axis (0 without one)."""
    if data_size(mesh) <= 1:
        return 0
    return mesh.get_local_rank("data")


def model_rank(mesh) -> int:
    if model_size(mesh) <= 1:
        return 0
    return mesh.get_local_rank("model")


def data_group(mesh):
    return mesh.get_group("data")


def model_group(mesh):
    return mesh.get_group("model")


@dataclass(frozen=True)
class Submesh:
    """One data shard's model group: its global ranks, and its one-axis
    ``("model",)`` DeviceMesh where this process is one of them (``None``
    elsewhere: a process holds only its own group)."""
    ranks: Tuple[int, ...]
    mesh: Any
    axis_names: Tuple[str, ...] = ("model",)


def data_submeshes(mesh) -> List[Submesh]:
    """One model-only submesh per data shard (disjoint ranks): what each
    shard's slot scheduler runs on (``serving/mesh_server.py``).  A mesh
    without a data axis is its own (single) submesh."""
    grid = mesh.mesh
    if data_size(mesh) <= 1:
        return [Submesh(tuple(grid.reshape(-1).tolist()), mesh,
                        tuple(mesh.mesh_dim_names))]
    mine = data_rank(mesh)
    rows = grid.reshape(data_size(mesh), -1)
    return [Submesh(tuple(rows[i].tolist()),
                    mesh["model"] if i == mine else None)
            for i in range(rows.shape[0])]


def batch_pspec(mesh, ndim: int, batch: int):
    """Leading-dimension partition over the data axes; a batch they do not
    divide is replicated (JAX's ``batch_pspec``)."""
    if data_size(mesh) <= 1:
        return (None,) * ndim
    return batch_spec(mesh, ndim, batch)


def batch_shardable(mesh, batch: int) -> bool:
    """Whether each data rank holds its own rows of a batch of ``batch``
    rows (``DataRows``): the mesh has a data axis and it divides."""
    return mesh is not None and batch_pspec(mesh, 1, batch)[0] is not None


# ------------------------------------------------------------------ placement


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def replicate(mesh, tree):
    """Every tensor of ``tree`` made equal to the mesh's first rank's, in
    place (a broadcast over the model group, then over the data group)."""
    if mesh is None:
        return tree

    def one(t):
        if isinstance(t, torch.Tensor):
            if model_size(mesh) > 1:
                broadcast_(t, model_group(mesh))
            if data_size(mesh) > 1:
                broadcast_(t, data_group(mesh))
        return t
    return _map(one, tree)


def host_fetch(tree):
    """Every tensor of ``tree`` as a host numpy array (bfloat16 widened to
    float32, exactly)."""
    def one(t):
        if isinstance(t, torch.Tensor):
            t = t.detach()
            if t.dtype == torch.bfloat16:
                t = t.float()
            return t.cpu().numpy()
        return t
    return _map(one, tree)


class _RowsOfKey:
    """A scalar key seen from a data shard: it draws the whole batch's
    noise, as the unsharded key does, and hands back its own rows, so a
    row's tokens do not depend on the layout (JAX's
    ``test_generate_identity_scalar_key``)."""

    def __init__(self, key, lo: int, hi: int, batch: int):
        self.key, self.lo, self.hi, self.batch = key, lo, hi, batch

    def split(self, num: int = 2):
        return tuple(_RowsOfKey(k, self.lo, self.hi, self.batch)
                     for k in self.key.split(num))

    def _rows(self, draw, shape):
        shape = tuple(shape)
        if shape[0] != self.hi - self.lo:
            raise ValueError(f"a shard of rows [{self.lo}, {self.hi}) draws "
                             f"{shape}")
        return draw((self.batch,) + shape[1:])[self.lo:self.hi]

    def uniform(self, shape):
        return self._rows(self.key.uniform, shape)

    def gumbel(self, shape):
        return self._rows(self.key.gumbel, shape)


class DataRows:
    """This process's rows of a batch of ``batch`` rows on ``mesh``:
    [lo, hi) when the data axes divide the batch (``batch_pspec``), else
    the whole batch (every data rank runs every row).  ``take`` cuts an
    argument to those rows; ``gather`` joins a per-row output of every
    data rank back into the whole batch."""

    def __init__(self, mesh, batch: int):
        self.batch = int(batch)
        self.sharded = batch_shardable(mesh, self.batch)
        self.lo, self.hi = 0, self.batch
        if self.sharded:
            n = self.batch // data_size(mesh)
            self.lo = data_rank(mesh) * n
            self.hi = self.lo + n
            self.group = data_group(mesh)

    def take(self, x):
        """Rows [lo, hi) of a tensor, an array, a sequence or a key (a key
        batch is indexed; a scalar key draws the whole batch and keeps its
        rows); ``None`` and scalars pass through."""
        if not self.sharded or x is None or isinstance(x, (int, float)):
            return x
        if isinstance(x, (torch.Tensor, np.ndarray, list, tuple)):
            if len(x) != self.batch:
                raise ValueError(f"{len(x)} rows for a batch of "
                                 f"{self.batch}")
            return x[self.lo:self.hi]
        if hasattr(x, "__len__"):                    # a key batch
            return x[self.lo:self.hi]
        return _RowsOfKey(x, self.lo, self.hi, self.batch)

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        return all_gather_cat(t, self.group) if self.sharded else t

    def gather_objects(self, obj) -> list:
        return all_gather_objects(obj, self.group) if self.sharded else [obj]


class LossRows(DataRows):
    """``DataRows`` of a loss's batch, with the mesh's rule for a loss and
    its gradients.  Where the data ranks hold rows of their own, a rank's
    loss divides by the whole batch's counts (``count``, ``whole_rows``),
    so its loss, diagnostics and gradients are its share of the whole
    batch's: ``finish`` sums the gradients (``finish_grads``) and ``sum``
    the loss and diagnostics over the data group.  Where a rank holds the
    whole batch (off the mesh, or a batch the data axes do not divide)
    the counts are its own (``count`` and ``whole_rows`` None), ``sum`` is
    the identity and ``finish`` averages over the data group."""

    def __init__(self, mesh, batch: int):
        super().__init__(mesh, batch)
        self.mesh = mesh
        self.whole_rows = self.batch if self.sharded else None

    def count(self, mask: torch.Tensor):
        """The whole batch's count of ``mask`` (given whole), or None where
        the rank's own count is the whole batch's."""
        return mask.float().sum() if self.sharded else None

    def finish(self, model, grads: Sequence[torch.Tensor]) -> None:
        """A rank's gradients of ``model`` finished on the mesh, in place
        (``finish_grads``)."""
        finish_grads(self.mesh, model, grads, rows_sharded=self.sharded)

    def sum(self, info: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Each rank's share of the loss and diagnostics summed over the
        data group: the whole batch's values, on every rank."""
        if not self.sharded or not info:
            return info
        names = sorted(info)
        flat = torch.stack([info[k].detach().float().reshape(())
                            for k in names])
        all_reduce_(flat, self.group)
        return dict(zip(names, flat.unbind()))

    def _mean_ce(self, stats) -> torch.Tensor:
        """Each MoE layer's routed fraction ``ce`` (L, E) over the whole
        batch: the data group's mean (every rank holds as many tokens)."""
        ce = torch.stack([s["ce"] for s in stats]).detach().float()
        return all_reduce_(ce, self.group) / data_size(self.mesh)

    def router_loss(self, cfg: ModelConfig, aux, stats):
        """A MoE trunk's router losses in this rank's loss: (the term,
        ``router_aux_coef`` times the load-balance loss plus
        ``router_z_coef`` times the z-loss, with its graph; this rank's
        share of the whole batch's ``moe_lb_loss``, detached, for
        ``sum``).  ``aux``/``stats``: the forward's aux and its
        ``router_stats``.

        Each is a mean over the batch, and the load-balance loss a product
        of two, ``lb = E * sum_e me_e * ce_e`` a layer (JAX's, on the whole
        batch).  Where a rank holds rows of its own, it takes the whole
        batch's ``ce`` (the data group's mean; ``ce`` carries no gradient)
        and its own ``me`` over D, and its own z-loss over D: the data
        group's sum of its terms is the whole batch's value, and so is
        the sum of their gradients (``finish``).  Where it holds the
        whole batch, the forward's own losses are the whole batch's."""
        if not self.sharded:
            lb = aux["moe_lb_loss"]
            z = aux["moe_z_loss"]
        else:
            D = data_size(self.mesh)
            me = torch.stack([s["me"] for s in stats])
            lb = cfg.num_experts * (me * self._mean_ce(stats)).sum(-1) \
                .mean() / D
            z = aux["moe_z_loss"] / D
        return cfg.router_aux_coef * lb + cfg.router_z_coef * z, lb.detach()

    def whole_aux(self, cfg: ModelConfig, aux, stats
                  ) -> Dict[str, torch.Tensor]:
        """A MoE trunk's aux diagnostics (``moe_lb_loss``, ``moe_z_loss``,
        ``moe_expert_frac`` and ``moe_drop_frac``, each the mean over its
        layers, detached) over the whole batch, on every rank: the
        forward's own where the rank holds the whole batch, else the data
        group's means (the load-balance loss by ``router_loss``'s rule)."""
        if not self.sharded or not aux:
            return {k: v.detach() for k, v in aux.items()}
        D = data_size(self.mesh)
        _, lb = self.router_loss(cfg, aux, stats)
        out = self.sum({"moe_lb_loss": lb,
                        **{k: aux[k] / D for k in ("moe_z_loss",
                                                   "moe_drop_frac")
                           if k in aux}})
        out["moe_expert_frac"] = self._mean_ce(stats).mean(0)
        return out


def shard_batch(mesh, tree):
    """This rank's rows of every leaf of ``tree`` (each leaf's leading
    dimension over the data axes, by ``batch_pspec``)."""
    if mesh is None:
        return tree

    def one(x):
        if isinstance(x, (torch.Tensor, np.ndarray)) and x.ndim:
            return DataRows(mesh, x.shape[0]).take(x)
        return x
    return _map(one, tree)


# ------------------------------------------------------- tensor parallelism


def check_mesh_family(cfg: ModelConfig, mesh=None) -> None:
    """The mesh runs GQA attention with dense FFN and MoE layers (qwen3,
    deepseek-7b, qwen1.5-110b, granite-34b, mixtral-8x22b); the other
    families come with part 3 of item 11.  On a data axis larger than 1
    it also refuses the MoE dispatches that couple rows across data
    ranks: ``sort`` (one capacity from the whole batch's tokens) and
    ``dispatch`` with ``moe_groups`` > 0 (a group may span two ranks'
    rows).  Reproducing them needs a data-group exchange inside every MoE
    call, so every data rank would run its forwards in lockstep, which
    the decode loops and the slot servers do not."""
    gqa = (cfg.attention_kind == "gqa"
           and all(kind == ATTN for kind, _ in cfg.layer_plan())
           and not cfg.cross_attention and not cfg.encoder_layers
           and not cfg.num_prefix_embeddings and not cfg.mtp)
    if not gqa:
        raise NotImplementedError(
            f"{cfg.name}: Mamba, MLA and MTP, RWKV6 and the modality "
            "frontends (cross-attention, encoders, vision prefixes) run on "
            "the mesh with part 3 of ROADMAP Queue 1 item 11 (the mesh); "
            "GQA attention with dense FFN and MoE layers runs there now")
    moe = any(m for _, m in cfg.layer_plan())
    coupled = cfg.moe_impl == "sort" or (cfg.moe_impl == "dispatch"
                                          and cfg.moe_groups > 0)
    if moe and coupled and data_size(mesh) > 1:
        raise NotImplementedError(
            f"{cfg.name}: moe_impl={cfg.moe_impl!r} with moe_groups="
            f"{cfg.moe_groups} couples rows across the data axis; it runs "
            "on a mesh whose data axis is 1 and comes to larger ones with "
            "part 3 of ROADMAP Queue 1 item 11 (the mesh)")


def _slice(t: torch.Tensor, spec, size: int, rank: int) -> torch.Tensor:
    for dim, ax in enumerate(spec):
        if ax == "model":
            t = t.chunk(size, dim=dim)[rank]
    return t


def _set_param(root: nn.Module, name: str, value: nn.Parameter) -> None:
    *path, leaf = name.split(".")
    mod = root
    for part in path:
        mod = getattr(mod, part)
    setattr(mod, leaf, value)


@torch.no_grad()
def shard_params(mesh, cfg: ModelConfig, model):
    """This rank's slice of ``model`` (an ``LM`` or a critic) over the
    mesh's model axis, by the ``param_spec`` rules: a new module of its
    type whose parameters are the local slices (copies), marked for its
    collectives (module docstring), with each parameter's spec in
    ``param_specs``.  The model itself on a mesh without a model axis
    (parameters replicated over data), and a model already cut for this
    model group as it is."""
    if mesh is None:
        return model
    check_mesh_family(cfg, mesh)
    m = model_size(mesh)
    if m <= 1:
        return model
    group = model_group(mesh)
    ranks = group_ranks(group)
    if getattr(model, "tp", None) is not None:
        if group_ranks(model.tp) != ranks:
            raise ValueError(f"a model cut for ranks {group_ranks(model.tp)} "
                             f"on a model group of ranks {ranks}")
        return model
    r = model_rank(mesh)
    specs = params_pspecs(cfg, model, m)
    out = type(model)(cfg, device="meta")
    for name, p in model.named_parameters():
        local = _slice(p.detach(), specs[name], m, r).clone()
        _set_param(out, name, nn.Parameter(local,
                                           requires_grad=p.requires_grad))
    out.tp = group
    out.param_specs = specs
    if "model" in specs["embed"]:
        V = cfg.vocab_size
        out.vocab_shard = (r * V // m, (r + 1) * V // m)
    head = "embed" if cfg.tie_embeddings else "lm_head.kernel"
    out.logits_sharded = head in specs and "model" in specs[head]
    for li, layer in enumerate(out.layers):
        attn = layer.attn
        pre = f"layers.{li}.attn."
        q_cut = "model" in specs[pre + "wq.kernel"]
        kv_cut = "model" in specs[pre + "wk.kernel"]
        # KV heads the axis does not divide are replicated: the queries
        # are gathered whole and the attention runs over every head
        attn.gather_q = q_cut and not kv_cut
    for name, mod in out.named_modules():
        kernel = getattr(mod, "kernel", None)
        if kernel is not None and kernel.ndim == 2 and \
                specs[f"{name}.kernel"] == ("model", None):
            mod.reduce_group = group             # row-parallel: all-reduce
        if hasattr(mod, "expert_group"):
            # a MoE: its expert stacks (E, ., .) cut together, on the
            # experts (dim 0) or on d_ff; whole, nothing is summed
            dim = _model_dim(specs[f"{name}.w_gate"])
            if dim is not None:
                mod.expert_group = group
                mod.expert_lo = r * mod.w_gate.shape[0] if dim == 0 else 0
    return out


# ------------------------------------------------------------------ training


def param_specs(model) -> Dict[str, tuple]:
    """Each parameter's spec on a cut model (``{}`` on an uncut one: every
    parameter whole)."""
    return getattr(model, "param_specs", None) or {}


def _model_dim(spec):
    return spec.index("model") if "model" in spec else None


def cut_flags(model) -> List[bool]:
    """For each parameter (in ``named_parameters`` order), whether it is
    cut over the model axis."""
    specs = param_specs(model)
    return [_model_dim(specs.get(n, ())) is not None
            for n, _ in model.named_parameters()]


def clone_module(module):
    """A deep copy of a (possibly cut) module that shares its process
    groups (a KL reference, an async service's model)."""
    memo = {}
    for mod in module.modules():
        for attr in ("tp", "reduce_group", "expert_group"):
            g = getattr(mod, attr, None)
            if g is not None:
                memo[id(g)] = g
    return copy.deepcopy(module, memo)


def region_params(model) -> set:
    """The replicated parameters that a cut model uses inside a
    model-parallel region: those of a module whose output is a
    row-parallel ``Dense`` (``reduce_group`` set: the attention's ``wo``,
    the FFN's ``w_down``), but for that output's bias, which is added
    after the sum, and a cut MoE's own tensors (``expert_group`` set: its
    region is its experts; its router sits outside, as the combine
    weights enter through copy-to-model, and its shared expert is an FFN,
    a region of its own).  Each rank's gradient of such a parameter is
    its own heads' (or experts') share."""
    specs = param_specs(model)
    out = set()

    def replicated(params):
        out.update(n for n, _ in params
                   if _model_dim(specs.get(n, ())) is None)

    for name, mod in model.named_modules():
        prefix = f"{name}." if name else ""
        if getattr(mod, "expert_group", None) is not None:
            replicated((prefix + n, p) for n, p in
                       mod.named_parameters(recurse=False))
        outs = [c for c in mod.children()
                if getattr(c, "reduce_group", None) is not None]
        if not outs:
            continue
        after = {id(c.bias) for c in outs if c.bias is not None}
        replicated((n, p) for n, p in mod.named_parameters(prefix=name)
                   if id(p) not in after)
    return out


# elements of one float32 bucket a gradient sum sends at once (256 MB)
GRAD_BUCKET = 1 << 26


def pieces(*ts: torch.Tensor) -> List[Tuple[torch.Tensor, ...]]:
    """Tensors of one shape, piece by piece: matching flat views of at
    most ``GRAD_BUCKET`` elements each, so that float32 temporaries of an
    expert stack's gradient, moments or update stay 256 MB; the tensors
    whole when they fit, or when one is not contiguous."""
    if ts[0].numel() <= GRAD_BUCKET or not all(t.is_contiguous()
                                               for t in ts):
        return [ts]
    return list(zip(*(t.view(-1).split(GRAD_BUCKET) for t in ts)))


@torch.no_grad()
def _sum_over(tensors: Sequence[torch.Tensor], group, scale: float = 1.0
              ) -> None:
    """Sum every tensor over ``group`` in place (times ``scale``), in
    float32 buckets of up to ``GRAD_BUCKET`` elements (a larger tensor in
    pieces: the bucket's float32 copy stays 256 MB)."""
    bucket: List[torch.Tensor] = []

    def flush():
        flat = torch.cat([t.reshape(-1).float() for t in bucket])
        all_reduce_(flat, group)
        if scale != 1.0:
            flat.mul_(scale)
        off = 0
        for t in bucket:
            t.copy_(flat[off:off + t.numel()].view(t.shape))
            off += t.numel()
        bucket.clear()

    n = 0
    for t in tensors:
        for piece, in pieces(t):
            if bucket and n + piece.numel() > GRAD_BUCKET:
                flush()
                n = 0
            bucket.append(piece)
            n += piece.numel()
    if bucket:
        flush()


def finish_grads(mesh, model, grads: Sequence[torch.Tensor], *,
                 rows_sharded: bool) -> None:
    """Finish a rank's gradients of ``model`` (in ``named_parameters``
    order) on the mesh, in place: the model-group sum of the
    ``region_params``, then the data-group sum, or the mean when the batch
    was replicated over the data axis (``rows_sharded`` False)."""
    if mesh is None:
        return
    if getattr(model, "tp", None) is not None:
        inside = region_params(model)
        _sum_over([g for (n, _), g in zip(model.named_parameters(), grads)
                   if n in inside], model.tp)
    D = data_size(mesh)
    if D > 1:
        _sum_over(grads, data_group(mesh),
                  scale=1.0 if rows_sharded else 1.0 / D)


# the mesh's rank that writes a snapshot (``rl/watchdog.py:write_once``)
WRITER = 0


def gather_params(model, tensors=None) -> Dict[str, torch.Tensor]:
    """The whole tensors of a model, for a snapshot: its parameters, or
    ``tensors`` laid out like them (a list in ``named_parameters`` order:
    AdamW's moments).  An uncut model's as they are.  A cut model's are
    gathered a tensor at a time to the host of the mesh's ``WRITER`` (a
    collective of its model group; the other groups send nothing), and
    are ``{}`` on every other rank: no rank holds a whole tree on its
    card, and only the writer holds one at all."""
    named = list(model.named_parameters())
    if tensors is None:
        tensors = [p for _, p in named]
    if getattr(model, "tp", None) is None:
        return {n: t.detach() for (n, _), t in zip(named, tensors)}
    if group_ranks(model.tp)[0] != WRITER:
        return {}
    lead = dist.get_rank() == WRITER
    specs = param_specs(model)
    out = {}
    for (n, _), t in zip(named, tensors):
        d = _model_dim(specs.get(n, ()))
        if d is not None:
            whole = gather_cat_to_host(t, model.tp, dim=d)
        else:
            whole = t.detach().cpu() if lead else None
        if whole is not None:
            out[n] = whole
    return out


def cut_on_read(models: Mapping[str, Any]
                ) -> Callable[[str, torch.Tensor], torch.Tensor]:
    """A leaf transform for ``checkpoint/io.load_pytree`` that cuts each
    whole tensor of a snapshot onto this rank as it is read, so a rank
    holds its own slices alone (the inverse of ``gather_params``).
    ``models`` maps the path of a subtree in the file to the model whose
    tensors it holds, by name (``"/params"``) or in ``named_parameters``
    order (``"/opt_state/mu"``: AdamW's moments take the parameters'
    layout and ``step`` is replicated, as JAX's ``shard_opt_state`` lays
    them); every other leaf is as it was written."""
    def cut(path: str, t: torch.Tensor) -> torch.Tensor:
        head, _, leaf = path.rpartition("/")
        model = models.get(head)
        if model is None or getattr(model, "tp", None) is None:
            return t
        if leaf.startswith("#"):
            leaf = [n for n, _ in model.named_parameters()][int(leaf[1:])]
        spec = param_specs(model).get(leaf, ())
        if _model_dim(spec) is None:
            return t
        # a copy: the whole tensor's memory goes with it
        return _slice(t, spec, group_size(model.tp),
                      group_rank(model.tp)).clone()
    return cut


# ------------------------------------------------------------------ KV caches


def _cache_leaf_pspec(shape, mesh, kv_heads: bool):
    """Partition of one trunk-cache leaf (leading axis = scan run)."""
    b_ax = batch_pspec(mesh, 1, shape[1])[0] if len(shape) >= 2 else None
    spec = [None, b_ax] + [None] * (len(shape) - 2)
    if kv_heads:
        msz = model_size(mesh)
        if msz > 1 and shape[2] % msz == 0 and shape[2] >= msz:
            spec[2] = "model"
    return tuple(spec)


def decode_cache_pspecs(cfg: ModelConfig, caches, mesh, *,
                        batch: bool = True):
    """Same-structure specs for a trunk decode cache (JAX's): batch (axis
    1, after the run axis) over ``data``; the KV head axis of attention
    ``k``/``v`` over ``model`` when the head count divides it.  A paged
    pool's axis 1 is the global block pool, where rows of different slots
    interleave, so it is never sharded like a batch; only its head axis
    is.  ``batch=False``: the slot engine's persistent batch, whole per
    data shard."""
    out = []
    for run in caches:
        new_run = {}
        for group, sub in run.items():
            paged = "table" in sub
            new_sub = {}
            for name, leaf in sub.items():
                kv_heads = group == "self" and name in ("k", "v") \
                    and leaf.ndim == 5
                if paged:
                    spec = [None] * leaf.ndim
                    if kv_heads:
                        msz = model_size(mesh)
                        if msz > 1 and leaf.shape[2] % msz == 0:
                            spec[2] = "model"
                    new_sub[name] = tuple(spec)
                    continue
                spec = _cache_leaf_pspec(leaf.shape, mesh, kv_heads)
                if not batch and len(spec) > 1:
                    spec = (spec[0], None) + spec[2:]
                new_sub[name] = spec
            new_run[group] = new_sub
        out.append(new_run)
    return out


def shard_caches(cfg: ModelConfig, caches, mesh, *, batch: bool = True):
    """This rank's slice of a whole decode cache, by
    ``decode_cache_pspecs`` (new tensors)."""
    if mesh is None:
        return caches
    specs = decode_cache_pspecs(cfg, caches, mesh, batch=batch)
    D, m = data_size(mesh), model_size(mesh)
    dr, mr = data_rank(mesh), model_rank(mesh)

    def cut(leaf, spec):
        for dim, ax in enumerate(spec):
            if ax == "model":
                leaf = leaf.chunk(m, dim=dim)[mr]
            elif ax is not None:
                leaf = leaf.chunk(D, dim=dim)[dr]
        return leaf.clone()
    return [{g: {n: cut(leaf, specs[i][g][n]) for n, leaf in sub.items()}
             for g, sub in run.items()} for i, run in enumerate(caches)]


# ------------------------------------------------------------------ ranks


def pick_backend(device: torch.device, ranks_per_host: int) -> str:
    """NCCL when every rank of a host has a card of its own, else gloo
    (ranks that share a card, or the CPU); chosen from the device count
    and logged on one line."""
    if device.type == "cuda" and torch.cuda.device_count() >= ranks_per_host:
        backend = "nccl"
    else:
        backend = "gloo"
    cards = torch.cuda.device_count() if device.type == "cuda" else 0
    log.info("mesh backend %s: %d ranks a host on %s with %d cards",
             backend, ranks_per_host, device.type, cards)
    return backend


def rank_device(device: DeviceLike, local_rank: int,
                ranks_per_host: int) -> torch.device:
    """A rank's device: its own card where each rank has one, else the
    first card (ranks share it), or the CPU."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return dev
    if torch.cuda.device_count() >= ranks_per_host:
        return torch.device("cuda", local_rank)
    return torch.device("cuda", 0)


def init_from_env(device: DeviceLike = None) -> torch.device:
    """Join the process group ``torchrun`` describes (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, the rendezvous
    address); a process started without it stays a world of one.
    Returns this rank's device."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1 or dist.is_initialized():
        return resolve_device(device)
    local = int(os.environ.get("LOCAL_RANK", "0"))
    per_host = int(os.environ.get("LOCAL_WORLD_SIZE", str(world)))
    dev = rank_device(device, local, per_host)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(pick_backend(dev, per_host))
    return dev


def _rank_main(fn, rank: int, world: int, tmp: str, device, timeout: float,
               args) -> None:
    dev = rank_device(device, rank, world)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    else:
        torch.set_num_threads(1)
    dist.init_process_group(
        pick_backend(dev, world),
        store=dist.FileStore(os.path.join(tmp, "store"), world),
        rank=rank, world_size=world, timeout=timedelta(seconds=timeout))
    try:
        out = fn(rank, *args)
        with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    except BaseException:
        with open(os.path.join(tmp, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()


def run_ranks(fn: Callable, world: int, args: Sequence = (), *,
              device: DeviceLike = None, timeout: float = 600.0) -> list:
    """Run ``fn(rank, *args)`` in ``world`` spawned processes, one rank
    each, joined in one process group through a ``FileStore`` in a
    temporary directory (no port, so parallel runs never meet).  ``fn``
    must be importable by name and its return value picklable.  Returns
    each rank's value, in rank order.  A rank that fails stops every
    other (its traceback is raised here); so does ``timeout``."""
    ctx = torch.multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, r, world, tmp, device, timeout,
                                   tuple(args)), daemon=True)
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        failed = None
        try:
            while any(p.is_alive() for p in procs):
                bad = [r for r, p in enumerate(procs)
                       if p.exitcode not in (None, 0)]
                if bad:
                    failed = bad[0]
                    break
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{world} ranks ran past {timeout} s")
                time.sleep(0.05)
            if failed is None:
                bad = [r for r, p in enumerate(procs) if p.exitcode != 0]
                failed = bad[0] if bad else None
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
            for p in procs:
                p.join(timeout=30)
        if failed is not None:
            err = os.path.join(tmp, f"rank{failed}.err")
            text = open(err).read() if os.path.exists(err) else \
                f"exit code {procs[failed].exitcode}"
            raise RuntimeError(f"rank {failed} of {world} failed:\n{text}")
        out = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
