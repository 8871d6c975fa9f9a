"""Parameter partition rules (the port's own copy of
``repro/distributed/sharding.py``), keyed on the port's parameter names.

Tensor parallelism runs on the ``model`` axis, data parallelism on
``(pod, data)``.  A rule is matched on the trailing components of a
parameter's path.  The port's path is its ``named_parameters`` name with
dots as slashes (``layers/3/attn/wq/kernel``); the components after the
layer index are the JAX pytree's keys (``models/convert.py`` maps one onto
the other by name), so every rule reads as JAX's does.  The port's layers
are not stacked, so no rule gets JAX's leading ``None`` scan axis.

A spec is a tuple with one entry a dimension, each ``None`` or an axis name
(JAX's ``PartitionSpec``); ``()`` replicates.

Key decisions, as in JAX:
- GQA kv projections shard on ``model`` only when the KV heads divide the
  axis; MQA or GQA with few KV heads replicates them.
- MoE experts are expert-parallel when ``num_experts % model == 0``, else
  each expert is tensor-parallel.
- ``zero_shard_spec`` (ZeRO-style: moments further sharded over ``data``
  on their first dimension that the parameter's spec leaves free and that
  divides) is the dry run's layout, as in JAX; the trainer's moments take
  the parameters' layout, as JAX's ``shard_opt_state`` lays them
  (``adamw.init`` of the cut parameters).

The mesh runs the dense GQA family's rules and the MoE rules
(``distributed/mesh.py``); the MLA, Mamba and RWKV rules are here and
held against JAX's, and run on the mesh with part 3 of ROADMAP Queue 1
item 11 (the mesh).
"""
from __future__ import annotations

import re
from typing import Dict, Optional, Tuple

from torch import nn

from repro_torch.models.config import ModelConfig

Spec = Tuple[Optional[object], ...]


def _divisible(n: int, size: int) -> bool:
    return size > 0 and n % size == 0


def param_spec(path_str: str, shape: Tuple[int, ...], cfg: ModelConfig,
               model_size: int) -> Spec:
    """The spec of one parameter, by its slash-separated path."""
    s = path_str

    def col():   # (in, out) -> shard out
        return (None, "model") if _divisible(shape[-1], model_size) else ()

    def row():   # (in, out) -> shard in
        return ("model", None) if _divisible(shape[-2], model_size) else ()

    # ---- embeddings / heads -------------------------------------------------
    if re.search(r"(^|/)embed$", s):
        return ("model", None) if _divisible(shape[0], model_size) else ()
    if "lm_head" in s and s.endswith("kernel"):
        return col()
    if "pos_table" in s:
        return ()
    if "value_head" in s:
        return ()

    # ---- attention ----------------------------------------------------------
    if re.search(r"attn/w[q]|wq_b", s) and s.endswith("kernel"):
        return col()
    if re.search(r"attn/w[kv]/kernel", s):
        return (None, "model") if _divisible(cfg.num_kv_heads,
                                             model_size) else ()
    if re.search(r"attn/w[kv]/bias", s):
        return ("model",) if _divisible(cfg.num_kv_heads, model_size) else ()
    if s.endswith("wq/bias"):
        return ("model",) if _divisible(shape[-1], model_size) else ()
    if s.endswith("wo/kernel"):
        return row()
    if "wq_a" in s and s.endswith("kernel"):
        return col()
    if "wkv_a" in s:   # keep the MLA latent whole per device
        return ()
    if "wkv_b" in s and s.endswith("kernel"):
        return col()

    # ---- MoE ------------------------------------------------------------------
    if s.endswith("moe/router/kernel"):
        return ()
    if re.search(r"moe/w_(gate|up)$", s):           # (E, d, ff)
        if _divisible(shape[0], model_size):
            return ("model", None, None)            # expert parallel
        return (None, None, "model") if _divisible(shape[-1],
                                                   model_size) else ()
    if s.endswith("moe/w_down"):                    # (E, ff, d)
        if _divisible(shape[0], model_size):
            return ("model", None, None)
        return (None, "model", None) if _divisible(shape[-2],
                                                   model_size) else ()

    # ---- dense FFN (mlp / shared expert / rwkv channel-mix) -----------------
    if re.search(r"w_(gate|up)/kernel$", s) or \
            s.endswith("channel_mix/wk/kernel"):
        return col()
    if s.endswith("w_down/kernel") or s.endswith("channel_mix/wv/kernel"):
        return row()
    if s.endswith("channel_mix/wr/kernel"):
        return ()                                   # output gates full-d

    # ---- mamba -----------------------------------------------------------------
    if s.endswith("in_proj/kernel"):
        return col()
    if s.endswith("conv_w"):
        return (None, "model") if _divisible(shape[-1], model_size) else ()
    if s.endswith("conv_b") or re.search(r"mamba/D$", s):
        return ("model",) if _divisible(shape[-1], model_size) else ()
    if s.endswith("x_proj/kernel"):
        return row()
    if s.endswith("dt_proj/kernel"):
        return col()
    if re.search(r"A_log$", s):
        return ("model", None) if _divisible(shape[-2], model_size) else ()
    if s.endswith("out_proj/kernel"):
        return row()

    # ---- rwkv time mix -----------------------------------------------------------
    if re.search(r"time_mix/w[rkvg]/kernel$", s):
        return col()
    if s.endswith("time_mix/wo/kernel"):
        return row()

    # default: replicate (norms, small vectors, loras, router bias, ...)
    return ()


def param_path(name: str) -> str:
    """A ``named_parameters`` name as the rules' slash-separated path."""
    return name.replace(".", "/")


def params_pspecs(cfg: ModelConfig, module: nn.Module,
                  model_size: int) -> Dict[str, Spec]:
    """The spec of every parameter of ``module`` (an ``LM``, any device,
    ``meta`` included), by its ``named_parameters`` name."""
    out = {}
    for name, p in module.named_parameters():
        spec = param_spec(param_path(name), tuple(p.shape), cfg, model_size)
        out[name] = () if len(spec) > p.ndim else spec
    return out


def zero_shard_spec(spec: Spec, shape: Tuple[int, ...], data_axes=("data",),
                    data_size: int = 16) -> Spec:
    """ZeRO-style optimizer-moment sharding: the (pod,)data axes go on the
    first dimension the parameter's spec leaves unsharded and that
    divides."""
    parts = list(spec) + [None] * (len(shape) - len(spec))
    for i, (cur, dim) in enumerate(zip(parts, shape)):
        if cur is None and dim >= data_size and dim % data_size == 0:
            parts[i] = tuple(data_axes) if len(data_axes) > 1 else data_axes[0]
            break
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


def axis_sizes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` (or anything with its
    ``mesh_dim_names`` and ``shape``)."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def batch_axes(mesh) -> Tuple[str, ...]:
    names = axis_sizes(mesh)
    return tuple(a for a in ("pod", "data") if a in names)


def data_shards(mesh) -> int:
    """The product of the data axes' sizes (1 without one)."""
    sizes = axis_sizes(mesh)
    total = 1
    for a in batch_axes(mesh):
        total *= sizes[a]
    return total


def batch_spec(mesh, ndim: int, batch_size: int) -> Spec:
    """Leading-dimension partition over the data axes; a batch they do not
    divide (or with fewer rows than shards) is replicated: the one rule of
    every batch split (``mesh.batch_pspec``, ``mesh.batch_shardable``)."""
    total = data_shards(mesh)
    if batch_size % total != 0 or batch_size < total:
        return (None,) * ndim
    axes = batch_axes(mesh)
    first = axes if len(axes) > 1 else axes[0]
    return (first,) + (None,) * (ndim - 1)
