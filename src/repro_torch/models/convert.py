"""Carry a JAX parameter pytree across into the port's ``LM`` (or any
module of the same trunk: the PPO critic's converters in ``rl/critic.py``
call ``load_params``/``params_tree`` with their own head).

``repro.models.model.init_lm`` returns nested dicts whose trunk leaves are
stacked per signature run with a leading ``run_len`` axis (DESIGN.md §2).
``from_jax_params`` takes that tree with every leaf already a numpy array
(``jax.tree.map(np.asarray, params)``; the port never imports JAX) and
copies it into an ``LM`` whose ``layers[i]`` is global layer i (a MoE
layer's ``moe.router``, stacked ``moe.w_gate`` / ``w_up`` / ``w_down`` and
``moe.shared`` by the same names; a decoder block's ``norm_ca`` and
``cross_attn`` too; an MLA layer's ``attn`` holds ``wq_a``, ``q_norm``,
``wq_b`` (or ``wq``), ``wkv_a``, ``kv_norm``, ``wkv_b`` and ``wo``).  An
encoder-decoder's ``encoder`` (``trunk``, stacked the same way, and
``final_norm``), a learned ``pos_table`` and deepseek-v3's ``mtp`` head
(``proj``, ``norm`` and one unstacked ``block``) come along.
``to_jax_params`` is the inverse: an ``LM`` back to that tree, as numpy
float32 leaves (a bfloat16 parameter widened exactly), so that a test can
hold updated parameters against JAX's leaf by leaf.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch
from torch import nn

from repro_torch.device import DeviceLike, resolve_device

from .blocks import signature_runs
from .config import ModelConfig
from .model import LM


def _tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":          # ml_dtypes: torch cannot wrap it
        a = a.astype(np.float32)
    return torch.tensor(a)


def _copy_into(param: nn.Parameter, value, where: str) -> None:
    t = _tensor(value)
    if tuple(t.shape) != tuple(param.shape):
        raise ValueError(f"{where}: shape {tuple(t.shape)} != "
                         f"{tuple(param.shape)}")
    param.copy_(t.to(device=param.device, dtype=param.dtype))


def _load(module: nn.Module, tree: Mapping[str, Any], where: str) -> None:
    for name, value in tree.items():
        target = getattr(module, name, None)
        if target is None:
            raise KeyError(f"{where}.{name} has no counterpart in the port")
        if isinstance(value, Mapping):
            _load(target, value, f"{where}.{name}")
        else:
            _copy_into(target, value, f"{where}.{name}")


@torch.no_grad()
def from_jax_params(tree: Mapping[str, Any], cfg: ModelConfig,
                    device: DeviceLike = None) -> LM:
    """tree: ``repro`` params with numpy leaves.  Returns an ``LM`` on
    ``device`` (the card unless ``device="cpu"``)."""
    model = LM(cfg, device=resolve_device(device))
    load_params(model, tree, "lm_head")
    return model


def load_params(module: nn.Module, tree: Mapping[str, Any],
                head: str) -> None:
    """Copy ``embed``, ``final_norm``, the per-run stacked ``trunk`` and,
    where the tree has them, the head named ``head``, ``pos_table``,
    ``encoder`` and ``mtp`` into ``module`` (one with ``embed``,
    ``layers``, ``final_norm``, that head and ``cfg``)."""
    _copy_into(module.embed, tree["embed"], "embed")
    _load(module.final_norm, tree["final_norm"], "final_norm")
    if head in tree:
        _load(getattr(module, head), tree[head], head)
    for name in ("pos_table", "encoder", "mtp"):
        if (name in tree) != (getattr(module, name, None) is not None):
            raise KeyError(f"{name}: in the tree {name in tree}, in the "
                           "port's module the other way")
    if "pos_table" in tree:
        _copy_into(module.pos_table, tree["pos_table"], "pos_table")
    if "mtp" in tree:
        _load(module.mtp, tree["mtp"], "mtp")
    if "encoder" in tree:
        enc = module.encoder
        _load(enc.final_norm, tree["encoder"]["final_norm"],
              "encoder.final_norm")
        _load_trunk(enc.trunk, enc.cfg, tree["encoder"]["trunk"],
                    "encoder.trunk")
    _load_trunk(module.layers, module.cfg, tree["trunk"], "trunk")


def _load_trunk(layers: nn.ModuleList, cfg: ModelConfig, trunk,
                where: str) -> None:
    layer = 0
    for run_idx, (_, run_len) in enumerate(signature_runs(cfg)):
        stacked = trunk[run_idx]
        for j in range(run_len):
            one = _index(stacked, j)
            _load(layers[layer], one, f"{where}[{run_idx}][{j}]")
            layer += 1


def _index(tree, j: int):
    if isinstance(tree, Mapping):
        return {k: _index(v, j) for k, v in tree.items()}
    return np.asarray(tree)[j]


def _array(p: torch.Tensor) -> np.ndarray:
    """A float32 numpy copy (never a view of the parameter's memory)."""
    return np.array(p.detach().float().cpu().numpy(), copy=True)


def _tree(module: nn.Module) -> dict:
    """A module's parameters as nested dicts of numpy float32 arrays, by
    attribute name (``None`` children, such as an absent bias, skipped)."""
    out = {name: _array(p) for name, p in module.named_parameters(recurse=False)}
    for name, child in module.named_children():
        out[name] = _tree(child)
    return out


def to_jax_params(model: LM) -> dict:
    """The ``repro`` params tree of ``model``: ``embed``, ``final_norm``,
    ``lm_head`` (untied heads), ``pos_table``, ``encoder`` and ``mtp``
    (where the model has them) and ``trunk``, a list with one tree per
    signature run whose leaves stack the run's layers on a leading axis."""
    return params_tree(model, "lm_head")


def params_tree(module: nn.Module, head: str) -> dict:
    """The inverse of ``load_params``: ``module``'s tree, with the head
    named ``head`` unless the module has none."""
    tree = {"embed": _array(module.embed),
            "final_norm": _tree(module.final_norm)}
    if getattr(module, head) is not None:
        tree[head] = _tree(getattr(module, head))
    if getattr(module, "pos_table", None) is not None:
        tree["pos_table"] = _array(module.pos_table)
    if getattr(module, "mtp", None) is not None:
        tree["mtp"] = _tree(module.mtp)
    enc = getattr(module, "encoder", None)
    if enc is not None:
        tree["encoder"] = {"trunk": _trunk_tree(enc.trunk, enc.cfg),
                           "final_norm": _tree(enc.final_norm)}
    tree["trunk"] = _trunk_tree(module.layers, module.cfg)
    return tree


def _trunk_tree(layers: nn.ModuleList, cfg: ModelConfig) -> list:
    trunk, layer = [], 0
    for _, run_len in signature_runs(cfg):
        trunk.append(_stack([_tree(layers[layer + j])
                             for j in range(run_len)]))
        layer += run_len
    return trunk


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return np.stack(trees)
