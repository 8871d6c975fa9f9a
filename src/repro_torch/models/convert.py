"""Carry a JAX parameter pytree across into the port's ``LM``.

``repro.models.model.init_lm`` returns nested dicts whose trunk leaves are
stacked per signature run with a leading ``run_len`` axis (DESIGN.md §2).
``from_jax_params`` takes that tree with every leaf already a numpy array
(``jax.tree.map(np.asarray, params)``; the port never imports JAX) and
copies it into an ``LM`` whose ``layers[i]`` is global layer i.
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
    _copy_into(model.embed, tree["embed"], "embed")
    _load(model.final_norm, tree["final_norm"], "final_norm")
    if "lm_head" in tree:
        _load(model.lm_head, tree["lm_head"], "lm_head")
    layer = 0
    for run_idx, (_, run_len) in enumerate(signature_runs(cfg)):
        stacked = tree["trunk"][run_idx]
        for j in range(run_len):
            one = _index(stacked, j)
            _load(model.layers[layer], one, f"trunk[{run_idx}][{j}]")
            layer += 1
    return model


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
    ``lm_head`` (untied heads) and ``trunk``, a list with one tree per
    signature run whose leaves stack the run's layers on a leading axis."""
    cfg = model.cfg
    tree = {"embed": _array(model.embed),
            "final_norm": _tree(model.final_norm)}
    if model.lm_head is not None:
        tree["lm_head"] = _tree(model.lm_head)
    trunk, layer = [], 0
    for _, run_len in signature_runs(cfg):
        layers = [_tree(model.layers[layer + j]) for j in range(run_len)]
        trunk.append(_stack(layers))
        layer += run_len
    tree["trunk"] = trunk
    return tree


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return np.stack(trees)
