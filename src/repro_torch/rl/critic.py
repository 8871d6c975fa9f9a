"""PPO critic (port of ``repro/rl/critic.py``): the policy's trunk family
with a scalar value head.

``Critic`` holds ``{"embed", "layers", "final_norm", "value_head"}``, the
JAX tree's keys (``layers[i]`` is global layer i, as in ``models.model.LM``;
JAX stacks them per run under ``trunk``).  Its parameters are built frozen;
the trainer turns grad on for the critic's update alone.  ``forward_values``
runs ``models.blocks.apply_trunk``, so a no-grad call on the card reaches
the ``flash_attention`` (or ``wkv``) kernel, and a call with grad on takes
the differentiable route, as ``models.model.forward`` does.
``critic_from_jax_params``/``critic_to_jax_params`` carry JAX's critic
tree across and back, as ``models.convert`` does the policy's.  On the
mesh a critic is cut as the policy is (``distributed/mesh.py:
shard_params``: the embedding over the vocabulary, the trunk over heads;
the value head replicated), and its lookup is the policy's.
"""
from __future__ import annotations

from typing import Any, Mapping

import torch
from torch import nn

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.engine.generate import positions_from_mask
from repro_torch.models import model as M
from repro_torch.models.blocks import (apply_trunk, block_signatures,
                                       check_supported, make_block)
from repro_torch.models.config import ModelConfig
from repro_torch.models.convert import load_params, params_tree
from repro_torch.models.layers import (Dense, RMSNorm, apply_dense,
                                       apply_rmsnorm)


class Critic(nn.Module):
    def __init__(self, cfg: ModelConfig, *, device=None):
        super().__init__()
        cfg.validate()
        check_supported(cfg)
        kw = dict(dtype=M.torch_dtype(cfg.param_dtype), device=device)
        self.cfg = cfg
        self.embed = nn.Parameter(torch.empty(cfg.vocab_size, cfg.d_model, **kw),
                                  requires_grad=False)
        self.layers = nn.ModuleList(make_block(cfg, sig, **kw)
                                    for sig in block_signatures(cfg))
        self.final_norm = RMSNorm(cfg.d_model, **kw)
        self.value_head = Dense(cfg.d_model, 1, bias=True, **kw)
        # the mesh's cut (distributed/mesh.py:shard_params), as an LM's
        self.tp = None
        self.vocab_shard = None

    @property
    def device(self) -> torch.device:
        return self.embed.device


@torch.no_grad()
def init_critic(cfg: ModelConfig, *, seed: int,
                device: DeviceLike = None) -> Critic:
    """Random parameters from an explicit ``torch.Generator`` seeded with
    ``seed`` on ``device`` (the card unless ``device="cpu"``).  Same
    distributions as ``repro.rl.critic.init_critic`` (value head truncated
    normal at fan-in scale, bias 0), not the same numbers."""
    critic = Critic(cfg, device=resolve_device(device))
    M.draw_parameters(critic, seed)
    return critic


@torch.no_grad()
def critic_from_jax_params(tree: Mapping[str, Any], cfg: ModelConfig,
                           device: DeviceLike = None) -> Critic:
    """tree: ``repro.rl.critic.init_critic``'s params with numpy leaves
    (``embed``, ``trunk``, ``final_norm``, ``value_head``).  Returns a
    ``Critic`` on ``device`` (the card unless ``device="cpu"``)."""
    critic = Critic(cfg, device=resolve_device(device))
    load_params(critic, tree, "value_head")
    return critic


def critic_to_jax_params(critic: Critic) -> dict:
    """The ``repro.rl.critic`` params tree of ``critic`` (the inverse of
    ``critic_from_jax_params``), numpy float32 leaves."""
    return params_tree(critic, "value_head")


def forward_values(critic: Critic, cfg: ModelConfig, tokens, mask):
    """tokens: (B, L) int; mask: (B, L) bool.  Returns (B, L) float32
    value estimates, 0 off the mask.  The head's output is cast to float32
    after the dense, as JAX's is (a bfloat16 head rounds the values)."""
    positions = positions_from_mask(mask)
    x = M._lookup(critic, tokens).to(M.torch_dtype(cfg.dtype))
    x = torch.where(mask[..., None], x, torch.zeros_like(x))
    x, _, _ = apply_trunk(critic.layers, cfg, x, positions)
    x = apply_rmsnorm(critic.final_norm, x, cfg.norm_eps)
    v = apply_dense(critic.value_head, x)[..., 0].float()
    return torch.where(mask, v, torch.zeros_like(v))
