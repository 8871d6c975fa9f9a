"""AdamW with global-norm clipping and learning-rate schedules (port of
``repro/optim/adamw.py``; the paper trains the actor with AdamW lr 5e-7,
wd 0.01, clip 1.0, Appendix A.1).  Not ``torch.optim.AdamW``: the step
follows the reference's arithmetic op for op.

* The gradients are clipped first: scaled by ``clip_norm / (gnorm +
  1e-9)`` only when their global norm exceeds ``clip_norm``.
* Then ``step + 1``, the schedule's learning rate at it, and the bias
  corrections, all in float32.
* The update runs in float32 with the decay inside the step,
  ``p - lr * (m̂ / (√v̂ + eps) + wd * p)``, and is cast back to the
  parameter's dtype.  There is no float32 master copy: a bfloat16 weight
  keeps only what its 8-bit mantissa holds of the step, as in JAX.

The moments are float32 from ``init`` on.  JAX's start in the parameter's
dtype and turn float32 at the first update; they start at zero, which
every dtype holds exactly, so the numbers are the same.

Parameters, gradients and moments are lists of tensors in one order
(``init(params)`` makes the moments in the order it is given); ``update``
works in place under ``torch.no_grad()``, one parameter at a time so that
its float32 temporaries stay the size of one tensor.

On the mesh (``mesh=``, with ``sharded`` flagging the tensors cut over
the model axis) the norm is the global one: the cut tensors' squares are
summed over the model group and each replicated tensor counts once, so
every rank clips by the same scale.  The gradients come finished
(``distributed/mesh.py:finish_grads``), so a rank's moments and
parameters step like the matching slices of one device's.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import torch

from repro_torch.distributed.comm import all_reduce_
from repro_torch.distributed.mesh import model_group, model_size, pieces


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 5e-7
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.01
    clip_norm: float = 1.0
    schedule: str = "constant"       # constant|cosine|warmup_cosine
    total_steps: int = 1000
    warmup_steps: int = 0


def _f32(x, device=None) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def lr_at(cfg: AdamWConfig, step, device=None) -> torch.Tensor:
    """The learning rate at ``step`` (a 0-d float32 tensor)."""
    step = _f32(step, device)
    lr = _f32(cfg.lr, device)
    if cfg.schedule == "constant":
        return lr
    if cfg.schedule not in ("cosine", "warmup_cosine"):
        raise ValueError(f"unknown schedule {cfg.schedule!r}")
    one = _f32(1.0, device)
    warm = (torch.minimum(one, step / max(cfg.warmup_steps, 1))
            if cfg.warmup_steps > 0 else one)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * t))
    if cfg.schedule == "cosine":
        return lr * cos
    return lr * warm * cos


def init(params: Sequence[torch.Tensor]) -> Dict[str, object]:
    """``{"mu", "nu": float32 zeros like each parameter, "step": 0}``."""
    return {"mu": [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                   for p in params],
            "nu": [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                   for p in params],
            "step": 0}


def _square_sum(tensors: Sequence[torch.Tensor]):
    total = None
    for x in tensors:
        for piece, in pieces(x):
            s = torch.sum(torch.square(piece.float()))
            total = s if total is None else total + s
    return total


def global_norm(tensors: Sequence[torch.Tensor], mesh=None,
                sharded: Optional[Sequence[bool]] = None) -> torch.Tensor:
    """sqrt of the sum of squares, in float32, summed tensor by tensor in
    the given order (as JAX's Python ``sum`` over the leaves).  On a mesh
    with a model axis, the tensors flagged in ``sharded`` are this rank's
    slices: their squares are summed over the model group, and every other
    tensor (replicated) counts once."""
    if mesh is None or model_size(mesh) <= 1 or not any(sharded or ()):
        return torch.sqrt(_square_sum(tensors))
    cut = _square_sum([x for x, c in zip(tensors, sharded) if c])
    whole = _square_sum([x for x, c in zip(tensors, sharded) if not c])
    all_reduce_(cut, model_group(mesh))
    return torch.sqrt(cut if whole is None else cut + whole)


@torch.no_grad()
def update(cfg: AdamWConfig, params: List[torch.Tensor],
           grads: List[torch.Tensor], state: Dict[str, object], *,
           mesh=None, sharded: Optional[Sequence[bool]] = None
           ) -> Dict[str, torch.Tensor]:
    """One step, in place: ``params`` and ``state`` are updated.  Returns
    ``{"grad_norm", "lr"}`` (0-d float32 tensors).  ``mesh``/``sharded``:
    the clip scale from the global norm (``global_norm``)."""
    if not (len(params) == len(grads) == len(state["mu"])):
        raise ValueError(f"{len(params)} parameters, {len(grads)} gradients "
                         f"and {len(state['mu'])} moments")
    dev = params[0].device
    gnorm = global_norm(grads, mesh, sharded)
    scale = torch.where(gnorm > cfg.clip_norm,
                        cfg.clip_norm / (gnorm + 1e-9), _f32(1.0, dev))
    step = int(state["step"]) + 1
    lr = lr_at(cfg, step, dev)
    step32 = _f32(step, dev)
    b1c = 1.0 - torch.pow(_f32(cfg.b1, dev), step32)
    b2c = 1.0 - torch.pow(_f32(cfg.b2, dev), step32)
    for whole in zip(params, grads, state["mu"], state["nu"]):
        # elementwise, a piece at a time: the float32 temporaries of one
        # piece, not of a whole expert stack
        for p, g, m, v in pieces(*whole):
            g32 = g.float() * scale
            m.mul_(cfg.b1).add_((1 - cfg.b1) * g32)
            v.mul_(cfg.b2).add_((1 - cfg.b2) * torch.square(g32))
            del g32
            p32 = p.float()
            step_ = lr * (m / b1c / (torch.sqrt(v / b2c) + cfg.eps)
                          + cfg.weight_decay * p32)
            p.copy_((p32 - step_).to(p.dtype))
    state["step"] = step
    return {"grad_norm": gnorm, "lr": lr}
