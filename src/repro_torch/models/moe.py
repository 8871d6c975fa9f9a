"""Feed-forward layer (port of the dense part of ``repro/models/moe.py``):
the SwiGLU FFN, or the two-matrix MLP.  Mixture-of-experts waits for the
slice that ports the other model families."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Dense, apply_dense

ACTIVATIONS = {"silu": F.silu, "gelu": lambda x: F.gelu(x, approximate="tanh"),
               "relu": F.relu}


class FFN(nn.Module):
    """``{"w_gate"?, "w_up", "w_down"}``, each a ``Dense``."""

    def __init__(self, d: int, ff: int, *, kind: str = "swiglu",
                 dtype=torch.float32, device=None):
        super().__init__()
        self.w_up = Dense(d, ff, dtype=dtype, device=device)
        self.w_down = Dense(ff, d, scale=1.0 / math.sqrt(ff), dtype=dtype,
                            device=device)
        self.w_gate = (Dense(d, ff, dtype=dtype, device=device)
                       if kind == "swiglu" else None)


def make_ffn(d: int, ff: int, *, kind: str = "swiglu", dtype=torch.float32,
             device=None) -> FFN:
    return FFN(d, ff, kind=kind, dtype=dtype, device=device)


def apply_ffn(p: FFN, x: torch.Tensor, act_name: str = "silu"
              ) -> torch.Tensor:
    act = ACTIVATIONS[act_name]
    if p.w_gate is not None:   # swiglu
        return apply_dense(p.w_down,
                           act(apply_dense(p.w_gate, x)) * apply_dense(p.w_up, x))
    return apply_dense(p.w_down, act(apply_dense(p.w_up, x)))
