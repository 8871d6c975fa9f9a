"""Feed-forward layers (port of ``repro/models/moe.py``): the SwiGLU FFN or
the two-matrix MLP, and mixture-of-experts.

Three MoE strategies, chosen by ``cfg.moe_impl``, each computing JAX's
function, dropped tokens included:

``dense``     every expert on every token, outputs combined with the router
              weights.  Exact (no token dropping).
``dispatch``  GShard grouped dispatch with a capacity per (group, expert):
              JAX contracts one-hot dispatch tensors; the port ranks each
              (token, choice) by a cumsum over the flattened (n, k) axis,
              scatters the kept rows into a (G, E, cap, d) buffer, runs the
              experts as batched products over E and gathers back.
``sort``      one global capacity per expert, tokens ordered by expert.

Routing selects the top k by a stable descending sort, so that among equal
probabilities the lower expert index comes first, as ``jax.lax.top_k``
does: a left-padded slot's hidden state is exactly 0, its router logits
are 0 and every expert ties.  Padding is routed (and takes capacity) as in
JAX.

The expert products are library GEMMs: the reference computes them outside
any Pallas kernel, so MoE has no kernel of its own.  The aux losses
(load balance and router z-loss), ``moe_expert_frac`` and ``moe_drop_frac``
go back to the caller.

``RouteLog`` records the routing of every MoE layer call, or replays a
recorded one, so that a check can run two models (card and CPU, bfloat16
and float32) on one routing.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.distributed.comm import copy_to_model

from .config import ModelConfig
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
    """The dense FFN.  On the mesh (a row-parallel ``w_down``) its input
    enters the model-parallel region through ``comm.copy_to_model``."""
    act = ACTIVATIONS[act_name]
    if p.w_down.reduce_group is not None:
        x = copy_to_model(x, p.w_down.reduce_group)
    if p.w_gate is not None:   # swiglu
        return apply_dense(p.w_down,
                           act(apply_dense(p.w_gate, x)) * apply_dense(p.w_up, x))
    return apply_dense(p.w_down, act(apply_dense(p.w_up, x)))


class MoE(nn.Module):
    """``{"router": Dense(d, E), "w_gate", "w_up": (E, d, ff), "w_down":
    (E, ff, d)[, "shared": FFN]}``, JAX's leaves and shapes."""

    def __init__(self, cfg: ModelConfig, *, dtype=torch.float32, device=None):
        super().__init__()
        E, d, ff = cfg.num_experts, cfg.d_model, cfg.resolved_moe_d_ff
        kw = dict(dtype=dtype, device=device)
        self.router = Dense(d, E, **kw)

        def stack(ins, outs):
            return nn.Parameter(torch.empty(E, ins, outs, **kw),
                                requires_grad=False)

        self.w_gate, self.w_up, self.w_down = stack(d, ff), stack(d, ff), \
            stack(ff, d)
        self.shared = (make_ffn(d, ff * cfg.num_shared_experts, **kw)
                       if cfg.num_shared_experts else None)

    def reset(self, generator: torch.Generator) -> None:
        """Each expert's matrix as ``make_dense`` draws it (truncated
        normal at 1/sqrt(fan-in)), one expert at a time so that the float32
        draw never holds a whole stack.  The router and the shared expert
        are containers of their own."""
        for w in (self.w_gate, self.w_up, self.w_down):
            scale = 1.0 / math.sqrt(w.shape[1])
            for e in range(w.shape[0]):
                t = torch.empty(w.shape[1:], dtype=torch.float32,
                                device=w.device)
                nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0,
                                      generator=generator)
                w[e].copy_(t * scale)


class RouteLog:
    """The expert choices of the ``_router`` calls made while it is active
    (``with RouteLog() as log:``): each call's (N, k) indices on the host,
    in call order.  Given ``replay`` (another log's ``calls``), call i
    routes by the i-th recorded indices in place of its own top k, each
    weighted by its own probability there, so that a rounding that tips a
    near tie one way in one run and the other way in another does not part
    them.  ``rerouted`` counts the tokens whose own top k the replay
    overrode.  A check's tool: it copies every call's indices to the host."""

    def __init__(self, replay: Optional[List[torch.Tensor]] = None):
        self.calls: List[torch.Tensor] = []
        self.replay = replay
        self.rerouted = 0

    def __enter__(self) -> "RouteLog":
        global _route_log
        if _route_log is not None:
            raise RuntimeError("a RouteLog is already active")
        _route_log = self
        return self

    def __exit__(self, *exc) -> None:
        global _route_log
        _route_log = None
        if exc[0] is None and self.replay is not None \
                and len(self.calls) != len(self.replay):
            raise RuntimeError(f"RouteLog replayed {len(self.calls)} of "
                               f"{len(self.replay)} recorded router calls")

    def route(self, idx: torch.Tensor) -> torch.Tensor:
        """The indices call ``len(self.calls)`` routes by (recorded)."""
        if self.replay is not None:
            i = len(self.calls)
            if i >= len(self.replay) or self.replay[i].shape != idx.shape:
                raise RuntimeError(f"RouteLog: router call {i} of shape "
                                   f"{tuple(idx.shape)} has no recorded twin")
            forced = self.replay[i].to(idx.device)
            self.rerouted += int((idx.sort(-1).values
                                  != forced.sort(-1).values).any(-1).sum())
            idx = forced
        self.calls.append(idx.cpu())
        return idx


_route_log: Optional[RouteLog] = None


def _router(p: MoE, cfg: ModelConfig, xf: torch.Tensor):
    """xf: (N, d) -> (weights (N, k) float32, idx (N, k) int64, aux)."""
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    logits = (xf @ p.router.kernel.to(xf.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    # the first k of a stable descending sort: lower index first among
    # equal probabilities, as jax.lax.top_k
    weights, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    weights, idx = weights[:, :k], idx[:, :k]
    if _route_log is not None:
        idx = _route_log.route(idx)
        weights = probs.gather(-1, idx)
    weights = weights / torch.clamp(weights.sum(-1, keepdim=True), min=1e-9)
    me = probs.mean(0)                                              # (E,)
    onehot = F.one_hot(idx, E).float()                              # (N,k,E)
    ce = onehot.sum(1).mean(0) / k                                  # (E,)
    aux = {"moe_lb_loss": E * torch.sum(me * ce),
           "moe_z_loss": torch.mean(torch.square(
               torch.logsumexp(logits, dim=-1))),
           "moe_expert_frac": ce}
    return weights, idx, aux


def _experts(p: MoE, xe: torch.Tensor, act_name: str) -> torch.Tensor:
    """xe: (..., E, C, d) -> (..., E, C, d) through each expert's SwiGLU."""
    act = ACTIVATIONS[act_name]
    dt = xe.dtype
    h = torch.einsum("...ecd,edf->...ecf", xe, p.w_gate.to(dt))
    u = torch.einsum("...ecd,edf->...ecf", xe, p.w_up.to(dt))
    return torch.einsum("...ecf,efd->...ecd", act(h) * u, p.w_down.to(dt))


def _combine(rows: torch.Tensor, w: torch.Tensor, n_tok: int, k: int,
             dtype) -> torch.Tensor:
    """rows (n_tok * k, d) expert outputs in token-major (token, choice)
    order, w (n_tok * k,) their weights (0 where dropped): each row times
    its weight cast to ``dtype`` (as JAX's combine tensor is), summed over
    the k choices in float32, then cast."""
    y = rows.float() * w.to(dtype).float()[:, None]
    return y.view(n_tok, k, -1).sum(1).to(dtype)


def _apply_moe_dense(p: MoE, cfg: ModelConfig, x):
    B, T, d = x.shape
    xf = x.reshape(-1, d)
    weights, idx, aux = _router(p, cfg, xf)
    act = ACTIVATIONS[cfg.act]
    dt = x.dtype
    h = torch.einsum("nd,edf->enf", xf, p.w_gate.to(dt))
    u = torch.einsum("nd,edf->enf", xf, p.w_up.to(dt))
    ye = torch.einsum("enf,efd->end", act(h) * u, p.w_down.to(dt))
    onehot = F.one_hot(idx, cfg.num_experts).to(dt)                 # (N,k,E)
    combine = torch.einsum("nke,nk->en", onehot, weights.to(dt))
    y = torch.einsum("end,en->nd", ye, combine)
    return y.reshape(B, T, d), aux


def dispatch_groups(cfg: ModelConfig, B: int, T: int) -> Tuple[int, int, int]:
    """(G groups, n tokens a group, capacity per (group, expert)) as
    JAX's ``_apply_moe_dispatch`` sizes them: G = ``moe_groups`` or B,
    lowered until it divides B * T."""
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    G = min(cfg.moe_groups or B, B * T)
    while (B * T) % G:
        G -= 1
    n = (B * T) // G
    cap = min(max(1, int(math.ceil(k * n / E * cfg.capacity_factor))), k * n)
    return G, n, cap


def _apply_moe_dispatch(p: MoE, cfg: ModelConfig, x):
    """GShard grouped dispatch with indices: the rank of (token i, choice j)
    among its group's assignments to the same expert, in token-major (n, k)
    order, decides whether it fits the expert's ``cap`` rows; kept rows are
    scattered into a (G, E, cap, d) buffer (dropped ones into a spare row
    past its end, never read), the experts run on the buffer, and each
    assignment's output row is gathered back and weighted (0 if dropped).
    A token counts as kept if any of its k assignments is."""
    B, T, d = x.shape
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    xf = x.reshape(-1, d)
    weights, idx, aux = _router(p, cfg, xf)
    G, n, cap = dispatch_groups(cfg, B, T)
    eid = idx.reshape(G, n * k)                                     # (G, nk)
    onehot = F.one_hot(eid, E)                                      # int64
    rank = (torch.cumsum(onehot, dim=1) - onehot).gather(
        2, eid[..., None])[..., 0]                                  # (G, nk)
    keep = rank < cap
    g = torch.arange(G, device=x.device)[:, None]
    spare = G * E * cap
    dest = torch.where(keep, (g * E + eid) * cap + rank,
                       torch.full_like(rank, spare)).reshape(-1)
    src = xf.repeat_interleave(k, dim=0)                            # (N*k, d)
    buf = xf.new_zeros(spare + 1, d).index_copy(0, dest, src)
    ye = _experts(p, buf[:spare].view(G, E, cap, d), cfg.act)
    rows = ye.reshape(spare, d)[dest.clamp(max=spare - 1)]
    w = weights.reshape(-1) * keep.reshape(-1)
    y = _combine(rows, w, B * T, k, x.dtype)
    kept_tok = keep.view(G, n, k).any(-1)
    aux["moe_drop_frac"] = 1.0 - kept_tok.float().mean()
    return y.reshape(B, T, d), aux


def _apply_moe_sort(p: MoE, cfg: ModelConfig, x):
    """One global capacity: assignments ordered by expert (stably, so
    token-major within an expert), the first ``cap`` of each expert kept.
    JAX writes the dropped assignments' zero rows to slot ``cap - 1`` of
    their expert after the kept one there (a scatter whose last write
    wins), so an expert that overflows computes 0 for the row it kept last;
    the port computes that function.  ``moe_drop_frac`` counts dropped
    assignments, as JAX does (the overwritten row counts as kept)."""
    B, T, d = x.shape
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    xf = x.reshape(-1, d)
    N = xf.shape[0]
    weights, idx, aux = _router(p, cfg, xf)
    cap = min(max(1, int(math.ceil(k * N / E * cfg.capacity_factor))), k * N)
    eid = idx.reshape(-1)                                           # (N*k,)
    onehot = F.one_hot(eid, E)
    rank = (torch.cumsum(onehot, dim=0) - onehot).gather(
        1, eid[:, None])[:, 0]
    counts = onehot.sum(0)
    keep = rank < cap
    live = keep & ~((rank == cap - 1) & (counts[eid] > cap))
    spare = E * cap
    dest = torch.where(live, eid * cap + rank, torch.full_like(rank, spare))
    buf = xf.new_zeros(spare + 1, d).index_copy(
        0, dest, xf.repeat_interleave(k, dim=0))
    ye = _experts(p, buf[:spare].view(E, cap, d), cfg.act)
    rows = ye.reshape(spare, d)[dest.clamp(max=spare - 1)]
    y = _combine(rows, weights.reshape(-1) * live, N, k, x.dtype)
    aux["moe_drop_frac"] = 1.0 - keep.float().mean()
    return y.reshape(B, T, d), aux


def apply_moe(p: MoE, cfg: ModelConfig, x) -> Tuple[torch.Tensor,
                                                    Dict[str, torch.Tensor]]:
    """x: (B, T, d).  Returns (y (B, T, d), aux)."""
    if cfg.moe_impl == "dispatch":
        y, aux = _apply_moe_dispatch(p, cfg, x)
    elif cfg.moe_impl == "sort":
        y, aux = _apply_moe_sort(p, cfg, x)
    else:
        y, aux = _apply_moe_dense(p, cfg, x)
    if p.shared is not None:
        y = y + apply_ffn(p.shared, x, cfg.act)
    return y, aux
