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
and float32, one process and the mesh) on one routing.

**On the mesh** (``distributed/mesh.py:shard_params``), a MoE's experts
are cut over the model group by JAX's rules: expert-parallel (a rank holds
E/m whole experts, ``expert_lo`` the first) when the axis divides E, else
tensor-parallel on ``d_ff`` (every expert, a slice of its hidden units),
else whole (no ``expert_group``: nothing is summed).  Every model rank
holds the same tokens, so it computes the whole routing, the whole
capacity ranks and the whole aux; it then runs only its experts' rows (or
its ``d_ff`` slice) and the output is summed by reduce-from-model.  The
experts' input and the combine weights enter that region through
copy-to-model, so the router's gradient comes out whole on every rank:
its share through the weights is summed there, and its share through the
aux losses, which every rank computes whole, is not.  The router is thus
outside ``region_params`` and nothing is summed for it afterwards.

``router_stats`` (a list) collects each layer's router mean ``me`` (with
its graph) and routed fraction ``ce``, from which ``LossRows.router_loss``
makes the whole batch's load-balance loss on a data-sharded batch.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.distributed.comm import copy_to_model, reduce_from_model

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
        # the mesh's cut (module docstring): the model group the partial
        # outputs are summed over, and the first expert this rank holds
        self.expert_group = None
        self.expert_lo = 0

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
    overrode, and ``moved`` holds each replayed call's (N,) mask of them.
    ``margins`` holds each call's (N,) gap between the k-th and
    the (k+1)-th largest router probability of each token (its own, before
    a replay): how near its choice came to another expert.  ``rows`` =
    (lo, hi, batch): the log runs on a data rank's rows [lo, hi) of a batch
    of ``batch`` rows, so each recorded call, whole, hands it those rows.
    A check's tool: it copies every call's indices to the host."""

    def __init__(self, replay: Optional[List[torch.Tensor]] = None, *,
                 rows: Optional[Tuple[int, int, int]] = None):
        self.calls: List[torch.Tensor] = []
        self.margins: List[torch.Tensor] = []
        self.moved: List[torch.Tensor] = []
        self.replay = replay
        self.rows = rows
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

    def route(self, idx: torch.Tensor, probs: torch.Tensor) -> torch.Tensor:
        """The indices call ``len(self.calls)`` routes by (recorded)."""
        k = idx.shape[-1]
        if probs.shape[-1] > k:
            top = probs.topk(k + 1, dim=-1).values
            self.margins.append((top[:, k - 1] - top[:, k]).cpu())
        if self.replay is not None:
            i = len(self.calls)
            forced = self.replay[i] if i < len(self.replay) else None
            if forced is not None and self.rows is not None:
                lo, hi, batch = self.rows
                forced = forced.reshape(batch, -1, k)[lo:hi].reshape(-1, k)
            if forced is None or forced.shape != idx.shape:
                raise RuntimeError(f"RouteLog: router call {i} of shape "
                                   f"{tuple(idx.shape)} has no recorded twin")
            forced = forced.to(idx.device)
            moved = (idx.sort(-1).values
                     != forced.sort(-1).values).any(-1).cpu()
            self.moved.append(moved)
            self.rerouted += int(moved.sum())
            idx = forced
        self.calls.append(idx.cpu())
        return idx


_route_log: Optional[RouteLog] = None


def _router(p: MoE, cfg: ModelConfig, xf: torch.Tensor, stats=None):
    """xf: (N, d) -> (weights (N, k) float32, idx (N, k) int64, aux).
    ``stats``: a list that takes this layer's ``{"me", "ce"}``."""
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    logits = (xf @ p.router.kernel.to(xf.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    # the first k of a stable descending sort: lower index first among
    # equal probabilities, as jax.lax.top_k
    weights, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    weights, idx = weights[:, :k], idx[:, :k]
    if _route_log is not None:
        idx = _route_log.route(idx, probs)
        weights = probs.gather(-1, idx)
    weights = weights / torch.clamp(weights.sum(-1, keepdim=True), min=1e-9)
    me = probs.mean(0)                                              # (E,)
    onehot = F.one_hot(idx, E).float()                              # (N,k,E)
    ce = onehot.sum(1).mean(0) / k                                  # (E,)
    aux = {"moe_lb_loss": E * torch.sum(me * ce),
           "moe_z_loss": torch.mean(torch.square(
               torch.logsumexp(logits, dim=-1))),
           "moe_expert_frac": ce}
    if stats is not None:
        stats.append({"me": me, "ce": ce})
    return weights, idx, aux


class _Local:
    """This rank's part of a MoE layer on the mesh (module docstring):
    its experts [lo, lo + E_l), the inputs of the experts' region (``x``)
    and the combine weights, through copy-to-model on a cut layer.  On an
    uncut layer lo = 0, E_l = E and both are the layer's own."""

    def __init__(self, p: MoE, xf: torch.Tensor, weights: torch.Tensor):
        self.group = p.expert_group
        self.lo, self.n = p.expert_lo, p.w_gate.shape[0]
        self.x, self.weights = xf, weights
        if self.group is not None:
            self.x = copy_to_model(xf, self.group)
            self.weights = copy_to_model(weights, self.group)

    def mine(self, eid: torch.Tensor) -> torch.Tensor:
        """Whether each global expert id is one of this rank's."""
        return (eid >= self.lo) & (eid < self.lo + self.n)

    def out(self, y: torch.Tensor) -> torch.Tensor:
        """A partial output summed over the model group (reduce-from-
        model); the output itself on an uncut layer."""
        return y if self.group is None else reduce_from_model(y, self.group)


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


def _apply_moe_dense(p: MoE, cfg: ModelConfig, x, stats=None):
    B, T, d = x.shape
    xf = x.reshape(-1, d)
    weights, idx, aux = _router(p, cfg, xf, stats)
    loc = _Local(p, xf, weights)
    act = ACTIVATIONS[cfg.act]
    dt = x.dtype
    h = torch.einsum("nd,edf->enf", loc.x, p.w_gate.to(dt))
    u = torch.einsum("nd,edf->enf", loc.x, p.w_up.to(dt))
    ye = torch.einsum("enf,efd->end", act(h) * u, p.w_down.to(dt))
    onehot = F.one_hot(idx, cfg.num_experts).to(dt)[
        ..., loc.lo:loc.lo + loc.n]                                 # (N,k,E_l)
    combine = torch.einsum("nke,nk->en", onehot, loc.weights.to(dt))
    y = torch.einsum("end,en->nd", ye, combine)
    return loc.out(y).reshape(B, T, d), aux


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


def _apply_moe_dispatch(p: MoE, cfg: ModelConfig, x, stats=None):
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
    weights, idx, aux = _router(p, cfg, xf, stats)
    loc = _Local(p, xf, weights)
    G, n, cap = dispatch_groups(cfg, B, T)
    eid = idx.reshape(G, n * k)                                     # (G, nk)
    onehot = F.one_hot(eid, E)                                      # int64
    rank = (torch.cumsum(onehot, dim=1) - onehot).gather(
        2, eid[..., None])[..., 0]                                  # (G, nk)
    keep = rank < cap
    # this rank's kept rows, in a buffer of its own E_l experts
    here = keep & loc.mine(eid)
    g = torch.arange(G, device=x.device)[:, None]
    spare = G * loc.n * cap
    dest = torch.where(here, (g * loc.n + eid - loc.lo) * cap + rank,
                       torch.full_like(rank, spare)).reshape(-1)
    src = loc.x.repeat_interleave(k, dim=0)                         # (N*k, d)
    buf = xf.new_zeros(spare + 1, d).index_copy(0, dest, src)
    ye = _experts(p, buf[:spare].view(G, loc.n, cap, d), cfg.act)
    rows = ye.reshape(spare, d)[dest.clamp(max=spare - 1)]
    w = loc.weights.reshape(-1) * here.reshape(-1)
    y = loc.out(_combine(rows, w, B * T, k, x.dtype))
    kept_tok = keep.view(G, n, k).any(-1)
    aux["moe_drop_frac"] = 1.0 - kept_tok.float().mean()
    return y.reshape(B, T, d), aux


def _apply_moe_sort(p: MoE, cfg: ModelConfig, x, stats=None):
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
    weights, idx, aux = _router(p, cfg, xf, stats)
    loc = _Local(p, xf, weights)
    cap = min(max(1, int(math.ceil(k * N / E * cfg.capacity_factor))), k * N)
    eid = idx.reshape(-1)                                           # (N*k,)
    onehot = F.one_hot(eid, E)
    rank = (torch.cumsum(onehot, dim=0) - onehot).gather(
        1, eid[:, None])[:, 0]
    counts = onehot.sum(0)
    keep = rank < cap
    live = keep & ~((rank == cap - 1) & (counts[eid] > cap)) & loc.mine(eid)
    spare = loc.n * cap
    dest = torch.where(live, (eid - loc.lo) * cap + rank,
                       torch.full_like(rank, spare))
    buf = xf.new_zeros(spare + 1, d).index_copy(
        0, dest, loc.x.repeat_interleave(k, dim=0))
    ye = _experts(p, buf[:spare].view(loc.n, cap, d), cfg.act)
    rows = ye.reshape(spare, d)[dest.clamp(max=spare - 1)]
    y = loc.out(_combine(rows, loc.weights.reshape(-1) * live, N, k,
                         x.dtype))
    aux["moe_drop_frac"] = 1.0 - keep.float().mean()
    return y.reshape(B, T, d), aux


def apply_moe(p: MoE, cfg: ModelConfig, x, stats=None
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (B, T, d).  Returns (y (B, T, d), aux).  ``stats``: as
    ``_router``'s."""
    if cfg.moe_impl == "dispatch":
        y, aux = _apply_moe_dispatch(p, cfg, x, stats)
    elif cfg.moe_impl == "sort":
        y, aux = _apply_moe_sort(p, cfg, x, stats)
    else:
        y, aux = _apply_moe_dense(p, cfg, x, stats)
    if p.shared is not None:
        y = y + apply_ffn(p.shared, x, cfg.act)
    return y, aux
