"""Step functions of the port (port of ``repro/launch/steps.py``).

- ``make_train_step``: forward + cross entropy (+ a MoE trunk's router
  losses) + backward + AdamW, with the naive or the vocabulary-chunked
  cross entropy and microbatch accumulation.
- ``make_verify_step``: teacher-forced log-probs over a full batch (the
  prefill-shaped SPEC-RL verification pass) and each row's first
  rejection through the ``spec_verify`` kernel.
- ``make_serve_step``: one decode step against the caches.

JAX's steps are pure functions of a params tree; the port's take an
``LM`` and update it (and the AdamW state) in place, returning them as
JAX returns its new ones.  They run in one process for every family.

``mesh=`` (GQA attention with dense FFN or MoE layers,
``distributed/mesh.py``): the model is one cut by ``shard_params`` and
the batch arguments are the whole batch on every rank.  Each data rank
runs its rows (``mesh.LossRows``); the cross entropy divides by the whole
(micro)batch's token count and a MoE trunk's router losses are the whole
(micro)batch's (``LossRows.router_loss``), so the gradients need only
``LossRows.finish`` and the loss ``LossRows.sum``, and AdamW clips by the
global norm.  The verify
and serve steps gather their outputs over the data group.
"""
from __future__ import annotations

from typing import Dict

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed.mesh import DataRows, LossRows, cut_flags
from repro_torch.distributed.shard_wrap import sharded_spec_verify
from repro_torch.engine.sampling import logprobs_of
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adamw


def _ce_mask(tokens, positions):
    """The target mask of each position t (token t + 1 exists and is not
    padding), over the token slots of ``positions`` (a vision prefix's
    positions come first)."""
    pos_t = positions[..., -tokens.shape[1]:]
    return torch.cat([pos_t[:, 1:] >= 0, torch.zeros_like(pos_t[:, :1],
                                                          dtype=torch.bool)],
                     dim=1).float()


def _ce_naive_sum(logits, tokens, positions):
    """The summed negative log-likelihood of each next token and the count
    of targets (JAX's ``_ce_naive`` is their quotient, at least 1)."""
    logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
    tgt = tokens[:, 1:].long()
    nll = -torch.gather(logp, -1, tgt[..., None])[..., 0]
    mask = _ce_mask(tokens, positions)[:, :-1]
    return (nll * mask).sum(), mask.sum()


def _chunks(T: int, chunk: int) -> int:
    chunk = min(chunk, T)
    while T % chunk:
        chunk -= 1
    return chunk


def _chunk_nll(model, cfg, h, t, m):
    logits = M._logits(model, cfg, h)                   # (B, chunk, V) f32
    lse = torch.logsumexp(logits, dim=-1)
    tl = torch.gather(logits, -1, t[..., None].long())[..., 0]
    return ((lse - tl) * m).sum()


def _ce_chunked_sum(model, cfg: ModelConfig, hidden, tokens, positions,
                    chunk: int = 1024):
    """Vocabulary-chunked cross entropy (JAX's ``_ce_chunked``): the head,
    logsumexp and target gather run per T-chunk and are recomputed in the
    backward (``torch.utils.checkpoint``), so at most (B, chunk, V) logits
    live at once.  Returns the summed loss and the count of targets (JAX's
    ``_ce_chunked`` is their quotient, at least 1)."""
    B, T, _ = hidden.shape
    tgt = torch.cat([tokens[:, 1:], torch.zeros_like(tokens[:, :1])], dim=1)
    mask = _ce_mask(tokens, positions)
    chunk = _chunks(T, chunk)
    total = hidden.new_zeros((), dtype=torch.float32)
    for lo in range(0, T, chunk):
        sl = slice(lo, lo + chunk)
        args = (hidden[:, sl], tgt[:, sl], mask[:, sl])
        if torch.is_grad_enabled() and hidden.requires_grad:
            total = total + checkpoint(_chunk_nll, model, cfg, *args,
                                       use_reentrant=False)
        else:
            total = total + _chunk_nll(model, cfg, *args)
    return total, mask.sum()


def _on(model, x, dtype=None):
    return x if x is None else torch.as_tensor(x, dtype=dtype,
                                               device=model.device)


def make_train_step(cfg: ModelConfig, ocfg: adamw.AdamWConfig, *,
                    ce_impl: str = "naive", ce_chunk: int = 1024,
                    microbatch: int = 1, accum_dtype: str = "float32",
                    mesh=None):
    """``train_step(model, opt_state, tokens, positions, **extras) ->
    (model, opt_state, loss, grad_norm)``: one AdamW step of ``model`` (in
    place) on the next-token cross entropy.  ``microbatch`` > 1 splits the
    batch into that many microbatches whose gradients accumulate in
    ``accum_dtype`` and are averaged, as the loss is (JAX's scan).
    ``opt_state`` is ``adamw.init`` of the model's parameters."""
    adt = getattr(torch, accum_dtype)

    def loss_parts(model, tokens, positions, extras, stats):
        if ce_impl == "chunked":
            hidden, aux = M.hidden_states(model, cfg, tokens, positions,
                                          router_stats=stats, **extras)
            s, _ = _ce_chunked_sum(model, cfg, hidden, tokens, positions,
                                   ce_chunk)
        else:
            logits, aux = M.forward(model, cfg, tokens, positions,
                                    router_stats=stats, **extras)
            s, _ = _ce_naive_sum(logits, tokens, positions)
        return s, aux

    def micro(model, params, tokens, positions, extras):
        """One (micro)batch's loss and finished gradients."""
        rows = LossRows(mesh, tokens.shape[0])
        count = torch.clamp_min(
            _ce_mask(tokens, positions)[:, :-1].sum(), 1.0)
        stats = []
        for p in params:
            p.requires_grad_(True)
        try:
            s, aux = loss_parts(model, rows.take(tokens),
                                rows.take(positions),
                                {k: rows.take(v) for k, v in extras.items()},
                                stats)
            loss = s / count
            if "moe_lb_loss" in aux:
                loss = loss + rows.router_loss(cfg, aux, stats)[0]
            loss.backward()
        finally:
            for p in params:
                p.requires_grad_(False)
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params]
        for p in params:
            p.grad = None
        rows.finish(model, grads)
        return rows.sum({"loss": loss.detach()})["loss"], grads

    def train_step(model, opt_state, tokens, positions, **extras):
        params = list(model.parameters())
        tokens = _on(model, tokens, torch.int32)
        positions = _on(model, positions, torch.int32)
        extras = {k: _on(model, v) for k, v in extras.items()}
        if microbatch > 1:
            B = tokens.shape[0]
            n = B // microbatch
            acc = [torch.zeros(p.shape, dtype=adt, device=p.device)
                   for p in params]
            losses = []
            for i in range(microbatch):
                sl = slice(i * n, (i + 1) * n)
                loss_i, g = micro(model, params, tokens[sl], positions[sl],
                                  {k: v[sl] for k, v in extras.items()})
                for a, gi in zip(acc, g):
                    a.add_(gi.to(adt))
                losses.append(loss_i.float())
            grads = [a / microbatch for a in acc]
            loss = torch.stack(losses).mean()
        else:
            loss, grads = micro(model, params, tokens, positions, extras)
        info = adamw.update(ocfg, params, grads, opt_state, mesh=mesh,
                            sharded=cut_flags(model))
        return model, opt_state, loss, info["grad_norm"]

    return train_step


def _score_chunked(model, cfg: ModelConfig, hidden, tokens,
                   chunk: int = 1024):
    """Chunked log-prob extraction (JAX's ``_score_chunked``): the head,
    log-softmax and gather per T-chunk; column t holds token t's log-prob
    (column 0 is 0)."""
    B, T, _ = hidden.shape
    tgt = torch.cat([tokens[:, 1:], torch.zeros_like(tokens[:, :1])], dim=1)
    chunk = _chunks(T, chunk)
    parts = []
    for lo in range(0, T, chunk):
        logits = M._logits(model, cfg, hidden[:, lo:lo + chunk])
        lse = torch.logsumexp(logits, dim=-1)
        tl = torch.gather(logits, -1,
                          tgt[:, lo:lo + chunk, None].long())[..., 0]
        parts.append(tl - lse)
    lp_next = torch.cat(parts, dim=1)                  # lp of token t+1 at t
    return torch.cat([torch.zeros_like(lp_next[:, :1]), lp_next[:, :-1]],
                     dim=1)


def make_verify_step(cfg: ModelConfig, *, score_impl: str = "naive",
                     score_chunk: int = 1024, mesh=None):
    """``verify_step(model, tokens, positions, draft_logprobs, u,
    draft_len, log_lenience, **extras) -> (n, lp)``: one scoring pass over
    prompt ⊕ draft (no grad; the attention kernels on the card), then each
    row's first rejection through the ``spec_verify`` kernel (JAX's step
    calls its oracle)."""
    @torch.no_grad()
    def verify_step(model, tokens, positions, draft_logprobs, u, draft_len,
                    log_lenience, **extras):
        tokens = _on(model, tokens, torch.int32)
        positions = _on(model, positions, torch.int32)
        rows = DataRows(mesh, tokens.shape[0])
        t, pz = rows.take(tokens), rows.take(positions)
        ex = {k: rows.take(_on(model, v)) for k, v in extras.items()}
        if score_impl == "chunked":
            hidden, _ = M.hidden_states(model, cfg, t, pz, **ex)
            lp = _score_chunked(model, cfg, hidden, t, score_chunk)
        else:
            logits, _ = M.forward(model, cfg, t, pz, **ex)
            lp = logprobs_of(logits[:, :-1], t[:, 1:])
            lp = torch.cat([torch.zeros_like(lp[:, :1]), lp], dim=1)
        lp = rows.gather(lp.float().contiguous())
        dlp = _on(model, draft_logprobs, torch.float32).contiguous()
        u = _on(model, u, torch.float32).contiguous()
        dlen = _on(model, draft_len, torch.int32).contiguous()
        n = sharded_spec_verify(mesh, lp, dlp, u, dlen, float(log_lenience))
        return n, lp

    return verify_step


def make_serve_step(cfg: ModelConfig, *, mesh=None):
    """``serve_step(model, token, position, caches, cache_start, **extras)
    -> (logits, caches)``: one ``decode_step``.  On the mesh ``caches``
    hold this data rank's rows and KV heads (``mesh.shard_caches``) and
    the logits come back whole."""
    def serve_step(model, token, position, caches, cache_start,
                   **extras) -> tuple:
        token = _on(model, token, torch.int32)
        position = _on(model, position, torch.int32)
        rows = DataRows(mesh, token.shape[0])
        start = cache_start if isinstance(cache_start, int) else \
            rows.take(_on(model, cache_start, torch.int32))
        ex: Dict = {k: rows.take(_on(model, v)) for k, v in extras.items()}
        logits, caches = M.decode_step(model, cfg, rows.take(token),
                                       rows.take(position), caches, start,
                                       **ex)
        return rows.gather(logits.contiguous()), caches

    return serve_step
