"""Clipped-surrogate policy loss, critic loss, KL penalty, diagnostics
(port of ``repro/rl/losses.py``).

Covers GRPO / PPO (clip 0.2, c=3) and DAPO (asymmetric clip high=0.28,
c=10, token-level aggregation) per Appendix A.1.  Plain functions on
tensors; they carry the graph of their inputs.  ``torch.minimum`` and
``torch.maximum`` split the gradient at ties as ``jnp`` does, which matters
at the first update, where the ratio is 1 and both surrogates tie.

On the mesh each data rank holds some rows of the batch, and the means
are the whole batch's: ``count`` (the whole batch's mask count) and
``rows`` (its row count) replace the rank's own, so a rank's loss and
diagnostics are its share of the whole batch's and their sum over the
data group is the one-device value (``rl/trainer.py`` sums them).  With
neither given a mean is over the tensors it is handed, as in JAX.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import torch


@dataclass(frozen=True)
class PolicyLossConfig:
    clip_low: float = 0.2
    clip_high: float = 0.2
    clip_c: float = 3.0               # dual-clip constant (DAPO c=10)
    agg: str = "seq"                  # seq (GRPO/PPO) | token (DAPO)
    kl_coef: float = 0.0              # GRPO: 1e-4 vs reference policy
    entropy_coef: float = 0.0


def masked_mean(x, mask, axis=None, eps: float = 1e-8, count=None):
    """The mean of ``x`` over ``mask``; ``count`` (with ``axis`` None)
    divides in place of the mask's own count."""
    m = mask.float()
    if axis is None:
        den = m.sum() if count is None else torch.as_tensor(
            count, dtype=torch.float32, device=m.device)
        return (x * m).sum() / torch.clamp_min(den, eps)
    return (x * m).sum(axis) / torch.clamp_min(m.sum(axis), eps)


def policy_loss(lp_new, lp_old, advantages, mask, cfg: PolicyLossConfig,
                *, count=None, rows=None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """PPO-style clipped surrogate.

    lp_new/lp_old: (B, N) token log-probs; advantages: (B, N); mask: (B, N).
    ``count``/``rows``: the whole batch's mask count and rows (module
    docstring).
    """
    ratio = torch.exp(lp_new - lp_old)
    clipped = torch.clamp(ratio, 1.0 - cfg.clip_low, 1.0 + cfg.clip_high)
    s1 = ratio * advantages
    s2 = clipped * advantages
    surrogate = torch.minimum(s1, s2)
    # dual clip (large negative advantage protection)
    surrogate = torch.where(advantages < 0,
                            torch.maximum(surrogate, cfg.clip_c * advantages),
                            surrogate)
    if cfg.agg == "token":
        loss = -masked_mean(surrogate, mask, count=count)
    else:  # per-sequence mean, then batch mean
        seq = masked_mean(surrogate, mask, axis=1)
        loss = -(seq.mean() if rows is None else seq.sum() / rows)
    with torch.no_grad():
        clip_frac = masked_mean(
            (torch.abs(ratio - 1.0) > min(cfg.clip_low, cfg.clip_high))
            .float(), mask, count=count)
        # E[log p_old/p_new]
        approx_kl = masked_mean(lp_old - lp_new, mask, count=count)
        ratio_mean = masked_mean(ratio, mask, count=count)
    return loss, {"clip_frac": clip_frac, "approx_kl": approx_kl,
                  "ratio_mean": ratio_mean}


def kl_to_reference(lp_new, lp_ref, mask, count=None):
    """k3 estimator of KL(pi || ref): exp(r) - r - 1, r = lp_ref - lp_new."""
    r = lp_ref - lp_new
    return masked_mean(torch.exp(r) - r - 1.0, mask, count=count)


def value_loss(values, returns, old_values, mask, clip: float = 0.2,
               count=None):
    v_clip = old_values + torch.clamp(values - old_values, -clip, clip)
    l1 = torch.square(values - returns)
    l2 = torch.square(v_clip - returns)
    return 0.5 * masked_mean(torch.maximum(l1, l2), mask, count=count)


def entropy_bonus(entropy, mask, count=None):
    return masked_mean(entropy, mask, count=count)
