"""Advantage estimators: GAE (PPO), group-relative (GRPO), DAPO (port of
``repro/rl/advantages.py``).

All return token-level advantages (B, N) masked by the response mask.
The task is bandit-like (single terminal verifiable reward), mirroring the
paper's RLVR setting.  On the mesh every data rank holds the whole rolled-out
batch, so the trainer takes the advantages (GRPO's groups, GAE, ``whiten``'s
mean and variance) over the whole batch and only then its rows.
"""
from __future__ import annotations

import torch


def group_relative_advantages(rewards, group_size: int, *, use_std: bool = True,
                              eps: float = 1e-6):
    """GRPO: z-score within each group of ``group_size`` rollouts.

    rewards: (B,) with B = num_prompts * group_size, groups contiguous.
    Returns (B,) scalar advantages (broadcast over tokens by the caller).
    The std is the population one (``jnp.std``'s ddof 0)."""
    B = rewards.shape[0]
    g = rewards.reshape(B // group_size, group_size)
    mean = g.mean(dim=1, keepdim=True)
    adv = g - mean
    if use_std:
        adv = adv / (g.std(dim=1, keepdim=True, correction=0) + eps)
    return adv.reshape(B)


def gae_advantages(rewards_tok, values, mask, *, gamma: float = 1.0,
                   lam: float = 0.95):
    """PPO GAE over token sequences.

    rewards_tok: (B, N) per-token rewards (terminal reward at last valid
    token); values: (B, N) critic estimates; mask: (B, N) response validity.
    Returns (advantages (B, N), returns (B, N)).  JAX's right-to-left
    ``lax.scan`` is a loop over N here: advantage_t = delta_t + gamma * lam
    * advantage_{t+1}, cut where no next token exists.
    """
    B, N = rewards_tok.shape
    m = mask.float()
    v = values * m
    # v_{t+1}: next valid value, 0 beyond the end
    v_next = torch.cat([v[:, 1:], torch.zeros_like(v[:, :1])], dim=1)
    delta = (rewards_tok + gamma * v_next - v) * m
    # mask of "next token exists"
    m_next = torch.cat([m[:, 1:], torch.zeros_like(m[:, :1])], dim=1)
    carry = torch.zeros((B,), dtype=torch.float32, device=rewards_tok.device)
    cols = [None] * N
    for t in range(N - 1, -1, -1):
        carry = delta[:, t] + gamma * lam * m_next[:, t] * carry
        cols[t] = carry
    adv = (torch.stack(cols, dim=1) if N else torch.zeros_like(delta)) * m
    returns = adv + v
    return adv, returns


def terminal_reward_to_tokens(rewards, lengths, N: int):
    """Place the scalar reward at the last generated token: (B,) -> (B, N)."""
    j = torch.arange(N, dtype=torch.int32, device=rewards.device)[None, :]
    last = torch.clamp_min(lengths - 1, 0)[:, None]
    return torch.where(j == last, rewards[:, None],
                       torch.zeros((), dtype=rewards.dtype,
                                   device=rewards.device))


def whiten(adv, mask, eps: float = 1e-6):
    m = mask.float()
    count = torch.clamp_min(m.sum(), 1.0)
    mean = (adv * m).sum() / count
    var = ((adv - mean) ** 2 * m).sum() / count
    return (adv - mean) * m / torch.sqrt(var + eps)
