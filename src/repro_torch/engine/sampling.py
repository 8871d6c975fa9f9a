"""Token sampling (port of ``repro/engine/sampling.py``): temperature and
nucleus (top-p), returning the log-prob of the sampled token under the
adjusted distribution (SPEC-RL's acceptance ratio needs exactly that).

Random keys are a small protocol instead of JAX's key arrays:

* ``split_key(key) -> (key, sub)`` calls ``key.split()``;
* ``key.gumbel(shape)`` and ``key.uniform(shape)`` draw float32 noise on the
  key's device.

``jax.random.categorical(key, logp)`` is exactly
``argmax(logp + gumbel(key, logp.shape))``, so ``sample`` draws that way: a
key that wraps a JAX key and draws with ``jax.random`` (the tests define
one) makes the sampled tokens identical to the reference.  The port's own
``Key`` wraps a ``torch.Generator`` on the device, seeded from an integer;
``split`` derives the two child seeds deterministically (splitmix64), so a
seed fixes the whole stream.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

from repro_torch.device import DeviceLike, resolve_device

NEG_INF = -1e30
_MASK64 = (1 << 64) - 1
_TINY = torch.finfo(torch.float32).tiny


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


class Key:
    """Counter-free random key: an integer seed on a device."""

    def __init__(self, seed: int, device: torch.device):
        self.seed = int(seed) & _MASK64
        self.device = torch.device(device)

    def split(self) -> Tuple["Key", "Key"]:
        return (Key(_splitmix64(2 * self.seed), self.device),
                Key(_splitmix64(2 * self.seed + 1), self.device))

    def _generator(self) -> torch.Generator:
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.seed >> 1)      # manual_seed takes 63 bits
        return gen

    def uniform(self, shape: Sequence[int]) -> torch.Tensor:
        return torch.rand(tuple(shape), generator=self._generator(),
                          dtype=torch.float32, device=self.device)

    def gumbel(self, shape: Sequence[int]) -> torch.Tensor:
        u = self.uniform(shape).clamp_min_(_TINY)
        return -torch.log(-torch.log(u))


def make_key(seed: int, device: DeviceLike = None) -> Key:
    """A key on ``device`` (the card unless ``device="cpu"``)."""
    return Key(seed, resolve_device(device))


def split_key(key):
    return key.split()


def adjust_logits(logits: torch.Tensor, temperature: float = 1.0,
                  top_p: float = 1.0) -> torch.Tensor:
    """Renormalised log-probs of the sampling distribution. logits: (..., V)
    float32."""
    if temperature != 1.0:
        logits = logits / max(temperature, 1e-6)
    logp = torch.log_softmax(logits, dim=-1)
    if top_p < 1.0:
        sorted_lp = torch.sort(logp, dim=-1, descending=True).values
        probs = torch.exp(sorted_lp)
        cum = torch.cumsum(probs, dim=-1)
        # keep the smallest set whose mass >= top_p (always keep argmax)
        keep_sorted = (cum - probs) < top_p
        thresh = torch.where(keep_sorted, sorted_lp,
                             torch.full_like(sorted_lp, float("inf"))
                             ).amin(dim=-1, keepdim=True)
        logp = torch.where(logp >= thresh, logp, torch.full_like(logp, NEG_INF))
        logp = torch.log_softmax(logp, dim=-1)
    return logp


def sample(key, logits: torch.Tensor, temperature: float = 1.0,
           top_p: float = 1.0):
    """One token per row. logits: (B, V).  Returns (token (B,) int32,
    logprob (B,) float32 under the adjusted distribution)."""
    logp = adjust_logits(logits.float(), temperature, top_p)
    if temperature <= 0.0:
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        return tok, torch.zeros(tok.shape, dtype=torch.float32,
                                device=tok.device)
    tok = torch.argmax(key.gumbel(logp.shape) + logp, dim=-1)
    lp = torch.gather(logp, -1, tok[..., None])[..., 0]
    return tok.to(torch.int32), lp


def logprobs_of(logits: torch.Tensor, tokens: torch.Tensor,
                temperature: float = 1.0, top_p: float = 1.0) -> torch.Tensor:
    """Log-prob of given tokens under the adjusted distribution.
    logits: (..., V); tokens: (...).  Returns (...) float32."""
    logp = adjust_logits(logits.float(), temperature, top_p)
    return torch.gather(logp, -1, tokens[..., None].long())[..., 0]


def entropy_of(logits: torch.Tensor, temperature: float = 1.0) -> torch.Tensor:
    logp = adjust_logits(logits.float(), temperature, 1.0)
    return -torch.sum(torch.exp(logp) * logp, dim=-1)
