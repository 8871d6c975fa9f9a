"""Token sampling (port of ``repro/engine/sampling.py``): temperature and
nucleus (top-p), returning the log-prob of the sampled token under the
adjusted distribution (SPEC-RL's acceptance ratio needs exactly that).

Random keys are a small protocol instead of JAX's key arrays:

* ``split_key(key) -> (key, sub)`` calls ``key.split()``;
  ``key.split(num)`` returns ``num`` children (JAX's ``split(key, num)``,
  which the trainer uses once, for its four streams);
* ``key.gumbel(shape)`` and ``key.uniform(shape)`` draw float32 noise on the
  key's device.

Two kinds of key keep JAX's two kinds apart.  A scalar key (JAX's (2,)
key) draws the whole batch's noise from one stream.  A key batch (JAX's
(B, 2) per-row keys) draws row b of ``gumbel((B, V))`` and
``uniform((B, N))`` from its key b alone, so a row's tokens depend on its
key and its tokens only, whatever batch it is sampled in: the invariance
the slot engine (``serving/engine_loop.py``) rests on.  A key batch can be
indexed (``kb[j]`` is a one-row batch), assigned by row (``kb[slot] =
other[j]``) and stacked (``stack_keys``); ``split`` works row by row;
``fold_in(key, i)`` derives row i's key from a scalar key.

``jax.random.categorical(key, logp)`` is exactly
``argmax(logp + gumbel(key, logp.shape))``, so ``sample`` draws that way: a
key that wraps a JAX key and draws with ``jax.random`` (the tests define a
scalar one and a per-row one) makes the sampled tokens identical to the
reference.

The port's own keys: ``Key`` wraps a ``torch.Generator`` on the device,
seeded from an integer; ``split`` derives the two child seeds
deterministically (splitmix64), so a seed fixes the whole stream.
``KeyBatch`` holds (B, 2) 32-bit words in an int64 tensor on the device and
draws with a counter-based hash (Wellons' lowbias32, keyed by both words),
vectorised over the batch: a fixed number of elementwise ops per draw,
whatever B is, and the same bits on the CPU and the card.  Every product is
kept below 2**63 (``_mul32`` splits the 32-bit multiplier), because int64
tensors have no unsigned wrap-around and no logical shift.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

from repro_torch.device import DeviceLike, resolve_device

NEG_INF = -1e30
_MASK64 = (1 << 64) - 1
_TINY = torch.finfo(torch.float32).tiny
_M32 = 0xFFFFFFFF


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

    def split(self, num: int = 2) -> Tuple["Key", ...]:
        """Children ``splitmix64(2 * seed + i)`` for two; for another count,
        ``splitmix64`` of the count and index mixed into the seed's own
        hash, so that no child of a ``num``-way split is a child of a
        two-way one."""
        if num == 2:
            return (Key(_splitmix64(2 * self.seed), self.device),
                    Key(_splitmix64(2 * self.seed + 1), self.device))
        base = _splitmix64(self.seed ^ 0xD1B54A32D192ED03)
        return tuple(Key(_splitmix64((base + (num << 32) + i) & _MASK64),
                         self.device) for i in range(num))

    def _generator(self) -> torch.Generator:
        gen = torch.Generator(device=self.device)
        # CUDA's Philox reads all 64 bits; the CPU's Mersenne Twister only
        # the low 32, so the high word is folded into them there (seeds
        # below 2**32 are kept as they are, and s and s + 2**32 differ)
        seed = self.seed
        if gen.device.type == "cpu":
            seed = (seed ^ (seed >> 32)) & _M32
        gen.manual_seed(seed)
        return gen

    def uniform(self, shape: Sequence[int]) -> torch.Tensor:
        return torch.rand(tuple(shape), generator=self._generator(),
                          dtype=torch.float32, device=self.device)

    def gumbel(self, shape: Sequence[int]) -> torch.Tensor:
        return _gumbel(self.uniform(shape))

    def fold_in(self, i: int) -> "KeyBatch":
        """Row ``i``'s key of a per-request key batch (JAX's
        ``fold_in(key, i)``): a one-row ``KeyBatch``."""
        words = torch.tensor([[self.seed & _M32, self.seed >> 32]],
                             dtype=torch.int64, device=self.device)
        return KeyBatch(_derive(words, (2 * int(i) + 3,))[:, 0])


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for x in [0, 2**32), with every product < 2**49."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _M32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """lowbias32: a bijective 32-bit hash with full avalanche."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def _derive(words: torch.Tensor, tags: Sequence[int]) -> torch.Tensor:
    """Child words (B, len(tags), 2) of ``words`` (B, 2), one child per
    32-bit tag, all in one pass."""
    t = torch.tensor(tags, dtype=torch.int64, device=words.device)[None, :]
    k0, k1 = words[:, :1], words[:, 1:]
    a = _mix32(k0 ^ _mix32((k1 + t) & _M32))
    b = _mix32(k1 ^ _mix32((a + 0x9E3779B9) & _M32))
    return torch.stack([a, b], dim=2)


def _gumbel(u: torch.Tensor) -> torch.Tensor:
    return -torch.log(-torch.log(u.clamp_min_(_TINY)))


class KeyBatch:
    """Per-row keys: ``words`` (B, 2) int64 holding 32-bit values."""

    def __init__(self, words: torch.Tensor):
        if words.ndim != 2 or words.shape[1] != 2:
            raise ValueError(f"KeyBatch wants (B, 2) words, got "
                             f"{tuple(words.shape)}")
        self.words = words

    @property
    def device(self) -> torch.device:
        return self.words.device

    def __len__(self) -> int:
        return self.words.shape[0]

    def __getitem__(self, idx) -> "KeyBatch":
        if isinstance(idx, int):
            idx = slice(idx, idx + 1)
        return KeyBatch(self.words[idx])

    def __setitem__(self, idx, other: "KeyBatch") -> None:
        self.words[idx] = other.words.to(self.device)

    @classmethod
    def stack(cls, keys: Sequence["KeyBatch"]) -> "KeyBatch":
        dev = keys[0].device
        return cls(torch.cat([k.words.to(dev) for k in keys], dim=0))

    def __array__(self, dtype=None, copy=None):
        """The (B, 2) words as a numpy array: how a snapshot stores a key
        batch (``Request.to_state``, the slot engine's ``state_dict``)."""
        a = self.words.cpu().numpy()
        return a if dtype is None else a.astype(dtype)

    @classmethod
    def from_words(cls, words, device) -> "KeyBatch":
        """The key batch whose words are ``words`` (any (B, 2) or (2,)
        array of 32-bit values), on ``device``."""
        return cls(torch.as_tensor(words, dtype=torch.int64,
                                   device=device).reshape(-1, 2))

    def split(self, num: int = 2) -> Tuple["KeyBatch", ...]:
        children = _derive(self.words, tuple(range(1, num + 1)))
        return tuple(KeyBatch(children[:, i]) for i in range(num))

    def uniform(self, shape: Sequence[int]) -> torch.Tensor:
        """float32 in [0, 1), (B, ...): row b from key b alone."""
        shape = tuple(shape)
        if shape[0] != len(self):
            raise ValueError(f"a batch of {len(self)} keys draws (B, ...) "
                             f"noise with B = {len(self)}, not {shape}")
        n = 1
        for d in shape[1:]:
            n *= d
        j = torch.arange(n, dtype=torch.int64, device=self.device)[None, :]
        x = _mix32(j ^ self.words[:, :1])
        x = _mix32(x ^ self.words[:, 1:])
        return ((x >> 8).to(torch.float32) * (1.0 / (1 << 24))).reshape(shape)

    def gumbel(self, shape: Sequence[int]) -> torch.Tensor:
        return _gumbel(self.uniform(shape))


def make_key(seed: int, device: DeviceLike = None) -> Key:
    """A key on ``device`` (the card unless ``device="cpu"``)."""
    return Key(seed, resolve_device(device))


def split_key(key):
    return key.split()


def fold_in(key, i: int):
    """Row ``i``'s key derived from a scalar key (a one-row key batch)."""
    return key.fold_in(i)


def stack_keys(keys: Sequence):
    """Stack one-row key batches (of one kind) into one batch."""
    return type(keys[0]).stack(list(keys))


def request_keys(key, batch: int):
    """Per-request keys for ``batch`` rows: a key batch is returned as it
    is; a scalar key is expanded with ``fold_in`` (a different stream from
    scalar-key sampling, which draws batch-coupled noise)."""
    if not hasattr(key, "fold_in"):
        return key
    return stack_keys([fold_in(key, i) for i in range(batch)])


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


def residual_sample(key, logits: torch.Tensor, banned_tok: torch.Tensor,
                    banned_mask: torch.Tensor, temperature: float = 1.0,
                    top_p: float = 1.0):
    """One token per row from the adjusted distribution with one token
    excluded: the rejection-sampling correction of draft-verify decoding
    (DESIGN.md §9).  An n-gram draft is a point mass q = δ(g), so the
    residual norm(max(p - q, 0)) is p with g masked out and renormalised;
    where ``banned_mask`` is False (the bonus token after a full accept)
    this is ``sample``.

    logits: (B, V); banned_tok: (B,) int; banned_mask: (B,) bool.  Returns
    (token (B,) int32, logprob (B,) float32), the log-prob under the
    UNMASKED adjusted distribution: the emitted token's marginal (accept
    path and reject path together) is exactly p.  Drawn as
    ``argmax(masked + gumbel)``, JAX's ``categorical``; temperature <= 0
    is the argmax of the raw logits (a greedy rejection implies draft !=
    argmax, so the ban never meets the argmax)."""
    logp = adjust_logits(logits.float(), temperature, top_p)
    if temperature <= 0.0:
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        return tok, torch.zeros(tok.shape, dtype=torch.float32,
                                device=tok.device)
    V = logits.shape[-1]
    ban = banned_mask[:, None] & (
        torch.arange(V, device=logits.device)[None, :]
        == banned_tok[:, None].long())
    masked = torch.log_softmax(
        torch.where(ban, torch.full_like(logp, NEG_INF), logp), dim=-1)
    tok = torch.argmax(key.gumbel(masked.shape) + masked, dim=-1)
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
