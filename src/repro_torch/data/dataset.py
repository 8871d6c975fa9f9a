"""Prompt dataset + epoch iterator with group (rollout-N) expansion.

The paper trains for tens of epochs over a small curated set — exactly the
regime where consecutive-epoch rollouts overlap.  ``PromptDataset`` yields
batches of (prompt row, cache key); each prompt is repeated ``group_size``
times and slot ``g`` of prompt ``p`` gets the stable cache key
``p * group_size + g`` so SPEC-RL reuses the previous epoch's rollout of the
*same slot*.
"""
from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Iterator, List, Sequence, Tuple

import numpy as np

from repro_torch.rewards.mathgen import Problem
from .tokenizer import BOS_ID, PAD_ID, encode


@dataclass
class PromptBatch:
    tokens: np.ndarray        # (B, P) left-padded int32
    mask: np.ndarray          # (B, P) bool
    cache_keys: List[int]     # (B,) stable SPEC-RL cache ids
    answers: List[int]        # (B,)
    problem_ids: List[int]    # (B,)
    epoch: int


class PromptDataset:
    def __init__(self, problems: Sequence[Problem], max_prompt_len: int = 32,
                 seed: int = 0):
        self.problems = list(problems)
        self.max_prompt_len = max_prompt_len
        self.seed = seed
        self._encoded = [encode(p.prompt_text)[:max_prompt_len]
                         for p in self.problems]

    def __len__(self) -> int:
        return len(self.problems)

    def _pack(self, idxs: List[int], group_size: int, epoch: int) -> PromptBatch:
        rows, keys, answers, pids = [], [], [], []
        for i in idxs:
            for g in range(group_size):
                rows.append(self._encoded[i])
                keys.append(i * group_size + g)
                answers.append(self.problems[i].answer)
                pids.append(self.problems[i].problem_id)
        P = self.max_prompt_len
        B = len(rows)
        toks = np.full((B, P), PAD_ID, np.int32)
        mask = np.zeros((B, P), bool)
        for r, ids in enumerate(rows):
            L = len(ids)
            toks[r, P - L:] = ids          # left padding
            mask[r, P - L:] = True
        return PromptBatch(toks, mask, keys, answers, pids, epoch)

    def epochs(self, prompts_per_batch: int, group_size: int,
               num_epochs: int, shuffle: bool = True
               ) -> Iterator[PromptBatch]:
        """Yields batches; each epoch visits every prompt once."""
        n = len(self.problems)
        for epoch in range(num_epochs):
            order = list(range(n))
            if shuffle:
                random.Random(self.seed + epoch).shuffle(order)
            for s in range(0, n - prompts_per_batch + 1, prompts_per_batch):
                yield self._pack(order[s:s + prompts_per_batch],
                                 group_size, epoch)

    def sample_batch(self, rng: random.Random, prompts_per_batch: int,
                     group_size: int, epoch: int = 0) -> PromptBatch:
        idxs = rng.sample(range(len(self.problems)),
                          min(prompts_per_batch, len(self.problems)))
        return self._pack(idxs, group_size, epoch)
