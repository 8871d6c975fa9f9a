"""Synthetic verifiable-math task generator.

Stands in for DeepMath-6K / SimpleRL-8K: prompts are small arithmetic
expressions ("17+25="), ground truth is the integer result, and the reward is
the same +1/0 exact-match rule the paper uses (math-verify style).  Task
difficulty (operand range, #terms) is configurable so tiny models can learn
within a few hundred steps.
"""
from __future__ import annotations

import random
from dataclasses import dataclass
from typing import List, Tuple


@dataclass(frozen=True)
class MathTaskConfig:
    num_problems: int = 256
    min_operand: int = 0
    max_operand: int = 20
    max_terms: int = 2
    ops: str = "+-"
    seed: int = 0


@dataclass(frozen=True)
class Problem:
    prompt_text: str
    answer: int
    problem_id: int


def generate_problems(cfg: MathTaskConfig) -> List[Problem]:
    rng = random.Random(cfg.seed)
    problems = []
    seen = set()
    while len(problems) < cfg.num_problems:
        n_terms = rng.randint(2, max(2, cfg.max_terms))
        terms = [rng.randint(cfg.min_operand, cfg.max_operand)
                 for _ in range(n_terms)]
        ops = [rng.choice(cfg.ops) for _ in range(n_terms - 1)]
        expr = str(terms[0])
        for o, t in zip(ops, terms[1:]):
            expr += o + str(t)
        if expr in seen:
            continue
        seen.add(expr)
        answer = eval(expr)  # trusted: generated from digits/ops only
        problems.append(Problem(expr + "=", int(answer), len(problems)))
    return problems
