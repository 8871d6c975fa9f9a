"""Rule-based verifiable reward (math-verify style, Appendix A.1).

+1 if the final integer in the decoded response matches the ground truth,
0 otherwise.  Deterministic, tamper-resistant, no format shaping — matching
the paper's reward design.
"""
from __future__ import annotations

import re
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.data.tokenizer import decode

_INT_RE = re.compile(r"-?\d+")


def extract_answer(text: str) -> Optional[int]:
    """Last integer in the response (simplified 'boxed or numeric answer')."""
    matches = _INT_RE.findall(text)
    if not matches:
        return None
    try:
        return int(matches[-1])
    except ValueError:
        return None


def verify_text(response: str, answer: int) -> float:
    got = extract_answer(response)
    return 1.0 if got is not None and got == answer else 0.0


def verify_tokens(tokens: Sequence[int], answer: int) -> float:
    return verify_text(decode(tokens), answer)


def batch_rewards(responses: np.ndarray, lengths: np.ndarray,
                  answers: Sequence[int]) -> np.ndarray:
    """responses: (B, N) token ids; lengths: (B,).  Returns (B,) float32."""
    out = np.zeros((len(answers),), np.float32)
    for i, ans in enumerate(answers):
        out[i] = verify_tokens(responses[i, :int(lengths[i])], ans)
    return out
