"""Character-level tokenizer for the synthetic verifiable-math task.

Fixed special ids: pad=0, bos=1, eos=2.  Vocabulary covers digits, operators
and a small alphabet so prompts like ``"17+25="`` and CoT-ish responses like
``"17+25=42"`` round-trip exactly.
"""
from __future__ import annotations

from typing import List

PAD_ID = 0
BOS_ID = 1
EOS_ID = 2

_CHARS = "0123456789+-*/=()., ?abcdefghijklmnopqrstuvwxyz"
_CHAR_TO_ID = {c: i + 3 for i, c in enumerate(_CHARS)}
_ID_TO_CHAR = {i + 3: c for i, c in enumerate(_CHARS)}

VOCAB_SIZE = 3 + len(_CHARS)


def encode(text: str, add_bos: bool = True, add_eos: bool = False) -> List[int]:
    ids = [BOS_ID] if add_bos else []
    ids += [_CHAR_TO_ID[c] for c in text.lower() if c in _CHAR_TO_ID]
    if add_eos:
        ids.append(EOS_ID)
    return ids


def decode(ids, stop_at_eos: bool = True) -> str:
    out = []
    for i in ids:
        i = int(i)
        if i == EOS_ID and stop_at_eos:
            break
        if i in (PAD_ID, BOS_ID):
            continue
        out.append(_ID_TO_CHAR.get(i, ""))
    return "".join(out)
