#!/usr/bin/env python3
"""Where the drafted decode loop's time goes, beside the vanilla loop's.

    python3 tools/draft_breakdown.py

At ``chip_smoke.py``'s ``draft`` traffic (full-width, full-depth
qwen3-1.7b with random weights from seed 0; B = 16, P = 64, temperature
1), one vanilla ``generate`` of 16 decode steps and one
``drafted_generate`` of 16 tokens a row (``DraftConfig(kind="ngram",
draft_k=8)``: at temperature 1 about 16 macro-steps of T = 2 and 3
blocks), each through ``chip_smoke.time_breakdown``: the host wall time
without the profiler, then the device busy time, CUDA launches, top
kernels and host ops under ``torch.profiler``.  Prints one ``breakdown``
line each, then the card's name and power limit.
"""
from __future__ import annotations

import sys
from dataclasses import replace
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def main() -> int:
    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        print("draft_breakdown: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.drafting import DraftConfig, drafted_generate
    from repro_torch.engine.sampling import make_key
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    _build.library()
    cs.OUT_DIR.mkdir(exist_ok=True)
    model, cfg, batch, gen = cs.setup_model(torch)
    cs.generate_breakdown(torch, model, cfg, gen, batch)
    g = replace(gen, eos_id=-1, max_new_tokens=cs.BREAKDOWN_STEPS)
    cs.time_breakdown(
        torch, f"drafted generate dense B={batch.tokens.shape[0]} "
        f"P={batch.tokens.shape[1]} tokens={cs.BREAKDOWN_STEPS}",
        lambda: drafted_generate(model, cfg, g, batch.tokens, batch.mask,
                                 make_key(cs.SEED + 1),
                                 DraftConfig(kind="ngram",
                                             draft_k=cs.DRAFT_K)))
    print(cs.smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
