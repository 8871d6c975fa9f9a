#!/usr/bin/env python3
"""The slot engine's decode steps with and without the §10 non-finite
guard, in turns on one card.

    python3 tools/guard_ab.py --old DIR

DIR holds an earlier ``serving/engine_loop.py`` without the guard (for
example ``git show <rev>:src/repro_torch/serving/engine_loop.py`` into a
gitignored directory such as ``build/``).  It is loaded as a module of
``repro_torch.serving`` beside the current one.  At ``chip_smoke.py``'s
engine breakdown (full-width, full-depth qwen3-1.7b with random weights
from seed 0, 8 slots, P = 64, 8 requests of 16 tokens: one admission and
16 decode steps), each engine serves the same requests four times, old,
new, new, old: the host wall time of the whole serve (ending in a
synchronise) and, under ``torch.profiler``, its CUDA launches and device
busy time.  The tokens of the two engines must be equal.  It prints one
JSON line per run and one with the launches a decode step each engine
adds, then the card's name and power limit, and writes them to
``chiprun_out/guard_ab.json``.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

STEPS = 16


def load_old(path: Path):
    name = "repro_torch.serving._engine_loop_old"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod.SlotEngine


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--old", required=True, type=Path)
    args = p.parse_args(argv)
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from repro_torch.engine.sampling import make_key, request_keys
    from repro_torch.serving import Request, SlotEngine

    if not torch.cuda.is_available():
        print("guard_ab: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    _build.library()
    old_cls = load_old(args.old / "engine_loop.py")
    model, cfg, batch, gen = cs.setup_model(torch)
    from dataclasses import replace
    g = replace(gen, eos_id=-1, max_new_tokens=STEPS)
    keys = request_keys(make_key(cs.SEED + 1), cs.SLOTS)

    def serve(cls):
        eng = cls(model, cfg, g, num_slots=cs.SLOTS, prompt_width=cs.P)
        for i in range(cs.SLOTS):
            row = batch.tokens[i, cs.P - int(batch.mask[i].sum()):]
            eng.submit(Request(request_id=i, prompt=row, key=keys[i],
                               max_new_tokens=STEPS))
        out = eng.run()
        torch.cuda.synchronize()
        return np.stack([out[i].tokens for i in range(cs.SLOTS)])

    records, tokens = [], {}
    for label, cls in (("old", old_cls), ("new", SlotEngine)):
        tokens[label] = serve(cls)                  # warm
    if not np.array_equal(tokens["old"], tokens["new"]):
        raise AssertionError("guard_ab: the two engines' tokens differ")
    for label, cls in (("old", old_cls), ("new", SlotEngine),
                       ("new", SlotEngine), ("old", old_cls)):
        t0 = time.perf_counter()
        serve(cls)
        wall_ms = (time.perf_counter() - t0) * 1e3
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            serve(cls)
        ev = prof.key_averages()
        busy = sum(e.self_device_time_total for e in ev
                   if e.device_type == DeviceType.CUDA) / 1e3
        launches = sum(e.count for e in ev if e.device_type == DeviceType.CPU
                       and e.key.startswith("cudaLaunchKernel"))
        rec = {"engine": label, "wall_ms": wall_ms, "device_busy_ms": busy,
               "cuda_launches": launches}
        records.append(rec)
        print(json.dumps(rec), flush=True)
    per = {lab: [r["cuda_launches"] for r in records if r["engine"] == lab]
           for lab in ("old", "new")}
    summary = {"steps": STEPS, "slots": cs.SLOTS,
               "launches_old": per["old"], "launches_new": per["new"],
               "guard_launches_per_step":
                   (min(per["new"]) - min(per["old"])) / STEPS,
               "old_launches_per_step": min(per["old"]) / STEPS,
               "new_launches_per_step": min(per["new"]) / STEPS}
    print(json.dumps(summary), flush=True)
    smi = cs.smi_line()
    print(smi, flush=True)
    cs.OUT_DIR.mkdir(exist_ok=True)
    (cs.OUT_DIR / "guard_ab.json").write_text(json.dumps(
        {"runs": records, "summary": summary, "device": smi}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
