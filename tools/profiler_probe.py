#!/usr/bin/env python3
"""How often ``torch.profiler`` loses a session's device events, on one card.

    python3 tools/profiler_probe.py [--sessions 300]

``chip_smoke.py`` reads each kernel's device time and its launches a call
from ``Timer.device_ms``, one profiler session of 20 calls, and fails when
the trace shows no launch of the kernel.  This script runs ``--sessions``
such sessions of ``wkv`` at the smoke's decode shape (T = 1, B = 16,
H = 40, hd = 64, one done row) through ``chip_smoke.Timer.session``: the
window's lead-in (``chip_smoke.LEAD_IN`` one-cycle markers), then a marker
kernel before each call and after the last, the L2 flushed before each
call.  Sessions alternate between no host time at the window's ends
(``device_ms``'s windows before the markers came) and
``chip_smoke.PROFILE_PAD_S`` at both ends.  A session is complete when its
trace holds every marker and one launch of the kernel a call.  Prints, and
writes with the card's name and power limit to
``chiprun_out/profiler_probe.json``, the count of complete sessions for each
pad, the counts of every incomplete one and the lead-in's lost records,
session by session.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sessions", type=int, default=300)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("profiler_probe: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels.rwkv6_wkv import ops as wkv_ops

    smi = cs.smi_line()
    print(smi, flush=True)
    _build.library()
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    B = cs.PROMPTS * cs.GROUP
    valid = torch.arange(B, device="cuda")[:, None] > 0        # row 0 done
    r, k, v, w, u, s0 = cs.wkv_inputs(torch, gen, 1, valid)
    s_out = torch.empty_like(s0)

    def fn():
        wkv_ops.wkv_cuda(r, k, v, w, u, s0, s_out)

    timer = cs.Timer(torch)
    fn()
    torch.cuda.synchronize()
    pads = (0.0, cs.PROFILE_PAD_S)
    result = {str(p): {"sessions": 0, "complete": 0, "incomplete": [],
                       "lead_in_lost": []} for p in pads}
    t0 = time.perf_counter()
    for i in range(args.sessions):
        pad = pads[i % 2]
        got = timer.session(fn, "wkv_", cs.REPS, pad_s=pad)
        rec = result[str(pad)]
        rec["sessions"] += 1
        rec["lead_in_lost"].append(got["lead_in_lost"])
        if got["markers"] == cs.REPS + 1 and got["launches"] == cs.REPS:
            rec["complete"] += 1
        else:
            rec["incomplete"].append(dict(got, session=i))
    out = {"card": smi, "torch": torch.__version__, "reps": cs.REPS,
           "seconds": time.perf_counter() - t0, "by_pad_s": result}
    line = json.dumps(out)
    print(line, flush=True)
    cs.OUT_DIR.mkdir(exist_ok=True)
    (cs.OUT_DIR / "profiler_probe.json").write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
