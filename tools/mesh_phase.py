#!/usr/bin/env python3
"""``chip_smoke.py``'s mesh phases alone: the §8 mesh's rollout, serving
and trainer checks against the single-process reference, for the dense
GQA family (``mesh``) and the MoE family (``mesh moe``, mixtral-8x22b).

    python3 tools/mesh_phase.py [--dense | --moe] [--kl]

Builds the kernels, runs ``chip_smoke.mesh_path`` and then
``chip_smoke.mesh_moe_path`` (``--dense`` or ``--moe``: that one alone)
with every check of the smoke (four ranks as a (2, 2) mesh: over ``gloo``
on one card, which they share, or over NCCL when each rank has a card of
its own, as on four), and prints the card's name and power limit, the
phases' lines and seconds, then ``{"ok": true, ...}`` with the device
count.  ``--kl``: the MoE trainer keeps GRPO's KL reference, which four
ranks on one card cannot hold (run it with a card a rank).  Exits 2
without a card.  About 3.5 minutes for ``mesh`` on one card with the
build.  The spawned ranks import this file again, so its work runs only
under ``__main__``.
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    which = ap.add_mutually_exclusive_group()
    which.add_argument("--dense", action="store_true",
                       help="the dense GQA mesh phase alone")
    which.add_argument("--moe", action="store_true",
                       help="the MoE mesh phase alone")
    ap.add_argument("--kl", action="store_true",
                    help="the MoE trainer with GRPO's KL reference")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("mesh_phase: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as C
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    _build.library()
    C.log(f"kernels built and loaded in {time.perf_counter() - t0:.1f} s")
    C.log(C.smi_line())
    phases = []
    if not args.moe:
        phases.append(("mesh", lambda: C.mesh_path(torch)))
    if not args.dense:
        phases.append(("mesh moe", lambda: C.mesh_moe_path(torch,
                                                           kl=args.kl)))
    for label, run in phases:
        t0 = time.perf_counter()
        launches = run()
        C.log(f"{label} phase {time.perf_counter() - t0:.1f} s on "
              f"{torch.cuda.device_count()} card(s); launches "
              f"{dict(launches)}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
