#!/usr/bin/env python3
"""``chip_smoke.py``'s ``mesh`` phase alone: the §8 mesh's rollout,
serving and trainer checks against the single-process reference.

    python3 tools/mesh_phase.py

Builds the kernels, runs ``chip_smoke.mesh_path`` with every check of the
smoke (four ranks as a (2, 2) mesh: over ``gloo`` on one card, which they
share, or over NCCL when each rank has a card of its own, as on four), and
prints the card's name and power limit, the phase's ``mesh`` and ``mesh
train`` lines and its seconds, then ``{"ok": true, ...}`` with the device
count.  Exits 2 without a card.  About 3.5 minutes on one card with the
build.  The spawned ranks import this file again, so its work runs only
under ``__main__``.
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def main() -> int:
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
    t0 = time.perf_counter()
    launches = C.mesh_path(torch)
    C.log(f"mesh phase {time.perf_counter() - t0:.1f} s on "
          f"{torch.cuda.device_count()} card(s); launches {dict(launches)}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
