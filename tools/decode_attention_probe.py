#!/usr/bin/env python3
"""Where the dense decode kernel's time goes, on one card.

    python3 tools/decode_attention_probe.py

Builds instrumented copies of ``src/repro_torch/csrc/decode_attention.cu``
(with ``decode_attention.cuh`` edited by exact text substitutions, each of
which must apply once, so a changed kernel makes this script fail rather
than measure something else) and runs them at ``chip_smoke.py``'s epoch-1
decode step (B = 16, S = 576, 16 / 8 heads of 128, rows 0-2 done, row 3
with no live slot), at the cluster size the wrapper picks:

* variants, by device time per call (``torch.profiler``): the kernel;
  without the tile compute; without the loads (no bulk copy; each slot's
  position written as its index, no k_pos read); without either (launch,
  reads of the row bounds, barriers and the merge).  Each with the L2 flushed before each call as
  ``chip_smoke.Timer`` does (zeroing 256 MB, which leaves the L2 full of
  dirty lines that a read must first write back) and with a flush that
  reads 256 MB instead (a clean L2, as after a layer's weight reads);
* a trace: each block stamps ``%globaltimer`` and ``%clock64`` at its phase
  boundaries into a device array, read back after one launch; the script
  prints the medians over blocks (in SM clock cycles) and the span of the
  launch (ns).

It prints one JSON line per measurement and writes them all, with the
card's name and power limit, to ``chiprun_out/decode_attention_probe.json``.
"""
from __future__ import annotations

import ctypes
import json
import math
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))
CSRC = ROOT / "src" / "repro_torch" / "csrc"
WORK = ROOT / "build" / "decode_attention_probe"

WAIT = "      hopper::mbar_wait(&full[s], (i / NS) & 1);\n      float sc[ROUNDS];\n"
RELEASE = ("      __syncwarp();\n      if (lane == 0) hopper::mbar_arrive(&empty[s]);"
           "\n    }\n")
COPIES = ("        hopper::mbar_expect_tx(&full[s], n * (ROWK + ROWV));\n"
          "        hopper::bulk_load(ks + (lo - j0) * ROWK, p.k + row * DK, n * ROWK,\n"
          "                          &full[s]);\n"
          "        hopper::bulk_load(ks + TILE * ROWK + (lo - j0) * ROWV, p.v + row * DV,\n"
          "                          n * ROWV, &full[s]);\n")
KPOS = "          hopper::cp_async_4(kps + j, p.k_pos + (size_t)b * S + j0 + j);\n"
NO_COMPUTE = [(WAIT, WAIT.replace("      float sc", "      if (p.G < 0) {\n      float sc")),
              (RELEASE, "      }\n" + RELEASE)]
NO_LOADS = [(COPIES, "        hopper::mbar_arrive(&full[s]);\n        (void)ks;\n"
                     "        (void)n;\n        (void)row;\n"),
            (KPOS, "          kps[j] = j0 + j;\n")]
VARIANTS = {"kernel": [], "no compute": NO_COMPUTE, "no loads": NO_LOADS,
            "neither": NO_COMPUTE + NO_LOADS}

# trace: TR[0] globaltimer and TR[1] clock64 at the start, TR[2] once the row
# bounds are read, TR[5] at the first copy, TR[8 + 2 w] / TR[9 + 2 w] when
# warp w's first tile has landed / is done, TR[24] when the block's partial
# is merged, TR[25] after the first cluster wait, TR[26] (rank 0) after the
# second, TR[27] globaltimer and TR[28] clock64 at the end
TRACE_HEAD = '''
__device__ unsigned long long g_trace[4096 * 32];
__device__ __forceinline__ unsigned long long clk() {
  unsigned long long c; asm volatile("mov.u64 %0, %%clock64;" : "=l"(c)); return c; }
__device__ __forceinline__ unsigned long long gtime() {
  unsigned long long c; asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(c)); return c; }
extern "C" int probe_trace(void* dst) {
  return (int)cudaMemcpyFromSymbol(dst, g_trace, sizeof(g_trace)); }
namespace decode_attn {'''
TRACE = [
    ("namespace decode_attn {", TRACE_HEAD),
    ("  const int T = p.T, S = p.S;\n",
     "  const int T = p.T, S = p.S;\n"
     "  unsigned long long* TR = g_trace + ((size_t)(blockIdx.z * gridDim.y + "
     "blockIdx.y) * gridDim.x + blockIdx.x) * 32;\n"
     "  if (tid == 0) { for (int z = 2; z < 32; ++z) TR[z] = 0; TR[0] = gtime(); "
     "TR[1] = clk(); }\n"),
    ("  const int ntiles = t_hi - t_lo;\n",
     "  const int ntiles = t_hi - t_lo;\n  if (tid == 0) TR[2] = clk();\n"),
    ("      if (lane == 0) {\n        const uint32_t n",
     "      if (lane == 0 && i == 0) TR[5] = clk();\n"
     "      if (lane == 0) {\n        const uint32_t n"),
    (WAIT, WAIT + "      if (lane == 0 && i < NW) TR[8 + 2 * i] = clk();\n"),
    (RELEASE, "      if (lane == 0 && i < NW) TR[9 + 2 * i] = clk();\n" + RELEASE),
    ("  // ---- rank c > 0 hands its partial to rank 0 and leaves\n",
     "  if (tid == 0) TR[24] = clk();\n"),
    ("  hopper::cluster_wait();                    // phase 1: rank 0 runs\n",
     "  hopper::cluster_wait();\n  if (tid == 0) TR[25] = clk();\n"),
    ("    hopper::cluster_arrive();                // phase 2: released to rank 0\n"
     "    return;",
     "    hopper::cluster_arrive();\n"
     "    if (tid == 0) { TR[27] = gtime(); TR[28] = clk(); }\n    return;"),
    ("  hopper::cluster_wait();                    // phase 2: every peer's partial\n",
     "  hopper::cluster_wait();\n  if (tid == 0) TR[26] = clk();\n"),
    ("      o[e] = l > 0.f ? a / l : 0.f;\n    }\n  }\n}",
     "      o[e] = l > 0.f ? a / l : 0.f;\n    }\n  }\n"
     "  if (tid == 0) { TR[27] = gtime(); TR[28] = clk(); }\n}"),
]


def edited(name: str, subs) -> Path:
    """A copy of the dense kernel's sources with ``subs`` applied."""
    d = WORK / name.replace(" ", "_")
    d.mkdir(parents=True, exist_ok=True)
    for f in ("decode_attention.cu", "decode_attention.cuh", "hopper.cuh"):
        shutil.copy(CSRC / f, d / f)
    text = (d / "decode_attention.cuh").read_text()
    for old, new in subs:
        if text.count(old) != 1:
            raise SystemExit(f"{name}: the kernel source changed; update "
                             f"this script's substitution for:\n{old}")
        text = text.replace(old, new)
    (d / "decode_attention.cuh").write_text(text)
    return d


def main() -> int:
    import torch

    import chip_smoke
    import decode_attention_ab as ab
    from repro_torch.kernels import _build
    from repro_torch.kernels.decode_attention import ops as dec_ops

    if not torch.cuda.is_available():
        print("decode_attention_probe: no CUDA device", file=sys.stderr)
        return 2
    smi = chip_smoke.smi_line()
    builds = dict(VARIANTS, trace=TRACE)
    dirs = {n: edited(n, s) for n, s in builds.items()}
    procs = {n: subprocess.Popen(
        [_build._nvcc(), *_build.ARCH, *_build.FLAGS, "-shared", "-o",
         str(d / "lib.so"), str(d / "decode_attention.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for n, d in dirs.items()}
    libs = {}
    for n, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{n}: nvcc failed\n{out}")
        lib = ctypes.CDLL(str(dirs[n] / "lib.so"))
        lib.repro_decode_attention.argtypes = _build.SIGNATURES[
            "repro_decode_attention"]
        lib.repro_decode_attention.restype = ctypes.c_int
        libs[n] = lib

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    timer = chip_smoke.Timer(torch)
    B, S, Hq, Hkv, D, W = 16, ab.P + 2 * ab.N, ab.Hq, ab.Hkv, ab.D, ab.W
    p_len = torch.randint(6, 10, (B,), generator=gen, device=dev)
    n = torch.randint(0, ab.N + 1, (B,), generator=gen, device=dev)
    starts = (W - (p_len + n)).to(torch.int32)
    lengths = torch.full((B,), W + 1 + ab.STEP, dtype=torch.int32, device=dev)
    j = torch.arange(S, device=dev)[None, :]
    k_pos = torch.where((j >= starts[:, None]) & (j < lengths[:, None]),
                        j - starts[:, None], torch.full_like(j, -1)
                        ).to(torch.int32)
    q_pos = (lengths - 1 - starts)[:, None].to(torch.int32).contiguous()
    q_pos[:3] = -1
    lengths[3] = starts[3]
    bf = dict(dtype=torch.bfloat16, device=dev)
    q = torch.randn((B, Hq, 1, D), generator=gen, **bf)
    k = torch.randn((B, Hkv, S, D), generator=gen, **bf)
    v = torch.randn((B, Hkv, S, D), generator=gen, **bf)
    want = dec_ops.decode_attention_plain(q, k, v, q_pos, k_pos, lengths,
                                          starts)
    C = dec_ops.cluster_size(B * Hkv, -(-S // dec_ops.DENSE_TILE),
                             dec_ops._sm_count(0), Hq // Hkv)

    def call(lib):
        out = torch.empty((B, Hq, 1, D), dtype=torch.float32, device=dev)
        _build.check(lib.repro_decode_attention(
            *(t.data_ptr() for t in (q, k, v, q_pos, k_pos, lengths, starts,
                                     out)),
            B, Hq, Hkv, 1, S, D, D, C, 0, 1.0 / math.sqrt(D),
            torch.cuda.current_stream().cuda_stream), "probe")
        return out

    def device_ms(fn, flush, reps=50):
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                flush()
                fn()
            torch.cuda.synchronize()
        return sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and "decode_kernel" in e.key) / reps / 1e3

    flushes = {"zeroing flush": timer.flush.zero_,
               "reading flush": lambda: timer.flush.sum()}
    rows = []
    for name in VARIANTS:
        fn = (lambda lib=libs[name]: call(lib))
        err = float((fn() - want).abs().max())
        row = {"variant": name, "cluster": C, "max_abs_err": err}
        for _ in range(2):                   # in turns
            for label, flush in flushes.items():
                row.setdefault(label + " device_ms", []).append(
                    device_ms(fn, flush))
        rows.append(row)
        print(json.dumps(row), flush=True)

    buf = (ctypes.c_ulonglong * (4096 * 32))()
    timer.flush.zero_()
    call(libs["trace"])
    torch.cuda.synchronize()
    _build.check(libs["trace"].probe_trace(ctypes.addressof(buf)), "trace")
    nblk = B * Hkv * C
    tr = [list(buf[b * 32:(b + 1) * 32]) for b in range(nblk)]
    rank0 = [r for i, r in enumerate(tr) if i % C == 0]

    def med(vals):
        vals = [x for x in vals if x is not None]
        return statistics.median(vals) if vals else None

    def gap(r, a, b):
        return r[b] - r[a] if r[a] and r[b] else None

    tiles = [r[9 + 2 * w] - r[8 + 2 * w] for r in tr for w in range(4)
             if r[8 + 2 * w] and r[9 + 2 * w]]
    t0 = min(r[0] for r in tr)
    span_ns = max(r[27] for r in tr) - t0
    cycles = max(r[28] - r[1] for r in tr)
    rows.append({
        "trace": "median over blocks, SM clock cycles", "cluster": C,
        "span_ns": span_ns, "last_block_start_ns": max(r[0] for r in tr) - t0,
        "slowest_block_cycles": cycles,
        "bounds_read": med(gap(r, 1, 2) for r in tr),
        "first_copy_issued": med(gap(r, 1, 5) for r in tr),
        "first_tile_landed": med(gap(r, 1, 8) for r in tr),
        "tile_compute": med(tiles), "tile_compute_max": max(tiles),
        "block_partial_done": med(gap(r, 1, 24) for r in tr),
        "cluster_phase1": med(gap(r, 24, 25) for r in tr),
        "rank0_waits_peers": med(gap(r, 25, 26) for r in rank0),
        "rank0_merge": med(gap(r, 26, 28) for r in rank0)})
    print(json.dumps(rows[-1]), flush=True)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "decode_attention_probe.json").write_text(
        json.dumps({"device": smi, "rows": rows}, indent=1))
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
