#!/usr/bin/env python3
"""Time the port's ``wkv`` and ``spec_verify`` kernels against an earlier
version of them, in turns on one card.

    python3 tools/wkv_ab.py --old DIR

DIR holds the earlier ``wkv.cu`` and ``spec_verify.cu`` (with the C entry
points ``repro_wkv(r, k, v, w, u, s0, y, s_out, B, T, H, hd, stream)`` and
``repro_spec_verify(lp_curr, lp_prev, u, valid_len, out, B, N,
log_lenience, stream)``, ``valid_len`` int32).  They are built with the
port's ``nvcc`` flags into their own library, beside the port's, together
with an empty kernel whose device time is the card's launch floor.

At ``chip_smoke.py``'s shapes, rwkv6-3b's B = 16, H = 40, hd = 64 for
``wkv`` at T = 1 (a decode step, one done row), T = 64 (the epoch-0
prefill, the prompts' left pads) and T = 320 (the epoch-1 verify score,
the prompts' and drafts' pads), and (B, N) = (16, 256) for ``spec_verify``
(one row with nothing to verify, ``valid_len`` int32; the new kernel also
with int64), each version is checked against the plain version and timed
as ``chip_smoke.Timer`` times: CUDA events (median, L2 flushed and the card
spun 0.5 ms before each call, old and new in turns) and the device time
per call of every kernel the call launched (``torch.profiler``, twice in
turns; the new version must be one launch a call).  It prints one JSON
line per shape, then the card's name and power limit, and writes them all,
with the SM clock, to ``chiprun_out/wkv_ab.json``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

B = 16
EMPTY_CU = r"""
#include <cuda_runtime.h>
__global__ void empty_kernel() {}
extern "C" int repro_empty(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
"""


def build_old(old: Path, out_dir: Path) -> ctypes.CDLL:
    """The earlier ``wkv.cu`` and ``spec_verify.cu`` and the empty kernel,
    one ``nvcc`` each, all started together, linked into one library."""
    from repro_torch.kernels import _build

    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "empty.cu").write_text(EMPTY_CU)
    srcs = {"wkv": old / "wkv.cu", "spec_verify": old / "spec_verify.cu",
            "empty": out_dir / "empty.cu"}
    nvcc = _build._nvcc()
    procs = [(n, subprocess.Popen(
        [nvcc, *_build.ARCH, *_build.FLAGS, "-c", str(src), "-o",
         str(out_dir / f"{n}.o")], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)) for n, src in srcs.items()]
    log = []
    for n, p in procs:
        text, _ = p.communicate()
        log.append(f"== {n} ==\n{text}")
        if p.returncode:
            raise RuntimeError(text)
    (out_dir / "build.log").write_text("\n".join(log))
    lib = out_dir / "libold_wkv.so"
    subprocess.run([nvcc, *_build.ARCH, "-shared", "-o", str(lib),
                    *(str(out_dir / f"{n}.o") for n in srcs)], check=True)
    dll = ctypes.CDLL(str(lib))
    P_, I_, F_ = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    dll.repro_wkv.argtypes = [P_] * 8 + [I_] * 4 + [P_]
    dll.repro_spec_verify.argtypes = [P_] * 5 + [I_, I_, F_, P_]
    dll.repro_empty.argtypes = [P_]
    for fn in (dll.repro_wkv, dll.repro_spec_verify, dll.repro_empty):
        fn.restype = I_
    return dll


def sm_clocks() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", type=Path, required=True)
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args()

    import torch

    import chip_smoke
    from repro_torch.kernels import _build
    from repro_torch.kernels.rwkv6_wkv import ops as wkv_ops
    from repro_torch.kernels.spec_verify import ops as sv_ops

    if not torch.cuda.is_available():
        print("wkv_ab: no CUDA device", file=sys.stderr)
        return 2
    smi = chip_smoke.smi_line()
    _build.library()
    old = build_old(args.old, ROOT / "build" / "wkv_ab_old")
    timer = chip_smoke.Timer(torch)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(chip_smoke.SEED)
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    P, N = chip_smoke.P, chip_smoke.N
    rows = []

    def per_call_device_ms(fn, reps):
        """Device time (ms) of one call of ``fn``: each kernel it launches,
        by name, (launches a call, mean ms a launch), over ``reps``
        L2-flushed calls (the flush aside); and their sum, each kernel's
        mean times its launches a call rounded (CUPTI may drop a record)."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                timer.flush.zero_()
                fn()
            torch.cuda.synchronize()
        kernels = {e.key[:80]: (e.count / reps,
                                e.self_device_time_total / e.count / 1e3)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and e.count
                   and "FillFunctor" not in e.key and "Memset" not in e.key}
        return sum(ms * max(1, round(n)) for n, ms in kernels.values()), kernels

    def compare(label, old_fn, new_fn, check, bound_ms):
        errs = [check(old_fn()), check(new_fn())]
        ev = timer.turns(old_fn, new_fn, reps=args.reps)
        dev_ms = [per_call_device_ms(f, args.reps)
                  for f in (old_fn, new_fn, old_fn, new_fn)]
        row = {"shape": label, "old_ms": ev[0], "new_ms": ev[1],
               "old_device_ms": [dev_ms[0][0], dev_ms[2][0]],
               "new_device_ms": [dev_ms[1][0], dev_ms[3][0]],
               "old_kernels": dev_ms[0][1], "new_kernels": dev_ms[1][1],
               "old_max_abs_err": errs[0], "new_max_abs_err": errs[1],
               "bound_ms": bound_ms, "sm_clocks": sm_clocks()}
        print(json.dumps(row), flush=True)
        chip_smoke.require(all(e is not None for e in errs),
                           f"{label}: a version disagrees: {row}")
        chip_smoke.require(len(row["new_kernels"]) == 1 and all(
            round(n) == 1 for n, _ in row["new_kernels"].values()),
            f"{label}: the new version is not one launch a call: {row}")
        rows.append(row)

    # --- wkv at the rwkv path's three regimes -------------------------------
    p_len = torch.randint(6, 10, (B,), generator=gen, device=dev)
    n = torch.randint(0, N + 1, (B,), generator=gen, device=dev)
    col = torch.arange(P, device=dev)[None, :]
    for T, valid in ((1, torch.arange(B, device=dev)[:, None] > 0),
                     (P, col >= P - p_len[:, None]),
                     (P + N, chip_smoke.score_valid(torch, p_len, n))):
        r, k, v, w, u, s0 = chip_smoke.wkv_inputs(torch, gen, T, valid)
        H, hd = u.shape
        want_y, want_s = wkv_ops.wkv_plain(r, k, v, w, u, s0)
        s_out = torch.empty_like(s0)

        def old_fn(r=r, k=k, v=v, w=w, u=u, s0=s0, s_out=s_out):
            y = torch.empty_like(r)
            _build.check(old.repro_wkv(
                *(t.data_ptr() for t in (r, k, v, w, u, s0, y, s_out)),
                B, r.shape[1], H, hd, stream()), "old wkv")
            return y

        def new_fn(r=r, k=k, v=v, w=w, u=u, s0=s0, s_out=s_out):
            return wkv_ops.wkv_cuda(r, k, v, w, u, s0, s_out)

        def check(y, want_y=want_y, want_s=want_s, s_out=s_out):
            torch.cuda.synchronize()
            err = max(float((y - want_y).abs().max()),
                      float((s_out - want_s).abs().max()))
            scale = max(float(want_y.abs().max()), float(want_s.abs().max()))
            ok = bool(torch.isfinite(y).all() and torch.isfinite(s_out).all())
            return err if ok and err <= chip_smoke.WKV_TOL * scale else None

        nbytes = 5 * r.numel() * 4 + 2 * s0.numel() * 4 + u.numel() * 4
        bound_ms, by = chip_smoke.bound(nbytes, 5 * r.numel() * hd,
                                        chip_smoke.FP32_FLOP_PER_S)
        compare(f"wkv T={T} B={B} H={H} hd={hd}", old_fn, new_fn, check,
                [bound_ms, by])
        del r, k, v, w, s0, s_out, want_y, want_s

    # --- spec_verify: the accept test of epoch 1 ----------------------------
    f32 = dict(dtype=torch.float32, device=dev)
    lp_prev = -torch.rand((B, N), generator=gen, **f32) * 8.0
    lp_curr = lp_prev + 0.01 * torch.randn((B, N), generator=gen, **f32)
    u = torch.rand((B, N), generator=gen, **f32)
    vlen64 = torch.full((B,), N, dtype=torch.int64, device=dev)
    vlen64[0] = 0
    vlen = vlen64.to(torch.int32)
    ll = math.log(chip_smoke.LENIENCE)
    want = sv_ops.spec_verify_plain(lp_curr, lp_prev, u, vlen, ll)

    def old_sv():
        out = torch.empty((B,), dtype=torch.int32, device=dev)
        _build.check(old.repro_spec_verify(
            *(t.data_ptr() for t in (lp_curr, lp_prev, u, vlen, out)), B, N,
            ll, stream()), "old spec_verify")
        return out

    def sv_check(got):
        torch.cuda.synchronize()
        return 0.0 if torch.equal(got, want) else None

    sv_bound = chip_smoke.bound(3 * B * N * 4 + 2 * B * 4, 5 * B * N)
    for label, vl in (("int32", vlen), ("int64", vlen64)):
        compare(f"spec_verify B={B} N={N} valid_len {label}", old_sv,
                lambda vl=vl: sv_ops.spec_verify_cuda(lp_curr, lp_prev, u, vl,
                                                      ll), sv_check,
                list(sv_bound))

    # --- the launch floor ----------------------------------------------------
    def empty():
        _build.check(old.repro_empty(stream()), "empty")

    floor_ms = timer.ms(empty, reps=args.reps)
    floor_dev = [per_call_device_ms(empty, args.reps)[0] for _ in range(2)]
    rows.append({"shape": "empty kernel <<<1, 32>>>", "ms": floor_ms,
                 "device_ms": floor_dev})
    print(json.dumps(rows[-1]), flush=True)

    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "wkv_ab.json").write_text(json.dumps(
        {"device": smi, "sm_clocks": sm_clocks(), "rows": rows}, indent=1))
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
