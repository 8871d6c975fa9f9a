#!/usr/bin/env python3
"""Time the port's two decode-attention kernels against an earlier version
of them, in turns on one card.

    python3 tools/decode_attention_ab.py --old DIR

DIR holds the earlier ``decode_attention.cu``, ``decode_attention.cuh``
and ``paged_decode_attention.cu`` (and any header they include): the
split-K pair of kernels whose C entry points take the partials (m, l,
acc) from the caller, ``repro_decode_attention(q, k, v, q_pos, k_pos,
lengths, starts, m, l, acc, out, B, Hq, Hkv, T, S, D, nsplit, window,
scale, stream)`` with 64-slot splits and ``repro_paged_decode_attention(q,
k_pool, v_pool, table, q_pos, k_pos, lengths, starts, m, l, acc, out, B,
Hq, Hkv, T, nb, bs, D, window, scale, stream)``.  It is built with the
port's ``nvcc`` flags into its own library, beside the port's.

At the decode shapes of ``chip_smoke.py`` (epoch 1: B = 16, S = 576; epoch
0: S = 320; the slot engine: B = 8, S = 576; the paged pools of 32-slot
blocks; qwen3-1.7b's 16 / 8 heads of 128, one query a row) each version
is called as its wrapper calls it (the earlier one allocating its
partials, as its wrapper did), checked against the plain version and
timed: CUDA events (median, L2 flushed before each call, old and new in
turns) and device time per call from ``torch.profiler`` (every kernel the
call launched).  Then the new dense kernel at the epoch-1 and the slot engine's
shapes for each cluster size C, to check the wrapper's choice.  It prints one JSON line
per shape, then the card's name and power limit, and writes them to
``chiprun_out/decode_attention_ab.json``.
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

P, N, W, STEP = 64, 256, 320, 128      # chip_smoke.py's traffic
Hq, Hkv, D = 16, 8, 128


def build_old(old: Path, out_dir: Path) -> ctypes.CDLL:
    from repro_torch.kernels import _build

    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / "libold_decode.so"
    nvcc = _build._nvcc()
    procs = [subprocess.Popen(
        [nvcc, *_build.ARCH, *_build.FLAGS, "-c", str(old / f"{n}.cu"), "-o",
         str(out_dir / f"{n}.o")], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
        for n in ("decode_attention", "paged_decode_attention")]
    for p in procs:
        text, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(text)
    subprocess.run([nvcc, *_build.ARCH, "-shared", "-o", str(lib),
                    str(out_dir / "decode_attention.o"),
                    str(out_dir / "paged_decode_attention.o")], check=True)
    dll = ctypes.CDLL(str(lib))
    P_, I_, F_ = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    dll.repro_decode_attention.argtypes = [P_] * 11 + [I_] * 8 + [F_, P_]
    dll.repro_paged_decode_attention.argtypes = [P_] * 12 + [I_] * 8 + [F_, P_]
    dll.repro_decode_attention.restype = I_
    dll.repro_paged_decode_attention.restype = I_
    return dll


def per_call_device_ms(torch, timer, fn, reps):
    """Device time (ms) of every kernel ``fn`` launches, a call, by name,
    over ``reps`` L2-flushed calls (the flush aside)."""
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
    kernels = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and "FillFunctor" not in e.key \
                and "Memset" not in e.key:
            kernels[e.key[:80]] = (e.count / reps,
                                   e.self_device_time_total / reps / 1e3)
    return sum(ms for _, ms in kernels.values()), kernels


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", type=Path, required=True)
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args()

    import torch

    import chip_smoke
    from repro_torch.kernels import _build
    from repro_torch.kernels.decode_attention import ops as dec_ops

    if not torch.cuda.is_available():
        print("decode_attention_ab: no CUDA device", file=sys.stderr)
        return 2
    smi = chip_smoke.smi_line()
    _build.library()
    old = build_old(args.old, ROOT / "build" / "decode_ab_old")
    timer = chip_smoke.Timer(torch)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    bf = dict(dtype=torch.bfloat16, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    scale = 1.0 / math.sqrt(D)

    def inputs(B, S, prompt, smoke_rows=False):
        """chip_smoke.py's decode step; with ``smoke_rows`` its epoch-1
        check's rows too: rows 0-2 done, row 3 with no live slot."""
        p_len = torch.randint(6, 10, (B,), generator=gen, device=dev)
        n = torch.randint(0, N + 1, (B,), generator=gen, device=dev)
        starts = (prompt - (p_len + (n if S > W else 0))).to(torch.int32)
        lengths = torch.full((B,), prompt + 1 + STEP, dtype=torch.int32,
                             device=dev)
        j = torch.arange(S, device=dev)[None, :]
        k_pos = torch.where((j >= starts[:, None]) & (j < lengths[:, None]),
                            j - starts[:, None], torch.full_like(j, -1)
                            ).to(torch.int32)
        q_pos = (lengths - 1 - starts)[:, None].to(torch.int32).contiguous()
        if smoke_rows:
            q_pos[:3] = -1
            lengths[3] = starts[3]
            k_pos[3] = -1
        q = torch.randn((B, Hq, 1, D), generator=gen, **bf)
        k = torch.randn((B, Hkv, S, D), generator=gen, **bf)
        v = torch.randn((B, Hkv, S, D), generator=gen, **bf)
        return q, k, v, q_pos, k_pos, lengths, starts

    def old_dense(q, k, v, q_pos, k_pos, lengths, starts):
        B, S = k.shape[0], k.shape[2]
        ns = -(-S // 64)
        m = torch.empty((B, Hkv, ns, Hq // Hkv), **f32)
        l = torch.empty((B, Hkv, ns, Hq // Hkv), **f32)
        acc = torch.empty((B, Hkv, ns, Hq // Hkv, D), **f32)
        out = torch.empty((B, Hq, 1, D), **f32)
        _build.check(old.repro_decode_attention(
            *(t.data_ptr() for t in (q, k, v, q_pos, k_pos, lengths, starts,
                                     m, l, acc, out)),
            B, Hq, Hkv, 1, S, D, ns, 0, scale, stream()), "old dense")
        return out

    def old_paged(q, kp, vp, table, q_pos, k_pos, lengths, starts):
        B, nb = table.shape
        bs = kp.shape[2]
        m = torch.empty((B, Hkv, nb, Hq // Hkv), **f32)
        l = torch.empty((B, Hkv, nb, Hq // Hkv), **f32)
        acc = torch.empty((B, Hkv, nb, Hq // Hkv, D), **f32)
        out = torch.empty((B, Hq, 1, D), **f32)
        _build.check(old.repro_paged_decode_attention(
            *(t.data_ptr() for t in (q, kp, vp, table, q_pos, k_pos, lengths,
                                     starts, m, l, acc, out)),
            B, Hq, Hkv, 1, nb, bs, D, 0, scale, stream()), "old paged")
        return out

    def new_dense_c(C, q, k, v, q_pos, k_pos, lengths, starts):
        B, S = k.shape[0], k.shape[2]
        out = torch.empty((B, Hq, 1, D), **f32)
        _build.launch("repro_decode_attention", dev,
                      *(t.data_ptr() for t in (q, k, v, q_pos, k_pos,
                                               lengths, starts, out)),
                      B, Hq, Hkv, 1, S, D, D, C, 0, scale)
        return out

    def compare(label, old_fn, new_fn, plain_fn, new_kernel):
        want = plain_fn()
        errs = [float((f() - want).abs().max()) for f in (old_fn, new_fn)]
        torch.cuda.synchronize()
        # events in turns: old, new, new, old, ...
        old_ms, new_ms = timer.turns(old_fn, new_fn, reps=args.reps)
        old_dev, old_k = per_call_device_ms(torch, timer, old_fn, args.reps)
        new_dev, new_k = per_call_device_ms(torch, timer, new_fn, args.reps)
        old_dev2, _ = per_call_device_ms(torch, timer, old_fn, args.reps)
        new_dev2, _ = per_call_device_ms(torch, timer, new_fn, args.reps)
        row = {"shape": label, "old_ms": old_ms, "new_ms": new_ms,
               "old_device_ms": [old_dev, old_dev2],
               "new_device_ms": [new_dev, new_dev2],
               "old_kernels": old_k, "new_kernels": new_k,
               "old_max_abs_err": errs[0], "new_max_abs_err": errs[1]}
        assert all(e <= chip_smoke.ATTN_TOL for e in errs), row
        assert len(new_k) == 1 and new_kernel in next(iter(new_k)), row
        print(json.dumps(row), flush=True)
        return row

    rows = []
    for label, B, S, prompt in (("epoch 1 B=16 S=576", 16, P + 2 * N, W),
                                ("epoch 0 B=16 S=320", 16, W, P),
                                ("slot engine B=8 S=576", 8, P + 2 * N, W)):
        a = inputs(B, S, prompt, smoke_rows=label.startswith("epoch 1"))
        rows.append(compare(
            label, lambda a=a: old_dense(*a),
            lambda a=a: dec_ops.decode_attention_cuda(*a),
            lambda a=a: dec_ops.decode_attention_plain(*a),
            "dense_decode_kernel"))
        if label.startswith("epoch 1"):
            dense_args = a
        if label.startswith("slot engine"):
            slot_args = a

    # the paged pools of epoch 1: 32-slot blocks behind a shuffled table
    q, k, v, q_pos, k_pos, lengths, starts = dense_args
    B, S, bs = 16, P + 2 * N, 32
    nb = S // bs
    table = torch.randperm(B * nb, generator=gen, device=dev).to(
        torch.int32).reshape(B, nb)
    pools = []
    for x in (k, v):
        pool = torch.empty((B * nb, Hkv, bs, D), **bf)
        pool[table.reshape(-1).long()] = x.view(B, Hkv, nb, bs, D).transpose(
            1, 2).reshape(B * nb, Hkv, bs, D)
        pools.append(pool)
    pa = (q, pools[0], pools[1], table, q_pos, k_pos, lengths, starts)
    rows.append(compare(
        "paged epoch 1 B=16 S=576 bs=32", lambda: old_paged(*pa),
        lambda: dec_ops.paged_decode_attention_cuda(*pa),
        lambda: dec_ops.paged_decode_attention_plain(*pa),
        "paged_decode_kernel"))

    # the cluster size at the epoch-1 and the slot engine's shapes
    for label, a in (("epoch 1 B=16", dense_args), ("slot engine B=8", slot_args)):
        Bc = a[1].shape[0]
        fns = {C: (lambda C=C, a=a: new_dense_c(C, *a)) for C in (1, 2, 3, 4)}
        ev = timer.turns(*fns.values(), reps=args.reps)
        sweep = {C: {"ms": ms, "device_ms": per_call_device_ms(
            torch, timer, fn, args.reps)[0]} for (C, fn), ms in zip(fns.items(), ev)}
        chosen = dec_ops.cluster_size(Bc * Hkv, -(-S // dec_ops.DENSE_TILE),
                                      dec_ops._sm_count(0), Hq // Hkv)
        rows.append({"shape": f"cluster sweep, {label} dense", "chosen": chosen,
                     "by_cluster": sweep})
        print(json.dumps(rows[-1]), flush=True)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "decode_attention_ab.json").write_text(
        json.dumps({"device": smi, "rows": rows}, indent=1))
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
