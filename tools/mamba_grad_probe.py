#!/usr/bin/env python3
"""Where the time of a Mamba layer's gradient route goes, on one H100.

Run from the root of a checkout, with no arguments:

    python3 tools/mamba_grad_probe.py

At jamba-v0.1-52b's full width (d_model 4,096, d_inner 8,192, d_state 16)
and the train step's shape (B = 16 rows of T = 320 tokens), in bfloat16,
it times forward + backward (CUDA events, median of 3 after one warm-up)
of: the one-layer model (Mamba + MoE, ``dispatch``) as the actor update
runs it (``engine/generate.py:token_logprobs``, then the log-probs'
sum), the whole Mamba layer (``models/mamba.py:apply_mamba`` with grad
on, so through ``ssm_scan`` chunked under ``torch.utils.checkpoint``), the
MoE layer, the scan alone (``ssm_scan`` on float32 inputs, chunked and
unchunked), and the scan's forward alone (each first call's time beside);
then one ``torch.profiler`` session of the model's forward + backward,
whose top device kernels and host ops by self time it prints.  Beside
them, the no-grad forward through the ``mamba_scan`` kernel.  Writes ``chiprun_out/mamba_grad_probe.json``.
Exits nonzero without a CUDA device.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
B, T = 16, 320


def timed(torch, fn, reps: int = 3):
    """(median ms of ``reps`` calls, the first call's ms)."""
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    first = (time.perf_counter() - t0) * 1e3
    out = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end))
    return statistics.median(out), first


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("mamba_grad_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.engine.generate import token_logprobs
    from repro_torch.kernels import _build
    from repro_torch.models import mamba as MB
    from repro_torch.models.model import init_lm
    from repro_torch.models.moe import apply_moe

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.library()
    cfg = get_config("jamba-v0.1-52b").replace(num_layers=1)
    model = init_lm(cfg, seed=0, device="cuda")
    layer, moe = model.layers[0].mamba, model.layers[0].moe
    for p in model.parameters():
        p.requires_grad_(True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    tokens = torch.randint(3, cfg.vocab_size, (B, T), generator=gen,
                           device="cuda", dtype=torch.int32)
    mask = torch.ones((B, T), dtype=torch.bool, device="cuda")

    def model_fb():
        lp, _, aux = token_logprobs(model, cfg, tokens, mask)
        (lp.sum() + aux["moe_lb_loss"]).backward()
        model.zero_grad(set_to_none=True)
    x = torch.randn((B, T, cfg.d_model), generator=gen, device="cuda",
                    dtype=torch.bfloat16, requires_grad=True)
    pos = torch.arange(T, device="cuda", dtype=torch.int32)[None].repeat(B, 1)
    w = torch.randn((B, T, cfg.d_model), generator=gen, device="cuda",
                    dtype=torch.bfloat16)

    def layer_fb():
        out = MB.apply_mamba(layer, cfg, x, pos)
        (out.float() * w.float()).sum().backward()

    def moe_fb():
        out, aux = apply_moe(moe, cfg, x)
        ((out.float() * w.float()).sum() + aux["moe_lb_loss"]).backward()

    di, ds = cfg.mamba_d_inner, cfg.mamba_d_state
    f32 = dict(device="cuda", dtype=torch.float32)
    dt = (0.1 * torch.rand((B, T, di), generator=gen, **f32)).requires_grad_()
    u = torch.randn((B, T, di), generator=gen, **f32).requires_grad_()
    Bc = torch.randn((B, T, ds), generator=gen, **f32).requires_grad_()
    Cc = torch.randn((B, T, ds), generator=gen, **f32).requires_grad_()
    A = (-torch.arange(1, ds + 1, **f32)[None].repeat(di, 1)).requires_grad_()
    D = torch.ones((di,), **f32).requires_grad_()
    s0 = torch.zeros((B, di, ds), **f32)
    gy = torch.randn((B, T, di), generator=gen, **f32)

    def scan_fb(chunk):
        def run():
            y, _ = MB.ssm_scan(dt, u, Bc, Cc, A, D, s0, chunk)
            (y * gy).sum().backward()
        return run

    def scan_f():
        with torch.no_grad():
            MB.ssm_scan(dt, u, Bc, Cc, A, D, s0, cfg.scan_chunk)

    def layer_kernel():
        with torch.no_grad():
            MB.apply_mamba(layer, cfg, x, pos)

    res = {"device": smi, "B": B, "T": T, "scan_chunk": cfg.scan_chunk}
    t0 = time.perf_counter()
    res["model_fwd_bwd_ms"] = timed(torch, model_fb)
    res["layer_fwd_bwd_ms"] = timed(torch, layer_fb)
    res["moe_fwd_bwd_ms"] = timed(torch, moe_fb)
    res["scan_fwd_bwd_ms_chunked"] = timed(torch, scan_fb(cfg.scan_chunk))
    res["scan_fwd_bwd_ms_unchunked"] = timed(torch, scan_fb(T))
    res["scan_fwd_ms"] = timed(torch, scan_f)
    res["layer_no_grad_kernel_ms"] = timed(torch, layer_kernel)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        model_fb()
        torch.cuda.synchronize()
    dev, host = [], []
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            dev.append((e.self_device_time_total / 1e3, e.count, e.key))
        else:
            host.append((e.self_cpu_time_total / 1e3, e.count, e.key))
    res["top_device_ms"] = sorted(dev, reverse=True)[:15]
    res["top_host_ms"] = sorted(host, reverse=True)[:15]
    res["device_total_ms"] = sum(d[0] for d in dev)
    res["wall_s"] = time.perf_counter() - t0
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "mamba_grad_probe.json").write_text(json.dumps(res, indent=1))
    for k, v in res.items():
        print(k, json.dumps(v), flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
