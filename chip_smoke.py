#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA H100.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

What it does, failing (nonzero exit, no result line) at the first fault:

1. prints the card's name and power limit (``nvidia-smi``);
2. builds the four CUDA kernels from ``src/repro_torch/csrc`` for sm_90a
   and prints the build time and ``ptxas`` register/spill lines;
3. for each kernel, at the shapes the qwen3-1.7b rollout gives it, in
   bfloat16: calls the public wrapper the model calls (with positions and
   bounds in the raw forms the wrapper converts, done rows and a row with
   no live slot among them) and holds its result against the plain PyTorch
   version on the same inputs (exactly for spec_verify and cache_roll,
   within ``ATTN_TOL`` for the two attentions; rows that see no key must
   come out exactly 0), then times the kernel entry on inputs already in
   its form, the plain version and, where one PyTorch call computes the
   same function, that call (CUDA events, median of ``REPS`` launches with
   the L2 cache flushed before each);
4. holds the port on the card against the port on the CPU at a small size
   (the reduced qwen3-1.7b in bfloat16: forward, prefill, decode steps and
   the compaction roll, teacher-forced), within ``SMALL_TOL``;
5. runs the main path: two rollout epochs of full-width, full-depth
   qwen3-1.7b (random weights from a seed) through ``repro_torch.core.
   rollout`` — epoch 0 vanilla, epoch 1 the one-pass speculative branch —
   with the launch counts set to 0 just before and read just after, and
   checks the outputs; then shows where a short vanilla generate's time
   goes (host wall time, device busy time and top kernels from
   ``torch.profiler``);
6. prints one ``{"kernels": [...]}`` JSON line, the ``nvidia-smi`` line
   again, and last ``{"ok": true, "device": {...}}``.

What is too long for the end of the output goes to ``chiprun_out/`` beside
this script: the kernels' build log (``chip_smoke_build.log``, with the
``ptxas -v`` lines) and the profiler's top 40 device kernels and host ops
(``chip_smoke_profile.tsv``).

It needs the repository's ``src/`` beside it and a CUDA device; without
either it exits nonzero before printing any result.
"""
from __future__ import annotations

import copy
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ATTN_TOL = 1e-3     # both attentions compute in float32 from the same bf16
                    # inputs; they differ only in summation order
SMALL_TOL = 5e-2    # card vs CPU logits in bfloat16 (8-bit mantissa: each
                    # rounding at another place moves a value of order 1 by
                    # up to 4e-3; two layers of them)
REPS = 20
OUT_DIR = Path(__file__).resolve().parent / "chiprun_out"
HBM_BYTES_PER_S = 3.35e12       # H100 SXM data sheet
BF16_FLOP_PER_S = 989e12        # dense bf16 tensor-core peak

# the slice's traffic
PROMPTS, GROUP, P, N = 4, 4, 64, 256
LENIENCE = 0.99
SEED = 0


def require(cond, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------- timing


class Timer:
    """Median device time of one call, L2 flushed before each launch."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(64 * 1024 * 1024, dtype=torch.int32,
                                 device="cuda")      # 256 MB > 50 MB L2

    def ms(self, fn, reps: int = REPS) -> float:
        torch = self.torch
        for _ in range(3):
            fn()
        times = []
        for _ in range(reps):
            self.flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)


def bound(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------- kernels


def kernel_checks(torch, timer):
    """Each kernel against its plain version at the slice's shapes."""
    from repro_torch.kernels.cache_gather import ops as roll_ops
    from repro_torch.kernels.decode_attention import ops as dec_ops
    from repro_torch.kernels.flash_attention import ops as fl_ops
    from repro_torch.kernels.spec_verify import ops as sv_ops
    import torch.nn.functional as F

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    B, Hq, Hkv, D = PROMPTS * GROUP, 16, 8, 128
    W = P + N
    bf = dict(dtype=torch.bfloat16, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    records = {}
    # per-row verified prefix and prompt length, as the one-pass epoch has
    n = torch.randint(0, N + 1, (B,), generator=gen, device=dev, dtype=torch.int32)
    p_len = torch.randint(6, 10, (B,), generator=gen, device=dev, dtype=torch.int32)

    def randn(*shape):
        return torch.randn(shape, generator=gen, **bf)

    def record(name, src, replaces, err, fn, plain, library, nbytes, flops):
        ms, plain_ms = timer.ms(fn), timer.ms(plain)
        library_ms = timer.ms(library) if library is not None else None
        b_ms, b_by = bound(nbytes, flops)
        rec = {"name": name, "route": "cuda", "source": src,
               "replaces": replaces, "launches": None, "max_abs_err": err,
               "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
               "bound_by": b_by, "library_ms": library_ms}
        records[name] = rec
        log(f"kernel {name}: max_abs_err={err} ms={ms} plain_ms={plain_ms} "
            f"library_ms={library_ms} bound_ms={b_ms} ({b_by})")

    # --- decode_attention: a resumed decode step of epoch 1 (S = W + N) ----
    # Rows 0-2 are done (q_pos -1, as the decode loop feeds rows past EOS);
    # row 3 has no live slot (lengths == starts) but a valid query; row 4's
    # length runs past the cache and is clamped.  Positions and bounds go in
    # as int64, the query position as (B,), for the wrapper to convert.
    S = W + N
    step = N // 2
    starts = (W - (p_len + n)).long()
    lengths = torch.full((B,), W + 1 + step, dtype=torch.int64, device=dev)
    j = torch.arange(S, device=dev)[None, :]
    k_pos = torch.where((j >= starts[:, None]) & (j < lengths[:, None]),
                        j - starts[:, None], torch.full_like(j, -1)
                        ).to(torch.int32)
    q_pos = lengths - 1 - starts
    q_pos[:3] = -1
    lengths[3] = starts[3]
    lengths[4] = S + 5
    q, k, v = randn(B, Hq, 1, D), randn(B, Hkv, S, D), randn(B, Hkv, S, D)
    kargs = (q, k, v, q_pos.view(B, 1).to(torch.int32), k_pos,
             lengths.clamp(max=S).to(torch.int32),
             starts.clamp(0, S).to(torch.int32))       # the kernel's form
    got = dec_ops.decode_attention(q, k, v, q_pos, k_pos, lengths, starts)
    want = dec_ops.decode_attention_plain(*kargs)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    require(err <= ATTN_TOL, f"decode_attention: max_abs_err {err} > {ATTN_TOL}")
    require(bool((got[:4] == 0).all()) and bool((want[:4] == 0).all()),
            "decode_attention: done rows and the row with no live slot "
            "must come out exactly 0")
    # the bound counts what this step's data needs: q and the visible K/V
    # of rows with a live query, the k_pos of their live span, the output
    qp32, len32, st32 = kargs[3], kargs[5], kargs[6]
    row_live = (qp32[:, 0] >= 0) & (len32 > st32)
    span = (j >= st32[:, None]) & (j < len32[:, None]) & row_live[:, None]
    seen = span & (k_pos >= 0) & (k_pos <= qp32)
    n_span, n_seen = int(span.sum()), int(seen.sum())
    mask4 = seen[:, None, None, :].expand(B, Hq, 1, S)
    record("decode_attention", "src/repro_torch/csrc/decode_attention.cu",
           "src/repro/kernels/decode_attention/kernel.py:193", err,
           lambda: dec_ops.decode_attention_cuda(*kargs),
           lambda: dec_ops.decode_attention_plain(*kargs),
           lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask4,
                                                  enable_gqa=True),
           nbytes=int(row_live.sum()) * Hq * D * 2 + n_seen * Hkv * D * 2 * 2
           + n_span * 4 + 3 * B * 4 + B * Hq * D * 4,
           flops=4 * n_seen * Hq * D)

    # --- flash_attention: the verify prefill of epoch 1 (T = W, S = W + N) -
    # left-padded prompt and right-padded draft: the padded query rows carry
    # q_pos -1 and must come out exactly 0; q_pos goes in as int64
    T = W
    col = torch.arange(T, device=dev)[None, :]
    pad = P - p_len[:, None]
    valid = ((col >= pad) & (col < P)) | ((col >= P) & (col < P + n[:, None]))
    q_pos_f = torch.where(valid, torch.cumsum(valid.long(), 1) - 1,
                          torch.full_like(col, -1))
    k_pos_f = torch.full((B, S), -1, **i32)
    k_pos_f[:, :T] = q_pos_f
    qf, kf, vf = randn(B, Hq, T, D), randn(B, Hkv, S, D), randn(B, Hkv, S, D)
    fargs = (qf, kf, vf, q_pos_f.to(torch.int32), k_pos_f)   # kernel's form
    got = fl_ops.flash_attention(qf, kf, vf, q_pos_f, k_pos_f)
    want = fl_ops.flash_attention_plain(*fargs)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    require(err <= ATTN_TOL, f"flash_attention: max_abs_err {err} > {ATTN_TOL}")
    require(bool((got.transpose(1, 2)[~valid] == 0).all()),
            "flash_attention: padded query rows must come out exactly 0")
    vis = ((k_pos_f[:, None, :] >= 0)
           & (k_pos_f[:, None, :] <= q_pos_f[:, :, None]))     # (B, T, S)
    pairs = int(vis.sum())
    kv_seen = int(vis.any(dim=1).sum())
    fmask = vis[:, None].expand(B, Hq, T, S)
    # bytes: q of the valid rows only (a padded row's q is never needed),
    # the K/V some query sees, both position arrays, the whole fp32 output
    # (padded rows are written as zeros)
    record("flash_attention", "src/repro_torch/csrc/flash_attention.cu",
           "src/repro/kernels/flash_attention/kernel.py:69", err,
           lambda: fl_ops.flash_attention_cuda(*fargs),
           lambda: fl_ops.flash_attention_plain(*fargs),
           lambda: F.scaled_dot_product_attention(qf, kf, vf, attn_mask=fmask,
                                                  enable_gqa=True),
           nbytes=int(valid.sum()) * Hq * D * 2 + kv_seen * Hkv * D * 2 * 2
           + B * (T + S) * 4 + B * Hq * T * D * 4,
           flops=4 * D * Hq * pairs)

    # --- spec_verify: the accept test of epoch 1 (B, N) --------------------
    f32 = dict(dtype=torch.float32, device=dev)
    lp_prev = -torch.rand((B, N), generator=gen, **f32) * 8.0
    lp_curr = lp_prev + 0.01 * torch.randn((B, N), generator=gen, **f32)
    u = torch.rand((B, N), generator=gen, **f32)
    vlen = torch.full((B,), N, dtype=torch.int64, device=dev)
    vlen[0] = 0
    sargs = (lp_curr, lp_prev, u, vlen.to(torch.int32), math.log(LENIENCE))
    got = sv_ops.spec_verify(lp_curr, lp_prev, u, vlen, math.log(LENIENCE))
    want = sv_ops.spec_verify_plain(*sargs)
    torch.cuda.synchronize()
    require(torch.equal(got, want), f"spec_verify differs: {got} vs {want}")
    record("spec_verify", "src/repro_torch/csrc/spec_verify.cu",
           "src/repro/kernels/spec_verify/kernel.py:44", 0.0,
           lambda: sv_ops.spec_verify_cuda(*sargs),
           lambda: sv_ops.spec_verify_plain(*sargs), None,
           nbytes=3 * B * N * 4 + 2 * B * 4, flops=5 * B * N)

    # --- cache_roll: the compaction of one epoch-1 buffer (28*16*8 rows) ---
    R = 28 * B * Hkv
    buf = randn(R, S, D)
    shift64 = (N - n).long().repeat_interleave(Hkv).repeat(28)
    shift = shift64.to(torch.int32)                            # kernel's form
    got = roll_ops.cache_roll(buf, shift64)
    want = roll_ops.cache_roll_plain(buf, shift)
    torch.cuda.synchronize()
    require(torch.equal(got, want), "cache_roll differs from its plain version")
    del got, want
    src_idx = torch.remainder(torch.arange(S, device=dev)[None, :]
                              - shift.long()[:, None], S)
    gidx = src_idx[:, :, None].expand(R, S, D)
    record("cache_roll", "src/repro_torch/csrc/cache_roll.cu",
           "src/repro/kernels/cache_gather/kernel.py:38", 0.0,
           lambda: roll_ops.cache_roll_cuda(buf, shift),
           lambda: roll_ops.cache_roll_plain(buf, shift),
           lambda: torch.gather(buf, 1, gidx),
           nbytes=2 * buf.numel() * 2 + R * 4, flops=0.0)
    del buf, gidx
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # the epoch-0 shapes of the two attentions, for the record
    S0 = W
    k0, v0 = randn(B, Hkv, S0, D), randn(B, Hkv, S0, D)
    st0 = (P - p_len).contiguous()
    ln0 = torch.full((B,), P + 1 + step, **i32)
    j0 = torch.arange(S0, **i32)[None, :]
    kp0 = torch.where((j0 >= st0[:, None]) & (j0 < ln0[:, None]),
                      j0 - st0[:, None], torch.full_like(j0, -1))
    qp0 = (ln0 - 1 - st0)[:, None].contiguous()
    qp0[:2] = -1                                             # done rows
    a0 = (q, k0, v0, qp0, kp0, ln0, st0)
    got0 = dec_ops.decode_attention(*a0)
    err0 = float((got0 - dec_ops.decode_attention_plain(*a0)).abs().max())
    require(bool((got0[:2] == 0).all()), "epoch-0 decode: done rows not 0")
    qp_pref = torch.where(col[:, :P] >= pad, col[:, :P] - pad,
                          torch.full_like(col[:, :P], -1)).to(torch.int32)
    kp_pref = torch.full((B, S0), -1, **i32)
    kp_pref[:, :P] = qp_pref
    fa0 = (randn(B, Hq, P, D), k0, v0, qp_pref, kp_pref)
    errf0 = float((fl_ops.flash_attention(*fa0)
                   - fl_ops.flash_attention_plain(*fa0)).abs().max())
    require(err0 <= ATTN_TOL and errf0 <= ATTN_TOL,
            f"epoch-0 shapes: decode err {err0}, flash err {errf0} > {ATTN_TOL}")
    log(f"kernel decode_attention at S={S0}: max_abs_err={err0} "
        f"ms={timer.ms(lambda: dec_ops.decode_attention_cuda(*a0))}")
    log(f"kernel flash_attention at (T, S)=({P}, {S0}): max_abs_err={errf0} "
        f"ms={timer.ms(lambda: fl_ops.flash_attention_cuda(*fa0))}")
    return records


# ---------------------------------------------------------------- small ref


def small_reference(torch):
    """The port on the card against the port on the CPU, teacher-forced, at
    the reduced qwen3-1.7b in bfloat16 (head_dim 64, G = 2)."""
    from repro_torch.configs import get_config
    from repro_torch.engine.generate import positions_from_mask
    from repro_torch.models import model as M

    cfg = get_config("qwen3-1.7b").reduced(num_kv_heads=2, dtype="bfloat16",
                                           param_dtype="bfloat16")
    cpu_model = M.init_lm(cfg, seed=SEED, device="cpu")
    gpu_model = copy.deepcopy(cpu_model).to("cuda")
    g = torch.Generator().manual_seed(SEED)
    B, Pp, steps = 4, 16, 6
    prompt = torch.randint(3, cfg.vocab_size, (B, Pp), generator=g,
                           dtype=torch.int32)
    mask = torch.ones(B, Pp, dtype=torch.bool)
    for b in range(B):
        mask[b, :b * 3] = False
    nxt = torch.randint(3, cfg.vocab_size, (B, steps), generator=g,
                        dtype=torch.int32)
    shift = torch.tensor([0, 3, 5, 1], dtype=torch.int32)

    def run(model, dev):
        pos = positions_from_mask(mask.to(dev))
        outs = [M.forward(model, cfg, prompt.to(dev), pos)[0]]
        caches = M.init_cache(cfg, B, Pp + 2 * steps, device=dev)
        logits, caches = M.prefill(model, cfg, prompt.to(dev), pos, caches)
        outs.append(logits)
        p_len = mask.sum(1).to(torch.int32).to(dev)
        for s in range(steps):
            logits, caches = M.decode_step(
                model, cfg, nxt[:, s:s + 1].to(dev), (p_len + s)[:, None],
                caches, Pp + s, kv_length=Pp + 1 + s, kv_start=Pp - p_len)
            outs.append(logits)
        width = Pp + steps
        caches = M.realign_decode_cache(cfg, caches, shift.to(dev),
                                        p_len + steps - shift.to(dev), width)
        outs.append(caches[0]["self"]["k"].float())
        return [o.float().cpu() for o in outs]

    want = run(cpu_model, torch.device("cpu"))
    got = run(gpu_model, torch.device("cuda"))
    err = max(float((a - b).abs().max()) for a, b in zip(got, want))
    log(f"small reference (reduced qwen3-1.7b, bf16, card vs CPU): "
        f"max_abs_err={err} tol={SMALL_TOL}")
    require(err <= SMALL_TOL, f"card vs CPU max_abs_err {err} > {SMALL_TOL}")


# ---------------------------------------------------------------- main path


def main_path(torch):
    from repro_torch.configs import get_config
    from repro_torch.core import RolloutCache, SpecConfig, rollout
    from repro_torch.data.dataset import PromptDataset
    from repro_torch.data.tokenizer import EOS_ID, PAD_ID
    from repro_torch.engine.generate import GenerateConfig
    from repro_torch.engine.sampling import make_key, split_key
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models import model as M
    from repro_torch.rewards.mathgen import MathTaskConfig, generate_problems
    from repro_torch.rewards.verifier import batch_rewards

    import numpy as np

    cfg = get_config("qwen3-1.7b")
    t0 = time.perf_counter()
    model = M.init_lm(cfg, seed=SEED, device="cuda")
    torch.cuda.synchronize()
    log(f"model {cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"{M.count_params(model)} params in {cfg.param_dtype}, init "
        f"{time.perf_counter() - t0:.2f} s")
    problems = generate_problems(MathTaskConfig(num_problems=PROMPTS, seed=SEED))
    batch = next(PromptDataset(problems, max_prompt_len=P).epochs(
        PROMPTS, GROUP, 1, shuffle=False))
    gen = GenerateConfig(max_new_tokens=N, temperature=1.0, top_p=1.0,
                         eos_id=EOS_ID, pad_id=PAD_ID)
    spec = SpecConfig(variant="spec", one_pass="auto", lenience=LENIENCE)
    cache = RolloutCache(history=spec.cache_history, group_size=GROUP)
    key = make_key(SEED)

    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    rbs = []
    for epoch in (0, 1):
        key, sub = split_key(key)
        before = dict(LAUNCHES)
        te = time.perf_counter()
        rb = rollout(model, cfg, gen, spec, batch.tokens, batch.mask,
                     batch.cache_keys, cache, sub, epoch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - te
        rewards = batch_rewards(rb.response, rb.length, batch.answers)
        m = rb.metrics
        log("epoch " + json.dumps({
            "epoch": epoch, "wall_s": wall, "n_generated": m["n_generated"],
            "n_reused": m["n_reused"], "accept_rate": m["accept_rate"],
            "one_pass": m["one_pass"], "verify_time": m["verify_time"],
            "compact_time": m["compact_time"],
            "decode_time": m["decode_time"],
            "reward_mean": float(rewards.mean()),
            "launches": {k: LAUNCHES[k] - before[k] for k in LAUNCHES},
            "n": rb.n.tolist()}))
        rbs.append(rb)
    launches = dict(LAUNCHES)
    log(f"main path launches: {launches}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    rb0, rb1 = rbs
    B = PROMPTS * GROUP
    for rb in rbs:
        require(rb.response.shape == (B, N)
                and rb.behaviour_logprobs.shape == (B, N), "output shapes")
        lp = rb.behaviour_logprobs
        require(np.all(np.isfinite(lp)), "non-finite behaviour logprobs")
        require(np.all(lp[rb.response_mask] <= 0.0)
                and np.all(lp[~rb.response_mask] == 0.0), "logprob layout")
        require(np.array_equal(rb.response_mask.sum(1), rb.length),
                "response mask vs length")
        require(np.all((rb.response >= 0) & (rb.response < cfg.vocab_size)),
                "token ids out of range")
    require(rb0.metrics["one_pass"] == 0.0 and rb0.metrics["n_generated"] > 0,
            f"epoch 0 was not a vanilla rollout: {rb0.metrics}")
    require(rb1.metrics["one_pass"] == 1.0,
            f"epoch 1 did not take the one-pass branch: {rb1.metrics}")
    n = rb1.n
    require(np.any((n > 0) & (n < N)), f"no partial acceptance: n={n}")
    require(int(n.sum()) == rb1.metrics["n_reused"], "n vs n_reused")
    for b in range(B):
        nb = int(n[b])
        require(np.array_equal(rb1.response[b, :nb], rb0.response[b, :nb]),
                f"row {b}: response does not start with its draft[:{nb}]")
    for name, count in launches.items():
        require(count > 0, f"kernel {name} was not launched on the main path")
    time_breakdown(torch, model, cfg, gen, batch)
    return launches


def time_breakdown(torch, model, cfg, gen, batch, steps: int = 16):
    """Where a vanilla generate's time goes (prefill + ``steps`` decode
    steps at the slice's batch): host wall time without the profiler, then
    device busy time and the top kernels and host ops from
    ``torch.profiler`` over the same call."""
    from dataclasses import replace

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.engine.generate import generate
    from repro_torch.engine.sampling import make_key

    g = replace(gen, eos_id=-1, max_new_tokens=steps)   # exactly `steps` steps

    def run():
        generate(model, cfg, g, batch.tokens, batch.mask, make_key(SEED + 1))
        torch.cuda.synchronize()

    run()
    t0 = time.perf_counter()
    run()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
    events = prof.key_averages()
    kernels = sorted((e for e in events if e.device_type == DeviceType.CUDA),
                     key=lambda e: -e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    host = sorted((e for e in events if e.device_type == DeviceType.CPU),
                  key=lambda e: -e.self_cpu_time_total)
    log("breakdown " + json.dumps({
        "what": f"generate B={batch.tokens.shape[0]} "
                f"P={batch.tokens.shape[1]} steps={steps}",
        "wall_ms": wall_ms, "device_busy_ms": busy_ms,
        "device_idle_share": 1.0 - busy_ms / wall_ms,
        "top_kernels": [[e.key[:60], e.count, e.self_device_time_total / 1e3]
                        for e in kernels[:8]],
        "top_host_ops": [[e.key[:60], e.count, e.self_cpu_time_total / 1e3]
                         for e in host[:8]]}))
    rows = ["side\tname\tcalls\tself_ms"]
    rows += [f"device\t{e.key}\t{e.count}\t{e.self_device_time_total / 1e3}"
             for e in kernels[:40]]
    rows += [f"host\t{e.key}\t{e.count}\t{e.self_cpu_time_total / 1e3}"
             for e in host[:40]]
    (OUT_DIR / "chip_smoke_profile.tsv").write_text("\n".join(rows) + "\n")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke test runs on the "
              "card", file=sys.stderr)
        return 2
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch").is_dir():
        print(f"chip_smoke: {src / 'repro_torch'} not found; run from the "
              "root of a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = smi_line()
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    _build.library()
    log(f"kernels built and loaded in {time.perf_counter() - t0:.1f} s")
    OUT_DIR.mkdir(exist_ok=True)
    (OUT_DIR / "chip_smoke_build.log").write_text(_build.build_log())
    for line in _build.build_log().splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            log("  ptxas: " + line.strip())

    timer = Timer(torch)
    records = kernel_checks(torch, timer)
    del timer
    torch.cuda.empty_cache()
    small_reference(torch)
    launches = main_path(torch)
    for name, rec in records.items():
        rec["launches"] = launches[name]
    print(json.dumps({"kernels": list(records.values())}), flush=True)
    print(smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
