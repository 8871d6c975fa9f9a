#!/usr/bin/env python3
"""Where the ``wkv`` and ``spec_verify`` kernels' time goes, on one card.

    python3 tools/wkv_probe.py

Builds copies of ``src/repro_torch/csrc/wkv.cu`` and ``spec_verify.cu``
(one ``nvcc`` each, all started together, with the port's flags), each
edited by exact text substitutions (which must apply once, so a changed
kernel makes this script fail rather than measure something else) or
with a kernel of this script's appended, and times them at
``chip_smoke.py``'s shapes (rwkv6-3b: B = 16, H = 40, hd = 64; the accept
test's (16, 256)):

* T = 1 (a decode step, one done row): the kernel's design, one block per
  (b, h) with every load at once into registers; option (b), the same
  with a block per group of 16 or 32 columns of a (b, h); and option (a),
  persistent blocks walking the (b, h) items with a two-stage ring of
  bulk copies, 1 or 2 blocks an SM (both this script's kernels, appended
  to ``wkv.cu`` and sized by ``-D``);
* T = 320 (the verify score) and T = 64 (the epoch-0 prefill): thread
  layouts of R rows x C columns a thread (the source's ``SEQ_ROWS`` and
  ``SEQ_COLS``: 4 x 4, 4 x 8, 8 x 4, 8 x 8), 4 x 8 at a ring of 8 steps x
  4 stages (``TC``, ``NS``) beside 16 x 2, and 4 x 8 and 8 x 8 without
  the step's arithmetic (update and butterfly; the ring, the shared loads
  and the y stores stay), without the loads (no bulk copy: the stage's
  barrier completes at once, the compute runs on what shared memory
  holds) and without either;
* ``spec_verify`` with ``valid_len`` int32 and int64, and int32 read with
  no choice of type (what reading the type at run time costs);
* T = 1 is timed after each of two flushes: zeroing 256 MB, which leaves
  the L2 full of dirty lines that the kernel's traffic must first write
  back, and reading 256 MB (a clean L2).

Each variant is checked against the plain version (the full kernels:
within ``WKV_TOL``, exactly for ``spec_verify``) and timed by its device
time per call (``torch.profiler``, every kernel of the call, the L2
flushed by zeroing 256 MB before each call as ``chip_smoke.Timer`` does),
twice, all variants of a shape in turns.  It prints one JSON line per
shape and writes them, with the card's name, power limit and SM clock, to
``chiprun_out/wkv_probe.json``.
"""
from __future__ import annotations

import ctypes
import json
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))
CSRC = ROOT / "src" / "repro_torch" / "csrc"
WORK = ROOT / "build" / "wkv_probe"
B = 16

STEP = "      *y_t = wkv_step<R, C, L>(S, rr, kk, ww, uu, vc, p);\n"
NO_COMPUTE = [(STEP, "      *y_t = rr[0] + kk[0] + ww[0] + vc[0];\n")]
NO_LOADS = [("  if (lane == 0) hopper::mbar_expect_tx(&full[s], 4 * nt * HD * 4);\n",
             "  if (lane == 0) hopper::mbar_arrive(&full[s]);\n"),
            ("  for (int i = lane; i < 4 * nt; i += 32) {\n",
             "  for (int i = lane; i < 0 * nt; i += 32) {\n")]


# Option (a) at T = 1, appended to wkv.cu (the kernel's helpers are in
# scope): persistent blocks walking the (b, h) items, each item's state and
# rows bulk-copied into a two-stage ring, the new state written back in
# shared memory and out by bulk store; called through ``repro_wkv_ring``.
END = "  return static_cast<int>(cudaErrorInvalidValue);\n}\n"
RING_CU = r'''
namespace {

// Persistent blocks walking the (b, h) items bh = blockIdx.x + j gridDim.x;
// thread 0 bulk-copies item j + 2's state and rows into the stage item j
// leaves, once item j's new state (written back in place) has been read
// out by its bulk store.
template <int HD>
__global__ void __launch_bounds__(4 * HD) wkv_ring_kernel(
    const float* __restrict__ r, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ w,
    const float* __restrict__ u, const float* s0, float* __restrict__ y,
    float* s_out, int H, int n_items) {
  constexpr int R = HD / LANES, NS = 2;
  __shared__ __align__(128) float st[NS][HD * HD];
  __shared__ __align__(128) float rows[NS][4][HD];
  __shared__ __align__(8) uint64_t full[NS];
  const int tid = threadIdx.x, p = tid % LANES, g = tid / LANES;

  if (tid == 0) {
    for (int s = 0; s < NS; ++s) hopper::mbar_init(&full[s], 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();
  auto produce = [&](int s, int item) {       // thread 0
    hopper::mbar_expect_tx(&full[s], (HD * HD + 4 * HD) * 4);
    hopper::bulk_load(st[s], s0 + (size_t)item * HD * HD, HD * HD * 4, &full[s]);
    const float* src[4] = {r, k, v, w};
#pragma unroll
    for (int a = 0; a < 4; ++a)
      hopper::bulk_load(rows[s][a], src[a] + (size_t)item * HD, HD * 4, &full[s]);
  };
  if (tid == 0)
    for (int j = 0; j < NS && blockIdx.x + j * gridDim.x < n_items; ++j)
      produce(j, blockIdx.x + j * gridDim.x);

  for (int j = 0;; ++j) {
    const int item = blockIdx.x + j * gridDim.x;
    if (item >= n_items) break;
    const int s = j % NS, h = item % H;
    float uu[R], rr[R], kk[R], ww[R], vc[4], S[R][4];
    load_rows<R>(u + h * HD + R * p, uu);
    hopper::mbar_wait(&full[s], (j / NS) & 1);
    load_state<R, 4>(st[s], p, g, HD, S);
    load_rows<R>(&rows[s][0][R * p], rr);
    load_rows<R>(&rows[s][1][R * p], kk);
    load_rows<R>(&rows[s][3][R * p], ww);
    unpack4(*reinterpret_cast<const float4*>(&rows[s][2][4 * g]), vc);
    const float yv = wkv_step<R, 4, LANES>(S, rr, kk, ww, uu, vc, p);
    if ((p & 3) == 0) y[(size_t)item * HD + 4 * g + ycol<4, LANES>(p)] = yv;
    store_state<R, 4>(st[s], p, g, HD, S);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (tid == 0) {
      hopper::bulk_store(s_out + (size_t)item * HD * HD, st[s], HD * HD * 4);
      hopper::bulk_commit();
      const int next = item + NS * gridDim.x;
      if (next < n_items) {
        hopper::bulk_wait_read<0>();
        produce(s, next);
      }
    }
  }
  if (tid == 0) hopper::bulk_wait<0>();
}

}  // namespace

// the probe's entry: T = 1, hd = 64, BLOCKS_PER_SM persistent blocks an SM
extern "C" int repro_wkv_ring(const void* r, const void* k, const void* v,
                              const void* w, const void* u, const void* s0,
                              void* y, void* s_out, int B, int T, int H,
                              int hd, void* stream) {
  if (T != 1 || hd != 64) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int grid = B * H < BLOCKS_PER_SM * sms ? B * H : BLOCKS_PER_SM * sms;
  wkv_ring_kernel<64><<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(r), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(w),
      static_cast<const float*>(u), static_cast<const float*>(s0),
      static_cast<float*>(y), static_cast<float*>(s_out), H, B * H);
  return static_cast<int>(cudaGetLastError());
}
'''
RING = [(END, END + RING_CU)]

# Option (b) at T = 1, appended to wkv.cu: the kernel's wkv_step_kernel with
# a block per group of SPLIT_COLS columns of a (b, h) (16 row lanes x
# SPLIT_COLS / 4 column groups); called through ``repro_wkv_split``.
SPLIT_CU = r'''
namespace {

template <int HD, int COLS>
__global__ void __launch_bounds__(4 * COLS) wkv_split_kernel(
    const float* __restrict__ r, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ w,
    const float* __restrict__ u, const float* s0, float* __restrict__ y,
    float* s_out, int H) {
  constexpr int R = HD / LANES, GROUPS = HD / COLS;
  const int bh = blockIdx.x / GROUPS, h = bh % H;
  const int p = threadIdx.x % LANES;
  const int g = (blockIdx.x % GROUPS) * (COLS / 4) + threadIdx.x / LANES;
  const size_t row = (size_t)bh * HD;     // (b, 0, h, 0) at T = 1
  float S[R][4], rr[R], kk[R], ww[R], uu[R], vc[4];
  load_state<R, 4>(s0 + (size_t)bh * HD * HD, p, g, HD, S);
  load_rows<R>(r + row + R * p, rr);
  load_rows<R>(k + row + R * p, kk);
  load_rows<R>(w + row + R * p, ww);
  load_rows<R>(u + h * HD + R * p, uu);
  unpack4(*reinterpret_cast<const float4*>(v + row + 4 * g), vc);
  const float yv = wkv_step<R, 4, LANES>(S, rr, kk, ww, uu, vc, p);
  if ((p & 3) == 0) y[row + 4 * g + ycol<4, LANES>(p)] = yv;
  store_state<R, 4>(s_out + (size_t)bh * HD * HD, p, g, HD, S);
}

}  // namespace

// the probe's entry: T = 1, hd = 64, a block per SPLIT_COLS columns
extern "C" int repro_wkv_split(const void* r, const void* k, const void* v,
                               const void* w, const void* u, const void* s0,
                               void* y, void* s_out, int B, int T, int H,
                               int hd, void* stream) {
  if (T != 1 || hd != 64) return static_cast<int>(cudaErrorInvalidValue);
  wkv_split_kernel<64, SPLIT_COLS><<<B * H * (64 / SPLIT_COLS), 4 * SPLIT_COLS,
                                     0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(r), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(w),
      static_cast<const float*>(u), static_cast<const float*>(s0),
      static_cast<float*>(y), static_cast<float*>(s_out), H);
  return static_cast<int>(cudaGetLastError());
}
'''
SPLIT = [(END, END + SPLIT_CU)]


def rows_layout(R, C, tc=16, ns=2):
    """Substitutions giving the T > 1 kernel R x C elements a thread and a
    ring of ``ns`` stages of ``tc`` steps."""
    return [("constexpr int SEQ_ROWS = 4;", f"constexpr int SEQ_ROWS = {R};"),
            ("constexpr int SEQ_COLS = 8;", f"constexpr int SEQ_COLS = {C};"),
            ("constexpr int TC = 16;", f"constexpr int TC = {tc};"),
            ("constexpr int NS = 2;", f"constexpr int NS = {ns};")]


# name: (source, -D settings, substitutions, what it is timed at, C entry)
VARIANTS = {
    "step split 16": ("wkv", {"SPLIT_COLS": 16}, SPLIT, "T1", "repro_wkv_split"),
    "step split 32": ("wkv", {"SPLIT_COLS": 32}, SPLIT, "T1", "repro_wkv_split"),
    "step (b, h) a block": ("wkv", {}, [], "T1", "repro_wkv"),
    "step ring 1/SM": ("wkv", {"BLOCKS_PER_SM": 1}, RING, "T1", "repro_wkv_ring"),
    "step ring 2/SM": ("wkv", {"BLOCKS_PER_SM": 2}, RING, "T1", "repro_wkv_ring"),
    "rows R=4 C=4": ("wkv", {}, rows_layout(4, 4), "seq", "repro_wkv"),
    "rows R=4 C=8": ("wkv", {}, rows_layout(4, 8), "seq", "repro_wkv"),
    "rows R=8 C=4": ("wkv", {}, rows_layout(8, 4), "seq", "repro_wkv"),
    "rows R=8 C=8": ("wkv", {}, rows_layout(8, 8), "seq", "repro_wkv"),
    "rows R=4 C=8 8x4": ("wkv", {}, rows_layout(4, 8, tc=8, ns=4), "seq",
                         "repro_wkv"),
}
for _R, _C in ((4, 8), (8, 8)):
    for _what, _subs in (("no compute", NO_COMPUTE), ("no loads", NO_LOADS),
                         ("neither", NO_COMPUTE + NO_LOADS)):
        VARIANTS[f"rows R={_R} C={_C} {_what}"] = (
            "wkv", {}, rows_layout(_R, _C) + _subs, "seq", "repro_wkv")
for _vl in ("int32", "int64"):
    VARIANTS[f"spec_verify, valid_len {_vl}"] = ("spec_verify", {}, [], "sv",
                                                 "repro_spec_verify")
# what reading the length's type at run time costs: int32 lengths read
# with no choice of type
INT_ONLY = [("  const long long vl = vl_int64 ? static_cast<const long long*>(valid_len)[b]\n"
             "                                : static_cast<const int*>(valid_len)[b];\n",
             "  const long long vl = static_cast<const int*>(valid_len)[b];\n")]
VARIANTS["spec_verify, valid_len int32 read as int only"] = (
    "spec_verify", {}, INT_ONLY, "sv", "repro_spec_verify")


def build(name, src, defines, subs, nvcc, arch, flags):
    """Start the ``nvcc`` of one variant; returns (process, library path)."""
    text = (CSRC / f"{src}.cu").read_text()
    for old, new in subs:
        if text.count(old) != 1:
            raise RuntimeError(f"{name}: the substitution {old!r} does not "
                               "apply once: the kernel's source changed")
        text = text.replace(old, new)
    tag = "".join(c if c.isalnum() else "_" for c in name)
    cu = WORK / f"{tag}.cu"
    cu.write_text(text)
    lib = WORK / f"lib{tag}.so"
    cmd = [nvcc, *arch, *flags, "-shared", f"-I{CSRC}",
           *(f"-D{k}={v}" for k, v in defines.items()), "-o", str(lib), str(cu)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), lib


def main() -> int:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    from repro_torch.kernels import _build
    from repro_torch.kernels.rwkv6_wkv import ops as wkv_ops
    from repro_torch.kernels.spec_verify import ops as sv_ops
    from wkv_ab import sm_clocks

    if not torch.cuda.is_available():
        print("wkv_probe: no CUDA device", file=sys.stderr)
        return 2
    smi = chip_smoke.smi_line()
    WORK.mkdir(parents=True, exist_ok=True)
    nvcc = _build._nvcc()
    procs = {name: build(name, *spec[:3], nvcc, _build.ARCH, _build.FLAGS)
             for name, spec in VARIANTS.items()}
    libs, log = {}, []
    for name, (proc, lib) in procs.items():
        text, _ = proc.communicate()
        log.append(f"== {name} ==\n{text}")
        if proc.returncode:
            raise RuntimeError(f"{name}:\n{text}")
        dll = ctypes.CDLL(str(lib))
        P_, I_, F_ = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        if VARIANTS[name][0] == "wkv":
            entry = getattr(dll, VARIANTS[name][4])
            entry.argtypes = [P_] * 8 + [I_] * 4 + [P_]
            entry.restype = I_
        else:
            dll.repro_spec_verify.argtypes = [P_] * 4 + [I_, P_, I_, I_, F_, P_]
            dll.repro_spec_verify.restype = I_
        libs[name] = dll
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "wkv_probe_build.log").write_text("\n".join(log))

    timer = chip_smoke.Timer(torch)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(chip_smoke.SEED)
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731

    flushes = {"zeroing flush": timer.flush.zero_,
               "reading flush": lambda: timer.flush.sum()}

    def device_ms(fn, kernel, flush, reps=50):
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
                   and kernel in e.key) / reps / 1e3

    def measure(label, fns, checks, kernel, flush_names=("zeroing flush",)):
        row = {"shape": label, "max_abs_err": {}}
        for name, fn in fns.items():
            row["max_abs_err"][name] = checks(name, fn)
        for _ in range(2):                            # in turns
            for f in flush_names:
                for name, fn in fns.items():
                    row.setdefault(f"device_ms, {f}", {}).setdefault(
                        name, []).append(device_ms(fn, kernel, flushes[f]))
        row["sm_clocks"] = sm_clocks()
        print(json.dumps(row), flush=True)
        return row

    rows = []
    P, N = chip_smoke.P, chip_smoke.N
    p_len = torch.randint(6, 10, (B,), generator=gen, device=dev)
    n = torch.randint(0, N + 1, (B,), generator=gen, device=dev)
    col = torch.arange(P, device=dev)[None, :]
    for T, valid, kind in ((1, torch.arange(B, device=dev)[:, None] > 0, "T1"),
                           (P + N, chip_smoke.score_valid(torch, p_len, n), "seq"),
                           (P, col >= P - p_len[:, None], "seq")):
        r, k, v, w, u, s0 = chip_smoke.wkv_inputs(torch, gen, T, valid)
        H, hd = u.shape
        want_y, want_s = wkv_ops.wkv_plain(r, k, v, w, u, s0)
        s_out = torch.empty_like(s0)

        def call(lib, entry="repro_wkv"):
            y = torch.empty_like(r)
            _build.check(getattr(lib, entry)(
                *(t.data_ptr() for t in (r, k, v, w, u, s0, y, s_out)), B, T,
                H, hd, stream()), "probe wkv")
            return y

        def checks(name, fn):
            y = fn()
            torch.cuda.synchronize()
            err = max(float((y - want_y).abs().max()),
                      float((s_out - want_s).abs().max()))
            if name.endswith(("no compute", "no loads", "neither")):
                return err                 # no result to hold
            scale = max(float(want_y.abs().max()), float(want_s.abs().max()))
            chip_smoke.require(err <= chip_smoke.WKV_TOL * scale,
                               f"{name} at T={T}: max_abs_err {err}")
            return err

        fns = {name: (lambda lib=libs[name], e=spec[4]: call(lib, e))
               for name, spec in VARIANTS.items() if spec[3] == kind}
        rows.append(measure(f"wkv T={T} B={B} H={H} hd={hd}", fns, checks,
                            "wkv_", tuple(flushes) if T == 1 else
                            ("zeroing flush",)))
        del r, k, v, w, s0, s_out, want_y, want_s

    f32 = dict(dtype=torch.float32, device=dev)
    lp_prev = -torch.rand((B, N), generator=gen, **f32) * 8.0
    lp_curr = lp_prev + 0.01 * torch.randn((B, N), generator=gen, **f32)
    uu = torch.rand((B, N), generator=gen, **f32)
    vlen64 = torch.full((B,), N, dtype=torch.int64, device=dev)
    vlen64[0] = 0
    vlen = vlen64.to(torch.int32)
    ll = math.log(chip_smoke.LENIENCE)
    want = sv_ops.spec_verify_plain(lp_curr, lp_prev, uu, vlen, ll)

    def sv_call(lib, name):
        vl = vlen64 if "int64" in name else vlen
        o = torch.empty((B,), dtype=torch.int32, device=dev)
        _build.check(lib.repro_spec_verify(
            lp_curr.data_ptr(), lp_prev.data_ptr(), uu.data_ptr(),
            vl.data_ptr(), int(vl.dtype == torch.int64), o.data_ptr(), B, N,
            ll, stream()), "probe sv")
        return o

    def sv_checks(name, fn):
        got = fn()
        torch.cuda.synchronize()
        chip_smoke.require(torch.equal(got, want), f"{name}: {got} vs {want}")
        return 0.0

    fns = {name: (lambda lib=libs[name], name=name: sv_call(lib, name))
           for name, spec in VARIANTS.items() if spec[3] == "sv"}
    rows.append(measure(f"spec_verify B={B} N={N}", fns, sv_checks,
                        "spec_verify_kernel"))

    (out / "wkv_probe.json").write_text(json.dumps(
        {"device": smi, "sm_clocks": sm_clocks(), "rows": rows}, indent=1))
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
