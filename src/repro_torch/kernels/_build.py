"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` has a plain C interface.  At first use each source is
compiled by its own ``nvcc`` process, all started together, for ``sm_90a``
(``-gencode arch=compute_90a,code=sm_90a -O3 -Xcompiler -fPIC``); the
objects are linked into one shared library, loaded with ``ctypes``.  The
build lands in ``build/kernels/<hash of sources and flags>/`` under the
checkout (listed in ``.gitignore``), so a changed source builds anew and an
unchanged one is reused.  ``ptxas -v`` output (registers, shared memory,
spills) is kept in ``build.log`` beside the library.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import torch

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG.parents[1] / "build" / "kernels"
SOURCES = ("decode_attention", "flash_attention", "spec_verify", "cache_roll",
           "cache_slot_write", "paged_gather", "paged_decode_attention",
           "wkv", "mamba_scan")
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
         "-lineinfo"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
SIGNATURES = {
    # q, k, v, q_pos, k_pos, lengths, starts, out,
    # B, Hq, Hkv, T, S, Dk, Dv, cluster, window, scale, stream
    "repro_decode_attention": [_P] * 8 + [_I] * 9 + [_F, _P],
    # q, k, v, q_pos, k_pos, out, B, Hq, Hkv, T, S, Dk, Dv, causal, window,
    # scale, stream
    "repro_flash_attention": [_P] * 6 + [_I] * 9 + [_F, _P],
    # lp_curr, lp_prev, u, valid_len, valid_len is int64, out, B, N,
    # log_lenience, stream
    "repro_spec_verify": [_P] * 4 + [_I, _P, _I, _I, _F, _P],
    # buf, shift, out, R, S, row_bytes, stream
    "repro_cache_roll": [_P] * 3 + [_L, _I, _I, _P],
    # dst, src, src_for_dst, Rd, row_bytes, stream
    "repro_cache_slot_write": [_P] * 3 + [_L, _L, _P],
    # pool, table, out, n_blocks, block_bytes, stream
    "repro_paged_gather": [_P] * 3 + [_L, _L, _P],
    # q, k_pool, v_pool, table, q_pos, k_pos, lengths, starts, out,
    # B, Hq, Hkv, T, nb, bs, D, cluster, window, scale, stream
    "repro_paged_decode_attention": [_P] * 9 + [_I] * 9 + [_F, _P],
    # r, k, v, w, u, s0, y, s_out, B, T, H, hd, stream
    "repro_wkv": [_P] * 8 + [_I] * 4 + [_P],
    # dt, u, Bc, Cc, A, D, s, y, B, T, di, ds, stream
    "repro_mamba_scan": [_P] * 8 + [_I] * 4 + [_P],
}

_LIB: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the port's CUDA kernels are "
                           "built on a machine with the CUDA toolkit")
    return path


def _digest() -> str:
    h = hashlib.sha256(" ".join(ARCH + FLAGS).encode())
    for name in SOURCES:
        h.update((CSRC / f"{name}.cu").read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile (if needed) and return the path of the shared library."""
    out_dir = BUILD_ROOT / _digest()
    lib = out_dir / "librepro_torch_kernels.so"
    if lib.exists():
        return lib
    nvcc = _nvcc()
    tmp = out_dir.with_name(out_dir.name + f".tmp{os.getpid()}")
    tmp.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in SOURCES:
        cmd = [nvcc, *ARCH, *FLAGS, "-c", str(CSRC / f"{name}.cu"),
               "-o", str(tmp / f"{name}.o")]
        procs.append((name, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT,
                                             text=True)))
    log = []
    failed = []
    for name, proc in procs:
        text, _ = proc.communicate()
        log.append(f"== {name}.cu ==\n{text}")
        if proc.returncode != 0:
            failed.append(name)
    (tmp / "build.log").write_text("\n".join(log))
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(log))
    link = subprocess.run(
        [nvcc, *ARCH, "-shared", "-o", str(tmp / lib.name),
         *[str(tmp / f"{name}.o") for name in SOURCES]],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"linking the kernels failed:\n{link.stdout}")
    tmp.replace(out_dir)
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library (built at first use)."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        for fn, argtypes in SIGNATURES.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _LIB = lib
    return _LIB


def build_log() -> str:
    path = BUILD_ROOT / _digest() / "build.log"
    return path.read_text() if path.exists() else ""


def check(err: int, name: str) -> None:
    """Raise on a nonzero ``cudaGetLastError()`` from a launch."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")


def launch(fn: str, device: torch.device, *args) -> None:
    """Call ``fn`` of the library on ``device``'s current stream (pointers
    as ``data_ptr()`` ints) and raise if the launch failed."""
    lib = library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, fn)(*args, stream)
    check(err, fn)
