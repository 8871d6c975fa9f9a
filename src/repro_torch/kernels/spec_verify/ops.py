"""SPEC-RL accept / first-reject test (port of
``repro/kernels/spec_verify``).

``spec_verify`` returns, per row, the first rejected draft position
``n`` in [0, valid_len] (== valid_len: every draft token accepted).  It
launches the CUDA kernel (``csrc/spec_verify.cu``, which replaces
``spec_verify_pallas``, ``repro/kernels/spec_verify/kernel.py:44``, and the
clamp of its ``ops.py``) on CUDA tensors and runs ``spec_verify_plain`` on
CPU tensors.  The two agree exactly.  The kernel is one memory trip: one
warp per row loads every token together with ``valid_len`` (int32 or
int64, as the caller holds it, so the call is one launch and nothing
else) and finds the first rejection by a ballot.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import LAUNCHES, refuse_grad
from repro_torch.kernels._build import launch


def spec_verify_plain(lp_curr, lp_prev, u, valid_len, log_lenience: float
                      ) -> torch.Tensor:
    """Acceptance u <= min(1, l * p_curr / p_prev), in log space
    (``repro/kernels/spec_verify/ref.py``).  Returns (B,) int32."""
    B, N = lp_curr.shape
    log_alpha = torch.clamp(lp_curr.float() - lp_prev.float() + log_lenience,
                            max=0.0)
    alpha = torch.exp(log_alpha)
    gidx = torch.arange(N, dtype=torch.int32, device=lp_curr.device)[None, :]
    reject = (u > alpha) & (gidx < valid_len[:, None])
    first = torch.argmax(reject.to(torch.int32), dim=1).to(torch.int32)
    return torch.where(reject.any(dim=1), first, valid_len.to(torch.int32))


def spec_verify_cuda(lp_curr, lp_prev, u, valid_len, log_lenience: float
                     ) -> torch.Tensor:
    """The kernel entry: lp_curr / lp_prev / u contiguous float32 (B, N);
    valid_len (B,) int32 or int64, read as it is (one launch, nothing
    else)."""
    B, N = lp_curr.shape
    for name, t in (("lp_curr", lp_curr), ("lp_prev", lp_prev), ("u", u)):
        if (t.dtype != torch.float32 or not t.is_contiguous()
                or t.device != lp_curr.device):
            raise ValueError(f"spec_verify kernel needs a contiguous float32 "
                             f"{name} on {lp_curr.device}")
    if (valid_len.dtype not in (torch.int32, torch.int64)
            or not valid_len.is_contiguous()
            or valid_len.device != lp_curr.device):
        raise ValueError("spec_verify kernel needs a contiguous int32 or "
                         f"int64 valid_len on {lp_curr.device}")
    if lp_prev.shape != (B, N) or u.shape != (B, N) or valid_len.shape != (B,):
        raise ValueError("spec_verify kernel: lp_prev/u must be (B, N) and "
                         "valid_len (B,)")
    out = torch.empty((B,), dtype=torch.int32, device=lp_curr.device)
    launch("repro_spec_verify", lp_curr.device, lp_curr.data_ptr(),
           lp_prev.data_ptr(), u.data_ptr(), valid_len.data_ptr(),
           int(valid_len.dtype == torch.int64), out.data_ptr(), B, N,
           float(log_lenience))
    LAUNCHES["spec_verify"] += 1
    return out


def spec_verify(lp_curr, lp_prev, u, valid_len, log_lenience: float
                ) -> torch.Tensor:
    """lp_curr / lp_prev / u: (B, N) float32; valid_len: (B,) int32 or
    int64.  Returns (B,) int32.  CUDA tensors launch the kernel (or raise);
    CPU tensors take the plain version."""
    refuse_grad("spec_verify", lp_curr, lp_prev, u)
    if lp_curr.device.type == "cuda":
        return spec_verify_cuda(lp_curr.contiguous(), lp_prev.contiguous(),
                                u.contiguous(), valid_len.contiguous(),
                                log_lenience)
    if lp_curr.device.type != "cpu":
        raise ValueError(f"spec_verify: no kernel for {lp_curr.device}")
    return spec_verify_plain(lp_curr, lp_prev, u, valid_len, log_lenience)
